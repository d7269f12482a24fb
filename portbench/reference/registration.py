"""Plain reference of probabilistic point-cloud registration, for deciding
whether the program's answers are correct.

It is written from the method's description, not from the program's code:
per outer iteration, a brute-force radius k-NN of the moved source against
the target, then an inner solve of the weighted least-squares problem over
(q, t) (an unnormalised quaternion, rotated by ``q / |q|``, and a
translation) by Levenberg-Marquardt with Ceres's trust-region rules
(nonmonotonic steps, function and parameter tolerance), with Student-t
(or Gaussian) EM weights refreshed at every LM iteration; the increment is
composed onto the cumulative transform in float64, and the reference's
stopping rule (cost drop under a threshold for more than ``n_cost_drop_it``
checks, or ``n_iter`` iterations) ends the loop. It imports nothing of the
program and takes nothing the program made: every grid, table and weight is
worked out again from the raw points.

``precision="float64"`` is the reference. ``precision="tf32"`` is the
control: the same algorithm in float32 with every contraction (the distance
matrix's cross term, the moved source, the normal equations' sums) taken
on operands rounded to TF32's 10-bit mantissa, as tensor cores take them.
The 7x7 step is solved in float64 in both, as the program solves it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

_MAX_RADIUS = 1e16
_MIN_RADIUS = 1e-32
_MAX_NONMONOTONIC = 5


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest (ties to even) at TF32's 10-bit
    mantissa; the exponent range is float32's."""
    bits = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & -0x2000).view(torch.float32)


class Arith:
    """The working precision: float64, or float32 with TF32 contractions."""

    def __init__(self, precision: str):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision={precision!r}: float64 or tf32")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def _r(self, x):
        return round_tf32(x) if self.tf32 else x

    def mm(self, a, b):
        return self._r(a) @ self._r(b)

    def einsum(self, spec, *ops):
        return torch.einsum(spec, *(self._r(x) for x in ops))


@dataclass
class Iteration:
    initial_cost: float
    final_cost: float
    num_correspondences: int
    lm_iterations: int


@dataclass
class Result:
    transform: np.ndarray
    iterations: List[Iteration] = field(default_factory=list)


# --- search -------------------------------------------------------------------


class Target:
    """A target cloud sorted by x, centred on its bounding box's midpoint
    (which keeps the distance expansion's cancellation small)."""

    def __init__(self, points: np.ndarray, ar: Arith, device):
        pts = np.asarray(points, dtype=np.float64)
        self.center = 0.5 * (pts.min(0) + pts.max(0))
        order = np.argsort(pts[:, 0], kind="stable")
        self.order = torch.as_tensor(order, device=device)
        self.xyz = torch.as_tensor(pts[order] - self.center, dtype=ar.dtype, device=device)
        self.x = self.xyz[:, 0].contiguous()
        self.sq = (self.xyz * self.xyz).sum(-1)


def radius_knn(moved: torch.Tensor, target: Target, k: int, radius: float, ar: Arith,
               block: int = 4096):
    """For each row of ``moved`` (in the caller's frame), up to ``k`` nearest
    targets within ``radius``: (indices into the caller's target (N, k),
    squared distances (N, k), mask (N, k), in-radius counts (N,)).

    Rows are taken in x order, a block at a time, against the slab of
    targets whose x lies within ``radius`` of the block's x range."""
    dev = moved.device
    n = moved.shape[0]
    src = moved - torch.as_tensor(target.center, dtype=moved.dtype, device=dev)
    order = torch.argsort(src[:, 0], stable=True)
    src = src[order]
    r2 = radius * radius
    idx = torch.zeros((n, k), dtype=torch.long, device=dev)
    d2 = torch.full((n, k), math.inf, dtype=moved.dtype, device=dev)
    counts = torch.zeros(n, dtype=torch.long, device=dev)
    for s in range(0, n, block):
        rows = src[s:s + block]
        lo_hi = torch.stack([rows[0, 0] - radius, rows[-1, 0] + radius])
        lo, hi = torch.searchsorted(target.x, lo_hi.to(target.x.dtype)).tolist()
        if hi <= lo:
            continue
        cand = target.xyz[lo:hi]
        dist = ((rows * rows).sum(-1, keepdim=True) + target.sq[None, lo:hi]
                - 2.0 * ar.mm(rows, cand.T)).clamp_min(0.0)
        inside = dist <= r2
        counts[s:s + rows.shape[0]] = inside.sum(-1)
        dist = torch.where(inside, dist, math.inf)
        kk = min(k, hi - lo)
        best, arg = torch.topk(dist, kk, dim=-1, largest=False, sorted=True)
        d2[s:s + rows.shape[0], :kk] = best
        idx[s:s + rows.shape[0], :kk] = target.order[lo + arg]
    mask = torch.isfinite(d2)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    return idx[inv], d2[inv], mask[inv], counts[inv]


# --- inner solve ----------------------------------------------------------------


def rotation(q: torch.Tensor) -> torch.Tensor:
    """The rotation matrix of the unit quaternion q / |q| (w, x, y, z)."""
    w, x, y, z = q / torch.linalg.vector_norm(q)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def em_weights(e2: torch.Tensor, mask: torch.Tensor, dof: float, dim: int = 3):
    """Posterior association weights of one E-step: the row softmax of each
    slot's log-likelihood, times the t-distribution's expected precision."""
    if math.isinf(dof):
        logp = -0.5 * e2
        scale = 1.0
    else:
        logp = -0.5 * (dof + dim) * torch.log1p(e2 / dof)
        scale = (dof + dim) / (dof + e2)
    logp = torch.where(mask, logp, -math.inf)
    lse = torch.logsumexp(logp, dim=-1, keepdim=True)
    return torch.where(mask, torch.exp(logp - lse), 0.0) * scale


def _ratio(a: float, b: float) -> float:
    return a / b if b != 0 and math.isfinite(b) else -math.inf


def _cost(q, t, src, tgt, w, ar):
    res = tgt - (ar.mm(src, rotation(q).T) + t)[:, None, :]
    return 0.5 * torch.sum(w * (res * res).sum(-1))


def lm_solve(src, tgt, mask, cfg: dict, ar: Arith):
    """One inner solve from the identity: (q (4,), t (3,), initial cost,
    final cost, LM iterations), the LM on Ceres's rules."""
    dev, dt = src.device, ar.dtype
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dt, device=dev)
    t = torch.zeros(3, dtype=dt, device=dev)
    dof = float(cfg["dof"])
    ftol, xtol = float(cfg["function_tolerance"]), 1e-8
    radius, decrease = float(cfg["initial_trust_region_radius"]), 2.0
    min_diag, max_diag = float(cfg["min_lm_diagonal"]), float(cfg["max_lm_diagonal"])
    min_rel = float(cfg["min_relative_decrease"])
    nonmonotonic = bool(cfg["use_nonmonotonic_steps"])
    max_iter = int(cfg["max_inner_iterations"])

    def estep(q, t):
        res = tgt - (ar.mm(src, rotation(q).T) + t)[:, None, :]
        e2 = (res * res).sum(-1)
        w = em_weights(e2, mask, dof)
        return res, w, 0.5 * torch.sum(w * e2)

    initial = float(estep(q, t)[2])
    minimum = reference = candidate = initial
    acc_ref = acc_cand = 0.0
    n_nm = 0
    cost = initial
    it = 0
    while it < max_iter:
        res, w, c = estep(q, t)
        cost = float(c)
        dR = torch.autograd.functional.jacobian(rotation, q)  # (3, 3, 4)
        jq = ar.einsum("cda,nd->nca", dR, src)  # d(R x_i)/dq, (N, 3, 4)
        sw = w.sum(-1)
        m = (w[..., None] * res).sum(1)  # (N, 3)
        h_qq = ar.einsum("n,nca,ncb->ab", sw, jq, jq)
        h_qt = ar.einsum("n,nca->ac", sw, jq)
        H = torch.zeros((7, 7), dtype=torch.float64)
        H[:4, :4] = h_qq.double().cpu()
        H[:4, 4:] = h_qt.double().cpu()
        H[4:, :4] = h_qt.double().cpu().T
        H[4:, 4:] = torch.eye(3, dtype=torch.float64) * float(sw.sum())
        g = -torch.cat([ar.einsum("nca,nc->a", jq, m), m.sum(0)]).double().cpu()
        H, g = H.numpy(), g.numpy()
        diag = np.clip(np.diag(H), min_diag, max_diag)
        try:
            delta = np.linalg.solve(H + np.diag(diag / radius), -g)
        except np.linalg.LinAlgError:
            delta = np.full(7, np.nan)
        finite = bool(np.all(np.isfinite(delta)))
        if not finite:
            delta = np.zeros(7)
        x = np.concatenate([q.double().cpu().numpy(), t.double().cpu().numpy()])
        xn = x + delta
        q_new = torch.as_tensor(xn[:4], dtype=dt, device=dev)
        t_new = torch.as_tensor(xn[4:], dtype=dt, device=dev)
        cand = float(_cost(q_new, t_new, src, tgt, w, ar))
        change = cost - cand
        model = -(g @ delta + 0.5 * delta @ H @ delta)
        ok = finite and model > 0 and math.isfinite(cand)
        rel = _ratio(change, model)
        quality = max(rel, _ratio(reference - cand, acc_ref + model)) if nonmonotonic else rel
        accepted = ok and quality > min_rel
        if accepted:
            radius = min(radius / max(1.0 - (2.0 * quality - 1.0) ** 3, 1.0 / 3.0), _MAX_RADIUS)
            decrease = 2.0
            new_cost = cand
            if new_cost < minimum:
                minimum, n_nm = new_cost, 0
                improved = True
            else:
                n_nm += 1
                improved = False
            if improved or new_cost > candidate:
                candidate, acc_cand = new_cost, 0.0
            else:
                acc_cand += model
            if n_nm == _MAX_NONMONOTONIC:
                reference, acc_ref = candidate, acc_cand
            else:
                acc_ref += model
            q, t = q_new, t_new
        else:
            radius /= decrease
            decrease *= 2.0
            new_cost = cost
        it += 1
        cost = new_cost
        ftol_hit = accepted and abs(change) <= ftol * float(c)
        xtol_hit = finite and np.linalg.norm(delta) <= xtol * (np.linalg.norm(x) + xtol)
        if ftol_hit or xtol_hit or radius < _MIN_RADIUS or not math.isfinite(new_cost):
            break
    return q, t, initial, cost, it


# --- outer loop -----------------------------------------------------------------


def _se3(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = rotation(torch.as_tensor(q, dtype=torch.float64)).numpy()
    m[:3, 3] = t
    return m


def register(source: np.ndarray, target: np.ndarray, cfg: dict, *,
             precision: str = "float64", device="cpu") -> Result:
    """Align ``source`` onto ``target`` with the parameters ``cfg`` (the
    configuration's ``params`` with the traffic's stopping rule: ``n_iter``,
    ``cost_drop_thresh``, ``n_cost_drop_it``)."""
    ar = Arith(precision)
    tgt_np = np.asarray(target, dtype=np.float64)
    tgt = Target(tgt_np, ar, device)
    tgt_raw = torch.as_tensor(tgt_np, dtype=ar.dtype, device=device)
    src = torch.as_tensor(np.asarray(source, dtype=np.float64), dtype=ar.dtype, device=device)
    k, radius = int(cfg["max_neighbours"]), float(cfg["radius"])
    n_iter, thresh = int(cfg["n_iter"]), float(cfg["cost_drop_thresh"])
    n_drop = int(cfg.get("n_cost_drop_it", 5))
    result = Result(transform=np.eye(4))
    cost_drop, unuseful = 0.0, 0
    while len(result.iterations) < n_iter:
        if cost_drop < thresh:
            if unuseful > n_drop:
                break
            unuseful += 1
        else:
            unuseful = 0
        cum = result.transform
        rot = torch.as_tensor(cum[:3, :3], dtype=ar.dtype, device=device)
        moved = ar.mm(src, rot.T) + torch.as_tensor(cum[:3, 3], dtype=ar.dtype, device=device)
        idx, _, mask, _ = radius_knn(moved, tgt, k, radius, ar)
        q, t, ic, fc, n_lm = lm_solve(moved, tgt_raw[idx], mask, cfg, ar)
        qd = q.double().cpu().numpy()
        result.transform = _se3(qd / np.linalg.norm(qd), t.double().cpu().numpy()) @ cum
        result.iterations.append(Iteration(ic, fc, int(mask.sum()), n_lm))
        cost_drop = (ic - fc) / ic if ic else 0.0
    return result


def in_radius_counts(source: np.ndarray, target: np.ndarray, radius: float,
                     device="cpu") -> np.ndarray:
    """Per source row, the number of targets within ``radius`` (float64)."""
    ar = Arith("float64")
    tgt = Target(target, ar, device)
    src = torch.as_tensor(np.asarray(source, dtype=np.float64), device=device)
    return radius_knn(src, tgt, 1, radius, ar)[3].cpu().numpy()
