"""Inner EM solve: weighted nonlinear least squares on SE(3) (port of the
JAX package's ``models/em_lm.py``, moments form).

Replaces the reference's Ceres problem
(prob_point_cloud_registration_iteration.hpp:21-78): one residual block per
correspondence, shared (quaternion[4], translation[3]) parameters, and
per-term weights refreshed by an EM E-step after *every* Levenberg-Marquardt
iteration (weight_updater_callback.hpp:36-63).

The residual r_ij = y_j - (R(q) x_i + t) is linear in the source point, so
the whole LM step (7x7 normal equations, gradient, current cost, and the
trial iterate's candidate cost) reduces to 26 weighted moment scalars
(`_Moments`) taken in ONE pass over the (N, K) table per LM iteration.

Levenberg-Marquardt trust-region dynamics mirror Ceres defaults, with the
nonmonotonic (Conn-Gould-Toint) step acceptance the reference enables
(src/prob_point_cloud_registration.cc:90). As in the JAX package, when the
E-step changes the weights the current cost is re-evaluated under the new
weights (Ceres keeps a stale cached cost).

The JAX package runs the solve in one ``lax.while_loop``. Here the loop's
body is one fixed-shape step on device tensors, :func:`lm_step`, with no
Python branch on a tensor value; its state freezes once ``done`` is set or
``max_iterations`` steps have run, so that extra steps change nothing.
:func:`em_lm_solve` runs it in blocks of ``LM_BLOCK`` steps and reads
``done`` and the counters once a block, in one small device-to-host copy.
On a CUDA device a registration's :class:`LMBlocks` captures the step as a
CUDA graph once per input shape and replays it. On the CPU the step runs
eagerly in blocks of one: a read costs nothing there, and a frozen step a
whole E-step.

A leading pair axis (``parallel/batch.py``, the JAX package's ``vmap`` of
the solve): every function here also takes ``(B, N, ...)`` inputs with
``(B, 4)`` / ``(B, 3)`` iterates and ``(B,)`` flags; a pair that is done
freezes bit for bit while the others step, and a block read ends when every
pair is finished. The E-step runs pair by pair on each pair's own rows and
the O(1) step math as elementwise products and trailing sums, so that a
pair's result does not depend on the batch it is in (it need not round as
the single solve, which calls BLAS there); the single solve runs exactly
the operations it ran before.

Multi-device (``parallel/``): with ``LMConfig.axis_name`` set, the source
rows are sharded over that mesh axis (or tuple of axes) and the E-step's 26
moment scalars are summed across it by one ``all_reduce`` per E-step
(``parallel.mesh.Mesh.psum``, the JAX package's ``lax.psum``), so every rank
steps the same iterate. The solve is then given the :class:`~..parallel.mesh.Mesh`
explicitly (``mesh=``); without an axis nothing changes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.se3 import quat_rotate, quat_rotate_points
from ..ops.weights import update_weights
from ..utils import spans

_MAX_TRUST_REGION_RADIUS = 1e16
_MIN_TRUST_REGION_RADIUS = 1e-32
_MAX_CONSECUTIVE_NONMONOTONIC_STEPS = 5
# LM steps per block on a CUDA device, between two reads of ``done``.
# Chosen on the card among 4, 8, 16 and max_iterations (PERF.md, section
# 6): a frozen step costs as much device time as a live one, a read costs
# a host round trip, and the bench pairs' solves take 2-3 steps.
LM_BLOCK = 4


class LMConfig(NamedTuple):
    """Solver configuration (the Ceres options the reference sets at
    src/prob_point_cloud_registration.cc:88-99)."""

    dof: float = 5.0
    dimension: int = 3
    function_tolerance: float = 1e-5
    # Ceres's parameter_tolerance default: stop when a step moves the
    # iterate by less than xtol * (|x| + xtol).
    parameter_tolerance: float = 1e-8
    max_iterations: int = 100
    initial_radius: float = 1e4
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    min_relative_decrease: float = 1e-3
    use_nonmonotonic_steps: bool = True
    # Mesh axis (or tuple of axes) the source rows are sharded over; the
    # solve then reduces its moments over it through the Mesh it is given.
    axis_name: str | tuple | None = None
    # Record per-LM-iteration (cost, step_quality, radius, accepted) into
    # LMResult.trace, the analogue of the rows of Ceres's
    # ``summary.FullReport()`` (src/prob_point_cloud_registration.cc:108).
    # The buffer is (max_iterations, 4) of carried state, (0, 4) when off.
    trace: bool = False


class LMState(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    cost: torch.Tensor
    radius: torch.Tensor
    decrease_factor: torch.Tensor
    iteration: torch.Tensor
    num_successful: torch.Tensor
    done: torch.Tensor
    # Nonmonotonic (Conn-Gould-Toint) bookkeeping.
    minimum_cost: torch.Tensor
    reference_cost: torch.Tensor
    candidate_cost: torch.Tensor
    acc_reference_mcc: torch.Tensor
    acc_candidate_mcc: torch.Tensor
    num_nonmonotonic: torch.Tensor
    # (max_iterations, 4) rows [cost, step_quality, radius, accepted] when
    # LMConfig.trace, else (0, 4).
    trace: torch.Tensor


class LMResult(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    num_iterations: torch.Tensor  # 0-d int32
    num_successful_steps: torch.Tensor  # 0-d int32
    # Per-LM-iteration [cost, step_quality, radius, accepted]; (0, 4) unless
    # LMConfig.trace. Rows beyond num_iterations are zeros.
    trace: torch.Tensor


def _residuals(q, t, source, targets):
    """r_ij = y_ij - (R(q) x_i + t); source (N,3), targets (N,K,3)."""
    moved = quat_rotate_points(q, source) + t
    return targets - moved[:, None, :]


# The pair axis. Each helper runs the single solve's own operation on
# unbatched operands. With a leading pair axis it computes the same
# contraction as elementwise products and one sum over the trailing,
# contiguous contracted axes: no BLAS call, whose algorithm may change with
# the batch, so that a pair's value does not depend on the batch it is in.


def _contract(spec: str, *ops):
    """``torch.einsum(spec, *ops)`` for operands with a leading pair axis
    (small operands: the full product is formed)."""
    ins, out = spec.split("->")
    ins = ins.split(",")
    summed = "".join(sorted(set("".join(ins)) - set(out)))
    order = out + summed
    prod = None
    for letters, op in zip(ins, ops):
        present = sorted(letters, key=order.index)
        x = op.permute(0, *(1 + letters.index(c) for c in present))
        x = x.reshape(x.shape[:1] + tuple(
            x.shape[1 + present.index(c)] if c in letters else 1 for c in order))
        prod = x if prod is None else prod * x
    return prod.flatten(-len(summed)).sum(-1) if summed else prod


def _vdot(a, b):
    """a . b over the last axis."""
    return a @ b if a.dim() == 1 else _contract("i,i->", a, b)


def _mv(m, v):
    """m @ v for a matrix m."""
    return m @ v if m.dim() == 2 else _contract("ij,j->i", m, v)


def _einsum(spec: str, *ops):
    """``torch.einsum(spec, *ops)``, with a leading pair axis on every
    operand and the output when the first operand has one."""
    if ops[0].dim() == len(spec.split(",")[0]):
        return torch.einsum(spec, *ops)
    return _contract(spec, *ops)


def _sum_last(x, n: int):
    """Sum over the last ``n`` axes (the whole tensor when unbatched)."""
    return torch.sum(x) if x.dim() == n else torch.sum(x, dim=tuple(range(-n, 0)))


def _pairwise(flag, x):
    """``flag`` (one per pair) broadcast against ``x``'s trailing axes."""
    return flag.reshape(flag.shape + (1,) * (x.dim() - flag.dim()))


class _Moments(NamedTuple):
    """Sufficient statistics of one E-step pass over the (N, K) table."""

    m0: torch.Tensor   # sum_i sw_i                      (scalar)
    m1: torch.Tensor   # sum_i sw_i x_i                  (3,)
    m2: torch.Tensor   # sum_i sw_i x_i x_i^T            (3, 3)
    sm: torch.Tensor   # sum_i m_i                       (3,)
    smx: torch.Tensor  # sum_i m_i x_i^T                 (3, 3)
    cost: torch.Tensor # 0.5 sum_ij w_ij |r_ij|^2        (scalar)


def _rotation_matrix(q, dtype):
    """M(q) with quat_rotate(q, x) == M(q) @ x (columns are the rotated
    basis vectors)."""
    eye = torch.eye(3, dtype=dtype, device=q.device)
    if q.dim() == 1:
        return quat_rotate(q, eye).T
    return quat_rotate(q[..., None, :], eye.expand(q.shape[:-1] + (3, 3))).transpose(-1, -2)


def _estep_moments(q, t, source, targets, mask, dof, dimension, reduce=None):
    """E-step + sufficient statistics in one (N, K) pass; ``reduce`` (a
    sum across the ranks that hold the other source rows) takes the 26
    scalars as one vector.

    With a pair axis the pass runs pair by pair on each pair's own rows,
    the single solve's operations: a sum over N x K elements splits across
    thread blocks by how many outputs it has, so a sum over the whole
    (B, N, K) table would round differently in a batch of another size.
    """
    if source.dim() == 3:
        stats = _Moments(*(torch.stack(f) for f in zip(*(
            _estep_moments(q[b], t[b], source[b], targets[b], mask[b], dof, dimension)
            for b in range(source.shape[0])))))
    else:
        r = _residuals(q, t, source, targets)  # (N, K, 3)
        e2 = torch.sum(r * r, dim=-1)
        w = update_weights(e2, mask, dof=dof, dimension=dimension)
        wm = torch.where(mask, w, 0.0)
        sw = torch.sum(wm, dim=-1)  # (N,)
        m = torch.sum(wm[..., None] * r, dim=1)  # (N, 3)
        stats = _Moments(
            m0=torch.sum(sw),
            m1=sw @ source,
            m2=torch.einsum("n,na,nb->ab", sw, source, source),
            sm=torch.sum(m, dim=0),
            smx=torch.einsum("na,nb->ab", m, source),
            cost=0.5 * torch.sum(wm * e2),
        )
    if reduce is None:
        return stats
    flat = reduce(torch.cat([x.reshape(-1) for x in stats]))
    sizes = [x.numel() for x in stats]
    return _Moments(*(part.reshape(x.shape)
                      for part, x in zip(torch.split(flat, sizes), stats)))


def _reducer(config: "LMConfig", mesh):
    """The moments' cross-rank sum for ``config.axis_name`` (None without
    an axis)."""
    if config.axis_name is None:
        return None
    if mesh is None:
        raise ValueError(
            f"LMConfig.axis_name={config.axis_name!r}: the solve needs the Mesh (mesh=)")
    return lambda x: mesh.psum(x, config.axis_name)


def _rotation_jacobian(q, dtype):
    """J[c,d,a] = dM(q)[c,d]/dq_a, by forward mode written out.

    The JAX package takes ``jax.jacfwd`` of ``_rotation_matrix``; this
    pushes the four unit tangents of q through the same operations: the
    normalization u = q/|q|, then the cross-product form of the rotation,
    M(q)^T e_j = e_j + 2 (w (u_v x e_j) + u_v x (u_v x e_j)). In float32 it
    matters that J differentiates exactly this form: a closed-form dR/du
    (equal in exact arithmetic) moved the float32 solve ~5e-6 away from the
    float64 one on a 6k-point pair, this form ~1e-8.
    """
    dev = q.device
    lead = q.shape[:-1]
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(lead + (4, 3, 3))
    dq = torch.eye(4, dtype=dtype, device=dev)  # the four tangents, one per row
    if q.dim() == 1:
        n = torch.linalg.vector_norm(q)
        u = q / n
        du = dq / n - u[None, :] * ((dq @ q) / (n * n))[:, None]  # (4, 4)
    else:  # per pair; dq @ q is q itself
        n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        u = q / n
        du = dq / n[..., None] - u[..., None, :] * (q / (n * n))[..., :, None]
    w, uv = u[..., 0, None, None, None], u[..., None, None, 1:].expand(lead + (4, 3, 3))
    dw, duv = du[..., :, 0, None, None], du[..., :, None, 1:].expand(lead + (4, 3, 3))
    c1 = torch.linalg.cross(uv, eye3)  # u_v x e_j, row j
    d_c1 = torch.linalg.cross(duv, eye3)
    d_mt = 2.0 * (
        dw * c1 + w * d_c1 + torch.linalg.cross(duv, c1) + torch.linalg.cross(uv, d_c1)
    )  # (..., a, j, c) = dM[c, j]/dq_a
    return d_mt.transpose(-3, -1)


def _normal_from_moments(q, stats: _Moments, dtype):
    """(H (7,7), g (7,)) from the moment statistics.

    With J[c,d,a] = dM(q)[c,d]/dq_a:
      H_qq[a,b] = J[c,d,a] J[c,e,b] m2[d,e]
      H_qt[a,b] = J[b,d,a] m1[d]
      g_q[a]    = -J[c,d,a] smx[c,d]
    """
    J = _rotation_jacobian(q, dtype)  # ([B,] 3, 3, 4)
    h_qq = _einsum("cda,ceb,de->ab", J, J, stats.m2)
    h_qt = _einsum("bda,d->ab", J, stats.m1)  # ([B,] 4, 3)
    h_tt = stats.m0[..., None, None] * torch.eye(3, dtype=dtype, device=q.device)
    H = torch.cat(
        [torch.cat([h_qq, h_qt], dim=-1), torch.cat([h_qt.transpose(-1, -2), h_tt], dim=-1)],
        dim=-2,
    )
    g = torch.cat([-_einsum("cda,cd->a", J, stats.smx), -stats.sm], dim=-1)
    return H, g


def _cost_change_from_moments(q, t, q_new, t_new, stats: _Moments, dtype):
    """cost(q,t) - cost(q_new,t_new) under the CURRENT weights, exactly:
    with d_i = (M(q_new) - M(q)) x_i + (t_new - t),
      cost_change = sum_i m_i.d_i - 0.5 sum_i sw_i |d_i|^2.
    """
    dM = _rotation_matrix(q_new, dtype) - _rotation_matrix(q, dtype)
    dmtdm = dM.T @ dM if dM.dim() == 2 else _contract("ca,cb->ab", dM, dM)
    dt = t_new - t
    dm = _sum_last(dM * stats.smx, 2) + _vdot(dt, stats.sm)
    swd2 = (
        _sum_last(dmtdm * stats.m2, 2)
        + _vdot(2.0 * dt, _mv(dM, stats.m1))
        + stats.m0 * _vdot(dt, dt)
    )
    return dm - 0.5 * swd2


def _solve_lu(a, b):
    """x with a @ x = b for a small square ``a``, or for each of a stack of
    them: LU with partial pivoting written as tensor ops, so that it needs
    no host sync and no library call and a CUDA graph can hold it (the JAX
    package calls ``jnp.linalg.solve``, LAPACK's getrf + getrs on the CPU).

    The order of operations is LAPACK's unblocked one: pivot on the first
    largest |a_ij| of the column, scale by the pivot's reciprocal, rank-1
    update (the right-hand side rides along as the last column: forward
    substitution), then column-oriented back substitution. A zero pivot
    gives a non-finite x, which the caller rejects as the reference does.
    """
    n = a.shape[-1]
    m = torch.cat([a, b[..., None]], dim=-1)
    rows = torch.arange(n, device=a.device)
    for j in range(n - 1):
        p = torch.argmax(m[..., j:, j].abs(), dim=-1, keepdim=True) + j
        swap = torch.where(rows == j, p, torch.where(rows == p, j, rows))
        m = torch.gather(m, -2, swap[..., None].expand(m.shape))
        lower = m[..., j + 1:, j] * (1.0 / m[..., j, j, None])
        m = torch.cat([m[..., : j + 1, :], m[..., j + 1:, :] - lower[..., None] * m[..., j : j + 1, :]],
                      dim=-2)
    y = m[..., n]
    x = [None] * n
    for j in reversed(range(n)):
        x[j] = y[..., j] / m[..., j, j]
        y = y[..., :j] - x[j][..., None] * m[..., :j, j]
    return torch.stack(x, dim=-1)


def lm_init(source, targets, mask, q0, t0, config: LMConfig, frozen=None, mesh=None):
    """The solve's state before its first step, and its initial cost (the
    weight callback's first E-step, iteration.hpp:49).

    ``frozen`` (a bool tensor, one per pair) starts the state done: no
    step moves it. ``mesh`` serves ``config.axis_name``. With a pair axis,
    ``q0`` / ``t0`` are (B, 4) / (B, 3).
    """
    dtype = source.dtype
    initial_cost = _estep_moments(
        q0, t0, source, targets, mask, config.dof, config.dimension,
        _reducer(config, mesh),
    ).cost
    lead = initial_cost.shape
    zero = initial_cost.new_zeros(lead)
    izero = torch.zeros(lead, dtype=torch.int32, device=source.device)
    done = torch.zeros(lead, dtype=torch.bool, device=source.device)
    state = LMState(
        q=q0.to(dtype),
        t=t0.to(dtype),
        cost=initial_cost,
        radius=initial_cost.new_full(lead, config.initial_radius),
        decrease_factor=initial_cost.new_full(lead, 2.0),
        iteration=izero,
        num_successful=izero + 1,  # Ceres counts iteration 0
        done=done if frozen is None else done | frozen,
        minimum_cost=initial_cost,
        reference_cost=initial_cost,
        candidate_cost=initial_cost,
        acc_reference_mcc=zero,
        acc_candidate_mcc=zero,
        num_nonmonotonic=izero,
        trace=initial_cost.new_zeros(
            lead + (config.max_iterations if config.trace else 0, 4)
        ),
    )
    return state, initial_cost


def lm_step(s: LMState, source, targets, mask, config: LMConfig, mesh=None) -> LMState:
    """One LM iteration (the body of the JAX package's ``while_loop``,
    models/em_lm.py:319-432 there) on a fixed-shape state. A state that is
    done, or has run ``max_iterations`` steps, comes back unchanged, bit
    for bit: every field is ``torch.where(live, new, old)``, per pair with
    a pair axis."""
    dtype = source.dtype
    live = ~s.done & (s.iteration < config.max_iterations)
    # E-step at the current iterate; everything below is O(1) in N.
    st = _estep_moments(s.q, s.t, source, targets, mask, config.dof, config.dimension,
                        _reducer(config, mesh))
    cost = st.cost
    H, g = _normal_from_moments(s.q, st, dtype)

    # Levenberg-Marquardt step: (H + diag(clamp(diag H)) / radius) d = -g,
    # solved in float64 whatever the working dtype: in float32 the LU's
    # rounding (in another order than LAPACK's) moved the kitti131k bench
    # pair's final 4x4 7.7e-6 from the JAX fixture, in float64 1.9e-6
    # (PERF.md, section 6).
    diag = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), config.min_lm_diagonal,
                       config.max_lm_diagonal)
    damped = H + torch.diag_embed(diag / s.radius[..., None])
    delta = _solve_lu(damped.double(), -g.double()).to(dtype)
    delta_finite = torch.all(torch.isfinite(delta), dim=-1)
    step_ok = delta_finite
    delta = torch.where(step_ok[..., None], delta, 0.0)

    q_new = s.q + delta[..., :4]
    t_new = s.t + delta[..., 4:]
    cost_change_fwd = _cost_change_from_moments(s.q, s.t, q_new, t_new, st, dtype)
    cand = cost - cost_change_fwd

    # Model cost change m(0) - m(delta) = -(g.d + 0.5 d^T H d).
    model_cost_change = -(_vdot(g, delta) + _vdot(0.5 * delta, _mv(H, delta)))
    step_ok = step_ok & (model_cost_change > 0) & torch.isfinite(cand)

    relative_decrease = cost_change_fwd / model_cost_change
    if config.use_nonmonotonic_steps:
        historical = (s.reference_cost - cand) / (s.acc_reference_mcc + model_cost_change)
        step_quality = torch.maximum(relative_decrease, historical)
    else:
        step_quality = relative_decrease
    accepted = step_ok & (step_quality > config.min_relative_decrease)

    # Trust-region radius update (Ceres LevenbergMarquardtStrategy).
    boost = 1.0 / torch.clamp(1.0 - (2.0 * step_quality - 1.0) ** 3, min=1.0 / 3.0)
    radius_acc = torch.clamp(s.radius * boost, max=_MAX_TRUST_REGION_RADIUS)
    radius = torch.where(accepted, radius_acc, s.radius / s.decrease_factor)
    decrease_factor = torch.where(accepted, 2.0, s.decrease_factor * 2.0)

    # Nonmonotonic bookkeeping on acceptance.
    new_cost = torch.where(accepted, cand, cost)
    improved = new_cost < s.minimum_cost
    minimum_cost = torch.where(accepted & improved, new_cost, s.minimum_cost)
    num_nm = torch.where(
        accepted, torch.where(improved, 0, s.num_nonmonotonic + 1), s.num_nonmonotonic
    ).to(torch.int32)
    reset = accepted & (improved | (new_cost > s.candidate_cost))
    candidate_cost = torch.where(reset, new_cost, s.candidate_cost)
    acc_candidate_mcc = torch.where(
        reset, 0.0,
        torch.where(accepted, s.acc_candidate_mcc + model_cost_change, s.acc_candidate_mcc),
    )
    promote = accepted & (num_nm == _MAX_CONSECUTIVE_NONMONOTONIC_STEPS)
    reference_cost = torch.where(promote, candidate_cost, s.reference_cost)
    acc_reference_mcc = torch.where(
        promote, acc_candidate_mcc,
        torch.where(accepted, s.acc_reference_mcc + model_cost_change, s.acc_reference_mcc),
    )

    # Convergence: function tolerance on accepted steps; parameter
    # tolerance on every valid step (Ceres tests the candidate x before
    # acceptance); a dead trust region; a non-finite cost.
    ftol_hit = accepted & (torch.abs(cost_change_fwd) <= config.function_tolerance * cost)
    x_norm = torch.sqrt(_vdot(s.q, s.q) + _vdot(s.t, s.t))
    xtol = config.parameter_tolerance
    xtol_hit = delta_finite & (torch.sqrt(_vdot(delta, delta)) <= xtol * (x_norm + xtol))
    done = (
        ftol_hit | xtol_hit | (radius < _MIN_TRUST_REGION_RADIUS) | ~torch.isfinite(new_cost)
    )

    trace = s.trace
    if config.trace:
        row = torch.stack([new_cost, step_quality, radius, accepted.to(dtype)], dim=-1)
        slot = torch.clamp(s.iteration, max=config.max_iterations - 1).long()
        trace = trace.scatter(-2, slot[..., None, None].expand(row.shape[:-1] + (1, 4)),
                              row[..., None, :])

    new = LMState(
        q=torch.where(accepted[..., None], q_new, s.q),
        t=torch.where(accepted[..., None], t_new, s.t),
        cost=new_cost,
        radius=radius,
        decrease_factor=decrease_factor,
        iteration=s.iteration + 1,
        num_successful=s.num_successful + accepted.to(torch.int32),
        done=done,
        minimum_cost=minimum_cost,
        reference_cost=reference_cost,
        candidate_cost=candidate_cost,
        acc_reference_mcc=acc_reference_mcc,
        acc_candidate_mcc=acc_candidate_mcc,
        num_nonmonotonic=num_nm,
        trace=trace,
    )
    return LMState(*(torch.where(_pairwise(live, a), a, b) for a, b in zip(new, s)))


def _status(s: LMState) -> torch.Tensor:
    """(done, iteration, num_successful) as one int32 tensor (3, [B]): what
    a block read brings to the host."""
    return torch.stack([s.done.to(torch.int32), s.iteration, s.num_successful])


def _result(s: LMState, initial_cost) -> LMResult:
    return LMResult(
        q=s.q, t=s.t, initial_cost=initial_cost, final_cost=s.cost,
        num_iterations=s.iteration, num_successful_steps=s.num_successful,
        trace=s.trace,
    )


def _capture(graph, fn, pool) -> None:
    """Capture ``fn``'s launches into ``graph`` on a side stream, as
    ``torch.cuda.graph`` does but without its allocator flush: emptying the
    cache at every capture would make the pair's later allocations fresh
    ``cudaMalloc`` calls. The capture forbids unsafe CUDA calls in this
    thread only: a sequence's prep thread uploads and builds the next
    pair's target while this thread captures."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin(pool, capture_error_mode="thread_local")
        try:
            fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)


class _Graphs:
    """The initial E-step and one LM step as two CUDA graphs over static
    buffers, for one input shape and configuration. Everything that passes
    from one replay to the next lives in the buffers, so the two graphs
    share one memory pool; a block replays the step graph."""

    def __init__(self, source, targets, mask, q0, t0, frozen, config: LMConfig, mesh=None):
        self.inputs = [x.clone() for x in (source, targets, mask, q0, t0, frozen)]
        src, tgt, msk = self.inputs[:3]
        # Eager warm-up on a side stream (library handles, the allocator),
        # as torch.cuda.graphs asks; its values only shape the buffers.
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            state, initial_cost = lm_init(*self.inputs[:5], config, self.inputs[5], mesh)
            state = lm_step(state, src, tgt, msk, config, mesh)
            self.state = LMState(*(x.clone() for x in state))
            self.initial_cost = initial_cost.clone()
            self.status = _status(state)
        torch.cuda.current_stream().wait_stream(side)

        def init():
            state, initial_cost = lm_init(*self.inputs[:5], config, self.inputs[5], mesh)
            self._store(state)
            self.initial_cost.copy_(initial_cost)

        def step():
            self._store(lm_step(self.state, src, tgt, msk, config, mesh))

        pool = torch.cuda.graph_pool_handle()
        self.init, self.step = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        _capture(self.init, init, pool)
        _capture(self.step, step, pool)

    def _store(self, state: LMState) -> None:
        for buf, value in zip(self.state, state):
            buf.copy_(value)
        self.status.copy_(_status(state))


class LMBlocks:
    """Runs :func:`em_lm_solve`'s blocks of ``block`` steps, eagerly or as
    CUDA graphs.

    With ``graphs``, the first solve of each input shape and configuration
    captures the initial E-step and the step into CUDA graphs over static
    buffers; every solve then copies its inputs into the buffers and
    replays them, the step ``block`` times between two reads. A capture
    costs tens of milliseconds of host time, so it pays off for a caller
    that solves many times (a registration keeps one per pair). A capture
    that fails raises; nothing falls back to eager. A solve whose
    ``config.axis_name`` reduces across ranks captures the ``all_reduce``
    too (NCCL); the eager warm-up before the first capture makes the
    communicator. A collective staged through host memory cannot be
    captured: such a caller builds its blocks with ``graphs=False``.

    :meth:`solve` returns the result and the solve's last read: (done,
    iteration, num_successful) as ints, as lists of ints with a pair axis;
    a batched solve's block read ends it when every pair is finished. A
    solve that was frozen from the start reads done with iteration 0 (a
    live step always counts).
    ``capture_seconds`` sums the host time spent capturing.
    """

    def __init__(self, graphs: bool, block: int = LM_BLOCK):
        self.graphs = graphs
        self.block = block
        self._captured: dict = {}
        self.capture_seconds = 0.0

    @classmethod
    def for_device(cls, device) -> "LMBlocks":
        """For a caller that solves many times on ``device``: CUDA graphs of
        LM_BLOCK steps on a CUDA device, eager single steps elsewhere."""
        cuda = torch.device(device).type == "cuda"
        return cls(graphs=cuda, block=LM_BLOCK if cuda else 1)

    def solve(self, source, targets, mask, q0, t0, config: LMConfig, frozen=None,
              mesh=None):
        """(LMResult, the last read (done, iteration, num_successful)).
        ``mesh`` serves ``config.axis_name``; the state is then the same on
        every rank, and so is every read."""

        def read(status):  # one device-to-host copy
            with spans.span("lm_read"):
                return tuple(status.tolist())

        def finished(status):
            done, iteration = status[0], status[1]
            if isinstance(done, list):  # a pair axis
                return all(d or i >= config.max_iterations for d, i in zip(done, iteration))
            return bool(done) or iteration >= config.max_iterations

        if not self.graphs:
            state, initial_cost = lm_init(source, targets, mask, q0, t0, config, frozen, mesh)
            status = read(_status(state)) if config.max_iterations == 0 else (0, 0, 0)
            while not finished(status):
                for _ in range(self.block):
                    state = lm_step(state, source, targets, mask, config, mesh)
                status = read(_status(state))
            return _result(state, initial_cost), status
        if frozen is None:
            frozen = torch.zeros(source.shape[:-2], dtype=torch.bool, device=source.device)
        inputs = (source, targets, mask, q0.to(source.dtype), t0.to(source.dtype), frozen)
        key = (config, id(mesh)) + tuple((x.shape, x.dtype, x.device) for x in inputs)
        graphs = self._captured.get(key)
        if graphs is None:
            with spans.span("lm_capture") as capture:
                graphs = self._captured[key] = _Graphs(*inputs, config, mesh)
            self.capture_seconds += capture.seconds
        for buf, value in zip(graphs.inputs, inputs):
            buf.copy_(value)
        graphs.init.replay()
        status = read(graphs.status) if config.max_iterations == 0 else (0, 0, 0)
        while not finished(status):
            for _ in range(self.block):
                graphs.step.replay()
            status = read(graphs.status)
        # The buffers serve the next solve: hand out copies.
        return _result(LMState(*(x.clone() for x in graphs.state)),
                       graphs.initial_cost.clone()), status


def em_lm_solve(
    source: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor,
    q0: torch.Tensor,
    t0: torch.Tensor,
    config: LMConfig,
    mesh=None,
) -> LMResult:
    """Run one full inner EM solve (the reference's ``solve()``,
    iteration.hpp:52-57), eagerly in blocks (a one-off solve gains nothing
    from a capture; a registration keeps an :class:`LMBlocks` of graphs).

    Args:
      source: (N, 3) source points (already moved by the outer loop).
      targets: (N, K, 3) gathered target neighbors per source point.
      mask: (N, K) validity of each association slot.
      q0 / t0: initial quaternion (w,x,y,z) and translation.
      config: solver configuration.
      mesh: the Mesh that ``config.axis_name`` names axes of (source rows
        sharded over them); None without an axis.
    """
    blocks = LMBlocks(graphs=False, block=LM_BLOCK if source.is_cuda else 1)
    return blocks.solve(source, targets, mask, q0, t0, config, mesh=mesh)[0]
