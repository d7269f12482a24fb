"""Pose-graph optimization over relative-pose constraints (port of the JAX
package's ``models/pose_graph.py``).

Poses are nodes, odometry pairs and loop closures are edges with
relative-SE(3) measurements, and the maximum-likelihood trajectory is found
by damped Gauss-Newton; pose 0 is held fixed (gauge). The reference has no
multi-scan machinery: its durable outputs are per pair only
(src/prob_point_cloud_registration_ex.cc:161-183).

Residual (per edge (i, j) with measurement T_ij): r = [2 * vec(q_err),
t_err] * sqrt(w), where q_err is the quaternion of T_ij^{-1} (P_i^{-1} P_j)
(small-angle: 2*vec ~ rotation vector) and t_err its translation.

Design for a GPU. The JAX package solves each Gauss-Newton step matrix-free
by conjugate gradients, with every Hessian-vector product one JVP and one
VJP through the residual function, which XLA fuses into a few kernels. The
same in eager PyTorch would be hundreds of small launches per CG iteration.
Here each edge's (6, 12) Jacobian is built once per GN step in closed form
(``_edge_jacobians``; the JAX package's block-Jacobi preconditioner takes
the same per-edge Jacobian with ``jacfwd``), and J^T J v is applied as
gathers, batched products and ``index_add_``. It is the same linear operator, so results agree with the
JAX package to rounding. CG runs ``cg_iterations`` fixed-shape steps whose
carries freeze (``torch.where``) once the residual test fails, which equals
the JAX package's ``while_loop``; the host reads ``done`` once per GN step.
Everything is computed in the dtype of the inputs (float64 from the numpy
wrapper).

Edge-sharded (``PoseGraphConfig.axis_name``, :func:`make_sharded_pose_graph_solver`):
every rank holds every pose and a block of the edges; the cost, J^T r, the
preconditioner's blocks and each CG matrix-vector product's J^T J v are
summed across the mesh axis (``Mesh.psum``), so every rank steps the same
poses and reads the same ``done``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.se3 import (
    np_matrix_to_quat,
    quat_conjugate,
    quat_multiply,
    quat_normalize,
    quat_to_matrix,
    unit_quat_rotate,
)
from ..utils.device import resolve_device

class PoseGraphConfig(NamedTuple):
    max_iterations: int = 20
    cg_iterations: int = 50
    damping: float = 1e-6
    tolerance: float = 1e-10  # relative cost-change stop
    axis_name: Optional[str] = None  # mesh axis the edges are sharded over
    # Block-Jacobi PCG: precondition each CG solve with the inverted 6x6
    # diagonal blocks of J^T J + damping*I. Any SPD preconditioner leaves
    # the solution unchanged; on a drifted loop the same CG budget gets
    # closer to the GN step's solution.
    precondition: bool = True


def _exp_quat(w):
    """Rotation-vector -> quaternion (w, x, y, z); small-angle safe."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp_min(theta2, 1e-30))
    half = 0.5 * theta
    small = theta2 < 1e-12
    sinc = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return torch.cat(
        [torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half)), w * sinc], dim=-1)


def _retract(base_q, base_t, delta):
    """Left-multiplicative retraction: (exp(dw), dt) applied to each pose."""
    dq = _exp_quat(delta[:, :3])
    q = quat_multiply(dq, base_q)
    t = unit_quat_rotate(dq, base_t) + delta[:, 3:]
    return q, t


def _pair_residuals(qi, ti, qj, tj, rel_q_inv, rel_t, sqrt_w):
    """(E, 6) weighted residuals of T_ij^{-1} (P_i^{-1} P_j), per edge's
    two poses."""
    qi_inv = quat_conjugate(qi)
    # P_i^{-1} P_j
    q_ij = quat_multiply(qi_inv, qj)
    t_ij = unit_quat_rotate(qi_inv, tj - ti)
    # T_meas^{-1} * (P_i^{-1} P_j)
    q_err = quat_multiply(rel_q_inv, q_ij)
    t_err = unit_quat_rotate(rel_q_inv, t_ij) + rel_t
    # Sign-fix the double cover so the residual is continuous at identity.
    q_err = torch.where(q_err[:, :1] < 0, -q_err, q_err)
    r = torch.cat([2.0 * q_err[:, 1:], t_err], dim=-1)
    return r * sqrt_w[:, None]


def _edge_residuals(q, t, edges_i, edges_j, rel_q_inv, rel_t, sqrt_w):
    """(E, 6) weighted residuals of every edge."""
    return _pair_residuals(q[edges_i], t[edges_i], q[edges_j], t[edges_j],
                           rel_q_inv, rel_t, sqrt_w)


def _skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrices: skew(a) @ b = a x b."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def _edge_jacobians(q, t, edges_i, edges_j, rel_q_inv, rel_t, sqrt_w):
    """Each edge's residual Jacobian at delta = 0 (the retraction's
    derivative at the identity, the JAX package's ``jacfwd`` in
    ``_block_jacobi_blocks``, pose_graph.py:137-170) as (A, B), (E, 6, 6)
    each: d r_e / d delta_i and d r_e / d delta_j.

    Closed form, in tensor ops (automatic differentiation would pull in
    ``torch._dynamo`` at its first use, seconds of imports per process).
    With q_A = T_ij^{-1}'s rotation times P_i^{-1}'s, R_A its matrix and
    q_err = [w, v] sign-fixed, a left step (dw, dv) of P_j moves
    2 vec(q_err) by (w I - [v]x) R_A dw and the translation error by
    R_A (dv - [t_j]x dw); a step of P_i moves both by the opposite:
    B = sqrt(w) [[(w I - [v]x) R_A, 0], [-R_A [t_j]x, R_A]], A = -B.
    ``rel_t`` is unused: the residual's translation offset has no
    derivative."""
    qa = quat_multiply(rel_q_inv, quat_conjugate(q[edges_i]))
    q_err = quat_multiply(qa, q[edges_j])
    q_err = torch.where(q_err[:, :1] < 0, -q_err, q_err)
    r_a = quat_to_matrix(qa)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    rot = (q_err[:, :1, None] * eye - _skew(q_err[:, 1:])) @ r_a
    top = torch.cat([rot, torch.zeros_like(rot)], dim=2)
    bottom = torch.cat([-r_a @ _skew(t[edges_j]), r_a], dim=2)
    b = torch.cat([top, bottom], dim=1) * sqrt_w[:, None, None]
    return -b, b


def _gauge(delta):
    """Pose 0's update held at zero."""
    return torch.cat([torch.zeros_like(delta[:1]), delta[1:]])


def _jt(a, b, edges_i, edges_j, r, n_poses: int, reduce=None):
    """J^T r for per-edge residual vectors r (E, 6): (P, 6); ``reduce``
    sums it over the ranks that hold the other edges."""
    out = torch.zeros((n_poses, 6), dtype=r.dtype, device=r.device)
    out.index_add_(0, edges_i, torch.bmm(a.transpose(1, 2), r[:, :, None])[:, :, 0])
    out.index_add_(0, edges_j, torch.bmm(b.transpose(1, 2), r[:, :, None])[:, :, 0])
    return out if reduce is None else reduce(out)


def _jtj_matvec(a, b, edges_i, edges_j, v, damping: float, reduce=None):
    """(J^T J + damping I) v with pose 0 gauge-fixed, J the stacked edge
    Jacobians: the JAX package's JVP + VJP product (pose_graph.py:207-220)
    as gathers, batched products and scatter-adds."""
    g = _gauge(v)
    jv = (torch.bmm(a, g[edges_i][:, :, None]) + torch.bmm(b, g[edges_j][:, :, None]))[:, :, 0]
    return _gauge(_jt(a, b, edges_i, edges_j, jv, v.shape[0], reduce)) + damping * v


def _conjugate_gradient(matvec, b, maxiter: int, rtol: float = 1e-5, precond=None):
    """(Preconditioned) CG as ``maxiter`` fixed-shape steps with scipy-style
    rtol stopping: once the true residual's squared norm is at or under
    tol2, every carry keeps its value (``torch.where``), so the result is
    the JAX package's ``while_loop`` (pose_graph.py:97-134) and more steps
    change nothing."""
    tol2 = (rtol * torch.sqrt(torch.sum(b * b))) ** 2
    apply_m = precond if precond is not None else (lambda x: x)
    z0 = apply_m(b)
    x, r, p = torch.zeros_like(b), b, z0
    rz, rs = torch.sum(b * z0), torch.sum(b * b)
    for _ in range(maxiter):
        active = rs > tol2
        ap = matvec(p)
        alpha = rz / torch.sum(p * ap)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        z = apply_m(r_new)
        rz_new = torch.sum(r_new * z)
        p_new = z + (rz_new / rz) * p
        x, r, p = (torch.where(active, new, old)
                   for new, old in ((x_new, x), (r_new, r), (p_new, p)))
        rz = torch.where(active, rz_new, rz)
        rs = torch.where(active, torch.sum(r_new * r_new), rs)
    return x


def optimize_pose_graph_qt(
    base_q,
    base_t,
    edges_i,
    edges_j,
    rel_q,
    rel_t,
    weights,
    config: PoseGraphConfig,
    stats: Optional[dict] = None,
    mesh=None,
):
    """Gauss-Newton pose-graph solve on (P, 4)+(P, 3) pose tensors, on their
    device and in their dtype.

    Returns (q (P,4), t (P,3), final_cost). Pose 0 is gauge-fixed. When a
    ``stats`` dict is given, it receives ``gn_iterations`` (GN steps
    taken). With ``config.axis_name`` the edge arrays are this rank's block
    and ``mesh`` (a ``parallel.Mesh``) sums over that axis.
    """
    reduce = None
    if config.axis_name is not None:
        if mesh is None:
            raise ValueError(
                f"PoseGraphConfig.axis_name={config.axis_name!r}: the sharded solve needs "
                "the Mesh (make_sharded_pose_graph_solver)")
        axis = config.axis_name

        def reduce(x):
            return mesh.psum(x, axis)

    def psum(x):
        return x if reduce is None else reduce(x)

    n_poses = base_q.shape[0]
    edges_i, edges_j = edges_i.long(), edges_j.long()
    rel_q_inv = quat_conjugate(quat_normalize(rel_q))
    # Precompute measurement translation term: -R_meas^{-1} t_meas.
    rel_t_term = -unit_quat_rotate(rel_q_inv, rel_t)
    sqrt_w = torch.sqrt(weights)
    edge_args = (edges_i, edges_j, rel_q_inv, rel_t_term, sqrt_w)

    def total_cost(q, t):
        r = _edge_residuals(q, t, *edge_args)
        return 0.5 * psum(torch.sum(r * r))

    q, t = base_q, base_t
    cost = total_cost(q, t)
    it = 0
    eye = torch.eye(6, dtype=q.dtype, device=q.device)
    while it < config.max_iterations:
        zero = torch.zeros((n_poses, 6), dtype=q.dtype, device=q.device)
        r0 = _edge_residuals(*_retract(q, t, zero), *edge_args)
        a, b = _edge_jacobians(q, t, *edge_args)
        g = _gauge(_jt(a, b, edges_i, edges_j, r0, n_poses, reduce))  # J^T r
        precond = None
        if config.precondition:
            blocks = torch.zeros((n_poses, 6, 6), dtype=q.dtype, device=q.device)
            blocks.index_add_(0, edges_i, a.transpose(1, 2) @ a)
            blocks.index_add_(0, edges_j, b.transpose(1, 2) @ b)
            m_inv = torch.linalg.inv(psum(blocks) + config.damping * eye)  # SPD by construction

            def precond(v):
                return torch.bmm(m_inv, v[:, :, None])[:, :, 0]

        delta = _conjugate_gradient(
            lambda v: _jtj_matvec(a, b, edges_i, edges_j, v, config.damping, reduce),
            -g, config.cg_iterations, precond=precond,
        )
        q_new, t_new = _retract(q, t, _gauge(delta))
        q_new = quat_normalize(q_new)
        new_cost = total_cost(q_new, t_new)
        improved = new_cost < cost
        q = torch.where(improved, q_new, q)
        t = torch.where(improved, t_new, t)
        cost_next = torch.where(improved, new_cost, cost)
        rel_change = torch.abs(cost - cost_next) / torch.clamp_min(cost, 1e-30)
        done = (~improved) | (rel_change < config.tolerance)
        cost = cost_next
        it += 1
        if bool(done):  # one read per GN step
            break
    if stats is not None:
        stats["gn_iterations"] = it
    return q, t, cost


def optimize_pose_graph(
    poses: Sequence[np.ndarray],
    edges: Sequence[Tuple[int, int, np.ndarray]],
    *,
    weights: Optional[Sequence[float]] = None,
    config: PoseGraphConfig = PoseGraphConfig(),
    device="cuda",
    stats: Optional[dict] = None,
    mesh=None,
) -> Tuple[list, float]:
    """Numpy-facing wrapper: 4x4 poses + (i, j, T_ij 4x4) edges, solved in
    float64 on ``device``.

    Returns (refined 4x4 poses, final cost). Pose 0 is held fixed (gauge).
    With a ``mesh`` (``parallel.Mesh``, on its device) the edges are
    sharded over its ``"points"`` axis: padded to a multiple of the axis
    with zero-weight edges (pose 0 to itself, which add exact zeros), and
    each rank solves on its block (:func:`make_sharded_pose_graph_solver`).
    """
    edges, weights = list(edges), None if weights is None else list(weights)
    if mesh is not None:
        from ..parallel.mesh import POINTS_AXIS

        n_pad = (-len(edges)) % mesh.shape[POINTS_AXIS]
        weights = ([1.0] * len(edges) if weights is None else weights) + [0.0] * n_pad
        edges = edges + [(0, 0, np.eye(4))] * n_pad
        per = len(edges) // mesh.shape[POINTS_AXIS]
        mine = slice(mesh.index(POINTS_AXIS) * per, (mesh.index(POINTS_AXIS) + 1) * per)
        edges, weights = edges[mine], weights[mine]
        config = config._replace(axis_name=POINTS_AXIS)
        device = mesh.device
    dev = resolve_device(device)

    def put(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    base_q = put(np.stack([np_matrix_to_quat(p[:3, :3]) for p in poses]))
    base_t = put(np.stack([np.asarray(p, np.float64)[:3, 3] for p in poses]))
    ei = put(np.array([e[0] for e in edges], dtype=np.int64), torch.int64)
    ej = put(np.array([e[1] for e in edges], dtype=np.int64), torch.int64)
    rq = put(np.stack([np_matrix_to_quat(e[2][:3, :3]) for e in edges]))
    rt = put(np.stack([np.asarray(e[2], np.float64)[:3, 3] for e in edges]))
    w = put(np.ones(len(edges)) if weights is None else np.asarray(weights, np.float64))

    q, t, cost = optimize_pose_graph_qt(base_q, base_t, ei, ej, rq, rt, w, config, stats,
                                        mesh=mesh)
    rot = quat_to_matrix(q).cpu().numpy()
    t = t.cpu().numpy()
    out = []
    for k in range(rot.shape[0]):
        m = np.eye(4)
        m[:3, :3] = rot[k]
        m[:3, 3] = t[k]
        out.append(m)
    return out, float(cost)


def odometry_edges(relative_transforms: Sequence[np.ndarray], weight: float = 1.0):
    """Chain edges (k, k+1, T_rel_k) from an odometry run
    (models/odometry.py's relative_transforms)."""
    return [
        (k, k + 1, np.asarray(t, dtype=np.float64))
        for k, t in enumerate(relative_transforms)
    ]


def make_sharded_pose_graph_solver(mesh, config: PoseGraphConfig = PoseGraphConfig()):
    """Edge-sharded pose-graph solve over the mesh's ``"points"`` axis:

      solve(base_q, base_t, ei, ej, rq, rt, w) -> (q, t, final_cost)

    Every rank passes every pose and its own block of the edges (rank p of
    the axis the p-th of equal contiguous blocks, as ``shard_rows`` cuts
    them); the result is the same on every rank.
    """
    from ..parallel.mesh import POINTS_AXIS

    cfg = config._replace(axis_name=POINTS_AXIS)

    def solve(base_q, base_t, ei, ej, rq, rt, w, stats: Optional[dict] = None):
        return optimize_pose_graph_qt(base_q, base_t, ei, ej, rq, rt, w, cfg, stats, mesh=mesh)

    return solve
