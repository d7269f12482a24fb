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

The JAX package runs the solve in one ``lax.while_loop``; here it is a
Python loop that reads the ``done`` flag once per LM step (one host sync per
step). The step's arithmetic stays on the device of the inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.se3 import quat_rotate, quat_rotate_points
from ..ops.weights import update_weights

_MAX_TRUST_REGION_RADIUS = 1e16
_MIN_TRUST_REGION_RADIUS = 1e-32
_MAX_CONSECUTIVE_NONMONOTONIC_STEPS = 5


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


class LMResult(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    num_iterations: int
    num_successful_steps: int


def _residuals(q, t, source, targets):
    """r_ij = y_ij - (R(q) x_i + t); source (N,3), targets (N,K,3)."""
    moved = quat_rotate_points(q, source) + t
    return targets - moved[:, None, :]


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
    return quat_rotate(q, torch.eye(3, dtype=dtype, device=q.device)).T


def _estep_moments(q, t, source, targets, mask, dof, dimension):
    """E-step + sufficient statistics in one (N, K) pass."""
    r = _residuals(q, t, source, targets)  # (N, K, 3)
    e2 = torch.sum(r * r, dim=-1)
    w = update_weights(e2, mask, dof=dof, dimension=dimension)
    wm = torch.where(mask, w, 0.0)
    sw = torch.sum(wm, dim=-1)  # (N,)
    m = torch.sum(wm[..., None] * r, dim=1)  # (N, 3)
    return _Moments(
        m0=torch.sum(sw),
        m1=sw @ source,
        m2=torch.einsum("n,na,nb->ab", sw, source, source),
        sm=torch.sum(m, dim=0),
        smx=torch.einsum("na,nb->ab", m, source),
        cost=0.5 * torch.sum(wm * e2),
    )


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
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(4, 3, 3)
    dq = torch.eye(4, dtype=dtype, device=dev)  # the four tangents, one per row
    n = torch.linalg.vector_norm(q)
    u = q / n
    du = dq / n - u[None, :] * ((dq @ q) / (n * n))[:, None]  # (4, 4)
    w, uv = u[0], u[1:].expand(4, 3, 3)
    dw, duv = du[:, 0, None, None], du[:, None, 1:].expand(4, 3, 3)
    c1 = torch.linalg.cross(uv, eye3)  # u_v x e_j, row j
    d_c1 = torch.linalg.cross(duv, eye3)
    d_mt = 2.0 * (
        dw * c1 + w * d_c1 + torch.linalg.cross(duv, c1) + torch.linalg.cross(uv, d_c1)
    )  # (a, j, c) = dM[c, j]/dq_a
    return d_mt.permute(2, 1, 0)


def _normal_from_moments(q, stats: _Moments, dtype):
    """(H (7,7), g (7,)) from the moment statistics.

    With J[c,d,a] = dM(q)[c,d]/dq_a:
      H_qq[a,b] = J[c,d,a] J[c,e,b] m2[d,e]
      H_qt[a,b] = J[b,d,a] m1[d]
      g_q[a]    = -J[c,d,a] smx[c,d]
    """
    J = _rotation_jacobian(q, dtype)  # (3, 3, 4)
    h_qq = torch.einsum("cda,ceb,de->ab", J, J, stats.m2)
    h_qt = torch.einsum("bda,d->ab", J, stats.m1)  # (4, 3)
    h_tt = stats.m0 * torch.eye(3, dtype=dtype, device=q.device)
    H = torch.cat(
        [torch.cat([h_qq, h_qt], dim=1), torch.cat([h_qt.T, h_tt], dim=1)], dim=0
    )
    g = torch.cat([-torch.einsum("cda,cd->a", J, stats.smx), -stats.sm])
    return H, g


def _cost_change_from_moments(q, t, q_new, t_new, stats: _Moments, dtype):
    """cost(q,t) - cost(q_new,t_new) under the CURRENT weights, exactly:
    with d_i = (M(q_new) - M(q)) x_i + (t_new - t),
      cost_change = sum_i m_i.d_i - 0.5 sum_i sw_i |d_i|^2.
    """
    dM = _rotation_matrix(q_new, dtype) - _rotation_matrix(q, dtype)
    dt = t_new - t
    dm = torch.sum(dM * stats.smx) + dt @ stats.sm
    swd2 = (
        torch.sum((dM.T @ dM) * stats.m2)
        + 2.0 * dt @ (dM @ stats.m1)
        + stats.m0 * (dt @ dt)
    )
    return dm - 0.5 * swd2


def em_lm_solve(
    source: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor,
    q0: torch.Tensor,
    t0: torch.Tensor,
    config: LMConfig,
) -> LMResult:
    """Run one full inner EM solve (the reference's ``solve()``,
    iteration.hpp:52-57).

    Args:
      source: (N, 3) source points (already moved by the outer loop).
      targets: (N, K, 3) gathered target neighbors per source point.
      mask: (N, K) validity of each association slot.
      q0 / t0: initial quaternion (w,x,y,z) and translation.
      config: solver configuration.
    """
    dtype = source.dtype
    dev = source.device

    def f(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    def moments(q, t):
        return _estep_moments(
            q, t, source, targets, mask, config.dof, config.dimension
        )

    q = q0.to(dtype)
    t = t0.to(dtype)
    # Initial E-step at the initial iterate (iteration.hpp:49).
    initial_cost = moments(q, t).cost
    cost = initial_cost
    radius = f(config.initial_radius)
    decrease_factor = f(2.0)
    num_successful = torch.ones((), dtype=torch.int32, device=dev)  # Ceres counts it 0
    minimum_cost = reference_cost = candidate_cost = initial_cost
    acc_reference_mcc = acc_candidate_mcc = f(0.0)
    num_nm = torch.zeros((), dtype=torch.int32, device=dev)
    one_third = f(1.0 / 3.0)
    max_radius = f(_MAX_TRUST_REGION_RADIUS)
    xtol = f(config.parameter_tolerance)

    iteration = 0
    while iteration < config.max_iterations:
        # E-step at the current iterate; everything below is O(1) in N.
        st = moments(q, t)
        cost = st.cost
        H, g = _normal_from_moments(q, st, dtype)

        # Levenberg-Marquardt step: (H + diag(clamp(diag H)) / radius) d = -g.
        diag = torch.clamp(
            torch.diagonal(H), config.min_lm_diagonal, config.max_lm_diagonal
        )
        delta, info = torch.linalg.solve_ex(H + torch.diag(diag / radius), -g)
        delta_finite = torch.all(torch.isfinite(delta)) & (info == 0)
        step_ok = delta_finite
        delta = torch.where(step_ok, delta, 0.0)

        q_new = q + delta[:4]
        t_new = t + delta[4:]
        cost_change_fwd = _cost_change_from_moments(q, t, q_new, t_new, st, dtype)
        cand = cost - cost_change_fwd

        # Model cost change m(0) - m(delta) = -(g.d + 0.5 d^T H d).
        model_cost_change = -(g @ delta + 0.5 * delta @ (H @ delta))
        step_ok = step_ok & (model_cost_change > 0) & torch.isfinite(cand)

        relative_decrease = cost_change_fwd / model_cost_change
        if config.use_nonmonotonic_steps:
            historical = (reference_cost - cand) / (
                acc_reference_mcc + model_cost_change
            )
            step_quality = torch.maximum(relative_decrease, historical)
        else:
            step_quality = relative_decrease
        accepted = step_ok & (step_quality > config.min_relative_decrease)

        # Trust-region radius update (Ceres LevenbergMarquardtStrategy).
        boost = 1.0 / torch.maximum(one_third, 1.0 - (2.0 * step_quality - 1.0) ** 3)
        radius_acc = torch.minimum(radius * boost, max_radius)
        radius = torch.where(accepted, radius_acc, radius / decrease_factor)
        decrease_factor = torch.where(accepted, 2.0, decrease_factor * 2.0)

        # Nonmonotonic bookkeeping on acceptance.
        new_cost = torch.where(accepted, cand, cost)
        acc_cand = acc_candidate_mcc + model_cost_change
        acc_ref = acc_reference_mcc + model_cost_change
        improved = new_cost < minimum_cost
        minimum_cost = torch.where(accepted & improved, new_cost, minimum_cost)
        num_nm = torch.where(
            accepted, torch.where(improved, 0, num_nm + 1), num_nm
        ).to(torch.int32)
        reset = accepted & (improved | (new_cost > candidate_cost))
        candidate_cost = torch.where(reset, new_cost, candidate_cost)
        acc_candidate_mcc = torch.where(
            reset, 0.0, torch.where(accepted, acc_cand, acc_candidate_mcc)
        )
        promote = accepted & (num_nm == _MAX_CONSECUTIVE_NONMONOTONIC_STEPS)
        reference_cost = torch.where(promote, candidate_cost, reference_cost)
        acc_reference_mcc = torch.where(
            promote, acc_candidate_mcc,
            torch.where(accepted, acc_ref, acc_reference_mcc),
        )

        # Convergence: function tolerance on accepted steps; parameter
        # tolerance on every valid step (Ceres tests the candidate x before
        # acceptance); a dead trust region; a non-finite cost.
        ftol_hit = accepted & (
            torch.abs(cost_change_fwd) <= config.function_tolerance * cost
        )
        x_norm = torch.sqrt(q @ q + t @ t)
        xtol_hit = delta_finite & (
            torch.sqrt(delta @ delta) <= xtol * (x_norm + xtol)
        )
        done = (
            ftol_hit | xtol_hit | (radius < _MIN_TRUST_REGION_RADIUS)
            | ~torch.isfinite(new_cost)
        )

        q = torch.where(accepted, q_new, q)
        t = torch.where(accepted, t_new, t)
        cost = new_cost
        num_successful = num_successful + accepted.to(torch.int32)
        iteration += 1
        if bool(done):
            break

    return LMResult(
        q=q,
        t=t,
        initial_cost=initial_cost,
        final_cost=cost,
        num_iterations=iteration,
        num_successful_steps=int(num_successful),
    )
