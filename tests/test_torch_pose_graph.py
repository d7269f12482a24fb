"""The port's pose-graph solve (``models/pose_graph.py``) against the JAX
package's, in float64.

The port builds each edge's Jacobian once per Gauss-Newton step in closed
form (held here against ``jacfwd`` through its own retraction and residual
code) and applies J^T J v as gathers, batched products and scatter-adds,
where the JAX package takes a JVP and a VJP per CG iteration: the same
operator, so the matvec agrees to 1e-12 and the solves to rounding (poses
1e-8, cost 1e-9 relative).

Plain CG (``precondition=False``) is held on a 6-pose loop: on longer
graphs its 50-80 steps stop short of the GN step's solution, and the JAX
package's own answer then moves far past these tolerances when one input
changes in its last bit, so no second implementation can agree with it
there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilistic_point_clouds_registration_tpu.models import pose_graph as J
from probabilistic_point_clouds_registration_tpu_torch.io import synthetic as S
from probabilistic_point_clouds_registration_tpu_torch.models import pose_graph as P


def _integrate(rels):
    poses = [np.eye(4)]
    for r in rels:
        poses.append(poses[-1] @ r)
    return poses


def _loop(n, seed=0, closure_weight=50.0):
    """tests/test_pose_graph.py's drifted circle: noisy odometry around a
    circle of ``n`` poses and one exact closure from the last pose to the
    first."""
    gt = S.circle_trajectory(n)
    gt0 = [np.linalg.inv(gt[0]) @ p for p in gt]
    rels = S.noisy_odometry(gt0, seed=seed)
    edges = J.odometry_edges(rels)
    edges.append((n - 1, 0, np.linalg.inv(gt0[-1]) @ gt0[0]))
    weights = [1.0] * (len(edges) - 1) + [closure_weight]
    return _integrate(rels), edges, weights, gt0


def _solve_both(poses, edges, weights, **cfg):
    jp, jc = J.optimize_pose_graph(poses, edges, weights=weights, config=J.PoseGraphConfig(**cfg))
    stats = {}
    pp, pc = P.optimize_pose_graph(poses, edges, weights=weights,
                                   config=P.PoseGraphConfig(**cfg), device="cpu", stats=stats)
    return (jp, jc), (pp, pc), stats


@pytest.mark.parametrize(
    "n, precondition, cfg",
    [(16, True, dict(max_iterations=25, cg_iterations=80)),
     (40, True, dict()),
     (6, False, dict())],
    ids=["circle16-pcg", "circle40-pcg", "loop6-plain-cg"],
)
def test_drifted_loop_matches_jax(n, precondition, cfg):
    poses, edges, weights, gt0 = _loop(n)
    (jp, jc), (pp, pc), stats = _solve_both(poses, edges, weights, precondition=precondition,
                                            **cfg)
    assert 1 <= stats["gn_iterations"] <= cfg.get("max_iterations", 20)
    assert pc == pytest.approx(jc, rel=1e-9)
    for a, b in zip(pp, jp):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(pp[0], poses[0])  # the gauge


def test_perfect_odometry_is_a_fixed_point():
    gt = S.circle_trajectory(8)
    gt0 = [np.linalg.inv(gt[0]) @ p for p in gt]
    rels = [np.linalg.inv(gt0[k]) @ gt0[k + 1] for k in range(len(gt0) - 1)]
    refined, cost = P.optimize_pose_graph(gt0, P.odometry_edges(rels), device="cpu")
    assert cost < 1e-12
    for a, b in zip(refined, gt0):
        np.testing.assert_allclose(a, b, atol=1e-6)


def _tensors(poses, edges, weights):
    from probabilistic_point_clouds_registration_tpu_torch.core.se3 import np_matrix_to_quat

    q = np.stack([np_matrix_to_quat(p[:3, :3]) for p in poses])
    t = np.stack([p[:3, 3] for p in poses])
    ei = np.array([e[0] for e in edges])
    ej = np.array([e[1] for e in edges])
    rq = np.stack([np_matrix_to_quat(e[2][:3, :3]) for e in edges])
    rt = np.stack([e[2][:3, 3] for e in edges])
    return q, t, ei, ej, rq, rt, np.asarray(weights, np.float64)


def test_explicit_jacobian_matvec_equals_jax_jvp_vjp():
    """(J^T J + damping I) v, J^T r and the block-Jacobi blocks: the port's
    per-edge Jacobians against the JAX package's linearize / vjp of the
    same residual (pose_graph.py:197-234), at 1e-12."""
    poses, edges, weights, _ = _loop(12, seed=1)
    q, t, ei, ej, rq, rt, w = _tensors(poses, edges, weights)
    damping = 1e-6
    jq, jt = jnp.asarray(q), jnp.asarray(t)
    j_rqi = jax.vmap(J.quat_conjugate)(jax.vmap(J.quat_normalize)(jnp.asarray(rq)))
    j_rt = -jax.vmap(J.unit_quat_rotate)(j_rqi, jnp.asarray(rt))
    j_args = (jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32), j_rqi, j_rt,
              jnp.sqrt(jnp.asarray(w)))

    def resid(delta):
        dq, dt = J._retract(jq, jt, delta.at[0].set(0.0))
        return J._edge_residuals(dq, dt, *j_args)

    r0, jvp = jax.linearize(resid, jnp.zeros((len(poses), 6)))
    _, vjp = jax.vjp(resid, jnp.zeros((len(poses), 6)))
    v = np.random.default_rng(2).normal(size=(len(poses), 6))
    want_hv = vjp(jvp(jnp.asarray(v)))[0] + damping * v
    want_g = vjp(r0)[0]
    want_blocks = J._block_jacobi_blocks(jq, jt, *j_args, len(poses))

    tq, tt = torch.as_tensor(q), torch.as_tensor(t)
    t_ei, t_ej = torch.as_tensor(ei), torch.as_tensor(ej)
    t_rqi = P.quat_conjugate(P.quat_normalize(torch.as_tensor(rq)))
    t_args = (t_ei, t_ej, t_rqi, -P.unit_quat_rotate(t_rqi, torch.as_tensor(rt)),
              torch.sqrt(torch.as_tensor(w)))
    a, b = P._edge_jacobians(tq, tt, *t_args)
    got_hv = P._jtj_matvec(a, b, t_ei, t_ej, torch.as_tensor(v), damping)
    r = P._edge_residuals(tq, tt, *t_args)
    got_g = P._gauge(P._jt(a, b, t_ei, t_ej, r, len(poses)))
    got_blocks = torch.zeros((len(poses), 6, 6), dtype=torch.float64)
    got_blocks.index_add_(0, t_ei, a.transpose(1, 2) @ a)
    got_blocks.index_add_(0, t_ej, b.transpose(1, 2) @ b)
    np.testing.assert_allclose(r.numpy(), np.asarray(r0), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_hv.numpy(), np.asarray(want_hv), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_blocks.numpy(), np.asarray(want_blocks), rtol=0, atol=1e-12)


def test_closed_form_jacobians_equal_forward_mode_ad():
    """The closed-form edge Jacobians against ``vmap(jacfwd)`` of the
    port's own retraction + residual (the JAX package's per-edge
    ``jacfwd``), on random poses and measurements, about half of the edges
    on the sign-fixed branch of the double cover: 1e-12 in float64."""
    g = torch.Generator().manual_seed(0)
    n, e = 30, 200
    q = P.quat_normalize(torch.randn(n, 4, dtype=torch.float64, generator=g))
    t = 10.0 * torch.randn(n, 3, dtype=torch.float64, generator=g)
    ei, ej = (torch.randint(0, n, (e,), generator=g) for _ in range(2))
    rqi = P.quat_normalize(torch.randn(e, 4, dtype=torch.float64, generator=g))
    rt = torch.randn(e, 3, dtype=torch.float64, generator=g)
    sw = torch.rand(e, dtype=torch.float64, generator=g) + 0.5

    def one_edge(qi, ti, qj, tj, rq, rtt, w):
        bq, bt = torch.stack([qi, qj]), torch.stack([ti, tj])

        def res(d):
            q2, t2 = P._retract(bq, bt, d)
            return P._pair_residuals(q2[0:1], t2[0:1], q2[1:2], t2[1:2], rq[None], rtt[None],
                                     w[None])[0]

        return torch.func.jacfwd(res)(torch.zeros((2, 6), dtype=qi.dtype))

    jac = torch.func.vmap(one_edge)(q[ei], t[ei], q[ej], t[ej], rqi, rt, sw)
    a, b = P._edge_jacobians(q, t, ei, ej, rqi, rt, sw)
    q_err = P.quat_multiply(P.quat_multiply(rqi, P.quat_conjugate(q[ei])), q[ej])
    assert 0 < int((q_err[:, 0] < 0).sum()) < e
    np.testing.assert_allclose(a.numpy(), jac[:, :, 0, :].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.numpy(), jac[:, :, 1, :].numpy(), rtol=0, atol=1e-12)


def test_extra_frozen_cg_steps_change_nothing():
    """Once the residual test fails, every CG carry keeps its bits: more
    fixed-shape steps give the same answer, which is the JAX package's
    while_loop (held at 1e-12)."""
    rng = np.random.default_rng(3)
    m = rng.normal(size=(24, 24))
    spd = m @ m.T + 24 * np.eye(24)
    rhs = rng.normal(size=(24,))
    diag = 1.0 / np.diag(spd)
    t_spd, t_diag = torch.as_tensor(spd), torch.as_tensor(diag)
    for precond in (None, lambda x: t_diag * x):
        solve = [P._conjugate_gradient(lambda v: t_spd @ v, torch.as_tensor(rhs), steps,
                                       precond=precond) for steps in (40, 41, 90)]
        assert torch.equal(solve[0], solve[1]) and torch.equal(solve[0], solve[2])
        want = J._conjugate_gradient(
            lambda v: jnp.asarray(spd) @ v, jnp.asarray(rhs), 40,
            precond=None if precond is None else (lambda x: jnp.asarray(diag) * x))
        np.testing.assert_allclose(solve[0].numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_sharded_config_and_missing_card_are_refused():
    poses, edges, weights, _ = _loop(6)
    with pytest.raises(ValueError, match="the sharded solve needs the Mesh"):
        P.optimize_pose_graph(poses, edges, weights=weights,
                              config=P.PoseGraphConfig(axis_name="points"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.optimize_pose_graph(poses, edges, weights=weights)
