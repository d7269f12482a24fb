"""Parity of the port's moments-form EM-LM solve with the JAX package's.

Fixtures follow tests/test_em_lm.py (the reference's
test/PointCloudRegistrationTest.cc wave grid), plus a noisy many-neighbor
table where the E-step weights actually move. Both solves run in float64
from the same numpy inputs. Tolerance: q and t at 1e-8 (the two solves take
the same steps; the rotation Jacobian is forward mode written out here and
``jax.jacfwd`` there, equal up to rounding, which the LM iteration can
amplify slightly), the costs at 1e-8 relative (1e-12 absolute for the exact
fixtures, which end at the rounding floor), and the iteration counts must be
equal.

The port's solve runs a fixed-shape step whose state freezes once done, in
blocks between reads of ``done``: the blocked form (``LM_BLOCK`` steps a
read, as on a card) is held to the same tolerances, its trace rows to 1e-8
relative, and extra steps after convergence must leave every output
bit-equal.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilistic_point_clouds_registration_tpu.io.synthetic import (
    transform_cloud,
    wave_grid,
)
from probabilistic_point_clouds_registration_tpu.models.em_lm import (
    LMConfig as JConfig,
    _estep_moments as j_moments,
    em_lm_solve as j_solve,
)
from probabilistic_point_clouds_registration_tpu_torch.models.em_lm import (
    LM_BLOCK,
    LMBlocks,
    LMConfig as TConfig,
    _estep_moments as t_moments,
    _solve_lu,
    em_lm_solve as t_solve,
    lm_init,
    lm_step,
)


def _wave_fixture():
    source = wave_grid()
    c, s = np.cos(0.34), np.sin(0.34)
    m = np.eye(4)
    m[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    m[0, 3] = 2.5
    target = transform_cloud(source, m)
    return source, target


def _exact(dof):
    source, target = _wave_fixture()
    return source, target[:, None, :], np.ones((source.shape[0], 1), bool)


def _garbage(dof):
    source, target = _wave_fixture()
    rng = np.random.default_rng(0)
    targets = np.concatenate(
        [target[:, None, :], rng.random((source.shape[0], 2, 3)) * 100], axis=1
    )
    mask = np.zeros(targets.shape[:2], bool)
    mask[:, 0] = True
    return source, targets, mask


def _noisy(dof):
    rng = np.random.default_rng(1)
    source = rng.normal(size=(400, 3))
    c, s = np.cos(0.05), np.sin(0.05)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    moved = source @ rot.T + np.array([0.1, -0.05, 0.02])
    targets = moved[:, None, :] + rng.normal(scale=0.05, size=(400, 6, 3))
    mask = rng.random((400, 6)) > 0.25
    return source, targets, mask


@pytest.mark.parametrize("fixture", [_exact, _garbage, _noisy])
@pytest.mark.parametrize("dof", [math.inf, 5.0], ids=["gaussian", "t5"])
def test_solve_matches_jax(fixture, dof):
    source, targets, mask = fixture(dof)
    kw = dict(dof=dof, function_tolerance=1e-4, max_iterations=200)
    q0 = np.array([1.0, 0.0, 0.0, 0.0])
    t0 = np.zeros(3)
    want = j_solve(
        jnp.asarray(source), jnp.asarray(targets), jnp.asarray(mask),
        jnp.asarray(q0), jnp.asarray(t0), JConfig(**kw),
    )
    got = t_solve(
        torch.as_tensor(source), torch.as_tensor(targets), torch.as_tensor(mask),
        torch.as_tensor(q0), torch.as_tensor(t0), TConfig(**kw),
    )
    assert got.num_iterations == int(want.num_iterations)
    assert got.num_successful_steps == int(want.num_successful_steps)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=1e-8)
    np.testing.assert_allclose(
        float(got.initial_cost), float(want.initial_cost), rtol=1e-12
    )
    # Exact fixtures end at the rounding floor (~1e-27), hence the atol.
    np.testing.assert_allclose(
        float(got.final_cost), float(want.final_cost), rtol=1e-8, atol=1e-12
    )


def test_moments_match_jax():
    source, targets, mask = _noisy(5.0)
    q = np.array([0.99, 0.02, -0.01, 0.05])
    t = np.array([0.01, 0.02, -0.03])
    want = j_moments(jnp.asarray(q), jnp.asarray(t), jnp.asarray(source),
                     jnp.asarray(targets), jnp.asarray(mask), 5.0, 3)
    got = t_moments(torch.as_tensor(q), torch.as_tensor(t), torch.as_tensor(source),
                    torch.as_tensor(targets), torch.as_tensor(mask), 5.0, 3)
    for name in ("m0", "m1", "m2", "sm", "smx", "cost"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-12, atol=1e-12, err_msg=name,
        )


def test_empty_association_stays_at_identity():
    source, targets, _ = _exact(5.0)
    mask = np.zeros((source.shape[0], 1), bool)
    got = t_solve(
        torch.as_tensor(source), torch.as_tensor(targets), torch.as_tensor(mask),
        torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64),
        torch.zeros(3, dtype=torch.float64), TConfig(max_iterations=20),
    )
    assert np.all(np.isfinite(got.q.numpy()))
    np.testing.assert_array_equal(got.t.numpy(), np.zeros(3))
    assert got.num_iterations <= 20


def _both(fixture, dof, **kw):
    """The JAX package's solve and the port's blocked one (LM_BLOCK steps
    between reads), float64, from the same inputs."""
    source, targets, mask = fixture(dof)
    kw = dict(dof=dof, function_tolerance=1e-4, max_iterations=200, **kw)
    q0 = np.array([1.0, 0.0, 0.0, 0.0])
    t0 = np.zeros(3)
    want = j_solve(
        jnp.asarray(source), jnp.asarray(targets), jnp.asarray(mask),
        jnp.asarray(q0), jnp.asarray(t0), JConfig(**kw),
    )
    got, status = LMBlocks(graphs=False, block=LM_BLOCK).solve(
        torch.as_tensor(source), torch.as_tensor(targets), torch.as_tensor(mask),
        torch.as_tensor(q0), torch.as_tensor(t0), TConfig(**kw),
    )
    return got, want, status


@pytest.mark.parametrize("fixture", [_exact, _garbage, _noisy])
@pytest.mark.parametrize("dof", [math.inf, 5.0], ids=["gaussian", "t5"])
def test_blocked_solve_with_trace_matches_jax(fixture, dof):
    got, want, status = _both(fixture, dof, trace=True)
    n = int(want.num_iterations)
    assert int(got.num_iterations) == n
    assert int(got.num_successful_steps) == int(want.num_successful_steps)
    # One read per block of LM_BLOCK steps, the last one after the block
    # in which the solve finished.
    assert status == (1, n, int(want.num_successful_steps))
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=1e-8)
    trace, want_trace = got.trace.numpy(), np.asarray(want.trace)
    assert trace.shape == want_trace.shape == (200, 4)
    # Exact fixtures run down to the rounding floor (costs 1e-10 to 1e-27):
    # costs get the final cost's atol, and the step quality of a step taken
    # from a cost already at the floor (a ratio of rounding residues) 1e-6.
    start = np.concatenate([[float(want.initial_cost)], want_trace[: n - 1, 0]])
    live = start > 1e-12
    np.testing.assert_allclose(trace[:n][live], want_trace[:n][live], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(trace[:n][~live][:, [0, 2, 3]],
                               want_trace[:n][~live][:, [0, 2, 3]], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(trace[:n][~live, 1], want_trace[:n][~live, 1], rtol=1e-6)
    assert np.all(trace[n:] == 0)


def _converged_state(extra_fields=False):
    source, targets, mask = _noisy(5.0)
    config = TConfig(trace=True, max_iterations=40)
    args = (torch.as_tensor(source), torch.as_tensor(targets), torch.as_tensor(mask))
    state, _ = lm_init(*args, torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64),
                       torch.zeros(3, dtype=torch.float64), config)
    while not bool(state.done) and int(state.iteration) < config.max_iterations:
        state = lm_step(state, *args, config)
    return state, args, config


@pytest.mark.parametrize("extra", [1, LM_BLOCK, 40], ids=["one", "block", "max-iterations"])
def test_steps_after_convergence_change_nothing(extra):
    state, args, config = _converged_state()
    assert bool(state.done) and 0 < int(state.iteration) < config.max_iterations
    after = state
    for _ in range(extra):
        after = lm_step(after, *args, config)
    for name, a, b in zip(state._fields, after, state):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_steps_past_max_iterations_change_nothing():
    """A solve cut by max_iterations (not done) freezes as well."""
    source, targets, mask = _noisy(5.0)
    config = TConfig(trace=True, max_iterations=3, function_tolerance=0.0,
                     parameter_tolerance=0.0)
    args = (torch.as_tensor(source), torch.as_tensor(targets), torch.as_tensor(mask))
    state, _ = lm_init(*args, torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64),
                       torch.zeros(3, dtype=torch.float64), config)
    for _ in range(3):
        state = lm_step(state, *args, config)
    assert not bool(state.done) and int(state.iteration) == 3
    after = state
    for _ in range(LM_BLOCK):
        after = lm_step(after, *args, config)
    for name, a, b in zip(state._fields, after, state):
        assert torch.equal(a, b), name


def test_frozen_solve_takes_no_step():
    """The outer chunk's stopped slots: a frozen solve keeps q0/t0, reads
    done at iteration 0, and its trace stays empty."""
    source, targets, mask = _noisy(5.0)
    q0 = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    got, status = LMBlocks(graphs=False, block=LM_BLOCK).solve(
        torch.as_tensor(source), torch.as_tensor(targets), torch.as_tensor(mask),
        q0, torch.zeros(3, dtype=torch.float64), TConfig(trace=True),
        frozen=torch.tensor(True))
    assert status == (1, 0, 1)
    assert torch.equal(got.q, q0) and torch.equal(got.t, torch.zeros(3, dtype=torch.float64))
    assert torch.equal(got.final_cost, got.initial_cost)
    assert not got.trace.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lu_solve_matches_numpy(seed):
    """The 7x7 LU written as tensor ops (pivoting needed: a small leading
    entry) against LAPACK through numpy."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(7, 7))
    a[0, 0] = 1e-9
    b = rng.normal(size=7)
    got = _solve_lu(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(a, b), rtol=1e-10, atol=1e-12)


def test_lu_solve_of_a_singular_matrix_is_not_finite():
    a = np.ones((7, 7))
    got = _solve_lu(torch.as_tensor(a), torch.ones(7, dtype=torch.float64))
    assert not torch.all(torch.isfinite(got))
