"""The pooled engine's budgets on every path that sizes them
(``ops/fused_pool.py``'s sizing rule): the single pair, the batch without
a mesh and on a 3-rank ``gloo`` mesh, the sharded plan with and without
source slices, and a prepared sharded target, each at the budget rungs it
runs (the batch has none: an overflowed pair is redone on the grid
engine), with the narrow-class cutoff of the CPU (64) and of a CUDA device
(0).

The search's final arguments (budget_rows, class_budgets, small_unions)
are held to literals recorded once at commit e64773b, where each of these
callers still computed them itself; the sharded plan's own budgets and
small-unions hint are also held to the JAX package's. The small-unions
hint merged from several plans' parts is held to the hint of their
concatenated windows.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from probabilistic_point_clouds_registration_tpu.ops import fused_pool as j_fp
from probabilistic_point_clouds_registration_tpu.parallel import pool_sharded as j_ps
from probabilistic_point_clouds_registration_tpu_torch import RegistrationParams
from probabilistic_point_clouds_registration_tpu_torch.models.registration import (
    ProbabilisticRegistration,
)
from probabilistic_point_clouds_registration_tpu_torch.ops import fused_grid as t_fg
from probabilistic_point_clouds_registration_tpu_torch.ops import fused_pool as t_fp
from probabilistic_point_clouds_registration_tpu_torch.ops.grid import build_grid_host
from probabilistic_point_clouds_registration_tpu_torch.parallel import make_mesh
from probabilistic_point_clouds_registration_tpu_torch.parallel import pool_sharded as t_ps
from probabilistic_point_clouds_registration_tpu_torch.parallel.align import (
    DistributedRegistration,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_port_mesh_worker as W  # noqa: E402
from test_torch_parallel import RADIUS, TARGETS  # noqa: E402

SHIFT = np.array([0.1, -0.05, 0.02])
CUTOFFS = {"cpu": None, "cuda": 0}
# (path, fixture, cutoff) -> per rung (budget_rows, class_budgets, small_unions),
# recorded at commit e64773b. The pair, the sharded plans and the prepared
# target run on tests/test_torch_parallel.py's targets (:func:`_pair_of`);
# the batch on the mesh worker's 5-scan sequences.
PARENT = {
    ("pair", "slab", "cpu"): [
        (32768, (1024, 2048, 4096, 4096), False),
        (65536, (1024, 4096, 7168, 8192), False),
        (131072, (1024, 7168, 14336, 16384), False)],
    ("pair", "hot", "cpu"): [
        (81920, (1024, 1024, 1024, 1024, 2048, 10240), False),
        (163840, (1024, 1024, 1024, 1024, 4096, 20480), False),
        (327680, (1024, 1024, 1024, 1024, 8192, 40960), False)],
    ("pair", "slab", "cuda"): [
        (14336, (1792,), True), (28672, (3584,), True), (57344, (7168,), True)],
    ("pair", "hot", "cuda"): [
        (28672, (1024, 3584), True), (57344, (1024, 7168), True),
        (114688, (1024, 14336), True)],
    ("batch", "wave", "cpu"): [(16384, (2048, 2048), False)],
    ("batch", "hot", "cpu"): [(20480, (1024, 2048, 2560, 2560), False)],
    ("batch", "wave", "cuda"): [(16384, (2048,), True)],
    ("batch", "hot", "cuda"): [(20480, (2560,), True)],
    ("sharded", "slab", "cpu"): [
        (20480, (1024, 2560, 2560), False), (40960, (2048, 5120, 5120), False),
        (81920, (4096, 10240, 10240), False)],
    ("sharded", "hot", "cpu"): [
        (40960, (1024, 1024, 1024, 1024, 5120), False),
        (81920, (2048, 2048, 2048, 2048, 10240), False),
        (163840, (4096, 4096, 4096, 4096, 20480), False)],
    ("sharded_slices", "slab", "cpu"): [
        (20480, (1024, 1024, 2560), False), (40960, (2048, 2048, 5120), False),
        (81920, (4096, 4096, 10240), False)],
    ("sharded_slices", "hot", "cpu"): [
        (40960, (1024, 1024, 1024, 1024, 5120), False),
        (81920, (2048, 2048, 2048, 2048, 10240), False),
        (163840, (4096, 4096, 4096, 4096, 20480), False)],
    ("prepared", "slab", "cpu"): [
        (32768, (1024, 2048, 4096, 4096), False), (65536, (2048, 4096, 8192, 8192), False),
        (131072, (4096, 8192, 16384, 16384), False)],
    ("prepared", "hot", "cpu"): [
        (81920, (1024, 1024, 1024, 1024, 2048, 10240), False),
        (163840, (2048, 2048, 2048, 2048, 4096, 20480), False),
        (327680, (4096, 4096, 4096, 4096, 8192, 40960), False)],
    ("sharded", "slab", "cuda"): [
        (20480, (2560,), True), (40960, (5120,), True), (81920, (10240,), True)],
    ("sharded", "hot", "cuda"): [
        (40960, (5120,), True), (81920, (10240,), True), (163840, (20480,), True)],
    ("sharded_slices", "slab", "cuda"): [
        (20480, (2560,), True), (40960, (5120,), True), (81920, (10240,), True)],
    ("sharded_slices", "hot", "cuda"): [
        (40960, (5120,), True), (81920, (10240,), True), (163840, (20480,), True)],
    ("prepared", "slab", "cuda"): [
        (32768, (4096,), True), (65536, (8192,), True), (131072, (16384,), True)],
    ("prepared", "hot", "cuda"): [
        (81920, (1024, 10240), True), (163840, (2048, 20480), True),
        (327680, (4096, 40960), True)],
    ("pair", "far", "cpu"): [
        (81920, (1024, 1024, 1024, 1024, 2048, 10240), False),
        (163840, (1024, 1024, 1024, 1024, 4096, 20480), False),
        (327680, (1024, 1024, 1024, 1024, 8192, 40960), False)],
    ("pair", "far", "cuda"): [
        (69632, (1024, 8704), True),
        (137216, (1024, 17152), True),
        (272384, (1024, 34048), True)],
    ("sharded", "far", "cpu"): [
        (256000, (7168, 7168, 7168, 7168, 32000), False),
        (512000, (13312, 13312, 13312, 13312, 64000), False),
        (1024000, (25600, 25600, 25600, 25600, 128000), False)],
    ("sharded", "far", "cuda"): [
        (256000, (32000,), True),
        (512000, (64000,), True),
        (1024000, (128000,), True)],
    ("sharded_slices", "far", "cpu"): [
        (81920, (1024, 1024, 1024, 1024, 10240), False),
        (163840, (2048, 2048, 2048, 2048, 20480), False),
        (327680, (4096, 4096, 4096, 4096, 40960), False)],
    ("sharded_slices", "far", "cuda"): [
        (81920, (10240,), True),
        (163840, (20480,), True),
        (327680, (40960,), True)],
    ("prepared", "far", "cpu"): [
        (81920, (1024, 1024, 1024, 1024, 2048, 10240), False),
        (163840, (2048, 2048, 2048, 2048, 4096, 20480), False),
        (327680, (4096, 4096, 4096, 4096, 8192, 40960), False)],
    ("prepared", "far", "cuda"): [
        (81920, (1024, 10240), True),
        (163840, (2048, 20480), True),
        (327680, (4096, 40960), True)],
}
CASES = [(key, rung) for key, rungs in PARENT.items() for rung in range(len(rungs))]


def _pair_of(name):
    """(target, source): "far" is the hot target against eight copies of
    its shifted self 100 m apart, so that the source's own rows, not its
    grouping demand, set the row budget's floor."""
    target = TARGETS["hot" if name == "far" else name]
    source = target + SHIFT
    if name == "far":
        source = np.concatenate([source + [100.0 * i, 0.0, 0.0] for i in range(8)])
    return target, source


@pytest.fixture(scope="module")
def mesh_batch(tmp_path_factory):
    """The batch's pools on each rank of a 3-rank ``gloo`` mesh (4 pairs
    padded to 6, two a rank), for both sequences and both cutoffs."""
    cases = [("batch_pools", dict(dp=3, scans=name, cutoff=cut, tag=f"{name}/{label}"))
             for name in ("wave", "hot") for label, cut in CUTOFFS.items()]
    return W.run_group(3, cases, tmp_path_factory.mktemp("sizing3"), timeout=300)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch work on one CPU thread (several test processes
    share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(**kw):
    return RegistrationParams(**W.params_kw(n_iter=3, cost_drop_thresh=-1.0, **kw))


def _sizer(path, name):
    """``rung -> (budget_rows, class_budgets, small_unions)`` of ``path``."""
    if path == "batch":
        got = W.batch_pools("cpu", 1, name)
        return lambda rung: got
    target, source = _pair_of(name)
    if path == "pair":
        reg = ProbabilisticRegistration(source, target, _params(search_impl="pool"),
                                        device="cpu")

        def pair(rung):
            reg._pool_budget_boost = rung
            return (*reg.pool_budgets(), reg._pool.small_unions)

        return pair
    if path == "prepared":
        mesh = make_mesh(device="cpu")
        prep = DistributedRegistration.prepare_target(target, _params(), mesh)
        reg = DistributedRegistration(source, target, _params(), mesh=mesh,
                                      prepared_target=prep)
        sp, rows = reg._sp, reg._rows_per_shard
    else:
        half = len(source) // 2
        slices = [source[:half], source[half:]] if path == "sharded_slices" else None
        sp = t_ps.build_sharded_pool_host(target, RADIUS, 2, k=8, source_slices=slices,
                                          device="cpu")
        j_fp._select_max_w, real = (lambda: sp.select_max_w), j_fp._select_max_w
        try:
            want = j_ps.build_sharded_pool_host(target, RADIUS, 2, k=8, source_slices=slices)
        finally:
            j_fp._select_max_w = real
        assert (sp.budget_rows, sp.class_budgets, sp.small_unions) == (
            want.budget_rows, want.class_budgets, want.small_unions)
        rows = half
    return lambda rung: (*t_ps._pool_budgets(sp, rows, rung), sp.small_unions)


_SIZERS = {}


@pytest.mark.parametrize("key, rung", CASES, ids=["-".join(k) + f"-rung{r}" for k, r in CASES])
def test_pool_budgets_equal_the_parent(key, rung, monkeypatch, request):
    path, name, cutoff = key
    if key not in _SIZERS:
        if CUTOFFS[cutoff] is not None:
            monkeypatch.setattr(t_fp, "_select_max_w", lambda device: CUTOFFS[cutoff])
        _SIZERS[key] = _sizer(path, name)
    budget, budgets, small = _SIZERS[key](rung)
    want = PARENT[key][rung]
    assert (int(budget), tuple(int(b) for b in budgets), bool(small)) == want
    if path == "batch":
        for rank in request.getfixturevalue("mesh_batch"):
            budget, budgets, small = rank[f"{name}/{cutoff}"]
            assert (int(budget), tuple(int(b) for b in budgets), bool(small)) == want, "mesh"


@pytest.mark.parametrize("smw", [0, 8, 64])
@pytest.mark.parametrize("k", [2, 4, 8, 32])
def test_merged_small_unions_parts_equal_the_concatenated_windows(k, smw):
    """The parts of the hot target's three shards' plans, summed, give the
    hint ``_small_unions`` gives their kernel-class windows concatenated,
    and the one the mean of min(union, k) gives (near 0.75 k at k = 2
    without a cutoff, and at k = 32 with cutoff 8)."""
    target = TARGETS["hot"]
    rows_of = [np.arange(s, target.shape[0], 3) for s in range(3)]
    plans = t_fp.plan_pool_host_group(
        [build_grid_host(target[r], RADIUS, buckets=False) for r in rows_of],
        [target[r] for r in rows_of], select_max_w=smw)
    unions = np.concatenate([p["dil"]["union"] for p in plans])
    unions = unions[unions > smw]
    part = sum(t_fp.small_unions_part(p, k, smw) for p in plans)
    assert part.tolist() == [np.minimum(unions, k).sum(), unions.size]
    want = bool(np.mean(np.minimum(unions, k)) < 0.75 * k)
    assert t_fg.small_unions_of(part, k) == t_fg._small_unions(unions, k) == want
