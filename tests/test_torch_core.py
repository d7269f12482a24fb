"""Parity of the PyTorch port's small modules with the JAX package:
core types, SE(3) math, parameters, the E-step weights, and the rule that
the port imports no JAX.

Tolerances: the SE(3) tensor functions are compared in float64 at 1e-12
(same formulas, summation order may differ by an ulp); the numpy host
helpers and the integer size helpers must be equal; the weights are held to
the reference's golden vectors at 1e-6 (test/ProbabilisticWeightsTest.cc)
and to the JAX function at 1e-12 in float64.

Also here: how `kernels.py` keys a build (source, shared headers and
flags), and that the GPU scripts' text handling (the ptxas summary of the
smoke run, the patched kernel copies of the kernel benchmark) still fits
the sources.
"""
import importlib.util
import math
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilistic_point_clouds_registration_tpu.core import params as j_params
from probabilistic_point_clouds_registration_tpu.core import se3 as j_se3
from probabilistic_point_clouds_registration_tpu.core import types as j_types
from probabilistic_point_clouds_registration_tpu.ops.weights import (
    update_weights as j_update_weights,
)
from probabilistic_point_clouds_registration_tpu_torch.core import params as t_params
from probabilistic_point_clouds_registration_tpu_torch.core import se3 as t_se3
from probabilistic_point_clouds_registration_tpu_torch.core import types as t_types
from probabilistic_point_clouds_registration_tpu_torch.ops.weights import (
    update_weights as t_update_weights,
)

REPO = Path(__file__).resolve().parents[1]


def _quats_and_points(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4) * rng.uniform(0.5, 3.0)  # deliberately non-unit
    b = rng.normal(size=4)
    pts = rng.normal(size=(64, 3)) * 10.0
    return q, b, pts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_se3_tensor_functions_match_jax(seed):
    q, b, pts = _quats_and_points(seed)
    tq, tb, tp = (torch.as_tensor(a, dtype=torch.float64) for a in (q, b, pts))
    jq, jb, jp = (jnp.asarray(a, dtype=jnp.float64) for a in (q, b, pts))
    qn = q / np.linalg.norm(q)
    cases = [
        (t_se3.quat_normalize(tq), j_se3.quat_normalize(jq)),
        (t_se3.unit_quat_rotate(torch.as_tensor(qn), tp),
         j_se3.unit_quat_rotate(jnp.asarray(qn), jp)),
        (t_se3.unit_quat_rotate(torch.as_tensor(qn), tp[0]),
         j_se3.unit_quat_rotate(jnp.asarray(qn), jp[0])),
        (t_se3.quat_rotate(tq, tp), j_se3.quat_rotate(jq, jp)),
        (t_se3.quat_rotate_points(tq, tp), j_se3.quat_rotate_points(jq, jp)),
        (t_se3.quat_multiply(tq, tb), j_se3.quat_multiply(jq, jb)),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def _pivot_rotations(rng):
    """Unit quaternions whose matrices take each of the four Shepperd
    pivots (w, x, y or z largest), plus random ones."""
    qs = [np.array([1.0, 0.1, -0.2, 0.1]), np.array([0.05, 1.0, 0.2, -0.1]),
          np.array([0.1, -0.2, 1.0, 0.3]), np.array([-0.1, 0.1, 0.2, 1.0])]
    qs += list(rng.normal(size=(4, 4)))
    return np.stack([q / np.linalg.norm(q) for q in qs])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_se3_rest_matches_jax(seed):
    """The functions the CLI, the sequences and the pose graph need, single
    and batched (the JAX package calls them under vmap), at 1e-12 in
    float64."""
    import jax

    q, b, pts = _quats_and_points(seed)
    rng = np.random.default_rng(seed)
    tq, tb, tp = (torch.as_tensor(a, dtype=torch.float64) for a in (q, b, pts))
    jq, jb, jp = (jnp.asarray(a, dtype=jnp.float64) for a in (q, b, pts))
    t, t2 = rng.normal(size=3), rng.normal(size=3)
    qs = _pivot_rotations(rng)
    mats = np.stack([j_se3.np_quat_to_matrix(x) for x in qs])
    angles = rng.uniform(-3.0, 3.0, size=(3, 5))
    ta, tb_ = t_se3.SE3(tq, torch.as_tensor(t)), t_se3.SE3(tb, torch.as_tensor(t2))
    ja, jb_ = j_se3.SE3(jq, jnp.asarray(t)), j_se3.SE3(jb, jnp.asarray(t2))
    bq = torch.as_tensor(qs)
    cases = [
        (t_se3.quat_conjugate(tq), j_se3.quat_conjugate(jq)),
        (t_se3.quat_to_matrix(tq), j_se3.quat_to_matrix(jq)),
        (t_se3.quat_to_matrix(bq), jax.vmap(j_se3.quat_to_matrix)(jnp.asarray(qs))),
        (t_se3.matrix_to_quat(torch.as_tensor(mats)),
         jax.vmap(j_se3.matrix_to_quat)(jnp.asarray(mats))),
        (t_se3.matrix_to_quat(torch.as_tensor(mats[1])), j_se3.matrix_to_quat(mats[1])),
        (t_se3.quat_multiply(bq, bq.flip(0)),
         jax.vmap(j_se3.quat_multiply)(jnp.asarray(qs), jnp.asarray(qs[::-1]))),
        (t_se3.unit_quat_rotate(bq, tp[:8]),
         jax.vmap(j_se3.unit_quat_rotate)(jnp.asarray(qs), jp[:8])),
        (t_se3.se3_apply(ta, tp), j_se3.se3_apply(ja, jp)),
        *zip(t_se3.se3_compose(ta, tb_), j_se3.se3_compose(ja, jb_)),
        *zip(t_se3.se3_inverse(ta), j_se3.se3_inverse(ja)),
        (t_se3.se3_to_matrix(ta), j_se3.se3_to_matrix(ja)),
        (t_se3.se3_to_matrix(t_se3.SE3(bq, tp[:8])),
         jax.vmap(lambda a, c: j_se3.se3_to_matrix(j_se3.SE3(a, c)))(jnp.asarray(qs), jp[:8])),
        *zip(t_se3.se3_from_matrix(t_se3.se3_to_matrix(ta)),
             j_se3.se3_from_matrix(j_se3.se3_to_matrix(ja))),
        (t_se3.euler_zyx_to_quat(*torch.as_tensor(angles[:, 0])),
         j_se3.euler_zyx_to_quat(*angles[:, 0])),
        (t_se3.euler_zyx_to_quat(*torch.as_tensor(angles)),
         jax.vmap(j_se3.euler_zyx_to_quat)(*jnp.asarray(angles))),
    ]
    for got, want in cases:
        assert got.dtype == torch.float64 and tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    d, base = rng.normal(size=(4, 4)), rng.normal(size=(4, 4))
    np.testing.assert_array_equal(t_se3.compose_matrices(d, base),
                                  j_se3.compose_matrices(d, base))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_se3_host_helpers_equal_jax(seed):
    q, _, _ = _quats_and_points(seed)
    q = q / np.linalg.norm(q)
    t = np.random.default_rng(seed).normal(size=3)
    m = j_se3.np_quat_to_matrix(q)
    np.testing.assert_array_equal(t_se3.np_quat_to_matrix(q), m)
    np.testing.assert_array_equal(t_se3.np_matrix_to_quat(m), j_se3.np_matrix_to_quat(m))
    np.testing.assert_array_equal(t_se3.np_se3_matrix(q, t), j_se3.np_se3_matrix(q, t))
    np.testing.assert_array_equal(t_se3.matrix_euler_xyz(m), j_se3.matrix_euler_xyz(m))


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_se3_identity():
    tf = t_se3.SE3.identity(torch.float64)
    np.testing.assert_array_equal(tf.q.numpy(), [1.0, 0.0, 0.0, 0.0])
    np.testing.assert_array_equal(tf.t.numpy(), [0.0, 0.0, 0.0])


@pytest.mark.parametrize("n", [0, 1, 7, 63, 64, 65, 1000, 35_000, 131_072, 458_751])
def test_size_helpers_equal_jax(n):
    assert t_types.round_up(n, 128) == j_types.round_up(n, 128)
    assert t_types.pow2(n) == j_types.pow2(n)
    assert t_types.bucket_rows(n) == j_types.bucket_rows(n)
    assert t_types.bucket_rows(n, 128) == j_types.bucket_rows(n, 128)
    assert t_types.bucket_rows(n, step_bits=3) == j_types.bucket_rows(n, step_bits=3)


def test_pad_cloud_and_valid_mask_equal_jax():
    pts = np.random.default_rng(0).normal(size=(100, 3))
    for mult, pad_value in ((128, 0.0), (100, np.inf), (64, np.inf)):
        got, n = t_types.pad_cloud(pts, mult, pad_value)
        want, nj = j_types.pad_cloud(pts, mult, pad_value)
        assert n == nj
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        t_types.valid_mask(128, 100).numpy(), np.asarray(j_types.valid_mask(128, 100))
    )


@pytest.mark.parametrize(
    "search_impl,search_select",
    [("fused", "auto"), ("grid", "topk"), ("grid", "hier"), ("grid", "pallas"),
     ("grid", "approx"), ("pallas", "auto"), ("pool", "auto"), ("brute", "auto")],
)
def test_from_reference_params_carries_every_field(search_impl, search_select):
    import dataclasses

    ref = j_params.RegistrationParams(
        max_neighbours=7, dof=math.inf, radius=0.3, n_iter=9, cost_drop_thresh=-1.0,
        initial_rotation=(0.0, 1.0, 0.0, 0.0), pad_multiple=1024,
        max_inner_iterations=50, search_impl=search_impl, outer_chunk=15,
        search_select=search_select,
    )
    got = t_params.from_reference_params(ref)
    assert isinstance(got, t_params.RegistrationParams)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.is_gaussian
    assert (got.search_impl, got.search_select) == (search_impl, search_select)
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(ref)]
    got.validate()


def _weights_fixture():
    # Row 0 has 3 associations, row 1 has 4 (ProbabilisticWeightsTest.cc).
    sq = np.array([[1.0, 1.0, 1.0, 0.0], [1.0, 4.0, 9.0, 16.0]])
    mask = np.array([[True, True, True, False], [True, True, True, True]])
    return torch.as_tensor(sq), torch.as_tensor(mask)


@pytest.mark.parametrize(
    "dof,row1",
    [
        (5.0, [0.7151351, 0.1412613, 0.0241258, 0.0047656]),
        (math.inf, [0.805153702921689, 0.179654074677018, 0.0147469044726408,
                    0.000445317928652638]),
    ],
    ids=["t5", "gaussian"],
)
def test_weights_golden_vectors(dof, row1):
    sq, mask = _weights_fixture()
    w = t_update_weights(sq, mask, dof=dof, dimension=1).numpy()
    expected = np.array([[1 / 3, 1 / 3, 1 / 3, 0.0], row1])
    np.testing.assert_allclose(w, expected, atol=1e-6)


@pytest.mark.parametrize("dof", [5.0, 1.5, math.inf], ids=["t5", "t1.5", "gaussian"])
def test_weights_match_jax(dof):
    rng = np.random.default_rng(0)
    sq = rng.random((64, 20)) * 10
    mask = rng.random((64, 20)) > 0.3
    mask[3] = False  # an empty row
    got = t_update_weights(torch.as_tensor(sq), torch.as_tensor(mask), dof=dof, dimension=3)
    want = j_update_weights(jnp.asarray(sq), jnp.asarray(mask), dof=dof, dimension=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-15)
    assert np.all(got.numpy()[3] == 0.0)


def test_port_imports_without_jax():
    """Every module of the port imports with JAX (and the JAX package)
    unavailable: the test walks the package, so a new module is covered
    the day it lands."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'probabilistic_point_clouds_registration_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import probabilistic_point_clouds_registration_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names), sorted(p.__all__), names)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "ProbabilisticRegistration" in proc.stdout
    for module in ("cli", "cli_odometry", "__main__", "io.pcd", "io.kitti", "io.eth_csv",
                   "io.prefetch", "models.odometry", "models.loop_closure",
                   "models.pose_graph", "ops.fused_pool", "kernels", "native"):
        assert f"'probabilistic_point_clouds_registration_tpu_torch.{module}'" in proc.stdout


def _script(path):
    """A script of the repository, imported as a module (its ``main`` is
    not run; it imports torch's CUDA side only there)."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("edited", ["topk_merge.cuh", "row_topk.cu", "new_header.cuh"])
def test_library_path_follows_sources_and_headers(edited, tmp_path, monkeypatch):
    """A build is keyed by its source, by every csrc/*.cuh (a header the
    source may include) and by the flags: an edit to a shared header
    rebuilds the kernels that include it."""
    from probabilistic_point_clouds_registration_tpu_torch import kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels._CSRC, csrc)
    monkeypatch.setattr(kernels, "_CSRC", csrc)
    names = ("row_topk", "brute_knn", "select_windows", "select_bitonic")
    before = {name: kernels.library_path(name) for name in names}
    assert before == {name: kernels.library_path(name) for name in names}
    assert len(set(before.values())) == len(names)
    target = csrc / edited
    target.write_text((target.read_text() if target.exists() else "") + "\n// edited\n")
    after = {name: kernels.library_path(name) for name in names}
    changed = {name for name in names if after[name] != before[name]}
    assert changed == ({"row_topk"} if edited.endswith(".cu") else set(names))
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-lineinfo",))
    assert all(kernels.library_path(name) != after[name] for name in names)


def test_shared_header_is_included_by_the_two_streaming_selections_only():
    from probabilistic_point_clouds_registration_tpu_torch import kernels

    including = {p.name for p in kernels._CSRC.glob("*.cu")
                 if '#include "topk_merge.cuh"' in p.read_text()}
    assert including == {"row_topk.cu", "brute_knn.cu"}


def test_window_walk_header_is_shared_by_the_two_window_selects():
    """B1 and B4 run one walk (csrc/window_select.cuh, which takes its keys
    and merges from topk_merge.cuh); each keeps its own entry point."""
    from probabilistic_point_clouds_registration_tpu_torch import kernels

    sources = {p.name: p.read_text() for p in kernels._CSRC.glob("*.cu")}
    including = {name for name, text in sources.items()
                 if '#include "window_select.cuh"' in text}
    assert including == {"select_windows.cu", "select_bitonic.cu"}
    assert '#include "topk_merge.cuh"' in (kernels._CSRC / "window_select.cuh").read_text()
    for name in including:
        assert "wsel::select_groups(" in sources[name]
        assert f'extern "C" int {name[:-3]}_launch(' in sources[name]
    assert "select_windows_rounds_kernel" in sources["select_windows.cu"]  # k > 32


def test_smoke_run_summarises_the_ptxas_log():
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN45_GLOBAL__N__20c56b78_12_brute_knn_cu_d699097c16brute_knn_kernelILi4EEEvPKfiiii'"
        " for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN45_brute_knn_kernelILi4EEEvPKfiiii\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 59 registers, used 1 barriers\n"
        "ptxas info    : Function properties for _ZN43_INTERNAL_9merge_rowEPyPKyii\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Compiling entry function "
        "'_ZN44_GLOBAL__N__4a0a61b0_11_row_topk_cu_f0b2c7d115row_topk_kernelEPKfPfPiiii'"
        " for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 56 registers, used 0 barriers, 2048 bytes smem\n"
    )
    assert _script(REPO / "chip_smoke.py")._ptxas_summary(log) == (
        "brute_knn_kernel<4> 59 registers, 0 spill bytes, 0 B static shared; "
        "row_topk_kernel 56 registers, 12 spill bytes, 2048 B static shared")


@pytest.mark.parametrize("name", ["row_topk", "brute_knn", "select_windows", "select_bitonic"])
def test_kernel_benchmark_patches_fit_the_sources(name, tmp_path):
    """tools/bench_select_kernels.py times copies of a kernel's source with
    a tuning constant changed or a merge counter added; the text it patches
    must still be in the sources."""
    from probabilistic_point_clouds_registration_tpu_torch import kernels

    bench = _script(REPO / "tools" / "bench_select_kernels.py")

    def with_headers(cu):  # a constant is the source's own or a header's
        return cu.read_text() + "".join(h.read_text() for h in sorted(cu.parent.glob("*.cuh")))

    source = with_headers(kernels._CSRC / f"{name}.cu")
    for knobs in bench.VARIANTS[name]:
        cu = bench._variant_copy(kernels._CSRC, name, knobs, tmp_path / "variant")
        text = with_headers(cu)
        assert text != source or all(
            f"constexpr int {c} = {v};" in source for c, v in knobs.items())
        assert all(f"constexpr int {c} = {v};" in text for c, v in knobs.items())
        assert (tmp_path / "variant" / "topk_merge.cuh").exists()
    if name == "brute_knn":
        text = bench._no_candidates_copy(kernels._CSRC, name, tmp_path / "none").read_text()
        assert "thr[r] = -CUDART_INF_F;" in text and "in_range ? CUDART_INF_F" not in text
    if name.startswith("select_"):
        original = (kernels._CSRC / "window_select.cuh").read_text()
        bench._no_candidates_copy(kernels._CSRC, name, tmp_path / "none")
        assert "thr0 = a.r2 >= below_empty ? -1.0f" in (
            tmp_path / "none" / "window_select.cuh").read_text()
        bench._writes_only_copy(kernels._CSRC, name, tmp_path / "writes")
        assert "if (width <= a.n_lanes) {" in (
            tmp_path / "writes" / "window_select.cuh").read_text()
        cu = bench._phase_copy(kernels._CSRC, name, tmp_path / "phases")
        assert "phase_count" in cu.read_text()
        timed = (tmp_path / "phases" / "window_select.cuh").read_text()
        assert timed.count("phase_add(") == 3 and timed.count("clock64()") == 3
        assert original == (kernels._CSRC / "window_select.cuh").read_text()
    cu = bench._counting_copy(kernels._CSRC, name, tmp_path / "count")
    assert "merge_count" in cu.read_text()
    header = (tmp_path / "count" / "topk_merge.cuh").read_text()
    # One count in each of the header's two merges, one where keys are staged.
    assert header.count("atomicAdd(&g_merges") == 2 and header.count("atomicAdd(&g_staged") == 1


def test_kernel_benchmark_counts_an_older_tree(tmp_path):
    """The benchmark's other tree may predate the shared headers: a bitonic
    select with its network in the kernel is counted there, and a window
    select that takes k rounds has no merge to count."""
    bench = _script(REPO / "tools" / "bench_select_kernels.py")
    old = tmp_path / "csrc"
    old.mkdir()
    (old / "topk_merge.cuh").write_text("// a header the selects do not include\n")
    (old / "select_windows.cu").write_text("namespace {\n}  // k rounds, no network\n")
    (old / "select_bitonic.cu").write_text(
        "namespace {\n"
        "      if (!__any_sync(kFull, live && key < worst)) continue;\n"
        "}\n")
    assert bench._counting_copy(old, "select_windows", tmp_path / "b1") is None
    counted = bench._counting_copy(old, "select_bitonic", tmp_path / "b4").read_text()
    assert counted.count("atomicAdd(&g_merges") == 1 and "merge_count" in counted


def test_every_file_a_build_reads_is_package_data():
    """An installed package must carry every file ``kernels.library_path``
    hashes (the sources and every header they may include) and the native
    library's source: each matches a ``package-data`` pattern."""
    import fnmatch
    import tomllib

    from probabilistic_point_clouds_registration_tpu_torch import kernels, native

    pkg = Path(kernels.__file__).resolve().parent
    config = tomllib.loads((REPO / "pyproject.toml").read_text())
    patterns = config["tool"]["setuptools"]["package-data"][pkg.name]
    read = [*kernels._CSRC.glob("*.cu"), *kernels._CSRC.glob("*.cuh"), native._SRC]
    assert {p.suffix for p in read} == {".cu", ".cuh", ".cpp"}
    for path in read:
        rel = path.relative_to(pkg).as_posix()
        assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), rel


def test_build_dir_variable_moves_the_builds(tmp_path, monkeypatch):
    from probabilistic_point_clouds_registration_tpu_torch import kernels, native

    default = kernels.library_path("row_topk")
    assert default.parent == REPO / "build" / "kernels"
    monkeypatch.setenv("PCR_TORCH_BUILD_DIR", str(tmp_path))
    moved = kernels.library_path("row_topk")
    assert moved == tmp_path / "kernels" / default.name
    assert native.library_path() == tmp_path / "native" / native.library_path().name
