"""The port's command lines (``cli.py``, ``cli_odometry.py``) against the
JAX package's, in the style of tests/test_cli.py and tests/test_kitti.py:
the same argv through both pair CLIs gives the same standard output apart
from timings (numbers printed at 6 significant digits within 1e-5) and the
same summary file within 1e-6 (float64); the refusals and degradations are
the JAX CLI's; the odometry CLI registers written KITTI ``.bin`` scans and
refuses a ``--mesh`` whose size is not the world size. Each CLI writes into the working directory, so every
test runs in its own."""
import json
import re

import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu import cli as j_cli
from probabilistic_point_clouds_registration_tpu import cli_odometry as j_cli_odo
from probabilistic_point_clouds_registration_tpu_torch import cli as t_cli
from probabilistic_point_clouds_registration_tpu_torch import cli_odometry as t_cli_odo
from probabilistic_point_clouds_registration_tpu_torch.io.kitti import save_poses
from probabilistic_point_clouds_registration_tpu_torch.io.pcd import load_pcd, save_pcd
from probabilistic_point_clouds_registration_tpu_torch.io.synthetic import (
    sequence_from_world,
    transform_cloud,
    wave_grid,
)

NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|[-+]?inf|nan")


@pytest.fixture
def pair_files(tmp_path):
    """tests/test_cli.py's pair: source binary_compressed, target binary,
    ground truth ascii."""
    source = wave_grid().astype(np.float32)
    m = np.eye(4)
    a = 0.08
    m[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    m[0, 3] = 0.2
    target = transform_cloud(source, m)
    paths = [tmp_path / name for name in ("src.pcd", "tgt.pcd", "gt.pcd")]
    for path, cloud, mode in zip(paths, (source, target, target),
                                 ("binary_compressed", "binary", "ascii")):
        save_pcd(path, cloud, mode=mode)
    return paths


def _run(main, argv, cwd, monkeypatch, capsys):
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    rc = main(argv)
    return rc, capsys.readouterr().out


def _same_numbers(got: str, want: str, rtol: float, what: str) -> None:
    """The same text with numbers masked, and the numbers within rtol."""
    assert NUMBER.sub("#", got) == NUMBER.sub("#", want), what
    a = np.array([float(x) for x in NUMBER.findall(got)])
    b = np.array([float(x) for x in NUMBER.findall(want)])
    np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-9, err_msg=what)


def test_pair_cli_matches_jax(pair_files, tmp_path, monkeypatch, capsys):
    src, tgt, gt = (str(p) for p in pair_files)
    argv = [src, tgt, "-r", "3", "-m", "8", "-i", "5", "-g", gt, "--dump", "-v",
            "--dtype", "float64", "--search_impl", "grid"]
    rc_j, out_j = _run(j_cli.main, argv, tmp_path / "jax", monkeypatch, capsys)
    rc_t, out_t = _run(t_cli.main, argv + ["--device", "cpu"], tmp_path / "port", monkeypatch,
                       capsys)
    assert rc_j == rc_t == 0
    lines_j, lines_t = out_j.splitlines(), out_t.splitlines()
    assert len(lines_t) == len(lines_j)
    for a, b in zip(lines_t, lines_j):
        if a.startswith("[iter "):  # the line ends in the iteration's wall time
            a, b = a.rsplit(",", 1)[0], b.rsplit(",", 1)[0]
        _same_numbers(a, b, 1e-5, a)
    assert "Transformation history:" in out_t and "MSE w.r.t. ground truth" in out_t
    summary = "src_tgt_summary.txt"
    _same_numbers((tmp_path / "port" / summary).read_text(),
                  (tmp_path / "jax" / summary).read_text(), 1e-6, summary)
    aligned = load_pcd(tmp_path / "port" / "aligned_src.pcd")
    np.testing.assert_allclose(aligned, load_pcd(tmp_path / "jax" / "aligned_src.pcd"),
                               rtol=0, atol=1e-5)


def test_missing_source_exits_1(tmp_path, capsys):
    for main in (t_cli.main, j_cli.main):
        assert main([str(tmp_path / "nope.pcd"), str(tmp_path / "nope2.pcd")]) == 1
        assert "Could not load source cloud" in capsys.readouterr().out


def test_bad_ground_truth_degrades(pair_files, tmp_path, monkeypatch, capsys):
    src, tgt, _ = (str(p) for p in pair_files)
    argv = [src, tgt, "-i", "2", "-g", str(tmp_path / "missing.pcd"), "--dtype", "float64",
            "--search_impl", "grid"]
    rc_j, out_j = _run(j_cli.main, argv, tmp_path / "jax", monkeypatch, capsys)
    rc_t, out_t = _run(t_cli.main, argv + ["--device", "cpu"], tmp_path / "port", monkeypatch,
                       capsys)
    assert rc_j == rc_t == 0
    assert "Could not load ground truth" in out_t
    assert out_t == out_j


@pytest.mark.parametrize("search_impl", ["pool", "fused", "auto", "brute"])
def test_every_engine_is_accepted(pair_files, tmp_path, monkeypatch, capsys, search_impl):
    src, tgt, _ = (str(p) for p in pair_files)
    rc, out = _run(t_cli.main, [src, tgt, "-r", "1", "-i", "2", "-u", "-v", "--device", "cpu",
                                "--search_impl", search_impl], tmp_path / "run", monkeypatch,
                   capsys)
    assert rc == 0 and "Using gaussian model" in out
    assert (tmp_path / "run" / "aligned_src.pcd").exists()


def test_cuda_without_a_card_is_an_error(pair_files, tmp_path, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src, tgt, _ = (str(p) for p in pair_files)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main([src, tgt, "-i", "1"])


def _bin_scans(tmp_path):
    """tests/test_kitti.py's three KITTI .bin scans of the wave surface,
    with their ground-truth poses file."""
    scans, poses = sequence_from_world(wave_grid(), 0.05, [0.1, -0.02, 0.01], 3)
    for i, scan in enumerate(scans):
        rec = np.concatenate([scan.astype(np.float32), np.zeros((len(scan), 1), np.float32)], 1)
        rec.tofile(tmp_path / f"{i:06d}.bin")
    save_poses(tmp_path / "gt.txt", poses)
    return tmp_path


def test_odometry_cli_on_bin_scans_matches_jax(tmp_path, monkeypatch, capsys):
    scan_dir = _bin_scans(tmp_path)
    argv = [str(scan_dir), "-r", "1.0", "-m", "10", "-i", "10", "--ground_truth",
            str(scan_dir / "gt.txt"), "--pose_graph", "--closure_min_gap", "2"]
    outs = {}
    for name, main, extra in (("jax", j_cli_odo.main, []),
                              ("port", t_cli_odo.main, ["--device", "cpu"])):
        traj = tmp_path / f"traj_{name}.json"
        rc, out = _run(main, argv + ["-o", str(traj)] + extra, tmp_path / name, monkeypatch,
                       capsys)
        refined = traj.with_name(traj.stem + "_refined.json")
        assert rc == 0 and traj.exists() and refined.exists()
        outs[name] = (out, json.loads(traj.read_text()), json.loads(refined.read_text()))
    (out_t, traj_t, ref_t), (out_j, traj_j, ref_j) = outs["port"], outs["jax"]
    assert "Odometry over 3 scans (2 pairs)" in out_t and "ATE RMSE" in out_t
    assert "Detected 1 loop closures" in out_t and "Detected 1 loop closures" in out_j
    np.testing.assert_allclose(ref_t["poses"], ref_j["poses"], rtol=0, atol=1e-4)
    assert float(out_t.rsplit(":", 1)[1]) < 0.05
    assert traj_t["num_pairs"] == traj_j["num_pairs"] == 2
    np.testing.assert_allclose(traj_t["relative_transforms"], traj_j["relative_transforms"],
                               rtol=0, atol=1e-4)


def test_odometry_cli_refuses_mesh(tmp_path, capsys):
    scan_dir = _bin_scans(tmp_path)
    rc = t_cli_odo.main([str(scan_dir), "-o", str(tmp_path / "t.json"), "--mesh", "2x4",
                         "--device", "cpu"])
    assert rc == 2
    assert "a 2x4 mesh needs a world of 8 ranks, this one has 1" in capsys.readouterr().out
    assert not (tmp_path / "t.json").exists()
