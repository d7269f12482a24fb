"""The port's readers and writers (``io/pcd.py``, ``io/kitti.py``,
``io/eth_csv.py``, ``io/prefetch.py``) against the JAX package's.

Every PCD mode written by either package is read by the other with equal
arrays, and both write the same bytes for the same points; the golden
binary_compressed file of tests/test_pcd.py decodes equal in both; KITTI
scans, poses and calibration and the ETH CSV rules agree exactly.
"""
from pathlib import Path

import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.io import eth_csv as j_eth
from probabilistic_point_clouds_registration_tpu.io import kitti as j_kitti
from probabilistic_point_clouds_registration_tpu.io import pcd as j_pcd
from probabilistic_point_clouds_registration_tpu_torch import native
from probabilistic_point_clouds_registration_tpu_torch.io import eth_csv as t_eth
from probabilistic_point_clouds_registration_tpu_torch.io import kitti as t_kitti
from probabilistic_point_clouds_registration_tpu_torch.io import pcd as t_pcd
from probabilistic_point_clouds_registration_tpu_torch.io.prefetch import ScanPrefetcher

GOLDEN = Path(__file__).parent / "data" / "golden_binary_compressed.pcd"
MODES = ["ascii", "binary", "binary_compressed"]


def _cloud(n=1234, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)) * 100 - 50).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pcd_written_by_one_read_by_the_other(tmp_path, mode, writer):
    pts = _cloud()
    path = tmp_path / f"{writer}_{mode}.pcd"
    (j_pcd if writer == "jax" else t_pcd).save_pcd(path, pts, mode=mode)
    got_port, got_jax = t_pcd.load_pcd(path), j_pcd.load_pcd(path)
    assert got_port.dtype == np.float32 and got_port.shape == pts.shape
    np.testing.assert_array_equal(got_port, got_jax)
    np.testing.assert_allclose(got_port, pts, rtol=1e-6 if mode == "ascii" else 0)


@pytest.mark.parametrize("mode", MODES)
def test_pcd_same_bytes_for_the_same_points(tmp_path, mode):
    pts = _cloud(seed=1)
    j_pcd.save_pcd(tmp_path / "j.pcd", pts, mode=mode)
    t_pcd.save_pcd(tmp_path / "t.pcd", pts, mode=mode)
    assert (tmp_path / "j.pcd").read_bytes() == (tmp_path / "t.pcd").read_bytes()


def test_lzf_python_codec_matches_jax(monkeypatch):
    """The pure-Python fallbacks (native library declined) give the JAX
    package's bytes, and decode the native encoder's stream."""
    data = np.random.default_rng(2).integers(0, 4, 5000, dtype=np.uint8).tobytes()
    native_comp = t_pcd.lzf_compress(data)
    monkeypatch.setattr(native, "lzf_compress", lambda *a: None)
    monkeypatch.setattr(native, "lzf_decompress", lambda *a: None)
    comp = t_pcd.lzf_compress(data)
    import probabilistic_point_clouds_registration_tpu.native as j_native

    monkeypatch.setattr(j_native, "lzf_compress", lambda *a: None)
    assert comp == j_pcd.lzf_compress(data)
    assert t_pcd.lzf_decompress(comp, len(data)) == data
    assert t_pcd.lzf_decompress(native_comp, len(data)) == data


def test_golden_binary_compressed(monkeypatch):
    expected = np.array([[1.5, 1.5, 0.0], [2.5, 2.5, 0.0]] * 2, np.float32)
    np.testing.assert_array_equal(t_pcd.load_pcd(GOLDEN), expected)
    np.testing.assert_array_equal(t_pcd.load_pcd(GOLDEN), j_pcd.load_pcd(GOLDEN))
    monkeypatch.setattr(native, "lzf_decompress", lambda *a: None)
    np.testing.assert_array_equal(t_pcd.load_pcd(GOLDEN), expected)


@pytest.mark.parametrize("mode", ["ascii", "binary"])
def test_pcd_extra_fields(tmp_path, mode):
    n = 7
    rng = np.random.default_rng(3)
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("i", "<f4")])
    for name in "xyz":
        rec[name] = rng.random(n).astype(np.float32)
    rec["i"] = 42.0
    header = (
        "VERSION 0.7\nFIELDS x y z i\nSIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA {mode}\n"
    )
    path = tmp_path / f"xyzi_{mode}.pcd"
    if mode == "binary":
        path.write_bytes(header.encode() + rec.tobytes())
    else:
        body = "\n".join(" ".join(f"{v:.9g}" for v in row) for row in rec.tolist())
        path.write_text(header + body + "\n")
    got = t_pcd.load_pcd(path)
    np.testing.assert_array_equal(got, j_pcd.load_pcd(path))
    np.testing.assert_array_equal(got, np.stack([rec["x"], rec["y"], rec["z"]], 1))


def test_pcd_missing_file_and_bad_mode(tmp_path):
    with pytest.raises(OSError):
        t_pcd.load_pcd(tmp_path / "nope.pcd")
    with pytest.raises(ValueError, match="unsupported"):
        t_pcd.save_pcd(tmp_path / "x.pcd", _cloud(4), mode="lzma")


def test_kitti_scans_poses_calibration(tmp_path):
    rng = np.random.default_rng(4)
    for i in range(3):
        rng.standard_normal((500 + i, 4)).astype(np.float32).tofile(tmp_path / f"{i:06d}.bin")
    scans = t_kitti.list_velodyne_scans(tmp_path)
    assert scans == j_kitti.list_velodyne_scans(tmp_path) and len(scans) == 3
    for path in scans:
        got = t_kitti.load_velodyne_bin(path)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, j_kitti.load_velodyne_bin(path))
    (tmp_path / "bad.bin").write_bytes(b"\0" * 12)
    with pytest.raises(ValueError, match="multiple of 4"):
        t_kitti.load_velodyne_bin(tmp_path / "bad.bin")

    poses = []
    for _ in range(5):
        m = np.eye(4)
        m[:3, :4] = rng.standard_normal((3, 4))
        poses.append(m)
    t_kitti.save_poses(tmp_path / "t.txt", poses)
    j_kitti.save_poses(tmp_path / "j.txt", poses)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    for a, b in zip(t_kitti.load_poses(tmp_path / "j.txt"), poses):
        np.testing.assert_allclose(a, b, atol=1e-8)

    tr = rng.standard_normal(12)
    (tmp_path / "calib.txt").write_text(
        "P0: " + " ".join(["0"] * 12) + "\nTr: " + " ".join(f"{v:.12e}" for v in tr) + "\n")
    calib = t_kitti.load_calibration(tmp_path / "calib.txt")
    np.testing.assert_array_equal(calib, j_kitti.load_calibration(tmp_path / "calib.txt"))
    calib[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    for a, b in zip(t_kitti.camera_poses_to_velodyne(poses, calib),
                    j_kitti.camera_poses_to_velodyne(poses, calib)):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "nocalib.txt").write_text("P0: 1 2 3\n")
    with pytest.raises(ValueError, match="Tr"):
        t_kitti.load_calibration(tmp_path / "nocalib.txt")


@pytest.mark.parametrize(
    "text",
    [
        "timestamp,x,y,z,intensity\n100.5,1.0,2.0,3.0,17\n100.6,4.0,5.0,6.0,18\n",
        "idx,Z,Y,X\n0,3.0,2.0,1.0\n",
        "100.0,1.0,2.0,3.0\n101.0,4.0,5.0,6.0\n",
        "1.0,2.0,3.0\n",
        "x,y,z\n1,2,3\nnan,nan,nan\n4,5,6\n",
        "x;y;z\n1;2;3\n4;nan;6\n7;8;9\n",
        "",
    ],
    ids=["header", "any-order", "headerless-4", "headerless-3", "nan-rows", "semicolons",
         "empty"],
)
def test_eth_csv_rules(tmp_path, text):
    f = tmp_path / "s.csv"
    f.write_text(text)
    got = t_eth.load_eth_csv(f)
    np.testing.assert_array_equal(got, j_eth.load_eth_csv(f))
    assert got.ndim == 2 and got.shape[1] == 3 and np.isfinite(got).all()


def test_eth_csv_errors_and_listing(tmp_path):
    (tmp_path / "b.csv").write_text("a,b,c\n1,2,3\n")
    with pytest.raises(ValueError, match="x/y/z"):
        t_eth.load_eth_csv(tmp_path / "b.csv")
    (tmp_path / "a.csv").write_text("1,2\n")
    with pytest.raises(ValueError, match=">= 3"):
        t_eth.load_eth_csv(tmp_path / "a.csv")
    assert t_eth.list_eth_scans(tmp_path) == j_eth.list_eth_scans(tmp_path)


def test_prefetcher_order(tmp_path):
    arrays = [np.random.default_rng(i).random((50 + i, 3)) for i in range(6)]
    paths = []
    for i, a in enumerate(arrays):
        paths.append(tmp_path / f"s{i}.pcd")
        t_pcd.save_pcd(paths[-1], a)
    with ScanPrefetcher(paths, depth=2) as pf:
        assert len(pf) == 6
        for i in (0, 1, 2, 4, 5, 3):  # in order, a skip, then a step back
            np.testing.assert_allclose(pf.get(i), arrays[i], atol=1e-6)
