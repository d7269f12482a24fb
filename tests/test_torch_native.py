"""The port's copy of the native host library (``native/``) against its
numpy fallbacks and the JAX package's copy: tests/test_native.py's cases.

The library is built with g++ at first use into the package's build root;
every native function must equal its numpy body bit for bit.
"""
import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu_torch import kernels, native
from probabilistic_point_clouds_registration_tpu_torch.ops import fused_grid
from probabilistic_point_clouds_registration_tpu_torch.ops.grid import build_grid_host


@pytest.fixture(autouse=True)
def _built():
    assert native.available(), "g++ builds the native library here"
    assert native.library_path().parent == kernels.build_root() / "native"


def _python_lzf_decompress(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        ctrl = data[i]
        i += 1
        if ctrl < 32:
            out += data[i: i + ctrl + 1]
            i += ctrl + 1
        else:
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    assert len(out) == expected
    return bytes(out)


@pytest.mark.parametrize("seed,size", [(0, 0), (1, 1), (2, 100), (3, 65_536)])
def test_lzf_roundtrip_random(seed, size):
    data = np.random.default_rng(seed).integers(0, 8, size=size, dtype=np.uint8).tobytes()
    comp = native.lzf_compress(data)
    if size == 0:
        assert comp is None
        return
    assert native.lzf_decompress(comp, size) == data
    assert _python_lzf_decompress(comp, size) == data


def test_lzf_compresses_structured_data():
    rng = np.random.default_rng(0)
    pts = (rng.integers(0, 200, size=(10_000, 3)) * 0.05).astype(np.float32)
    body = np.concatenate([pts[:, 0], pts[:, 1], pts[:, 2]]).tobytes()
    comp = native.lzf_compress(body)
    assert comp is not None and len(comp) < len(body)
    assert native.lzf_decompress(comp, len(body)) == body


def test_lzf_decompress_accepts_a_literal_stream():
    data = bytes(range(256)) * 10
    stream = b"".join(bytes([len(data[i: i + 32]) - 1]) + data[i: i + 32]
                      for i in range(0, len(data), 32))
    assert native.lzf_decompress(stream, len(data)) == data


def test_lzf_decompress_rejects_a_corrupt_stream():
    with pytest.raises(ValueError):
        native.lzf_decompress(b"\xff\xff\xff", 1000)


@pytest.mark.parametrize("seed,n,leaf", [(0, 1000, 0.5), (1, 5000, 0.25), (2, 37, 2.0)])
def test_voxel_native_equals_numpy(seed, n, leaf, monkeypatch):
    from probabilistic_point_clouds_registration_tpu_torch.ops.voxel import voxel_downsample

    pts = np.random.default_rng(seed).standard_normal((n, 3)) * 3.0
    got = native.voxel_downsample(pts, leaf)
    monkeypatch.setattr(native, "voxel_downsample", lambda *a, **k: None)
    want = voxel_downsample(pts, leaf)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed,n", [(0, 5000), (3, 2000)], ids=["bunny", "sheet"])
def test_dilate_cells_native_equals_numpy(seed, n, monkeypatch):
    """``dilate_cells_host`` on the native library and on its numpy body:
    every table equal (the stable descending-union order and the 27-offset
    tie order included)."""
    from probabilistic_point_clouds_registration_tpu_torch.io.synthetic import bunny_like

    rng = np.random.default_rng(seed)
    if seed:
        tgt = rng.uniform(0, 12, size=(n, 3))
        tgt[:, 2] = rng.normal(scale=0.4, size=n)
    else:
        tgt = bunny_like(n, seed=seed)
    gh = build_grid_host(tgt, 0.35 if seed else 0.06)
    counts = gh["cell_count"].astype(np.int64)
    calls = []
    dilate = native.dilate_cells
    monkeypatch.setattr(native, "dilate_cells", lambda *a: calls.append(1) or dilate(*a))
    got = fused_grid.dilate_cells_host(gh, counts=counts)
    assert calls == [1]
    monkeypatch.setattr(native, "dilate_cells", lambda *a: None)
    want = fused_grid.dilate_cells_host(gh, counts=counts)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_native_library_equals_the_jax_packages():
    """The copy's source is the JAX package's below its header comment."""
    from pathlib import Path

    import probabilistic_point_clouds_registration_tpu as jax_pkg

    ours = native._SRC.read_text()
    theirs = (Path(jax_pkg.__file__).parent / "native" / "pcr_native.cpp").read_text()
    body = theirs[theirs.index("#include <algorithm>"):]
    assert ours.endswith(body)
