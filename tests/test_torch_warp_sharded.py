"""The row-sharded warp (sarpro_tpu_torch/parallel/warp.py) on an 8-entry
CPU mesh, the cases of tests/test_warp_sharded.py one for one.

Each output row block is one `ops.warp_sample` call with its `row0` and
`rows`: the whole output's grid scales, global row coordinates (integers,
exact in f32), so every block equals the same rows of the unsharded output
bit for bit. Against the JAX package's sharded sampler the bounds are those
of tests/test_torch_warp.py: on a smooth source the values within 1e-3
(near: under 1e-3 of pixels differ) and the same zeros; a warp of a band
within 1e-3 mean and 0.1 max relative.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fixtures  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu.io import warp as jw  # noqa: E402
from sarpro_tpu.parallel import warp as jpw  # noqa: E402
from sarpro_tpu_torch import ops  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from sarpro_tpu_torch.io import safe as tsafe  # noqa: E402
from sarpro_tpu_torch.io import warp as tw  # noqa: E402
from sarpro_tpu_torch.ops import warp_kernel  # noqa: E402
from sarpro_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from sarpro_tpu_torch.parallel import warp as tpw  # noqa: E402
from test_torch_warp import _no_native  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))


@pytest.fixture(autouse=True)
def host_devices(monkeypatch):
    monkeypatch.setattr(tmesh, "HOST_DEVICE_COUNT", 8)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest should provide 8 virtual devices"
    return jpw.make_row_mesh(8)


@pytest.fixture
def mesh():
    return tpw.make_row_mesh(8, "cpu")


def _mapping(out_rows, out_cols, src_h, src_w, gh=17, gw=17):
    """Smooth affine-ish inverse mapping with mild rotation / shear."""
    yyn, xxn = np.meshgrid(np.linspace(0, 1, gh), np.linspace(0, 1, gw),
                           indexing="ij")
    map_x = (xxn * 0.93 + 0.04 * yyn) * (src_w - 6) + 2.0
    map_y = (yyn * 0.91 + 0.03 * xxn) * (src_h - 6) + 1.5
    return map_x, map_y


def _smooth(h, w):
    """A source whose gradient stays below 2.5 a pixel
    (tests/test_torch_warp.py)."""
    r, c = np.mgrid[:h, :w].astype(np.float32)
    return (100 + 20 * np.sin(c / 9) * np.cos(r / 13)).astype(np.float32)


def _unsharded(src, map_x, map_y, out_rows, out_cols, method):
    gx, gy = (torch.from_numpy(np.asarray(g, np.float32))
              for g in (map_x, map_y))
    return ops.warp_sample(torch.from_numpy(src), gx, gy, out_rows, out_cols,
                           method)


def _vs_jax(got, want, method):
    d = np.abs(got - want)
    if method == "near":
        assert (d > 0).mean() < 1e-3
    else:
        assert d.max() < 1e-3
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize("method", ["near", "bilinear", "cubic"])
def test_sharded_warp_bit_identical(mesh, jmesh, method):
    src = _smooth(200, 160)
    out_rows, out_cols = 120, 144
    map_x, map_y = _mapping(out_rows, out_cols, *src.shape)
    got = tpw.warp_sample_sharded(src, map_x, map_y, out_rows, out_cols,
                                  method, mesh)
    assert got.shape == (out_rows, out_cols)
    assert torch.equal(got, _unsharded(src, map_x, map_y, out_rows, out_cols,
                                       method))
    want = np.asarray(jpw.warp_sample_sharded(src, map_x, map_y, out_rows,
                                              out_cols, method, jmesh))
    _vs_jax(got.numpy(), want, method)


def test_sharded_warp_ragged_rows(mesh, jmesh):
    """107 output rows over 8 devices: blocks of 14, the last one 9."""
    src = _smooth(96, 96)
    out_rows, out_cols = 107, 96
    map_x, map_y = _mapping(out_rows, out_cols, *src.shape)
    got = tpw.warp_sample_sharded(src, map_x, map_y, out_rows, out_cols,
                                  "bilinear", mesh)
    assert got.shape == (out_rows, out_cols)
    assert torch.equal(got, _unsharded(src, map_x, map_y, out_rows, out_cols,
                                       "bilinear"))
    want = np.asarray(jpw.warp_sample_sharded(src, map_x, map_y, out_rows,
                                              out_cols, "bilinear", jmesh))
    _vs_jax(got.numpy(), want, "bilinear")


def test_sharded_warp_declines_single_device():
    src = np.random.default_rng(3).random((64, 64), dtype=np.float32)
    map_x, map_y = _mapping(64, 64, 64, 64)
    assert tpw.warp_sample_sharded(src, map_x, map_y, 64, 64, "bilinear",
                                   tpw.make_row_mesh(1, "cpu")) is None
    assert jpw.warp_sample_sharded(src, map_x, map_y, 64, 64, "bilinear",
                                   jpw.make_row_mesh(1)) is None
    assert tpw.shard_mesh(0, "cpu") is None
    assert tpw.shard_mesh(-1, "cpu").shape == {"scene": 1, "row": 8}
    assert tpw.shard_mesh(3, "cpu").shape == {"scene": 1, "row": 3}


@pytest.mark.parametrize("method", ["near", "bilinear", "cubic"])
def test_row_blocks_equal_rows_of_whole_output(method):
    """The counterpart of the JAX tiled backend's rebased coefficient
    tables (not ported): any (row0, rows) block of the sampler equals its
    rows of the whole output, and the JAX package's `_warp_sample_block`
    at the same row0 within the parity bound."""
    src = _smooth(160, 150)
    out_rows, out_cols = 131, 140
    map_x, map_y = _mapping(out_rows, out_cols, *src.shape)
    whole = _unsharded(src, map_x, map_y, out_rows, out_cols, method)
    gx, gy = (torch.from_numpy(np.asarray(g, np.float32))
              for g in (map_x, map_y))
    for row0, rows in ((0, 1), (7, 33), (32, 32), (100, 31), (130, 1)):
        part = ops.warp_sample(torch.from_numpy(src), gx, gy, out_rows,
                               out_cols, method, row0=row0, rows=rows)
        assert torch.equal(part, whole[row0:row0 + rows]), (row0, rows)
        want = np.asarray(jw._warp_sample_block(
            jnp.asarray(src), jnp.asarray(gx.numpy()),
            jnp.asarray(gy.numpy()), out_rows, out_cols, method, row0, rows))
        _vs_jax(part.numpy(), want, method)
    with pytest.raises(ValueError):
        ops.warp_sample(torch.from_numpy(src), gx, gy, out_rows, out_cols,
                        method, row0=130, rows=2)
    plain = warp_kernel._warp_sample_plain(torch.from_numpy(src), gx, gy,
                                           out_rows, out_cols, method, 50, 9)
    assert torch.equal(plain, whole[50:59])


def test_warp_to_crs_sharded_matches_unsharded(rng, tmp_path, monkeypatch):
    """warp_to_crs with shard_devices: the same raster, bit for bit, and
    georeferencing as the unsharded run (GCP / TPS fixture); against the
    JAX package's sharded warp within test_torch_warp's bound."""
    _no_native(monkeypatch)
    path = tmp_path / "gcp.tiff"
    data = (rng.random((96, 128)) * 3000).astype(np.uint16)
    fixtures._write_measurement_tiff(path, data)
    runs = []
    for shard in (0, 8):
        r = traster.RasterReader(path)
        try:
            runs.append(tw.warp_to_crs(r, "EPSG:4326", "cpu",
                                       resample_alg="bilinear",
                                       shard_devices=shard))
        finally:
            r.close()
    want, got = runs
    assert got.epsg == want.epsg and got.geotransform == want.geotransform
    assert torch.equal(got.data, want.data)
    r = jraster.RasterReader(path)
    token = jw.SHARD_DEVICES.set(8)
    try:
        j = jw.warp_to_crs(r, "EPSG:4326", resample_alg="bilinear")
    finally:
        jw.SHARD_DEVICES.reset(token)
        r.close()
    assert got.geotransform == j.geotransform and got.epsg == j.epsg
    g, w = got.data.numpy(), np.asarray(j.data)
    rel = np.abs(g - w) / np.maximum(np.abs(w), 1.0)
    assert (g == 0).sum() == (w == 0).sum()
    assert rel.mean() < 1e-3 and rel.max() < 0.1


def test_multiband_warp_engages_sharded_sampler(tmp_path, monkeypatch):
    """Dual-pol + target CRS + shard_devices: the sharded sampler runs for
    both bands (on the thread that owns the device work), and the JPEG's
    coefficient blocks equal the unsharded fast route's; the warped bands
    against the JAX package's sharded reader within test_torch_warp's
    bound."""
    from sarpro_tpu import api as japi
    from sarpro_tpu.io.safe import SafeReader
    from sarpro_tpu_torch import api as tapi
    from sarpro_tpu_torch.io.writers import jpeg as tjpeg
    from sarpro_tpu_torch.params import ProcessingParams
    from sarpro_tpu_torch.types import (
        AutoscaleStrategy,
        OutputFormat,
        Polarization,
    )

    _no_native(monkeypatch)
    calls, blocks = [], []
    real = tpw.warp_sample_sharded

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(tpw, "warp_sample_sharded", spy)
    monkeypatch.setattr(tjpeg, "write_synrgb_jpeg_dct",
                        lambda o, c, r, co: blocks.append(co))
    base = fixtures.make_safe(tmp_path, name="mb.SAFE", seed=5)
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.CLAHE, size=64,
        target_crs="EPSG:4326", resample_alg="cubic",
    )
    tapi.process_safe_to_path(base, tmp_path / "mb.jpg", params,
                              shard_devices=8, device="cpu")
    assert calls == [True, True], \
        "sharded warp sampler never engaged for the dual-pol warp config"
    tapi.process_safe_to_path(base, tmp_path / "ref.jpg", params, fast=True,
                              device="cpu")
    np.testing.assert_array_equal(blocks[0], blocks[1])
    # the bands the band stages took, from each package's sharded reader
    scene = tsafe.open_scene(base, "cpu", None, "Multiband", 64,
                             "EPSG:4326", "cubic", decimate=False,
                             shard_devices=8)
    token = jw.SHARD_DEVICES.set(8)
    try:
        ref = SafeReader.open_with_options(base, "all_pairs", "EPSG:4326",
                                           "cubic", 64)
        jb = japi._band_pair(ref, "Multiband")[:2]
    finally:
        jw.SHARD_DEVICES.reset(token)
    for t, j in zip((scene.band1, scene.band2), jb):
        g, w = t.numpy(), np.asarray(j)
        assert g.shape == w.shape
        rel = np.abs(g - w) / np.maximum(np.abs(w), 1.0)
        assert (g == 0).sum() == (w == 0).sum()
        assert rel.mean() < 1e-3 and rel.max() < 0.1
