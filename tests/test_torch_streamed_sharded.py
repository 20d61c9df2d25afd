"""The streamed passes' mesh mode (sarpro_tpu_torch/core/streamed.py, `mesh`)
on an 8-entry CPU mesh, the cases of tests/test_streamed_sharded.py one for
one.

Each case holds the port's mesh run bit-equal to the port's unsharded
streamed passes, and against the JAX package's mesh run on its 8-device
CPU mesh within the bounds of tests/test_torch_streamed.py's parity tests:
the bands within 1 (Tamed) or `_level_bound`, the synRGB floor equal and
the RGB equal wherever both packages' bands agree (but for the JAX
program's floor-40 table gap, `floor40_gap`), the DCT blocks within 1
wherever the RGB agree on the whole block.

416 rows over 8 row blocks are 52 local rows: in chunks of 24, two and a
ragged 4-row tail a block, and CLAHE tiles (52 rows) cut mid-chunk.
"""
import logging

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sarpro_tpu.core import fast_path as jfast  # noqa: E402
from sarpro_tpu.core import streamed as js  # noqa: E402
from sarpro_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from sarpro_tpu_torch.core import fast_path as tfast  # noqa: E402
from sarpro_tpu_torch.core import streamed as ts  # noqa: E402
from sarpro_tpu_torch.io.tiffio import TiffReader  # noqa: E402
from sarpro_tpu_torch.io.writers import jpeg as tjpeg  # noqa: E402
from sarpro_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from sarpro_tpu_torch.types import (  # noqa: E402
    AutoscaleStrategy,
    BitDepth,
    OutputFormat,
)
from test_stats import sar_like  # noqa: E402
from test_torch_gray import _j, _level_bound  # noqa: E402
from test_torch_sharded import floor40_gap  # noqa: E402

S = AutoscaleStrategy
SHAPE, CHUNK = (416, 176), 24


@pytest.fixture(autouse=True)
def host_devices(monkeypatch):
    monkeypatch.setattr(tmesh, "HOST_DEVICE_COUNT", 8)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest should provide 8 virtual devices"
    return j_make_mesh(8, shape=(1, 8))


@pytest.fixture
def mesh():
    return tmesh.make_mesh(8, shape=(1, 8), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.uint16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    assert torch.equal(got, want)


def _band_bound(x, strategy, bit_depth=BitDepth.U8):
    return 1 if strategy is S.TAMED else _level_bound(x, strategy, bit_depth)


def _bands_vs_jax(vv, vh, strategy, mesh, jmesh):
    """Both packages' mesh-mode bands of the pair, within their bound;
    (JAX bands, port bands)."""
    jb, tb = [], []
    for d, c in ((vv, True), (vh, False)):
        copol = c if strategy is S.TAMED else None
        jb.append(np.asarray(js.band_u8_streamed(
            d, _j(strategy), copol, chunk_rows=CHUNK, mesh=jmesh)))
        tb.append(ts.band_u8_streamed(_t(d), strategy, copol,
                                      chunk_rows=CHUNK, mesh=mesh).numpy())
        diff = np.abs(jb[-1].astype(int) - tb[-1].astype(int))
        assert diff.max() <= _band_bound(d, strategy)
    return jb, tb


def _synrgb_vs_jax(t_rgb, j_rgb, jb, tb, strategy, pad):
    rows, cols = jb[0].shape
    if pad:
        m = max(rows, cols)
        jb, tb = ([np.pad(b, ((((m - rows) // 2), m - rows - (m - rows) // 2),
                              ((m - cols) // 2, m - cols - (m - cols) // 2)))
                   for b in bands] for bands in (jb, tb))
    both = (jb[0] == tb[0]) & (jb[1] == tb[1])
    if strategy in (S.TAMED, S.CLAHE):
        fl = [ts._suppressed_floor_host(np.bincount(
            np.concatenate([b[0].ravel(), b[1].ravel()]), minlength=256),
            2 * b[0].size) for b in (jb, tb)]
        assert fl[0] == fl[1]
        if fl[0] == 40:  # the JAX in-graph tables differ there
            both &= ~floor40_gap(*jb)
    assert both.mean() > 0.5
    np.testing.assert_array_equal(t_rgb[both], j_rgb[both])


def _pair(rng):
    return sar_like(rng, SHAPE), sar_like(rng, SHAPE)


@pytest.mark.parametrize(
    "strategy",
    [S.CLAHE, S.ROBUST, S.STANDARD, S.EQUALIZED, S.TAMED, S.DEFAULT],
)
def test_sharded_streamed_synrgb_bit_identical(rng, mesh, jmesh, strategy):
    vv, vh = _pair(rng)
    want = ts.synrgb_streamed(_t(vv), _t(vh), strategy=strategy,
                              chunk_rows=CHUNK)
    got = ts.synrgb_streamed(_t(vv), _t(vh), strategy=strategy,
                             chunk_rows=CHUNK, mesh=mesh)
    _equal(got, want)
    j_rgb = np.asarray(js.synrgb_streamed(vv, vh, strategy=_j(strategy),
                                          chunk_rows=CHUNK, mesh=jmesh))
    _synrgb_vs_jax(got.numpy(), j_rgb,
                   *_bands_vs_jax(vv, vh, strategy, mesh, jmesh), strategy,
                   False)


def test_sharded_streamed_synrgb_pad_suppressed(rng, mesh, jmesh):
    """The pad precedes the suppressed compose: the combined histogram's
    pad zeros are counted after the blocks' u8 histograms are summed."""
    vv, vh = _pair(rng)
    kw = dict(strategy=S.CLAHE, pad=True, chunk_rows=CHUNK)
    want = ts.synrgb_streamed(_t(vv), _t(vh), **kw)
    got = ts.synrgb_streamed(_t(vv), _t(vh), mesh=mesh, **kw)
    assert got.shape == (416, 416, 3)
    _equal(got, want)
    j_rgb = np.asarray(js.synrgb_streamed(
        vv, vh, mesh=jmesh, **{**kw, "strategy": _j(S.CLAHE)}))
    _synrgb_vs_jax(got.numpy(), j_rgb,
                   *_bands_vs_jax(vv, vh, S.CLAHE, mesh, jmesh), S.CLAHE,
                   True)


def test_sharded_streamed_synrgb_dct_layout(rng, mesh, jmesh):
    """layout='dct': the chunked JPEG front end on the gathered RGB, the
    same ints as the unsharded run."""
    vv, vh = _pair(rng)
    kw = dict(strategy=S.ROBUST, chunk_rows=CHUNK)
    want = ts.synrgb_streamed(_t(vv), _t(vh), layout="dct", **kw)
    got = ts.synrgb_streamed(_t(vv), _t(vh), layout="dct", mesh=mesh, **kw)
    _equal(got, want)
    jkw = {**kw, "strategy": _j(S.ROBUST), "mesh": jmesh}
    j_dct = np.asarray(js.synrgb_streamed(vv, vh, layout="dct", **jkw))
    j_rgb = np.asarray(js.synrgb_streamed(vv, vh, **jkw))
    t_rgb = ts.synrgb_streamed(_t(vv), _t(vh), mesh=mesh, **kw).numpy()
    assert got.shape == j_dct.shape == (3, 52, 22, 8, 8)
    same = np.all(t_rgb == j_rgb, axis=-1)
    agree = same.reshape(52, 8, 22, 8).all(axis=(1, 3))
    assert agree.mean() > 0.2
    assert np.abs(got.numpy().astype(int)
                  - j_dct.astype(int))[:, agree].max() <= 1


@pytest.mark.parametrize("bit_depth", [BitDepth.U8, BitDepth.U16])
def test_sharded_streamed_grayscale_bit_identical(rng, mesh, jmesh,
                                                  bit_depth):
    dn = sar_like(rng, SHAPE)
    kw = dict(strategy=S.CLAHE, bit_depth=bit_depth, chunk_rows=CHUNK)
    want = ts.grayscale_streamed(_t(dn), **kw)
    got = ts.grayscale_streamed(_t(dn), mesh=mesh, **kw)
    _equal(got, want)
    j = np.asarray(js.grayscale_streamed(
        dn, mesh=jmesh, **{**kw, "strategy": _j(S.CLAHE),
                           "bit_depth": _j(bit_depth)}))
    d = np.abs(got.numpy().astype(np.int64) - j.astype(np.int64))
    assert d.max() <= _level_bound(dn, S.CLAHE, bit_depth)


def test_sharded_streamed_adaptive_bit_identical(rng, mesh, jmesh):
    """Adaptive's mean and std come from the summed integer histogram
    (`fused._stats_finalize`): the mesh run equals the unsharded one."""
    dn = sar_like(rng, SHAPE)
    want = ts.grayscale_streamed(_t(dn), strategy=S.ADAPTIVE,
                                 chunk_rows=CHUNK)
    got = ts.grayscale_streamed(_t(dn), strategy=S.ADAPTIVE,
                                chunk_rows=CHUNK, mesh=mesh)
    _equal(got, want)
    j = np.asarray(js.grayscale_streamed(dn, strategy=_j(S.ADAPTIVE),
                                         chunk_rows=CHUNK, mesh=jmesh))
    d = np.abs(got.numpy().astype(int) - j.astype(int))
    assert d.max() <= _level_bound(dn, S.ADAPTIVE, BitDepth.U8)


def test_sharded_streamed_masked_shard(rng, mesh, jmesh):
    """A block whose rows are all masked (DN 0, below the -50 dB floor)
    folds +-inf, and the global min / max come out of the other blocks."""
    dn = np.asarray(sar_like(rng, SHAPE)).copy()
    dn[0:52] = 0.0  # exactly block 0
    want = ts.grayscale_streamed(_t(dn), strategy=S.STANDARD,
                                 chunk_rows=CHUNK)
    got = ts.grayscale_streamed(_t(dn), strategy=S.STANDARD,
                                chunk_rows=CHUNK, mesh=mesh)
    _equal(got, want)
    assert not got.numpy()[:52].any()
    j = np.asarray(js.grayscale_streamed(dn, strategy=_j(S.STANDARD),
                                         chunk_rows=CHUNK, mesh=jmesh))
    d = np.abs(got.numpy().astype(int) - j.astype(int))
    assert d.max() <= _level_bound(dn, S.STANDARD, BitDepth.U8)


def test_sharded_streamed_odd_rows_falls_back(rng, mesh, jmesh, caplog):
    """Rows that do not split evenly over the row axis run unsharded, with
    the JAX package's warning."""
    dn = sar_like(rng, (409, 176))
    want = ts.grayscale_streamed(_t(dn), strategy=S.CLAHE, chunk_rows=CHUNK)
    with caplog.at_level(logging.WARNING, logger="sarpro"):
        got = ts.grayscale_streamed(_t(dn), strategy=S.CLAHE,
                                    chunk_rows=CHUNK, mesh=mesh)
    _equal(got, want)
    msgs = [r.getMessage() for r in caplog.records]
    assert "streamed: 409 rows don't split evenly over 8 'row' devices; " \
        "running unsharded" in msgs
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="sarpro"):
        j = np.asarray(js.grayscale_streamed(dn, strategy=_j(S.CLAHE),
                                             chunk_rows=CHUNK, mesh=jmesh))
    assert [r.getMessage() for r in caplog.records] == msgs
    d = np.abs(got.numpy().astype(int) - j.astype(int))
    assert d.max() <= _level_bound(dn, S.CLAHE, BitDepth.U8)


@pytest.fixture
def big(monkeypatch):
    """BIG_SCENE_PIXELS at 100 in both packages: every scene is big."""
    monkeypatch.setattr(ts, "BIG_SCENE_PIXELS", 100)
    monkeypatch.setattr(js, "BIG_SCENE_PIXELS", 100)


def test_fast_path_big_scene_with_mesh_routes_to_sharded_streamed(
        tmp_path, monkeypatch, rng, big, mesh, jmesh):
    """A shard request on a big scene takes the streamed passes' mesh mode,
    and the file's coefficient blocks equal the unsharded run's."""
    seen, blocks = {}, []
    real = ts.synrgb_streamed

    def spy(*a, **k):
        seen["mesh"] = k.get("mesh")
        return real(*a, **k)

    monkeypatch.setattr(ts, "synrgb_streamed", spy)
    monkeypatch.setattr(tjpeg, "write_synrgb_jpeg_dct",
                        lambda o, c, r, co: blocks.append(co))
    dn1 = rng.integers(1, 60000, (48, 64)).astype(np.uint16)
    dn2 = rng.integers(1, 60000, (48, 64)).astype(np.uint16)
    for name, shard in (("ref.jpg", 0), ("shd.jpg", 8)):
        tfast.save_multiband_fast(
            _t(dn1), _t(dn2), tmp_path / name, OutputFormat.JPEG,
            BitDepth.U8, None, strategy=S.CLAHE, shard_devices=shard)
    assert seen["mesh"] is not None and seen["mesh"].shape["row"] == 8
    np.testing.assert_array_equal(blocks[0], blocks[1])
    # against the JAX package's mesh mode on the same pair
    j_mesh = j_make_mesh(8, shape=(1, 8))
    t_mesh = tmesh.make_mesh(8, shape=(1, 8), device="cpu")
    jb, tb = [], []
    for d, c in ((dn1, True), (dn2, False)):
        jb.append(np.asarray(js.band_u8_streamed(d, _j(S.CLAHE), None,
                                                 mesh=j_mesh)))
        tb.append(ts.band_u8_streamed(_t(d), S.CLAHE, None,
                                      mesh=t_mesh).numpy())
        assert np.abs(jb[-1].astype(int) - tb[-1].astype(int)).max() <= \
            _level_bound(d, S.CLAHE, BitDepth.U8)
    j_rgb = np.asarray(js.synrgb_streamed(dn1, dn2, _j(S.CLAHE),
                                          mesh=j_mesh))
    t_rgb = real(_t(dn1), _t(dn2), S.CLAHE, mesh=t_mesh).numpy()
    _synrgb_vs_jax(t_rgb, j_rgb, jb, tb, S.CLAHE, False)


def test_fast_path_big_gray_with_mesh(tmp_path, rng, big, jmesh):
    """The u16 Robust TIFF of a big scene under a shard request: the band
    equals the unsharded file's, and the JAX package's within its bound."""
    dn = rng.integers(1, 60000, (48, 64)).astype(np.uint16)
    ref, shd, jshd = (tmp_path / f"{n}.tiff" for n in ("ref", "shd", "j"))
    for out, shard in ((ref, 0), (shd, 8)):
        tfast.save_single_band_fast(_t(dn), out, OutputFormat.TIFF,
                                    BitDepth.U16, None, strategy=S.ROBUST,
                                    shard_devices=shard)
    assert ref.read_bytes() == shd.read_bytes()
    jfast.save_single_band_fast(dn, jshd, _j(OutputFormat.TIFF),
                                _j(BitDepth.U16), None,
                                strategy=_j(S.ROBUST), shard_devices=8)
    a = TiffReader(shd).read(1).astype(np.int64)
    b = TiffReader(jshd).read(1).astype(np.int64)
    assert np.abs(a - b).max() <= _level_bound(dn, S.ROBUST, BitDepth.U16)
