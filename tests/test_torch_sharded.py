"""The port's sharded programs (sarpro_tpu_torch/parallel/sharded.py) on an
8-entry CPU mesh, the cases of tests/test_sharded.py one for one.

Each case holds the port's sharded output bit-equal to the port's unsharded
program on every scene, and against the JAX package's sharded output on its
8-device CPU mesh within the bounds of the unsharded parity tests
(tests/test_torch_gray.py, tests/test_torch_clahe.py): the bands within
`_level_bound` (Tamed 1, CLAHE `BAND_BOUND`), and the JAX synRGB equal to
the port's combine stage of the JAX bands.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sarpro_tpu.core import fused as jf  # noqa: E402
from sarpro_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from sarpro_tpu.parallel import sharded as jsh  # noqa: E402
from sarpro_tpu_torch.core import fused as tf  # noqa: E402
from sarpro_tpu_torch.core import synthetic_rgb as tsyn  # noqa: E402
from sarpro_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from sarpro_tpu_torch.parallel import sharded as tsh  # noqa: E402
from sarpro_tpu_torch.types import AutoscaleStrategy, BitDepth  # noqa: E402
from test_stats import sar_like  # noqa: E402
from test_torch_clahe import BAND_BOUND  # noqa: E402
from test_torch_gray import _j, _level_bound  # noqa: E402

S = AutoscaleStrategy


@pytest.fixture(autouse=True)
def host_devices(monkeypatch):
    monkeypatch.setattr(tmesh, "HOST_DEVICE_COUNT", 8)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest should provide 8 virtual devices"
    return j_make_mesh(8)


@pytest.fixture
def mesh():
    return tmesh.make_mesh(8, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _equal(got, want, label=""):
    assert got.dtype == want.dtype and got.shape == want.shape, label
    if got.dtype == torch.uint16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    assert torch.equal(got, want), label


def _band_bound(x, strategy, bit_depth=BitDepth.U8):
    if strategy is S.TAMED:
        return 1
    if strategy is S.CLAHE and bit_depth is BitDepth.U8:
        return BAND_BOUND
    return _level_bound(x, strategy, bit_depth)


def _synrgb_vs_jax(j_rgb, vv, vh, strategy, target_size=None, pad=False):
    """The JAX package's sharded RGB against the port: each package's band
    stage within its bound, and the port's combine stage fed the JAX
    package's bands equal to the JAX RGB, but for the floor-40 table gap
    (ROADMAP queue 3 #2; the port's own RGB is its
    combine of its bands, held bit-equal by each case; a band that differs
    near the water floor may move the floor, so the two packages' RGB are
    compared through the same bands)."""
    jbs = []
    for dn, copol in ((vv, True), (vh, False)):
        kw = dict(copol=copol, target_size=target_size, pad=pad)
        jb = np.asarray(jf.synrgb_band_stage(dn, strategy=_j(strategy), **kw))
        tb = tf.synrgb_band_stage(_t(dn), strategy=strategy, **kw).numpy()
        rows, cols, filt = tf._plan_read_dims(*dn.shape, target_size)
        x = (tf._resample_dn(_t(dn), rows, cols, filt).numpy() if filt
             else dn.astype(np.float32))
        d = np.abs(jb.astype(int) - tb.astype(int))
        assert d.max() <= _band_bound(x, strategy)
        jbs.append(jb)
    got = tf.synrgb_combine_stage(*map(_t, jbs), strategy, None,
                                  "rgb").numpy()
    same = np.all(got == j_rgb, axis=-1)
    if strategy in (S.TAMED, S.CLAHE):
        b1, b2 = (b.astype(np.int64) for b in jbs)
        hist = np.bincount(np.concatenate([b1.ravel(), b2.ravel()]),
                           minlength=256)
        if tsyn.FLOOR_MAX == int(jf._suppressed_floor(hist, 2 * b1.size)):
            gap = floor40_gap(b1, b2)
            assert not (~same & ~gap).any()
            same |= gap
    assert same.all()


def floor40_gap(b1, b2):
    """Pixels of u8 bands (b1, b2) whose suppressed compose at floor 40
    reads a table entry where the JAX program's in-graph tables differ from
    the host tables the port uses (1 green and 6 blue entries,
    tests/test_torch_tables.py)."""
    b1, b2 = (np.asarray(b).astype(np.int64) for b in (b1, b2))
    lut_g, lut_b = (np.asarray(a).astype(np.int64) for a in
                    jf._suppressed_luts(jnp.float32(40))[1:])
    _, host_g, host_b = tsyn.suppressed_luts(40)
    return ((lut_g != host_g)[b2]
            | (lut_b != host_b.astype(np.int64))[b1 * 256 + b2])


def test_mesh_shape(mesh):
    assert mesh.shape["scene"] * mesh.shape["row"] == 8
    assert mesh.shape["row"] >= 2  # real row sharding, not a trivial axis
    assert mesh.shape == dict(j_make_mesh(8).shape)
    assert all(d == torch.device("cpu") for r in mesh.devices for d in r)


def _scenes(rng, n, shape):
    return np.stack([sar_like(rng, shape) for _ in range(n)])


def test_sharded_synrgb_matches_single_device(rng, mesh, jmesh):
    """CLAHE synRGB: the tile and percentile histograms sum as integers, so
    every scene equals the unsharded program bit for bit."""
    n_scene = mesh.shape["scene"]
    rows = 64 * mesh.shape["row"]
    vv, vh = _scenes(rng, n_scene, (rows, 96)), _scenes(rng, n_scene,
                                                        (rows, 96))
    out = tsh.synrgb_batch(vv, vh, mesh, strategy=S.CLAHE, target_size=None)
    assert out.shape == (n_scene, rows, 96, 3)
    jout = np.asarray(jsh.synrgb_batch(vv, vh, jmesh,
                                       strategy=_j(S.CLAHE),
                                       target_size=None))
    for i in range(n_scene):
        _equal(out[i], tf.synrgb_pipeline(_t(vv[i]), _t(vh[i]),
                                          strategy=S.CLAHE, target_size=None))
        _synrgb_vs_jax(jout[i], vv[i], vh[i], S.CLAHE)


@pytest.mark.parametrize("strategy,bit_depth", [(S.ROBUST, BitDepth.U16)])
def test_sharded_grayscale_batch(rng, mesh, jmesh, strategy, bit_depth):
    n_scene = mesh.shape["scene"]
    rows = 32 * mesh.shape["row"]
    dn = _scenes(rng, n_scene, (rows, 64))
    out = tsh.grayscale_batch(dn, mesh, strategy=strategy,
                              bit_depth=bit_depth)
    assert out.shape == (n_scene, rows, 64)
    jout = np.asarray(jsh.grayscale_batch(dn, jmesh, strategy=_j(strategy),
                                          bit_depth=_j(bit_depth)))
    for i in range(n_scene):
        _equal(out[i], tf.grayscale_pipeline(_t(dn[i]), strategy=strategy,
                                             bit_depth=bit_depth))
        d = np.abs(out[i].numpy().astype(np.int64) - jout[i].astype(np.int64))
        assert d.max() <= _level_bound(dn[i], strategy, bit_depth)


def test_sharded_adaptive_bit_identical(rng, mesh, jmesh):
    """Adaptive's mean and std derive from the summed integer histogram, so
    the sharded program equals the unsharded one exactly."""
    n_scene = mesh.shape["scene"]
    rows = 32 * mesh.shape["row"]
    dn = _scenes(rng, n_scene, (rows, 64))
    out = tsh.grayscale_batch(dn, mesh, strategy=S.ADAPTIVE,
                              bit_depth=BitDepth.U8)
    jout = np.asarray(jsh.grayscale_batch(dn, jmesh,
                                          strategy=_j(S.ADAPTIVE),
                                          bit_depth=_j(BitDepth.U8)))
    for i in range(n_scene):
        _equal(out[i], tf.grayscale_pipeline(_t(dn[i]), strategy=S.ADAPTIVE,
                                             bit_depth=BitDepth.U8))
        d = np.abs(out[i].numpy().astype(int) - jout[i].astype(int))
        assert d.max() <= _level_bound(dn[i], S.ADAPTIVE, BitDepth.U8)


def test_gspmd_fallback_resample_pad_matches_unsharded(rng, mesh, jmesh):
    """The resample + pad config: the axis-0 resample split by output rows
    over each scene's row devices, the rest on the scene's lead. The
    scenes are 5 times the JAX case's side, so CLAHE's tiles of the 256
    output are 21 x 32 pixels: at the JAX case's 8 x 12, one pixel that
    moves a bin moves its tile's CDF by up to 1/96, past the band bound
    (ROADMAP queue 3 #2, "CLAHE at 5 x 5-pixel tiles")."""
    n_scene = mesh.shape["scene"]
    rows = 240 * mesh.shape["row"]
    vv, vh = _scenes(rng, n_scene, (rows, 720)), _scenes(rng, n_scene,
                                                         (rows, 720))
    out = tsh.synrgb_batch(vv, vh, mesh, strategy=S.CLAHE, target_size=256,
                           pad=True)
    assert out.shape == (n_scene, 256, 256, 3)
    jout = np.asarray(jsh.synrgb_batch(vv, vh, jmesh, strategy=_j(S.CLAHE),
                                       target_size=256, pad=True))
    for i in range(n_scene):
        _equal(out[i], tf.synrgb_pipeline(_t(vv[i]), _t(vh[i]),
                                          strategy=S.CLAHE, target_size=256,
                                          pad=True))
        _synrgb_vs_jax(jout[i], vv[i], vh[i], S.CLAHE, 256,
                       True)


def test_gspmd_fallback_grayscale_target_size(rng, mesh, jmesh):
    n_scene = mesh.shape["scene"]
    rows = 48 * mesh.shape["row"]
    dn = _scenes(rng, n_scene, (rows, 120))
    kw = dict(strategy=S.STANDARD, bit_depth=BitDepth.U8, target_size=64,
              pad=True)
    out = tsh.grayscale_batch(dn, mesh, **kw)
    assert out.shape == (n_scene, 64, 64)
    jout = np.asarray(jsh.grayscale_batch(
        dn, jmesh, **{**kw, "strategy": _j(S.STANDARD),
                      "bit_depth": _j(BitDepth.U8)}))
    for i in range(n_scene):
        _equal(out[i], tf.grayscale_pipeline(_t(dn[i]), **kw))
        r, c, filt = tf._plan_read_dims(rows, 120, 64)
        x = tf._resample_dn(_t(dn[i]), r, c, filt).numpy()
        d = np.abs(out[i].numpy().astype(int) - jout[i].astype(int))
        assert d.max() <= _level_bound(x, S.STANDARD, BitDepth.U8)


def test_graft_entry_contract(mesh, jmesh):
    """The JAX package's multi-chip dry run (__graft_entry__.
    dryrun_multichip) on the port: CLAHE synRGB of a scene batch in RGB and
    in JPEG DCT blocks, each equal to the unsharded program, the shapes
    the JAX dry run's. On these inputs the JAX dry run itself differs from
    the JAX program of each scene (0 to 6 pixels: its two programs compile
    apart), so the port is held to the JAX program of each scene within
    the parity bounds."""
    n_scene, n_row = mesh.shape["scene"], mesh.shape["row"]
    rows = 64 * n_row
    rng = np.random.default_rng(0)
    vv = rng.lognormal(5.0, 1.1, (n_scene, rows, 96)).astype(np.float32)
    vh = rng.lognormal(4.2, 1.1, (n_scene, rows, 96)).astype(np.float32)
    out = tsh.synrgb_batch(vv, vh, mesh, strategy=S.CLAHE, target_size=None)
    assert out.shape == (n_scene, rows, 96, 3)
    dct = tsh.synrgb_batch(vv, vh, mesh, strategy=S.CLAHE, target_size=None,
                           channel_order="dct")
    assert dct.shape == (n_scene, 3, rows // 8, 12, 8, 8)
    jout = jsh.synrgb_batch(vv, vh, jmesh, strategy=_j(S.CLAHE),
                            target_size=None)
    assert tuple(jout.shape) == tuple(out.shape)
    for i in range(n_scene):
        one = dict(strategy=S.CLAHE, target_size=None)
        _equal(out[i], tf.synrgb_pipeline(_t(vv[i]), _t(vh[i]), **one))
        _equal(dct[i], tf.synrgb_pipeline(_t(vv[i]), _t(vh[i]),
                                          channel_order="dct", **one))
        _synrgb_vs_jax(np.asarray(jf.synrgb_pipeline(
            vv[i], vh[i], strategy=_j(S.CLAHE), target_size=None)),
            vv[i], vh[i], S.CLAHE)


def test_shardmap_clahe_tile_straddles_shard_boundary(rng, mesh, jmesh):
    """Row blocks that cut through CLAHE tile rows (rows = 328, tile_h =
    41, a 2-way row axis: the boundary at 164 is mid-tile): the summed tile
    histograms and the lookup at each block's global row offset agree with
    the unsharded program."""
    n_scene = mesh.shape["scene"]
    rows = 41 * mesh.shape["row"] * 2
    vv, vh = _scenes(rng, n_scene, (rows, 96)), _scenes(rng, n_scene,
                                                        (rows, 96))
    out = tsh.synrgb_batch(vv, vh, mesh, strategy=S.CLAHE, target_size=None)
    jout = np.asarray(jsh.synrgb_batch(vv, vh, jmesh, strategy=_j(S.CLAHE),
                                       target_size=None))
    for i in range(n_scene):
        _equal(out[i], tf.synrgb_pipeline(_t(vv[i]), _t(vh[i]),
                                          strategy=S.CLAHE, target_size=None))
        _synrgb_vs_jax(jout[i], vv[i], vh[i], S.CLAHE)


def test_shardmap_tamed_and_equalized(rng, mesh, jmesh):
    """Tamed (the band-specific window, the suppressed compose's summed
    histogram) and Equalized (the default compose) through the full-
    resolution path."""
    n_scene = mesh.shape["scene"]
    rows = 32 * mesh.shape["row"]
    vv, vh = _scenes(rng, n_scene, (rows, 64)), _scenes(rng, n_scene,
                                                        (rows, 64))
    for strat in (S.TAMED, S.EQUALIZED):
        out = tsh.synrgb_batch(vv, vh, mesh, strategy=strat,
                               target_size=None)
        jout = np.asarray(jsh.synrgb_batch(vv, vh, jmesh, strategy=_j(strat),
                                           target_size=None))
        for i in range(n_scene):
            _equal(out[i], tf.synrgb_pipeline(_t(vv[i]), _t(vh[i]),
                                              strategy=strat,
                                              target_size=None), str(strat))
            _synrgb_vs_jax(jout[i], vv[i], vh[i], strat)


def test_gspmd_fallback_ycbcr_planar_sharding(rng, mesh, jmesh):
    """channel_order ycbcr: planar (scene, 3, rows, cols), the planes of the
    RGB output, and equal to the JAX package's wherever the two RGB agree."""
    n_scene = mesh.shape["scene"]
    vv, vh = _scenes(rng, n_scene, (96, 144)), _scenes(rng, n_scene,
                                                       (96, 144))
    kw = dict(strategy=S.CLAHE, target_size=96, pad=True)
    out = tsh.synrgb_batch(vv, vh, mesh, channel_order="ycbcr", **kw)
    assert out.shape == (n_scene, 3, 96, 96)
    rgb = tsh.synrgb_batch(vv, vh, mesh, channel_order="rgb", **kw)
    jkw = {**kw, "strategy": _j(S.CLAHE)}
    j_out = np.asarray(jsh.synrgb_batch(vv, vh, jmesh, channel_order="ycbcr",
                                        **jkw))
    j_rgb = np.asarray(jsh.synrgb_batch(vv, vh, jmesh, channel_order="rgb",
                                        **jkw))
    for i in range(n_scene):
        _equal(out[i], tf.synrgb_pipeline(_t(vv[i]), _t(vh[i]),
                                          channel_order="ycbcr", **kw))
        _equal(out[i], tf.ycbcr_planes(rgb[i]))
        same = np.all(rgb[i].numpy() == j_rgb[i], axis=-1)
        assert same.mean() > 0.5
        np.testing.assert_array_equal(out[i].numpy()[:, same],
                                      j_out[i][:, same])
