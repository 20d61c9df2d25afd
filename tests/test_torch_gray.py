"""The port's other strategies, default synRGB, grayscale program and the
single-band, operation and TIFF routes against the JAX package, on the CPU.

Tolerances, each checked below:
  * exact where inputs are identical: `_quantize` at gamma 1, default synRGB
    and the bgr order on identical bands;
  * `_quantize` at gamma 0.8 / 0.9 / 1.1 fed the JAX package's own dB and
    window: within 1 level on under 1e-4 of pixels (f32 `pow` differs by an
    ulp between XLA and PyTorch);
  * from DN (`_band_u8`, `grayscale_pipeline`, whole CLI routes): XLA's f32
    `log` is off by an ulp on about 2 % of values, which can move a
    percentile by one 4096-bin step and so the window. `_level_bound` turns
    one such step at each end of the window into levels through the
    strategy's gamma, plus 1 for the trunc; for CLAHE one CLAHE bin of
    shift moves a pixel by less than (CLIP_LIMIT + 1) / 256 of the range.
    Measured on these inputs: u8 within 1 (CLAHE 2), u16 within 1 (CLAHE
    529), every case under its bound; other seeds moved a u16 level by up
    to 17 where a percentile moved;
  * JPEG DCT blocks within 1 wherever the two bands' 8x8 blocks agree (the
    f32 matmul against the JAX program's 3-term bf16 split).
"""
import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fixtures  # noqa: E402
from sarpro_tpu import api as japi  # noqa: E402
from sarpro_tpu.cli import _params_from_args, build_parser  # noqa: E402
from sarpro_tpu.core import clahe as jclahe  # noqa: E402
from sarpro_tpu.core import fused as jf  # noqa: E402
from sarpro_tpu.io.safe import SafeReader  # noqa: E402
from sarpro_tpu import types as jtypes  # noqa: E402
from sarpro_tpu_torch import cli as tcli  # noqa: E402
from sarpro_tpu_torch.core import fused as tf  # noqa: E402
from sarpro_tpu_torch.errors import ProcessingError  # noqa: E402
from sarpro_tpu_torch.io import safe as tsafe  # noqa: E402
from sarpro_tpu_torch.io.tiffio import TiffReader  # noqa: E402
from sarpro_tpu_torch.io.writers import jpeg as tjpeg  # noqa: E402
from sarpro_tpu_torch.types import AutoscaleStrategy, BitDepth  # noqa: E402

S = AutoscaleStrategy
STRATEGIES = list(AutoscaleStrategy)


def _j(e):
    """The JAX package's member of the enum member `e` names (each package
    takes its own enums)."""
    return getattr(jtypes, type(e).__name__)(e.value)


def _jkw(kw):
    return {k: _j(v) if k in ("strategy", "bit_depth") else v
            for k, v in kw.items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _dn(rng, shape, mean):
    dn = np.clip(rng.lognormal(mean, 1.1, shape), 0, 65535).astype(np.uint16)
    dn[rng.random(shape) < 0.02] = 0
    return dn


def _level_bound(x, strategy, bit_depth):
    """Levels the port may differ by from the JAX program on raster `x` (at
    size, f32): see the module docstring."""
    max_val = bit_depth.max_val
    if strategy.value == "clahe":
        return 1 + math.ceil(max_val * (jclahe.CLIP_LIMIT + 1)
                             / jclahe.CLAHE_BINS)
    db, mask = jax.jit(jf._db_mask)(jnp.asarray(x, jnp.float32))
    s = jax.jit(jf._stats)(db, mask)
    low, high, gamma = (float(v) for v in jf._window(s, _j(strategy)))
    step = (float(s["max"]) - float(s["min"])) / jf.NUM_BINS
    d = min(2 * step / max(high - low, 1.0), 1.0)
    shift = d ** gamma if gamma < 1 else gamma * d
    if bit_depth.value == "u8":
        # the 0..255 values are stretched to the full u8 range
        q = np.asarray(jax.jit(jf._quantize)(db, mask, low, high, gamma,
                                             jnp.float32(255.0)))
        shift *= 255.0 / max(float(q.max()) - float(q.min()), 1.0)
    return 1 + math.ceil(max_val * shift)


# ---------------------------------------------------------------------------
# _quantize, the band stage and the grayscale program
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def db_and_mask():
    rng = np.random.default_rng(3)
    x = rng.lognormal(5.0, 1.1, 2_000_000).astype(np.float32)
    x[rng.random(x.size) < 0.03] = 0.0
    db, mask = jax.jit(jf._db_mask)(x)
    return np.array(db), np.array(mask)


@pytest.mark.parametrize("max_val", [255.0, 65535.0])
@pytest.mark.parametrize("gamma", [1.0, 0.8, 0.9, 1.1])
def test_quantize_on_jax_db_and_window(db_and_mask, gamma, max_val):
    db, mask = db_and_mask
    low, high, g = np.float32(-3.2), np.float32(31.7), np.float32(gamma)
    want = np.asarray(jax.jit(jf._quantize)(db, mask, low, high, g,
                                            np.float32(max_val)))
    got = tf._quantize(_t(db), _t(mask), _t(low), _t(high), _t(g), max_val)
    assert got.dtype == torch.float32
    d = np.abs(got.numpy().astype(np.int64) - want.astype(np.int64))
    print(f"gamma {gamma} max {max_val}: share differing {(d > 0).mean():.2e}")
    if gamma == 1.0:
        assert d.max() == 0
    else:
        assert d.max() <= 1 and (d > 0).mean() < 1e-4


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_band_u8_every_strategy(rng, strategy):
    """The synRGB band stage of every strategy (Tamed takes its
    band-specific window, the others `_band_u8`'s dispatch)."""
    for copol, mean in ((True, 5.0), (False, 4.2)):
        dn = _dn(rng, (500, 620), mean)
        kw = dict(strategy=strategy, copol=copol, target_size=200, pad=True,
                  resample_alg="cubic")
        want = np.asarray(jf.synrgb_band_stage(dn, **_jkw(kw)))
        got = tf.synrgb_band_stage(_t(dn), **kw).numpy()
        assert got.shape == want.shape == (200, 200) and got.dtype == np.uint8
        x = tf._resample_dn(_t(dn), 161, 200, "cubic").numpy()
        bound = (1 if strategy is S.TAMED
                 else _level_bound(x, strategy, BitDepth.U8))
        d = np.abs(got.astype(int) - want.astype(int))
        print(f"{strategy.value} copol={copol}: max|diff| {d.max()} "
              f"(bound {bound}), share differing {(d > 0).mean():.2e}")
        assert d.max() <= bound


@pytest.mark.parametrize("bit_depth", list(BitDepth))
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("shape,size,alg,pad", [
    ((333, 517), 300, None, True),
    ((240, 200), None, None, False),
])
def test_grayscale_pipeline(rng, strategy, bit_depth, shape, size, alg, pad):
    dn = _dn(rng, shape, 4.6)
    kw = dict(strategy=strategy, bit_depth=bit_depth, target_size=size,
              pad=pad, resample_alg=alg)
    want = np.asarray(jf.grayscale_pipeline(dn, **_jkw(kw)))
    got = tf.grayscale_pipeline(_t(dn), **kw).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    rows, cols, filt = tf._plan_read_dims(*shape, size, alg)
    x = (tf._resample_dn(_t(dn), rows, cols, filt).numpy() if filt
         else dn.astype(np.float32))
    bound = _level_bound(x, strategy, bit_depth)
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    print(f"{strategy.value} {bit_depth.value} {shape}->{size}: max|diff| "
          f"{d.max()} (bound {bound}), share differing {(d > 0).mean():.2e}")
    assert d.max() <= bound


def test_grayscale_pipeline_jpeg_dct(rng):
    """The DCT tail: the port's blocks of its own band equal
    `jpeg_dct_planes` of it, and are within 1 of the JAX program's blocks
    wherever the two u8 bands agree on the whole block."""
    dn = _dn(rng, (300, 410), 5.0)
    kw = dict(strategy=S.STANDARD, target_size=203, pad=True)
    band_j = np.asarray(jf.grayscale_pipeline(dn, **_jkw(kw)))
    band_t = tf.grayscale_pipeline(_t(dn), **kw)
    dct_j = np.asarray(jf.grayscale_pipeline(dn, jpeg_dct=True, **_jkw(kw)))
    dct_t = tf.grayscale_pipeline(_t(dn), jpeg_dct=True, **kw).numpy()
    assert dct_t.shape == dct_j.shape == (26, 26, 8, 8)
    np.testing.assert_array_equal(
        dct_t, tf.jpeg_dct_planes(band_t[None])[0].numpy())
    agree = _block_agree(band_t.numpy(), band_j)
    assert agree.mean() > 0.5
    assert np.abs(dct_t.astype(int) - dct_j.astype(int))[agree].max() <= 1
    with pytest.raises(ValueError):
        tf.grayscale_pipeline(_t(dn), bit_depth=BitDepth.U16, jpeg_dct=True)


def _block_agree(a, b):
    """(bh, bw) mask of the 8x8 blocks where two u8 planes agree (edge
    blocks replicated like the encoder's)."""
    same = a == b
    h, w = same.shape
    same = np.pad(same, ((0, -h % 8), (0, -w % 8)), mode="edge")
    return same.reshape(same.shape[0] // 8, 8, -1, 8).all(axis=(1, 3))


# ---------------------------------------------------------------------------
# default synRGB and the bgr order
# ---------------------------------------------------------------------------
def _u8_pair(rng, shape=(96, 130)):
    b1 = rng.integers(0, 256, shape).astype(np.uint8)
    b2 = rng.integers(0, 256, shape).astype(np.uint8)
    b2[rng.random(shape) < 0.1] = 0  # the b2 == 0 column of the blue LUT
    return b1, b2


def test_synrgb_default_exact(rng):
    b1, b2 = _u8_pair(rng)
    want = np.asarray(jax.jit(jf._synrgb_default)(b1, b2))
    got = tf._synrgb_default(_t(b1), _t(b2)).numpy()
    assert got.shape == b1.shape + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert not got[b2 == 0][:, 2].any()
    # every (b1, b2) pair once
    a = np.arange(256, dtype=np.uint8)
    p1, p2 = np.repeat(a, 256), np.tile(a, 256)
    np.testing.assert_array_equal(
        tf._synrgb_default(_t(p1), _t(p2)).numpy(),
        np.asarray(jax.jit(jf._synrgb_default)(p1, p2)))


@pytest.mark.parametrize("suppressed", [False, True])
def test_bgr_is_reversed_rgb(rng, suppressed):
    b1, b2 = _u8_pair(rng)
    rgb = tf._synrgb_combine(_t(b1), _t(b2), S.ROBUST, suppressed, "rgb")
    bgr = tf._synrgb_combine(_t(b1), _t(b2), S.ROBUST, suppressed, "bgr")
    np.testing.assert_array_equal(bgr.numpy(), rgb.numpy()[..., ::-1])
    want = np.asarray(jf.synrgb_combine_stage(b1, b2, _j(S.ROBUST),
                                              suppressed, "bgr"))
    np.testing.assert_array_equal(bgr.numpy(), want)


@pytest.mark.parametrize("strategy", [S.STANDARD, S.ADAPTIVE, S.DEFAULT])
def test_combine_stage_default_mode(rng, strategy):
    """Strategies other than Tamed and CLAHE compose in the default mode."""
    b1, b2 = _u8_pair(rng, (64, 72))
    for order in ("rgb", "ycbcr", "dct"):
        want = np.asarray(jf.synrgb_combine_stage(b1, b2, _j(strategy),
                                                  None, order))
        got = tf.synrgb_combine_stage(_t(b1), _t(b2), strategy, None,
                                      order).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        if order == "dct":
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the reader's single-band and all_pairs loads
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return fixtures.make_safe(tmp_path_factory.mktemp("gray"),
                              shape=(600, 800))


@pytest.fixture(scope="module")
def scene_hh(tmp_path_factory):
    return fixtures.make_safe(tmp_path_factory.mktemp("gray_hh"),
                              name="S1A_EW_GRDM_1SDH_20250706T204346.SAFE",
                              pols=("hh", "hv"), shape=(300, 400), seed=11,
                              with_affine_geotransform=True)


# the decimated read: average for >= 4x, lanczos below, or the user's filter
@pytest.mark.parametrize("pol,size,alg", [
    ("vv", 128, None), ("vh", 300, None), ("vv", 200, "cubic"),
    ("vh", 150, "nearest"), ("vv", None, None)])
def test_open_band_matches_jax_reader(scene, pol, size, alg):
    ref = SafeReader.open_with_options(scene, pol, None, alg, size)
    meta, band = tsafe.open_band(scene, pol, "cpu", size, resample_alg=alg)
    want = np.asarray(getattr(ref, f"{pol}_data")())
    assert band.shape == want.shape
    if alg == "nearest" or size is None:
        np.testing.assert_array_equal(band.numpy().astype(np.float32), want)
    else:  # the resample's f32 tap sums, reduced in another order
        np.testing.assert_allclose(band.numpy(), want, rtol=2e-6, atol=2e-2)
    for k in ("polarizations", "lines", "samples", "geotransform",
              "projection", "crs"):
        assert getattr(meta, k) == getattr(ref.metadata, k), k
    assert meta.polarizations == [pol.upper()]


def test_open_pair_prefers_vvvh_then_hhhv(scene, scene_hh):
    for safe, want in ((scene, True), (scene_hh, False)):
        pair = tsafe.open_pair(safe, "cpu", "Multiband", 100)
        assert pair.is_vvvh is want
        assert pair.metadata.polarizations == ["VV", "VH", "HH", "HV"]


def test_open_pair_error_text_matches_jax(tmp_path):
    from sarpro_tpu.errors import ProcessingError as JProcessingError

    safe = fixtures.make_safe(tmp_path, pols=("vv",), shape=(40, 50))
    ref = SafeReader.open_with_options(safe, "all_pairs", None, None, None)
    with pytest.raises(JProcessingError) as j_err:
        japi._op_band(ref, japi.PolarizationOperation.RATIO)
    with pytest.raises(ProcessingError) as t_err:
        tsafe.open_pair(safe, "cpu", "Operation ratio")
    assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# whole CLI routes against the JAX package's --fast route
# ---------------------------------------------------------------------------
@pytest.fixture
def captured(monkeypatch):
    calls = []

    def capture(output, cols, rows, coeffs):
        calls.append((cols, rows, coeffs))
        open(output, "wb").close()

    monkeypatch.setattr(tjpeg, "write_gray_jpeg_dct", capture)
    monkeypatch.setattr(tjpeg, "write_synrgb_jpeg_dct", capture)
    return calls


def _run_both(safe, tmp_path, args, ext):
    t_out, j_out = tmp_path / "t" / f"out.{ext}", tmp_path / "j" / f"out.{ext}"
    t_out.parent.mkdir()
    j_out.parent.mkdir()
    argv = ["-i", str(safe), "--fast"] + args
    assert tcli.run(argv + ["-o", str(t_out)], device="cpu") == 0
    japi.process_safe_to_path(
        safe, j_out,
        _params_from_args(build_parser().parse_args(argv + ["-o",
                                                            str(j_out)])),
        fast=True)
    return t_out, j_out


def _jax_band(safe, args):
    """The raster the JAX route's grayscale program sees: its reader's
    band, or its operation over the reader's (already reduced) pair."""
    params = _params_from_args(build_parser().parse_args(
        ["-i", str(safe), "-o", "x"] + args))
    target, resample = japi._resolve_target_args(params)
    ref = SafeReader.open_with_options(
        safe, japi._pol_to_reader_hint(params.polarization), target,
        resample, params.size)
    pol = params.polarization
    if pol.kind in ("vv", "vh", "hh", "hv"):
        return params, np.asarray(japi._single_band(ref, pol))
    if pol.kind == "op":
        return params, np.asarray(japi._op_band(ref, pol.op))
    b1, b2, _ = japi._band_pair(ref, "Multiband")
    return params, (np.asarray(b1), np.asarray(b2))


TIFF_ROUTES = {
    "vv u8 clahe": ["--polarization", "vv", "-f", "tiff", "--autoscale",
                    "clahe", "--size", "128"],
    "vh u16 adaptive cubic": ["--polarization", "vh", "-f", "tiff",
                              "--bit-depth", "u16", "--autoscale",
                              "adaptive", "--size", "300",
                              "--resample-alg", "cubic"],
    "multiband u8 robust": ["--polarization", "multiband", "-f", "tiff",
                            "--autoscale", "robust", "--size", "128"],
    "multiband u16 standard pad": ["--polarization", "multiband", "-f",
                                   "tiff", "--bit-depth", "u16",
                                   "--autoscale", "standard", "--size",
                                   "200", "--pad"],
    "sum u8 equalized": ["--polarization", "sum", "-f", "tiff",
                         "--autoscale", "equalized", "--size", "160"],
}


@pytest.mark.parametrize("route", list(TIFF_ROUTES))
def test_cli_tiff_route_matches_jax(scene, tmp_path, route):
    args = TIFF_ROUTES[route]
    t_out, j_out = _run_both(scene, tmp_path, args, "tiff")
    _compare_tiffs(scene, args, t_out, j_out)


def test_cli_hh_route_on_hhhv_product(scene_hh, tmp_path):
    """The CLI's defaults (u8 TIFF, CLAHE, original size) on HH, from a
    product with an affine geotransform, which the TIFF carries."""
    args = ["--polarization", "hh"]
    t_out, j_out = _run_both(scene_hh, tmp_path, args, "tiff")
    _compare_tiffs(scene_hh, args, t_out, j_out)
    t = TiffReader(t_out)
    assert t.read(1).shape == (300, 400)
    assert t.geo_info().geotransform is not None
    assert t.gdal_metadata()["POLARIZATIONS"] == "HH"


def _compare_tiffs(safe, args, t_out, j_out):
    params, raster = _jax_band(safe, args)
    rasters = raster if isinstance(raster, tuple) else (raster,)
    t, j = TiffReader(t_out), TiffReader(j_out)
    assert t.samples == j.samples == len(rasters)
    for i, x in enumerate(rasters, 1):
        a, b = t.read(i), j.read(i)
        assert a.dtype == b.dtype and a.shape == b.shape
        bound = _level_bound(x, params.autoscale,
                             params.bit_depth.to_bit_depth())
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        print(f"band {i} {a.dtype}: max|diff| {d.max()} (bound {bound}), "
              f"share differing {(d > 0).mean():.2e}")
        assert d.max() <= bound
    assert t.geo_info() == j.geo_info()
    # every item but the time of the write
    t_meta, j_meta = t.gdal_metadata(), j.gdal_metadata()
    assert t_meta.pop("CONVERSION_TIMESTAMP") and j_meta.pop(
        "CONVERSION_TIMESTAMP")
    assert t_meta == j_meta


JPEG_ROUTES = {
    "ratio standard": ["--polarization", "ratio", "-f", "jpeg",
                       "--autoscale", "standard", "--size", "128"],
    "n-diff robust pad": ["--polarization", "n-diff", "-f", "jpeg",
                          "--autoscale", "robust", "--size", "150", "--pad"],
    "vv clahe auto cubic": ["--polarization", "vv", "-f", "jpeg",
                            "--autoscale", "clahe", "--size", "128",
                            "--target-crs", "auto", "--resample-alg",
                            "cubic"],
}


@pytest.mark.parametrize("route", list(JPEG_ROUTES))
def test_cli_gray_jpeg_route_matches_jax(scene, captured, tmp_path, route):
    args = JPEG_ROUTES[route]
    t_out, j_out = _run_both(scene, tmp_path, args, "jpg")
    (cols, rows, coeffs), = captured
    _compare_sidecars(t_out, j_out)
    params, x = _jax_band(scene, args)
    kw = dict(strategy=params.autoscale, target_size=params.size,
              pad=params.pad)
    band_j = np.asarray(jf.grayscale_pipeline(x, **kw))
    dct_j = np.asarray(jf.grayscale_pipeline(x, jpeg_dct=True, **kw))
    band_t = tf.grayscale_pipeline(
        _t(x), **{**kw, "strategy": S(params.autoscale.value)}).numpy()
    assert (rows, cols) == band_j.shape and coeffs.shape == dct_j.shape
    bound = _level_bound(x, params.autoscale, BitDepth.U8)
    d = np.abs(band_t.astype(int) - band_j.astype(int))
    print(f"{route}: band max|diff| {d.max()} (bound {bound})")
    assert d.max() <= bound
    agree = _block_agree(band_t, band_j)
    assert agree.mean() > 0.2
    assert np.abs(coeffs.astype(int) - dct_j.astype(int))[agree].max() <= 1
    if "auto" in route:
        assert "UTM zone 32N" in t_out.with_suffix(".prj").read_text()


def _compare_sidecars(t_out, j_out):
    """Byte-identical sidecars, but for the value of the JSON's
    conversion_timestamp: the time each package's write stamps."""
    for ext in (".jgw", ".prj", ".json"):
        t, j = (re.sub(rb'"conversion_timestamp": "[^"]*"', b'""',
                       o.with_suffix(ext).read_bytes()) for o in (t_out, j_out))
        assert t == j, ext


def test_cli_multiband_jpeg_default_synrgb(scene, captured, tmp_path):
    """Multiband standard takes the default synRGB mode."""
    args = ["--polarization", "multiband", "-f", "jpeg", "--autoscale",
            "standard", "--size", "128", "--pad"]
    t_out, j_out = _run_both(scene, tmp_path, args, "jpg")
    (cols, rows, coeffs), = captured
    assert (cols, rows) == (128, 128)
    _compare_sidecars(t_out, j_out)
    meta = json.loads(t_out.with_suffix(".json").read_text())
    assert "VV" in json.dumps(meta)
    vv, vh = (TiffReader(next((scene / "measurement").glob(f"*-{p}-*")))
              .read(1).astype(np.uint16) for p in ("vv", "vh"))
    kw = dict(strategy=S.STANDARD, target_size=128, pad=True)
    jb = [np.asarray(jf.synrgb_band_stage(d, copol=c, **_jkw(kw)))
          for d, c in ((vv, True), (vh, False))]
    tb = [tf.synrgb_band_stage(_t(d), copol=c, **kw)
          for d, c in ((vv, True), (vh, False))]
    j_rgb = np.asarray(jf.synrgb_combine_stage(jb[0], jb[1],
                                               _j(S.STANDARD), None, "rgb"))
    j_dct = np.asarray(jf.synrgb_combine_stage(jb[0], jb[1],
                                               _j(S.STANDARD), None, "dct"))
    t_rgb = tf.synrgb_combine_stage(tb[0], tb[1], S.STANDARD, None,
                                    "rgb").numpy()
    both = (jb[0] == tb[0].numpy()) & (jb[1] == tb[1].numpy())
    np.testing.assert_array_equal(t_rgb[both], j_rgb[both])
    agree = _block_agree(np.all(t_rgb == j_rgb, -1), np.True_)
    assert agree.mean() > 0.5
    assert np.abs(coeffs.astype(int) - j_dct.astype(int))[:, agree].max() <= 1
    np.testing.assert_array_equal(
        coeffs, tf.synrgb_combine_stage(tb[0], tb[1], S.STANDARD, None,
                                        "dct").numpy())
