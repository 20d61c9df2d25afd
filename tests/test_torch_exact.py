"""The port's exact mode (the CLI and API default without --fast) against
the JAX package's exact mode, on the CPU.

The JAX side runs as its own tests run it: on XLA's CPU backend, with its
Pallas kernels replaced by their XLA fallbacks. Inputs come from seeded
numpy generators and the fixture SAFEs (48 x 64, and a ragged 37 x 53 HH+HV
product with an affine geotransform).

Tolerances, each checked below:
  * the stats assembled from identical dB: count, min, max, the 4096-bin
    histogram and every percentile exact; mean and std (from f32 sums that
    PyTorch adds in another order than XLA) to a relative 1e-6;
  * the device passes fed the JAX package's own dB, mask and stats: exact,
    but for the CLAHE lookup (XLA contracts its blend into FMAs, queue 3's
    1e-6), within 1 level, and a window gamma other than 1 (f32 `pow`
    differs by an ulp), within 1 level on under 1e-3 of pixels;
  * synRGB on identical u8 bands: exact, default and suppressed;
  * whole routes: the bands within one 4096-bin window step through the
    strategy's gamma plus 1 (a log ulp can move a percentile by one bin),
    CLAHE within one CLAHE bin of window shift plus 1 (queue 3 #2); TIFFs
    byte-identical, gray JPEGs byte-identical to the JAX package's native
    stream, wherever the arrays are equal; synRGB JPEGs by their RGB array
    (equal wherever both bands are), with the file's coefficients within
    +-1 of an f64 DCT of the port's YCbCr planes (chip_smoke.py's check).

Both packages code gray JPEGs and reduce on read in the same native
library here (the JAX package's own is not built; the `native_both`
fixture hands it the port's build of the same sources).
"""
import dataclasses
import datetime
import functools
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fixtures  # noqa: E402
from sarpro_tpu import _native as jnative  # noqa: E402
from sarpro_tpu import api as japi  # noqa: E402
from sarpro_tpu import types as jtypes  # noqa: E402
from sarpro_tpu.cli import _params_from_args, build_parser  # noqa: E402
from sarpro_tpu.core import clahe as jclahe  # noqa: E402
from sarpro_tpu.core import pipeline as jp  # noqa: E402
from sarpro_tpu.core import save as jsave  # noqa: E402
from sarpro_tpu.core import stats as jstats  # noqa: E402
from sarpro_tpu.core import synthetic_rgb as jsyn  # noqa: E402
from sarpro_tpu.io import safe as jsafe  # noqa: E402
from sarpro_tpu_torch import _native as tnative  # noqa: E402
from sarpro_tpu_torch import api as tapi  # noqa: E402
from sarpro_tpu_torch import cli as tcli  # noqa: E402
from sarpro_tpu_torch.core import clahe as tclahe  # noqa: E402
from sarpro_tpu_torch.core import fused as tf  # noqa: E402
from sarpro_tpu_torch.core import pipeline as tp  # noqa: E402
from sarpro_tpu_torch.core import save as tsave  # noqa: E402
from sarpro_tpu_torch.core import stats as tstats  # noqa: E402
from sarpro_tpu_torch.core import synthetic_rgb as tsyn  # noqa: E402
from sarpro_tpu_torch.io import safe as tsafe  # noqa: E402
from sarpro_tpu_torch.io.tiffio import TiffReader  # noqa: E402
from sarpro_tpu_torch.types import (  # noqa: E402
    AutoscaleStrategy,
    BitDepth,
    OutputFormat,
    Polarization,
    PolarizationOperation,
    SyntheticRgbMode,
)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

S = AutoscaleStrategy
SHAPES = [(48, 64), (37, 53)]
POW_SHARE = 1e-3


def _j(e):
    """The JAX package's member of the enum member `e` names (each package
    takes its own enums)."""
    return getattr(jtypes, type(e).__name__)(e.value)


def _t(a):
    return torch.from_numpy(np.array(a))


def _dn(rng, shape, mean=5.0):
    x = np.clip(rng.lognormal(mean, 1.1, shape), 0, 65535).astype(np.float32)
    x[rng.random(shape) < 0.03] = 0.0
    return x


def _port_stats(st):
    return tstats.HistogramStats(**dataclasses.asdict(st))


def _stats_equal(got, want, moments_rtol=1e-6):
    """Every field exact but mean and std (relative `moments_rtol`)."""
    assert type(got) is tstats.HistogramStats
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name in ("mean_db", "std_db"):
            assert math.isclose(a, b, rel_tol=moments_rtol, abs_tol=0.0), (
                f.name, a, b)
        else:
            assert a == b, (f.name, a, b)


# ---------------------------------------------------------------------------
# compute_db_and_stats
# ---------------------------------------------------------------------------
def _case_dn(rng, shape, case):
    if case == "degenerate":  # every valid value equal
        x = np.full(shape, 500.0, np.float32)
        x[rng.random(shape) < 0.1] = 0.0
        return x
    if case == "empty":  # every pixel under the -50 dB threshold
        return np.zeros(shape, np.float32)
    return _dn(rng, shape)


@pytest.mark.parametrize("case", ["sar", "degenerate", "empty"])
@pytest.mark.parametrize("shape", SHAPES)
def test_compute_db_and_stats_on_jax_db(rng, monkeypatch, shape, case):
    x = _case_dn(rng, shape, case)
    db, mask, want = jp.compute_db_and_stats(x)
    db, mask = np.asarray(db), np.asarray(mask)
    monkeypatch.setattr(tp, "_db_mask", lambda _x: (_t(db), _t(mask)))
    _, _, got = tp.compute_db_and_stats(_t(x))
    _stats_equal(got, want)
    if case == "sar":
        mn, mx = np.float32(db[mask].min()), np.float32(db[mask].max())
        hist_j, _, _ = jp._hist_moments(db, mask, mn, mx)
        hist_t, _, _ = tp._hist_moments(_t(db), _t(mask), _t(mn), _t(mx))
        assert hist_t.dtype == torch.int32
        np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))
        assert int(hist_t.sum()) == want.valid_count


@pytest.mark.parametrize("shape", SHAPES)
def test_compute_db_and_stats_from_dn(rng, shape):
    """From DN, f32 log differs by an ulp on some values: dB within 1e-5,
    count exact, every percentile within one 4096-bin step."""
    x = _dn(rng, shape)
    db_j, mask_j, want = jp.compute_db_and_stats(x)
    db_t, mask_t, got = tp.compute_db_and_stats(_t(x))
    assert np.abs(db_t.numpy() - np.asarray(db_j)).max() <= 1e-5
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert got.valid_count == want.valid_count
    step = (want.max_db - want.min_db) / jstats.NUM_BINS
    for f in dataclasses.fields(want):
        if f.name == "valid_count":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert abs(a - b) <= step + 1e-5, (f.name, a, b)


# ---------------------------------------------------------------------------
# the device passes on identical inputs
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_db_stats(shape):
    x = _dn(np.random.default_rng(sum(shape)), shape)
    db, mask, st = jp.compute_db_and_stats(x)
    return np.asarray(db), np.asarray(mask), st


def _window(st, strategy):
    if strategy is S.STANDARD:
        return jstats.standard_window(st)
    return jstats.advanced_window(st, _j(strategy))


@pytest.mark.parametrize("bit_depth", list(BitDepth))
@pytest.mark.parametrize("strategy", list(AutoscaleStrategy))
@pytest.mark.parametrize("shape", SHAPES + [(300, 400)])
def test_autoscale_on_jax_db_and_stats(shape, strategy, bit_depth):
    db, mask, st = _jax_db_stats(shape)
    if strategy is S.STANDARD:
        want = jp.autoscale_db_image(db, mask, st, _j(bit_depth))
        got = tp.autoscale_db_image(_t(db), _t(mask), _port_stats(st),
                                    bit_depth)
    else:
        want = jp.autoscale_db_image_advanced(db, mask, st, _j(bit_depth),
                                              _j(strategy))
        got = tp.autoscale_db_image_advanced(_t(db), _t(mask),
                                             _port_stats(st), bit_depth,
                                             strategy)
    want = np.asarray(want)
    assert got.dtype == torch.uint16 and got.shape == want.shape
    d = np.abs(got.numpy().astype(np.int64) - want.astype(np.int64))
    gamma = _window(st, strategy).gamma
    print(f"{shape} {strategy.value} {bit_depth.value} gamma {gamma}: "
          f"max|diff| {d.max()}, share differing {(d > 0).mean():.2e}")
    if strategy is S.CLAHE:
        assert d.max() <= 1
    elif gamma != 1.0:
        assert d.max() <= 1 and (d > 0).mean() < POW_SHARE
    else:
        assert d.max() == 0
    # the U8 wrapper's stretch on the JAX package's own u16 values
    u8 = tp.scale_u16_to_u8(_t(want.astype(np.int32)).to(torch.int16).view(
        torch.uint16))
    assert u8.dtype == torch.uint8
    np.testing.assert_array_equal(u8.numpy(),
                                  np.asarray(jp.scale_u16_to_u8(want)))


@pytest.mark.parametrize("copol", [True, False])
@pytest.mark.parametrize("shape", SHAPES + [(300, 400)])
def test_tamed_synrgb_band_exact(shape, copol):
    db, mask, st = _jax_db_stats(shape)
    want = np.asarray(jp.autoscale_db_image_tamed_synrgb_u8(db, mask, st,
                                                            copol))
    got = tp.autoscale_db_image_tamed_synrgb_u8(_t(db), _t(mask),
                                                _port_stats(st), copol)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES + [(300, 400)])
def test_clahe_tile_histograms_exact(shape):
    """CLAHE's device pass 1 on the host window: the tile histograms the
    host's CDFs are built from are exact."""
    db, mask, st = _jax_db_stats(shape)
    window = jstats.advanced_window(st, _j(S.CLAHE))
    rows, cols = shape
    tile_h, tile_w = -(-rows // 8), -(-cols // 8)
    _, want = jclahe._normalize_and_tile_hists(
        db, mask, np.float32(window.low), np.float32(window.high),
        np.float32(window.range), tile_h, tile_w)
    bins, got = tclahe._normalize_and_tile_hists(
        _t(db), _t(mask), tstats.ScaleWindow(window.low, window.high,
                                             window.gamma), tile_h, tile_w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bins.shape == (rows * cols,) and bins.dtype == torch.int32
    assert int((bins == 256).sum()) == int((~mask).sum())


@pytest.mark.parametrize("bit_depth", list(BitDepth))
@pytest.mark.parametrize("strategy", [S.STANDARD, S.ROBUST, S.CLAHE])
def test_process_scalar_data_pipeline_shapes_and_types(rng, strategy,
                                                       bit_depth):
    x = _dn(rng, (37, 53))
    res = tp.process_scalar_data_pipeline(_t(x), bit_depth, strategy)
    ref = jp.process_scalar_data_pipeline(x, _j(bit_depth), _j(strategy))
    assert res.shape == ref.shape == (37, 53)
    if bit_depth is BitDepth.U8:
        assert res.scaled_u16 is None and res.scaled_u8.dtype == torch.uint8
    else:
        assert res.scaled_u8 is None and res.scaled_u16.dtype == torch.uint16
    assert res.stats.valid_count == ref.stats.valid_count


def test_empty_band_gives_zeros():
    x = np.zeros((20, 30), np.float32)
    for strategy in (S.STANDARD, S.CLAHE, S.TAMED):
        res = tp.process_scalar_data_pipeline(_t(x), BitDepth.U16, strategy)
        assert res.stats.valid_count == 0
        assert res.scaled_u16.dtype == torch.uint16
        assert not res.scaled_u16.view(torch.int16).any()
    st = tp.compute_db_and_stats(_t(x))[2]
    band = tp.autoscale_db_image_tamed_synrgb_u8(*tf._db_mask(_t(x)), st, True)
    assert band.dtype == torch.uint8 and not band.any()


# ---------------------------------------------------------------------------
# synRGB
# ---------------------------------------------------------------------------
def _u8_pair(rng, floor, shape=(60, 70)):
    """u8 bands whose suppressed floor is `floor` (3: many zeros; 40: every
    value at 37 or above; between: the p05 value at floor - 3)."""
    lo = {3: 0, 40: 37}.get(floor, floor - 3)
    b = [rng.integers(lo, 256, shape).astype(np.uint8) for _ in range(2)]
    if floor == 3:
        b[0][rng.random(shape) < 0.2] = 0
    elif floor != 40:
        b[0].flat[:int(0.06 * b[0].size)] = lo  # p05 sits at lo
    b[1][rng.random(shape) < 0.05] = 0 if floor == 3 else lo
    return b


@pytest.mark.parametrize("floor", [3, 17, 40])
def test_synrgb_suppressed_and_default_exact(rng, floor):
    b1, b2 = _u8_pair(rng, floor)
    assert tsyn._suppressed_floor(_t(b1), _t(b2)) == \
        jsyn._suppressed_floor(b1, b2) == floor
    np.testing.assert_array_equal(
        tsyn.create_synthetic_rgb_suppressed(_t(b1), _t(b2)).numpy(),
        np.asarray(jsyn.create_synthetic_rgb_suppressed(b1, b2)))
    np.testing.assert_array_equal(
        tsyn.create_synthetic_rgb(_t(b1), _t(b2)).numpy(),
        np.asarray(jsyn.create_synthetic_rgb(b1, b2)))


@pytest.mark.parametrize("strategy", list(AutoscaleStrategy))
def test_synrgb_dispatch_exact(rng, strategy):
    b1, b2 = _u8_pair(rng, 17, (33, 41))
    for mode in SyntheticRgbMode:
        got = tsyn.create_synthetic_rgb_by_mode_and_strategy(
            mode, strategy, _t(b1), _t(b2))
        want = jsyn.create_synthetic_rgb_by_mode_and_strategy(
            _j(mode), _j(strategy), b1, b2)
        assert got.shape == (33, 41, 3) and got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# whole routes: process_safe_to_path(fast=False) and the buffer API
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("exact")
    return {
        "iw": fixtures.make_safe(root / "iw", shape=(48, 64), seed=3),
        "ragged": fixtures.make_safe(
            root / "ragged", name="S1A_EW_GRDM_1SDH_20250706T204346.SAFE",
            pols=("hh", "hv"), shape=(37, 53), seed=11,
            with_affine_geotransform=True),
    }


class _FixedClock:
    """Stands in for the `datetime` module in both SAFE parsers, so both
    packages stamp one conversion_timestamp."""

    timezone = datetime.timezone

    class datetime:
        @staticmethod
        def now(tz=None):
            return datetime.datetime(2025, 7, 6, 20, 43, 46, tzinfo=tz)


@pytest.fixture
def native_both(monkeypatch, tmp_path):
    """The JAX package's native library is the port's build of the same
    sources (native/*.cpp), so both packages code gray JPEGs and reduce on
    read alike; both stamp one conversion time. The JAX binding is handed
    `coder_threads`' count, which is its own wherever its band split is
    sound (tests/test_torch_jpeg_threads.py), so no split can abort the
    worker."""
    if not tnative.available():
        pytest.skip("g++ is not available to build the native codec")
    lib_dir = tmp_path / "jax_native"
    lib_dir.mkdir()
    (lib_dir / "tiffcodec.so").symlink_to(tnative._build())
    monkeypatch.setattr(jnative, "__file__", str(lib_dir / "__init__.py"))
    monkeypatch.setattr(jnative, "_TRIED", False)
    monkeypatch.setattr(jnative, "_LIB", None)
    assert jnative.available()
    gray = jnative.jpeg_encode_gray
    monkeypatch.setattr(jnative, "jpeg_encode_gray", lambda y, n_threads=0:
                        gray(y, tnative.coder_threads(y.shape[0], n_threads)))
    for mod in (jsafe, tsafe):
        monkeypatch.setattr(mod, "datetime", _FixedClock)
        mod._parse_comprehensive_cached.cache_clear()
    yield
    for mod in (jsafe, tsafe):
        mod._parse_comprehensive_cached.cache_clear()


@pytest.fixture
def captured(monkeypatch):
    """What each package's save hands its JPEG writers and its synRGB
    composition: {("j" | "t", kind): [args]}."""
    calls = {}

    def wrap(key, mod, name):
        orig = getattr(mod, name)

        def rec(*args):
            calls.setdefault(key, []).append(args)
            return orig(*args)

        monkeypatch.setattr(mod, name, rec)

    for side, mod in (("j", jsave), ("t", tsave)):
        wrap((side, "gray"), mod, "write_gray_jpeg")
        wrap((side, "rgb"), mod, "write_rgb_jpeg")
        wrap((side, "compose"), mod,
             "create_synthetic_rgb_by_mode_and_strategy")
    return calls


def _params(argv):
    return _params_from_args(build_parser().parse_args(argv))


def _jax_rasters(safe, params):
    """The rasters the JAX exact route's pipeline sees: its reader's bands,
    or its operation over the reader's pair."""
    target, resample = japi._resolve_target_args(params)
    ref = jsafe.SafeReader.open_with_options(
        safe, japi._pol_to_reader_hint(params.polarization), target,
        resample, params.size)
    pol = params.polarization
    if pol.kind in ("vv", "vh", "hh", "hv"):
        return [np.asarray(japi._single_band(ref, pol))]
    if pol.kind == "op":
        return [np.asarray(japi._op_band(ref, pol.op))]
    return [np.asarray(b) for b in japi._band_pair(ref, "Multiband")[:2]]


def _level_bound(x, strategy, max_val: float, stretch: bool = True,
                 window=None):
    """Levels a band may move by when a log ulp moves a percentile of the
    4096-bin histogram by one bin at each end of the window (through the
    strategy's gamma), plus 1 for the trunc; for CLAHE one CLAHE bin of
    window shift (a CDF step under (CLIP_LIMIT + 1) / 256) plus 1."""
    if strategy is S.CLAHE:
        return 1 + math.ceil(max_val * (jclahe.CLIP_LIMIT + 1)
                             / jclahe.CLAHE_BINS)
    db, mask, st = jp.compute_db_and_stats(np.asarray(x, np.float32))
    window = window or _window(st, strategy)
    step = (st.max_db - st.min_db) / jstats.NUM_BINS
    d = min(2 * step / window.range, 1.0)
    shift = d ** window.gamma if window.gamma < 1 else window.gamma * d
    if stretch:  # the U8 wrapper stretches the values to the full range
        q = np.asarray(jp._apply_window_u16(db, mask, window,
                                            jtypes.BitDepth.U8))
        shift *= 255.0 / max(float(q.max()) - float(q.min()), 1.0)
    return 1 + math.ceil(max_val * shift)


def _within(label, a, b, bound):
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
    print(f"{label}: max|diff| {d.max()} (bound {bound}), share differing "
          f"{(d > 0).mean():.2e}")
    assert d.max() <= bound
    return d.max() == 0


def _run_both(safe, tmp_path, args, ext):
    t_out, j_out = tmp_path / "t" / f"out.{ext}", tmp_path / "j" / f"out.{ext}"
    t_out.parent.mkdir()
    j_out.parent.mkdir()
    argv = ["-i", str(safe)] + args
    assert tcli.run(argv + ["-o", str(t_out)], device="cpu") == 0
    params = _params(argv + ["-o", str(j_out)])
    japi.process_safe_to_path(safe, j_out, params)
    return params, t_out, j_out


def _sidecars_equal(t_out, j_out):
    for ext in (".jgw", ".prj", ".json"):
        t, j = t_out.with_suffix(ext), j_out.with_suffix(ext)
        assert t.exists() == j.exists(), ext
        if t.exists():
            assert t.read_bytes() == j.read_bytes(), ext


TIFF_ROUTES = {
    "vv u8 clahe original": ("iw", ["--polarization", "vv"]),
    "hh u8 clahe original ragged": ("ragged", ["--polarization", "hh"]),
    "vh u16 adaptive cubic": ("iw", [
        "--polarization", "vh", "--bit-depth", "u16", "--autoscale",
        "adaptive", "--size", "40", "--resample-alg", "cubic"]),
    "ratio u8 robust pad": ("iw", [
        "--polarization", "ratio", "--autoscale", "robust", "--size", "32",
        "--pad"]),
    "sum u16 standard ragged": ("ragged", [
        "--polarization", "sum", "--bit-depth", "u16", "--autoscale",
        "standard"]),
    "multiband u8 robust": ("iw", [
        "--polarization", "multiband", "--autoscale", "robust"]),
    "multiband u16 equalized pad ragged": ("ragged", [
        "--polarization", "multiband", "--bit-depth", "u16", "--autoscale",
        "equalized", "--size", "40", "--pad"]),
    "multiband u16 tamed": ("iw", [
        "--polarization", "multiband", "--bit-depth", "u16", "--autoscale",
        "tamed", "--size", "40"]),
    "vv u8 tamed auto-UTM": ("iw", [
        "--polarization", "vv", "--autoscale", "tamed", "--size", "40",
        "--target-crs", "auto"]),
}


@pytest.mark.parametrize("route", list(TIFF_ROUTES))
def test_tiff_route_matches_jax(scenes, native_both, tmp_path, route):
    which, args = TIFF_ROUTES[route]
    params, t_out, j_out = _run_both(scenes[which], tmp_path,
                                     ["-f", "tiff"] + args, "tiff")
    rasters = _jax_rasters(scenes[which], params)
    depth = params.bit_depth.to_bit_depth()
    strategy = S(params.autoscale.value)
    t, j = TiffReader(t_out), TiffReader(j_out)
    try:
        assert t.samples == j.samples == len(rasters)
        equal = True
        for i, x in enumerate(rasters, 1):
            a, b = t.read(i), j.read(i)
            assert a.dtype == b.dtype and a.shape == b.shape
            equal &= _within(f"{route} band {i}", a, b, _level_bound(
                x, strategy, depth.max_val, depth.value == "u8"))
        assert t.geo_info() == j.geo_info()
        assert t.gdal_metadata() == j.gdal_metadata()
    finally:
        t.close()
        j.close()
    if equal:
        assert t_out.read_bytes() == j_out.read_bytes()
    if "auto" in route:
        assert t.geo_info().geotransform is not None


GRAY_JPEG_ROUTES = {
    "vv standard": ("iw", ["--polarization", "vv", "--autoscale",
                           "standard"]),
    "n-diff tamed": ("iw", ["--polarization", "n-diff", "--autoscale",
                            "tamed", "--size", "40"]),
    "hv clahe pad ragged": ("ragged", ["--polarization", "hv", "--size",
                                       "40", "--pad"]),
}


@pytest.mark.parametrize("route", list(GRAY_JPEG_ROUTES))
def test_gray_jpeg_route_matches_jax(scenes, native_both, captured,
                                     tmp_path, route):
    which, args = GRAY_JPEG_ROUTES[route]
    params, t_out, j_out = _run_both(scenes[which], tmp_path,
                                     ["-f", "jpeg"] + args, "jpg")
    (_, jc, jr, ja), = captured[("j", "gray")]
    (_, tc, tr, ta), = captured[("t", "gray")]
    assert (tc, tr) == (jc, jr)
    x, = _jax_rasters(scenes[which], params)
    if _within(route, ta.numpy(), np.asarray(ja),
               _level_bound(x, S(params.autoscale.value), 255.0)):
        assert t_out.read_bytes() == j_out.read_bytes()
    _sidecars_equal(t_out, j_out)


SYNRGB_ROUTES = {
    "tamed pad": ("iw", ["--autoscale", "tamed", "--size", "40", "--pad"]),
    "clahe ragged": ("ragged", ["--autoscale", "clahe"]),
    "adaptive default mode": ("iw", ["--autoscale", "adaptive",
                                     "--synrgb-mode", "sar-urban"]),
    "tamed auto-UTM cubic pad": ("iw", [
        "--autoscale", "tamed", "--size", "40", "--pad", "--target-crs",
        "auto", "--resample-alg", "cubic"]),
}


@pytest.mark.parametrize("route", list(SYNRGB_ROUTES))
def test_synrgb_jpeg_route_matches_jax(scenes, native_both, captured,
                                       tmp_path, route):
    which, args = SYNRGB_ROUTES[route]
    params, t_out, j_out = _run_both(
        scenes[which], tmp_path,
        ["-f", "jpeg", "--polarization", "multiband"] + args, "jpg")
    strategy = S(params.autoscale.value)
    (_, _, jb1, jb2), = captured[("j", "compose")]
    (_, _, tb1, tb2), = captured[("t", "compose")]
    rasters = _jax_rasters(scenes[which], params)
    for i, (a, b, x) in enumerate(zip((tb1, tb2), (jb1, jb2), rasters)):
        if strategy is S.TAMED:  # the band-specific window, no stretch
            st = jp.compute_db_and_stats(x)[2]
            bound = _level_bound(x, strategy, 255.0, False,
                                 jstats.tamed_synrgb_window(st, i == 0))
        else:
            bound = _level_bound(x, strategy, 255.0)
        _within(f"{route} band {i + 1}", a.numpy(), b, bound)
    both = (tb1.numpy() == np.asarray(jb1)) & (tb2.numpy() == np.asarray(jb2))
    if strategy in (S.TAMED, S.CLAHE):
        assert tsyn._suppressed_floor(tb1, tb2) == jsyn._suppressed_floor(
            np.asarray(jb1), np.asarray(jb2))
    (_, jc, jr, j_rgb), = captured[("j", "rgb")]
    (_, tc, tr, t_rgb), = captured[("t", "rgb")]
    assert (tc, tr) == (jc, jr)
    np.testing.assert_array_equal(t_rgb.numpy()[both], np.asarray(j_rgb)[both])
    print(f"{route}: rgb equal on a share {both.mean():.3f} of pixels")
    planes = tf.ycbcr_planes(t_rgb).numpy()
    chip_smoke._check_mcus_f64(route, t_out.read_bytes(), planes,
                               -(-tr // 8) * -(-tc // 8))
    _sidecars_equal(t_out, j_out)
    meta = json.loads(t_out.with_suffix(".json").read_text())
    assert meta["synthetic_rgb_mode"] == params.synrgb_mode.display
    if "auto" in route:
        assert "UTM zone 32N" in t_out.with_suffix(".prj").read_text()


@pytest.mark.parametrize("bit_depth", list(BitDepth))
def test_clahe_on_jax_warped_bands(scenes, monkeypatch, bit_depth):
    """CLAHE on the auto-UTM warp's output. The warps agree within 8 ulps
    of their coordinates (tests/test_torch_warp.py), which can move a pixel
    of a 5 x 5 tile to another CLAHE bin and so its tile's CDF; fed the dB
    of the JAX reader's warped bands, the pipelines agree within the
    lookup's 1. Their std differs by 1.2e-6 relative (the f32 sums over
    1600 pixels, a third outside the footprint), held to 2e-6 here."""
    params = _params(["-i", "x", "-o", "y", "--polarization", "multiband",
                      "--autoscale", "clahe", "--size", "40",
                      "--target-crs", "auto", "--resample-alg", "cubic"])
    for x in _jax_rasters(scenes["iw"], params):
        assert (x == 0).any()  # outside the footprint
        want = jp.process_scalar_data_pipeline(x, _j(bit_depth),
                                               _j(S.CLAHE))
        monkeypatch.setattr(tp, "_db_mask", lambda _x: (
            _t(want.db), _t(want.mask)))
        got = tp.process_scalar_data_pipeline(_t(x), bit_depth, S.CLAHE)
        _stats_equal(got.stats, want.stats, moments_rtol=2e-6)
        field = "scaled_u8" if bit_depth is BitDepth.U8 else "scaled_u16"
        _within(f"clahe on the warped band {bit_depth.value}",
                getattr(got, field).numpy(), getattr(want, field), 1)


BUFFER_ROUTES = {
    "vv u8 tiff": ("iw", "vv", S.CLAHE, BitDepth.U8, None, False,
                   OutputFormat.TIFF),
    "vh u16 tiff adaptive 40": ("iw", "vh", S.ADAPTIVE, BitDepth.U16, 40,
                                False, OutputFormat.TIFF),
    "hh jpeg standard pad ragged": ("ragged", "hh", S.STANDARD, BitDepth.U16,
                                    40, True, OutputFormat.JPEG),
    "ratio tiff robust": ("iw", "ratio", S.ROBUST, BitDepth.U8, 32, False,
                          OutputFormat.TIFF),
    "multiband u16 tiff equalized": ("ragged", "multiband", S.EQUALIZED,
                                     BitDepth.U16, None, False,
                                     OutputFormat.TIFF),
    "multiband jpeg tamed pad": ("iw", "multiband", S.TAMED, BitDepth.U8, 40,
                                 True, OutputFormat.JPEG),
    "multiband jpeg clahe": ("ragged", "multiband", S.CLAHE, BitDepth.U8,
                             None, False, OutputFormat.JPEG),
    "multiband jpeg default": ("iw", "multiband", S.DEFAULT, BitDepth.U8, 40,
                               False, OutputFormat.JPEG),
}


@pytest.mark.parametrize("route", list(BUFFER_ROUTES))
def test_buffer_route_matches_jax(scenes, native_both, route):
    which, pol, strategy, depth, size, pad, fmt = BUFFER_ROUTES[route]
    safe = scenes[which]
    got = tapi.process_safe_to_buffer_with_mode(
        safe, Polarization.from_cli(pol), strategy, depth, size, pad, fmt,
        SyntheticRgbMode.DEFAULT, device="cpu")
    want = japi.process_safe_to_buffer_with_mode(
        safe, jtypes.Polarization.from_cli(pol), _j(strategy), _j(depth),
        size, pad, _j(fmt), jtypes.SyntheticRgbMode.DEFAULT)
    assert (got.width, got.height) == (want.width, want.height)
    assert got.bit_depth.value == want.bit_depth.value
    assert got.format.value == want.format.value
    assert dataclasses.asdict(got.metadata) == dataclasses.asdict(
        want.metadata)
    params = _params(["-i", "x", "-o", "y", "--polarization", pol,
                      "--autoscale", strategy.value] + (
                          ["--size", str(size)] if size else []))
    rasters = _jax_rasters(safe, params)
    fields = ("gray", "gray16", "rgb", "gray_band2", "gray16_band2")
    present = [f for f in fields if getattr(want, f) is not None]
    assert present == [f for f in fields if getattr(got, f) is not None]
    for f in present:
        a, b = getattr(got, f), getattr(want, f)
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        assert a.shape == b.shape
        if f == "rgb":
            continue
        x = rasters[1 if f.endswith("band2") else 0]
        max_val = 65535.0 if f.startswith("gray16") else 255.0
        _within(f"{route} {f}", a, b, _level_bound(x, strategy, max_val,
                                                   max_val == 255.0))
    if want.rgb is not None:  # equal wherever both bands are
        pair = tsafe.open_pair(safe, "cpu", "Multiband", size)
        jb = [np.asarray(jp.process_scalar_data_pipeline(
            x, jtypes.BitDepth.U8, _j(strategy)).scaled_u8) for x in rasters]
        tb = [tp.process_scalar_data_pipeline(
            b, BitDepth.U8, strategy).scaled_u8.numpy()
            for b in (pair.band1, pair.band2)]
        if pad:
            jb = [tf._pad_square(_t(b), *b.shape).numpy() for b in jb]
            tb = [tf._pad_square(_t(b), *b.shape).numpy() for b in tb]
        both = (jb[0] == tb[0]) & (jb[1] == tb[1])
        np.testing.assert_array_equal(got.rgb[both], want.rgb[both])


def test_typed_api_matches_jax(scenes, native_both, tmp_path):
    """process_safe_with_options, save_image / save_multiband_image on
    loaded arrays, load_polarization and load_operation."""
    safe = scenes["iw"]
    t_out, j_out = tmp_path / "t.tiff", tmp_path / "j.tiff"
    tapi.process_safe_with_options(safe, t_out, OutputFormat.TIFF,
                                   BitDepth.U8, Polarization.from_cli("vh"),
                                   S.ROBUST, 40, True, device="cpu")
    japi.process_safe_with_options(safe, j_out, jtypes.OutputFormat.TIFF,
                                   jtypes.BitDepth.U8,
                                   jtypes.Polarization.from_cli("vh"),
                                   jtypes.AutoscaleStrategy.ROBUST, 40, True)
    assert TiffReader(t_out).read(1).shape == (40, 40)
    x = TiffReader(j_out).read(1)
    if np.array_equal(TiffReader(t_out).read(1), x):
        assert t_out.read_bytes() == j_out.read_bytes()

    band_t, meta_t = tapi.load_polarization(safe, Polarization.from_cli("vv"),
                                            device="cpu")
    band_j, meta_j = japi.load_polarization(
        safe, jtypes.Polarization.from_cli("vv"))
    np.testing.assert_array_equal(band_t.numpy().astype(np.float32),
                                  np.asarray(band_j))
    assert meta_t.polarizations == meta_j.polarizations
    op_t, _ = tapi.load_operation(safe, PolarizationOperation.RATIO,
                                  device="cpu")
    op_j, _ = japi.load_operation(safe, jtypes.PolarizationOperation.RATIO)
    np.testing.assert_allclose(op_t.numpy(), np.asarray(op_j), rtol=1e-6)
    with pytest.raises(Exception, match="single polarization"):
        tapi.load_polarization(safe, Polarization.from_cli("multiband"),
                               device="cpu")

    # save_image on a numpy array (tiff u16, the Lanczos3 resize) and
    # save_multiband_image (the default-mode synRGB JPEG)
    arr = np.asarray(band_j)
    for name, t_kw, j_kw in (
            ("u16.tiff", (OutputFormat.TIFF, BitDepth.U16),
             (jtypes.OutputFormat.TIFF, jtypes.BitDepth.U16)),
            ("gray.jpg", (OutputFormat.JPEG, BitDepth.U8),
             (jtypes.OutputFormat.JPEG, jtypes.BitDepth.U8))):
        tapi.save_image(arr, tmp_path / f"t_{name}", *t_kw, target_size=40,
                        metadata=meta_t, device="cpu")
        japi.save_image(arr, tmp_path / f"j_{name}", *j_kw, target_size=40,
                        metadata=meta_j)
        a, b = (tmp_path / f"t_{name}").read_bytes(), \
            (tmp_path / f"j_{name}").read_bytes()
        if name.endswith("tiff"):
            ra = TiffReader(tmp_path / f"t_{name}").read(1)
            rb = TiffReader(tmp_path / f"j_{name}").read(1)
            assert ra.shape == rb.shape == (30, 40)
            if np.array_equal(ra, rb):
                assert a == b
            _within(f"save_image {name}", ra, rb, _level_bound(
                arr, S.STANDARD, 65535.0, False))
        else:
            assert a[:2] == b"\xff\xd8"
    vh, _ = tapi.load_polarization(safe, Polarization.from_cli("vh"),
                                   device="cpu")
    tapi.save_multiband_image(arr, vh.numpy(), tmp_path / "t_rgb.jpg",
                              OutputFormat.JPEG, BitDepth.U8,
                              metadata=meta_t, device="cpu")
    assert (tmp_path / "t_rgb.jpg").read_bytes()[:2] == b"\xff\xd8"
    assert json.loads((tmp_path / "t_rgb.json").read_text())[
        "synthetic_rgb_mode"] == "Default"
