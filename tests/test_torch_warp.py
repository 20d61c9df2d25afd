"""The port's warp against the JAX package's, on the CPU: the sampler's plain
PyTorch version against the XLA sampler and the tiled Pallas kernel in
interpret mode, the jax-free copies of the host plan, the decimated read,
and the warp of a band.

Tolerances. XLA on the CPU contracts the sampler's grid interpolation into
FMAs, PyTorch rounds each step, so the mapped source coordinate differs by
a few ulps (measured up to 4 ulps of the coordinate), and a sampled value by
that much times the source's gradient. Where no operation rounds (dyadic
grids and scales, small-integer sources) the two are equal bit for bit,
NaN, infinite and far-out grid nodes and out-of-bounds taps included. The
plan copies are equal to the originals.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fixtures  # noqa: E402
from sarpro_tpu import _native as j_native  # noqa: E402
from sarpro_tpu.io import geodesy  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu.io import warp as jw  # noqa: E402
from sarpro_tpu.io.safe import (  # noqa: E402
    SafeReader,
    TargetCrsArg as JTargetCrsArg,
    parse_comprehensive_metadata,
)
from sarpro_tpu.ops import kernels as JK  # noqa: E402
from sarpro_tpu.ops import warp_kernel as JWK  # noqa: E402
from sarpro_tpu_torch import _native as t_native  # noqa: E402
from sarpro_tpu_torch import ops  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from sarpro_tpu_torch.io import warp as tw  # noqa: E402
from sarpro_tpu_torch.io.safe import TargetCrsArg, open_dual_pol  # noqa: E402

METHODS = ("near", "bilinear", "cubic")
RESAMPLE_TOL = dict(rtol=2e-6, atol=2e-2)  # tests/test_torch_kernels.py


def _readers(path):
    """The port's reader and the JAX package's of one raster (each package
    reads with its own)."""
    return traster.RasterReader(path), jraster.RasterReader(path)


def _no_native(monkeypatch):
    """Both packages without their native codec: the device route."""
    for mod in (j_native, t_native):
        monkeypatch.setattr(mod, "available", lambda: False)


def _xla(src, mx, my, rows, cols, method):
    return np.asarray(jw._warp_sample(jnp.asarray(src), jnp.asarray(mx),
                                      jnp.asarray(my), rows, cols, method))


def _port(src, mx, my, rows, cols, method):
    return ops.warp_sample(torch.from_numpy(src), torch.from_numpy(mx),
                           torch.from_numpy(my), rows, cols, method).numpy()


def _dyadic_case(rng):
    """Grid steps of 1/2 an output pixel and half-integer nodes, so every
    mapped coordinate is a multiple of 1/8; sources of small integers. The
    grid is sheared and reaches past the source on every side."""
    rows, cols, gh, gw = 33, 41, 17, 21  # scales (gh-1)/(rows-1) = 1/2
    i, j = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    mx = (1.5 * j - 0.5 * i - 4.0).astype(np.float32)
    my = (1.5 * i + 0.5 * j - 3.5).astype(np.float32)
    mx[2, 3] = np.nan  # out-of-domain node (near reads pixel (0, 0) there)
    my[9, 12] = np.nan
    mx[5, 17] = np.inf
    my[12, 4] = -np.inf
    mx[14, 8] = 3e9  # beyond int32
    my[3, 15] = -3e9
    src = rng.integers(0, 4, (20, 27)).astype(np.float32)
    return src, mx, my, rows, cols


@pytest.mark.parametrize("method", METHODS)
def test_warp_sample_exact_where_nothing_rounds(rng, method):
    src, mx, my, rows, cols = _dyadic_case(rng)
    got = _port(src, mx, my, rows, cols, method)
    want = _xla(src, mx, my, rows, cols, method)
    assert got.shape == (rows, cols) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    assert 0.1 < (got == 0).mean() < 0.9  # both in- and out-of-bounds


def test_near_reads_pixel_zero_at_nan_node():
    """XLA's float -> int maps NaN to 0: the reference's near sampler reads
    source pixel (0, 0) wherever the mapped coordinate is NaN."""
    src = np.arange(1, 13, dtype=np.float32).reshape(3, 4)
    mx = np.full((2, 2), np.nan, np.float32)
    my = np.full((2, 2), np.nan, np.float32)
    for impl in (_port, _xla):
        out = impl(src, mx, my, 3, 3, "near")
        np.testing.assert_array_equal(out, np.full((3, 3), 1.0, np.float32))
        for method in ("bilinear", "cubic"):
            assert not impl(src, mx, my, 3, 3, method).any()


def _rotated_case(rng, side=420, out_r=256, out_c=300, gh=10, gw=11):
    yy, xx = np.meshgrid(np.linspace(0, 1, gh), np.linspace(0, 1, gw),
                         indexing="ij")
    mx = ((xx * 1.1 + 0.15 * yy) * (side - 8) - 30.3).astype(np.float32)
    my = ((yy * 1.1 - 0.15 * xx) * (side - 8) + 20.7).astype(np.float32)
    return side, out_r, out_c, mx, my


def test_mapped_coordinates_within_fma_bound(rng):
    """Bilinear sampling of a column (row) ramp returns the mapped column
    (row) itself: the port and XLA agree on it to 8 ulps."""
    side, out_r, out_c, mx, my = _rotated_case(rng)
    r, c = np.mgrid[:side, :side].astype(np.float32)
    for ramp in (c, r):
        got = _port(ramp, mx, my, out_r, out_c, "bilinear")
        want = _xla(ramp, mx, my, out_r, out_c, "bilinear")
        inside = (want > 1) & (want < side - 2)
        d = np.abs(got - want)[inside]
        print(f"mapped coordinate: max|diff| {d.max():.3g} px, share "
              f"differing {(d > 0).mean():.3f}")
        assert d.max() <= 8 * np.spacing(np.float32(side))


@pytest.mark.parametrize("method", METHODS)
def test_warp_sample_matches_xla_on_smooth_source(rng, method):
    """On a smooth source (gradient below 2.5 per pixel) the coordinate
    difference moves a value by < 1e-3; near differs only where a
    coordinate sits within its rounding of a .5 tie."""
    side, out_r, out_c, mx, my = _rotated_case(rng)
    r, c = np.mgrid[:side, :side].astype(np.float32)
    src = (100 + 20 * np.sin(c / 9) * np.cos(r / 13)).astype(np.float32)
    got = _port(src, mx, my, out_r, out_c, method)
    want = _xla(src, mx, my, out_r, out_c, method)
    d = np.abs(got - want)
    print(f"{method}: max|diff| {d.max():.3g}, share differing "
          f"{(d > 0).mean():.3f}")
    if method == "near":
        assert (d > 0).mean() < 1e-3
    else:
        assert d.max() < 1e-3
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize("method", ("bilinear", "cubic"))
def test_warp_sample_matches_tiled_pallas_interpret(rng, method):
    """Against the TPU kernel body: mean abs < 1e-3, the bound of
    tests/test_pallas_interpret.py."""
    side, out_r, out_c = 420, 256, 256
    gh = gw = 17
    yy, xx = np.meshgrid(np.linspace(0, 1, gh), np.linspace(0, 1, gw),
                         indexing="ij")
    map_x = (xx * 0.9 + 0.02 * yy) * (side - 8) + 3.0
    map_y = (yy * 0.9 + 0.02 * xx) * (side - 8) + 2.0
    src = rng.normal(size=(side, side)).astype(np.float32)
    gx, gy = tw.plan_grids_to_device(map_x, map_y, "cpu")
    got = ops.warp_sample(torch.from_numpy(src), gx, gy, out_r, out_c,
                          method).numpy()
    with JK.pallas_interpret():
        want = JWK.warp_sample_tiled(jnp.asarray(src), map_x, map_y, out_r,
                                     out_c, method)
        assert want is not None
        want = np.asarray(want)
    assert np.abs(got - want).mean() < 1e-3


def test_warp_sample_rejects_bad_input():
    src = torch.zeros((8, 8))
    g = torch.zeros((3, 3))
    with pytest.raises(ValueError):
        ops.warp_sample(src, g, g, 4, 4, "lanczos")
    with pytest.raises(TypeError):
        ops.warp_sample(src.double(), g, g, 4, 4, "near")
    with pytest.raises(ValueError):
        ops.warp_sample(src, g, g[:2], 4, 4, "near")
    with pytest.raises(ValueError):
        ops.warp_sample(src, g[:1], g[:1], 4, 4, "near")


# ---------------------------------------------------------------------------
# the host plan
# ---------------------------------------------------------------------------
SOURCES = {
    "gcp": {},
    "affine": {"with_affine_geotransform": True},
    "geolocation_grid": {"tiff_gcps": False, "with_geolocation_grid": True},
}


@pytest.fixture(scope="module")
def safes(tmp_path_factory):
    return {name: fixtures.make_safe(tmp_path_factory.mktemp(name),
                                     shape=(300, 400), **kw)
            for name, kw in SOURCES.items()}


def _measurement(safe, pol="vv"):
    return next((safe / "measurement").glob(f"*-{pol}-*"))


def _resolve(safe, target):
    if target != "auto":
        return target
    crs = geodesy.resolve_auto_target_crs(safe)
    if crs is None:
        # an affine product carries neither GCPs nor a geolocation grid:
        # auto resolves to nothing and the product is not warped; plan
        # against another UTM zone instead
        assert "affine" in safe.parent.name
        return "EPSG:32633"
    return crs


def _plans_equal(tp, jp):
    assert (tp.out_cols, tp.out_rows, tp.dst_epsg, tp.method) == \
        (jp.out_cols, jp.out_rows, jp.dst_epsg, jp.method)
    assert tp.geotransform == jp.geotransform
    np.testing.assert_array_equal(tp.map_x, jp.map_x)
    np.testing.assert_array_equal(tp.map_y, jp.map_y)


@pytest.mark.parametrize("source", list(SOURCES))
@pytest.mark.parametrize("target", ["auto", "EPSG:4326", "EPSG:3857"])
@pytest.mark.parametrize("size,alg", [(128, "cubic"), (None, None)])
def test_plan_copies_equal_jax_package(safes, source, target, size, alg):
    safe = safes[source]
    crs = _resolve(safe, target)
    grid = parse_comprehensive_metadata(safe).geolocation_grid
    treader, jreader = _readers(_measurement(safe))
    try:
        tp = tw.plan_warp(treader, crs, alg, size, grid)
        jp = jw.plan_warp(jreader, crs, alg, size, grid)
    finally:
        treader.close()
        jreader.close()
    _plans_equal(tp, jp)
    cols, rows = np.meshgrid(np.arange(0, tp.out_cols, 7.0),
                             np.arange(0, tp.out_rows, 5.0))
    for a, b in zip(tp.exact_source_pixels(cols, rows),
                    jp.exact_source_pixels(cols, rows)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tp.interp_source_pixels(cols, rows),
                    jp.interp_source_pixels(cols, rows)):
        np.testing.assert_array_equal(a, b)
    t2 = tw.two_stage_plan(tp, 400, 300)
    j2 = jw.two_stage_plan(jp, 400, 300)
    assert (t2 is None) == (j2 is None)
    if t2 is not None:
        assert t2[:2] == j2[:2]
        for a, b in zip(t2[2:], j2[2:]):
            np.testing.assert_array_equal(a, b)
    for g in (tp.map_x, tp.map_y):
        got = tw.plan_grids_to_device(g, g, "cpu")[0]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jnp.asarray(g, jnp.float32)))


def test_resample_name_and_unsupported_crs_equal(safes):
    for alg in (None, "nearest", "near", "bilinear", "cubic", "lanczos", "x"):
        assert tw._resample_name(alg) == jw._resample_name(alg)
    treader, jreader = _readers(_measurement(safes["gcp"]))
    try:
        for crs in ("EPSG:999999", "not-a-crs"):
            with pytest.raises(Exception) as t_err:
                tw.plan_warp(treader, crs)
            with pytest.raises(Exception) as j_err:
                jw.plan_warp(jreader, crs)
            # each package raises its own copy of the error class
            assert type(t_err.value).__name__ == type(j_err.value).__name__
            assert str(t_err.value) == str(j_err.value)
    finally:
        treader.close()
        jreader.close()


def test_two_stage_plan_nan_nodes_equal():
    """proj_pipe targets can leave grid nodes nan: the nan-aware estimate
    of the copy equals the original's."""
    mx, my = np.meshgrid(np.linspace(0, 3000, 20), np.linspace(0, 2500, 18))
    mx[0, :4] = np.nan
    my[-1, -2:] = np.nan
    for out in ((300, 280), (2000, 1900)):
        tp = tw.WarpPlan(out[1], out[0], [0.0] * 6, 4326, "cubic", None,
                         mx, my)
        jp = jw.WarpPlan(out[1], out[0], [0.0] * 6, 4326, "cubic", None,
                         mx, my)
        t2, j2 = tw.two_stage_plan(tp, 3001, 2501), jw.two_stage_plan(
            jp, 3001, 2501)
        assert (t2 is None) == (j2 is None)
        if t2 is not None:
            assert t2[:2] == j2[:2]
            np.testing.assert_array_equal(t2[2], j2[2])
            np.testing.assert_array_equal(t2[3], j2[3])


# ---------------------------------------------------------------------------
# the decimated read
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("in_size,out_size", [
    (20000, 2560), (1600, 411), (1200, 300), (300, 299), (37, 5)])
def test_average_windows_copy_equal(in_size, out_size):
    t = traster._average_windows(in_size, out_size)
    j = jraster._average_windows(in_size, out_size)
    assert (t is None) == (j is None)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("out_cols,out_rows", [(101, 77), (400, 300)])
def test_decimated_read_device_route_equals_jax(safes, monkeypatch, out_cols,
                                                out_rows):
    """Without the native reducer (or, at 400 x 300, without a reduction)
    the band is read whole and resampled on the device with the same
    'average' windows as the JAX package's resample_plane."""
    _no_native(monkeypatch)
    treader, jreader = _readers(_measurement(safes["gcp"]))
    try:
        before = dict(traster.ROUTES)
        got = traster.read_band_resampled_to_device(
            treader, 1, out_cols, out_rows, "cpu", "average")
        want = jreader.read_band_resampled(1, out_cols, out_rows, "average")
    finally:
        treader.close()
        jreader.close()
    assert traster.ROUTES["device_resample"] == before["device_resample"] + 1
    assert got.dtype == torch.float32 and got.shape == (out_rows, out_cols)
    np.testing.assert_allclose(got.numpy(), want, **RESAMPLE_TOL)


def test_decimated_read_host_route_equals_jax(safes):
    """The native route (the JAX package's where `python native/build.py`
    has run, the port's own where g++ builds it; the card's run exercises
    it in chip_smoke.py): the same box reducer over the same windows, chunk
    by chunk, gives the JAX package's plane."""
    if not (j_native.available() and t_native.available()):
        pytest.skip("the native box reducer is not built here")
    treader, jreader = _readers(_measurement(safes["gcp"]))
    try:
        before = dict(traster.ROUTES)
        got = traster.read_band_resampled_to_device(
            treader, 1, 101, 77, "cpu", "average", chunk_out_rows=20)
        want = jreader.read_band_resampled(1, 101, 77, "average")
    finally:
        treader.close()
        jreader.close()
    assert traster.ROUTES["host_reduce"] == before["host_reduce"] + 1
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the warp of a band, and the reader's warp branch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", [128, None])
def test_warp_to_crs_matches_jax(safes, monkeypatch, size):
    """A two-stage warp (128) and a warp at about the source scale without
    the pre-reduce (None): same grid, geotransform and CRS; the samples
    agree to the coordinate rounding times the speckle's gradient."""
    _no_native(monkeypatch)
    safe = safes["gcp"]
    grid = parse_comprehensive_metadata(safe).geolocation_grid
    treader, jreader = _readers(_measurement(safe))
    try:
        got = tw.warp_to_crs(treader, "EPSG:32632", "cpu", "bilinear", size,
                             grid)
        want = jw.warp_to_crs(jreader, "EPSG:32632", "bilinear", size, grid)
    finally:
        treader.close()
        jreader.close()
    assert got.geotransform == want.geotransform
    assert (got.projection, got.epsg) == (want.projection, want.epsg)
    g, w = got.data.numpy(), np.asarray(want.data)
    assert g.shape == w.shape and g.dtype == np.float32
    rel = np.abs(g - w) / np.maximum(np.abs(w), 1.0)
    print(f"warp {size}: share differing {(g != w).mean():.3f}, max rel "
          f"{rel.max():.3g}, mean rel {rel.mean():.3g}")
    assert (g == 0).sum() == (w == 0).sum()
    assert rel.mean() < 1e-3 and rel.max() < 0.1


def test_skip_warp_guard_loads_full_resolution(safes):
    """A source already in the target CRS is not warped: the band stage
    gets the full-resolution DN, and the metadata its raster's own."""
    safe = safes["affine"]
    scene = open_dual_pol(safe, "cpu", 64, target_crs="EPSG:32632")
    ref = SafeReader.open_with_options(safe, "all_pairs", "EPSG:32632", None,
                                       64)
    assert scene.band1.dtype == torch.uint16
    assert scene.band1.shape == (300, 400)
    np.testing.assert_array_equal(scene.band1.numpy(), np.asarray(ref._vv))
    for key in ("geotransform", "projection", "crs", "lines", "samples"):
        assert getattr(scene.metadata, key) == getattr(ref.metadata, key), key


def test_reader_warp_branch_metadata_equals_jax(safes, monkeypatch):
    _no_native(monkeypatch)
    safe = safes["geolocation_grid"]
    scene = open_dual_pol(safe, "cpu", 128, target_crs=TargetCrsArg.AUTO,
                          resample_alg="cubic")
    ref = SafeReader.open_with_options(safe, "all_pairs", JTargetCrsArg.AUTO,
                                       "cubic", 128)
    assert scene.band1.dtype == torch.float32
    assert scene.band1.shape == np.asarray(ref._vv).shape
    for key in ("geotransform", "projection", "crs", "lines", "samples"):
        assert getattr(scene.metadata, key) == getattr(ref.metadata, key), key
    assert "UTM zone 32N" in scene.metadata.projection
