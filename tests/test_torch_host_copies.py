"""The port's copies of the JAX package's host modules against the
originals, on the CPU: the SAFE parser and file discovery, the raster
reader, geodesy, the TIFF codec and writers, the world file, .prj and JSON
sidecar, the CLI parser, chip_smoke.py's copy of the fixture SAFE writer,
the port's own build of the native codec and its pixel JPEG entries, and
exact mode's host pieces: the stats module, the CLAHE CDFs, the quantized
Lanczos3 resize and the padding.

Everything is held exactly: equal fields, bit-equal arrays, byte-identical
files. The one field that differs by nature is a parse's
conversion_timestamp (the time of the parse); the files are written from
metadata that carries one timestamp."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import fixtures  # noqa: E402
from oracle import decode_baseline_jpeg_coeffs  # noqa: E402
from sarpro_tpu import cli as jcli  # noqa: E402
from sarpro_tpu.io import geodesy as jgeo  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu.io import safe as jsafe  # noqa: E402
from sarpro_tpu.io import tiffio as jtiff  # noqa: E402
from sarpro_tpu.io.writers import metadata as jmeta  # noqa: E402
from sarpro_tpu.io.writers import tiff as jwtiff  # noqa: E402
from sarpro_tpu.io.writers import worldfile as jworld  # noqa: E402
from sarpro_tpu_torch import _native as t_native  # noqa: E402
from sarpro_tpu_torch import cli as tcli  # noqa: E402
from sarpro_tpu_torch.io import geodesy as tgeo  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from sarpro_tpu_torch.io import safe as tsafe  # noqa: E402
from sarpro_tpu_torch.io import tiffio as ttiff  # noqa: E402
from sarpro_tpu_torch.io.writers import metadata as tmeta  # noqa: E402
from sarpro_tpu_torch.io.writers import tiff as twtiff  # noqa: E402
from sarpro_tpu_torch.io.writers import worldfile as tworld  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

SOURCES = {
    "gcp": {},
    "affine": {"with_affine_geotransform": True},
    "geolocation_grid": {"tiff_gcps": False, "with_geolocation_grid": True},
}


@pytest.fixture(scope="module")
def safes(tmp_path_factory):
    return {name: fixtures.make_safe(tmp_path_factory.mktemp(name),
                                     shape=(60, 80), **kw)
            for name, kw in SOURCES.items()}


def _same_value(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def _fields_equal(t, j, skip=()):
    """Every dataclass field of the port's object equals the original's."""
    names = [f.name for f in dataclasses.fields(j)]
    assert [f.name for f in dataclasses.fields(t)] == names
    for name in names:
        if name not in skip:
            assert _same_value(getattr(t, name), getattr(j, name)), name


def _port_metadata(j):
    """The port's SafeMetadata holding the original's values."""
    return tsafe.SafeMetadata(**{f.name: getattr(j, f.name)
                                 for f in dataclasses.fields(j)})


# ---------------------------------------------------------------------------
# the SAFE parser, file discovery and the raster reader
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("source", list(SOURCES))
def test_parse_comprehensive_metadata_equal(safes, source):
    t = tsafe.parse_comprehensive_metadata(safes[source])
    j = jsafe.parse_comprehensive_metadata(safes[source])
    _fields_equal(t, j, skip=("conversion_timestamp",))
    assert t.conversion_version == j.conversion_version == "0.5.0"
    assert t.conversion_timestamp.endswith("+00:00")


@pytest.mark.parametrize("source", list(SOURCES))
def test_identify_polarization_files_equal(safes, source):
    meas = safes[source] / "measurement"
    for available in (["VV", "VH"], ["HH"], []):
        assert tsafe.identify_polarization_files(meas, available) == \
            jsafe.identify_polarization_files(meas, available)


def test_identify_polarization_files_infers_from_available(tmp_path):
    """No polarization in the file name: both infer it the same way."""
    (tmp_path / "scene.tiff").write_bytes(b"")
    (tmp_path / "other.txt").write_bytes(b"")
    for available in (["VV"], ["VH", "VV"], ["HH"], ["HV"]):
        assert tsafe.identify_polarization_files(tmp_path, available) == \
            jsafe.identify_polarization_files(tmp_path, available)


# the products of a batch directory: make_safe's keywords, None for a
# directory that is no SAFE, "xml" for a product whose annotation is broken
SKIP_PRODUCTS = {
    "grd vv+vh": {},
    "grd hh+hv": dict(name="S1A_EW_GRDM_1SDH_20250706T204346.SAFE",
                      pols=("hh", "hv")),
    "slc": dict(product_type="SLC"),
    "grd vv only": dict(pols=("vv",)),
    "not a safe": None,
    "unreadable xml": "xml",
}


def _skip_outcome(fn, path, params):
    try:
        return "reason", fn(path, params)
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return "raises", type(e).__name__


@pytest.mark.parametrize("product", list(SKIP_PRODUCTS))
def test_scene_skip_reason_equal(tmp_path, product):
    """The batch drivers' XML-only viability check, for every polarization
    the CLI takes."""
    from sarpro_tpu import api as japi
    from sarpro_tpu_torch import api as tapi

    kw = SKIP_PRODUCTS[product]
    if kw is None:
        path = tmp_path / "junk"
        path.mkdir()
        (path / "notes.txt").write_text("no product here")
    else:
        path = fixtures.make_safe(tmp_path, **({} if kw == "xml" else kw))
        if kw == "xml":
            for xml in (path / "annotation").glob("*.xml"):
                xml.write_text("<product><adsHeader>")
    outcomes = set()
    for pol in jcli.build_parser()._option_string_actions[
            "--polarization"].choices:
        argv = ["--polarization", pol]
        t = _skip_outcome(tapi.scene_skip_reason, path,
                          tcli._params_from_args(tcli.build_parser()
                                                 .parse_args(argv)))
        j = _skip_outcome(japi.scene_skip_reason, path,
                          jcli._params_from_args(jcli.build_parser()
                                                 .parse_args(argv)))
        assert t == j, pol
        outcomes.add(t)
    print(f"{product}: {sorted(outcomes, key=str)}")


@pytest.mark.parametrize("source", list(SOURCES))
def test_raster_reader_equal(safes, source):
    path = next((safes[source] / "measurement").glob("*-vv-*"))
    t, j = traster.RasterReader(path), jraster.RasterReader(path)
    try:
        _fields_equal(t.metadata, j.metadata)
        _fields_equal(t.geo, j.geo)
        np.testing.assert_array_equal(t.read_band(1), j.read_band(1))
        assert t.read_band(1).dtype == np.float32
    finally:
        t.close()
        j.close()


def test_parse_epsg_equal():
    for wkt in ('PROJCS["x",AUTHORITY["EPSG","32632"]]', 'AUTHORITY["EPSG","',
                'AUTHORITY["EPSG","x4"]', "", jgeo.epsg_to_wkt(4326)):
        assert traster.parse_epsg(wkt) == jraster.parse_epsg(wkt)


def test_raster_reader_refuses_a_non_tiff(tmp_path):
    """A file that is neither a TIFF, netCDF nor a decodable PNG (here a
    PNG cut after its signature) raises the JAX reader's error in both."""
    path = tmp_path / "scene.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(tsafe.raster.RasterError) as t_err:
        traster.RasterReader(path)
    with pytest.raises(jraster.RasterError) as j_err:
        jraster.RasterReader(path)
    for err in (t_err, j_err):
        assert str(err.value).startswith(
            f"unsupported raster format: {path} is neither a TIFF nor "
            "PIL-decodable")


# ---------------------------------------------------------------------------
# geodesy
# ---------------------------------------------------------------------------
def _crs(safe, target):
    if target != "auto":
        return target
    crs = jgeo.resolve_auto_target_crs(safe)
    assert tgeo.resolve_auto_target_crs(safe) == crs
    return crs or "EPSG:32633"  # an affine product resolves to nothing


@pytest.mark.parametrize("source", list(SOURCES))
@pytest.mark.parametrize("target", ["auto", "EPSG:4326", "EPSG:3857"])
def test_geodesy_bit_equal(safes, source, target):
    crs = _crs(safes[source], target)
    code = tgeo.parse_epsg_code(crs)
    assert code == jgeo.parse_epsg_code(crs)
    assert tgeo.epsg_kind(code) == jgeo.epsg_kind(code)
    assert tgeo.epsg_to_wkt(code) == jgeo.epsg_to_wkt(code)
    assert tgeo.unsupported_reason(code) == jgeo.unsupported_reason(code)
    lon, lat = np.meshgrid(np.linspace(10.2, 11.9, 23),
                           np.linspace(45.1, 46.8, 19))
    fwd_t = tgeo.project_forward(lon, lat, code)
    fwd_j = jgeo.project_forward(lon, lat, code)
    for a, b in zip(fwd_t, fwd_j):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tgeo.project_inverse(*fwd_t, code),
                    jgeo.project_inverse(*fwd_j, code)):
        np.testing.assert_array_equal(a, b)
    tgeo.refine_dynamic_crs_area(code, 11.0, 46.0)
    jgeo.refine_dynamic_crs_area(code, 11.0, 46.0)
    assert tgeo.epsg_kind(code) == jgeo.epsg_kind(code)


def test_geodesy_tables_and_auto_zones_equal():
    assert tgeo.SUPPORTED_CRS_FAMILIES == jgeo.SUPPORTED_CRS_FAMILIES
    for lon, lat in ((11.0, 46.0), (-70.5, -33.4), (5.0, 60.5),
                     (20.0, 78.0), (0.0, 89.0), (0.0, -89.0)):
        assert tgeo.lonlat_to_epsg(lon, lat) == jgeo.lonlat_to_epsg(lon, lat)
    for code in (999999, 32632, 4326):
        assert tgeo.unsupported_reason(code) == jgeo.unsupported_reason(code)


def test_thin_plate_spline_bit_equal(rng):
    src = rng.random((25, 2)) * [400, 300]
    dst = np.stack([11 + src[:, 0] / 1600, 46 - src[:, 1] / 1200], -1)
    pts = rng.random((500, 2)) * [400, 300]
    np.testing.assert_array_equal(tgeo.ThinPlateSpline2D(src, dst)(pts),
                                  jgeo.ThinPlateSpline2D(src, dst)(pts))


# ---------------------------------------------------------------------------
# the TIFF codec and the writers
# ---------------------------------------------------------------------------
def _both(tmp_path, name):
    (tmp_path / "t").mkdir(exist_ok=True)
    (tmp_path / "j").mkdir(exist_ok=True)
    return tmp_path / "t" / name, tmp_path / "j" / name


WRITERS = {
    "u8": ("write_tiff_u8", np.uint8, 1),
    "u16": ("write_tiff_u16", np.uint16, 1),
    "multiband u8": ("write_tiff_multiband_u8", np.uint8, 2),
    "multiband u16": ("write_tiff_multiband_u16", np.uint16, 2),
}


@pytest.mark.parametrize("kind", list(WRITERS))
@pytest.mark.parametrize("source", ["gcp", "affine"])
def test_tiff_writers_byte_identical(safes, tmp_path, rng, kind, source):
    name, dtype, n = WRITERS[kind]
    meta_j = jsafe.parse_comprehensive_metadata(safes[source])
    meta_t = _port_metadata(meta_j)
    rows, cols = 37, 53
    bands = [rng.integers(0, np.iinfo(dtype).max, (rows, cols)).astype(dtype)
             for _ in range(n)]
    gt = ([500000.0, 20.0, 0.0, 5100000.0, 0.0, -20.0]
          if source == "affine" else None)
    proj = jgeo.epsg_to_wkt(32632) if gt else None
    t_out, j_out = _both(tmp_path, "out.tiff")
    for mod, meta, out, md in ((twtiff, meta_t, t_out, tmeta),
                               (jwtiff, meta_j, j_out, jmeta)):
        ds = getattr(mod, name)(out, cols, rows, *bands)
        md.embed_tiff_metadata(ds, meta, "VV", gt, proj)
        ds.flush()
    assert t_out.read_bytes() == j_out.read_bytes()
    t, j = ttiff.TiffReader(t_out), jtiff.TiffReader(j_out)
    try:
        for i in range(1, n + 1):
            np.testing.assert_array_equal(t.read(i), j.read(i))
            np.testing.assert_array_equal(t.read(i), bands[i - 1])
        _fields_equal(t.geo_info(), j.geo_info())
        assert t.gdal_metadata() == j.gdal_metadata()
    finally:
        t.close()
        j.close()


@pytest.mark.parametrize("source", ["gcp", "affine", "geolocation_grid"])
def test_jpeg_sidecars_byte_identical(safes, tmp_path, source):
    meta_j = jsafe.parse_comprehensive_metadata(safes[source])
    meta_t = _port_metadata(meta_j)
    gt = [600000.0, 10.0, 0.0, 5200000.0, 0.0, -10.0]
    proj = jgeo.epsg_to_wkt(32632)
    t_out, j_out = _both(tmp_path, "out.jpg")
    extras = [("synthetic_rgb_mode", "Default")]
    for world, md, meta, out in ((tworld, tmeta, meta_t, t_out),
                                 (jworld, jmeta, meta_j, j_out)):
        world.write_world_file(out, gt)
        world.write_prj_file(out, proj)
        md.create_jpeg_metadata_sidecar_with_overrides_and_extras(
            out, meta, "Multiband (VV+VH)", gt, proj, extras)
    for ext in (".jgw", ".prj", ".json"):
        assert t_out.with_suffix(ext).read_bytes() == \
            j_out.with_suffix(ext).read_bytes(), ext


# ---------------------------------------------------------------------------
# the CLI parser
# ---------------------------------------------------------------------------
ARGVS = [args for _, _, args in chip_smoke.GRAY_RUNS] + [
    ["-f", "jpeg", "--polarization", "multiband", "--autoscale", "tamed",
     "--size", "2048", "--pad", "--target-crs", "auto", "--resample-alg",
     "cubic"],
    [],
    ["--polarization", "log-ratio", "--synrgb-mode", "sar-urban", "--size",
     "original", "--target-crs", "EPSG:4326"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "defaults"
                                             for a in ARGVS])
def test_cli_params_equal(argv):
    argv = ["-i", "X.SAFE", "-o", "out", "--fast"] + argv
    t = tcli._params_from_args(tcli.build_parser().parse_args(argv))
    j = jcli._params_from_args(jcli.build_parser().parse_args(argv))
    assert t.to_dict() == j.to_dict()
    assert t.to_json() == j.to_json()
    assert type(t).__module__ == "sarpro_tpu_torch.params"


def test_cli_version_and_errors_equal(capsys):
    for mod in (tcli, jcli):
        with pytest.raises(SystemExit):
            mod.build_parser().parse_args(["--version"])
    t, j = capsys.readouterr().out.splitlines()
    assert t == j == "sarpro 0.5.0"
    for size in ("0", "-3", "abc"):
        args = ["-i", "x", "-o", "y", "--size", size]
        with pytest.raises(Exception) as t_err:
            tcli._params_from_args(tcli.build_parser().parse_args(args))
        with pytest.raises(Exception) as j_err:
            jcli._params_from_args(jcli.build_parser().parse_args(args))
        assert type(t_err.value).__name__ == type(j_err.value).__name__
        assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# chip_smoke.py's copy of the fixture SAFE writer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    {},
    dict(name="S1A_EW_GRDM_1SDH_20250706T204346.SAFE", pols=("hh", "hv"),
         seed=11, with_affine_geotransform=True),
], ids=["gcp", "affine hh+hv"])
def test_make_safe_copy_byte_identical(tmp_path, kw):
    t = chip_smoke.make_safe(tmp_path / "t", shape=(41, 67), **kw)
    j = fixtures.make_safe(tmp_path / "j", shape=(41, 67), **kw)
    files = sorted(p.relative_to(j) for p in j.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(t) for p in t.rglob("*")
                           if p.is_file())
    for rel in files:
        assert (t / rel).read_bytes() == (j / rel).read_bytes(), rel


# ---------------------------------------------------------------------------
# the port's own build of the native codec
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def codec():
    if not t_native.available():
        pytest.skip("g++ is not available to build the native codec")
    return t_native


def test_native_codec_builds_into_the_checkout(codec):
    built = list(t_native.BUILD_DIR.glob("libsarpro_codec_*.so"))
    assert built and all(p.parent == t_native.BUILD_DIR for p in built)
    assert t_native.BUILD_DIR.is_relative_to(REPO)


def test_native_box_reduce_matches_numpy(codec, rng):
    src = rng.integers(0, 65536, (97, 130)).astype(np.uint16)
    (ys, yc) = traster._average_windows(97, 20)
    (xs, xc) = traster._average_windows(130, 31)
    out = np.empty((20, 31), np.float32)
    codec.box_reduce_u16(src, out, 0, 20, ys, yc, xs, xc)
    want = np.array([[src[y:y + h, x:x + w].astype(np.float64).mean()
                      for x, w in zip(xs, xc)] for y, h in zip(ys, yc)])
    np.testing.assert_allclose(out, want, rtol=1e-6)


@pytest.mark.parametrize("shape", [(24, 40), (72, 56)])
def test_native_jpeg_holds_the_coefficients(codec, rng, shape):
    """The entropy coder's output decodes to the blocks it was given (the
    block layout of io/writers/jpeg: transposed 8x8 blocks, zigzag in the
    file)."""
    rows, cols = shape
    n = (rows // 8) * (cols // 8)
    blocks = rng.integers(-40, 41, (3, n, 8, 8)).astype(np.int16)
    blob = codec.jpeg_encode_coeffs444(blocks[0], blocks[1], blocks[2], cols,
                                       rows)
    got, ncomp = decode_baseline_jpeg_coeffs(blob, n)
    assert ncomp == 3
    zz = chip_smoke._zigzag()
    for m in range(n):
        for c in range(3):
            assert got[m * 3 + c] == [int(blocks[c, m][col, row])
                                      for row, col in zz]
    gray = codec.jpeg_encode_coeffs_gray(blocks[0], cols, rows)
    got, ncomp = decode_baseline_jpeg_coeffs(gray, n)
    assert ncomp == 1
    assert got[0] == [int(blocks[0, 0][col, row]) for row, col in zz]


# ---------------------------------------------------------------------------
# exact mode's host pieces: stats, the CLAHE CDFs, the quantized resize
# ---------------------------------------------------------------------------
def _code_of(module):
    """A module's source below its docstring."""
    import inspect

    src = inspect.getsource(module)
    return src[src.index("from __future__"):]


def test_stats_copy_is_the_original():
    from sarpro_tpu.core import stats as jstats
    from sarpro_tpu_torch.core import stats as tstats

    assert _code_of(tstats) == _code_of(jstats)


def _random_hist(rng, count):
    hist = np.zeros(4096, np.uint64)
    np.add.at(hist, rng.integers(0, 4096, count), 1)
    return hist


@pytest.mark.parametrize("count", [1, 2, 37, 5000])
def test_stats_copy_bit_equal(rng, count):
    from sarpro_tpu.core import stats as jstats
    from sarpro_tpu.types import AutoscaleStrategy as JStrategy
    from sarpro_tpu_torch.core import stats as tstats
    from sarpro_tpu_torch.types import AutoscaleStrategy

    hist = _random_hist(rng, count)
    args = (hist, count, -23.5, 17.25, -3.1, 6.7)
    t, j = tstats.stats_from_histogram(*args), jstats.stats_from_histogram(
        *args)
    _fields_equal(t, j)
    for p in (0.0, 0.01, 0.5, 0.99, 1.0):
        assert tstats.estimate_percentile(hist, count, -23.5, 17.25, p) == \
            jstats.estimate_percentile(hist, count, -23.5, 17.25, p)
    db = rng.normal(-10, 6, (31, 47)).astype(np.float32)
    valid = rng.random(db.shape) < 0.9
    _fields_equal(tstats.compute_histogram_stats_host(db, valid),
                  jstats.compute_histogram_stats_host(db, valid))
    for s in AutoscaleStrategy:
        _fields_equal(tstats.advanced_window(t, s),
                      jstats.advanced_window(j, JStrategy(s.value)))
    _fields_equal(tstats.standard_window(t), jstats.standard_window(j))
    for copol in (True, False):
        w = tstats.tamed_synrgb_window(t, copol)
        _fields_equal(w, jstats.tamed_synrgb_window(j, copol))
        assert w.range == jstats.tamed_synrgb_window(j, copol).range
    for kind in ("empty", "degenerate"):
        a = (tstats.HistogramStats.empty() if kind == "empty"
             else tstats.HistogramStats.degenerate(5, -2.0, -2.0, 0.0))
        b = (jstats.HistogramStats.empty() if kind == "empty"
             else jstats.HistogramStats.degenerate(5, -2.0, -2.0, 0.0))
        _fields_equal(a, b)


@pytest.mark.parametrize("rows,cols", [(48, 64), (37, 53), (8, 9), (300, 7)])
@pytest.mark.parametrize("skew", [0.0, 0.9])
def test_clip_redistribute_cdf_bit_equal(rng, rows, cols, skew):
    """The host's f64 CLAHE CDFs, on tile histograms from clipped-heavy
    (skewed into few bins) to flat."""
    from sarpro_tpu.core import clahe as jclahe
    from sarpro_tpu_torch.core import clahe as tclahe

    tile_h, tile_w = -(-rows // 8), -(-cols // 8)
    bins = rng.integers(0, 256, rows * cols)
    bins[rng.random(bins.size) < skew] = 17
    r, c = np.divmod(np.arange(rows * cols), cols)
    tile = np.minimum(r // tile_h, 7) * 8 + np.minimum(c // tile_w, 7)
    hists = np.bincount(tile * 256 + bins, minlength=64 * 256).astype(np.int32)
    got = tclahe._clip_redistribute_cdf(hists, rows, cols, tile_h, tile_w)
    want = jclahe._clip_redistribute_cdf(hists, rows, cols, tile_h, tile_w)
    assert got.dtype == np.float64 and got.shape == (64, 256)
    np.testing.assert_array_equal(got, want)


# (rows, cols, target_size): the columns pass and the rows pass up to 24 taps
# (the JAX package's unrolled loop) and past it (its dot), one pass only, the
# skip at the target size and the upscale no-op
RESIZES = [(48, 64, 40), (37, 53, 29), (300, 200, 64), (480, 640, 128),
           (64, 30, 48), (40, 64, 64), (37, 53, 80)]


@pytest.mark.parametrize("rows,cols,size", RESIZES)
@pytest.mark.parametrize("depth", ["u8", "u16"])
def test_quantized_resize_bit_equal(rng, rows, cols, size, depth):
    import torch

    from sarpro_tpu.core import resize as jresize
    from sarpro_tpu.types import BitDepth as JBitDepth
    from sarpro_tpu_torch.core import resize as tresize
    from sarpro_tpu_torch.types import BitDepth

    dtype = np.uint8 if depth == "u8" else np.uint16
    data = rng.integers(0, np.iinfo(dtype).max + 1, (rows, cols)).astype(dtype)
    tc, tr = jresize.calculate_resize_dimensions(cols, rows, size)
    assert tresize.calculate_resize_dimensions(cols, rows, size) == (tc, tr)
    fj, ft = ((jresize.resize_u8_image, tresize.resize_u8_image) if depth ==
              "u8" else (jresize.resize_u16_image, tresize.resize_u16_image))
    got = ft(torch.from_numpy(data), cols, rows, tc, tr)
    want = np.asarray(fj(data, cols, rows, tc, tr))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    for pad in (False, True):
        u8, u16 = ((data, None) if depth == "u8" else (None, data))
        t_out = tresize.resize_image_data_with_meta(
            None if u8 is None else torch.from_numpy(u8),
            None if u16 is None else torch.from_numpy(u16), cols, rows, size,
            BitDepth(depth), pad)
        j_out = jresize.resize_image_data_with_meta(u8, u16, cols, rows, size,
                                                    JBitDepth(depth), pad)
        assert t_out[:2] + t_out[4:] == j_out[:2] + j_out[4:]
        for a, b in zip(t_out[2:4], j_out[2:4]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tresize.resize_image_data(
            *(None if v is None else torch.from_numpy(v) for v in (u8, u16)),
            cols, rows, size, BitDepth(depth), pad)[:2] == j_out[:2]


@pytest.mark.parametrize("rows,cols", [(30, 50), (50, 30), (40, 40)])
def test_add_padding_to_square_bit_equal(rng, rows, cols):
    import torch

    from sarpro_tpu.core import resize as jresize
    from sarpro_tpu.types import BitDepth as JBitDepth
    from sarpro_tpu_torch.core import resize as tresize
    from sarpro_tpu_torch.types import BitDepth

    u8 = rng.integers(0, 256, (rows, cols)).astype(np.uint8)
    u16 = rng.integers(0, 65536, (rows, cols)).astype(np.uint16)
    t8, _ = tresize.add_padding_to_square(torch.from_numpy(u8), None, cols,
                                          rows, BitDepth.U8)
    j8, _ = jresize.add_padding_to_square(u8, None, cols, rows, JBitDepth.U8)
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    _, t16 = tresize.add_padding_to_square(None, torch.from_numpy(u16), cols,
                                           rows, BitDepth.U16)
    _, j16 = jresize.add_padding_to_square(None, u16, cols, rows,
                                           JBitDepth.U16)
    assert t16.dtype == torch.uint16
    np.testing.assert_array_equal(t16.numpy(), np.asarray(j16))
    with pytest.raises(ValueError, match="U16 data required"):
        tresize.add_padding_to_square(None, None, cols, rows, BitDepth.U16)


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_native_pixel_entries_match_the_jax_bindings(codec, rng, monkeypatch,
                                                     tmp_path, shape):
    """The port's pixel entries give the JAX package's bindings' streams
    (same library sources; the JAX package's own build is stood in for by
    the port's), at every thread count whose band split is sound; every
    MCU within +-1 of an f64 DCT of the planes."""
    from oracle import jpeg_dct_oracle
    from sarpro_tpu import _native as jnative

    lib_dir = tmp_path / "jax_native"
    lib_dir.mkdir()
    (lib_dir / "tiffcodec.so").symlink_to(t_native._build())
    monkeypatch.setattr(jnative, "__file__", str(lib_dir / "__init__.py"))
    monkeypatch.setattr(jnative, "_TRIED", False)
    monkeypatch.setattr(jnative, "_LIB", None)
    planes = rng.integers(0, 256, (3,) + shape).astype(np.uint8)
    rows = -(-shape[0] // 8)
    for n in (1, 2, 3, 5):
        if (min(n, rows) - 1) * -(-rows // min(n, rows)) >= rows:
            continue  # a split the JAX bindings would abort on
        assert codec.jpeg_encode_gray(planes[0], n) == \
            jnative.jpeg_encode_gray(planes[0], n)
        assert codec.jpeg_encode_ycbcr444(*planes, n) == \
            jnative.jpeg_encode_ycbcr444(*planes, n)
    blob = codec.jpeg_encode_ycbcr444(*planes)
    h, w = shape
    padded = np.pad(planes, ((0, 0), (0, -h % 8), (0, -w % 8)), mode="edge")
    want = jpeg_dct_oracle(padded).reshape(3, -1, 8, 8)
    got, ncomp = decode_baseline_jpeg_coeffs(blob, want.shape[1])
    assert ncomp == 3
    zz = chip_smoke._zigzag()
    for m in range(want.shape[1]):
        for c in range(3):
            exp = [int(want[c, m][col, row]) for row, col in zz]
            assert max(abs(a - b) for a, b in zip(got[m * 3 + c], exp)) <= 1
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        codec.jpeg_encode_gray(planes[0].astype(np.uint16))


# ---------------------------------------------------------------------------
# the GUI slice's copies: the logging ring, the netCDF reader, the non-TIFF
# reader's sidecar georeferencing, the GUI's host helpers and its page
# ---------------------------------------------------------------------------
def _source(obj):
    import inspect

    return inspect.getsource(obj)


def test_logging_and_netcdf_copies_are_the_originals():
    from sarpro_tpu.io import ncraster as jnc
    from sarpro_tpu.utils import logging as jlog
    from sarpro_tpu_torch.io import ncraster as tnc
    from sarpro_tpu_torch.utils import logging as tlog

    assert _code_of(tlog) == _code_of(jlog)
    assert _code_of(tnc) == _code_of(jnc)
    assert tlog.RING_CAPACITY == jlog.RING_CAPACITY


@pytest.mark.parametrize("name", ["world_file_candidates", "read_world_file",
                                  "read_prj_epsg"])
def test_pilraster_sidecar_functions_are_the_originals(name):
    from sarpro_tpu.io import pilraster as jpil
    from sarpro_tpu_torch.io import pilraster as tpil

    assert _source(getattr(tpil, name)) == _source(getattr(jpil, name))
    assert tpil.PIL_EXTENSIONS == jpil.PIL_EXTENSIONS


@pytest.mark.parametrize("name", ["list_directory"])
def test_gui_server_helpers_are_the_originals(name):
    from sarpro_tpu.gui import server as jsrv
    from sarpro_tpu_torch.gui import server as tsrv

    assert _source(getattr(tsrv, name)) == _source(getattr(jsrv, name))


@pytest.mark.parametrize("name", ["save_preset", "load_preset",
                                  "system_stats"])
def test_gui_state_helpers_are_the_originals(name):
    from sarpro_tpu.gui import state as jst
    from sarpro_tpu_torch.gui import state as tst

    assert _source(getattr(tst, name)) == _source(getattr(jst, name))


def test_gui_page_is_the_original_but_its_device_labels():
    j = (REPO / "sarpro_tpu/gui/static/index.html").read_text().split("\n")
    t = (REPO / "sarpro_tpu_torch/gui/static/index.html").read_text().split(
        "\n")
    assert len(t) == len(j)
    differ = [i + 1 for i, (a, b) in enumerate(zip(t, j)) if a != b]
    assert differ == [5, 73]
    for i in (4, 72):
        assert "TPU" in j[i] and t[i] == j[i].replace("TPU", "GPU")


def test_list_directory_and_system_stats_equal(tmp_path):
    from sarpro_tpu.gui import server as jsrv
    from sarpro_tpu.gui import state as jst
    from sarpro_tpu_torch.gui import server as tsrv
    from sarpro_tpu_torch.gui import state as tst

    fixtures.make_safe(tmp_path, name="S1A_X.SAFE", pols=("vv",))
    (tmp_path / "b.tiff").write_bytes(b"x")
    (tmp_path / ".h").mkdir()
    assert tsrv.list_directory(str(tmp_path)) == jsrv.list_directory(
        str(tmp_path))
    assert set(tst.system_stats()) == set(jst.system_stats())
