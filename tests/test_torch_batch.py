"""The port's batch drivers on the CPU: `api.process_directory_to_path`
(serial) and `parallel/batch.process_directory_pipelined` (loader threads,
a writer thread, device-batch buckets), against the JAX package's drivers
and against the port's own single-scene CLI.

  * counters (processed, skipped, errors) equal to the JAX drivers' on the
    same directory, and the cases of tests/test_batch.py: SLC and non-SAFE
    directories skipped, a failed loader or write counted, missing
    polarizations skipped by both drivers, resume, progress, observer
    exceptions ignored, full, partial and mixed-shape buckets;
  * every file of the serial, pipelined and bucketed drivers byte-identical
    to the single-scene CLI's for its product (one conversion time fixed);
  * one fast route (gray JPEG, coefficient blocks captured) and one exact
    route (u16 TIFF) against the JAX batch's output, within the bounds of
    tests/test_torch_gray.py and tests/test_torch_exact.py;
  * every kernel wrapper call and every Tensor.to onto a device made on the
    calling thread, none on a loader or the writer;
  * the O_DIRECT read bit-equal to the buffered one; the pinned staging
    recycled under concurrent loaders.
"""
import logging
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fixtures  # noqa: E402
from sarpro_tpu import api as japi  # noqa: E402
from sarpro_tpu.cli import _params_from_args, build_parser  # noqa: E402
from sarpro_tpu.core import fast_path as jfast  # noqa: E402
from sarpro_tpu.core import fused as jf  # noqa: E402
from sarpro_tpu.parallel.batch import (  # noqa: E402
    process_directory_pipelined as j_pipelined,
)
from sarpro_tpu_torch import _native as tnative  # noqa: E402
from sarpro_tpu_torch import api as tapi  # noqa: E402
from sarpro_tpu_torch import cli as tcli  # noqa: E402
from sarpro_tpu_torch.core import fused as tf  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from sarpro_tpu_torch.io import safe as tsafe  # noqa: E402
from sarpro_tpu_torch.io.raster import RasterReader  # noqa: E402
from sarpro_tpu_torch.io.tiffio import TiffReader  # noqa: E402
from sarpro_tpu_torch.io.writers import jpeg as tjpeg  # noqa: E402
from sarpro_tpu_torch.parallel import batch as tbatch  # noqa: E402
from test_torch_exact import _FixedClock, _jax_rasters, _within  # noqa: E402
from test_torch_exact import _level_bound as _exact_bound  # noqa: E402
from test_torch_exact import native_both  # noqa: E402,F401
from test_torch_gray import _block_agree, _jax_band, _t  # noqa: E402
from test_torch_gray import _level_bound as _fast_bound  # noqa: E402

DRIVERS = ("serial", "pipelined")


def _jparams(argv):
    return _params_from_args(build_parser().parse_args(argv))


def _tparams(argv):
    return tcli._params_from_args(tcli.build_parser().parse_args(argv))


def _setup(root):
    """Three GRD products, an SLC one and a directory that is no SAFE."""
    indir = root / "in"
    indir.mkdir()
    for i, name in enumerate(("a", "b", "c"), 1):
        fixtures.make_safe(indir, name=f"{name}.SAFE", seed=i)
    fixtures.make_safe(indir, name="slc.SAFE", product_type="SLC", seed=4)
    (indir / "junk").mkdir()
    return indir


def _port(driver, indir, out, params, **kw):
    if driver == "serial":
        return tapi.process_directory_to_path(indir, out, params,
                                              device="cpu", **kw)
    return tbatch.process_directory_pipelined(indir, out, params, prefetch=2,
                                              device="cpu", **kw)


def _jax(driver, indir, out, params, **kw):
    if driver == "serial":
        return japi.process_directory_to_path(indir, out, params, **kw)
    return j_pipelined(indir, out, params, prefetch=2, **kw)


def _counts(report):
    return report.processed, report.skipped, report.errors


@pytest.fixture
def codec():
    if not tnative.available():
        pytest.skip("g++ is not available to build the native codec")


@pytest.fixture
def fixed_clock(monkeypatch):
    """One conversion time for every parse, so files compare by bytes."""
    monkeypatch.setattr(tsafe, "datetime", _FixedClock)
    tsafe._parse_comprehensive_cached.cache_clear()
    yield
    tsafe._parse_comprehensive_cached.cache_clear()


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------
COUNTER_ROUTES = {
    "exact standard tiff": ["--autoscale", "standard", "--size", "32"],
    "fast tamed synrgb jpeg": ["-f", "jpeg", "--polarization", "multiband",
                               "--autoscale", "tamed", "--size", "32",
                               "--fast"],
}


@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("route", list(COUNTER_ROUTES))
def test_counters_equal_jax(tmp_path, codec, driver, route):
    indir = _setup(tmp_path)
    argv = COUNTER_ROUTES[route]
    fast = "--fast" in argv
    t = _port(driver, indir, tmp_path / "t", _tparams(argv), fast=fast)
    j = _jax(driver, indir, tmp_path / "j", _jparams(argv), fast=fast)
    assert _counts(t) == _counts(j) == (3, 2, 0)
    ext = "jpg" if fast else "tiff"
    assert sorted(p.name for p in (tmp_path / "t").glob(f"*.{ext}")) == [
        f"{n}.SAFE.{ext}" for n in "abc"]


@pytest.mark.parametrize("driver", DRIVERS)
def test_counters_equal_jax_with_a_cut_raster(mixed, tmp_path, codec,
                                              driver):
    """A product whose raster is cut short is an error in both packages;
    a second shape changes nothing."""
    argv = ["--polarization", "vv", "--autoscale", "robust", "--size", "32"]
    t = _port(driver, mixed, tmp_path / "t", _tparams(argv))
    j = _jax(driver, mixed, tmp_path / "j", _jparams(argv))
    assert _counts(t) == _counts(j) == (4, 2, 1)


def test_loader_crash_is_isolated(tmp_path, monkeypatch):
    """A loader that raises on one scene costs that scene only."""
    indir = _setup(tmp_path)
    real = tbatch._load_scene

    def flaky(path, *args):
        if path.name == "b.SAFE":
            raise RuntimeError("synthetic loader crash")
        return real(path, *args)

    monkeypatch.setattr(tbatch, "_load_scene", flaky)
    report = _port("pipelined", indir, tmp_path / "o",
                   _tparams(["--autoscale", "standard", "--size", "32"]))
    assert _counts(report) == (2, 2, 1)


@pytest.mark.parametrize("driver", DRIVERS)
def test_write_error_is_counted(tmp_path, monkeypatch, driver):
    """A failure inside the (deferred) write counts as an error."""
    indir = _setup(tmp_path)

    def boom(*a, **k):
        raise RuntimeError("synthetic encode failure")

    monkeypatch.setattr(tjpeg, "write_synrgb_jpeg_dct", boom)
    argv = ["-f", "jpeg", "--polarization", "multiband", "--autoscale",
            "clahe", "--size", "32"]
    report = _port(driver, indir, tmp_path / "o", _tparams(argv), fast=True)
    assert _counts(report) == (0, 2, 3)


@pytest.mark.parametrize("driver", DRIVERS)
def test_missing_polarization_is_skipped(tmp_path, codec, driver):
    """A GRD product without VH under multiband is skipped, not an error
    (reference: api/mod.rs:502-533)."""
    indir = tmp_path / "in"
    indir.mkdir()
    fixtures.make_safe(indir, name="full.SAFE", pols=("vv", "vh"), seed=1)
    fixtures.make_safe(indir, name="vvonly.SAFE", pols=("vv",), seed=2)
    argv = ["-f", "jpeg", "--polarization", "multiband", "--autoscale",
            "tamed", "--size", "32"]
    report = _port(driver, indir, tmp_path / "o", _tparams(argv), fast=True)
    assert _counts(report) == (1, 1, 0)
    assert (tmp_path / "o" / "full.SAFE.jpg").exists()
    hh = _port(driver, indir, tmp_path / "hh",
               _tparams(["--polarization", "hh", "--size", "32"]))
    assert _counts(hh) == (0, 2, 0)


@pytest.mark.parametrize("driver", DRIVERS)
def test_resume_skips_existing_outputs(tmp_path, driver):
    indir = _setup(tmp_path)
    params = _tparams(["--autoscale", "standard", "--size", "32"])
    out = tmp_path / "o"
    assert _counts(_port(driver, indir, out, params)) == (3, 2, 0)
    (out / "b.SAFE.tiff").unlink()
    before = (out / "a.SAFE.tiff").stat().st_mtime_ns
    assert _counts(_port(driver, indir, out, params, resume=True)) == (1, 4, 0)
    assert (out / "b.SAFE.tiff").exists()
    assert (out / "a.SAFE.tiff").stat().st_mtime_ns == before


@pytest.mark.parametrize("driver", DRIVERS)
def test_progress_counts_every_scene(tmp_path, driver):
    indir = _setup(tmp_path)
    events = []
    report = _port(driver, indir, tmp_path / "o",
                   _tparams(["--autoscale", "standard", "--size", "32"]),
                   progress=lambda *e: events.append(e))
    dones = [e[0] for e in events]
    assert dones == sorted(dones)
    assert events[-1][0] == sum(_counts(report)) == 5
    assert all(e[1] == 5 for e in events)
    assert any(e[2] and e[2].endswith(".SAFE") for e in events)


@pytest.mark.parametrize("driver", DRIVERS)
def test_progress_exceptions_are_ignored(tmp_path, driver):
    indir = _setup(tmp_path)

    def bad(done, total, current):
        raise RuntimeError("observer crash")

    report = _port(driver, indir, tmp_path / "o",
                   _tparams(["--autoscale", "standard", "--size", "32"]),
                   progress=bad)
    assert _counts(report) == (3, 2, 0)


@pytest.mark.parametrize("driver", DRIVERS)
def test_sharding_raises(tmp_path, driver, fixed_clock, caplog):
    """A shard request (the name is the test's from before sharding was
    ported, when it raised): on the one CPU device each driver logs the
    JAX package's one-device warning and writes, in exact mode too, the
    single-scene --fast files byte for byte."""
    indir = tmp_path / "in"
    indir.mkdir()
    fixtures.make_safe(indir, name="a.SAFE", seed=1)
    params = _tparams(["--autoscale", "robust", "--size", "48"])
    with caplog.at_level(logging.WARNING, logger="sarpro"):
        report = _port(driver, indir, tmp_path / "o", params,
                       shard_devices=2)
    assert _counts(report) == (1, 0, 0)
    assert "shard: 2 device(s) requested but only 1 available; running " \
        "unsharded" in caplog.text
    ref = tmp_path / "ref.tiff"
    tapi.process_safe_to_path(indir / "a.SAFE", ref, params, fast=True,
                              device="cpu")
    assert (tmp_path / "o" / "a.SAFE.tiff").read_bytes() == ref.read_bytes()


def test_mixed_shapes_evict_partial_buckets(tmp_path, codec, monkeypatch):
    """12 shapes with device_batch 4: no bucket fills, so the staging cap
    (max(8, 2 * 4)) runs the oldest partial bucket per scene mid-run; every
    scene is written once, and the scenes loaded but not yet run stay under
    the cap plus the loads in flight."""
    indir = tmp_path / "in"
    indir.mkdir()
    for i in range(12):
        fixtures.make_safe(indir, name=f"h{i:02d}.SAFE", seed=40 + i,
                           shape=(96 + 4 * i, 128))
    loaded, saved, most = [0], [0], [0]
    real_load, real_save = tbatch._load_scene, tapi._Route.save

    def load(*a):
        r = real_load(*a)
        loaded[0] += 1
        return r

    def save(self, *a, **k):
        most[0] = max(most[0], loaded[0] - saved[0])
        saved[0] += 1
        return real_save(self, *a, **k)

    monkeypatch.setattr(tbatch, "_load_scene", load)
    monkeypatch.setattr(tapi._Route, "save", save)
    argv = ["-f", "jpeg", "--polarization", "multiband", "--autoscale",
            "clahe", "--size", "32"]
    report = tbatch.process_directory_pipelined(
        indir, tmp_path / "o", _tparams(argv), prefetch=2, fast=True,
        device_batch=4, device="cpu")
    assert _counts(report) == (12, 0, 0)
    assert saved[0] == 12
    assert most[0] <= 8 + 3 + 1
    assert len(list((tmp_path / "o").glob("*.jpg"))) == 12


# ---------------------------------------------------------------------------
# every driver writes what the single-scene CLI writes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Four GRD products (three of one shape, one of another), an SLC, a
    directory that is no SAFE, and a product whose VV raster is cut short:
    4 processed, 2 skipped, 1 error."""
    indir = tmp_path_factory.mktemp("mixed") / "in"
    indir.mkdir()
    for i, name in enumerate(("a", "b", "c"), 1):
        fixtures.make_safe(indir, name=f"{name}.SAFE", seed=i)
    fixtures.make_safe(indir, name="e.SAFE", seed=5, shape=(80, 120))
    fixtures.make_safe(indir, name="slc.SAFE", product_type="SLC", seed=6)
    (indir / "junk").mkdir()
    cut = fixtures.make_safe(indir, name="t.SAFE", seed=7)
    vv = next((cut / "measurement").glob("*-vv-*"))
    os.truncate(vv, vv.stat().st_size // 2)
    return indir


SAME_ROUTES = {
    "fast clahe auto synrgb jpeg": (
        "jpg", ["-f", "jpeg", "--polarization", "multiband", "--autoscale",
                "clahe", "--size", "32", "--pad", "--target-crs", "auto",
                "--resample-alg", "cubic", "--fast"]),
    "fast tamed cubic synrgb jpeg": (
        "jpg", ["-f", "jpeg", "--polarization", "multiband", "--autoscale",
                "tamed", "--size", "32", "--resample-alg", "cubic",
                "--fast"]),
    "exact clahe tiff": ("tiff", ["--polarization", "vv", "--size", "32"]),
    "fast ratio gray jpeg": ("jpg", ["-f", "jpeg", "--polarization", "ratio",
                                     "--autoscale", "standard", "--size",
                                     "32", "--fast"]),
}
def _o_direct_works(tiff) -> bool:
    reader = RasterReader(tiff)
    wins = traster._box_windows(reader, 1, 8, 8, "average")
    try:
        traster._read_average_direct(reader, np.empty((8, 8), np.float32),
                                     *wins, lambda o0, o1: None)
    except OSError:
        return False
    return True


RUNS = {"serial": ["--prefetch", "0"],
        "pipelined": ["--prefetch", "2", "--device-batch", "1"],
        "bucketed": ["--prefetch", "2", "--device-batch", "2"]}


@pytest.mark.parametrize("route", list(SAME_ROUTES))
def test_drivers_write_the_single_scene_files(mixed, tmp_path, codec,
                                              fixed_clock, capsys, route):
    ext, args = SAME_ROUTES[route]
    single = tmp_path / "single"
    single.mkdir()
    for name in ("a", "b", "c", "e"):
        assert tcli.run(["-i", str(mixed / f"{name}.SAFE"), "-o",
                         str(single / f"{name}.SAFE.{ext}")] + args,
                        device="cpu") == 0
    want = {p.name: p.read_bytes() for p in single.iterdir()}
    assert len([n for n in want if n.endswith(ext)]) == 4
    direct = _o_direct_works(next((mixed / "a.SAFE" / "measurement").glob(
        "*.tiff")))
    for run, extra in RUNS.items():
        capsys.readouterr()
        for k in traster.ROUTES:
            traster.ROUTES[k] = 0
        out = tmp_path / run
        assert tcli.run(["--input-dir", str(mixed), "--output-dir", str(out)]
                        + args + extra, device="cpu") == 0
        assert capsys.readouterr().out.splitlines()[-3:] == [
            "Processed: 4", "Skipped: 2", "Errors: 1"], run
        got = {p.name: p.read_bytes() for p in out.iterdir()}
        assert sorted(got) == sorted(want), run
        for name in want:
            assert got[name] == want[name], (run, name)
        print(f"{run}: read routes {traster.ROUTES}")
        if run != "serial" and direct and traster.ROUTES["host_reduce"]:
            # the loaders' host reduce took O_DIRECT; the serial driver's
            # and the single-scene CLI's, the buffered read
            assert traster.ROUTES["direct_io"] > 0
        if run == "serial":
            assert traster.ROUTES["direct_io"] == 0


# ---------------------------------------------------------------------------
# against the JAX package's batch
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def larger(tmp_path_factory):
    """Three products large enough that most 8 x 8 blocks of a 128 output
    agree between the packages."""
    indir = tmp_path_factory.mktemp("larger") / "in"
    indir.mkdir()
    for i, name in enumerate(("a", "b", "c"), 1):
        fixtures.make_safe(indir, name=f"{name}.SAFE", seed=20 + i,
                           shape=(300, 400))
    return indir


def test_fast_gray_jpeg_matches_jax_batch(larger, tmp_path, monkeypatch,
                                          native_both):
    """The pipelined fast ratio JPEG: each scene's coefficient blocks
    against the JAX pipelined batch's, within 1 wherever the two bands'
    8x8 blocks agree (tests/test_torch_gray.py's bound on the band)."""
    args = ["-f", "jpeg", "--polarization", "ratio", "--autoscale",
            "standard", "--size", "128"]
    got = {"t": {}, "j": {}}

    def capture(side):
        def write(output, cols, rows, coeffs):
            got[side][os.path.basename(output)] = (cols, rows,
                                                   np.asarray(coeffs))
            open(output, "wb").close()
        return write

    monkeypatch.setattr(tjpeg, "write_gray_jpeg_dct", capture("t"))
    monkeypatch.setattr(jfast, "write_gray_jpeg_dct", capture("j"))
    t = _port("pipelined", larger, tmp_path / "t", _tparams(args), fast=True)
    j = _jax("pipelined", larger, tmp_path / "j", _jparams(args), fast=True)
    assert _counts(t) == _counts(j) == (3, 0, 0)
    assert sorted(got["t"]) == sorted(got["j"]) == [
        f"{n}.SAFE.jpg" for n in "abc"]
    for name, (cols, rows, coeffs) in got["t"].items():
        jcols, jrows, jcoeffs = got["j"][name]
        assert (cols, rows, coeffs.shape) == (jcols, jrows, jcoeffs.shape)
        params, x = _jax_band(larger / name[:-4], args)
        kw = dict(strategy=params.autoscale, target_size=params.size)
        band_j = np.asarray(jf.grayscale_pipeline(x, **kw))
        band_t = tf.grayscale_pipeline(
            _t(x), strategy=tf.AutoscaleStrategy(params.autoscale.value),
            target_size=params.size).numpy()
        bound = _fast_bound(x, params.autoscale,
                            tf.BitDepth.U8)
        assert np.abs(band_t.astype(int) - band_j.astype(int)).max() <= bound
        agree = _block_agree(band_t, band_j)
        assert agree.mean() > 0.2
        d = np.abs(coeffs.astype(int) - jcoeffs.astype(int))[agree]
        print(f"{name}: blocks agreeing {agree.mean():.2f}, max|diff| "
              f"{d.max()}")
        assert d.max() <= 1


def test_exact_tiff_matches_jax_batch(larger, tmp_path, native_both):
    """The serial exact u16 adaptive cubic TIFF: each scene's band within
    tests/test_torch_exact.py's bound of the JAX serial batch's."""
    args = ["--polarization", "vh", "--bit-depth", "u16", "--autoscale",
            "adaptive", "--size", "64", "--resample-alg", "cubic"]
    t = _port("serial", larger, tmp_path / "t", _tparams(args))
    j = _jax("serial", larger, tmp_path / "j", _jparams(args))
    assert _counts(t) == _counts(j) == (3, 0, 0)
    params = _jparams(args)
    strategy = tf.AutoscaleStrategy(params.autoscale.value)
    for name in "abc":
        x, = _jax_rasters(larger / f"{name}.SAFE", params)
        a = TiffReader(tmp_path / "t" / f"{name}.SAFE.tiff").read(1)
        b = TiffReader(tmp_path / "j" / f"{name}.SAFE.tiff").read(1)
        assert a.dtype == b.dtype == np.uint16 and a.shape == b.shape
        _within(name, a, b, _exact_bound(x, strategy, 65535.0, False))


# ---------------------------------------------------------------------------
# threads: all device work on the calling thread
# ---------------------------------------------------------------------------
THREAD_ROUTES = {
    "fast clahe auto synrgb jpeg, per scene": (
        SAME_ROUTES["fast clahe auto synrgb jpeg"][1], 1),
    "fast clahe auto synrgb jpeg, buckets": (
        SAME_ROUTES["fast clahe auto synrgb jpeg"][1], 2),
    "exact vv tamed auto tiff": (
        ["--polarization", "vv", "--autoscale", "tamed", "--size", "32",
         "--target-crs", "auto"], 1),
}


@pytest.mark.parametrize("route", list(THREAD_ROUTES))
def test_device_work_stays_on_the_calling_thread(mixed, tmp_path, codec,
                                                 monkeypatch, route):
    """Every kernel wrapper (each calls its module's `use_kernel`) and every
    Tensor.to onto a device runs on the thread that called the driver; the
    loaders do run on other threads."""
    from sarpro_tpu_torch.ops import kernels, resample_kernel, warp_kernel

    calls, loads = [], []
    for mod in (kernels, resample_kernel, warp_kernel):
        real_use = mod.use_kernel

        def use(t, _real=real_use, _mod=mod.__name__):
            calls.append((_mod, threading.get_ident()))
            return _real(t)

        monkeypatch.setattr(mod, "use_kernel", use)
    real_to = torch.Tensor.to

    def to(self, *a, **k):
        if "device" in k or any(isinstance(v, (torch.device, str))
                                for v in a):
            calls.append(("Tensor.to", threading.get_ident()))
        return real_to(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "to", to)
    real_load = tbatch._load_scene

    def load(*a):
        loads.append(threading.get_ident())
        return real_load(*a)

    monkeypatch.setattr(tbatch, "_load_scene", load)
    args, device_batch = THREAD_ROUTES[route]
    report = tbatch.process_directory_pipelined(
        mixed, tmp_path / "o", _tparams(args), prefetch=2,
        fast="--fast" in args, device_batch=device_batch, device="cpu")
    assert _counts(report) == (4, 2, 1)
    me = threading.get_ident()
    assert loads and me not in loads
    mods = {m for m, _ in calls}
    assert {"Tensor.to", "sarpro_tpu_torch.ops.warp_kernel",
            "sarpro_tpu_torch.ops.kernels"} <= mods
    assert {tid for _, tid in calls} == {me}


# ---------------------------------------------------------------------------
# the O_DIRECT read and the pinned staging
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def band(tmp_path_factory):
    safe = fixtures.make_safe(tmp_path_factory.mktemp("directio"),
                              shape=(531, 640), seed=11)
    return sorted((safe / "measurement").glob("*.tiff"))[0]


@pytest.mark.parametrize("out", [(64, 64), (128, 96), (101, 77), (1, 33)])
def test_direct_read_bit_equal_to_buffered(band, codec, out):
    rows, cols = out
    reader = RasterReader(band)
    if not _o_direct_works(band):
        pytest.skip("the file system refuses O_DIRECT")
    want = traster.reduce_band(reader, 1, cols, rows)
    before = traster.ROUTES["direct_io"]
    token = traster.DIRECT_IO.set(True)
    try:
        got = traster.reduce_band(reader, 1, cols, rows)
    finally:
        traster.DIRECT_IO.reset(token)
    assert traster.ROUTES["direct_io"] == before + 1
    assert want.resample is None and got.resample is None
    assert torch.equal(got.data, want.data)


def test_failed_load_returns_its_staging(mixed, codec):
    """A load that fails after taking a staging buffer (the cut raster)
    gives it back; a good one keeps its buffers until released."""
    pool = tbatch._PinnedStaging(torch.device("cpu"),
                                 tbatch._staging_bytes(32), 2, 2)
    params = _tparams(["--polarization", "vv", "--size", "32"])
    cut = tbatch._load_scene(mixed / "t.SAFE", params, False,
                             torch.device("cpu"), True, pool)
    assert cut.error is not None and not pool._lent and len(pool._free) == 2
    good = tbatch._load_scene(mixed / "a.SAFE", params, False,
                              torch.device("cpu"), True, pool)
    assert good.error is None and len(pool._lent) == 1
    pool.release(good.scene)
    pool.reclaim(0)
    assert not pool._lent and len(pool._free) == 2


def test_pinned_staging_recycles_under_concurrent_loaders():
    """Loaders take buffers while the consumer releases and reclaims them:
    no buffer is lent twice at once, a band that finds none free gets
    pageable memory, and every buffer comes back. (On the CPU the buffers
    are pageable and free again as soon as they are released.)"""
    pool = tbatch._PinnedStaging(torch.device("cpu"), 4 * 8 * 8, 4, 6)
    lent, errors, scenes = set(), [], []
    lock = threading.Lock()

    def loader():
        for _ in range(300):
            t = pool.host((8, 8), torch.float32)
            if t._base is not None:  # a view of a staging buffer
                with lock:
                    if t.data_ptr() in lent:
                        errors.append("lent twice")
                    lent.add(t.data_ptr())
            scenes.append(tsafe.HostScene(None, [traster.HostBand(t)]))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=loader) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads) or scenes:
            while scenes:
                s = scenes.pop()
                with lock:
                    lent.discard(s.bands[0].data.data_ptr())
                pool.release(s)
            pool.reclaim(2)
    finally:
        for t in threads:
            t.join(timeout=10)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    pool.reclaim(0)
    assert len(pool._free) == pool._made <= 6 and not pool._lent
    big = pool.host((64, 64), torch.float32)  # larger than any buffer
    assert big.shape == (64, 64) and big._base is None
