"""The port's whole slice on the CPU: the CLI on a synthetic dual-pol SAFE
against the JAX package's fused program on the same DN, and the sidecar
files against the JAX package's own file route.

The native entropy coder is not built in every test environment (the port
builds its own where g++ is present), so the coefficient blocks handed to
the port's JPEG writer are captured and compared; the encoder itself is
covered by tests/test_native.py and tests/test_torch_host_copies.py.
"""
import json
import logging
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fixtures  # noqa: E402
from sarpro_tpu import api as japi  # noqa: E402
from sarpro_tpu.cli import _params_from_args, build_parser  # noqa: E402
from sarpro_tpu.core import fused as jf  # noqa: E402
from sarpro_tpu.types import AutoscaleStrategy as JStrategy  # noqa: E402
from sarpro_tpu_torch import api as tapi  # noqa: E402
from sarpro_tpu_torch import cli as tcli  # noqa: E402
from sarpro_tpu_torch.core import fused as tf  # noqa: E402
from sarpro_tpu_torch.io.tiffio import TiffReader  # noqa: E402
from sarpro_tpu_torch.io.writers import jpeg as tjpeg  # noqa: E402
from sarpro_tpu_torch.types import AutoscaleStrategy  # noqa: E402

TAMED = AutoscaleStrategy.TAMED


def _j(strategy):
    """The JAX package's strategy (each package takes its own enums)."""
    return JStrategy(strategy.value)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    safe = fixtures.make_safe(tmp_path_factory.mktemp("slice"),
                              shape=(1200, 1600))
    dn = {p: TiffReader(next((safe / "measurement").glob(f"*-{p}-*"))).read(1)
          for p in ("vv", "vh")}
    return safe, dn["vv"].astype(np.uint16), dn["vh"].astype(np.uint16)


def _argv(safe, out, size, alg):
    argv = ["-i", str(safe), "-o", str(out), "-f", "jpeg", "--polarization",
            "multiband", "--autoscale", "tamed", "--size", str(size), "--pad",
            "--fast"]
    return argv + (["--resample-alg", alg] if alg else [])


@pytest.fixture
def captured(monkeypatch):
    calls = []

    def capture(output, cols, rows, coeffs):
        calls.append((output, cols, rows, coeffs))
        open(output, "wb").close()

    monkeypatch.setattr(tjpeg, "write_synrgb_jpeg_dct", capture)
    return calls


def _unstamped(out):
    """The JSON sidecar's bytes with the value of conversion_timestamp, the
    time each package's write stamps, blanked."""
    return re.sub(rb'"conversion_timestamp": "[^"]*"', b'""',
                  out.with_suffix(".json").read_bytes())


def _block_agree(rgb_a, rgb_b):
    """(bh, bw) mask of the 8x8 blocks whose pixels agree in every channel
    (edge-replicated like the encoder's partial blocks)."""
    same = np.all(rgb_a == rgb_b, axis=-1)
    h, w = same.shape
    same = np.pad(same, ((0, -h % 8), (0, -w % 8)), mode="edge")
    return same.reshape(same.shape[0] // 8, 8, -1, 8).all(axis=(1, 3))


@pytest.mark.parametrize("size,alg", [(512, "cubic"), (400, None)])
def test_cli_slice_matches_jax_program(scene, captured, tmp_path, size, alg):
    safe, vv, vh = scene
    assert tcli.run(_argv(safe, tmp_path / "out.jpg", size, alg),
                    device="cpu") == 0
    (_, cols, rows, coeffs), = captured
    assert (cols, rows) == (size, size)
    assert coeffs.shape == (3, size // 8, size // 8, 8, 8)

    kw = dict(target_size=size, pad=True, resample_alg=alg)
    jkw = dict(strategy=_j(TAMED), **kw)
    kw["strategy"] = TAMED
    jb = [np.asarray(jf.synrgb_band_stage(d, copol=c, **jkw))
          for d, c in ((vv, True), (vh, False))]
    tb = [tf.synrgb_band_stage(torch.from_numpy(d), copol=c, **kw)
          for d, c in ((vv, True), (vh, False))]
    for j, t in zip(jb, tb):
        d = np.abs(j.astype(int) - t.numpy().astype(int))
        print(f"size {size} {alg}: band share differing {(d > 0).mean():.2e}")
        assert d.max() <= 1
    jhist = np.bincount(np.concatenate([b.ravel() for b in jb]),
                        minlength=256).astype(np.int32)
    thist = tf.histogram((tb[0].reshape(-1), tb[1].reshape(-1)), 256)
    total = 2 * size * size
    assert int(tf._suppressed_floor(thist, total)) == float(
        jf._suppressed_floor(jnp.asarray(jhist), total))

    j_rgb = np.asarray(jf.synrgb_pipeline(vv, vh, channel_order="rgb", **jkw))
    j_dct = np.asarray(jf.synrgb_pipeline(vv, vh, channel_order="dct", **jkw))
    t_rgb = tf.synrgb_pipeline(torch.from_numpy(vv), torch.from_numpy(vh),
                               channel_order="rgb", **kw).numpy()
    both = (jb[0] == tb[0].numpy()) & (jb[1] == tb[1].numpy())
    np.testing.assert_array_equal(t_rgb[both], j_rgb[both])
    agree = _block_agree(t_rgb, j_rgb)
    assert agree.mean() > 0.9
    d = np.abs(coeffs.astype(int) - j_dct.astype(int))
    assert d[:, agree].max() <= 1
    # the CLI handed the writer exactly what the stage API computes
    np.testing.assert_array_equal(
        coeffs, tf.synrgb_combine_stage(tb[0], tb[1], TAMED, None,
                                        "dct").numpy())


def test_sidecars_match_jax_route(scene, captured, tmp_path):
    safe = scene[0]
    t_out, j_out = tmp_path / "t" / "out.jpg", tmp_path / "j" / "out.jpg"
    t_out.parent.mkdir()
    j_out.parent.mkdir()
    argv = _argv(safe, j_out, 512, "cubic")
    japi.process_safe_to_path(safe, j_out,
                              _params_from_args(build_parser().parse_args(argv)),
                              fast=True)
    assert tcli.run(_argv(safe, t_out, 512, "cubic"), device="cpu") == 0
    for ext in (".jgw", ".prj"):
        assert t_out.with_suffix(ext).read_bytes() == \
            j_out.with_suffix(ext).read_bytes()
    t_meta = json.loads(t_out.with_suffix(".json").read_text())
    j_meta = json.loads(j_out.with_suffix(".json").read_text())
    assert t_meta["geotransform"] == j_meta["geotransform"]
    # every item but the time of the write, which each package stamps
    assert t_meta.pop("conversion_timestamp") and j_meta.pop(
        "conversion_timestamp")
    assert t_meta == j_meta
    assert _unstamped(t_out) == _unstamped(j_out)


CLAHE = AutoscaleStrategy.CLAHE
# the CLAHE band's bound against the JAX package from the DN: one CLAHE bin
# of window shift plus rounding (tests/test_torch_clahe.py); Tamed's is 1
BAND_BOUND = {CLAHE: 4, TAMED: 1}


def _compare_bands_and_combine(jb, tb, strategy, size, coeffs):
    """Bands within the strategy's bound, the water floor exact, rgb equal
    wherever both bands agree, the CLI's DCT blocks within 1 of the JAX
    program's in agreeing blocks and equal to the stage API's."""
    for j, t in zip(jb, tb):
        d = np.abs(j.astype(int) - t.numpy().astype(int))
        print(f"{strategy.value} {size}: band max|diff| {d.max()}, share "
              f"differing {(d > 0).mean():.2e}")
        assert d.max() <= BAND_BOUND[strategy]
    jhist = np.bincount(np.concatenate([b.ravel() for b in jb]),
                        minlength=256).astype(np.int32)
    thist = tf.histogram((tb[0].reshape(-1), tb[1].reshape(-1)), 256)
    total = 2 * size * size
    assert int(tf._suppressed_floor(thist, total)) == float(
        jf._suppressed_floor(jnp.asarray(jhist), total))
    j_rgb = np.asarray(jf.synrgb_combine_stage(jb[0], jb[1], _j(strategy),
                                               None, "rgb"))
    j_dct = np.asarray(jf.synrgb_combine_stage(jb[0], jb[1], _j(strategy),
                                               None, "dct"))
    t_rgb = tf.synrgb_combine_stage(tb[0], tb[1], strategy, None,
                                    "rgb").numpy()
    both = (jb[0] == tb[0].numpy()) & (jb[1] == tb[1].numpy())
    np.testing.assert_array_equal(t_rgb[both], j_rgb[both])
    agree = _block_agree(t_rgb, j_rgb)
    print(f"{strategy.value} {size}: blocks agreeing {agree.mean():.3f}")
    assert agree.mean() > 0.2  # enough blocks to compare
    d = np.abs(coeffs.astype(int) - j_dct.astype(int))
    assert d[:, agree].max() <= 1
    np.testing.assert_array_equal(
        coeffs, tf.synrgb_combine_stage(tb[0], tb[1], strategy, None,
                                        "dct").numpy())


def _warp_argv(safe, out, strategy, alg):
    argv = ["-i", str(safe), "-o", str(out), "-f", "jpeg", "--polarization",
            "multiband", "--autoscale", strategy, "--size", "512", "--pad",
            "--target-crs", "auto", "--fast"]
    return argv + (["--resample-alg", alg] if alg else [])


@pytest.mark.parametrize("strategy,alg", [
    ("clahe", "cubic"), ("clahe", None), ("tamed", "cubic")])
def test_cli_warp_path_matches_jax_route(scene, captured, tmp_path,
                                         strategy, alg):
    """The CLI with auto-UTM warp and pad, against the JAX package's file
    route and its band programs on the JAX reader's warped bands."""
    from sarpro_tpu.io.safe import SafeReader
    from sarpro_tpu.io.safe import TargetCrsArg as JTargetCrsArg
    from sarpro_tpu_torch.io.safe import TargetCrsArg, open_dual_pol

    safe = scene[0]
    t_out, j_out = tmp_path / "t" / "out.jpg", tmp_path / "j" / "out.jpg"
    t_out.parent.mkdir()
    j_out.parent.mkdir()
    assert tcli.run(_warp_argv(safe, t_out, strategy, alg), device="cpu") == 0
    (_, cols, rows, coeffs), = captured
    assert (cols, rows) == (512, 512)
    japi.process_safe_to_path(
        safe, j_out, _params(_warp_argv(safe, j_out, strategy, alg)),
        fast=True)
    for ext in (".jgw", ".prj"):
        assert t_out.with_suffix(ext).read_bytes() == \
            j_out.with_suffix(ext).read_bytes(), ext
    assert _unstamped(t_out) == _unstamped(j_out)
    assert "UTM zone 32N" in t_out.with_suffix(".prj").read_text()

    ref = SafeReader.open_with_options(safe, "all_pairs", JTargetCrsArg.AUTO,
                                       alg, 512)
    port = open_dual_pol(safe, "cpu", 512, target_crs=TargetCrsArg.AUTO,
                         resample_alg=alg)
    s = AutoscaleStrategy(strategy)
    kw = dict(strategy=s, target_size=512, pad=True, resample_alg=None)
    jb = [np.asarray(jf.synrgb_band_stage(d, copol=c, **{**kw,
                                                          "strategy": _j(s)}))
          for d, c in ((ref._vv, True), (ref._vh, False))]
    tb = [tf.synrgb_band_stage(d, copol=c, **kw)
          for d, c in ((port.band1, True), (port.band2, False))]
    _compare_bands_and_combine(jb, tb, s, 512, coeffs)


def test_cli_clahe_no_warp_matches_jax_program(scene, captured, tmp_path):
    safe, vv, vh = scene
    argv = _argv(safe, tmp_path / "out.jpg", 512, "cubic")
    argv[argv.index("tamed")] = "clahe"
    assert tcli.run(argv, device="cpu") == 0
    (_, cols, rows, coeffs), = captured
    assert (cols, rows) == (512, 512)
    kw = dict(strategy=CLAHE, target_size=512, pad=True, resample_alg="cubic")
    jb = [np.asarray(jf.synrgb_band_stage(d, copol=c,
                                          **{**kw, "strategy": _j(CLAHE)}))
          for d, c in ((vv, True), (vh, False))]
    tb = [tf.synrgb_band_stage(torch.from_numpy(d), copol=c, **kw)
          for d, c in ((vv, True), (vh, False))]
    _compare_bands_and_combine(jb, tb, CLAHE, 512, coeffs)


def _params(argv):
    return _params_from_args(build_parser().parse_args(argv))


def _tparams(argv):
    """The port's own params from the port's parser."""
    return tcli._params_from_args(tcli.build_parser().parse_args(argv))


@pytest.mark.parametrize("extra,kwargs", [
    (["-f", "tiff", "--polarization", "vv"],
     {"fast": True, "shard_devices": 2}),
    (["-f", "jpeg", "--polarization", "multiband"],
     {"fast": False, "shard_devices": 2}),
    (["-f", "jpeg", "--polarization", "multiband"],
     {"fast": True, "shard_devices": 2}),
])
def test_unported_routes_raise(scene, tmp_path, monkeypatch, caplog, extra,
                               kwargs):
    """A shard request, in either mode (the name is the test's from before
    sharding was ported, when these routes raised): on the one CPU device
    it logs the JAX package's one-device warning and writes the --fast
    route's file byte for byte, exact mode included (a shard request
    implies fast mode)."""
    from sarpro_tpu_torch.io import safe as tsafe
    from test_torch_exact import _FixedClock

    monkeypatch.setattr(tsafe, "datetime", _FixedClock)
    tsafe._parse_comprehensive_cached.cache_clear()
    params = _tparams(["--autoscale", "tamed", "--size", "64"] + extra)
    ext = params.format.extension
    got, want = tmp_path / f"shd.{ext}", tmp_path / f"ref.{ext}"
    with caplog.at_level(logging.WARNING, logger="sarpro"):
        tapi.process_safe_to_path(scene[0], got, params, device="cpu",
                                  **kwargs)
    assert "shard: 2 device(s) requested but only 1 available; running " \
        "unsharded" in caplog.text
    tapi.process_safe_to_path(scene[0], want, params, fast=True,
                              device="cpu")
    tsafe._parse_comprehensive_cached.cache_clear()
    for suffix in ((".jgw", ".prj", ".json") if ext == "jpg" else ()):
        assert got.with_suffix(suffix).read_bytes() == \
            want.with_suffix(suffix).read_bytes()
    assert got.read_bytes() == want.read_bytes()


# full-resolution routes above BIG_SCENE_PIXELS: (CLI arguments, --fast);
# the size is the CLI's default, the original
BIG_ROUTES = {
    "exact vv tamed tiff": (["-f", "tiff", "--polarization", "vv",
                             "--autoscale", "tamed"], False),
    "fast vv tamed tiff": (["-f", "tiff", "--polarization", "vv",
                            "--autoscale", "tamed"], True),
    "fast vh u16 adaptive tiff": (["-f", "tiff", "--polarization", "vh",
                                   "--bit-depth", "u16", "--autoscale",
                                   "adaptive"], True),
    "fast vv auto-UTM robust tiff": (["-f", "tiff", "--polarization", "vv",
                                      "--autoscale", "robust",
                                      "--target-crs", "auto"], True),
    "exact multiband clahe jpeg": (["-f", "jpeg", "--polarization",
                                    "multiband", "--autoscale", "clahe"],
                                   False),
}


@pytest.fixture
def big_scene(monkeypatch):
    """BIG_SCENE_PIXELS lowered in both packages below the fixture's
    1200 x 1600 and its 1604 x 1142 auto-UTM band, the port's chunks cut to
    256 rows (five chunks, a ragged tail); returns the port's streamed
    calls."""
    from sarpro_tpu.core import streamed as jstreamed
    from sarpro_tpu_torch.core import streamed as tstreamed

    for mod in (jstreamed, tstreamed):
        monkeypatch.setattr(mod, "BIG_SCENE_PIXELS", 10**6)
    monkeypatch.setattr(tstreamed, "CHUNK_ROWS", 256)
    calls = []
    for name in ("grayscale_streamed", "synrgb_streamed"):
        def spy(*a, _f=getattr(tstreamed, name), _n=name, **kw):
            calls.append(_n)
            return _f(*a, **kw)
        monkeypatch.setattr(tstreamed, name, spy)
    return calls


@pytest.mark.parametrize("route", list(BIG_ROUTES))
def test_big_scene_routes_match_jax(scene, captured, big_scene, tmp_path,
                                    route):
    """A full-resolution scene above BIG_SCENE_PIXELS runs the streamed
    passes in both modes (exact mode hands it to the fast path, as the JAX
    package does, sarpro_tpu/api.py:358-376): the output equals the port's
    fused program on the port's band bit for bit, and the JAX package's
    route within the bounds of the fused path."""
    from test_torch_gray import _compare_tiffs

    from sarpro_tpu_torch.io import safe as tsafe

    safe, vv, vh = scene
    args, fast = BIG_ROUTES[route]
    t_out = tmp_path / "t" / ("out.jpg" if "jpeg" in route else "out.tiff")
    t_out.parent.mkdir()
    argv = ["-i", str(safe), "-o", str(t_out)] + args
    tapi.process_safe_to_path(safe, t_out, _tparams(argv), fast=fast,
                              device="cpu")
    assert big_scene == (["synrgb_streamed"] if "jpeg" in route
                         else ["grayscale_streamed"])
    params = _tparams(argv)
    if "jpeg" in route:
        (_, cols, rows, coeffs), = captured
        assert (cols, rows) == (1600, 1200)
        assert t_out.with_suffix(".json").exists()
        _compare_big_synrgb(vv, vh, params.autoscale, coeffs)
        return
    j_out = tmp_path / "j" / "out.tiff"
    j_out.parent.mkdir()
    japi.process_safe_to_path(safe, j_out, _params(argv[:3] + [str(j_out)]
                                                   + args), fast=fast)
    _compare_tiffs(safe, args, t_out, j_out)
    _, band = tsafe.open_band(
        safe, params.polarization.kind, "cpu",
        target_crs=tsafe.TargetCrsArg.AUTO if params.target_crs else None)
    want = tf.grayscale_pipeline(band, params.autoscale,
                                 params.bit_depth.to_bit_depth(),
                                 target_size=None)
    got = TiffReader(t_out).read(1)
    assert got.shape == tuple(want.shape) == tuple(band.shape)
    np.testing.assert_array_equal(got, want.numpy())


def _compare_big_synrgb(vv, vh, strategy, coeffs):
    """The coefficient blocks the CLI handed the writer: the port's fused
    program's at original size bit for bit; against the JAX package's
    streamed path, the bands within their bound, the floor exact, the rgb
    equal where both bands agree and the blocks within 1 where it agrees
    on the whole block."""
    from sarpro_tpu.core import streamed as js

    t = [torch.from_numpy(d) for d in (vv, vh)]
    np.testing.assert_array_equal(
        coeffs, tf.synrgb_pipeline(*t, strategy=strategy, target_size=None,
                                   channel_order="dct").numpy())
    jb = [np.asarray(jf.synrgb_band_stage(d, copol=c, strategy=_j(strategy),
                                          target_size=None, pad=False))
          for d, c in ((vv, True), (vh, False))]
    tb = [tf.synrgb_band_stage(d, copol=c, strategy=strategy,
                               target_size=None, pad=False).numpy()
          for d, c in zip(t, (True, False))]
    for j, b in zip(jb, tb):
        assert np.abs(j.astype(int) - b.astype(int)).max() <= \
            BAND_BOUND[strategy]
    floors = [tstreamed_floor(b) for b in (jb, tb)]
    assert floors[0] == floors[1] < 40  # the JAX in-graph tables differ at 40
    j_rgb, j_dct = (np.asarray(js.synrgb_streamed(vv, vh, _j(strategy),
                                                  layout=lay))
                    for lay in ("rgb", "dct"))
    t_rgb = tf.synrgb_pipeline(*t, strategy=strategy, target_size=None,
                               channel_order="rgb").numpy()
    both = (jb[0] == tb[0]) & (jb[1] == tb[1])
    np.testing.assert_array_equal(t_rgb[both], j_rgb[both])
    agree = _block_agree(t_rgb, j_rgb)
    assert agree.mean() > 0.2
    assert np.abs(coeffs.astype(int) - j_dct.astype(int))[:, agree].max() <= 1


def tstreamed_floor(bands):
    """The streamed path's host water floor of two u8 bands."""
    from sarpro_tpu_torch.core import streamed

    hist = np.bincount(np.concatenate([b.ravel() for b in bands]),
                       minlength=256)
    return streamed._suppressed_floor_host(hist, 2 * bands[0].size)


def test_batch_mode_raises(scene, tmp_path, capsys):
    """Batch mode, once refused, now runs: the CLI prints the three
    counters for a directory of one product and one that is no SAFE, and
    names a missing --output-dir."""
    indir = tmp_path / "in"
    indir.mkdir()
    (indir / scene[0].name).symlink_to(scene[0], target_is_directory=True)
    (indir / "junk").mkdir()
    out = tmp_path / "out"
    assert tcli.run(["--input-dir", str(indir), "--output-dir", str(out),
                     "--fast", "--polarization", "vv", "--size", "64"],
                    device="cpu") == 0
    assert capsys.readouterr().out.splitlines()[-3:] == [
        "Processed: 1", "Skipped: 1", "Errors: 0"]
    assert (out / f"{scene[0].name}.tiff").exists()
    assert tcli.run(["--input-dir", str(indir)], device="cpu") == 1
    assert "--output-dir" in capsys.readouterr().err


def test_cuda_device_needs_cuda(scene, tmp_path):
    """Fast mode, exact mode and the in-memory and typed API: no CPU route
    runs when CUDA is asked for and absent."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sarpro_tpu_torch.types import (
        BitDepth,
        OutputFormat,
        Polarization,
        PolarizationOperation,
    )

    params = _tparams(["-f", "jpeg", "--polarization", "multiband",
                       "--autoscale", "tamed", "--size", "64"])
    vv = Polarization.from_cli("vv")
    for call in (
            lambda: tapi.process_safe_to_path(scene[0], tmp_path / "o.jpg",
                                              params, fast=True),
            lambda: tapi.process_safe_to_path(scene[0], tmp_path / "o.jpg",
                                              params),
            lambda: tcli.run(["-i", str(scene[0]), "-o",
                              str(tmp_path / "o.tiff")]),
            lambda: tapi.process_safe_to_buffer(scene[0], vv, TAMED,
                                                BitDepth.U8, 64),
            lambda: tapi.process_safe_to_buffer_with_mode(
                scene[0], vv, TAMED, BitDepth.U8, 64, False,
                OutputFormat.JPEG),
            lambda: tapi.process_safe_with_options(
                scene[0], tmp_path / "o.tiff", OutputFormat.TIFF,
                BitDepth.U8, vv, TAMED, 64),
            lambda: tapi.save_image(np.ones((8, 8), np.float32),
                                    tmp_path / "o.tiff", OutputFormat.TIFF,
                                    BitDepth.U8),
            lambda: tapi.save_multiband_image(
                np.ones((8, 8), np.float32), np.ones((8, 8), np.float32),
                tmp_path / "o.jpg", OutputFormat.JPEG, BitDepth.U8),
            lambda: tapi.load_polarization(scene[0], vv),
            lambda: tapi.load_operation(scene[0],
                                        PolarizationOperation.RATIO)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not (tmp_path / "o.jpg").exists()
    assert not (tmp_path / "o.tiff").exists()


def test_writer_needs_native_codec(monkeypatch, tmp_path):
    monkeypatch.setattr(tjpeg._native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native JPEG encoder"):
        tjpeg.write_synrgb_jpeg_dct(tmp_path / "o.jpg", 8, 8,
                                    np.zeros((3, 1, 1, 8, 8), np.int16))
    # exact mode's pixel writers fall back to no other encoder either
    for write, arr in ((tjpeg.write_gray_jpeg, np.zeros((8, 8), np.uint8)),
                       (tjpeg.write_rgb_jpeg, np.zeros((8, 8, 3), np.uint8))):
        with pytest.raises(RuntimeError, match="native JPEG encoder"):
            write(tmp_path / "o.jpg", 8, 8, arr)
    assert not (tmp_path / "o.jpg").exists()
