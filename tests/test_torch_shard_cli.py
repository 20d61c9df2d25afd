"""`--shard-devices` through the port's product surface (the CLI,
`api.process_safe_to_path`, both batch drivers) on an 8-entry CPU mesh,
the cases of tests/test_shard_cli.py one for one; `_build_shard_mesh`
against the JAX package's over a grid of requests; a CUDA mesh without
CUDA.

Each case writes files byte-equal to the port's unsharded `--fast` run (one
conversion time fixed), and holds them against the JAX package's sharded
run within the bounds of tests/test_torch_gray.py: TIFF bands within
`_level_bound`, the synRGB band stages within theirs and the JPEG's blocks
from the port's own combine of its bands.
"""
import logging
import re

import jax
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
from sarpro_tpu_torch.core import fast_path as tfast  # noqa: E402
from sarpro_tpu_torch.core import fused as tf  # noqa: E402
from sarpro_tpu_torch.io import safe as tsafe  # noqa: E402
from sarpro_tpu_torch.io.tiffio import TiffReader  # noqa: E402
from sarpro_tpu_torch.parallel import batch as tbatch  # noqa: E402
from sarpro_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from test_torch_clahe import BAND_BOUND  # noqa: E402
from test_torch_exact import _FixedClock  # noqa: E402
from test_torch_gray import _compare_tiffs, _j, _level_bound  # noqa: E402


@pytest.fixture(autouse=True)
def host_devices(monkeypatch):
    monkeypatch.setattr(tmesh, "HOST_DEVICE_COUNT", 8)
    monkeypatch.setattr(tsafe, "datetime", _FixedClock)
    tsafe._parse_comprehensive_cached.cache_clear()
    yield
    tsafe._parse_comprehensive_cached.cache_clear()


@pytest.fixture(scope="module")
def safe_dir(tmp_path_factory):
    return fixtures.make_safe(tmp_path_factory.mktemp("shardsafe"))


@pytest.fixture
def codec():
    if not tnative.available():
        pytest.skip("g++ is not available to build the native codec")


def _argv(params_args):
    return ["-i", "x", "-o", "x"] + params_args


def _tparams(args):
    return tcli._params_from_args(tcli.build_parser().parse_args(_argv(args)))


def _jparams(args):
    return _params_from_args(build_parser().parse_args(_argv(args)))


def _files(out):
    """The output and its sidecars, by suffix."""
    return {p.name[len(out.stem):]: p.read_bytes()
            for p in out.parent.glob(out.stem + ".*")}


def _port_pair(safe, tmp_path, args, ext, shard):
    """The port's sharded and unsharded fast runs: files byte-equal."""
    outs = []
    for name, kw in (("shd", dict(shard_devices=shard)),
                     ("ref", dict(fast=True))):
        out = tmp_path / name / f"out.{ext}"
        out.parent.mkdir()
        tapi.process_safe_to_path(safe, out, _tparams(args), device="cpu",
                                  **kw)
        outs.append(out)
    assert _files(outs[0]) == _files(outs[1])
    return outs[0]


def _jax_sharded(safe, tmp_path, args, ext, shard):
    out = tmp_path / "j" / f"out.{ext}"
    out.parent.mkdir()
    japi.process_safe_to_path(safe, out, _jparams(args), shard_devices=shard)
    return out


def _dn_pair(safe):
    return [TiffReader(next((safe / "measurement").glob(f"*-{p}-*")))
            .read(1).astype(np.uint16) for p in ("vv", "vh")]


def _synrgb_bands_vs_jax(safe, args):
    """The synRGB JPEG route's band stages of both packages on the pair's
    DN within their bound."""
    p = _tparams(args)
    bound = 1 if p.autoscale.value == "tamed" else BAND_BOUND
    for dn, copol in zip(_dn_pair(safe), (True, False)):
        kw = dict(copol=copol, target_size=p.size, pad=p.pad)
        jb = np.asarray(jf.synrgb_band_stage(dn, strategy=_j(p.autoscale),
                                             **kw))
        tb = tf.synrgb_band_stage(torch.from_numpy(dn), strategy=p.autoscale,
                                  **kw).numpy()
        assert np.abs(jb.astype(int) - tb.astype(int)).max() <= bound


def _unstamped_json(out):
    return re.sub(rb'"conversion_timestamp": "[^"]*"', b'""',
                  out.with_suffix(".json").read_bytes())


def test_shard_multiband_tiff_fullres_exact(safe_dir, tmp_path):
    """Full-resolution multiband TIFF: the row blocks' reductions give the
    unsharded bands byte for byte."""
    args = ["--polarization", "multiband", "-f", "tiff", "--bit-depth",
            "u16", "--autoscale", "robust"]
    out = _port_pair(safe_dir, tmp_path, args, "tiff", 8)
    _compare_tiffs(safe_dir, args, out,
                   _jax_sharded(safe_dir, tmp_path, args, "tiff", 8))


def test_shard_single_band_sized_exact(safe_dir, tmp_path):
    """Resize + pad: the axis-0 resample split by output rows."""
    args = ["--polarization", "vv", "-f", "tiff", "--autoscale", "clahe",
            "--size", "64", "--pad"]
    out = _port_pair(safe_dir, tmp_path, args, "tiff", -1)
    _compare_tiffs(safe_dir, args, out,
                   _jax_sharded(safe_dir, tmp_path, args, "tiff", -1))


def test_shard_polar_op_exact(safe_dir, tmp_path):
    args = ["--polarization", "ratio", "-f", "tiff", "--bit-depth", "u16",
            "--autoscale", "standard"]
    out = _port_pair(safe_dir, tmp_path, args, "tiff", 4)
    _compare_tiffs(safe_dir, args, out,
                   _jax_sharded(safe_dir, tmp_path, args, "tiff", 4))


def test_shard_synrgb_jpeg_sized_identical_bytes(safe_dir, tmp_path, codec):
    """Sized synRGB JPEG: byte-identical files and sidecars."""
    args = ["--polarization", "multiband", "-f", "jpeg", "--autoscale",
            "tamed", "--size", "64", "--pad"]
    out = _port_pair(safe_dir, tmp_path, args, "jpg", 8)
    j = _jax_sharded(safe_dir, tmp_path, args, "jpg", 8)
    assert _unstamped_json(out) == _unstamped_json(j)
    assert out.with_suffix(".jgw").read_bytes() == \
        j.with_suffix(".jgw").read_bytes()
    _synrgb_bands_vs_jax(safe_dir, args)


def test_shard_synrgb_jpeg_fullres_pixels(safe_dir, tmp_path, codec):
    """Full-resolution synRGB JPEG: the sharded blocks are the unsharded
    ones, so the files are byte-identical (the JAX package's sharded route
    codes interleaved RGB on the host and differs from its own unsharded
    file in rounding)."""
    args = ["--polarization", "multiband", "-f", "jpeg", "--autoscale",
            "clahe"]
    out = _port_pair(safe_dir, tmp_path, args, "jpg", 8)
    j = _jax_sharded(safe_dir, tmp_path, args, "jpg", 8)
    assert _unstamped_json(out) == _unstamped_json(j)
    _synrgb_bands_vs_jax(safe_dir, args)


def test_shard_mesh_fallbacks(caplog):
    with caplog.at_level(logging.WARNING, logger="sarpro"):
        # odd row count has no even power-of-two split
        assert tfast._build_shard_mesh(8, 97, full_res=True,
                                       device="cpu") is None
    assert "no even power-of-two split" in caplog.text
    # resample / pad configs need no divisibility
    mesh = tfast._build_shard_mesh(8, 97, full_res=False, device="cpu")
    assert mesh is not None and mesh.shape["row"] == 8
    # more devices requested than available clamps to the mesh size
    mesh = tfast._build_shard_mesh(64, 96, full_res=True, device="cpu")
    assert mesh is not None and mesh.shape["row"] <= 8
    assert jfast._build_shard_mesh(64, 96, full_res=True).shape == \
        dict(mesh.shape)


def test_shard_cli_flag(safe_dir, tmp_path):
    outs = {}
    for name, flag in (("shd", ["--shard-devices", "8"]), ("ref",
                                                           ["--fast"])):
        outs[name] = tmp_path / name / "cli.tiff"
        outs[name].parent.mkdir()
        rc = tcli.run(["-i", str(safe_dir), "-o", str(outs[name]),
                       "--bit-depth", "u16", "--autoscale", "robust"] + flag,
                      device="cpu")
        assert rc == 0
    assert outs["shd"].read_bytes() == outs["ref"].read_bytes()
    args = ["--bit-depth", "u16", "--autoscale", "robust"]
    _compare_tiffs(safe_dir, args, outs["shd"],
                   _jax_sharded(safe_dir, tmp_path, args, "tiff", 8))


def test_shard_batch_directory(tmp_path):
    indir, outdir = tmp_path / "in", tmp_path / "out"
    indir.mkdir()
    fixtures.make_safe(indir, name="a.SAFE", seed=1)
    fixtures.make_safe(indir, name="b.SAFE", seed=2)
    args = ["--bit-depth", "u16", "--polarization", "vv", "--autoscale",
            "robust"]
    report = tapi.process_directory_to_path(indir, outdir, _tparams(args),
                                            shard_devices=8, device="cpu")
    assert (report.processed, report.errors) == (2, 0)
    ref = tmp_path / "ref.tiff"
    tapi.process_safe_to_path(indir / "a.SAFE", ref, _tparams(args),
                              fast=True, device="cpu")
    assert (outdir / "a.SAFE.tiff").read_bytes() == ref.read_bytes()
    jout = tmp_path / "jout"
    jrep = japi.process_directory_to_path(indir, jout, _jparams(args),
                                          shard_devices=8)
    assert (jrep.processed, jrep.errors) == (2, 0)
    _compare_tiffs(indir / "a.SAFE", args, outdir / "a.SAFE.tiff",
                   jout / "a.SAFE.tiff")


def test_shard_pipelined_batch_driver(tmp_path, codec, caplog):
    """Pipelined driver + shard_devices: fast mode, no device-batch
    buckets, and each scene's file equal to the unsharded fast route's."""
    indir, outdir = tmp_path / "in", tmp_path / "out"
    indir.mkdir()
    fixtures.make_safe(indir, name="a.SAFE", seed=3)
    fixtures.make_safe(indir, name="b.SAFE", seed=4)
    args = ["--polarization", "multiband", "-f", "jpeg", "--autoscale",
            "tamed", "--size", "64", "--pad"]
    with caplog.at_level(logging.INFO, logger="sarpro"):
        report = tbatch.process_directory_pipelined(
            indir, outdir, _tparams(args), prefetch=2, device_batch=4,
            shard_devices=8, device="cpu")
    assert (report.processed, report.errors) == (2, 0)
    assert "device-batch bucketing disabled" in caplog.text
    ref = tmp_path / "ref.jpg"
    tapi.process_safe_to_path(indir / "b.SAFE", ref, _tparams(args),
                              fast=True, device="cpu")
    assert (outdir / "b.SAFE.jpg").read_bytes() == ref.read_bytes()
    jrep = j_pipelined(indir, tmp_path / "jout", _jparams(args), prefetch=2,
                       device_batch=4, shard_devices=8)
    assert (jrep.processed, jrep.errors) == (2, 0)
    _synrgb_bands_vs_jax(indir / "b.SAFE", args)


def test_shard_with_warp_exact(safe_dir, tmp_path):
    """The warp's sampler row-sharded before the sharded device programs:
    the file equals the unsharded fast route's, georeferencing included."""
    args = ["--polarization", "vv", "-f", "tiff", "--autoscale", "robust",
            "--size", "64", "--target-crs", "auto", "--resample-alg",
            "cubic"]
    out = _port_pair(safe_dir, tmp_path, args, "tiff", 8)
    j = _jax_sharded(safe_dir, tmp_path, args, "tiff", 8)
    _compare_tiffs(safe_dir, args, out, j)
    assert TiffReader(out).geo_info().geotransform == \
        TiffReader(j).geo_info().geotransform


def test_batch_shard_with_warp_matches_unsharded(tmp_path):
    """The pipelined driver with a shard request and a target CRS: the
    sharded warp runs in the consumer's device half, and the file equals
    the unsharded fast route's. The JAX package's sharded and unsharded
    warps compile apart and differ by up to one level after the autoscale
    (tests/test_shard_cli.py), so against it the bound is `_level_bound`
    plus that level."""
    indir = tmp_path / "in"
    indir.mkdir()
    fixtures.make_safe(indir, name="w.SAFE", pols=("vv",), seed=9)
    args = ["--polarization", "vv", "-f", "tiff", "--autoscale", "robust",
            "--size", "64", "--target-crs", "EPSG:4326", "--resample-alg",
            "cubic"]
    outdir = tmp_path / "out"
    report = tbatch.process_directory_pipelined(
        indir, outdir, _tparams(args), prefetch=2, shard_devices=8,
        device="cpu")
    assert (report.processed, report.errors) == (1, 0)
    ref = tmp_path / "ref.tiff"
    tapi.process_safe_to_path(indir / "w.SAFE", ref, _tparams(args),
                              fast=True, device="cpu")
    assert (outdir / "w.SAFE.tiff").read_bytes() == ref.read_bytes()
    jrep = j_pipelined(indir, tmp_path / "jout", _jparams(args), prefetch=2,
                       shard_devices=8)
    assert (jrep.processed, jrep.errors) == (1, 0)
    a = TiffReader(outdir / "w.SAFE.tiff").read(1).astype(np.int64)
    b = TiffReader(tmp_path / "jout" / "w.SAFE.tiff").read(1).astype(
        np.int64)
    from test_torch_gray import _jax_band

    params, x = _jax_band(indir / "w.SAFE", args)
    bound = _level_bound(x, params.autoscale, params.bit_depth.to_bit_depth())
    assert np.abs(a - b).max() <= bound + 1


# ---------------------------------------------------------------------------
# _build_shard_mesh against the JAX package's, and the CUDA mesh
# ---------------------------------------------------------------------------
def _mesh_and_log(build, caplog):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="sarpro"):
        mesh = build()
    log = [(r.levelname, r.getMessage()) for r in caplog.records]
    return (None if mesh is None else dict(mesh.shape)), log


@pytest.mark.parametrize("devices", [1, 8])
@pytest.mark.parametrize("full_res", [True, False])
@pytest.mark.parametrize("rows", [96, 97, 100])
@pytest.mark.parametrize("shard", [-1, 0, 1, 2, 3, 8, 64])
def test_build_shard_mesh_matches_jax(monkeypatch, caplog, shard, rows,
                                      full_res, devices):
    """The mesh shape (or None) and the log lines of both packages'
    `_build_shard_mesh`, with 1 or 8 devices."""
    monkeypatch.setattr(tmesh, "HOST_DEVICE_COUNT", devices)
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: real(*a)[:devices])
    got = _mesh_and_log(lambda: tfast._build_shard_mesh(
        shard, rows, full_res, "cpu"), caplog)
    want = _mesh_and_log(lambda: jfast._build_shard_mesh(
        shard, rows, full_res), caplog)
    assert got == want


def test_cuda_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_mesh(4, shape=(1, 4), devices=["cuda:0"] * 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.available_devices("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfast._build_shard_mesh(2, 96, True, "cuda")
