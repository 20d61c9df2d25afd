"""The port's GUI server (sarpro_tpu_torch/gui) on the CPU, and its
utilities (utils/profiling).

  * one counterpart of each test of tests/test_gui.py, against
    `make_server("127.0.0.1", 0, device="cpu")`;
  * the JAX GUI's state model: the CLI command generator (the first word
    `sarpro-torch`), GuiState.apply / to_dict and preset bodies, over a
    parametrised set of states;
  * GUI jobs against the port's CLI (byte for byte, one conversion time
    fixed) and against the JAX GUI (one exact and one fast route, within
    the bounds of tests/test_torch_exact.py and tests/test_torch_gray.py;
    batch reports equal);
  * a sharded job reported as failed with the multi-GPU item's message,
    `make_server(device="cuda")` refused without CUDA, every kernel wrapper
    and device copy of a job on that job's worker thread, and two jobs in a
    row writing the same bytes;
  * `render_preview` against the JAX package's (pixels decoded by Pillow
    here), with the port's PNG writer read back by Pillow and by io/png;
  * utils/profiling: the JAX report format, a trace file, memory stats.

Both packages log under "sarpro", and each keeps one ring per process, so a
ring may hold the other package's events: the log tests filter by message.
"""
import io
import json
import logging
import re
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fixtures  # noqa: E402
from PIL import Image  # noqa: E402
from sarpro_tpu.core import fast_path as jfast  # noqa: E402
from sarpro_tpu.gui import server as jserver  # noqa: E402
from sarpro_tpu.gui import state as jstate  # noqa: E402
from sarpro_tpu.io.tiffio import TiffWriter as JTiffWriter  # noqa: E402
from sarpro_tpu.utils import profiling as jprof  # noqa: E402
from sarpro_tpu_torch import _native as tnative  # noqa: E402
from sarpro_tpu_torch import cli as tcli  # noqa: E402
from sarpro_tpu_torch.core import fused as tf  # noqa: E402
from sarpro_tpu_torch.gui import server as tserver  # noqa: E402
from sarpro_tpu_torch.gui import state as tstate  # noqa: E402
from sarpro_tpu_torch.gui.server import make_server  # noqa: E402
from sarpro_tpu_torch.gui.state import (  # noqa: E402
    GuiState,
    Worker,
    generate_cli_command,
)
from sarpro_tpu_torch.io import geodesy as tgeo  # noqa: E402
from sarpro_tpu_torch.io import png  # noqa: E402
from sarpro_tpu_torch.io import safe as tsafe  # noqa: E402
from sarpro_tpu_torch.io.tiffio import TiffReader  # noqa: E402
from sarpro_tpu_torch.io.writers import jpeg as tjpeg  # noqa: E402
from sarpro_tpu_torch.utils import profiling as tprof  # noqa: E402
from test_io import _build_tiff  # noqa: E402
from test_torch_exact import _FixedClock, _jax_rasters, _within  # noqa: E402
from test_torch_exact import _level_bound as _exact_bound  # noqa: E402
from test_torch_exact import native_both  # noqa: E402,F401
from test_torch_gray import _block_agree, _jax_band, _t  # noqa: E402
from test_torch_gray import _level_bound as _fast_bound  # noqa: E402


def _serve(srv):
    t = threading.Thread(target=srv.serve_forever, args=(0.05,),
                         daemon=True)
    t.start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture
def server():
    srv = make_server("127.0.0.1", 0, device="cpu")
    yield _serve(srv)
    srv.shutdown()
    srv.server_close()


@pytest.fixture
def jax_server():
    srv = jserver.make_server("127.0.0.1", 0)
    yield _serve(srv)
    srv.shutdown()
    srv.server_close()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return json.loads(r.read())


def _post(base, path, obj):
    req = urllib.request.Request(
        base + path, data=json.dumps(obj).encode(), method="POST"
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _wait(base, timeout: float = 120.0) -> dict:
    """Poll /api/state until the job has finished; its last_result."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        s = _get(base, "/api/state")
        if not s["running"] and s["last_result"]:
            return s["last_result"]
        time.sleep(0.05)
    raise AssertionError("the GUI job did not finish in time")


def _job(base, state: dict) -> dict:
    _post(base, "/api/state", state)
    assert _post(base, "/api/process", {})["started"]
    return _wait(base)


def _params(argv):
    """ProcessingParams of CLI arguments, as the GUI's state carries them."""
    return tcli._params_from_args(tcli.build_parser().parse_args(argv))


def _single(safe, out, argv) -> dict:
    return {"mode": "single", "input_path": str(safe),
            "output_path": str(out), "params": _params(argv).to_dict(),
            "fast": "--fast" in argv}


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
# the counterparts of tests/test_gui.py
# ---------------------------------------------------------------------------
def test_index_and_state(server):
    with urllib.request.urlopen(server + "/", timeout=10) as r:
        html = r.read().decode()
    assert "sarproUI" in html and "Autoscale" in html
    state = _get(server, "/api/state")
    assert state["params"]["autoscale"] == "Clahe"
    assert state["running"] is False


def test_state_update_and_cli_generator(server):
    _post(server, "/api/state", {
        "mode": "batch", "input_dir": "/d/in", "output_dir": "/d/out",
        "prefetch": 3,
        "params": {"format": "JPEG", "polarization": "multiband",
                   "autoscale": "tamed", "size": 2048, "pad": True,
                   "target_crs": "auto"},
    })
    cmd = _get(server, "/api/cli")["command"]
    assert cmd.startswith("sarpro-torch --input-dir /d/in")
    assert "-f jpeg" in cmd
    assert "--polarization multiband" in cmd
    assert "--autoscale tamed" in cmd
    assert "--size 2048" in cmd and "--pad" in cmd
    assert "--target-crs auto" in cmd and "--prefetch 3" in cmd


def test_preset_roundtrip(server, tmp_path):
    p = tmp_path / "x.sarpro"
    _post(server, "/api/state", {"params": {"autoscale": "robust",
                                            "size": 512}})
    _post(server, "/api/preset/save", {"path": str(p)})
    text = p.read_text()
    assert text.startswith("//")  # commented JSON header (models.rs:208-341)
    _post(server, "/api/state", {"params": {"autoscale": "clahe",
                                            "size": None}})
    loaded = _post(server, "/api/preset/load", {"path": str(p)})
    assert loaded["params"]["autoscale"] == "Robust"
    assert loaded["params"]["size"] == 512


def test_process_single_file(server, tmp_path):
    logging.getLogger("sarpro").setLevel(logging.INFO)
    base = fixtures.make_safe(tmp_path)
    out = tmp_path / "gui_out.tiff"
    result = _job(server, {
        "mode": "single", "input_path": str(base), "output_path": str(out),
        "params": {"autoscale": "standard", "size": 32},
    })
    assert result["ok"], result
    assert result["output"] == str(out) and result["elapsed_s"] >= 0
    assert TiffReader(out).read(1).shape == (24, 32)
    # logs flowed through the ring buffer
    logs = _get(server, "/api/logs")
    assert isinstance(logs, list) and logs
    assert all(set(e) == {"level", "timestamp", "message", "target"}
               for e in logs)
    assert any(e["message"].startswith("decimated read") for e in logs)


def test_cli_generator_defaults():
    cmd = generate_cli_command(GuiState())
    assert cmd.startswith("sarpro-torch -i")
    assert "--autoscale clahe" in cmd
    assert "--bit-depth" not in cmd  # u8 default omitted


def test_listdir_endpoint(server, tmp_path):
    base = fixtures.make_safe(tmp_path, name="S1A_PICK.SAFE", pols=("vv",))
    (tmp_path / "plain_dir").mkdir()
    (tmp_path / "out.tiff").write_bytes(b"x")
    (tmp_path / ".hidden").mkdir()
    d = _get(server, "/api/listdir?path=" + urllib.parse.quote(str(tmp_path)))
    assert d["path"] == str(tmp_path)
    assert d["parent"] == str(tmp_path.parent)
    names = {e["name"]: e for e in d["entries"]}
    assert names["S1A_PICK.SAFE"]["dir"] and names["S1A_PICK.SAFE"]["safe"]
    assert names["plain_dir"]["dir"] and not names["plain_dir"]["safe"]
    assert not names["out.tiff"]["dir"]
    assert ".hidden" not in names
    entry_names = [e["name"] for e in d["entries"]]
    assert entry_names.index("plain_dir") < entry_names.index("out.tiff")
    d2 = _get(server, "/api/listdir?path=" + urllib.parse.quote(str(base)))
    assert {"annotation", "measurement"} <= {e["name"] for e in d2["entries"]}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server, "/api/listdir?path="
             + urllib.parse.quote(str(tmp_path / "out.tiff")))
    assert ei.value.code == 400


def test_html_js_server_consistency():
    """Every element id the page script references exists in the markup,
    every onclick handler is defined, and every fetched /api route is
    handled by the port's server.py."""
    html = (Path(tserver.__file__).parent / "static" / "index.html").read_text()
    script = html.split("<script>")[1].split("</script>")[0]
    markup = html.split("<script>")[0]
    dom_ids = set(re.findall(r'id="([^"]+)"', markup))
    referenced = set(re.findall(r"\$\('([^']+)'\)", script))
    referenced |= set(re.findall(r"getElementById\('([^']+)'\)", script))
    assert not referenced - dom_ids
    handlers = {m.split("(")[0]
                for m in re.findall(r'onclick="([^"]+)"', markup)}
    defined = set(re.findall(r"(?:async\s+)?function\s+(\w+)", script))
    defined |= {"document"}
    assert not {h for h in handlers if h.split(".")[0] not in defined}
    server_src = Path(tserver.__file__).read_text()
    routes = set(re.findall(r"fetch\('(/api/[a-z-]+)", script))
    assert routes
    for route in routes:
        assert f'"{route}' in server_src, route


def test_forbidden_host_header_rejected(server):
    for path in ("/api/listdir", "/api/state"):
        req = urllib.request.Request(server + path,
                                     headers={"Host": "evil.example.com"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10)
        assert exc.value.code == 403
    assert "entries" in _get(server, "/api/listdir")


def test_fast_mode_toggle_and_cli_generation(server):
    s = _post(server, "/api/state", {"fast": True, "mode": "batch",
                                     "input_dir": "/tmp/in",
                                     "output_dir": "/tmp/out"})
    assert s["fast"] is True
    cmd = _get(server, "/api/cli")["command"]
    assert "--fast" in cmd and "--prefetch" in cmd


def _probes(events, tag):
    return [e["message"] for e in events if e["message"].startswith(tag)]


def test_log_cursor_protocol(server):
    """`/api/logs?since=N` returns only events past the cursor (the no-arg
    form stays a list)."""
    log = logging.getLogger("sarpro")
    log.setLevel(logging.INFO)
    log.info("torch-cursor-probe-1")
    d = _get(server, "/api/logs?since=0")
    assert set(d) == {"next", "events"}
    n1 = d["next"]
    assert n1 == len(d["events"]) >= 1
    assert _probes(d["events"], "torch-cursor-probe") == [
        "torch-cursor-probe-1"]
    d2 = _get(server, f"/api/logs?since={n1}")
    assert d2["next"] == n1 + len(d2["events"])
    assert _probes(d2["events"], "torch-cursor-probe") == []
    log.info("torch-cursor-probe-2")
    d3 = _get(server, f"/api/logs?since={d2['next']}")
    assert _probes(d3["events"], "torch-cursor-probe") == [
        "torch-cursor-probe-2"]
    assert d3["next"] == d2["next"] + len(d3["events"])


def test_listdir_recents(server, tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    _get(server, "/api/listdir?path=" + urllib.parse.quote(str(a)))
    d = _get(server, "/api/listdir?path=" + urllib.parse.quote(str(b)))
    assert d["recents"][0] == str(b)
    assert str(a) in d["recents"]


def test_preview_endpoint(server, tmp_path):
    """After a single-file run the GUI serves the output's preview (TIFF
    rendered to PNG by the port's writer); 404 before any run."""
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(server + "/api/preview", timeout=10)
    assert ei.value.code == 404
    base = fixtures.make_safe(tmp_path)
    out = tmp_path / "prev.tiff"
    result = _job(server, {
        "mode": "single", "input_path": str(base), "output_path": str(out),
        "params": {"autoscale": "standard", "size": 32, "bit_depth": "U16"},
    })
    assert result["ok"], result
    with urllib.request.urlopen(server + "/api/preview", timeout=10) as r:
        assert r.headers["Content-Type"] == "image/png"
        blob = r.read()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    im = Image.open(io.BytesIO(blob))
    assert im.size == (32, 24)  # 128x96 fixture scene at size 32
    ours, _ = png.decode(blob)
    assert np.array_equal(ours[..., 0], np.asarray(im))


def test_log_cursor_stale_after_restart_resends(server):
    logging.getLogger("sarpro").setLevel(logging.INFO)
    logging.getLogger("sarpro").info("torch-restart-probe")
    d = _get(server, "/api/logs?since=999999")
    assert d["next"] >= 1
    assert any(e["message"] == "torch-restart-probe" for e in d["events"])


def test_preview_corrupt_output_returns_415(server, tmp_path):
    base = fixtures.make_safe(tmp_path)
    out = tmp_path / "c.tiff"
    result = _job(server, {
        "mode": "single", "input_path": str(base), "output_path": str(out),
        "params": {"autoscale": "standard", "size": 32},
    })
    assert result["ok"]
    out.write_bytes(b"not a tiff at all")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(server + "/api/preview", timeout=10)
    assert ei.value.code == 415
    assert _get(server, "/api/state")["running"] is False  # still serving


def test_preview_decimation_content_exact(tmp_path):
    """render_preview's block-decimated read equals a straight
    [::step, ::step] subsample of the raster."""
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 65535, (5000, 3000)).astype(np.uint16)
    p = tmp_path / "big.tiff"
    JTiffWriter(p).write([arr])
    blob, ctype = tserver.render_preview(p)
    assert ctype == "image/png"
    im = Image.open(io.BytesIO(blob))
    assert im.size == (600, 1000)  # step = ceil(5000/1024) = 5
    sub = arr[::5, ::5].astype(np.float32)
    lo, hi = float(sub.min()), float(sub.max())
    expect = np.clip((sub - lo) / (hi - lo) * 255.0 + 0.5,
                     0, 255).astype(np.uint8)
    assert np.array_equal(np.asarray(im.convert("L")), expect)


def test_crs_validation_endpoint(server):
    d = _get(server, "/api/crs?value=none")
    assert d["ok"] is True and d["method"] == "none"
    d = _get(server, "/api/crs?value=auto")
    assert d["ok"] is True and "centroid" in d["name"]
    d = _get(server, "/api/crs?value=EPSG%3A32633")
    assert d["ok"] is True and "Transverse Mercator" in d["method"]
    assert d["backend"] == "native tables"
    d = _get(server, "/api/crs?value=EPSG%3A999999")
    assert d["ok"] is False and "not known" in d["reason"]
    d = _get(server, "/api/crs?value=garbage")
    assert d["ok"] is False


def test_crs_validation_endpoint_pipe_tier(server):
    import shutil

    if shutil.which("cs2cs") is None or shutil.which("projinfo") is None:
        pytest.skip("PROJ tools missing")
    d = _get(server, "/api/crs?value=EPSG%3A3375")
    assert d["ok"] is True and "cs2cs pipe" in d["backend"]
    assert "RSO" in d["name"]


def test_shard_devices_state_and_cli_generator(server):
    assert _get(server, "/api/state").get("shard_devices", 0) == 0
    _post(server, "/api/state", {"shard_devices": 8, "fast": True,
                                 "input_path": "/x.SAFE",
                                 "output_path": "/x.tiff"})
    assert "--shard-devices 8" in _get(server, "/api/cli")["command"]


def test_crs_validation_proj_string_no_registration(server):
    before = dict(tgeo._PROJ_STRING_CODES)
    d = _get(server, "/api/crs?value=" + urllib.parse.quote(
        "+proj=tmerc +lat_0=0 +lon_0=9 +k=0.9996 +datum=WGS84"))
    assert d["ok"] is True and "Transverse Mercator" in d["method"]
    assert "proj string" in d["backend"]
    d = _get(server, "/api/crs?value=" + urllib.parse.quote(
        "+proj=moll +lon_0=10 +datum=WGS84"))
    assert d["ok"] is True
    assert tgeo._PROJ_STRING_CODES == before


# ---------------------------------------------------------------------------
# the state model against the JAX GUI's
# ---------------------------------------------------------------------------
STATES = {
    "defaults": {},
    "batch multiband jpeg": {
        "mode": "batch", "input_dir": "/d/in", "output_dir": "/d/out",
        "prefetch": 3, "params": {"format": "JPEG",
                                  "polarization": "multiband",
                                  "autoscale": "tamed", "size": 2048,
                                  "pad": True, "target_crs": "auto"}},
    "batch serial": {"mode": "batch", "prefetch": 0},
    "u16 tiff": {"params": {"bit_depth": "U16", "autoscale": "adaptive"}},
    "resample cubic": {"params": {"resample_alg": "cubic", "size": 800}},
    "resample lanczos": {"params": {"resample_alg": "lanczos"}},
    "suppressed synrgb": {"params": {"format": "JPEG",
                                     "polarization": "Multiband",
                                     "synrgb_mode": "RgbRatio"}},
    "target crs": {"input_path": "/p/x.SAFE", "output_path": "/p/x.tif",
                   "params": {"target_crs": "EPSG:32633", "pad": True}},
    "fast": {"fast": True},
    "shard": {"shard_devices": 4, "fast": True},
    **{f"polarization {p}": {"params": {"polarization": p}}
       for p in ("vh", "hh", "hv", "sum", "n-diff", "log-ratio")},
    **{f"operation {op}": {"params": {"polarization": {"OP": op}}}
       for op in ("Sum", "Diff", "Ratio", "NDiff", "LogRatio")},
    **{f"format {f}": {"params": {"format": f}} for f in ("TIFF", "JPEG")},
}


def _both_states(d):
    t, j = GuiState(), jstate.GuiState()
    t.apply(d)
    j.apply(d)
    return t, j


@pytest.mark.parametrize("name", list(STATES))
def test_state_apply_and_cli_command_equal_jax(name):
    t, j = _both_states(STATES[name])
    assert t.to_dict() == j.to_dict()
    jcmd = jstate.generate_cli_command(j)
    assert jcmd.startswith("sarpro ")
    assert generate_cli_command(t) == "sarpro-torch " + jcmd[len("sarpro "):]


@pytest.mark.parametrize("name", ["defaults", "suppressed synrgb",
                                  "operation LogRatio", "target crs"])
def test_preset_bodies_equal_jax(name, tmp_path):
    t, j = _both_states(STATES[name])
    tstate.save_preset(t, tmp_path / "t.sarpro")
    jstate.save_preset(j, tmp_path / "j.sarpro")
    tl = (tmp_path / "t.sarpro").read_text().splitlines()
    jl = (tmp_path / "j.sarpro").read_text().splitlines()
    assert tl[:2] == jl[:2] and tl[2].startswith("// ")
    assert tl[3:] == jl[3:]  # below the header's timestamp line
    u = GuiState()
    tstate.load_preset(u, tmp_path / "j.sarpro")
    assert u.params == t.params


# ---------------------------------------------------------------------------
# jobs against the port's CLI and the JAX GUI
# ---------------------------------------------------------------------------
CLI_ROUTES = {
    "exact standard u16 tiff": ["--autoscale", "standard", "--bit-depth",
                                "u16", "--size", "32"],
    "exact clahe gray jpeg": ["-f", "jpeg", "--size", "40"],
    "fast clahe auto synrgb jpeg": [
        "-f", "jpeg", "--polarization", "multiband", "--autoscale", "clahe",
        "--size", "32", "--pad", "--target-crs", "auto", "--resample-alg",
        "cubic", "--fast"],
}
SIDECARS = ("", ".jgw", ".prj", ".json")


def _outputs(out: Path) -> dict:
    return {ext: out.with_suffix(ext).read_bytes() if ext else
            out.read_bytes() for ext in SIDECARS
            if (out.with_suffix(ext) if ext else out).exists()}


@pytest.fixture(scope="module")
def product(tmp_path_factory):
    return fixtures.make_safe(tmp_path_factory.mktemp("gui"), seed=11)


@pytest.mark.parametrize("route", list(CLI_ROUTES))
def test_job_writes_the_cli_bytes(server, product, tmp_path, codec,
                                  fixed_clock, route):
    argv = CLI_ROUTES[route]
    ext = "jpg" if "jpeg" in argv else "tiff"
    gui_out, cli_out = tmp_path / f"gui.{ext}", tmp_path / f"cli.{ext}"
    result = _job(server, _single(product, gui_out, argv))
    assert result["ok"], result
    assert tcli.run(["-i", str(product), "-o", str(cli_out)] + argv,
                    device="cpu") == 0
    got, want = _outputs(gui_out), _outputs(cli_out)
    assert set(got) == set(want) and "" in got
    assert (".json" in got) == (ext == "jpg")
    for k in want:
        assert got[k] == want[k], k


@pytest.fixture(scope="module")
def larger(tmp_path_factory):
    """A product large enough that most 8 x 8 blocks of a 128 output agree
    between the packages."""
    return fixtures.make_safe(tmp_path_factory.mktemp("larger"), seed=21,
                              shape=(300, 400))


def test_exact_tiff_job_matches_jax_gui(server, jax_server, larger,
                                        tmp_path, native_both):
    """The exact u16 adaptive cubic TIFF through both GUIs: bands within
    tests/test_torch_exact.py's bound."""
    argv = ["--polarization", "vh", "--bit-depth", "u16", "--autoscale",
            "adaptive", "--size", "64", "--resample-alg", "cubic"]
    t_out, j_out = tmp_path / "t.tiff", tmp_path / "j.tiff"
    assert _job(server, _single(larger, t_out, argv))["ok"]
    assert _job(jax_server, _single(larger, j_out, argv))["ok"]
    params = _params(["-i", str(larger), "-o", "x"] + argv)
    x, = _jax_rasters(larger, params)
    a, b = TiffReader(t_out).read(1), TiffReader(j_out).read(1)
    assert a.dtype == b.dtype == np.uint16 and a.shape == b.shape
    strategy = tf.AutoscaleStrategy(params.autoscale.value)
    _within("gui exact tiff", a, b, _exact_bound(x, strategy, 65535.0,
                                                 False))


def test_fast_gray_jpeg_job_matches_jax_gui(server, jax_server, larger,
                                            tmp_path, monkeypatch,
                                            native_both):
    """The fast ratio JPEG through both GUIs: coefficient blocks within 1
    wherever the bands' 8 x 8 blocks agree (tests/test_torch_gray.py's
    bound on the band)."""
    argv = ["-f", "jpeg", "--polarization", "ratio", "--autoscale",
            "standard", "--size", "128", "--fast"]
    got = {}

    def capture(side):
        def write(output, cols, rows, coeffs):
            got[side] = (cols, rows, np.asarray(coeffs))
            open(output, "wb").close()
        return write

    monkeypatch.setattr(tjpeg, "write_gray_jpeg_dct", capture("t"))
    monkeypatch.setattr(jfast, "write_gray_jpeg_dct", capture("j"))
    assert _job(server, _single(larger, tmp_path / "t.jpg", argv))["ok"]
    assert _job(jax_server, _single(larger, tmp_path / "j.jpg", argv))["ok"]
    (cols, rows, coeffs), (jcols, jrows, jcoeffs) = got["t"], got["j"]
    assert (cols, rows, coeffs.shape) == (jcols, jrows, jcoeffs.shape)
    args = [a for a in argv if a != "--fast"]
    params, x = _jax_band(larger, args)
    band_t = tf.grayscale_pipeline(
        _t(x), strategy=tf.AutoscaleStrategy(params.autoscale.value),
        target_size=params.size).numpy()
    from sarpro_tpu.core import fused as jf

    band_j = np.asarray(jf.grayscale_pipeline(
        x, strategy=params.autoscale, target_size=params.size))
    bound = _fast_bound(x, params.autoscale, tf.BitDepth.U8)
    assert np.abs(band_t.astype(int) - band_j.astype(int)).max() <= bound
    agree = _block_agree(band_t, band_j)
    assert agree.mean() > 0.2
    d = np.abs(coeffs.astype(int) - jcoeffs.astype(int))[agree]
    assert d.max() <= 1


@pytest.fixture(scope="module")
def batch_dir(tmp_path_factory):
    """A GRD product, an SLC product and a directory that is no SAFE."""
    d = tmp_path_factory.mktemp("gui_batch") / "in"
    d.mkdir()
    fixtures.make_safe(d, name="a.SAFE", seed=1)
    fixtures.make_safe(d, name="slc.SAFE", product_type="SLC", seed=4)
    (d / "junk").mkdir()
    return d


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batch_job_report_equals_jax_gui(server, jax_server, batch_dir,
                                         tmp_path, codec, prefetch):
    argv = ["-f", "jpeg", "--polarization", "multiband", "--autoscale",
            "tamed", "--size", "32", "--fast"]

    def state(out):
        return {"mode": "batch", "input_dir": str(batch_dir),
                "output_dir": str(out), "prefetch": prefetch, "fast": True,
                "params": _params(argv).to_dict()}

    t = _job(server, state(tmp_path / "t"))
    j = _job(jax_server, state(tmp_path / "j"))
    assert t["ok"] and j["ok"], (t, j)
    assert t["report"] == j["report"] == {"processed": 1, "skipped": 2,
                                          "errors": 0}
    assert (tmp_path / "t" / "a.SAFE.jpg").exists()
    s = _get(server, "/api/state")
    assert s["progress"] is None  # no job running


@pytest.mark.parametrize("mode", ["single", "batch"])
def test_sharded_job_fails_with_the_multi_gpu_item(server, product,
                                                   tmp_path, fixed_clock,
                                                   caplog, mode):
    """A sharded job (the name is the test's from before sharding was
    ported, when the job failed) runs: on the server's one device it logs
    the JAX package's one-device warning and writes the file of the CLI's
    --fast run, byte for byte."""
    argv = ["--autoscale", "standard", "--size", "32", "--fast"]
    cli_out = tmp_path / "cli.tiff"
    assert tcli.run(["-i", str(product), "-o", str(cli_out)] + argv,
                    device="cpu") == 0
    with caplog.at_level(logging.WARNING, logger="sarpro"):
        result = _job(server, {
            "mode": mode, "input_path": str(product),
            "output_path": str(tmp_path / "s.tiff"),
            "input_dir": str(product.parent),
            "output_dir": str(tmp_path / "o"), "shard_devices": 2,
            "fast": False, "params": _params(argv).to_dict()})
    assert result["ok"] is True, result
    assert "shard: 2 device(s) requested but only 1 available; running " \
        "unsharded" in caplog.text
    out = (tmp_path / "s.tiff" if mode == "single"
           else tmp_path / "o" / f"{product.name}.tiff")
    if mode == "batch":
        assert result["report"]["processed"] == 1
    assert out.read_bytes() == cli_out.read_bytes()


def test_cuda_server_is_refused_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_server("127.0.0.1", 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Worker()
    assert Worker("cpu").device == torch.device("cpu")


THREAD_JOBS = {
    "fast clahe auto synrgb jpeg": (
        "single", CLI_ROUTES["fast clahe auto synrgb jpeg"]),
    "exact u16 cubic tiff": (
        "single", ["--bit-depth", "u16", "--autoscale", "adaptive",
                   "--size", "32", "--resample-alg", "cubic"]),
    "pipelined tamed cubic jpeg": (
        "batch", ["-f", "jpeg", "--polarization", "multiband", "--autoscale",
                  "tamed", "--size", "32", "--pad", "--resample-alg",
                  "cubic", "--fast"]),
}


@pytest.mark.parametrize("name", list(THREAD_JOBS))
def test_device_work_runs_on_the_job_thread(server, product, batch_dir,
                                            tmp_path, codec, fixed_clock,
                                            monkeypatch, name):
    """Every kernel wrapper call (each calls its module's `use_kernel`) and
    every Tensor.to onto a device of a job runs on that job's worker
    thread; none on an HTTP handler thread or the caller's."""
    from sarpro_tpu_torch.ops import kernels, resample_kernel, warp_kernel

    calls = []
    for mod in (kernels, resample_kernel, warp_kernel):
        real_use = mod.use_kernel

        def use(t, _real=real_use, _mod=mod.__name__):
            calls.append((_mod, threading.current_thread()))
            return _real(t)

        monkeypatch.setattr(mod, "use_kernel", use)
    real_to = torch.Tensor.to

    def to(self, *a, **k):
        if "device" in k or any(isinstance(v, (torch.device, str))
                                for v in a):
            calls.append(("Tensor.to", threading.current_thread()))
        return real_to(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "to", to)
    mode, argv = THREAD_JOBS[name]
    ext = "jpg" if "jpeg" in argv else "tiff"
    jobs = {}
    for run in ("first", "second"):
        out = tmp_path / run
        out.mkdir()
        state = (_single(product, out / f"o.{ext}", argv) if mode == "single"
                 else {"mode": "batch", "input_dir": str(batch_dir),
                       "output_dir": str(out), "prefetch": 2,
                       "fast": "--fast" in argv,
                       "params": _params(argv).to_dict()})
        del calls[:]
        assert _job(server, state)["ok"]
        threads = {t for _, t in calls}
        assert len(threads) == 1, threads
        thread, = threads
        assert thread.name.startswith("sarpro-gui-job-")
        assert thread is not threading.current_thread()
        jobs[run] = (thread, {m for m, _ in calls},
                     {p.name: p.read_bytes() for p in sorted(out.iterdir())})
    assert "sarpro_tpu_torch.ops.kernels" in jobs["first"][1]
    assert "Tensor.to" in jobs["first"][1]
    # a new thread for each job, the same wrappers, the same bytes
    assert jobs["first"][0] is not jobs["second"][0]
    assert jobs["first"][1:] == jobs["second"][1:]


# ---------------------------------------------------------------------------
# the preview and the PNG writer
# ---------------------------------------------------------------------------
def _jax_tiff(path, arr):
    JTiffWriter(path).write([arr])


PREVIEWS = {
    "u8 strip": (np.uint8, (96, 128), False),
    "u16 strip": (np.uint16, (96, 128), False),
    "u8 tiled": (np.uint8, (150, 77), True),
    "u16 tiled": (np.uint16, (150, 77), True),
    "u16 one value": (np.uint16, (40, 30), False),
    "decimated 5000 x 3000": (np.uint16, (5000, 3000), False),
    "rows just past 1024": (np.uint16, (1025, 300), False),
    "cols just past 2048, tiled": (np.uint8, (90, 2049), True),
}


@pytest.mark.parametrize("name", list(PREVIEWS))
def test_preview_pixels_equal_jax(tmp_path, name):
    """The port's render_preview and the JAX package's decode (by Pillow)
    to equal pixels. The JAX function's Image.thumbnail keeps each of these
    images as it is: the sides just past a multiple of 1024 show that no
    resize follows the decimation."""
    dtype, shape, tiled = PREVIEWS[name]
    rng = np.random.default_rng(len(name))
    arr = rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)
    if name == "u16 one value":
        arr[:] = 777
    p = tmp_path / "x.tiff"
    if tiled:
        _build_tiff(p, arr, tiled=True, tile=(32, 48))
    else:
        _jax_tiff(p, arr)
    assert TiffReader(p).tiled is tiled
    t_blob, t_type = tserver.render_preview(p)
    j_blob, j_type = jserver.render_preview(p)
    assert t_type == j_type == "image/png"
    t_im, j_im = Image.open(io.BytesIO(t_blob)), Image.open(io.BytesIO(j_blob))
    assert t_im.mode == j_im.mode == "L"
    step = max(1, -(-max(shape) // 1024))
    assert t_im.size == j_im.size == (-(-shape[1] // step),
                                      -(-shape[0] // step))
    assert np.array_equal(np.asarray(t_im), np.asarray(j_im))
    ours, _ = png.decode(t_blob)
    assert np.array_equal(ours[..., 0], np.asarray(t_im))


def test_preview_serves_jpeg_as_is_and_refuses_other_suffixes(tmp_path):
    p = tmp_path / "x.jpg"
    p.write_bytes(b"\xff\xd8 anything \xff\xd9")
    assert tserver.render_preview(p) == (p.read_bytes(), "image/jpeg")
    with pytest.raises(ValueError, match="no preview"):
        tserver.render_preview(tmp_path / "x.png")


@pytest.mark.parametrize("shape", [(1, 1), (7, 300), (300, 7), (64, 64)])
def test_png_writer_reads_back_through_pillow_and_the_port(shape):
    rng = np.random.default_rng(sum(shape))
    u8 = rng.integers(0, 256, shape).astype(np.uint8)
    blob = png.encode_gray8(u8)
    im = Image.open(io.BytesIO(blob))
    assert im.mode == "L" and im.size == shape[::-1]
    assert np.array_equal(np.asarray(im), u8)
    ours, text = png.decode(blob)
    assert ours.dtype == np.uint8 and text == {}
    assert np.array_equal(ours[..., 0], u8)


# ---------------------------------------------------------------------------
# utils/profiling
# ---------------------------------------------------------------------------
def test_stage_timer_report_equals_jax():
    t, j = tprof.StageTimer(), jprof.StageTimer()
    for timer in (t, j):
        for name, secs, n in (("read", 1.25, 2), ("device stage", 0.0042, 7),
                              ("a stage with a name longer than thirty", 3e-5,
                               1), ("zero", 0.0, 3)):
            timer.totals[name] += secs
            timer.counts[name] += n
    assert t.report() == j.report()
    assert t.report().splitlines()[0].startswith("read ")


def test_stage_timer_times_cpu_values():
    timer = tprof.StageTimer()
    x = torch.arange(10.0)
    with timer.stage("sum", x):
        y = x.sum()
    assert timer.block("again", (y, [x], {"k": x})) == (y, [x], {"k": x})
    assert timer.counts == {"sum": 1, "again": 1}
    assert all(v >= 0 for v in timer.totals.values())
    assert "sum" in timer.report() and "again" in timer.report()


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(tmp_path, device="cpu"):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_device_memory_stats_and_trace_without_a_card():
    assert tprof.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert tprof.device_memory_stats() == {}
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            with tprof.trace("unused"):
                pass
