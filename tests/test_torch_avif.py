"""The port's AVIF reader (io/avif.py, _native/av1dec.cpp) against the JAX
package's RasterReader, which opens the same files through Pillow 12.1,
libavif 1.3.0, dav1d 1.5.1 and libyuv, on the CPU: every band bit-equal
(dtype included), equal size, bands, geotransform, EPSG and
gdal_metadata(), and RasterError where the JAX reader raises it. No
tolerance anywhere: AV1 decoding and libyuv's conversion are integer
arithmetic.

Inputs are the committed files of tests/data/avif (chip_smoke.py's avif
phase decodes them on the card), which Pillow writes with aom 3.12.1 from
seeded numpy arrays (`fixture_files`, re-encoded here and held equal byte
for byte): speeds 6, 8 and 10 at qualities 10, 50, 90 and 100; sizes of
1 x 1, 7 x 5, 130 x 67 and 257 x 129 (odd sizes, and sizes that cross a 128
superblock); 2 x 2 tiles; each intra tool switched off alone and all of
them at once; ICC, EXIF and XMP; the limited range, all saved with aom's
loop filter off (`loopfilter-control 0`). Then the in-loop filters
(deblocking, CDEF, loop restoration) as aom writes them: Pillow's defaults
at speeds 6, 8 and 10; speeds 0, 2 and 4; `enable-cdef 1` at speeds 4 and
6; sharpness 3 and 7; delta-LF; 128 x 128 superblocks; 2 x 2 tiles; sizes
of 1 x 1, 7 x 5 and 257 x 129. Then the other sample layouts and alpha:
4:4:4, 4:2:2 and 4:0:0 with the filters off and on, RGBA of three
layouts, "LA", palette blocks. Beside them: the `colr` matrix and range
patched to each value on every layout, RGB and RGBA, the alpha item's
properties, references and data edited, bit flips of a file with every
kind of item, of one with all three filters on and of one with alpha,
files cut short, and the files the port refuses by name
(tests/test_torch_legacy_rasters.py holds those: aom's 4:0:0 frame with a
grain model it estimates; 10- and 12-bit samples are
tests/test_torch_avif_depth.py's, grid items and image sequences
tests/test_torch_avif_container.py's, frames scaled to their `ispe` and the
matrices libavif converts itself tests/test_torch_avif_scale.py's). The
tables of av1dec.cpp are held to the read-only data of Pillow's libavif."""
import hashlib
import io
import re
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu_torch._native import av1_tables  # noqa: E402
from sarpro_tpu_torch.errors import RasterError  # noqa: E402
from sarpro_tpu_torch.io import avif  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from test_torch_decoders import (  # noqa: E402
    RESAMPLE_TOL,
    _both_refuse,
    _equal_to_jax,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

AVIF_DIR = chip_smoke.AVIF_DIR
LF0 = {"loopfilter-control": "0"}
# each intra tool switched off alone (aom's codec-specific options)
TOOLS_OFF = {
    "tx64": {"enable-tx64": "0"},
    "dct_only": {"use-intra-dct-only": "1"},
    "smooth": {"enable-smooth-intra": "0"},
    "paeth": {"enable-paeth-intra": "0"},
    "cfl": {"enable-cfl-intra": "0"},
    "filter_intra": {"enable-filter-intra": "0"},
    "edge_filter": {"enable-intra-edge-filter": "0"},
    "directional": {"enable-directional-intra": "0"},
    "angle_delta": {"enable-angle-delta": "0"},
    "reduced_tx_set": {"reduced-tx-type-set": "1"},
}
MINIMAL = {k: v for d in list(TOOLS_OFF.values())[:7] for k, v in d.items()}
NOT_YET = "not read by the port yet"
# the fixtures of the coding tools past Pillow's defaults (quantizer
# matrices, film grain, premultiplied alpha, intra block copy):
# tests/test_torch_avif_tools.py writes and checks them
TOOL_PREFIXES = ("qm_", "fg_", "prem_", "ibc_")
# the fixtures of 10- and 12-bit samples (tests/test_torch_avif_depth.py)
DEPTH_PREFIX = chip_smoke.AVIF_DEPTH_PREFIX
# and the grid items and image sequences (tests/test_torch_avif_container.py),
# the scaled frames and 8-bit sweeps (tests/test_torch_avif_scale.py) and the
# frames coded with superres (tests/test_torch_avif_superres.py)
OTHER_PREFIXES = TOOL_PREFIXES + (DEPTH_PREFIX,) + \
    chip_smoke.AVIF_CONTAINER_PREFIXES + chip_smoke.AVIF_SCALE_PREFIXES + \
    (chip_smoke.AVIF_SUPERRES_PREFIX,)
CDEF = {"enable-cdef": "1"}
LAYOUTS = ("4:4:4", "4:2:2", "4:0:0")


def scene(seed: int, rows: int, cols: int) -> np.ndarray:
    """A u8 RGB scene that keeps every intra tool busy: sinusoids and
    gradients under speckle, a flat block with sharp edges and a diagonal
    stripe pattern, from `seed`."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:rows, 0:cols].astype(np.float32)
    a = np.stack([128 + 90 * np.sin(x / 9.0) * np.cos(y / 7.0),
                  (x * 3 + y) % 256, 64 + (x * y / 40.0) % 128], -1)
    a += rng.gamma(2.0, 6.0, a.shape)
    a[rows // 3:rows // 2, cols // 4:cols // 2] = (200, 30, 60)
    a[((x + 2 * y) // 6 % 2 == 0) & (y > rows * 0.7)] = (20, 220, 240)
    return np.clip(a, 0, 255).astype(np.uint8)


def two_textures(seed: int, rows: int, cols: int) -> np.ndarray:
    """scene() with its right half smoothed to gentle waves and its lower
    left quarter white noise: units that want different restorations."""
    a = scene(seed, rows, cols)
    rng = np.random.default_rng(seed)
    x = np.arange(cols // 2, cols, dtype=np.float32)[None, :, None]
    a[:, cols // 2:] = np.clip(a[:, cols // 2:] * 0.2 + 100 + 20 * np.sin(
        x / 30.0), 0, 255).astype(np.uint8)
    a[rows // 2:, :cols // 2] = rng.integers(
        0, 255, (rows - rows // 2, cols // 2, 3), dtype=np.uint8)
    return a


def _save(a: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="AVIF", **kw)
    return buf.getvalue()


def fixture_files() -> dict:
    """tests/data/avif's files as Pillow writes them from chip_smoke's
    AVIF_SEED, in the order of chip_smoke.AVIF_FIXTURES (the files the port
    refuses by name are refusal_files())."""
    s = chip_smoke.AVIF_SEED
    base = scene(s, 67, 130)
    out = {}
    for speed in (6, 8, 10):
        for q in (10, 50, 90, 100):
            out[f"s{speed}_q{q}.avif"] = _save(base, quality=q, speed=speed,
                                               advanced=LF0)
    for rows, cols in ((1, 1), (5, 7), (129, 257)):
        out[f"size_{cols}x{rows}.avif"] = _save(
            scene(s + rows, rows, cols), quality=60, speed=6, advanced=LF0)
    out["tiles_2x2.avif"] = _save(scene(s + 1, 300, 520), quality=40,
                                  speed=8, tile_rows=1, tile_cols=1,
                                  advanced=LF0)
    for name, opt in TOOLS_OFF.items():
        out[f"off_{name}.avif"] = _save(scene(s + 2, 129, 257), quality=60,
                                        speed=6, advanced={**LF0, **opt})
    out["minimal.avif"] = _save(scene(s + 2, 129, 257), quality=60, speed=6,
                                advanced={**LF0, **MINIMAL})
    img = Image.fromarray(base)
    exif = img.getexif()
    exif[0x0112] = 6
    exif[0x010F] = "sarpro"
    out["metadata.avif"] = _save(base, quality=50, speed=6, advanced=LF0,
                                 icc_profile=b"\0\0\2\0" + bytes(124),
                                 exif=exif.tobytes(),
                                 xmp=b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>")
    out["limited_range.avif"] = _save(base, quality=50, speed=6,
                                      range="limited", advanced=LF0)
    out.update(filtered_files())
    out.update(layout_files())
    return out


def filtered_files() -> dict:
    """The fixtures with aom's in-loop filters on, as fixture_files() ends.
    The first three were the files the port refused by name before it read
    the filters: deblocking (speed 6, Pillow's defaults), CDEF alone (speed
    4, loop filter and restoration off) and restoration alone (speed 0,
    loop filter off). Between the others: deblocking with both luma levels
    set and with one of them 0 (lf_s2), sharpness 3 and 7, delta-LF
    (deltaq-mode 2 with delta-lf-mode: delta_lf_present without
    delta_lf_multi, which aom never writes), CDEF with 2 and 4 strength
    sets, Wiener and self-guided units, 128 x 128 superblocks, 2 x 2 tiles,
    and one switchable frame with 128-sample units (lf_s0_switchable;
    every other file's units are 256 samples: aom searches smaller ones
    only at speed 0)."""
    s = chip_smoke.AVIF_SEED
    a = scene(s + 3, 64, 96)
    base = scene(s, 67, 130)
    big = scene(s + 2, 129, 257)
    out = {
        "filter_deblocking.avif": _save(a, quality=50, speed=6),
        "filter_cdef.avif": _save(a, quality=50, speed=4, advanced={
            **LF0, **CDEF, "enable-restoration": "0"}),
        "filter_restoration.avif": _save(a, quality=50, speed=0,
                                         advanced=LF0),
    }
    for speed in (6, 8, 10):
        for q in (10, 50, 90):
            out[f"lf_s{speed}_q{q}.avif"] = _save(base, quality=q,
                                                  speed=speed)
    out["lf_s0_switchable.avif"] = _save(two_textures(s + 20, 128, 256),
                                         quality=20, speed=0)
    out["lf_s2.avif"] = _save(big, quality=50, speed=2)
    out["lf_s4.avif"] = _save(base, quality=30, speed=4)
    for speed in (4, 6):
        out[f"lf_cdef_s{speed}.avif"] = _save(big, quality=40, speed=speed,
                                              advanced=CDEF)
    for sharp in (3, 7):
        out[f"lf_sharpness{sharp}.avif"] = _save(
            big, quality=30, speed=6, advanced={"sharpness": str(sharp)})
    out["lf_delta_lf.avif"] = _save(big, quality=30, speed=6, advanced={
        "deltaq-mode": "2", "delta-lf-mode": "1"})
    out["lf_sb128.avif"] = _save(big, quality=20, speed=4, advanced={
        **CDEF, "sb-size": "128"})
    out["lf_tiles_2x2.avif"] = _save(scene(s + 1, 300, 520), quality=40,
                                     speed=4, tile_rows=1, tile_cols=1,
                                     advanced=CDEF)
    for (rows, cols), q in (((1, 1), 20), ((5, 7), 20), ((129, 257), 30)):
        out[f"lf_size_{cols}x{rows}.avif"] = _save(
            scene(s + 30 + rows, rows, cols), quality=q, speed=4,
            advanced=CDEF)
    return out


def alpha_plane(rows: int, cols: int, seed: int = None) -> np.ndarray:
    """An alpha channel that is 0 on the left quarter, graded (0 to 255
    along the rows) on the lower half of the rest, and 255 elsewhere; with
    `seed`, 0 or 255 at random on the upper right (aom codes such a plane
    with palette blocks)."""
    a = np.full((rows, cols), 255, np.uint8)
    y = np.arange(rows)[:, None]
    a[rows // 2:] = (255 * (y[rows // 2:] - rows // 2) // max(1, rows - 1
                                                               - rows // 2))
    a[:, :cols // 4] = 0
    if seed is not None:
        noise = np.random.default_rng(seed).random((rows, cols)) < 0.5
        top = slice(0, rows * 3 // 5)
        a[top, cols * 3 // 10:] = np.where(noise[top, cols * 3 // 10:], 0, 255)
    return a


def layout_files() -> dict:
    """The fixtures of the other sample layouts and of alpha, as
    fixture_files() ends: 4:4:4, 4:2:2 and 4:0:0 at speeds 6 and 10 with
    the loop filter off and at Pillow's defaults, with `enable-cdef 1` at
    speed 4, at sizes 7 x 5 and 257 x 129 (4:4:4 and 4:2:2), and 4:2:2 at
    speed 0 (loop restoration on its chroma); RGBA at 4:2:0, 4:4:4 and
    4:0:0 (alpha_plane: partly 0, 255 and graded), RGBA whose alpha aom
    codes with palette blocks (rgba_speckled), an "LA" image (Pillow
    saves it as RGBA) and a 1 x 1 RGBA image. Last, the three files the
    port refused by name before it read 4:4:4, alpha and palette blocks
    (the last two need palette blocks: aom codes alpha planes with
    them), then the three it refused before it read quantizer matrices,
    film grain and premultiplied alpha, and the one it refused before it
    read 10-bit samples (Pillow writes none: an 8-bit file with `av1C`
    and `pixi` saying 10 bits, which libavif reads by its sequence
    header's 8 bits) and the one it refused before it scaled frames
    (s6_q50.avif with its `ispe` set to 48 x 32: libavif scales the 130 x
    67 frame to it, and Pillow opens it at 48 x 32)."""
    s = chip_smoke.AVIF_SEED
    base = scene(s, 67, 130)
    big = scene(s + 2, 129, 257)
    out = {}
    for ss in LAYOUTS:
        tag = ss.replace(":", "")
        for speed in (6, 10):
            out[f"ss{tag}_s{speed}.avif"] = _save(
                base, quality=50, speed=speed, subsampling=ss, advanced=LF0)
            out[f"ss{tag}_lf_s{speed}.avif"] = _save(
                base, quality=50, speed=speed, subsampling=ss)
        out[f"ss{tag}_cdef_s4.avif"] = _save(big, quality=40, speed=4,
                                             subsampling=ss, advanced=CDEF)
    out["ss422_s0.avif"] = _save(two_textures(s + 20, 128, 256), quality=20,
                                 speed=0, subsampling="4:2:2")
    for ss in ("4:2:2", "4:4:4"):
        for rows, cols in ((5, 7), (129, 257)):
            out[f"ss{ss.replace(':', '')}_size_{cols}x{rows}.avif"] = _save(
                scene(s + 40 + rows, rows, cols), quality=40, speed=6,
                subsampling=ss)
    rgba = np.dstack([base, alpha_plane(67, 130)])
    for ss in ("4:2:0", "4:4:4", "4:0:0"):
        out[f"rgba_{ss.replace(':', '')}.avif"] = _save(
            rgba, quality=50, speed=6, subsampling=ss)
    out["rgba_speckled.avif"] = _save(
        np.dstack([base, alpha_plane(67, 130, s)]), quality=50, speed=6)
    la = Image.fromarray(np.dstack([base[..., 1], alpha_plane(67, 130)]),
                         "LA")
    buf = io.BytesIO()
    la.save(buf, format="AVIF", quality=50, speed=6)
    out["la.avif"] = buf.getvalue()
    out["rgba_1x1.avif"] = _save(np.array([[[200, 30, 90, 77]]], np.uint8),
                                 quality=50, speed=6)
    a = scene(s + 3, 64, 96)
    flat = np.zeros((64, 64, 3), np.uint8)
    flat[:, :21], flat[:, 21:42], flat[:, 42:] = (255, 0, 0), (0, 255, 0), \
        (0, 0, 255)
    flat[20:40, 10:50] = (250, 250, 0)
    out["was_refused_444.avif"] = _save(a, quality=50, speed=6,
                                        subsampling="4:4:4", advanced=LF0)
    out["was_refused_rgba.avif"] = _save(np.dstack([a, a[..., :1]]),
                                         quality=50, speed=6, advanced=LF0)
    out["was_refused_palette.avif"] = _save(flat, quality=60, speed=6,
                                            advanced={**LF0,
                                                      "enable-palette": "1"})
    out["was_refused_qm.avif"] = _save(a, quality=50, speed=6, advanced={
        **LF0, "enable-qm": "1"})
    out["was_refused_film_grain.avif"] = _save(a, quality=50, speed=6,
                                               advanced={
                                                   **LF0,
                                                   "film-grain-test": "1"})
    out["was_refused_prem.avif"] = _save(
        np.dstack([a, alpha_plane(64, 96)]), quality=50, speed=6,
        advanced=LF0, alpha_premultiplied=True)
    ten = bytearray(_save(scene(s + 3, 64, 96), quality=50, speed=6,
                          advanced=LF0))
    c = ten.find(b"av1C") + 6
    ten[c] |= 0x40  # high_bitdepth
    p = ten.find(b"pixi") + 9
    ten[p:p + 3] = bytes([10, 10, 10])
    out["was_refused_10bit.avif"] = bytes(ten)
    ispe = bytearray(_save(base, quality=50, speed=6, advanced=LF0))
    k = ispe.find(b"ispe") + 8
    ispe[k:k + 8] = struct.pack(">II", 48, 32)
    out["was_refused_ispe.avif"] = bytes(ispe)
    return out


# the files the port refuses by name, and the words of each refusal
REFUSALS = {
    "refuse_denoise_400.avif": re.escape(
        "AV1 tile data that does not end in the spec's trailing bits are"),
}


def refusal_files() -> dict:
    """The files of REFUSALS: aom's 4:0:0 frame with a grain model it
    estimates (`denoise-noise-level`), whose header carries chroma grain
    fields a monochrome frame does not have, so its tile data does not end
    in the spec's trailing bits (dav1d decodes it to garbage, which the JAX
    reader opens). The `ispe` patched to 48 x 32 that stood here before the
    port scaled frames is was_refused_ispe.avif now (layout_files)."""
    sar = chip_smoke.avif_band_u8(64)
    files = {"refuse_denoise_400.avif": _save(
        np.dstack([sar] * 3), quality=30, speed=6, subsampling="4:0:0",
        advanced={"denoise-noise-level": "25"})}
    assert list(files) == list(REFUSALS)
    return files


def band_file() -> bytes:
    """chip_smoke.AVIF_BAND as Pillow writes it: avif_band_u8 at
    AVIF_BAND_SIDE^2 as RGB, speed 6, AVIF_BAND_QUALITY, autotiling, aom's
    loop filter off (11 s and 1 GB here; not run by the tests)."""
    img = Image.fromarray(chip_smoke.avif_band_u8(chip_smoke.AVIF_BAND_SIDE))
    return _save(np.asarray(img.convert("RGB")),
                 quality=chip_smoke.AVIF_BAND_QUALITY, speed=6,
                 autotiling=True, advanced=LF0)


def filtered_band_file() -> bytes:
    """chip_smoke.AVIF_FILTERED_BAND as Pillow writes it: the same band at
    speed 4 with `enable-cdef 1`, so that deblocking, CDEF and loop
    restoration are all on (not run by the tests)."""
    img = Image.fromarray(chip_smoke.avif_band_u8(chip_smoke.AVIF_BAND_SIDE))
    return _save(np.asarray(img.convert("RGB")),
                 quality=chip_smoke.AVIF_BAND_QUALITY, speed=4,
                 autotiling=True, advanced=CDEF)


def footprint(side: int) -> np.ndarray:
    """A warped scene's no-data footprint on a side^2 grid: 255 inside a
    rectangle turned by 0.2 rad about the centre (84 % by 76 % of the side),
    0 outside it."""
    c = np.float32((side - 1) / 2)
    y = np.arange(side, dtype=np.float32)[:, None] - c
    x = np.arange(side, dtype=np.float32)[None, :] - c
    cos, sin = np.float32(np.cos(0.2)), np.float32(np.sin(0.2))
    inside = np.abs(x * cos + y * sin) < np.float32(0.42 * side)
    inside &= np.abs(y * cos - x * sin) < np.float32(0.38 * side)
    return np.where(inside, np.uint8(255), np.uint8(0))


def la_band_file() -> bytes:
    """chip_smoke.AVIF_LA_BAND as Pillow writes it: avif_band_u8 at
    AVIF_BAND_SIDE^2 as "LA" with footprint() as its alpha and the gray 0
    under alpha 0, 4:0:0, speed 6, AVIF_BAND_QUALITY, autotiling, the loop
    filter at its default (not run by the tests)."""
    side = chip_smoke.AVIF_BAND_SIDE
    gray = chip_smoke.avif_band_u8(side)
    alpha = footprint(side)
    gray[alpha == 0] = 0
    buf = io.BytesIO()
    Image.fromarray(np.dstack([gray, alpha]), "LA").save(
        buf, format="AVIF", quality=chip_smoke.AVIF_BAND_QUALITY, speed=6,
        subsampling="4:0:0", autotiling=True)
    return buf.getvalue()


def _write(tmp_path, blob: bytes, name: str = "a.avif") -> Path:
    path = tmp_path / name
    path.write_bytes(blob)
    return path


def _outcome(path) -> tuple:
    """("open", None) where both readers open the file bit-equal, ("refused",
    None) where both refuse it, ("not yet", message) where only the port
    refuses it, naming what it does not read yet."""
    try:
        jraster.RasterReader(path).close()
    except jraster.RasterError:
        with pytest.raises(RasterError):
            traster.RasterReader(path)
        return "refused", None
    try:
        traster.RasterReader(path).close()
    except RasterError as e:
        assert NOT_YET in str(e), str(e)
        return "not yet", str(e)
    _equal_to_jax(path)
    return "open", None


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------
def test_fixtures_are_pillows(tmp_path):
    """tests/data/avif holds what Pillow writes from the seeds, under 1 MB
    in all, each opening to the SHA-256 chip_smoke pins (AVIF_FIXTURES; the
    tool fixtures are checked by tests/test_torch_avif_tools.py, the 10-
    and 12-bit ones by tests/test_torch_avif_depth.py)."""
    files = fixture_files()
    tools = [n for n in chip_smoke.AVIF_FIXTURES
             if n.startswith(OTHER_PREFIXES)]
    assert list(files) == [n for n in chip_smoke.AVIF_FIXTURES
                           if n not in tools]
    refused = refusal_files()
    on_disk = sorted(p.name for p in AVIF_DIR.glob("*.avif"))
    assert on_disk == sorted([*files, *refused, *tools])
    assert sum(p.stat().st_size for p in AVIF_DIR.iterdir()) < 1 << 20
    for name, blob in [*files.items(), *refused.items()]:
        assert (AVIF_DIR / name).read_bytes() == blob, name
    for name, blob in files.items():
        with Image.open(io.BytesIO(blob)) as im:
            digest = hashlib.sha256(np.asarray(im).tobytes()).hexdigest()
        assert digest == chip_smoke.AVIF_FIXTURES[name], name


def test_band_equals_pillows_decode():
    """The committed 9216^2 band (chip_smoke's avif phase): 8-bit 4:2:0 in
    several tiles, under 2 MB, and the port's decode and Pillow's both hash
    to AVIF_BAND_SHA256."""
    blob = chip_smoke.AVIF_BAND.read_bytes()
    assert len(blob) < 2 << 20
    p = avif.parse(blob)
    side = chip_smoke.AVIF_BAND_SIDE
    assert (p.width, p.height, p.matrix, p.full_range, p.alpha) == (
        side, side, 6, 1, None)
    with Image.open(io.BytesIO(blob)) as im:
        want = hashlib.sha256(np.asarray(im).tobytes()).hexdigest()
    assert want == chip_smoke.AVIF_BAND_SHA256
    got = avif.read(blob).load().array
    assert hashlib.sha256(got.tobytes()).hexdigest() == want
    assert np.array_equal(got[..., 0], got[..., 2])


def test_la_band_equals_pillows_decode():
    """The committed 9216^2 "LA" band (chip_smoke's avif phase): 4:0:0 with
    an alpha item in 16 tiles each, under 1 MB; Pillow opens it as RGBA, and
    the port's decode and Pillow's both hash to AVIF_LA_BAND_SHA256."""
    blob = chip_smoke.AVIF_LA_BAND.read_bytes()
    assert len(blob) < 1 << 20
    p = avif.parse(blob)
    side = chip_smoke.AVIF_BAND_SIDE
    assert (p.width, p.height, p.alpha_size) == (side, side, (side, side))
    with Image.open(io.BytesIO(blob)) as im:
        assert im.mode == "RGBA"
        want = hashlib.sha256(np.asarray(im).tobytes()).hexdigest()
    assert want == chip_smoke.AVIF_LA_BAND_SHA256
    got = avif.read(blob).load().array
    assert hashlib.sha256(got.tobytes()).hexdigest() == want
    assert np.array_equal(got[..., 0], got[..., 2])
    assert (got[..., 3] == 0).any() and (got[..., 3] == 255).any()


@pytest.mark.parametrize("name", [n for n in chip_smoke.AVIF_FIXTURES
                                  if not n.startswith(OTHER_PREFIXES)])
def test_fixture_equals_jax(name):
    got = _equal_to_jax(AVIF_DIR / name)
    with Image.open(AVIF_DIR / name) as im:
        bands = len(im.mode)
    assert got.dtype == np.uint8 and got.shape[2] == bands
    assert hashlib.sha256(got.tobytes()).hexdigest() == \
        chip_smoke.AVIF_FIXTURES[name]


# ---------------------------------------------------------------------------
# the matrix and range of the conversion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("matrix", [1, 2, 5, 6, 9])
@pytest.mark.parametrize("name", ["s6_q50.avif", "limited_range.avif"])
def test_colr_matrix_equals_jax(tmp_path, name, matrix):
    """The `colr` nclx matrix picks libyuv's constants (BT.601 as JPEG /
    I601, BT.709 as F709 / H709, BT.2020 as V2020 / 2020, by the sequence
    header's range)."""
    b = bytearray((AVIF_DIR / name).read_bytes())
    k = b.find(b"colrnclx") + 8
    b[k + 4:k + 6] = struct.pack(">H", matrix)
    _equal_to_jax(_write(tmp_path, bytes(b)))


@pytest.mark.parametrize("matrix", [1, 6, 9])
@pytest.mark.parametrize("name", ["s6_q50.avif", "limited_range.avif"])
def test_colr_range_flag_equals_jax(tmp_path, name, matrix):
    """The nclx range flag, not the sequence header's, picks full or
    limited range (libavif takes the `colr` box's CICP and range)."""
    b = bytearray((AVIF_DIR / name).read_bytes())
    k = b.find(b"colrnclx") + 8
    b[k + 4:k + 6] = struct.pack(">H", matrix)
    b[k + 6] ^= 0x80
    _equal_to_jax(_write(tmp_path, bytes(b)))


@pytest.mark.parametrize("matrix", [4, 7, 8, 12, 15])
def test_other_colr_matrix_is_named(tmp_path, matrix):
    """Matrices libavif converts with its own code (FCC, SMPTE 240M,
    YCgCo, chroma-derived NCL over the BT.709 primaries, a reserved value
    read as BT.601) open bit-equal to the JAX reader, and differ from the
    file's own BT.601 but for chroma-derived NCL over BT.709 (libyuv's
    BT.709 constants)."""
    b = bytearray((AVIF_DIR / "s6_q50.avif").read_bytes())
    k = b.find(b"colrnclx") + 8
    b[k + 4:k + 6] = struct.pack(">H", matrix)
    got = _equal_to_jax(_write(tmp_path, bytes(b)))
    plain = avif.read((AVIF_DIR / "s6_q50.avif").read_bytes()).load().array
    assert not np.array_equal(got, plain)


@pytest.mark.parametrize("matrix,name", [
    *[(m, "s6_q50.avif") for m in (0, 3, 10, 11, 13, 14, 16, 65535)],
    (16, "hbd_12_420_full.avif")],
    ids=[*map(str, (0, 3, 10, 11, 13, 14, 16, 65535)), "16-12bit"])
def test_colr_matrix_libavif_refuses_is_refused(tmp_path, matrix, name):
    """Identity on 4:2:0, the reserved values, constant-luminance BT.2020,
    SMPTE ST 2085, ICtCp, and YCgCo-Re from 8- and 12-bit samples (libavif
    converts it only where the samples have two bits more than the 8-bit
    RGB): libavif's conversion fails, and so does the port's."""
    b = bytearray((AVIF_DIR / name).read_bytes())
    k = b.find(b"colrnclx") + 8
    b[k + 4:k + 6] = struct.pack(">H", matrix)
    _both_refuse(_write(tmp_path, bytes(b)), match="Reformat failed")


def _colr_outcome(name: str, matrix: int, limited: bool) -> str:
    """What libavif 1.3.0 makes of tests/data/avif/`name` with its `colr`
    matrix and range set so, as Pillow's decodes show: "refused" (Reformat
    failed: the reserved 3 and values past 17, constant-luminance BT.2020,
    SMPTE ST 2085, ICtCp, YCgCo-Ro, limited-range YCgCo and YCgCo-Re,
    YCgCo-Re but from 10-bit samples, identity on subsampled colour) or
    "open"."""
    blob = (AVIF_DIR / name).read_bytes()
    av1c = blob[blob.find(b"av1C") + 4:]  # the primary item's comes first
    mono, layout_444 = av1c[2] & 0x10 != 0, av1c[2] & 0x0C == 0
    if matrix in (3, 10, 11, 13, 14, 17) or matrix > 17 or (
            matrix in (8, 16) and limited) or (
            matrix == 16 and avif._depth(av1c) != 10) or (
            matrix == 0 and not (mono or layout_444)):
        return "refused"
    return "open"


@pytest.mark.parametrize("limited", [False, True], ids=["full", "limited"])
@pytest.mark.parametrize("matrix", [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 15, 16])
@pytest.mark.parametrize("name", ["ss444_s6.avif", "ss422_s6.avif",
                                  "ss400_s6.avif", "rgba_444.avif",
                                  "rgba_400.avif"])
def test_colr_of_other_layouts_equals_jax(tmp_path, name, matrix, limited):
    """The `colr` matrix and range on 4:4:4, 4:2:2 and monochrome samples,
    RGB and RGBA: libyuv's constants (4:2:2 upsampled along the rows), the
    identity (GBR) on 4:4:4, monochrome as gray whatever the matrix (the
    limited range widened in float, but through libyuv's BT.601 constants
    where it writes RGBA), and libavif's refusals."""
    b = bytearray((AVIF_DIR / name).read_bytes())
    k = b.find(b"colrnclx") + 8
    b[k + 4:k + 6] = struct.pack(">H", matrix)
    if limited:
        b[k + 6] ^= 0x80
    kind, why = _outcome(_write(tmp_path, bytes(b)))
    assert kind == _colr_outcome(name, matrix, limited), why


def _ramp(mode: str) -> bytes:
    """Every sample value, 4:0:0 at quality 100 in full range, as `mode`."""
    g = np.tile(np.repeat(np.arange(256, dtype=np.uint8), 2)[None], (8, 1))
    a = np.dstack([g] * 3 + ([255 - g] if mode == "RGBA" else []))
    return _save(a, quality=100, speed=6, subsampling="4:0:0")


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("matrix", [1, 6, 9])
def test_monochrome_ramp_widens_as_libavif(tmp_path, mode, matrix):
    """All 256 gray values read in limited range: libavif's float widening
    for RGB, libyuv's I400ToARGBMatrix for RGBA (BT.601 and 709 constants
    differ from the float on 10 values; BT.2020's do not)."""
    b = bytearray(_ramp(mode))
    k = b.find(b"colrnclx") + 8
    b[k + 4:k + 6] = struct.pack(">H", matrix)
    b[k + 6] ^= 0x80
    got = _equal_to_jax(_write(tmp_path, bytes(b)))
    assert len(np.unique(avif.read(bytes(b)).load().array[..., 0])) > 200
    assert got.shape[2] == len(mode)


# ---------------------------------------------------------------------------
# damaged files
# ---------------------------------------------------------------------------
def _obu_span(blob: bytes) -> tuple:
    obus = avif.parse(blob).obus
    start = blob.find(obus)
    return start, start + len(obus)


def _obu_spans(blob: bytes) -> list:
    """[(start, end)] of the AV1 data of the primary item and of its alpha
    item, if any."""
    p = avif.parse(blob)
    return [(blob.find(o), blob.find(o) + len(o)) for o in (p.obus, p.alpha)
            if o is not None]


def _bit_flips(tmp_path, name: str, seed: int, head: int = 0) -> dict:
    """50 single-bit flips of tests/data/avif/`name` from `seed`, anywhere
    in it (or in the first `head` bytes of its AV1 data): both readers open
    the file bit-equal or both refuse it, or the port names what it does
    not read yet. The port's refusals by name come from the AV1 data (tile
    data that no longer ends in the spec's trailing bits, a header that now
    asks for another kind of frame), at most two a case from the container
    (a flipped av1C depth or subsampling); a header that now asks for
    superres opens as the JAX reader opens it, or is refused by both.
    Returns the count of each outcome."""
    blob = (AVIF_DIR / name).read_bytes()
    spans = _obu_spans(blob)
    lo, hi = spans[0]
    rng = np.random.default_rng(seed)
    seen = {"open": 0, "refused": 0, "not yet": 0}
    outside = 0
    for k in range(50):
        b = bytearray(blob)
        pos = lo + int(rng.integers(0, head)) if head else \
            int(rng.integers(0, len(b)))
        b[pos] ^= 1 << int(rng.integers(0, 8))
        kind, _ = _outcome(_write(tmp_path, bytes(b), f"f{k}.avif"))
        seen[kind] += 1
        if kind == "not yet" and not any(a <= pos < z for a, z in spans):
            outside += 1
    assert sum(seen.values()) == 50
    assert outside <= 2, seen
    assert seen["not yet"] <= sum(z - a for a, z in spans), seen
    return seen


@pytest.mark.parametrize("chunk", range(6))
def test_bit_flips_agree_with_jax(tmp_path, chunk):
    """300 single-bit flips of a file with every kind of item (50 a
    case)."""
    _bit_flips(tmp_path, "metadata.avif", 2100 + chunk)


@pytest.mark.parametrize("chunk", range(4))
def test_bit_flips_of_filtered_file_agree_with_jax(tmp_path, chunk):
    """200 single-bit flips in the sequence and frame headers (the first 48
    bytes of the AV1 data) of a file with deblocking, CDEF (four strength
    sets) and Wiener restoration on (50 a case): a flip of a filter level,
    the sharpness, a CDEF strength or damping leaves the tile data in step,
    and the file opens with other filtering, bit-equal to the JAX reader's;
    others desync the tiles or change the format."""
    seen = _bit_flips(tmp_path, "lf_cdef_s4.avif", 2200 + chunk, head=48)
    assert seen["open"] >= 5, seen


@pytest.mark.parametrize("chunk", range(4))
def test_bit_flips_of_rgba_file_agree_with_jax(tmp_path, chunk):
    """200 single-bit flips of a 4:4:4 file with an alpha item (50 a
    case), anywhere in it: flips of `av1C`'s subsampling and monochrome
    bits, of the alpha item's properties and references, and of either
    item's AV1 data."""
    _bit_flips(tmp_path, "rgba_444.avif", 2300 + chunk)


@pytest.mark.parametrize("bit", [0x10, 0x08, 0x04, 0x02],
                         ids=["monochrome", "subsampling x", "subsampling y",
                              "sample position"])
@pytest.mark.parametrize("item", [0, 1], ids=["colour", "alpha"])
def test_av1c_layout_bits_agree_with_jax(tmp_path, item, bit):
    """`av1C`'s monochrome, subsampling and chroma sample position bits of
    either item of a 4:4:4 file with alpha flipped: neither libavif nor the
    port takes the layout from them (the sequence header rules), so both
    readers open the file alike."""
    b = bytearray((AVIF_DIR / "rgba_444.avif").read_bytes())
    pos = b.find(b"av1C")
    if item:
        pos = b.find(b"av1C", pos + 4)
    b[pos + 6] ^= bit
    kind, why = _outcome(_write(tmp_path, bytes(b)))
    assert kind == "open", why


@pytest.mark.parametrize("cut", [0.05, 0.2, 0.5, 0.9, 0.999])
def test_cut_file_agrees_with_jax(tmp_path, cut):
    blob = (AVIF_DIR / "tiles_2x2.avif").read_bytes()
    kind, why = _outcome(_write(tmp_path, blob[:int(len(blob) * cut)]))
    assert kind in ("refused", "not yet"), why


@pytest.mark.parametrize("cut", [0.3, 0.6, 0.9, 0.999])
def test_cut_rgba_file_agrees_with_jax(tmp_path, cut):
    """A 4:4:4 file with alpha cut short: its alpha item's data lies before
    the colour item's, so a cut ends either."""
    blob = (AVIF_DIR / "rgba_444.avif").read_bytes()
    kind, why = _outcome(_write(tmp_path, blob[:int(len(blob) * cut)]))
    assert kind in ("refused", "not yet"), why


class Items:
    """The items of a Pillow AVIF (iloc version 0, 4-byte offsets and
    lengths; item 1 the colour, item 2 the alpha), to edit and write back:
    `props` the ipco boxes [type, payload], `assoc` the ipma entries [item,
    [property bytes]], `refs` the iref payload, `data` each item's bytes."""

    def __init__(self, blob: bytes):
        top = dict(_boxes(blob))
        self.ftyp = top[b"ftyp"]
        self.kids = [list(k) for k in _boxes(top[b"meta"], 4)]
        kids = dict(self.kids)
        iloc = kids[b"iloc"]
        self.data, pos = {}, 8
        for _ in range(struct.unpack(">H", iloc[6:8])[0]):
            item, _, n = struct.unpack(">HHH", iloc[pos:pos + 6])
            ext = [struct.unpack(">II", iloc[pos + 6 + 8 * e:pos + 14 + 8 * e])
                   for e in range(n)]
            self.data[item] = b"".join(blob[o:o + n] for o, n in ext)
            pos += 6 + 8 * n
        iprp = dict(_boxes(kids[b"iprp"]))
        self.props = [list(k) for k in _boxes(iprp[b"ipco"])]
        ipma, self.assoc, pos = iprp[b"ipma"], [], 8
        for _ in range(struct.unpack(">I", ipma[4:8])[0]):
            item, n = struct.unpack(">HB", ipma[pos:pos + 3])
            self.assoc.append([item, list(ipma[pos + 3:pos + 3 + n])])
            pos += 3 + n
        self.refs = kids[b"iref"]

    def prop(self, kind: bytes, payload: bytes, item: int,
             essential: bool = False) -> None:
        """A new property of `item`, in place of the one of that type it
        has."""
        self.props.append([kind, payload])
        entries = dict(self.assoc)[item]
        entries[:] = [e for e in entries if self.props[(e & 0x7F) - 1][0]
                      != kind] + [len(self.props) | (essential << 7)]

    def build(self) -> bytes:
        ipma = struct.pack(">II", 0, len(self.assoc)) + b"".join(
            struct.pack(">HB", i, len(e)) + bytes(e) for i, e in self.assoc)
        iprp = _box(b"ipco", b"".join(_box(k, v) for k, v in self.props)) \
            + _box(b"ipma", ipma)

        def meta(base: int) -> bytes:
            iloc = struct.pack(">IBBH", 0, 0x44, 0, len(self.data))
            for item, data in self.data.items():
                iloc += struct.pack(">HHHII", item, 0, 1, base, len(data))
                base += len(data)
            body = {b"iloc": iloc, b"iprp": iprp, b"iref": self.refs}
            return _box(b"meta", b"\0\0\0\0" + b"".join(
                _box(k, body.get(k, v)) for k, v in self.kids))

        head = _box(b"ftyp", self.ftyp)
        base = len(head) + len(meta(0)) + 8
        return head + meta(base) + _box(b"mdat", b"".join(self.data.values()))


def _color_range_bit(obus: bytes) -> int:
    """The bit offset of color_range in the first sequence header OBU of
    `obus` (aom's: OBUs with sizes, no timing info, no frame ids)."""
    start = 0
    while True:
        size, n = 0, 0
        while True:
            size |= (obus[start + 1 + n] & 0x7F) << (7 * n)
            n += 1
            if not obus[start + n] & 0x80:
                break
        if obus[start] >> 3 & 15 == 1:
            break
        start += 1 + n + size
    pos = 8 * (start + 1 + n)

    def f(k: int) -> int:
        nonlocal pos
        v = 0
        for _ in range(k):
            v = 2 * v + (obus[pos >> 3] >> (7 - (pos & 7)) & 1)
            pos += 1
        return v

    profile, _, reduced = f(3), f(1), f(1)
    if reduced:
        f(5)
    else:
        assert not f(1)  # timing_info_present
        delay = f(1)
        for _ in range(f(5) + 1):
            f(12)
            if f(5) > 7:
                f(1)
            if delay and f(1):
                f(4)
    wb, hb = f(4) + 1, f(4) + 1
    f(wb + hb)
    if not reduced:
        assert not f(1)  # frame_id_numbers_present
    f(3)
    if not reduced:
        f(4)
        order_hint = f(1)
        if order_hint:
            f(2)
        if f(1) or f(1):  # seq_choose_screen_content_tools, or forced on
            if not f(1):
                f(1)
        if order_hint:
            f(3)
    f(3)
    if f(1) and profile == 2:  # high_bitdepth, then twelve_bit
        f(1)
    if profile != 1:
        f(1)  # mono_chrome
    if f(1):
        f(24)
    return pos


@pytest.mark.parametrize("name", ["rgba_444.avif", "la.avif"])
def test_limited_range_alpha_is_widened(tmp_path, name):
    """An alpha item whose sequence header says limited range: libavif
    widens it as its float path widens luma (bit-equal to the JAX
    reader)."""
    f = Items((AVIF_DIR / name).read_bytes())
    b = bytearray(f.data[2])
    bit = _color_range_bit(bytes(b))
    assert b[bit >> 3] >> (7 - (bit & 7)) & 1  # aom writes full range
    b[bit >> 3] ^= 0x80 >> (bit & 7)
    f.data[2] = bytes(b)
    got = _equal_to_jax(_write(tmp_path, f.build()))
    plain = avif.read((AVIF_DIR / name).read_bytes()).load().array
    assert not np.array_equal(got[..., 3], plain[..., 3])
    assert np.array_equal(got[..., :3], plain[..., :3])


def _alpha_cases() -> dict:
    """Name -> (edit of Items, the outcome both readers must agree on)."""
    def ispe(w, h):
        return lambda f: f.prop(b"ispe", struct.pack(">III", 0, w, h), 2)

    def drop(kind):
        def edit(f):
            entries = dict(f.assoc)[2]
            entries[:] = [e for e in entries
                          if f.props[(e & 0x7F) - 1][0] != kind]
        return edit

    def ref(kind, a, b):
        def edit(f):
            f.refs += _box(kind, struct.pack(">HHH", a, 1, b))
        return edit

    def alpha_data(fn):
        def edit(f):
            f.data[2] = fn(f)
        return edit

    def flip_tail(f):
        d = bytearray(f.data[2])
        d[-3] ^= 0x55
        return bytes(d)

    other = _save(np.dstack([scene(5, 32, 64), alpha_plane(32, 64)]),
                  quality=50, speed=6)
    return {
        "other size": (ispe(130, 66), "refused"),
        "zero width": (ispe(0, 67), "refused"),
        "past the limit": (ispe(40000, 67), "refused"),
        "no ispe": (drop(b"ispe"), "refused"),
        "no av1C": (drop(b"av1C"), "refused"),
        "no pixi": (drop(b"pixi"), "open"),
        "pixi of 10 bits": (lambda f: f.prop(
            b"pixi", bytes.fromhex("00000000010a"), 2), "refused"),
        "unknown essential": (lambda f: f.prop(b"zzzz", b"abc", 2, True),
                              "open"),
        "thumbnail": (ref(b"thmb", 2, 1), "open"),
        "hevc urn": (lambda f: f.prop(
            b"auxC", b"\0\0\0\0urn:mpeg:hevc:2015:auxid:1\0", 2), "open"),
        "depth urn": (lambda f: f.prop(
            b"auxC", b"\0\0\0\0urn:mpeg:hevc:2015:auxid:2\0", 2), "open"),
        "prem from the alpha": (ref(b"prem", 2, 1), "open"),
        "no data": (alpha_data(lambda f: b""), "open"),
        "colour data": (alpha_data(lambda f: f.data[1]), "open"),
        "corrupt": (alpha_data(flip_tail), "refused"),
        "cut": (alpha_data(lambda f: f.data[2][:len(f.data[2]) // 2]),
                "refused"),
        "frame of another size": (alpha_data(
            lambda f: Items(other).data[2]), "open"),
    }


@pytest.mark.parametrize("case", list(_alpha_cases()))
def test_alpha_item_equals_jax(tmp_path, case):
    """libavif 1.3.0's alpha item, as Pillow's opens show: its `ispe` must
    be the image's size (else the decode fails) and within the limits,
    `ispe` and `av1C` present and `pixi` of the `av1C` depth (else the
    parse fails); an item without data, with an unknown essential property,
    a thumbnail or an `auxC` that is not alpha is no alpha item (RGB); the
    AV1 data of any layout gives its luma plane, a frame of another size
    than its `ispe` scaled to it."""
    edit, want = _alpha_cases()[case]
    f = Items((AVIF_DIR / "rgba_444.avif").read_bytes())
    edit(f)
    kind, why = _outcome(_write(tmp_path, f.build()))
    assert kind == want, why
    if want == "open":
        with Image.open(_write(tmp_path, f.build(), "b.avif")) as im:
            bands = len(im.mode)
        assert bands == (4 if case in ("no pixi", "hevc urn",
                                       "prem from the alpha",
                                       "colour data",
                                       "frame of another size") else 3)


def _boxes(blob: bytes, pos: int = 0, end: int = None) -> list:
    """[(type, payload)] of the plain boxes in blob[pos:end]."""
    end = len(blob) if end is None else end
    out = []
    while pos < end:
        size, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        out.append((kind, blob[pos + 8:pos + size]))
        pos += size
    return out


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


@pytest.mark.parametrize("form", ["idat, two extents", "file, two extents",
                                  "iloc v2, free box first"])
def test_container_forms_equal_jax(tmp_path, form):
    """The item's data from an iloc of version 1 with construction method
    1 (inside idat) or 0, split over two extents, or from an iloc of
    version 2 (32-bit item ids and counts) after a box libavif skips: each
    opens as in the JAX reader."""
    blob = (AVIF_DIR / "s6_q50.avif").read_bytes()
    top = dict(_boxes(blob))
    obus = avif.parse(blob).obus
    meta = _boxes(top[b"meta"], 4)
    half = len(obus) // 2
    kids = [(k, v) for k, v in meta if k != b"iloc"]
    if form == "idat, two extents":
        iloc = struct.pack(">BxxxBBHHHHHII II", 1, 0x44, 0x00, 1, 1, 1, 0,
                           2, 0, half, half, len(obus) - half)
        kids.append((b"idat", obus))
        tail = b""
    elif form == "file, two extents":
        iloc = struct.pack(">BxxxBBHHHHHII II", 1, 0x44, 0x00, 1, 1, 0, 0,
                           2, 0, half, half, len(obus) - half)
        tail = obus
    else:
        iloc = struct.pack(">BxxxBBIIHHHII", 2, 0x44, 0x00, 1, 1, 0, 0, 1,
                           0, len(obus))
        tail = obus
    kids.insert(2, (b"iloc", iloc))

    def build(base: int) -> bytes:
        m = bytearray(iloc)
        if base:  # offsets are file offsets: point them at the mdat payload
            if form == "file, two extents":
                struct.pack_into(">I", m, 16, base)
                struct.pack_into(">I", m, 24, base + half)
            else:
                struct.pack_into(">I", m, 20, base)
        body = b"\0\0\0\0" + b"".join(_box(k, bytes(m) if k == b"iloc"
                                             else v) for k, v in kids)
        head = _box(b"ftyp", top[b"ftyp"])
        if form == "iloc v2, free box first":
            head += _box(b"free", bytes(8))
        return head + _box(b"meta", body)

    first = build(0)
    out = build(len(first) + 8 if tail else 0) + (_box(b"mdat", tail)
                                                  if tail else b"")
    got = _equal_to_jax(_write(tmp_path, out))
    assert hashlib.sha256(got.tobytes()).hexdigest() == \
        chip_smoke.AVIF_FIXTURES["s6_q50.avif"]


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------
def test_av1_tables_equal_libavif():
    """Each table of av1_tables.h equals its run in the read-only data of
    Pillow's libavif, found by the generator's own search (the header is
    the generator's rendering of what it finds there)."""
    lib = av1_tables.default_library()
    if lib is None:
        pytest.skip("Pillow's libavif is not installed here")
    tables = av1_tables.extract(lib)
    assert set(tables) == {t.name for t in av1_tables.CDFS} | {
        c.name for c in av1_tables.CONSTS}
    header = Path(av1_tables.HEADER).read_text()
    assert av1_tables.render(tables) == header
    # spot checks of the spec's values: the first kf y-mode row, the 8-bit
    # quantizer ends, the cos / sin constants at 12 bits
    assert [32768 - v for v in tables["KF_Y_MODE"][2][0][:3]] == \
        [15588, 17027, 19338]
    assert tables["DC_QLOOKUP"][2][-1] == 1336
    assert tables["AC_QLOOKUP"][2][-1] == 1828
    # the 10- and 12-bit quantizer lookups: the spec's first and last values
    for name, ends in (("DC_QLOOKUP_10", (4, 9, 5347)),
                       ("AC_QLOOKUP_10", (4, 9, 7312)),
                       ("DC_QLOOKUP_12", (4, 12, 21387)),
                       ("AC_QLOOKUP_12", (4, 13, 29247))):
        q = tables[name][2]
        assert (q[0], q[1], q[-1]) == ends, name
        assert all(b >= a for a, b in zip(q, q[1:])), name
    assert tables["COSPI"][2][32] == 2896 and tables["SINPI"][2][4] == 3803
    # the in-loop filters': the restoration CDFs, Cdef_Directions of
    # direction 0 ({-1, 1}, {-2, 2}) and 7 ({1, 0}, {2, -1}), the CDEF taps
    # and divisors, Sgr_Params of sets 0, 10 and 14, the Wiener midpoints
    assert [32768 - v for v in tables["RESTORATION_TYPE"][2][0]] == \
        [9413, 22581]
    assert [32768 - tables["USE_WIENER"][2][0][0],
            32768 - tables["USE_SGRPROJ"][2][0][0]] == [11570, 16855]
    dirs = tables["CDEF_DIRECTIONS"][2]
    assert dirs[4:6] == [-1 * 144 + 1, -2 * 144 + 2]
    assert dirs[18:20] == [1 * 144 + 0, 2 * 144 - 1]
    assert tables["CDEF_PRI_TAPS"][2] == [4, 2, 3, 3]
    assert tables["CDEF_SEC_TAPS"][2] == [2, 1]
    assert tables["CDEF_DIV_TABLE"][2][1:3] == [840, 420]
    sgr = tables["SGR_PARAMS"][2]
    assert (sgr[0:2], sgr[20:22], sgr[28:30]) == ([140, 3236], [0, 2589],
                                                   [56, 0])
    assert tables["WIENER_TAPS_MID"][2] == [3, -7, 15]
    # Quantizer_Matrix: level 0's luma and chroma 4x4 and the first column
    # of its luma 4x8 (aom keeps the matrices column by column), level 14's
    # luma 4x4; the Gaussian sequence's ends and range
    qm = np.array(tables["QUANTIZER_MATRIX"][2]).reshape(15, 2, 3344)
    assert list(qm[0, 0, :16]) == [32, 43, 73, 97, 43, 67, 94, 110, 73, 94,
                                   137, 150, 97, 110, 150, 200]
    assert list(qm[0, 1, :4]) == [35, 46, 57, 66]
    assert list(qm[0, 0, 1360:1368]) == [32, 33, 37, 49, 65, 80, 91, 104]
    assert list(qm[14, 0, :4]) == [31, 31, 31, 31]
    gauss = tables["GAUSSIAN_SEQUENCE"][2]
    assert gauss[:4] == [56, 568, -180, 172] and gauss[-1] == -484
    assert (min(gauss), max(gauss)) == (-1752, 1688)
    # intra block copy's: txfm_split's first contexts, the inter set 3 and
    # the MV joint, class, sign, class0 and bit CDFs (the spec's defaults)
    assert [32768 - r[0] for r in tables["TXFM_SPLIT"][2][:3]] == \
        [28581, 23846, 20847]
    assert [32768 - r[0] for r in tables["INTER_TX_SET3"][2]] == \
        [16384, 4167, 1998, 748]
    assert [32768 - v for v in tables["MV_JOINT"][2][0]] == \
        [4096, 11264, 19328]
    assert 32768 - tables["MV_CLASS"][2][0][0] == 28672
    assert [32768 - tables[k][2][0][0] for k in ("MV_SIGN", "MV_CLASS0")] \
        == [16384, 27648]
    assert [32768 - r[0] for r in tables["MV_BITS"][2]] == \
        [17408, 17920, 18944, 20480, 22528, 24576, 28672, 29952, 29952,
         30720]


# ---------------------------------------------------------------------------
# the decoded band onto the device (the CPU here)
# ---------------------------------------------------------------------------
def _decimated_read_equals_jax(name: str, band: int, cols: int, rows: int,
                               alg: str) -> None:
    """read_band_resampled of tests/data/avif/`name`: the port's device route
    against the JAX package's."""
    path = AVIF_DIR / name
    t, j = traster.RasterReader(path), jraster.RasterReader(path)
    try:
        got = traster.read_band_resampled_to_device(t, band, cols, rows, "cpu",
                                                    alg)
        want = j.read_band_resampled(band, cols, rows, alg)
    finally:
        t.close()
        j.close()
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, cols)
    np.testing.assert_allclose(got.numpy(), want, **RESAMPLE_TOL)


@pytest.mark.parametrize("alg", ["average", "cubic", "nearest"])
def test_decimated_read_of_avif_band_equals_jax(alg):
    """tests/test_io.py's read_band_resampled(1, 30, 20, ...) on an AVIF
    band."""
    _decimated_read_equals_jax("off_cfl.avif", 1, 30, 20, alg)


@pytest.mark.parametrize("alg", ["average", "cubic", "nearest"])
def test_decimated_read_of_filtered_avif_equals_jax(alg):
    """The same decimated read of a 2 x 2-tile file with deblocking, CDEF
    and Wiener restoration on in every plane."""
    _decimated_read_equals_jax("lf_tiles_2x2.avif", 2, 170, 90, alg)


@pytest.mark.parametrize("alg", ["average", "cubic", "nearest"])
def test_decimated_read_of_alpha_equals_jax(alg):
    """The same decimated read of an alpha band (band 4 of an RGBA file
    whose alpha aom codes with palette blocks)."""
    _decimated_read_equals_jax("rgba_speckled.avif", 4, 40, 25, alg)


def test_header_only_avif_refused_by_both(tmp_path):
    _both_refuse(_write(tmp_path, b"\0\0\0\x1cftypavif" + bytes(60)))
