"""The port's AVIF reader on frames of another size than their item's
`ispe` or their track's `tkhd`, which libavif 1.3.0 scales, and on the
`colr` matrices libavif converts with its own code (io/avif.py over
_native/av1dec.cpp), against the JAX package's RasterReader, which opens
the same files through Pillow 12.1, libavif 1.3.0, dav1d 1.5.1 and libyuv,
on the CPU: every band bit-equal (dtype included), and RasterError where
the JAX reader raises it. No tolerance anywhere: libyuv's scaler is integer
arithmetic, and libavif's own conversion is single-precision float code
the port runs in the same order.

Inputs are the committed files of tests/data/avif whose names start with
SCALE_PREFIXES (`scale_files`, written by Debian's libavif 0.11.1 and aom
3.6.0 through tests/avif_encode.py, then edited): frames of 96 x 48 at 8,
10 and 12 bits in every layout, with and without an alpha item (`prem`
too), each with its `ispe` set to a size that takes another branch of
libyuv's ScalePlane and its `colr` set to a matrix libavif converts itself;
and lossless 8-bit sweeps of every sample value (`sweep_8_*`) beside the
10- and 12-bit ones of tests/test_torch_avif_depth.py. Beside them, edits of
the files of the earlier slices: every `colr` matrix 0-17 and 65535 on every
layout, depth and range (libavif's refusals included), the primaries that
chroma-derived NCL takes its coefficients from, RGBA and `prem` under each
new matrix, the `ispe` set to a size of every scaler branch on each layout
and depth and on an alpha item, a `tkhd` of another size than its track's
frames, and grids whose tiles share an `ispe` their frames do not have.
Where Pillow's own libavif is found, its avifImageScale and
avifImageYUVToRGB, called by ctypes on random planes, hold the port's
scaler and conversion (`_native.av1_scale_plane`, `av1_convert_planes`)."""
import hashlib
import io
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
import avif_encode  # noqa: E402
from sarpro_tpu_torch import _native  # noqa: E402
from sarpro_tpu_torch.io import avif  # noqa: E402
from test_torch_avif import (  # noqa: E402
    AVIF_DIR,
    Items,
    _color_range_bit,
    _outcome,
    _write,
    alpha_plane,
    footprint,
    scene,
)
from test_torch_avif_container import Grid  # noqa: E402
from test_torch_avif_depth import SUB, deep_alpha, deep_planes, sweep  # noqa: E402
from test_torch_decoders import _equal_to_jax  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SCALE_PREFIXES = chip_smoke.AVIF_SCALE_PREFIXES
NAMES = [n for n in chip_smoke.AVIF_FIXTURES if n.startswith(SCALE_PREFIXES)]
SCALED = [n for n in NAMES if n.startswith(SCALE_PREFIXES[0])]
SWEEPS = [n for n in chip_smoke.AVIF_FIXTURES
          if n.startswith((SCALE_PREFIXES[1],
                           chip_smoke.AVIF_DEPTH_PREFIX + "sweep_"))]
LAYOUTS = ("4:2:0", "4:2:2", "4:4:4", "4:0:0")
# the frame of every scale_ file
FRAME = (96, 48)
# name -> (depth, layout, alpha, premultiplied, its `ispe`, its `colr`
# matrix, range and primaries); each `ispe` takes another branch of
# libyuv's ScalePlane from 96 x 48 (on the luma; the chroma of 4:2:0 and
# 4:2:2 may take another)
SCALE_SPEC = {
    "scale_8_420.avif": (8, "4:2:0", False, False, (150, 77), (7, False, 1)),
    "scale_8_422.avif": (8, "4:2:2", False, False, (72, 36), (4, True, 1)),
    "scale_8_444.avif": (8, "4:4:4", False, False, (191, 95), (8, True, 1)),
    "scale_8_400.avif": (8, "4:0:0", False, False, (20, 10), (1, False, 1)),
    "scale_8_rgba.avif": (8, "4:2:0", True, False, (70, 40),
                          (12, True, 11)),
    "scale_8_prem.avif": (8, "4:4:4", True, True, (48, 24), (15, True, 1)),
    "scale_10_420.avif": (10, "4:2:0", False, False, (36, 18),
                          (16, True, 1)),
    "scale_10_422.avif": (10, "4:2:2", False, False, (192, 48),
                          (12, False, 22)),
    "scale_10_rgba.avif": (10, "4:4:4", True, False, (24, 12),
                           (16, True, 1)),
    "scale_12_444.avif": (12, "4:4:4", False, False, (32, 48),
                          (7, True, 1)),
    "scale_12_400.avif": (12, "4:0:0", False, False, (96, 70),
                          (4, False, 1)),
    "scale_12_la.avif": (12, "4:0:0", True, True, (97, 48), (1, True, 1)),
}
# a target size of 96 x 48 for each branch of libyuv's ScalePlane
# (ScaleFilterReduce first turns the box filter into bilinear where an
# axis keeps half or more, bilinear into linear where the height is kept
# or thirded, linear into none where the width is)
BRANCHES = {
    "vertical": (96, 70),
    "down 3/4": (72, 36),
    "down 1/2": (48, 24),
    "down 3/8": (36, 18),
    "down 1/4": (24, 12),
    "box": (20, 10),
    "up 2x linear": (192, 48),
    "up 2x linear, odd": (191, 48),
    "up 2x bilinear": (192, 96),
    "up 2x bilinear, odd": (191, 95),
    "bilinear up": (150, 77),
    "bilinear up, odd": (97, 49),
    "bilinear down": (70, 40),
    "linear": (97, 48),
    "point": (32, 48),
}


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------
def scale_files() -> dict:
    """The scale_ and sweep_8_ files of tests/data/avif as libavif 0.11.1
    writes them from chip_smoke's AVIF_SEED and SCALE_SPEC (its `ispe`
    and `colr` then set), in the order of chip_smoke.AVIF_FIXTURES."""
    s = chip_smoke.AVIF_SEED
    base = scene(s + 30, FRAME[1], FRAME[0])
    out = {}
    for name, (depth, layout, alpha, prem, ispe, colr) in SCALE_SPEC.items():
        a = deep_alpha(alpha_plane(FRAME[1], FRAME[0]), depth) if alpha \
            else None
        blob = avif_encode.encode(*deep_planes(base, depth, layout), a,
                                  depth=depth, layout=layout, quantizer=30,
                                  premultiplied=prem)
        matrix, full, primaries = colr
        blob = avif_encode.set_colr(blob, matrix, full, primaries)
        out[name] = avif_encode.set_ispe(blob, *ispe)
    for layout in LAYOUTS:
        tag = SCALE_PREFIXES[1] + layout.replace(":", "")
        out[f"{tag}.avif"] = sweep(8, layout)
    out[f"{SCALE_PREFIXES[1]}420_a.avif"] = sweep(8, "4:2:0", alpha=True)
    out[f"{SCALE_PREFIXES[1]}444_prem.avif"] = sweep(8, "4:4:4", True, True)
    return out


def scale_band_file() -> bytes:
    """chip_smoke.AVIF_SCALE_BAND as Pillow writes it, then edited:
    avif_band_u8 at AVIF_SCALE_BAND_SIDE^2 as RGBA (its gray in each
    colour, footprint() as alpha, the gray 0 under alpha 0), 8-bit 4:2:0,
    speed 6, AVIF_BAND_QUALITY, autotiling; then both items' `ispe` set to
    AVIF_BAND_SIDE^2 and the `colr` matrix to SMPTE 240M (7) in limited
    range, so that libavif scales both frames up (ScalePlaneBilinearUp)
    and converts them with its own float code (6 s of aom here)."""
    side = chip_smoke.AVIF_SCALE_BAND_SIDE
    gray = chip_smoke.avif_band_u8(side)
    alpha = footprint(side)
    gray[alpha == 0] = 0
    buf = io.BytesIO()
    Image.fromarray(np.dstack([gray, gray, gray, alpha]), "RGBA").save(
        buf, format="AVIF", quality=chip_smoke.AVIF_BAND_QUALITY, speed=6,
        autotiling=True)
    blob = avif_encode.set_ispe(buf.getvalue(), chip_smoke.AVIF_BAND_SIDE,
                                chip_smoke.AVIF_BAND_SIDE)
    return avif_encode.set_colr(blob, 7, False)


def _digest(blob: bytes) -> str:
    with Image.open(io.BytesIO(blob)) as im:
        return hashlib.sha256(np.asarray(im).tobytes()).hexdigest()


def test_scale_fixtures_are_written():
    """The scale_ and sweep_8_ files are libavif 0.11.1's (re-encoded and
    held equal byte for byte where that library is installed), and
    Pillow's decode of each hashes to what chip_smoke pins."""
    assert NAMES == list(SCALE_SPEC) + [
        n for n in NAMES if n.startswith(SCALE_PREFIXES[1])]
    if avif_encode.available():
        files = scale_files()
        assert list(files) == NAMES
        for name, blob in files.items():
            assert (AVIF_DIR / name).read_bytes() == blob, name
    for name in NAMES:
        blob = (AVIF_DIR / name).read_bytes()
        assert _digest(blob) == chip_smoke.AVIF_FIXTURES[name], name


def test_scale_fixtures_hold_their_sizes():
    """Each scale_ file's frame is 96 x 48 and its `ispe` another size,
    its layout, depth and alpha what SCALE_SPEC says."""
    for name in SCALED:
        depth, layout, alpha, prem, ispe, colr = SCALE_SPEC[name]
        p = avif.parse((AVIF_DIR / name).read_bytes())
        assert (p.width, p.height) == ispe != FRAME
        assert (p.matrix, p.full_range, p.primaries) == (
            colr[0], int(colr[1]), colr[2])
        assert (p.alpha_image is not None, p.premultiplied) == (alpha, prem)
        av1c = (AVIF_DIR / name).read_bytes()
        av1c = av1c[av1c.find(b"av1C") + 4:]
        assert avif._depth(av1c) == depth


@pytest.mark.parametrize("name", NAMES)
def test_scale_fixture_equals_jax(name):
    got = _equal_to_jax(AVIF_DIR / name)
    assert hashlib.sha256(got.tobytes()).hexdigest() == \
        chip_smoke.AVIF_FIXTURES[name]


def test_scale_band_equals_pillows_decode():
    """The committed band of phase 18 whose frames libavif scales up
    (6144^2 to 9216^2) and converts with its own code: under 1 MB, RGBA,
    and the port's decode and Pillow's both hash to
    AVIF_SCALE_BAND_SHA256."""
    blob = chip_smoke.AVIF_SCALE_BAND.read_bytes()
    assert len(blob) < 1 << 20
    p = avif.parse(blob)
    side = chip_smoke.AVIF_BAND_SIDE
    assert (p.width, p.height, p.alpha_size) == (side, side, (side, side))
    assert (p.matrix, p.full_range) == (7, 0)
    assert p.color.tile_width == side
    want = _digest(blob)
    assert want == chip_smoke.AVIF_SCALE_BAND_SHA256
    got = avif.read(blob).load().array
    assert got.shape == (side, side, 4)
    assert hashlib.sha256(got.tobytes()).hexdigest() == want


# ---------------------------------------------------------------------------
# the `colr` matrices
# ---------------------------------------------------------------------------
MATRICES = list(range(18)) + [65535]
# a colour file of each depth and layout: Pillow's at 8 bits, libavif
# 0.11.1's at 10 and 12
COLOUR = {
    (8, "4:2:0"): "s6_q50.avif", (8, "4:2:2"): "ss422_s6.avif",
    (8, "4:4:4"): "ss444_s6.avif", (8, "4:0:0"): "ss400_s6.avif",
    **{(d, k): f"hbd_{d}_{k.replace(':', '')}_full.avif"
       for d in (10, 12) for k in LAYOUTS}}


def refused(matrix: int, depth: int, layout: str, full: bool) -> bool:
    """libavif 1.3.0's conversion refusals, as Pillow's decodes show them:
    the reserved values (3, and past 17), BT.2020 and chroma-derived
    constant luminance (10, 13), SMPTE ST 2085 (11), ICtCp (14) and
    YCgCo-Ro (17); YCgCo (8) and YCgCo-Re (16) in limited range; YCgCo-Re
    from samples of other than 10 bits (its RGB has two bits fewer than
    the samples, and Pillow's is 8-bit); the identity (0) on 4:2:0 and
    4:2:2."""
    return (matrix in (3, 10, 11, 13, 14, 17) or matrix > 17
            or (matrix in (8, 16) and not full)
            or (matrix == 16 and depth != 10)
            or (matrix == 0 and layout in ("4:2:0", "4:2:2")))


@pytest.mark.parametrize("limited", [False, True], ids=["full", "limited"])
@pytest.mark.parametrize("key", list(COLOUR),
                         ids=[f"{d}-{k.replace(':', '')}" for d, k in COLOUR])
@pytest.mark.parametrize("matrix", MATRICES)
def test_matrix_equals_jax(tmp_path, matrix, key, limited):
    """Every `colr` matrix on every depth, layout and range: libyuv's
    matrices as before, libavif's own float code for the others (FCC,
    SMPTE 240M, YCgCo, chroma-derived NCL, a reserved 15 as BT.601,
    YCgCo-Re from 10 bits), and libavif's refusals, bit-equal to the JAX
    reader or refused by both."""
    depth, layout = key
    blob = avif_encode.set_colr((AVIF_DIR / COLOUR[key]).read_bytes(),
                                matrix, not limited)
    kind, why = _outcome(_write(tmp_path, blob))
    assert kind == ("refused" if refused(matrix, depth, layout, not limited)
                    else "open"), why


NEW_MATRICES = (4, 7, 8, 12, 15, 16)
ALPHA = ("rgba_420.avif", "rgba_444.avif", "rgba_400.avif", "la.avif",
         "prem_rgba_420.avif", "prem_rgba_444.avif", "prem_la_400.avif",
         "hbd_10_rgba_420.avif", "hbd_10_rgba_444.avif",
         "hbd_10_prem_420.avif", "hbd_10_prem_la.avif",
         "hbd_12_rgba_422.avif", "hbd_12_prem_la.avif")


@pytest.mark.parametrize("limited", [False, True], ids=["full", "limited"])
@pytest.mark.parametrize("name", ALPHA)
@pytest.mark.parametrize("matrix", NEW_MATRICES)
def test_alpha_under_own_matrix_equals_jax(tmp_path, matrix, name, limited):
    """RGBA and `prem` under the matrices libavif converts itself: the
    alpha copied (8 bits) or narrowed in float (deeper), the colour
    unpremultiplied by libyuv's ARGBUnattenuate after libavif's fast 4:4:4
    and monochrome routines, in float inside its slow routine (4:2:0, 4:2:2,
    YCgCo)."""
    blob = (AVIF_DIR / name).read_bytes()
    depth = avif._depth(blob[blob.find(b"av1C") + 4:])
    layout = "4:0:0" if "_400" in name or "la" in name else \
        "4:4:4" if "444" in name else "4:2:2" if "422" in name else "4:2:0"
    kind, why = _outcome(_write(tmp_path, avif_encode.set_colr(
        blob, matrix, not limited)))
    assert kind == ("refused" if refused(matrix, depth, layout, not limited)
                    else "open"), why


PRIMARIES = list(range(13)) + [22, 255]


@pytest.mark.parametrize("name", ["s6_q50.avif", "ss444_s6.avif",
                                  "rgba_400.avif", "hbd_10_422_full.avif",
                                  "hbd_12_444_limited.avif"])
@pytest.mark.parametrize("primaries", PRIMARIES)
def test_chroma_derived_primaries_equal_jax(tmp_path, primaries, name):
    """Chroma-derived NCL (12) over each `colr` primaries: libyuv's
    BT.709, BT.601 and BT.2020 constants where the primaries are one of
    those (1 and 2, 5 and 6, 9), else libavif's (kr, kb) from the
    primaries' chromaticities in float (unknown ones as BT.709's)."""
    blob = avif_encode.set_colr((AVIF_DIR / name).read_bytes(), 12,
                                primaries=primaries)
    kind, why = _outcome(_write(tmp_path, blob))
    assert kind == "open", why


@pytest.mark.parametrize("limited", [False, True], ids=["full", "limited"])
@pytest.mark.parametrize("matrix", NEW_MATRICES)
@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_under_own_matrix_equals_jax(tmp_path, name, matrix, limited):
    """Every sample value through libavif's own conversion: the lossless
    sweeps of each depth and layout (with alpha and `prem`) under each
    matrix it converts itself, in both ranges."""
    blob = (AVIF_DIR / name).read_bytes()
    depth = avif._depth(blob[blob.find(b"av1C") + 4:])
    layout = next(k for k in LAYOUTS if f"_{k.replace(':', '')}" in name)
    kind, why = _outcome(_write(tmp_path, avif_encode.set_colr(
        blob, matrix, not limited)))
    assert kind == ("refused" if refused(matrix, depth, layout, not limited)
                    else "open"), why


def test_ycgco_re_of_10_bits_is_read(tmp_path):
    """YCgCo-Re on each 10-bit layout opens bit-equal to the JAX reader
    (before this slice the port refused it as libavif refuses YCgCo-Re of
    other depths), and differs from the same file read as BT.709."""
    for name in ("hbd_10_420_full.avif", "hbd_10_422_full.avif",
                 "hbd_10_444_full.avif"):
        blob = (AVIF_DIR / name).read_bytes()
        got = _equal_to_jax(_write(tmp_path, avif_encode.set_colr(blob, 16),
                                   name))
        assert not np.array_equal(got, avif.read(blob).load().array)


# ---------------------------------------------------------------------------
# the scale of a frame
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["s6_q50.avif", "rgba_444.avif"])
@pytest.mark.parametrize("size", [(48, 32), (128, 80), (96, 32), (97, 64)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_ispe_of_another_size_equals_jax(tmp_path, size, name):
    """A Pillow file (and one with an alpha item, both items' `ispe` set)
    whose 130 x 67 frame libavif scales to its `ispe`: Pillow opens it at
    the `ispe` size, and the port's decode is bit-equal."""
    blob = avif_encode.set_ispe((AVIF_DIR / name).read_bytes(), *size)
    got = _equal_to_jax(_write(tmp_path, blob))
    assert got.shape[:2] == (size[1], size[0])


# the files each branch is read from: 8, 10 and 12 bits, every layout, an
# alpha item
BRANCH_FILES = ("scale_8_420.avif", "scale_8_422.avif", "scale_8_444.avif",
                "scale_8_400.avif", "scale_8_rgba.avif", "scale_10_420.avif",
                "scale_10_422.avif", "scale_10_rgba.avif",
                "scale_12_444.avif", "scale_12_la.avif")


@pytest.mark.parametrize("name", BRANCH_FILES)
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_scaler_branch_equals_jax(tmp_path, branch, name):
    """The `ispe` of a 96 x 48 frame set to a size of each branch of
    libyuv's ScalePlane (ScalePlane_12 for deeper samples), on each layout
    (the chroma at the subsampled size, odd targets under 4:2:0 included)
    and on an alpha item."""
    size = BRANCHES[branch]
    blob = avif_encode.set_ispe((AVIF_DIR / name).read_bytes(), *size)
    kind, why = _outcome(_write(tmp_path, blob))
    assert kind == "open", why


@pytest.mark.parametrize("size", [(48, 32), (200, 90)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["rgba_444.avif", "la.avif",
                                  "hbd_10_rgba_420.avif"])
def test_limited_alpha_is_widened_before_the_scale(tmp_path, name, size):
    """An alpha item whose sequence header says limited range, its frame
    scaled with the colour's: libavif widens it to full range first, then
    scales it."""
    f = Items((AVIF_DIR / name).read_bytes())
    b = bytearray(f.data[2])
    bit = _color_range_bit(bytes(b))
    b[bit >> 3] ^= 0x80 >> (bit & 7)
    f.data[2] = bytes(b)
    blob = avif_encode.set_ispe(f.build(), *size)
    kind, why = _outcome(_write(tmp_path, blob))
    assert kind == "open", why


@pytest.mark.parametrize("case", ["alpha only", "colour only"])
def test_alpha_of_another_size_than_the_colour_is_refused(tmp_path, case):
    """Only one item's `ispe` set: libavif scales each frame to its own
    item's size, and an alpha of another size than the colour fails the
    decode in both readers."""
    f = Items((AVIF_DIR / "rgba_444.avif").read_bytes())
    f.prop(b"ispe", struct.pack(">III", 0, 64, 40),
           2 if case == "alpha only" else 1)
    kind, why = _outcome(_write(tmp_path, f.build()))
    assert kind == "refused", why


@pytest.mark.parametrize("size", [(96, 32), (24, 16), (49, 33), (150, 100)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["seq_pillow.avif", "seq_pillow_rgba.avif",
                                  "seq_aom.avif", "seq_svt.avif"])
def test_tkhd_of_another_size_equals_jax(tmp_path, name, size):
    """A sequence whose tracks' `tkhd` (the colour's and the alpha's) is
    another size than its frames: libavif scales the first frame to it,
    and Pillow opens it at that size."""
    blob = avif_encode.set_tkhd((AVIF_DIR / name).read_bytes(), *size)
    got = _equal_to_jax(_write(tmp_path, blob))
    assert got.shape[:2] == (size[1], size[0])


# (file, tile `ispe`, grid columns and rows, the outcome both readers
# agree on): tiles scaled to a shared `ispe` before they are stitched, and
# the grid's rules (tiles of 64 or more a side) on the scaled size
GRID_SCALES = {
    "4:2:0 tiles 80 x 72": ("grid_420.avif", (80, 72), (3, 2), "open"),
    "4:2:0 tiles 66 x 64": ("grid_420.avif", (66, 64), (3, 2), "open"),
    "4:2:0 tiles 40 x 34": ("grid_420.avif", (40, 34), (3, 2), "refused"),
    "4:2:2 tiles 100 x 70": ("grid_422.avif", (100, 70), (2, 2), "open"),
    "RGBA tiles 80 x 72": ("grid_rgba.avif", (80, 72), (2, 2), "open"),
    "10-bit RGBA tiles 97 x 65": ("grid_10_rgba_444.avif", (97, 65), (2, 2),
                                  "open"),
    "12-bit LA tiles 48 x 40": ("grid_12_la.avif", (48, 40), (2, 2),
                                "refused"),
    "12-bit LA tiles 130 x 64": ("grid_12_la.avif", (130, 64), (2, 2),
                                 "open"),
}


@pytest.mark.parametrize("case", list(GRID_SCALES))
def test_grid_tiles_scaled_equal_jax(tmp_path, case):
    """A grid whose tiles (and alpha tiles) share an `ispe` their 64 x 64
    frames do not have, the grid's output 10 x 4 short of what the scaled
    tiles cover: libavif scales each tile, then checks and stitches the
    grid as its tiles' `ispe` says."""
    name, (tw, th), (cols, rows), want = GRID_SCALES[case]
    f = Grid((AVIF_DIR / name).read_bytes())
    width, height = cols * tw - 10, rows * th - 4
    # the colour grid, and the alpha grid (item 6) where there is one
    grids = [k for k, d in f.data.items() if k in (1, 6) and len(d) <= 12]
    for item in f.data:
        size = (width, height) if item in grids else (tw, th)
        f.prop(b"ispe", struct.pack(">III", 0, *size), item)
    f.output(width, height)
    for item in grids:
        f.data[item] = f.data[1]
    kind, why = _outcome(_write(tmp_path, f.build()))
    assert kind == want, why


def test_frame_past_the_scaler_limit_is_refused(tmp_path):
    """A frame wider than 16384 samples whose `ispe` is another size:
    avifImageScale refuses to scale it, and both readers refuse the file
    (at the frame's own size it opens)."""
    a = np.tile(np.arange(16385, dtype=np.uint8)[None], (2, 1))
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="AVIF", quality=10, speed=10,
                            subsampling="4:0:0")
    kind, why = _outcome(_write(tmp_path, buf.getvalue()))
    assert kind == "open", why
    blob = avif_encode.set_ispe(buf.getvalue(), 16384, 2)
    kind, why = _outcome(_write(tmp_path, blob, "b.avif"))
    assert kind == "refused", why


# ---------------------------------------------------------------------------
# the scaler and the conversion against Pillow's libavif
# ---------------------------------------------------------------------------
needs_oracle = pytest.mark.skipif(avif_encode.oracle() is None,
                                  reason="Pillow bundles no libavif here")


def _sizes(rng) -> tuple:
    """A source size and a target of one of libyuv's ratios (or none)."""
    sw, sh = int(rng.integers(1, 160)), int(rng.integers(1, 160))
    pick = int(rng.integers(0, 8))
    if pick in (1, 2, 3, 4):  # 3/4, 1/2, 3/8, 1/4: sizes that divide
        sw, sh = 8 * max(1, sw // 8), 8 * max(1, sh // 8)
    ratio = {0: None, 1: (3, 4), 2: (1, 2), 3: (3, 8), 4: (1, 4),
             5: (2, 1), 6: (1, 3), 7: (1, 1)}[pick]
    if ratio is None:
        return (sw, sh), (int(rng.integers(1, 320)),
                          int(rng.integers(1, 320)))
    dw, dh = max(1, sw * ratio[0] // ratio[1]), max(1, sh * ratio[0]
                                                    // ratio[1])
    if rng.random() < 0.3:  # one axis only, or one short of 2x
        dh = sh if pick != 5 else 2 * sh - 1
    return (sw, sh), (dw, dh)


@needs_oracle
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("seed", range(4))
def test_scaler_equals_libavif(seed, depth):
    """av1dec.cpp's scaler against avifImageScale on 60 random planes of
    random sizes, half at the ratios libyuv has branches for."""
    rng = np.random.default_rng(2800 + 10 * seed + depth)
    for _ in range(60):
        (sw, sh), (dw, dh) = _sizes(rng)
        plane = rng.integers(0, 1 << depth, (sh, sw))
        res, want = avif_encode.oracle_scale((plane, None, None, None), dw,
                                             dh, depth, "4:0:0")
        assert res == 0
        got = _native.av1_scale_plane(plane, dw, dh, depth)
        assert np.array_equal(got, want[0]), ((sw, sh), (dw, dh))


@needs_oracle
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_conversion_equals_libavif(depth, layout):
    """av1dec.cpp's conversion against avifImageYUVToRGB on random planes
    of odd and even sizes: every matrix 0-17 and 65535 in both ranges,
    chroma-derived NCL over each primaries, RGB, RGBA and `prem`, and the
    refusals."""
    rng = np.random.default_rng(2900 + depth + 7 * LAYOUTS.index(layout))
    sx, sy = SUB[layout]
    for matrix in MATRICES:
        for primaries in (PRIMARIES if matrix == 12 else [1]):
            for full in (True, False):
                for alpha, prem in ((False, False), (True, False),
                                    (True, True)):
                    h, w = int(rng.integers(1, 14)), int(rng.integers(1, 14))
                    y = rng.integers(0, 1 << depth, (h, w))
                    u = v = a = None
                    if layout != "4:0:0":
                        shape = ((h + sy) >> sy, (w + sx) >> sx)
                        u = rng.integers(0, 1 << depth, shape)
                        v = rng.integers(0, 1 << depth, shape)
                    if alpha:
                        a = rng.integers(0, 1 << depth, (h, w))
                        a.flat[0], a.flat[-1] = 0, (1 << depth) - 1
                    res, want = avif_encode.oracle_rgb(
                        (y, u, v, a), depth, layout, full, matrix, primaries,
                        prem)
                    try:
                        got = _native.av1_convert_planes(
                            y, u, v, a, depth, (sx, sy), matrix, primaries,
                            full, prem)
                    except ValueError as e:
                        assert res != 0 and "Reformat failed" in str(e)
                        continue
                    case = (matrix, primaries, full, alpha, prem, (h, w))
                    assert res == 0, case
                    assert np.array_equal(got, want), case


@needs_oracle
def test_own_conversion_of_every_8bit_triple_equals_libavif():
    """All 2^24 8-bit (Y, U, V) triples of 4:4:4 samples through libavif's
    own float code at FCC, SMPTE 240M, YCgCo and chroma-derived NCL over
    EBU 3213 primaries, full range."""
    v = np.arange(1 << 24, dtype=np.uint32)
    planes = [((v >> s) & 255).astype(np.uint16).reshape(4096, 4096)
              for s in (16, 8, 0)]
    for matrix, primaries in ((4, 1), (7, 1), (8, 1), (12, 22)):
        res, want = avif_encode.oracle_rgb((*planes, None), 8, "4:4:4", True,
                                           matrix, primaries)
        assert res == 0
        got = _native.av1_convert_planes(*planes, None, 8, (0, 0), matrix,
                                         primaries, True)
        assert np.array_equal(got, want), matrix
