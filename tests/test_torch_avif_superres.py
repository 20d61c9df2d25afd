"""The port's AVIF reader on AV1 frames coded with superres (io/avif.py
over _native/av1dec.cpp: superres_params, the restoration units over the
upscaled columns, the upscaling process after CDEF, loop restoration and
film grain at the upscaled width) against the JAX package's RasterReader,
which opens the same files through Pillow 12.1, libavif 1.3.0, dav1d 1.5.1
and libyuv, on the CPU: every band bit-equal (dtype included), and
RasterError where the JAX reader raises it. No tolerance anywhere.

Inputs are the committed files tests/data/avif/sr_*.avif (`superres_files`,
re-encoded here where libaom 3.6.0 and libavif 0.11.1 are installed and
held equal byte for byte): libaom 3.6.0 codes each frame through its own API
(tests/avif_encode.encode_av1, superres fixed at a denominator of 9 to 16
for key and other frames), and the frames are spliced into the container
libavif 0.11.1 writes for the same planes (`splice_av1`). They cover each
denominator on 8-bit 4:2:0 (odd coded widths among them), 4:4:4, 4:2:2 and
4:0:0, 10 and 12 bits, every in-loop filter combination (none, deblocking
alone, CDEF alone, restoration alone, both; Wiener, self-guided and
switchable frames), restoration units of 128 and 256 samples, 128 x 128
superblocks, two tile columns, widths of 17 to 40 (the 16-sample floor of
the coded width), film grain (a limited-range frame among them), aom's
all-intra usage, an alpha item, a 2 x 2 grid of tiles at four
denominators, the first frame of an `avis` sequence and `ispe` sizes that
make libavif scale the upscaled frame. SUPERRES_INFO records what the
decoder's own parse makes of each (`_native.av1_frame_info`).

Beside them: the two files the port refuses by name (tests/data/
avif_superres, `refusal_files`: superres that leaves a frame as wide, whose
allow_intrabc bit dav1d does not read); 200 single-bit flips in the headers
of a file with CDEF and Wiener restoration on; the film grain's clip_to_restricted_range flipped
(at the bit the port's own parse gives) in grain fixtures of every layout
and depth, a limited-range one among them; restoration units of 64 samples
and a chroma shift set in the headers of one-unit frames (libaom 3.6.0
writes neither); the decimated read; a 1024^2 band coded with the options of
chip_smoke.py's eighth band; and that band (9216^2, coded 4608 wide)."""
import hashlib
import io
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
import avif_encode  # noqa: E402
from sarpro_tpu_torch import _native  # noqa: E402
from sarpro_tpu_torch._native import av1_tables  # noqa: E402
from sarpro_tpu_torch.io import avif  # noqa: E402
from test_torch_avif import (  # noqa: E402
    AVIF_DIR,
    _bit_flips,
    _color_range_bit,
    _decimated_read_equals_jax,
    _outcome,
    _write,
    alpha_plane,
    footprint,
    scene,
    two_textures,
)
from test_torch_avif_container import _zero_times  # noqa: E402
from test_torch_avif_depth import deep_planes  # noqa: E402
from test_torch_decoders import _equal_to_jax  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

PREFIX = chip_smoke.AVIF_SUPERRES_PREFIX
NAMES = [n for n in chip_smoke.AVIF_FIXTURES if n.startswith(PREFIX)]
FILTERS = {"enable-cdef": 1, "enable-restoration": 1}
# 64 x 64 superblocks (aom picks 128 x 128 ones under superres)
SB64 = {"sb-size": 64}
LF_OFF = {"loopfilter-control": 0, "enable-cdef": 0, "enable-restoration": 0,
          **SB64}
# what the decoder's own parse makes of each sr_ file (its name less the
# prefix): the upscaled and coded widths, SuperresDenom, the tile columns,
# FrameRestorationType of Y, U and V (0 none, 1 Wiener, 2 self-guided, 3
# switchable), the luma LoopRestorationSize, the units of the three planes
# that take none, Wiener and self-guided restoration, whether CDEF runs,
# apply_grain and use_128x128_superblock
SUPERRES_INFO = {
    "d9": (130, 116, 9, 1, (1, 1, 1), 128, (0, 3, 0), 1, 0, 0),
    "d10": (130, 104, 10, 1, (0, 1, 1), 128, (0, 2, 0), 1, 0, 0),
    "d11": (130, 95, 11, 1, (0, 1, 1), 128, (0, 2, 0), 1, 0, 0),
    "d12": (130, 87, 12, 1, (1, 0, 1), 128, (0, 2, 0), 1, 0, 0),
    "d13": (130, 80, 13, 1, (1, 0, 1), 128, (0, 2, 0), 1, 0, 0),
    "d14": (130, 74, 14, 1, (1, 0, 1), 128, (0, 2, 0), 1, 0, 0),
    "d15": (130, 69, 15, 1, (1, 0, 1), 128, (0, 2, 0), 1, 0, 0),
    "d16": (130, 65, 16, 1, (1, 1, 1), 128, (0, 3, 0), 1, 0, 0),
    "444": (130, 87, 12, 1, (1, 2, 1), 128, (0, 2, 1), 1, 0, 1),
    "422": (130, 80, 13, 1, (1, 2, 1), 128, (0, 2, 1), 1, 0, 1),
    "400": (130, 80, 13, 1, (1, 0, 0), 128, (0, 1, 0), 1, 0, 1),
    "10_420": (130, 95, 11, 1, (0, 2, 1), 128, (0, 1, 1), 1, 0, 1),
    "12_420": (130, 95, 11, 1, (1, 0, 1), 128, (0, 2, 0), 1, 0, 1),
    "12_444": (130, 95, 11, 1, (2, 1, 1), 128, (0, 2, 1), 1, 0, 1),
    "lf_off": (130, 87, 12, 1, (0, 0, 0), 0, (0, 0, 0), 0, 0, 0),
    "deblocking": (130, 69, 15, 1, (0, 0, 0), 0, (0, 0, 0), 0, 0, 0),
    "cdef": (130, 87, 12, 1, (0, 0, 0), 0, (0, 0, 0), 1, 0, 0),
    "restoration": (256, 205, 10, 1, (1, 1, 1), 128, (0, 4, 0), 0, 0, 0),
    "cdef_wiener": (256, 205, 10, 1, (1, 1, 1), 128, (1, 3, 0), 1, 0, 0),
    "sgr": (256, 128, 16, 1, (3, 1, 1), 128, (0, 3, 1), 1, 0, 0),
    "switchable": (256, 205, 10, 1, (3, 1, 1), 128, (0, 3, 1), 1, 0, 1),
    "unit256": (416, 277, 12, 1, (1, 1, 1), 256, (1, 3, 0), 1, 0, 1),
    "sb128": (130, 74, 14, 1, (1, 0, 1), 128, (0, 2, 0), 1, 0, 1),
    "tiles": (300, 267, 9, 2, (1, 1, 1), 128, (0, 4, 0), 1, 0, 0),
    "w17_d9": (17, 16, 9, 1, (1, 0, 1), 128, (0, 2, 0), 1, 0, 0),
    "w24_d16": (24, 16, 16, 1, (2, 2, 0), 128, (0, 0, 2), 1, 0, 0),
    "w31_d12": (31, 21, 12, 1, (1, 0, 1), 128, (0, 2, 0), 1, 0, 0),
    "w40_d16": (40, 20, 16, 1, (2, 1, 1), 128, (0, 2, 1), 1, 0, 0),
    "w17_422": (17, 16, 9, 1, (0, 0, 1), 128, (0, 1, 0), 1, 0, 1),
    "grain": (130, 87, 12, 1, (0, 0, 1), 128, (0, 1, 0), 1, 1, 1),
    "grain_clip": (130, 80, 13, 1, (1, 0, 1), 128, (0, 2, 0), 1, 1, 1),
    "grain_limited": (130, 95, 11, 1, (0, 1, 1), 128, (0, 2, 0), 1, 1, 1),
    "allintra": (130, 80, 13, 1, (0, 0, 0), 0, (0, 0, 0), 1, 0, 1),
    "rgba": (130, 87, 12, 1, (0, 0, 1), 128, (0, 1, 0), 1, 0, 1),
    "grid": (96, 85, 9, 1, (1, 1, 0), 128, (0, 2, 0), 1, 0, 1),
    "seq": (130, 95, 11, 1, (0, 0, 1), 128, (0, 1, 0), 1, 0, 1),
    "ispe_160x90": (130, 87, 12, 1, (0, 0, 1), 128, (0, 1, 0), 1, 0, 1),
    "ispe_100x50": (130, 87, 12, 1, (0, 0, 1), 128, (0, 1, 0), 1, 0, 1),
}
BAND_1024 = chip_smoke.AVIF_BAND.with_name("sar_band_1024_superres.avif")
# the superres files the port refuses by name (refusal_files)
REFUSED_DIR = AVIF_DIR.with_name("avif_superres")
REFUSED = ("w16_screen.avif", "w12_screen.avif")


def _still(a: np.ndarray, *, depth: int = 8, layout: str = "4:2:0",
           alpha: np.ndarray = None, **kw) -> bytes:
    """The AVIF file of a u8 RGB scene's planes (deep_planes) at `depth`,
    coded by encode_av1 with `kw` (alpha, if any, too) and spliced into
    libavif 0.11.1's container of the same planes."""
    planes = deep_planes(a, depth, layout)
    template = avif_encode.encode(*planes, alpha, depth=depth, layout=layout,
                                  speed=10, quantizer=60)
    data = avif_encode.encode_av1([planes], depth=depth, layout=layout, **kw)
    if alpha is not None:  # libavif writes the alpha's data first
        data = avif_encode.encode_av1([(alpha, None, None)], depth=depth,
                                      layout="4:0:0", **kw) + data
    return avif_encode.splice_av1(template, data)


def _flip(blob: bytes, bit_of) -> bytes:
    """`blob` with one bit of its colour item's AV1 data flipped: the bit
    bit_of(that data) gives, counted from its start."""
    obus = avif.parse(blob).color.tiles[0]
    pos = blob.find(obus) * 8 + bit_of(obus)
    b = bytearray(blob)
    b[pos >> 3] ^= 0x80 >> (pos & 7)
    return bytes(b)


def _clip_bit(obus: bytes) -> int:
    return _native.av1_frame_info(obus)["clip_bit"]


def _limited(blob: bytes) -> bytes:
    """`blob` in limited range: its sequence header's color_range and its
    `colr` range flag cleared (no length changes)."""
    return avif_encode.set_colr(_flip(blob, _color_range_bit), full=False)


def superres_files() -> dict:
    """The sr_ files of tests/data/avif as libaom 3.6.0 and libavif 0.11.1
    write them from chip_smoke's AVIF_SEED, in the order of
    chip_smoke.AVIF_FIXTURES."""
    s = chip_smoke.AVIF_SEED
    base = scene(s, 67, 130)
    textures = two_textures(s + 20, 128, 256)
    big = two_textures(s + 30, 256, 416)
    still = _still
    out = {}
    for d in range(9, 17):
        out[f"{PREFIX}d{d}.avif"] = still(base, superres=d, speed=4,
                                          options={**FILTERS, **SB64})
    for layout, d in (("4:4:4", 12), ("4:2:2", 13), ("4:0:0", 13)):
        out[f"{PREFIX}{layout.replace(':', '')}.avif"] = still(
            base, layout=layout, superres=d, speed=2, quantizer=40,
            options=FILTERS)
    for depth, layout in ((10, "4:2:0"), (12, "4:2:0"), (12, "4:4:4")):
        out[f"{PREFIX}{depth}_{layout.replace(':', '')}.avif"] = still(
            base, depth=depth, layout=layout, superres=11, speed=2,
            quantizer=40, options=FILTERS)
    out[f"{PREFIX}lf_off.avif"] = still(base, superres=12, speed=4,
                                        options=LF_OFF)
    out[f"{PREFIX}deblocking.avif"] = still(
        base, superres=15, speed=4,
        options={"enable-cdef": 0, "enable-restoration": 0, **SB64})
    out[f"{PREFIX}cdef.avif"] = still(
        base, superres=12, speed=4,
        options={"enable-cdef": 1, "enable-restoration": 0, **SB64})
    out[f"{PREFIX}restoration.avif"] = still(
        textures, superres=10, speed=2, quantizer=40,
        options={"enable-cdef": 0, "enable-restoration": 1, **SB64})
    out[f"{PREFIX}cdef_wiener.avif"] = still(textures, superres=10, speed=4,
                                             quantizer=40,
                                             options={**FILTERS, **SB64})
    out[f"{PREFIX}sgr.avif"] = still(textures, superres=16, speed=2,
                                     quantizer=40, options={**FILTERS, **SB64})
    out[f"{PREFIX}switchable.avif"] = still(textures, superres=10, speed=0,
                                            quantizer=40, options=FILTERS)
    out[f"{PREFIX}unit256.avif"] = still(big, superres=12, speed=4,
                                         quantizer=50, options=FILTERS)
    out[f"{PREFIX}sb128.avif"] = still(base, superres=14, speed=4,
                                       options={**FILTERS, "sb-size": 128})
    # two tile columns (aom wants each at least 64 wide, upscaled)
    out[f"{PREFIX}tiles.avif"] = still(
        scene(s + 40, 67, 300), superres=9, speed=4,
        options={**FILTERS, **SB64, "tile-columns": 1})
    for w, d in ((17, 9), (24, 16), (31, 12), (40, 16)):
        out[f"{PREFIX}w{w}_d{d}.avif"] = still(
            scene(s + w, 23, w), superres=d, speed=2,
            options={**FILTERS, **SB64})
    out[f"{PREFIX}w17_422.avif"] = still(scene(s + 17, 23, 17),
                                         layout="4:2:2", superres=9,
                                         speed=2, options=FILTERS)
    out[f"{PREFIX}grain.avif"] = still(
        base, superres=12, speed=4, options={**FILTERS,
                                             "film-grain-test": 10})
    out[f"{PREFIX}grain_clip.avif"] = still(
        base, superres=13, speed=4, options={**FILTERS,
                                             "film-grain-test": 1})
    out[f"{PREFIX}grain_limited.avif"] = _limited(still(
        base, superres=11, speed=4, options={**FILTERS,
                                             "film-grain-test": 16}))
    out[f"{PREFIX}allintra.avif"] = still(base, superres=13,
                                          usage="allintra", options=FILTERS)
    out[f"{PREFIX}rgba.avif"] = still(base, superres=12, speed=4,
                                      options=FILTERS,
                                      alpha=alpha_plane(67, 130))
    # a 2 x 2 grid of 96 x 64 tiles, each at its own denominator
    cells = scene(s + 5, 128, 192)
    planes = [deep_planes(cells[r:r + 64, c:c + 96], 8, "4:2:0")
              for r in (0, 64) for c in (0, 96)]
    template = avif_encode.encode_grid([(*p, None) for p in planes], 2, 2,
                                       speed=10, quantizer=60)
    out[f"{PREFIX}grid.avif"] = avif_encode.splice_av1(template, [
        avif_encode.encode_av1([p], superres=d, speed=4, options=FILTERS)[0]
        for p, d in zip(planes, (9, 12, 14, 16))])
    # the first frame of a sequence of two (no creation times)
    frames = [deep_planes(scene(s + k, 67, 130), 8, "4:2:0") for k in (0, 1)]
    template = _zero_times(avif_encode.encode_sequence(
        [(*p, None) for p in frames], speed=10, quantizer=60))
    out[f"{PREFIX}seq.avif"] = avif_encode.splice_av1(
        template, avif_encode.encode_av1(frames, superres=11, speed=4,
                                         options=FILTERS))
    scaled = still(base, superres=12, speed=4, options=FILTERS)
    out[f"{PREFIX}ispe_160x90.avif"] = avif_encode.set_ispe(scaled, 160, 90)
    out[f"{PREFIX}ispe_100x50.avif"] = avif_encode.set_ispe(scaled, 100, 50)
    return out


def refusal_files() -> dict:
    """tests/data/avif_superres's files as libaom 3.6.0 and libavif 0.11.1
    write them: frames of 16 and 12 samples coded with superres at 9, which
    leaves them as wide, and screen content tools. libaom writes their
    allow_intrabc bit, as the spec reads it where superres does not narrow
    the frame; dav1d reads it only where superres is off, so it reads the
    rest of the frame header from the wrong bit and decodes garbage, which
    the JAX reader opens. The port reads the header as dav1d does, and its
    tile data does not end in the spec's trailing bits."""
    s = chip_smoke.AVIF_SEED
    return {name: _still(scene(s + w, 16, w), superres=9, speed=4,
                         options={"tune-content": "screen"})
            for name, w in zip(REFUSED, (16, 12))}


def superres_band_file(side: int) -> bytes:
    """chip_smoke.AVIF_SUPERRES_BAND (side 9216; 1024 for the tests) as
    libaom 3.6.0 and libavif 0.11.1 write it: avif_band_u8 at side^2 as
    the luma of 8-bit 4:2:0 (chroma 128) with the gray 0 outside
    footprint(), which is its alpha item; both coded with superres at
    AVIF_SUPERRES_BAND_DENOMINATOR (half the columns), CDEF and loop
    restoration on, speed 4, four tile columns, at quantizer
    AVIF_SUPERRES_BAND_QUANTIZER."""
    gray = chip_smoke.avif_band_u8(side)
    alpha = footprint(side)
    gray[alpha == 0] = 0
    chroma = np.full(((side + 1) // 2,) * 2, 128)
    template = avif_encode.encode(gray, chroma, chroma, alpha, speed=10,
                                  quantizer=63, threads=8)
    kw = dict(superres=chip_smoke.AVIF_SUPERRES_BAND_DENOMINATOR, speed=4,
              quantizer=chip_smoke.AVIF_SUPERRES_BAND_QUANTIZER, threads=8,
              options={**FILTERS, "tile-columns": 2})
    return avif_encode.splice_av1(template, avif_encode.encode_av1(
        [(alpha, None, None)], layout="4:0:0", **kw) + avif_encode.encode_av1(
        [(gray, chroma, chroma)], **kw))


def _info(blob: bytes) -> tuple:
    """SUPERRES_INFO's fields of the frame of `blob`'s first colour tile."""
    i = _native.av1_frame_info(avif.parse(blob).color.tiles[0])
    return (i["width"], i["coded_width"], i["superres_denominator"],
            i["tile_cols"], i["lr_type"], i["lr_size"][0], i["lr_units"],
            i["cdef"], i["grain"], i["sb128"])


def _digest(blob: bytes) -> str:
    with Image.open(io.BytesIO(blob)) as im:
        return hashlib.sha256(np.asarray(im).tobytes()).hexdigest()


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------
def test_superres_fixtures_are_written():
    """tests/data/avif's sr_ files open in Pillow to the SHA-256 chip_smoke
    pins (AVIF_FIXTURES), and, where libaom 3.6.0 and libavif 0.11.1 are
    installed, are what superres_files() writes, byte for byte."""
    on_disk = sorted(p.name for p in AVIF_DIR.glob(PREFIX + "*"))
    assert on_disk == sorted(NAMES)
    assert [n[len(PREFIX):-5] for n in NAMES] == list(SUPERRES_INFO)
    for name in NAMES:
        assert _digest((AVIF_DIR / name).read_bytes()) == \
            chip_smoke.AVIF_FIXTURES[name], name
    if avif_encode.available() and avif_encode.aom_available():
        files = superres_files()
        assert list(files) == NAMES
        for name, blob in files.items():
            assert (AVIF_DIR / name).read_bytes() == blob, name


def test_superres_fixtures_hold_their_tools():
    """What each file is there for is in it, by the decoder's own parse
    (SUPERRES_INFO): every denominator, a coded width at the 16-sample
    floor, two tile columns, each restoration type and unit size, CDEF on
    and off, grain with and without clip_to_restricted_range; and, by the
    container's parse, the alpha item, the grid, the sequence and the
    `ispe` sizes."""
    for name in NAMES:
        blob = (AVIF_DIR / name).read_bytes()
        assert _info(blob) == SUPERRES_INFO[name[len(PREFIX):-5]], name
    rows = list(SUPERRES_INFO.values())
    assert {r[2] for r in rows} == set(range(9, 17))
    assert any(r[1] == 16 < r[0] for r in rows)
    assert max(r[3] for r in rows) >= 2
    assert {t for r in rows for t in r[4]} == {0, 1, 2, 3}
    assert {r[5] for r in rows} == {0, 128, 256}
    assert all(sum(r[6][1:]) for r in rows if any(r[4]))
    assert {r[7] for r in rows} == {r[9] for r in rows} == {0, 1}
    grain = (AVIF_DIR / f"{PREFIX}grain_clip.avif").read_bytes()
    obus = avif.parse(grain).color.tiles[0]
    bit = _clip_bit(obus)
    assert obus[bit >> 3] & 0x80 >> (bit & 7)
    p = {n: avif.parse((AVIF_DIR / f"{PREFIX}{n}.avif").read_bytes())
         for n in ("rgba", "grid", "seq", "ispe_160x90", "grain_limited")}
    assert p["rgba"].alpha_image is not None
    alpha = _native.av1_frame_info(p["rgba"].alpha_image.tiles[0])
    assert alpha["superres_denominator"] == 12 and alpha["mono"]
    grid = p["grid"].color
    assert (grid.grid, grid.columns, grid.rows) == (True, 2, 2)
    assert [_native.av1_frame_info(t)["superres_denominator"]
            for t in grid.tiles] == [9, 12, 14, 16]
    assert p["seq"].timescale == 30
    assert (p["ispe_160x90"].width, p["ispe_160x90"].height) == (160, 90)
    assert p["grain_limited"].full_range == 0


@pytest.mark.parametrize("name", NAMES)
def test_superres_fixture_equals_jax(name):
    got = _equal_to_jax(AVIF_DIR / name)
    with Image.open(AVIF_DIR / name) as im:
        assert got.shape == (im.height, im.width, len(im.mode))


def test_upscale_filter_is_the_specs():
    """av1_tables.h's AV1_RESIZE_FILTER, read from Pillow's libavif (dav1d's
    resize filter), is the spec's Upscale_Filter negated: each of its 64
    phases sums to 128 once negated, phase 0 is the identity at tap 3, and
    phase 64 - k is phase k reversed."""
    lib = av1_tables.default_library()
    if lib is None:
        pytest.skip("Pillow's libavif is not installed here")
    taps = -np.array(av1_tables.extract(lib)["RESIZE_FILTER"][2])
    taps = taps.reshape(64, 8)
    assert (taps.sum(1) == 128).all()
    assert list(taps[0]) == [0, 0, 0, 128, 0, 0, 0, 0]
    assert (taps[1:] == taps[:0:-1, ::-1]).all()


@pytest.mark.parametrize("name", REFUSED)
def test_superres_of_a_frame_left_as_wide_is_refused_by_name(tmp_path, name):
    """refusal_files(): the JAX reader opens dav1d's garbage, the port
    names the tile data that no longer ends in its trailing bits; the
    files are what libaom 3.6.0 and libavif 0.11.1 write, where they are
    installed."""
    blob = (REFUSED_DIR / name).read_bytes()
    if avif_encode.available() and avif_encode.aom_available():
        assert refusal_files()[name] == blob
    assert sorted(p.name for p in REFUSED_DIR.iterdir()) == sorted(REFUSED)
    kind, why = _outcome(_write(tmp_path, blob))
    assert kind == "not yet", why
    assert "tile data that does not end in the spec's trailing bits" in why


# ---------------------------------------------------------------------------
# edited files
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", range(4))
def test_bit_flips_of_superres_file_agree_with_jax(tmp_path, chunk):
    """200 single-bit flips in the sequence and frame headers (the first 48
    bytes of the AV1 data) of a superres file with deblocking, CDEF and
    Wiener restoration on (50 a case): a flipped superres denominator,
    filter level, strength or restoration type opens with another width
    or other filtering, bit-equal to the JAX reader's, or both readers
    refuse it; others desync the tiles."""
    seen = _bit_flips(tmp_path, f"{PREFIX}cdef_wiener.avif", 2800 + chunk,
                      head=48)
    assert seen["open"] >= 5, seen


# the grain files whose clip_to_restricted_range is flipped: the superres
# ones (the limited-range one, and one aom wrote with the flag set) and
# those of every layout and depth beside them
CLIP_FILES = [f"{PREFIX}grain.avif", f"{PREFIX}grain_clip.avif",
              f"{PREFIX}grain_limited.avif", "fg_test01.avif",
              "fg_test15.avif", "fg_444.avif", "fg_422.avif", "fg_400.avif",
              "fg_rgba.avif", "hbd_10_fg1.avif", "hbd_12_fg15.avif",
              "hbd_10_grain.avif"]


@pytest.mark.parametrize("limited", [False, True], ids=["as coded", "limited"])
@pytest.mark.parametrize("name", CLIP_FILES)
def test_clip_flag_equals_jax(tmp_path, name, limited):
    """The film grain's clip_to_restricted_range flipped, at the bit the
    port's own film_grain_params parse gives (the last of the frame
    header: no length changes), in the file as coded and in the file set
    to limited range: the grain is clipped to 16..235 (luma) and 16..240
    (chroma) at the samples' depth, or no longer clipped, bit-equal to the
    JAX reader."""
    blob = (AVIF_DIR / name).read_bytes()
    if limited and "limited" not in name:
        blob = _limited(blob)
    edited = _flip(blob, _clip_bit)
    kind, why = _outcome(_write(tmp_path, edited))
    assert kind == "open", why


def test_clip_flag_changes_the_decode():
    """The flag is not idle: set on the limited-range superres grain file,
    it changes the JAX reader's decode."""
    blob = (AVIF_DIR / f"{PREFIX}grain_limited.avif").read_bytes()
    assert _digest(blob) != _digest(_flip(blob, _clip_bit))


def _flip_to(blob: bytes, want) -> bytes:
    """`blob` with the one bit of its colour item's first 48 bytes of AV1
    data flipped whose flip leaves the frame decoding with only its
    restoration unit sizes changed, to want(the parse's lr_size)."""
    obus = avif.parse(blob).color.tiles[0]
    before = _native.av1_frame_info(obus)
    for bit in range(8 * 48):
        b = bytearray(obus)
        b[bit >> 3] ^= 0x80 >> (bit & 7)
        try:
            after = _native.av1_frame_info(bytes(b))
        except ValueError:
            continue
        same = all(after[k] == before[k] for k in before if k != "lr_size")
        if same and after["lr_size"] == want(before["lr_size"]):
            return _flip(blob, lambda _: bit)
    raise AssertionError("no such bit")


@pytest.mark.parametrize("edit", ["chroma shift", "luma 256"])
@pytest.mark.parametrize("name", [f"{PREFIX}w17_d9.avif",
                                  f"{PREFIX}w31_d12.avif",
                                  f"{PREFIX}w40_d16.avif"])
def test_unit_size_edit_equals_jax(tmp_path, name, edit):
    """Restoration units libaom 3.6.0 does not write, set in the headers
    of frames of one unit a plane (so the units read stay the same):
    lr_uv_shift, which makes 4:2:0 chroma units of 64 samples, and
    lr_unit_extra_shift, which makes luma units of 256."""
    blob = (AVIF_DIR / name).read_bytes()
    if edit == "chroma shift":
        edited = _flip_to(blob, lambda s: (s[0], s[1] // 2, s[2] // 2))
    else:
        edited = _flip_to(blob, lambda s: (2 * s[0], 2 * s[1], 2 * s[2]))
    kind, why = _outcome(_write(tmp_path, edited))
    assert kind == "open", why


# ---------------------------------------------------------------------------
# onto the device (the CPU here), and the eighth band of the avif phase
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alg", ["average", "cubic", "nearest"])
@pytest.mark.parametrize("band", [1, 4])
def test_decimated_read_of_superres_file_equals_jax(alg, band):
    """The decimated read of a superres RGBA file's first and alpha
    bands."""
    _decimated_read_equals_jax(f"{PREFIX}rgba.avif", band, 40, 25, alg)


def test_superres_band_1024_equals_jax():
    """superres_band_file(1024): the eighth band's options on a 1024^2
    band (coded 512 wide in two tile columns, Wiener units, CDEF, an alpha
    item coded with superres too), bit-equal to the JAX reader, and what
    libaom 3.6.0 and libavif 0.11.1 write, where they are installed."""
    blob = BAND_1024.read_bytes()
    if avif_encode.available() and avif_encode.aom_available():
        assert superres_band_file(1024) == blob
    width, coded, denom, _, lr, _, units, cdef, _, _ = _info(blob)
    assert (width, coded, denom, cdef) == (1024, 512, 16, 1)
    assert lr[0] and units[1]
    got = _equal_to_jax(BAND_1024)
    assert got.shape == (1024, 1024, 4)


def test_superres_band_is_pillows():
    """The committed 9216^2 band (chip_smoke's avif phase, its eighth, where
    the port's decode is held to it): under 1 MB, and Pillow's decode
    hashes to AVIF_SUPERRES_BAND_SHA256 (the superres_band_file(1024) test
    holds the port to the JAX reader on the same options)."""
    blob = chip_smoke.AVIF_SUPERRES_BAND.read_bytes()
    assert len(blob) < 1 << 20
    p = avif.parse(blob)
    side = chip_smoke.AVIF_BAND_SIDE
    assert (p.width, p.height, p.alpha_size) == (side, side, (side, side))
    assert _digest(blob) == chip_smoke.AVIF_SUPERRES_BAND_SHA256
