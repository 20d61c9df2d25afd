"""The port's AVIF reader on 10- and 12-bit samples (io/avif.py over
_native/av1dec.cpp) against the JAX package's RasterReader, which opens the
same files through Pillow 12.1, libavif 1.3.0, dav1d 1.5.1 and libyuv into
8-bit RGB or RGBA, on the CPU: every band bit-equal (dtype included), and
RasterError where the JAX reader raises it. No tolerance anywhere.

Inputs are the committed files tests/data/avif/hbd_*.avif, written from
seeded arrays by Debian's libavif 0.11.1 through tests/avif_encode.py
(`depth_files`; re-encoded here where that library is installed, and held
equal byte for byte): aom 3.6.0 at 10 and 12 bits in each layout (4:2:0,
4:2:2, 4:4:4, 4:0:0) at full and limited range; the loop filter off, then
CDEF (`enable-cdef 1` at speed 4) and loop restoration (speeds 0 and 2:
self-guided and Wiener units) beside deblocking; `tune-content screen`
(palette blocks and intra block copy) on 4:2:0 and 4:4:4; `enable-qm 1`;
film grain (`denoise-noise-level 25` on speckle, `film-grain-test` 1 and
15: chroma offsets, chroma from luma); alpha items beside 4:2:0, 4:2:2,
4:4:4 and 4:0:0 ("LA"), speckled (palette blocks), premultiplied (`prem`);
odd sizes; rav1e 0.5.1 and SVT-AV1 1.4.1 at 10 bits 4:2:0; and lossless
sweeps of the sample values of each depth and layout (`sweep`), with and
without alpha, premultiplied on 4:4:4 and 4:0:0.

Beside them: the sweeps with their `colr` matrix and range set to each
value (which picks libavif's conversion: its float code at the samples'
depth, libyuv's 10-bit rows or its 12-bit 4:2:0 rows, or its 8-bit rows
after a shift, and how the alpha is narrowed to 8 bits), the range flipped
on the layout files, the alpha item edited (limited range, another depth,
`pixi`, `prem`), bit flips of a 10-bit and a 12-bit file, the decimated
read, and the 9216^2 12-bit band of chip_smoke's avif phase."""
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
from sarpro_tpu_torch.io import avif  # noqa: E402
from test_torch_avif import (  # noqa: E402
    AVIF_DIR,
    Items,
    _bit_flips,
    _box,
    _color_range_bit,
    _colr_outcome,
    _decimated_read_equals_jax,
    _outcome,
    _write,
    alpha_plane,
    footprint,
    scene,
    two_textures,
)
from test_torch_decoders import _equal_to_jax  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

DEPTH_PREFIX = chip_smoke.AVIF_DEPTH_PREFIX
LAYOUTS = ("4:2:0", "4:2:2", "4:4:4", "4:0:0")
# chroma subsampling (x, y) of each layout
SUB = {"4:2:0": (1, 1), "4:2:2": (1, 0), "4:4:4": (0, 0), "4:0:0": (1, 1)}
LF_OFF = {"loopfilter-control": "0", "enable-cdef": "0",
          "enable-restoration": "0"}
SCREEN = {"tune-content": "screen"}
NAMES = [n for n in chip_smoke.AVIF_FIXTURES if n.startswith(DEPTH_PREFIX)]
SWEEPS = [n for n in NAMES if n.startswith(DEPTH_PREFIX + "sweep_")]


def deep(a: np.ndarray, depth: int, seed: int) -> np.ndarray:
    """u8 samples widened to `depth` bits: their 8 bits on top, seeded
    bits below."""
    rng = np.random.default_rng(seed)
    s = depth - 8
    return (a.astype(np.int64) << s) | rng.integers(0, 1 << s, a.shape)


def deep_planes(a: np.ndarray, depth: int, layout: str, seed: int = 0):
    """Y, U, V of `depth` bits from a u8 RGB scene: Y of its first channel,
    U and V of the others subsampled to `layout` (None for 4:0:0)."""
    y = deep(a[..., 0], depth, seed)
    if layout == "4:0:0":
        return y, None, None
    sx, sy = SUB[layout]
    return (y, deep(a[::1 + sy, ::1 + sx, 1], depth, seed + 1),
            deep(a[::1 + sy, ::1 + sx, 2], depth, seed + 2))


def deep_alpha(a: np.ndarray, depth: int, seed: int = 3) -> np.ndarray:
    """A u8 alpha at `depth` bits, 0 and 255 kept at the ends of the
    range."""
    out = deep(a, depth, seed)
    out[a == 0] = 0
    out[a == 255] = (1 << depth) - 1
    return out


def sweep(depth: int, layout: str, alpha: bool = False,
          premultiplied: bool = False) -> bytes:
    """A 64 x 64 lossless file of every `depth`-bit luma value (a ramp in
    raster order; each value 4 times at 10 bits), chroma ramps over the
    whole range (U ascending, V descending along the other axis) and, with
    `alpha`, the luma ramp transposed and reversed as alpha (its first rows
    0, 1 and the maximum where `premultiplied`)."""
    m = (1 << depth) - 1
    n = 64
    y = np.arange(n * n).reshape(n, n) * (m + 1) // (n * n)
    sx, sy = SUB[layout]
    cw, ch = (n + sx) >> sx, (n + sy) >> sy
    k = np.arange(cw * ch).reshape(ch, cw) * (m + 1) // (cw * ch)
    u = v = None
    if layout != "4:0:0":
        u, v = k, m - (k.T if cw == ch else k[::-1, ::-1])
    a = None
    if alpha:
        a = m - y.T
        if premultiplied:
            a[:6], a[6:10], a[10:12] = 0, m, 1
    return avif_encode.encode(y, u, v, a, depth=depth, layout=layout,
                              quantizer=0, speed=6,
                              premultiplied=premultiplied)


def depth_files() -> dict:
    """The hbd_ files of tests/data/avif as libavif 0.11.1 writes them from
    chip_smoke's AVIF_SEED, in the order of chip_smoke.AVIF_FIXTURES."""
    enc = avif_encode.encode
    s = chip_smoke.AVIF_SEED
    base = scene(s, 67, 130)
    big = scene(s + 2, 129, 257)
    textures = two_textures(s + 20, 128, 256)
    patch = scene(s, 37, 41)
    sar = chip_smoke.avif_band_u8(192)
    out = {}
    for depth in (10, 12):
        d = f"{DEPTH_PREFIX}{depth}"
        for layout in LAYOUTS:
            tag = layout.replace(":", "")
            for full in (True, False):
                out[f"{d}_{tag}_{'full' if full else 'limited'}.avif"] = enc(
                    *deep_planes(base, depth, layout), depth=depth,
                    layout=layout, full=full, quantizer=30)
        out[f"{d}_lf0.avif"] = enc(*deep_planes(base, depth, "4:2:0"),
                                   depth=depth, quantizer=30, options=LF_OFF)
        out[f"{d}_cdef_s4.avif"] = enc(*deep_planes(big, depth, "4:2:0"),
                                       depth=depth, quantizer=30, speed=4,
                                       options={"enable-cdef": "1"})
        for speed in (0, 2):
            out[f"{d}_lr_s{speed}.avif"] = enc(
                *deep_planes(textures, depth, "4:2:0"), depth=depth,
                quantizer=40, speed=speed,
                options={"enable-restoration": "1"})
        # periodic content (tiles of one patch, its low bits tiled too)
        y, u, v = deep_planes(patch, depth, "4:4:4")
        tiled = [np.tile(p, (6, 6))[:200, :240] for p in (y, u, v)]
        out[f"{d}_screen_420.avif"] = enc(
            tiled[0], tiled[1][::2, ::2], tiled[2][::2, ::2], depth=depth,
            quantizer=30, options=SCREEN)
        out[f"{d}_screen_444.avif"] = enc(*tiled, depth=depth,
                                          layout="4:4:4", quantizer=30,
                                          options=SCREEN)
        out[f"{d}_qm.avif"] = enc(*deep_planes(base, depth, "4:2:0"),
                                  depth=depth, quantizer=30, options={
                                      "enable-qm": "1", "qm-min": "2",
                                      "qm-max": "6"})
        out[f"{d}_grain.avif"] = enc(
            *deep_planes(np.dstack([sar] * 3), depth, "4:2:0"), depth=depth,
            quantizer=40, options={"denoise-noise-level": "25"})
        # aom's test vectors 1 (chroma offsets and multipliers) and 15
        # (chroma scaled from luma)
        for vector in (1, 15):
            out[f"{d}_fg{vector}.avif"] = enc(
                *deep_planes(base, depth, "4:2:0"), depth=depth,
                quantizer=30, options={"film-grain-test": str(vector)})
        alpha = deep_alpha(alpha_plane(67, 130), depth)
        for layout in LAYOUTS:
            name = "la" if layout == "4:0:0" else \
                f"rgba_{layout.replace(':', '')}"
            out[f"{d}_{name}.avif"] = enc(*deep_planes(base, depth, layout),
                                          alpha, depth=depth, layout=layout,
                                          quantizer=30)
        out[f"{d}_rgba_speckled.avif"] = enc(
            *deep_planes(base, depth, "4:2:0"),
            deep_alpha(alpha_plane(67, 130, s), depth), depth=depth,
            quantizer=30)
        for layout, name in (("4:2:0", "prem_420"), ("4:0:0", "prem_la")):
            out[f"{d}_{name}.avif"] = enc(*deep_planes(base, depth, layout),
                                          alpha, depth=depth, layout=layout,
                                          quantizer=30, premultiplied=True)
        for rows, cols in ((5, 7), (129, 257)):
            out[f"{d}_size_{cols}x{rows}.avif"] = enc(
                *deep_planes(scene(s + rows, rows, cols), depth, "4:2:0"),
                depth=depth, quantizer=30)
    small = deep_planes(scene(s + 3, 64, 96), 10, "4:2:0")
    out[f"{DEPTH_PREFIX}rav1e_420.avif"] = enc(*small, codec="rav1e",
                                               quantizer=30)
    out[f"{DEPTH_PREFIX}svt_420.avif"] = enc(*small, codec="svt", speed=8,
                                             quantizer=30)
    for depth in (10, 12):
        for layout in LAYOUTS:
            tag = f"{DEPTH_PREFIX}sweep_{depth}_{layout.replace(':', '')}"
            out[f"{tag}.avif"] = sweep(depth, layout)
            out[f"{tag}_a.avif"] = sweep(depth, layout, alpha=True)
        for layout in ("4:4:4", "4:0:0"):
            out[f"{DEPTH_PREFIX}sweep_{depth}_{layout.replace(':', '')}"
                "_prem.avif"] = sweep(depth, layout, True, True)
    return out


def _digest(blob: bytes) -> str:
    with Image.open(io.BytesIO(blob)) as im:
        return hashlib.sha256(np.asarray(im).tobytes()).hexdigest()


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------
def test_depth_fixtures_are_written():
    """tests/data/avif's hbd_ files open in Pillow to the SHA-256
    chip_smoke pins (AVIF_FIXTURES), and, where libavif 0.11.1 is
    installed, are what depth_files() writes, byte for byte."""
    on_disk = sorted(p.name for p in AVIF_DIR.glob(DEPTH_PREFIX + "*"))
    assert on_disk == sorted(NAMES)
    for name in NAMES:
        assert _digest((AVIF_DIR / name).read_bytes()) == \
            chip_smoke.AVIF_FIXTURES[name], name
    if avif_encode.available():
        files = depth_files()
        assert list(files) == NAMES
        for name, blob in files.items():
            assert (AVIF_DIR / name).read_bytes() == blob, name


def test_depth_fixtures_hold_their_tools():
    """What each file is there for is in it: the depth and layout its name
    says (the sequence header's), `prem` where named, and an alpha item
    beside each rgba_, la, prem_ and _a file."""
    for name in NAMES:
        blob = (AVIF_DIR / name).read_bytes()
        p = avif.parse(blob)
        av1c = blob[blob.find(b"av1C") + 6]
        depth = 12 if av1c & 0x20 else 10 if av1c & 0x40 else 8
        assert depth == (12 if "_12_" in name else 10), name
        with_alpha = any(k in name for k in ("rgba", "_la", "prem", "_a."))
        assert (p.alpha is not None) == with_alpha, name
        assert p.premultiplied == ("prem" in name), name
        layout = "400" if av1c & 0x10 else "444" if not av1c & 0x0C else \
            "422" if av1c & 0x08 and not av1c & 0x04 else "420"
        for tag in ("420", "422", "444", "400"):
            if f"_{tag}" in name:
                assert layout == tag, name
        if "_la" in name:
            assert layout == "400", name


@pytest.mark.parametrize("name", NAMES)
def test_depth_fixture_equals_jax(name):
    """Each file opens in the port as in the JAX reader, bit for bit: RGB,
    or RGBA where it has an alpha item."""
    got = _equal_to_jax(AVIF_DIR / name)
    with Image.open(AVIF_DIR / name) as im:
        assert got.shape[-1] == len(im.mode)


# ---------------------------------------------------------------------------
# the conversion to 8-bit RGB(A)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("limited", [False, True], ids=["full", "limited"])
@pytest.mark.parametrize("matrix", [0, 1, 2, 5, 6, 9, 12])
@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_colr_equals_jax(tmp_path, name, matrix, limited):
    """Every sample value through libavif's conversion at each `colr`
    matrix and range: the float code at the samples' depth for monochrome
    RGB and the identity matrix (dividing by alpha in float where `prem`
    asks), libyuv's 10-bit rows for 10-bit RGBA (the luma widened by
    repeating its bits, the chroma upsampled at 10 bits, then shifted),
    its 12-bit rows with nearest chroma for 12-bit 4:2:0 RGBA, else the
    samples shifted down to 8 bits and converted as 8-bit ones; the alpha
    shifted where libyuv's rows convert, else narrowed in float. Identity
    on subsampled colour is refused by both; matrix 12 is named."""
    b = bytearray((AVIF_DIR / name).read_bytes())
    k = b.find(b"colrnclx") + 8
    b[k + 4:k + 6] = struct.pack(">H", matrix)
    if limited:
        b[k + 6] ^= 0x80
    kind, why = _outcome(_write(tmp_path, bytes(b)))
    assert kind == _colr_outcome(name, matrix, limited), why
    if kind == "not yet":
        assert f"AV1 YUV matrix {matrix} is" in why


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if n.endswith(("_full.avif",
                                                 "_limited.avif"))])
def test_colr_range_flag_of_depth_file_equals_jax(tmp_path, name):
    """The nclx range flag flipped on each layout file: libavif takes the
    `colr` box's range over the sequence header's at every depth."""
    b = bytearray((AVIF_DIR / name).read_bytes())
    b[b.find(b"colrnclx") + 8 + 6] ^= 0x80
    kind, why = _outcome(_write(tmp_path, bytes(b)))
    assert kind == "open", why


def test_identity_of_premultiplied_8bit_limited_equals_jax(tmp_path):
    """An 8-bit 4:4:4 file with `prem` read as the identity matrix in
    limited range: libavif takes its float code, which divides by alpha in
    float, not libyuv's unattenuate (as at 10 and 12 bits)."""
    b = bytearray((AVIF_DIR / "prem_rgba_444.avif").read_bytes())
    k = b.find(b"colrnclx") + 8
    b[k + 4:k + 6] = struct.pack(">H", 0)
    b[k + 6] &= 0x7F
    kind, why = _outcome(_write(tmp_path, bytes(b)))
    assert kind == "open", why


# ---------------------------------------------------------------------------
# the alpha item
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [f"{DEPTH_PREFIX}{d}_{k}.avif"
                                  for d in (10, 12)
                                  for k in ("rgba_420", "la")])
def test_limited_range_alpha_of_depth_is_widened(tmp_path, name):
    """An alpha item whose sequence header says limited range: libavif
    widens it at its depth (avifLimitedToFullY), then narrows it to 8
    bits."""
    f = Items((AVIF_DIR / name).read_bytes())
    b = bytearray(f.data[2])
    bit = _color_range_bit(bytes(b))
    assert b[bit >> 3] >> (7 - (bit & 7)) & 1  # written in full range
    b[bit >> 3] ^= 0x80 >> (bit & 7)
    f.data[2] = bytes(b)
    got = _equal_to_jax(_write(tmp_path, f.build()))
    plain = avif.read((AVIF_DIR / name).read_bytes()).load().array
    assert not np.array_equal(got[..., 3], plain[..., 3])
    assert np.array_equal(got[..., :3], plain[..., :3])


def _depth_alpha_cases() -> dict:
    """Name -> (file, edit of Items, the outcome both readers agree on)."""
    def alpha_of(name):
        def edit(f):
            f.data[2] = Items((AVIF_DIR / name).read_bytes()).data[2]
        return edit

    def pixi(depth):
        return lambda f: f.prop(b"pixi", bytes([0, 0, 0, 0, 1, depth]), 2)

    def prem(f):
        f.refs += _box(b"prem", struct.pack(">HHH", 1, 1, 2))

    d10, d12 = f"{DEPTH_PREFIX}10_", f"{DEPTH_PREFIX}12_"
    return {
        "8-bit alpha beside 10": (d10 + "rgba_420.avif",
                                  alpha_of("rgba_420.avif"), "refused"),
        "10-bit alpha beside 8": ("rgba_420.avif",
                                  alpha_of(d10 + "rgba_420.avif"), "refused"),
        "10-bit alpha beside 12": (d12 + "rgba_420.avif",
                                   alpha_of(d10 + "rgba_420.avif"),
                                   "refused"),
        "pixi of 8 bits": (d10 + "rgba_444.avif", pixi(8), "refused"),
        "pixi of its depth": (d12 + "rgba_444.avif", pixi(12), "open"),
        "colour data": (d12 + "rgba_422.avif",
                        lambda f: f.data.__setitem__(2, f.data[1]), "open"),
        "prem 10": (d10 + "rgba_444.avif", prem, "open"),
        "prem 12": (d12 + "rgba_444.avif", prem, "open"),
        "prem on gray 12": (d12 + "la.avif", prem, "open"),
    }


@pytest.mark.parametrize("case", list(_depth_alpha_cases()))
def test_alpha_item_of_depth_equals_jax(tmp_path, case):
    """Alpha items edited beside 10- and 12-bit colour: an alpha of another
    depth than the colour fails (libavif: "Decoding of alpha plane
    failed"), a `pixi` other than the `av1C` depth fails the parse, the
    colour item's AV1 data as alpha gives its luma, and a `prem` reference
    added has the colour unpremultiplied."""
    name, edit, want = _depth_alpha_cases()[case]
    f = Items((AVIF_DIR / name).read_bytes())
    edit(f)
    kind, why = _outcome(_write(tmp_path, f.build()))
    assert kind == want, why


# ---------------------------------------------------------------------------
# corrupt files
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", range(3))
def test_bit_flips_of_10bit_file_agree_with_jax(tmp_path, chunk):
    """150 single-bit flips of a 10-bit 4:4:4 file with an alpha item (50
    a case), anywhere in it."""
    _bit_flips(tmp_path, f"{DEPTH_PREFIX}10_rgba_444.avif", 2500 + chunk)


@pytest.mark.parametrize("chunk", range(3))
def test_bit_flips_of_12bit_file_agree_with_jax(tmp_path, chunk):
    """150 single-bit flips in the headers (the first 48 bytes of the AV1
    data) of a 12-bit file with deblocking and Wiener restoration on: a
    flipped filter level or strength reads with other filtering,
    bit-equal to the JAX reader's."""
    _bit_flips(tmp_path, f"{DEPTH_PREFIX}12_lr_s2.avif", 2600 + chunk,
               head=48)


# ---------------------------------------------------------------------------
# onto the device (the CPU here), and the avif phase's 12-bit band
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alg", ["average", "cubic", "nearest"])
@pytest.mark.parametrize("band", [1, 4])
def test_decimated_read_of_depth_file_equals_jax(alg, band):
    """The decimated read of a 12-bit "LA" file's gray and alpha bands."""
    _decimated_read_equals_jax(f"{DEPTH_PREFIX}12_la.avif", band, 40, 25,
                               alg)


def depth_band_file() -> bytes:
    """chip_smoke.AVIF_DEPTH_BAND as libavif 0.11.1 writes it: make_safe's
    DN at AVIF_BAND_SIDE^2 clipped to 12 bits (0 outside footprint()),
    12-bit 4:0:0 at quantizer AVIF_DEPTH_BAND_QUANTIZER, speed 6, 4 x 4
    tiles, with footprint() at 12 bits as its alpha item (lossless)."""
    side = chip_smoke.AVIF_BAND_SIDE
    y = np.minimum(chip_smoke.formats_dn(chip_smoke.AVIF_SEED, side, side),
                   4095)
    inside = footprint(side) > 0
    y[~inside] = 0
    return avif_encode.encode(
        y, alpha=np.where(inside, 4095, 0), depth=12, layout="4:0:0",
        quantizer=chip_smoke.AVIF_DEPTH_BAND_QUANTIZER, alpha_quantizer=0,
        speed=6, tiles_log2=(2, 2), threads=8)


def test_depth_band_equals_pillows_decode():
    """The committed 9216^2 12-bit band (chip_smoke's avif phase): 4:0:0
    with a 12-bit alpha item, under 2 MB; Pillow opens it as RGBA, and the
    port's decode and Pillow's both hash to AVIF_DEPTH_BAND_SHA256."""
    blob = chip_smoke.AVIF_DEPTH_BAND.read_bytes()
    assert len(blob) < 2 << 20
    assert blob[blob.find(b"av1C") + 6] & 0x70 == 0x70  # 12-bit 4:0:0
    p = avif.parse(blob)
    side = chip_smoke.AVIF_BAND_SIDE
    assert (p.width, p.height, p.alpha_size) == (side, side, (side, side))
    with Image.open(io.BytesIO(blob)) as im:
        assert im.mode == "RGBA"
        want = hashlib.sha256(np.asarray(im).tobytes()).hexdigest()
    assert want == chip_smoke.AVIF_DEPTH_BAND_SHA256
    got = avif.read(blob).load().array
    assert hashlib.sha256(got.tobytes()).hexdigest() == want
    assert np.array_equal(got[..., 0], got[..., 2])
    assert set(np.unique(got[..., 3])) == {0, 255}
