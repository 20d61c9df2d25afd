"""The JPEG 2000 files the JAX reader opens and the port once refused, held
to the JAX package's RasterReader (Pillow 12.1 -> OpenJPEG 2.5.4) on the
CPU: every file decodes bit for bit to the JAX reader's array (dtype, size
and metadata too) or is refused by both. No tolerance anywhere.

  * components sub-sampled ((1,1)/(2,2)/(2,2), (1,1)/(2,1)/(2,1), (2,2) x
    3, (1,1)/(1,2)/(3,1), (1,1)/(1,1)/(2,2); alpha planes; gray ones, which Pillow has no
    unpacker for), at even and odd sizes and origins, with and without
    tiles, 5/3 and 9/7, as codestreams (Pillow guesses sYCC where the first
    sub-sampled component is the second or third) and as JP2s of sRGB or
    sYCC. Pillow's unpackers read OpenJPEG's tile buffer at strides W / dx
    and offsets (W / dx) * (H / dy) that are not the sizes OpenJPEG wrote
    at odd sizes: the array is not an up-sampling of the planes;
  * sYCC without sub-sampling, through Pillow's fixed-point YCbCr to RGB;
  * precisions of 17 to 31 bits, signed and unsigned, for L (I;16), LA,
    RGB and RGBA, the samples at the top of the range wrapping in Pillow's
    stores; 32 to 38 bits, which OpenJPEG's encoder writes and its decoder
    refuses;
  * `pclr` palettes of 1, 2, 4, 5 and 6 columns on L and LA;
  * Rsiz's Part-2 and HTJ2K bits and CAP segments over Part-1 code-blocks;
  * the Part-2 component transform OpenJPEG writes (opj_set_MCT), and an
    RCT over components of unequal size, which both refuse.

The codestreams come from OpenJPEG 2.5.4's own encoder (tests/opj_encode.py)
and the JP2 boxes from tests/test_torch_jpeg2000.py. One test reads a
sub-sampled file in a fresh process: Pillow's array is the same there."""
import hashlib
import io
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import opj_encode as oe  # noqa: E402
from PIL import Image  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu_torch.io import jpeg2000  # noqa: E402
from test_torch_decoders import _both_refuse, _equal_to_jax  # noqa: E402
from test_torch_jpeg2000 import (  # noqa: E402
    _encode,
    _insert_main_marker,
    _jp2,
    _pclr,
    _rsiz,
    _scene,
    _write,
)
from test_torch_jpeg2000_styles import _held_to_jax  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# "cr 2x2": the first sub-sampled component is the third, where Pillow
# guesses sYCC for a codestream as it does for the second
PATTERNS = {"420": [(1, 1), (2, 2), (2, 2)], "422": [(1, 1), (2, 1), (2, 1)],
            "all 2x2": [(2, 2)] * 3, "1-2 3-1": [(1, 1), (1, 2), (3, 1)],
            "cr 2x2": [(1, 1), (1, 1), (2, 2)]}
# the codestream alone (Pillow's guess), OpenJPEG's JP2 of sRGB, of sYCC
CONTAINERS = {"j2k": {}, "jp2 srgb": {"jp2": True, "colour_space": "srgb"},
              "jp2 sycc": {"jp2": True, "colour_space": "sycc"}}


def _subsampled(rng, pattern, shape, **kw) -> bytes:
    """OpenJPEG's codestream (or JP2) of an image of `shape` with its
    components sub-sampled by `pattern`; 2 resolutions, as OpenJPEG's
    encoder refuses more at these sizes."""
    a = _scene(rng, shape + (len(pattern),))
    kw.setdefault("resolutions", 2)
    return oe.encode(a, subsampling=pattern, **kw)


@pytest.mark.parametrize("container", list(CONTAINERS))
@pytest.mark.parametrize("irreversible", [False, True], ids=["5-3", "9-7"])
@pytest.mark.parametrize("tiles", [False, True], ids=["one tile", "tiles"])
@pytest.mark.parametrize("shape", [(24, 32), (25, 33), (37, 50)],
                         ids=["24x32", "25x33", "37x50"])
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_subsampled_rgb_equals_jax(tmp_path, rng, pattern, shape, tiles,
                                   irreversible, container):
    kw = dict(CONTAINERS[container], irreversible=irreversible)
    if tiles:
        # no tile 1 px wide, which OpenJPEG's 9/7 encoder aborts on
        kw["tile"] = (12, 16)
    code = _subsampled(rng, PATTERNS[pattern], shape, **kw)
    got = _held_to_jax(tmp_path, code,
                       "s.jp2" if kw.get("jp2") else "s.j2k")
    assert got is not None and got.shape == shape + (3,)


def test_subsampled_is_not_an_upsampling_at_odd_sizes(tmp_path, rng):
    """At 25 x 33 Pillow's sRGB unpacker reads the 13 x 17 planes of the
    2 x 2 components at strides of 16 words: the port's array (the JAX
    reader's) differs from the planes up-sampled by replication, which it
    equals at 24 x 32 (ROADMAP queue 3)."""
    for shape, same in (((24, 32), True), ((25, 33), False)):
        a = _scene(rng, shape + (3,))
        code = oe.encode(a, subsampling=PATTERNS["420"], resolutions=2,
                         jp2=True, colour_space="srgb")
        got = _held_to_jax(tmp_path, code, "u.jp2")
        up = np.stack([a[..., 0]] + [
            np.repeat(np.repeat(a[::2, ::2, c], 2, 0), 2, 1)[:shape[0],
                                                             :shape[1]]
            for c in (1, 2)], -1)
        assert np.array_equal(got, up) == same


@pytest.mark.parametrize("origin", [(1, 0), (0, 3), (5, 7)],
                         ids=["x 1", "y 3", "x 5 y 7"])
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_subsampled_at_odd_origins_equals_jax(tmp_path, rng, pattern,
                                              origin):
    """Image origins off the sub-sampling grid, one tile and tiles of 16:
    a tile-component then holds fewer samples than Pillow's W / dx reads,
    which run on past them into the buffer Pillow zeroed."""
    for tile in (None, (16, 16)):
        code = _subsampled(rng, PATTERNS[pattern], (29, 35), origin=origin,
                           tile=tile)
        assert _held_to_jax(tmp_path, code) is not None


@pytest.mark.parametrize("prog", ["RPCL", "PCRL", "CPRL"])
@pytest.mark.parametrize("pattern", ["420", "1-2 3-1"])
def test_subsampled_progressions_equal_jax(tmp_path, rng, pattern, prog):
    """The position-driven progressions over tiles of sub-sampled
    components (pi.c's steps of dx << (PPx + levels))."""
    code = _subsampled(rng, PATTERNS[pattern], (40, 56), tile=(32, 16),
                       progression=prog, resolutions=3, rates=[20, 0])
    assert _held_to_jax(tmp_path, code) is not None


def test_subsampled_short_of_the_last_resolution_equals_jax(tmp_path, rng):
    """A POC whose packets stop below the last resolution: OpenJPEG hands
    over the sub-sampled planes at that resolution, packed, and Pillow
    reads its own layout of them."""
    for pattern in ("420", "all 2x2"):
        code = _subsampled(rng, PATTERNS[pattern], (33, 40), resolutions=3,
                           pocs=[(0, 0, 1, 2, 3, "LRCP")])
        assert _held_to_jax(tmp_path, code) is not None


ALPHA_PATTERNS = {"ycc 420 alpha": [(1, 1), (2, 2), (2, 2), (1, 1)],
                  "alpha 2x2": [(1, 1), (1, 1), (1, 1), (2, 2)],
                  "all 2x2": [(2, 2)] * 4}


@pytest.mark.parametrize("shape", [(24, 32), (25, 33)], ids=["even", "odd"])
@pytest.mark.parametrize("pattern", list(ALPHA_PATTERNS))
def test_subsampled_rgba_equals_jax(tmp_path, rng, pattern, shape):
    """Four components: sYCC with alpha (j2ku_sycca_rgba) where the second
    is the first sub-sampled, else sRGB with alpha; also as RGB from a JP2
    header of three components, and as CMYK."""
    code = _subsampled(rng, ALPHA_PATTERNS[pattern], shape)
    assert _held_to_jax(tmp_path, code).shape == shape + (4,)
    for enumcs in (None, 16, 18):
        got = _held_to_jax(tmp_path, _jp2(code, shape, 3, 8, enumcs),
                           "a.jp2")
        assert got.shape == shape + (3,)
    got = _held_to_jax(tmp_path, _jp2(code, shape, 4, 8, 12), "c.jp2")
    assert got.shape == shape + (4,)


@pytest.mark.parametrize("mode", ["L", "LA", "I;16", "RGB from L"])
def test_subsampled_gray_is_refused_as_by_jax(tmp_path, rng, mode):
    """Pillow's unpackers of one or two components take no sub-sampled
    component: L, LA, I;16 and RGB from a gray component are refused by
    both readers."""
    nc = 2 if mode == "LA" else 1
    steps = [(1, 1), (2, 2)] if mode == "LA" else [(2, 2)]
    a = _scene(rng, (24, 32, nc))
    if mode == "I;16":
        a = a.astype(np.uint16) << 4
    code = oe.encode(a, subsampling=steps, resolutions=2,
                     prec=12 if mode == "I;16" else 8)
    if mode == "RGB from L":
        code = _jp2(code, (24, 32), 3, 8, 17)
    _both_refuse(_write(tmp_path, code, "g.jp2" if mode == "RGB from L"
                        else "g.j2k"))


def test_rct_over_unequal_components_is_refused_as_by_jax(tmp_path, rng):
    """OpenJPEG's encoder drops the RCT over components of unequal size; a
    COD patched to ask for it: opj_tcd_mct_decode refuses, and so does the
    port."""
    code = _subsampled(rng, PATTERNS["420"], (24, 32), mct=0)
    pos = code.index(b"\xff\x52")
    assert code[pos + 8] == 0  # SGcod's component transform
    code = code[:pos + 8] + b"\x01" + code[pos + 9:]
    _both_refuse(_write(tmp_path, code, "m.j2k"), "different sizes")


def test_subsampled_read_is_the_same_in_a_fresh_process(tmp_path, rng):
    """Pillow's array of an odd-sized sub-sampled file in a new process
    (nothing decoded before it), in this one after other decodes, and the
    port's: one SHA-256."""
    code = _subsampled(rng, PATTERNS["1-2 3-1"], (37, 50), tile=(16, 16),
                       origin=(5, 7))
    path = _write(tmp_path, code, "d.j2k")
    script = ("import hashlib, sys, numpy as np; from PIL import Image; "
              "print(hashlib.sha256(np.asarray(Image.open(sys.argv[1]))"
              ".tobytes()).hexdigest())")
    fresh = subprocess.run([sys.executable, "-c", script, str(path)],
                           capture_output=True, text=True, check=True)
    Image.open(io.BytesIO(_encode(_scene(rng, (40, 40, 3)), "RGB",
                                  no_jp2=True))).load()
    here = hashlib.sha256(np.asarray(Image.open(path)).tobytes()).hexdigest()
    port = hashlib.sha256(jpeg2000.read(code).array.tobytes()).hexdigest()
    assert fresh.stdout.strip() == here == port


# ---------------------------------------------------------------------------
# sYCC without sub-sampling
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("irreversible", [False, True], ids=["5-3", "9-7"])
@pytest.mark.parametrize("nc", [3, 4])
def test_sycc_jp2_equals_jax(tmp_path, rng, nc, irreversible):
    """OpenJPEG's JP2 of sYCC (no component transform): Pillow unpacks it
    as sRGB and runs its YCbCr conversion on each row; every Y, Cb, Cr
    byte value occurs."""
    a = np.zeros((32, 40, nc), np.uint8)
    a[..., :3] = rng.integers(0, 256, (32, 40, 3))
    a.reshape(-1, nc)[:256, :3] = np.arange(256)[:, None]
    if nc == 4:
        a[..., 3] = rng.integers(0, 256, (32, 40))
    code = oe.encode(a, jp2=True, colour_space="sycc", mct=0,
                     irreversible=irreversible, resolutions=3)
    got = _held_to_jax(tmp_path, code, "y.jp2")
    if not irreversible:
        want = np.asarray(Image.fromarray(a[..., :3], "YCbCr").convert("RGB"))
        assert np.array_equal(got[..., :3], want)


# ---------------------------------------------------------------------------
# precisions above 16 bits
# ---------------------------------------------------------------------------
MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _deep(rng, prec, signed, nc, shape=(20, 24)):
    """Samples of `prec` bits over the whole range, the first row holding
    its bottom and top and the values whose rounding offset wraps Pillow's
    store."""
    lo, hi = ((-(1 << (prec - 1)), 1 << (prec - 1)) if signed
              else (0, 1 << prec))
    a = rng.integers(lo, hi, shape + (nc,), dtype=np.int64)
    top = [lo, hi - 1, hi - 2, lo + 1, hi - (1 << max(prec - 17, 0)),
           hi - (1 << max(prec - 9, 0)), (lo + hi) // 2]
    a[0, :len(top)] = np.array(top)[:, None]
    return a


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("prec", range(17, 32))
@pytest.mark.parametrize("mode", list(MODES))
def test_deep_precision_equals_jax(tmp_path, rng, mode, prec, signed):
    """17 to 31 bits, 5/3: I;16 for one component (shifted down by prec -
    16 with the unpacker's rounding offset), 8 bits for the others; the
    stores wrap at the top of the range."""
    a = _deep(rng, prec, signed, MODES[mode])
    code = oe.encode(a, prec=prec, signed=signed, resolutions=3)
    got = _held_to_jax(tmp_path, code, "p.j2k")
    assert got.dtype == (np.uint16 if mode == "L" else np.uint8)


@pytest.mark.parametrize("prec", [17, 20, 24, 28, 31])
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_deep_precision_97_equals_jax(tmp_path, rng, mode, prec):
    """The 9/7 at 17 to 31 bits: floats bit-equal to OpenJPEG's, in a JP2
    too."""
    a = _deep(rng, prec, False, MODES[mode])
    code = oe.encode(a, prec=prec, irreversible=True, resolutions=3,
                     tile=(16, 16))
    _held_to_jax(tmp_path, code, "p.j2k")
    _held_to_jax(tmp_path, _jp2(code, (20, 24), MODES[mode], prec,
                                17 if mode == "L" else 16), "p.jp2")


@pytest.mark.parametrize("prec", range(32, 39))
def test_precision_past_31_bits_is_refused_as_by_jax(tmp_path, rng, prec):
    """SIZ allows 38 bits and OpenJPEG's encoder writes them; its decoder
    takes 31 at most: both readers refuse."""
    a = _deep(rng, 31, False, 1)
    code = oe.encode(a, prec=prec, resolutions=2)
    assert code[42] == prec - 1
    _both_refuse(_write(tmp_path, code, "x.j2k"), "above 31 bits")


# ---------------------------------------------------------------------------
# pclr palettes of other than three columns
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("entries", ["200", "50 repeated", "300"])
@pytest.mark.parametrize("npc", [1, 2, 4, 5, 6])
@pytest.mark.parametrize("mode", ["L", "LA"])
def test_palette_widths_equal_jax(tmp_path, rng, mode, npc, entries):
    """Pillow's palette of a pclr box of `npc` columns: an RGBA palette of
    four (expanded to RGB through its first three), else an RGB one whose
    getcolor places an entry of one or two bytes at index 0 (a palette of
    no colour: black), of five or six at every len // 3 (each colour's
    first bytes), refusing past 256; on LA (PA) the indices and alpha."""
    n = MODES[mode]
    a = rng.integers(0, 200, (12, 17, n)).astype(np.uint8)
    code = _encode(a[..., 0] if n == 1 else a, mode, no_jp2=True)
    count = 300 if entries == "300" else 200
    rows = [tuple((37 * i + 11 * k) % 256 for k in range(npc))
            for i in range(count)]
    if entries == "50 repeated":
        rows = [rows[i % 50] for i in range(count)]
    path = _write(tmp_path, _jp2(code, (12, 17), n, 8, 16,
                                 _pclr(rows, npc=npc)))
    try:
        jraster.RasterReader(path).close()
    except jraster.RasterError:
        _both_refuse(path)
        return
    got = _equal_to_jax(path)
    if mode == "L" and npc in (1, 2):
        assert not got.any()


def test_palette_of_nine_bit_entries_equals_jax(tmp_path, rng):
    """Columns of 9 bits (Ssiz 8): Pillow still builds its palette, from
    one byte a value of the two OpenJPEG reads; signed 8-bit columns (Ssiz
    0x87) leave the mode L."""
    a = rng.integers(0, 100, (12, 17)).astype(np.uint8)
    code = _encode(a, "L", no_jp2=True)
    rows = [(i, 3 * i, 500 - i) for i in range(100)]
    deep = _pclr(rows, depth=9)
    signed = bytearray(_pclr([(i, 2 * i, 255 - i) for i in range(100)]))
    signed[8 + 3:8 + 6] = b"\x87\x87\x87"
    for extra, colr in ((deep, 16), (bytes(signed), 16), (bytes(signed), 17)):
        path = _write(tmp_path, _jp2(code, (12, 17), 1, 8, colr, extra))
        try:
            jraster.RasterReader(path).close()
        except jraster.RasterError:
            _both_refuse(path)
            continue
        _equal_to_jax(path)


# ---------------------------------------------------------------------------
# Part-2 and HTJ2K signalling over Part-1 code-blocks
# ---------------------------------------------------------------------------
SIGNALS = {
    "rsiz 0x8000": lambda c: _rsiz(c, 0x8000),
    "rsiz 0x4000": lambda c: _rsiz(c, 0x4000),
    "rsiz 0xC000": lambda c: _rsiz(c, 0xC000),
    "cap": lambda c: _insert_main_marker(
        c, struct.pack(">HHIH", 0xFF50, 8, 0x00020000, 0)),
    "cap empty": lambda c: _insert_main_marker(
        c, struct.pack(">HH", 0xFF50, 2)),
    "cap two ccap": lambda c: _insert_main_marker(
        c, struct.pack(">HHIHH", 0xFF50, 10, 0x00020002, 0, 5)),
}


@pytest.mark.parametrize("coding", ["5-3 420", "9-7 tiles", "u16"])
@pytest.mark.parametrize("signal", list(SIGNALS))
def test_part2_and_ht_signalling_equals_jax(tmp_path, rng, signal, coding):
    """OpenJPEG decodes Part-1 code-blocks whatever Rsiz's capability bits
    say, and skips a CAP segment (opj_j2k_read_cap reads nothing): the
    port too. Only HT code-block styles stay refused."""
    if coding == "5-3 420":
        code = _subsampled(rng, PATTERNS["420"], (25, 33))
    elif coding == "9-7 tiles":
        code = oe.encode(_scene(rng, (40, 48, 3)), irreversible=True,
                         tile=(32, 32), resolutions=3)
    else:
        code = oe.encode(_deep(rng, 16, False, 1)[..., 0].astype(np.uint16),
                         resolutions=3)
    got = _held_to_jax(tmp_path, SIGNALS[signal](code))
    assert got is not None


def test_part2_component_transform_is_refused_as_by_jax(tmp_path, rng):
    """The only Part-2 feature OpenJPEG's encoder writes: a custom
    component transform (opj_set_MCT: Rsiz 0x8100, CBD / MCT / MCC / MCO
    segments and a COD asking for transform 2). OpenJPEG's decoder refuses
    its own file, so the JAX reader does; the port refuses the markers by
    name."""
    matrix = [[0.5, 0.25, 0.25], [0, 1, 0], [-0.25, 0, 1]]
    for irreversible in (False, True):
        code = oe.encode(_scene(rng, (32, 40, 3)), mct_matrix=matrix,
                         irreversible=irreversible)
        assert struct.unpack_from(">H", code, 6)[0] == 0x8100
        _both_refuse(_write(tmp_path, code, "t.j2k"), "Part-2")


# ---------------------------------------------------------------------------
# the committed codestreams of chip_smoke.py's jpeg2000 phase
# ---------------------------------------------------------------------------
def subsampling_fixtures() -> dict:
    """tests/data/jpeg2000's sub-sampled and deep tiles, as OpenJPEG writes
    them from their seeds: (a) the sYCC 4:2:0 tile, 9/7 at 20:1, one 256^2
    tile; (b) the 20-bit amplitude tile, lossless, one 256^2 tile."""
    return {
        chip_smoke.J2K_SYCC: oe.encode(
            chip_smoke.j2k_sycc_tile(), subsampling=PATTERNS["420"],
            irreversible=True, rates=[20], tile=(256, 256),
            colour_space="sycc"),
        chip_smoke.J2K_DEEP: oe.encode(
            chip_smoke.j2k_deep_tile(), prec=20, tile=(256, 256)),
    }


def _fixture_jp2(name: str, code: bytes, nx: int = 1, ny: int = 1) -> bytes:
    """chip_smoke.py's JP2 of a fixture spliced nx x ny times: sYCC over
    three components, gray over the 20-bit one."""
    side = 256
    sycc = name == chip_smoke.J2K_SYCC
    if (nx, ny) != (1, 1):
        code = chip_smoke.j2k_splice(code, nx, ny)
    return chip_smoke.jp2_wrap(code, nx * side, ny * side, 3 if sycc else 1,
                               8 if sycc else 20, 18 if sycc else 17)


def test_committed_subsampling_codestreams_are_openjpegs(tmp_path):
    """The committed bytes are OpenJPEG's encode from the seeds; their JP2s
    decode bit-equal to the JAX reader's, whose arrays have the SHA-256
    chip_smoke.py holds the card's to; the 20-bit one is the seeded
    amplitude shifted to 16 bits as Pillow's I;16 unpacker rounds and
    wraps it."""
    sizes = 0
    for name, code in subsampling_fixtures().items():
        assert (chip_smoke.J2K_DIR / name).read_bytes() == code, name
        sizes += len(code)
        got = _equal_to_jax(_write(tmp_path, _fixture_jp2(name, code),
                                   "f.jp2"))
        digest = hashlib.sha256(
            (got[..., 0] if got.shape[2] == 1 else got).tobytes()).hexdigest()
        if name == chip_smoke.J2K_SYCC:
            assert digest == chip_smoke.J2K_SYCC_SHA256
        else:
            assert digest == chip_smoke.J2K_DEEP_SHA256
            amp = chip_smoke.j2k_deep_tile().astype(np.uint32)
            assert np.array_equal(got[..., 0],
                                  ((amp + 8) >> 4).astype(np.uint16))
    assert sizes < 1 << 19


@pytest.mark.parametrize("name", ["sycc", "deep"])
def test_spliced_subsampling_codestreams_equal_jax(tmp_path, name):
    """chip_smoke.py's splice at 3 x 2 tiles: both readers decode it to
    np.tile of the tile; a tile of odd side is refused by the splice."""
    fname = chip_smoke.J2K_SYCC if name == "sycc" else chip_smoke.J2K_DEEP
    code = (chip_smoke.J2K_DIR / fname).read_bytes()
    tile = jpeg2000.read(_fixture_jp2(fname, code)).array
    got = _equal_to_jax(_write(tmp_path, _fixture_jp2(fname, code, 3, 2),
                               "s.jp2"))
    want = np.tile(tile if tile.ndim == 3 else tile[..., None], (2, 3, 1))
    assert np.array_equal(got, want)
    if name == "sycc":
        odd = bytearray(code)
        struct.pack_into(">II", odd, 8, 255, 255)
        struct.pack_into(">II", odd, 24, 255, 255)
        with pytest.raises(ValueError, match="sub-sampling"):
            chip_smoke.j2k_splice(bytes(odd), 2, 2)
