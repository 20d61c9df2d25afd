"""The JPEG 2000 coding options Pillow's `save` does not write, decoded by
the port (_native/j2kdec.cpp) and by the JAX package's RasterReader
(Pillow 12.1 -> OpenJPEG 2.5.4) on the CPU: every file either decodes bit
for bit to the JAX reader's array (dtype, size and metadata too) or is
refused by both. No tolerance anywhere.

The codestreams come from OpenJPEG 2.5.4's own encoder, the libopenjp2
Pillow bundles, driven through ctypes (tests/opj_encode.py): the six
code-block styles and their combinations, progression order changes (POC),
region-of-interest shifts (RGN), SOP / EPH. Surgery on them moves the POC
or RGN between the main and the tile-part headers and the packet headers
into PPT or PPM segments, claims more than 109 coding passes for a
code-block, and breaks each new segment the way OpenJPEG refuses. The
committed codestream of chip_smoke.py's styled band is re-encoded here
from its seed."""
import hashlib
import io
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import opj_encode as oe  # noqa: E402
from PIL import Image  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from test_torch_decoders import (  # noqa: E402
    RESAMPLE_TOL,
    _both_refuse,
    _equal_to_jax,
)
from test_torch_jpeg2000 import _scene, _write  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

STYLES = {"bypass": oe.BYPASS, "reset": oe.RESET, "termall": oe.TERMALL,
          "vsc": oe.VSC, "pterm": oe.PTERM, "segsym": oe.SEGSYM}


def _held_to_jax(tmp_path, code: bytes, name: str = "x.j2k"):
    """The port's decode of `code` against the JAX reader's: the same array,
    or RasterError from both. Returns the array, or None where both
    refuse."""
    path = _write(tmp_path, code, name)
    try:
        jraster.RasterReader(path).close()
    except jraster.RasterError:
        _both_refuse(path)
        return None
    return _equal_to_jax(path)


def _u8(rng, shape=(37, 50)):
    return _scene(rng, shape)


def _rgb(rng, shape=(64, 80)):
    return _scene(rng, shape + (3,))


# ---------------------------------------------------------------------------
# code-block styles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", range(1, 64))
def test_style_combination_equals_jax(tmp_path, rng, mode):
    """Each of the 63 combinations of the six styles on a lossless u8 band
    of 16 x 16 code-blocks: the JAX reader's array, which is the band."""
    a = _u8(rng)
    got = _held_to_jax(tmp_path, oe.encode(a, mode=mode, cblk=(16, 16)))
    assert np.array_equal(got[..., 0], a)


@pytest.mark.parametrize("style", list(STYLES))
def test_style_on_lossy_97_rgb_equals_jax(tmp_path, rng, style):
    """Each style alone on a 9/7 RGB band with the ICT, three layers cut by
    rate and 16 x 8 code-blocks: segments that end inside a layer."""
    code = oe.encode(_rgb(rng), mode=STYLES[style], irreversible=True,
                     rates=[30, 10, 3], cblk=(16, 8))
    assert _held_to_jax(tmp_path, code) is not None


@pytest.mark.parametrize("mode", [oe.BYPASS, oe.BYPASS | oe.TERMALL, 63])
def test_styles_on_u16_tiles_equal_jax(tmp_path, rng, mode):
    """u16 samples (up to 18 bit-planes a code-block, the raw passes of
    BYPASS the most of them) in four tiles of two layers."""
    a = _scene(rng, (70, 90), 65535)
    got = _held_to_jax(tmp_path, oe.encode(a, mode=mode, tile=(48, 40),
                                           rates=[8, 0], cblk=(32, 16)))
    assert np.array_equal(got[..., 0], a)


# ---------------------------------------------------------------------------
# progression order changes
# ---------------------------------------------------------------------------
POCS = [(0, 0, 1, 3, 3, "CPRL"), (3, 0, 1, 6, 3, "RPCL")]


@pytest.mark.parametrize("where", ["tile-part header", "main header"])
def test_poc_equals_jax(tmp_path, rng, where):
    """Two progressions (CPRL over resolutions 0-2, RPCL over 3-5): OpenJPEG
    writes them in the tile-part header; moved into the main header they
    hold for the tile as well."""
    a = _rgb(rng)
    code = oe.encode(a, pocs=POCS)
    if where == "main header":
        code = oe.move_to_main(code, 0xFF5F)
    assert np.array_equal(_held_to_jax(tmp_path, code), a)


@pytest.mark.parametrize("second", list(oe.PROGRESSIONS))
@pytest.mark.parametrize("first", list(oe.PROGRESSIONS))
def test_poc_layers_bounded_equal_jax(tmp_path, rng, first, second):
    """A first progression bounded below the last layer (and to two
    components and four resolutions), a second over everything from
    layer 0: the packets the first emitted are skipped."""
    code = oe.encode(_rgb(rng), rates=[40, 10, 0],
                     pocs=[(0, 0, 2, 4, 2, first), (0, 0, 3, 6, 3, second)])
    assert _held_to_jax(tmp_path, code) is not None


@pytest.mark.parametrize("prog", list(oe.PROGRESSIONS))
def test_poc_per_tile_equals_jax(tmp_path, rng, prog):
    """Six tiles, each with its POC in its own tile-part header, the first
    progression bounded in layers, components and resolutions, the second
    over the rest. (OpenJPEG's encoder gives a tile with n progressions the
    first n it is given, whatever their tile numbers.)"""
    pocs = [p for t in range(1, 7)
            for p in ((0, 0, 2, 4, 2, prog, t), (2, 0, 3, 6, 3, "PCRL", t))]
    code = oe.encode(_rgb(rng), rates=[40, 10, 0], tile=(32, 48),
                     pocs=pocs)
    assert _held_to_jax(tmp_path, code) is not None


def test_poc_in_main_and_tile_headers_equals_jax(tmp_path, rng):
    """A main-header POC and a tile-part POC: the tile's progressions follow
    the main header's (a tile starts as a copy of the main header)."""
    code = oe.encode(_rgb(rng), rates=[40, 10, 0],
                     pocs=[(0, 0, 2, 4, 2, "CPRL"), (2, 1, 3, 6, 3, "PCRL")])
    code = oe.move_to_tiles(oe.move_to_main(code, 0xFF5F), 0xFF64)
    pos = oe.main_header_end(code)
    code = (code[:pos] + oe.poc_segment([(0, 0, 3, 6, 3, "RLCP")])
            + code[pos:])
    assert _held_to_jax(tmp_path, code) is not None


@pytest.mark.parametrize("tiles", [[2], [1], [1, 2]], ids=["tile 1",
                                                            "tile 0",
                                                            "tiles 0 1"])
@pytest.mark.parametrize("bands", [1, 3])
def test_poc_short_of_the_last_resolution_equals_jax(tmp_path, rng, tiles,
                                                     bands):
    """A tile whose POC stops at resolution 3 of 5: OpenJPEG hands Pillow
    that resolution's samples packed, which Pillow reads as full-size rows;
    under the component transform, components decoded to different
    resolutions are refused by both."""
    a = _rgb(rng)
    if bands == 1:
        a = a[..., 0]
    pocs = [(0, 0, 1, 4, bands - 1 or 1, "LRCP", t) for t in tiles]
    _held_to_jax(tmp_path, oe.encode(a, tile=(32, 48), pocs=pocs))


def _poc_main(code: bytes, segment: bytes, before_cod: bool = False):
    """`segment` added to the main header, at its end or before COD."""
    head = oe.segments(code, 2, oe.main_header_end(code))
    if before_cod:
        i = [m for m, _ in head].index(0xFF52)
        head = head[:i] + [(0xFF5F, segment)] + head[i:]
    else:
        head = head + [(0xFF5F, segment)]
    return oe.rebuild(b"".join(s for _, s in head), oe.tile_parts(code))


POC_EDGES = {
    # Ppoc past CPRL: pi.c's iterator emits nothing for it
    "unknown order": ([(0, 0, 1, 6, 3, 7), (0, 0, 1, 6, 3, "LRCP")], False),
    "first component past Csiz": ([(0, 5, 1, 6, 6, "LRCP"),
                                   (0, 0, 1, 6, 3, "RLCP")], False),
    "last component past Csiz": ([(0, 0, 1, 6, 9, "RPCL")], False),
    "resolutions past the last": ([(0, 0, 1, 40, 3, "PCRL")], False),
    "before COD": ([(0, 0, 1, 6, 3, "RPCL")], True),  # no layers yet
    "empty": ([(3, 0, 1, 2, 3, "LRCP")], False),
    "31 progressions": ([(r % 6, 0, 1, r % 6 + 1, 3, "LRCP")
                         for r in range(31)], False),
    "32 progressions": ([(0, 0, 1, 6, 3, "LRCP")] * 32, False),
}


@pytest.mark.parametrize("edge", list(POC_EDGES))
def test_poc_edges_equal_jax(tmp_path, rng, edge):
    entries, before_cod = POC_EDGES[edge]
    code = oe.encode(_rgb(rng, (32, 40)), rates=[30, 0])
    _held_to_jax(tmp_path, _poc_main(code, oe.poc_segment(entries),
                                     before_cod))


def test_poc_of_the_wrong_length_is_refused_as_by_jax(tmp_path, rng):
    code = oe.encode(_rgb(rng, (32, 40)))
    segment = oe.poc_segment([(0, 0, 1, 6, 3, "LRCP")])
    bad = struct.pack(">H", 0xFF5F) + struct.pack(">H", 10) + segment[4:] \
        + b"\0"
    _both_refuse(_write(tmp_path, _poc_main(code, bad), "p.j2k"))


# ---------------------------------------------------------------------------
# region of interest
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shift", [1, 7, 15, 20, 21, 22, 30, 31, 200])
@pytest.mark.parametrize("irreversible", [False, True], ids=["5-3", "9-7"])
def test_rgn_shift_equals_jax(tmp_path, rng, irreversible, shift):
    """OpenJPEG writes the shift and codes the samples unshifted; its
    decoder starts `shift` bit-planes up and scales every magnitude back
    down. A code-block past 30 bit-planes in all (on a u8 band from a
    shift of about 20, by the block's bit-planes; every block from 31 on)
    makes both refuse the file."""
    a = _u8(rng)
    got = _held_to_jax(tmp_path, oe.encode(a, roi=(0, shift),
                                           irreversible=irreversible))
    if shift <= 15:
        assert got is not None
        if not irreversible:
            assert np.array_equal(got[..., 0], a)
    elif shift >= 31:
        assert got is None


@pytest.mark.parametrize("shift", [1, 7])
def test_rgn_with_bypass_equals_jax(tmp_path, rng, shift):
    """BYPASS under an RGN shift: OpenJPEG's decoder takes the raw passes
    `shift` bit-planes later than its encoder wrote them, so Pillow's
    image is not the band written; the port's is Pillow's."""
    a = _u8(rng)
    got = _held_to_jax(tmp_path, oe.encode(a, roi=(0, shift), mode=63))
    assert not np.array_equal(got[..., 0], a)


@pytest.mark.parametrize("comp", [0, 1, 2])
def test_rgn_in_tile_part_headers_equals_jax(tmp_path, rng, comp):
    """One component's shift in each tile's header, on three components
    and four tiles, 9/7 with layers."""
    code = oe.encode(_rgb(rng), roi=(comp, 5), tile=(48, 40),
                     irreversible=True, rates=[20, 5])
    code = oe.move_to_tiles(code, 0xFF5E)
    assert _held_to_jax(tmp_path, code) is not None


def test_poc_in_a_later_tile_part_equals_jax(tmp_path, rng):
    """OpenJPEG's POC moved from each tile's first tile-part header into its
    last (OpenJPEG cuts a tile-part a progression where it has packets):
    the tile is decoded once all its tile-parts are read."""
    a = _rgb(rng)
    code = oe.encode(a, pocs=POCS, tile=(32, 32))
    parts = oe.tile_parts(code)
    moved = 0
    for tile in range(4):
        mine = [p for p in parts if p[0] == tile]
        if len(mine) < 2:
            continue
        poc = [x for x in mine[0][3] if x[0] == 0xFF5F]
        mine[0][3] = [x for x in mine[0][3] if x[0] != 0xFF5F]
        mine[-1][3] = mine[-1][3] + poc
        moved += 1
    assert moved
    code = oe.rebuild(oe.main_header(code), parts)
    assert np.array_equal(_held_to_jax(tmp_path, code), a)


def test_tile_rgn_overrides_the_main_one_as_jax(tmp_path, rng):
    """A main-header shift of 3 and a tile-part shift of 12 for the same
    component: the tile's holds for that tile."""
    a = _u8(rng, (64, 80))
    code = oe.encode(a, roi=(0, 12), tile=(32, 32), mode=oe.TERMALL)
    code = oe.move_to_tiles(code, 0xFF5E)
    parts = oe.tile_parts(code)
    for part in parts[1::2]:
        part[3] = [x for x in part[3] if x[0] != 0xFF5E]
    code = oe.rebuild(oe.main_header(code) + oe.rgn_segment(0, 3), parts)
    got = _held_to_jax(tmp_path, code)
    assert np.array_equal(got[..., 0], a)


def _with_main(code: bytes, segment: bytes) -> bytes:
    pos = oe.main_header_end(code)
    return code[:pos] + segment + code[pos:]


RGN_EDGES = {
    "Srgn 1": (oe.rgn_segment(0, 7, srgn=1), None),
    "component past Csiz": (oe.rgn_segment(3, 7), "RGN"),
    "too long": (struct.pack(">HHBBBB", 0xFF5E, 6, 0, 0, 7, 0), "RGN"),
    "too short": (struct.pack(">HHBB", 0xFF5E, 4, 0, 0), "RGN"),
}


@pytest.mark.parametrize("edge", list(RGN_EDGES))
def test_rgn_edges_equal_jax(tmp_path, rng, edge):
    segment, match = RGN_EDGES[edge]
    code = _with_main(oe.encode(_rgb(rng, (32, 40))), segment)
    got = _held_to_jax(tmp_path, code)
    assert (got is None) == (match is not None)


# ---------------------------------------------------------------------------
# packed packet headers
# ---------------------------------------------------------------------------
PACKED_CODINGS = {
    "one layer": {},
    "layers": {"rates": [30, 8, 0]},
    "tiles RPCL": {"rates": [30, 8, 0], "tile": (32, 32),
                   "progression": "RPCL"},
    "poc": {"pocs": POCS},
    "styles 97": {"mode": 63 & ~oe.BYPASS, "irreversible": True,
                  "rates": [20, 4]},
}
PACKINGS = {
    "sop eph": lambda c: c,
    "ppt": oe.to_ppt,
    "ppt split": lambda c: oe.to_ppt(c, chunk=37),
    "ppt split Zppt reversed": lambda c: oe.to_ppt(c, chunk=37,
                                                   reverse_z=True),
    "ppm": oe.to_ppm,
    "ppm split": lambda c: oe.to_ppm(c, chunk=61),
}


@pytest.mark.parametrize("packing", list(PACKINGS))
@pytest.mark.parametrize("coding", list(PACKED_CODINGS))
def test_packed_headers_equal_jax(tmp_path, rng, coding, packing):
    """SOP before every packet and EPH after its header (OpenJPEG's csty
    6); the headers, EPH included, moved into PPT segments of each
    tile-part or PPM segments of the main header, whole or cut into
    segments of a few dozen bytes; the SOP segments stay with the bodies."""
    a = _rgb(rng)
    kw = PACKED_CODINGS[coding]
    code = PACKINGS[packing](oe.encode(a, csty=oe.SOP | oe.EPH, **kw))
    got = _held_to_jax(tmp_path, code)
    if not kw.get("irreversible"):
        assert np.array_equal(got, a)


def _tiles_reversed(code: bytes, tnsot: int) -> bytes:
    parts = oe.tile_parts(code)[::-1]
    for part in parts:
        part[2] = tnsot
    return oe.rebuild(oe.main_header(code), parts)


@pytest.mark.parametrize("tnsot", [1, 0])
def test_ppm_over_tiles_out_of_order_equals_jax(tmp_path, rng, tnsot):
    """PPM's one stream of headers is read in the order OpenJPEG decodes the
    tiles: as each tile's last tile-part arrives (TNsot 1: the codestream's
    order, here the tiles reversed, which the stream follows), or, where no
    tile-part says the count (TNsot 0), by tile index after EOC, which
    reads the reversed stream against the wrong tiles."""
    a = _rgb(rng)
    code = oe.encode(a, csty=oe.SOP | oe.EPH, rates=[30, 0], tile=(32, 32))
    got = _held_to_jax(tmp_path, oe.to_ppm(_tiles_reversed(code, tnsot)))
    if tnsot:
        assert np.array_equal(got, a)


def _ppm_cut_in_nppm(code: bytes) -> bytes:
    """PPM segments cut inside an Nppm field: OpenJPEG refuses them."""
    whole = oe.to_ppm(code)
    head = oe.segments(whole, 2, oe.main_header_end(whole))
    (ppm,) = [s for m, s in head if m == 0xFF60]
    data = ppm[5:]
    cut = 2  # inside the first Nppm
    segs = (struct.pack(">HHB", 0xFF60, 3 + cut, 0) + data[:cut]
            + struct.pack(">HHB", 0xFF60, 3 + len(data) - cut, 1)
            + data[cut:])
    main = b"".join(s for m, s in head if m != 0xFF60) + segs
    return oe.rebuild(main, oe.tile_parts(whole))


def _zppt_twice(code: bytes) -> bytes:
    whole = oe.to_ppt(code, chunk=37)
    parts = oe.tile_parts(whole)
    head = parts[0][3]
    seg = [s for m, s in head if m == 0xFF61]
    parts[0][3] = [(m, s) for m, s in head if m != 0xFF61] + [
        (0xFF61, seg[0]), (0xFF61, seg[0][:4] + b"\x00" + seg[1][5:])]
    return oe.rebuild(oe.main_header(whole), parts)


def _ppt_and_ppm(code: bytes) -> bytes:
    ppm = oe.to_ppm(code)
    parts = oe.tile_parts(ppm)
    parts[0][3] = parts[0][3] + [(0xFF61, struct.pack(">HHBB", 0xFF61, 4, 0,
                                                      0))]
    return oe.rebuild(oe.main_header(ppm), parts)


PACKED_FAULTS = {
    "Nppm cut": _ppm_cut_in_nppm,
    "Nppm past the headers": lambda c: _with_main(
        oe.to_ppm(c), struct.pack(">HHBI", 0xFF60, 7, 9, 1000)),
    "Zppm twice": lambda c: _with_main(
        oe.to_ppm(c), struct.pack(">HHBI", 0xFF60, 7, 0, 0)),
    "Zppt twice": _zppt_twice,
    "PPT with PPM": _ppt_and_ppm,
    "headers short": lambda c: oe.to_ppt(c)[:-40] + b"\xff\xd9",
}


@pytest.mark.parametrize("fault", list(PACKED_FAULTS))
def test_packed_header_faults_equal_jax(tmp_path, rng, fault):
    """PPM / PPT segments OpenJPEG refuses: an Nppm cut by a segment's end,
    or running past the last segment, a Zppm or Zppt used twice, PPT where
    the main header has PPM."""
    code = oe.encode(_rgb(rng, (32, 40)), csty=oe.SOP | oe.EPH,
                     rates=[30, 0])
    _held_to_jax(tmp_path, PACKED_FAULTS[fault](code))


# ---------------------------------------------------------------------------
# more than one segment's passes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("passes", [110, 112, 164])
def test_more_than_109_passes_equal_jax(tmp_path, rng, passes):
    """A u16 code-block (all 16 bit-planes, one layer) whose header claims
    more passes than one segment holds: OpenJPEG opens a second segment and
    decodes the passes the bit-planes allow, the band written."""
    a = rng.integers(0, 65536, (32, 32)).astype(np.uint16)
    code = oe.more_passes(oe.encode(a, resolutions=1), passes,
                          bytes(range(passes - 109)))
    got = _held_to_jax(tmp_path, code)
    assert np.array_equal(got[..., 0], a)


# ---------------------------------------------------------------------------
# the decoded band onto the device (the CPU here)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alg", ["average", "cubic", "nearest"])
def test_decimated_read_of_styled_band_equals_jax(tmp_path, rng, alg):
    """read_band_resampled(1, 30, 20, ...) on a u16 band of every style,
    a POC and an RGN in its tile-part headers: the port's device route
    against the JAX package's."""
    a = _scene(rng, (60, 90), 65535)
    code = oe.encode(a, mode=63 & ~oe.BYPASS, roi=(0, 3), tile=(48, 32),
                     pocs=[(0, 0, 1, 3, 1, "CPRL", t) for t in range(1, 7)]
                     + [(3, 0, 1, 6, 1, "RPCL", t) for t in range(1, 7)])
    path = _write(tmp_path, oe.move_to_tiles(code, 0xFF5E), "s.j2k")
    _equal_to_jax(path)
    t, j = traster.RasterReader(path), jraster.RasterReader(path)
    try:
        got = traster.read_band_resampled_to_device(t, 1, 30, 20, "cpu", alg)
        want = j.read_band_resampled(1, 30, 20, alg)
    finally:
        t.close()
        j.close()
    assert got.dtype == torch.float32 and tuple(got.shape) == (20, 30)
    np.testing.assert_allclose(got.numpy(), want, **RESAMPLE_TOL)


# ---------------------------------------------------------------------------
# the committed codestream of chip_smoke.py's styled band
# ---------------------------------------------------------------------------
STYLED_POCS = [(0, 0, 1, 3, 1, "CPRL"), (3, 0, 1, 6, 1, "RPCL")]
STYLED_SHIFT = 7


def styled_codestream() -> bytes:
    """tests/data/jpeg2000's styled file as OpenJPEG 2.5.4 writes it from
    the seeded u16 tile: a row of two 512^2 tiles; tile 0 coded with all
    six styles (the main COD), tile 1 with all but BYPASS (a tile-part COD)
    and an RGN shift (a tile-part RGN), both under a main-header POC of two
    progressions (OpenJPEG writes it in each tile's first tile-part header,
    and splits the tile into a tile-part a progression). BYPASS stays out
    of the shifted tile: OpenJPEG 2.5.4 does not decode the two together to
    what it encoded (test_rgn_with_bypass_equals_jax)."""
    tile = chip_smoke.j2k_band_tile()
    a = oe.encode(tile, tile=(512, 512), mode=63, pocs=STYLED_POCS)
    b = oe.encode(tile, tile=(512, 512), mode=63 & ~oe.BYPASS,
                  pocs=STYLED_POCS, roi=(0, STYLED_SHIFT))
    head_a = oe.segments(a, 2, oe.main_header_end(a))
    head_b = dict(oe.segments(b, 2, oe.main_header_end(b)))
    assert dict(head_a)[0xFF5C] == head_b[0xFF5C]  # the same QCD
    pa, pb = oe.tile_parts(a), oe.tile_parts(b)
    (poc,) = [s for m, s in pa[0][3] if m == 0xFF5F]
    main = bytearray(b"".join(s for _, s in head_a) + poc)
    struct.pack_into(">I", main, 6, 1024)  # Xsiz: two tiles
    for part in pa + pb:
        part[3] = [(m, s) for m, s in part[3] if m != 0xFF5F]
    for part in pb:
        part[0] = 1
    pb[0][3] = [(0xFF52, head_b[0xFF52]), (0xFF5E, head_b[0xFF5E])] + pb[0][3]
    return oe.rebuild(bytes(main), pa + pb)


def test_committed_styled_codestream_is_openjpegs(tmp_path):
    """The committed bytes are OpenJPEG's re-encode from the seed; Pillow
    and the port decode them to the seeded tile twice, whose SHA-256
    chip_smoke.py holds the card's decode to; the splice of 3 x 2 tiles
    decodes to np.tile of the tile in both."""
    blob = styled_codestream()
    assert (chip_smoke.J2K_DIR / chip_smoke.J2K_STYLED).read_bytes() == blob
    want = np.tile(chip_smoke.j2k_band_tile(), (1, 2))
    pil = np.asarray(Image.open(io.BytesIO(blob)))
    assert np.array_equal(pil, want)
    assert hashlib.sha256(pil.tobytes()).hexdigest() == \
        chip_smoke.J2K_STYLED_SHA256
    got = _equal_to_jax(_write(tmp_path, blob, "styled.j2k"))
    assert np.array_equal(got[..., 0], want)
    spliced = chip_smoke.j2k_splice(blob, 3, 2)
    path = _write(tmp_path, chip_smoke.jp2_wrap(spliced, 1536, 1024, 1, 16,
                                                17), "band.jp2")
    got = _equal_to_jax(path)
    assert np.array_equal(got[..., 0],
                          np.tile(chip_smoke.j2k_band_tile(), (2, 3)))
