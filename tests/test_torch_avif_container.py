"""The port's AVIF reader on grid items and image sequences (io/avif.py over
_native/av1dec.cpp) against the JAX package's RasterReader, which opens the
same files through Pillow 12.1, libavif 1.3.0, dav1d 1.5.1 and libyuv, on
the CPU: every band bit-equal (dtype included), and RasterError where the
JAX reader raises it. No tolerance anywhere.

Inputs are the committed files of tests/data/avif whose names start with
CONTAINER_PREFIXES (`container_files`; chip_smoke.py's avif phase decodes
them on the card):

  * grid items written by Debian's libavif 0.11.1 (aom 3.6.0) through
    tests/avif_encode.encode_grid: 8-bit 4:2:0 as 3 x 2 tiles of 64^2, then
    2 x 2 tiles of 64^2 in every layout (4:2:0, 4:2:2, 4:4:4, 4:0:0) at 8,
    10 and 12 bits, RGBA with an alpha grid (8-bit 4:2:0, 10-bit 4:4:4,
    12-bit "LA"), premultiplied (`prem`), film grain on every tile
    (`film-grain-test 1`) and the limited range;
  * `avis` image sequences: Pillow's (aom 3.12.1; RGB, and RGBA with an
    alpha track) and libavif 0.11.1's of three frames from aom, rav1e and
    SVT-AV1 (whose sequence header has no colour description: the sample
    entry's `colr` gives the matrix and range), and aom's with an alpha
    track; their creation and modification times set to 0.

Beside them: the `grid` box's output size edited (crops, and libavif's
"Invalid image grid" rules), against the grid item's `ispe`; the `dimg`
references cut, reordered, doubled or pointed at other items; alpha
auxiliary items of each tile in place of an alpha grid; tiles of
another size, depth or layout, without `av1C`, or leaning on the sequence
header of the tile before them; the payload in `idat` and with 32-bit
sizes; the sample tables and track boxes of a sequence edited; a file
whose `meta` item and first sample differ (libavif takes the tracks where
the major brand is `avis` or neither `avif` nor `avis`, else the items);
and 200 single-bit flips each of the grid and `iref` bytes of a grid file
and of the `moov` box of a sequence, and a `tkhd` of another size than the
frames (libavif scales the frame to it). A hidden key frame or
`show_existing_frame` in the first sample stays refused by name."""
import copy
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
    NOT_YET,
    Items,
    _box,
    _color_range_bit,
    _decimated_read_equals_jax,
    _outcome,
    _write,
    alpha_plane,
    footprint,
    scene,
)
from test_torch_avif_depth import deep_alpha, deep_planes  # noqa: E402
from test_torch_decoders import _equal_to_jax  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

CONTAINER_PREFIXES = chip_smoke.AVIF_CONTAINER_PREFIXES
NAMES = [n for n in chip_smoke.AVIF_FIXTURES
         if n.startswith(CONTAINER_PREFIXES)]
LAYOUTS = ("4:2:0", "4:2:2", "4:4:4", "4:0:0")
# the boxes holding other boxes, and the bytes of their own fields first
CONTAINERS = {b"moov": 0, b"trak": 0, b"mdia": 0, b"minf": 0, b"stbl": 0,
              b"edts": 0, b"tref": 0, b"dinf": 0, b"stsd": 8, b"av01": 78}


def cells(a: np.ndarray, cols: int, rows: int, depth: int, layout: str,
          alpha: np.ndarray = None) -> list:
    """The (y, u, v, alpha) planes of each of the cols x rows tiles of the
    u8 RGB scene `a` (and u8 `alpha`) at `depth` bits, in raster order."""
    th, tw = a.shape[0] // rows, a.shape[1] // cols
    out = []
    for r in range(rows):
        for c in range(cols):
            win = (slice(r * th, (r + 1) * th), slice(c * tw, (c + 1) * tw))
            al = None
            if alpha is not None:
                al = alpha[win] if depth == 8 else deep_alpha(alpha[win],
                                                               depth)
            out.append((*deep_planes(a[win], depth, layout), al))
    return out


def _zero_times(blob: bytes) -> bytes:
    """`blob` with the creation and modification times of its mvhd, tkhd
    and mdhd boxes set to 0 (the encoders write the clock's)."""
    tree = parse_boxes(blob)

    def walk(nodes):
        for node in nodes:
            if len(node) == 3:
                walk(node[2])
            elif node[0] in (b"mvhd", b"tkhd", b"mdhd"):
                n = 16 if node[1][0] == 1 else 8
                node[1] = node[1][:4] + bytes(n) + node[1][4 + n:]

    walk(tree)
    return build_boxes(tree)


def _pillow_sequence(frames: list) -> bytes:
    buf = io.BytesIO()
    images = [Image.fromarray(f) for f in frames]
    images[0].save(buf, format="AVIF", save_all=True,
                   append_images=images[1:], quality=50, speed=8)
    return _zero_times(buf.getvalue())


def container_files() -> dict:
    """The grid_ and seq_ files of tests/data/avif from chip_smoke's
    AVIF_SEED, in the order of chip_smoke.AVIF_FIXTURES: the grids and
    libavif's sequences as libavif 0.11.1 writes them (tests/avif_encode),
    Pillow's sequences as Pillow writes them."""
    s = chip_smoke.AVIF_SEED
    grid = avif_encode.encode_grid
    out = {"grid_420.avif": grid(cells(scene(s, 128, 192), 3, 2, 8, "4:2:0"),
                                 3, 2, quantizer=20)}
    for depth in (8, 10, 12):
        for layout in LAYOUTS:
            if (depth, layout) == (8, "4:2:0"):
                continue
            tag = layout.replace(":", "")
            name = f"grid_{tag}" if depth == 8 else f"grid_{depth}_{tag}"
            out[f"{name}.avif"] = grid(
                cells(scene(s + depth, 128, 128), 2, 2, depth, layout), 2, 2,
                depth=depth, layout=layout, quantizer=30)
    a = alpha_plane(128, 128)
    out["grid_rgba.avif"] = grid(cells(scene(s + 1, 128, 128), 2, 2, 8,
                                       "4:2:0", a), 2, 2, quantizer=30)
    out["grid_10_rgba_444.avif"] = grid(
        cells(scene(s + 2, 128, 128), 2, 2, 10, "4:4:4", a), 2, 2, depth=10,
        layout="4:4:4", quantizer=30)
    out["grid_12_la.avif"] = grid(
        cells(scene(s + 3, 128, 128), 2, 2, 12, "4:0:0", a), 2, 2, depth=12,
        layout="4:0:0", quantizer=30)
    out["grid_prem.avif"] = grid(cells(scene(s + 4, 128, 128), 2, 2, 8,
                                       "4:2:0", a), 2, 2, quantizer=30,
                                 premultiplied=True)
    out["grid_grain.avif"] = grid(cells(scene(s + 5, 128, 128), 2, 2, 8,
                                        "4:2:0"), 2, 2, quantizer=30,
                                  options={"film-grain-test": "1"})
    out["grid_limited.avif"] = grid(cells(scene(s + 6, 128, 192), 3, 2, 8,
                                          "4:2:0"), 3, 2, quantizer=30,
                                    full=False)
    out["seq_pillow.avif"] = _pillow_sequence([scene(s + k, 32, 48)
                                               for k in (4, 5)])
    out["seq_pillow_rgba.avif"] = _pillow_sequence(
        [np.dstack([scene(s + k, 32, 48), alpha_plane(32, 48)])
         for k in (4, 5)])
    frames = [(*deep_planes(scene(s + k, 64, 96), 8, "4:2:0"), None)
              for k in range(3)]
    for codec in ("aom", "rav1e", "svt"):
        out[f"seq_{codec}.avif"] = _zero_times(avif_encode.encode_sequence(
            frames, codec=codec, quantizer=30, speed=8))
    out["seq_rgba.avif"] = _zero_times(avif_encode.encode_sequence(
        [(*f[:3], alpha_plane(64, 96)) for f in frames], quantizer=30,
        speed=8))
    return out


def grid_band_file() -> bytes:
    """chip_smoke.AVIF_GRID_BAND as libavif 0.11.1 writes it: avif_band_u8
    at AVIF_BAND_SIDE^2 (its gray as Y, flat chroma) as a 3 x 3 grid of
    3072^2 8-bit 4:2:0 tiles, with footprint() as a 3 x 3 alpha grid (the
    gray 0 under alpha 0), aom at speed 6 and quantizer
    AVIF_GRID_BAND_QUANTIZER (lossless alpha; not run by the tests)."""
    side = chip_smoke.AVIF_BAND_SIDE
    gray = chip_smoke.avif_band_u8(side)
    alpha = footprint(side)
    gray[alpha == 0] = 0
    rgb = np.dstack([gray, np.full_like(gray, 128), np.full_like(gray, 128)])
    return avif_encode.encode_grid(
        cells(rgb, 3, 3, 8, "4:2:0", alpha), 3, 3,
        quantizer=chip_smoke.AVIF_GRID_BAND_QUANTIZER, alpha_quantizer=0,
        threads=8)


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------
def parse_boxes(blob: bytes, pos: int = 0, end: int = None) -> list:
    """The box tree of blob[pos:end]: [type, payload] for a leaf, [type,
    own fields, children] for the boxes of CONTAINERS (and `meta`)."""
    end = len(blob) if end is None else end
    out = []
    while pos < end:
        size, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + size]
        n = 4 if kind == b"meta" else CONTAINERS.get(kind)
        if n is not None and len(body) >= n:
            out.append([kind, body[:n], parse_boxes(body, n)])
        else:
            out.append([kind, body])
        pos += size
    return out


def build_boxes(tree: list) -> bytes:
    out = b""
    for node in tree:
        body = node[1] + build_boxes(node[2]) if len(node) == 3 else node[1]
        out += struct.pack(">I", 8 + len(body)) + node[0] + body
    return out


def find(tree: list, *path):
    """The first node down `path` (box types), or None."""
    for node in tree:
        if node[0] == path[0]:
            if len(path) == 1:
                return node
            if len(node) == 3:
                got = find(node[2], *path[1:])
                if got is not None:
                    return got
    return None


def tracks(tree: list) -> list:
    return [n for n in find(tree, b"moov")[2] if n[0] == b"trak"]


def _top(blob: bytes, kind: bytes) -> tuple:
    """(start, end) of the top-level box `kind`."""
    pos = 0
    while pos < len(blob):
        size, k = struct.unpack(">I4s", blob[pos:pos + 8])
        if k == kind:
            return pos, pos + size
        pos += size
    raise KeyError(kind)


def rebuild(tree: list, old: bytes) -> bytes:
    """build_boxes, then the chunk offsets (stco) and item offsets (iloc of
    version 0, 4-byte offsets) moved by as much as the mdat box moved."""
    new = build_boxes(tree)
    delta = _top(new, b"mdat")[0] - _top(old, b"mdat")[0]
    if not delta:
        return new

    def walk(nodes):
        for node in nodes:
            if len(node) == 3:
                walk(node[2])
            elif node[0] == b"stco":
                b = bytearray(node[1])
                for i in range(struct.unpack(">I", b[4:8])[0]):
                    v = struct.unpack_from(">I", b, 8 + 4 * i)[0]
                    struct.pack_into(">I", b, 8 + 4 * i, v + delta)
                node[1] = bytes(b)
            elif node[0] == b"iloc":
                b = bytearray(node[1])
                assert b[0] == 0 and b[4:6] == b"\x44\x00"
                pos = 8
                for _ in range(struct.unpack(">H", b[6:8])[0]):
                    n = struct.unpack_from(">H", b, pos + 4)[0]
                    pos += 6
                    for _ in range(n):
                        v = struct.unpack_from(">I", b, pos)[0]
                        struct.pack_into(">I", b, pos, v + delta)
                        pos += 8
                node[1] = bytes(b)

    walk(tree)
    return build_boxes(tree)


class Grid(Items):
    """Items of a grid file (item 1 the colour grid; its `grid` payload in
    data[1]), with the `iref` kept as [type, from, [to ...]] in `links`,
    and the choice of items whose data go into `idat` (iloc version 1)."""

    def __init__(self, blob: bytes):
        super().__init__(blob)
        self.links, pos = [], 4
        while pos < len(self.refs):
            size, kind, frm, n = struct.unpack(">I4sHH", self.refs[pos:pos
                                                                 + 12])
            self.links.append([kind, frm, list(struct.unpack(
                f">{n}H", self.refs[pos + 12:pos + 12 + 2 * n]))])
            pos += size
        self.in_idat = set()
        self.iref_version = 0

    def output(self, width: int, height: int, flags: int = 0,
               version: int = 0) -> None:
        head = bytearray(self.data[1][:4])
        head[0], head[1] = version, flags
        fmt = ">II" if flags & 1 else ">HH"
        self.data[1] = bytes(head) + struct.pack(fmt, width, height)

    def build(self) -> bytes:
        self.refs = bytes([self.iref_version, 0, 0, 0]) + b"".join(
            _box(k, struct.pack(f">HH{len(to)}H", frm, len(to), *to))
            for k, frm, to in self.links)
        if not self.in_idat:
            return super().build()
        ipma = struct.pack(">II", 0, len(self.assoc)) + b"".join(
            struct.pack(">HB", i, len(e)) + bytes(e) for i, e in self.assoc)
        iprp = _box(b"ipco", b"".join(_box(k, v) for k, v in self.props)) \
            + _box(b"ipma", ipma)
        idat = b"".join(d for i, d in self.data.items() if i in self.in_idat)
        rest = b"".join(d for i, d in self.data.items()
                        if i not in self.in_idat)

        def meta(base: int) -> bytes:
            iloc = struct.pack(">IBBH", 1 << 24, 0x44, 0, len(self.data))
            at_idat = 0
            for item, data in self.data.items():
                if item in self.in_idat:
                    iloc += struct.pack(">HHHHII", item, 1, 0, 1, at_idat,
                                        len(data))
                    at_idat += len(data)
                else:
                    iloc += struct.pack(">HHHHII", item, 0, 0, 1, base,
                                        len(data))
                    base += len(data)
            body = {b"iloc": iloc, b"iprp": iprp, b"iref": self.refs}
            kids = b"".join(_box(k, body.get(k, v)) for k, v in self.kids)
            return _box(b"meta", b"\0\0\0\0" + kids + _box(b"idat", idat))

        head = _box(b"ftyp", self.ftyp)
        base = len(head) + len(meta(0)) + 8
        return head + meta(base) + _box(b"mdat", rest)


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------
def _digest(blob: bytes) -> str:
    with Image.open(io.BytesIO(blob)) as im:
        return hashlib.sha256(np.asarray(im).tobytes()).hexdigest()


def test_container_fixtures_are_written():
    """tests/data/avif's grid_ and seq_ files open in Pillow to the SHA-256
    chip_smoke pins (AVIF_FIXTURES), and are what container_files() writes
    (the libavif 0.11.1 ones where that library is installed)."""
    on_disk = sorted(p.name for p in AVIF_DIR.glob("*.avif")
                     if p.name.startswith(CONTAINER_PREFIXES))
    assert on_disk == sorted(NAMES)
    for name in NAMES:
        assert _digest((AVIF_DIR / name).read_bytes()) == \
            chip_smoke.AVIF_FIXTURES[name], name
    if avif_encode.available():
        files = container_files()
        assert list(files) == NAMES
        for name, blob in files.items():
            assert (AVIF_DIR / name).read_bytes() == blob, name


def _film_grain_present(obus: bytes) -> bool:
    """The film_grain_params_present bit of an 8-bit 4:2:0 sequence header
    (after color_range: chroma_sample_position, separate_uv_delta_q)."""
    bit = _color_range_bit(obus) + 1 + 2 + 1
    return bool(obus[bit >> 3] >> (7 - (bit & 7)) & 1)


def test_container_fixtures_hold_their_tools():
    """What each file is there for is in it: grids of the tiles, layouts
    and alpha their names say, `prem` and film grain where named; the
    sequences as tracks, with an alpha track where named, and an SVT-AV1
    sequence header without a colour description beside a `colr` entry."""
    for name in NAMES:
        blob = (AVIF_DIR / name).read_bytes()
        p = avif.parse(blob)
        rgba = any(k in name for k in ("rgba", "_la", "prem"))
        assert (p.alpha_image is not None) == rgba, name
        assert p.premultiplied == ("prem" in name), name
        if name.startswith("grid_"):
            c = p.color
            assert c.grid and (c.tile_width, c.tile_height) == (64, 64)
            assert (c.columns, c.rows) == ((3, 2) if c.width == 192
                                           else (2, 2)), name
            if rgba:
                assert p.alpha_image.grid and len(p.alpha_image.tiles) == 4
            av1c = blob[blob.find(b"av1C") + 6]
            depth = 12 if av1c & 0x20 else 10 if av1c & 0x40 else 8
            assert depth == (10 if "_10_" in name else 12 if "_12_" in name
                             else 8), name
            if depth == 8 and av1c & 0x1C == 0x0C:  # 8-bit 4:2:0
                assert _film_grain_present(c.tiles[0]) == ("grain" in name)
        else:
            assert _top(blob, b"moov") and p.timescale > 0, name
            assert blob[8:12] == b"avis"
    svt = avif.parse((AVIF_DIR / "seq_svt.avif").read_bytes())
    assert (svt.matrix, svt.full_range) == (1, 1)


@pytest.mark.parametrize("name", NAMES)
def test_container_fixture_equals_jax(name):
    """Each file opens in the port as in the JAX reader, bit for bit: RGB,
    or RGBA where it has an alpha grid or track."""
    got = _equal_to_jax(AVIF_DIR / name)
    with Image.open(AVIF_DIR / name) as im:
        assert got.shape[-1] == len(im.mode)
    assert hashlib.sha256(got.tobytes()).hexdigest() == \
        chip_smoke.AVIF_FIXTURES[name]


def test_grid_band_equals_pillows_decode():
    """The committed 9216^2 grid band (chip_smoke's avif phase): 3 x 3
    colour and alpha tiles of 3072^2, under 2 MB, and the port's decode and
    Pillow's both hash to AVIF_GRID_BAND_SHA256."""
    blob = chip_smoke.AVIF_GRID_BAND.read_bytes()
    assert len(blob) < 2 << 20
    p = avif.parse(blob)
    side = chip_smoke.AVIF_BAND_SIDE
    for image in (p.color, p.alpha_image):
        assert (image.columns, image.rows, image.tile_width, image.width) \
            == (3, 3, side // 3, side)
    want = _digest(blob)
    assert want == chip_smoke.AVIF_GRID_BAND_SHA256
    got = avif.read(blob).load().array
    assert hashlib.sha256(got.tobytes()).hexdigest() == want
    assert (got[..., 3] == 0).any() and (got[..., 3] == 255).any()


# ---------------------------------------------------------------------------
# grid items
# ---------------------------------------------------------------------------
def _first_tile(name: str) -> bytes:
    """The AV1 data of the (first tile of the) colour image of
    tests/data/avif/`name`."""
    return avif.parse((AVIF_DIR / name).read_bytes()).obus


def _grid_cases() -> dict:
    """Name -> (file, edit of Grid, the outcome both readers agree on)."""
    def output(w, h, ispe=True):
        def edit(f):
            f.output(w, h)
            if ispe:
                f.prop(b"ispe", struct.pack(">III", 0, w, h), 1)
        return edit

    def ispe(w, h):
        return lambda f: f.prop(b"ispe", struct.pack(">III", 0, w, h), 1)

    def links(fn):
        def edit(f):
            f.links[0][2] = fn(f.links[0][2])
        return edit

    def tile_data(item, fn):
        def edit(f):
            f.data[item] = fn(f)
        return edit

    def tile_prop(item, kind, payload):
        return lambda f: f.prop(kind, payload, item)

    def drop(item, kind):
        def edit(f):
            entries = dict(f.assoc)[item]
            entries[:] = [e for e in entries
                          if f.props[(e & 0x7F) - 1][0] != kind]
        return edit

    def strip_header(data: bytes) -> bytes:
        """AV1 data without its temporal delimiter and sequence header
        (aom's: 2 bytes, then the header OBU's 2 + size)."""
        return data[2 + 2 + data[3]:]

    def both(*edits):
        def edit(f):
            for e in edits:
                e(f)
        return edit

    def split_dimg(f):  # the tiles listed in two `dimg` boxes
        f.links.append([b"dimg", 1, f.links[0][2][3:]])
        del f.links[0][2][3:]

    def retype(item, kind):
        def edit(f):
            k = [name for name, _ in f.kids].index(b"iinf")
            f.kids[k][1] = f.kids[k][1].replace(
                struct.pack(">HH", item, 0) + b"av01",
                struct.pack(">HH", item, 0) + kind, 1)
        return edit

    def tile_alphas(pairs, colour=(2, 3, 4, 5), alpha_grid=False):
        """grid_rgba's alpha tiles made alpha items of the colour tiles
        (`auxl` of each (alpha, colour) pair), its alpha grid dropped."""
        def edit(f):
            f.links[:] = [[b"dimg", 1, list(colour)]] + (
                [[b"dimg", 6, [7, 8, 9, 10]]] if alpha_grid else []) + [
                    [b"auxl", a, [c]] for a, c in pairs]
        return edit

    each = list(zip((7, 8, 9, 10), (2, 3, 4, 5)))

    def drop_links(kind):
        def edit(f):
            f.links[:] = [ln for ln in f.links if ln[0] != kind]
        return edit

    return {
        "output 190 x 128": ("grid_420.avif", output(190, 128), "open"),
        "output 150 x 100": ("grid_420.avif", output(150, 100), "open"),
        "output 130 x 66": ("grid_420.avif", output(130, 66), "open"),
        "output 129 x 65": ("grid_420.avif", output(129, 65), "refused"),
        "output 128 x 64": ("grid_420.avif", output(128, 64), "refused"),
        "output 200 x 128": ("grid_420.avif", output(200, 128), "refused"),
        "output 191 x 128": ("grid_420.avif", output(191, 128), "refused"),
        "444 output 127 x 65": ("grid_444.avif", output(127, 65), "open"),
        "422 output 128 x 65": ("grid_422.avif", output(128, 65), "open"),
        "422 output 127 x 65": ("grid_422.avif", output(127, 65), "refused"),
        "400 output 65 x 127": ("grid_400.avif", output(65, 127), "open"),
        "colour and alpha output 126 x 126": ("grid_rgba.avif", both(
            output(126, 126), lambda f: f.data.__setitem__(6, f.data[1])),
            "open"),
        "colour output 126 x 126 only": ("grid_rgba.avif", output(126, 126),
                                         "refused"),
        "output 150 x 100, ispe 192 x 128": (
            "grid_420.avif", output(150, 100, ispe=False), "refused"),
        "output 192 x 128, ispe 150 x 100": ("grid_420.avif", ispe(150, 100),
                                             "open"),
        "output 192 x 128, ispe 64 x 64": ("grid_420.avif", ispe(64, 64),
                                           "open"),
        "32-bit output": ("grid_420.avif", lambda f: f.output(192, 128, 1),
                          "open"),
        "version 1": ("grid_420.avif", lambda f: f.output(192, 128,
                                                          version=1),
                      "refused"),
        "payload past its sizes": ("grid_420.avif", tile_data(
            1, lambda f: f.data[1] + b"\0"), "refused"),
        "payload cut": ("grid_420.avif", tile_data(1, lambda f: f.data[1][:7]),
                        "refused"),
        "payload in idat": ("grid_rgba.avif",
                            lambda f: f.in_idat.update((1, 6)), "open"),
        "too few dimg": ("grid_420.avif", links(lambda t: t[:-1]), "refused"),
        "a tile of both grids": ("grid_rgba.avif", links(lambda t: t + [7]),
                          "refused"),
        "a tile twice": ("grid_420.avif", links(lambda t: t[:-1] + t[:1]),
                         "refused"),
        "tiles reordered": ("grid_420.avif", links(lambda t: t[::-1]),
                            "open"),
        "dimg to the grid": ("grid_420.avif", links(lambda t: t[:-1] + [1]),
                             "refused"),
        "two dimg boxes": ("grid_420.avif", split_dimg, "refused"),
        "tile without av1C": ("grid_420.avif", drop(4, b"av1C"), "refused"),
        "tile without ispe": ("grid_420.avif", drop(4, b"ispe"), "refused"),
        "tile of another av1C": ("grid_420.avif", tile_prop(
            4, b"av1C", bytes.fromhex("81004c00")), "refused"),
        "tile of another ispe": ("grid_420.avif", tile_prop(
            4, b"ispe", struct.pack(">III", 0, 64, 32)), "refused"),
        "tile of another depth": ("grid_420.avif", tile_data(
            4, lambda f: _first_tile("grid_10_420.avif")), "refused"),
        "tile of another layout": ("grid_420.avif", tile_data(
            4, lambda f: _first_tile("grid_444.avif")), "refused"),
        "tile of another size": ("grid_420.avif", both(tile_data(
            4, lambda f: _first_tile("s6_q50.avif")), tile_prop(
                4, b"ispe", struct.pack(">III", 0, 130, 67))), "refused"),
        "tile of another range": ("grid_420.avif", tile_data(
            4, lambda f: _first_tile("grid_limited.avif")), "refused"),
        "tile without a sequence header": ("grid_420.avif", tile_data(
            4, lambda f: strip_header(f.data[4])), "open"),
        "first tile without a sequence header": ("grid_420.avif", tile_data(
            2, lambda f: strip_header(f.data[2])), "refused"),
        "alpha tile without a sequence header": ("grid_rgba.avif", tile_data(
            8, lambda f: strip_header(f.data[8])), "open"),
        "first alpha tile without it": ("grid_rgba.avif", tile_data(
            7, lambda f: strip_header(f.data[7])), "refused"),
        "first LA alpha tile without it": ("grid_12_la.avif", tile_data(
            7, lambda f: strip_header(f.data[7])), "open"),
        "a tile and the next": ("grid_420.avif", tile_data(
            2, lambda f: f.data[2] + f.data[3]), "open"),
        "a tile and the next cut": ("grid_420.avif", tile_data(
            2, lambda f: f.data[2] + f.data[3][:-9]), "refused"),
        "empty tile": ("grid_420.avif", tile_data(3, lambda f: b""),
                       "refused"),
        "tile is an Exif item": ("grid_420.avif", retype(5, b"Exif"),
                                 "refused"),
        "colour range flipped": ("grid_420.avif", lambda f: f.prop(
            b"colr", b"nclx\0\1\0\x0d\0\1\0", 1), "open"),
        "matrix 9": ("grid_limited.avif", lambda f: f.prop(
            b"colr", b"nclx\0\1\0\x0d\0\x09\0", 1), "open"),
        "prem dropped": ("grid_prem.avif", drop_links(b"prem"), "open"),
        "alpha not auxl": ("grid_rgba.avif", drop_links(b"auxl"), "open"),
        "alpha of each tile": ("grid_rgba.avif", tile_alphas(each), "open"),
        "alpha of each tile but one": ("grid_rgba.avif",
                                       tile_alphas(each[:3]), "open"),
        "alpha of each tile, permuted": ("grid_rgba.avif", tile_alphas(
            list(zip((10, 9, 8, 7), (2, 3, 4, 5)))), "open"),
        "alpha of each tile, tiles reordered": ("grid_rgba.avif", tile_alphas(
            each, colour=(3, 2, 5, 4)), "open"),
        "a tile with two alphas": ("grid_rgba.avif", tile_alphas(
            each + [(6, 2)]), "refused"),
        "a tile's alpha in a grid": ("grid_rgba.avif", tile_alphas(
            each, alpha_grid=True), "refused"),
        "iref of version 2": ("grid_420.avif",
                              lambda f: setattr(f, "iref_version", 2),
                              "refused"),
    }


GRID_CASES = _grid_cases()


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_grid_edit_equals_jax(tmp_path, case):
    """libavif 1.3.0's grid items, as Pillow's opens of edited files show:
    the output is cropped from the tiles at the right and bottom (and
    converted over the crop), which must cover it with every tile row and
    column and, where the chroma is subsampled, be even (an alpha grid
    need not, but must match the colour's size); Pillow reads the decode
    at the grid item's `ispe` (a larger one is a truncated file); `dimg`
    must list as many av01 tiles as the grid has, each once, and tiles
    share their `av1C` fields, size, depth, layout and range; a tile may
    lean on the sequence header of the tile before it (one dav1d decodes
    them all), and whatever follows a tile's frame must parse."""
    name, edit, want = GRID_CASES[case]
    blob = (AVIF_DIR / name).read_bytes()
    f = Grid(blob)
    edit(f)
    kind, why = _outcome(_write(tmp_path, f.build()))
    assert kind == want, why


def test_grid_crop_is_converted_over_the_crop(tmp_path):
    """A 150 x 100 output differs from the crop of the whole grid's decode
    at its last row and column only (the chroma upsampling reads past the
    crop's edge in the whole image, not in the crop)."""
    f = Grid((AVIF_DIR / "grid_420.avif").read_bytes())
    whole = _equal_to_jax(AVIF_DIR / "grid_420.avif")
    f.output(150, 100)
    f.prop(b"ispe", struct.pack(">III", 0, 150, 100), 1)
    got = _equal_to_jax(_write(tmp_path, f.build()))
    diff = np.any(got != whole[:100, :150], axis=2)
    assert diff[-1].any() and diff[:, -1].any() and not diff[:-1, :-1].any()


@pytest.mark.parametrize("chunk", range(4))
def test_bit_flips_of_grid_boxes_agree_with_jax(tmp_path, chunk):
    """200 single-bit flips of an RGBA grid file's `iref` box and `grid`
    payload (libavif 0.11.1 stores one for the colour and alpha grids, both
    2 x 2 of 128^2), 50 a case: both readers open the file bit-equal or
    both refuse it."""
    blob = (AVIF_DIR / "grid_rgba.avif").read_bytes()
    iref = blob.find(b"iref") - 4
    size = struct.unpack(">I", blob[iref:iref + 4])[0]
    payload = Grid(blob).data[1]
    at = blob.find(payload, _top(blob, b"mdat")[0])
    positions = [*range(iref, iref + size), *range(at, at + len(payload))]
    rng = np.random.default_rng(2600 + chunk)
    seen = {"open": 0, "refused": 0, "not yet": 0}
    for k in range(50):
        b = bytearray(blob)
        b[positions[int(rng.integers(0, len(positions)))]] ^= \
            1 << int(rng.integers(0, 8))
        kind, why = _outcome(_write(tmp_path, bytes(b), f"f{k}.avif"))
        seen[kind] += 1
        assert kind != "not yet", why
    assert seen["open"] and seen["refused"], seen


@pytest.mark.parametrize("alg", ["average", "cubic", "nearest"])
@pytest.mark.parametrize("band", [1, 4])
def test_decimated_read_of_grid_equals_jax(alg, band):
    """read_band_resampled of an RGBA grid's colour and alpha bands."""
    _decimated_read_equals_jax("grid_rgba.avif", band, 40, 25, alg)


# ---------------------------------------------------------------------------
# image sequences
# ---------------------------------------------------------------------------
def _track_edit(name: str, fn) -> bytes:
    blob = (AVIF_DIR / name).read_bytes()
    tree = parse_boxes(blob)
    fn(tree)
    return rebuild(tree, blob)


def _seq_cases() -> dict:
    """Name -> (file, edit of the box tree, the outcome both readers agree
    on)."""
    stbl = (b"mdia", b"minf", b"stbl")

    def at(k, *path):
        return lambda t: find(tracks(t)[k][2], *path)

    def rename(k, *path, to=b"free"):
        def edit(t):
            at(k, *path)(t)[0] = to
        return edit

    def patch(k, path, offset, value):
        def edit(t):
            node = at(k, *path)(t)
            b = bytearray(node[1])
            b[offset:offset + len(value)] = value
            node[1] = bytes(b)
        return edit

    def dup(k, *path):
        def edit(t):
            parent = at(k, *path[:-1])(t) if len(path) > 1 else tracks(t)[k]
            parent[2].append(copy.deepcopy(at(k, *path)(t)))
        return edit

    def tref(k, kind, to):
        def edit(t):
            tracks(t)[k][2].insert(1, [b"tref", b"", [[kind, struct.pack(
                ">I", to)]]])
        return edit

    def entry(k, fn):
        def edit(t):
            node = at(k, *stbl, b"stsd", b"av01")(t)
            node[2] = fn(node[2])
        return edit

    u32 = struct.Struct(">I").pack
    p, pr, svt = "seq_pillow.avif", "seq_pillow_rgba.avif", "seq_svt.avif"
    return {
        "mvhd dropped": (p, lambda t: find(t, b"moov", b"mvhd").__setitem__(
            0, b"free"), "open"),
        "tkhd dropped": (p, rename(0, b"tkhd"), "refused"),
        "tkhd version 2": (p, patch(0, [b"tkhd"], 0, b"\2"), "refused"),
        "tkhd width 0": (p, patch(0, [b"tkhd"], 88, bytes(4)), "refused"),
        "tkhd width 48.5": (p, patch(0, [b"tkhd"], 88, b"\0\x30\x80\0"),
                            "open"),
        "tkhd duration 0 under a repeating elst": (
            p, patch(0, [b"tkhd"], 28, bytes(8)), "refused"),
        "tkhd track 0": (p, patch(0, [b"tkhd"], 20, bytes(4)), "refused"),
        "two tkhd": (p, dup(0, b"tkhd"), "refused"),
        "mdhd dropped": (p, rename(0, b"mdia", b"mdhd"), "refused"),
        "mdhd timescale 0": (p, patch(0, [b"mdia", b"mdhd"], 20, bytes(4)),
                             "refused"),
        "mdhd version 2": (p, patch(0, [b"mdia", b"mdhd"], 0, b"\2"),
                           "refused"),
        "hdlr vide": (p, patch(0, [b"mdia", b"hdlr"], 8, b"vide"), "open"),
        "hdlr pre_defined": (p, patch(0, [b"mdia", b"hdlr"], 4, b"\1"),
                             "refused"),
        "stbl dropped": (p, rename(0, *stbl), "refused"),
        "two stbl": (p, dup(0, *stbl), "refused"),
        "stco dropped": (p, rename(0, *stbl, b"stco"), "refused"),
        "stco version 1": (p, patch(0, [*stbl, b"stco"], 0, b"\1"),
                           "refused"),
        "stco past the file": (p, patch(0, [*stbl, b"stco"], 8, u32(1 << 20)),
                               "refused"),
        "stsc first chunk 2": (p, patch(0, [*stbl, b"stsc"], 8, u32(2)),
                               "refused"),
        "stsc no samples": (p, patch(0, [*stbl, b"stsc"], 12, u32(0)),
                            "refused"),
        "stsc one sample": (p, patch(0, [*stbl, b"stsc"], 12, u32(1)),
                            "open"),
        "stsc more samples than sizes": (
            p, patch(0, [*stbl, b"stsc"], 12, u32(9)), "refused"),
        "stsz empty sample 1": (p, patch(0, [*stbl, b"stsz"], 16, u32(0)),
                                "refused"),
        "stsz one size for all": (p, patch(0, [*stbl, b"stsz"], 4, u32(100)),
                                  "refused"),
        "stss and stts dropped": (p, lambda t: (rename(0, *stbl, b"stss")(t),
                                                rename(0, *stbl, b"stts")(t)),
                                  "open"),
        "stsd version 1": (p, patch(0, [*stbl, b"stsd"], 0, b"\1"), "open"),
        "stsd version 2": (p, patch(0, [*stbl, b"stsd"], 0, b"\2"),
                           "refused"),
        "sample entry av02": (p, rename(0, *stbl, b"stsd", b"av01",
                                        to=b"av02"), "refused"),
        "sample entry without av1C": (p, entry(0, lambda e: [
            x for x in e if x[0] != b"av1C"]), "refused"),
        "sample entry with two colr": (p, entry(0, lambda e: e + [
            x for x in e if x[0] == b"colr"]), "refused"),
        "svt entry without colr": (svt, entry(0, lambda e: [
            x for x in e if x[0] != b"colr"]), "open"),
        "elst dropped": (p, rename(0, b"edts", b"elst"), "refused"),
        "edts dropped": (p, rename(0, b"edts"), "open"),
        "elst not repeating": (p, patch(0, [b"edts", b"elst"], 3, b"\0"),
                               "open"),
        "elst of two entries": (p, patch(0, [b"edts", b"elst"], 4, u32(2)),
                                "refused"),
        "colour track auxiliary": (p, tref(0, b"auxl", 7), "refused"),
        "alpha auxi of another kind": (pr, entry(1, lambda e: [
            [b"auxi", b"\0\0\0\0urn:other\0"] if x[0] == b"auxi" else x
            for x in e]), "open"),
        "alpha auxi dropped": (pr, entry(1, lambda e: [
            x for x in e if x[0] != b"auxi"]), "open"),
        "alpha tref dropped": (pr, lambda t: tracks(t)[1][2].__setitem__(
            slice(None), [x for x in tracks(t)[1][2] if x[0] != b"tref"]),
            "open"),
        "alpha premultiplied": (pr, tref(0, b"prem", 2), "open"),
        "alpha tkhd of another size": (pr, patch(1, [b"tkhd"], 88,
                                                 b"\0\x60\0\0"), "refused"),
        "alpha sample 1 empty": (pr, patch(1, [*stbl, b"stsz"], 16, u32(0)),
                                 "refused"),
        "tracks swapped": (pr, lambda t: find(t, b"moov")[2].reverse(),
                           "open"),
        "major brand mif1": (p, None, "open"),
    }


SEQ_CASES = _seq_cases()


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_sequence_edit_equals_jax(tmp_path, case):
    """libavif 1.3.0's tracks, as Pillow's opens of edited files show: one
    `tkhd` (its size, a duration where the edit list repeats) and `stbl`
    per track, `mvhd` unread, the sample tables of version 0 (stsd up to
    1) that give every sample data inside the file, an `av01` entry with
    `av1C` and at most one `colr` (SVT-AV1's sequence header has no colour
    description: the entry's `colr` decides the conversion), the colour
    track the first that is no auxiliary track, the alpha one the first
    whose `auxl` is to it, the image at the colour track's `tkhd` size and
    Pillow's load dividing by its `mdhd` timescale."""
    name, edit, want = SEQ_CASES[case]
    if edit is None:
        b = bytearray((AVIF_DIR / name).read_bytes())
        b[8:12] = b"mif1"
        out = bytes(b)
    else:
        out = _track_edit(name, edit)
    kind, why = _outcome(_write(tmp_path, out))
    assert kind == want, why


def _item_is_another_frame() -> bytes:
    """seq_pillow.avif with its `meta` item pointed at other AV1 data of its
    size (the alpha track's first sample of seq_pillow_rgba.avif), appended
    to mdat: the item and the track's sample 0 differ."""
    blob = (AVIF_DIR / "seq_pillow.avif").read_bytes()
    other = avif.parse((AVIF_DIR / "seq_pillow_rgba.avif").read_bytes()).alpha
    b = bytearray(blob + other)
    start, _ = _top(blob, b"mdat")
    struct.pack_into(">I", b, start, len(b) - start)
    iloc = blob.find(b"iloc") + 4
    struct.pack_into(">II", b, iloc + 14, len(blob), len(other))
    return bytes(b)


@pytest.mark.parametrize("major", [b"avis", b"avif", b"mif1", b"msf1"])
def test_item_and_track_that_differ_equal_jax(tmp_path, major):
    """A sequence whose `meta` item is not its first sample: libavif reads
    the track where the major brand is `avis`, `mif1` or `msf1`, and the
    item (a gray frame) where it is `avif`."""
    b = bytearray(_item_is_another_frame())
    b[8:12] = major
    got = _equal_to_jax(_write(tmp_path, bytes(b)))
    track = hashlib.sha256(got.tobytes()).hexdigest() == \
        chip_smoke.AVIF_FIXTURES["seq_pillow.avif"]
    assert track == (major != b"avif")
    assert (major != b"avif") or np.array_equal(got[..., 0], got[..., 2])


@pytest.mark.parametrize("chunk", range(4))
def test_bit_flips_of_moov_agree_with_jax(tmp_path, chunk):
    """200 single-bit flips of the `moov` box of Pillow's RGBA sequence (50
    a case): both readers open the file bit-equal (a flipped `tkhd` size
    scales the frame) or both refuse it."""
    blob = (AVIF_DIR / "seq_pillow_rgba.avif").read_bytes()
    lo, hi = _top(blob, b"moov")
    rng = np.random.default_rng(2700 + chunk)
    seen = {"open": 0, "refused": 0, "not yet": 0}
    for k in range(50):
        b = bytearray(blob)
        b[int(rng.integers(lo, hi))] ^= 1 << int(rng.integers(0, 8))
        kind, why = _outcome(_write(tmp_path, bytes(b), f"f{k}.avif"))
        seen[kind] += 1
        assert kind != "not yet", why
    assert seen["open"] and seen["refused"], seen


@pytest.mark.parametrize("header,words", [
    (b"\x80", "show_existing_frame"),
    (b"\x00", "key frame that is not shown"),
])
def test_hidden_or_existing_frame_is_named(header, words):
    """Sample 0 of aom's sequence with its frame header turned into a
    `show_existing_frame` or a hidden key frame: the port names both (the
    first sample of every sequence here is a shown key frame)."""
    p = avif.parse((AVIF_DIR / "seq_aom.avif").read_bytes())
    obus, w, h = p.obus, p.width, p.height
    # temporal delimiter, sequence header, then the frame OBU's header byte
    # made a frame header OBU (type 3) of one byte
    head = 2 + 2 + obus[3]
    data = obus[:head] + b"\x1a\x01" + header
    with pytest.raises(ValueError, match=f"{words} is {NOT_YET}"):
        _native.av1_decode(data, w, h, -1, -1)


def test_frame_of_another_size_than_tkhd_is_named(tmp_path):
    """A `tkhd` of 96 x 32 over frames of 48 x 32: libavif scales the frame
    (up 2x along the rows), Pillow opens it at 96 x 32, and the port's
    decode is bit-equal to the JAX reader's."""
    out = _track_edit("seq_pillow.avif", lambda t: (
        lambda n: n.__setitem__(1, n[1][:88] + b"\0\x60\0\0" + n[1][92:]))(
            find(tracks(t)[0][2], b"tkhd")))
    path = _write(tmp_path, out)
    with Image.open(path) as im:
        assert im.size == (96, 32)
    got = _equal_to_jax(path)
    assert got.shape == (32, 96, 3)


@pytest.mark.parametrize("alg", ["average", "cubic", "nearest"])
@pytest.mark.parametrize("band", [1, 4])
def test_decimated_read_of_sequence_equals_jax(alg, band):
    """read_band_resampled of an RGBA sequence's first frame."""
    _decimated_read_equals_jax("seq_rgba.avif", band, 40, 25, alg)


def test_boxes_round_trip():
    """The box tree helpers rebuild every container file byte for byte."""
    for name in NAMES:
        blob = (AVIF_DIR / name).read_bytes()
        assert rebuild(parse_boxes(blob), blob) == blob, name
