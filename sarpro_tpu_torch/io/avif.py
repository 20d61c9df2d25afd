"""AVIF reader: the still image Pillow 12.1 opens from an .avif file (its
AvifImagePlugin over libavif 1.3.0, which decodes with dav1d 1.5.1 and
converts with libyuv), decoded by the port's C++ library
(`_native/av1dec.cpp`, built at first use).

Accepted as Pillow accepts it (`pilraster._ACCEPT["AVIF"]`). Then, as
libavif's avifDecoderParse reads the file (read.c):

  * top-level boxes up to the point where the brands are satisfied: `ftyp`
    first, with the brand `avif` (or `avis`) among its brands; a `meta`
    box where `avif` is one; parsing stops there, so nothing past it is
    read;
  * `meta` (version 0) with `hdlr` `pict` first, then at most one each of
    `iloc` (versions 0-2, construction methods 0 and 1, several extents),
    `pitm`, `idat`, `iprp` (`ipco`, then `ipma` boxes: `ispe`, `pixi`,
    `av1C`, `colr` nclx / ICC, `irot`, `imir`, `clap`, `pasp`, `auxC`,
    ...), `iinf` (`infe` versions 2-3) and `iref`;
  * the primary item must be an `av01` item with `ispe` and `av1C`, its
    data inside the file; an `Exif` item that describes it must hold a
    TIFF header where its offset says (Pillow then loads it as EXIF).

  * the alpha item: the first item with data, of type `av01` or `grid`,
    no unsupported essential property and no `thmb` reference, whose
    `auxC` names alpha and whose `auxl` reference is to the primary item;
    it must have `av1C` and an `ispe` within the limits, and a `pixi` of
    its `av1C` depth.

A file libavif refuses at this point is refused as Pillow refuses it
(SyntaxError: the next plugin is tried; RuntimeError / ValueError: the open
fails). An item keeps the last reference of each type in `iref`, as
libavif's do. The mode is Pillow's "RGBA" where there is an alpha item,
else "RGB"; the features the port does not read yet raise by name: grid
items, `avis` image sequences, samples other than 8-bit (from `av1C`). The
items' OBUs go to `av1dec.cpp` with the matrix and range of the `colr`
nclx box (the sequence header's where there is none) and whether the
colour item's last `prem` reference is to the alpha item (libavif then
unpremultiplies the RGB through libyuv's ARGBUnattenuate: its table and
rounding read off Pillow's decodes of all 65536 (colour, alpha) pairs,
test_torch_avif_tools.py); the sample layout (4:2:0, 4:2:2, 4:4:4,
monochrome) is the sequence header's. An alpha item of another size than
the image fails the load, as in libavif. `irot`, `imir` and `clap` change
no pixels (Pillow turns the first two into an EXIF orientation). Pillow's
`info` holds ICC, EXIF and XMP as bytes, so the text is empty.

Film grain is applied, to the alpha item's stream too: libavif 1.3.0 leaves
dav1d's `apply_grain` at its default (on). Pillow's decode of a 4:0:0 file
with aom's `film-grain-test 10` equals the luma Debian's dav1d 1.0.0 gives
with `apply_grain` 1 and differs from its luma with 0 by up to 6 at 7102 of
8710 samples."""
from __future__ import annotations

import struct
from typing import NamedTuple, Optional

from .. import _native
from ..errors import RasterError
from . import pixels

PARSE_FAILED = "Failed to decode image: BMFF parsing failed"
TRUNCATED = "Failed to decode image: Truncated data"
INVALID_FTYP = "Failed to decode image: Invalid ftyp"
MISSING_ITEM = "Failed to decode image: Missing or empty image item"
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")
TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x00\x2b", b"II\x2b\x00")
# libavif's decoder limits (avif.h): AVIF_DEFAULT_IMAGE_SIZE_LIMIT and
# AVIF_DEFAULT_IMAGE_DIMENSION_LIMIT
IMAGE_SIZE_LIMIT = 16384 * 16384
IMAGE_DIMENSION_LIMIT = 32768
# the properties libavif parses; an unknown one flagged essential makes
# its item unusable
SUPPORTED = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot",
             b"imir", b"pixi", b"a1op", b"lsel", b"a1lx", b"clli")
MUST_NOT_BE_ESSENTIAL = (b"a1lx", b"clli")
MUST_BE_ESSENTIAL = (b"a1op", b"lsel", b"clap", b"irot", b"imir")
# the boxes a meta box holds at most once
UNIQUE = (b"hdlr", b"dinf", b"iloc", b"pitm", b"idat", b"iprp", b"iinf",
          b"iref")


def _fail(msg: str = PARSE_FAILED):
    raise SyntaxError(msg)


class Stream:
    """libavif's avifROStream over blob[pos:end]: every read past the end
    fails the parse."""

    def __init__(self, blob, pos: int, end: int):
        self.b, self.pos, self.end = blob, pos, end

    def left(self) -> int:
        return self.end - self.pos

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > self.end:
            _fail()
        out = bytes(self.b[self.pos:self.pos + n])
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big") if n else 0

    def version_flags(self) -> tuple:
        v = self.uint(4)
        return v >> 24, v & 0xFFFFFF

    def string(self) -> bytes:
        nul = self.b.find(b"\0", self.pos, self.end)
        if nul < 0:
            _fail()
        out = bytes(self.b[self.pos:nul])
        self.pos = nul + 1
        return out

    def box(self, top: bool = False) -> tuple:
        """(type, payload start, payload end) of the next box header."""
        start = self.pos
        size = self.uint(4)
        kind = self.take(4)
        if size == 1:
            size = self.uint(8)
        if kind == b"uuid":
            self.take(16)
        head = self.pos - start
        if size == 0 and top:
            return kind, self.pos, None
        if size < head:
            _fail()
        end = start + size
        if not top and end > self.end:
            _fail()
        return kind, self.pos, end


class Item:
    def __init__(self, item_id: int):
        self.id = item_id
        self.type = b""
        self.content_type = b""
        self.extents = []
        self.idat = False
        self.props = []  # (type, payload) in association order
        self.ipma_seen = False
        self.unsupported_essential = False
        self.refs = {}  # reference type -> to item id

    def prop(self, kind: bytes):
        for k, payload in self.props:
            if k == kind:
                return payload
        return None


class Meta:
    def __init__(self):
        self.items = {}
        self.primary = 0
        self.idat = None
        self.properties = []

    def item(self, item_id: int) -> Item:
        if item_id not in self.items:
            self.items[item_id] = Item(item_id)
        return self.items[item_id]


def _parse_iloc(meta: Meta, s: Stream) -> None:
    version, _ = s.version_flags()
    if version > 2:
        _fail()
    a, b = s.uint(1), s.uint(1)
    offset_size, length_size, base_size = a >> 4, a & 15, b >> 4
    index_size = b & 15 if version in (1, 2) else 0
    for n in (offset_size, length_size, base_size, index_size):
        if n not in (0, 4, 8):
            _fail()
    count = s.uint(2 if version < 2 else 4)
    for _ in range(count):
        item_id = s.uint(2 if version < 2 else 4)
        if item_id == 0:
            _fail()
        item = meta.item(item_id)
        if item.extents:
            _fail()
        if version in (1, 2):
            method = s.uint(2) & 15
            if method not in (0, 1):
                _fail()
            item.idat = method == 1
        s.uint(2)  # data_reference_index
        base = s.uint(base_size)
        for _ in range(s.uint(2)):
            if index_size:
                s.uint(index_size)
            offset = s.uint(offset_size)
            length = s.uint(length_size)
            item.extents.append((base + offset, length))


def _parse_property(kind: bytes, payload: bytes) -> object:
    """A property's parsed value (raw bytes of those read later), or
    SyntaxError where libavif fails to parse it."""
    s = Stream(payload, 0, len(payload))
    if kind == b"ispe":
        if s.version_flags()[0] != 0:
            _fail()
        return s.uint(4), s.uint(4)
    if kind == b"av1C":
        raw = s.take(4)
        if raw[0] != 0x81:
            _fail()
        return raw
    if kind == b"pixi":
        if s.version_flags()[0] != 0:
            _fail()
        n = s.uint(1)
        if n > 4:
            _fail()
        return list(s.take(n))
    if kind == b"colr":
        ctype = s.take(4)
        if ctype == b"nclx":
            p, t, m, r = s.uint(2), s.uint(2), s.uint(2), s.uint(1)
            if r & 0x7F:
                _fail()
            return ("nclx", p, t, m, r >> 7)
        if ctype in (b"rICC", b"prof"):
            return ("icc", payload[4:])
        return ("other",)
    if kind == b"auxC":
        if s.version_flags()[0] != 0:
            _fail()
        return s.string()
    if kind in (b"irot", b"imir"):
        v = s.uint(1)
        if v & (0xFC if kind == b"irot" else 0xFE):  # reserved bits
            _fail()
        return v
    if kind == b"clap":
        return s.take(32)
    if kind == b"pasp":
        return s.take(8)
    return payload


def _parse_iprp(meta: Meta, s: Stream) -> None:
    kind, start, end = s.box()
    if kind != b"ipco":
        _fail()
    c = Stream(s.b, start, end)
    while c.left() > 0:
        pk, ps, pe = c.box()
        payload = bytes(s.b[ps:pe])
        value = _parse_property(pk, payload) if pk in SUPPORTED else None
        meta.properties.append((pk, value))
        c.pos = pe
    s.pos = end
    prev = 0
    while s.left() > 0:
        kind, start, end = s.box()
        if kind != b"ipma":
            _fail()
        a = Stream(s.b, start, end)
        version, flags = a.version_flags()
        for _ in range(a.uint(4)):
            item_id = a.uint(2 if version < 1 else 4)
            if item_id == 0 or item_id <= prev:
                _fail()
            prev = item_id
            item = meta.item(item_id)
            if item.ipma_seen:
                _fail()
            item.ipma_seen = True
            for _ in range(a.uint(1)):
                if flags & 1:
                    v = a.uint(2)
                    essential, index = v >> 15, v & 0x7FFF
                else:
                    v = a.uint(1)
                    essential, index = v >> 7, v & 0x7F
                if index == 0:
                    continue
                if index > len(meta.properties):
                    _fail()
                pk, value = meta.properties[index - 1]
                if pk in SUPPORTED:
                    if essential and pk in MUST_NOT_BE_ESSENTIAL:
                        _fail()
                    if not essential and pk in MUST_BE_ESSENTIAL:
                        _fail()
                    item.props.append((pk, value))
                elif essential:
                    item.unsupported_essential = True
        s.pos = end


def _parse_iinf(meta: Meta, s: Stream) -> None:
    version, _ = s.version_flags()
    for _ in range(s.uint(2 if version == 0 else 4)):
        kind, start, end = s.box()
        if kind != b"infe":
            _fail()
        e = Stream(s.b, start, end)
        v, _ = e.version_flags()
        if v not in (2, 3):
            _fail()
        item_id = e.uint(2 if v == 2 else 4)
        if item_id == 0:
            _fail()
        e.uint(2)  # item_protection_index
        item_type = e.take(4)
        e.string()  # item_name
        content_type = e.string() if item_type == b"mime" else b""
        item = meta.item(item_id)
        if item.type:
            _fail()
        item.type, item.content_type = item_type, content_type
        s.pos = end


def _parse_iref(meta: Meta, s: Stream) -> None:
    """libavif reads each reference box's fields on from its header, not
    from its size (a short count leaves the rest to be read as the next
    box); item IDs are 32-bit in version 1 only, and never 0. An item keeps
    the last reference of each type (libavif overwrites its thumbnailForID,
    auxForID, descForID and premByID at each one)."""
    version, _ = s.version_flags()
    n = 4 if version == 1 else 2
    while s.left() > 0:
        kind, _, _ = s.box()
        from_id = s.uint(n)
        if from_id == 0:
            _fail()
        for _ in range(s.uint(2)):
            to_id = s.uint(n)
            if to_id == 0:
                _fail()
            meta.item(from_id).refs[kind] = to_id


def _parse_meta(blob, start: int, end: int) -> Meta:
    s = Stream(blob, start, end)
    if s.version_flags()[0] != 0:
        _fail()
    meta = Meta()
    seen = set()
    first = True
    while s.left() > 0:
        kind, bstart, bend = s.box()
        body = Stream(blob, bstart, bend)
        if first:
            if kind != b"hdlr":
                _fail()
            first = False
        if kind in UNIQUE:
            if kind in seen:
                _fail()
            seen.add(kind)
        if kind == b"hdlr":
            if body.version_flags()[0] != 0:
                _fail()
            if body.uint(4) != 0 or body.take(4) != b"pict":  # pre_defined
                _fail()
            body.take(12)
            body.string()
        elif kind == b"iloc":
            _parse_iloc(meta, body)
        elif kind == b"pitm":
            version, _ = body.version_flags()
            meta.primary = body.uint(2 if version == 0 else 4)
        elif kind == b"idat":
            meta.idat = bytes(blob[bstart:bend])
        elif kind == b"iprp":
            _parse_iprp(meta, body)
        elif kind == b"iinf":
            _parse_iinf(meta, body)
        elif kind == b"iref":
            _parse_iref(meta, body)
        s.pos = bend
    if first:
        _fail()
    return meta


def _brands(payload: bytes) -> list:
    if len(payload) < 8 or (len(payload) - 8) % 4:
        _fail()
    return [payload[:4]] + [payload[k:k + 4]
                            for k in range(8, len(payload), 4)]


def _item_data(blob, meta: Meta, item: Item) -> bytes:
    """An item's bytes from its extents; SyntaxError where they lie past
    the file (libavif's truncated data)."""
    src = meta.idat if item.idat else blob
    if item.idat and src is None:
        _fail()
    out = bytearray()
    for offset, length in item.extents:
        if offset + length > len(src):
            _fail(TRUNCATED if not item.idat else PARSE_FAILED)
        out += src[offset:offset + length]
    return bytes(out)


class Parsed(NamedTuple):
    """What libavif's parse of an AVIF file gives the decode."""
    width: int
    height: int
    obus: bytes  # the primary item's AV1 data
    matrix: int  # the `colr` nclx matrix coefficients, or -1
    full_range: int  # the `colr` nclx range flag, or -1
    alpha: Optional[bytes]  # the alpha item's AV1 data, or None
    alpha_size: Optional[tuple]  # the alpha item's `ispe`
    premultiplied: bool = False  # a `prem` reference to the alpha item


def parse(blob: bytes) -> Parsed:
    """The file as libavif parses it; SyntaxError / RuntimeError /
    ValueError where it refuses it, ValueError naming a feature the port
    does not read."""
    top = Stream(blob, 0, len(blob))
    brands, meta, moov = None, None, False
    while top.left() > 0:
        kind, start, end = top.box(top=True)
        if end is None:
            end = len(blob)
            if kind in (b"ftyp", b"meta", b"moov"):
                _fail()
        if kind in (b"ftyp", b"meta", b"moov") and end > len(blob):
            _fail(TRUNCATED)
        if brands is None and kind != b"ftyp":
            _fail(INVALID_FTYP)
        if kind == b"ftyp":
            if brands is not None:
                _fail()
            brands = _brands(blob[start:end])
            if b"avif" not in brands and b"avis" not in brands:
                _fail(INVALID_FTYP)
        elif kind == b"meta":
            if meta is not None:
                _fail()
            meta = _parse_meta(blob, start, end)
        elif kind == b"moov":
            moov = True
        if (brands is not None and (b"avif" not in brands or meta is not None)
                and (b"avis" not in brands or moov)):
            break
        top.pos = end
    else:
        if brands is None:
            _fail(INVALID_FTYP)
        if (b"avif" in brands and meta is None) or (b"avis" in brands
                                                   and not moov):
            _fail(TRUNCATED)
    if moov and (meta is None or brands[0] == b"avis"):
        raise ValueError("AVIF image sequences (avis) are not read by the "
                         "port yet")
    if meta is None:
        raise RuntimeError(MISSING_ITEM)
    color = meta.items.get(meta.primary) if meta.primary else None
    if (color is None or color.type not in (b"av01", b"grid")
            or color.unsupported_essential or b"thmb" in color.refs):
        raise RuntimeError(MISSING_ITEM)
    if color.type == b"av01" and color.prop(b"av1C") is None:
        raise RuntimeError(MISSING_ITEM)
    ispe = color.prop(b"ispe")
    if ispe is None:
        _fail()
    if color.type == b"grid":
        raise ValueError("AVIF grid items are not read by the port yet")
    colr = [v for k, v in color.props if k == b"colr"]
    nclx = [v for v in colr if v[0] == "nclx"]
    if len(nclx) > 1 or sum(v[0] == "icc" for v in colr) > 1:
        _fail()
    nclx = nclx[0] if nclx else None
    av1c = color.prop(b"av1C")
    depth = 12 if av1c[2] & 0x20 else 10 if av1c[2] & 0x40 else 8
    pixi = color.prop(b"pixi")
    if pixi is not None and any(d != depth for d in pixi):
        _fail()
    width, height = ispe
    _check_size(width, height)
    obus = _item_data(blob, meta, color)
    if not obus:
        raise RuntimeError(MISSING_ITEM)
    # libavif takes the first Exif item whatever it describes, and XMP that
    # describes the image; an item without data is none
    exif = [i for i in meta.items.values() if i.type == b"Exif" and i.extents]
    if exif:
        _exif(_item_data(blob, meta, exif[0]))
    for item in meta.items.values():
        if (item.type == b"mime" and item.extents
                and item.content_type == b"application/rdf+xml"
                and item.refs.get(b"cdsc") == color.id):
            _item_data(blob, meta, item)
    alpha = _alpha_item(meta, color)
    alpha_obus = alpha_size = None
    premultiplied = False
    if alpha is not None:
        if alpha.type == b"grid":
            raise ValueError("AVIF grid items are not read by the port yet")
        alpha_av1c, alpha_size = alpha.prop(b"av1C"), alpha.prop(b"ispe")
        if alpha_av1c is None or alpha_size is None:
            _fail()
        alpha_depth = 12 if alpha_av1c[2] & 0x20 else \
            10 if alpha_av1c[2] & 0x40 else 8
        if any(d != alpha_depth for d in alpha.prop(b"pixi") or ()):
            _fail()
        _check_size(*alpha_size)
        alpha_obus = _item_data(blob, meta, alpha)
        premultiplied = color.refs.get(b"prem") == alpha.id
    return Parsed(width, height, obus, nclx[3] if nclx else -1,
                  nclx[4] if nclx else -1, alpha_obus, alpha_size,
                  premultiplied)


def _check_size(width: int, height: int) -> None:
    """libavif's limits on an item's `ispe`."""
    if (width == 0 or height == 0 or width > IMAGE_DIMENSION_LIMIT
            or height > IMAGE_DIMENSION_LIMIT
            or width * height > IMAGE_SIZE_LIMIT):
        _fail()


def _alpha_item(meta: Meta, color: Item):
    """libavif's alpha item of `color`: the first item with data, an AV1
    or grid type and no unsupported essential property, not a thumbnail,
    whose `auxC` names alpha and whose `auxl` reference is to `color`."""
    for item in meta.items.values():
        if (item is color or not any(n for _, n in item.extents)
                or item.unsupported_essential
                or item.type not in (b"av01", b"grid") or b"thmb" in item.refs):
            continue
        if item.prop(b"auxC") in ALPHA_URNS and \
                item.refs.get(b"auxl") == color.id:
            return item
    return None


def _exif(data: bytes) -> None:
    """libavif's Exif payload check (exif_tiff_header_offset must point at
    the first TIFF header) and Pillow's Exif.load of the rest."""
    if len(data) < 4:
        raise ValueError("Failed to decode image: Invalid Exif payload")
    offset = struct.unpack(">I", data[:4])[0]
    body = data[4:]
    first = min((i for i in (body.find(p) for p in TIFF_PREFIXES[:2])
                 if i >= 0), default=-1)
    if first < 0 or offset != first:
        raise ValueError("Failed to decode image: Invalid Exif payload")
    while body.startswith(b"Exif\0\0"):
        body = body[6:]
    if body and body[:4] not in TIFF_PREFIXES:
        raise SyntaxError(f"not a TIFF file (header {body[:8]!r} not valid)")


def read(blob: bytes) -> pixels.Opened:
    """Pillow's AvifImageFile._open and load of `blob`: "RGBA" where the
    image has an alpha item, else "RGB"."""
    p = parse(blob)
    mode = "RGB" if p.alpha is None else "RGBA"

    def load() -> pixels.Decoded:
        # libavif decodes the alpha item only at its image's size
        if p.alpha is not None and p.alpha_size != (p.width, p.height):
            raise RasterError("Failed to decode frame 0: Decoding of alpha "
                              "plane failed")
        try:
            out = _native.av1_decode(p.obus, p.width, p.height, p.matrix,
                                     p.full_range, p.alpha, p.premultiplied)
        except ValueError as e:
            raise RasterError(str(e)) from e
        return pixels.Decoded(mode, out)

    return pixels.Opened(mode, (p.width, p.height), load)
