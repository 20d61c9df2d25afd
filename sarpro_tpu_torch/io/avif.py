"""AVIF reader: the image Pillow 12.1 opens from an .avif file (its
AvifImagePlugin over libavif 1.3.0, which decodes with dav1d 1.5.1 and
converts with libyuv): a still item, a grid of items, or the first frame of
an `avis` image sequence, decoded by the port's C++ library
(`_native/av1dec.cpp`, built at first use).

Accepted as Pillow accepts it (`pilraster._ACCEPT["AVIF"]`). Then, as
libavif's avifDecoderParse reads the file (read.c):

  * top-level boxes up to the point where the brands are satisfied: `ftyp`
    first, with the brand `avif` (or `avis`) among its brands; a `meta`
    box where `avif` is one, a `moov` box where `avis` is; parsing stops
    there, so nothing past it is read;
  * `meta` (version 0) with `hdlr` `pict` first, then at most one each of
    `iloc` (versions 0-2, construction methods 0 and 1, several extents),
    `pitm`, `idat`, `iprp` (`ipco`, then `ipma` boxes: `ispe`, `pixi`,
    `av1C`, `colr` nclx / ICC, `irot`, `imir`, `clap`, `pasp`, `auxC`,
    ...), `iinf` (`infe` versions 2-3; a later entry of an item overwrites
    an earlier one) and `iref` (versions 0-1; a later version is skipped);
    every `av01` or `grid` item with data, no unsupported essential
    property and no `thmb` reference needs an `ispe` within the limits;
  * `moov` (_parse_moov): each `trak` with one `tkhd`, `mdia` (`mdhd`,
    `hdlr`, `minf` / `stbl`: stco / co64, stsc, stsz, stss, stts and stsd
    with its `av01` sample entries and their property boxes), `tref`
    (`auxl`, `prem`) and `edts` / `elst`; `mvhd` is not read.

libavif reads the tracks where the major brand is `avis`, the items where
it is `avif`, else the tracks if there are any (a `mif1` or `msf1` file of
both opens its track). From the items:

  * the primary item must be an `av01` item with `ispe` and `av1C`, or a
    `grid` item with `ispe` (_grid: the `grid` payload from `iloc`, in the
    file or in `idat`; as many `av01` tiles listing it in `dimg` as it
    has, each at its place, sharing the first tile's `av1C` fields, which
    the grid takes), its data inside the file; an `Exif` item that
    describes it must hold a TIFF header where its offset says (Pillow then
    loads it as EXIF);
  * the alpha item: the first item with data, of type `av01` or `grid`,
    no unsupported essential property and no `thmb` reference, whose
    `auxC` names alpha and whose `auxl` reference is to the primary item;
    it must have `av1C` and an `ispe` within the limits, and a `pixi` of
    its `av1C` depth. A colour grid without one takes an alpha grid made of
    an alpha item of each of its tiles, where each has one (_tile_alphas).

From the tracks (_from_tracks): the colour track is the first with a
sample table, an ID, chunks and an `av01` entry that is no `auxl` track,
the alpha track the first whose `auxl` is to it; their first samples,
checked as libavif checks every sample, decode at their `tkhd` sizes with
the colour entry's `colr` (SVT-AV1 writes no colour description in its
sequence header), and Pillow's load divides by the colour track's `mdhd`
timescale.

A file libavif refuses at this point is refused as Pillow refuses it
(SyntaxError: the next plugin is tried; RuntimeError / ValueError: the open
fails). An item keeps the last reference of each type in `iref`, as
libavif's do. The mode is Pillow's "RGBA" where there is an alpha item or
track, else "RGB". The AV1 data go to `av1dec.cpp` with the matrix,
range and primaries of the `colr` nclx box (the sequence header's where
there is none; chroma-derived NCL takes its coefficients from the
primaries), the size each frame is scaled to where it has another (the
item's `ispe`, a grid tile's, the track's `tkhd`: libavif's avifImageScale
through libyuv's box filter, after the in-loop filters and film grain, a
limited-range alpha widened first) and whether the colour image's `prem`
reference is to the alpha image
(libavif then unpremultiplies the RGB through libyuv's ARGBUnattenuate: its
table and rounding read off Pillow's decodes of all 65536 (colour, alpha)
pairs, test_torch_avif_tools.py); the sample layout (4:2:0, 4:2:2, 4:4:4,
monochrome) and depth are the sequence header's. A grid's tiles are
stitched and cropped to its output before the conversion, which libavif
runs once over the whole image; a grid whose tiles do not cover its output
as libavif requires fails the load, and Pillow reads the decode as an
image of the size it opened (the grid item's `ispe`): a larger output gives
its first bytes, a smaller one is a truncated file. An alpha image of
another size than the colour image fails the load, as in libavif. `irot`,
`imir` and `clap` change no pixels (Pillow turns the first two into an EXIF
orientation). Pillow's `info` holds ICC, EXIF and XMP as bytes, so the text
is empty. Frames coded with superres are upscaled to their width after
CDEF, and restored there. Still refused by name: a hidden key frame or
`show_existing_frame` in the first sample, a 4:2:2 block the spec gives no
chroma size, and tile data that does not end in the spec's trailing bits.

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
INVALID_GRID = "Failed to decode image: Invalid image grid"
NOT_IMPLEMENTED = "Failed to decode image: Not implemented"
NO_CONTENT = "Failed to decode image: No content"
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")
TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x00\x2b", b"II\x2b\x00")
# libavif's decoder limits (avif.h): AVIF_DEFAULT_IMAGE_SIZE_LIMIT and
# AVIF_DEFAULT_IMAGE_DIMENSION_LIMIT
IMAGE_SIZE_LIMIT = 16384 * 16384
IMAGE_DIMENSION_LIMIT = 32768
# AVIF_DEFAULT_IMAGE_COUNT_LIMIT: 12 hours of 60 frames a second
IMAGE_COUNT_LIMIT = 12 * 3600 * 60
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
        # the grid that lists this item in its `dimg` reference, and where
        self.dimg_for = 0
        self.dimg_idx = 0

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
        if not 1 <= n <= 4:
            raise RuntimeError(NOT_IMPLEMENTED)
        depths = list(s.take(n))
        if any(d != depths[0] for d in depths):  # planes of two depths
            raise RuntimeError(NOT_IMPLEMENTED)
        return depths
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
    if kind in (b"auxC", b"auxi"):
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


def _properties(blob, start: int, end: int, track: bool = False) -> list:
    """[(type, parsed value, None where libavif does not parse it)] of the
    property boxes in blob[start:end]: an `ipco`, or a track's sample entry
    after its 78 bytes of VisualSampleEntry (where `auxi` is parsed too)."""
    out = []
    c = Stream(blob, start, end)
    while c.left() > 0:
        pk, ps, pe = c.box()
        payload = bytes(blob[ps:pe])
        known = pk in SUPPORTED or (track and pk == b"auxi")
        out.append((pk, _parse_property(pk, payload) if known else None))
        c.pos = pe
    return out


def _parse_iprp(meta: Meta, s: Stream) -> None:
    kind, start, end = s.box()
    if kind != b"ipco":
        _fail()
    meta.properties = _properties(s.b, start, end)
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
        item = meta.item(item_id)  # a later entry for it overwrites it
        item.type, item.content_type = item_type, content_type
        s.pos = end


def _parse_iref(meta: Meta, s: Stream) -> None:
    """libavif reads each reference box's fields on from its header, not
    from its size (a short count leaves the rest to be read as the next
    box); item IDs are 32-bit in version 1 only, and never 0. An item keeps
    the last reference of each type (libavif overwrites its thumbnailForID,
    auxForID, descForID and premByID at each one). A `dimg` reference is
    kept on the item it points to, with its place in the list (its
    dimgForID and dimgIdx, the last place where it is listed twice): an
    item with two `dimg` boxes fails the parse, and an item listed by two
    items is not read by libavif. A box of a version past 1 is skipped."""
    version, _ = s.version_flags()
    if version > 1:
        return
    n = 4 if version == 1 else 2
    grids = set()
    while s.left() > 0:
        kind, _, _ = s.box()
        from_id = s.uint(n)
        if from_id == 0:
            _fail()
        if kind == b"dimg":
            if from_id in grids:
                _fail()
            grids.add(from_id)
        for index in range(s.uint(2)):
            to_id = s.uint(n)
            if to_id == 0:
                _fail()
            meta.item(from_id).refs[kind] = to_id
            if kind == b"dimg":
                tile = meta.item(to_id)
                if tile.dimg_for not in (0, from_id):
                    raise RuntimeError(NOT_IMPLEMENTED)
                tile.dimg_for, tile.dimg_idx = from_id, index


def _parse_hdlr(s: Stream) -> bytes:
    """A `hdlr` box's handler type (version 0, pre_defined 0, a name)."""
    if s.version_flags()[0] != 0 or s.uint(4) != 0:  # pre_defined
        _fail()
    handler = s.take(4)
    s.take(12)
    s.string()
    return handler


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
            if _parse_hdlr(body) != b"pict":
                _fail()
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


class SampleTable:
    """A track's `stbl`: chunk offsets, sample-to-chunk runs (first chunk,
    samples per chunk), sample sizes (one for all where `all_size`), and
    the sample entries (format, properties)."""

    def __init__(self):
        self.chunks = []
        self.runs = []
        self.all_size = 0
        self.sizes = []
        self.entries = []

    def properties(self) -> Optional[list]:
        """The first `av01` sample entry's properties, or None."""
        return next((p for f, p in self.entries if f == b"av01"), None)


class Track:
    """What libavif keeps of a `trak` box."""

    def __init__(self):
        self.id = 0
        self.width = self.height = 0  # tkhd, integer part
        self.duration = 0  # tkhd
        self.aux_for = self.prem_by = 0  # tref auxl / prem: the first ID
        self.timescale = 0  # mdhd
        self.repeating = False  # an elst whose flags say repeat
        self.stbl = None


def _full_box(s: Stream, version_max: int = 0) -> int:
    """A full box's version, at most `version_max`."""
    version, _ = s.version_flags()
    if version > version_max:
        _fail()
    return version


def _parse_stbl(track: Track, blob, start: int, end: int) -> None:
    """libavif's avifParseSampleTableBox: one per track; stco / co64,
    stsc, stsz, stss and stts of version 0 (stsc's first chunks 1 and
    rising), stsd of version 0 or 1, whose av01 entries are at least 78 bytes
    and hold property boxes after them."""
    if track.stbl is not None:
        _fail()
    t = track.stbl = SampleTable()
    s = Stream(blob, start, end)
    while s.left() > 0:
        kind, bs, be = s.box()
        b = Stream(blob, bs, be)
        if kind in (b"stco", b"co64"):
            _full_box(b)
            n = 8 if kind == b"co64" else 4
            t.chunks += [b.uint(n) for _ in range(b.uint(4))]
        elif kind == b"stsc":
            _full_box(b)
            for i in range(b.uint(4)):
                first, per, _ = b.uint(4), b.uint(4), b.uint(4)
                if (first != 1) if i == 0 else (first <= t.runs[-1][0]):
                    _fail()
                t.runs.append((first, per))
        elif kind == b"stsz":
            _full_box(b)
            all_size, count = b.uint(4), b.uint(4)
            if all_size:
                t.all_size = all_size
            else:
                t.sizes += [b.uint(4) for _ in range(count)]
        elif kind in (b"stss", b"stts"):
            _full_box(b)
            for _ in range(b.uint(4) * (1 if kind == b"stss" else 2)):
                b.uint(4)
        elif kind == b"stsd":
            _full_box(b, 1)
            for _ in range(b.uint(4)):
                fmt, es, ee = b.box()
                props = []
                if fmt == b"av01":
                    if ee - es < 78:
                        _fail()
                    props = _properties(blob, es + 78, ee, track=True)
                t.entries.append((fmt, props))
                b.pos = ee
        s.pos = be


def _parse_trak(blob, start: int, end: int) -> Track:
    """libavif's avifParseTrackBox: one `tkhd` (version 0 or 1, a size
    within the limits), `meta` parsed as the top-level one, `mdia` (`mdhd`
    of version 0 or 1, `hdlr`, `minf` / `stbl`), `tref` (`auxl`, `prem`)
    and at most one `edts` with one `elst`: a repeating edit list needs a
    track duration."""
    track = Track()
    tkhd = edts = False
    s = Stream(blob, start, end)
    while s.left() > 0:
        kind, bs, be = s.box()
        b = Stream(blob, bs, be)
        if kind == b"tkhd":
            if tkhd:
                _fail()
            tkhd = True
            n = 8 if _full_box(b, 1) else 4
            b.uint(2 * n)  # creation and modification times
            track.id = b.uint(4)
            b.uint(4)
            track.duration = b.uint(n)
            b.take(52)
            track.width, track.height = b.uint(4) >> 16, b.uint(4) >> 16
            _check_size(track.width, track.height)
        elif kind == b"meta":
            _parse_meta(blob, bs, be)
        elif kind == b"mdia":
            _parse_mdia(track, blob, bs, be)
        elif kind == b"tref":
            while b.left() > 0:
                rk, rs, re_ = b.box()
                if rk in (b"auxl", b"prem"):
                    if re_ - rs < 4:
                        _fail()
                    first = Stream(blob, rs, re_).uint(4)
                    if rk == b"auxl":
                        track.aux_for = first
                    else:
                        track.prem_by = first
                b.pos = re_
        elif kind == b"edts":
            if edts:
                _fail()
            edts = True
            elst = False
            while b.left() > 0:
                ek, es, ee = b.box()
                if ek == b"elst":
                    if elst:
                        _fail()
                    elst = True
                    _parse_elst(track, Stream(blob, es, ee))
                b.pos = ee
            if not elst:
                _fail()
        s.pos = be
    if not tkhd or (edts and track.repeating and track.duration == 0):
        _fail()
    return track


def _parse_elst(track: Track, s: Stream) -> None:
    version, flags = s.version_flags()
    track.repeating = bool(flags & 1)
    if not track.repeating:
        return
    if s.uint(4) != 1 or version > 1 or s.uint(8 if version else 4) == 0:
        _fail()


def _parse_mdia(track: Track, blob, start: int, end: int) -> None:
    s = Stream(blob, start, end)
    while s.left() > 0:
        kind, bs, be = s.box()
        b = Stream(blob, bs, be)
        if kind == b"mdhd":
            n = 8 if _full_box(b, 1) else 4
            b.uint(2 * n)  # creation and modification times
            track.timescale = b.uint(4)
            b.uint(n)
        elif kind == b"hdlr":
            _parse_hdlr(b)
        elif kind == b"minf":
            m = Stream(blob, bs, be)
            while m.left() > 0:
                mk, ms, me = m.box()
                if mk == b"stbl":
                    _parse_stbl(track, blob, ms, me)
                m.pos = me
        s.pos = be


def _parse_moov(blob, start: int, end: int) -> list:
    """The tracks of a `moov` box (its `mvhd` is not read)."""
    tracks = []
    s = Stream(blob, start, end)
    while s.left() > 0:
        kind, bs, be = s.box()
        if kind == b"trak":
            tracks.append(_parse_trak(blob, bs, be))
        s.pos = be
    return tracks


def _first_sample(blob, t: SampleTable) -> bytes:
    """Sample 0's data, after libavif's avifCodecDecodeInputFillFromSample
    Table checks of every sample: no chunk without samples, no more
    samples than AVIF_DEFAULT_IMAGE_COUNT_LIMIT, a size for each, none past
    the file, and none empty."""
    counts = []
    for k in range(len(t.chunks)):
        n = next((per for first, per in reversed(t.runs) if first <= k + 1),
                 0)
        if n == 0 or sum(counts) + n > IMAGE_COUNT_LIMIT:
            _fail()
        counts.append(n)
    index = 0
    for offset, n in zip(t.chunks, counts):
        if t.all_size:
            sizes = [t.all_size] * n
        else:
            sizes = t.sizes[index:index + n]
            if len(sizes) < n:
                _fail()
        if offset + sum(sizes) > len(blob) or 0 in sizes:
            _fail()
        index += n
    size = t.all_size or t.sizes[0]
    return bytes(blob[t.chunks[0]:t.chunks[0] + size])


def _from_tracks(blob, tracks: list) -> Parsed:
    """libavif's avifDecoderReset on tracks: the colour track is the first
    with a sample table, an ID, chunks and an `av01` sample entry that is
    no auxiliary (`auxl`) track; the alpha track the first such one whose
    `auxl` is to the colour track (and whose `auxi`, if any, names alpha).
    Their first samples decode at their `tkhd` sizes, with the colour
    entry's `colr` and `av1C`; the colour track's `prem` to the alpha track
    marks premultiplied alpha."""
    def usable(t):
        return (t.stbl is not None and t.id and t.stbl.chunks
                and t.stbl.properties() is not None)

    color = next((t for t in tracks if usable(t) and not t.aux_for), None)
    if color is None:
        _fail(NO_CONTENT)
    props = color.stbl.properties()
    alpha = None
    for t in tracks:
        auxi = dict(t.stbl.properties()).get(b"auxi") if usable(t) else None
        if usable(t) and t.aux_for == color.id and (auxi is None
                                                    or auxi in ALPHA_URNS):
            alpha = t
            break
    obus = _first_sample(blob, color.stbl)
    alpha_obus = None if alpha is None else _first_sample(blob, alpha.stbl)
    colr = [v for k, v in props if k == b"colr"]
    nclx = [v for v in colr if v[0] == "nclx"]
    if len(nclx) > 1 or sum(v[0] == "icc" for v in colr) > 1:
        _fail()
    if not any(k == b"av1C" for k, _ in props):
        _fail()
    nclx = nclx[0] if nclx else None
    size = (color.width, color.height)
    alpha_image = None if alpha is None else Coded.single(
        alpha_obus, alpha.width, alpha.height)
    return Parsed(*size, Coded.single(obus, *size), nclx[3] if nclx else -1,
                  nclx[4] if nclx else -1, alpha_image,
                  alpha is not None and color.prem_by == alpha.id,
                  color.timescale, nclx[1] if nclx else -1)


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


class Coded(NamedTuple):
    """One coded image: an `av01` item (or a track's first sample) as a
    single tile, or a `grid` item's tiles. Its fields are what
    _native.av1_decode_grid takes."""
    tiles: tuple  # the AV1 data of each tile, in raster order
    grid: bool
    columns: int
    rows: int
    tile_width: int  # each tile's `ispe` (a track's `tkhd`): the size its
    tile_height: int  # frame is scaled to where it has another
    width: int  # the image's size: its tile's, or the grid's output
    height: int

    @classmethod
    def single(cls, obus: bytes, width: int, height: int) -> "Coded":
        return cls((obus,), False, 1, 1, width, height, width, height)


class Parsed(NamedTuple):
    """What libavif's parse of an AVIF file gives the decode."""
    width: int  # the size Pillow opens: the colour item's `ispe`, or the
    height: int  # track's `tkhd`
    color: Coded
    matrix: int  # the `colr` nclx matrix coefficients, or -1
    full_range: int  # the `colr` nclx range flag, or -1
    alpha_image: Optional[Coded]  # the alpha item or track, or None
    premultiplied: bool = False  # a `prem` reference to the alpha image
    timescale: int = 1  # the colour track's `mdhd` timescale (items: 1)
    primaries: int = -1  # the `colr` nclx colour primaries, or -1

    @property
    def obus(self) -> bytes:
        """The colour image's (first tile's) AV1 data."""
        return self.color.tiles[0]

    @property
    def alpha(self) -> Optional[bytes]:
        """The alpha image's (first tile's) AV1 data, or None."""
        return None if self.alpha_image is None else self.alpha_image.tiles[0]

    @property
    def alpha_size(self) -> Optional[tuple]:
        """The alpha image's size, or None."""
        a = self.alpha_image
        return None if a is None else (a.width, a.height)


def _depth(av1c: bytes) -> int:
    return 12 if av1c[2] & 0x20 else 10 if av1c[2] & 0x40 else 8


def _grid(blob, meta: Meta, item: Item) -> tuple:
    """A `grid` item's (columns, rows, output width, output height) and its
    tile items in `dimg` order, as libavif's avifDecoderItemReadAndParse and
    avifDecoderGenerateImageTiles read them: the `grid` payload (version 0,
    16- or 32-bit output sizes by flags & 1, nothing after them, an output
    within the limits), as many items listing it in `dimg` as it has tiles,
    each at its own place, each an `av01` item with no unsupported
    essential property and an `av1C` whose fields are the first tile's. The
    grid takes the first tile's `av1C` (avifDecoderAdoptGridTileCodecType)."""
    data = _item_data(blob, meta, item)
    s = Stream(data, 0, len(data))
    try:
        version = s.uint(1)
        if version != 0:
            raise RuntimeError(NOT_IMPLEMENTED)
        flags, rows, cols = s.uint(1), s.uint(1) + 1, s.uint(1) + 1
        n = 4 if flags & 1 else 2
        width, height = s.uint(n), s.uint(n)
    except SyntaxError:
        raise RuntimeError(INVALID_GRID) from None
    if (s.left() or width == 0 or height == 0 or width > IMAGE_DIMENSION_LIMIT
            or height > IMAGE_DIMENSION_LIMIT
            or width * height > IMAGE_SIZE_LIMIT):
        raise RuntimeError(INVALID_GRID)
    listed = [i for i in meta.items.values() if i.dimg_for == item.id]
    if len(listed) != rows * cols or all(i.type != b"av01" for i in listed):
        raise RuntimeError(INVALID_GRID)
    tiles = [None] * len(listed)
    for i in listed:
        if i.dimg_idx >= len(tiles) or tiles[i.dimg_idx] is not None:
            raise RuntimeError(INVALID_GRID)
        tiles[i.dimg_idx] = i
    item.props.append((b"av1C", _tiles_av1c(tiles)))
    return (cols, rows, width, height), tiles


def _tiles_av1c(tiles: list) -> bytes:
    """The first tile's `av1C`, after libavif's checks of a grid's tiles:
    each an `av01` item with no unsupported essential property, with an
    `av1C` whose fields are the first tile's."""
    for i in tiles:
        if i.type != b"av01" or i.unsupported_essential:
            raise RuntimeError(INVALID_GRID)
    first = tiles[0].prop(b"av1C")
    for i in tiles:
        av1c = i.prop(b"av1C")
        if first is None or av1c is None or av1c[1:3] != first[1:3]:
            _fail()
    return first


def _coded(blob, meta: Meta, item: Item, grid) -> Coded:
    """The coded image of an `av01` item, or of a `grid` item from _grid:
    each tile's data (none may be empty) and `ispe`. Tiles of two sizes
    never make a grid (libavif scales each to its `ispe`, then refuses
    tiles that differ)."""
    if grid is None:
        w, h = item.prop(b"ispe")
        return Coded.single(_item_data(blob, meta, item), w, h)
    (cols, rows, width, height), tiles = grid
    data = tuple(_item_data(blob, meta, i) for i in tiles)
    if not all(data):
        _fail()
    sizes = {i.prop(b"ispe") for i in tiles}  # parse() checked each found
    if None in sizes:
        _fail()
    if len(sizes) > 1:
        raise RuntimeError(INVALID_GRID)
    (w, h), = sizes
    return Coded(data, True, cols, rows, w, h, width, height)


def parse(blob: bytes) -> Parsed:
    """The file as libavif parses it; SyntaxError / RuntimeError /
    ValueError where it refuses it, ValueError naming a feature the port
    does not read."""
    top = Stream(blob, 0, len(blob))
    brands, meta, moov = None, None, None
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
            if moov is not None:
                _fail()
            moov = _parse_moov(blob, start, end)
        if (brands is not None and (b"avif" not in brands or meta is not None)
                and (b"avis" not in brands or moov is not None)):
            break
        top.pos = end
    else:
        if brands is None:
            _fail(INVALID_FTYP)
        if (b"avif" in brands and meta is None) or (b"avis" in brands
                                                   and moov is None):
            _fail(TRUNCATED)
    if meta is not None:
        # every image item with data, no unsupported essential property and
        # no thumbnail reference needs an `ispe` within the limits
        for item in meta.items.values():
            if (item.type in (b"av01", b"grid")
                    and not item.unsupported_essential
                    and b"thmb" not in item.refs
                    and any(n for _, n in item.extents)):
                if item.prop(b"ispe") is None:
                    _fail()
                _check_size(*item.prop(b"ispe"))
    # libavif's source: the tracks where the major brand is `avis`, the
    # items where it is `avif`, else the tracks if there are any
    if brands[0] == b"avis" or (brands[0] != b"avif" and moov):
        return _from_tracks(blob, moov or [])
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
    grid = _grid(blob, meta, color) if color.type == b"grid" else None
    colr = [v for k, v in color.props if k == b"colr"]
    nclx = [v for v in colr if v[0] == "nclx"]
    if len(nclx) > 1 or sum(v[0] == "icc" for v in colr) > 1:
        _fail()
    nclx = nclx[0] if nclx else None
    depth = _depth(color.prop(b"av1C"))
    pixi = color.prop(b"pixi")
    if pixi is not None and any(d != depth for d in pixi):
        _fail()
    width, height = ispe
    _check_size(width, height)
    image = _coded(blob, meta, color, grid)
    if not image.tiles[0]:
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
    alpha_image = None
    premultiplied = False
    if alpha is not None:  # its `ispe` checked with every image item's
        alpha_grid = _grid(blob, meta, alpha) if alpha.type == b"grid" \
            else None
        alpha_av1c = alpha.prop(b"av1C")
        if alpha_av1c is None:
            _fail()
        alpha_depth = _depth(alpha_av1c)
        if any(d != alpha_depth for d in alpha.prop(b"pixi") or ()):
            _fail()
        alpha_image = _coded(blob, meta, alpha, alpha_grid)
        premultiplied = color.refs.get(b"prem") == alpha.id
    elif grid is not None:
        alpha_image = _tile_alphas(blob, meta, color, grid)
    return Parsed(width, height, image, nclx[3] if nclx else -1,
                  nclx[4] if nclx else -1, alpha_image, premultiplied,
                  primaries=nclx[1] if nclx else -1)


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


def _tile_alphas(blob, meta: Meta, color: Item, grid) -> Optional[Coded]:
    """libavif's alpha of a colour grid with no alpha item
    (avifMetaFindAlphaItem): where each tile, in item order, has an item
    whose `auxl` is to it and whose `auxC` names alpha (of any type, with
    or without data), those items make an alpha grid of the colour grid's
    layout and output, in the tiles' `dimg` order, checked as a grid's
    tiles; a tile with two, or one that is itself a grid's tile, is an
    invalid grid; a tile with none means no alpha."""
    (cols, rows, width, height), tiles = grid
    found = [None] * len(tiles)
    for tile in meta.items.values():
        if tile.dimg_for != color.id:
            continue
        seen = False
        for aux in meta.items.values():
            if (aux.refs.get(b"auxl") != tile.id
                    or aux.prop(b"auxC") not in ALPHA_URNS):
                continue
            if seen or aux.dimg_for or found[tile.dimg_idx] is not None:
                raise RuntimeError(INVALID_GRID)
            found[tile.dimg_idx], seen = aux, True
        if not seen:
            return None
    _tiles_av1c(found)
    return _coded(blob, meta, None, ((cols, rows, width, height), found))


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
    image has an alpha item, else "RGB". Pillow opens the image at the size
    libavif's parse gives (the colour item's `ispe`) and reads the decoded
    bytes as an image of that size: a grid whose output is larger gives
    its first bytes, one whose output is smaller is a truncated file."""
    p = parse(blob)
    mode = "RGB" if p.alpha_image is None else "RGBA"

    def load() -> pixels.Decoded:
        c, a = p.color, p.alpha_image
        if not p.timescale:  # Pillow's load divides by it
            raise RasterError("division by zero (the track's timescale)")
        # libavif decodes the alpha only at its image's size
        if a is not None and (a.width, a.height) != (c.width, c.height):
            raise RasterError("Failed to decode frame 0: Decoding of alpha "
                              "plane failed")
        try:
            out = _native.av1_decode_grid(c, a, p.matrix, p.full_range,
                                          p.premultiplied, p.primaries)
        except ValueError as e:
            raise RasterError(str(e)) from e
        if out.shape[:2] != (p.height, p.width):
            shape = (p.height, p.width, out.shape[2])
            n = shape[0] * shape[1] * shape[2]
            if out.size < n:
                raise RasterError(f"image file is truncated ({out.size} "
                                  f"bytes of {n})")
            out = out.reshape(-1)[:n].reshape(shape)
        return pixels.Decoded(mode, out)

    return pixels.Opened(mode, (p.width, p.height), load)
