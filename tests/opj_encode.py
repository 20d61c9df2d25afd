"""OpenJPEG 2.5.4's encoder (the libopenjp2 that Pillow 12.1 bundles in
pillow.libs/) driven through ctypes, for the coding options Pillow's `save`
does not expose: the code-block styles (`mode`: BYPASS 1, RESET 2, TERMALL
4, VSC 8, PTERM 16, SEGSYM 32), SOP / EPH (`csty`), progression order
changes, a region-of-interest shift, tiles, layers, 5/3 or 9/7, the
component transform (Part 1's, or a Part-2 matrix), component
sub-sampling, the image's origin and colour space (written into a JP2's
`colr` box). Then codestream surgery for what OpenJPEG does not write: the
packet headers moved into PPT or PPM segments, a POC moved from the
tile-part headers into the main header, an RGN moved into them.

`opj_cparameters_t` is read as an int32 array at the offsets below; each is
checked against the encoder defaults (numresolution 6, 64 x 64 code-blocks,
roi_compno -1, subsampling 1, formats -1) before a parameter is written."""
from __future__ import annotations

import ctypes
import glob
import os
import struct
import tempfile
from pathlib import Path

import numpy as np
import PIL

# int32 indices into opj_cparameters_t (OpenJPEG 2.5.4, LP64)
TILE_SIZE_ON, CP_TX0, CP_TY0, CP_TDX, CP_TDY = 0, 1, 2, 3, 4
CP_DISTO_ALLOC, CSTY, PROG_ORDER = 5, 12, 13
POC0, POC_INTS = 14, 37  # opj_poc_t[32]: resno0 +0, compno0 +1, layno1 +2,
POC_FIELDS = {"resno0": 0, "compno0": 1, "layno1": 2, "resno1": 3,
              "compno1": 4, "prg1": 8, "tile": 12}  # resno1 +3 ... tile +12
NUMPOCS, TCP_NUMLAYERS, TCP_RATES = 1198, 1199, 1200
NUMRESOLUTION, CBLOCKW, CBLOCKH, MODE = 1400, 1401, 1402, 1403
IRREVERSIBLE, ROI_COMPNO, ROI_SHIFT = 1404, 1405, 1406
SUBSAMPLING_DX, SUBSAMPLING_DY, DECOD_FORMAT, COD_FORMAT = (4549, 4550,
                                                           4551, 4552)
TCP_MCT_BYTE = 18698  # char tcp_mct, after cp_rsiz (int 4673) and tp_on/flag
PARAMS_INTS = 16384  # more than sizeof(opj_cparameters_t) / 4
DEFAULTS = {NUMRESOLUTION: 6, CBLOCKW: 64, CBLOCKH: 64, ROI_COMPNO: -1,
            SUBSAMPLING_DX: 1, SUBSAMPLING_DY: 1, DECOD_FORMAT: -1,
            COD_FORMAT: -1}
PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32
SOP, EPH = 2, 4
# OPJ_COLOR_SPACE
COLOUR_SPACES = {"unspecified": 0, "srgb": 1, "gray": 2, "sycc": 3,
                 "eycc": 4, "cmyk": 5}


class _CompParm(ctypes.Structure):  # opj_image_cmptparm_t
    _fields_ = [(f, ctypes.c_uint32) for f in (
        "dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class _Comp(ctypes.Structure):  # opj_image_comp_t
    _fields_ = [(f, ctypes.c_uint32) for f in (
        "dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
        "resno_decoded", "factor")] + [
        ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class _Image(ctypes.Structure):  # opj_image_t
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32),
                ("x1", ctypes.c_uint32), ("y1", ctypes.c_uint32),
                ("numcomps", ctypes.c_uint32), ("color_space", ctypes.c_int),
                ("comps", ctypes.POINTER(_Comp)),
                ("icc_profile_buf", ctypes.c_void_p),
                ("icc_profile_len", ctypes.c_uint32)]


_LIB = None


def library():
    """Pillow's bundled libopenjp2 2.5.4, its encoder functions typed."""
    global _LIB
    if _LIB is None:
        libs = Path(PIL.__file__).resolve().parents[1] / "pillow.libs"
        found = glob.glob(str(libs / "libopenjp2-*.so.2.5.4"))
        if not found:
            raise FileNotFoundError(f"no libopenjp2 2.5.4 in {libs}")
        lib = ctypes.CDLL(found[0])
        vp = ctypes.c_void_p
        lib.opj_image_create.restype = ctypes.POINTER(_Image)
        lib.opj_image_create.argtypes = [ctypes.c_uint32,
                                         ctypes.POINTER(_CompParm),
                                         ctypes.c_int]
        lib.opj_image_destroy.argtypes = [ctypes.POINTER(_Image)]
        lib.opj_create_compress.restype = vp
        lib.opj_create_compress.argtypes = [ctypes.c_int]
        lib.opj_setup_encoder.argtypes = [vp, vp, ctypes.POINTER(_Image)]
        lib.opj_stream_create_default_file_stream.restype = vp
        lib.opj_stream_create_default_file_stream.argtypes = [
            ctypes.c_char_p, ctypes.c_int]
        lib.opj_start_compress.argtypes = [vp, ctypes.POINTER(_Image), vp]
        lib.opj_encode.argtypes = [vp, vp]
        lib.opj_end_compress.argtypes = [vp, vp]
        lib.opj_stream_destroy.argtypes = [vp]
        lib.opj_destroy_codec.argtypes = [vp]
        _LIB = lib
    return _LIB


def _params(lib):
    buf = (ctypes.c_int32 * PARAMS_INTS)()
    lib.opj_set_default_encoder_parameters(buf)
    for i, v in DEFAULTS.items():
        if buf[i] != v:
            raise AssertionError(f"opj_cparameters_t[{i}] is {buf[i]}, not "
                                 f"the default {v}: another layout")
    return buf


def encode(planes, *, irreversible: bool = False, mode: int = 0,
           csty: int = 0, progression: str = "LRCP", pocs=(), roi=None,
           tile=None, rates=None, resolutions: int = 6, cblk=(64, 64),
           mct=None, prec=None, signed: bool = False, subsampling=None,
           colour_space=None, jp2: bool = False, origin=(0, 0),
           mct_matrix=None) -> bytes:
    """A J2K codestream (a JP2 file with `jp2`) of `planes` ((h, w) or
    (h, w, c) integers) as OpenJPEG 2.5.4 writes it. `pocs`: (resno0,
    compno0, layno1, resno1, compno1, progression[, tile]) each, tile
    1-based (1 by default); `roi`: (component, shift); `tile`: (width,
    height); `rates`: the compression ratio of each layer (0: lossless);
    `mct`: the component transform (the default: on for 3 components or
    more); `prec`: the bits of a sample (the dtype's by default);
    `subsampling`: (dx, dy) of each component
    (1, 1 by default), plane c cut to [::dy, ::dx]; `colour_space`:
    opj_image_create's (COLOUR_SPACES, or its number; by default sRGB for 3
    components or more, gray below); `origin`: the image's (x0, y0) on the
    reference grid, planes[0, 0] there; `mct_matrix`: a Part-2 custom
    component transform (opj_set_MCT, no DC shift) in place of `mct`."""
    a = np.asarray(planes)
    if a.ndim == 2:
        a = a[..., None]
    h, w, nc = a.shape
    prec = prec or a.dtype.itemsize * 8
    lib = library()
    p = _params(lib)
    p[NUMRESOLUTION] = resolutions
    p[CBLOCKW], p[CBLOCKH] = cblk
    p[MODE] = mode
    p[CSTY] = csty
    p[PROG_ORDER] = PROGRESSIONS[progression]
    p[IRREVERSIBLE] = int(irreversible)
    if tile is not None:
        p[TILE_SIZE_ON], (p[CP_TDX], p[CP_TDY]) = 1, tile
    if rates:
        p[CP_DISTO_ALLOC] = 1
        p[TCP_NUMLAYERS] = len(rates)
        rate_view = ctypes.cast(ctypes.byref(p, 4 * TCP_RATES),
                                ctypes.POINTER(ctypes.c_float))
        for i, r in enumerate(rates):
            rate_view[i] = float(r)
    else:
        p[TCP_NUMLAYERS] = 1
    if roi is not None:
        p[ROI_COMPNO], p[ROI_SHIFT] = roi
    for k, poc in enumerate(pocs):
        r0, c0, l1, r1, c1, prog, *t = poc
        base = POC0 + POC_INTS * k
        for f, v in zip(("resno0", "compno0", "layno1", "resno1", "compno1",
                         "prg1", "tile"),
                        (r0, c0, l1, r1, c1, PROGRESSIONS[prog],
                         t[0] if t else 1)):
            p[base + POC_FIELDS[f]] = v
    p[NUMPOCS] = len(pocs)
    if mct_matrix is None:
        ctypes.cast(p, ctypes.POINTER(ctypes.c_char))[TCP_MCT_BYTE] = bytes(
            [int(nc >= 3 if mct is None else mct)])
    else:
        matrix = (ctypes.c_float * (nc * nc))(*np.ravel(mct_matrix))
        shifts = (ctypes.c_int32 * nc)()
        lib.opj_set_MCT.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_uint32]
        if not lib.opj_set_MCT(p, matrix, shifts, nc):
            raise RuntimeError("opj_set_MCT refused the matrix")
    x0, y0 = origin
    steps = list(subsampling or [(1, 1)] * nc)
    parms = (_CompParm * nc)()
    for c, (dx, dy) in enumerate(steps):
        parms[c].dx, parms[c].dy = dx, dy
        parms[c].x0, parms[c].y0 = -(-x0 // dx), -(-y0 // dy)
        parms[c].w = -(-(x0 + w) // dx) - parms[c].x0
        parms[c].h = -(-(y0 + h) // dy) - parms[c].y0
        parms[c].prec, parms[c].sgnd = prec, int(signed)
    if colour_space is None:
        colour_space = "srgb" if nc >= 3 else "gray"
    image = lib.opj_image_create(nc, parms,
                                 COLOUR_SPACES.get(colour_space,
                                                   colour_space))
    if not image:
        raise RuntimeError("opj_image_create failed")
    codec = stream = None
    try:
        img = image.contents
        img.x0, img.y0, img.x1, img.y1 = x0, y0, x0 + w, y0 + h
        for c, (dx, dy) in enumerate(steps):
            plane = np.ascontiguousarray(
                a[parms[c].y0 * dy - y0::dy, parms[c].x0 * dx - x0::dx, c],
                dtype=np.int32)
            ctypes.memmove(img.comps[c].data, plane.ctypes.data, plane.nbytes)
        codec = lib.opj_create_compress(2 if jp2 else 0)  # JP2 / J2K
        if not lib.opj_setup_encoder(codec, p, image):
            raise RuntimeError("opj_setup_encoder refused the parameters")
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "x.j2k")
            stream = lib.opj_stream_create_default_file_stream(
                path.encode(), 0)
            ok = (lib.opj_start_compress(codec, image, stream)
                  and lib.opj_encode(codec, stream)
                  and lib.opj_end_compress(codec, stream))
            lib.opj_stream_destroy(stream)
            stream = None
            if not ok:
                raise RuntimeError("OpenJPEG failed to encode")
            return Path(path).read_bytes()
    finally:
        if stream:
            lib.opj_stream_destroy(stream)
        if codec:
            lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)


# ---------------------------------------------------------------------------
# codestream surgery
# ---------------------------------------------------------------------------
def segments(code: bytes, start: int, stop: int):
    """(marker, bytes of the whole segment) of each marker segment in
    code[start:stop]."""
    pos, out = start, []
    while pos < stop:
        m, n = struct.unpack_from(">HH", code, pos)
        out.append((m, code[pos:pos + 2 + n]))
        pos += 2 + n
    return out


def main_header_end(code: bytes) -> int:
    """The offset of the first SOT."""
    pos = 2
    while struct.unpack_from(">H", code, pos)[0] != 0xFF90:
        pos += 2 + struct.unpack_from(">H", code, pos + 2)[0]
    return pos


def tile_parts(code: bytes):
    """[isot, tpsot, tnsot, header segments [(marker, bytes)], data] of each
    tile-part, in codestream order."""
    pos, parts = main_header_end(code), []
    while struct.unpack_from(">H", code, pos)[0] == 0xFF90:
        isot, psot, tpsot, tnsot = struct.unpack_from(">HIBB", code, pos + 4)
        q = pos + 12
        sod = q
        while struct.unpack_from(">H", code, sod)[0] != 0xFF93:
            sod += 2 + struct.unpack_from(">H", code, sod + 2)[0]
        parts.append([isot, tpsot, tnsot, segments(code, q, sod),
                      code[sod + 2:pos + psot]])
        pos += psot
    return parts


def rebuild(main: bytes, parts) -> bytes:
    """SOC + main header `main` (SIZ onwards, no SOC), the tile-parts of
    `tile_parts`'s form with their Psot recomputed, then EOC."""
    out = [b"\xff\x4f", main]
    for isot, tpsot, tnsot, header, data in parts:
        head = b"".join(s for _, s in header)
        out.append(struct.pack(">HHHIBB", 0xFF90, 10, isot,
                               14 + len(head) + len(data), tpsot, tnsot)
                   + head + b"\xff\x93" + data)
    return b"".join(out) + b"\xff\xd9"


def main_header(code: bytes) -> bytes:
    return code[2:main_header_end(code)]


def packets(data: bytes):
    """(header, body) of each packet of a tile-part's data written with SOP
    and EPH: the header runs from the SOP segment's end through the EPH
    marker, the body up to the next SOP. Packet headers are bit-stuffed and
    code-block data holds no marker above 0xFF8F, so the markers are
    found by their codes."""
    if not data.startswith(b"\xff\x91\x00\x04"):
        raise ValueError("the tile-part's data does not start with SOP")
    out, pos = [], 0
    while pos < len(data):
        eph = data.index(b"\xff\x92", pos + 6) + 2
        nxt = data.find(b"\xff\x91\x00\x04", eph)
        nxt = len(data) if nxt < 0 else nxt
        out.append((data[pos:pos + 6], data[pos + 6:eph], data[eph:nxt]))
        pos = nxt
    return out


def _pp_segments(marker: int, stream: bytes, chunk: int, z0: int = 0):
    """`stream` as PPM / PPT marker segments of at most `chunk` bytes of
    data each, Zppm / Zppt counting up from z0."""
    out = []
    for k, i in enumerate(range(0, max(len(stream), 1), chunk)):
        piece = stream[i:i + chunk]
        out.append((marker, struct.pack(">HHB", marker, 3 + len(piece),
                                        z0 + k) + piece))
    return out


def to_ppt(code: bytes, chunk: int = 65532, reverse_z: bool = False) -> bytes:
    """Every packet header (through its EPH) moved from the tile-part's data
    into PPT segments of that tile-part's header; the SOP segments and the
    bodies stay. `chunk` splits the headers over several PPT segments;
    `reverse_z` writes them last Zppt first."""
    parts = tile_parts(code)
    z = {}
    for part in parts:
        pk = packets(part[4])
        stream = b"".join(h for _, h, _ in pk)
        segs = _pp_segments(0xFF61, stream, chunk, z.get(part[0], 0))
        z[part[0]] = z.get(part[0], 0) + len(segs)
        if reverse_z:
            segs = segs[::-1]
        part[3] = part[3] + segs
        part[4] = b"".join(s + b for s, _, b in pk)
    return rebuild(main_header(code), parts)


def to_ppm(code: bytes, chunk: int = 65532) -> bytes:
    """Every packet header moved into PPM segments of the main header: for
    each tile-part in order its Nppm (4 bytes) and its headers, the whole
    stream cut into segments of at most `chunk` bytes (an Nppm group may
    run on into the next segment; no cut falls inside an Nppm field)."""
    parts = tile_parts(code)
    stream = []
    for part in parts:
        pk = packets(part[4])
        heads = b"".join(h for _, h, _ in pk)
        stream.append(struct.pack(">I", len(heads)) + heads)
        part[4] = b"".join(s + b for s, _, b in pk)
    joined, cuts, at = b"".join(stream), [0], 0
    fields = set()  # the offsets inside an Nppm field
    for group in stream:
        fields.update(range(at + 1, at + 4))
        at += len(group)
    while cuts[-1] + chunk < len(joined):
        cut = cuts[-1] + chunk
        while cut in fields:
            cut -= 1
        cuts.append(cut)
    cuts.append(len(joined))
    ppm = b"".join(struct.pack(">HHB", 0xFF60, 3 + b - a, z) + joined[a:b]
                   for z, (a, b) in enumerate(zip(cuts, cuts[1:])))
    return rebuild(main_header(code) + ppm, parts)


def move_to_main(code: bytes, marker: int) -> bytes:
    """The `marker` segments of the first tile-part's header moved to the
    end of the main header, and taken out of every tile-part header."""
    parts = tile_parts(code)
    moved = b"".join(s for m, s in parts[0][3] if m == marker)
    for part in parts:
        part[3] = [(m, s) for m, s in part[3] if m != marker]
    return rebuild(main_header(code) + moved, parts)


def move_to_tiles(code: bytes, marker: int) -> bytes:
    """The main header's `marker` segments moved into the header of each
    tile's first tile-part."""
    head = segments(code, 2, main_header_end(code))
    moved = [(m, s) for m, s in head if m == marker]
    parts = tile_parts(code)
    for part in parts:
        if part[1] == 0:
            part[3] = part[3] + moved
    return rebuild(b"".join(s for m, s in head if m != marker), parts)


def poc_segment(entries, csiz: int = 1) -> bytes:
    """A POC marker segment: (resno0, compno0, layno1, resno1, compno1,
    progression) each, component indices of 1 byte (2 above 256
    components)."""
    cfmt = "B" if csiz <= 256 else "H"
    body = b"".join(struct.pack(">B" + cfmt + "HB" + cfmt + "B", r0, c0, l1,
                                r1, c1, PROGRESSIONS.get(prg, prg))
                    for r0, c0, l1, r1, c1, prg in entries)
    return struct.pack(">HH", 0xFF5F, 2 + len(body)) + body


def rgn_segment(comp: int, shift: int, srgn: int = 0) -> bytes:
    return struct.pack(">HHBBB", 0xFF5E, 5, comp, srgn, shift)


class _BitReader:  # bio.c's reader: a 0 bit stuffed after each 0xFF
    def __init__(self, data: bytes):
        self.data, self.pos, self.buf, self.ct = data, 0, 0, 0

    def bit(self) -> int:
        if self.ct == 0:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.pos < len(self.data):
                self.buf |= self.data[self.pos]
                self.pos += 1
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v


class _BitWriter:  # bio.c's writer
    def __init__(self):
        self.out, self.buf, self.ct = bytearray(), 0, 8

    def _byteout(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def bit(self, b: int):
        if self.ct == 0:
            self._byteout()
        self.ct -= 1
        self.buf |= b << self.ct

    def bits(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


def _passes_code(w: _BitWriter, n: int):
    """t2.c's opj_t2_putnumpasses."""
    if n == 1:
        w.bit(0)
    elif n == 2:
        w.bits(2, 2)
    elif n <= 5:
        w.bits(0xC | (n - 3), 4)
    elif n <= 36:
        w.bits(0x1E0 | (n - 6), 9)
    else:
        w.bits(0xFF80 | (n - 37), 16)


def more_passes(code: bytes, passes: int, junk: bytes) -> bytes:
    """A codestream of one tile, one layer, one resolution and one
    code-block (no SOP / EPH) whose packet header is rewritten to claim
    `passes` (110 to 164) coding passes: a first segment of 109, its length
    the coded data's, then one of the rest holding `junk`. OpenJPEG decodes
    the passes the bit-planes allow and never reaches the second segment."""
    (part,) = tile_parts(code)
    data = part[4]
    r = _BitReader(data)
    if not (r.bit() and r.bit()):  # present; included in layer 0
        raise ValueError("the packet is empty")
    zero = 0
    while not r.bit():
        zero += 1
    if not r.bit():
        n = 1
    elif not r.bit():
        n = 2
    elif (k := r.bits(2)) != 3:
        n = 3 + k
    elif (k := r.bits(5)) != 31:
        n = 6 + k
    else:
        n = 37 + r.bits(7)
    lenbits = 3
    while r.bit():
        lenbits += 1
    length = r.bits(lenbits + n.bit_length() - 1)
    if (r.buf & 0xFF) == 0xFF:  # bio.c's opj_bio_inalign
        r.pos += 1
    body = data[r.pos:]
    if length != len(body):
        raise ValueError("more than one code-block in the packet")
    w = _BitWriter()
    w.bits(0b11, 2)
    w.bits(1, zero + 1)
    _passes_code(w, passes)
    rest = passes - 109
    lenbits = max(3, len(body).bit_length() - 6,
                  len(junk).bit_length() - (rest.bit_length() - 1))
    w.bits((1 << (lenbits - 3 + 1)) - 2, lenbits - 3 + 1)  # comma code
    w.bits(len(body), lenbits + 6)
    w.bits(len(junk), lenbits + rest.bit_length() - 1)
    part[4] = w.flush() + body + junk
    return rebuild(main_header(code), [part])
