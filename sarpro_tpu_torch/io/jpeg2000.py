"""JPEG 2000 reader: the image Pillow 12.1 opens from a .jp2 / .j2k / .jpx
file (Jpeg2KImagePlugin's mode and size, OpenJPEG 2.5.4's decode, the
unpacking of Pillow's Jpeg2KDecode.c), decoded by the port's C++ library
(`_native/j2kdec.cpp`, built at first use).

Accepted as Pillow accepts them: a raw codestream (SOC + SIZ) and a JP2
file (its signature box). Modes as Pillow gives them:

  * codestream: the component count (1: "L", or "I;16" above 8 bits; 2
    "LA", 3 "RGB", 4 "RGBA");
  * JP2: the ihdr box's, "CMYK" for an enumerated CMYK `colr` on 4
    components, "P" / "PA" for a `pclr` box on "L" / "LA" (its palette
    as Pillow's ImagePalette.getcolor builds it, RGB, or RGBA for four
    columns, from one byte a value; entries above 8 bits leave the mode as
    it is).

The samples reach the mode as Pillow's unpackers put them: shifted to 8
bits (16 for "I;16": a 12-bit band reads as its values << 4, a 20-bit one
as its values >> 4), rounded where the shift is down, signed samples
offset by half their range, the stores wrapping. Which unpacker a file
takes follows its colour space (the JP2 `colr` box; for a codestream, or
a JP2 without one, Pillow's guess from the component count and the first
sub-sampled component) and component count, as measured against Pillow
12.1 (UNPACKERS); a pairing Pillow has no unpacker for is refused, as
Pillow refuses it (e-YCC has none; sub-sampled components have none under
one or two). sYCC is unpacked as sRGB and taken to RGB by Pillow's
fixed-point YCbCr conversion. Sub-sampled components are read where
Pillow's unpackers read them in OpenJPEG's tile buffer: at strides and
offsets of W / dx and H / dy, which at odd sizes are not the samples an
up-sampling would give. The codestream's coding options are decoded as
OpenJPEG decodes them: the six code-block styles (BYPASS, RESET, TERMALL,
VSC, PTERM, SEGSYM), region-of-interest shifts (RGN), progression order
changes (POC), packed packet headers (PPM / PPT), SOP / EPH, precisions up
to 31 bits, Rsiz capability bits and CAP segments, and HTJ2K code-blocks
(ISO/IEC 15444-15: the cleanup, SigProp and MagRef passes, as OpenJPEG's
ht_dec.c decodes them). Refused as RasterError naming the feature: mixed
HT / Part-1 code-blocks, an ROI shift or more than 3 passes over HT
code-blocks (OpenJPEG refuses all three), Part-2 wavelets, quantization,
coding styles and multiple component transforms (their markers), and a
codestream cut short or malformed where OpenJPEG refuses it. Pillow's `info` holds no strings for a JPEG 2000 file
(the comment is bytes), so the text is empty."""
from __future__ import annotations

import struct

from .. import _native
from ..errors import RasterError
from . import pixels

SIGNATURES = (b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \r\n\x87\n")

# OpenJPEG's colour space of an enumerated `colr` (jp2.c); any other
# (none, ICC, unknown values) is left for the unpacker to guess
ENUMCS = {16: "srgb", 17: "gray", 18: "sycc", 24: "eycc", 12: "cmyk"}
# (mode, colour space, components) -> the component of each channel of
# Pillow's image (-1: 0xFF), as Pillow 12.1 unpacks them; those of one or
# two components take no sub-sampled component, the sYCC ones convert to
# RGB
UNPACKERS = {
    ("L", "gray", 1): (0,),
    ("P", "srgb", 1): (0,),
    ("PA", "srgb", 2): (0, 1),
    ("I;16", "gray", 1): (0,),
    ("LA", "gray", 2): (0, 1),
    ("RGB", "gray", 1): (0, 0, 0),
    ("RGB", "gray", 2): (0, 0, 0),
    ("RGB", "srgb", 3): (0, 1, 2),
    ("RGB", "srgb", 4): (0, 1, 2),
    ("RGBA", "gray", 1): (0, 0, 0, -1),
    ("RGBA", "gray", 2): (0, 0, 0, 1),
    ("RGBA", "gray", 4): (0, 1, 2, 3),
    ("RGBA", "srgb", 3): (0, 1, 2, -1),
    ("RGBA", "srgb", 4): (0, 1, 2, 3),
    ("CMYK", "cmyk", 4): (0, 1, 2, 3),
    ("RGB", "sycc", 3): (0, 1, 2),
    ("RGB", "sycc", 4): (0, 1, 2),
    ("RGBA", "sycc", 3): (0, 1, 2, -1),
    ("RGBA", "sycc", 4): (0, 1, 2, 3),
}


def _guess(nc: int, subsampled: int) -> str:
    """Pillow's colour space for an unspecified one: gray for one or two
    components; for three or four sRGB, or sYCC where the first
    sub-sampled component is the second or the third."""
    if nc <= 2:
        return "gray"
    return "sycc" if subsampled in (1, 2) else "srgb"


def _boxes(blob: bytes, start: int, end: int):
    """(type, content start, content end) of each box in blob[start:end];
    a box of length 0 runs to `end`. RasterError where a box header is
    cut or its length is impossible (Pillow's "Invalid header length")."""
    pos = start
    while pos < end:
        if end - pos < 8:
            raise RasterError("JPEG 2000: Invalid header length")
        lbox, tbox = struct.unpack_from(">I4s", blob, pos)
        hlen = 8
        if lbox == 1:
            if end - pos < 16:
                raise RasterError("JPEG 2000: Invalid header length")
            lbox = struct.unpack_from(">Q", blob, pos + 8)[0]
            hlen = 16
        elif lbox == 0:
            lbox = end - pos
        if lbox < hlen:
            raise RasterError("JPEG 2000: Invalid header length")
        yield tbox, pos + hlen, pos + lbox
        pos += lbox


def _jp2_header(blob: bytes, start: int, end: int):
    """Pillow's _parse_jp2_header on the jp2h box's content: (size, mode,
    palette) and OpenJPEG's colour space (its first `colr` box)."""
    size = mode = None
    nc = None
    palette = None
    colour = None
    has_pclr = False
    depths = ()
    for tbox, a, b in _boxes(blob, start, end):
        if b > end:
            raise RasterError("JPEG 2000: Invalid header length")
        body = blob[a:b]
        if tbox == b"ihdr":
            if len(body) < 11:
                raise RasterError("JPEG 2000: Not enough data in header")
            height, width, nc, bpc = struct.unpack_from(">IIHB", body)
            size = (width, height)
            mode = ("I;16" if nc == 1 and (bpc & 0x7F) > 8 else
                    {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode))
        elif tbox == b"colr":
            if len(body) >= 7:
                meth, _, _, enumcs = struct.unpack_from(">BBBI", body)
            else:
                meth, enumcs = (body[0] if body else 0), 0
            if colour is None and meth in (1, 2):
                colour = ENUMCS.get(enumcs, "") if meth == 1 else ""
            if nc == 4 and meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and not has_pclr:
            has_pclr = True
            depths = _pclr_depths(body)
            if mode in ("L", "LA"):
                palette = _palette(body)
                if palette is not None:
                    mode = "P" if mode == "L" else "PA"
        elif tbox == b"cmap":
            if not has_pclr:
                raise RasterError("JPEG 2000: a cmap box before its pclr "
                                  "box")
            if len(body) < 4 * len(depths):
                raise RasterError("JPEG 2000: a cmap box too short for its "
                                  "palette")
    if size is None or mode is None:
        raise RasterError("JPEG 2000: Malformed JP2 header")
    return size, mode, palette, colour or ""


def _pclr_depths(body: bytes) -> tuple:
    """The bit depth of each column of a pclr box, as OpenJPEG reads it:
    RasterError where it reports no entries, more than 1024, no columns,
    or holds fewer bytes than its entries take."""
    if len(body) < 3:
        raise RasterError("JPEG 2000: Not enough data in header")
    ne, npc = struct.unpack_from(">HB", body)
    if not 1 <= ne <= 1024 or npc == 0 or len(body) < 3 + npc:
        raise RasterError(f"JPEG 2000: invalid pclr box ({ne} entries, "
                          f"{npc} columns)")
    depths = tuple((b & 0x7F) + 1 for b in body[3:3 + npc])
    need = 3 + npc + ne * sum(min((d + 7) >> 3, 4) for d in depths)
    if len(body) < need:
        raise RasterError("JPEG 2000: invalid pclr box (cut short)")
    return depths


def _palette(body: bytes):
    """The RGB palette Pillow makes of a pclr box: None where a column's
    Ssiz byte is above 8 (Pillow keeps no palette); else each entry of one
    byte a column handed to ImagePalette.getcolor in order (an RGBA
    palette for four columns, else RGB; each colour once, at the index
    getcolor gives it, which for other than three or four columns is not
    one a colour), and the entries Image.putpalette makes of its bytes."""
    ne, npc = struct.unpack_from(">HB", body)
    if max(body[3:3 + npc]) > 8:
        return None
    table = body[3 + npc:3 + npc + ne * npc]
    if len(table) < ne * npc:
        raise RasterError("JPEG 2000: Not enough data in header")
    width = 4 if npc == 4 else 3
    seen: set = set()
    pal = b""
    for i in range(0, len(table), npc):
        c = table[i:i + npc]
        if c in seen:
            continue
        index = len(pal) // width
        if index >= 256:
            raise RasterError(
                "JPEG 2000: cannot allocate more than 256 colors")
        seen.add(c)
        at = index * width
        pal = pal[:at] + c + pal[at + width:] if at < len(pal) else pal + c
    return b"".join(pal[k:k + 3] for k in range(0, len(pal) - width + 1,
                                                 width))


def _siz(code: bytes):
    """(size, component count, first component's Ssiz, index of the first
    sub-sampled component or -1) from the SIZ segment that must open a
    codestream (Pillow's _parse_codestream reads the first three)."""
    if not code.startswith(SIGNATURES[0]):
        raise RasterError("JPEG 2000: the codestream does not start with "
                          "SOC and SIZ")
    if len(code) < 46:
        raise RasterError("JPEG 2000: codestream cut short")
    (lsiz, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _,
     csiz) = struct.unpack_from(">HHIIIIIIIIH", code, 4)
    if lsiz < 41:
        raise RasterError("JPEG 2000: invalid SIZ length")
    subsampled = next((i for i in range(csiz)
                       if code[43 + 3 * i:45 + 3 * i] not in (b"\1\1", b"")),
                      -1)
    return (xsiz - xosiz, ysiz - yosiz), csiz, code[42], subsampled


def _jp2(blob: bytes):
    """(codestream, size, mode, palette, colour space) of a JP2 file: Pillow's
    header parse, and the box walk OpenJPEG makes to its codestream."""
    header = None
    code = None
    for i, (tbox, a, b) in enumerate(_boxes(blob, 0, len(blob))):
        if i == 1 and tbox != b"ftyp":
            raise RasterError("JPEG 2000: the ftyp box must be the second "
                              "box of a JP2 file")
        if tbox == b"jp2h" and header is None:
            if b > len(blob):
                raise RasterError("JPEG 2000: Not enough data in header")
            header = _jp2_header(blob, a, b)
        elif tbox == b"jp2c":
            if header is None:
                raise RasterError("JPEG 2000: no jp2h box before the "
                                  "codestream")
            code = blob[a:b]
            break
    if header is None:
        raise RasterError("JPEG 2000: Malformed JP2 header")
    if code is None:
        raise RasterError("JPEG 2000: no codestream (jp2c box)")
    return (code,) + header


def read(blob: bytes) -> pixels.Decoded:
    if blob.startswith(SIGNATURES[0]):
        code = blob
        size, nc, ssiz, subsampled = _siz(code)
        if nc == 1:
            mode = "I;16" if (ssiz & 0x7F) + 1 > 8 else "L"
        elif nc in (2, 3, 4):
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}[nc]
        else:
            raise RasterError("JPEG 2000: unable to determine J2K image mode")
        palette, colour = None, ""
    else:
        code, size, mode, palette, colour = _jp2(blob)
        siz_size, nc, _, subsampled = _siz(code)
        if size != siz_size:
            raise RasterError(f"JPEG 2000: the ihdr box's size {size} is "
                              f"not the codestream's {siz_size}")
    width, height = size
    pixels.check_size(width, height)
    space = colour or _guess(nc, subsampled)
    chans = UNPACKERS.get((mode, space, nc))
    if chans is None or (subsampled >= 0 and nc <= 2):
        raise RasterError(f"JPEG 2000: no unpacker for mode {mode} from "
                          f"{nc} components in colour space "
                          f"{space or 'unspecified'} (broken data stream)")
    try:
        out = _native.j2k_decode(code, width, height, chans,
                                 16 if mode == "I;16" else 8,
                                 space == "sycc")
    except (ValueError, RuntimeError) as e:
        raise RasterError(f"JPEG 2000: {e}") from e
    return pixels.Decoded(mode, out[..., 0] if len(chans) == 1 else out,
                          palette or b"")
