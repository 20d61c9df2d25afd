"""IPTC/NAA reader: the image Pillow 12.1 opens from an IPTC/NAA stream
(PIL/IptcImagePlugin.py), quirks included:

  * no `_accept`: every file that reaches the plugin is read as fields
    (0x1C, record, dataset, size; sizes over 128 bytes long) up to the
    first (8, 10) field or a field of zeros; a repeated tag keeps a list;
  * the mode from (3, 60): one layer without a component "L", three or
    four layers with one "RGB" or "CMYK"; the size from (3, 20) and
    (3, 30); the compression from (3, 120), 1 (raw) or 5 (JPEG), any
    other value failing the open with Pillow's OSError;
  * the data of the (8, 10) fields gathered and opened again through the
    plugin loop (io/pilraster.open_image): raw data behind a "P5" header
    of the image's size (io/netpbm), JPEG as it is (io/jpeg);
  * "L" keeps that image; "RGB" and "CMYK" put it into band (3, 65) - 1
    (Python's index, so 0 is the last band; band 1 without the tag) of a
    merge of zero "L" bands, as Pillow's Image.merge does, which fails
    unless the image is "L".
Pillow's `info` holds no strings for an IPTC stream (its keys are
tuples)."""
from __future__ import annotations

import struct

import numpy as np

from ..errors import RasterError
from . import pixels

COMPRESSION = {1: "raw", 5: "jpeg"}


def _field(blob: bytes, pos: int) -> tuple:
    """(tag or None, size, position after the header)."""
    s = blob[pos:pos + 5]
    pos += len(s)
    if not s.strip(b"\x00"):
        return None, 0, pos
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise OSError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        more = blob[pos:pos + size - 128]
        pos += len(more)
        size = struct.unpack(">I", (bytes(4) + more)[-4:])[0]
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size, pos


def _int(value) -> int:
    return struct.unpack(">I", (b"\0\0\0\0" + value)[-4:])[0]


def open_image(blob: bytes) -> pixels.Opened:
    info: dict = {}
    pos = 0
    while True:
        offset = pos
        tag, size, pos = _field(blob, pos)
        if not tag or tag == (8, 10):
            break
        data = blob[pos:pos + size] if size else None
        pos += len(data or b"")
        if tag in info:
            if isinstance(info[tag], list):
                info[tag].append(data)
            else:
                info[tag] = [info[tag], data]
        else:
            info[tag] = data
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    width, height = _int(info[(3, 20)]), _int(info[(3, 30)])
    try:
        compression = COMPRESSION[_int(info[(3, 120)])]
    except KeyError as e:
        raise OSError("Unknown IPTC image compression") from e
    tiled = tag == (8, 10)

    def load() -> pixels.Decoded:
        from .pilraster import open_image as open_any

        if not tiled:
            raise RasterError("cannot load this image")
        out = bytearray(b"P5\n%d %d\n255\n" % (width, height)
                        if compression == "raw" else b"")
        at = offset
        while True:
            kind, size, at = _field(blob, at)
            if kind != (8, 10):
                break
            data = blob[at:at + max(0, size)]
            at += len(data)
            out += data
        inner = open_any(bytes(out))
        arr = inner.array
        if band is not None:
            bands = len(mode)
            if inner.mode != "L":
                raise RasterError("mode mismatch")
            if not -bands <= band < bands:
                raise RasterError("list assignment index out of range")
            full = np.zeros(arr.shape + (bands,), np.uint8)
            full[..., band] = arr
            arr = full
        elif inner.mode != "L":
            raise RasterError(f"IPTC: an {inner.mode} image in an L stream")
        if arr.shape[:2] != (height, width):
            raise RasterError(f"IPTC: the {arr.shape[1]} x {arr.shape[0]} "
                              f"image of a {width} x {height} stream")
        return pixels.Decoded(mode, arr)

    return pixels.Opened(mode, (width, height), load)
