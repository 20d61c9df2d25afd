"""PCX and DCX reader: the image Pillow 12.1 opens from a Paintbrush file
or frame 0 of an Intel DCX file (PIL/PcxImagePlugin.py,
PIL/DcxImagePlugin.py), quirks included:

  * the 128-byte header: its bounding box gives the size; 1 bit in 1 plane
    is "1", 1 bit in 2 or 4 planes "P" (bit planes, the 16-colour header
    palette), version 5 at 8 bits in 1 plane "L", or "P" where the 769-byte
    table at the end of the file (0x0C, then 256 entries) is not the gray
    ramp, and version 5 at 8 bits in 3 planes "RGB" (line-interleaved);
  * the line's bytes are Pillow's, not the header's: (width * bits + 7) //
    8 a plane, made even where the header's count differs;
  * the RLE lines through the C++ copy of PcxDecode (rledec.cpp): a run
    past its line fails the decode, and the byte planes of a line whose
    length is not a multiple of the width are moved to `width` bytes apart
    before it is unpacked (which garbles the planes of RGB images 1 or 3
    pixels wide, as in Pillow); bit planes are read a stride apart;
  * DCX: a directory of up to 1024 offsets after its magic; frame 0 is the
    PCX image at the first.
`info["dpi"]` is a tuple, so Pillow's `info` holds no strings."""
from __future__ import annotations

import struct

import numpy as np

from .. import _native
from ..errors import RasterError
from . import pixels, rawmode

DCX_MAGIC = 0x3ADE68B1


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def dcx_accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and struct.unpack_from("<I", prefix)[0] == \
        DCX_MAGIC


def open_image(blob: bytes, start: int = 0) -> pixels.Opened:
    s = blob[start:start + 68]
    if not accept(s):
        raise SyntaxError("not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
    x1, y1 = x1 + 1, y1 + 1
    if x1 <= x0 or y1 <= y0:
        raise SyntaxError("bad PCX image size")
    offset = start + len(s) + 60
    version, bits, planes = s[1], s[3], s[65]
    provided = struct.unpack_from("<H", s, 66)[0]
    palette = b""
    if bits == 1 and planes == 1:
        mode = raw = "1"
    elif bits == 1 and planes in (2, 4):
        mode, raw = "P", f"P;{planes}L"
        palette = s[16:64]
    elif version == 5 and bits == 8 and planes == 1:
        mode = raw = "L"
        if len(blob) < 769:  # Pillow seeks 769 bytes before the end
            raise OSError("[Errno 22] Invalid argument")
        tail = blob[-769:]
        if len(tail) == 769 and tail[0] == 12:
            ramp = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
            if tail[1:] != ramp:
                mode = raw = "P"
                palette = tail[1:]
    elif version == 5 and bits == 8 and planes == 3:
        mode, raw = "RGB", "RGB;L"
    else:
        raise OSError("unknown PCX mode")
    width, height = x1 - x0, y1 - y0
    stride = (width * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    linebytes = planes * stride

    def load() -> pixels.Decoded:
        if rawmode.linebytes(raw, width) > linebytes:
            raise RasterError("buffer overrun when reading image file")
        # the planes of a padded line move only where they are bytes
        try:
            lines, done = _native.rle_lines("pcx", blob, offset, linebytes,
                                            height,
                                            xsize=width if bits == 8 else 0)
        except ValueError as e:
            raise RasterError(str(e)) from e
        if done < height:
            raise RasterError(pixels.TRUNCATED)
        if planes > 1 and bits == 1:  # bit plane k starts k strides in
            step = (width + 7) // 8
            lines = np.concatenate([lines[:, k * stride:k * stride + step]
                                    for k in range(planes)], axis=1)
        return pixels.Decoded(mode, rawmode.unpack(lines, raw, width),
                              palette)

    return pixels.Opened(mode, (width, height), load)


def dcx_open_image(blob: bytes) -> pixels.Opened:
    if not dcx_accept(blob[:4]):
        raise SyntaxError("not a DCX file")
    offsets = []
    for i in range(1024):
        offset = struct.unpack_from("<I", blob[4 + 4 * i:8 + 4 * i])[0]
        if not offset:
            break
        offsets.append(offset)
    return open_image(blob, offsets[0])
