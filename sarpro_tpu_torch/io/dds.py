"""DDS reader: the image Pillow 12.1 opens from a DirectDraw Surface
(PIL/DdsImagePlugin.py), quirks included:

  * a 124-byte header (another size, or a header cut short, fails the open
    with Pillow's OSError); the pixels follow the header (and the DX10
    extension), whatever the header says;
  * uncompressed RGB / RGBA under any masks and bit counts (DdsRgbDecoder:
    each pixel `bitcount // 8` little-endian bytes, each channel its masked
    bits over the mask's maximum times 255, truncated; a file cut short
    reads zeros), L at 8 bits, LA at 16, P with a 1024-byte RGBA palette
    (the alpha dropped, as the JAX reader's `convert("RGB")` drops it), and
    DX10 R8G8B8A8;
  * block-compressed pixels through io/bcn: DXT1 / DXT3 / DXT5, BC4 /
    ATI1, BC5 / ATI2 / BC5S, and DX10's BC1-BC7 (their TYPELESS and UNORM
    forms, BC7's sRGB one too, and BC5_SNORM and BC6H's two);
  * other pixel formats, flags and DXGI formats refused with Pillow's
    NotImplementedError words.
Pillow's `info` holds no strings for a DDS."""
from __future__ import annotations

import struct

import numpy as np

from ..errors import RasterError
from . import bcn, pixels, rawmode

MAGIC = b"DDS "
RGB, ALPHAPIXELS, FOURCC, PAL8, LUMINANCE = 0x40, 0x1, 0x4, 0x20, 0x20000


def _fourcc(text: bytes) -> int:
    return struct.unpack("<I", text)[0]


# FOURCC -> (mode, n, signed)
FOURCCS = {
    _fourcc(b"DXT1"): ("RGBA", 1, False), _fourcc(b"DXT3"): ("RGBA", 2, False),
    _fourcc(b"DXT5"): ("RGBA", 3, False), _fourcc(b"BC4U"): ("L", 4, False),
    _fourcc(b"ATI1"): ("L", 4, False), _fourcc(b"BC5S"): ("RGB", 5, True),
    _fourcc(b"BC5U"): ("RGB", 5, False), _fourcc(b"ATI2"): ("RGB", 5, False),
}
DX10 = _fourcc(b"DX10")
# DXGI format -> (mode, n, signed); n 0: raw RGBA
DXGI = {70: ("RGBA", 1, False), 71: ("RGBA", 1, False),
        73: ("RGBA", 2, False), 74: ("RGBA", 2, False),
        76: ("RGBA", 3, False), 77: ("RGBA", 3, False),
        79: ("L", 4, False), 80: ("L", 4, False),
        82: ("RGB", 5, False), 83: ("RGB", 5, False),
        84: ("RGB", 5, True), 95: ("RGB", 6, False), 96: ("RGB", 6, True),
        97: ("RGBA", 7, False), 98: ("RGBA", 7, False),
        99: ("RGBA", 7, False), 27: ("RGBA", 0, False),
        28: ("RGBA", 0, False), 29: ("RGBA", 0, False)}


def accept(prefix: bytes) -> bool:
    return prefix.startswith(MAGIC)


def _masked(blob: bytes, pos: int, width: int, height: int, bitcount: int,
            masks: tuple) -> np.ndarray:
    """DdsRgbDecoder: (height, width, len(masks)) u8."""
    count = bitcount // 8
    npx = width * height
    raw = np.frombuffer(blob[pos:pos + count * npx], np.uint8)
    raw = np.concatenate([raw, np.zeros(count * npx - len(raw), np.uint8)])
    keep = min(count, 4)
    value = np.zeros(npx, np.uint64)
    if count:
        px = raw.reshape(npx, count)
        for k in range(keep):
            value |= px[:, k].astype(np.uint64) << np.uint64(8 * k)
    out = np.empty((npx, len(masks)), np.uint8)
    for i, mask in enumerate(masks):
        offset = 0
        if mask:
            while mask >> (offset + 1) << (offset + 1) == mask:
                offset += 1
        total = mask >> offset
        if total:
            v = (value & np.uint64(mask)) >> np.uint64(offset)
            out[:, i] = np.floor(v.astype(np.float64) / total * 255)
        else:
            out[:, i] = 0
    return out.reshape(height, width, len(masks))


def open_image(blob: bytes) -> pixels.Opened:
    if not blob.startswith(MAGIC):
        raise SyntaxError("not a DDS file")
    (header_size,) = struct.unpack("<I", blob[4:8])
    if header_size != 124:
        raise OSError(f"Unsupported header size {header_size!r}")
    header = blob[8:128]
    if len(header) != 120:
        raise OSError(f"Incomplete header: {len(header)} bytes")
    _, height, width = struct.unpack("<3I", header[:12])
    pfflags, fourcc, bitcount = struct.unpack("<3I", header[72:84])
    pos = 128
    if pfflags & RGB:
        mode = "RGBA" if pfflags & ALPHAPIXELS else "RGB"
        masks = struct.unpack(f"<{len(mode)}I", header[84:84 + 4 * len(mode)])
        return pixels.Opened(mode, (width, height), lambda: pixels.Decoded(
            mode, _masked(blob, pos, width, height, bitcount, masks)))
    palette = b""
    n, signed = 0, False
    if pfflags & LUMINANCE:
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and pfflags & ALPHAPIXELS:
            mode = "LA"
        else:
            raise OSError(f"Unsupported bitcount {bitcount} for {pfflags}")
    elif pfflags & PAL8:
        mode = "P"
        table = blob[pos:pos + 1024]
        pos += len(table)
        entries = np.frombuffer(table[:len(table) // 4 * 4], np.uint8)
        palette = entries.reshape(-1, 4)[:, :3].tobytes()
    elif pfflags & FOURCC:
        if fourcc == DX10:
            (dxgi,) = struct.unpack("<I", blob[pos:pos + 4])
            pos += 4 + len(blob[pos + 4:pos + 20])
            if dxgi not in DXGI:
                raise NotImplementedError(f"Unimplemented DXGI format {dxgi}")
            mode, n, signed = DXGI[dxgi]
        elif fourcc in FOURCCS:
            mode, n, signed = FOURCCS[fourcc]
        else:
            raise NotImplementedError(
                f"Unimplemented pixel format {fourcc!r}")
    else:
        raise NotImplementedError(f"Unknown pixel format flags {pfflags}")

    def load() -> pixels.Decoded:
        if n:
            return pixels.Decoded(mode, bcn.decode(blob[pos:], width, height,
                                                   n, signed))
        lines = pixels.raw_lines(blob, pos, rawmode.linebytes(mode, width),
                                 height)
        return pixels.Decoded(mode, rawmode.unpack(lines, mode, width),
                              palette)

    return pixels.Opened(mode, (width, height), load)
