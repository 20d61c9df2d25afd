"""ICNS reader: the image Pillow 12.1 opens from a Mac OS icon
(PIL/IcnsImagePlugin.py), quirks included:

  * the blocks after the 8-byte header, each (type, size) with its data,
    up to the size the header gives; a block size of 0 or less, or a
    header that runs past the data, hands the file on;
  * the size: the largest (width, height, scale) of Pillow's table with a
    block of its types, "RGBA" at width * scale, height * scale while it
    opens;
  * every reader of that size's block types runs, in the table's order:
    PNG blocks (io/png, the image in its own mode) and JPEG 2000 ones
    (io/jpeg2000, converted to "RGBA") give the image; else the RGB of
    it32 (4 zero bytes first) / ih32 / il32 / is32, raw where the block is
    exactly 3 * w * h bytes, else three run-length channels read on from
    the block's start (C++, _native/rledec.cpp), with the alpha of the
    t8mk / h8mk / l8mk / s8mk mask where there is one;
  * the image's own size kept where one of the file's sizes divides to it
    (Pillow's size check), else the load fails.
Pillow's `info` holds no strings for an ICNS (the sizes are a list)."""
from __future__ import annotations

import struct

import numpy as np

from .. import _native
from ..errors import RasterError
from . import jpeg2000, pixels, png

MAGIC = b"icns"
# (width, height, scale) -> the block types of that size, in Pillow's order
SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",),
    (256, 256, 2): (b"ic14",), (256, 256, 1): (b"ic08",),
    (128, 128, 2): (b"ic13",),
    (128, 128, 1): (b"ic07", b"it32", b"t8mk"),
    (64, 64, 1): (b"icp6",), (32, 32, 2): (b"ic12",),
    (48, 48, 1): (b"ih32", b"h8mk"),
    (32, 32, 1): (b"icp5", b"il32", b"l8mk"),
    (16, 16, 2): (b"ic11",),
    (16, 16, 1): (b"icp4", b"is32", b"s8mk"),
}
J2K_SIGS = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")
JP2_SIG = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"


def accept(prefix: bytes) -> bool:
    return prefix.startswith(MAGIC)


def _blocks(blob: bytes) -> dict:
    sig, filesize = struct.unpack(">4sI", blob[:8])
    if not accept(sig):
        raise SyntaxError("not an icns file")
    blocks = {}
    i = 8
    while i < filesize:
        sig, size = struct.unpack(">4sI", blob[i:i + 8])
        if size <= 0:
            raise SyntaxError("invalid block header")
        i += 8
        blocks[sig] = (i, size - 8)
        i += size - 8
    return blocks


def _png_or_j2k(blob: bytes, start: int, length: int) -> pixels.Decoded:
    sig = blob[start:start + 12]
    if sig.startswith(png.SIGNATURE):
        return png.read(blob[start:])
    if sig.startswith(J2K_SIGS) or sig == JP2_SIG:
        if length < -1:
            raise RasterError("read length must be non-negative or -1")
        img = jpeg2000.read(blob[start:] if length == -1 else
                            blob[start:start + length])
        return pixels.Decoded("RGBA", pixels.to_rgba(img))
    raise RasterError("Unsupported icon subimage format")


def _rgb32(blob: bytes, start: int, length: int, side: int) -> np.ndarray:
    count = side * side
    if length == 3 * count:
        data = blob[start:start + length]
        if len(data) < 3 * count:
            raise RasterError("not enough image data")
        return np.frombuffer(data, np.uint8).reshape(side, side, 3).copy()
    out = np.empty((side, side, 3), np.uint8)
    pos = start
    for band in range(3):
        try:
            channel, pos = _native.icns_rle(blob, pos, count)
        except ValueError as e:
            raise RasterError(str(e)) from e
        out[..., band] = channel.reshape(side, side)
    return out


def open_image(blob: bytes) -> pixels.Opened:
    blocks = _blocks(blob)
    sizes = [size for size, kinds in SIZES.items()
             if any(k in blocks for k in kinds)]
    if not sizes:
        raise SyntaxError("No 32bit icon resources found")
    best = max(sizes)
    w, h, scale = best

    def load() -> pixels.Decoded:
        side = w * scale
        channels = {}
        for kind in SIZES[best]:
            if kind not in blocks:
                continue
            start, length = blocks[kind]
            if kind in (b"it32", b"ih32", b"il32", b"is32"):
                if kind == b"it32":
                    if blob[start:start + 4] != bytes(4):
                        raise RasterError(
                            "Unknown signature, expecting 0x00000000")
                    start, length = start + 4, length - 4
                channels["RGB"] = _rgb32(blob, start, length, side)
            elif kind.endswith(b"8mk"):
                data = blob[start:start + side * side]
                if len(data) < side * side:
                    raise RasterError("buffer is not large enough")
                channels["A"] = np.frombuffer(data, np.uint8).reshape(side,
                                                                      side)
            else:
                channels["RGBA"] = _png_or_j2k(blob, start, length)
        if "RGBA" in channels:
            img = channels["RGBA"]
        elif "RGB" not in channels:
            raise RasterError("ICNS: no RGB block for the mask ('RGB')")
        elif "A" in channels:
            img = pixels.Decoded("RGBA", np.dstack([channels["RGB"],
                                                    channels["A"]]))
        else:
            img = pixels.Decoded("RGB", channels["RGB"])
        height, width = img.array.shape[:2]
        for s in sizes:
            sw, sh = s[0] * s[2], s[1] * s[2]
            if sh / height == sw // width:
                return img
        raise RasterError("This is not one of the allowed sizes of this "
                          "image")

    return pixels.Opened("RGBA", (w * scale, h * scale), load)
