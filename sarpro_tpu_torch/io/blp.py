"""BLP reader: the image Pillow 12.1 opens from a Blizzard Mipmap file
(PIL/BlpImagePlugin.py), quirks included:

  * "RGBA" where the header's alpha field is not 0, else "RGB"; the 16
    mipmap offsets and lengths after the header, only the first mipmap
    read;
  * BLP1 JPEG (compression 0): a shared JPEG header, then the first
    mipmap's bytes from its offset, opened through io/jpeg; a CMYK JPEG
    read as CMYK even where its Adobe marker says YCCK (Pillow's jpegmode
    "CMYK") and taken to RGB by Pillow's conversion, and the RGB
    bytes read back as BGR (red and blue swapped) onto the BLP's rows;
  * palettes (BLP1 encodings 4 and 5, BLP2 encoding 1): 256 BGRA entries,
    each index byte its entry's RGB (and its A in an "RGBA" image), BLP1
    reading the indices right after the palette, BLP2 at the mipmap's
    offset;
  * BLP2 DXT1 / DXT3 / DXT5 (encoding 2, alpha encodings 0, 1 and 7)
    through Pillow's own Python decoders (`decode_dxt1/3/5`: 5-6-5 colours
    shifted, not widened, so a block reads otherwise than through io/bcn),
    each block row of (width + 3) // 4 blocks, the rows of padded pixels
    laid onto the image's rows as one byte stream (an RGB image reads DXT3
    / DXT5's four bytes a pixel three at a time);
  * other compressions and encodings refused with Pillow's words, and a
    file cut short with its "Truncated File Read".
Pillow's `info` holds no strings for a BLP."""
from __future__ import annotations

import struct

import numpy as np

from ..errors import RasterError
from . import jpeg, pixels

MAGICS = (b"BLP1", b"BLP2")


def accept(prefix: bytes) -> bool:
    return prefix.startswith(MAGICS)


class _File:
    """Pillow's `_safe_read` over the blob from a position."""

    def __init__(self, blob: bytes, pos: int):
        self.blob, self.pos = blob, pos

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        data = self.blob[self.pos:self.pos + n]
        if len(data) < n:
            raise RasterError("Truncated File Read")
        self.pos += n
        return data


def _565(c: np.ndarray) -> np.ndarray:
    """unpack_565: (..., 3) int32."""
    return np.stack([((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2,
                     (c & 0x1F) << 3], -1)


def _colours(blocks: np.ndarray, three: bool) -> tuple:
    """(n, 16, 3) colours and (n, 16) alphas (255, or 0 for DXT1's
    transparent black) of (n, 8) colour blocks."""
    w = blocks[:, :4].copy().view("<u2").astype(np.int32)
    c0, c1 = w[:, 0], w[:, 1]
    e0, e1 = _565(c0), _565(c1)
    four = (c0 > c1)[:, None] if three else np.ones((len(c0), 1), bool)
    p2 = np.where(four, (2 * e0 + e1) // 3, (e0 + e1) // 2)
    p3 = np.where(four, (2 * e1 + e0) // 3, 0)
    pal = np.stack([e0, e1, p2, p3], 1)
    code = blocks[:, 4:8].copy().view("<u4")[:, 0].astype(np.int64)
    idx = (code[:, None] >> (2 * np.arange(16))) & 3
    rgb = np.take_along_axis(pal, idx[..., None], 1)
    alpha = np.where((idx == 3) & ~four, 0, 255)
    return rgb, alpha


def _dxt(data: bytes, bw: int, bh: int, kind: int, alpha: bool) -> bytes:
    """decode_dxt1 / 3 / 5 of every block row: the byte stream of the
    rows of 4 * bw pixels (RGB, or RGBA for DXT1 with alpha, DXT3, DXT5)."""
    size = 8 if kind == 1 else 16
    blocks = np.frombuffer(data, np.uint8).reshape(bh * bw, size)
    if kind == 1:
        rgb, a = _colours(blocks, True)
    else:
        rgb, _ = _colours(blocks[:, 8:], False)
        if kind == 3:
            nib = np.stack([blocks[:, :8] & 15, blocks[:, :8] >> 4], 2)
            a = nib.reshape(-1, 16).astype(np.int32) * 17
        else:
            a0 = blocks[:, 0].astype(np.int32)[:, None]
            a1 = blocks[:, 1].astype(np.int32)[:, None]
            bits = np.zeros(len(blocks), np.int64)
            for k in range(6):
                bits |= blocks[:, 2 + k].astype(np.int64) << (8 * k)
            code = (bits[:, None] >> (3 * np.arange(16))) & 7
            big = a0 > a1
            a = np.where(code == 0, a0, np.where(code == 1, a1, np.where(
                big, ((8 - code) * a0 + (code - 1) * a1) // 7, np.where(
                    code == 6, 0, np.where(
                        code == 7, 255,
                        ((6 - code) * a0 + (code - 1) * a1) // 5)))))
    keep_alpha = kind != 1 or alpha
    px = np.concatenate([rgb, a[..., None]], -1) if keep_alpha else rgb
    px = px.astype(np.uint8).reshape(bh, bw, 4, 4, -1)
    return px.transpose(0, 2, 1, 3, 4).tobytes()


def _as_raw(data: bytes, mode: str, width: int, height: int,
            raw: str = "") -> np.ndarray:
    """set_as_raw: the image's rows from the start of `data` (in `raw`,
    its mode's rawmode by default)."""
    raw = raw or mode
    bands = len(raw)
    need = width * height * bands
    if len(data) < need:
        raise RasterError("not enough image data")
    px = np.frombuffer(data, np.uint8, need).reshape(height, width, bands)
    if raw == "BGR":
        px = px[..., ::-1]
    if mode == "RGBA" and bands == 3:
        px = np.concatenate([px, np.full((height, width, 1), 255, np.uint8)],
                            -1)
    return np.ascontiguousarray(px)


def _bgra(f: _File, palette: np.ndarray, alpha: bool, length: int) -> bytes:
    idx = np.frombuffer(f.read(length), np.uint8)
    table = palette[:, [2, 1, 0, 3]] if alpha else palette[:, [2, 1, 0]]
    return table[idx].tobytes()


def _cmyk_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's CMYK to RGB conversion."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:4]
    tmp = c[..., :3] * nk + 128
    return np.clip(nk - (((tmp >> 8) + tmp) >> 8), 0, 255).astype(np.uint8)


def _jpeg(f: _File, offsets: tuple, lengths: tuple) -> np.ndarray:
    (size,) = struct.unpack("<I", f.read(4))
    header = f.read(size)
    f.read(offsets[0] - f.pos)
    data = header + f.read(lengths[0])
    if not data.startswith(jpeg.SIGNATURE):
        raise RasterError("not a JPEG file")
    img = jpeg.read(data, cmyk=True)
    if img.mode == "CMYK":
        return _cmyk_rgb(img.array)
    if img.mode == "L":
        return np.repeat(img.array[..., None], 3, -1)
    return img.array


def open_image(blob: bytes) -> pixels.Opened:
    magic = blob[:4]
    if magic not in MAGICS:
        raise NotImplementedError(f"Bad BLP magic {magic!r}")
    (compression,) = struct.unpack("<i", blob[4:8])
    if magic == b"BLP1":
        alpha = struct.unpack("<I", blob[8:12])[0] != 0
        pos = 12
    else:
        encoding, alpha_flag, alpha_encoding = struct.unpack("<3b",
                                                             blob[8:11])
        alpha = alpha_flag != 0
        pos = 12
    width, height = struct.unpack("<II", blob[pos:pos + 8])
    if magic == b"BLP1":
        (encoding,) = struct.unpack("<i", blob[20:24])
        offset = 28
    else:
        offset = 20
    mode = "RGBA" if alpha else "RGB"

    def load() -> pixels.Decoded:
        f = _File(blob, offset)
        offsets = struct.unpack("<16I", f.read(64))
        lengths = struct.unpack("<16I", f.read(64))
        if magic == b"BLP1":
            if compression == 0:
                rgb = _jpeg(f, offsets, lengths)
                return pixels.Decoded(mode, _as_raw(rgb.tobytes(), mode,
                                                    width, height, "BGR"))
            if compression != 1:
                raise RasterError(f"Unsupported BLP compression {encoding!r}")
            if encoding not in (4, 5):
                raise RasterError(f"Unsupported BLP encoding {encoding!r}")
            palette = np.frombuffer(f.read(1024), np.uint8).reshape(256, 4)
            data = _bgra(f, palette, alpha, lengths[0])
            return pixels.Decoded(mode, _as_raw(data, mode, width, height))
        palette = np.frombuffer(f.read(1024), np.uint8).reshape(256, 4)
        f.pos = offsets[0]
        if compression != 1:
            raise RasterError(f"Unknown BLP compression {compression!r}")
        if encoding == 1:
            data = _bgra(f, palette, alpha, lengths[0])
        elif encoding == 2:
            kind = {0: 1, 1: 3, 7: 5}.get(alpha_encoding)
            if kind is None:
                raise RasterError(
                    f"Unsupported alpha encoding {alpha_encoding!r}")
            bw, bh = (width + 3) // 4, (height + 3) // 4
            line = bw * (8 if kind == 1 else 16)
            data = _dxt(f.read(line * bh), bw, bh, kind, alpha)
        else:
            raise RasterError(f"Unknown BLP encoding {encoding!r}")
        return pixels.Decoded(mode, _as_raw(data, mode, width, height))

    return pixels.Opened(mode, (width, height), load)
