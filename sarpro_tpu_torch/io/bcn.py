"""Block-compressed textures: Pillow 12.1's `bcn` decoder (its C BcnDecode,
reached from PIL/DdsImagePlugin.py and PIL/FtexImagePlugin.py) for the
formats n = 1..7 it takes, each 4 x 4 block to the pixels Pillow gives:

  * BC1 (n 1, "RGBA"): two 5-6-5 colours widened by bit copies, their
    thirds (or their half and transparent black where c0 <= c1);
  * BC2 (2, "RGBA"): BC1 colours in the four-colour mode and 4-bit alphas
    times 17; BC3 (3, "RGBA"): BC1 colours and BC4's 3-bit alpha ramp;
  * BC4 (4, "L"): eight levels between two bytes (six and 0 / 255 where
    the first is not above the second);
  * BC5 (5, "RGB") and BC5S: two BC4 channels into red and green, the
    signed one's end points offset by 128 and its blue 128 (the unsigned
    one's 0);
  * BC6H (6, "RGB", unsigned and signed): the fourteen modes' end points,
    deltas (their sums not sign-extended again, as Pillow leaves them) and
    unquantisation, interpolated, taken through half floats and clamped to
    0..1 times 255 (a reserved mode code reads black);
  * BC7 (7, "RGBA"): the eight modes (a first byte of 0 reads opaque
    black).

The C++ library (`_native/bcndec.cpp`) decodes files; `decode_blocks`
here is the plain numpy / Python version the tests hold it to, block by
block."""
from __future__ import annotations

import numpy as np

from .. import _native
from ..errors import RasterError
from . import pixels

# n -> (bytes a block, bands of the image)
BLOCK = {1: (8, 4), 2: (16, 4), 3: (16, 4), 4: (8, 1), 5: (16, 3),
         6: (16, 3), 7: (16, 4)}

# BC7 / BC6H two- and three-subset partitions (pixel i's subset), and the
# anchor pixels of the second and third subsets
P2 = (0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80,
      0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000,
      0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE,
      0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C,
      0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A,
      0x73CE, 0x13C8, 0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660,
      0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C,
      0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22)
P3 = (0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000,
      0xA0A05050, 0x5555A0A0, 0x5A5A5050, 0xAA550000, 0xAA555500,
      0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4, 0xA9A59450,
      0x2A0A4250, 0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0,
      0xA8A85454, 0x6A6A4040, 0xA4A45000, 0x1A1A0500, 0x0050A4A4,
      0xAAA59090, 0x14696914, 0x69691400, 0xA08585A0, 0xAA821414,
      0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050,
      0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50,
      0x500AA550, 0xAAAA4444, 0x66660000, 0xA5A0A5A0, 0x50A050A0,
      0x69286928, 0x44AAAA44, 0x66666600, 0xAA444444, 0x54A854A8,
      0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414,
      0x96960000, 0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000,
      0x40804080, 0xA9A8A9A8, 0xAAAAAA44, 0x2A4A5254)
A2 = (15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
      15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
      15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
      6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
A31 = (3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
       3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
       8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
       3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
A32 = (15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
       15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
       15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
       15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8)
WEIGHTS = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
           4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)}
# BC7 modes: subsets, partition bits, rotation bits, index-selection bits,
# colour bits, alpha bits, end-point P-bits, shared P-bits, index bits,
# secondary index bits
BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
             (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
             (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
             (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
# BC6H modes by Pillow's index (mode codes 00, 01, then x10 by code >> 2,
# then x11): subsets, transformed (delta) end points, partition bits, end
# point bits, red / green / blue delta bits
BC6_MODES = ((2, 1, 5, 10, 5, 5, 5), (2, 1, 5, 7, 6, 6, 6),
             (2, 1, 5, 11, 5, 4, 4), (2, 1, 5, 11, 4, 5, 4),
             (2, 1, 5, 11, 4, 4, 5), (2, 1, 5, 9, 5, 5, 5),
             (2, 1, 5, 8, 6, 5, 5), (2, 1, 5, 8, 5, 6, 5),
             (2, 1, 5, 8, 5, 5, 6), (2, 0, 5, 6, 6, 6, 6),
             (1, 0, 0, 10, 10, 10, 10), (1, 1, 0, 11, 9, 9, 9),
             (1, 1, 0, 12, 8, 8, 8), (1, 1, 0, 16, 4, 4, 4))
# where each end-point bit of a BC6H mode lies, in the order stored: the
# field (r, g, b of end points w, x, y, z) and its bit; "a-b" runs a..b
BC6_LAYOUTS = (
    "gy4 by4 bz4 rw0-9 gw0-9 bw0-9 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 bx0-4 "
    "bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    "gy5 gz4 gz5 rw0-6 bz0 bz1 by4 gw0-6 by5 bz2 gy4 bw0-6 bz3 bz5 bz4 "
    "rx0-5 gy0-3 gx0-5 gz0-3 bx0-5 by0-3 ry0-5 rz0-5",
    "rw0-9 gw0-9 bw0-9 rx0-4 rw10 gy0-3 gx0-3 gw10 bz0 gz0-3 bx0-3 bw10 "
    "bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    "rw0-9 gw0-9 bw0-9 rx0-3 rw10 gz4 gy0-3 gx0-4 gw10 gz0-3 bx0-3 bw10 "
    "bz1 by0-3 ry0-3 bz0 bz2 rz0-3 gy4 bz3",
    "rw0-9 gw0-9 bw0-9 rx0-3 rw10 by4 gy0-3 gx0-3 gw10 bz0 gz0-3 bx0-4 "
    "bw10 by0-3 ry0-3 bz1 bz2 rz0-3 bz4 bz3",
    "rw0-8 by4 gw0-8 gy4 bw0-8 bz4 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 bx0-4 "
    "bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    "rw0-7 gz4 by4 gw0-7 bz2 gy4 bw0-7 bz3 bz4 rx0-5 gy0-3 gx0-4 bz0 "
    "gz0-3 bx0-4 bz1 by0-3 ry0-5 rz0-5",
    "rw0-7 bz0 by4 gw0-7 gy5 gy4 bw0-7 gz5 bz4 rx0-4 gz4 gy0-3 gx0-5 "
    "gz0-3 bx0-4 bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    "rw0-7 bz1 by4 gw0-7 by5 gy4 bw0-7 bz5 bz4 rx0-4 gz4 gy0-3 gx0-4 bz0 "
    "gz0-3 bx0-5 by0-3 ry0-4 bz2 rz0-4 bz3",
    "rw0-5 gz4 bz0 bz1 by4 gw0-5 gy5 by5 bz2 gy4 bw0-5 gz5 bz3 bz5 bz4 "
    "rx0-5 gy0-3 gx0-5 gz0-3 bx0-5 by0-3 ry0-5 rz0-5",
    "rw0-9 gw0-9 bw0-9 rx0-9 gx0-9 bx0-9",
    "rw0-9 gw0-9 bw0-9 rx0-8 rw10 gx0-8 gw10 bx0-8 bw10",
    "rw0-9 gw0-9 bw0-9 rx0-7 rw11-10 gx0-7 gw11-10 bx0-7 bw11-10",
    "rw0-9 gw0-9 bw0-9 rx0-3 rw15-10 gx0-3 gw15-10 bx0-3 bw15-10",
)


def _layout(text: str) -> tuple:
    """(field, bit) of each stored end-point bit: field 3 * point +
    channel, points w, x, y, z."""
    out = []
    for tok in text.split():
        field = "wxyz".index(tok[1]) * 3 + "rgb".index(tok[0])
        a, _, b = tok[2:].partition("-")
        a, b = int(a), int(b or a)
        step = 1 if b >= a else -1
        out += [(field, k) for k in range(a, b + step, step)]
    return tuple(out)


BC6_BITS = tuple(_layout(t) for t in BC6_LAYOUTS)


def _bits(block: bytes, start: int, count: int) -> int:
    return (int.from_bytes(block, "little") >> start) & ((1 << count) - 1)


def _565(c: np.ndarray) -> np.ndarray:
    """(..., 3) int32 of 5-6-5 words, each channel widened by copying its
    top bits."""
    r = (c & 0xF800) >> 8
    g = (c & 0x7E0) >> 3
    b = (c & 0x1F) << 3
    return np.stack([r | (r >> 5), g | (g >> 6), b | (b >> 5)], -1)


def _bc1(blocks: np.ndarray, four: bool) -> np.ndarray:
    """(n, 16, 4) of (n, 8) BC1 colour blocks; `four`: always the
    four-colour mode (BC2 and BC3)."""
    w = blocks.view("<u2").astype(np.int32)
    c0, c1 = w[:, 0], w[:, 1]
    e0, e1 = _565(c0), _565(c1)
    opaque = np.full(len(blocks), 255, np.int32)
    third = (c0 > c1) | four
    p2 = np.where(third[:, None], (2 * e0 + e1) // 3, (e0 + e1) // 2)
    p3 = np.where(third[:, None], (e0 + 2 * e1) // 3, 0)
    a3 = np.where(third, 255, 0)
    pal = np.stack([np.concatenate([e0, opaque[:, None]], 1),
                    np.concatenate([e1, opaque[:, None]], 1),
                    np.concatenate([p2, opaque[:, None]], 1),
                    np.concatenate([p3, a3[:, None]], 1)], 1)
    lut = blocks[:, 4:8].copy().view("<u4")[:, 0].astype(np.int64)
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(pal, idx[..., None], 1).astype(np.uint8)


def _ramp(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    """(n, 16) of (n, 8) BC4 blocks (BC3's alpha, BC5's channels)."""
    a0 = blocks[:, 0].astype(np.int32)
    a1 = blocks[:, 1].astype(np.int32)
    if signed:
        a0 = blocks[:, 0].view(np.int8).astype(np.int32) + 128
        a1 = blocks[:, 1].view(np.int8).astype(np.int32) + 128
    big = (a0 > a1)[:, None]
    k = np.arange(1, 7)
    seven = ((7 - k) * a0[:, None] + k * a1[:, None]) // 7
    k4 = np.arange(1, 5)
    five = ((5 - k4) * a0[:, None] + k4 * a1[:, None]) // 5
    five = np.concatenate([five, np.zeros((len(a0), 1), np.int32),
                           np.full((len(a0), 1), 255, np.int32)], 1)
    pal = np.concatenate([a0[:, None], a1[:, None],
                          np.where(big, seven, five)], 1) & 255
    bits = np.zeros(len(blocks), np.int64)
    for k in range(6):
        bits |= blocks[:, 2 + k].astype(np.int64) << (8 * k)
    idx = (bits[:, None] >> (3 * np.arange(16))) & 7
    return np.take_along_axis(pal, idx, 1).astype(np.uint8)


def _bc7(block: bytes) -> np.ndarray:
    out = np.zeros((16, 4), np.int64)
    first = block[0]
    if not first:
        out[:, 3] = 255
        return out
    mode = (first & -first).bit_length() - 1
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = BC7_MODES[mode]
    bit = mode + 1

    def take(n):
        nonlocal bit
        v = _bits(block, bit, n)
        bit += n
        return v

    partition, rotation, index_sel = take(pb), take(rb), take(isb)
    nep = 2 * ns
    ends = np.zeros((nep, 4), np.int64)
    for ch in range(3):
        for i in range(nep):
            ends[i, ch] = take(cb)
    for i in range(nep):
        ends[i, 3] = take(ab) if ab else 255
    chans = 4 if ab else 3
    if epb:
        cb += 1
        ab += 1 if ab else 0
        for i in range(nep):
            p = take(1)
            ends[i, :chans] = (ends[i, :chans] << 1) | p
    if spb:
        cb += 1
        ab += 1 if ab else 0
        for i in range(0, nep, 2):
            p = take(1)
            ends[i:i + 2, :chans] = (ends[i:i + 2, :chans] << 1) | p

    def expand(v, b):
        v = (v << (8 - b)) & 255
        return v | (v >> b)

    ends[:, :3] = expand(ends[:, :3], cb)
    if ab:
        ends[:, 3] = expand(ends[:, 3], ab)
    cw = WEIGHTS[ib]
    aw = WEIGHTS[ib2 if ab and ib2 else ib]
    cbit = bit
    abit = cbit + 16 * ib - ns
    for i in range(16):
        if ns == 2:
            s = (P2[partition] >> i) & 1
        elif ns == 3:
            s = (P3[partition] >> (2 * i)) & 3
        else:
            s = 0
        n = ib
        if i == 0 or (ns == 2 and i == A2[partition]) or (
                ns == 3 and ((s == 1 and i == A31[partition])
                             or (s == 2 and i == A32[partition]))):
            n -= 1
        i0 = _bits(block, cbit, n)
        cbit += n
        e0, e1 = ends[2 * s], ends[2 * s + 1]
        if ab and ib2:
            n2 = ib2 - 1 if i == 0 else ib2
            i1 = _bits(block, abit, n2)
            abit += n2
            sc, sa = (aw[i1], cw[i0]) if index_sel else (cw[i0], aw[i1])
        else:
            sc = sa = cw[i0]
        px = np.empty(4, np.int64)
        px[:3] = ((64 - sc) * e0[:3] + sc * e1[:3] + 32) >> 6
        px[3] = ((64 - sa) * e0[3] + sa * e1[3] + 32) >> 6
        if rotation:
            px[rotation - 1], px[3] = px[3], px[rotation - 1]
        out[i] = px & 255
    return out


def _half_to_float(h: int) -> float:
    """Half-float bits to float32 as Pillow converts them (infinities and
    NaNs from exponent 31)."""
    v = np.array([h & 0x7FFF], np.uint32) << 13
    f = v.view(np.float32) * np.float32(2.0 ** 112)
    if f[0] >= np.float32(65536.0):
        f = (f.view(np.uint32) | np.uint32(255 << 23)).view(np.float32)
    bits = f.view(np.uint32) | np.uint32((h & 0x8000) << 16)
    return bits.view(np.float32)[0]


def _bc6_out(v: int, signed: bool) -> int:
    if signed:
        h = 0x8000 | (-v * 31) // 32 if v < 0 else (v * 31) // 32
    else:
        h = (v * 31) // 64
    f = _half_to_float(h & 0xFFFF)
    if f < 0:
        return 0
    if f > 1:
        return 255
    return int(np.float32(f) * np.float32(255.0))


def _sext(v: int, bits: int) -> int:
    v &= 0xFFFF
    if v & (1 << (bits - 1)):
        v |= (-1 << bits) & 0xFFFF
    return v


def _unquantize(v: int, bits: int, signed: bool) -> int:
    if not signed:
        if bits >= 15 or v == 0:
            return v
        if v == (1 << bits) - 1:
            return 0xFFFF
        return ((v << 15) + 0x4000) >> (bits - 1)
    x = v - 0x10000 if v & 0x8000 else v
    if bits >= 16:
        return x
    neg = x < 0
    x = -x if neg else x
    if x:
        x = 0x7FFF if x >= (1 << (bits - 1)) - 1 else \
            ((x << 15) + 0x4000) >> (bits - 1)
    return -x if neg else x


def _bc6(block: bytes, signed: bool) -> np.ndarray:
    out = np.zeros((16, 3), np.int64)
    code = block[0] & 0x1F
    bit, epbits, ib = 5, 72, 3
    if code & 3 in (0, 1):
        mode, bit, epbits = code & 3, 2, 75
    elif code & 3 == 2:
        mode = 2 + (code >> 2)
    else:
        mode, epbits, ib = 10 + (code >> 2), 60, 4
    if mode >= 14:
        return out
    ns, tr, pb, epb, rb, gb, bb = BC6_MODES[mode]
    ends = [0] * 12
    for k, (field, b) in enumerate(BC6_BITS[mode]):
        ends[field] |= _bits(block, bit + k, 1) << b
    bit += epbits
    partition = _bits(block, bit, pb)
    bit += pb
    mask = (1 << epb) - 1
    nep = 12 if ns == 2 else 6
    if signed:
        ends[0:3] = [_sext(e, epb) for e in ends[0:3]]
    if signed or tr:
        for i in range(3, nep, 3):
            ends[i] = _sext(ends[i], rb)
            ends[i + 1] = _sext(ends[i + 1], gb)
            ends[i + 2] = _sext(ends[i + 2], bb)
    if tr:
        for i in range(3, nep):
            # Pillow adds the deltas under the mask and, signed or not,
            # does not sign-extend the sums again
            ends[i] = (ends[i] + ends[i % 3]) & mask
    u = [_unquantize(e, epb, signed) for e in ends[:nep]]
    w = WEIGHTS[ib]
    for i in range(16):
        s = (P2[partition] >> i) & 1 if ns == 2 else 0
        n = ib - 1 if i == 0 or (ns == 2 and i == A2[partition]) else ib
        i0 = _bits(block, bit, n)
        bit += n
        t = w[i0]
        for ch in range(3):
            v = (u[6 * s + ch] * (64 - t) + u[6 * s + 3 + ch] * t) >> 6
            out[i, ch] = _bc6_out(v, signed)
    return out


def decode_blocks(blocks: np.ndarray, n: int, signed: bool = False
                  ) -> np.ndarray:
    """(count, 16, bands) u8 pixels (row-major in each block) of (count,
    block bytes) u8 blocks of format n; `signed` picks BC5S / BC6HS."""
    blocks = np.ascontiguousarray(blocks, np.uint8)
    if n == 1:
        return _bc1(blocks, False)
    if n == 2:
        col = _bc1(blocks[:, 8:], True)
        nib = np.stack([blocks[:, :8] & 15, blocks[:, :8] >> 4], 2)
        col[..., 3] = nib.reshape(-1, 16) * 17
        return col
    if n == 3:
        col = _bc1(blocks[:, 8:], True)
        col[..., 3] = _ramp(blocks[:, :8])
        return col
    if n == 4:
        return _ramp(blocks)[..., None]
    if n == 5:
        out = np.zeros((len(blocks), 16, 3), np.uint8)
        out[..., 2] = 128 if signed else 0
        out[..., 0] = _ramp(blocks[:, :8], signed)
        out[..., 1] = _ramp(blocks[:, 8:], signed)
        return out
    fn = _bc7 if n == 7 else (lambda b: _bc6(b, signed))
    out = np.stack([fn(bytes(b)) for b in blocks]) if len(blocks) else \
        np.zeros((0, 16, BLOCK[n][1]), np.int64)
    return out.astype(np.uint8)


def decode_plain(data: bytes, width: int, height: int, n: int,
                 signed: bool = False) -> tuple:
    """(image, complete) of Pillow's bcn decoder over `data`: the (height,
    width[, bands]) u8 image of its block rows (each (width + 3) // 4
    blocks, the blocks past the image's edge cropped), and whether the data
    held every block row; the rows of an incomplete block row stay 0."""
    size, bands = BLOCK[n]
    bw, bh = (width + 3) // 4, (height + 3) // 4
    rows = min(bh, len(data) // (size * bw)) if bw else bh
    blocks = np.frombuffer(data, np.uint8, rows * bw * size).reshape(-1, size)
    px = decode_blocks(blocks, n, signed).reshape(rows, bw, 4, 4, bands)
    img = np.zeros((bh * 4, bw * 4, bands), np.uint8)
    img[:rows * 4] = px.transpose(0, 2, 1, 3, 4).reshape(rows * 4, bw * 4,
                                                           bands)
    img = img[:height, :width]
    return (img[..., 0] if bands == 1 else img), rows == bh


def decode(data: bytes, width: int, height: int, n: int,
           signed: bool = False) -> np.ndarray:
    """The image Pillow's bcn decoder gives of `data` (C++,
    _native/bcndec.cpp); RasterError where the data ends before the last
    block row, as Pillow's load fails."""
    try:
        img, complete = _native.bcn_decode(data, width, height, n, signed,
                                           BLOCK[n][1])
    except RuntimeError as e:
        raise RasterError(str(e)) from e
    if not complete:
        raise RasterError(pixels.TRUNCATED)
    return img
