"""A test encoder of HTJ2K (ITU-T T.814 / ISO/IEC 15444-15) codestreams, in
numpy alone (no Pillow, so it runs wherever the tests run): what no
library on the test machines writes (OpenJPEG and OpenCV decode HT
code-blocks but encode none), for holding the port's HT block decoder
(sarpro_tpu_torch/_native/j2kdec.cpp) to Pillow 12.1's OpenJPEG 2.5.4.

  * the block coder: the HT cleanup pass (MagSgn, MEL and VLC, the VLC
    codewords found by inverting the decoder's tables in
    sarpro_tpu_torch/_native/ht_tables.h, U-VLC with the first row's
    pairing rule, each stream's bit stuffing, the Scup locator), and
    optionally the SigProp and MagRef passes of the plane below it (with
    or without VSC, the stripe-causal context);
  * the codestream: SOC, SIZ (Rsiz bit 14), CAP (Pcap bit 15, Ccap15),
    COD (code-block style 0x40), QCD, one tile-part a tile, EOC; the
    reversible 5/3 (integer lifting) or irreversible 9/7 (float, scalar
    expounded quantization) forward wavelet, the RCT / ICT over three
    components, any code-block size Part 1 allows, one layer, LRCP, one
    precinct a resolution; packet headers with their inclusion and
    zero-bit-plane tag trees, pass counts and Lblock.

OpenJPEG's HT decoder (ht_dec.c) codes the cleanup pass's magnitudes
above bit-plane p - 1, with p = Mb - Z (Z the block's zero-bit-plane tag
tree value), so a cleanup-only block coded down to plane 0 has Z = Mb - 1,
and one with refinement passes for plane 0 has Z = Mb - 2.

`encode(planes, ...)` returns the codestream; keyword arguments also make
what OpenJPEG refuses or warns on (`passes` beyond 3, placeholder passes
with no bytes, an RGN segment, style bits, a damaged Scup)."""
from __future__ import annotations

import re
import struct
from pathlib import Path

import numpy as np

HEADER = (Path(__file__).resolve().parents[1] / "sarpro_tpu_torch"
          / "_native" / "ht_tables.h")


# ---------------------------------------------------------------------------
# the VLC tables, inverted
# ---------------------------------------------------------------------------
def _tables() -> dict:
    text = HEADER.read_text()
    out = {}
    for name in ("VLC_TBL0", "VLC_TBL1"):
        body = re.search(r"HT_%s\[1024\] = \{([^}]*)\}" % name, text).group(1)
        out[name] = [int(v, 16) for v in re.findall(r"0x[0-9A-F]+", body)]
    return out


def _codewords(table: list) -> dict:
    """{(context, rho, u_off): [(length, cwd, e_k, e_1)]}, shortest first:
    each codeword of the decoder's table once."""
    words = {}
    for idx, e in enumerate(table):
        c, win = idx >> 7, idx & 127
        n = e & 7
        cwd = win & ((1 << n) - 1)
        key = (c, (e >> 4) & 0xF, (e >> 3) & 1)
        entry = (n, cwd, (e >> 12) & 0xF, (e >> 8) & 0xF)
        words.setdefault(key, set()).add(entry)
    return {k: sorted(v) for k, v in words.items()}


_TABLES = _tables()
CWD0 = _codewords(_TABLES["VLC_TBL0"])
CWD1 = _codewords(_TABLES["VLC_TBL1"])
MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)


# ---------------------------------------------------------------------------
# the bit streams (each the inverse of ht_dec.c's reader)
# ---------------------------------------------------------------------------
class _Fwd:
    """MagSgn / SigProp: bits from the LSB of each byte up, a byte after
    0xFF holding 7 (its top bit 0)."""

    def __init__(self):
        self.out, self.tmp, self.used, self.max = bytearray(), 0, 0, 8

    def put(self, v: int, n: int):
        for i in range(n):
            self.tmp |= ((v >> i) & 1) << self.used
            self.used += 1
            if self.used == self.max:
                self.out.append(self.tmp)
                self.max = 7 if self.tmp == 0xFF else 8
                self.tmp, self.used = 0, 0

    def magsgn_end(self) -> bytes:
        """OpenJPH's ms_terminate: the last byte filled with 1s and dropped
        where it is 0xFF (the reader pads with 0xFF)."""
        if self.used:
            self.tmp |= ((1 << (self.max - self.used)) - 1) << self.used
            if self.tmp != 0xFF:
                self.out.append(self.tmp)
        elif self.max == 7:
            self.out.pop()
        return bytes(self.out)

    def sigprop_end(self) -> bytes:
        if self.used:
            self.out.append(self.tmp)
        return bytes(self.out)


class _Rev:
    """VLC / MagRef, written from the end back: bits from the LSB of each
    byte up; after a byte above 0x8F, a byte whose low 7 bits are all 1
    has its top bit 0. The VLC's first byte keeps its low nibble for Scup."""

    def __init__(self, vlc: bool):
        self.out = bytearray()  # in reverse
        if vlc:
            self.tmp, self.used, self.gt = 0xF, 4, True
        else:
            self.tmp, self.used, self.gt = 0, 0, True

    def put(self, v: int, n: int):
        for i in range(n):
            self.tmp |= ((v >> i) & 1) << self.used
            self.used += 1
            if self.used == 8 - self.gt:
                if self.gt and self.tmp != 0x7F:
                    self.gt = False
                    continue
                self._emit()

    def _emit(self):
        self.out.append(self.tmp)
        self.gt = self.tmp > 0x8F
        self.tmp, self.used = 0, 0

    def magref_end(self) -> bytes:
        if self.used:
            self.out.append(self.tmp)
        return bytes(reversed(self.out))


class _Mel:
    """The MEL coder: runs of 0 events against 2^MEL_EXP[k], bits from
    the MSB of each byte down, a byte after 0xFF holding 7."""

    def __init__(self):
        self.out, self.tmp, self.rem = bytearray(), 0, 8
        self.run, self.k = 0, 0

    def _bit(self, b: int):
        self.tmp = (self.tmp << 1) | b
        self.rem -= 1
        if self.rem == 0:
            self.out.append(self.tmp)
            self.rem = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def event(self, one: bool):
        if not one:
            self.run += 1
            if self.run >= 1 << MEL_EXP[self.k]:
                self._bit(1)
                self.run = 0
                self.k = min(12, self.k + 1)
        else:
            self._bit(0)
            for t in range(MEL_EXP[self.k] - 1, -1, -1):
                self._bit((self.run >> t) & 1)
            self.run = 0
            self.k = max(0, self.k - 1)


def _terminate(mel: _Mel, vlc: _Rev) -> tuple:
    """OpenJPH's terminate_mel_vlc: (MEL bytes, VLC bytes in place), the
    last bytes of both fused into one where their bits allow."""
    if mel.run > 0:
        mel._bit(1)
    mel_tmp = (mel.tmp << mel.rem) & 0xFF
    mel_mask = (0xFF << mel.rem) & 0xFF
    vlc_mask = 0xFF >> (8 - vlc.used)
    mel_out, vlc_out = bytearray(mel.out), bytearray(vlc.out)
    if mel_mask | vlc_mask:
        fuse = mel_tmp | vlc.tmp
        if (((fuse ^ mel_tmp) & mel_mask) | ((fuse ^ vlc.tmp) & vlc_mask)) \
                == 0 and fuse != 0xFF and len(vlc.out) > 0:
            mel_out.append(fuse)
        else:
            mel_out.append(mel_tmp)
            vlc_out.append(vlc.tmp)
    # the VLC's last byte in place holds Scup's high bits
    return bytes(mel_out), bytes(reversed(vlc_out)) + b"\xff"


# ---------------------------------------------------------------------------
# the block coder
# ---------------------------------------------------------------------------
_UPFX = {1: (1, 1), 2: (2, 2)}  # u -> (codeword, length) of its prefix


def _u_prefix(u: int) -> tuple:
    if u in _UPFX:
        return _UPFX[u]
    return (4, 3) if u <= 4 else (0, 3)


def _u_suffix(u: int) -> tuple:
    if u <= 2:
        return 0, 0
    return (u - 3, 1) if u <= 4 else (u - 5, 5)


def _bitlen(v: int) -> int:
    return int(v).bit_length()


def _choose(words: dict, c: int, rho: int, u_off: int, uq: int,
            v: list) -> tuple:
    """The shortest codeword of (c, rho, u_off) whose e_k / e_1 fit the
    quad: an e_k sample's bit uq - 1 of v_n is its e_1 bit (and it keeps
    at least one bit of its own)."""
    for n, cwd, ek, e1 in words[(c, rho, u_off)]:
        ok = True
        for s in range(4):
            if (ek >> s) & 1:
                if uq < 2 or ((v[s] >> (uq - 1)) & 1) != ((e1 >> s) & 1):
                    ok = False
            elif (e1 >> s) & 1:
                ok = False
        if ok:
            return n, cwd, ek
    raise ValueError(f"no codeword for context {c}, rho {rho}, u_off {u_off}")


def cleanup(mu: np.ndarray, neg: np.ndarray) -> bytes:
    """The cleanup pass of magnitudes `mu` (h, w) and signs `neg`: MagSgn,
    MEL, VLC and the Scup locator, as one segment."""
    h, w = mu.shape
    mu = mu.astype(np.int64)
    ms, mel, vlc = _Fwd(), _Mel(), _Rev(vlc=True)
    pad = np.zeros((h + 2, w + 4), np.int64)
    pad[:h, :w] = mu
    negp = np.zeros((h + 2, w + 4), bool)
    negp[:h, :w] = neg
    # E and significance of the previous quad row's bottom samples, by
    # column (index + 1; 0 outside)
    e_above = np.zeros(w + 8, np.int64)
    for y in range(0, h, 2):
        first = y == 0
        words = CWD0 if first else CWD1
        e_row = np.zeros(w + 8, np.int64)
        c_w = 0  # the context the previous quad leaves
        for x in range(0, w, 4):
            quads = []
            for q in range(2):
                x0 = x + 2 * q
                exists = q == 0 or x0 < w
                ms_ = [pad[y, x0], pad[y + 1, x0], pad[y, x0 + 1],
                       pad[y + 1, x0 + 1]] if exists else [0, 0, 0, 0]
                sg = [negp[y, x0], negp[y + 1, x0], negp[y, x0 + 1],
                      negp[y + 1, x0 + 1]] if exists else [0] * 4
                rho = sum((1 << s) for s in range(4) if ms_[s] > 0)
                e = [_bitlen(2 * (m - 1) + 1) if m > 0 else 0 for m in ms_]
                v = [2 * (m - 1) + int(s) if m > 0 else 0
                     for m, s in zip(ms_, sg)]
                if first:
                    c = c_w
                    kappa = 1
                else:
                    sa = e_above > 0
                    c = c_w | int(sa[x0] or sa[x0 + 1]) \
                        | (int(sa[x0 + 2] or sa[x0 + 3]) << 2)
                    emax = int(max(e_above[x0:x0 + 4]))
                    kappa = max(1, emax - 1) if bin(rho).count("1") > 1 \
                        else 1
                uq = max(max(e), kappa)
                quads.append(dict(exists=exists, rho=rho, e=e, v=v, c=c,
                                  uq=uq, u=uq - kappa, x0=x0))
                if first:
                    c_w = (int(bool(rho & 3))) | ((rho >> 2) & 1) << 1 \
                        | ((rho >> 3) & 1) << 2
                else:
                    c_w = 2 if rho & 0xC else 0
                e_row[x0 + 1] = e[1]
                e_row[x0 + 2] = e[3]
            for qd in quads:
                if not qd["exists"]:
                    continue
                if qd["c"] == 0:
                    mel.event(qd["rho"] != 0)
                    if qd["rho"] == 0:
                        qd["ek"] = 0
                        continue
                n, cwd, ek = _choose(words, qd["c"], qd["rho"],
                                     int(qd["u"] > 0), qd["uq"], qd["v"])
                qd["ek"] = ek
                vlc.put(cwd, n)
            u0, u1 = quads[0]["u"], quads[1]["u"] if quads[1]["exists"] \
                else 0
            if first and u0 > 0 and u1 > 0:
                mel.event(min(u0, u1) > 2)
                if min(u0, u1) > 2:
                    vlc.put(*_u_prefix(u0 - 2))
                    vlc.put(*_u_prefix(u1 - 2))
                    vlc.put(*_u_suffix(u0 - 2))
                    vlc.put(*_u_suffix(u1 - 2))
                elif u0 > 2:
                    vlc.put(*_u_prefix(u0))
                    vlc.put(u1 - 1, 1)
                    vlc.put(*_u_suffix(u0))
                else:
                    vlc.put(*_u_prefix(u0))
                    vlc.put(*_u_prefix(u1))
                    vlc.put(*_u_suffix(u0))
                    vlc.put(*_u_suffix(u1))
            else:
                for u in (u0, u1):
                    if u > 0:
                        vlc.put(*_u_prefix(u))
                for u in (u0, u1):
                    if u > 0:
                        vlc.put(*_u_suffix(u))
            for qd in quads:
                if not qd["exists"]:
                    continue
                for s in range(4):
                    if (qd["rho"] >> s) & 1:
                        m = qd["uq"] - ((qd["ek"] >> s) & 1)
                        ms.put(qd["v"][s] & ((1 << m) - 1), m)
        e_above = e_row
    ms_bytes = ms.magsgn_end()
    mel_bytes, vlc_bytes = _terminate(mel, vlc)
    scup = len(mel_bytes) + len(vlc_bytes)
    if scup > 4079:
        raise ValueError(f"MEL and VLC of {scup} bytes (Scup is at most 4079)")
    out = bytearray(ms_bytes + mel_bytes + vlc_bytes)
    out[-1] = scup >> 4
    out[-2] = (out[-2] & 0xF0) | (scup & 0xF)
    return bytes(out)


def refinement(sig: np.ndarray, bits: np.ndarray, neg: np.ndarray,
               vsc: bool, magref: bool = True) -> bytes:
    """The SigProp (and MagRef) passes of the plane below the cleanup's:
    `sig` the cleanup's significance, `bits` each sample's bit of that
    plane; SigProp forward from the segment's start, MagRef back from its
    end."""
    h, w = sig.shape
    sp = _Fwd()
    state = np.zeros((h + 2, w + 2), bool)  # significant, by the scan so far
    state[1:-1, 1:-1] = sig
    for y0 in range(0, h, 4):
        rows = range(y0, min(y0 + 4, h))
        for g in range(0, w, 4):
            new = []
            for x in range(g, min(g + 4, w)):
                for y in rows:
                    if sig[y, x]:
                        continue
                    nb = state[y:y + 3, x:x + 3].copy()
                    if y == y0 + 3:  # the next stripe: cleanup's only
                        nb[2, :] = False
                        if not vsc and y + 1 < h:
                            nb[2, :] = np.concatenate(
                                ([False], sig[y + 1, :], [False]))[x:x + 3]
                    if not nb.any():
                        continue
                    b = int(bits[y, x])
                    sp.put(b, 1)
                    if b:
                        state[y + 1, x + 1] = True
                        new.append((y, x))
            for y, x in sorted(new, key=lambda t: (t[1], t[0])):
                sp.put(int(neg[y, x]), 1)
    out = sp.sigprop_end()
    if not magref:
        return out
    mr = _Rev(vlc=False)
    for y0 in range(0, h, 4):
        for x in range(w):
            for y in range(y0, min(y0 + 4, h)):
                if sig[y, x]:
                    mr.put(int(bits[y, x]), 1)
    return out + mr.magref_end()


def encode_block(mag: np.ndarray, neg: np.ndarray, mb: int, plane: int = 0,
                 vsc: bool = False, passes: int | None = None) -> tuple:
    """(Z, [(passes, bytes)]) of a code-block: its cleanup pass above
    `plane` (0: every plane), and where plane is 1 its SigProp and MagRef
    passes of plane 0 (`passes` 2 stops after SigProp). None where the
    block has nothing to code."""
    mag = mag.astype(np.int64)
    if int(mag.max(initial=0)) == 0:
        return None
    if int(mag.max()) >> mb:
        raise ValueError(f"a magnitude of more than Mb = {mb} bits")
    z = mb - 1 - plane
    mu = mag >> plane
    segs = [(1, cleanup(mu, neg))]
    if plane == 1:
        n = 3 if passes is None else passes
        segs.append((n - 1, refinement(mu > 0, mag & 1, neg, vsc,
                                       magref=n > 2)))
    elif plane:
        raise ValueError("plane is 0 or 1")
    return z, segs


# ---------------------------------------------------------------------------
# wavelets and component transforms
# ---------------------------------------------------------------------------
def _fdwt53_line(x: np.ndarray, i0: int) -> np.ndarray:
    """The forward 5/3 of samples at absolute positions i0.. (whole-sample
    symmetric extension), interleaved, int64."""
    n = len(x)
    y = x.astype(np.int64).copy()
    if n == 1:
        return y * 2 if i0 & 1 else y

    def at(i):  # symmetric index
        if i < 0:
            i = -i
        if i >= n:
            i = 2 * (n - 1) - i
        return i
    odd = [i for i in range(n) if (i0 + i) & 1]
    even = [i for i in range(n) if not (i0 + i) & 1]
    for i in odd:
        y[i] -= (y[at(i - 1)] + y[at(i + 1)]) >> 1
    for i in even:
        y[i] += (y[at(i - 1)] + y[at(i + 1)] + 2) >> 2
    return y


ALPHA, BETA, GAMMA, DELTA = (-1.586134342, -0.052980118, 0.882911075,
                             0.443506852)
K97 = 1.230174105


def _fdwt97_line(x: np.ndarray, i0: int) -> np.ndarray:
    n = len(x)
    y = x.astype(np.float64).copy()
    if n == 1:
        return y

    def at(i):
        if i < 0:
            i = -i
        if i >= n:
            i = 2 * (n - 1) - i
        return i
    odd = [i for i in range(n) if (i0 + i) & 1]
    even = [i for i in range(n) if not (i0 + i) & 1]
    for c, idx in ((ALPHA, odd), (BETA, even), (GAMMA, odd), (DELTA, even)):
        for i in idx:
            y[i] += c * (y[at(i - 1)] + y[at(i + 1)])
    y[even] /= K97
    y[odd] *= K97 / 2
    return y


def _split(y: np.ndarray, i0: int) -> np.ndarray:
    """Interleaved coefficients to low then high (the decoder's layout)."""
    idx = np.arange(len(y))
    low = ((i0 + idx) & 1) == 0
    return np.concatenate([y[low], y[~low]])


def forward_dwt(a: np.ndarray, x0: int, y0: int, levels: int,
                reversible: bool) -> np.ndarray:
    """The tile-component `a` (its origin x0, y0 on the grid) transformed
    `levels` times in place: each level's LL at the top left, its bands
    after it, as OpenJPEG's tile buffer holds them."""
    buf = a.astype(np.int64 if reversible else np.float64).copy()
    line = _fdwt53_line if reversible else _fdwt97_line
    x1, y1 = x0 + a.shape[1], y0 + a.shape[0]
    for lev in range(levels):
        rx0, ry0 = -(-x0 >> lev), -(-y0 >> lev)
        rx1, ry1 = -(-x1 >> lev), -(-y1 >> lev)
        rw, rh = rx1 - rx0, ry1 - ry0
        if rw == 0 or rh == 0:
            continue
        for x in range(rw):  # columns first: the decoder undoes rows first
            buf[:rh, x] = _split(line(buf[:rh, x], ry0), ry0)
        for y in range(rh):
            buf[y, :rw] = _split(line(buf[y, :rw], rx0), rx0)
    return buf


def rct(r, g, b):
    r, g, b = (np.asarray(v, np.int64) for v in (r, g, b))
    return (r + 2 * g + b) >> 2, b - g, r - g


def ict(r, g, b):
    r, g, b = (np.asarray(v, np.float64) for v in (r, g, b))
    return (0.299 * r + 0.587 * g + 0.114 * b,
            -0.16875 * r - 0.33126 * g + 0.5 * b,
            0.5 * r - 0.41869 * g - 0.08131 * b)


# ---------------------------------------------------------------------------
# tier-2
# ---------------------------------------------------------------------------
class BitWriter:
    """bio.c's writer: bits from the MSB down, a 0 stuffed after 0xFF."""

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


class TagTree:
    """tgt.c's tag tree over w x h leaves, encoding."""

    def __init__(self, w: int, h: int, values):
        self.parent, self.value = [], []
        lw, lh = [w], [h]
        while lw[-1] * lh[-1] > 1:
            lw.append((lw[-1] + 1) // 2)
            lh.append((lh[-1] + 1) // 2)
        base, total = [], 0
        for a, b in zip(lw, lh):
            base.append(total)
            total += a * b
        self.parent = [-1] * total
        self.value = [1 << 30] * total
        for lvl in range(len(lw) - 1):
            for y in range(lh[lvl]):
                for x in range(lw[lvl]):
                    self.parent[base[lvl] + y * lw[lvl] + x] = \
                        base[lvl + 1] + (y // 2) * lw[lvl + 1] + x // 2
        for i, v in enumerate(values):
            self.value[i] = v
        for i in range(total):  # children before parents
            p = self.parent[i]
            if p >= 0:
                self.value[p] = min(self.value[p], self.value[i])
        self.low = [0] * total
        self.known = [False] * total

    def encode(self, bw: BitWriter, leaf: int, threshold: int):
        path = [leaf]
        while self.parent[path[-1]] >= 0:
            path.append(self.parent[path[-1]])
        low = 0
        for node in reversed(path):
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bw.bit(1)
                        self.known[node] = True
                    break
                bw.bit(0)
                low += 1
            self.low[node] = low


def _numpasses(bw: BitWriter, n: int):
    """t2.c's opj_t2_putnumpasses."""
    if n == 1:
        bw.bit(0)
    elif n == 2:
        bw.bits(2, 2)
    elif n <= 5:
        bw.bits(0xC | (n - 3), 4)
    elif n <= 36:
        bw.bits(0x1E0 | (n - 6), 9)
    else:
        bw.bits(0xFF80 | (n - 37), 16)


def _floorlog2(v: int) -> int:
    return max(v, 1).bit_length() - 1


def packet(bands: list) -> bytes:
    """One layer's packet of a precinct: `bands` a list of (cw, ch,
    blocks) with blocks a list (raster order) of None or (Z, [(passes,
    bytes)])."""
    bw = BitWriter()
    body = bytearray()
    if not any(b is not None for _, _, blocks in bands for b in blocks):
        bw.bit(0)
        return bw.flush()
    bw.bit(1)
    for cw, ch, blocks in bands:
        if not blocks:
            continue
        incl = TagTree(cw, ch, [0 if b is not None else 1 for b in blocks])
        zbp = TagTree(cw, ch, [b[0] if b is not None else 0 for b in blocks])
        for k, b in enumerate(blocks):
            incl.encode(bw, k, 1)
            if b is None:
                continue
            z, segs = b
            zbp.encode(bw, k, z + 1)
            total = sum(n for n, _ in segs)
            _numpasses(bw, total)
            lenbits = 3
            for n, data in segs:
                need = len(data).bit_length() - _floorlog2(n)
                lenbits = max(lenbits, need)
            bw.bits((1 << (lenbits - 3 + 1)) - 2, lenbits - 3 + 1)
            for n, data in segs:
                bw.bits(len(data), lenbits + _floorlog2(n))
                body += data
    return bw.flush() + bytes(body)


# ---------------------------------------------------------------------------
# the codestream
# ---------------------------------------------------------------------------
def _ceil_div_pow2(a: int, e: int) -> int:
    return -(-a >> e)


def _band_geometry(tx0, ty0, tx1, ty1, levels):
    """[(r, orient, bx0, by0, bx1, by1, xoff, yoff)] of a tile-component,
    as tcd.c lays its bands."""
    out = []
    for r in range(levels + 1):
        lev = levels - r
        if r == 0:
            bx0, by0 = _ceil_div_pow2(tx0, lev), _ceil_div_pow2(ty0, lev)
            bx1, by1 = _ceil_div_pow2(tx1, lev), _ceil_div_pow2(ty1, lev)
            out.append((0, 0, bx0, by0, bx1, by1, 0, 0))
            continue
        pw = _ceil_div_pow2(tx1, lev + 1) - _ceil_div_pow2(tx0, lev + 1)
        ph = _ceil_div_pow2(ty1, lev + 1) - _ceil_div_pow2(ty0, lev + 1)
        for orient in (1, 2, 3):
            xob, yob = orient & 1, orient >> 1
            bx0 = _ceil_div_pow2(tx0 - (xob << lev), lev + 1)
            by0 = _ceil_div_pow2(ty0 - (yob << lev), lev + 1)
            bx1 = _ceil_div_pow2(tx1 - (xob << lev), lev + 1)
            by1 = _ceil_div_pow2(ty1 - (yob << lev), lev + 1)
            out.append((r, orient, bx0, by0, bx1, by1, pw if xob else 0,
                        ph if yob else 0))
    return out


def _gain(orient: int) -> int:
    return (0, 1, 1, 2)[orient]


def encode(planes, *, prec: int = 8, signed: bool = False,
           levels: int = 5, cblk: tuple = (64, 64),
           tile: tuple | None = None, irreversible: bool = False,
           mct: bool | None = None, refine: bool = False, vsc: bool = False,
           step: float = 1.0, guard: int = 2, passes: int | None = None,
           empty_refinement: bool = False, rgn: int = 0,
           style_bits: int = 0, scup: int | None = None) -> bytes:
    """The HTJ2K codestream of `planes` (a list of 2-D integer arrays of
    one size, one a component, values of `prec` bits): `levels` wavelet
    levels, code-blocks of `cblk` (w, h), tiles of `tile` (w, h; None: one
    tile), 5/3 or (irreversible) 9/7 with quantization steps `step` times
    two in the HH bands, the RCT / ICT over three components (`mct`, default
    on for three). `refine`: the cleanup codes above plane 1, SigProp
    and MagRef plane 0. Faults for the refusal tests: `passes` claimed a
    block (the extra ones empty), `empty_refinement` (passes 3 with no
    refinement bytes), an RGN shift `rgn`, extra style bits, a block's
    Scup replaced by `scup`."""
    planes = [np.asarray(p) for p in planes]
    h, w = planes[0].shape
    nc = len(planes)
    if mct is None:
        mct = nc == 3
    tw, th = tile if tile else (w, h)
    reversible = not irreversible
    cbw, cbh = (int(v).bit_length() - 1 for v in cblk)
    # DC level shift and the component transform
    comps = [p.astype(np.int64) - (0 if signed else 1 << (prec - 1))
             for p in planes]
    if mct:
        comps = list(rct(*comps) if reversible else ict(*comps))
    # quantization: the bands of one component, in QCD order
    nb = 3 * levels + 1
    orients = [0] + [o for _ in range(levels) for o in (1, 2, 3)]
    if reversible:
        expn = [prec + _gain(o) for o in orients]
        mant = [0] * nb
        sqcd = bytes([(guard << 5) | 0]) + bytes(e << 3 for e in expn)
    else:
        expn, mant = [], []
        for o in orients:
            d = step * (2.0 if o == 3 else 1.0)
            e = int(np.floor(np.log2(d)))
            m = int(round((d / 2.0 ** e - 1) * 2048))
            if m >= 2048:
                e, m = e + 1, 0
            expn.append(prec - e)
            mant.append(m)
        sqcd = bytes([(guard << 5) | 2]) + b"".join(
            struct.pack(">H", (e << 11) | m) for e, m in zip(expn, mant))
    mbs = [e + guard - 1 for e in expn]
    steps = [(1 + m / 2048) * 2.0 ** (prec - e) for e, m in zip(expn, mant)]
    style = 0x40 | (0x08 if vsc else 0) | style_bits
    # main header
    rsiz = 0x4000
    siz = struct.pack(">HIIIIIIIIH", rsiz, w, h, 0, 0, tw, th, 0, 0, nc)
    for _ in range(nc):
        siz += bytes([(prec - 1) | (0x80 if signed else 0), 1, 1])
    out = bytearray(b"\xff\x4f")
    out += struct.pack(">HH", 0xFF51, 2 + len(siz)) + siz
    out += struct.pack(">HHIH", 0xFF50, 8, 0x00020000, 0)
    cod = struct.pack(">BBHB", 0, 0, 1, 1 if mct else 0)
    cod += bytes([levels, cbw - 2, cbh - 2, style, 1 if reversible else 0])
    out += struct.pack(">HH", 0xFF52, 2 + len(cod)) + cod
    out += struct.pack(">HH", 0xFF5C, 2 + len(sqcd)) + sqcd
    if rgn:
        out += struct.pack(">HHBBB", 0xFF5E, 5, 0, 0, rgn)
    ntx, nty = -(-w // tw), -(-h // th)
    for t in range(ntx * nty):
        tx0, ty0 = (t % ntx) * tw, (t // ntx) * th
        tx1, ty1 = min(tx0 + tw, w), min(ty0 + th, h)
        # per component: its bands' blocks, in packet order (r, c)
        per = {}
        for c in range(nc):
            a = comps[c][ty0:ty1, tx0:tx1]
            coef = forward_dwt(a, tx0, ty0, levels, reversible)
            for r, orient, bx0, by0, bx1, by1, xo, yo in _band_geometry(
                    tx0, ty0, tx1, ty1, levels):
                bi = 0 if r == 0 else 3 * (r - 1) + orient
                band = coef[yo:yo + by1 - by0, xo:xo + bx1 - bx0]
                if not reversible:
                    band = np.sign(band) * np.floor(np.abs(band) / steps[bi])
                band = band.astype(np.int64)
                # code-blocks within the resolution's one precinct
                ecbw = min(cbw, 15 if r == 0 else 14)
                ecbh = min(cbh, 15 if r == 0 else 14)
                blocks, cw, ch = [], 0, 0
                if bx1 > bx0 and by1 > by0:
                    gx0, gy0 = (bx0 >> ecbw) << ecbw, (by0 >> ecbh) << ecbh
                    cw = (_ceil_div_pow2(bx1, ecbw) << ecbw) - gx0 >> ecbw
                    ch = (_ceil_div_pow2(by1, ecbh) << ecbh) - gy0 >> ecbh
                    for k in range(cw * ch):
                        x = gx0 + (k % cw << ecbw)
                        y = gy0 + (k // cw << ecbh)
                        cx0, cy0 = max(x, bx0), max(y, by0)
                        cx1 = min(x + (1 << ecbw), bx1)
                        cy1 = min(y + (1 << ecbh), by1)
                        blk = band[cy0 - by0:cy1 - by0, cx0 - bx0:cx1 - bx0]
                        b = encode_block(np.abs(blk), blk < 0, mbs[bi],
                                         1 if refine else 0, vsc)
                        if b is not None:
                            b = _fault(b, passes, empty_refinement, scup)
                        blocks.append(b)
                per.setdefault((r, c), []).append((cw, ch, blocks))
        data = bytearray()
        for r in range(levels + 1):
            for c in range(nc):
                data += packet(per[(r, c)])
        psot = 12 + 2 + len(data)
        out += struct.pack(">HHHIBB", 0xFF90, 10, t, psot, 0, 1)
        out += b"\xff\x93" + data
    out += b"\xff\xd9"
    return bytes(out)


def _fault(block, passes, empty_refinement, scup):
    z, segs = block
    if scup is not None:
        data = bytearray(segs[0][1])
        data[-1] = scup >> 4
        data[-2] = (data[-2] & 0xF0) | (scup & 0xF)
        segs = [(1, bytes(data))] + segs[1:]
    if empty_refinement:
        segs = [segs[0], (2, b"")]
    if passes is not None and passes > sum(n for n, _ in segs):
        extra = passes - segs[0][0]
        rest = segs[1][1] if len(segs) > 1 else b"\x00"
        segs = [segs[0], (extra, rest)]
    return z, segs
