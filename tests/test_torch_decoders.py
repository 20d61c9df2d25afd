"""The port's raster decoders (io/jpeg, io/bmp, io/gif, io/netpbm; io/png in
tests/test_torch_readers.py) against the JAX package's RasterReader, which
opens the same files through Pillow 12.1, on the CPU: every band bit-equal
(the dtype included: bool for mode "1"), equal size, bands, geotransform,
EPSG and gdal_metadata(), and RasterError where the JAX reader raises it.

Inputs are written by Pillow from seeded numpy arrays, and, for what Pillow
does not write, byte by byte here: a baseline JPEG coder with any sampling
factors, scan split, restart interval, colour transform and component IDs;
BMPs with RLE8 / RLE4 streams, bit fields and top-down rows; GIFs with
local palettes, offsets and frames past the screen; netpbm files with
comments and every maxval."""
import dataclasses
import io
import logging
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu_torch.errors import RasterError  # noqa: E402
from sarpro_tpu_torch.io import pixels  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from test_torch_readers import WKT_32632, _readers_equal  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

RESAMPLE_TOL = dict(rtol=2e-6, atol=2e-2)  # tests/test_torch_kernels.py


def _equal_to_jax(path):
    """Bands, metadata and georeferencing equal to the JAX reader's, and
    the decoded arrays equal in dtype and value. Returns the port's
    array."""
    _readers_equal(path)
    t, j = traster.RasterReader(path), jraster.RasterReader(path)
    try:
        got, want = t._tiff._data, j._tiff._data
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
        assert t._tiff.gdal_metadata() == j._tiff.gdal_metadata()
        return got
    finally:
        t.close()
        j.close()


def _both_refuse(path, match=None):
    with pytest.raises(jraster.RasterError, match="unsupported raster"):
        jraster.RasterReader(path)
    with pytest.raises(RasterError, match=match) as ei:
        traster.RasterReader(path)
    assert str(ei.value).startswith("unsupported raster format")


def _scene(rng, shape):
    """SAR-like content: speckled gradients, so every DCT band is busy."""
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    g = (x * 5 + y * 3) % 256
    if len(shape) == 3:
        g = g[..., None] + 40 * np.arange(shape[2])
    noise = rng.gamma(4.0, 8.0, shape)
    return np.clip(0.6 * g + noise, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# JPEGs Pillow writes
# ---------------------------------------------------------------------------
SUBSAMPLING = ("4:4:4", "4:2:2", "4:2:0", "4:1:1")
CODINGS = {"baseline": {}, "optimized": {"optimize": True},
           "progressive": {"progressive": True, "optimize": True}}
JPEG_SIZES = ((13, 21), (37, 50))
JPEG_CASES = [("L", "4:4:4")] + [(m, s) for m in ("RGB", "CMYK")
                                 for s in SUBSAMPLING]


@pytest.mark.parametrize("quality", [60, 95])
@pytest.mark.parametrize("size", JPEG_SIZES, ids=["13x21", "37x50"])
@pytest.mark.parametrize("coding", list(CODINGS))
@pytest.mark.parametrize("mode,subsampling", JPEG_CASES)
def test_pillow_jpeg_equals_jax(tmp_path, rng, mode, subsampling, coding,
                                size, quality):
    bands = {"L": (), "RGB": (3,), "CMYK": (4,)}[mode]
    a = _scene(rng, size + bands)
    path = tmp_path / "scene.jpg"
    Image.fromarray(a, mode).save(path, quality=quality,
                                  subsampling=subsampling, **CODINGS[coding])
    path.with_suffix(".jgw").write_text(
        "10.0\n0.0\n0.0\n-10.0\n500005.0\n3999995.0\n")
    path.with_suffix(".prj").write_text(WKT_32632)
    got = _equal_to_jax(path)
    assert got.shape == size + ((bands or (1,))[0],)
    t = traster.RasterReader(path)
    assert t.metadata.epsg == 32632 and t.metadata.metadata == {}
    assert t.metadata.geotransform == [500000.0, 10.0, 0.0, 4000000.0, 0.0,
                                       -10.0]


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1},
                                     {"restart_marker_blocks": 5},
                                     {"restart_marker_rows": 1}],
                         ids=["every block", "5 blocks", "every row"])
@pytest.mark.parametrize("coding", list(CODINGS))
def test_pillow_jpeg_with_restarts_equals_jax(tmp_path, rng, restart,
                                              coding):
    path = tmp_path / "r.jpg"
    Image.fromarray(_scene(rng, (45, 61, 3))).save(
        path, quality=85, subsampling="4:2:0", **restart, **CODINGS[coding])
    assert b"\xff\xdd" in path.read_bytes()
    _equal_to_jax(path)


def test_progressive_jpeg_is_not_smoothed(tmp_path, rng):
    """A complete progressive file decodes to the pixels of the baseline
    file of the same coefficients: libjpeg smooths blocks only while bits
    are missing. Pillow writes both from one quantization, so their
    decodes (Pillow's and the port's) agree pixel for pixel."""
    a = _scene(rng, (64, 80))
    base, prog = tmp_path / "b.jpg", tmp_path / "p.jpg"
    Image.fromarray(a).save(base, quality=75)
    Image.fromarray(a).save(prog, quality=75, progressive=True)
    got_b, got_p = _equal_to_jax(base), _equal_to_jax(prog)
    assert np.array_equal(got_b, got_p)


def test_dc_only_progressive_jpeg_is_smoothed_as_jax(tmp_path, rng):
    """A progressive file cut after its first scan (an EOI put after the
    DC scan) leaves every AC bit missing: libjpeg-turbo interpolates the
    DC values (its block smoothing), and the port's decode is bit-equal to
    the JAX reader's."""
    buf = io.BytesIO()
    Image.fromarray(_scene(rng, (32, 40))).save(buf, format="JPEG",
                                                quality=80, progressive=True)
    blob = buf.getvalue()
    sos = [i for i in range(len(blob) - 1) if blob[i:i + 2] == b"\xff\xda"]
    path = tmp_path / "dc_only.jpg"
    path.write_bytes(blob[:sos[1]] + b"\xff\xd9")
    assert jraster.RasterReader(path).metadata.bands == 1
    got = _equal_to_jax(path)
    # smoothed: not flat 8 x 8 blocks, as the DC values alone would give
    assert (np.diff(got[:8, :8, 0].astype(int), axis=1) != 0).any()


@pytest.mark.parametrize("cut", [0.5, 0.9, -2])
@pytest.mark.parametrize("coding", ["baseline", "progressive"])
def test_cut_jpeg_is_refused_as_by_jax(tmp_path, rng, cut, coding):
    buf = io.BytesIO()
    Image.fromarray(_scene(rng, (40, 48, 3))).save(buf, format="JPEG",
                                                   quality=90,
                                                   **CODINGS[coding])
    blob = buf.getvalue()
    path = tmp_path / "cut.jpg"
    path.write_bytes(blob[:int(len(blob) * cut) if cut > 0 else cut])
    _both_refuse(path, "truncated")


# ---------------------------------------------------------------------------
# JPEGs coded here: sampling factors, scans, transforms Pillow does not
# write
# ---------------------------------------------------------------------------
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8)
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])
# one code length for every symbol: DC sizes 0..11 at 4 bits, the 162 AC
# symbols at 8 bits
DC_SYMS = list(range(12))
AC_SYMS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                          for s in range(1, 11)]


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v: int) -> tuple:
    s = abs(int(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(body) + 2) + body


# T.81 Table D.2 (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) and
# libjpeg's fixed 0.5 estimate at 113, for the arithmetic coder below
QE_TABLE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]


class _QM:
    """T.81 Annex D's arithmetic encoder with jcarith.c's registers and
    termination. A statistics bin is a (bytearray, index) pair holding the
    state index and the MPS in bit 7."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.a, self.c, self.ct = 0x10000, 0, 11
        self.buffer, self.sc, self.zc = -1, 0, 0

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _carry(self):  # output the buffer plus a carry
        if self.buffer >= 0:
            self._zeros()
            self._emit(self.buffer + 1)
            if self.buffer + 1 == 0xFF:
                self._emit(0)
        self.zc += self.sc
        self.sc = 0

    def _settle(self):  # output the buffer and stacked 0xFF bytes
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self._emit(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def encode(self, bins, i, val):
        sv = bins[i]
        qe, nlps, nmps, switch = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the LPS
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) ^ (nlps | switch << 7)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._settle()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def flush(self) -> bytes:
        """Terminates the segment (D.1.8) and returns its bytes."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._settle()
        if self.c & 0x7FFF800:
            self._zeros()
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if self.c & mask:
                    b = (self.c >> shift) & 0xFF
                    self._emit(b)
                    if b == 0xFF:
                        self._emit(0)
        out, self.out = bytes(self.out), bytearray()
        self.reset()
        return out


class _ArithCoder:
    """jcarith.c's sequential DCT and Annex F DC models over the QM coder,
    with DAC conditioning `L`, `U`, `K` (per table 0)."""

    def __init__(self, L=0, U=1, K=5):
        self.qm, self.L, self.U, self.K = _QM(), L, U, K
        self.restart()

    def restart(self):
        self.dc = bytearray(64)
        self.ac = bytearray(256)
        self.fixed = bytearray([113])
        self.ctx = {}

    def dc_diff(self, key, v):
        """One DC difference of component `key` (also a lossless sample's
        difference, coded the same way here)."""
        ctx = self.ctx.get(key, 0)
        qm, st = self.qm, ctx
        if v == 0:
            qm.encode(self.dc, st, 0)
            self.ctx[key] = 0
            return
        qm.encode(self.dc, st, 1)
        qm.encode(self.dc, st + 1, int(v < 0))
        new = 8 if v < 0 else 4
        st += 3 if v < 0 else 2
        v = abs(v) - 1
        m = 0
        if v:
            qm.encode(self.dc, st, 1)
            m, v2, st = 1, v, 20
            while v2 >> 1:
                v2 >>= 1
                qm.encode(self.dc, st, 1)
                m <<= 1
                st += 1
        qm.encode(self.dc, st, 0)
        if m < (1 << self.L) >> 1:
            new = 0
        elif m > (1 << self.U) >> 1:
            new += 8
        self.ctx[key] = new
        st += 14
        while m > 1:
            m >>= 1
            qm.encode(self.dc, st, 1 if m & v else 0)

    def ac_block(self, zz):
        qm, ac = self.qm, self.ac
        ke = max([k for k in range(1, 64) if zz[k]] or [0])
        k = 1
        while k <= ke:
            st = 3 * (k - 1)
            qm.encode(ac, st, 0)
            while zz[k] == 0:
                qm.encode(ac, st + 1, 0)
                st += 3
                k += 1
            qm.encode(ac, st + 1, 1)
            v = int(zz[k])
            qm.encode(self.fixed, 0, int(v < 0))
            v = abs(v) - 1
            st += 2
            m = 0
            if v:
                qm.encode(ac, st, 1)
                m, v2 = 1, v
                if v2 >> 1:
                    v2 >>= 1
                    qm.encode(ac, st, 1)
                    m <<= 1
                    st = 189 if k <= self.K else 217
                    while v2 >> 1:
                        v2 >>= 1
                        qm.encode(ac, st, 1)
                        m <<= 1
                        st += 1
            qm.encode(ac, st, 0)
            st += 14
            while m > 1:
                m >>= 1
                qm.encode(ac, st, 1 if m & v else 0)
            k += 1
        if k <= 63:
            qm.encode(ac, 3 * (k - 1), 1)


# one code length for the lossless difference categories 0..16: 5 bits
LOSSLESS_SYMS = list(range(17))


def _lossless_diffs(plane, psv, first_rows, pt):
    """jdlossls.c inverted: the differences of `plane` (undifferenced
    values, mod 2^16) under predictor `psv`, rows in `first_rows` coded as
    first rows (the left neighbour; 2^(7 - pt) for the first sample), the
    first sample of the other rows from above."""
    p = plane.astype(np.int64)
    pred = np.zeros_like(p)
    for y in range(p.shape[0]):
        if y in first_rows:
            pred[y, 0] = 1 << (7 - pt)
            pred[y, 1:] = p[y, :-1]
            continue
        ra, rb, rc = p[y, :-1], p[y - 1, 1:], p[y - 1, :-1]
        pred[y, 0] = p[y - 1, 0]
        pred[y, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                       5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                       7: (ra + rb) >> 1}[psv]
    d = (p - pred) & 0xFFFF
    return np.where(d > 32768, d - 65536, d)


def _coded_jpeg(planes, factors, *, quant=6, restart=0, scans=None,
                ids=None, app=b"", precision=8, sof=0xC0, arith=None,
                dac=b"", lossless=None):
    """A JPEG of `planes` (one array a component, each at its own sampled
    size) with sampling `factors` [(h, v), ...]: the scans `scans` (lists
    of component indices; default all in one), a restart interval (in
    MCUs), component `ids` and extra marker segments `app` (after SOI) and
    `dac` (before the first scan). DCT frames (`sof`, baseline by default)
    have one quant table of `quant` and Huffman tables of one code length;
    with `arith` ((L, U, Kx) of table 0, written in a DAC segment) the QM
    coder codes them instead (SOF9), as jcarith.c does. `lossless` ((psv,
    pt)) writes a lossless frame (SOF3; SOF11 with `arith`) of the planes'
    values (u8, or u16 taken mod 2^16 as the undifferenced samples), the
    first row of a scan and the top row of every iMCU row a restart falls
    in coded as first rows, as jddiffct.c undifferences them. In SOF11 the
    differences go through Annex F's DC model: a genuine QM-coded stream,
    which no decoder at hand reads (libjpeg refuses SOF11 before its
    data)."""
    n = len(planes)
    ids = ids or list(range(1, n + 1))
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    unit = 1 if lossless else 8
    height = max(-(-p.shape[0] * vmax // v)
                 for p, (_, v) in zip(planes, factors))
    width = max(-(-p.shape[1] * hmax // h)
                for p, (h, _) in zip(planes, factors))
    mcux, mcuy = -(-width // (unit * hmax)), -(-height // (unit * vmax))
    blocks = []
    if lossless is None:
        for p, (h, v) in zip(planes, factors):
            bh, bw = mcuy * v, mcux * h
            pad = np.pad(p.astype(np.float64), ((0, bh * 8 - p.shape[0]),
                                                (0, bw * 8 - p.shape[1])),
                         mode="edge") - 128
            tiles = pad.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
            c = _DCT @ tiles @ _DCT.T
            blocks.append(np.rint(c / quant).astype(int).reshape(bh, bw, 64)
                          [..., ZIGZAG])
    if lossless is not None:
        sof = 0xCB if arith is not None else 0xC3
    elif arith is not None:
        sof = 0xC9
    comps = b"".join(struct.pack(">BBB", ids[i], (h << 4) | v, 0)
                     for i, (h, v) in enumerate(factors))
    out = b"\xff\xd8" + app
    if lossless is None:
        out += _segment(0xDB, b"\x00" + bytes([quant] * 64))
    out += _segment(sof, struct.pack(">BHHB", precision, height, width, n)
                    + comps)
    if lossless is not None and arith is None:
        out += _segment(0xC4, b"\x00" + bytes(4) + bytes([17]) + bytes(11)
                        + bytes(LOSSLESS_SYMS))
    elif arith is None:
        dc_bits = bytes(16)[:3] + bytes([12]) + bytes(12)
        ac_bits = bytes(7) + bytes([162]) + bytes(8)
        out += _segment(0xC4, b"\x00" + dc_bits + bytes(DC_SYMS) + b"\x10"
                        + ac_bits + bytes(AC_SYMS))
    if arith is not None:
        L_, U_, K_ = arith
        out += _segment(0xCC, bytes([0x00, L_ | U_ << 4, 0x10, K_]))
    out += dac
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    for scan in scans or [list(range(n))]:
        spectral = (bytes([lossless[0], 0, lossless[1]]) if lossless
                    else b"\x00\x3f\x00")
        out += _segment(0xDA, bytes([len(scan)]) + b"".join(
            bytes([ids[i], 0]) for i in scan) + spectral)
        if len(scan) == 1:
            (h, v), ci = factors[scan[0]], scan[0]
            p = planes[ci]
            units = [[(ci, r, c)] for r in range(-(-p.shape[0] // unit))
                     for c in range(-(-p.shape[1] // unit))]
            per_row = -(-p.shape[1] // unit)
        else:
            units = [[(ci, my * factors[ci][1] + y, mx * factors[ci][0] + x)
                      for ci in scan for y in range(factors[ci][1])
                      for x in range(factors[ci][0])]
                     for my in range(mcuy) for mx in range(mcux)]
            per_row = mcux
        if lossless is not None:
            diffs = {}
            for ci in scan:
                v = factors[ci][1]
                firsts = {0}
                for k in range(restart, len(units), restart or len(units)):
                    row = k // per_row  # the MCU row the restart opens
                    # its iMCU row's top component row
                    firsts.add(row * v if len(scan) > 1 else row // v * v)
                diffs[ci] = _lossless_diffs(planes[ci], lossless[0], firsts,
                                            lossless[1])
        bits, pred, rst = _Bits(), [0] * n, 0
        coder = _ArithCoder(*arith) if arith is not None else None
        for k, unit_ in enumerate(units):
            if restart and k and k % restart == 0:
                if coder:
                    bits.out += coder.qm.flush()
                    coder.restart()
                else:
                    bits.flush()
                bits.out += bytes([0xFF, 0xD0 + rst])
                rst, pred = (rst + 1) & 7, [0] * n
            for ci, r, c in unit_:
                if lossless is not None:
                    d = diffs[ci]
                    v = int(d[r, c]) if r < d.shape[0] and c < d.shape[1] \
                        else 0
                    if coder:
                        coder.dc_diff(ci, v)
                        continue
                    s = 16 if v == 32768 else abs(v).bit_length()
                    bits.put(LOSSLESS_SYMS.index(s), 5)
                    if s < 16:
                        bits.put(v if v >= 0 else v + (1 << s) - 1, s)
                    continue
                zz = blocks[ci][r, c]
                if coder:
                    coder.dc_diff(ci, int(zz[0]) - pred[ci])
                    pred[ci] = int(zz[0])
                    coder.ac_block(zz)
                    continue
                s, v = _category(zz[0] - pred[ci])
                pred[ci] = zz[0]
                bits.put(DC_SYMS.index(s), 4)
                bits.put(v, s)
                run = 0
                last = max([i for i in range(1, 64) if zz[i]] or [0])
                for i in range(1, last + 1):
                    if zz[i] == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits.put(AC_SYMS.index(0xF0), 8)
                        run -= 16
                    s, v = _category(zz[i])
                    bits.put(AC_SYMS.index((run << 4) | s), 8)
                    bits.put(v, s)
                    run = 0
                if last < 63:
                    bits.put(AC_SYMS.index(0x00), 8)
        if coder:
            bits.out += coder.qm.flush()
        else:
            bits.flush()
        out += bytes(bits.out)
    return out + b"\xff\xd9"


def _planes(rng, width, height, factors):
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    return [_scene(rng, (-(-height * v // vmax), -(-width * h // hmax)))
            for h, v in factors]


ADOBE = {t: _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, t))
         for t in (0, 1, 2)}
JFIF = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
# (sampling factors, scans): sampling that Pillow does not write, with
# each upsampler of jdsample.c
SAMPLINGS = {
    "4:4:0 h1v2": ([(1, 2), (1, 1), (1, 1)], None),
    "4:2:2 vertical mix": ([(2, 2), (1, 2), (2, 1)], None),
    "h2v1 under h4": ([(4, 1), (2, 1), (1, 1)], None),
    "h3 integral": ([(3, 1), (1, 1), (1, 1)], None),
    "v3 h2 integral": ([(2, 3), (1, 1), (1, 1)], None),
    "chroma larger": ([(1, 1), (2, 2), (1, 1)], None),
    "4x4 non-interleaved": ([(4, 4), (2, 2), (1, 1)], [[0], [1], [2]]),
    "4x2 interleaved": ([(4, 2), (1, 1), (1, 1)], None),
    "gray 2x2 declared": ([(2, 2)], None),
    "one scan a component": ([(2, 2), (1, 1), (1, 1)], [[0], [1], [2]]),
    "two scans": ([(2, 1), (1, 1), (1, 1)], [[0], [1, 2]]),
}
CODED_SIZES = ((1, 1), (2, 3), (19, 9), (35, 29))


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("size", CODED_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(SAMPLINGS))
def test_coded_jpeg_sampling_equals_jax(tmp_path, rng, name, size, restart):
    factors, scans = SAMPLINGS[name]
    planes = _planes(rng, *size, factors)
    path = tmp_path / "s.jpg"
    path.write_bytes(_coded_jpeg(planes, factors, scans=scans,
                                 restart=restart, app=JFIF))
    _equal_to_jax(path)


# (components, marker segments, component IDs): the colour transforms
TRANSFORMS = {
    "ycc by ids": (3, b"", None),
    "rgb by ids": (3, b"", [82, 71, 66]),
    "jfif over rgb ids": (3, JFIF, [82, 71, 66]),
    "adobe rgb": (3, ADOBE[0], None),
    "adobe ycc": (3, ADOBE[1], None),
    "other ids": (3, b"", [5, 6, 7]),
    "cmyk": (4, b"", None),
    "adobe cmyk": (4, ADOBE[0], None),
    "adobe ycck": (4, ADOBE[2], None),
}


@pytest.mark.parametrize("subsampled", [False, True])
@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_coded_jpeg_colour_transform_equals_jax(tmp_path, rng, name,
                                                subsampled):
    n, app, ids = TRANSFORMS[name]
    factors = [(2, 2) if subsampled else (1, 1)] + [(1, 1)] * (n - 1)
    path = tmp_path / "c.jpg"
    path.write_bytes(_coded_jpeg(_planes(rng, 27, 22, factors), factors,
                                 ids=ids, app=app))
    _equal_to_jax(path)


@pytest.mark.parametrize("what", ["fractional sampling", "12-bit",
                                  "two components", "mcu over 10 blocks"])
def test_coded_jpeg_refused_as_by_jax(tmp_path, rng, what):
    factors = {"fractional sampling": [(3, 1), (2, 1), (1, 1)],
               "two components": [(1, 1), (1, 1)],
               "mcu over 10 blocks": [(4, 4), (1, 1), (1, 1)]}.get(
        what, [(1, 1)])
    path = tmp_path / "x.jpg"
    path.write_bytes(_coded_jpeg(_planes(rng, 20, 12, factors), factors,
                                 precision=12 if what == "12-bit" else 8))
    _both_refuse(path)


@pytest.mark.parametrize("sof,match", [(0xC9, "arithmetic"),
                                       (0xC3, "lossless")])
def test_arithmetic_and_lossless_jpeg_equal_jax(tmp_path, rng, sof, match):
    """An arithmetic-coded (SOF9, the QM coder here) and a lossless (SOF3)
    file, which libjpeg-turbo decodes and the JAX reader opens: the port
    decodes them bit-equal (tests/test_torch_jpeg_coding.py has the
    rest)."""
    path = tmp_path / "a.jpg"
    plane = _scene(rng, (8, 8))
    path.write_bytes(_coded_jpeg(
        [plane], [(1, 1)], arith=(0, 1, 5) if match == "arithmetic" else None,
        lossless=(1, 0) if match == "lossless" else None))
    assert path.read_bytes()[2:].find(bytes([0xFF, sof])) >= 0
    got = _equal_to_jax(path)
    if match == "lossless":
        assert np.array_equal(got[..., 0], plane)


def test_jpeg_without_sidecars_and_exif_equals_jax(tmp_path, rng):
    """The content decides, not the name; EXIF orientation is not
    applied."""
    path = tmp_path / "plain.img"
    exif = Image.Exif()
    exif[0x0112] = 6  # rotate 90
    Image.fromarray(_scene(rng, (16, 30, 3))).save(
        path, format="JPEG", exif=exif, comment=b"a comment")
    got = _equal_to_jax(path)
    assert got.shape == (16, 30, 3)
    t = traster.RasterReader(path)
    assert t.metadata.geotransform == [0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
    assert t.metadata.epsg is None and t.metadata.metadata == {}


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------
def _palette_image(rng, shape, colors):
    im = Image.fromarray(rng.integers(0, colors, shape).astype(np.uint8), "P")
    im.putpalette(list(rng.integers(0, 256, 3 * colors)))
    return im


@pytest.mark.parametrize("kind", ["1", "L", "P", "P16", "RGB", "RGBA"])
@pytest.mark.parametrize("shape", [(1, 1), (13, 21), (40, 37)])
def test_pillow_bmp_equals_jax(tmp_path, rng, kind, shape):
    if kind == "1":
        im = Image.fromarray(rng.random(shape) > 0.5)
    elif kind in ("L", "RGB", "RGBA"):
        bands = {"L": (), "RGB": (3,), "RGBA": (4,)}[kind]
        im = Image.fromarray(_scene(rng, shape + bands), kind)
    else:
        im = _palette_image(rng, shape, 16 if kind == "P16" else 200)
    path = tmp_path / "b.bmp"
    im.save(path)
    path.with_suffix(".bpw").write_text("2.0\n0.0\n0.0\n-2.0\n11.0\n49.0\n")
    path.with_suffix(".prj").write_text("EPSG:4326")
    _equal_to_jax(path)
    t = traster.RasterReader(path)
    assert t.metadata.epsg == 4326 and t.geo.is_geographic
    assert t.metadata.geotransform == [10.0, 2.0, 0.0, 50.0, 0.0, -2.0]


def _bmp(width, height, bits, data, *, palette=b"", compression=0,
         header=40, masks=(), colors=0, offset=None, top_down=False):
    """A BMP file: its header (12, 40, 108 or 124 bytes, `masks` after a
    40-byte header or in a larger one), the palette, the pixel data."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        h = (2 ** 32 - height) if top_down else height
        info = struct.pack("<IIIHHIIiiII", header, width, h, 1, bits,
                           compression, len(data), 2835, 2835, colors, 0)
        if header > 40:
            m = list(masks) + [0] * (4 - len(masks))
            info += struct.pack("<4I", *m) + bytes(header - 56)
        elif masks:
            info += struct.pack(f"<{len(masks)}I", *masks)
    head_len = 14 + len(info) + len(palette)
    off = head_len if offset is None else offset
    return (b"BM" + struct.pack("<IHHI", head_len + len(data), 0, 0, off)
            + info + palette + data)


def _rows(rows, stride):
    return b"".join(bytes(r) + bytes(stride - len(r)) for r in rows)


def _rle8(a):
    """RLE8 of a (rows, cols) index array, bottom-up: runs, absolute runs
    (odd lengths padded), end of line, a delta record and end of bitmap."""
    out = bytearray()
    for r in a[::-1]:
        r = list(r)
        i = 0
        while i < len(r):
            j = i
            while j < len(r) and r[j] == r[i] and j - i < 255:
                j += 1
            if j - i >= 3 or len(r) - i < 3:
                out += bytes([j - i, r[i]])
                i = j
            else:
                n = min(len(r) - i, 7)
                out += bytes([0, n]) + bytes(r[i:i + n])
                if n % 2:
                    out += b"\x00"
                i += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def _rle4(a):
    out = bytearray()
    for r in a[::-1]:
        r = list(r)
        i = 0
        while i < len(r):
            if i + 4 <= len(r) and i % 3 == 0:
                n = 4
                out += bytes([0, n, (r[i] << 4) | r[i + 1],
                              (r[i + 2] << 4) | r[i + 3]])
            else:
                n = min(len(r) - i, 2)
                hi, lo = r[i], r[i + 1] if n == 2 else 0
                out += bytes([n, (hi << 4) | lo])
            i += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def _bgrx(rng, colors, gray=False):
    if gray:
        return b"".join(bytes([i, i, i, 0]) for i in range(colors))
    return rng.integers(0, 256, (colors, 4)).astype(np.uint8).tobytes()


def _hand_bmp(rng, name):
    w, h = 11, 7
    if name == "rle8":
        a = rng.integers(0, 3, (h, w)).astype(np.uint8)
        a[2, :] = 1
        return _bmp(w, h, 8, _rle8(a), palette=_bgrx(rng, 256),
                    compression=1)
    if name == "rle8 gray":
        a = rng.integers(0, 256, (h, w)).astype(np.uint8)
        return _bmp(w, h, 8, _rle8(a), palette=_bgrx(rng, 256, True),
                    compression=1)
    if name == "rle8 delta":
        body = (b"\x03\x05\x00\x02\x09\x09\x01\x02\x02\x07\x00\x00"
                + b"\x0b\x01\x00\x00" * 6 + b"\x00\x01")
        return _bmp(w, h, 8, body, palette=_bgrx(rng, 16), colors=16,
                    compression=1)
    if name == "rle4":
        a = rng.integers(0, 16, (h, w)).astype(np.uint8)
        return _bmp(w, h, 4, _rle4(a), palette=_bgrx(rng, 16),
                    compression=2)
    if name == "rle4 odd absolute":
        body = b"".join(b"\x00\x05\x12\x34\x50\x00\x04\x67\x02\x89\x00\x00"
                        for _ in range(h)) + b"\x00\x01"
        return _bmp(w, h, 4, body, palette=_bgrx(rng, 16), compression=2)
    if name == "rle cut short":
        return _bmp(w, h, 8, b"\x05\x01\x00\x00\x00\x01",
                    palette=_bgrx(rng, 256), compression=1)
    if name == "16 bit 555":
        a = rng.integers(0, 1 << 15, (h, w)).astype("<u2")
        return _bmp(w, h, 16, _rows(a.view(np.uint8), 24))
    if name in ("bitfields 565", "bitfields 555"):
        m = ((0xF800, 0x7E0, 0x1F) if name.endswith("565")
             else (0x7C00, 0x3E0, 0x1F))
        a = rng.integers(0, 1 << 16, (h, w)).astype("<u2")
        return _bmp(w, h, 16, _rows(a.view(np.uint8), 24), compression=3,
                    masks=m)
    if name.startswith("bitfields 32"):
        m = {"bitfields 32 xbgr": (0xFF000000, 0xFF0000, 0xFF00, 0),
             "bitfields 32 rgba": (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
             "bitfields 32 bgar": (0xFF000000, 0xFF00, 0xFF, 0xFF0000)}[name]
        a = rng.integers(0, 256, (h, w * 4)).astype(np.uint8)
        return _bmp(w, h, 32, _rows(a, w * 4), compression=3, masks=m,
                    header=124)
    if name == "bitfields unsupported":
        a = rng.integers(0, 256, (h, w * 4)).astype(np.uint8)
        return _bmp(w, h, 32, _rows(a, w * 4), compression=3, header=108,
                    masks=(0xF00, 0xF0, 0xF, 0))
    if name == "24 bit top-down":
        a = rng.integers(0, 256, (h, w * 3)).astype(np.uint8)
        return _bmp(w, h, 24, _rows(a, 36), top_down=True)
    if name == "32 bit":
        a = rng.integers(0, 256, (h, w * 4)).astype(np.uint8)
        return _bmp(w, h, 32, _rows(a, w * 4))
    if name == "os2 8 bit":
        a = rng.integers(0, 256, (h, w)).astype(np.uint8)
        pal = rng.integers(0, 256, 256 * 3).astype(np.uint8).tobytes()
        return _bmp(w, h, 8, _rows(a, 12), palette=pal, header=12)
    if name == "1 bit colour":
        a = np.packbits(rng.integers(0, 2, (h, w)).astype(np.uint8), axis=1)
        return _bmp(w, h, 1, _rows(a, 4), palette=_bgrx(rng, 2))
    if name == "4 bit short palette":
        a = rng.integers(0, 256, (h, 6)).astype(np.uint8)
        return _bmp(w, h, 4, _rows(a, 8), palette=_bgrx(rng, 5), colors=5)
    if name == "4 bit gray palette":
        a = rng.integers(0, 256, (h, 6)).astype(np.uint8)
        return _bmp(w, h, 4, _rows(a, 8), palette=_bgrx(rng, 16, True))
    if name == "offset past the palette":
        a = rng.integers(0, 256, (h, w)).astype(np.uint8)
        # the header's offset points right after the header: Pillow adds
        # the palette's size
        return _bmp(w, h, 8, _rows(a, 12), palette=_bgrx(rng, 256),
                    offset=54)
    if name == "cut pixel data":
        a = rng.integers(0, 256, (h, w * 3)).astype(np.uint8)
        return _bmp(w, h, 24, _rows(a, 36))[:-40]
    if name == "2 bit":
        return _bmp(w, h, 2, bytes(28), palette=_bgrx(rng, 4))
    raise AssertionError(name)


HAND_BMP = ["rle8", "rle8 gray", "rle8 delta", "rle4", "rle4 odd absolute",
            "rle cut short", "16 bit 555", "bitfields 565", "bitfields 555",
            "bitfields 32 xbgr", "bitfields 32 rgba", "bitfields 32 bgar",
            "bitfields unsupported", "24 bit top-down", "32 bit",
            "os2 8 bit", "1 bit colour", "4 bit short palette",
            "4 bit gray palette", "offset past the palette",
            "cut pixel data", "2 bit"]


@pytest.mark.parametrize("name", HAND_BMP)
def test_hand_built_bmp_equals_jax(tmp_path, rng, name):
    path = tmp_path / "h.bmp"
    path.write_bytes(_hand_bmp(rng, name))
    try:
        jraster.RasterReader(path)
    except jraster.RasterError:
        _both_refuse(path)
        return
    _equal_to_jax(path)


def test_bmp_modes_are_pillows(tmp_path, rng):
    """The modes that decide the arrays: a black / white palette gives
    bool, a gray one u8 gray, a 4-bit gray ramp read as 8-bit rows."""
    path = tmp_path / "m.bmp"
    Image.fromarray(rng.random((9, 10)) > 0.5).save(path)
    assert _equal_to_jax(path).dtype == bool
    path.write_bytes(_hand_bmp(rng, "rle8 gray"))
    assert _equal_to_jax(path).shape == (7, 11, 1)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------
def _lzw(indices, min_bits: int) -> bytes:
    """GIF LZW of a flat index sequence, in sub-blocks, with a clear code
    first and whenever the table fills."""
    clear, end = 1 << min_bits, (1 << min_bits) + 1
    size = min_bits + 1
    table = {bytes([i]): i for i in range(clear)}
    nxt = end + 1
    out_bits = []

    def emit(c):
        out_bits.append((c, size))

    emit(clear)
    w = b""
    for k in bytes(indices):
        wk = w + bytes([k])
        if wk in table:
            w = wk
            continue
        emit(table[w])
        if nxt < 4096:
            table[wk] = nxt
            nxt += 1
            if nxt - 1 == (1 << size) and size < 12:
                size += 1
        else:
            emit(clear)
            table = {bytes([i]): i for i in range(clear)}
            nxt, size = end + 1, min_bits + 1
        w = bytes([k])
    if w:
        emit(table[w])
    emit(end)
    acc = nbits = 0
    data = bytearray()
    for c, s in out_bits:
        acc |= c << nbits
        nbits += s
        while nbits >= 8:
            data.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        data.append(acc)
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return bytes([min_bits]) + blocks + b"\x00"


def _gif(screen, frames, global_palette=None, background=0):
    """A GIF: `frames` of (x0, y0, index array, local palette or None,
    transparency or None, interlaced)."""
    sw, sh = screen
    flags = 0
    pal = b""
    if global_palette is not None:
        bits = max(1, (len(global_palette) // 3 - 1).bit_length())
        flags = 0x80 | (bits - 1)
        pal = global_palette + bytes(3 * (1 << bits) - len(global_palette))
    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, flags, background, 0)
    out += pal
    for x0, y0, a, local, transparency, interlace in frames:
        if transparency is not None:
            out += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 10,
                                                 transparency) + b"\x00"
        fl = 0x40 if interlace else 0
        lp = b""
        if local is not None:
            bits = max(1, (len(local) // 3 - 1).bit_length())
            fl |= 0x80 | (bits - 1)
            lp = local + bytes(3 * (1 << bits) - len(local))
        h, w = a.shape
        rows = a
        if interlace:
            order = (list(range(0, h, 8)) + list(range(4, h, 8))
                     + list(range(2, h, 4)) + list(range(1, h, 2)))
            rows = a[order]
        out += b"\x2c" + struct.pack("<HHHHB", x0, y0, w, h, fl) + lp
        out += _lzw(rows.reshape(-1), max(2, int(a.max()).bit_length()))
    return out + b"\x3b"


def _hand_gif(rng, name):
    a = rng.integers(0, 8, (13, 17)).astype(np.uint8)
    pal = rng.integers(0, 256, 24).astype(np.uint8).tobytes()
    gray = bytes(i for i in range(8) for _ in range(3))
    if name == "global palette":
        return _gif((17, 13), [(0, 0, a, None, None, False)], pal)
    if name == "local palette":
        return _gif((17, 13), [(0, 0, a, pal, None, False)], gray)
    if name == "no palette":
        return _gif((17, 13), [(0, 0, a, None, None, False)])
    if name == "identity gray palette":
        return _gif((17, 13), [(0, 0, a, None, None, False)], gray)
    if name == "offset inside the screen":
        return _gif((30, 20), [(5, 3, a, None, None, False)], pal)
    if name == "offset transparency":
        return _gif((30, 20), [(5, 3, a, None, 6, False)], pal)
    if name == "frame past the screen":
        return _gif((10, 8), [(4, 2, a, None, None, True)], pal)
    if name == "index past the palette":
        return _gif((17, 13), [(0, 0, a, pal[:9], None, False)])
    if name == "two frames":
        b = rng.integers(0, 8, (5, 6)).astype(np.uint8)
        return _gif((17, 13), [(0, 0, a, None, None, False),
                               (2, 2, b, None, 1, False)], pal)
    if name == "wide codes":
        big = rng.integers(0, 256, (70, 90)).astype(np.uint8)
        big[:20] = np.arange(90) % 4
        pal256 = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
        return _gif((90, 70), [(0, 0, big, None, None, False)], pal256)
    if name == "cut data":
        return _gif((17, 13), [(0, 0, a, None, None, False)], pal)[:-30]
    if name == "no image":
        return b"GIF89a" + struct.pack("<HHBBB", 4, 4, 0, 0, 0) + b"\x3b"
    raise AssertionError(name)


HAND_GIF = ["global palette", "local palette", "no palette",
            "identity gray palette", "offset inside the screen",
            "offset transparency", "frame past the screen",
            "index past the palette", "two frames", "wide codes",
            "cut data", "no image"]


@pytest.mark.parametrize("name", HAND_GIF)
def test_hand_built_gif_equals_jax(tmp_path, rng, name):
    path = tmp_path / "h.gif"
    path.write_bytes(_hand_gif(rng, name))
    try:
        jraster.RasterReader(path)
    except jraster.RasterError:
        _both_refuse(path)
        return
    _equal_to_jax(path)


@pytest.mark.parametrize("kind", ["gray", "colour", "interlaced",
                                  "transparency", "two frames"])
def test_pillow_gif_equals_jax(tmp_path, rng, kind):
    path = tmp_path / "p.gif"
    if kind == "gray":
        Image.fromarray(_scene(rng, (33, 47))).save(path)
    elif kind == "colour":
        Image.fromarray(_scene(rng, (33, 47, 3))).save(path)
    elif kind == "interlaced":
        Image.fromarray(_scene(rng, (40, 31))).save(path, interlace=True)
    elif kind == "transparency":
        _palette_image(rng, (21, 18), 64).save(path, transparency=5)
    else:
        a, b = (_palette_image(rng, (21, 18), 32) for _ in range(2))
        a.save(path, save_all=True, append_images=[b], duration=100,
               loop=0)
    path.with_suffix(".gfw").write_text("1.0\n0.0\n0.0\n-1.0\n0.5\n-0.5\n")
    _equal_to_jax(path)
    t = traster.RasterReader(path)
    assert t.metadata.geotransform == [0.0, 1.0, 0.0, 0.0, 0.0, -1.0]


# ---------------------------------------------------------------------------
# netpbm
# ---------------------------------------------------------------------------
def _netpbm(rng, magic: str, maxval: int, shape=(7, 9), comments=False):
    """A netpbm file of random values up to `maxval` (plain or raw by
    `magic`), with comments in its header (and plain data) if asked."""
    h, w = shape
    bands = 3 if magic in ("P3", "P6") else 1
    c = b"# made by the test\n" if comments else b""
    head = magic.encode() + b"\n" + c + f"{w} {h}".encode() + b"\n" + c
    if magic in ("P1", "P4"):
        a = rng.integers(0, 2, (h, w)).astype(np.uint8)
        if magic == "P4":
            return head + np.packbits(a, axis=1).tobytes()
        body = b"".join(bytes(str(v), "ascii") for v in a.reshape(-1))
        body = b"\n".join(body[i:i + 7] for i in range(0, len(body), 7))
        return head + (body[:5] + b"#x\n" + body[5:] if comments else body)
    head += str(maxval).encode() + b"\n"
    a = rng.integers(0, maxval + 1, (h, w, bands))
    a.reshape(-1)[:2] = (0, maxval)
    if magic in ("P2", "P3"):
        vals = [str(v).encode() for v in a.reshape(-1)]
        lines = [b" ".join(vals[i:i + 5]) for i in range(0, len(vals), 5)]
        if comments:
            lines.insert(1, b"# a comment in the data")
        return head + b"\n".join(lines) + b"\n"
    return head + a.astype(">u2" if maxval > 255 else np.uint8).tobytes()


NETPBM = ([("P1", 1), ("P4", 1)]
          + [(m, v) for m in ("P2", "P3", "P5", "P6")
             for v in (1, 15, 255, 4095, 65535)])


@pytest.mark.parametrize("comments", [False, True])
@pytest.mark.parametrize("magic,maxval", NETPBM)
def test_netpbm_equals_jax(tmp_path, rng, magic, maxval, comments):
    path = tmp_path / "n.pgm"
    path.write_bytes(_netpbm(rng, magic, maxval, comments=comments))
    got = _equal_to_jax(path)
    want = {"P1": bool, "P4": bool}.get(
        magic, np.uint16 if maxval > 255 and magic in ("P2", "P5")
        else np.uint8)
    assert got.dtype == want


@pytest.mark.parametrize("kind", ["ppm", "pgm", "pbm", "pgm 16"])
def test_pillow_netpbm_equals_jax(tmp_path, rng, kind):
    a = {"ppm": lambda: _scene(rng, (19, 23, 3)),
         "pgm": lambda: _scene(rng, (19, 23)),
         "pbm": lambda: rng.random((19, 23)) > 0.3,
         "pgm 16": lambda: rng.integers(0, 65536, (19, 23)).astype(
             np.uint16)}[kind]()
    path = tmp_path / "p.pnm"
    Image.fromarray(a).save(path, format="PPM")
    _equal_to_jax(path)


NETPBM_BROKEN = {
    "cut raw": lambda b: b[:-3],
    "cut rescaled": lambda b: b.replace(b"255", b"200", 1)[:-3],
    "value past maxval": lambda b: b.replace(b"P5", b"P2", 1)[:14]
                                   + b" 300 1 2",
    "plain bitonal junk": lambda b: b"P1\n2 2\n0 1 2 0\n",
    "maxval zero": lambda b: b"P5\n2 2\n0\n" + bytes(4),
    "token too long": lambda b: b"P5\n12345678901 2\n255\n" + bytes(4),
    "pfm": lambda b: b"Pf\n2 2\n-1.0\n" + bytes(16),
}


@pytest.mark.parametrize("name", list(NETPBM_BROKEN))
def test_broken_netpbm_is_refused_as_by_jax(tmp_path, rng, name):
    path = tmp_path / "b.pgm"
    path.write_bytes(NETPBM_BROKEN[name](_netpbm(rng, "P5", 255)))
    try:
        jraster.RasterReader(path)
    except jraster.RasterError:
        _both_refuse(path)
        return
    # Pillow opens the float format (PFM), and so does the port (io/netpbm)
    assert name == "pfm"
    got = _equal_to_jax(path)
    assert got.dtype == np.float32 and got.shape == (2, 2, 1)


# ---------------------------------------------------------------------------
# the decompression-bomb limit, WebP, and JPEG 2000 opened
# ---------------------------------------------------------------------------
def _bomb(fmt: str, width: int, height: int) -> bytes:
    """A file whose header claims width x height pixels and holds no
    pixel data."""
    if fmt == "bmp":
        return _bmp(width, height, 24, b"")
    if fmt == "png":
        from sarpro_tpu_torch.io import png

        def chunk(kind, data):
            import zlib
            return (struct.pack(">I", len(data)) + kind + data
                    + struct.pack(">I", zlib.crc32(kind + data)))
        return (png.SIGNATURE + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", width, height, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", b"") + chunk(b"IEND", b""))
    if fmt == "jpeg":
        return (b"\xff\xd8" + _segment(0xDB, b"\x00" + bytes([1] * 64))
                + _segment(0xC0, struct.pack(">BHHBBBB", 8, height, width, 1,
                                             1, 0x11, 0))
                + _segment(0xDA, b"\x01\x01\x00\x00\x3f\x00") + b"\xff\xd9")
    if fmt == "gif":
        return (b"GIF89a" + struct.pack("<HHBBB", width, height, 0, 0, 0)
                + b"\x2c" + struct.pack("<HHHHB", 0, 0, 1, 1, 0)
                + b"\x02\x00\x3b")
    if fmt == "pgm":
        return f"P5\n{width} {height}\n255\n".encode()
    raise AssertionError(fmt)


@pytest.mark.parametrize("fmt", ["bmp", "png", "jpeg", "gif", "pgm"])
def test_decompression_bomb_is_refused_as_by_jax(tmp_path, fmt):
    """179 MP claimed (over twice Pillow's MAX_IMAGE_PIXELS): both readers
    raise with Pillow's message, before reading any pixel."""
    w, h = (65535, 2731) if fmt == "gif" else (13380, 13380)
    assert w * h > 2 * pixels.MAX_IMAGE_PIXELS
    path = tmp_path / f"bomb.{fmt}"
    path.write_bytes(_bomb(fmt, w, h))
    with pytest.raises(jraster.RasterError) as je:
        jraster.RasterReader(path)
    with pytest.raises(RasterError) as te:
        traster.RasterReader(path)
    want = (f"Image size ({w * h} pixels) exceeds limit of 178956970 pixels, "
            "could be decompression bomb DOS attack.")
    assert want in str(je.value) and want in str(te.value)
    assert str(te.value) == str(je.value)


def test_decompression_bomb_warning_band(tmp_path, caplog):
    """Between the limit and twice it Pillow warns: the port logs the same
    words (both then fail on the missing pixel data)."""
    path = tmp_path / "big.bmp"
    path.write_bytes(_bomb("bmp", 10000, 10000))
    with caplog.at_level(logging.WARNING, logger="sarpro"):
        _both_refuse(path, "truncated")
    assert any("Image size (100000000 pixels) exceeds limit of 89478485 "
               "pixels" in r.getMessage() for r in caplog.records)


def test_pillow_limit_constant():
    assert pixels.MAX_IMAGE_PIXELS == Image.MAX_IMAGE_PIXELS


@pytest.mark.parametrize("fmt", ["WEBP", "JPEG2000", "J2K"])
def test_webp_and_jpeg2000_open_as_jax(tmp_path, rng, fmt):
    """Pillow opens them (the JAX reader gives the image); so does the port,
    to the JAX reader's image: WebP (io/webp.py;
    tests/test_torch_webp.py holds it in full) and JPEG 2000, JP2 and raw
    codestream (io/jpeg2000.py; tests/test_torch_jpeg2000.py)."""
    path = tmp_path / "x.img"
    buf = io.BytesIO()
    Image.fromarray(_scene(rng, (16, 16, 3))).save(
        buf, format="JPEG2000" if fmt == "J2K" else fmt,
        **({"no_jp2": True} if fmt == "J2K" else {}))
    path.write_bytes(buf.getvalue())
    assert jraster.RasterReader(path).metadata.bands == 3
    assert _equal_to_jax(path).shape == (16, 16, 3)


def test_unknown_content_is_refused(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(b"not an image at all")
    _both_refuse(path, "cannot identify")


# ---------------------------------------------------------------------------
# the decoded band onto the device (the CPU here): the decimated read and
# the gray product
# ---------------------------------------------------------------------------
def _decoded_files(tmp_path, rng):
    files = {}
    files["jpeg u8"] = tmp_path / "g.jpg"
    Image.fromarray(_scene(rng, (60, 90))).save(files["jpeg u8"], quality=92)
    files["pbm bool"] = tmp_path / "b.pbm"
    files["pbm bool"].write_bytes(_netpbm(rng, "P4", 1, (60, 90)))
    files["pgm u16"] = tmp_path / "w.pgm"
    files["pgm u16"].write_bytes(_netpbm(rng, "P5", 4095, (60, 90)))
    files["bmp rgb"] = tmp_path / "c.bmp"
    Image.fromarray(_scene(rng, (60, 90, 3))).save(files["bmp rgb"])
    return files


@pytest.mark.parametrize("alg", ["average", "cubic", "nearest"])
@pytest.mark.parametrize("kind", ["jpeg u8", "pbm bool", "pgm u16",
                                  "bmp rgb"])
def test_decimated_read_of_decoded_band_equals_jax(tmp_path, rng, kind, alg):
    """tests/test_io.py's read_band_resampled(1, 30, 20, ...) on a decoded
    band: the port's device route (the band uploaded as f32 or u16, the
    resample kernel's plain version here) against the JAX package's."""
    path = _decoded_files(tmp_path, rng)[kind]
    t, j = traster.RasterReader(path), jraster.RasterReader(path)
    try:
        before = dict(traster.ROUTES)
        got = traster.read_band_resampled_to_device(t, 1, 30, 20, "cpu", alg)
        want = j.read_band_resampled(1, 30, 20, alg)
    finally:
        t.close()
        j.close()
    assert traster.ROUTES["device_resample"] == before["device_resample"] + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (20, 30)
    np.testing.assert_allclose(got.numpy(), want, **RESAMPLE_TOL)


def test_decoded_band_to_gray_product(tmp_path, rng):
    """A decoded JPEG's band, read decimated to the device and written as a
    CLAHE gray JPEG by api.save_image, reads back through the port's own
    decoder at the size asked."""
    from sarpro_tpu_torch import _native, api
    from sarpro_tpu_torch.types import (
        AutoscaleStrategy,
        BitDepth,
        OutputFormat,
    )

    if not _native.available():
        pytest.skip("the native JPEG coder is not built here")
    path = _decoded_files(tmp_path, rng)["jpeg u8"]
    t = traster.RasterReader(path)
    band = traster.read_band_resampled_to_device(t, 1, 64, 48, "cpu",
                                                 "cubic")
    out = tmp_path / "gray.jpg"
    api.save_image(band + 1.0, out, OutputFormat.JPEG, BitDepth.U8,
                   autoscale=AutoscaleStrategy.CLAHE, device="cpu")
    back = traster.RasterReader(out)
    assert (back.metadata.size_x, back.metadata.size_y,
            back.metadata.bands) == (64, 48, 1)
    assert back._tiff._data.dtype == np.uint8
    ref = Image.open(out)
    assert np.array_equal(back._tiff._data[..., 0], np.asarray(ref))


def test_reader_fields_match_dataclass():
    """The comparisons above walk every field of the JAX metadata."""
    assert {f.name for f in dataclasses.fields(traster.RasterMetadata)} == {
        f.name for f in dataclasses.fields(jraster.RasterMetadata)}


# ---------------------------------------------------------------------------
# the port's own q100 coders, read back: the bounds chip_smoke.py's rasters
# phase holds the card's JPEGs to
# ---------------------------------------------------------------------------
# the largest |decode - coded| seen: 2 on the gray coder over 9 MP of the
# rasters phase's band (exponential x 60, clamped; 1 pixel in 9 M at 2), 4
# on the synRGB route over 2048^2 uniform bands (1838 pixels at 4)
GRAY_Q100_ROUNDTRIP = 2
SYNRGB_Q100_ROUNDTRIP = 4


@pytest.mark.parametrize("content", ["uniform", "sar"])
@pytest.mark.parametrize("route", ["gray pixels", "synrgb dct"])
def test_own_jpeg_round_trip(tmp_path, content, route):
    """The gray pixel coder and the synRGB DCT route (the fused program's
    coefficients, the entropy-only coder), on the rasters phase's kind of
    band: the port's decode equals Pillow's, and lies within the pinned
    bound of what was coded."""
    from sarpro_tpu_torch import _native
    from sarpro_tpu_torch.core import fused
    from sarpro_tpu_torch.io.writers import jpeg as wjpeg

    if not _native.available():
        pytest.skip("the native JPEG coder is not built here")
    g = torch.Generator().manual_seed(13)
    side = 600

    def band():
        if content == "uniform":
            return torch.randint(0, 256, (side, side), generator=g,
                                 dtype=torch.uint8)
        return (torch.empty(side, side).exponential_(generator=g).mul_(60.0)
                .clamp_(0, 255).to(torch.uint8))

    path = tmp_path / "own.jpg"
    if route == "gray pixels":
        want = band()
        wjpeg.write_gray_jpeg(path, side, side, want)
        want, bound = want.numpy()[..., None], GRAY_Q100_ROUNDTRIP
    else:
        b1, b2 = band(), band()
        clahe = fused.AutoscaleStrategy.CLAHE
        want = fused.synrgb_combine_stage(b1, b2, clahe, None, "rgb")
        dct = fused.synrgb_combine_stage(b1, b2, clahe, None, "dct")
        wjpeg.write_synrgb_jpeg_dct(path, side, side, dct)
        want = want.numpy().reshape(side, side, 3)
        bound = SYNRGB_Q100_ROUNDTRIP
    got = _equal_to_jax(path)
    err = np.abs(got.astype(np.int32) - want).max()
    assert err <= bound
    assert (chip_smoke.GRAY_Q100_ROUNDTRIP,
            chip_smoke.SYNRGB_Q100_ROUNDTRIP) == (GRAY_Q100_ROUNDTRIP,
                                                  SYNRGB_Q100_ROUNDTRIP)


def test_decoder_build_failure_raises_with_the_compilers_message(
        tmp_path, monkeypatch, rng):
    """No silent fallback: where the decoder library cannot be built, a JPEG,
    GIF, JPEG 2000 or WebP raises RasterError carrying g++'s message (PNG,
    BMP without RLE and netpbm need no library)."""
    from sarpro_tpu_torch import _native

    bad = tmp_path / "rasterdec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "RASTER_SOURCE", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_RASTER", None)
    monkeypatch.setattr(_native, "_RASTER_WHY", None)
    for fmt in ("JPEG", "GIF", "JPEG2000", "WEBP"):
        path = tmp_path / f"x.{fmt.lower()}"
        Image.fromarray(_scene(rng, (8, 8))).save(path, format=fmt)
        with pytest.raises(RasterError, match="could not be built") as ei:
            traster.RasterReader(path)
        assert "rasterdec.cpp" in str(ei.value)
    path = tmp_path / "x.pgm"
    path.write_bytes(_netpbm(rng, "P5", 255))
    _equal_to_jax(path)
