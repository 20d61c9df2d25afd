"""Generator of `av1_tables.h`, the constant tables of the port's AV1 decoder
(`av1dec.cpp`): the default CDFs an intra frame reads (palette blocks'
included), the 8-bit quantizer
lookups, the directional-prediction derivatives, the smooth weights, the
filter-intra taps, the intra edge kernels, the transforms' cos / sin
constants, and the in-loop filters' tables (the restoration CDFs, CDEF's
directions, taps and divisors, the self-guided filter's parameters and the
Wiener filter's reference taps), aom's quantizer matrices, dav1d's film
grain Gaussian sequence and its superres upscaling filter.

Nothing here is typed by hand. Each table is found in the read-only data of
the libavif shared library that Pillow's wheels ship (`pillow.libs/libavif-
*.so*`, which links aom 3.12.1 and dav1d 1.5.1 statically) by its known shape
and its first row, and read from there:

  * aom keeps a CDF of n symbols as its n - 1 values inverted (32768 - x),
    then 0 and a counter: `CDF_SIZE(n)` = n + 1 u16, padded to the row width
    of its array;
  * dav1d keeps the same values, then the counter, padded to its field's
    width (the tables aom's encoder build does not keep as such: skip,
    segment id, palette UV mode with intrabc, filter-intra mode, CfL sign).

CDEF's directions are aom's padded offsets into its filter buffer (y * 144 +
x, directions 6, 7, 0 ... 7, 0, 1), the self-guided parameters dav1d's
pairs of scales (a pass's radius is 0 where its scale is 0, else 2 and 1), and
the UV directions aom's 4:4:0 and 4:2:2 rows (identity on 4:2:0). The
ranges of the coded Wiener and self-guided coefficients are not tables
there (both libraries keep them as immediates): av1dec.cpp holds them as
the spec's constants.

The header is the source of truth; this script and
tests/test_torch_avif.py::test_av1_tables_equal_libavif only re-check it:

    python -m sarpro_tpu_torch._native.av1_tables [LIBAVIF.so] > \\
        sarpro_tpu_torch/_native/av1_tables.h

Each CDF row of the header holds the inverted values, the terminating 0 and
room for the decoder's adaptation counter (spec §8.2.6), padded to the
widest row of its table plus one."""
from __future__ import annotations

import dataclasses
import glob
import os
import sys

import numpy as np

HEADER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "av1_tables.h")
# the .rodata span of the 16.3.0 build that holds both libraries' tables,
# and the whole of its .rodata (aom's quantizer matrices lie before the span)
RODATA = (0x437000, 0x480000)
RODATA_ALL = (0x3D4000, 0x485720)


@dataclasses.dataclass
class Cdf:
    """A CDF table: `dims` rows (flattened in C order) of `nsym` symbols
    (one count for all rows, or one a row), `stride` u16 apart; anchored
    by the (non-inverted, spec) values of its first `len(first)` rows, or
    `at` u16 past another table's start. `dav1d`: the value run ends in
    the counter only (no terminating 0)."""

    name: str
    dims: tuple
    nsym: object
    stride: int
    first: tuple = ()
    dav1d: bool = False
    at: tuple = ()

    def counts(self) -> list:
        rows = int(np.prod(self.dims))
        return list(self.nsym) if isinstance(self.nsym, (list, tuple)) \
            else [self.nsym] * rows


@dataclasses.dataclass
class Const:
    """A constant array of `dtype`, `count` entries, anchored by its first
    values (which may run on past `count` into what follows it), searched
    for in `span` of the file and rendered `per_line` values a line."""

    name: str
    ctype: str
    dtype: str
    count: int
    first: tuple
    span: tuple = RODATA
    per_line: int = 12


Q4 = (4,)
CDFS = (
    Cdf("KF_Y_MODE", (5, 5), 13, 14, ((15588, 17027, 19338, 20218, 20682,
                                       21110, 21825, 23244, 24189, 28165,
                                       29093, 30466),)),
    Cdf("UV_MODE", (2, 13), [13] * 13 + [14] * 13, 15,
        ((22631, 24152, 25378, 25661, 25986, 26520, 27055, 27923, 28244,
          30059, 30941, 31961),)),
    Cdf("ANGLE_DELTA", (8,), 7, 8, ((2180, 5032, 7567, 22776, 26989,
                                     30217),)),
    Cdf("PARTITION", (20,), [4] * 4 + [10] * 12 + [8] * 4, 11,
        ((19132, 25510, 30392),)),
    Cdf("SKIP", (3,), 2, 2, ((31671,), (16515,), (4576,)), dav1d=True),
    Cdf("SEGMENT_ID", (3,), 8, 8, ((5622, 7893, 16093, 18233, 27809, 28373,
                                    32533),), dav1d=True),
    Cdf("DELTA_LF_MULTI", (4,), 4, 5, ((28160, 32120, 32677),) * 4),
    Cdf("PALETTE_Y_MODE", (7, 3), 2, 3, ((31676,), (3419,), (1261,))),
    Cdf("PALETTE_UV_MODE_INTRABC", (3,), 2, 2, ((32461,), (21488,),
                                                (30531,)), dav1d=True),
    Cdf("PALETTE_Y_SIZE", (7,), 7, 8, ((7952, 13000, 18149, 21478, 25527,
                                        29241),)),
    Cdf("PALETTE_UV_SIZE", (7,), 7, 8, ((8713, 19979, 27128, 29609, 31331,
                                         32272),)),
    Cdf("PALETTE_Y_COLOR", (7, 5), [n for n in range(2, 9) for _ in range(5)],
        9, ((28710,), (16384,), (10553,), (27036,), (31603,))),
    Cdf("PALETTE_UV_COLOR", (7, 5), [n for n in range(2, 9) for _ in range(5)],
        9, ((29089,), (16384,), (8713,), (29257,), (31610,))),
    Cdf("FILTER_INTRA", (22,), 2, 3, ((4621,), (6743,), (5893,))),
    Cdf("FILTER_INTRA_MODE", (1,), 5, 8, ((8949, 12776, 17211, 29558),),
        dav1d=True),
    Cdf("CFL_SIGN", (1,), 8, 8, ((1418, 2123, 13340, 18405, 26972, 28343,
                                  32294),), dav1d=True),
    Cdf("CFL_ALPHA", (6,), 16, 17, ((7637, 20719, 31401, 32481, 32657, 32688,
                                     32692, 32696, 32700, 32704, 32708,
                                     32712, 32716, 32720, 32724),)),
    Cdf("TX_SIZE", (4, 3), [2] * 3 + [3] * 9, 4, ((19968,), (19968,),
                                                   (24320,))),
    Cdf("INTRA_TX_SET1", (2, 13), 7, 17, ((1535, 8035, 9461, 12751, 23467,
                                           27825),)),
    Cdf("INTRA_TX_SET2", (3, 13), 5, 17, at=("INTRA_TX_SET1", 4 * 13 * 17)),
    Cdf("TXB_SKIP", Q4 + (5, 13), 2, 3, ((31849,), (5892,), (12112,))),
    Cdf("EOB_EXTRA", Q4 + (5, 2, 9), 2, 3, ((16961,), (17223,), (7621,))),
    Cdf("DC_SIGN", Q4 + (2, 3), 2, 3, ((16000,), (13056,), (18816,))),
    Cdf("EOB_PT_16", Q4 + (2, 2), 5, 6, ((840, 1039, 1980, 4895),)),
    Cdf("EOB_PT_32", Q4 + (2, 2), 6, 7, ((400, 520, 977, 2102, 6542),)),
    Cdf("EOB_PT_64", Q4 + (2, 2), 7, 8, ((329, 498, 1101, 1784, 3265,
                                          7758),)),
    Cdf("EOB_PT_128", Q4 + (2, 2), 8, 9, ((219, 482, 1140, 2091, 3680, 6028,
                                           12586),)),
    Cdf("EOB_PT_256", Q4 + (2, 2), 9, 10, ((310, 584, 1887, 3589, 6168, 8611,
                                            11352, 15652),)),
    Cdf("EOB_PT_512", Q4 + (2, 2), 10, 11, ((641, 983, 3707, 5430, 10234,
                                             14958, 18788, 23412, 26061),)),
    Cdf("EOB_PT_1024", Q4 + (2, 2), 11, 12, ((393, 421, 751, 1623, 3160, 6352,
                                              13345, 18047, 22571, 25830),)),
    Cdf("COEFF_BASE_EOB", Q4 + (5, 2, 4), 3, 4, ((17837, 29055),)),
    Cdf("COEFF_BASE", Q4 + (5, 2, 42), 4, 5, ((4034, 8930, 12727),)),
    Cdf("COEFF_BR", Q4 + (5, 2, 21), 4, 5, ((14298, 20718, 24174),)),
    # intra block copy: the split of an inter (here intrabc) block's
    # transforms, the inter transform type sets (aom's [set][square size]
    # rows: set 1 at 4x4 and 8x8, set 2 at 16x16, set 3 at every size),
    # and the MV joint and first component's CDFs (the spec's defaults of
    # both components; aom's nmv_component: sign, class0 and bits at 27, 36
    # and 39 u16 past its classes)
    Cdf("TXFM_SPLIT", (21,), 2, 3, ((28581,), (23846,), (20847,))),
    Cdf("INTER_TX_SET1", (2,), 16, 17, ((4458, 5560, 7695, 9709, 13330,
                                         14789, 17537, 20266, 21504, 22848,
                                         23934, 25474, 27727, 28915,
                                         30631),)),
    Cdf("INTER_TX_SET2", (1,), 12, 17, at=("INTER_TX_SET1", 6 * 17)),
    Cdf("INTER_TX_SET3", (4,), 2, 17, at=("INTER_TX_SET1", 8 * 17)),
    Cdf("MV_JOINT", (1,), 4, 5, ((4096, 11264, 19328),)),
    Cdf("MV_CLASS", (1,), 11, 12, ((28672, 30976, 31858, 32320, 32551,
                                    32656, 32740, 32757, 32762, 32767),)),
    Cdf("MV_SIGN", (1,), 2, 3, at=("MV_CLASS", 27)),
    Cdf("MV_CLASS0", (1,), 2, 3, at=("MV_CLASS", 36)),
    Cdf("MV_BITS", (10,), 2, 3, at=("MV_CLASS", 39)),
    Cdf("RESTORATION_TYPE", (1,), 3, 4, ((9413, 22581),), dav1d=True),
    Cdf("USE_WIENER", (1,), 2, 2, ((11570,),), dav1d=True),
    Cdf("USE_SGRPROJ", (1,), 2, 2, ((16855,),), dav1d=True),
)
CONSTS = (
    Const("DC_QLOOKUP", "int16_t", "<i2", 256, (4, 8, 8, 9, 10, 11, 12, 12,
                                                13, 14)),
    Const("AC_QLOOKUP", "int16_t", "<i2", 256, (4, 8, 9, 10, 11, 12, 13, 14,
                                                15, 16)),
    # Dc_Qlookup and Ac_Qlookup of 10- and 12-bit samples
    Const("DC_QLOOKUP_10", "int16_t", "<i2", 256, (4, 9, 10, 13, 15, 17, 20,
                                                   22, 25, 28)),
    Const("AC_QLOOKUP_10", "int16_t", "<i2", 256, (4, 9, 11, 13, 16, 18, 21,
                                                   24, 27, 30)),
    Const("DC_QLOOKUP_12", "int16_t", "<i2", 256, (4, 12, 18, 25, 33, 41, 50,
                                                   60, 70, 80)),
    Const("AC_QLOOKUP_12", "int16_t", "<i2", 256, (4, 13, 19, 27, 35, 44, 54,
                                                   64, 75, 87)),
    Const("DR_INTRA_DERIVATIVE", "uint16_t", "<u2", 90,
          (0, 0, 0, 1023, 0, 0, 547, 0, 0, 372)),
    # the weights of block sizes 4, 8, 16, 32 and 64, one after the other
    Const("SM_WEIGHTS", "uint8_t", "u1", 4 + 8 + 16 + 32 + 64,
          (255, 149, 85, 64, 255, 197, 146, 105)),
    # [mode][output pixel][tap], the eighth tap of each row unused
    Const("FILTER_INTRA_TAPS", "int8_t", "i1", 5 * 8 * 8,
          (-6, 10, 0, 0, 0, 12, 0, 0, -5, 2, 10, 0)),
    Const("INTRA_EDGE_KERNEL", "int32_t", "<i4", 3 * 5,
          (0, 4, 8, 4, 0, 0, 5, 6, 5, 0)),
    # cos(i * pi / 128) and the sinpi(k / 9) terms at 12 bits
    Const("COSPI", "int32_t", "<i4", 64, (4096, 4095, 4091, 4085, 4076)),
    Const("SINPI", "int32_t", "<i4", 5, (0, 1321, 2482, 3344, 3803)),
    # [direction 6, 7, 0 ... 7, 0, 1][tap]: y * 144 + x
    Const("CDEF_DIRECTIONS", "int32_t", "<i4", 24,
          (144, 288, 144, 287, -143, -286, 1, -142)),
    # aom keeps it, padded to 4, just before the directions
    Const("CDEF_SEC_TAPS", "int32_t", "<i4", 2, (2, 1, 0, 0, 144, 288, 144)),
    Const("CDEF_PRI_TAPS", "int32_t", "<i4", 4, (4, 2, 3, 3)),
    Const("CDEF_DIV_TABLE", "int32_t", "<i4", 9,
          (0, 840, 420, 280, 210, 168, 140, 120, 105)),
    # Cdef_Uv_Dir of 4:4:0, then of 4:2:2
    Const("CDEF_UV_DIR", "int32_t", "<i4", 16,
          (1, 2, 2, 2, 3, 4, 6, 0, 7, 0, 2, 4, 5, 6, 6, 6)),
    # Sgr_Params as [set][pass]: the scale s of the r = 2 and r = 1 box
    # passes (0 where the pass is not run)
    Const("SGR_PARAMS", "uint16_t", "<u2", 32, (140, 3236, 112, 2158, 93, 1618)),
    # the first three taps of the filter the Wiener references start from
    Const("WIENER_TAPS_MID", "int32_t", "<i4", 3,
          (3, -7, 15, 106, 15, -7, 3)),
    # Quantizer_Matrix as aom keeps it (iwt_matrix_ref): [level 0-14][luma,
    # chroma][3344], the matrices of 4x4, 8x8, 16x16, 32x32, 4x8, 8x4, 8x16,
    # 16x8, 16x32, 32x16, 4x16, 16x4, 8x32 and 32x8 one after the other,
    # each column by column (aom's transposed coefficient layout); its
    # forward weights follow it
    Const("QUANTIZER_MATRIX", "uint8_t", "u1", 15 * 2 * 3344,
          (32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150, 97, 110, 150,
           200), RODATA_ALL, 32),
    # the film grain's Gaussian_Sequence (dav1d's int16 copy)
    Const("GAUSSIAN_SEQUENCE", "int16_t", "<i2", 2048,
          (56, 568, -180, 172, 124, -84, 172, -64, -900, 24, 820, 224,
           1248)),
    # superres's Upscale_Filter [phase][tap] as dav1d keeps it (its
    # resize filter: the spec's taps negated)
    Const("RESIZE_FILTER", "int8_t", "i1", 64 * 8,
          (0, 0, 0, -128, 0, 0, 0, 0, 0, 0, 1, -128, -2, 1, 0, 0),
          per_line=8),
)


def default_library() -> str | None:
    """Pillow's libavif, found beside the installed `PIL` package on
    sys.path (None where it is not installed)."""
    for entry in sys.path:
        hits = sorted(glob.glob(os.path.join(entry or ".", "pillow.libs",
                                             "libavif-*.so*")))
        if hits:
            return hits[0]
    return None


def _row_ok(words: np.ndarray, n: int, stride: int, dav1d: bool) -> bool:
    vals = words[:n - 1].astype(np.int64)
    if not ((vals > 0).all() and (vals < 32768).all()
            and (np.diff(vals) <= 0).all()):
        return False
    rest = words[n - 1:stride]
    return bool((rest[:1 if dav1d else 2] == 0).all())


def _find_cdf(blob: bytes, t: Cdf, found: dict) -> int:
    lo, hi = RODATA
    counts = t.counts()
    if t.at:
        return found[t.at[0]] + 2 * t.at[1]
    pattern = []
    for k, row in enumerate(t.first):
        words = [32768 - v for v in row] + [0] * (t.stride - len(row))
        assert len(row) == counts[k] - 1, t.name
        pattern += words
    # the padding past the last anchored row may hold the next table
    tail = t.stride - len(t.first[-1]) - (1 if t.dav1d else 2)
    pat = np.array(pattern[:len(pattern) - tail], "<u2").tobytes()
    hits = []
    pos = blob.find(pat, lo, hi)
    while pos >= 0:
        words = np.frombuffer(blob, "<u2", len(counts) * t.stride, pos)
        if all(_row_ok(words[k * t.stride:], n, t.stride, t.dav1d)
               for k, n in enumerate(counts)):
            hits.append(pos)
        pos = blob.find(pat, pos + 2, hi)
    datas = {blob[p:p + 2 * t.stride * len(counts)] for p in hits}
    if len(datas) != 1:
        raise LookupError(f"{t.name}: {len(hits)} runs found")
    return hits[0]


def extract(path: str) -> dict:
    """{name: (kind, dims or count, list of rows / values)} read from the
    library at `path`; LookupError where a table is not found once."""
    with open(path, "rb") as f:
        blob = f.read()
    found, out = {}, {}
    for t in CDFS:
        pos = _find_cdf(blob, t, found)
        found[t.name] = pos
        counts = t.counts()
        words = np.frombuffer(blob, "<u2", len(counts) * t.stride, pos)
        rows = []
        for k, n in enumerate(counts):
            row = words[k * t.stride:k * t.stride + n - 1]
            if not _row_ok(words[k * t.stride:], n, t.stride, t.dav1d):
                raise LookupError(f"{t.name}: row {k} is not a CDF")
            rows.append([int(v) for v in row])
        out[t.name] = ("cdf", t.dims, rows)
    for c in CONSTS:
        lo, hi = c.span
        pat = np.array(c.first, c.dtype).tobytes()
        pos = blob.find(pat, lo, hi)
        if pos < 0:
            raise LookupError(f"{c.name}: not found")
        vals = np.frombuffer(blob, c.dtype, c.count, pos)
        out[c.name] = ("const", c.count, [int(v) for v in vals])
    return out


def _c_list(vals, width: int = 12) -> str:
    lines = []
    for k in range(0, len(vals), width):
        lines.append("    " + ", ".join(str(v) for v in vals[k:k + width]))
    return ",\n".join(lines)


def render(tables: dict) -> str:
    """The text of av1_tables.h."""
    out = ["// Generated by sarpro_tpu_torch/_native/av1_tables.py from the "
           "read-only data of",
           "// libavif 1.3.0 (aom 3.12.1, dav1d 1.5.1) as Pillow 12.1 ships "
           "it. Do not edit.",
           "// A CDF row: the n - 1 values of n symbols as 32768 - cdf, a 0, "
           "then the",
           "// adaptation counter, padded with zeros to the table's width.",
           "#pragma once", "#include <cstdint>", ""]
    for t in CDFS:
        _, dims, rows = tables[t.name]
        width = max(len(r) for r in rows) + 2
        flat = []
        for r in rows:
            flat += r + [0] * (width - len(r))
        shape = "".join(f"[{d}]" for d in dims)
        out.append(f"static const uint16_t AV1_{t.name}{shape}[{width}] = {{")
        out.append(_c_list(flat, width) + "};")
        out.append("")
    for c in CONSTS:
        _, count, vals = tables[c.name]
        out.append(f"static const {c.ctype} AV1_{c.name}[{count}] = {{")
        out.append(_c_list(vals, c.per_line) + "};")
        out.append("")
    return "\n".join(out)


def main(argv: list) -> int:
    path = argv[1] if len(argv) > 1 else default_library()
    if path is None:
        print("libavif not found: pass its path", file=sys.stderr)
        return 2
    sys.stdout.write(render(extract(path)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
