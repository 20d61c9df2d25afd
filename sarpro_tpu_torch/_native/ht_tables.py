"""Generator of `ht_tables.h`, the constant tables of the port's HTJ2K
(ITU-T T.814 / ISO/IEC 15444-15) block decoder in `j2kdec.cpp`: the two
VLC tables of the cleanup pass (the first quad row's and the later rows')
and the MEL coder's exponents.

Nothing here is typed by hand. Each table is found in the data of the
libopenjp2 shared library that Pillow's wheels ship (`pillow.libs/
libopenjp2-*.so*`, OpenJPEG 2.5.4, whose ht_dec.c decodes HT code-blocks)
by its shape and its first words, and read from there:

  * a VLC table is 1024 little-endian u16: 8 contexts of 128 entries, one
    for each 7-bit window of the VLC stream (its next bits, the first in
    the lowest). An entry holds the codeword's length (bits 0-2, 1-7),
    u_off (bit 3), rho (bits 4-7), e_1 (bits 8-11) and e_k (bits 12-15);
    a codeword of length L is decided by its L bits, so each context's
    entries repeat with period 1 << L;
  * the MEL exponents are 13 int32, {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5}.

The header is the source of truth; this script and
tests/test_torch_jpeg2000_ht.py::test_ht_tables_equal_libopenjp2 only
re-check it:

    python -m sarpro_tpu_torch._native.ht_tables [LIBOPENJP2.so] > \\
        sarpro_tpu_torch/_native/ht_tables.h
"""
from __future__ import annotations

import glob
import os
import sys

import numpy as np

HEADER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "ht_tables.h")
# the first words of each VLC table (T.814's tables, as ht_dec.c lays them)
VLC_FIRST = {
    "VLC_TBL0": (0x0023, 0x00A5, 0x0043, 0x0066, 0x0083, 0xA8EE, 0x0014,
                 0xD8DF),
    "VLC_TBL1": (0x0013, 0x0065, 0x0043, 0x00DE, 0x0083, 0x888D, 0x0023,
                 0x444E),
}
MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)


def default_library() -> str | None:
    """Pillow's libopenjp2, found beside the installed `PIL` package on
    sys.path (None where it is not installed)."""
    for entry in sys.path:
        hits = sorted(glob.glob(os.path.join(entry or ".", "pillow.libs",
                                             "libopenjp2-*.so*")))
        if hits:
            return hits[0]
    return None


def vlc_shape_ok(words: np.ndarray) -> bool:
    """1024 words of 8 contexts x 128 windows: every length 1-7 and every
    entry equal to that of its window cut to the codeword's length."""
    if words.shape != (1024,):
        return False
    lens = words & 7
    if lens.min() < 1:
        return False
    w = np.arange(1024)
    base = (w & ~127) | ((w & 127) & ((1 << lens) - 1))
    return bool(np.array_equal(words, words[base]))


def _find_all(blob: bytes, needle: bytes) -> list:
    out, at = [], blob.find(needle)
    while at >= 0:
        out.append(at)
        at = blob.find(needle, at + 1)
    return out


def extract(path: str) -> dict:
    """{name: table} of the library at `path`; ValueError where a table is
    not found exactly once."""
    blob = open(path, "rb").read()
    tables = {}
    for name, first in VLC_FIRST.items():
        hits = []
        for at in _find_all(blob, np.array(first, "<u2").tobytes()):
            if at % 2 or at + 2048 > len(blob):
                continue
            words = np.frombuffer(blob, "<u2", 1024, at)
            if vlc_shape_ok(words):
                hits.append(words.astype(np.uint16))
        if len(hits) != 1:
            raise ValueError(f"{name}: {len(hits)} runs of its shape")
        tables[name] = hits[0]
    hits = _find_all(blob, np.array(MEL_EXP, "<i4").tobytes())
    if len(hits) != 1:
        raise ValueError(f"MEL_EXP: {len(hits)} runs")
    tables["MEL_EXP"] = np.frombuffer(blob, "<i4", 13, hits[0]).astype(
        np.int32)
    return tables


def render(tables: dict) -> str:
    lines = [
        "// Generated by sarpro_tpu_torch/_native/ht_tables.py from the data "
        "of",
        "// libopenjp2 2.5.4 as Pillow 12.1 ships it. Do not edit.",
        "// A VLC entry: codeword length (bits 0-2), u_off (3), rho (4-7),",
        "// e_1 (8-11), e_k (12-15); index (context << 7) | next 7 bits.",
        "#pragma once",
        "#include <cstdint>",
        "",
    ]
    for name in VLC_FIRST:
        vals = [f"0x{int(v):04X}" for v in tables[name]]
        lines.append(f"static const uint16_t HT_{name}[1024] = {{")
        for i in range(0, 1024, 8):
            lines.append("    " + ", ".join(vals[i:i + 8]) + ",")
        lines.append("};")
        lines.append("")
    lines.append("static const int HT_MEL_EXP[13] = {"
                 + ", ".join(str(int(v)) for v in tables["MEL_EXP"]) + "};")
    return "\n".join(lines) + "\n"


def main(argv: list) -> int:
    path = argv[1] if len(argv) > 1 else default_library()
    if path is None:
        print("no libopenjp2 given and none found beside Pillow",
              file=sys.stderr)
        return 1
    sys.stdout.write(render(extract(path)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
