"""AV1 coefficients past the spec's ranges: the port's AV1 decoder
(_native/av1dec.cpp) refuses by name any block whose inverse transform
stores a value outside what AV1 §7.13.3 requires of a conformant stream
(8 + BitDepth signed bits in the row transforms, Max(BitDepth + 6, 16) in
the column ones, 8 + BitDepth + 12 in the ADST4's s and x arrays), on the
CPU against the JAX package's RasterReader (Pillow 12.1, libavif 1.3.0,
dav1d 1.5.1).

Why refuse rather than decode: on such data the JAX reader's own pixels
hang on the host's SIMD level. dav1d's C transforms and its AVX2 ones
give different pixels for the same non-conformant file (measured here
through `dav1d_set_cpu_flags_mask`, which Pillow's libavif exports), so
there is no one answer a port could match. Conformant data never reaches
the check: every committed fixture opens bit-equal to the JAX reader
(tests/test_torch_avif*.py), and a sweep of base_q_idx over 0-255 on
small files of each depth and layout either opens bit-equal, is refused
by both readers, or is refused by the port by name."""
import ctypes
import glob
import io
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
from sarpro_tpu_torch import _native  # noqa: E402
from sarpro_tpu_torch.errors import RasterError  # noqa: E402
from sarpro_tpu_torch.io import avif  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from test_torch_avif import AVIF_DIR, _outcome, _write  # noqa: E402

RANGES = "coefficients past the spec's ranges (non-conformant data)"
# sr_12_444.avif with file byte 292, bit 6 flipped: base_q_idx 160 -> 224
FLIP = ("sr_12_444.avif", 292, 6)
# dav1d's DAV1D_X86_CPU_FLAG_* bits: SSE2, SSSE3, SSE4.1, AVX2, AVX-512
C_ONLY, ALL = 0, 0xFFFFFFFF


def _flipped() -> bytes:
    name, pos, bit = FLIP
    b = bytearray((AVIF_DIR / name).read_bytes())
    b[pos] ^= 1 << bit
    return bytes(b)


def _with_q(blob: bytes, obus: bytes, q: int) -> bytes:
    """`blob` with base_q_idx of the frame in `obus` (its bytes within
    blob) set to q: the 8 bits at av1_frame_info's q_bit."""
    pos = blob.find(obus) * 8 + _native.av1_frame_info(obus)["q_bit"]
    b = bytearray(blob)
    for i in range(8):
        p = pos + i
        b[p >> 3] = (b[p >> 3] & ~(0x80 >> (p & 7))) | \
            (((q >> (7 - i)) & 1) << (7 - (p & 7)))
    return bytes(b)


def test_flipped_file_is_refused_by_name(tmp_path):
    """The flipped file: its base_q_idx reads 224, the port refuses it
    naming the coefficients past the spec's ranges; the JAX reader opens
    it (to pixels that depend on the host, below)."""
    blob = (AVIF_DIR / FLIP[0]).read_bytes()
    obus = avif.parse(blob).obus
    q_bit = blob.find(obus) * 8 + _native.av1_frame_info(obus)["q_bit"]
    assert q_bit >> 3 == FLIP[1] and blob[FLIP[1]] >> FLIP[2] & 1 == 0
    with pytest.raises(RasterError, match="spec's ranges"):
        avif.read(_flipped()).load()
    kind, why = _outcome(_write(tmp_path, _flipped()))
    assert kind == "not yet" and RANGES in why, why


@pytest.fixture
def dav1d_mask():
    """Set dav1d's CPU flags mask in Pillow's libavif (global to the
    process): yields the setter, restores every flag after."""
    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        Image.__file__)), "pillow.libs", "libavif-*.so*"))
    if not libs:
        pytest.skip("Pillow's libavif is not installed here")
    lib = ctypes.CDLL(libs[0])
    if not hasattr(lib, "dav1d_set_cpu_flags_mask"):
        pytest.skip("Pillow's libavif does not export dav1d's mask")
    lib.dav1d_set_cpu_flags_mask.argtypes = [ctypes.c_uint]
    try:
        yield lib.dav1d_set_cpu_flags_mask
    finally:
        lib.dav1d_set_cpu_flags_mask(ALL)


def _has_avx2() -> bool:
    try:
        return " avx2" in Path("/proc/cpuinfo").read_text()
    except OSError:
        return False


def _pillow(blob: bytes, set_mask, mask: int) -> np.ndarray:
    set_mask(mask)
    try:
        return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
    finally:
        set_mask(ALL)


def test_jax_reader_pixels_hang_on_the_simd_level(dav1d_mask):
    """The experiment behind the refusal: dav1d's C transforms (mask 0)
    and its SIMD ones (every flag; AVX2 and up on this host) decode the
    flipped file to different pixels, while they agree on the file as
    written. The count of samples that differ is printed."""
    if not _has_avx2():
        pytest.skip("the host has no AVX2: dav1d takes no SIMD transform "
                    "that differs from its C one")
    blob = (AVIF_DIR / FLIP[0]).read_bytes()
    assert np.array_equal(_pillow(blob, dav1d_mask, C_ONLY),
                          _pillow(blob, dav1d_mask, ALL))
    flipped = _flipped()
    c, simd = (_pillow(flipped, dav1d_mask, m) for m in (C_ONLY, ALL))
    differ = int((c != simd).sum())
    print(f"{FLIP[0]} flipped: dav1d C and SIMD differ in {differ} of "
          f"{c.size} samples")
    assert c.shape == simd.shape and differ > 0


SWEEP = ("sr_444.avif", "sr_12_444.avif", "sr_10_420.avif",
         "sr_12_420.avif", "hbd_10_444_full.avif", "hbd_12_420_full.avif",
         "sr_d12.avif")


@pytest.mark.parametrize("name", SWEEP)
def test_base_q_idx_sweep_opens_or_is_refused(tmp_path, name):
    """base_q_idx set to each of 0-255 in a small file (8, 10 and 12
    bits, 4:4:4 and 4:2:0): each case opens bit-equal to the JAX reader,
    is refused by both readers, or is refused by the port by name (past
    the spec's ranges, or tile data desynchronised from its trailing
    bits); no case opens to other pixels. The counts are printed."""
    blob = (AVIF_DIR / name).read_bytes()
    obus = avif.parse(blob).obus
    seen = {"open": 0, "refused": 0, "ranges": 0, "other by name": 0}
    for q in range(256):
        kind, why = _outcome(_write(tmp_path, _with_q(blob, obus, q),
                                    f"q{q}.avif"))
        if kind == "not yet":
            kind = "ranges" if RANGES in why else "other by name"
        seen[kind] += 1
    print(f"{name}: base_q_idx 0-255: {seen}")
    assert seen["open"] > 0, seen
    if name != "sr_d12.avif":  # its blocks stay in range at every q
        assert seen["ranges"] > 0, seen


def test_refusal_reaches_the_alpha_item(tmp_path):
    """The alpha image decodes through the same transforms: its base_q_idx
    raised until a block leaves the ranges, the port refuses the file by
    name; a case the ranges keep opens bit-equal or is refused as the JAX
    reader refuses it."""
    blob = (AVIF_DIR / "hbd_10_rgba_speckled.avif").read_bytes()
    alpha = avif.parse(blob).alpha
    kinds = set()
    for q in range(0, 256, 4):
        kind, why = _outcome(_write(tmp_path, _with_q(blob, alpha, q),
                                    f"a{q}.avif"))
        kinds.add("ranges" if kind == "not yet" and RANGES in why else kind)
    assert "ranges" in kinds, kinds


def test_refusal_reaches_grid_tiles(tmp_path):
    """A grid's tiles decode through the same transforms: a tile's
    base_q_idx raised refuses the grid file by name."""
    blob = (AVIF_DIR / "grid_12_444.avif").read_bytes()
    tile = avif.parse(blob).color.tiles[0]
    kinds = set()
    for q in range(160, 256, 8):
        kind, why = _outcome(_write(tmp_path, _with_q(blob, tile, q),
                                    f"g{q}.avif"))
        kinds.add("ranges" if kind == "not yet" and RANGES in why else kind)
    assert "ranges" in kinds, kinds
    with pytest.raises(RasterError):
        traster.RasterReader(_write(tmp_path, _with_q(blob, tile, 255),
                                    "g.avif"))


def test_refusal_names_the_data_for_every_depth():
    """The message is the same at 8, 10 and 12 bits (the ranges scale
    with BitDepth; the name does not)."""
    for name in ("sr_444.avif", "sr_10_420.avif", "sr_12_444.avif"):
        blob = (AVIF_DIR / name).read_bytes()
        obus = avif.parse(blob).obus
        msgs = set()
        for q in range(200, 256):
            try:
                avif.read(_with_q(blob, obus, q)).load()
            except RasterError as e:
                if "spec's ranges" in str(e):
                    msgs.add(str(e).split(": ", 1)[-1])
        assert msgs and all(RANGES in m for m in msgs), (name, msgs)
