"""The port's JPEG coder bindings (the coefficient entries and the pixel
entries) at every thread count, on the CPU.

The native coder splits the MCU rows into restart-marker bands, one a
thread. `sarpro_tpu_torch._native.coder_threads` picks the thread count so
that no band starts at or past the image's last MCU row (where the coder
would abort the process or end the stream in stray restart markers). The
encodes run in a child process, so that an abort fails a test instead of
taking its worker down; each stream is decoded with the test oracle and must
hold the 1-thread stream's coefficients."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from oracle import decode_baseline_jpeg_coeffs  # noqa: E402
from sarpro_tpu_torch import _native as t_native  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SIDES = (200, 800, 1300, 2048)
THREADS = range(1, 17)

# encodes argv[2] as a side x side image through one entry at 1..16 threads:
# 3 planes of coefficient blocks for the coefficient entries ("444", "gray"),
# 3 u8 planes for the pixel entries ("ycbcr444", "gray pixels"); at 2048 also
# through the library's entry with the requested count unchanged (what the
# bindings passed before coder_threads)
_CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from sarpro_tpu_torch import _native
data = np.load(sys.argv[2])
side, entry, out = int(sys.argv[3]), sys.argv[4], sys.argv[5]
planes = [np.ascontiguousarray(p) for p in data]
encode = {
    "444": lambda n: _native.jpeg_encode_coeffs444(
        *planes, side, side, n_threads=n),
    "gray": lambda n: _native.jpeg_encode_coeffs_gray(
        planes[0], side, side, n_threads=n),
    "ycbcr444": lambda n: _native.jpeg_encode_ycbcr444(*planes, n_threads=n),
    "gray pixels": lambda n: _native.jpeg_encode_gray(planes[0], n_threads=n),
}[entry]
blobs = {f"t{n}": encode(n) for n in range(1, 17)}
if side == 2048:
    lib = _native._load()
    i16p = _native.ctypes.POINTER(_native.ctypes.c_int16)
    ptrs = [p.ctypes.data_as(i16p) if p.dtype == np.int16
            else _native._u8p(p) for p in planes]
    cap = side * side * 3 * 5 + (1 << 16)
    raw = {
        "444": lambda buf, n: lib.jpeg_encode_coeffs444(
            *ptrs, side, side, _native._u8p(buf), cap, n),
        "gray": lambda buf, n: lib.jpeg_encode_coeffs_gray(
            ptrs[0], side, side, _native._u8p(buf), cap, n),
        "ycbcr444": lambda buf, n: lib.jpeg_encode_ycbcr444(
            *ptrs, side, side, _native._u8p(buf), cap, n),
        "gray pixels": lambda buf, n: lib.jpeg_encode_gray(
            ptrs[0], side, side, _native._u8p(buf), cap, n),
    }[entry]
    for n in range(1, 17):
        buf = np.empty(cap, np.uint8)
        blobs[f"raw{n}"] = buf[:raw(buf, n)].tobytes()
np.savez(out, **{k: np.frombuffer(v, np.uint8) for k, v in blobs.items()})
"""
PIXEL_ENTRIES = ("ycbcr444", "gray pixels")


@pytest.fixture(scope="module")
def codec():
    if not t_native.available():
        pytest.skip("g++ is not available to build the native codec")
    return t_native


def _split_starts_last(rows: int, threads: int) -> int:
    """The first MCU row of the last band the coder makes
    (native/jpegenc.cpp's encode_multi, below its DRI limit)."""
    bands = min(max(threads, 1), rows)
    return (bands - 1) * -(-rows // bands)


def test_coder_threads_leaves_no_band_past_the_image():
    for rows in range(1, 5001):
        for n in range(1, 65):
            t = t_native.coder_threads(8 * rows, n)
            assert 1 <= t <= n
            assert _split_starts_last(rows, t) < rows, (rows, n, t)
            if _split_starts_last(rows, n) < rows:  # a good split is kept
                assert min(t, rows) == min(n, rows), (rows, n, t)
    # the split the coder aborts on (800 and 1300 px on 16 threads)
    assert _split_starts_last(100, 16) >= 100
    assert _split_starts_last(163, 16) >= 163
    # 2048 px (256 MCU rows): every count up to 16 is kept
    assert [t_native.coder_threads(2048, n) for n in THREADS] == list(THREADS)
    assert t_native.coder_threads(2047, 16) == 16
    assert t_native.coder_threads(1, 16) == 1


def _blocks(side: int) -> np.ndarray:
    """3 planes of coefficient blocks: a DC of -3..3 in every block, one AC
    coefficient in every eighth (few bits a block, so the oracle is quick)."""
    rng = np.random.default_rng(side)
    nb = ((side + 7) // 8) ** 2
    blocks = np.zeros((3, nb, 8, 8), np.int16)
    blocks[:, :, 0, 0] = rng.integers(-3, 4, (3, nb))
    some = rng.random((3, nb)) < 0.125
    pos = rng.integers(1, 64, (3, nb))
    c, b = np.nonzero(some)
    blocks[c, b, pos[c, b] // 8, pos[c, b] % 8] = rng.integers(
        -20, 21, c.size)
    return blocks


def _pixels(side: int) -> np.ndarray:
    """3 u8 planes, each 8 x 8 block one value (a DC coefficient only, so
    the oracle is quick)."""
    nb = (side + 7) // 8
    vals = np.random.default_rng(side).integers(0, 256, (3, nb, nb))
    return np.repeat(np.repeat(vals, 8, 1), 8, 2)[:, :side, :side].astype(
        np.uint8)


@pytest.mark.parametrize("entry", ["444", "gray", *PIXEL_ENTRIES])
@pytest.mark.parametrize("side", SIDES)
def test_every_thread_count_holds_the_one_thread_coefficients(
        codec, tmp_path, side, entry):
    np.save(tmp_path / "blocks.npy",
            _pixels(side) if entry in PIXEL_ENTRIES else _blocks(side))
    out = tmp_path / "blobs.npz"
    res = subprocess.run(
        [sys.executable, "-c", _CHILD, str(REPO), str(tmp_path / "blocks.npy"),
         str(side), entry, str(out)], capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, f"encoder process failed: {res.stderr[-2000:]}"
    blobs = {k: v.tobytes() for k, v in np.load(out).items()}
    nb = ((side + 7) // 8) ** 2
    want, ncomp = decode_baseline_jpeg_coeffs(blobs["t1"], nb)
    assert ncomp == (3 if entry in ("444", "ycbcr444") else 1)
    decoded = {blobs["t1"]: want}
    for n in THREADS:
        blob = blobs[f"t{n}"]
        assert blob[:2] == b"\xff\xd8" and blob[-2:] == b"\xff\xd9"
        if blob not in decoded:
            decoded[blob] = decode_baseline_jpeg_coeffs(blob, nb)[0]
        assert decoded[blob] == want, f"{n} threads"
        if side == 2048:  # the bindings' streams are unchanged at 2048
            assert blob == blobs[f"raw{n}"], f"{n} threads"
