"""The port's JPEG decoder (io/jpeg, _native/rasterdec.cpp) on the codings
libjpeg-turbo 3.1.3 decodes besides Huffman DCT, against the JAX package's
RasterReader, which opens them through Pillow 12.1: arithmetic-coded
sequential (SOF9) and progressive (SOF10) frames with DAC conditioning,
lossless frames (SOF3), and the block smoothing of progressive files whose
first coefficients are not all refined. Every case bit-equal, mode
included, or refused by both readers.

The files come from libjpeg-turbo's own encoder (tests/ljt_encode.py; this
module's in one child process), from Pillow (progressive SOF2), and from
test_torch_decoders._coded_jpeg's QM and lossless coders for what the
encoder does not write: odd sampling factors on SOF9, category-16
differences, DAC segments, SOF11."""
import hashlib
import io
import os
import pickle
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu_torch import _native  # noqa: E402
from sarpro_tpu_torch.io import jpeg  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import ljt_encode  # noqa: E402
from test_torch_decoders import (  # noqa: E402
    ADOBE,
    JFIF,
    SAMPLINGS,
    _both_refuse,
    _coded_jpeg,
    _equal_to_jax,
    _planes,
    _scene,
    _segment,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SPACE = {1: "gray", 3: "ycc", 4: "cmyk"}
SIZES = {"13x21": (13, 21), "37x50": (37, 50)}
SAMPLING = {"4:4:4": [(1, 1)] * 4, "4:2:0": [(2, 2), (1, 1), (1, 1), (2, 2)],
            "4:2:2": [(2, 1), (1, 1), (1, 1), (2, 1)]}
# DAC conditioning: (L, U) of DC tables 0 and 1, Kx of AC tables 0 and 1
DACS = {"default": None,
        "custom": {"L": [1, 2], "U": [4, 6], "K": [2, 40]}}


def _array(seed, shape):
    return _scene(np.random.default_rng(seed), shape)


def _arith_cases():
    cases = {}
    for coding in ("SOF9", "SOF10"):
        for nc, subs in ((1, ["4:4:4"]), (3, list(SAMPLING)),
                         (4, list(SAMPLING))):
            for sub in subs:
                for restart in (0, 3):
                    for dac in DACS:
                        for size in SIZES:
                            key = (f"{coding} {nc}c {sub} r{restart} "
                                   f"{dac} {size}")
                            a = _array(len(cases), SIZES[size]
                                       + ((nc,) if nc > 1 else ()))
                            cases[key] = (a, dict(
                                arith=True, progressive=coding == "SOF10",
                                restart=restart, dac=DACS[dac],
                                sampling=SAMPLING[sub][:nc], quality=85))
    return cases


ARITH = _arith_cases()
# DAC values at their edges, written by the encoder (libjpeg checks only
# L <= U: Kx 0 and past 63 are read as they are)
DAC_EDGES = {f"L{l_} U{u} K{k}": (l_, u, k) for l_, u, k in (
    (0, 0, 0), (0, 15, 1), (15, 15, 63), (5, 9, 64), (3, 3, 255),
    (0, 1, 5))}
# lossless: every predictor at every point transform, restarts on the odd
# ones, gray; each predictor in RGB with restarts every two rows
LOSSLESS = {f"gray psv{p} pt{t}": (
    _array(100 + 4 * p + t, (37, 50)),
    dict(lossless=(p, t), restart_rows=(p + t) % 2))
    for p in range(1, 8) for t in range(4)}
LOSSLESS.update({f"rgb psv{p}": (
    _array(200 + p, (29, 43, 3)),
    dict(lossless=(p, p % 3), space="rgb", restart_rows=2))
    for p in range(1, 8)})
# lossless colour: what the markers and component IDs make of three
# components (RGB where nothing says YCbCr: libjpeg converts no colour in a
# lossless frame, so YCbCr and YCCK are refused), and sub-sampled samples
# (replicated up, no triangle filter)
LOSSLESS_COLOUR = {
    "rgb ids, adobe 0": (3, dict(space="rgb"), True),
    "rgb ids, no marker": (3, dict(space="rgb", adobe=False), True),
    "ids 1 2 3, no marker": (3, dict(space="rgb", adobe=False,
                                     ids=[1, 2, 3]), True),
    "ids 5 6 7, no marker": (3, dict(space="rgb", adobe=False,
                                     ids=[5, 6, 7]), True),
    "jfif": (3, dict(space="ycc", sampling=[(1, 1)] * 3), False),
    "adobe 1": (3, dict(space="ycc", sampling=[(1, 1)] * 3, jfif=False,
                        adobe=True), False),
    "cmyk": (4, dict(space="cmyk"), True),
    "ycck": (4, dict(space="ycck", sampling=[(1, 1)] * 4), False),
    "rgb 4:2:0": (3, dict(space="rgb", sampling=[(2, 2), (1, 1), (1, 1)]),
                  True),
    "rgb 4:2:2 one scan each": (3, dict(
        space="rgb", sampling=[(2, 1), (1, 1), (1, 1)],
        scans=[([c], 3, 0, 0, 0) for c in range(3)]), True),
    "rgb h3, chroma larger": (3, dict(space="rgb",
                                      sampling=[(3, 1), (1, 1), (3, 2)]),
                              True),
}
# block smoothing: progressive files cut with an EOI after each scan but
# the last; the two sizes have 5 x 7 and 2 x 2 blocks of luma
SMOOTH_SIZES = {"37x50": (37, 50), "9x14": (9, 14)}
SMOOTH_MODES = {"L": (), "RGB 4:2:0": (3,), "CMYK": (4,)}


def _sof10_smooth_cases():
    return {f"SOF10 {mode} {size}": (
        _array(300 + 7 * i + j, SMOOTH_SIZES[size] + bands),
        dict(arith=True, progressive=True, quality=80))
        for i, (mode, bands) in enumerate(SMOOTH_MODES.items())
        for j, size in enumerate(SMOOTH_SIZES)}


SMOOTH10 = _sof10_smooth_cases()
# Pillow's 64 KiB read block: single-scan SOF9 noise of growing size, and a
# multi-scan file whose scans each lie inside a block
BLOCK_CASES = {180: True, 300: False, 420: False}


def _encoder_jobs():
    jobs = {f"arith {k}": v for k, v in ARITH.items()}
    for k, (l_, u, kx) in DAC_EDGES.items():
        jobs[f"dac {k}"] = (_array(400, (37, 50)), dict(
            arith=True, dac={"L": [l_], "U": [u], "K": [kx]}, quality=90))
    jobs.update({f"lossless {k}": v for k, v in LOSSLESS.items()})
    for k, (nc, kw, _) in LOSSLESS_COLOUR.items():
        jobs[f"colour {k}"] = (_array(500 + len(jobs), (23, 31, nc)),
                               dict(lossless=(6, 0), **kw))
    jobs.update({f"smooth {k}": v for k, v in SMOOTH10.items()})
    noise = np.random.default_rng(600)
    for side in BLOCK_CASES:
        jobs[f"block SOF9 {side}"] = (
            noise.integers(0, 256, (side, side + 7), dtype=np.uint8),
            dict(arith=True, quality=90))
    jobs["block SOF9 three scans"] = (
        noise.integers(0, 256, (60, 70, 3), dtype=np.uint8),
        dict(arith=True, quality=90, sampling=[(1, 1)] * 3,
             scans=[([c], 0, 63, 0, 0) for c in range(3)]))
    jobs["splice SOF9"] = (_array(707, (16, 640)),
                           dict(arith=True, restart_rows=1))
    jobs["cut SOF9"] = (_array(700, (40, 48, 3)), dict(arith=True))
    jobs["cut SOF10"] = (_array(701, (40, 48, 3)),
                         dict(arith=True, progressive=True))
    jobs["cut SOF3"] = (_array(702, (40, 48, 3)),
                        dict(lossless=(5, 0), space="rgb"))
    jobs["corrupt SOF9"] = (_array(703, (48, 64, 3)),
                            dict(arith=True, restart=1))
    jobs["corrupt SOF10"] = (_array(704, (48, 64, 3)),
                             dict(arith=True, progressive=True, restart=1))
    jobs["refused SOF3"] = (_array(705, (20, 24)), dict(lossless=(1, 0)))
    jobs["refused SOF10"] = (_array(706, (20, 24)),
                             dict(arith=True, progressive=True))
    return jobs


@pytest.fixture(scope="module")
def encoded():
    """Every encoder-written file of this module, from one child process:
    name -> bytes (or the EncodeError libjpeg raised)."""
    jobs = _encoder_jobs()
    return dict(zip(jobs, ljt_encode.encode_many(list(jobs.values()))))


def _write(tmp_path, blob, name="x.jpg"):
    path = tmp_path / name
    path.write_bytes(blob)
    return path


def _scans(blob):
    return [i for i in range(len(blob) - 1) if blob[i:i + 2] == b"\xff\xda"]


def _cuts(blob):
    """The file cut with an EOI after each scan but the last."""
    return [blob[:s] + b"\xff\xd9" for s in _scans(blob)[1:]]


# ---------------------------------------------------------------------------
# arithmetic coding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(ARITH))
def test_arithmetic_jpeg_equals_jax(tmp_path, encoded, case):
    blob = encoded[f"arith {case}"]
    marker = 0xCA if case.startswith("SOF10") else 0xC9
    assert bytes([0xFF, marker]) in blob and b"\xff\xcc" in blob
    assert (b"\xff\xdd" in blob) == (" r3 " in case)
    _equal_to_jax(_write(tmp_path, blob))


@pytest.mark.parametrize("case", list(DAC_EDGES))
def test_arithmetic_dac_edges_equal_jax(tmp_path, encoded, case):
    l_, u, k = DAC_EDGES[case]
    blob = encoded[f"dac {case}"]
    assert bytes([0x00, l_ | u << 4, 0x10, k]) in blob
    _equal_to_jax(_write(tmp_path, blob))


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("name", list(SAMPLINGS))
def test_coded_arithmetic_sampling_equals_jax(tmp_path, name, restart):
    """SOF9 from the QM coder in the tests, with the sampling factors and
    scan splits of test_torch_decoders (an MCU of up to ten blocks, one
    scan a component) and DAC conditioning of its own."""
    factors, scans = SAMPLINGS[name]
    planes = _planes(np.random.default_rng(800), 35, 29, factors)
    path = _write(tmp_path, _coded_jpeg(planes, factors, scans=scans,
                                        restart=restart, app=JFIF,
                                        arith=(1, 3, 9)))
    _equal_to_jax(path)


@pytest.mark.parametrize("side,opens", list(BLOCK_CASES.items()))
def test_arithmetic_past_pillows_read_block_refused_as_by_jax(
        tmp_path, encoded, side, opens):
    """Pillow hands libjpeg the file 64 KiB at a time and jdarith.c cannot
    wait for more: a single-scan SOF9 file whose coded data runs past the
    first block is refused ("broken data stream"), by the port too."""
    blob = encoded[f"block SOF9 {side}"]
    path = _write(tmp_path, blob)
    assert (len(blob) < 65536) == opens
    if opens:
        _equal_to_jax(path)
        return
    _both_refuse(path, "broken data stream")
    with Image.open(path) as im:
        assert im.mode == "L" and im.size == (side + 7, side)


@pytest.mark.parametrize("gap,opens", [(0, True), (-200, False)],
                         ids=["next block", "straddling"])
def test_multi_scan_arithmetic_past_a_block_as_jax(tmp_path, encoded, gap,
                                                    opens):
    """Between scans libjpeg reads markers, and there it waits for Pillow's
    next block: a SOF9 file of one scan a component, a COM segment padding
    its second scan to the next 64 KiB block, opens in both readers; padded
    to 200 bytes short of it, so that the scan's coded data straddles the
    block's end, both refuse it."""
    blob = encoded["block SOF9 three scans"]
    second = _scans(blob)[1]
    pad = 65536 + gap - second - 4
    com = b"\xff\xfe" + struct.pack(">H", pad + 2) + bytes(pad)
    blob = blob[:second] + com + blob[second:]
    assert len(blob) > 65536 and len(_scans(blob)) == 3
    path = _write(tmp_path, blob)
    if opens:
        _equal_to_jax(path)
    else:
        _both_refuse(path, "broken data stream")


@pytest.mark.parametrize("k", range(6))
@pytest.mark.parametrize("coding", ["SOF9", "SOF10"])
def test_corrupt_arithmetic_data_equals_libjpeg(tmp_path, encoded, coding, k):
    """A byte changed inside one restart interval: jdarith.c's "bad
    arithmetic code" leaves the rest of that interval at zero and the next
    restart starts over. The garbage coefficients before it go through the
    16-bit lanes of libjpeg-turbo's SIMD IDCT, as in the JAX reader."""
    blob = bytearray(encoded[f"corrupt {coding}"])
    rst = [i for i in range(len(blob) - 1)
           if blob[i] == 0xFF and 0xD0 <= blob[i + 1] <= 0xD7]
    rng = np.random.default_rng(900 + k)
    at = rst[(5 * k) % len(rst)] + 2 + int(rng.integers(1, 6))
    blob[at] ^= int(rng.integers(1, 128))
    _equal_to_jax(_write(tmp_path, bytes(blob)))


# coefficient blocks with which jidctint.c and the SIMD IDCT part: values
# whose dequantised products, sums or pass outputs leave 16 bits
GARBAGE = {
    "ac of every size": lambda rng: np.where(
        rng.random((16, 64)) < 0.4,
        (rng.integers(0, 1 << 15, (16, 64)) >> rng.integers(0, 16, (16, 64)))
        * rng.choice([-1, 1], (16, 64)), 0),
    "row 0 only": lambda rng: np.pad(rng.integers(-3000, 3000, (16, 8)),
                                     ((0, 0), (0, 56))),
    "mid values": lambda rng: np.where(rng.random((16, 64)) < 0.3,
                                       rng.integers(-300, 300, (16, 64)), 0),
    "sparse 11 bits": lambda rng: np.where(
        rng.random((16, 64)) < 0.1, rng.integers(-2047, 2048, (16, 64)), 0),
    "big dc, one ac": lambda rng: np.concatenate(
        [rng.integers(-16000, 16000, (16, 1)),
         np.eye(63, dtype=int)[rng.integers(0, 63, 16)]
         * rng.integers(-5, 5, (16, 1))], 1),
}
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
    43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63])


def _coefficient_jpeg(blocks, quant) -> bytes:
    """A baseline gray JPEG, one row of 8 x 8 blocks, of the coefficients
    `blocks` ((n, 64) in natural order, DC within 16 bits) under the 16-bit
    quant table `quant` (natural order): DC categories 0-15 in 5-bit codes,
    every (run, size) of the AC table in 8-bit codes."""
    ac_syms = [0x00, 0xF0] + [r << 4 | z for r in range(16)
                              for z in range(1, 16)]
    code = {v: i for i, v in enumerate(ac_syms)}
    bits = []

    def put(v, n):
        bits.extend((v >> i) & 1 for i in range(n - 1, -1, -1))

    def value(v):
        z = int(abs(v)).bit_length()
        return z, (v if v >= 0 else v - 1 + (1 << z))

    pred = 0
    for blk in np.asarray(blocks, np.int64):
        zz = blk[ZIGZAG]
        z, v = value(int(zz[0]) - pred)
        pred = int(zz[0])
        put(z, 5)
        put(v, z)
        last = max([k for k in range(1, 64) if zz[k]] or [0])
        run = 0
        for k in range(1, last + 1):
            if zz[k] == 0:
                run += 1
                continue
            while run >= 16:
                put(code[0xF0], 8)
                run -= 16
            z, v = value(int(zz[k]))
            put(code[run << 4 | z], 8)
            put(v, z)
            run = 0
        if last < 63:
            put(code[0x00], 8)
    bits += [1] * (-len(bits) % 8)
    data = bytes(int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8)).replace(b"\xff", b"\xff\x00")
    n = len(blocks)
    dqt = b"\x10" + struct.pack(">64H", *np.asarray(quant)[ZIGZAG])
    sof = struct.pack(">BHHB", 8, 8, 8 * n, 1) + b"\x01\x11\x00"
    dht = (b"\x00" + bytes([0, 0, 0, 0, 16] + [0] * 11) + bytes(range(16))
           + b"\x10" + bytes([0] * 7 + [len(ac_syms)] + [0] * 8)
           + bytes(ac_syms))
    return (b"\xff\xd8" + _segment(0xDB, dqt) + _segment(0xC0, sof)
            + _segment(0xC4, dht) + _segment(0xDA, b"\x01\x01\x00\x00\x3f\x00")
            + data + b"\xff\xd9")


@pytest.mark.parametrize("wide_quant", [False, True],
                         ids=["8-bit quant", "16-bit quant"])
@pytest.mark.parametrize("case", list(GARBAGE))
def test_idct_of_garbage_coefficients_equals_jax(tmp_path, case,
                                                 wide_quant):
    """Coefficients that corrupt data can leave, in a Huffman file: the
    port runs libjpeg-turbo's SIMD IDCT arithmetic (16-bit lanes that wrap
    and saturate, pass 1's zero-rows shortcut), as Pillow does on x86-64,
    and is bit-equal to the JAX reader; libjpeg-turbo's C IDCT gives other
    pixels for these blocks."""
    rng = np.random.default_rng(1200 + 2 * list(GARBAGE).index(case)
                                + wide_quant)
    blocks = GARBAGE[case](rng)
    blocks[:, 0] = np.clip(blocks[:, 0], -16000, 16000)
    quant = rng.integers(1, 65536 if wide_quant else 256, 64)
    blob = _coefficient_jpeg(blocks, quant)
    got = _equal_to_jax(_write(tmp_path, blob))
    (mode, c_idct), = _pillow_without_simd([blob])
    assert mode == "L" and not np.array_equal(got[..., 0], c_idct)


def _pillow_without_simd(blobs):
    """Pillow's decode of each file in a child process whose libjpeg-turbo
    runs without SIMD (its C IDCT): (mode, array) or (None, message)."""
    code = ("import io, pickle, sys, numpy as np\n"
            "from PIL import Image\n"
            "out = []\n"
            "for b in pickle.loads(sys.stdin.buffer.read()):\n"
            "    try:\n"
            "        im = Image.open(io.BytesIO(b)); im.load()\n"
            "        out.append((im.mode, np.asarray(im)))\n"
            "    except Exception as e:\n"
            "        out.append((None, str(e)))\n"
            "sys.stdout.buffer.write(pickle.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          input=pickle.dumps(blobs), capture_output=True,
                          check=True,
                          env=dict(os.environ, JSIMD_FORCENONE="1"))
    return pickle.loads(proc.stdout)


# ---------------------------------------------------------------------------
# lossless
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(LOSSLESS))
def test_lossless_jpeg_equals_jax(tmp_path, encoded, case):
    blob = encoded[f"lossless {case}"]
    assert b"\xff\xc3" in blob
    _equal_to_jax(_write(tmp_path, blob))


@pytest.mark.parametrize("case", list(LOSSLESS_COLOUR))
def test_lossless_colour_and_sampling_as_jax(tmp_path, encoded, case):
    _, _, opens = LOSSLESS_COLOUR[case]
    path = _write(tmp_path, encoded[f"colour {case}"])
    if opens:
        _equal_to_jax(path)
    else:
        _both_refuse(path, "color conversion")


@pytest.mark.parametrize("lossless", [True, False])
def test_unknown_component_ids_guess_as_jax(tmp_path, lossless):
    """Three components with IDs 1 2 3 and no marker: libjpeg guesses YCbCr
    in a DCT frame and RGB in a lossless one; so do the port's colour
    rules."""
    factors = [(1, 1)] * 3
    planes = _planes(np.random.default_rng(810), 21, 17, factors)
    path = _write(tmp_path, _coded_jpeg(
        planes, factors, lossless=(1, 0) if lossless else None))
    got = _equal_to_jax(path)
    if lossless:
        assert np.array_equal(got, np.dstack(planes))


@pytest.mark.parametrize("restart", [0, 1, 2])
@pytest.mark.parametrize("psv", range(1, 8))
def test_coded_lossless_equals_jax(tmp_path, psv, restart):
    """SOF3 from the lossless coder in the tests: differences of 2^15
    (category 16, no extra bits) among values taken mod 2^16, and a
    component sampled 2 x 2 alone, where a restart every row resets the
    predictor only at the top of each two-row iMCU row (jddiffct.c
    undifferences an iMCU row after decoding it)."""
    rng = np.random.default_rng(820 + psv)
    g = rng.integers(0, 256, (13, 17)).astype(np.uint16)
    g[3, 5] = (g[3, 4] + 32768) & 0xFFFF
    g[7, 0] = (g[6, 0] + 32768) & 0xFFFF
    _equal_to_jax(_write(tmp_path, _coded_jpeg(
        [g], [(1, 1)], lossless=(psv, 1), restart=17 * restart), "a.jpg"))
    _equal_to_jax(_write(tmp_path, _coded_jpeg(
        [g & 0xFF], [(2, 2)], lossless=(psv, 0), restart=17 * restart),
        "b.jpg"))


@pytest.mark.parametrize("name", ["4:2:2 vertical mix", "h3 integral",
                                  "chroma larger", "4x4 non-interleaved"])
def test_coded_lossless_sampling_equals_jax(tmp_path, name):
    factors, scans = SAMPLINGS[name]
    planes = _planes(np.random.default_rng(830), 35, 29, factors)
    _equal_to_jax(_write(tmp_path, _coded_jpeg(
        planes, factors, scans=scans, lossless=(4, 0), ids=[82, 71, 66])))


# ---------------------------------------------------------------------------
# block smoothing
# ---------------------------------------------------------------------------
def _pillow_progressive(mode, size):
    a = _array(1000 + len(mode) + size[0], size + SMOOTH_MODES[mode])
    buf = io.BytesIO()
    Image.fromarray(a, mode.split()[0]).save(
        buf, format="JPEG", quality=80, progressive=True,
        subsampling="4:2:0")
    return buf.getvalue()


SMOOTH2 = [(mode, size, k) for mode in SMOOTH_MODES for size in SMOOTH_SIZES
           for k in range(len(_scans(_pillow_progressive(
               mode, SMOOTH_SIZES[size]))) - 1)]


@pytest.mark.parametrize("mode,size,k", SMOOTH2,
                         ids=[f"{m} {s} after scan {k + 1}"
                              for m, s, k in SMOOTH2])
def test_pillow_progressive_cut_is_smoothed_as_jax(tmp_path, mode, size, k):
    """A Pillow SOF2 file cut with an EOI after scan k + 1: libjpeg-turbo
    2.1+'s block smoothing (the DC-only 5 x 5 kernel while no AC scan has
    come, then the predictions of the first nine AC coefficients, edge
    blocks replicated) holds for the port's decode too."""
    blob = _cuts(_pillow_progressive(mode, SMOOTH_SIZES[size]))[k]
    _equal_to_jax(_write(tmp_path, blob))


SMOOTH10_CUTS = [(name, k) for name, (a, _) in SMOOTH10.items()
                 for k in range({1: 5, 3: 9, 4: 17}[
                     a.shape[2] if a.ndim == 3 else 1])]


@pytest.mark.parametrize("name,k", SMOOTH10_CUTS,
                         ids=[f"{n} after scan {k + 1}"
                              for n, k in SMOOTH10_CUTS])
def test_arithmetic_progressive_cut_is_smoothed_as_jax(tmp_path, encoded,
                                                       name, k):
    cuts = _cuts(encoded[f"smooth {name}"])
    assert len(cuts) == len([c for n, c in SMOOTH10_CUTS if n == name])
    _equal_to_jax(_write(tmp_path, cuts[k]))


@pytest.mark.parametrize("name", ["sar_sof2_smoothed.jpg",
                                  "sar_sof10_smoothed.jpg"])
def test_block_smoothing_is_equal_at_every_thread_count(monkeypatch, name):
    """The smoothing reads neighbouring blocks' DC values, not their
    smoothed copies, so the row-parallel IDCT gives the same bytes on any
    number of threads."""
    blob = (chip_smoke.JPEG_DIR / name).read_bytes()
    outs = []
    for n in (1, 2, 3, 7, 16):
        monkeypatch.setattr(_native, "_threads", lambda n=n: n)
        outs.append(jpeg.read(blob).array)
    assert all(np.array_equal(o, outs[0]) for o in outs[1:])
    assert hashlib.sha256(outs[0].tobytes()).hexdigest() \
        == chip_smoke.JPEG_FIXTURES[name]


@pytest.mark.parametrize("frac", [0.3, 0.6])
@pytest.mark.parametrize("scan", range(1, 6))
def test_progressive_cut_inside_a_scan_is_smoothed_as_libjpeg(tmp_path,
                                                              scan, frac):
    """An EOI inside a scan's data: the rows past the last iMCU row decoded
    in full take the coefficient bits from before that scan
    (last_good_iMCU_row). The port is bit-equal to the JAX reader, or
    refuses as it does."""
    buf = io.BytesIO()
    Image.fromarray(_array(1100 + scan, (48, 64))).save(
        buf, format="JPEG", quality=80, progressive=True)
    blob = buf.getvalue()
    sos = _scans(blob)
    cut = sos[scan - 1] + int((sos[scan] - sos[scan - 1]) * frac)
    blob = blob[:cut] + b"\xff\xd9"
    path = _write(tmp_path, blob)
    try:
        jraster.RasterReader(path).close()
    except jraster.RasterError:
        _both_refuse(path)
    else:
        _equal_to_jax(path)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cut", [0.5, 0.9, -2])
@pytest.mark.parametrize("coding", ["SOF9", "SOF10", "SOF3"])
def test_cut_jpeg_as_jax(tmp_path, encoded, coding, cut):
    """A file cut short: arithmetic-coded data that runs out is Pillow's
    "broken data stream" (libjpeg cannot wait), Huffman data or markers
    that run out its "image file is truncated"."""
    blob = encoded[f"cut {coding}"]
    path = _write(tmp_path, blob[:int(len(blob) * cut) if cut > 0 else cut])
    _both_refuse(path, "truncated" if coding == "SOF3"
                 else "truncated|broken data stream")


def _patch_sos(blob, ss, se, ahal):
    """`blob` with its first scan header's Ss, Se and Ah / Al replaced."""
    i = blob.index(b"\xff\xda")
    n = blob[i + 4]
    seg = _segment(0xDA, blob[i + 4:i + 5 + 2 * n] + bytes([ss, se, ahal]))
    j = i + 2 + int.from_bytes(blob[i + 2:i + 4], "big")
    return blob[:i] + seg + blob[j:]


def _refused_files(encoded):
    ll, prog = encoded["refused SOF3"], encoded["refused SOF10"]
    i = ll.index(b"\xff\xc3")
    files = {f"SOF{m - 0xC0} patched": ll[:i + 1] + bytes([m]) + ll[i + 2:]
             for m in (0xCB, 0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)}
    g = np.random.default_rng(840).integers(0, 256, (12, 20), np.uint8)
    files["SOF11 QM-coded"] = _coded_jpeg([g], [(1, 1)], lossless=(1, 0),
                                          arith=(0, 1, 5))
    files["SOF11 QM-coded RGB"] = _coded_jpeg([g, g, g], [(1, 1)] * 3,
                                              lossless=(7, 2),
                                              arith=(1, 2, 5))
    for name, dac in {"DAC index 32": b"\x20\x10",
                      "DAC index 64": b"\x40\x10",
                      "DAC L over U": b"\x00\x12",
                      "DAC L 15 U 0": b"\x01\x0f",
                      "DAC odd length": b"\x00"}.items():
        files[name] = _coded_jpeg([g], [(1, 1)], arith=(0, 1, 5),
                                  dac=_segment(0xCC, dac))
    files["DAC in a Huffman file, L over U"] = _coded_jpeg(
        [g], [(1, 1)], dac=_segment(0xCC, b"\x00\x01"))
    for name, (ss, se, ahal) in {
            "SOF10 DC scan Se 1": (0, 1, 0x01), "SOF10 Ss over Se": (5, 2, 0),
            "SOF10 Se 64": (1, 64, 0), "SOF10 Al 14": (0, 0, 0x0E),
            "SOF10 Ah not Al + 1": (0, 0, 0x31)}.items():
        files[name] = _patch_sos(prog, ss, se, ahal)
    for name, (ss, se, ahal) in {
            "SOF3 Ss 0": (0, 0, 0), "SOF3 Ss 8": (8, 0, 0),
            "SOF3 Se 1": (1, 1, 0), "SOF3 Ah 1": (1, 0, 0x10),
            "SOF3 Pt 8": (1, 0, 8)}.items():
        files[name] = _patch_sos(ll, ss, se, ahal)
    files["SOF3 restart not a whole row"] = _coded_jpeg(
        [g], [(1, 1)], lossless=(1, 0), restart=7)
    files["SOF3 12-bit"] = _coded_jpeg([g], [(1, 1)], lossless=(1, 0),
                                       precision=12)
    files["SOF3 JFIF (YCbCr)"] = _coded_jpeg([g, g, g], [(1, 1)] * 3,
                                             lossless=(1, 0), app=JFIF)
    files["SOF3 Adobe YCCK"] = _coded_jpeg([g] * 4, [(1, 1)] * 4,
                                           lossless=(1, 0), app=ADOBE[2])
    files["SOF3 MCU of 11"] = _coded_jpeg(
        [np.zeros((12, 16), np.uint8), g[:3, :5], g[:3, :5]],
        [(4, 4), (1, 1), (1, 1)], lossless=(1, 0), ids=[82, 71, 66])
    return files


REFUSED_NAMES = (
    [f"SOF{m - 0xC0} patched" for m in (0xCB, 0xC5, 0xC6, 0xC7, 0xCD, 0xCE,
                                        0xCF)]
    + ["SOF11 QM-coded", "SOF11 QM-coded RGB", "DAC index 32",
       "DAC index 64", "DAC L over U", "DAC L 15 U 0", "DAC odd length",
       "DAC in a Huffman file, L over U", "SOF10 DC scan Se 1",
       "SOF10 Ss over Se", "SOF10 Se 64", "SOF10 Al 14",
       "SOF10 Ah not Al + 1", "SOF3 Ss 0", "SOF3 Ss 8", "SOF3 Se 1",
       "SOF3 Ah 1", "SOF3 Pt 8", "SOF3 restart not a whole row",
       "SOF3 12-bit", "SOF3 JFIF (YCbCr)", "SOF3 Adobe YCCK",
       "SOF3 MCU of 11"])


@pytest.mark.parametrize("name", REFUSED_NAMES)
def test_refused_as_by_jax(tmp_path, encoded, name):
    """Lossless arithmetic (SOF11: libjpeg-turbo refuses it before reading
    its data, whatever the data) and hierarchical frames, DAC values
    libjpeg refuses, and scan headers it calls invalid progressive /
    lossless parameters."""
    files = _refused_files(encoded)
    assert set(files) == set(REFUSED_NAMES)
    _both_refuse(_write(tmp_path, files[name]))


# ---------------------------------------------------------------------------
# the committed files chip_smoke.py reads on the card
# ---------------------------------------------------------------------------
def fixture_files() -> dict:
    """tests/data/jpeg's files, from chip_smoke.JPEG_SEED on: the SOF9 and
    SOF3 strips of a SAR-like band (webp_band's speckle), an RGB 4:2:0
    SOF10 file, and a Pillow SOF2 and a SOF10 file of two SAR-like bands,
    each cut with an EOI after its third scan."""
    s = chip_smoke.JPEG_SEED
    band = chip_smoke.webp_band(s + 3, 480, 640)
    jobs = [(chip_smoke.webp_band(s, 16, 8000),
             dict(arith=True, quality=80, restart_rows=1)),
            (chip_smoke.webp_band(s + 1, 20, 8000),
             dict(lossless=(1, 0), restart_rows=1)),
            (chip_smoke.webp_rgba_tile(s + 2, 240, 320)[..., :3],
             dict(arith=True, progressive=True, quality=85)),
            (chip_smoke.webp_band(s + 4, 480, 640),
             dict(arith=True, progressive=True, quality=85))]
    sof9, sof3, rgb, sof10 = ljt_encode.encode_many(jobs)
    buf = io.BytesIO()
    Image.fromarray(band).save(buf, format="JPEG", quality=85,
                               progressive=True)
    return {chip_smoke.JPEG_SOF9_STRIP: sof9,
            chip_smoke.JPEG_SOF3_STRIP: sof3,
            "rgb_sof10_420.jpg": rgb,
            "sar_sof2_smoothed.jpg": _cuts(buf.getvalue())[2],
            "sar_sof10_smoothed.jpg": _cuts(sof10)[2]}


def _sha(blob):
    with Image.open(io.BytesIO(blob)) as im:
        return hashlib.sha256(np.asarray(im).tobytes()).hexdigest()


def test_committed_files_are_the_encoders(tmp_path):
    """The committed bytes are the encoders' from the seeds, each at most
    200 KB; each decodes bit-equal to the JAX reader's, Pillow's decode has
    the SHA-256 chip_smoke.py holds the card's to, the strips restart every
    MCU row / row, and the cut files are block-smoothed (their first nine
    AC coefficients not all refined)."""
    files = fixture_files()
    assert set(files) == set(chip_smoke.JPEG_FIXTURES)
    for name, blob in files.items():
        assert (chip_smoke.JPEG_DIR / name).read_bytes() == blob, name
        assert len(blob) <= 200_000, name
        _equal_to_jax(_write(tmp_path, blob, name))
        assert _sha(blob) == chip_smoke.JPEG_FIXTURES[name], name
        assert hashlib.sha256(jpeg.read(blob).array.tobytes()).hexdigest() \
            == chip_smoke.JPEG_FIXTURES[name], name
    dri = {n: struct.unpack(">H", b[b.index(b"\xff\xdd") + 4:][:2])[0]
           for n, b in files.items() if b"\xff\xdd" in b}
    assert dri == {chip_smoke.JPEG_SOF9_STRIP: 1000,
                   chip_smoke.JPEG_SOF3_STRIP: 8000}
    for name in ("sar_sof2_smoothed.jpg", "sar_sof10_smoothed.jpg"):
        assert len(_scans(files[name])) == 3
        assert _smoothed(files[name])


def _smoothed(blob) -> bool:
    """Whether libjpeg block-smooths a progressive gray file: its DC seen
    and some coefficient of 1..9 not refined to the last bit (jdcoefct.c
    smoothing_ok)."""
    bits = [-1] * 64
    for i in _scans(blob):
        n = blob[i + 4]
        ss, se, ahal = blob[i + 5 + 2 * n:i + 8 + 2 * n]
        bits[ss:se + 1] = [ahal & 15] * (se + 1 - ss)
    return bits[0] >= 0 and any(b != 0 for b in bits[1:10])


@pytest.mark.parametrize("strip", ["SOF9", "SOF9 narrow", "SOF3"])
def test_spliced_strip_equals_tiled_strip(tmp_path, encoded, strip):
    """chip_smoke.jpeg_splice: a strip's restart intervals over and over
    decode to np.tile of the strip's decode, in both readers. Arithmetic-
    coded data past Pillow's first 64 KiB block opens in neither, so a SOF9
    splice stays under it: the SOF9 fixture's two intervals cut to 13 rows,
    and a narrow encoder-written SOF9 strip (a restart every MCU row) to
    five strips and 3 rows."""
    if strip == "SOF9 narrow":
        blob = encoded["splice SOF9"]
    else:
        blob = (chip_smoke.JPEG_DIR / {
            "SOF9": chip_smoke.JPEG_SOF9_STRIP,
            "SOF3": chip_smoke.JPEG_SOF3_STRIP}[strip]).read_bytes()
    strip_px = jpeg.read(blob).array
    rows = (strip_px.shape[0] - 3 if strip == "SOF9"
            else strip_px.shape[0] * 5 + 3)
    band = chip_smoke.jpeg_splice(blob, rows)
    assert strip == "SOF3" or len(band) < 65536
    want = np.tile(strip_px, (6, 1))[:rows]
    got = _equal_to_jax(_write(tmp_path, band))
    assert np.array_equal(got[..., 0], want)
