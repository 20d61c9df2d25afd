"""The port's WebP reader (io/webp.py, _native/webpdec.cpp) against the JAX
package's RasterReader, which opens the same files through Pillow 12.1 and
libwebp 1.6.0, on the CPU: every band bit-equal (dtype included), equal
size, bands, geotransform, EPSG and gdal_metadata(), and RasterError where
the JAX reader raises it. No tolerance anywhere: libwebp's decode is integer
arithmetic.

Inputs are written by Pillow from seeded numpy arrays (lossy qualities and
methods, lossless methods and `exact`, alpha_quality, sizes of 1 x 1, odd
and one past a macroblock, gray, RGB and RGBA, animations), by libwebp
1.6.0's own WebPEncode through ctypes for the knobs Pillow does not expose
(the simple and the normal loop filter, sharpness, filter strength 0, token
partitions, segments, alpha filtering and compression, near-lossless, sharp
YUV), and chunk by chunk here: raw ALPH planes under each filter, ALPH
headers libwebp refuses, animations with patched ANMF offsets and frames
smaller than the canvas, VP8X flags that disagree with the bitstream,
unknown, odd-length and metadata chunks, files cut short, bit flips. The
committed files of tests/data/webp (chip_smoke.py's webp phase) are
re-encoded here from their seeds, and chip_smoke's VP8L writer is held to
Pillow."""
import ctypes
import glob
import hashlib
import io
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import PIL  # noqa: E402
from PIL import Image  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu_torch.errors import RasterError  # noqa: E402
from sarpro_tpu_torch.io import pixels, webp  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from test_torch_decoders import (  # noqa: E402
    RESAMPLE_TOL,
    _both_refuse,
    _equal_to_jax,
)
from test_torch_readers import WKT_32632  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

BANDS = {"L": 3, "RGB": 3, "RGBA": 4}
SIZES = ((1, 1), (13, 21), (17, 16), (37, 50))  # (17, 16): a row past one MB


def _scene(rng, shape):
    """Speckled gradients (every macroblock busy); a fourth band is an alpha
    ramp with a transparent corner."""
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    g = (x * 5 + y * 3) % 256
    if len(shape) == 3:
        g = g[..., None] + 40 * np.arange(shape[2])
    a = np.clip(0.6 * g + rng.gamma(4.0, 8.0, shape), 0, 255).astype(np.uint8)
    if len(shape) == 3 and shape[2] == 4:
        a[..., 3] = np.clip(40 + 7 * x + 3 * y, 0, 255)
        a[:shape[0] // 3, :shape[1] // 3, 3] = 0
    return a


def _encode(a, mode: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a, mode).save(buf, format="WEBP", **kw)
    return buf.getvalue()


def _write(tmp_path, blob: bytes, name: str = "x.webp") -> Path:
    path = tmp_path / name
    path.write_bytes(blob)
    return path


def _mode(path) -> str:
    with Image.open(path) as im:
        return im.mode


def _open_equal(tmp_path, blob: bytes, mode: str):
    """Pillow opens `blob` in `mode`; the port reads it bit-equal to the
    JAX reader."""
    path = _write(tmp_path, blob)
    assert _mode(path) == mode
    got = _equal_to_jax(path)
    assert got.shape[2] == len(mode)
    return got


# ---------------------------------------------------------------------------
# RIFF chunks
# ---------------------------------------------------------------------------
def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (tag + struct.pack("<I", len(payload)) + payload
            + b"\0" * (len(payload) & 1))


def _riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _chunks(blob: bytes) -> list:
    """[(tag, payload)] of a RIFF WEBP file's top-level chunks."""
    out, pos = [], 12
    while pos + 8 <= len(blob):
        tag, n = blob[pos:pos + 4], struct.unpack_from("<I", blob, pos + 4)[0]
        out.append((tag, blob[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def _le24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def _vp8x(flags: int, width: int, height: int) -> bytes:
    return _chunk(b"VP8X", bytes([flags, 0, 0, 0]) + _le24(width - 1)
                  + _le24(height - 1))


def _image_chunks(blob: bytes) -> bytes:
    """The ALPH / VP8 / VP8L chunks of a still image, as they sit in it."""
    return b"".join(_chunk(t, p) for t, p in _chunks(blob)
                    if t in (b"ALPH", b"VP8 ", b"VP8L"))


# ---------------------------------------------------------------------------
# libwebp 1.6.0's own encoder, for the knobs Pillow does not expose
# ---------------------------------------------------------------------------
WEBP_ENCODER_ABI_VERSION = 0x0210
CONFIG_FIELDS = (
    "lossless", "quality", "method", "image_hint", "target_size",
    "target_PSNR", "segments", "sns_strength", "filter_strength",
    "filter_sharpness", "filter_type", "autofilter", "alpha_compression",
    "alpha_filtering", "alpha_quality", "pass", "show_compressed",
    "preprocessing", "partitions", "partition_limit", "emulate_jpeg_size",
    "thread_level", "low_memory", "near_lossless", "exact",
    "use_delta_palette", "use_sharp_yuv", "qmin", "qmax")


class _Config(ctypes.Structure):
    """WebPConfig of libwebp 1.6.0 (encode.h): every field 4 bytes."""
    _fields_ = [(f, ctypes.c_float if f in ("quality", "target_PSNR")
                 else ctypes.c_int) for f in CONFIG_FIELDS]


class _Picture(ctypes.Structure):
    """WebPPicture of libwebp 1.6.0 (encode.h), x86-64 layout."""
    _fields_ = [
        ("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("y", ctypes.c_void_p), ("u", ctypes.c_void_p),
        ("v", ctypes.c_void_p), ("y_stride", ctypes.c_int),
        ("uv_stride", ctypes.c_int), ("a", ctypes.c_void_p),
        ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
        ("argb", ctypes.c_void_p), ("argb_stride", ctypes.c_int),
        ("pad2", ctypes.c_uint32 * 3), ("writer", ctypes.c_void_p),
        ("custom_ptr", ctypes.c_void_p), ("extra_info_type", ctypes.c_int),
        ("extra_info", ctypes.c_void_p), ("stats", ctypes.c_void_p),
        ("error_code", ctypes.c_int), ("progress_hook", ctypes.c_void_p),
        ("user_data", ctypes.c_void_p), ("pad3", ctypes.c_uint32 * 3),
        ("pad4", ctypes.c_void_p), ("pad5", ctypes.c_void_p),
        ("pad6", ctypes.c_uint32 * 8), ("memory_", ctypes.c_void_p),
        ("memory_argb_", ctypes.c_void_p), ("pad7", ctypes.c_void_p * 2)]


class _MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)),
                ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32 * 1)]


def _load_libwebp():
    """(library, None), or (None, why) where Pillow's bundled libwebp
    1.6.0 cannot be loaded."""
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    sharp = glob.glob(str(libs / "libsharpyuv-*.so*"))
    found = glob.glob(str(libs / "libwebp-*.so*"))
    if not sharp or not found:
        return None, f"no libwebp / libsharpyuv in {libs}"
    try:
        ctypes.CDLL(sharp[0], mode=ctypes.RTLD_GLOBAL)
        lib = ctypes.CDLL(found[0])
    except OSError as e:
        return None, f"libwebp does not load: {e}"
    if lib.WebPGetEncoderVersion() != 0x010600:
        return None, (f"libwebp {lib.WebPGetEncoderVersion():#x} is not "
                      "1.6.0, whose WebPConfig layout this test holds")
    return lib, None


LIBWEBP, LIBWEBP_WHY = _load_libwebp()


def _libwebp_encode(a, **knobs) -> bytes:
    """WebPEncode of an RGB or RGBA array with WebPConfig's defaults
    (WebPConfigInit, quality 75) and `knobs`."""
    if LIBWEBP is None:
        pytest.skip(LIBWEBP_WHY)
    lib = LIBWEBP
    cfg = _Config()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0,
                                      ctypes.c_float(75.0),
                                      WEBP_ENCODER_ABI_VERSION)
    for k, v in knobs.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg)), knobs
    pic = _Picture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic),
                                       WEBP_ENCODER_ABI_VERSION)
    a = np.ascontiguousarray(a)
    h, w, c = a.shape
    pic.width, pic.height, pic.use_argb = w, h, 1
    imp = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    assert imp(ctypes.byref(pic), a.ctypes.data_as(ctypes.c_void_p), w * c)
    wr = _MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    pic.custom_ptr = ctypes.addressof(wr)
    ok = lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    out = ctypes.string_at(wr.mem, wr.size)
    lib.WebPMemoryWriterClear(ctypes.byref(wr))
    lib.WebPPictureFree(ctypes.byref(pic))
    assert ok, pic.error_code
    return out


def test_libwebp_config_layout_is_pillows(rng):
    """WebPConfigInit's defaults land on the fields named here, and the
    ctypes encoder writes Pillow's bytes for Pillow's settings."""
    if LIBWEBP is None:
        pytest.skip(LIBWEBP_WHY)
    cfg = _Config()
    assert LIBWEBP.WebPConfigInitInternal(ctypes.byref(cfg), 0,
                                          ctypes.c_float(75.0),
                                          WEBP_ENCODER_ABI_VERSION)
    assert (cfg.quality, cfg.method, cfg.segments, cfg.filter_strength,
            cfg.alpha_quality, cfg.near_lossless, cfg.qmax) == (
                75.0, 4, 4, 60, 100, 100, 100)
    a = _scene(rng, (24, 40, 4))
    for lossless in (0, 1):
        assert _libwebp_encode(a, lossless=lossless, quality=80.0) == \
            _encode(a, "RGBA", lossless=bool(lossless), quality=80)


# ---------------------------------------------------------------------------
# Pillow's encoder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("quality", [0, 50, 80, 100])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_pillow_lossy_equals_jax(tmp_path, rng, mode, quality, size):
    a = _scene(rng, size + ((BANDS[mode],) if mode != "L" else ()))
    _open_equal(tmp_path, _encode(a, mode, quality=quality),
                "RGBA" if mode == "RGBA" else "RGB")


@pytest.mark.parametrize("method", range(7))
def test_pillow_lossy_methods_equal_jax(tmp_path, rng, method):
    a = _scene(rng, (45, 70, 4))
    _open_equal(tmp_path, _encode(a, "RGBA", quality=70, method=method),
                "RGBA")


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("method", [0, 3, 6])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_pillow_lossless_equals_jax(tmp_path, rng, mode, method, exact):
    """Lossless: equal to the array written (where `exact` keeps the colour
    under alpha 0: straight RGBA, not premultiplied)."""
    a = _scene(rng, (29, 43) + ((BANDS[mode],) if mode != "L" else ()))
    got = _open_equal(tmp_path, _encode(a, mode, lossless=True, method=method,
                                        exact=exact),
                      "RGBA" if mode == "RGBA" else "RGB")
    if mode == "L":
        assert all(np.array_equal(got[..., k], a) for k in range(3))
    elif exact or mode == "RGB":
        assert np.array_equal(got, a)


@pytest.mark.parametrize("alpha_quality", [0, 30, 70])
def test_pillow_alpha_quality_equals_jax(tmp_path, rng, alpha_quality):
    a = _scene(rng, (40, 56, 4))
    _open_equal(tmp_path, _encode(a, "RGBA", quality=60,
                                  alpha_quality=alpha_quality), "RGBA")


@pytest.mark.parametrize("size", [(1, 1), (16, 16), (15, 33), (64, 65)])
def test_pillow_sizes_equal_jax(tmp_path, rng, size):
    """Odd sizes, a width past a macroblock and 1 x 1: the upsampler's
    first and last rows and columns."""
    a = _scene(rng, size + (3,))
    _open_equal(tmp_path, _encode(a, "RGB", quality=90), "RGB")


# ---------------------------------------------------------------------------
# libwebp's knobs
# ---------------------------------------------------------------------------
KNOBS = (
    [dict(filter_type=t, filter_sharpness=s, filter_strength=80)
     for t in (0, 1) for s in range(8)]
    + [dict(filter_strength=0), dict(filter_strength=100, autofilter=1)]
    + [dict(partitions=p) for p in range(4)]
    + [dict(segments=n, sns_strength=100) for n in range(1, 5)]
    + [dict(alpha_filtering=f, alpha_compression=c) for f in range(3)
       for c in (0, 1)]
    + [dict(lossless=1, near_lossless=n) for n in (0, 40, 80)]
    + [dict(use_sharp_yuv=1), dict(quality=5.0, preprocessing=2),
       dict(quality=100.0, method=6, segments=1)])


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(
    f"{a}{b}" for a, b in k.items()))
def test_libwebp_knobs_equal_jax(tmp_path, rng, knobs):
    """Several macroblock rows and columns (for the partitions and the
    filter's edges), with alpha."""
    a = _scene(rng, (70, 90, 4))
    _open_equal(tmp_path, _libwebp_encode(a, **knobs), "RGBA")


# ---------------------------------------------------------------------------
# chunks built here
# ---------------------------------------------------------------------------
def _filtered(plane: np.ndarray, method: int) -> np.ndarray:
    """libwebp's forward alpha filter (filters.c): none, horizontal,
    vertical, gradient; the first row predicted from the left (0 for the
    first pixel), the first column from above."""
    p = plane.astype(np.int32)
    pred = np.zeros_like(p)
    if method == 0:
        return plane.copy()
    pred[0, 1:] = p[0, :-1]
    pred[1:, 0] = p[:-1, 0]
    if method == 1:
        pred[1:, 1:] = p[1:, :-1]
    elif method == 2:
        pred[1:, 1:] = p[:-1, 1:]
    else:
        g = p[1:, :-1] + p[:-1, 1:] - p[:-1, :-1]
        pred[1:, 1:] = np.clip(g, 0, 255)
    return ((p - pred) & 0xFF).astype(np.uint8)


def _lossy_with_alph(rng, alph: bytes, flags: int = 0x10, shape=(21, 34)):
    """A VP8X file: `alph` as its ALPH payload before Pillow's lossy VP8
    chunk of an RGB scene of `shape`."""
    vp8 = _chunks(_encode(_scene(rng, shape + (3,)), "RGB", quality=85))[0]
    return _riff(_vp8x(flags, shape[1], shape[0]) + _chunk(b"ALPH", alph)
                 + _chunk(*vp8))


@pytest.mark.parametrize("levels", [0, 1])
@pytest.mark.parametrize("method", range(4))
def test_raw_alph_filters_equal_jax(tmp_path, rng, method, levels):
    """A raw (uncompressed) ALPH plane under each filter decodes to the
    plane (the pre-processing bit, level reduction, changes nothing in the
    decode)."""
    plane = _scene(rng, (21, 34, 4))[..., 3]
    alph = bytes([method << 2 | levels << 4]) + _filtered(plane,
                                                          method).tobytes()
    got = _open_equal(tmp_path, _lossy_with_alph(rng, alph), "RGBA")
    assert np.array_equal(got[..., 3], plane)


@pytest.mark.parametrize("header", ["method 2", "method 3", "reserved bit",
                                    "pre-processing 2", "cut plane",
                                    "empty"])
def test_bad_alph_is_refused_as_by_jax(tmp_path, rng, header):
    """ALPH chunks libwebp refuses (alpha_dec.c's ALPHInit): the frame does
    not decode."""
    plane = bytes(21 * 34)
    alph = {"method 2": b"\x02" + plane, "method 3": b"\x03" + plane,
            "reserved bit": b"\x40" + plane,
            "pre-processing 2": b"\x20" + plane,
            "cut plane": b"\x00" + plane[:-1], "empty": b""}[header]
    _both_refuse(_write(tmp_path, _lossy_with_alph(rng, alph)),
                 "failed to decode")


def _still(rng, lossless: bool, alpha: bool, shape=(19, 26)):
    a = _scene(rng, shape + (4 if alpha else 3,))
    return _encode(a, "RGBA" if alpha else "RGB", quality=80,
                   lossless=lossless)


def _flags_case(rng, case: str) -> bytes:
    lossy_rgba = _still(rng, False, True)
    lossy_rgb = _still(rng, False, False)
    vp8l_rgba = _still(rng, True, True)
    vp8l_rgb = _still(rng, True, False)
    alph = _chunks(lossy_rgba)[1]
    assert alph[0] == b"ALPH"
    w, h = 26, 19
    if case == "alpha flag, VP8 without ALPH":
        return _riff(_vp8x(0x10, w, h) + _image_chunks(lossy_rgb))
    if case == "no alpha flag, ALPH and VP8":
        return _riff(_vp8x(0x00, w, h) + _image_chunks(lossy_rgba))
    if case == "alpha flag, VP8L without alpha hint":
        return _riff(_vp8x(0x10, w, h) + _image_chunks(vp8l_rgb))
    if case == "no alpha flag, VP8L with alpha hint":
        return _riff(_vp8x(0x00, w, h) + _image_chunks(vp8l_rgba))
    if case == "VP8L hint cleared over alpha":
        body = bytearray(_chunks(vp8l_rgba)[0][1])
        body[4] &= ~0x10  # bit 28 of the header: the alpha hint
        return _riff(_chunk(b"VP8L", bytes(body)))
    if case == "ICC, EXIF and XMP flags without chunks":
        return _riff(_vp8x(0x2C | 0x10, w, h) + _image_chunks(lossy_rgba))
    if case == "ALPH after VP8, no alpha flag":
        return _riff(_vp8x(0x00, w, h) + _chunk(*_chunks(lossy_rgb)[0])
                     + _chunk(*alph))
    if case == "ALPH after VP8 in a simple file":
        return _riff(_chunk(*_chunks(lossy_rgb)[0]) + _chunk(*alph))
    raise AssertionError(case)


# Pillow 12.1's mode for files whose VP8X flags disagree with the bitstream
# (libwebp's WebPGetFeatures, io/webp.has_alpha), and the alpha decoded
FLAG_CASES = {
    "alpha flag, VP8 without ALPH": "RGBA",
    "no alpha flag, ALPH and VP8": "RGBA",
    "alpha flag, VP8L without alpha hint": "RGB",
    "no alpha flag, VP8L with alpha hint": "RGBA",
    "VP8L hint cleared over alpha": "RGB",
    "ICC, EXIF and XMP flags without chunks": "RGBA",
    "ALPH after VP8, no alpha flag": "RGB",
    "ALPH after VP8 in a simple file": "RGB",
}


@pytest.mark.parametrize("case", FLAG_CASES)
def test_flags_against_bitstream_equal_jax(tmp_path, rng, case):
    got = _open_equal(tmp_path, _flags_case(rng, case), FLAG_CASES[case])
    if case in ("alpha flag, VP8 without ALPH", "no alpha flag, ALPH and VP8"):
        assert (got[..., 3] == 255).all()  # no alpha decoded


@pytest.mark.parametrize("flags", [0x01, 0x40, 0x80, 0x12])
def test_vp8x_flags_the_demuxer_refuses(tmp_path, rng, flags):
    """Reserved flag bits, or the animation flag on a still image."""
    blob = _riff(_vp8x(flags, 26, 19) + _image_chunks(_still(rng, False,
                                                              True)))
    _both_refuse(_write(tmp_path, blob), "could not create decoder")


@pytest.mark.parametrize("size", [11, 12, 16])
def test_long_vp8x_is_refused_as_by_jax(tmp_path, rng, size):
    """A VP8X chunk past its 10 bytes: the demuxer skips the rest, but
    WebPGetFeatures, which WebPAnimDecoderNew asks first, refuses it."""
    payload = _vp8x(0x10, 26, 19)[8:] + bytes(size - 10)
    blob = _riff(_chunk(b"VP8X", payload)
                 + _image_chunks(_still(rng, False, False)))
    assert webp.Demux(blob).error is None and webp.has_alpha(blob) is None
    _both_refuse(_write(tmp_path, blob), "could not create decoder")


def _frame(x: int, y: int, w: int, h: int, data: bytes, bits: int = 0):
    return _chunk(b"ANMF", _le24(x // 2) + _le24(y // 2) + _le24(w - 1)
                  + _le24(h - 1) + _le24(100) + bytes([bits]) + data)


def _animation(canvas, frames, flags: int = 0x12, anim: bool = True):
    body = _vp8x(flags, *canvas)
    if anim:
        body += _chunk(b"ANIM", struct.pack("<IH", 0xFF102030, 0))
    return _riff(body + b"".join(frames))


def _anim_case(rng, case: str):
    """(file, mode) of a hand-built animation."""
    f_rgba = _still(rng, False, True, (20, 30))
    f_rgb = _still(rng, False, False, (20, 30))
    f_vp8l = _still(rng, True, True, (12, 14))
    data = {"rgba": _image_chunks(f_rgba), "rgb": _image_chunks(f_rgb),
            "vp8l": _image_chunks(f_vp8l)}
    if case == "frame at its offsets, alpha canvas":
        return _animation((40, 30), [
            _frame(6, 4, 30, 20, data["rgba"]),
            _frame(0, 0, 30, 20, data["rgb"])]), "RGBA"
    if case == "frame at its offsets, no-alpha canvas":
        return _animation((40, 30), [_frame(10, 8, 30, 20, data["rgba"])],
                          flags=0x02), "RGB"
    if case == "opaque frame on an alpha canvas":
        return _animation((31, 25), [_frame(0, 2, 30, 20, data["rgb"])]), \
            "RGBA"
    if case == "VP8L frame, odd canvas":
        return _animation((33, 17), [_frame(18, 4, 14, 12, data["vp8l"]),
                                     _frame(0, 0, 14, 12, data["vp8l"])]), \
            "RGBA"
    if case == "frame filling the canvas":
        return _animation((30, 20), [_frame(0, 0, 30, 20, data["rgba"], 3)]), \
            "RGBA"
    if case == "ANMF size field disagrees with the bitstream":
        return _animation((40, 30), [_frame(2, 2, 7, 5, data["rgba"])]), \
            "RGBA"
    if case == "unknown chunk inside and between frames":
        junk = _chunk(b"JUNK", b"abc")
        return _animation((40, 30), [_frame(4, 4, 30, 20, data["rgb"] + junk),
                                     junk]), "RGBA"
    raise AssertionError(case)


ANIM_CASES = ("frame at its offsets, alpha canvas",
              "frame at its offsets, no-alpha canvas",
              "opaque frame on an alpha canvas", "VP8L frame, odd canvas",
              "frame filling the canvas",
              "ANMF size field disagrees with the bitstream",
              "unknown chunk inside and between frames")


@pytest.mark.parametrize("case", ANIM_CASES)
def test_animation_first_frame_equals_jax(tmp_path, rng, case):
    """The first frame on a zero-filled canvas at its doubled offsets, no
    blending."""
    blob, mode = _anim_case(rng, case)
    got = _open_equal(tmp_path, blob, mode)
    if case == "frame at its offsets, alpha canvas":
        assert (got[:4] == 0).all() and (got[:, :6] == 0).all()


@pytest.mark.parametrize("case", ["frame past the canvas", "no ANIM chunk",
                                  "animation flag missing", "empty ANMF",
                                  "ANMF shorter than its header"])
def test_bad_animation_is_refused_as_by_jax(tmp_path, rng, case):
    data = _image_chunks(_still(rng, False, True, (20, 30)))
    blob = {
        "frame past the canvas": lambda: _animation(
            (40, 30), [_frame(12, 0, 30, 20, data)]),
        "no ANIM chunk": lambda: _animation(
            (40, 30), [_frame(0, 0, 30, 20, data)], anim=False),
        "animation flag missing": lambda: _animation(
            (40, 30), [_frame(0, 0, 30, 20, data)], flags=0x10),
        "empty ANMF": lambda: _animation((40, 30),
                                         [_frame(0, 0, 30, 20, b"")]),
        "ANMF shorter than its header": lambda: _animation(
            (40, 30), [_chunk(b"ANMF", bytes(12))]),
    }[case]()
    _both_refuse(_write(tmp_path, blob), "could not create decoder")


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_pillow_animation_equals_jax(tmp_path, rng, mode, lossless):
    frames = [Image.fromarray(_scene(rng, (30, 41, len(mode))), mode)
              for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, format="WEBP", save_all=True,
                   append_images=frames[1:], duration=80, lossless=lossless)
    blob = buf.getvalue()
    assert [t for t, _ in _chunks(blob)][:2] == [b"VP8X", b"ANIM"]
    _open_equal(tmp_path, blob, "RGBA" if mode == "RGBA" else "RGB")


def _container_case(rng, case: str) -> bytes:
    lossy = _still(rng, False, True)
    vp8l = _still(rng, True, False)
    junk = _chunk(b"JUNK", b"12345")  # odd length: one byte of padding
    if case == "unknown chunks before and after the image":
        return _riff(_vp8x(0x10, 26, 19) + junk + _image_chunks(lossy) + junk)
    if case == "unknown chunk after a simple VP8L":
        return _riff(_chunk(*_chunks(vp8l)[0]) + junk)
    if case == "second image after a simple VP8L":
        return _riff(_chunk(*_chunks(vp8l)[0]) + _chunk(*_chunks(vp8l)[0]))
    if case == "bytes past the RIFF size":
        return vp8l + b"trailing bytes past the RIFF chunk"
    if case == "odd VP8L payload":  # the padding byte reaches the decoder
        for width in range(20, 40):
            blob = _still(rng, True, False, (9, width))
            if len(_chunks(blob)[0][1]) % 2:
                return blob
        raise AssertionError("no odd VP8L payload")
    if case == "ICCP, EXIF and XMP chunks":
        return _riff(_vp8x(0x3C, 26, 19) + _chunk(b"ICCP", b"\0" * 7)
                     + _image_chunks(lossy) + _chunk(b"EXIF", b"II*\0")
                     + _chunk(b"XMP ", b"<x/>"))
    raise AssertionError(case)


CONTAINER_CASES = {
    "unknown chunks before and after the image": "RGBA",
    "unknown chunk after a simple VP8L": "RGB",
    "second image after a simple VP8L": "RGB",
    "bytes past the RIFF size": "RGB",
    "odd VP8L payload": "RGB",
    "ICCP, EXIF and XMP chunks": "RGBA",
}


@pytest.mark.parametrize("case", CONTAINER_CASES)
def test_container_chunks_equal_jax(tmp_path, rng, case):
    _open_equal(tmp_path, _container_case(rng, case), CONTAINER_CASES[case])


@pytest.mark.parametrize("meta", ["icc_profile", "exif", "xmp"])
def test_pillow_metadata_chunks_add_no_text(tmp_path, rng, meta):
    """Pillow keeps ICC / EXIF / XMP as bytes: gdal_metadata() stays empty
    on both sides."""
    value = {"icc_profile": b"\0" * 40, "exif": b"Exif\0\0II*\0\x08\0\0\0\0\0",
             "xmp": b"<x:xmpmeta/>"}[meta]
    blob = _encode(_scene(rng, (20, 24, 4)), "RGBA", quality=70,
                   **{meta: value})
    assert any(t in (b"ICCP", b"EXIF", b"XMP ") for t, _ in _chunks(blob))
    path = _write(tmp_path, blob)
    _equal_to_jax(path)
    assert traster.RasterReader(path).metadata.metadata == {}


def test_world_file_and_prj(tmp_path, rng):
    """The .wpw world file (first and last letter + w) and a .prj: the
    port's geotransform and EPSG are the JAX reader's."""
    path = _write(tmp_path, _encode(_scene(rng, (16, 20, 3)), "RGB"), "g.webp")
    path.with_suffix(".wpw").write_text(
        "10.0\n0.0\n0.0\n-10.0\n500005.0\n3999995.0\n")
    path.with_suffix(".prj").write_text(WKT_32632)
    _equal_to_jax(path)
    t = traster.RasterReader(path)
    assert t.metadata.geotransform == [500000.0, 10.0, 0.0, 4000000.0, 0.0,
                                       -10.0]
    assert t.metadata.epsg == 32632 and t.metadata.metadata == {}


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cut", [0, 11, 19, 25, 40, -31, -2, -1])
@pytest.mark.parametrize("kind", ["lossy alpha", "lossless"])
def test_cut_files_are_refused_as_by_jax(tmp_path, rng, kind, cut):
    blob = _still(rng, kind == "lossless", True)
    _both_refuse(_write(tmp_path, blob[:cut] if cut else b""),
                 "could not create decoder|cannot identify")


def test_bad_fourcc_is_not_identified(tmp_path, rng):
    blob = bytearray(_still(rng, True, False))
    blob[12:16] = b"VP8Y"
    _both_refuse(_write(tmp_path, bytes(blob)), "cannot identify")


@pytest.mark.parametrize("canvas", [(27, 19), (26, 18), (100, 100)])
def test_vp8_size_against_vp8x_is_refused_as_by_jax(tmp_path, rng, canvas):
    blob = _riff(_vp8x(0x10, *canvas) + _image_chunks(_still(rng, False,
                                                             True)))
    _both_refuse(_write(tmp_path, blob), "could not create decoder")


@pytest.mark.parametrize("patch", ["VP8L signature", "VP8L version",
                                   "VP8 start code", "VP8 inter frame",
                                   "VP8 hidden frame", "VP8 partition size"])
def test_bitstream_headers_are_refused_as_by_jax(tmp_path, rng, patch):
    """Headers WebPGetFeatures refuses: the demuxer drops the file."""
    lossless = patch.startswith("VP8L")
    blob = bytearray(_still(rng, lossless, False))
    p = 20  # the first byte of the (only) image chunk's payload
    if patch == "VP8L signature":
        blob[p] = 0x2E
    elif patch == "VP8L version":
        blob[p + 4] |= 0x20
    elif patch == "VP8 start code":
        blob[p + 3] ^= 0xFF
    elif patch == "VP8 inter frame":
        blob[p] |= 1
    elif patch == "VP8 hidden frame":
        blob[p] &= ~0x10
    else:  # first partition as long as the chunk
        size = struct.unpack_from("<I", blob, 16)[0]
        bits = blob[p] | blob[p + 1] << 8 | blob[p + 2] << 16
        bits = (bits & 0x1F) | size << 5
        blob[p:p + 3] = struct.pack("<I", bits)[:3]
    _both_refuse(_write(tmp_path, bytes(blob)), "could not create decoder")


def test_decompression_bomb_is_refused_as_by_jax(tmp_path, rng):
    """179 MP of canvas (over twice Pillow's MAX_IMAGE_PIXELS): both readers
    raise with Pillow's message before decoding a pixel."""
    side = 13380
    assert side * side > 2 * pixels.MAX_IMAGE_PIXELS
    data = _image_chunks(_still(rng, False, False, (20, 30)))
    path = _write(tmp_path, _animation((side, side),
                                       [_frame(0, 0, 30, 20, data)]))
    with pytest.raises(jraster.RasterError) as je:
        jraster.RasterReader(path)
    with pytest.raises(RasterError) as te:
        traster.RasterReader(path)
    want = (f"Image size ({side * side} pixels) exceeds limit of 178956970 "
            "pixels, could be decompression bomb DOS attack.")
    assert want in str(je.value) and str(te.value) == str(je.value)


@pytest.mark.parametrize("seed", range(12))
def test_corrupt_bitstreams_agree_with_jax(tmp_path, seed):
    """Bit flips in the chunks: each file either opens bit-equal to the JAX
    reader's image or is refused by both (where a read runs past the data,
    a prefix code is incomplete, a copy reaches before the first pixel,
    ...)."""
    rng = np.random.default_rng(1000 + seed)
    kw = [dict(quality=70), dict(lossless=True), dict(lossless=True, method=0),
          dict(quality=30, alpha_quality=50)][seed % 4]
    blob = _encode(_scene(rng, (23, 30, 4)), "RGBA", **kw)
    opened = refused = 0
    for _ in range(25):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(20, len(b)))] ^= 1 << int(rng.integers(0, 8))
        path = _write(tmp_path, bytes(b))
        try:
            jraster.RasterReader(path).close()
        except jraster.RasterError:
            _both_refuse(path)
            refused += 1
            continue
        _equal_to_jax(path)
        opened += 1
    assert opened + refused == 25


# ---------------------------------------------------------------------------
# the decoded band onto the device (the CPU here)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alg", ["average", "cubic", "nearest"])
@pytest.mark.parametrize("kind", ["lossy", "lossless"])
def test_decimated_read_of_webp_band_equals_jax(tmp_path, rng, kind, alg):
    """tests/test_io.py's read_band_resampled(1, 30, 20, ...) on a WebP
    band: the port's device route against the JAX package's."""
    a = _scene(rng, (60, 90, 3))
    path = _write(tmp_path, _encode(a, "RGB", quality=85,
                                    lossless=kind == "lossless"))
    t, j = traster.RasterReader(path), jraster.RasterReader(path)
    try:
        got = traster.read_band_resampled_to_device(t, 1, 30, 20, "cpu", alg)
        want = j.read_band_resampled(1, 30, 20, alg)
    finally:
        t.close()
        j.close()
    assert got.dtype == torch.float32 and tuple(got.shape) == (20, 30)
    np.testing.assert_allclose(got.numpy(), want, **RESAMPLE_TOL)


# ---------------------------------------------------------------------------
# chip_smoke.py's webp phase: the committed files and the VP8L writer
# ---------------------------------------------------------------------------
def fixture_files() -> dict:
    """tests/data/webp's files, as Pillow writes them from chip_smoke's
    seeds: a SAR-like band as lossy RGB (Pillow's defaults), a lossy RGBA
    whose ALPH plane is VP8L-coded and filtered (method 6 picks the
    horizontal filter), a lossless RGBA, and a two-frame lossy RGBA
    animation."""
    s = chip_smoke.WEBP_SEED

    def save(img, **kw) -> bytes:
        buf = io.BytesIO()
        img.save(buf, format="WEBP", **kw)
        return buf.getvalue()

    frames = [Image.fromarray(chip_smoke.webp_rgba_tile(s + k, 96, 112),
                              "RGBA") for k in (3, 4)]
    return {
        "sar_lossy_rgb.webp": save(Image.fromarray(
            chip_smoke.webp_band(s, 320, 320), "L"), quality=80),
        "rgba_lossy_alph.webp": save(Image.fromarray(
            chip_smoke.webp_rgba_tile(s + 1, 160, 176), "RGBA"), quality=75,
            method=6),
        "rgba_lossless.webp": save(Image.fromarray(
            chip_smoke.webp_rgba_tile(s + 2, 128, 144), "RGBA"),
            lossless=True),
        "anim_two_frames.webp": save(frames[0], save_all=True,
                                     append_images=frames[1:], duration=100,
                                     loop=0, quality=70),
    }


def test_committed_files_are_pillows(tmp_path):
    """The committed bytes are Pillow's re-encode from the seeds, under
    1 MB together; each decodes bit-equal to the JAX reader's, Pillow's
    decode has the SHA-256 chip_smoke.py holds the card's to, and the
    ALPH plane is VP8L-coded and filtered."""
    files = fixture_files()
    assert set(files) == set(chip_smoke.WEBP_FIXTURES)
    assert sum(map(len, files.values())) < 1 << 20
    for name, blob in files.items():
        assert (chip_smoke.WEBP_DIR / name).read_bytes() == blob, name
        _equal_to_jax(_write(tmp_path, blob, name))
        with Image.open(io.BytesIO(blob)) as im:
            digest = hashlib.sha256(np.asarray(im).tobytes()).hexdigest()
        assert digest == chip_smoke.WEBP_FIXTURES[name], name
        assert hashlib.sha256(webp.read(blob).array.tobytes()).hexdigest() \
            == digest
    alph = dict(_chunks(files["rgba_lossy_alph.webp"]))[b"ALPH"]
    assert alph[0] & 3 == 1 and alph[0] >> 2 & 3 != 0
    kinds = {t for t, _ in _chunks(files["anim_two_frames.webp"])}
    assert {b"ANIM", b"ANMF"} <= kinds


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (33, 1), (64, 81)])
@pytest.mark.parametrize("planes", ["gray band", "constant green",
                                    "all constant", "four varying"])
def test_vp8l_writer_decodes_in_pillow(tmp_path, shape, planes):
    """chip_smoke.vp8l_write: Pillow decodes its file to the planes
    written, and the port reads it as the JAX reader does."""
    h, w = shape
    rng = np.random.default_rng(7)
    band = chip_smoke.webp_band(3, h, w)
    noise = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
    chans = {"gray band": (band, band, band, 255),
             "constant green": (band, 7, band, band),
             "all constant": (3, 4, 5, 255),
             "four varying": (noise[0], band, noise[1], band)}[planes]
    blob = chip_smoke.vp8l_write(chans, w, h)
    want = np.dstack([np.broadcast_to(np.asarray(p, np.uint8), (h, w))
                      for p in chans])
    with Image.open(io.BytesIO(blob)) as im:
        mode = im.mode
        got = np.asarray(im)
    assert mode == ("RGB" if isinstance(chans[3], int) else "RGBA")
    assert np.array_equal(got, want[..., :len(mode)])
    _equal_to_jax(_write(tmp_path, blob))


def test_vp8l_band_reads_as_written(tmp_path):
    """The webp phase's band at a small size: RasterReader gives the band
    written in each of its three bands, with the .wpw geotransform and the
    .prj's EPSG."""
    band = chip_smoke.webp_band(chip_smoke.WEBP_SEED, 96, 130)
    path = _write(tmp_path, chip_smoke.vp8l_write((band, band, band, 255),
                                                  130, 96), "band.webp")
    path.with_suffix(".wpw").write_text(
        "10.0\n0.0\n0.0\n-10.0\n500005.0\n5099995.0\n")
    path.with_suffix(".prj").write_text("EPSG:32632")
    got = _equal_to_jax(path)
    assert got.shape == (96, 130, 3)
    assert all(np.array_equal(got[..., k], band) for k in range(3))
    md = traster.RasterReader(path).metadata
    assert md.geotransform == [500000.0, 10.0, 0.0, 5100000.0, 0.0, -10.0]
    assert md.epsg == 32632
