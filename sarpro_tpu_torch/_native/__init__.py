"""ctypes bindings for the native TIFF codec, box reducer and JPEG entropy
coder (a copy of the entries of sarpro_tpu/_native that the port calls;
only where the library comes from differs).

The port builds the library itself at first use, from the repository's
`native/tiffcodec.cpp` and `native/jpegenc.cpp` with `native/build.py`'s g++
command and flags, into `build/sarpro_tpu_torch/` below the checkout root.
The file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once. Where g++ or the sources are
missing, or the build fails, the module behaves as the JAX package's does
without its library: `available()` is False and the TIFF codec takes its
pure-Python paths.

The raster decoders (`rasterdec.cpp` beside this file: JPEG, the GIF LZW
stream and BMP RLE, for io/jpeg.py, io/gif.py and io/bmp.py; `j2kdec.cpp`
with its generated `ht_tables.h`: the JPEG 2000 codestream, Part-1 and
HTJ2K code-blocks, for io/jpeg2000.py; `webpdec.cpp`: a WebP frame's
VP8 / VP8L and ALPH chunks, for io/webp.py; `rledec.cpp`: the run-length
scanlines of SGI, TGA, PCX, Sun and PSD files and QOI's op stream, for
io/sgi.py, io/tga.py, io/pcx.py, io/sun.py, io/psd.py and io/qoi.py;
`bcndec.cpp`: the BC1-BC7 blocks of DDS and FTEX textures, for io/bcn.py;
`av1dec.cpp` with its generated `av1_tables.h`: AV1 still key frames, one
or a grid of tiles, with their alpha image's and their YUV-to-RGB(A)
conversion, for io/avif.py) build
the same way into one library of their own, at their first use, with FMA
contraction off so the 9/7 wavelet rounds as written. They have no
fallback: where that library cannot be built, `raster_decoder()` raises
with the compiler's message.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "sarpro_tpu_torch"
SOURCES = ("tiffcodec.cpp", "jpegenc.cpp")
# native/build.py's g++ command
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOAD_LOCK = threading.Lock()


def _compile(sources: list, stem: str, extra: tuple = (),
             headers: tuple = ()) -> tuple:
    """(path, None) of the library built from `sources` (which include
    `headers`) with CXX_FLAGS and `extra`, built first if needed; (None,
    why) where it cannot be built."""
    if not all(p.exists() for p in sources):
        return None, "missing sources: " + ", ".join(
            str(p) for p in sources if not p.exists())
    flags = (*CXX_FLAGS, *extra)
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in (*sources, *headers):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so, None
    cxx = shutil.which("g++")
    if cxx is None:
        return None, "g++ is not on the PATH"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run([cxx, *flags, *map(str, sources), "-o",
                              str(tmp)], capture_output=True, text=True)
        if res.returncode != 0:
            return None, (f"g++ failed ({res.returncode}): "
                          f"{res.stderr[-2000:]}")
        os.replace(tmp, so)  # atomic: a concurrent build never loads a part
    finally:
        tmp.unlink(missing_ok=True)
    return so, None


def _build() -> Optional[pathlib.Path]:
    """The codec library's path, built first if needed; None where it
    cannot be built."""
    so, why = _compile([NATIVE_DIR / name for name in SOURCES],
                       "libsarpro_codec")
    if so is None and why.startswith("g++ failed"):
        logging.getLogger("sarpro").warning("native codec build failed: %s",
                                            why)
    return so


def _load() -> Optional[ctypes.CDLL]:
    # the batch driver's loader threads reach this concurrently: one builds
    # and loads, the others wait for its result
    with _LOAD_LOCK:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    i64 = ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.packbits_decode.restype = i64
    lib.packbits_decode.argtypes = [u8p, i64, u8p, i64]
    lib.lzw_decode.restype = i64
    lib.lzw_decode.argtypes = [u8p, i64, u8p, i64]
    lib.decode_strips.restype = i64
    lib.decode_strips.argtypes = [u8p, i64p, i64p, u8p, i64p, i64p, i64,
                                  ctypes.c_int32, ctypes.c_int32]
    u16p = ctypes.POINTER(ctypes.c_uint16)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.box_reduce_u16_f32.restype = None
    lib.box_reduce_u16_f32.argtypes = [u16p, i64, i64, f32p, i64, i64, i64,
                                       i32p, i32p, i32p, i32p]
    lib.jpeg_encode_ycbcr444.restype = i64
    lib.jpeg_encode_ycbcr444.argtypes = [u8p, u8p, u8p, i64, i64, u8p, i64,
                                         ctypes.c_int32]
    lib.jpeg_encode_gray.restype = i64
    lib.jpeg_encode_gray.argtypes = [u8p, i64, i64, u8p, i64, ctypes.c_int32]
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.jpeg_encode_coeffs444.restype = i64
    lib.jpeg_encode_coeffs444.argtypes = [i16p, i16p, i16p, i64, i64, u8p,
                                          i64, ctypes.c_int32]
    lib.jpeg_encode_coeffs_gray.restype = i64
    lib.jpeg_encode_coeffs_gray.argtypes = [i16p, i64, i64, u8p, i64,
                                            ctypes.c_int32]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


RASTER_SOURCE = pathlib.Path(__file__).resolve().with_name("rasterdec.cpp")
J2K_SOURCE = RASTER_SOURCE.with_name("j2kdec.cpp")
WEBP_SOURCE = RASTER_SOURCE.with_name("webpdec.cpp")
RLE_SOURCE = RASTER_SOURCE.with_name("rledec.cpp")
BCN_SOURCE = RASTER_SOURCE.with_name("bcndec.cpp")
AV1_SOURCE = RASTER_SOURCE.with_name("av1dec.cpp")
AV1_TABLES = RASTER_SOURCE.with_name("av1_tables.h")
HT_TABLES = RASTER_SOURCE.with_name("ht_tables.h")
# the 9/7 wavelet and the ICT are float code: no FMA contraction
RASTER_FLAGS = ("-ffp-contract=off",)
_RASTER: Optional[ctypes.CDLL] = None
_RASTER_WHY: Optional[str] = None
_RASTER_LOCK = threading.Lock()


def raster_decoder() -> ctypes.CDLL:
    """The raster decoder library, built at first use; RuntimeError with
    the compiler's message where it cannot be built (tried once a
    process)."""
    global _RASTER, _RASTER_WHY
    sources = [RASTER_SOURCE, J2K_SOURCE, WEBP_SOURCE, RLE_SOURCE,
               BCN_SOURCE, AV1_SOURCE]
    with _RASTER_LOCK:
        if _RASTER is None and _RASTER_WHY is None:
            so, why = _compile(sources, "libsarpro_rasterdec", RASTER_FLAGS,
                               (AV1_TABLES, HT_TABLES))
            if so is None:
                _RASTER_WHY = why
            else:
                lib = ctypes.CDLL(str(so))
                i32, i64 = ctypes.c_int32, ctypes.c_int64
                u8p = ctypes.POINTER(ctypes.c_uint8)
                lib.jpeg_info.restype = i64
                lib.jpeg_info.argtypes = [u8p, i64, ctypes.POINTER(i64),
                                          ctypes.c_char_p, i64]
                lib.jpeg_decode.restype = i64
                lib.jpeg_decode.argtypes = [u8p, i64, u8p, i64, i32, i32,
                                            ctypes.c_char_p, i64]
                lib.gif_lzw_decode.restype = i64
                lib.gif_lzw_decode.argtypes = [u8p, i64, i32, i32, u8p, i64,
                                               i32, i32]
                lib.bmp_rle_decode.restype = i64
                lib.bmp_rle_decode.argtypes = [u8p, i64, i64, i32, i64, i32,
                                               u8p]
                lib.j2k_decode.restype = i64
                lib.j2k_decode.argtypes = [u8p, i64, i64, i64, i32,
                                           ctypes.POINTER(i32), i32, i32,
                                           ctypes.c_void_p, i32,
                                           ctypes.c_char_p, i64]
                lib.webp_decode.restype = i64
                lib.webp_decode.argtypes = [u8p, i64, i32, u8p, i64, i64, i64,
                                            u8p, i64, i32, ctypes.c_char_p,
                                            i64]
                lib.rle_lines.restype = i64
                lib.rle_lines.argtypes = [i32, u8p, i64, i64, i64, i32, i64,
                                          u8p]
                lib.sgi_rle_decode.restype = i64
                lib.sgi_rle_decode.argtypes = [u8p, i64, i64, i64, i32, i32,
                                               u8p]
                lib.bit_decode.restype = i64
                lib.bit_decode.argtypes = [u8p, i64, i32, i64, i64,
                                           ctypes.POINTER(ctypes.c_float)]
                lib.qoi_decode.restype = i64
                lib.qoi_decode.argtypes = [u8p, i64, i64, i32, u8p]
                lib.icns_rle.restype = i64
                lib.icns_rle.argtypes = [u8p, i64, i64, u8p]
                lib.msp_rle.restype = i64
                u16p = ctypes.POINTER(ctypes.c_uint16)
                lib.msp_rle.argtypes = [u8p, i64, u16p, i64, i64, u8p, i64]
                lib.fli_decode.restype = i64
                lib.fli_decode.argtypes = [u8p, i64, u8p, i64, i64,
                                           ctypes.POINTER(i32)]
                lib.xbm_decode.restype = i64
                lib.xbm_decode.argtypes = [u8p, i64, i64, i64, u8p]
                i32p = ctypes.POINTER(i32)
                lib.av1_decode_grid.restype = i64
                lib.av1_decode_grid.argtypes = [
                    ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(i64),
                    i32p, i32p, i32, i32, i32, i32, i32, u8p, i64,
                    ctypes.c_char_p, i64]
                lib.av1_frame_info.restype = i64
                lib.av1_frame_info.argtypes = [u8p, i64, i32p,
                                               ctypes.c_char_p, i64]
                lib.av1_scale_plane.restype = None
                lib.av1_scale_plane.argtypes = [u16p, i32, i32, u16p, i32,
                                                i32, i32]
                lib.av1_convert_planes.restype = i64
                lib.av1_convert_planes.argtypes = [
                    ctypes.POINTER(ctypes.c_void_p)] + [i32] * 10 + [
                    u8p, i64, ctypes.c_char_p, i64]
                lib.bcn_decode.restype = i64
                lib.bcn_decode.argtypes = [u8p, i64, i64, i64, i32, i32, u8p,
                                           i32]
                _RASTER = lib
        if _RASTER is None:
            raise RuntimeError(
                "the raster decoder library ("
                + ", ".join(p.name for p in sources)
                + f") could not be built: {_RASTER_WHY}")
        return _RASTER


def _threads() -> int:
    return min(os.cpu_count() or 1, 16)


def jpeg_info(blob: bytes) -> tuple:
    """(width, height, components) of a JPEG's frame header; ValueError
    with the decoder's reason where it has none."""
    lib = raster_decoder()
    src = np.frombuffer(blob, np.uint8)
    info = (ctypes.c_int64 * 3)()
    err = ctypes.create_string_buffer(512)
    if lib.jpeg_info(_u8p(src), len(blob), info, err, len(err)) != 0:
        raise ValueError(err.value.decode("latin-1"))
    return info[0], info[1], info[2]


def jpeg_decode(blob: bytes, width: int, height: int,
                components: int, cmyk: bool = False) -> np.ndarray:
    """The (height, width, components) u8 decode of a JPEG whose frame
    header `jpeg_info` read; ValueError with the decoder's reason. The file
    is handed over 64 KiB at a time, as Pillow reads it: libjpeg's
    arithmetic decoder cannot wait for more, so arithmetic-coded data past
    a block is refused as Pillow refuses it. `cmyk`: four components are
    CMYK samples whatever an Adobe marker says (Pillow's jpegmode "CMYK")."""
    lib = raster_decoder()
    src = np.frombuffer(blob, np.uint8)
    out = np.empty((height, width, components), np.uint8)
    err = ctypes.create_string_buffer(512)
    if lib.jpeg_decode(_u8p(src), len(blob), _u8p(out), out.size,
                       _threads(), int(cmyk), err, len(err)) != 0:
        raise ValueError(err.value.decode("latin-1"))
    return out


def j2k_decode(code: bytes, width: int, height: int, chan_comp: tuple,
               bits: int, ycc: bool) -> np.ndarray:
    """The (height, width, len(chan_comp)) image (u8 for `bits` 8, u16 for
    16) Pillow unpacks from a JPEG 2000 codestream: channel k from
    component chan_comp[k] (-1: 0xFF), channels 0-2 taken from YCbCr to
    RGB with `ycc` (Pillow's sYCC unpackers); ValueError with the
    decoder's reason."""
    lib = raster_decoder()
    src = np.frombuffer(code, np.uint8)
    out = np.zeros((height, width, len(chan_comp)),
                   np.uint8 if bits == 8 else np.uint16)
    comps = (ctypes.c_int32 * len(chan_comp))(*chan_comp)
    err = ctypes.create_string_buffer(512)
    if lib.j2k_decode(_u8p(src), len(code), width, height, len(chan_comp),
                      comps, bits, int(ycc), out.ctypes.data, _threads(), err,
                      len(err)) != 0:
        raise ValueError(err.value.decode("latin-1"))
    return out


def webp_decode(image: memoryview, lossless: bool, alpha, window: np.ndarray
                ) -> None:
    """One WebP frame into `window`, a (height, width, 3 or 4) u8 view of
    the canvas with C-contiguous pixels (RGB or RGBA): `image` the VP8 /
    VP8L chunk's payload to the frame's end, `alpha` the ALPH chunk's
    payload or None; ValueError with the decoder's reason."""
    lib = raster_decoder()
    h, w, channels = window.shape
    assert window.dtype == np.uint8 and window.strides[1:] == (channels, 1)
    src = np.frombuffer(image, np.uint8)
    alp = np.frombuffer(alpha if alpha is not None else b"\0", np.uint8)
    err = ctypes.create_string_buffer(512)
    if lib.webp_decode(_u8p(src), len(src), int(lossless), _u8p(alp),
                       -1 if alpha is None else len(alpha), w, h,
                       window.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       window.strides[0], channels, err, len(err)) != 0:
        raise ValueError(err.value.decode("latin-1"))


def av1_decode(obus: bytes, width: int, height: int, matrix: int,
               full_range: int, alpha: Optional[bytes] = None,
               premultiplied: bool = False, primaries: int = -1
               ) -> np.ndarray:
    """The (height, width, 3) u8 RGB image of an AV1 still key frame (an
    AVIF item's OBUs) as libavif converts it for Pillow, or (height, width,
    4) RGBA with `alpha`, the OBUs of its alpha item (unpremultiplied where
    `premultiplied`): the frame scaled to width x height where it has
    another size, `matrix`, `full_range` and `primaries` the `colr` nclx
    box's matrix coefficients, range flag and colour primaries (-1: the
    sequence header's). ValueError with the decoder's reason."""
    single = ((obus,), 0, 1, 1, width, height, width, height)
    return av1_decode_grid(single, None if alpha is None else (
        (alpha,), *single[1:]), matrix, full_range, premultiplied, primaries)


def av1_decode_grid(color: tuple, alpha: Optional[tuple], matrix: int,
                    full_range: int, premultiplied: bool = False,
                    primaries: int = -1) -> np.ndarray:
    """av1_decode of images that may be grids: `color` and `alpha` (None:
    no alpha) each (tiles, grid, columns, rows, tile width, tile height,
    width, height): the AV1 data of each tile in raster order, whether it
    is a grid item (0: an item of one tile), its tiles' layout and the size
    each tile's frame is scaled to (its `ispe`), and the image's size. The
    tiles decode on up to 16 threads into the image's planes, cropped at
    its right and bottom edges, and the image is converted as av1_decode
    converts a frame. The (height, width, 3 or 4) u8 RGB(A) image of the
    colour image's size; ValueError with the decoder's reason."""
    lib = raster_decoder()
    images = [color] + ([alpha] if alpha is not None else [])
    tiles = [np.frombuffer(t, np.uint8) for im in images for t in im[0]]
    ptrs = (ctypes.c_void_p * len(tiles))(*[t.ctypes.data for t in tiles])
    sizes = (ctypes.c_int64 * len(tiles))(*[t.size for t in tiles])
    geometry = [(ctypes.c_int32 * 7)(*im[1:]) for im in images]
    none = (ctypes.c_int32 * 7)(0, 0, 1, 0, 0, 0, 0)
    width, height = color[6], color[7]
    out = np.empty((height, width, 3 if alpha is None else 4), np.uint8)
    err = ctypes.create_string_buffer(512)
    if lib.av1_decode_grid(ptrs, sizes, geometry[0],
                           geometry[1] if alpha is not None else none, matrix,
                           primaries, full_range, int(premultiplied),
                           _threads(),
                           _u8p(out), out.strides[0], err, len(err)) != 0:
        raise ValueError(err.value.decode("latin-1"))
    return out


AV1_FRAME_INFO = ("width", "coded_width", "height", "superres_denominator",
                  "tile_cols", "tile_rows", "lr_type", "lr_size",
                  "lr_units", "cdef", "deblocking", "grain", "clip_bit",
                  "mono", "sb128", "q_bit")


def av1_frame_info(obus: bytes) -> dict:
    """What av1dec.cpp's own parse makes of the frame in `obus` (its
    tiles decoded, no filter run): AV1_FRAME_INFO's keys, `lr_type` and
    `lr_size` each plane's restoration type (0 none, 1 Wiener, 2
    self-guided, 3 switchable) and unit size, `lr_units` the units of all
    planes that take none, Wiener and self-guided, `superres_denominator`
    8 where superres is off, `clip_bit` the bit offset of the film grain's
    clip_to_restricted_range in `obus` (-1: none), `q_bit` that of
    base_q_idx; ValueError with the decoder's reason."""
    lib = raster_decoder()
    src = np.frombuffer(obus, np.uint8)
    out = (ctypes.c_int32 * 22)()
    err = ctypes.create_string_buffer(512)
    if lib.av1_frame_info(_u8p(src), len(obus), out, err, len(err)) != 0:
        raise ValueError(err.value.decode("latin-1"))
    v = list(out)
    return dict(zip(AV1_FRAME_INFO, v[:6] + [tuple(v[6:9]), tuple(v[9:12]),
                                             tuple(v[12:15])] + v[15:]))


def av1_scale_plane(plane: np.ndarray, width: int, height: int,
                    depth: int) -> np.ndarray:
    """av1dec.cpp's scaler alone (libavif's avifImageScale of one plane):
    the 2-D array of `depth`-bit samples `plane` scaled to (height, width),
    as u16."""
    lib = raster_decoder()
    src = np.ascontiguousarray(plane, np.uint16)
    out = np.empty((height, width), np.uint16)
    lib.av1_scale_plane(_u16p(src), src.shape[1], src.shape[0], _u16p(out),
                        width, height, depth)
    return out


def av1_convert_planes(y: np.ndarray, u: Optional[np.ndarray],
                       v: Optional[np.ndarray], alpha: Optional[np.ndarray],
                       depth: int, subsampling: tuple, matrix: int,
                       primaries: int, full_range: bool,
                       premultiplied: bool = False) -> np.ndarray:
    """av1dec.cpp's conversion alone: the planes of `depth`-bit samples of
    an image (u and v None: monochrome; else chroma subsampled by
    `subsampling`, (x, y) shifts; alpha None or full range) into (height,
    width, 3 or 4) u8 RGB(A) as libavif converts them for Pillow;
    ValueError with libavif's refusal."""
    lib = raster_decoder()
    planes = [None if p is None else np.ascontiguousarray(p, np.uint16)
              for p in (y, u, v, alpha)]
    ptrs = (ctypes.c_void_p * 4)(*[None if p is None else p.ctypes.data
                                   for p in planes])
    h, w = y.shape
    out = np.empty((h, w, 3 if alpha is None else 4), np.uint8)
    err = ctypes.create_string_buffer(512)
    if lib.av1_convert_planes(ptrs, w, h, depth, int(u is None),
                              *subsampling, matrix, primaries,
                              int(full_range), int(premultiplied), _u8p(out),
                              out.strides[0], err, len(err)) != 0:
        raise ValueError(err.value.decode("latin-1"))
    return out


def gif_lzw_decode(blob: bytes, offset: int, bits: int, interlace: bool,
                   image: np.ndarray, x0: int, y0: int, w: int,
                   h: int) -> None:
    """The LZW data of a GIF frame (sub-blocks from `offset`) into the
    (w, h) window at (x0, y0) of `image`, a C-contiguous 2-D u8 array;
    ValueError where the data runs out or holds a bad code."""
    lib = raster_decoder()
    assert image.dtype == np.uint8 and image.flags.c_contiguous
    src = np.frombuffer(blob, np.uint8)[offset:]
    window = image[y0:, x0:]
    rc = lib.gif_lzw_decode(_u8p(src), len(src), bits, int(interlace),
                            _u8p(window), image.shape[1], w, h)
    if rc == -1:
        raise ValueError("image file is truncated")
    if rc < 0:
        raise ValueError("broken LZW data in GIF frame")


def bmp_rle_decode(blob: bytes, offset: int, xsize: int, dest_length: int,
                   rle4: bool) -> tuple:
    """(bytes, length): the first `dest_length` bytes Pillow's BMP RLE
    decoder expands from `offset`, and the length its data reaches;
    ValueError where it fails to read a delta record."""
    lib = raster_decoder()
    src = np.frombuffer(blob, np.uint8)
    out = np.zeros(dest_length, np.uint8)
    n = lib.bmp_rle_decode(_u8p(src), len(blob), offset, xsize, dest_length,
                           int(rle4), _u8p(out))
    if n < 0:
        raise ValueError("not enough values to unpack (expected 2)")
    return out, n


RLE_KINDS = {"tga": 0, "pcx": 1, "sun": 2, "packbits": 3}


def rle_lines(kind: str, blob, offset: int, linebytes: int, rows: int,
              depth: int = 1, xsize: int = 0) -> tuple:
    """(lines, count): the (rows, linebytes) u8 scanlines Pillow's `kind`
    decoder ("tga", "pcx", "sun" or "packbits") expands from blob[offset:],
    in the order it decodes them, and how many of them the data completes;
    ValueError where the decoder overruns its line."""
    lib = raster_decoder()
    src = np.frombuffer(blob, np.uint8)[max(0, offset):]
    out = np.zeros((max(0, rows), max(0, linebytes)), np.uint8)
    n = lib.rle_lines(RLE_KINDS[kind], _u8p(src), len(src), linebytes, rows,
                      depth, xsize, _u8p(out))
    if n < 0:
        raise ValueError("buffer overrun when reading image file")
    return out, int(n)


def sgi_rle_decode(blob, xsize: int, ysize: int, bands: int,
                   bpc: int) -> np.ndarray:
    """The (ysize, xsize * bands * bpc) line buffers of Pillow's SGI RLE
    decoder over the file `blob`, in the order of its tables (bottom row
    first); ValueError where it overruns."""
    lib = raster_decoder()
    src = np.frombuffer(blob, np.uint8)[512:]
    out = np.zeros((ysize, xsize * bands * bpc), np.uint8)
    if lib.sgi_rle_decode(_u8p(src), len(blob) - 512, xsize, ysize, bands,
                          bpc, _u8p(out)) < 0:
        raise ValueError("buffer overrun when reading image file")
    return out


def bit_decode(blob, offset: int, bits: int, xsize: int,
               rows: int) -> tuple:
    """(lines, count): the (rows, xsize) float32 samples Pillow's bit decoder
    (fill 3, pad 8) unpacks from blob[offset:], in the order it decodes
    them, and how many lines the data completes."""
    lib = raster_decoder()
    src = np.frombuffer(blob, np.uint8)[max(0, offset):]
    out = np.zeros((rows, xsize), np.float32)
    n = lib.bit_decode(_u8p(src), len(src), bits, xsize, rows,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out, int(n)


def qoi_decode(blob, offset: int, pixels: int, bands: int) -> np.ndarray:
    """The `pixels` x `bands` u8 samples of Pillow's QOI decoder from
    blob[offset:]; ValueError where it reads past the data."""
    lib = raster_decoder()
    src = np.frombuffer(blob, np.uint8)[offset:]
    out = np.zeros(pixels * bands, np.uint8)
    if lib.qoi_decode(_u8p(src), len(src), pixels, bands, _u8p(out)) < 0:
        raise ValueError("the QOI data ends before the image does")
    return out


def bcn_decode(data, width: int, height: int, n: int, signed: bool,
               bands: int) -> tuple:
    """(image, complete): the (height, width[, bands]) u8 image of Pillow's
    bcn decoder over `data` (format n, 1..7, of `bands` bands; `signed`:
    BC5S / BC6HS), and whether the data held every block row (rows past it
    stay 0)."""
    lib = raster_decoder()
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((height, width, bands), np.uint8)
    rows = lib.bcn_decode(_u8p(src), len(src), width, height, n, int(signed),
                          _u8p(out), _threads())
    return (out[..., 0] if bands == 1 else out), rows == (height + 3) // 4


def icns_rle(blob, offset: int, count: int) -> tuple:
    """(channel, end): the `count` bytes of an ICNS run-length channel from
    blob[offset:] and the offset after it; ValueError where Pillow's
    read_32 fails on it."""
    lib = raster_decoder()
    src = np.frombuffer(blob, np.uint8)[offset:]
    out = np.zeros(count, np.uint8)
    n = lib.icns_rle(_u8p(src), len(src), count, _u8p(out))
    if n < 0:
        raise ValueError("Error reading channel")
    return out, offset + int(n)


def msp_rle(blob, offset: int, rowlen: np.ndarray, linebytes: int,
            cap: int) -> tuple:
    """(stream, length): the first `cap` bytes of MspDecoder's stream from
    blob[offset:] under the row map `rowlen`, and the stream's length;
    ValueError with Pillow's reason where a row or a run is cut short."""
    lib = raster_decoder()
    src = np.frombuffer(blob, np.uint8)[offset:]
    rows = np.ascontiguousarray(rowlen, np.uint16)
    out = np.zeros(cap, np.uint8)
    n = lib.msp_rle(_u8p(src), len(src), rows.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint16)), len(rows), linebytes, _u8p(out),
        cap)
    if n == -1:
        raise ValueError("Truncated MSP file")
    if n < 0:
        raise ValueError("Corrupted MSP file")
    return out, int(n)


def fli_decode(buf: bytes, image: np.ndarray) -> tuple:
    """(status, err) of one call of Pillow's fli decoder on `buf` into the
    C-contiguous (ysize, xsize) u8 `image`: bytes consumed (>= 0, it waits
    for more) or -1 with err 0 (done) or Pillow's negative error code."""
    lib = raster_decoder()
    assert image.dtype == np.uint8 and image.flags.c_contiguous
    src = np.frombuffer(buf, np.uint8)
    err = ctypes.c_int32(0)
    n = lib.fli_decode(_u8p(src), len(src), _u8p(image), image.shape[1],
                       image.shape[0], ctypes.byref(err))
    return int(n), err.value


def xbm_decode(blob, offset: int, linebytes: int, rows: int) -> tuple:
    """(lines, count): XbmDecode's (rows, linebytes) bytes from
    blob[offset:] and the number of lines the data completes."""
    lib = raster_decoder()
    src = np.frombuffer(blob, np.uint8)[offset:]
    out = np.zeros((rows, linebytes), np.uint8)
    n = lib.xbm_decode(_u8p(src), len(src), linebytes, rows, _u8p(out))
    return out, int(n)


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u16p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def _i64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def lzw_decode(blob: bytes, out_cap: int) -> bytes:
    lib = _load()
    src = np.frombuffer(blob, np.uint8)
    dst = np.empty(out_cap, np.uint8)
    n = lib.lzw_decode(_u8p(src), len(blob), _u8p(dst), out_cap)
    if n < 0:
        raise ValueError("corrupt LZW stream")
    return dst[:n].tobytes()


def packbits_decode(blob: bytes, out_cap: int) -> bytes:
    lib = _load()
    src = np.frombuffer(blob, np.uint8)
    dst = np.empty(out_cap, np.uint8)
    n = lib.packbits_decode(_u8p(src), len(blob), _u8p(dst), out_cap)
    if n < 0:
        raise ValueError("corrupt PackBits stream")
    return dst[:n].tobytes()


def decode_strips(
    blobs: list[bytes], dst: np.ndarray, dst_offsets: np.ndarray,
    dst_lengths: np.ndarray, compression: int, n_threads: int = 0,
) -> None:
    """Decode many strips in parallel into a preallocated byte buffer."""
    lib = _load()
    srcs = np.frombuffer(b"".join(blobs), np.uint8)
    offsets = np.zeros(len(blobs), np.int64)
    lengths = np.array([len(b) for b in blobs], np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    rc = lib.decode_strips(
        _u8p(srcs), _i64p(offsets), _i64p(lengths),
        _u8p(dst), _i64p(np.ascontiguousarray(dst_offsets, np.int64)),
        _i64p(np.ascontiguousarray(dst_lengths, np.int64)),
        len(blobs), compression, n_threads,
    )
    if rc != 0:
        raise ValueError(f"strip {rc - 1} failed to decode")


def box_reduce_u16(
    src: np.ndarray, out: np.ndarray, oy0: int, oy1: int,
    ys: np.ndarray, yc: np.ndarray, xs: np.ndarray, xc: np.ndarray,
    src_row0: int = 0,
) -> None:
    """Box-average output rows [oy0, oy1) from a u16 source chunk whose first
    row is global row `src_row0`. `out` holds (oy1-oy0, out_cols) float32."""
    lib = _load()
    assert src.dtype == np.uint16 and src.flags.c_contiguous
    assert out.dtype == np.float32 and out.flags.c_contiguous
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.box_reduce_u16_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        src_row0, src.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        oy0, oy1, out.shape[1],
        ys.ctypes.data_as(i32), yc.ctypes.data_as(i32),
        xs.ctypes.data_as(i32), xc.ctypes.data_as(i32),
    )


def coder_threads(h: int, n_threads: int = 0) -> int:
    """The thread count to hand the JPEG entropy coder for an image `h`
    pixels tall, given a requested count (0: the host's cores, at most 16).

    The coder cuts the ceil(h / 8) MCU rows into bands = min(threads, rows)
    bands of ceil(rows / bands) rows and never drops a band that starts at or
    past the last row: one past it asks for a negative buffer and aborts the
    process, one at it ends the stream in stray restart markers. With
    ceil(rows / ceil(rows / n)) threads every band starts inside the image;
    where n's own split has no such band this is n itself, so the stream is
    the one n gives."""
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    rows = max(-(-h // 8), 1)
    return -(-rows // -(-rows // n_threads))


def jpeg_encode_coeffs444(cy: np.ndarray, ccb: np.ndarray, ccr: np.ndarray,
                          w: int, h: int, n_threads: int = 0) -> bytes:
    """Pre-quantized device DCT coefficients → baseline JPEG q100 4:4:4.

    Each component is an int16 array of ceil(h/8)*ceil(w/8) consecutive
    64-coeff blocks in block raster order (transposed 8x8 per block — the
    layout the fused program's in-graph FDCT emits). The host pays entropy
    coding only."""
    lib = _load()
    nblocks = ((h + 7) // 8) * ((w + 7) // 8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    comps = []
    for p in (cy, ccb, ccr):
        p = np.ascontiguousarray(p, np.int16).reshape(-1)
        if p.size != nblocks * 64:
            raise ValueError(
                f"coefficient plane has {p.size} values, expected "
                f"{nblocks * 64} for {w}x{h}")
        comps.append(p)
    cap = w * h * 3 * 5 + (1 << 16)
    out = np.empty(cap, np.uint8)
    n = lib.jpeg_encode_coeffs444(
        comps[0].ctypes.data_as(i16p), comps[1].ctypes.data_as(i16p),
        comps[2].ctypes.data_as(i16p), w, h, _u8p(out), cap,
        coder_threads(h, n_threads))
    if n < 0:
        raise ValueError("jpeg encode overflow")
    return out[:n].tobytes()


def jpeg_encode_coeffs_gray(cy: np.ndarray, w: int, h: int,
                            n_threads: int = 0) -> bytes:
    """Pre-quantized device DCT coefficients → baseline grayscale JPEG q100."""
    lib = _load()
    nblocks = ((h + 7) // 8) * ((w + 7) // 8)
    cy = np.ascontiguousarray(cy, np.int16).reshape(-1)
    if cy.size != nblocks * 64:
        raise ValueError(f"coefficient plane has {cy.size} values, expected "
                         f"{nblocks * 64} for {w}x{h}")
    cap = w * h * 5 + (1 << 16)
    out = np.empty(cap, np.uint8)
    n = lib.jpeg_encode_coeffs_gray(
        cy.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), w, h,
        _u8p(out), cap, coder_threads(h, n_threads))
    if n < 0:
        raise ValueError("jpeg encode overflow")
    return out[:n].tobytes()


def jpeg_encode_ycbcr444(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                         n_threads: int = 0) -> bytes:
    """Planar full-range YCbCr u8 -> baseline JPEG q100 4:4:4 bytes (the
    coder's own level shift, FDCT and quantization on the host)."""
    lib = _load()
    h, w = y.shape
    for p in (y, cb, cr):
        if p.dtype != np.uint8 or not p.flags.c_contiguous or p.shape != (h, w):
            raise ValueError("YCbCr planes must be C-contiguous uint8 of one "
                             "shape")
    # worst case ~27 bits/coeff + stuffing per component: 5 bytes/px/comp
    cap = w * h * 3 * 5 + (1 << 16)
    out = np.empty(cap, np.uint8)
    n = lib.jpeg_encode_ycbcr444(_u8p(y), _u8p(cb), _u8p(cr), w, h,
                                 _u8p(out), cap, coder_threads(h, n_threads))
    if n < 0:
        raise ValueError("jpeg encode overflow")
    return out[:n].tobytes()


def jpeg_encode_gray(y: np.ndarray, n_threads: int = 0) -> bytes:
    """u8 plane -> baseline grayscale JPEG q100 bytes."""
    lib = _load()
    h, w = y.shape
    if y.dtype != np.uint8 or not y.flags.c_contiguous:
        raise ValueError("the gray plane must be C-contiguous uint8")
    cap = w * h * 5 + (1 << 16)
    out = np.empty(cap, np.uint8)
    n = lib.jpeg_encode_gray(_u8p(y), w, h, _u8p(out), cap,
                             coder_threads(h, n_threads))
    if n < 0:
        raise ValueError("jpeg encode overflow")
    return out[:n].tobytes()
