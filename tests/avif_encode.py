"""AVIF files of 10- and 12-bit samples, written through Debian's libavif
0.11.1 (`libavif.so.15`: aom 3.6.0, rav1e 0.5.1, SVT-AV1 1.4.1) by ctypes.
Pillow's AVIF plugin writes 8-bit samples only, so the tests of deeper
samples (tests/test_torch_avif_depth.py) use the files this module wrote,
committed under tests/data/avif and tests/data/avif_band; they read the
committed bytes, and need no encoder.

`encode` takes the Y, U, V (and alpha) planes as integer arrays at the
sample depth and returns the file. Offsets are those of libavif 0.11.1's
`avifImage` (planes at byte 24, row bytes at 48, range at 16, alpha plane
at 64, its row bytes at 72, premultiplied at 80, CICP at 104) and
`avifEncoder` (codec 0, threads 4, speed 8, quantizers 24 to 36, tile
rows and columns 40 and 44);
`_check_layout` holds them to what libavif itself reports.

`set_ispe`, `set_tkhd` and `set_colr` edit a file's item sizes, track
sizes and `colr` box in place of re-encoding it. `oracle` loads the libavif
1.3.0 that Pillow bundles (`pillow.libs/libavif-*.so*`), whose avifImageScale
and avifImageYUVToRGB are what Pillow's decode runs after dav1d, so the
tests can hold the port's scaler and conversion to them on planes set by
hand (`oracle_scale`, `oracle_rgb`); its `avifImage` and `avifRGBImage`
offsets are held to what that library reports in `_check_oracle_layout`.

`encode_av1` codes frames with AV1 superres, which no encoder here writes
through libavif: it drives Debian's libaom 3.6.0 (`libaom.so.3`) through its
own API by ctypes, the words of `aom_codec_enc_cfg_t` it sets (CFG) and the
offsets of `aom_image_t` held to libaom's defaults in `_check_aom_layout`.
`splice_av1` puts such frames into a file libavif wrote for the same
planes, moving its `iloc`, `stco` and `stsz` entries to match.
"""
import ctypes
import glob
import os
import struct

import numpy as np

LIBRARY = "libavif.so.15"
# avifCodecChoice of libavif 0.11
CODECS = {"aom": 1, "rav1e": 4, "svt": 5}
# avifPixelFormat
LAYOUTS = {"4:4:4": 1, "4:2:2": 2, "4:2:0": 3, "4:0:0": 4}
# avifAddImageFlag: the one image of a still (a grid's cells included)
ADD_IMAGE_FLAG_SINGLE = 2
_lib = None


def available() -> bool:
    """Whether libavif 0.11's library can be loaded here."""
    try:
        _library()
    except OSError:
        return False
    return True


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(LIBRARY)
        vp, u32 = ctypes.c_void_p, ctypes.c_uint32
        lib.avifVersion.restype = ctypes.c_char_p
        lib.avifImageCreate.restype = vp
        lib.avifImageCreate.argtypes = [u32, u32, u32, u32]
        lib.avifImageAllocatePlanes.argtypes = [vp, u32]
        lib.avifImageDestroy.argtypes = [vp]
        lib.avifEncoderCreate.restype = vp
        lib.avifEncoderDestroy.argtypes = [vp]
        lib.avifEncoderWrite.argtypes = [vp, vp, vp]
        lib.avifEncoderAddImageGrid.argtypes = [vp, u32, u32, vp, u32]
        lib.avifEncoderAddImage.argtypes = [vp, vp, ctypes.c_uint64, u32]
        lib.avifEncoderFinish.argtypes = [vp, vp]
        lib.avifEncoderSetCodecSpecificOption.argtypes = [
            vp, ctypes.c_char_p, ctypes.c_char_p]
        lib.avifRWDataFree.argtypes = [vp]
        lib.avifResultToString.restype = ctypes.c_char_p
        _check_layout(lib)
        _lib = lib
    return _lib


def _check_layout(lib) -> None:
    """The struct offsets this module writes, against the library's own
    defaults (a 3 x 2 10-bit 4:2:0 image, a new encoder)."""
    assert lib.avifVersion() == b"0.11.1", lib.avifVersion()
    im = lib.avifImageCreate(3, 2, 10, LAYOUTS["4:2:0"])
    try:
        head = (ctypes.c_uint32 * 4).from_address(im)
        assert list(head) == [3, 2, 10, LAYOUTS["4:2:0"]]
        lib.avifImageAllocatePlanes(im, 0xFF)
        rows = (ctypes.c_uint32 * 3).from_address(im + 48)
        assert list(rows) == [6, 4, 4]
        assert ctypes.c_uint32.from_address(im + 72).value == 6
        assert ctypes.c_void_p.from_address(im + 64).value
    finally:
        lib.avifImageDestroy(im)
    enc = lib.avifEncoderCreate()
    try:
        assert list((ctypes.c_int32 * 4).from_address(enc)) == [0, 1, -1, 0]
        assert ctypes.c_uint64.from_address(enc + 16).value == 1  # timescale
        # quantizers, then tile rows and columns: all 0
        assert list((ctypes.c_int32 * 6).from_address(enc + 24)) == [0] * 6
    finally:
        lib.avifEncoderDestroy(enc)


def _fill(ptr: int, row_bytes: int, plane: np.ndarray, depth: int) -> None:
    rows, cols = plane.shape
    dtype = np.uint16 if depth > 8 else np.uint8
    buf = (ctypes.c_uint8 * (row_bytes * rows)).from_address(ptr)
    dst = np.frombuffer(buf, np.uint8).reshape(rows, row_bytes)
    src = np.ascontiguousarray(plane.astype(dtype)).view(np.uint8)
    dst[:, :src.shape[1]] = src


def _image(lib, y, u, v, alpha, depth, layout, full, matrix,
           premultiplied):
    """A new avifImage of planes `y`, `u`, `v` and `alpha` (see encode)."""
    rows, cols = y.shape
    for p in (y, u, v, alpha):
        if p is not None:
            assert p.min() >= 0 and p.max() < 1 << depth
    im = lib.avifImageCreate(cols, rows, depth, LAYOUTS[layout])
    ctypes.c_uint32.from_address(im + 16).value = 1 if full else 0
    for off, val in ((104, 1), (106, 13), (108, matrix)):
        ctypes.c_uint16.from_address(im + off).value = val
    lib.avifImageAllocatePlanes(im, 0xFF if alpha is not None else 1)
    planes = [y] if layout == "4:0:0" else [y, u, v]
    for i, plane in enumerate(planes):
        _fill(ctypes.c_void_p.from_address(im + 24 + 8 * i).value,
              ctypes.c_uint32.from_address(im + 48 + 4 * i).value,
              plane, depth)
    if alpha is not None:
        _fill(ctypes.c_void_p.from_address(im + 64).value,
              ctypes.c_uint32.from_address(im + 72).value, alpha, depth)
        ctypes.c_uint32.from_address(im + 80).value = int(premultiplied)
    return im


def _encoder(lib, codec, speed, quantizer, alpha_quantizer, tiles_log2,
             threads, options, timescale=1):
    """A new avifEncoder so set (see encode)."""
    enc = lib.avifEncoderCreate()
    aq = quantizer if alpha_quantizer is None else alpha_quantizer
    for off, val in ((0, CODECS[codec]), (4, threads), (8, speed),
                     (24, quantizer), (28, quantizer), (32, aq),
                     (36, aq), (40, tiles_log2[0]), (44, tiles_log2[1])):
        ctypes.c_int32.from_address(enc + off).value = val
    ctypes.c_uint64.from_address(enc + 16).value = timescale
    for key, val in (options or {}).items():
        lib.avifEncoderSetCodecSpecificOption(enc, key.encode(),
                                              str(val).encode())
    return enc


def _check(lib, res: int) -> None:
    if res != 0:
        raise RuntimeError(lib.avifResultToString(res).decode())


def _output(out) -> bytes:
    data = ctypes.c_void_p.from_buffer(out).value
    size = ctypes.c_size_t.from_buffer(out, 8).value
    return ctypes.string_at(data, size)


def encode(y: np.ndarray, u: np.ndarray = None, v: np.ndarray = None,
           alpha: np.ndarray = None, *, depth: int = 10,
           layout: str = "4:2:0", full: bool = True, matrix: int = 1,
           codec: str = "aom", speed: int = 6, quantizer: int = 20,
           alpha_quantizer: int = None, premultiplied: bool = False,
           tiles_log2: tuple = (0, 0), threads: int = 1,
           options: dict = None) -> bytes:
    """The AVIF file of planes `y`, `u`, `v` (none for 4:0:0) and `alpha`,
    each an integer array of `depth`-bit samples, with the BT.709
    primaries, sRGB transfer and `matrix`; `quantizer` the encoder's
    minimum and maximum quantizer (0: lossless), `tiles_log2` the log2 of
    the tile rows and columns, `options` aom's codec-specific options."""
    lib = _library()
    im = _image(lib, y, u, v, alpha, depth, layout, full, matrix,
                premultiplied)
    enc = _encoder(lib, codec, speed, quantizer, alpha_quantizer, tiles_log2,
                   threads, options)
    out = (ctypes.c_uint8 * 16)()
    try:
        _check(lib, lib.avifEncoderWrite(enc, im, out))
        return _output(out)
    finally:
        lib.avifRWDataFree(out)
        lib.avifEncoderDestroy(enc)
        lib.avifImageDestroy(im)


def encode_grid(cells: list, cols: int, rows: int, *, depth: int = 8,
                layout: str = "4:2:0", full: bool = True, matrix: int = 1,
                codec: str = "aom", speed: int = 6, quantizer: int = 20,
                alpha_quantizer: int = None, premultiplied: bool = False,
                threads: int = 1, options: dict = None) -> bytes:
    """The AVIF file of a `cols` x `rows` grid item: `cells` holds, in
    raster order, each cell's (y, u, v, alpha) planes as encode takes them
    (alpha None, or an alpha plane in every cell: an alpha grid beside the
    colour grid). libavif writes each cell as an `av01` item of its own,
    the grid as a `grid` item whose `dimg` references list them, and its
    output size as the cells' total."""
    lib = _library()
    assert len(cells) == cols * rows
    ims = [_image(lib, *cell, depth, layout, full, matrix, premultiplied)
           for cell in cells]
    enc = _encoder(lib, codec, speed, quantizer, alpha_quantizer, (0, 0),
                   threads, options)
    out = (ctypes.c_uint8 * 16)()
    try:
        arr = (ctypes.c_void_p * len(ims))(*ims)
        _check(lib, lib.avifEncoderAddImageGrid(enc, cols, rows, arr,
                                                ADD_IMAGE_FLAG_SINGLE))
        _check(lib, lib.avifEncoderFinish(enc, out))
        return _output(out)
    finally:
        lib.avifRWDataFree(out)
        lib.avifEncoderDestroy(enc)
        for im in ims:
            lib.avifImageDestroy(im)


def encode_sequence(frames: list, *, duration: int = 1, timescale: int = 30,
                    depth: int = 8, layout: str = "4:2:0", full: bool = True,
                    matrix: int = 1, codec: str = "aom", speed: int = 6,
                    quantizer: int = 20, alpha_quantizer: int = None,
                    premultiplied: bool = False, threads: int = 1,
                    options: dict = None) -> bytes:
    """The `avis` image sequence of `frames`, each a (y, u, v, alpha) of
    planes as encode takes them, each `duration` ticks of `timescale` long.
    libavif writes a `moov` with one track (two with alpha: the alpha
    track's `tref` `auxl` points at the colour track) and, for the first
    frame, the items of a still image beside it."""
    lib = _library()
    ims = [_image(lib, *f, depth, layout, full, matrix, premultiplied)
           for f in frames]
    enc = _encoder(lib, codec, speed, quantizer, alpha_quantizer, (0, 0),
                   threads, options, timescale)
    out = (ctypes.c_uint8 * 16)()
    try:
        for im in ims:
            _check(lib, lib.avifEncoderAddImage(enc, im, duration, 0))
        _check(lib, lib.avifEncoderFinish(enc, out))
        return _output(out)
    finally:
        lib.avifRWDataFree(out)
        lib.avifEncoderDestroy(enc)
        for im in ims:
            lib.avifImageDestroy(im)


# ---------------------------------------------------------------------------
# byte edits
# ---------------------------------------------------------------------------
def _boxes_of(blob: bytes, kind: bytes) -> list:
    """The payload offsets of every `kind` box in `blob`, found by its
    type and checked by its size field."""
    out, pos = [], 0
    while True:
        k = blob.find(kind, pos)
        if k < 4:
            return out
        size = struct.unpack(">I", blob[k - 4:k])[0]
        if 8 <= size <= len(blob) - k + 4:
            out.append(k + 4)
        pos = k + 1


def set_ispe(blob: bytes, width: int, height: int) -> bytes:
    """`blob` with every `ispe` property (the colour item's, its alpha
    item's and a grid's tiles') set to width x height."""
    b = bytearray(blob)
    for k in _boxes_of(blob, b"ispe"):
        struct.pack_into(">II", b, k + 4, width, height)
    return bytes(b)


def set_tkhd(blob: bytes, width: int, height: int) -> bytes:
    """`blob` with every track's `tkhd` size set to width x height (16.16
    fixed point, after the version 0 or 1 times)."""
    b = bytearray(blob)
    for k in _boxes_of(blob, b"tkhd"):
        at = k + (88 if b[k] == 1 else 76)
        struct.pack_into(">II", b, at, width << 16, height << 16)
    return bytes(b)


def set_colr(blob: bytes, matrix: int = None, full: bool = None,
             primaries: int = None) -> bytes:
    """`blob` with its first `colr` nclx box's matrix coefficients, range
    flag and colour primaries set where given."""
    b = bytearray(blob)
    k = blob.find(b"colrnclx") + 8
    assert k >= 8
    if primaries is not None:
        struct.pack_into(">H", b, k, primaries)
    if matrix is not None:
        struct.pack_into(">H", b, k + 4, matrix)
    if full is not None:
        b[k + 6] = (b[k + 6] & 0x7F) | (0x80 if full else 0)
    return bytes(b)


# ---------------------------------------------------------------------------
# Pillow's libavif 1.3.0 as an oracle
# ---------------------------------------------------------------------------
ORACLE_VERSION = b"1.3.0"
# avifRGBFormat
RGB, RGBA = 0, 1
_oracle = None


def oracle():
    """Pillow's own libavif (1.3.0, with libyuv built in), its layout
    checked; None where Pillow bundles none."""
    global _oracle
    if _oracle is None:
        import PIL
        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                            "pillow.libs")
        found = sorted(glob.glob(os.path.join(libs, "libavif-*.so*")))
        if not found:
            return None
        lib = ctypes.CDLL(found[0])
        vp, u32 = ctypes.c_void_p, ctypes.c_uint32
        lib.avifVersion.restype = ctypes.c_char_p
        lib.avifImageCreate.restype = vp
        lib.avifImageCreate.argtypes = [u32, u32, u32, u32]
        lib.avifImageAllocatePlanes.argtypes = [vp, u32]
        lib.avifImageDestroy.argtypes = [vp]
        lib.avifImageScale.argtypes = [vp, u32, u32, vp]
        lib.avifRGBImageSetDefaults.argtypes = [vp, vp]
        lib.avifImageYUVToRGB.argtypes = [vp, vp]
        _check_oracle_layout(lib)
        _oracle = lib
    return _oracle


def _check_oracle_layout(lib) -> None:
    """The avifImage and avifRGBImage offsets the oracle writes, against
    libavif 1.3.0's own defaults (a 3 x 2 10-bit 4:2:0 image)."""
    assert lib.avifVersion() == ORACLE_VERSION, lib.avifVersion()
    im = lib.avifImageCreate(3, 2, 10, LAYOUTS["4:2:0"])
    try:
        head = (ctypes.c_uint32 * 5).from_address(im)
        assert list(head) == [3, 2, 10, LAYOUTS["4:2:0"], 1]  # full range
        assert list((ctypes.c_uint16 * 3).from_address(im + 104)) == [2] * 3
        lib.avifImageAllocatePlanes(im, 0xFF)
        rows = (ctypes.c_uint32 * 3).from_address(im + 48)
        assert list(rows) == [6, 4, 4]
        assert ctypes.c_uint32.from_address(im + 72).value == 6
        assert ctypes.c_void_p.from_address(im + 64).value
        rgb = (ctypes.c_uint8 * 64)()
        lib.avifRGBImageSetDefaults(ctypes.addressof(rgb), im)
        # width, height, depth, RGBA; automatic chroma upsampling
        assert list((ctypes.c_uint32 * 5).from_buffer(rgb)) == [
            3, 2, 10, RGBA, 0]
        assert ctypes.c_void_p.from_buffer(rgb, 48).value is None
    finally:
        lib.avifImageDestroy(im)


def _oracle_image(lib, planes, depth, layout, full=True, matrix=1,
                  primaries=1, premultiplied=False):
    """A new avifImage of `planes` (Y, U, V, alpha; U and V None for 4:0:0,
    alpha None for none), each a 2-D array of `depth`-bit samples."""
    y, u, v, alpha = planes
    rows, cols = y.shape
    im = lib.avifImageCreate(cols, rows, depth, LAYOUTS[layout])
    ctypes.c_uint32.from_address(im + 16).value = int(full)
    for off, val in ((104, primaries), (106, 13), (108, matrix)):
        ctypes.c_uint16.from_address(im + off).value = val
    lib.avifImageAllocatePlanes(im, 1 | (2 if alpha is not None else 0))
    for i, plane in enumerate((y, u, v)):
        if plane is not None:
            _fill(ctypes.c_void_p.from_address(im + 24 + 8 * i).value,
                  ctypes.c_uint32.from_address(im + 48 + 4 * i).value,
                  plane, depth)
    if alpha is not None:
        _fill(ctypes.c_void_p.from_address(im + 64).value,
              ctypes.c_uint32.from_address(im + 72).value, alpha, depth)
        ctypes.c_uint32.from_address(im + 80).value = int(premultiplied)
    return im


def _read_plane(ptr: int, row_bytes: int, rows: int, cols: int,
                depth: int) -> np.ndarray:
    buf = (ctypes.c_uint8 * (row_bytes * rows)).from_address(ptr)
    a = np.frombuffer(buf, np.uint8).reshape(rows, row_bytes)
    a = a[:, :cols * (2 if depth > 8 else 1)]
    return (a.view(np.uint16) if depth > 8 else a).astype(np.uint16)


def oracle_scale(planes: tuple, width: int, height: int, depth: int,
                 layout: str) -> tuple:
    """avifImageScale of `planes` (as _oracle_image takes them) to width x
    height: (avifResult, the scaled planes, each u16 or None)."""
    lib = oracle()
    im = _oracle_image(lib, planes, depth, layout)
    try:
        diag = (ctypes.c_uint8 * 512)()
        res = lib.avifImageScale(im, width, height, ctypes.addressof(diag))
        if res:
            return res, None
        sx = 0 if layout == "4:4:4" else 1
        sy = 1 if layout in ("4:2:0", "4:0:0") else 0
        out = []
        for i in range(3):
            if planes[i] is None:
                out.append(None)
                continue
            cols = width if i == 0 else (width + sx) >> sx
            rows = height if i == 0 else (height + sy) >> sy
            out.append(_read_plane(
                ctypes.c_void_p.from_address(im + 24 + 8 * i).value,
                ctypes.c_uint32.from_address(im + 48 + 4 * i).value,
                rows, cols, depth))
        out.append(None if planes[3] is None else _read_plane(
            ctypes.c_void_p.from_address(im + 64).value,
            ctypes.c_uint32.from_address(im + 72).value, height, width,
            depth))
        return 0, tuple(out)
    finally:
        lib.avifImageDestroy(im)


def oracle_rgb(planes: tuple, depth: int, layout: str, full: bool,
               matrix: int, primaries: int = 1,
               premultiplied: bool = False) -> tuple:
    """avifImageYUVToRGB of `planes` (as _oracle_image takes them) into
    8-bit RGB, or RGBA where there is alpha, as Pillow asks for it:
    (avifResult, the (rows, cols, 3 or 4) u8 array)."""
    lib = oracle()
    im = _oracle_image(lib, planes, depth, layout, full, matrix, primaries,
                       premultiplied)
    try:
        rows, cols = planes[0].shape
        channels = 3 if planes[3] is None else 4
        out = np.zeros((rows, cols, channels), np.uint8)
        rgb = (ctypes.c_uint8 * 64)()
        lib.avifRGBImageSetDefaults(ctypes.addressof(rgb), im)
        ctypes.c_uint32.from_buffer(rgb, 8).value = 8
        ctypes.c_uint32.from_buffer(rgb, 12).value = \
            RGBA if channels == 4 else RGB
        ctypes.c_void_p.from_buffer(rgb, 48).value = out.ctypes.data
        ctypes.c_uint32.from_buffer(rgb, 56).value = out.strides[0]
        return lib.avifImageYUVToRGB(im, ctypes.addressof(rgb)), out
    finally:
        lib.avifImageDestroy(im)


# ---------------------------------------------------------------------------
# AV1 superres through libaom 3.6.0's own API
# ---------------------------------------------------------------------------
AOM_LIBRARY = "libaom.so.3"
# AOM_ENCODER_ABI_VERSION of libaom 3.6.0, and aom_codec_enc_init_ver's flag
# for samples of more than 8 bits
AOM_ABI_VERSION = 25
AOM_CODEC_USE_HIGHBITDEPTH = 0x40000
# aom_img_fmt_t: planar I420, I422, I444; the flag of 16-bit samples
AOM_FORMATS = {"4:2:0": 0x102, "4:2:2": 0x105, "4:4:4": 0x106,
               "4:0:0": 0x102}
AOM_IMG_FMT_HIGHBITDEPTH = 0x800
# the uint32 words of aom_codec_enc_cfg_t (aom_encoder.h) this module sets
CFG = {"g_usage": 0, "g_threads": 1, "g_profile": 2, "g_w": 3, "g_h": 4,
       "g_limit": 5, "g_bit_depth": 8, "g_input_bit_depth": 9,
       "g_timebase": 10, "g_lag_in_frames": 14, "rc_superres_mode": 19,
       "rc_superres_denominator": 20, "rc_superres_kf_denominator": 21,
       "rc_end_usage": 24, "rc_min_quantizer": 35, "rc_max_quantizer": 36,
       "kf_max_dist": 48, "monochrome": 52}
# aom_superres_mode AOM_SUPERRES_FIXED, aom_rc_mode AOM_Q, usages
AOM_SUPERRES_FIXED = 1
AOM_Q = 3
USAGES = {"good": 0, "allintra": 2}
_aom = None


def aom_available() -> bool:
    """Whether libaom 3.6.0's library can be loaded here."""
    try:
        _aom_library()
    except OSError:
        return False
    return True


def _aom_library():
    global _aom
    if _aom is None:
        lib = ctypes.CDLL(AOM_LIBRARY)
        vp, u32, err = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
        lib.aom_codec_version_str.restype = ctypes.c_char_p
        lib.aom_codec_version_str.argtypes = []
        lib.aom_codec_av1_cx.restype = vp
        lib.aom_codec_av1_cx.argtypes = []
        lib.aom_codec_enc_config_default.restype = err
        lib.aom_codec_enc_config_default.argtypes = [vp, vp, u32]
        lib.aom_codec_enc_init_ver.restype = err
        lib.aom_codec_enc_init_ver.argtypes = [vp, vp, vp, ctypes.c_long,
                                               ctypes.c_int]
        lib.aom_codec_set_option.restype = err
        lib.aom_codec_set_option.argtypes = [vp, ctypes.c_char_p,
                                             ctypes.c_char_p]
        lib.aom_codec_error_detail.restype = ctypes.c_char_p
        lib.aom_codec_error_detail.argtypes = [vp]
        lib.aom_img_alloc.restype = vp
        lib.aom_img_alloc.argtypes = [vp, ctypes.c_int, u32, u32, u32]
        lib.aom_img_free.restype = None
        lib.aom_img_free.argtypes = [vp]
        lib.aom_codec_encode.restype = err
        lib.aom_codec_encode.argtypes = [vp, vp, ctypes.c_int64,
                                         ctypes.c_ulong, ctypes.c_long]
        lib.aom_codec_get_cx_data.restype = vp
        lib.aom_codec_get_cx_data.argtypes = [vp, vp]
        lib.aom_codec_destroy.restype = err
        lib.aom_codec_destroy.argtypes = [vp]
        _check_aom_layout(lib)
        _aom = lib
    return _aom


def _check_aom_layout(lib) -> None:
    """The words of aom_codec_enc_cfg_t and the offsets of aom_image_t this
    module writes, against libaom's own defaults (the good and all-intra
    configurations, a 3 x 2 image of each format)."""
    assert lib.aom_codec_version_str() == b"v3.6.0"
    iface = lib.aom_codec_av1_cx()
    for usage, lag, end_usage in ((0, 35, 0), (2, 0, AOM_Q)):
        cfg = (ctypes.c_uint32 * 1024)()
        assert lib.aom_codec_enc_config_default(iface, cfg, usage) == 0
        want = {"g_usage": usage, "g_w": 320, "g_h": 240, "g_bit_depth": 8,
                "g_input_bit_depth": 8, "g_lag_in_frames": lag,
                "rc_superres_mode": 0, "rc_superres_denominator": 8,
                "rc_superres_kf_denominator": 8, "rc_end_usage": end_usage,
                "rc_min_quantizer": 0, "rc_max_quantizer": 63,
                "monochrome": 0}
        assert {k: cfg[CFG[k]] for k in want} == want, list(cfg[:60])
        assert list(cfg[CFG["g_timebase"]:CFG["g_timebase"] + 2]) == [1, 30]
        # the resize mode and denominators, the superres thresholds
        assert list(cfg[16:24]) == [0, 8, 8, 0, 8, 8, 63, 32]
    for layout, fmt in AOM_FORMATS.items():
        for high in (0, AOM_IMG_FMT_HIGHBITDEPTH):
            im = lib.aom_img_alloc(None, fmt | high, 3, 2, 32)
            try:
                words = (ctypes.c_uint32 * 16).from_address(im)
                assert words[0] == fmt | high
                shift = (1, 1) if fmt == 0x102 else (1, 0) \
                    if fmt == 0x105 else (0, 0)
                # w, h (aligned), bit depth, d_w, d_h, chroma shifts
                assert (words[9], words[10], words[11]) == (
                    16 if high else 8, 3, 2)
                assert (words[14], words[15]) == shift
                strides = (ctypes.c_int32 * 3).from_address(im + 88)
                assert strides[0] >= 3 * (2 if high else 1)
                assert all(ctypes.c_void_p.from_address(im + 64 + 8 * i).value
                           for i in range(3))
            finally:
                lib.aom_img_free(im)


def _aom_fail(lib, ctx, what: str):
    detail = lib.aom_codec_error_detail(ctx)
    raise RuntimeError(f"libaom: {what} failed"
                       + (f": {detail.decode()}" if detail else ""))


def encode_av1(frames: list, *, depth: int = 8, layout: str = "4:2:0",
               superres: int = 16, usage: str = "good", speed: int = 6,
               quantizer: int = 30, options: dict = None,
               threads: int = 1) -> list:
    """The AV1 data (temporal delimiter, sequence header, frame) of each of
    `frames` as libaom 3.6.0 codes them: each frame a (y, u, v) of integer
    planes at `depth` bits (u and v None for 4:0:0), coded with superres
    fixed at `superres` / 8 (key and other frames; 8: off) at `quantizer`
    (aom's Q mode, 0-63), `usage` "good" or "allintra", `options` aom's
    named options (aom_codec_set_option). One frame is a still picture
    (aom's reduced still picture header), more a sequence."""
    lib = _aom_library()
    iface = lib.aom_codec_av1_cx()
    rows, cols = frames[0][0].shape
    cfg = (ctypes.c_uint32 * 1024)()
    if lib.aom_codec_enc_config_default(iface, cfg, USAGES[usage]):
        raise RuntimeError("libaom: no default configuration")
    mono = layout == "4:0:0"
    profile = 2 if layout == "4:2:2" or depth == 12 else \
        1 if layout == "4:4:4" else 0
    for key, val in (("g_threads", threads), ("g_profile", profile),
                     ("g_w", cols), ("g_h", rows), ("g_limit", len(frames)),
                     ("g_bit_depth", depth), ("g_input_bit_depth", depth),
                     ("g_lag_in_frames", 0), ("rc_end_usage", AOM_Q),
                     ("rc_min_quantizer", quantizer),
                     ("rc_max_quantizer", quantizer), ("monochrome", mono),
                     ("rc_superres_mode",
                      AOM_SUPERRES_FIXED if superres != 8 else 0),
                     ("rc_superres_denominator", superres),
                     ("rc_superres_kf_denominator", superres)):
        cfg[CFG[key]] = val
    ctx = (ctypes.c_uint8 * 256)()
    if lib.aom_codec_enc_init_ver(
            ctx, iface, cfg, AOM_CODEC_USE_HIGHBITDEPTH if depth > 8 else 0,
            AOM_ABI_VERSION):
        _aom_fail(lib, ctx, "aom_codec_enc_init_ver")
    out = []
    try:
        for key, val in {"cpu-used": speed, "cq-level": quantizer,
                         **(options or {})}.items():
            if lib.aom_codec_set_option(ctx, key.encode(), str(val).encode()):
                _aom_fail(lib, ctx, f"option {key} {val}")
        fmt = AOM_FORMATS[layout] | (AOM_IMG_FMT_HIGHBITDEPTH
                                     if depth > 8 else 0)
        for pts, planes in enumerate(frames + [None]):
            im = None
            if planes is not None:
                im = lib.aom_img_alloc(None, fmt, cols, rows, 32)
                ctypes.c_int32.from_address(im + 16).value = int(mono)
                y, u, v = planes
                if mono:  # the chroma planes at the middle value
                    half = np.full(((rows + 1) // 2, (cols + 1) // 2),
                                   1 << (depth - 1))
                    u = v = half
                for i, plane in enumerate((y, u, v)):
                    assert plane.min() >= 0 and plane.max() < 1 << depth
                    _fill(ctypes.c_void_p.from_address(im + 64 + 8 * i).value,
                          ctypes.c_int32.from_address(im + 88 + 4 * i).value,
                          plane, 16 if depth > 8 else 8)
            try:
                if lib.aom_codec_encode(ctx, im, pts, 1, 0):
                    _aom_fail(lib, ctx, "aom_codec_encode")
            finally:
                if im is not None:
                    lib.aom_img_free(im)
            it = ctypes.c_void_p(0)
            while True:
                pkt = lib.aom_codec_get_cx_data(ctx, ctypes.byref(it))
                if not pkt:
                    break
                if ctypes.c_int32.from_address(pkt).value == 0:  # a frame
                    buf = ctypes.c_void_p.from_address(pkt + 8).value
                    size = ctypes.c_size_t.from_address(pkt + 16).value
                    out.append(ctypes.string_at(buf, size))
    finally:
        lib.aom_codec_destroy(ctx)
    assert len(out) == len(frames), len(out)
    return out


def _children(blob: bytes, start: int, end: int):
    """(type, payload start, end) of each box in blob[start:end]."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        head = 8
        if size == 1:
            size, head = struct.unpack(">Q", blob[pos + 8:pos + 16])[0], 16
        elif size == 0:
            size = end - pos
        yield kind, pos + head, pos + size
        pos += size


def _uint(blob: bytes, pos: int, size: int) -> int:
    return int.from_bytes(blob[pos:pos + size], "big") if size else 0


def _av1_fields(blob: bytes) -> list:
    """[(offset, length, offset fields [(position, size, base)], length
    fields [(position, size)])] of the AV1 data the file points at: each
    extent of an `av01` item (iloc, construction method 0) and each sample
    of a track (stco, stsc, stsz), an extent that an item and a sample
    share listed once, in the order of the file."""
    spans = {}

    def add(offset, length, field, size_field=None):
        spans.setdefault((offset, length), ([], []))
        spans[(offset, length)][0].append(field)
        if size_field is not None:
            spans[(offset, length)][1].append(size_field)

    top = {k: (a, z) for k, a, z in _children(blob, 0, len(blob))}
    if b"meta" in top:
        a, z = top[b"meta"]
        meta = {k: (p, q) for k, p, q in _children(blob, a + 4, z)}
        av01 = set()
        p, q = meta[b"iinf"]
        version = blob[p]
        p += 4 + (2 if version == 0 else 4)
        for k, ea, ez in _children(blob, p, q):
            v = blob[ea]
            idw = 2 if v < 3 else 4
            item = _uint(blob, ea + 4, idw)
            if blob[ea + 4 + idw + 2:ea + 4 + idw + 6] == b"av01":
                av01.add(item)
        p, _ = meta[b"iloc"]
        version = blob[p]
        osz, lsz = blob[p + 4] >> 4, blob[p + 4] & 15
        bsz, isz = blob[p + 5] >> 4, blob[p + 5] & 15 if version else 0
        idw = 4 if version == 2 else 2
        count = _uint(blob, p + 6, idw)
        p += 6 + idw
        for _ in range(count):
            item = _uint(blob, p, idw)
            p += idw
            method = _uint(blob, p, 2) & 15 if version else 0
            p += (2 if version else 0) + 2
            base = _uint(blob, p, bsz)
            p += bsz
            extents = _uint(blob, p, 2)
            p += 2
            for _ in range(extents):
                p += isz
                off, length = _uint(blob, p, osz), _uint(blob, p + osz, lsz)
                if item in av01 and method == 0:
                    add(base + off, length, (p, osz, base), (p + osz, lsz))
                p += osz + lsz
    if b"moov" in top:
        a, z = top[b"moov"]
        for kind, ta, tz in _children(blob, a, z):
            if kind != b"trak":
                continue
            stbl = (ta, tz)
            for path in (b"mdia", b"minf", b"stbl"):
                stbl = next((p, q) for k, p, q in _children(blob, *stbl)
                            if k == path)
            tables = {k: (p, q) for k, p, q in _children(blob, *stbl)}
            p = tables[b"stco"][0]
            chunks = [(p + 8 + 4 * i, _uint(blob, p + 8 + 4 * i, 4))
                      for i in range(_uint(blob, p + 4, 4))]
            p = tables[b"stsz"][0]
            assert _uint(blob, p + 4, 4) == 0  # one size a sample
            sizes = [(p + 12 + 4 * i, _uint(blob, p + 12 + 4 * i, 4))
                     for i in range(_uint(blob, p + 8, 4))]
            p = tables[b"stsc"][0]
            runs = [struct.unpack(">III", blob[p + 8 + 12 * i:p + 20 + 12 * i])
                    for i in range(_uint(blob, p + 4, 4))]
            sample = 0
            for c, (field, offset) in enumerate(chunks):
                per = [n for first, n, _ in runs if first <= c + 1][-1]
                for k in range(per):
                    pos, size = sizes[sample]
                    sample += 1
                    # a chunk's first sample moves its chunk offset
                    add(offset, size, (field, 4, 0) if k == 0 else None,
                        (pos, 4))
                    offset += size
    return [(o, n, [f for f in fields if f], lengths)
            for (o, n), (fields, lengths) in sorted(spans.items())]


def splice_av1(blob: bytes, payloads: list) -> bytes:
    """`blob`, a file libavif wrote, with the AV1 data of its `av01` items
    and track samples replaced by `payloads`, in the order of the file
    (libavif 0.11.1 writes an alpha image's tiles before the colour
    image's, each image's tiles in raster order, and a sequence's first
    sample where its still item's data is): the `mdat` rebuilt, each
    extent's offset and length in `iloc`, each chunk offset in `stco` and
    each sample size in `stsz` moved to match."""
    spans = _av1_fields(blob)
    assert len(spans) == len(payloads), (len(spans), len(payloads))
    kind, start, end = list(_children(blob, 0, len(blob)))[-1]
    # the last box, with a 32-bit size
    assert kind == b"mdat" and blob[start - 8:start - 4] == \
        (end - start + 8).to_bytes(4, "big")
    assert all(start <= o and o + n <= end for o, n, _, _ in spans)
    out = bytearray(blob[:start])
    pos = start
    moved = []
    for (o, n, fields, lengths), new in zip(spans, payloads):
        assert o >= pos, "overlapping AV1 data"
        out += blob[pos:o]
        moved.append((len(out), len(new), fields, lengths))
        out += new
        pos = o + n
    out += blob[pos:end]
    for at, n, fields, lengths in moved:
        for field, size, base in fields:
            out[field:field + size] = (at - base).to_bytes(size, "big")
        for field, size in lengths:
            out[field:field + size] = n.to_bytes(size, "big")
    out[start - 8:start - 4] = (len(out) - start + 8).to_bytes(4, "big")
    return bytes(out)
