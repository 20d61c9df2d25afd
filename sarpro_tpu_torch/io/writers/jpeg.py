"""q100 JPEGs from the device's quantized DCT blocks (port of the 'dct'
layouts of sarpro_tpu/io/writers/jpeg.py:53-57 and :108-117): 4:4:4 synRGB
and grayscale.

The host pays entropy coding only, in the repository's native encoder
(native/jpegenc.cpp, which `sarpro_tpu_torch._native` builds at first use
with g++). There is no cv2 or PIL route.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ... import _native


def _require_native() -> None:
    if not _native.available():
        raise RuntimeError("the native JPEG encoder could not be built: "
                           "sarpro_tpu_torch._native needs g++ and "
                           "native/jpegenc.cpp")


def write_synrgb_jpeg_dct(output, cols: int, rows: int,
                          coeffs: np.ndarray) -> None:
    """Write (3, ceil(rows/8), ceil(cols/8), 8, 8) int16 Y/Cb/Cr blocks."""
    _require_native()
    blob = _native.jpeg_encode_coeffs444(coeffs[0], coeffs[1], coeffs[2],
                                         cols, rows)
    Path(output).write_bytes(blob)


def write_gray_jpeg_dct(output, cols: int, rows: int,
                        coeffs: np.ndarray) -> None:
    """Write (ceil(rows/8), ceil(cols/8), 8, 8) int16 luma blocks."""
    _require_native()
    Path(output).write_bytes(_native.jpeg_encode_coeffs_gray(coeffs, cols,
                                                             rows))
