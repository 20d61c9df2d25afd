"""q100 4:4:4 JPEG from the device's quantized DCT blocks (port of the 'dct'
layout of sarpro_tpu/io/writers/jpeg.py:108-117).

The host pays entropy coding only, in the repository's native encoder
(native/jpegenc.cpp, built by `python native/build.py`). There is no
cv2 or PIL route.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from sarpro_tpu import _native


def write_synrgb_jpeg_dct(output, cols: int, rows: int,
                          coeffs: np.ndarray) -> None:
    """Write (3, ceil(rows/8), ceil(cols/8), 8, 8) int16 Y/Cb/Cr blocks."""
    if not _native.available():
        raise RuntimeError("the native JPEG encoder is not built; run "
                           "`python native/build.py`")
    blob = _native.jpeg_encode_coeffs444(coeffs[0], coeffs[1], coeffs[2],
                                         cols, rows)
    Path(output).write_bytes(blob)
