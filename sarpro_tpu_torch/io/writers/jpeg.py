"""q100 JPEG writers (port of sarpro_tpu/io/writers/jpeg.py; reference:
src/io/writers/jpeg.rs:6-30, quality 100, 4:4:4).

Every writer codes in the repository's native encoder (native/jpegenc.cpp,
which `sarpro_tpu_torch._native` builds at first use with g++). There is no
cv2 or PIL route, and no writer falls back to another encoder: without the
native library each raises.
  * fast mode hands the device's quantized DCT blocks to the entropy-only
    entries (the 'dct' layouts of the JAX package's :53-57 and :108-117);
  * exact mode hands pixels to the pixel entries: `write_gray_jpeg` the u8
    plane, as the JAX package's does (:38-44); `write_rgb_jpeg` the planar
    YCbCr of the RGB image, converted on the tensor's device by
    `core.fused.ycbcr_planes`, where the JAX package goes to cv2 or
    Pillow (:60-77).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ... import _native
from ...core.fused import ycbcr_planes


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


def write_gray_jpeg(output, cols: int, rows: int, data) -> None:
    """A u8 plane (numpy array or tensor), coded on the host (reference:
    jpeg.rs:6-17)."""
    _require_native()
    arr = np.ascontiguousarray(torch.as_tensor(data).cpu().numpy()
                               .reshape(rows, cols), dtype=np.uint8)
    Path(output).write_bytes(_native.jpeg_encode_gray(arr))


def write_rgb_jpeg(output, cols: int, rows: int, rgb_data) -> None:
    """Interleaved RGB u8 (numpy array or tensor; reference: jpeg.rs:19-30)
    -> full-range JFIF YCbCr on the tensor's device -> the native 4:4:4
    pixel coder."""
    _require_native()
    rgb = torch.as_tensor(rgb_data).reshape(rows, cols, 3)
    planes = ycbcr_planes(rgb).cpu().numpy()
    Path(output).write_bytes(_native.jpeg_encode_ycbcr444(
        *(np.ascontiguousarray(p) for p in planes)))
