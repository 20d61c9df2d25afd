"""JPEG reader: the image Pillow 12.1 opens from a JPEG file (its SOF
handler's modes, libjpeg-turbo 3.1.3's decode with Pillow's defaults),
decoded by the port's C++ library (`_native/rasterdec.cpp`, built at first
use).

Modes as Pillow's: one component "L", three "RGB", four "CMYK" (Pillow's
"CMYK;I" rawmode: the samples inverted, after libjpeg's YCCK -> CMYK where
an Adobe marker asks for it). Decoded bit-equal to Pillow: baseline,
extended and progressive Huffman frames (SOF0-2), arithmetic-coded
sequential and progressive frames (SOF9 / SOF10, DAC conditioning
included), and 8-bit lossless frames (SOF3: predictors 1-7, point
transforms, restarts, gray / RGB / CMYK samples, sub-sampled ones
replicated), with restart intervals and sampling factors up to 4, and
libjpeg-turbo's block smoothing of a progressive file whose first
coefficients are not all refined. Refused as RasterError, as Pillow
refuses them: samples other than 8 bits and layer counts other than 1, 3
or 4, lossless arithmetic (SOF11) and hierarchical frames, a lossless
frame of YCbCr or YCCK samples (libjpeg converts no colour there), DAC and
scan parameters libjpeg calls invalid, arithmetic-coded data past the 64
KiB blocks Pillow hands libjpeg (Pillow's "broken data stream"), and a
file cut short (Pillow's "image file is truncated"). EXIF orientation is
not applied, as Pillow does not apply it on open; Pillow's `info` holds no
strings for a JPEG, so the text is empty."""
from __future__ import annotations

from .. import _native
from ..errors import RasterError
from . import pixels

SIGNATURE = b"\xff\xd8\xff"
MODES = {1: "L", 3: "RGB", 4: "CMYK"}


def read(blob: bytes, cmyk: bool = False) -> pixels.Decoded:
    """`cmyk`: four components read as CMYK even where an Adobe marker says
    YCCK (Pillow's jpegmode "CMYK", which BLP files set)."""
    try:
        width, height, components = _native.jpeg_info(blob)
        pixels.check_size(width, height)
        out = _native.jpeg_decode(blob, width, height, components, cmyk)
    except (ValueError, RuntimeError) as e:
        raise RasterError(f"JPEG: {e}") from e
    return pixels.Decoded(MODES[components],
                          out[..., 0] if components == 1 else out)
