"""WebP reader: the image Pillow 12.1 opens from a .webp file (its
WebPImagePlugin, which always goes through libwebp 1.6.0's
WebPAnimDecoder), decoded by the port's C++ library (`_native/webpdec.cpp`,
built at first use).

Accepted as Pillow accepts it: `RIFF`, then `WEBP`, then a first chunk of
`VP8 `, `VP8L` or `VP8X` (any other content is left for the other readers,
and so is not identified). Then, as libwebp's demuxer reads the file
(demux.c; a file it refuses is refused here, as Pillow's "could not create
decoder object"):

  * the RIFF size bounds the file: bytes past it are ignored, a file shorter
    than it is refused;
  * chunks are padded to an even length; unknown chunks are skipped, and so
    are ICCP, EXIF and XMP (Pillow keeps them as bytes, so they add no text);
  * a VP8X chunk gives the flags and the 24-bit canvas size; its image (an
    optional ALPH chunk, then VP8 or VP8L) must fill the canvas, and its
    ALPH chunk is dropped where the VP8X alpha flag is not set;
  * an animation (the flag, ANIM, then ANMF frames) gives its first frame
    only, all that PilRaster loads: that frame at its doubled offsets on a
    zero-filled canvas, with no blending (libwebp's anim_decode.c treats
    frame 1 as a key frame).

The mode is Pillow's: "RGBA" where libwebp's WebPGetFeatures on the whole
file reports alpha, else "RGB"; a file on which it fails is refused
(WebPAnimDecoderNew asks it before the demuxer, which is more lenient: a
VP8X chunk longer than 10 bytes, say). How the VP8X alpha flag, an ALPH
chunk and the VP8L alpha hint combine there is in `has_alpha` (measured
against Pillow 12.1 in tests/test_torch_webp.py). The canvas takes Pillow's
decompression-bomb check before any pixel is decoded. A frame that fails to
decode is refused, as Pillow refuses it ("failed to decode next frame").
Pillow's `info` holds no strings for a WebP file, so the text is empty."""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .. import _native
from ..errors import RasterError
from . import pixels

MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
MAX_IMAGE_AREA = 1 << 32
ANIMATION_FLAG, XMP_FLAG, EXIF_FLAG, ALPHA_FLAG, ICCP_FLAG = (0x02, 0x04, 0x08,
                                                              0x10, 0x20)
ALL_VALID_FLAGS = (ANIMATION_FLAG | XMP_FLAG | EXIF_FLAG | ALPHA_FLAG
                   | ICCP_FLAG)
IMAGE_CHUNKS = (b"VP8 ", b"VP8L")
FIRST_CHUNKS = IMAGE_CHUNKS + (b"VP8X",)

# demux.c's parse states
OK, ERROR, NEED_MORE_DATA = "ok", "error", "need more data"


def accept(head: bytes) -> bool:
    """Pillow's WebPImagePlugin._accept."""
    return (head[:4] == b"RIFF" and head[8:12] == b"WEBP"
            and head[12:16] in FIRST_CHUNKS)


def _le24(blob, pos: int) -> int:
    return blob[pos] | blob[pos + 1] << 8 | blob[pos + 2] << 16


def _le32(blob, pos: int) -> int:
    return struct.unpack_from("<I", blob, pos)[0]


def vp8_info(data, chunk_size: int):
    """(width, height) of a VP8 key frame as VP8GetInfo checks it, or
    None."""
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        return None
    bits = data[0] | data[1] << 8 | data[2] << 16
    w = (data[7] << 8 | data[6]) & 0x3FFF
    h = (data[9] << 8 | data[8]) & 0x3FFF
    if (bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1
            or bits >> 5 >= chunk_size or w == 0 or h == 0):
        return None
    return w, h


def vp8l_info(data):
    """(width, height, alpha hint) of a VP8L header as VP8LGetInfo reads
    it, or None."""
    if len(data) < 5 or data[0] != 0x2F or data[4] >> 5 != 0:
        return None
    bits = int.from_bytes(bytes(data[1:5]), "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, (bits >> 28) & 1


def has_alpha(blob) -> bool | None:
    """WebPGetFeatures(...).has_alpha on the whole file
    (webp_dec.c's ParseHeadersInternal, without all the data required);
    None where it fails.

    An animation reports its VP8X alpha flag; a VP8L image its header's
    alpha hint (a VP8X flag does not count); a VP8 image the VP8X flag, or
    an ALPH chunk before it (where the VP8X flag is missing the decoder
    drops that chunk and the image is opaque)."""
    n = len(blob)
    if n < 12:
        return None
    pos, riff_size = 0, 0
    if blob[:4] == b"RIFF":
        if blob[8:12] != b"WEBP":
            return None
        riff_size = _le32(blob, 4)
        if riff_size < 12 or riff_size > MAX_CHUNK_PAYLOAD:
            return None
        pos = 12
    found_riff = riff_size > 0
    if n - pos < 8:
        return None
    found_vp8x, flags, canvas = False, 0, (0, 0)
    if blob[pos:pos + 4] == b"VP8X":
        if _le32(blob, pos + 4) != 10:
            return None
        if n - pos < 18:
            return None
        flags = _le32(blob, pos + 8)
        canvas = (1 + _le24(blob, pos + 12), 1 + _le24(blob, pos + 15))
        if canvas[0] * canvas[1] >= MAX_IMAGE_AREA:
            return None
        pos += 18
        found_vp8x = True
    if not found_riff and found_vp8x:
        return None
    alpha = bool(flags & ALPHA_FLAG)
    if found_vp8x and flags & ANIMATION_FLAG:
        return alpha
    alph = False

    def result(status):
        if status == OK or (status == NEED_MORE_DATA and found_vp8x):
            return alpha or alph
        return None

    if n - pos < 4:
        return result(NEED_MORE_DATA)
    if (found_riff and found_vp8x) or (not found_riff and not found_vp8x
                                       and blob[pos:pos + 4] == b"ALPH"):
        total = 4 + 8 + 10  # ParseOptionalChunks up to the VP8 / VP8L one
        while True:
            if n - pos < 8:
                return result(NEED_MORE_DATA)
            size = _le32(blob, pos + 4)
            if size > MAX_CHUNK_PAYLOAD:
                return result(ERROR)
            disk = (8 + size + 1) & ~1
            total += disk
            if riff_size > 0 and total > riff_size:
                return result(ERROR)
            if blob[pos:pos + 4] in IMAGE_CHUNKS:
                break
            if n - pos < disk:
                return result(NEED_MORE_DATA)
            alph = alph or blob[pos:pos + 4] == b"ALPH"
            pos += disk
    if n - pos < 8:
        return result(NEED_MORE_DATA)
    if blob[pos:pos + 4] in IMAGE_CHUNKS:
        size = _le32(blob, pos + 4)
        if riff_size >= 12 and size > riff_size - 12:
            return result(ERROR)
        lossless = blob[pos:pos + 4] == b"VP8L"
        pos += 8
    else:  # a raw bitstream
        size = n - pos
        lossless = vp8l_info(blob[pos:pos + 5]) is not None
    if size > MAX_CHUNK_PAYLOAD:
        return None
    if not lossless:
        if n - pos < 10:
            return result(NEED_MORE_DATA)
        info = vp8_info(blob[pos:pos + 10], size)
    else:
        if n - pos < 5:
            return result(NEED_MORE_DATA)
        info = vp8l_info(blob[pos:pos + 5])
        if info is not None:
            alpha = bool(info[2])
    if info is None or (found_vp8x and canvas != info[:2]):
        return None
    return result(OK)


@dataclasses.dataclass
class Frame:
    """A frame as the demuxer keeps it: offsets, size, and its image and
    ALPH chunks as (offset, size) of the whole chunk (header and padding
    within the data)."""

    x_offset: int = 0
    y_offset: int = 0
    width: int = 0
    height: int = 0
    image: tuple = (0, 0)
    alpha: tuple = (0, 0)
    frame_num: int = 0
    complete: bool = False


class Demux:
    """libwebp's WebPDemux on a whole file (demux.c): the canvas, the flags
    and the frames; `error` names why it refused the file, else None."""

    def __init__(self, blob: bytes):
        self.buf = blob
        self.frames: list = []
        self.canvas = (0, 0)
        self.flags = 0
        self.is_ext = False
        self.num_frames = 0
        self.error = self._parse()

    # the MemBuffer
    def _size(self) -> int:
        return self.end - self.start

    def _invalid(self, size: int) -> bool:
        return size > self.riff_end - self.start

    def _parse(self):
        blob = self.buf
        if len(blob) < 20:
            return "the file is too short for a WebP header"
        riff_size = _le32(blob, 4)
        if riff_size < 8 or riff_size > MAX_CHUNK_PAYLOAD:
            return f"bad RIFF size {riff_size}"
        self.riff_end = riff_size + 8
        self.end = min(len(blob), self.riff_end)
        if self.end < self.riff_end:
            return (f"the file is cut short ({len(blob)} bytes, the RIFF "
                    f"header says {self.riff_end})")
        self.start = 12
        first = blob[12:16]
        if blob[:4] != b"RIFF" or blob[8:12] != b"WEBP" or \
                first not in FIRST_CHUNKS:
            return "not a RIFF WEBP file opening with VP8, VP8L or VP8X"
        if first == b"VP8X":
            status, valid = self._parse_vp8x(), self._valid_extended
        else:
            status, valid = self._parse_single_image(), self._valid_simple
        if status == NEED_MORE_DATA:
            return "a chunk runs past the end of the file"
        if status == ERROR or not valid():
            return "the demuxer refuses the file's chunks"
        return None

    def _store_frame(self, frame_num: int, min_size: int, frame: Frame):
        blob = self.buf
        alpha_chunks = image_chunks = 0
        if self._size() < 8 or self._size() < min_size:
            return NEED_MORE_DATA
        status = OK
        while True:
            done = False
            chunk_start = self.start
            fourcc = blob[self.start:self.start + 4]
            payload = _le32(blob, self.start + 4)
            self.start += 8
            if payload > MAX_CHUNK_PAYLOAD:
                return ERROR
            padded = payload + (payload & 1)
            available = min(padded, self._size())
            chunk = (chunk_start, 8 + available)
            if self._invalid(padded):
                return ERROR
            if padded > self._size():
                status = NEED_MORE_DATA
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks += 1
                frame.alpha = chunk
                frame.frame_num = frame_num
                self.start += available
            elif fourcc in IMAGE_CHUNKS and not (fourcc == b"VP8L"
                                                 and alpha_chunks > 0) \
                    and image_chunks == 0:
                data = blob[chunk_start + 8:chunk_start + 8 + available]
                if fourcc == b"VP8 ":
                    info = vp8_info(data, payload)
                    short = len(data) < 10
                else:
                    info = vp8l_info(data)
                    short = len(data) < 5
                if status == NEED_MORE_DATA and short:
                    return NEED_MORE_DATA
                if info is None:
                    return ERROR
                image_chunks += 1
                frame.image = chunk
                frame.width, frame.height = info[:2]
                frame.frame_num = frame_num
                frame.complete = status == OK
                self.start += available
            elif fourcc == b"VP8L" and alpha_chunks > 0:
                return ERROR  # VP8L carries its own alpha
            else:
                self.start -= 8
                done = True
            if self.start == self.riff_end:
                done = True
            elif self._size() < 8:
                status = NEED_MORE_DATA
            if done or status != OK:
                return status

    def _add_frame(self, frame: Frame) -> bool:
        if self.frames and not self.frames[-1].complete:
            return False
        self.frames.append(frame)
        return True

    def _parse_single_image(self):
        if self.frames or self._invalid(8):
            return ERROR
        if self._size() < 8:
            return NEED_MORE_DATA
        frame = Frame()
        status = self._store_frame(1, 0, frame)
        if status != ERROR:
            if not self.flags & ALPHA_FLAG and frame.alpha[1] > 0:
                frame.alpha = (0, 0)  # no VP8X alpha flag: the ALPH goes
            if not self.is_ext and frame.width > 0 and frame.height > 0:
                self.canvas = (frame.width, frame.height)
            if not self._add_frame(frame):
                status = ERROR
            else:
                self.num_frames = 1
        return status

    def _parse_vp8x(self):
        blob = self.buf
        if self._size() < 8:
            return NEED_MORE_DATA
        self.is_ext = True
        size = _le32(blob, self.start + 4)
        self.start += 8
        if size > MAX_CHUNK_PAYLOAD or size < 10:
            return ERROR
        size += size & 1
        if self._invalid(size):
            return ERROR
        if self._size() < size:
            return NEED_MORE_DATA
        self.flags = blob[self.start]
        self.canvas = (1 + _le24(blob, self.start + 4),
                       1 + _le24(blob, self.start + 7))
        if self.canvas[0] * self.canvas[1] >= MAX_IMAGE_AREA:
            return ERROR
        self.start += size
        if self._invalid(8):
            return ERROR
        if self._size() < 8:
            return NEED_MORE_DATA
        return self._parse_vp8x_chunks()

    def _parse_vp8x_chunks(self):
        blob = self.buf
        is_animation = bool(self.flags & ANIMATION_FLAG)
        anim_chunks = 0
        while True:
            status = OK
            fourcc = blob[self.start:self.start + 4]
            size = _le32(blob, self.start + 4)
            self.start += 8
            if size > MAX_CHUNK_PAYLOAD:
                return ERROR
            padded = size + (size & 1)
            if self._invalid(padded) or fourcc == b"VP8X":
                return ERROR
            if fourcc in (b"ALPH",) + IMAGE_CHUNKS:
                if anim_chunks > 0 or is_animation:
                    return ERROR
                self.start -= 8
                status = self._parse_single_image()
            elif fourcc == b"ANIM" and anim_chunks == 0:
                if padded < 6:
                    return ERROR
                if self._size() < padded:
                    status = NEED_MORE_DATA
                else:
                    anim_chunks += 1
                    self.start += padded
            elif fourcc == b"ANMF":
                if anim_chunks == 0:
                    return ERROR  # ANIM comes before the frames
                status = self._parse_animation_frame(padded)
            else:  # ICCP, EXIF, XMP, a second ANIM, unknown chunks
                if fourcc == b"ANIM" and padded < 6:
                    return ERROR
                if padded <= self._size():
                    self.start += padded
                else:
                    status = NEED_MORE_DATA
            if self.start == self.riff_end:
                return status
            if self._size() < 8:
                status = NEED_MORE_DATA
            if status != OK:
                return status

    def _parse_animation_frame(self, chunk_size: int):
        blob = self.buf
        if self._invalid(16) or chunk_size < 16:
            return ERROR
        if self._size() < 16:
            return NEED_MORE_DATA
        p = self.start
        frame = Frame(x_offset=2 * _le24(blob, p),
                      y_offset=2 * _le24(blob, p + 3),
                      width=1 + _le24(blob, p + 6),
                      height=1 + _le24(blob, p + 9))
        self.start += 16
        if frame.width * frame.height >= MAX_IMAGE_AREA:
            return ERROR
        start = self.start
        status = self._store_frame(self.num_frames + 1, chunk_size - 16, frame)
        if status != ERROR and self.start - start > chunk_size - 16:
            status = ERROR
        if (status != ERROR and self.flags & ANIMATION_FLAG
                and frame.frame_num > 0):
            if self._add_frame(frame):
                self.num_frames += 1
            else:
                status = ERROR
        return status

    def _valid_simple(self) -> bool:
        return (self.canvas[0] > 0 and self.canvas[1] > 0 and bool(self.frames)
                and self.frames[0].width > 0 and self.frames[0].height > 0)

    def _valid_extended(self) -> bool:
        is_animation = bool(self.flags & ANIMATION_FLAG)
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames:
            return False
        if self.flags & ~ALL_VALID_FLAGS:
            return False
        for f in self.frames:
            if not is_animation and f.frame_num > 1:
                return False
            if not f.complete:  # no partial frame in a complete file
                return False
            if f.alpha[1] == 0 and f.image[1] == 0:
                return False
            if f.alpha[1] > 0 and f.alpha[0] > f.image[0]:
                return False  # ALPH comes before the image
            if f.width <= 0 or f.height <= 0:
                return False
            if is_animation:
                if (f.x_offset < 0 or f.y_offset < 0
                        or f.width + f.x_offset > self.canvas[0]
                        or f.height + f.y_offset > self.canvas[1]):
                    return False
            elif (f.x_offset, f.y_offset, f.width, f.height) != (
                    0, 0) + self.canvas:
                return False
        return True


def read(blob: bytes) -> pixels.Decoded:
    rgba = has_alpha(blob)
    dmx = Demux(blob)
    why = dmx.error or ("libwebp's WebPGetFeatures refuses the file"
                        if rgba is None else None)
    if why is not None:
        raise RasterError(f"WebP: could not create decoder object: {why}")
    width, height = dmx.canvas
    pixels.check_size(width, height)
    mode = "RGBA" if rgba else "RGB"
    frame = dmx.frames[0]
    view = memoryview(blob)
    at, size = frame.image
    lossless = blob[at:at + 4] == b"VP8L"
    alpha = None
    if frame.alpha[1] > 0:
        a = frame.alpha[0]
        alpha = view[a + 8:a + 8 + _le32(blob, a + 4)]
    canvas = np.zeros((height, width, len(mode)), np.uint8)
    window = canvas[frame.y_offset:frame.y_offset + frame.height,
                    frame.x_offset:frame.x_offset + frame.width]
    try:
        _native.webp_decode(view[at + 8:at + size], lossless, alpha, window)
    except RuntimeError as e:  # the decoder library did not build
        raise RasterError(f"WebP: {e}") from e
    except ValueError as e:
        raise RasterError(f"WebP: failed to decode next frame in WebP file "
                          f"({e})") from e
    return pixels.Decoded(mode, canvas)
