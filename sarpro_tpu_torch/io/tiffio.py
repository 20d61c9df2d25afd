"""Self-contained TIFF / GeoTIFF / BigTIFF codec (numpy).

Replaces the reference's GDAL raster path (src/io/gdal.rs:37-187 for reads,
src/io/writers/tiff.rs:6-78 for writes). This environment has no GDAL, so the
framework owns the container format:

Reader: classic + BigTIFF, both byte orders, striped + tiled layouts,
u8/u16/u32/i16/f32/f64 samples, compression none/deflate/packbits/LZW,
GeoTIFF tags (pixel scale, tiepoints/GCPs, geokeys), GDAL metadata XML.
Uncompressed contiguous rasters are memory-mapped (zero-copy) so the
downsample-on-read path streams straight from the page cache to the device.

Writer: little-endian classic TIFF (BigTIFF automatically above 4 GB),
striped, uncompressed, 1..N contiguous samples of u8/u16, GeoTIFF
georeferencing (ModelPixelScale+ModelTiepoint for north-up transforms,
ModelTransformation otherwise), EPSG geokeys, GDAL_METADATA items and
GDAL-compatible layout — outputs open identically under gdalinfo.
"""
# A copy of sarpro_tpu/io/tiffio.py, so that the port imports nothing of the
# JAX package; tests/test_torch_host_copies.py holds the two equal.
from __future__ import annotations

import dataclasses
import struct
import xml.etree.ElementTree as ET
import zlib
from pathlib import Path
from typing import BinaryIO, Optional

import numpy as np

from ..errors import RasterError

# --- tag ids -----------------------------------------------------------------
TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_PLANAR_CONFIG = 284
TAG_PREDICTOR = 317
TAG_EXTRA_SAMPLES = 338
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTE_COUNTS = 325
TAG_SAMPLE_FORMAT = 339
TAG_MODEL_PIXEL_SCALE = 33550
TAG_MODEL_TIEPOINT = 33922
TAG_MODEL_TRANSFORMATION = 34264
TAG_GEO_KEY_DIRECTORY = 34735
TAG_GEO_DOUBLE_PARAMS = 34736
TAG_GEO_ASCII_PARAMS = 34737
TAG_GDAL_METADATA = 42112
TAG_GDAL_NODATA = 42113

COMPRESSION_NONE = 1
COMPRESSION_LZW = 5
COMPRESSION_DEFLATE_ADOBE = 8
COMPRESSION_PACKBITS = 32773
COMPRESSION_DEFLATE = 32946

# TIFF field types: (struct char, size)
_FIELD_TYPES = {
    1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
    6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
    11: ("f", 4), 12: ("d", 8), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8),
}

TYPE_BYTE, TYPE_ASCII, TYPE_SHORT, TYPE_LONG = 1, 2, 3, 4
TYPE_RATIONAL, TYPE_DOUBLE = 5, 12
TYPE_LONG8 = 16


@dataclasses.dataclass
class GeoInfo:
    """Georeferencing extracted from GeoTIFF tags."""

    geotransform: Optional[list[float]] = None  # GDAL 6-element convention
    gcps: Optional[np.ndarray] = None  # (N, 5): pixel, line, X, Y, Z
    epsg: Optional[int] = None
    citation: Optional[str] = None
    is_geographic: bool = False
    gcp_epsg: Optional[int] = None
    gcp_is_geographic: bool = False


class TiffReader:
    """Minimal-overhead TIFF reader with decimated-read support."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fh: BinaryIO = open(self.path, "rb")
        header = self._fh.read(16)
        if len(header) < 8:
            raise RasterError(f"not a TIFF file: {self.path}")
        if header[:2] == b"II":
            self._e = "<"
        elif header[:2] == b"MM":
            self._e = ">"
        else:
            raise RasterError(f"not a TIFF file: {self.path}")
        magic = struct.unpack(self._e + "H", header[2:4])[0]
        if magic == 42:
            self.big = False
            first_ifd = struct.unpack(self._e + "I", header[4:8])[0]
        elif magic == 43:
            self.big = True
            first_ifd = struct.unpack(self._e + "Q", header[8:16])[0]
        else:
            raise RasterError(f"bad TIFF magic {magic}: {self.path}")
        self.tags = self._read_ifd(first_ifd)
        self._parse_layout()

    # -- IFD parsing --------------------------------------------------------
    def _read_ifd(self, offset: int) -> dict[int, tuple]:
        e = self._e
        fh = self._fh
        fh.seek(offset)
        if self.big:
            (count,) = struct.unpack(e + "Q", fh.read(8))
            entry_size, count_fmt = 20, "Q"
        else:
            (count,) = struct.unpack(e + "H", fh.read(2))
            entry_size, count_fmt = 12, "I"
        raw = fh.read(entry_size * count)
        tags: dict[int, tuple] = {}
        inline = 8 if self.big else 4
        for i in range(count):
            ent = raw[i * entry_size:(i + 1) * entry_size]
            tag, ftype = struct.unpack(e + "HH", ent[:4])
            (n,) = struct.unpack(e + count_fmt, ent[4:4 + (8 if self.big else 4)])
            val_bytes = ent[4 + (8 if self.big else 4):]
            if ftype not in _FIELD_TYPES:
                continue
            ch, size = _FIELD_TYPES[ftype]
            total = size * n * (2 if ftype in (5, 10) else 1)
            if total <= inline:
                data = val_bytes[:total]
            else:
                (ptr,) = struct.unpack(e + ("Q" if self.big else "I"), val_bytes[:inline])
                pos = fh.tell()
                fh.seek(ptr)
                data = fh.read(total)
                fh.seek(pos)
            tags[tag] = (ftype, n, data)
        return tags

    def _tag_values(self, tag: int):
        if tag not in self.tags:
            return None
        ftype, n, data = self.tags[tag]
        e = self._e
        if ftype == TYPE_ASCII:
            return data.split(b"\0")[0].decode("latin-1")
        ch, size = _FIELD_TYPES[ftype]
        if ftype in (5, 10):  # rational
            vals = struct.unpack(e + ch[0] * 2 * n, data)
            return [vals[2 * i] / max(vals[2 * i + 1], 1) for i in range(n)]
        return list(struct.unpack(e + ch * n, data))

    def _tag_scalar(self, tag: int, default=None):
        v = self._tag_values(tag)
        if v is None:
            return default
        return v[0] if isinstance(v, list) else v

    # -- layout ---------------------------------------------------------------
    def _parse_layout(self):
        self.width = int(self._tag_scalar(TAG_IMAGE_WIDTH))
        self.height = int(self._tag_scalar(TAG_IMAGE_LENGTH))
        self.samples = int(self._tag_scalar(TAG_SAMPLES_PER_PIXEL, 1))
        bits = self._tag_values(TAG_BITS_PER_SAMPLE) or [1]
        self.bits = int(bits[0])
        fmt = self._tag_values(TAG_SAMPLE_FORMAT) or [1]
        self.sample_format = int(fmt[0])
        self.compression = int(self._tag_scalar(TAG_COMPRESSION, COMPRESSION_NONE))
        self.predictor = int(self._tag_scalar(TAG_PREDICTOR, 1))
        self.planar = int(self._tag_scalar(TAG_PLANAR_CONFIG, 1))
        self.tiled = TAG_TILE_OFFSETS in self.tags

        kind = {1: "u", 2: "i", 3: "f"}.get(self.sample_format, "u")
        self.dtype = np.dtype(f"{self._e}{kind}{self.bits // 8}")

        if self.tiled:
            self.tile_w = int(self._tag_scalar(TAG_TILE_WIDTH))
            self.tile_h = int(self._tag_scalar(TAG_TILE_LENGTH))
            self.offsets = np.array(self._tag_values(TAG_TILE_OFFSETS), np.int64)
            self.byte_counts = np.array(self._tag_values(TAG_TILE_BYTE_COUNTS), np.int64)
        else:
            self.rows_per_strip = int(
                self._tag_scalar(TAG_ROWS_PER_STRIP, self.height) or self.height
            )
            self.offsets = np.array(self._tag_values(TAG_STRIP_OFFSETS), np.int64)
            self.byte_counts = np.array(self._tag_values(TAG_STRIP_BYTE_COUNTS), np.int64)

    # -- decode ---------------------------------------------------------------
    def _decompress(self, blob: bytes, out_count: int) -> np.ndarray:
        from .. import _native

        c = self.compression
        cap = out_count * self.dtype.itemsize
        if c == COMPRESSION_NONE:
            raw = blob
        elif c in (COMPRESSION_DEFLATE, COMPRESSION_DEFLATE_ADOBE):
            raw = zlib.decompress(blob)
        elif c == COMPRESSION_PACKBITS:
            raw = (_native.packbits_decode(blob, cap) if _native.available()
                   else _packbits_decode(blob))
        elif c == COMPRESSION_LZW:
            raw = (_native.lzw_decode(blob, cap) if _native.available()
                   else _lzw_decode(blob))
        else:
            raise RasterError(f"unsupported TIFF compression {c}")
        arr = np.frombuffer(raw, self.dtype, count=min(out_count, len(raw) // self.dtype.itemsize))
        if arr.size < out_count:  # short final block
            arr = np.concatenate([arr, np.zeros(out_count - arr.size, self.dtype)])
        return arr

    def _undo_predictor(self, arr: np.ndarray, rows: int,
                        cols: Optional[int] = None,
                        samples: Optional[int] = None) -> np.ndarray:
        """Predictor undo for one decoded block.

        `cols`/`samples` describe the block geometry: tile width for tiled
        files, 1 sample for planar strips (each strip holds one plane).
        Handles predictor=2 (horizontal differencing) and predictor=3
        (floating-point byte-split differencing, as produced by libtiff/GDAL).
        """
        if self.predictor == 1:
            return arr
        cols = self.width if cols is None else cols
        samples = self.samples if samples is None else samples
        if self.predictor == 2:
            a = arr.reshape(rows, cols, samples)
            return np.cumsum(a, axis=1, dtype=self.dtype).reshape(arr.shape)
        if self.predictor == 3:
            # fp predictor: per row, bytes are differenced then stored split
            # into byte-significance planes, MSB plane first (libtiff fpDiff)
            item = self.dtype.itemsize
            n = cols * samples
            b = arr.view(np.uint8).reshape(rows, n * item)
            b = np.cumsum(b, axis=1, dtype=np.uint8)
            be = np.ascontiguousarray(b.reshape(rows, item, n).transpose(0, 2, 1))
            big = be.reshape(rows * n * item).view(self.dtype.newbyteorder(">"))
            return big.astype(self.dtype).reshape(arr.shape)
        raise RasterError(f"unsupported TIFF predictor {self.predictor}")

    def _contiguous_uncompressed(self) -> bool:
        if self.compression != COMPRESSION_NONE or self.tiled or self.planar != 1:
            return False
        row_bytes = self.width * self.samples * self.dtype.itemsize
        expected = self.offsets[0] + np.arange(len(self.offsets)) * row_bytes * self.rows_per_strip
        return bool(np.all(self.offsets == expected))

    def read(self, band: int = 1) -> np.ndarray:
        """Full-raster read of one band (1-based) as the native dtype (rows, cols)."""
        full = self._read_all_samples()
        if self.samples == 1:
            return full.reshape(self.height, self.width)
        if self.planar == 1:
            return full.reshape(self.height, self.width, self.samples)[..., band - 1]
        plane = self.height * self.width
        return full[(band - 1) * plane:band * plane].reshape(self.height, self.width)

    def _read_all_samples(self) -> np.ndarray:
        if self._contiguous_uncompressed():
            count = self.height * self.width * self.samples
            return np.fromfile(self.path, self.dtype, count=count, offset=int(self.offsets[0]))
        if self.tiled:
            return self._read_tiled()
        return self._read_striped()

    def _read_striped(self) -> np.ndarray:
        from .. import _native

        n_strips = len(self.offsets)
        if self.planar == 1:
            out = np.empty(self.height * self.width * self.samples, self.dtype)
            # native parallel strip decode (LZW / PackBits / raw)
            if (_native.available() and self.predictor == 1
                    and self.compression in (COMPRESSION_NONE, COMPRESSION_LZW,
                                             COMPRESSION_PACKBITS)):
                blobs = []
                dst_off = np.empty(n_strips, np.int64)
                dst_len = np.empty(n_strips, np.int64)
                item = self.dtype.itemsize
                pos = 0
                for i in range(n_strips):
                    rows = min(self.rows_per_strip,
                               self.height - i * self.rows_per_strip)
                    cnt = rows * self.width * self.samples * item
                    self._fh.seek(int(self.offsets[i]))
                    blobs.append(self._fh.read(int(self.byte_counts[i])))
                    dst_off[i] = pos
                    dst_len[i] = cnt
                    pos += cnt
                _native.decode_strips(blobs, out.view(np.uint8), dst_off,
                                      dst_len, int(self.compression))
                return out
            pos = 0
            for i in range(n_strips):
                rows = min(self.rows_per_strip, self.height - i * self.rows_per_strip)
                cnt = rows * self.width * self.samples
                self._fh.seek(int(self.offsets[i]))
                blob = self._fh.read(int(self.byte_counts[i]))
                out[pos:pos + cnt] = self._undo_predictor(
                    self._decompress(blob, cnt), rows)
                pos += cnt
            return out
        # planar: strips per sample plane, sample-major
        strips_per_plane = n_strips // self.samples
        out = np.empty(self.samples * self.height * self.width, self.dtype)
        pos = 0
        for i in range(n_strips):
            row_in_plane = (i % strips_per_plane) * self.rows_per_strip
            rows = min(self.rows_per_strip, self.height - row_in_plane)
            cnt = rows * self.width
            self._fh.seek(int(self.offsets[i]))
            blob = self._fh.read(int(self.byte_counts[i]))
            out[pos:pos + cnt] = self._undo_predictor(
                self._decompress(blob, cnt), rows, samples=1)
            pos += cnt
        return out

    def _read_tiled(self) -> np.ndarray:
        tw, th = self.tile_w, self.tile_h
        tiles_x = -(-self.width // tw)
        tiles_y = -(-self.height // th)
        s = self.samples if self.planar == 1 else 1
        planes = 1 if self.planar == 1 else self.samples
        out = np.zeros((planes, self.height, self.width, s), self.dtype)
        idx = 0
        for p in range(planes):
            for ty in range(tiles_y):
                for tx in range(tiles_x):
                    self._fh.seek(int(self.offsets[idx]))
                    blob = self._fh.read(int(self.byte_counts[idx]))
                    tile = self._undo_predictor(
                        self._decompress(blob, th * tw * s), th,
                        cols=tw, samples=s,
                    ).reshape(th, tw, s)
                    y0, x0 = ty * th, tx * tw
                    h = min(th, self.height - y0)
                    w = min(tw, self.width - x0)
                    out[p, y0:y0 + h, x0:x0 + w] = tile[:h, :w]
                    idx += 1
        if self.planar == 1:
            return out[0].reshape(-1)
        return out[..., 0].reshape(-1)

    def read_strip_range(self, row0: int, row1: int, band: int = 1) -> np.ndarray:
        """Read rows [row0, row1) of one band — the building block for
        streamed / decimated reads (replaces GDAL RasterIO windows,
        reference: gdal.rs:145-177). Decodes only the strips covering the
        row window; never materializes the full raster."""
        if self._contiguous_uncompressed():
            row_bytes = self.width * self.samples * self.dtype.itemsize
            off = int(self.offsets[0]) + row0 * row_bytes
            arr = np.fromfile(self.path, self.dtype,
                              count=(row1 - row0) * self.width * self.samples,
                              offset=off)
            arr = arr.reshape(row1 - row0, self.width, self.samples)
            return arr[..., band - 1]
        if not self.tiled and self.planar == 1:
            rps = self.rows_per_strip
            s0, s1 = row0 // rps, -(-row1 // rps)
            rows_cov = min(s1 * rps, self.height) - s0 * rps
            out = np.empty(rows_cov * self.width * self.samples, self.dtype)
            pos = 0
            for i in range(s0, s1):
                rows = min(rps, self.height - i * rps)
                cnt = rows * self.width * self.samples
                self._fh.seek(int(self.offsets[i]))
                blob = self._fh.read(int(self.byte_counts[i]))
                out[pos:pos + cnt] = self._undo_predictor(
                    self._decompress(blob, cnt), rows)
                pos += cnt
            out = out[:pos].reshape(-1, self.width, self.samples)
            lo = row0 - s0 * rps
            return out[lo:lo + (row1 - row0), :, band - 1]
        return self.read(band)[row0:row1]

    # -- geo ------------------------------------------------------------------
    def geo_info(self) -> GeoInfo:
        info = GeoInfo()
        scale = self._tag_values(TAG_MODEL_PIXEL_SCALE)
        ties = self._tag_values(TAG_MODEL_TIEPOINT)
        xform = self._tag_values(TAG_MODEL_TRANSFORMATION)
        if xform and len(xform) >= 16:
            m = xform
            info.geotransform = [m[3], m[0], m[1], m[7], m[4], m[5]]
        elif scale and ties and len(ties) == 6:
            sx, sy = scale[0], scale[1]
            i, j, _k, x, y, _z = ties[:6]
            info.geotransform = [x - i * sx, sx, 0.0, y + j * sy, 0.0, -sy]
        elif ties and len(ties) > 6:
            t = np.array(ties, np.float64).reshape(-1, 6)
            info.gcps = t[:, [0, 1, 3, 4, 5]]  # pixel, line, X, Y, Z

        geokeys = self._tag_values(TAG_GEO_KEY_DIRECTORY)
        ascii_params = self._tag_values(TAG_GEO_ASCII_PARAMS) or ""
        if geokeys and len(geokeys) >= 4:
            n_keys = int(geokeys[3])
            model_type = None
            for k in range(n_keys):
                key_id, loc, cnt, val = geokeys[4 + 4 * k:8 + 4 * k]
                if key_id == 1024:
                    model_type = val
                elif key_id == 3072 and loc == 0:  # ProjectedCSTypeGeoKey
                    info.epsg = int(val)
                elif key_id == 2048 and loc == 0:  # GeographicTypeGeoKey
                    if info.epsg is None:
                        info.epsg = int(val)
                        info.is_geographic = True
                elif key_id in (1026, 2049) and loc == TAG_GEO_ASCII_PARAMS:
                    info.citation = ascii_params[val:val + cnt].rstrip("|")
            if model_type == 2 and info.epsg is not None:
                info.is_geographic = True
        if info.gcps is not None:
            # GCP CRS shares the file's geokeys (GDAL convention)
            info.gcp_epsg = info.epsg
            info.gcp_is_geographic = info.is_geographic or info.epsg == 4326
        return info

    def gdal_metadata(self) -> dict[str, str]:
        """Parse the GDAL_METADATA XML tag into a flat dict."""
        raw = self._tag_values(TAG_GDAL_METADATA)
        if not raw:
            return {}
        try:
            root = ET.fromstring(raw)
        except ET.ParseError:
            return {}
        return {
            item.get("name", ""): (item.text or "")
            for item in root.iter("Item")
        }

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _packbits_decode(blob: bytes) -> bytes:
    out = bytearray()
    i = 0
    L = len(blob)
    while i < L:
        n = blob[i]
        i += 1
        if n < 128:
            out += blob[i:i + n + 1]
            i += n + 1
        elif n > 128:
            out += blob[i:i + 1] * (257 - n)
            i += 1
    return bytes(out)


def _lzw_decode(blob: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first, early change)."""
    data = np.frombuffer(blob, np.uint8)
    bits = np.unpackbits(data)
    out = bytearray()
    dict_init = {i: bytes([i]) for i in range(256)}
    CLEAR, EOI = 256, 257
    table = dict(dict_init)
    next_code = 258
    code_size = 9
    pos = 0
    prev: bytes | None = None
    n = len(bits)
    while pos + code_size <= n:
        code = 0
        for b in bits[pos:pos + code_size]:
            code = (code << 1) | int(b)
        pos += code_size
        if code == CLEAR:
            table = dict(dict_init)
            next_code = 258
            code_size = 9
            prev = None
            continue
        if code == EOI:
            break
        if prev is None:
            entry = table[code]
        elif code in table:
            entry = table[code]
        elif code == next_code:
            entry = prev + prev[:1]
        else:
            raise RasterError("corrupt LZW stream")
        out += entry
        if prev is not None:
            table[next_code] = prev + entry[:1]
            next_code += 1
            if next_code == (1 << code_size) - 1 and code_size < 12:
                code_size += 1
        prev = entry
    return bytes(out)


# ==============================================================================
# Writer
# ==============================================================================
def _wkt_or_epsg_to_epsg(projection: str) -> Optional[int]:
    """Extract an EPSG code from 'EPSG:XXXX' or a WKT AUTHORITY tag
    (same heuristic as reference sentinel1.rs:948-958)."""
    if not projection:
        return None
    p = projection.strip()
    if p.upper().startswith("EPSG:"):
        try:
            return int(p.split(":")[1])
        except ValueError:
            return None
    key = 'AUTHORITY["EPSG","'
    idx = p.rfind(key)
    if idx >= 0:
        start = idx + len(key)
        end = p.find('"', start)
        if end > start:
            try:
                return int(p[start:end])
            except ValueError:
                return None
    return None


def _is_geographic_crs(projection: str, epsg: Optional[int]) -> bool:
    if epsg == 4326:
        return True
    p = (projection or "").upper()
    return p.startswith("GEOGCS") or p.startswith("GEOGCRS")


class TiffWriter:
    """Streamed striped TIFF writer (u8/u16, 1..N contiguous samples)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._ifd_entries: list[tuple[int, int, int, bytes | int]] = []
        self._geotransform: Optional[list[float]] = None
        self._tiepoints: Optional[list[float]] = None
        self._projection: Optional[str] = None
        self._metadata: dict[str, str] = {}
        self._nodata: Optional[float] = None

    def set_geotransform(self, gt):
        self._geotransform = list(gt)

    def set_tiepoints(self, ties):
        """GCPs as a flat [pixel, line, 0, X, Y, Z]*N ModelTiepoint list
        (GDAL's GeoTIFF GCP convention for unprojected rasters)."""
        self._tiepoints = list(ties)

    def set_projection(self, projection: str):
        self._projection = projection

    def set_metadata_item(self, key: str, value: str):
        self._metadata[key] = value

    def set_metadata(self, items: dict[str, str]):
        self._metadata.update(items)

    def write(self, bands: list[np.ndarray], force_bigtiff: bool = False):
        """Write one or more equally-shaped 2D bands (u8 or u16)."""
        if not bands:
            raise RasterError("no bands to write")
        shape = bands[0].shape
        dtype = bands[0].dtype
        for b in bands:
            if b.shape != shape or b.dtype != dtype:
                raise RasterError("bands must share shape and dtype")
        if dtype not in (np.dtype(np.uint8), np.dtype(np.uint16)):
            raise RasterError(f"unsupported write dtype {dtype}")
        rows, cols = shape
        n = len(bands)
        interleaved = (
            bands[0][..., None] if n == 1 else np.stack(bands, axis=-1)
        ).astype(dtype.newbyteorder("<"))

        data_bytes = interleaved.nbytes
        big = force_bigtiff or data_bytes + 65536 > 0xFFFFFFFF
        self._write_file(interleaved, rows, cols, n, dtype, big)

    # -- low-level ------------------------------------------------------------
    def _write_file(self, data: np.ndarray, rows: int, cols: int, nsamples: int,
                    dtype: np.dtype, big: bool):
        e = "<"
        entries: list[tuple[int, int, int, list]] = []

        def add(tag, ftype, values):
            count = _ascii_count(values) if ftype == TYPE_ASCII else len(values)
            entries.append((tag, ftype, count, values))

        item = dtype.itemsize
        # strip layout: aim ~1 MB strips
        rows_per_strip = max(1, (1 << 20) // max(cols * nsamples * item, 1))
        rows_per_strip = min(rows_per_strip, rows)
        n_strips = -(-rows // rows_per_strip)

        add(TAG_IMAGE_WIDTH, TYPE_LONG, [cols])
        add(TAG_IMAGE_LENGTH, TYPE_LONG, [rows])
        add(TAG_BITS_PER_SAMPLE, TYPE_SHORT, [item * 8] * nsamples)
        add(TAG_COMPRESSION, TYPE_SHORT, [COMPRESSION_NONE])
        add(TAG_PHOTOMETRIC, TYPE_SHORT, [1])  # MinIsBlack (GrayIndex)
        add(TAG_SAMPLES_PER_PIXEL, TYPE_SHORT, [nsamples])
        add(TAG_ROWS_PER_STRIP, TYPE_LONG, [rows_per_strip])
        add(TAG_PLANAR_CONFIG, TYPE_SHORT, [1])
        if nsamples > 1:
            add(TAG_EXTRA_SAMPLES, TYPE_SHORT, [0] * (nsamples - 1))
        add(TAG_SAMPLE_FORMAT, TYPE_SHORT, [1] * nsamples)

        gt = self._geotransform
        if self._tiepoints:
            add(TAG_MODEL_TIEPOINT, TYPE_DOUBLE, self._tiepoints)
        elif gt is not None and not _is_identity_gt(gt):
            if gt[2] == 0.0 and gt[4] == 0.0:
                add(TAG_MODEL_PIXEL_SCALE, TYPE_DOUBLE, [gt[1], -gt[5], 0.0])
                add(TAG_MODEL_TIEPOINT, TYPE_DOUBLE, [0.0, 0.0, 0.0, gt[0], gt[3], 0.0])
            else:
                m = [gt[1], gt[2], 0.0, gt[0],
                     gt[4], gt[5], 0.0, gt[3],
                     0.0, 0.0, 0.0, 0.0,
                     0.0, 0.0, 0.0, 1.0]
                add(TAG_MODEL_TRANSFORMATION, TYPE_DOUBLE, m)

        geo_ascii = ""
        if self._projection:
            epsg = _wkt_or_epsg_to_epsg(self._projection)
            geographic = _is_geographic_crs(self._projection, epsg)
            keys = [(1024, 0, 1, 2 if geographic else 1),  # GTModelType
                    (1025, 0, 1, 1)]  # RasterPixelIsArea
            citation = self._projection[:512].replace("\0", " ")
            geo_ascii = citation + "|"
            keys.append((1026, TAG_GEO_ASCII_PARAMS, len(citation) + 1, 0))
            if epsg is not None:
                if geographic:
                    keys.append((2048, 0, 1, epsg))
                else:
                    keys.append((3072, 0, 1, epsg))
            directory = [1, 1, 0, len(keys)]
            for k in sorted(keys):
                directory.extend(k)
            add(TAG_GEO_KEY_DIRECTORY, TYPE_SHORT, directory)
            add(TAG_GEO_ASCII_PARAMS, TYPE_ASCII, [geo_ascii])

        if self._metadata:
            root = ET.Element("GDALMetadata")
            for k, v in self._metadata.items():
                it = ET.SubElement(root, "Item", name=str(k))
                it.text = str(v)
            xml = ET.tostring(root, encoding="unicode")
            add(TAG_GDAL_METADATA, TYPE_ASCII, [xml])
        if self._nodata is not None:
            add(TAG_GDAL_NODATA, TYPE_ASCII, [repr(self._nodata)])

        # strip offsets/bytecounts filled after layout
        strip_rows = [min(rows_per_strip, rows - i * rows_per_strip) for i in range(n_strips)]
        strip_counts = [r * cols * nsamples * item for r in strip_rows]
        off_type = TYPE_LONG8 if big else TYPE_LONG
        add(TAG_STRIP_OFFSETS, off_type, [0] * n_strips)
        add(TAG_STRIP_BYTE_COUNTS, off_type, strip_counts)

        entries.sort(key=lambda t: t[0])

        with open(self.path, "wb") as fh:
            if big:
                fh.write(b"II" + struct.pack("<HHHQ", 43, 8, 0, 16))
                ifd_offset = 16
                entry_size = 20
                count_bytes = 8
                inline = 8
                head_fmt = "<Q"
                ptr_fmt = "<Q"
            else:
                fh.write(b"II" + struct.pack("<HI", 42, 8))
                ifd_offset = 8
                entry_size = 12
                count_bytes = 2
                inline = 4
                head_fmt = "<H"
                ptr_fmt = "<I"

            ifd_size = count_bytes + entry_size * len(entries) + (8 if big else 4)
            overflow_offset = ifd_offset + ifd_size
            # serialize values, planning overflow area
            blobs: list[bytes] = []
            ser: list[tuple[int, int, int, bytes, Optional[int]]] = []
            cursor = overflow_offset
            for tag, ftype, n, values in entries:
                payload = _pack_values(ftype, values)
                if len(payload) <= inline:
                    ser.append((tag, ftype, n, payload.ljust(inline, b"\0"), None))
                else:
                    if cursor % 2:
                        cursor += 1
                    ser.append((tag, ftype, n, b"", cursor))
                    blobs.append(payload)
                    cursor += len(payload)

            data_offset = cursor + (cursor % 2)
            # patch strip offsets now that data_offset is known
            strip_offsets = []
            pos = data_offset
            for c in strip_counts:
                strip_offsets.append(pos)
                pos += c
            patched = []
            blob_i = 0
            cursor2 = overflow_offset
            for (tag, ftype, n, payload, ptr) in ser:
                if tag == TAG_STRIP_OFFSETS:
                    new_payload = _pack_values(ftype, strip_offsets)
                    if ptr is None:
                        payload = new_payload.ljust(inline, b"\0")
                    else:
                        blobs[blob_i] = new_payload
                if ptr is not None:
                    blob_i += 1
                patched.append((tag, ftype, n, payload, ptr))

            # write IFD
            fh.seek(ifd_offset)
            fh.write(struct.pack(head_fmt, len(patched)))
            for tag, ftype, n, payload, ptr in patched:
                fh.write(struct.pack("<HH", tag, ftype))
                fh.write(struct.pack("<Q" if big else "<I", n))
                if ptr is None:
                    fh.write(payload)
                else:
                    fh.write(struct.pack(ptr_fmt, ptr))
            fh.write(struct.pack("<Q" if big else "<I", 0))  # next IFD

            # overflow blobs
            cursor2 = overflow_offset
            for b in blobs:
                if cursor2 % 2:
                    fh.seek(cursor2)
                    fh.write(b"\0")
                    cursor2 += 1
                fh.seek(cursor2)
                fh.write(b)
                cursor2 += len(b)

            # raster data
            fh.seek(data_offset)
            fh.write(data.tobytes())


def _pack_values(ftype: int, values) -> bytes:
    if ftype == TYPE_ASCII:
        s = values[0] if isinstance(values, list) else values
        b = s.encode("latin-1", "replace")
        if not b.endswith(b"\0"):
            b += b"\0"
        return b
    ch, _size = _FIELD_TYPES[ftype]
    return struct.pack("<" + ch * len(values), *values)


def _is_identity_gt(gt) -> bool:
    """reference: writers/metadata.rs:305-307."""
    return (gt[0] == 0.0 and gt[1] == 1.0 and gt[2] == 0.0
            and gt[3] == 0.0 and gt[4] == 0.0 and gt[5] == 1.0)


# count for ASCII must reflect byte length; fix at pack site
def _ascii_count(values) -> int:
    s = values[0]
    b = s.encode("latin-1", "replace")
    return len(b) + (0 if b.endswith(b"\0") else 1)
