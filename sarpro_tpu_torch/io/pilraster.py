"""Non-TIFF raster backend (port of sarpro_tpu/io/pilraster.py): the JAX
package's PilRaster decodes every non-TIFF, non-netCDF file through
Pillow's `Image.open`, which the machine with the GPU does not have. The
port decodes them with its own readers, to the image Pillow opens, trying
Pillow 12.1's plugins in its order (open_image, PLUGINS):

  * PNG (io/png.py), JPEG (io/jpeg.py), BMP (io/bmp.py), GIF (io/gif.py),
    netpbm P1-P6, PFM and Pillow's extensions (io/netpbm.py), WebP
    (io/webp.py: lossy, lossless, alpha, the first frame of an animation),
    JPEG 2000 (io/jpeg2000.py: JP2 files and raw codestreams), FITS
    (io/fits.py), McIdas AREA (io/mcidas.py), SPIDER (io/spider.py), IM
    (io/im.py), SGI (io/sgi.py), TGA (io/tga.py), PCX and DCX (io/pcx.py),
    Sun raster (io/sun.py), PSD (io/psd.py) and QOI (io/qoi.py);
  * a file that a plugin the port does not read takes raises RasterError
    naming the format, and so does content no plugin takes.

Each reader's image then takes the JAX module's normalisation
(io/pixels.normalise) and Pillow's decompression-bomb limit
(io/pixels.check_size). The sidecar georeferencing is the JAX module's,
copied as it is (PIL_EXTENSIONS, world_file_candidates, read_world_file,
read_prj_epsg; tests/test_torch_host_copies.py holds them equal):

  * world file (pixel-center convention; same extension family GDAL probes:
    pgw/jgw/bpw/gfw/…, <ext>w, and .wld)
  * .prj sidecar for the CRS ("EPSG:XXXX" or WKT with an AUTHORITY tag)
"""
from __future__ import annotations

import re
import struct
from pathlib import Path

import numpy as np

from ..errors import RasterError
from . import (
    bmp,
    fits,
    gif,
    im,
    jpeg,
    jpeg2000,
    mcidas,
    netpbm,
    pcx,
    pixels,
    png,
    psd,
    qoi,
    sgi,
    spider,
    sun,
    tga,
    webp,
)
from .tiffio import GeoInfo

# extensions PIL handles that we advertise (TIFF stays on the native codec)
PIL_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".ppm", ".pgm",
                  ".pbm", ".webp", ".jp2", ".j2k", ".jpx")


def world_file_candidates(path: Path) -> list[Path]:
    """Sidecar names probed for a world file, in priority order: the
    GDAL convention (first+last letter + 'w': bpw/gfw/pmw), the named
    shorthands (jgw/pgw/tfw), <ext>w, the reference writer's first-letter
    + 'w' spelling (worldfile.rs:17-30), and .wld."""
    ext = path.suffix.lstrip(".").lower()
    cands = []
    if ext in ("jpg", "jpeg"):
        cands.append(path.with_suffix(".jgw"))
    elif ext == "png":
        cands.append(path.with_suffix(".pgw"))
    elif ext in ("tif", "tiff"):
        cands.append(path.with_suffix(".tfw"))
    elif len(ext) >= 2:
        cands.append(path.with_suffix("." + ext[0] + ext[-1] + "w"))
    if ext:
        cands.append(path.with_suffix("." + ext + "w"))
        cands.append(path.with_suffix("." + ext[0] + "w"))
    cands.append(path.with_suffix(".wld"))
    return cands


def read_world_file(path: Path):
    """World file → GDAL geotransform (inverse of writers/worldfile.py:
    world files store the CENTER of the upper-left pixel)."""
    for cand in world_file_candidates(path):
        if not cand.is_file():
            continue
        try:
            vals = [float(v) for v in cand.read_text().split()][:6]
        except ValueError:
            continue
        if len(vals) != 6:
            continue
        a, d, b, e, c, f = vals
        return [c - 0.5 * a - 0.5 * b, a, b, f - 0.5 * d - 0.5 * e, d, e]
    return None


def read_prj_epsg(path: Path):
    """EPSG code from a .prj sidecar ('EPSG:XXXX' or WKT AUTHORITY tag)."""
    prj = path.with_suffix(".prj")
    if not prj.is_file():
        return None
    text = prj.read_text().strip()
    if text.upper().startswith("EPSG:"):
        try:
            return int(text[5:])
        except ValueError:
            return None
    from .raster import parse_epsg

    return parse_epsg(text)


# ImageFile.__init__ and Image.open: these errors in a plugin's `_open`
# (or its `_accept`) mean "not this format, try the next plugin"
TRY_NEXT = (SyntaxError, IndexError, TypeError, KeyError, EOFError,
            struct.error)
# any other error of a plugin ends the open with its message (a decoder
# library that cannot be built raises RuntimeError)
FINAL = (ValueError, OSError, AttributeError, OverflowError, RuntimeError)


def _u32be(b: bytes, o: int = 0) -> int:
    return struct.unpack_from(">I", b, o)[0]


def _u16le(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _u32le(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", b, o)[0]


# How far the port follows the `_open` of a plugin it does not read: where
# it would raise one of TRY_NEXT, the probe raises it too; otherwise the
# plugin takes the file (each returns the format's name).
def _cur(blob: bytes) -> str:
    """CurImagePlugin._open up to the bitmap header's size: the largest of
    the entries, and the word at its offset (at the end of the entries for
    an offset of 0)."""
    m, pos = b"", 6
    for _ in range(_u16le(blob, 4)):
        s = blob[pos:pos + 16]
        pos += len(s)
        if not m:
            m = s
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise TypeError("No cursors were found")
    at = _u32le(m, 12) or pos
    _u32le(blob[at:at + 4])
    return "CUR"


def _ico(blob: bytes) -> str:
    count = _u16le(blob, 4)
    if not count or len(blob) < 6 + 16 * count:
        raise IndexError("no icon entries")
    return "ICO"


def _gbr(blob: bytes) -> str:
    header, version, width, height, depth = struct.unpack(">5I", blob[:20])
    if header < 20 or version not in (1, 2) or not width or not height \
            or depth not in (1, 4):
        raise SyntaxError("not a GIMP brush")
    if version == 2 and blob[20:24] != b"GIMP":
        raise SyntaxError("not a GIMP brush, bad magic number")
    return "GBR"


def _fli(blob: bytes) -> str:
    s = blob[:128]
    if not (_ACCEPT["FLI"](s) and s[20:22] == bytes(2)
            and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        raise SyntaxError("not an FLI/FLC file")
    return "FLI"


def _imt(blob: bytes) -> str:
    """ImtImagePlugin._open: "width n", "height n" and "pixel n8" lines
    before a form feed; a mode and a positive size take the file."""
    buffer, pos = blob[:100], 100
    if b"\n" not in buffer:
        raise SyntaxError("not an IM file")
    width = height = 0
    mode = ""
    field = re.compile(rb"([a-z]*) ([^ \r\n]*)")
    while True:
        if buffer:
            c, buffer = buffer[:1], buffer[1:]
        else:
            c, pos = blob[pos:pos + 1], pos + 1
        if not c or c == b"\x0c":
            break
        if b"\n" not in buffer:
            buffer += blob[pos:pos + 100]
            pos += 100
        lines = buffer.split(b"\n")
        c += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(c) == 1 or len(c) > 100:
            break
        if c[0] == ord(b"*"):
            continue
        m = field.match(c)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            width = int(v)
        elif k == b"height":
            height = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or width <= 0 or height <= 0:
        raise SyntaxError("not identified by this plugin")
    return "IMT"


def _iptc(blob: bytes) -> str:
    """IptcImagePlugin._open up to its size: the fields it reads, and the
    layer, size and compression tags it needs."""
    info: dict = {}
    pos = 0
    while True:
        s = blob[pos:pos + 5]
        pos += len(s)
        if not s.strip(b"\x00"):
            break
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise SyntaxError("invalid IPTC/NAA file")
        size = s[3]
        if size > 132:
            raise OSError("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            size = _u32be((bytes(4) + blob[pos:pos + size - 128])[-4:])
            pos += len(blob[pos:pos + size - 128])
        else:
            size = struct.unpack_from(">H", s, 3)[0]
        if tag == (8, 10):
            break
        data = blob[pos:pos + size] if size else None
        pos += len(data or b"")
        info[tag] = data
    layers, component = info[(3, 60)][0], info[(3, 60)][1]

    def value(key):
        return _u32be((bytes(4) + info[key])[-4:])

    width, height = value((3, 20)), value((3, 30))
    if value((3, 120)) not in (1, 5):
        raise OSError("Unknown IPTC image compression")
    mode = "L" if layers == 1 and not component else \
        {3: "RGB", 4: "CMYK"}.get(layers, "") if component else ""
    if not mode or width <= 0 or height <= 0:
        raise SyntaxError("not identified by this plugin")
    return "IPTC"


def _pcd(blob: bytes) -> str:
    s = blob[2048:2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise SyntaxError("not a PCD file")
    s[1538]
    return "PCD"


_ACCEPT = {
    "DIB": lambda p: _u32le(p) in (12, 40, 52, 56, 64, 108, 124),
    "AVIF": lambda p: p[4:8] == b"ftyp" and (
        p[8:12] in (b"avif", b"avis") or p[8:12] in (b"mif1", b"msf1")),
    "BLP": lambda p: p.startswith((b"BLP1", b"BLP2")),
    "BUFR": lambda p: p.startswith((b"BUFR", b"ZCZC")),
    "CUR": lambda p: p.startswith(b"\0\0\2\0"),
    "DDS": lambda p: p.startswith(b"DDS "),
    "EPS": lambda p: p.startswith(b"%!PS") or (
        len(p) >= 4 and _u32le(p) == 0xC6D3D0C5),
    "FLI": lambda p: len(p) >= 16 and _u16le(p, 4) in (0xAF11, 0xAF12)
    and _u16le(p, 14) in (0, 3),
    "FTEX": lambda p: p.startswith(b"FTEX"),
    "GBR": lambda p: len(p) >= 8 and _u32be(p) >= 20
    and _u32be(p, 4) in (1, 2),
    "GRIB": lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
    "HDF5": lambda p: p.startswith(b"\x89HDF\r\n\x1a\n"),
    "ICNS": lambda p: p.startswith(b"icns"),
    "ICO": lambda p: p.startswith(b"\0\0\1\0"),
    "MPEG": lambda p: p.startswith(b"\x00\x00\x01\xb3"),
    "TIFF": lambda p: p.startswith((b"MM\x00\x2a", b"II\x2a\x00",
                                    b"MM\x2a\x00", b"II\x00\x2a",
                                    b"MM\x00\x2b", b"II\x2b\x00")),
    "MSP": lambda p: p.startswith((b"DanM", b"LinS")),
    "PIXAR": lambda p: p.startswith(b"\200\350\000\000"),
    "WMF": lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\x00\x00",
                                   b"\x01\x00\x00\x00")),
    "XBM": lambda p: p.lstrip().startswith(b"#define"),
    "XPM": lambda p: p.startswith(b"/* XPM */"),
    "XVTHUMB": lambda p: p.startswith(b"P7 332"),
}
_PROBES = {"CUR": _cur, "ICO": _ico, "GBR": _gbr, "FLI": _fli, "IMT": _imt,
           "IPTC": _iptc, "PCD": _pcd}
# Pillow opens these but reads no pixels of them here: a stub without a
# handler, EPS without Ghostscript, MPEG without a decoder
NO_PIXELS = ("BUFR", "EPS", "GRIB", "HDF5", "MPEG", "WMF")


def _elsewhere(name: str):
    """The opener of a format the port does not read: it refuses every file
    the plugin would take."""
    def refuse(blob: bytes):
        if name in _PROBES:
            _PROBES[name](blob)
        if name in NO_PIXELS:
            raise RasterError(f"{name}: Pillow opens the file but reads no "
                              "pixels of it")
        raise RasterError(f"{name} files are not read by the port yet")
    return (name, _ACCEPT.get(name), refuse)


# Image.ID after Image.init(): the preinit plugins, then the rest in the
# order PIL/__init__.py lists them (a plugin without `_accept` is tried on
# every file). Each entry: (name, accept or None, opener); an opener gives
# a pixels.Opened, or the pixels.Decoded of an eager reader.
PLUGINS = (
    ("BMP", lambda p: p.startswith(bmp.SIGNATURE), bmp.read),
    _elsewhere("DIB"),
    ("GIF", lambda p: p[:6] in gif.SIGNATURES, gif.read),
    ("JPEG", lambda p: p.startswith(jpeg.SIGNATURE), jpeg.read),
    ("PPM", netpbm.accept, netpbm.read),
    ("PNG", lambda p: p.startswith(png.SIGNATURE), png.read),
    _elsewhere("AVIF"), _elsewhere("BLP"), _elsewhere("BUFR"),
    _elsewhere("CUR"),
    ("PCX", pcx.accept, pcx.open_image),
    ("DCX", pcx.dcx_accept, pcx.dcx_open_image),
    _elsewhere("DDS"), _elsewhere("EPS"),
    ("FITS", fits.accept, fits.open_image),
    _elsewhere("FLI"), _elsewhere("FTEX"), _elsewhere("GBR"),
    _elsewhere("GRIB"), _elsewhere("HDF5"),
    ("JPEG2000", lambda p: p.startswith(jpeg2000.SIGNATURES), jpeg2000.read),
    _elsewhere("ICNS"), _elsewhere("ICO"),
    ("IM", None, im.open_image),
    _elsewhere("IMT"), _elsewhere("IPTC"),
    ("MCIDAS", mcidas.accept, mcidas.open_image),
    _elsewhere("MPEG"), _elsewhere("TIFF"), _elsewhere("MSP"),
    _elsewhere("PCD"), _elsewhere("PIXAR"),
    ("PSD", psd.accept, psd.open_image),
    ("QOI", qoi.accept, qoi.open_image),
    ("SGI", sgi.accept, sgi.open_image),
    ("SPIDER", None, spider.open_image),
    ("SUN", sun.accept, sun.open_image),
    ("TGA", None, tga.open_image),
    ("WEBP", webp.accept, webp.read),
    _elsewhere("WMF"), _elsewhere("XBM"), _elsewhere("XPM"),
    _elsewhere("XVTHUMB"),
)
READS = ("PNG, JPEG, BMP, GIF, netpbm and PFM, WebP, JPEG 2000, PCX, DCX, "
         "FITS, IM, McIdas, PSD, QOI, SGI, SPIDER, Sun and TGA")


def open_image(blob: bytes) -> pixels.Decoded:
    """Pillow's `Image.open` and `load()` of `blob`: each plugin in turn
    whose `_accept` takes the first 16 bytes opens it; an error of
    TRY_NEXT hands it on, any other error (and Pillow's decompression-bomb
    limit on the opened size) ends with RasterError."""
    prefix = blob[:16]
    for name, accept, opener in PLUGINS:
        try:
            if accept is not None and not accept(prefix):
                continue
            got = opener(blob)
            if isinstance(got, pixels.Decoded):  # an eager reader
                return got
            width, height = got.size
            if not got.mode or width <= 0 or height <= 0:
                raise SyntaxError("not identified by this plugin")
        except TRY_NEXT:
            continue
        except RasterError:
            raise
        except FINAL as e:
            raise RasterError(str(e)) from e
        pixels.check_size(width, height)
        try:
            return got.load()
        except FINAL as e:
            raise RasterError(str(e)) from e
    raise RasterError(f"cannot identify image file (the port reads {READS})")


class PilRaster:
    """TiffReader-shaped adapter over a file open_image decodes (the JAX
    PilRaster's interface and
    normalisation, sarpro_tpu/io/pilraster.py:82-146).

    Implements the subset RasterReader drives: width/height/samples/dtype,
    read(band), geo_info(), gdal_metadata(), close(). The strip-streaming
    fast paths are TIFF-codec-only and stay disabled for this backend."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        try:
            blob = self.path.read_bytes()
        except OSError as e:
            raise RasterError(f"failed to open raster {self.path}: {e}") from e
        try:
            img = open_image(blob)
            self._data = pixels.normalise(img, self.path)
        except RasterError as e:
            raise RasterError(f"failed to open raster {self.path}: {e}") from e
        self.height, self.width = self._data.shape[:2]
        self.samples = self._data.shape[2]
        self.dtype = self._data.dtype
        self._info = {k: v for k, v in img.info.items() if isinstance(v, str)}

    def read(self, band: int = 1) -> np.ndarray:
        if not 1 <= band <= self.samples:
            raise RasterError(
                f"band {band} out of range (raster has {self.samples})")
        return self._data[:, :, band - 1]

    def geo_info(self) -> GeoInfo:
        gt = read_world_file(self.path)
        epsg = read_prj_epsg(self.path)
        return GeoInfo(geotransform=gt, epsg=epsg,
                       is_geographic=epsg == 4326)

    def gdal_metadata(self) -> dict:
        return dict(self._info)

    def close(self):
        self._data = None
