"""Non-TIFF raster backend (port of sarpro_tpu/io/pilraster.py): the JAX
package's PilRaster decodes every non-TIFF, non-netCDF file through
Pillow's `Image.open`, which the machine with the GPU does not have. The
port decodes them with its own readers, to the image Pillow opens, trying
Pillow 12.1's plugins in its order (open_image, PLUGINS):

  * PNG (io/png.py), JPEG (io/jpeg.py), BMP and DIB (io/bmp.py), GIF
    (io/gif.py), netpbm P1-P6, PFM and Pillow's extensions (io/netpbm.py),
    WebP (io/webp.py: lossy, lossless, alpha, the first frame of an
    animation), JPEG 2000 (io/jpeg2000.py: JP2 files and raw codestreams),
    FITS (io/fits.py), McIdas AREA (io/mcidas.py), SPIDER (io/spider.py),
    IM (io/im.py), SGI (io/sgi.py), TGA (io/tga.py), PCX and DCX
    (io/pcx.py), Sun raster (io/sun.py), PSD (io/psd.py), QOI (io/qoi.py),
    ICO and CUR (io/ico.py), ICNS (io/icns.py), DDS (io/dds.py) and FTEX
    (io/ftex.py) with their block-compressed textures (io/bcn.py), BLP
    (io/blp.py), XBM (io/xbm.py), XPM (io/xpm.py), MSP (io/msp.py), PIXAR
    (io/pixar.py), GBR (io/gbr.py), FLI / FLC (io/fli.py), PhotoCD
    (io/pcd.py), XV thumbnails (io/xvthumb.py), IM Tools (io/imt.py),
    IPTC/NAA (io/iptc.py) and AVIF images (io/avif.py: 8-, 10- and
    12-bit key frames of any sample layout with their in-loop filters and
    alpha, as a still item, a grid of items or the first frame of an
    `avis` image sequence);
  * the formats Pillow opens but reads no pixels of here (NO_PIXELS) raise
    RasterError saying so, and so does content no plugin takes.

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

import struct
from pathlib import Path

import numpy as np

from ..errors import RasterError
from . import (
    avif,
    blp,
    bmp,
    dds,
    fits,
    fli,
    ftex,
    gbr,
    gif,
    icns,
    ico,
    im,
    imt,
    iptc,
    jpeg,
    jpeg2000,
    mcidas,
    msp,
    netpbm,
    pcd,
    pcx,
    pixar,
    pixels,
    png,
    psd,
    qoi,
    sgi,
    spider,
    sun,
    tga,
    webp,
    xbm,
    xpm,
    xvthumb,
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


def _u32le(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", b, o)[0]


_ACCEPT = {
    "DIB": lambda p: _u32le(p) in (12, 40, 52, 56, 64, 108, 124),
    "AVIF": lambda p: p[4:8] == b"ftyp" and (
        p[8:12] in (b"avif", b"avis") or p[8:12] in (b"mif1", b"msf1")),
    "BUFR": lambda p: p.startswith((b"BUFR", b"ZCZC")),
    "CUR": lambda p: p.startswith(b"\0\0\2\0"),
    "EPS": lambda p: p.startswith(b"%!PS") or (
        len(p) >= 4 and _u32le(p) == 0xC6D3D0C5),
    "GRIB": lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
    "HDF5": lambda p: p.startswith(b"\x89HDF\r\n\x1a\n"),
    "ICO": lambda p: p.startswith(b"\0\0\1\0"),
    "MPEG": lambda p: p.startswith(b"\x00\x00\x01\xb3"),
    "TIFF": lambda p: p.startswith((b"MM\x00\x2a", b"II\x2a\x00",
                                    b"MM\x2a\x00", b"II\x00\x2a",
                                    b"MM\x00\x2b", b"II\x2b\x00")),
    "WMF": lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\x00\x00",
                                   b"\x01\x00\x00\x00")),
}
# Pillow opens these but reads no pixels of them here: a stub without a
# handler, EPS without Ghostscript, MPEG without a decoder
NO_PIXELS = ("BUFR", "EPS", "GRIB", "HDF5", "MPEG", "WMF")


def _elsewhere(name: str):
    """The opener of a format the port does not read: it refuses every file
    the plugin would take."""
    def refuse(blob: bytes):
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
    ("DIB", _ACCEPT["DIB"], bmp.dib_open),
    ("GIF", lambda p: p[:6] in gif.SIGNATURES, gif.read),
    ("JPEG", lambda p: p.startswith(jpeg.SIGNATURE), jpeg.read),
    ("PPM", netpbm.accept, netpbm.read),
    ("PNG", lambda p: p.startswith(png.SIGNATURE), png.read),
    ("AVIF", _ACCEPT["AVIF"], avif.read),
    ("BLP", blp.accept, blp.open_image),
    _elsewhere("BUFR"),
    ("CUR", _ACCEPT["CUR"], ico.cur_open),
    ("PCX", pcx.accept, pcx.open_image),
    ("DCX", pcx.dcx_accept, pcx.dcx_open_image),
    ("DDS", dds.accept, dds.open_image),
    _elsewhere("EPS"),
    ("FITS", fits.accept, fits.open_image),
    ("FLI", fli.accept, fli.open_image),
    ("FTEX", ftex.accept, ftex.open_image),
    ("GBR", gbr.accept, gbr.open_image),
    _elsewhere("GRIB"), _elsewhere("HDF5"),
    ("JPEG2000", lambda p: p.startswith(jpeg2000.SIGNATURES), jpeg2000.read),
    ("ICNS", icns.accept, icns.open_image),
    ("ICO", _ACCEPT["ICO"], ico.ico_read),
    ("IM", None, im.open_image),
    ("IMT", None, imt.open_image),
    ("IPTC", None, iptc.open_image),
    ("MCIDAS", mcidas.accept, mcidas.open_image),
    _elsewhere("MPEG"),
    # unreachable: RasterReader hands every II / MM file to TiffReader
    _elsewhere("TIFF"),
    ("MSP", msp.accept, msp.open_image),
    ("PCD", None, pcd.open_image),
    ("PIXAR", pixar.accept, pixar.open_image),
    ("PSD", psd.accept, psd.open_image),
    ("QOI", qoi.accept, qoi.open_image),
    ("SGI", sgi.accept, sgi.open_image),
    ("SPIDER", None, spider.open_image),
    ("SUN", sun.accept, sun.open_image),
    ("TGA", None, tga.open_image),
    ("WEBP", webp.accept, webp.read),
    _elsewhere("WMF"),
    ("XBM", xbm.accept, xbm.open_image),
    ("XPM", xpm.accept, xpm.open_image),
    ("XVTHUMB", xvthumb.accept, xvthumb.open_image),
)
READS = ("PNG, JPEG, BMP, DIB, GIF, netpbm and PFM, WebP, JPEG 2000, PCX, "
         "DCX, FITS, IM, IMT, McIdas, PSD, QOI, SGI, SPIDER, Sun, TGA, ICO, "
         "CUR, ICNS, DDS, FTEX, BLP, XBM, XPM, MSP, PIXAR, GBR, FLI, PCD, "
         "XV thumbnails, IPTC and AVIF")


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
        except RasterError:
            raise
        except Exception as e:  # Pillow's load fails on any error
            raise RasterError(str(e) or type(e).__name__) from e
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
