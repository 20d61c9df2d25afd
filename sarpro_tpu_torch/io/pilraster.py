"""Non-TIFF raster backend (port of sarpro_tpu/io/pilraster.py): the JAX
package's PilRaster decodes PNG / JPEG / BMP / GIF / PPM / WebP / JPEG 2000
through Pillow, which the machine with the GPU does not have. The port
decodes them with its own readers, to the image Pillow opens, dispatching on
the first bytes as Pillow's `Image.open` does:

  * PNG (io/png.py), JPEG (io/jpeg.py), BMP (io/bmp.py), GIF (io/gif.py),
    netpbm P1-P6 (io/netpbm.py), WebP (io/webp.py: lossy, lossless, alpha,
    the first frame of an animation) and JPEG 2000 (io/jpeg2000.py: JP2
    files and raw codestreams);
  * any other content raises RasterError.

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

from pathlib import Path

import numpy as np

from ..errors import RasterError
from . import bmp, gif, jpeg, jpeg2000, netpbm, pixels, png, webp
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


def _reader(head: bytes):
    """The port's reader for content starting with `head`, as Pillow's
    plugins accept it; RasterError for anything else."""
    if head.startswith(png.SIGNATURE):
        return png.read
    if head.startswith(jpeg.SIGNATURE):
        return jpeg.read
    if head.startswith(bmp.SIGNATURE):
        return bmp.read
    if head[:6] in gif.SIGNATURES:
        return gif.read
    if netpbm.accept(head):
        return netpbm.read
    if webp.accept(head):
        return webp.read
    if head.startswith(jpeg2000.SIGNATURES):
        return jpeg2000.read
    raise RasterError("cannot identify image file (the port reads PNG, "
                      "JPEG, BMP, GIF, netpbm, WebP and JPEG 2000)")


class PilRaster:
    """TiffReader-shaped adapter over a decoded PNG, JPEG, BMP, GIF,
    netpbm, WebP or JPEG 2000 file (the JAX PilRaster's interface and
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
            img = _reader(blob[:16])(blob)
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
