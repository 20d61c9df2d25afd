"""SAFE reading onto the GPU (port of sarpro_tpu/io/safe.py).

The metadata parser and the measurement-file discovery (`SafeMetadata`,
`TargetCrsArg`, `parse_comprehensive_metadata`,
`identify_polarization_files`) are copies of the JAX package's, held equal
by tests/test_torch_host_copies.py. The loaders are the port's own (the
reader glue of sarpro_tpu/io/safe.py:459-611 and :637-710), each in two
halves: `read_scene`, the host half, parses, plans the warp, reads and
box-reduces into host memory and touches no device (the batch driver's
loader threads run it); `upload_scene`, the device half, uploads and
finishes each band on the device. The openers (`open_band`, `open_pair`,
`open_dual_pol`, all through `open_scene`) run the two halves in turn, band
by band. With a target CRS, each band is warped on the device
(`io/warp`): a strong reduction is box-averaged on the host first, so only
the reduced f32 plane is uploaded. Without one, two openers differ in where
the downsample-on-read runs:
  * `open_dual_pol` (the synRGB JPEG): the rasters are read as raw u16 DN
    (never cast to f32 on the host, which would double their 800 MB per
    band at 20000 x 20000) and copied to the device, where the band stage
    resamples them. Band 1 is handed to `band_stage` as soon as it lands on
    the device: its kernels are queued, the call returns, and the device
    works on band 1 while band 2 is still being read from disk;
  * `open_band` and `open_pair` (the reader hints vv/vh/hh/hv and
    all_pairs: single bands, operations, multiband TIFF): with a target
    size each band takes the decimated read (`io/raster`), host box reduce
    or device resample with the reader's filter choice, as the JAX reader
    does; without one, the full-resolution u16 DN.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import logging
import xml.etree.ElementTree as ET
from enum import Enum
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .. import __version__ as _VERSION
from ..core.fused import _plan_read_dims
from ..errors import (
    ProcessingError,
    SafeMissingField,
    SafeParseError,
    UnsupportedProduct,
)
from . import geodesy, raster, warp
from .raster import RasterReader
from .tiffio import TiffReader

logger = logging.getLogger("sarpro")

SPEED_OF_LIGHT = 299_792_458.0


class TargetCrsArg(Enum):
    """Deferred 'auto' resolution (reference: sentinel1.rs:44-49)."""

    NONE = "none"
    AUTO = "auto"

    @staticmethod
    def custom(value: str) -> str:
        return value


@dataclasses.dataclass
class SafeMetadata:
    """~40 fields of product metadata (reference: sentinel1.rs:53-111)."""

    # Basic product information
    instrument: str = ""
    platform: str = ""
    acquisition_start: str = ""
    acquisition_stop: str = ""
    orbit_number: int = 0
    polarizations: list[str] = dataclasses.field(default_factory=list)
    lines: int = 0
    samples: int = 0
    product_type: str = ""
    # SAR parameters
    range_sampling_rate: Optional[float] = None
    radar_frequency: Optional[float] = None
    prf: Optional[float] = None
    tx_pulse_length: Optional[float] = None
    tx_pulse_ramp_rate: Optional[float] = None
    velocity: Optional[float] = None
    slant_range_near: Optional[float] = None
    # Georeferencing
    geotransform: Optional[list[float]] = None
    projection: Optional[str] = None
    crs: Optional[str] = None
    pixel_spacing_range: Optional[float] = None
    pixel_spacing_azimuth: Optional[float] = None
    # annotation geolocationGridPointList as (N,4) [pixel, line, lon, lat];
    # TPS control-point source when the measurement TIFF carries no GCPs
    geolocation_grid: Optional[np.ndarray] = None
    # Acquisition details
    instrument_mode: Optional[str] = None
    pass_direction: Optional[str] = None
    data_take_id: Optional[str] = None
    product_id: Optional[str] = None
    # Processing parameters
    processing_level: Optional[str] = None
    multilook_factor: Optional[int] = None
    calibration_type: Optional[str] = None
    noise_estimate: Optional[float] = None
    processing_center: Optional[str] = None
    software_version: Optional[str] = None
    # Image characteristics
    pixel_data_type: Optional[str] = None
    bits_per_sample: Optional[int] = None
    sample_format: Optional[str] = None
    # Additional SAR-specific
    incidence_angle: Optional[float] = None
    look_angle: Optional[float] = None
    doppler_centroid: Optional[float] = None
    radiometric_calibration: Optional[str] = None
    geometric_calibration: Optional[str] = None
    # Conversion provenance
    conversion_tool: str = "SARPRO"
    conversion_version: str = _VERSION
    conversion_timestamp: str = ""

    def copy(self) -> "SafeMetadata":
        return dataclasses.replace(
            self, polarizations=list(self.polarizations),
            geotransform=list(self.geotransform) if self.geotransform else None,
        )


def _localname(tag: str) -> str:
    """Strip XML namespace; the reference's quick-xml matcher keys on the
    written tag names (sentinel1.rs:1195-1273)."""
    if "}" in tag:
        tag = tag.split("}", 1)[1]
    if ":" in tag:
        tag = tag.split(":", 1)[1]
    return tag


def parse_manifest_safe(path: Path, meta: SafeMetadata) -> SafeMetadata:
    """Streaming state machine over manifest.safe sections
    (reference: sentinel1.rs:1176-1281)."""
    sections = {
        "platform": False, "acquisitionPeriod": False, "orbitReference": False,
        "facility": False, "software": False,
        "standAloneProductInformation": False, "orbitProperties": False,
    }
    curr = ""
    try:
        for event, elem in ET.iterparse(str(path), events=("start", "end")):
            tag = _localname(elem.tag)
            if event == "start":
                curr = tag
                if tag in sections:
                    sections[tag] = True
                continue
            # end event: elem.text is complete
            txt = (elem.text or "").strip()
            if txt:
                if tag == "familyName" and sections["platform"]:
                    meta.platform = txt
                elif tag == "instrument" and sections["platform"]:
                    meta.instrument = txt
                elif tag == "mode" and sections["platform"]:
                    meta.instrument_mode = txt
                elif tag == "startTime" and sections["acquisitionPeriod"]:
                    meta.acquisition_start = txt
                elif tag == "stopTime" and sections["acquisitionPeriod"]:
                    meta.acquisition_stop = txt
                elif tag == "orbitNumber" and sections["orbitReference"]:
                    try:
                        meta.orbit_number = int(txt)
                    except ValueError:
                        meta.orbit_number = 0
                elif tag == "pass" and sections["orbitProperties"]:
                    meta.pass_direction = txt
                elif tag == "productType" and sections["standAloneProductInformation"]:
                    meta.product_type = txt
                elif tag == "missionDataTakeID" and sections["standAloneProductInformation"]:
                    meta.data_take_id = txt
                elif tag == "productClass" and sections["standAloneProductInformation"]:
                    meta.processing_level = txt
                elif tag == "transmitterReceiverPolarisation" and sections["standAloneProductInformation"]:
                    meta.polarizations.append(txt)
                elif tag == "name" and sections["facility"]:
                    meta.processing_center = txt
                elif tag == "name" and sections["software"]:
                    meta.software_version = txt
                elif tag == "version" and sections["software"]:
                    meta.software_version = txt
            if tag in sections:
                sections[tag] = False
            elem.clear()
    except ET.ParseError as e:
        raise SafeParseError(f"manifest.safe parse error: {e}") from e
    return meta


def parse_annotation_xml(path: Path, meta: SafeMetadata) -> SafeMetadata:
    """Annotation XML state machine (reference: sentinel1.rs:1297-1442)."""
    in_ = {
        "adsHeader": False, "productInformation": False,
        "downlinkInformation": False, "downlinkValues": False,
        "orbitStateVector": False, "imageAnnotation": False,
        "geolocationGridPoint": False,
    }
    downlink_done = 0
    state_vectors: list[tuple[float, float, float]] = []
    current = [0.0, 0.0, 0.0]
    gg_points: list[tuple[float, float, float, float]] = []
    gg_current: dict[str, float] = {}
    try:
        for event, elem in ET.iterparse(str(path), events=("start", "end")):
            tag = _localname(elem.tag)
            if event == "start":
                if tag == "downlinkInformation":
                    if downlink_done == 0:
                        in_["downlinkInformation"] = True
                elif tag in in_:
                    in_[tag] = True
                continue
            txt = (elem.text or "").strip()

            def fget(t=txt):
                try:
                    return float(t)
                except ValueError:
                    return None

            if txt:
                if in_["adsHeader"]:
                    if tag == "missionId":
                        meta.platform = txt
                    elif tag == "productType":
                        meta.product_type = txt
                    elif tag == "polarisation":
                        meta.polarizations.append(txt)
                    elif tag == "mode":
                        meta.instrument_mode = txt
                    elif tag == "startTime":
                        meta.acquisition_start = txt
                    elif tag == "stopTime":
                        meta.acquisition_stop = txt
                    elif tag == "absoluteOrbitNumber":
                        try:
                            meta.orbit_number = int(txt)
                        except ValueError:
                            meta.orbit_number = 0
                    elif tag == "missionDataTakeId":
                        meta.data_take_id = txt
                if in_["productInformation"]:
                    if tag == "pass":
                        meta.pass_direction = txt
                    elif tag == "rangeSamplingRate":
                        meta.range_sampling_rate = fget()
                    elif tag == "radarFrequency":
                        meta.radar_frequency = fget()
                if in_["downlinkInformation"] and tag == "prf" and meta.prf is None:
                    meta.prf = fget()
                if in_["downlinkValues"]:
                    if tag == "txPulseLength" and meta.tx_pulse_length is None:
                        meta.tx_pulse_length = fget()
                    elif tag == "txPulseRampRate" and meta.tx_pulse_ramp_rate is None:
                        meta.tx_pulse_ramp_rate = fget()
                if in_["imageAnnotation"]:
                    if tag == "slantRangeTime" and meta.slant_range_near is None:
                        srt = fget() or 0.0
                        meta.slant_range_near = srt * SPEED_OF_LIGHT / 2.0
                    elif tag == "rangePixelSpacing":
                        meta.pixel_spacing_range = fget()
                    elif tag == "azimuthPixelSpacing":
                        meta.pixel_spacing_azimuth = fget()
                if in_["orbitStateVector"]:
                    if tag == "vx":
                        current[0] = fget() or 0.0
                    elif tag == "vy":
                        current[1] = fget() or 0.0
                    elif tag == "vz":
                        current[2] = fget() or 0.0
                if in_["geolocationGridPoint"] and tag in (
                        "pixel", "line", "longitude", "latitude"):
                    v = fget()
                    if v is not None:
                        gg_current[tag] = v
                # image dimensions — matched anywhere (reference: :1421-1424)
                if tag == "lines":
                    try:
                        meta.lines = int(txt)
                    except ValueError:
                        pass
                elif tag in ("samplesPerLine", "numberOfSamples"):
                    try:
                        meta.samples = int(txt)
                    except ValueError:
                        pass
            # end-of-section bookkeeping
            if tag == "downlinkInformation" and in_["downlinkInformation"]:
                in_["downlinkInformation"] = False
                downlink_done += 1
            elif tag == "orbitStateVector":
                in_["orbitStateVector"] = False
                state_vectors.append(tuple(current))
                current = [0.0, 0.0, 0.0]
            elif tag == "geolocationGridPoint":
                in_["geolocationGridPoint"] = False
                if all(k in gg_current
                       for k in ("pixel", "line", "longitude", "latitude")):
                    gg_points.append((gg_current["pixel"], gg_current["line"],
                                      gg_current["longitude"],
                                      gg_current["latitude"]))
                gg_current = {}
            elif tag in in_:
                in_[tag] = False
            elem.clear()
    except ET.ParseError as e:
        raise SafeParseError(f"annotation parse error: {e}") from e
    if state_vectors:
        vx, vy, vz = state_vectors[len(state_vectors) // 2]
        meta.velocity = float(np.sqrt(vx * vx + vy * vy + vz * vz))
    if gg_points and meta.geolocation_grid is None:
        meta.geolocation_grid = np.asarray(gg_points, np.float64)
    return meta


def _parse_comprehensive(base: Path) -> SafeMetadata:
    meta = SafeMetadata(
        conversion_timestamp=datetime.datetime.now(datetime.timezone.utc).isoformat()
    )
    manifest = base / "manifest.safe"
    if manifest.exists():
        meta = parse_manifest_safe(manifest, meta)
    annotation = base / "annotation"
    if annotation.is_dir():
        for p in sorted(annotation.iterdir()):
            if p.suffix == ".xml":
                meta = parse_annotation_xml(p, meta)
    return meta


@functools.lru_cache(maxsize=32)
def _parse_comprehensive_cached(base_str: str, _stamp) -> SafeMetadata:
    return _parse_comprehensive(Path(base_str))


def parse_comprehensive_metadata(base: Path) -> SafeMetadata:
    """manifest.safe + annotation files (reference: sentinel1.rs:1114-1174).

    Memoized on (path, manifest/annotation mtimes): the batch paths run the
    metadata-only viability check (api.scene_skip_reason) and then open the
    product, which would otherwise parse every annotation XML twice per
    scene. Callers get a defensive copy — downstream loaders mutate the
    geotransform/dims fields."""
    base = Path(base)
    try:
        stamp = (
            (base / "manifest.safe").stat().st_mtime_ns,
            (base / "annotation").stat().st_mtime_ns,
        )
    except OSError:
        return _parse_comprehensive(base)
    return _parse_comprehensive_cached(str(base), stamp).copy()


def identify_polarization_files(measurement: Path, available: list[str]):
    """Find per-pol measurement TIFFs by filename substring, with `_warped`
    skip and single-file inference fallback (reference: sentinel1.rs:799-882)."""
    vv = vh = hh = hv = None
    for path in sorted(measurement.iterdir()):
        name = path.name.lower()
        if not (name.endswith(".tiff") or name.endswith(".tif")):
            continue
        if "_warped.tif" in name or "_warped.tiff" in name:
            continue
        if "vv" in name:
            vv = path
            logger.info("Found VV file: %s", path)
        elif "vh" in name:
            vh = path
            logger.info("Found VH file: %s", path)
        elif "hh" in name:
            hh = path
            logger.info("Found HH file: %s", path)
        elif "hv" in name:
            hv = path
            logger.info("Found HV file: %s", path)
    if vv is None and vh is None and hh is None and hv is None:
        logger.info("No polarization-specific files found; inferring from "
                    "available polarizations: %s", available)
        for path in sorted(measurement.iterdir()):
            if path.suffix.lower() not in (".tiff", ".tif"):
                continue
            for pol in available:
                p = pol.lower()
                if p == "vv":
                    vv = path
                    break
                if p == "vh":
                    vh = path
                    break
                if p == "hh":
                    hh = path
                    break
            if vv or vh or hh:
                break
    return vv, vh, hh, hv


@dataclasses.dataclass
class DualPolScene:
    """A co-/cross-pol pair on the device, with the product's metadata."""

    metadata: SafeMetadata
    band1: torch.Tensor  # co-pol (VV or HH): u16 DN, or f32 when warped or
    band2: torch.Tensor  # decimated; cross-pol (VH or HV) likewise
    is_vvvh: bool
    staged_band1: object = None  # band_stage(band1), queued during the read


@dataclasses.dataclass
class HostScene:
    """A product read on the host, the host half of an opener: its
    metadata (complete once every band is read) and one band (a single
    polarization) or two (co-pol, cross-pol), each with the device work
    that finishes it (`upload_scene`)."""

    metadata: SafeMetadata
    bands: list  # raster.HostBand
    is_vvvh: Optional[bool] = None  # pairs: VV+VH rather than HH+HV


def _read_dn(path: Path, metadata: SafeMetadata,
             target_size: Optional[int]) -> raster.HostBand:
    """Full-resolution DN in host memory, u16 as stored (f32 for other
    sample types). Records the raster's geotransform and projection in
    `metadata`, and as its size the read size that `target_size` plans
    (reference: sentinel1.rs:1084-1102)."""
    logger.info("Loading underlying data from: %s", path)
    reader = RasterReader(path)
    try:
        metadata.geotransform = list(reader.metadata.geotransform)
        metadata.projection = reader.metadata.projection
        metadata.crs = reader.metadata.projection
    finally:
        reader.close()
    tiff = TiffReader(path)
    try:
        arr = tiff.read(1)
    finally:
        tiff.close()
    arr = (arr.astype(np.uint16, copy=False) if arr.dtype.kind == "u"
           and arr.dtype.itemsize == 2 else arr.astype(np.float32))
    metadata.lines, metadata.samples, _ = _plan_read_dims(*arr.shape,
                                                          target_size)
    return raster.HostBand(torch.from_numpy(arr))


def _read_decimated(path: Path, metadata: SafeMetadata, target_size: int,
                    resample_alg: Optional[str],
                    staging: Optional[raster.HostStaging]
                    ) -> raster.HostBand:
    """The decimated read at `target_size` (long side), with the reader's
    filter: the user's, else average for a 4x or stronger reduction and
    lanczos below (reference: sentinel1.rs:1084-1112)."""
    logger.info("Reading at target size (long side): %d", target_size)
    reader = RasterReader(path)
    try:
        metadata.geotransform = list(reader.metadata.geotransform)
        metadata.projection = reader.metadata.projection
        metadata.crs = reader.metadata.projection
        rows, cols, filt = _plan_read_dims(
            reader.metadata.size_y, reader.metadata.size_x, target_size,
            resample_alg)
        band = raster.reduce_band(reader, 1, cols, rows, filt, staging)
    finally:
        reader.close()
    metadata.lines, metadata.samples = rows, cols
    return band


def _read_band(path: Path, metadata: SafeMetadata,
               target_size: Optional[int], target_crs: Optional[str],
               resample_alg: Optional[str], decimate: bool,
               staging: Optional[raster.HostStaging]) -> raster.HostBand:
    """The host half of one band: planned for a warp to `target_crs` when
    it is set (reference: sentinel1.rs:914-1071), else decimated on read
    when `decimate` and a target size are set, else the DN as stored."""
    if not target_crs:
        if decimate and target_size is not None:
            return _read_decimated(path, metadata, target_size,
                                   resample_alg, staging)
        return _read_dn(path, metadata, target_size)
    logger.info("Warping to target CRS: %s", target_crs)
    reader = RasterReader(path)
    try:
        # skip-warp guard when already in the target CRS (reference:
        # :959-986): the full-resolution DN, which the band stage resamples
        ds_epsg = reader.metadata.epsg
        dst_epsg = geodesy.parse_epsg_code(target_crs)
        if ds_epsg is not None and ds_epsg == dst_epsg:
            logger.info("Input already in target CRS (%s); skipping warp",
                        target_crs)
            return _read_dn(path, metadata, None)
        result = warp.plan_to_host(
            reader, target_crs, resample_alg=resample_alg or "bilinear",
            target_size=target_size,
            geolocation_grid=metadata.geolocation_grid, staging=staging)
    finally:
        reader.close()
    metadata.geotransform = list(result.geotransform)
    metadata.projection = result.projection
    metadata.crs = result.projection
    metadata.lines, metadata.samples = result.band.shape
    return result.band


@dataclasses.dataclass
class _Product:
    """A parsed GRD product before any band is loaded."""

    metadata: SafeMetadata
    paths: dict  # "vv" / "vh" / "hh" / "hv" -> measurement TIFF or None
    crs: Optional[str]  # the effective target CRS, None without a warp


def _open_product(safe_dir, target_crs) -> _Product:
    """Check the tree, parse the metadata, refuse non-GRD products, find the
    measurement files and resolve the target CRS once per product
    (reference: sentinel1.rs:169-175)."""
    base = Path(safe_dir)
    if not (base / "annotation").is_dir():
        raise SafeMissingField("annotation directory")
    if not (base / "measurement").is_dir():
        raise SafeMissingField("measurement directory")
    metadata = parse_comprehensive_metadata(base)
    if metadata.product_type.upper() != "GRD":
        raise UnsupportedProduct(metadata.product_type)
    found = identify_polarization_files(base / "measurement",
                                        metadata.polarizations)
    if isinstance(target_crs, str):
        crs: Optional[str] = target_crs
    elif target_crs is TargetCrsArg.AUTO:
        crs = geodesy.resolve_auto_target_crs(base)
    else:  # None or TargetCrsArg.NONE
        crs = None
    return _Product(metadata, dict(zip(("vv", "vh", "hh", "hv"), found)), crs)


def _pair(product: _Product, what: str):
    """VV+VH, else HH+HV (reference: api/mod.rs:133-143): (co-pol path,
    cross-pol path, is_vvvh)."""
    p = product.paths
    if p["vv"] is not None and p["vh"] is not None:
        return p["vv"], p["vh"], True
    if p["hh"] is not None and p["hv"] is not None:
        return p["hh"], p["hv"], False
    avail = ", ".join(k.upper() for k, v in p.items() if v is not None)
    raise ProcessingError(f"{what} requires VV+VH or HH+HV; available: "
                          f"{avail or 'none'}")


def _scene_bands(safe_dir, pol: Optional[str], what: str,
                 target_size: Optional[int], target_crs,
                 resample_alg: Optional[str], decimate: bool, staging):
    """(metadata, is_vvvh, bands): the product parsed, and a generator that
    reads each band's host half only when it is asked for the next one.
    `pol` is one polarization ("vv", "vh", "hh" or "hv"; metadata lists
    it), or None for the preferred co-/cross-pol pair (the JAX reader's
    "all_pairs" hint: metadata lists all four); `what` names the caller in
    the missing-pair error. `staging` (a `raster.HostStaging`) takes the
    reduced planes, one band after the other."""
    product = _open_product(safe_dir, target_crs)
    if pol is not None:
        path = product.paths[pol]
        if path is None:
            raise SafeMissingField(f"{pol.upper()} measurement file")
        paths, is_vvvh = [path], None
        product.metadata.polarizations = [pol.upper()]
    else:
        *paths, is_vvvh = _pair(product, what)
        product.metadata.polarizations = ["VV", "VH", "HH", "HV"]
    bands = (_read_band(p, product.metadata, target_size, product.crs,
                        resample_alg, decimate, staging) for p in paths)
    return product.metadata, is_vvvh, bands


def read_scene(safe_dir, pol: Optional[str] = None, what: str = "Multiband",
               target_size: Optional[int] = None, target_crs=None,
               resample_alg: Optional[str] = None, decimate: bool = True,
               staging: Optional[raster.HostStaging] = None) -> HostScene:
    """The host half of `open_band` (`pol` given), `open_pair` (`pol`
    None) and `open_dual_pol` (`pol` None, `decimate` False): parse, plan,
    read and reduce every band into host memory (`staging` for the reduced
    planes). Touches no device: the batch driver's loader threads run it."""
    metadata, is_vvvh, bands = _scene_bands(
        safe_dir, pol, what, target_size, target_crs, resample_alg, decimate,
        staging)
    return HostScene(metadata, list(bands), is_vvvh)


def _device_scene(metadata: SafeMetadata, bands, is_vvvh, device,
                  band_stage, shard_devices: int = 0) -> DualPolScene:
    """The device half of each host band in turn; `band_stage(band1)` is
    queued before band 2 is asked for (a generator then reads it).
    `shard_devices` splits a warp's output rows (`raster.band_to_device`)."""
    out, staged = [], None
    for hb in bands:
        out.append(raster.band_to_device(hb, device, shard_devices))
        if band_stage is not None and len(out) == 1:
            staged = band_stage(out[0])
    return DualPolScene(metadata, out[0], out[1] if len(out) > 1 else None,
                        is_vvvh, staged)


def upload_scene(scene: HostScene, device,
                 band_stage: Optional[Callable[[torch.Tensor], object]] = None,
                 shard_devices: int = 0) -> DualPolScene:
    """The device half of a `HostScene`: each band uploaded and finished
    on `device` (warped, resampled), band 1's `band_stage` queued before
    band 2's upload. Queues copies and kernels and waits for none; runs on
    the thread that owns the device work. A single band comes back as
    `band1` (band2 None). `shard_devices` (0 none, -1 all) splits a warp's
    output rows over the caller's devices."""
    return _device_scene(scene.metadata, scene.bands, scene.is_vvvh,
                         torch.device(device), band_stage, shard_devices)


def open_scene(safe_dir, device, pol: Optional[str] = None,
               what: str = "Multiband", target_size: Optional[int] = None,
               target_crs=None, resample_alg: Optional[str] = None,
               decimate: bool = True,
               band_stage: Optional[Callable[[torch.Tensor], object]] = None,
               shard_devices: int = 0) -> DualPolScene:
    """`read_scene` and `upload_scene` in turn, band by band: each band's
    host half, then its device half (on a GPU, each reduced chunk uploads
    while the next one reduces), band 1's `band_stage` queued while band 2
    is read."""
    device = torch.device(device)
    metadata, is_vvvh, bands = _scene_bands(
        safe_dir, pol, what, target_size, target_crs, resample_alg, decimate,
        raster.upload_staging(device))
    return _device_scene(metadata, bands, is_vvvh, device, band_stage,
                         shard_devices)


def open_band(safe_dir, pol: str, device, target_size: Optional[int] = None,
              target_crs=None, resample_alg: Optional[str] = None):
    """One polarization ("vv", "vh", "hh" or "hv") onto `device`, as the
    JAX reader's single-band hints load it: (metadata, band)."""
    scene = open_scene(safe_dir, device, pol, "", target_size, target_crs,
                       resample_alg)
    return scene.metadata, scene.band1


def open_pair(safe_dir, device, what: str, target_size: Optional[int] = None,
              target_crs=None, resample_alg: Optional[str] = None
              ) -> DualPolScene:
    """The preferred co-/cross-pol pair onto `device`, as the JAX reader's
    "all_pairs" hint loads it (metadata lists all four polarizations). Both
    bands are reduced on read, before any operation combines them.
    `what` names the caller in the missing-pair error."""
    return open_scene(safe_dir, device, None, what, target_size, target_crs,
                      resample_alg)


def open_dual_pol(safe_dir, device, target_size: Optional[int] = None,
                  band_stage: Optional[Callable[[torch.Tensor], object]] = None,
                  target_crs=None, resample_alg: Optional[str] = None
                  ) -> DualPolScene:
    """Open a GRD SAFE and load its VV+VH pair (else HH+HV) onto `device`
    (reference: api/mod.rs:133-143 pair preference) as full-resolution DN
    (or warped), which the band stage resamples. `target_crs` is None, a
    `TargetCrsArg` or an EPSG string; `resample_alg` is the warp's filter
    (bilinear when unset)."""
    return open_scene(safe_dir, device, None, "Multiband", target_size,
                      target_crs, resample_alg, decimate=False,
                      band_stage=band_stage)


class SafeReader:
    """The JAX package's reader object (sarpro_tpu/io/safe.py:402-801, the
    reference's sentinel1.rs:114-122) over the port's loaders: each band is
    read by `_read_band` (the warp to a target CRS, else the decimated read
    at a target size, else the raster as stored) and finished on `device`
    by the calling thread, one band after the other (the JAX reader loads a
    pair on two threads; here every upload and kernel of a product stays on
    the thread that opens it). Bands are f32 tensors on `device`, the JAX
    reader's arrays; the polarization hints, the metadata they leave, the
    warnings-mode skips and the operation accessors are the JAX reader's."""

    def __init__(self, base_path: Path, metadata: SafeMetadata,
                 product_type: str, vv=None, vh=None, hh=None, hv=None):
        self.base_path = base_path
        self.metadata = metadata
        self.product_type = product_type
        self._vv = vv
        self._vh = vh
        self._hh = hh
        self._hv = hv
        # band_stage(first band of a pair), when one was given
        self.staged_band1 = None

    # -- opening --------------------------------------------------------------
    @classmethod
    def open(cls, safe_dir, polarization: Optional[str] = None,
             device="cuda") -> "SafeReader":
        return cls.open_with_options(safe_dir, polarization, device=device)

    @classmethod
    def open_with_options(cls, safe_dir, polarization: Optional[str] = None,
                          target_crs=None, resample_alg: Optional[str] = None,
                          target_size: Optional[int] = None, band_stage=None,
                          device="cuda") -> "SafeReader":
        return cls._open(safe_dir, polarization, target_crs, resample_alg,
                         target_size, False, band_stage, device)

    @classmethod
    def open_with_warnings(cls, safe_dir, polarization: Optional[str] = None,
                           device="cuda"):
        """Batch-tolerant open: returns None to skip unsupported products
        (reference: sentinel1.rs:404-589)."""
        return cls._open(safe_dir, polarization, None, None, None, True,
                         None, device)

    @classmethod
    def open_with_warnings_with_options(
        cls, safe_dir, polarization=None, target_crs=None,
        resample_alg: Optional[str] = None, target_size: Optional[int] = None,
        device="cuda",
    ):
        """reference: sentinel1.rs:592-796."""
        return cls._open(safe_dir, polarization, target_crs, resample_alg,
                         target_size, True, None, device)

    @classmethod
    def _open(cls, safe_dir, polarization, target_crs, resample_alg,
              target_size, warnings_mode: bool, band_stage, device):
        from ..core.numerics import as_f32

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        base = Path(safe_dir)
        if not (base / "annotation").is_dir():
            raise SafeMissingField("annotation directory")
        if not (base / "measurement").is_dir():
            raise SafeMissingField("measurement directory")
        metadata = parse_comprehensive_metadata(base)
        if metadata.product_type.upper() != "GRD":
            if warnings_mode:
                logger.warning("Skipping unsupported product type: %s "
                               "(file: %s)", metadata.product_type, base)
                return None
            raise UnsupportedProduct(metadata.product_type)
        vv_path, vh_path, hh_path, hv_path = identify_polarization_files(
            base / "measurement", metadata.polarizations)
        if isinstance(target_crs, str):
            crs: Optional[str] = target_crs
        elif target_crs is TargetCrsArg.AUTO:
            crs = geodesy.resolve_auto_target_crs(base)
        else:  # None or TargetCrsArg.NONE
            crs = None

        def load(path):
            hb = _read_band(path, metadata, target_size, crs, resample_alg,
                            True, raster.upload_staging(device))
            return as_f32(raster.band_to_device(hb, device))

        staged = [None]

        def load_pair(p1, p2, stage: bool = True):
            a1 = load(p1)
            if stage and band_stage is not None:
                staged[0] = band_stage(a1)  # queued before band 2 is read
            return a1, load(p2)

        def missing(what):
            if warnings_mode:
                logger.warning("%s measurement file not found, skipping "
                               "product", what)
                return None
            raise SafeMissingField(f"{what} measurement file")

        vv = vh = hh = hv = None
        pol = polarization
        if pol in ("vv", "vh", "hh", "hv", None):
            pol = pol or "vv"
            metadata.polarizations = [pol.upper()]
            path = {"vv": vv_path, "vh": vh_path, "hh": hh_path,
                    "hv": hv_path}[pol]
            if path is None:
                return missing(pol.upper())
            band = load(path)
            vv, vh, hh, hv = (band if pol == p else None
                              for p in ("vv", "vh", "hh", "hv"))
        elif pol in ("multiband", "vv_vh_pair"):
            if pol == "vv_vh_pair":
                metadata.polarizations = ["VV", "VH"]
            # multiband leaves the polarizations as parsed (reference:
            # :248-275)
            if vv_path is None:
                return missing("VV")
            if vh_path is None:
                return missing("VH")
            vv, vh = load_pair(vv_path, vh_path)
        elif pol == "hh_hv_pair":
            metadata.polarizations = ["HH", "HV"]
            if hh_path is None:
                return missing("HH")
            if hv_path is None:
                return missing("HV")
            hh, hv = load_pair(hh_path, hv_path)
        elif pol == "all_pairs":
            metadata.polarizations = ["VV", "VH", "HH", "HV"]
            # band_stage applies to the pair multiband prefers (VV+VH when
            # present, else HH+HV)
            if vv_path is not None and vh_path is not None:
                vv, vh = load_pair(vv_path, vh_path)
            else:
                vv = load(vv_path) if vv_path is not None else None
                vh = load(vh_path) if vh_path is not None else None
            if hh_path is not None and hv_path is not None:
                hh, hv = load_pair(hh_path, hv_path,
                                   stage=vv is None or vh is None)
            else:
                hh = load(hh_path) if hh_path is not None else None
                hv = load(hv_path) if hv_path is not None else None
        else:
            if warnings_mode:
                logger.warning("Unsupported polarization: %s, skipping "
                               "product", pol)
                return None
            raise SafeParseError(f"Unsupported polarization: {pol}")
        reader = cls(base, metadata, "GRD", vv, vh, hh, hv)
        reader.staged_band1 = staged[0]
        return reader

    # -- accessors ------------------------------------------------------------
    def data(self):
        """VV if available, else VH (reference: sentinel1.rs:1450-1458)."""
        if self._vv is not None:
            return self._vv
        if self._vh is not None:
            return self._vh
        raise SafeMissingField("no polarization data available")

    def vv_data(self):
        if self._vv is None:
            raise SafeMissingField("vv_data")
        return self._vv

    def vh_data(self):
        if self._vh is None:
            raise SafeMissingField("vh_data")
        return self._vh

    def hh_data(self):
        if self._hh is None:
            raise SafeMissingField("hh_data")
        return self._hh

    def hv_data(self):
        if self._hv is None:
            raise SafeMissingField("hv_data")
        return self._hv

    def has_vv(self):
        return self._vv is not None

    def has_vh(self):
        return self._vh is not None

    def has_hh(self):
        return self._hh is not None

    def has_hv(self):
        return self._hv is not None

    # dual-pol operation accessors (reference: sentinel1.rs:1497-1579)
    def _op(self, a, b, name):
        from ..core import ops

        logger.info("Computing %s", name)
        return ops.OPERATIONS[name](a, b)

    def sum_data(self):
        return self._op(self.vv_data(), self.vh_data(), "sum")

    def difference_data(self):
        return self._op(self.vv_data(), self.vh_data(), "diff")

    def ratio_data(self):
        return self._op(self.vv_data(), self.vh_data(), "ratio")

    def normalized_diff_data(self):
        return self._op(self.vv_data(), self.vh_data(), "n-diff")

    def log_ratio_data(self):
        return self._op(self.vv_data(), self.vh_data(), "log-ratio")

    def sum_hh_hv_data(self):
        return self._op(self.hh_data(), self.hv_data(), "sum")

    def difference_hh_hv_data(self):
        return self._op(self.hh_data(), self.hv_data(), "diff")

    def ratio_hh_hv_data(self):
        return self._op(self.hh_data(), self.hv_data(), "ratio")

    def normalized_diff_hh_hv_data(self):
        return self._op(self.hh_data(), self.hv_data(), "n-diff")

    def log_ratio_hh_hv_data(self):
        return self._op(self.hh_data(), self.hv_data(), "log-ratio")

    def get_available_polarizations(self) -> str:
        """reference: sentinel1.rs:1582-1603."""
        avail = [name for name, band in (("VV", self._vv), ("VH", self._vh),
                                         ("HH", self._hh), ("HV", self._hv))
                 if band is not None]
        return ", ".join(avail) if avail else "none"
