"""Metadata extraction, TIFF embedding, JSON sidecars
(reference: src/io/writers/metadata.rs:20-437)."""
# A copy of sarpro_tpu/io/writers/metadata.py, so that the port imports nothing
# of the JAX package; tests/test_torch_host_copies.py holds the two equal.
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

from ..safe import SafeMetadata

logger = logging.getLogger("sarpro")


def _op_polarization_label(meta: SafeMetadata, operation: Optional[str]) -> str:
    """Operation-aware POLARIZATIONS label like 'SUM(VV, VH)'
    (reference: metadata.rs:40-113)."""
    pols = meta.polarizations
    has_vvvh = "VV" in pols and "VH" in pols
    has_hhhv = "HH" in pols and "HV" in pols
    prefixes = {
        "sum": "SUM", "difference": "DIFF", "ratio": "RATIO",
        "normalized_diff": "NORM_DIFF", "log_ratio": "LOG_RATIO",
    }
    if operation in prefixes:
        p = prefixes[operation]
        if has_vvvh:
            return f"{p}(VV, VH)"
        if has_hhhv:
            return f"{p}(HH, HV)"
        return ",".join(pols)
    if operation == "multiband_vv_vh":
        return "MULTIBAND(VV, VH)"
    if operation == "multiband_hh_hv":
        return "MULTIBAND(HH, HV)"
    return ",".join(pols)


def extract_metadata_fields(meta: SafeMetadata, operation: Optional[str] = None) -> dict[str, str]:
    """~35 UPPER_SNAKE metadata keys (reference: metadata.rs:20-229)."""
    md: dict[str, str] = {}
    md["INSTRUMENT"] = meta.instrument
    md["PLATFORM"] = meta.platform
    md["ACQUISITION_START"] = meta.acquisition_start
    md["ACQUISITION_STOP"] = meta.acquisition_stop
    md["ORBIT_NUMBER"] = str(meta.orbit_number)
    md["POLARIZATIONS"] = _op_polarization_label(meta, operation)
    md["PRODUCT_TYPE"] = meta.product_type

    def opt(key, value):
        if value is not None:
            md[key] = _fmt(value)

    opt("RANGE_SAMPLING_RATE", meta.range_sampling_rate)
    opt("RADAR_FREQUENCY", meta.radar_frequency)
    opt("PRF", meta.prf)
    opt("TX_PULSE_LENGTH", meta.tx_pulse_length)
    opt("TX_PULSE_RAMP_RATE", meta.tx_pulse_ramp_rate)
    opt("VELOCITY", meta.velocity)
    opt("SLANT_RANGE_NEAR", meta.slant_range_near)
    opt("PIXEL_SPACING_RANGE", meta.pixel_spacing_range)
    opt("PIXEL_SPACING_AZIMUTH", meta.pixel_spacing_azimuth)
    opt("INSTRUMENT_MODE", meta.instrument_mode)
    opt("PASS_DIRECTION", meta.pass_direction)
    opt("DATA_TAKE_ID", meta.data_take_id)
    opt("PRODUCT_ID", meta.product_id)
    opt("PROCESSING_LEVEL", meta.processing_level)
    opt("MULTILOOK_FACTOR", meta.multilook_factor)
    opt("CALIBRATION_TYPE", meta.calibration_type)
    opt("NOISE_ESTIMATE", meta.noise_estimate)
    opt("PROCESSING_CENTER", meta.processing_center)
    opt("SOFTWARE_VERSION", meta.software_version)
    opt("PIXEL_DATA_TYPE", meta.pixel_data_type)
    opt("BITS_PER_SAMPLE", meta.bits_per_sample)
    opt("SAMPLE_FORMAT", meta.sample_format)
    opt("INCIDENCE_ANGLE", meta.incidence_angle)
    opt("LOOK_ANGLE", meta.look_angle)
    opt("DOPPLER_CENTROID", meta.doppler_centroid)
    opt("RADIOMETRIC_CALIBRATION", meta.radiometric_calibration)
    opt("GEOMETRIC_CALIBRATION", meta.geometric_calibration)
    md["CONVERSION_TOOL"] = meta.conversion_tool
    md["CONVERSION_VERSION"] = meta.conversion_version
    md["CONVERSION_TIMESTAMP"] = meta.conversion_timestamp
    return md


def _fmt(v) -> str:
    """Rust's Display for f64 prints shortest round-trip — repr matches for
    the common cases; ints print plainly."""
    if isinstance(v, bool):
        return str(v).lower()
    if isinstance(v, float):
        if v == int(v) and abs(v) < 1e16:
            return str(int(v))
        return repr(v)
    return str(v)


def convert_metadata_to_json(metadata: dict[str, str]) -> dict:
    """Lowercase keys + numeric coercion (reference: metadata.rs:232-259)."""
    out = {}
    for key, value in metadata.items():
        jkey = key.lower()
        try:
            f = float(value)
            if f == f and f not in (float("inf"), float("-inf")):
                if f == int(f) and "." not in value and "e" not in value.lower():
                    out[jkey] = int(f)
                else:
                    out[jkey] = f
                continue
        except (ValueError, OverflowError):
            pass
        out[jkey] = value
    return out


def add_special_json_fields(
    json_metadata: dict, meta: SafeMetadata,
    geotransform_override=None, projection_override: Optional[str] = None,
) -> None:
    """geotransform array + crs string (reference: metadata.rs:262-294)."""
    gt = geotransform_override if geotransform_override is not None else meta.geotransform
    if gt is not None:
        json_metadata["geotransform"] = [float(v) for v in gt]
    crs = projection_override if projection_override is not None else meta.crs
    if crs:
        json_metadata["crs"] = crs


def _is_identity(gt) -> bool:
    """reference: metadata.rs:305-307."""
    return (gt[0] == 0.0 and gt[1] == 1.0 and gt[2] == 0.0
            and gt[3] == 0.0 and gt[4] == 0.0 and gt[5] == 1.0)


def embed_tiff_metadata(
    ds, meta: SafeMetadata, operation: Optional[str] = None,
    geotransform_override=None, projection_override: Optional[str] = None,
) -> None:
    """Embed georeferencing + metadata into a pending GeoTIFF
    (reference: metadata.rs:297-341). `ds` is a PendingTiff."""
    set_gt = False
    if geotransform_override is not None:
        if not _is_identity(geotransform_override):
            ds.set_geo_transform(geotransform_override)
            set_gt = True
    elif meta.geotransform is not None:
        if not _is_identity(meta.geotransform):
            ds.set_geo_transform(meta.geotransform)
            set_gt = True
    # projection only if a non-identity geotransform was set (metadata.rs:324-330)
    if set_gt:
        projection = projection_override if projection_override is not None else meta.projection
        if projection:
            ds.set_projection(projection)
    for key, value in extract_metadata_fields(meta, operation).items():
        ds.set_metadata_item(key, value)


class MetadataFormat:
    """Metadata destination selector (reference: metadata.rs:10-17)."""

    TIFF = "tiff"
    JSON = "json"


def handle_metadata(meta: SafeMetadata, format: str, output_path,
                    dataset=None) -> None:
    """Generic metadata handler (reference: metadata.rs:423-437)."""
    if format == MetadataFormat.TIFF:
        if dataset is None:
            raise ValueError("Dataset required for TIFF metadata")
        embed_tiff_metadata(dataset, meta, None, None, None)
    else:
        create_jpeg_metadata_sidecar(output_path, meta, None)


def create_jpeg_metadata_sidecar(output_path, meta: SafeMetadata,
                                 operation: Optional[str] = None) -> None:
    """reference: metadata.rs:344-367."""
    create_jpeg_metadata_sidecar_with_overrides(output_path, meta, operation, None, None)


def create_jpeg_metadata_sidecar_with_overrides(
    output_path, meta: SafeMetadata, operation: Optional[str] = None,
    geotransform_override=None, projection_override: Optional[str] = None,
) -> None:
    """reference: metadata.rs:370-390."""
    create_jpeg_metadata_sidecar_with_overrides_and_extras(
        output_path, meta, operation, geotransform_override, projection_override, None
    )


def create_jpeg_metadata_sidecar_with_overrides_and_extras(
    output_path, meta: SafeMetadata, operation: Optional[str] = None,
    geotransform_override=None, projection_override: Optional[str] = None,
    extras: Optional[list[tuple[str, str]]] = None,
) -> None:
    """reference: metadata.rs:393-420."""
    md = extract_metadata_fields(meta, operation)
    json_md = convert_metadata_to_json(md)
    add_special_json_fields(json_md, meta, geotransform_override, projection_override)
    if extras:
        for k, v in extras:
            json_md[k.lower()] = v
    sidecar = Path(output_path).with_suffix(".json")
    sidecar.write_text(json.dumps(json_md, indent=2, sort_keys=True))
    logger.info("Created JPEG metadata sidecar: %s", sidecar)
