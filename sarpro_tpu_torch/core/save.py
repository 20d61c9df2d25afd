"""Exact mode's save orchestration: pipeline -> resize/pad -> geotransform
rescale -> writers (port of sarpro_tpu/core/save.py; reference:
src/core/processing/save.rs:23-406).

The bands stay on the device from the pipeline through the resize, pad and
synRGB composition; the host gets the final u8/u16 band (TIFF, gray JPEG)
or the YCbCr planes (synRGB JPEG) and writes them with the port's copies of
the JAX package's writers, and fast mode's helpers for the geotransform
rescale (a copy of the JAX package's), the TIFF metadata and the JPEG
sidecars.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

from ..io.writers.jpeg import write_gray_jpeg, write_rgb_jpeg
from ..io.writers.tiff import (
    write_tiff_multiband_u8,
    write_tiff_multiband_u16,
    write_tiff_u8,
    write_tiff_u16,
)
from ..types import (
    AutoscaleStrategy,
    BitDepth,
    OutputFormat,
    ProcessingOperation,
    SyntheticRgbMode,
)
from .fast_path import _rescale_geotransform, _write_jpeg_sidecars, _write_tiff
from .pipeline import (
    autoscale_db_image_tamed_synrgb_u8,
    process_scalar_data_pipeline,
)
from .resize import resize_image_data_with_meta
from .synthetic_rgb import create_synthetic_rgb_by_mode_and_strategy

logger = logging.getLogger("sarpro")


def save_processed_image(
    processed,
    output,
    format: OutputFormat,
    bit_depth: BitDepth,
    target_size: Optional[int],
    metadata=None,
    pad: bool = False,
    strategy: AutoscaleStrategy = AutoscaleStrategy.STANDARD,
    operation: ProcessingOperation = ProcessingOperation.SINGLE_BAND,
) -> None:
    """Single-band save path (reference: save.rs:23-170): a device tensor
    of linear values in, a GeoTIFF (u8 or u16) or a gray JPEG with its world
    file, .prj and sidecar out."""
    output = Path(output)
    operation_label = operation.metadata_label

    if format is OutputFormat.TIFF:
        res = process_scalar_data_pipeline(processed, bit_depth, strategy)
        rows, cols = res.shape
        (final_cols, final_rows, final_u8, final_u16,
         scale_x, scale_y, pad_left, pad_top) = resize_image_data_with_meta(
            res.scaled_u8, res.scaled_u16, cols, rows, target_size, bit_depth, pad,
        )
        del res
        gt_override, proj_override = _rescale_geotransform(
            metadata, cols, rows, final_cols, final_rows, pad_left, pad_top,
            scale_x, scale_y,
        )
        if bit_depth is BitDepth.U8:
            ds = write_tiff_u8(output, final_cols, final_rows,
                               final_u8.cpu().numpy())
        else:
            ds = write_tiff_u16(output, final_cols, final_rows,
                                final_u16.cpu().numpy())
        _write_tiff(ds, metadata, operation_label, gt_override, proj_override)
        logger.info("save_processed_image: %s TIFF saved with metadata",
                    "U8" if bit_depth is BitDepth.U8 else "U16")
    else:  # JPEG: always U8 (reference: save.rs:119-167)
        res = process_scalar_data_pipeline(processed, BitDepth.U8, strategy)
        rows, cols = res.shape
        (final_cols, final_rows, final_u8, _f16,
         scale_x, scale_y, pad_left, pad_top) = resize_image_data_with_meta(
            res.scaled_u8, None, cols, rows, target_size, BitDepth.U8, pad,
        )
        del res
        write_gray_jpeg(output, final_cols, final_rows, final_u8)
        gt_override, proj_override = _rescale_geotransform(
            metadata, cols, rows, final_cols, final_rows, pad_left, pad_top,
            scale_x, scale_y,
        )
        _write_jpeg_sidecars(output, metadata, operation_label, gt_override,
                             proj_override)
        logger.info("save_processed_image: JPEG saved with metadata sidecar")


def _synrgb_input_band(processed, strategy: AutoscaleStrategy,
                       is_copol: bool):
    """One band's u8 input to the synRGB composition: the pipeline's u8,
    or for Tamed the band-specific window's recompute (reference:
    save.rs:324-328). Returns (rows, cols, u8 band)."""
    res = process_scalar_data_pipeline(processed, BitDepth.U8, strategy)
    if strategy is AutoscaleStrategy.TAMED:
        band = autoscale_db_image_tamed_synrgb_u8(res.db, res.mask, res.stats,
                                                  is_copol=is_copol)
    else:
        band = res.scaled_u8
    return (*res.shape, band)


def save_processed_multiband_image_sequential(
    processed1,
    processed2,
    output,
    format: OutputFormat,
    bit_depth: BitDepth,
    target_size: Optional[int],
    metadata=None,
    pad: bool = False,
    strategy: AutoscaleStrategy = AutoscaleStrategy.STANDARD,
    operation: ProcessingOperation = ProcessingOperation.MULTIBAND_VV_VH,
    syn_mode: SyntheticRgbMode = SyntheticRgbMode.DEFAULT,
) -> None:
    """Two-band save with sequential band staging to bound peak memory
    (reference: save.rs:172-406): band 1's intermediates (dB, mask, the u16
    band) are released before band 2 is processed, as the reference drops
    them (save.rs:239-255), so one full-resolution dB raster is on the
    device at a time."""
    output = Path(output)
    operation_label = operation.metadata_label

    if format is OutputFormat.TIFF:
        res1 = process_scalar_data_pipeline(processed1, bit_depth, strategy)
        rows, cols = res1.shape
        (final_cols, final_rows, final_u8, final_u16,
         scale_x, scale_y, pad_left, pad_top) = resize_image_data_with_meta(
            res1.scaled_u8, res1.scaled_u16, cols, rows, target_size, bit_depth, pad,
        )
        gt_override, proj_override = _rescale_geotransform(
            metadata, cols, rows, final_cols, final_rows, pad_left, pad_top,
            scale_x, scale_y,
        )
        band1 = (final_u8 if bit_depth is BitDepth.U8 else final_u16).cpu().numpy()
        del res1, final_u8, final_u16  # sequential staging (save.rs:239-241)

        res2 = process_scalar_data_pipeline(processed2, bit_depth, strategy)
        (_c2, _r2, f2_u8, f2_u16, _sx2, _sy2, _pl2, _pt2) = resize_image_data_with_meta(
            res2.scaled_u8, res2.scaled_u16, cols, rows, target_size, bit_depth, pad,
        )
        del res2
        band2 = (f2_u8 if bit_depth is BitDepth.U8 else f2_u16).cpu().numpy()

        if bit_depth is BitDepth.U8:
            ds = write_tiff_multiband_u8(output, final_cols, final_rows, band1, band2)
        else:
            ds = write_tiff_multiband_u16(output, final_cols, final_rows, band1, band2)
        _write_tiff(ds, metadata, operation_label, gt_override, proj_override)
        logger.info(
            "save_processed_multiband_image_sequential: %s TIFF saved with 2 bands",
            "U8" if bit_depth is BitDepth.U8 else "U16",
        )
    else:  # JPEG -> synthetic RGB (reference: save.rs:317-403)
        logger.info("Creating synthetic RGB JPEG from VV|HH (R) and VH|HV (G) bands")
        rows, cols, input_u8_band1 = _synrgb_input_band(processed1, strategy,
                                                        True)
        (final_cols, final_rows, final_u8_band1, _f16,
         scale_x, scale_y, pad_left, pad_top) = resize_image_data_with_meta(
            input_u8_band1, None, cols, rows, target_size, BitDepth.U8, pad,
        )
        del input_u8_band1

        _r, _c, input_u8_band2 = _synrgb_input_band(processed2, strategy,
                                                    False)
        (_c2, _r2, final_u8_band2, _f16b, _sx2, _sy2, _pl2, _pt2) = resize_image_data_with_meta(
            input_u8_band2, None, cols, rows, target_size, BitDepth.U8, pad,
        )
        del input_u8_band2

        rgb = create_synthetic_rgb_by_mode_and_strategy(
            syn_mode, strategy, final_u8_band1, final_u8_band2
        )
        write_rgb_jpeg(output, final_cols, final_rows, rgb)

        gt_override, proj_override = _rescale_geotransform(
            metadata, cols, rows, final_cols, final_rows, pad_left, pad_top,
            scale_x, scale_y,
        )
        _write_jpeg_sidecars(output, metadata, operation_label, gt_override,
                             proj_override,
                             [("synthetic_rgb_mode", syn_mode.display)])
        logger.info("Synthetic RGB JPEG saved with metadata sidecar")
