"""Fast-mode file output of the synRGB JPEG (port of the JPEG branch of
sarpro_tpu/core/fast_path.save_multiband_fast).

The device runs the whole chain down to quantized DCT blocks; the host
copies the blocks back, entropy-codes them and writes the world file, .prj
and JSON sidecar through the JAX package's host-only writers.
"""
from __future__ import annotations

import logging
from pathlib import Path

from sarpro_tpu.io.writers.metadata import (
    create_jpeg_metadata_sidecar_with_overrides_and_extras,
)
from sarpro_tpu.io.writers.worldfile import write_prj_file, write_world_file
from sarpro_tpu.types import (
    OutputFormat,
    ProcessingOperation,
    SyntheticRgbMode,
)

from ..io.writers import jpeg
from . import fused

logger = logging.getLogger("sarpro")

# full-resolution scenes above this size take the JAX package's streamed
# path (sarpro_tpu/core/streamed.py:57), which is not ported yet
BIG_SCENE_PIXELS = 192 << 20


def _is_big_scene(in_rows: int, in_cols: int, target_size) -> bool:
    return target_size is None and in_rows * in_cols > BIG_SCENE_PIXELS


def _final_dims(in_rows: int, in_cols: int, target_size, pad: bool,
                resample_alg=None):
    rows, cols, _f = fused._plan_read_dims(in_rows, in_cols, target_size,
                                           resample_alg)
    if pad:
        m = max(rows, cols)
        pad_left = (m - cols) // 2
        pad_top = (m - rows) // 2
        return rows, cols, m, m, pad_left, pad_top
    return rows, cols, cols, rows, 0, 0


def _rescale_geotransform(meta, cols, rows, final_cols, final_rows,
                          pad_left, pad_top, scale_x, scale_y):
    """Pixel-size rescale + padding origin shift (reference: save.rs:70-87;
    a copy of sarpro_tpu/core/save._rescale_geotransform, whose module
    imports Pillow)."""
    gt_override = None
    proj_override = None
    if meta is not None:
        if meta.geotransform is not None:
            gt = list(meta.geotransform)
            if scale_x > 0.0:
                gt[1] = gt[1] * (cols / final_cols)
            if scale_y > 0.0:
                gt[5] = gt[5] * (rows / final_rows)
            gt[0] = gt[0] - pad_left * gt[1]
            gt[3] = gt[3] - pad_top * gt[5]
            gt_override = gt
        if meta.projection:
            proj_override = meta.projection
    return gt_override, proj_override


def save_multiband_fast(
    dn1, dn2, output, format: OutputFormat, target_size, metadata=None,
    pad: bool = False, strategy=None,
    operation: ProcessingOperation = ProcessingOperation.MULTIBAND_VV_VH,
    syn_mode: SyntheticRgbMode = SyntheticRgbMode.DEFAULT,
    resample_alg=None, staged_b1=None,
) -> None:
    """Dual-band DN (device tensors) -> synRGB JPEG + world file, .prj and
    sidecar. `staged_b1` is band 1's already-queued band stage (the reader's
    overlapped load); without it band 1's stage runs here."""
    if format is not OutputFormat.JPEG:
        raise NotImplementedError("multiband TIFF is not ported yet "
                                  "(ROADMAP queue 1, gray/TIFF routes)")
    output = Path(output)
    in_rows, in_cols = dn1.shape
    if _is_big_scene(in_rows, in_cols, target_size):
        raise NotImplementedError("full-resolution big scenes need the "
                                  "streamed path, not ported yet (ROADMAP "
                                  "queue 1, streamed big scenes)")
    rows, cols, final_cols, final_rows, pad_left, pad_top = _final_dims(
        in_rows, in_cols, target_size, pad, resample_alg)
    gt_override, proj_override = _rescale_geotransform(
        metadata, cols, rows, final_cols, final_rows, pad_left, pad_top,
        1.0, 1.0)
    stage = dict(strategy=strategy, target_size=target_size, pad=pad,
                 resample_alg=resample_alg)
    b1 = (staged_b1 if staged_b1 is not None
          else fused.synrgb_band_stage(dn1, copol=True, **stage))
    b2 = fused.synrgb_band_stage(dn2, copol=False, **stage)
    coeffs = fused.synrgb_combine_stage(b1, b2, strategy=strategy,
                                        suppressed=None, channel_order="dct")
    jpeg.write_synrgb_jpeg_dct(output, final_cols, final_rows,
                               coeffs.cpu().numpy())
    if metadata is not None:
        if gt_override is not None:
            write_world_file(output, gt_override)
        if proj_override is not None:
            write_prj_file(output, proj_override)
        create_jpeg_metadata_sidecar_with_overrides_and_extras(
            output, metadata, operation.metadata_label, gt_override,
            proj_override, [("synthetic_rgb_mode", syn_mode.display)])
    logger.info("fast: saved %s", output)
