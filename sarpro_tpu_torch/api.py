"""High-level API of the port (port of sarpro_tpu/api.py): a GRD SAFE to a
GeoTIFF or JPEG, or to in-memory arrays, on the GPU.

Exact mode, the default of `process_safe_to_path` and of the CLI without
`--fast`, is the reference's semantics (api.py:345-407): the reader loads
each band (warped to a target CRS when one is set, else decimated on read
at the target size, else as stored), then `core/save` runs the band
pipeline with host-f64 statistics and CLAHE CDFs around the device
kernels. Fast mode (`fast=True`, :409-487) runs the fused device programs
of `core/fused` instead. Both run every route: single bands (vv, vh, hh,
hv), the five polarization operations, multiband TIFF and the multiband
synRGB JPEG, every strategy, u8 or u16 TIFF, with or without reprojection.

The in-memory and typed API (`ProcessedImage`, `process_safe_to_buffer`,
`process_safe_to_buffer_with_mode`, `process_safe_with_options`,
`save_image`, `save_multiband_image`, `load_polarization`,
`load_operation`, :126-243 and :490-554) runs exact mode; arrays come back
as numpy.

A full-resolution scene above `streamed.BIG_SCENE_PIXELS` takes the streamed
passes of `core/streamed` in both modes: exact mode hands it to fast mode,
as the JAX package does (:358-376).

Batch mode (:143-148, :246-342) runs every product of a directory through
the same routes (`_Route`): `process_directory_to_path` one after the
other, and `parallel/batch.process_directory_pipelined` with the host half
of each read on loader threads and everything on the device on the calling
thread. Products that cannot be processed are skipped
(`scene_skip_reason`, XML only), failures are counted, and `BatchReport`
holds the counters.

Every entry point computes on `device` ("cuda" unless the caller asks for
the CPU) and raises RuntimeError when CUDA is asked for and absent.

`shard_devices` (N >= 2, or -1 for every device the caller has) shards a
scene's rows over a mesh of devices and implies fast mode, as in the JAX
package (:346-357, :431-454): the warp's output rows (`parallel.warp`) and
the device programs (`core/fast_path._build_shard_mesh`,
`parallel.sharded`, the streamed passes' mesh mode) split over the mesh,
band 1's overlapped stage is off, and the file equals the unsharded fast
route's. With one device the unsharded fast route runs, with the JAX
package's warning.
"""
from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .core import fast_path, fused, ops, streamed
from .core.pipeline import process_scalar_data_pipeline
from .core.resize import resize_image_data
from .core.save import (
    save_processed_image,
    save_processed_multiband_image_sequential,
)
from .core.synthetic_rgb import create_synthetic_rgb_by_mode_and_strategy
from .errors import ProcessingError, SafeParseError
from .io.safe import (
    DualPolScene,
    SafeMetadata,
    TargetCrsArg,
    identify_polarization_files,
    open_band,
    open_pair,
    open_scene,
    parse_comprehensive_metadata,
    read_scene,
    upload_scene,
)
from .params import ProcessingParams
from .types import (
    AutoscaleStrategy,
    BitDepth,
    BitDepthArg,
    OutputFormat,
    Polarization,
    PolarizationOperation,
    ProcessingOperation,
    SyntheticRgbMode,
)

logger = logging.getLogger("sarpro")


def _resolve_target_args(params: ProcessingParams):
    """Map target CRS strings none/auto/custom and resample names
    (reference: api/mod.rs:544-557, lanczos default)."""
    t = params.target_crs
    if t is None:
        target_arg = None
    elif t.lower() == "none":
        target_arg = TargetCrsArg.NONE
    elif t.lower() == "auto":
        target_arg = TargetCrsArg.AUTO
    else:
        target_arg = t
    alg = params.resample_alg
    if alg in ("nearest", "bilinear", "cubic", "lanczos"):
        resample = alg
    elif alg is None:
        # unspecified -> reader heuristic (Average for >=4x reductions), the
        # reference CLI semantics (runner.rs:61-67)
        resample = None
    else:  # unknown name -> lanczos (api/mod.rs:556)
        resample = "lanczos"
    return target_arg, resample


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    return device


def _op_what(op: PolarizationOperation) -> str:
    """The caller's name in the missing-pair error (api.py:113-116)."""
    return f"Operation {op.metadata_label}"


def _multiband_operation(is_vvvh: bool) -> ProcessingOperation:
    return (ProcessingOperation.MULTIBAND_VV_VH if is_vvvh
            else ProcessingOperation.MULTIBAND_HH_HV)


def _is_big_original(input) -> bool:
    """A scene whose annotated size is above `streamed.BIG_SCENE_PIXELS`
    (api.py:363-370); an unreadable annotation is not big."""
    try:
        meta = parse_comprehensive_metadata(Path(input))
    except (OSError, SafeParseError):  # the exact path reports it
        return False
    return 0 < meta.lines * meta.samples > streamed.BIG_SCENE_PIXELS


class _Route:
    """How `params` take one product to a file on `device` (the routes of
    the reference's api/mod.rs:539-674; fast mode: api.py:409-487): the
    host half of the read (`read`), its device half (`upload`), both in
    turn band by band (`open`), and the device programs and the write
    (`save`). The single-scene entry and the batch drivers run the same
    halves, so a batch writes what the single-scene CLI writes."""

    def __init__(self, params: ProcessingParams, fast: bool,
                 device: torch.device, shard_devices: int = 0):
        self.params, self.device = params, device
        # a shard request implies fast mode (api.py:355)
        self.fast = fast = fast or bool(shard_devices)
        self.shard_devices = shard_devices
        target_arg, resample = _resolve_target_args(params)
        warping = target_arg not in (None, TargetCrsArg.NONE)
        self.alg0 = None if warping else resample  # the warp took the filter
        pol = params.polarization
        self.pol = pol.kind if pol.kind in ("vv", "vh", "hh", "hv") else None
        self.what = _op_what(pol.op) if pol.kind == "op" else "Multiband"
        # fast synRGB JPEG reads full DN (or warps) and resamples in its
        # band stage; every other route takes the decimated read
        self.synrgb = (fast and pol.kind == "multiband"
                       and params.format is OutputFormat.JPEG)
        self.load = dict(target_size=params.size, target_crs=target_arg,
                         resample_alg=resample, decimate=not self.synrgb)

    def read(self, input, staging=None):
        """The host half: an `io.safe.HostScene` (no device touched)."""
        return read_scene(input, self.pol, self.what, staging=staging,
                          **self.load)

    def upload(self, scene) -> DualPolScene:
        """The device half of `read`'s scene."""
        return upload_scene(scene, self.device, self._band_stage(),
                            self.shard_devices)

    def open(self, input) -> DualPolScene:
        """Both halves in turn, band by band (the single-scene overlaps)."""
        return open_scene(input, self.device, self.pol, self.what,
                          band_stage=self._band_stage(),
                          shard_devices=self.shard_devices, **self.load)

    def _band_stage(self):
        """Band 1's synRGB stage, queued while band 2 is read (fast synRGB
        JPEG below the streamed size only, and not under sharding)."""
        if not self.synrgb or self.shard_devices:
            return None
        p = self.params

        def band_stage(dn1):
            if fast_path._is_big_scene(*dn1.shape, p.size):
                return None  # the streamed passes take both bands
            return fused.synrgb_band_stage(
                dn1, strategy=p.autoscale, copol=True, target_size=p.size,
                pad=p.pad, resample_alg=self.alg0)

        return band_stage

    def save(self, scene: DualPolScene, output, write_pool=None):
        """The device programs and the write of `scene` to `output`. Fast
        mode with `write_pool` returns the Future of the deferred write;
        exact mode writes before it returns (None)."""
        p = self.params
        bit_depth = p.bit_depth.to_bit_depth()
        pol = p.polarization
        if pol.kind == "op":
            band = ops.OPERATIONS[pol.op.value](scene.band1, scene.band2)
            # the pair is not needed past the operation
            scene.band1 = scene.band2 = None
            operation = ProcessingOperation.PolarOp(pol.op)
        elif pol.kind == "multiband":
            band, operation = None, _multiband_operation(scene.is_vvvh)
        else:
            band, operation = scene.band1, ProcessingOperation.SINGLE_BAND
        if self.fast:
            common = dict(pad=p.pad, strategy=p.autoscale,
                          resample_alg=self.alg0, write_pool=write_pool,
                          shard_devices=self.shard_devices)
            if band is not None:
                return fast_path.save_single_band_fast(
                    band, output, p.format, bit_depth, p.size,
                    scene.metadata, operation=operation, **common)
            return fast_path.save_multiband_fast(
                scene.band1, scene.band2, output, p.format, bit_depth,
                p.size, scene.metadata, operation=operation,
                syn_mode=p.synrgb_mode, staged_b1=scene.staged_band1,
                **common)
        common = dict(format=p.format, bit_depth=bit_depth,
                      target_size=p.size, pad=p.pad, strategy=p.autoscale)
        if band is not None:
            save_processed_image(band, output, metadata=scene.metadata,
                                 operation=operation, **common)
        else:
            save_processed_multiband_image_sequential(
                scene.band1, scene.band2, output, metadata=scene.metadata,
                operation=operation, syn_mode=p.synrgb_mode, **common)
        return None


def _route(input, params: ProcessingParams, fast: bool,
           device: torch.device, shard_devices: int = 0) -> _Route:
    """The route of one product: exact mode at original size above the
    exact mode's device budget takes the streamed fast-mode passes, as in
    the JAX package; a shard request takes fast mode."""
    if (not fast and not shard_devices and params.size is None
            and _is_big_original(input)):
        logger.warning("scene exceeds the exact-mode device budget; using "
                       "the streamed fast-mode pipeline")
        fast = True
    return _Route(params, fast, device, shard_devices)


def process_safe_to_path(input, output, params: ProcessingParams,
                         fast: bool = False, shard_devices: int = 0,
                         device="cuda") -> None:
    """SAFE -> file, driven by ProcessingParams, computing on `device`
    (reference: api/mod.rs:539-674): exact mode, or fast mode with
    `fast=True`. `shard_devices` (N >= 2, or -1 for all) shards the
    scene's rows over that many of the caller's devices and implies fast
    mode."""
    route = _route(input, params, fast, _device(device), shard_devices)
    route.save(route.open(input), output)


# --------------------------------------------------------------------------
# Batch mode (reference: api/mod.rs:452-536)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class BatchReport:
    """reference: api/mod.rs:452-457."""

    processed: int = 0
    skipped: int = 0
    errors: int = 0


def iterate_safe_products(input_dir):
    """Immediate subdirectories of input_dir (reference: api/mod.rs:460-470)."""
    return iter(sorted(p for p in Path(input_dir).iterdir() if p.is_dir()))


def scene_skip_reason(path, params: ProcessingParams) -> Optional[str]:
    """Cheap (metadata-only) viability check for batch mode (a copy of
    sarpro_tpu/api.py:251-282).

    Mirrors the reference's warnings-mode reader skip semantics
    (sentinel1.rs:592-796 via api/mod.rs:502-533): unsupported product type,
    missing requested polarization files, and unsatisfiable band pairs all
    return a skip reason instead of becoming errors. Unlike the reference we
    do NOT load the raster data twice (known inefficiency, api/mod.rs:502-518)
    — the check reads XML only.

    Returns None when the product is viable, else a human-readable reason.
    """
    path = Path(path)
    if not (path / "annotation").is_dir() or not (path / "measurement").is_dir():
        return "missing annotation/measurement directory"
    meta = parse_comprehensive_metadata(path)
    if meta.product_type.upper() != "GRD":
        return f"unsupported product type: {meta.product_type}"
    vv, vh, hh, hv = identify_polarization_files(
        path / "measurement", meta.polarizations
    )
    kind = params.polarization.kind
    if kind in ("vv", "vh", "hh", "hv"):
        if {"vv": vv, "vh": vh, "hh": hh, "hv": hv}[kind] is None:
            return f"{kind.upper()} measurement file not found"
        return None
    # multiband and polarization ops need a co/cross pair (api.py:_band_pair)
    if (vv is not None and vh is not None) or (hh is not None and hv is not None):
        return None
    return "no usable polarization pair (need VV+VH or HH+HV)"


def process_directory_to_path(
    input_dir, output_dir, params: ProcessingParams,
    continue_on_error: bool = True, fast: bool = False, resume: bool = False,
    progress=None, shard_devices: int = 0, device="cuda",
) -> BatchReport:
    """Batch all SAFE subdirectories, one after the other, each through
    `process_safe_to_path` on `device` (reference: api/mod.rs:474-536).

    `progress(done, total, current_name)` (optional) is called as scenes
    finish — the GUI's live batch progress hook; its exceptions are
    ignored.

    Note: the reference opens each product twice (viability check + process,
    api/mod.rs:502-518) — a known inefficiency deliberately NOT replicated;
    we run the viability check cheaply on metadata only."""
    device = _device(device)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    report = BatchReport()
    products = list(iterate_safe_products(input_dir))

    def tick(current=None):
        if progress is not None:
            try:
                progress(report.processed + report.skipped + report.errors,
                         len(products), current)
            except Exception:  # noqa: BLE001 — observer must not break batch
                pass

    for path in products:
        tick(path.name)
        # viability: parse metadata + check product type / pol availability
        # (reference: api/mod.rs:502-533 — skip, don't error)
        try:
            reason = scene_skip_reason(path, params)
        except Exception:
            reason = "unreadable product metadata"
        if reason is not None:
            logger.warning("Skipping %s: %s", path, reason)
            report.skipped += 1
            tick()
            continue
        ext = params.format.extension
        output_path = output_dir / f"{path.name}.{ext}"
        if resume and output_path.exists():
            logger.info("Resume: output exists, skipping %s", path)
            report.skipped += 1
            tick()
            continue
        try:
            process_safe_to_path(path, output_path, params, fast=fast,
                                 shard_devices=shard_devices, device=device)
            report.processed += 1
        except Exception as e:
            logger.warning("Error processing %s: %s", path, e)
            report.errors += 1
            if not continue_on_error:
                raise
        tick()
    return report


# --------------------------------------------------------------------------
# The in-memory and typed API (reference: api/mod.rs:51-449, :677-916)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ProcessedImage:
    """Result of in-memory processing (reference: api/mod.rs:51-62)."""

    width: int
    height: int
    bit_depth: BitDepth
    format: OutputFormat
    gray: Optional[np.ndarray] = None          # single-band U8
    gray16: Optional[np.ndarray] = None        # single-band U16
    rgb: Optional[np.ndarray] = None           # interleaved RGB
    gray_band2: Optional[np.ndarray] = None    # multiband second band U8
    gray16_band2: Optional[np.ndarray] = None  # multiband second band U16
    metadata: Optional[SafeMetadata] = None


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.cpu().numpy()


def process_safe_to_buffer(
    input,
    polarization: Polarization,
    autoscale: AutoscaleStrategy,
    bit_depth: BitDepth,
    target_size: Optional[int] = None,
    pad: bool = False,
    output_format: OutputFormat = OutputFormat.TIFF,
    device="cuda",
) -> ProcessedImage:
    """In-memory processing, no disk output (reference: api/mod.rs:65-371).
    The buffer path never warps (no target CRS)."""
    return process_safe_to_buffer_with_mode(
        input, polarization, autoscale, bit_depth, target_size, pad,
        output_format, SyntheticRgbMode.DEFAULT, device=device,
    )


def process_safe_to_buffer_with_mode(
    input,
    polarization: Polarization,
    autoscale: AutoscaleStrategy,
    bit_depth: BitDepth,
    target_size: Optional[int] = None,
    pad: bool = False,
    output_format: OutputFormat = OutputFormat.TIFF,
    synrgb_mode: SyntheticRgbMode = SyntheticRgbMode.DEFAULT,
    device="cuda",
) -> ProcessedImage:
    """reference: api/mod.rs:374-449. The bands load as the JAX reader
    loads them without a target CRS: decimated on read at `target_size`,
    else as stored."""
    device = _device(device)
    tiff = output_format is OutputFormat.TIFF

    def run_single(band, metadata) -> ProcessedImage:
        depth = bit_depth if tiff else BitDepth.U8
        res = process_scalar_data_pipeline(band, depth, autoscale)
        rows, cols = res.shape
        fc, fr, f8, f16 = resize_image_data(
            res.scaled_u8, res.scaled_u16, cols, rows, target_size, depth, pad
        )
        return ProcessedImage(
            width=fc, height=fr, bit_depth=depth,
            format=OutputFormat.TIFF if tiff else OutputFormat.JPEG,
            gray=_host(f8), gray16=_host(f16), metadata=metadata.copy(),
        )

    if polarization.kind in ("vv", "vh", "hh", "hv"):
        metadata, band = open_band(input, polarization.kind, device,
                                   target_size)
        return run_single(band, metadata)

    if polarization.kind == "op":
        scene = open_pair(input, device, _op_what(polarization.op),
                          target_size)
        band = ops.OPERATIONS[polarization.op.value](scene.band1, scene.band2)
        return run_single(band, scene.metadata)

    scene = open_pair(input, device, "Multiband", target_size)
    depth = bit_depth if tiff else BitDepth.U8
    res1 = process_scalar_data_pipeline(scene.band1, depth, autoscale)
    rows, cols = res1.shape
    fc, fr, f1_8, f1_16 = resize_image_data(
        res1.scaled_u8, res1.scaled_u16, cols, rows, target_size, depth, pad
    )
    del res1
    res2 = process_scalar_data_pipeline(scene.band2, depth, autoscale)
    _c, _r, f2_8, f2_16 = resize_image_data(
        res2.scaled_u8, res2.scaled_u16, cols, rows, target_size, depth, pad
    )
    del res2
    if tiff:
        return ProcessedImage(
            width=fc, height=fr, bit_depth=bit_depth,
            format=OutputFormat.TIFF, gray=_host(f1_8), gray16=_host(f1_16),
            gray_band2=_host(f2_8), gray16_band2=_host(f2_16),
            metadata=scene.metadata.copy(),
        )
    # JPEG multiband -> synthetic RGB (api/mod.rs:203-247, :394-438)
    rgb = create_synthetic_rgb_by_mode_and_strategy(synrgb_mode, autoscale,
                                                    f1_8, f2_8)
    return ProcessedImage(
        width=fc, height=fr, bit_depth=BitDepth.U8, format=OutputFormat.JPEG,
        rgb=_host(rgb), metadata=scene.metadata.copy(),
    )


def process_safe_with_options(
    input, output,
    format: OutputFormat, bit_depth: BitDepth, polarization: Polarization,
    autoscale: AutoscaleStrategy, size: Optional[int] = None, pad: bool = False,
    device="cuda",
) -> None:
    """Typed convenience variant (reference: api/mod.rs:677-800)."""
    params = ProcessingParams(
        format=format,
        bit_depth=BitDepthArg.U8 if bit_depth is BitDepth.U8 else BitDepthArg.U16,
        polarization=polarization,
        autoscale=autoscale,
        size=size,
        pad=pad,
        target_crs=None,
        resample_alg=None,
        synrgb_mode=SyntheticRgbMode.DEFAULT,
    )
    process_safe_to_path(input, output, params, device=device)


def _on_device(x, device) -> torch.Tensor:
    """A numpy array or tensor of linear values on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))  # a copy: the caller's may be read-only
    return x.to(device)


def save_image(
    processed, output, format: OutputFormat, bit_depth: BitDepth,
    target_size: Optional[int] = None, metadata: Optional[SafeMetadata] = None,
    pad: bool = False,
    autoscale: AutoscaleStrategy = AutoscaleStrategy.STANDARD,
    operation: ProcessingOperation = ProcessingOperation.SINGLE_BAND,
    device="cuda",
) -> None:
    """Typed save helper for single-band arrays (reference: api/mod.rs:803-826)."""
    device = _device(device)
    save_processed_image(
        _on_device(processed, device), output, format, bit_depth, target_size,
        metadata, pad, autoscale, operation,
    )


def save_multiband_image(
    processed1, processed2, output, format: OutputFormat, bit_depth: BitDepth,
    target_size: Optional[int] = None, metadata: Optional[SafeMetadata] = None,
    pad: bool = False,
    autoscale: AutoscaleStrategy = AutoscaleStrategy.STANDARD,
    operation: ProcessingOperation = ProcessingOperation.MULTIBAND_VV_VH,
    device="cuda",
) -> None:
    """Typed save helper for multiband arrays (reference: api/mod.rs:829-856)."""
    device = _device(device)
    save_processed_multiband_image_sequential(
        _on_device(processed1, device), _on_device(processed2, device),
        output, format, bit_depth, target_size, metadata, pad, autoscale,
        operation, SyntheticRgbMode.DEFAULT,
    )


def load_polarization(input, pol: Polarization, device="cuda"):
    """Load one polarization's band as stored (a device tensor) and its
    metadata (reference: api/mod.rs:859-881)."""
    if pol.kind in ("multiband", "op"):
        raise ProcessingError(
            "load_polarization expects a single polarization (vv/vh/hh/hv)"
        )
    metadata, band = open_band(input, pol.kind, _device(device))
    return band, metadata.copy()


def load_operation(input, op: PolarizationOperation, device="cuda"):
    """An operation over the available pair, as stored (a device tensor),
    and the metadata (reference: api/mod.rs:884-916)."""
    scene = open_pair(input, _device(device), _op_what(op))
    return (ops.OPERATIONS[op.value](scene.band1, scene.band2),
            scene.metadata.copy())
