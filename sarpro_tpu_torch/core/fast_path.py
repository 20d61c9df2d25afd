"""Fast-mode file output (port of sarpro_tpu/core/fast_path.py).

The device runs the whole chain down to the band values, or for a JPEG down
to quantized DCT blocks; the host copies the result back and writes the
GeoTIFF (with its embedded metadata), or entropy-codes the JPEG and writes
the world file, .prj and JSON sidecar, through the writers of io/writers
(copies of the JAX package's). A full-resolution scene above
`streamed.BIG_SCENE_PIXELS` runs the chunked passes of core/streamed instead
of the fused programs, with the same output.

For the batch driver, each save takes a `write_pool`: the device work and
the copy back run on the calling thread, and the write (pageable host
arrays and a metadata snapshot only) goes to the pool. `save_multiband_batch_fast` runs
a bucket of same-shape synRGB JPEG scenes with one host sync.

A shard request (`shard_devices`: N >= 2, or -1 for every device the
caller has) splits the scene's rows over a mesh (`_build_shard_mesh`, the
JAX package's rules and messages): parallel/sharded for a scene below the
streamed size, the streamed passes' mesh mode above it. On one device it
runs the unsharded route, with a warning. The sharded programs end in the
same u8 / u16 bands as the unsharded ones, and the JPEG front end runs on
the gathered output, so each file equals the unsharded one byte for byte.
"""
from __future__ import annotations

import functools
import logging
from pathlib import Path

import torch

from ..io.writers import jpeg
from ..io.writers.metadata import (
    create_jpeg_metadata_sidecar_with_overrides_and_extras,
    embed_tiff_metadata,
)
from ..io.writers.tiff import (
    write_tiff_multiband_u8,
    write_tiff_multiband_u16,
    write_tiff_u8,
    write_tiff_u16,
)
from ..io.writers.worldfile import write_prj_file, write_world_file
from ..types import (
    BitDepth,
    OutputFormat,
    ProcessingOperation,
    SyntheticRgbMode,
)
from ..parallel.mesh import available_devices, make_mesh
from . import fused, streamed

logger = logging.getLogger("sarpro")


def _build_shard_mesh(shard_devices: int, rows: int, full_res: bool,
                      device="cuda"):
    """Mesh for single-scene row sharding over the devices a caller on
    `device` has (`parallel.mesh.available_devices`), or None with the
    reason logged (sarpro_tpu/core/fast_path.py:70-103).

    Full-res configs split the rows evenly: the largest power-of-two
    divisor of the scene height that fits the device count. Resample/pad
    configs split the resample's output rows, which need no divisibility,
    over every device asked for."""
    avail = len(available_devices(device))
    n = avail if shard_devices < 0 else min(shard_devices, avail)
    if n < 2:
        if shard_devices >= 2 or shard_devices < 0:
            logger.warning(
                "shard: %s device(s) requested but only %d available; "
                "running unsharded",
                "all" if shard_devices < 0 else shard_devices, avail)
        return None
    if full_res:
        r = 1
        while r * 2 <= n and rows % (r * 2) == 0:
            r *= 2
        if r < 2:
            logger.warning("shard: %d rows have no even power-of-two split "
                           "across %d devices; running unsharded", rows, n)
            return None
        if r < n:
            logger.info("shard: using %d of %d devices (largest even row "
                        "split of %d rows)", r, n, rows)
        return make_mesh(r, shape=(1, r), device=device)
    return make_mesh(n, shape=(1, n), device=device)


def _shard_mesh(shard_devices: int, dn, target_size, pad: bool):
    """The scene's mesh for a shard request, or None (unsharded)."""
    if not shard_devices:
        return None
    return _build_shard_mesh(shard_devices, dn.shape[0],
                             target_size is None and not pad, dn.device)

def _is_big_scene(in_rows: int, in_cols: int, target_size) -> bool:
    """Full-resolution outputs above `streamed.BIG_SCENE_PIXELS` (read at
    call time) take the streamed passes (core/streamed.py)."""
    return (target_size is None
            and in_rows * in_cols > streamed.BIG_SCENE_PIXELS)


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


def _geo(metadata, in_rows, in_cols, target_size, pad, resample_alg):
    """(final_cols, final_rows, geotransform override, projection
    override) of the output."""
    rows, cols, final_cols, final_rows, pad_left, pad_top = _final_dims(
        in_rows, in_cols, target_size, pad, resample_alg)
    gt, proj = _rescale_geotransform(metadata, cols, rows, final_cols,
                                     final_rows, pad_left, pad_top, 1.0, 1.0)
    return final_cols, final_rows, gt, proj


def _write_tiff(ds, metadata, label, gt, proj) -> None:
    if metadata is not None:
        embed_tiff_metadata(ds, metadata, label, gt, proj)
    ds.flush()


def _write_jpeg_sidecars(output: Path, metadata, label, gt, proj,
                         extras=None) -> None:
    """World file, .prj and JSON sidecar of a JPEG."""
    if metadata is None:
        return
    if gt is not None:
        write_world_file(output, gt)
    if proj is not None:
        write_prj_file(output, proj)
    create_jpeg_metadata_sidecar_with_overrides_and_extras(
        output, metadata, label, gt, proj, extras)


def _to_host(t: torch.Tensor, deferred: bool):
    """`t` in host memory, as numpy. For a deferred write the memory is
    pageable: a pinned result (the streamed JPEG front end's) is copied
    out here, so the writer thread never holds the last reference to a
    block of the caching host allocator, whose release records CUDA
    events."""
    t = t.cpu()
    if deferred and t.is_pinned():
        t = torch.empty(t.shape, dtype=t.dtype).copy_(t)
    return t.numpy()


def _submit(write, write_pool):
    """Run `write` now (None), or defer it to `write_pool` (its Future)."""
    if write_pool is not None:
        return write_pool.submit(write)
    write()
    return None


def save_single_band_fast(
    dn, output, format: OutputFormat, bit_depth: BitDepth, target_size,
    metadata=None, pad: bool = False, strategy=None,
    operation: ProcessingOperation = ProcessingOperation.SINGLE_BAND,
    resample_alg=None, write_pool=None, shard_devices: int = 0,
):
    """One band (device tensor) -> GeoTIFF (u8 or u16) or grayscale JPEG
    (always u8, from the device's DCT blocks) + world file, .prj and
    sidecar, through the grayscale program (streamed for a big scene;
    sharded over a mesh for a shard request, `_build_shard_mesh`).

    With `write_pool` (an Executor), the write (the TIFF, or the entropy
    coding, world file, .prj and sidecar) is submitted to it and its Future
    returned: the band is copied back and the metadata snapshotted here,
    so the writer gets host arrays only and never touches the device.
    Without it the write runs here and None is returned."""
    output = Path(output)
    in_rows, in_cols = dn.shape
    tiff = format is OutputFormat.TIFF
    depth = bit_depth if tiff else BitDepth.U8
    mesh = _shard_mesh(shard_devices, dn, target_size, pad)
    if _is_big_scene(in_rows, in_cols, target_size):
        out = streamed.grayscale_streamed(dn, strategy=strategy,
                                          bit_depth=depth, pad=pad,
                                          jpeg_dct=not tiff, mesh=mesh)
    elif mesh is not None:
        from ..parallel import sharded

        out = sharded.grayscale_batch(
            dn[None], mesh, strategy=strategy, bit_depth=depth,
            target_size=target_size, pad=pad, resample_alg=resample_alg)[0]
        if not tiff:
            out = fused.jpeg_dct_planes(out[None])[0]
    else:
        out = fused.grayscale_pipeline(
            dn, strategy=strategy, bit_depth=depth, target_size=target_size,
            pad=pad, resample_alg=resample_alg, jpeg_dct=not tiff)
    arr = _to_host(out, write_pool is not None)
    final_cols, final_rows, gt, proj = _geo(metadata, in_rows, in_cols,
                                            target_size, pad, resample_alg)
    label = operation.metadata_label
    meta = metadata.copy() if metadata is not None else None

    def write():
        if tiff:
            writer = write_tiff_u8 if depth is BitDepth.U8 else write_tiff_u16
            _write_tiff(writer(output, final_cols, final_rows, arr), meta,
                        label, gt, proj)
        else:
            jpeg.write_gray_jpeg_dct(output, final_cols, final_rows, arr)
            _write_jpeg_sidecars(output, meta, label, gt, proj)
        logger.info("fast: saved %s", output)

    return _submit(write, write_pool)


def _synrgb_coeffs(dn1, dn2, target_size, pad, strategy, resample_alg,
                   staged_b1=None) -> torch.Tensor:
    """The synRGB JPEG's quantized DCT blocks (3, bh, bw, 8, 8) int16 of a
    band pair below the streamed size, on the bands' device: band 1's stage
    (unless `staged_b1` is already queued), band 2's, the combine."""
    stage = dict(strategy=strategy, target_size=target_size, pad=pad,
                 resample_alg=resample_alg)
    b1 = (staged_b1 if staged_b1 is not None
          else fused.synrgb_band_stage(dn1, copol=True, **stage))
    b2 = fused.synrgb_band_stage(dn2, copol=False, **stage)
    return fused.synrgb_combine_stage(b1, b2, strategy=strategy,
                                      suppressed=None, channel_order="dct")


def _write_synrgb(output: Path, final_cols, final_rows, coeffs, metadata,
                  label, gt, proj, syn_mode) -> None:
    """Entropy-code the host blocks `coeffs` and write the sidecars."""
    jpeg.write_synrgb_jpeg_dct(output, final_cols, final_rows, coeffs)
    _write_jpeg_sidecars(output, metadata, label, gt, proj,
                         [("synthetic_rgb_mode", syn_mode.display)])
    logger.info("fast: saved %s", output)


def save_multiband_fast(
    dn1, dn2, output, format: OutputFormat, bit_depth: BitDepth, target_size,
    metadata=None, pad: bool = False, strategy=None,
    operation: ProcessingOperation = ProcessingOperation.MULTIBAND_VV_VH,
    syn_mode: SyntheticRgbMode = SyntheticRgbMode.DEFAULT,
    resample_alg=None, staged_b1=None, write_pool=None,
    shard_devices: int = 0,
):
    """Dual-band DN (device tensors) -> two-band GeoTIFF (u8 or u16, one
    grayscale program per band) or synRGB JPEG + world file, .prj and
    sidecar; a big scene takes the streamed passes. `staged_b1` is band 1's
    already-queued synRGB band stage (the reader's overlapped load; never
    made for a big scene); without it band 1's stage runs here.
    `write_pool` defers the write and `shard_devices` shards the scene as
    in `save_single_band_fast`."""
    output = Path(output)
    in_rows, in_cols = dn1.shape
    big = _is_big_scene(in_rows, in_cols, target_size)
    final_cols, final_rows, gt, proj = _geo(metadata, in_rows, in_cols,
                                            target_size, pad, resample_alg)
    label = operation.metadata_label
    meta = metadata.copy() if metadata is not None else None
    mesh = _shard_mesh(shard_devices, dn1, target_size, pad)
    if format is OutputFormat.TIFF:
        if big:
            gray = functools.partial(streamed.grayscale_streamed,
                                     strategy=strategy, bit_depth=bit_depth,
                                     pad=pad, mesh=mesh)
        elif mesh is not None:
            from ..parallel import sharded

            def gray(dn):
                return sharded.grayscale_batch(
                    dn[None], mesh, strategy=strategy, bit_depth=bit_depth,
                    target_size=target_size, pad=pad,
                    resample_alg=resample_alg)[0]
        else:
            gray = functools.partial(
                fused.grayscale_pipeline, strategy=strategy,
                bit_depth=bit_depth, target_size=target_size, pad=pad,
                resample_alg=resample_alg)
        b1, b2 = (_to_host(gray(dn), write_pool is not None)
                  for dn in (dn1, dn2))

        def write():
            writer = (write_tiff_multiband_u8 if bit_depth is BitDepth.U8
                      else write_tiff_multiband_u16)
            _write_tiff(writer(output, final_cols, final_rows, b1, b2), meta,
                        label, gt, proj)
            logger.info("fast: saved %s", output)

        return _submit(write, write_pool)
    if big:
        # host blocks (pinned on a GPU), after the streamed front end's
        # end-of-copies sync
        coeffs = streamed.synrgb_streamed(dn1, dn2, strategy=strategy,
                                          pad=pad, layout="dct", mesh=mesh)
    elif mesh is not None:
        from ..parallel import sharded

        coeffs = sharded.synrgb_batch(
            dn1[None], dn2[None], mesh, strategy=strategy,
            target_size=target_size, pad=pad, channel_order="dct",
            resample_alg=resample_alg)[0]
    else:
        coeffs = _synrgb_coeffs(dn1, dn2, target_size, pad, strategy,
                                resample_alg, staged_b1)
    coeffs = _to_host(coeffs, write_pool is not None)
    return _submit(functools.partial(
        _write_synrgb, output, final_cols, final_rows, coeffs, meta, label,
        gt, proj, syn_mode), write_pool)


def save_multiband_batch_fast(
    items, target_size, pad: bool = False, strategy=None,
    operation: ProcessingOperation = ProcessingOperation.MULTIBAND_VV_VH,
    syn_mode: SyntheticRgbMode = SyntheticRgbMode.DEFAULT,
    resample_alg=None, write_pool=None,
):
    """Synthetic-RGB JPEGs of a bucket of same-shape scenes below the
    streamed size (port of sarpro_tpu/core/fast_path.py:351-422). `items`
    yields (dn1, dn2, output, metadata) with the bands on a device, each
    scene's stages running on its bands' device (`bucket_devices` spreads
    a bucket over the caller's devices); a generator may upload each scene
    as it is asked for. Each
    scene's band stages and combine stage are queued back to back with no
    host sync between scenes, and its blocks copied back to pinned host
    memory without waiting; one sync for the bucket, then one write a
    scene (deferred to `write_pool` when given, with the blocks in pageable
    memory, `_to_host`). The kernels are the
    per-scene route's, so each file equals `save_multiband_fast`'s. Returns
    the write Futures (None entries where written here)."""
    label = operation.metadata_label
    done, pinned = [], []
    devices = []
    for dn1, dn2, output, metadata in items:
        in_rows, in_cols = dn1.shape
        if _is_big_scene(in_rows, in_cols, target_size):
            raise ValueError("a device-batch bucket takes scenes below the "
                             "streamed size")
        device = dn1.device
        if device not in devices:
            devices.append(device)
        coeffs = _synrgb_coeffs(dn1, dn2, target_size, pad, strategy,
                                resample_alg)
        host = torch.empty(coeffs.shape, dtype=coeffs.dtype,
                           pin_memory=device.type == "cuda")
        host.copy_(coeffs, non_blocking=True)
        pinned.append(host)
        final_cols, final_rows, gt, proj = _geo(
            metadata, in_rows, in_cols, target_size, pad, resample_alg)
        meta = metadata.copy() if metadata is not None else None
        done.append(functools.partial(
            _write_synrgb, Path(output), final_cols, final_rows,
            metadata=meta, label=label, gt=gt, proj=proj,
            syn_mode=syn_mode))
        del dn1, dn2, coeffs
    for device in devices:
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
    return [_submit(functools.partial(write, coeffs=_to_host(
        host, write_pool is not None)), write_pool)
        for write, host in zip(done, pinned)]


def bucket_devices(n_scenes: int, device) -> list:
    """The device of each scene of a bucket of `n_scenes`: a pure scene
    mesh over the largest divisor of the bucket that is at most the number
    of devices a caller on `device` has (sarpro_tpu/core/fast_path.py:
    374-383), scenes in contiguous groups. One device on one card."""
    avail = available_devices(device)
    n = max(d for d in range(1, min(len(avail), n_scenes) + 1)
            if n_scenes % d == 0)
    mesh = make_mesh(n, shape=(n, 1), devices=avail)
    return [mesh.row_devices(i * n // n_scenes)[0] for i in range(n_scenes)]
