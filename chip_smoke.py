#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sarpro_tpu_torch) on one GPU.

    python3 chip_smoke.py [--walls N]

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):
  1. environment: a CUDA device is required; prints the card's name and
     power limit, the torch and CUDA versions; TF32 off;
  2. build: the native codec and box reducer and the raster decoders (g++,
     sarpro_tpu_torch._native) and the Hopper kernels (nvcc,
     sarpro_tpu_torch/csrc) from source, at the same time;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the slice gives it (the histogram and the CLAHE kernels also
     at the 100 MP full-resolution route's, on a 100 MP band of one bin and
     a ragged 9999 x 10001; the histogram and synRGB lookup at every length
     0..67 and of every residue mod 16 from every base offset past 16 bytes,
     HIST_EDGES (one bin, all masked, negative and past-the-end values,
     MAX_HIST_BINS, two u8 streams of unequal length and alignment) and on
     uniform and SAR-like u8 pairs, synRGB also at every floor 3..40 with
     and without the water mask; the CLAHE kernels at CLAHE_EDGES: widths
     of every residue mod 4, base pointers off 16 bytes, bands under 8
     pixels a side, row offsets, one bin, all masked, bins out of range;
     resample and warp also at edge shapes, with the warp's share of tiles
     on each branch), with the
     device times of both (device_ms, cross-checked by torch.profiler), the
     bound (bytes over the memory rate or operations over the f32 rate)
     and, where one PyTorch call computes the same function, that call's
     time (the 100 MP lookup also beside a device copy of its bytes);
  4. slice: a 20000 x 20000 dual-pol SAFE (make_safe below, random DN from
     a seed) through the port's CLI to 2048 synRGB JPEGs: CLAHE with
     auto-UTM warp, pad and cubic (cold, then warm), Tamed with the same
     warp (warm), and Tamed without warp (warm cubic, warm default filter).
     Each warm path is driven with the launch counts set to 0 just before it
     and read just after: the CLAHE warp path must launch histogram,
     tile_histogram, clahe_lookup, warp_sample and synrgb_lookup and take
     the host box reduce; the Tamed warp path histogram, warp_sample and
     synrgb_lookup; the no-warp path histogram, resample_axis0 and
     synrgb_lookup. The warp paths' .prj must name a UTM CRS;
  5. resident: the band and combine stages once more on the device-resident
     bands (the warped ones for CLAHE, the DN for Tamed), with host syncs
     made errors, and under force_plain(); the bands must agree within 1 and
     the rgb where they agree; the JPEG's first MCUs are entropy-decoded
     and must equal the device's coefficient blocks. A breakdown of the warp
     path's time is printed;
  6. gray: the single-band, operation and TIFF routes on the same SAFE
     (GRAY_RUNS: u8 CLAHE and u16 adaptive TIFF, multiband robust JPEG in
     the default synRGB mode, ratio JPEG, u16 multiband TIFF, CLAHE JPEG
     with auto-UTM warp), each run twice, the second with its launch counts
     checked against PATHS. The TIFFs are read back (dtype, shape, bands,
     georeferencing as the reference writes it) and must hold the device's
     band; the gray JPEGs' first MCUs must be the device's blocks. The
     grayscale program runs again on the resident bands of the two TIFF
     routes with host syncs made errors, then under force_plain(). A
     breakdown of the single-band route is printed. Then JPEG_800, the
     multiband robust and ratio JPEGs at --size 800 (the 4:4:4 and gray
     entropy coder entries at 100 MCU rows), each driven once with its
     launch counts checked: every MCU of each file, and of the device's
     blocks coded again on 16 threads, decodes to the device's blocks;
  7. exact: a 10000 x 10000 HH+HV SAFE (the size of a Sentinel-1 EW
     medium-resolution GRD, under BIG_SCENE_PIXELS, so the fused programs
     take it at original size), then EXACT_RUNS, exact mode through the CLI without
     --fast: the CLAHE auto-UTM synRGB JPEG and the u16 adaptive cubic TIFF
     at 2048, the ratio and multiband robust JPEGs at 800 (the gray and
     4:4:4 pixel coder entries), and the CLI's defaults at original size on
     the 10000^2 product. Each runs twice, the second with its launch counts
     checked against PATHS (all six kernels between them) and its device
     peak memory read, then once with --fast for the wall beside it. Every
     MCU of the 800 JPEGs, and of their planes coded again on 16 threads,
     decodes to within +-1 of an f64 DCT of the planes the coder was handed
     (the 2048 JPEG's first MCUs too); the TIFFs are read back.
     process_safe_to_buffer runs with the kernels and under force_plain()
     on the 2048 CLAHE synRGB and the 100 MP CLAHE routes: bit-equal, and
     the 100 MP band equals the CLI's TIFF. The band pipeline's time between
     CUDA events, its kernels' time and its host syncs are printed;
  8. full resolution: the 10000 x 10000 product through the CLI's defaults
     at original size with --fast (u8 CLAHE TIFF, run twice) and to a 2048
     padded CLAHE synRGB JPEG; the CLAHE kernels at 100 MP against their
     plain versions through the grayscale program;
  9. streamed: STREAMED_RUNS, the 20000^2 SAFE at original size (above
     BIG_SCENE_PIXELS, so core/streamed runs it): the CLI's defaults
     without --fast (u8 VV CLAHE TIFF), the --fast CLAHE synRGB JPEG (q16
     compose, chunked DCT) and the --fast u16 adaptive VH TIFF, each driven
     once with its launches equal to the chunk plan's (_streamed_launches);
     the TIFFs read back and equal to the device's band, the JPEG's first
     MCUs equal to the device's blocks. On the resident DN the streamed
     grayscale and synRGB (dct) passes are bit-equal to the fused program
     (the synRGB floors compared first) and under force_plain(), with each
     side's device time, wall and peak memory and the streamed side's host
     syncs at two chunk heights; exact mode's band pipeline on the same
     bands with its peak. The kernel phase also times tile_histogram,
     clahe_lookup and the 4096-bin histogram at the chunk shapes;
 10. batch: BATCH_RUNS over a directory of hard links to both products, a
     copy with VV and VH exchanged, a cut raster (an error), an SLC and a
     directory that is no SAFE (both skipped): each route through the
     single-scene CLI, then the batch CLI serial, pipelined and (synRGB
     routes) bucketed, with the counters, the launches and the files of the
     single-scene runs; one route again under force_plain(), and each
     synRGB route's pipelined run under torch.profiler with every launch
     and copy on the consumer thread;
 11. GUI: the port's GUI server (make_server on the card, in a thread),
     driven over HTTP: the page, stats and CRS check; the warm CLAHE
     auto-UTM JPEG job (the second time under utils.profiling.trace, whose
     trace must name its five kernels), the exact 100 MP CLAHE TIFF job
     with its PNG preview against the script's own render, the Tamed cubic
     batch job (prefetch 2) and a sharded job asking for exact mode, which
     must write the --fast CLI's files (on one card with the one-device
     warning). Launches equal the CLI's on each route, files equal the
     CLI's and the batch phase's (one conversion time), and every kernel
     wrapper call and device copy of a job lies on that job's worker
     thread. Then the root's SafeReader on the card against open_pair;
 12. shard: on the card(s) there are, the headline CLAHE auto-UTM 2048
     JPEG and the 100 MP CLAHE TIFF through the CLI with --shard-devices 2
     and -1 (and 2 without --fast): files byte-equal to --fast, on one card
     with the JAX package's one-device warning and the --fast launches.
     Then on a virtual mesh of the card repeated 4 times (and 2 or 3 where
     noted): grayscale_batch (100 MP CLAHE u8, Adaptive u16), synrgb_batch
     (100 MP CLAHE with tiles across row blocks, 2- and 4-way; the 400 MP
     pair at 2048 padded), the streamed mesh mode on one 400 MP band and
     warp_sample_sharded on the headline warp (4-way, and 3-way with a
     ragged last block), each bit-equal to its unsharded run with its
     launches the per-shard kernels x n, the 100 MP and 400 MP device
     times and peaks beside the unsharded ones; on 2 or more cards the same
     on the cards (else a line says the copies between cards went
     unchecked);
 13. rasters: the non-TIFF readers (io/jpeg, io/bmp, io/netpbm) on inputs
     written without Pillow: an 80 MP (8000 x 10000) SAR-like u8 band as a
     q100 gray JPEG with .jgw and .prj (the native coder), the same band as
     a 24-bit BMP, a P5 PGM of maxval 4095, and the headline route's 2048
     synRGB JPEG. Each opens through RasterReader (decode ms on the host
     clock, median of 3), holds its size and georeferencing, equals what
     was written (BMP and PGM bit for bit, the PGM through Pillow's
     rescale; the JPEGs within the round trip of tests/
     test_torch_decoders.py), and reads decimated to 2048^2 on the card
     (cubic) with the launch counts set to 0 just before and read just
     after, bit-equal to the plain resample; the 80 MP band's read is then
     written as a CLAHE gray JPEG by api.save_image and read back. Then
     the JPEG codings of tests/data/jpeg (libjpeg-turbo's or Pillow's from
     seeds): each file decodes to the SHA-256 of Pillow's decode (a SOF9
     and a SOF3 strip, an RGB 4:2:0 SOF10 file, a SOF2 and a SOF10 file
     block-smoothed); the SOF3 strip spliced restart interval by restart
     interval into an 80 MP band equal to np.tile of the strip's decode, and
     the SOF9 strip as it is (arithmetic-coded data past Pillow's first 64
     KiB read opens in neither reader), each with .jgw / .prj through
     RasterReader, decode ms beside the Huffman band's, each read to 2048^2
     on the card (cubic) with its launches counted from 0, bit-equal to the
     plain resample, and saved as a CLAHE gray JPEG that reads back;
 14. jpeg2000: io/jpeg2000 on the five codestreams of tests/data/jpeg2000
     (written by Pillow, or by OpenJPEG's own encoder, from seeds; no Pillow
     here) and the HTJ2K one of tests/data/jpeg2000_ht (tests/htj2k_encode.py),
     spliced tile-part by tile-part into an 84.9 MP (9216^2, 18 x 18
     tiles of 512^2) lossless SAR-like u16 band in a JP2 with .j2w and
     .prj, the same band with HT code-blocks (J2K_HT: its tile's decode
     has the SHA-256 of Pillow's, J2K_HT_SHA256, the seeded DN; two resample
     launches in its decimated read, one of each CLAHE kernel in its save,
     its decode ms beside the default band's), the same band coded with
     every code-block style (BYPASS, RESET,
     TERMALL, VSC, PTERM, SEGSYM), a main-header POC of two progressions and,
     in every other tile, a tile-part COD and an RGN shift (J2K_STYLED),
     a 4096^2 RGB band (16 x 16 tiles of a 9/7, ICT, two-layer RPCL
     tile), a 4096^2 sYCC 4:2:0 JP2 (J2K_SYCC: Cb and Cr sub-sampled 2 x
     2, 9/7; 16 x 16 tiles of 256^2) and a 4096^2 JP2 of 20-bit amplitude
     (J2K_DEEP, read as I;16; 16 x 16 tiles). Each opens through
     RasterReader (decode ms on the host clock, median of 3, MB and MP/s
     beside the host CPU; the styled band's, the sYCC one's and the 20-bit
     one's beside the default band's); the u16 bands are bit-equal to
     np.tile of the seeded tile with their geotransform and EPSG (the
     styled codestream's own decode has the SHA-256 of Pillow's,
     J2K_STYLED_SHA256), every RGB tile equals the port's decode of the
     tile alone, whose SHA-256 is Pillow's (J2K_RGB_SHA256), and so do the
     sYCC and 20-bit bands (J2K_SYCC_SHA256, J2K_DEEP_SHA256; all pinned in
     tests/test_torch_jpeg2000*.py); each band but the RGB one reads
     decimated to 2048^2 on the card (cubic) with the launch counts set to
     0 just before and read just after (two resample launches for the
     styled, sYCC and 20-bit bands), bit-equal to the plain resample, and
     that read is written as a CLAHE gray JPEG by api.save_image (one launch
     of each CLAHE kernel for the sYCC and 20-bit bands) and read back;
 15. webp: io/webp on the four files of tests/data/webp (written by
     Pillow from seeds; no Pillow here: a SAR-like band as lossy RGB, a lossy
     RGBA with a filtered, VP8L-coded ALPH plane, a lossless RGBA, a
     two-frame animation), each decoding to the SHA-256 of Pillow's decode
     (WEBP_FIXTURES, pinned in tests/test_torch_webp.py), and an 84.9 MP
     (9216^2) SAR-like u8 band written here as VP8L by vp8l_write (no
     transforms, 8-bit literal codes: the decoder's literal path only) with
     .wpw and .prj. The band opens through RasterReader (decode ms on the
     host clock, median of 3, MB and MP/s beside the host CPU), equals the
     band written with its geotransform and EPSG, reads decimated to 2048^2
     on the card (cubic) with the launch counts set to 0 just before and
     read just after, bit-equal to the plain resample, and that read is
     written as a CLAHE gray JPEG by api.save_image and read back;
 16. formats: io/pilraster's plugin loop (Pillow 12.1's order and its "try
     the next plugin" errors) and the float, scientific and run-length
     readers (io/netpbm's PFM, io/fits, io/mcidas, io/spider, io/im,
     io/sgi, io/tga, io/pcx, io/sun, io/psd, io/qoi; the run-length loops
     in sarpro_tpu_torch/_native/rledec.cpp) on the 22 files of
     tests/data/formats (FORMATS_FIXTURES: the SHA-256 of Pillow's decode
     of each, pinned in tests/test_torch_rle_rasters.py), and five bands of
     make_safe's lognormal DN written here without Pillow: a 9216^2 float32
     "Pf" PFM, a 9216^2 FITS of BITPIX 16 (read as Pillow reads it: the
     big-endian samples as little-endian, rows bottom-up), a 10848^2 2-byte
     McIdas AREA (GOES-R ABI's 1 km full disk, 117.7 MP: the port logs
     Pillow's decompression-bomb warning), and 9216^2 u8 SGI RLE and TGA
     RLE bands, each with .wld and .prj. Each opens through RasterReader
     (decode ms on the host clock, median of 3), equals what Pillow reads of
     it, reads decimated to 2048^2 on the card (cubic; the float band on the
     resample's f32 route) with the launch counts set to 0 just before and
     read just after, bit-equal to the plain resample, and that read is
     written as a CLAHE gray JPEG by api.save_image and read back;
 17. longtail: Pillow's long tail of formats (io/bmp's DIB, io/ico for ICO
     and CUR, io/icns, io/dds and io/ftex over io/bcn's BC1-BC7, with the
     blocks decoded by sarpro_tpu_torch/_native/bcndec.cpp, io/blp, io/xbm,
     io/xpm, io/msp, io/pixar, io/gbr, io/fli, io/pcd, io/xvthumb, io/imt,
     io/iptc; their loops in _native/rledec.cpp) on the files of
     tests/data/formats that LONGTAIL_FIXTURES names (the SHA-256 of
     Pillow's decode of each, pinned in tests/test_torch_legacy_rasters.py),
     and three 9216^2 bands of make_safe's DN written here without Pillow,
     each with a .wld and a .prj: a DDS of BC4 blocks, a DDS DX10 of BC7
     mode-6 blocks (bc7_mode6_write) and an IM Tools "L" file. Each opens
     through RasterReader (decode ms on the host clock, median of 3),
     decodes to the SHA-256 of Pillow's decode of the same band
     (LONGTAIL_BANDS), reads decimated to 2048^2 on the card (cubic) with
     the launch counts set to 0 just before and read just after, bit-equal
     to the plain resample, and is saved as a CLAHE gray JPEG that reads
     back;
 18. avif: io/avif over sarpro_tpu_torch/_native/av1dec.cpp (libavif
     1.3.0's container with its alpha item, AV1 intra key frames of 8-, 10-
     and 12-bit 4:2:0, 4:2:2, 4:4:4 and monochrome samples with palette
     blocks, quantizer matrices and intra block copy, their in-loop filters
     (deblocking, CDEF, loop restoration) and film grain; libavif's YUV to
     RGB(A) through libyuv and its own code, and its unpremultiply of a
     `prem` alpha) on the files of tests/data/avif (written by Pillow from
     AVIF_SEED; AVIF_FIXTURES pins the SHA-256 of Pillow's decode of each,
     held in tests/test_torch_avif.py and tests/test_torch_avif_tools.py;
     the hbd_ files of 10- and 12-bit samples written by libavif 0.11.1,
     held in tests/test_torch_avif_depth.py; the grid_ and seq_ files of
     grid items and `avis` image sequences, held in
     tests/test_torch_avif_container.py; the scale_ and sweep_8_ files of
     frames scaled to their `ispe` and of libavif's own conversion, held in
     tests/test_torch_avif_scale.py; the sr_ files of frames coded with AV1
     superres by libaom 3.6.0, held in tests/test_torch_avif_superres.py)
     and on the eight committed
     9216^2 SAR-like bands of tests/data/avif_band (Pillow at speed 6,
     autotiling, loop filter off, AVIF_BAND_SHA256; at speed 4 with CDEF
     on, so that all three filters are on, AVIF_FILTERED_BAND_SHA256; as
     "LA", 4:0:0, its alpha a no-data footprint, AVIF_LA_BAND_SHA256; and
     as premultiplied RGBA with the footprint, quantizer matrices and a
     grain model aom estimates from the speckle, AVIF_GRAIN_BAND_SHA256;
     and make_safe's DN clipped to 12 bits as 12-bit 4:0:0 with the
     footprint as a 12-bit alpha item, written by libavif 0.11.1 and aom
     3.6.0, AVIF_DEPTH_BAND_SHA256; and as a 3 x 3 grid of 3072^2 8-bit
     4:2:0 tiles with the footprint as a 3 x 3 alpha grid, written by
     libavif 0.11.1 and aom 3.6.0, AVIF_GRID_BAND_SHA256; and as Pillow's
     6144^2 8-bit 4:2:0 RGBA with the footprint, both items' `ispe` set to
     9216^2 and the `colr` matrix to SMPTE 240M in limited range, so that
     the decode scales both frames up and converts them with libavif's own
     float code, AVIF_SCALE_BAND_SHA256; and as 8-bit 4:2:0 with the
     footprint as alpha, both coded by libaom 3.6.0 with superres at 8/16
     (4608 columns, upscaled after CDEF, then loop-restored at 9216),
     AVIF_SUPERRES_BAND_SHA256), each with a .wld
     and a .prj beside a copy of it. Each opens through RasterReader (decode
     ms on the host clock, median of 3, MP/s), decodes to the pinned
     SHA-256, reads decimated to 2048^2 on the card (cubic; the alpha, band
     4, of the LA,
     grain, 12-bit, grid, scaled and superres bands too) with the launch
     counts set to
     0 just
     before and read just after, bit-equal to the plain resample, and is
     saved as a CLAHE gray JPEG that reads back;
 19. with --walls N only: every warm path N times more, interleaved, with
     medians and quartiles of its wall; the no-warp synRGB read through
     each of the two loaders (full DN + device resample, decimated read) in
     the same rounds; a torch.profiler trace of the single-band TIFF, the
     full-resolution TIFF runs (fast, then exact) and the streamed CLAHE
     TIFF with the device's busy share.
Then one JSON line of the kernels, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Nothing of jax or of the JAX package
(sarpro_tpu) may be imported: the script raises at the end if one was.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SIDE = 20000  # 400 MP per band, the reference's published scene size
SIZE = 2048
MID = 2380  # the host-reduced source of the 20000^2 -> 2048 auto-UTM warp
EW_SIDE = 10000  # 100 MP per band: a Sentinel-1 EW medium-resolution GRD
EW_NAME = "S1A_EW_GRDM_1SDH_20250706T204346.SAFE"
DEVICE = "cuda"
RESAMPLE_TOL = dict(rtol=2e-6, atol=2e-2)
# kernel -> (source, the TPU kernel body it replaces[, a second body])
KERNELS = {
    "histogram": ("sarpro_tpu_torch/csrc/histogram.cu",
                  "sarpro_tpu/ops/kernels.py:107"),
    "tile_histogram": ("sarpro_tpu_torch/csrc/tile_histogram.cu",
                       "sarpro_tpu/ops/kernels.py:202"),
    "clahe_lookup": ("sarpro_tpu_torch/csrc/clahe_lookup.cu",
                     "sarpro_tpu/ops/kernels.py:352"),
    "resample_axis0": ("sarpro_tpu_torch/csrc/resample.cu",
                       "sarpro_tpu/ops/resample_kernel.py:87"),
    "synrgb_lookup": ("sarpro_tpu_torch/csrc/synrgb.cu",
                      "sarpro_tpu/ops/kernels.py:635",
                      "sarpro_tpu/ops/kernels.py:581"),
    "warp_sample": ("sarpro_tpu_torch/csrc/warp.cu",
                    "sarpro_tpu/ops/warp_kernel.py:67"),
}
# the kernels each warm path of the slice phase must launch
PATHS = {
    "warm clahe auto": ("histogram", "tile_histogram", "clahe_lookup",
                        "warp_sample", "synrgb_lookup"),
    "warm tamed auto": ("histogram", "warp_sample", "synrgb_lookup"),
    "warm tamed cubic": ("histogram", "resample_axis0", "synrgb_lookup"),
    "gray clahe tiff": ("histogram", "tile_histogram", "clahe_lookup"),
    "gray adaptive u16 cubic": ("histogram", "resample_axis0"),
    "multiband robust jpeg": ("histogram", "resample_axis0", "synrgb_lookup"),
    "ratio jpeg": ("histogram",),
    "multiband tiff": ("histogram",),
    "gray auto": ("histogram", "tile_histogram", "clahe_lookup",
                  "warp_sample"),
    "full clahe tiff": ("histogram", "tile_histogram", "clahe_lookup"),
    "full multiband jpeg": ("histogram", "resample_axis0", "tile_histogram",
                            "clahe_lookup", "synrgb_lookup"),
    "multiband robust jpeg 800": ("histogram", "resample_axis0",
                                  "synrgb_lookup"),
    "ratio jpeg 800": ("histogram",),
    "exact clahe auto jpeg": ("histogram", "tile_histogram", "clahe_lookup",
                              "warp_sample", "synrgb_lookup"),
    "exact adaptive u16 cubic tiff": ("histogram", "resample_axis0"),
    "exact ratio jpeg 800": ("histogram",),
    "exact multiband robust jpeg 800": ("histogram", "synrgb_lookup"),
    "exact full clahe tiff": ("histogram", "tile_histogram", "clahe_lookup"),
    "streamed exact clahe tiff": ("histogram", "tile_histogram",
                                  "clahe_lookup"),
    "streamed synrgb jpeg": ("histogram", "tile_histogram", "clahe_lookup",
                             "synrgb_lookup"),
    "streamed adaptive u16 tiff": ("histogram",),
}
# the single-band, operation and TIFF routes on the 20000^2 SAFE: (label,
# output suffix, CLI arguments; the rest are the CLI's defaults)
GRAY_RUNS = (
    ("gray clahe tiff", "tiff", ["--polarization", "vv", "-f", "tiff",
                                 "--autoscale", "clahe"]),
    ("gray adaptive u16 cubic", "tiff", [
        "--polarization", "vh", "-f", "tiff", "--bit-depth", "u16",
        "--autoscale", "adaptive", "--resample-alg", "cubic"]),
    ("multiband robust jpeg", "jpg", ["--polarization", "multiband", "-f",
                                      "jpeg", "--autoscale", "robust",
                                      "--pad"]),
    ("ratio jpeg", "jpg", ["--polarization", "ratio", "-f", "jpeg",
                           "--autoscale", "standard"]),
    ("multiband tiff", "tiff", ["--polarization", "multiband", "-f", "tiff",
                                "--bit-depth", "u16", "--autoscale",
                                "standard"]),
    ("gray auto", "jpg", ["--polarization", "vv", "-f", "jpeg",
                          "--autoscale", "clahe", "--target-crs", "auto",
                          "--resample-alg", "cubic"]),
)
# the 4:4:4 and gray JPEG routes at an output of 100 MCU rows, where the
# entropy coder's band split put bands past the image on 16 threads before
# the bindings chose its thread count (sarpro_tpu_torch._native.
# coder_threads): (label, CLI arguments)
SIZE_800 = 800
JPEG_800 = (
    ("multiband robust jpeg 800", ["--polarization", "multiband", "-f", "jpeg",
                                   "--autoscale", "robust", "--pad"]),
    ("ratio jpeg 800", ["--polarization", "ratio", "-f", "jpeg",
                        "--autoscale", "standard"]),
)
# exact mode's routes, the CLI without --fast: (label, SAFE ("main", the
# 20000^2 IW product, or "ew", the 10000^2 EW one), output suffix, --size
# ("SIZE", "SIZE_800" or None: original), the other CLI arguments). Each
# also runs once with --fast, for the wall beside it. The two 800 JPEGs take
# the gray and the 4:4:4 pixel coder entries.
EXACT_RUNS = (
    ("exact clahe auto jpeg", "main", "jpg", "SIZE", [
        "--polarization", "multiband", "-f", "jpeg", "--autoscale", "clahe",
        "--pad", "--target-crs", "auto", "--resample-alg", "cubic"]),
    ("exact adaptive u16 cubic tiff", "main", "tiff", "SIZE", [
        "--polarization", "vh", "-f", "tiff", "--bit-depth", "u16",
        "--autoscale", "adaptive", "--resample-alg", "cubic"]),
    ("exact ratio jpeg 800", "main", "jpg", "SIZE_800", [
        "--polarization", "ratio", "-f", "jpeg", "--autoscale", "standard"]),
    ("exact multiband robust jpeg 800", "main", "jpg", "SIZE_800", [
        "--polarization", "multiband", "-f", "jpeg", "--autoscale", "robust",
        "--pad"]),
    ("exact full clahe tiff", "ew", "tiff", None, ["--polarization", "hh"]),
)
# the streamed routes: the SIDE^2 SAFE at its original size, above
# BIG_SCENE_PIXELS, so both modes take core/streamed: (label, output
# suffix, CLI arguments; the size is the CLI's default, the original)
STREAMED_RUNS = (
    ("streamed exact clahe tiff", "tiff", ["--polarization", "vv"]),
    ("streamed synrgb jpeg", "jpg", [
        "--fast", "--polarization", "multiband", "-f", "jpeg", "--autoscale",
        "clahe"]),
    ("streamed adaptive u16 tiff", "tiff", [
        "--fast", "--polarization", "vh", "-f", "tiff", "--bit-depth", "u16",
        "--autoscale", "adaptive"]),
)
# the batch routes over the batch directory (_batch_dir): (label, CLI
# arguments besides --input-dir and --output-dir, with "SIZE" for SIZE, the
# kernels its runs must launch, whether it buckets). Each runs through the
# single-scene CLI per product, then serial, pipelined and (bucketing
# routes) bucketed
BATCH_RUNS = (
    ("batch clahe auto jpeg", [
        "--fast", "-f", "jpeg", "--polarization", "multiband", "--autoscale",
        "clahe", "--size", "SIZE", "--pad", "--target-crs", "auto",
        "--resample-alg", "cubic"],
     ("histogram", "tile_histogram", "clahe_lookup", "warp_sample",
      "synrgb_lookup"), True),
    ("batch tamed cubic jpeg", [
        "--fast", "-f", "jpeg", "--polarization", "multiband", "--autoscale",
        "tamed", "--size", "SIZE", "--pad", "--resample-alg", "cubic"],
     ("histogram", "resample_axis0", "synrgb_lookup"), True),
    ("batch exact clahe tiff", ["--polarization", "vv", "--size", "SIZE"],
     ("histogram", "tile_histogram", "clahe_lookup"), False),
)
BATCH_MODES = {"serial": ["--prefetch", "0"],
               "pipelined": ["--prefetch", "2", "--device-batch", "1"],
               "bucketed": ["--prefetch", "2", "--device-batch", "2"]}
# the warm runs that --walls traces under torch.profiler
TRACED = ("gray clahe tiff", "full clahe tiff", "exact full clahe tiff",
          "streamed exact clahe tiff")
# label -> (CLI arguments, output) of each run driven, for --walls
DRIVEN: dict = {}
# label -> (wall s, launches) of each run driven, for the GUI phase
DRIVE_LOG: dict = {}
# label -> the composed RGB (host copy) of a resident run, whose JPEG the
# rasters phase reads back
RESIDENT_RGB: dict = {}
# the log line of a shard request on a host with one device (the JAX
# package's, sarpro_tpu/core/fast_path.py:82-90), % the request
ONE_DEVICE_WARNING = ("shard: %s device(s) requested but only 1 available; "
                      "running unsharded")
# the rasters phase: an 80 MP (8000 x 10000) SAR-like u8 band, under
# Pillow's 89.5 MP warning; the JPEGs read back within the round trip the
# CPU suite measures for the port's q100 coders, decoded there by the port
# and by Pillow alike (tests/test_torch_decoders.py); the synRGB JPEG's
# coefficients come from the card's DCT, within +-1 of the f64 one, so its
# bound here is one level wider
RASTER_ROWS, RASTER_COLS = 10000, 8000
PGM_ROWS, PGM_COLS, PGM_MAXVAL = 4000, 5000, 4095
GRAY_Q100_ROUNDTRIP = 2
SYNRGB_Q100_ROUNDTRIP = 4
# the jpeg2000 phase: Pillow-written tiles (tests/data/jpeg2000, made by
# tests/test_torch_jpeg2000.py from these seeds) spliced into 84.9 MP of
# u16 (under Pillow's 89.5 MP warning) and 4096^2 of RGB; the SHA-256 of
# Pillow's decode of the RGB tile, which the port's must match
J2K_DIR = ROOT / "tests" / "data" / "jpeg2000"
J2K_BAND, J2K_BAND_SEED, J2K_BAND_TILES = "sar_u16_512.j2k", 13, 18
J2K_RGB, J2K_RGB_SEED, J2K_RGB_TILES = "rgb_97_256.j2k", 14, 16
J2K_RGB_SHA256 = ("4c7da7321af50225bed0e90a4909a7d1"
                  "de1fcc26f06e867d74b9dfc2e5bafb21")
# the styled band: the u16 tile twice in a row, written by OpenJPEG 2.5.4's
# own encoder (tests/opj_encode.py): tile 0 with every code-block style,
# tile 1 with a tile-part COD of all but BYPASS and a tile-part RGN shift,
# both under a main-header POC of two progressions; spliced 9 x 18 times
# into the 84.9 MP band; the SHA-256 of Pillow's decode of the 1024 x 512
# codestream (np.tile of the tile twice)
J2K_STYLED = "sar_u16_styled_1024x512.j2k"
J2K_STYLED_SHA256 = ("531a3115ed580c7fa6a4b397329dbe35"
                     "96785e4a5115b7ce532522dcb508019e")
# the sub-sampled and deep tiles: OpenJPEG 2.5.4's codestreams of a 256^2
# tile each, written by tests/test_torch_jpeg2000_subsampling.py from these
# seeds: a quick-look camera's sYCC 4:2:0 tile (Y at 1 x 1, Cb and Cr at
# 2 x 2; 9/7 at 20:1), read in a JP2 of the sYCC colour space, and a
# 20-bit SAR-like amplitude tile (5/3, lossless), read as I;16; each
# spliced J2K_SUB_TILES^2 times into 4096^2; the SHA-256 of Pillow's
# decode of each tile (the sYCC one in its JP2)
J2K_SYCC, J2K_SYCC_SEED = "sycc_420_97_256.j2k", 16
J2K_DEEP, J2K_DEEP_SEED = "sar_20bit_256.j2k", 17
J2K_SUB_TILES = 16
J2K_SYCC_SHA256 = ("b4e46e95d316fc5d7e28f35666fe511e"
                   "160ae4ff2dbe92526b0fed3f5375b518")
J2K_DEEP_SHA256 = ("d56a5ea7e7a674791780a94e7e2a1aa2"
                   "566362095144c35f9b5e9c87365818c2")
# the HTJ2K band: the u16 tile coded losslessly with HT code-blocks (5/3,
# 64^2 blocks, cleanup passes only) by tests/htj2k_encode.py, which
# tests/test_torch_jpeg2000_ht.py re-runs; spliced like the default band
# into 84.9 MP; the SHA-256 of Pillow's decode of the tile (the seeded DN)
J2K_HT_DIR = ROOT / "tests" / "data" / "jpeg2000_ht"
J2K_HT = "sar_u16_ht_512.j2k"
J2K_HT_SHA256 = ("bda372a60e39af946dd7815d19df93eb"
                 "4b979e709eaf984d8d8c7653abd38598")
# the webp phase: Pillow-written files (tests/data/webp, made by
# tests/test_torch_webp.py from WEBP_SEED on) and the SHA-256 of Pillow's
# decode of each (np.asarray of the image), which the port's must match; an
# 84.9 MP band (under Pillow's 89.5 MP warning) written here as VP8L
WEBP_DIR = ROOT / "tests" / "data" / "webp"
WEBP_SEED = 15
WEBP_BAND_SIDE = 9216
WEBP_FIXTURES = {
    "sar_lossy_rgb.webp": ("1742d8197358e65ee9296cbfafffeb57"
                           "41c4b585a6efeed8a4d9aeb601ee0e15"),
    "rgba_lossy_alph.webp": ("b22e302cb177063e609c4a1d0033d6cf"
                             "9704be3b2ce08ce67c5222a846c15176"),
    "rgba_lossless.webp": ("8a3858983c73a3142f807a84f2495592"
                           "525298b73550fe0935017aa17e825e92"),
    "anim_two_frames.webp": ("deae7540ce10f6c3dc893aac73217345"
                             "188f155937c2066b7e4fa79ef2d60201"),
}
# the avif phase's files: tests/data/avif, written by Pillow 12.1 (aom
# 3.12.1; loop filter off, then the in-loop filters on from
# filter_deblocking.avif, then 4:4:4, 4:2:2, 4:0:0 and alpha from
# ss444_s6.avif) from AVIF_SEED (tests/test_torch_avif.py's fixture_files),
# with the SHA-256 of Pillow's decode of each, which the port's must match;
# and three SAR-like bands of tests/data/avif_band (avif_band_u8 at
# AVIF_BAND_SIDE^2, saved by Pillow at quality AVIF_BAND_QUALITY with
# autotiling: at speed 6 with the loop filter off by
# tests/test_torch_avif.band_file, 0.97 MB; at speed 4 with `enable-cdef 1`
# by filtered_band_file, deblocking, CDEF and Wiener restoration on, 1.63
# MB; as "LA" by la_band_file: 4:0:0 at speed 6 with the loop filter at
# its default, its alpha a rotated no-data footprint with the gray 0 under
# it, which Pillow opens as RGBA; and by tests/test_torch_avif_tools.
# grain_band_file as premultiplied RGBA with the footprint as alpha, speed
# 6, `enable-qm 1` and `denoise-noise-level 25`, so that aom stores a grain
# model of the speckle and codes the denoised band: quantizer matrices,
# film grain and the unpremultiply at a band's size, 0.16 MB; the card's
# machine has no encoder). The files whose names start qm_, fg_, prem_ and
# ibc_ hold the coding tools past Pillow's defaults; those that start hbd_
# (AVIF_DEPTH_PREFIX) hold 10- and 12-bit samples, written by Debian's
# libavif 0.11.1 (aom 3.6.0, rav1e 0.5.1, SVT-AV1 1.4.1) through
# tests/avif_encode.py from AVIF_SEED (tests/test_torch_avif_depth.py's
# depth_files), as is AVIF_DEPTH_BAND: make_safe's DN at AVIF_BAND_SIDE^2
# clipped to 12 bits, 12-bit 4:0:0 at quantizer AVIF_DEPTH_BAND_QUANTIZER
# with the footprint as a lossless 12-bit alpha item (depth_band_file,
# 0.91 MB, 20 s of aom here). The grid_ and seq_ files
# (AVIF_CONTAINER_PREFIXES) hold grid items and `avis` image sequences,
# written by libavif 0.11.1 through tests/avif_encode.py and by Pillow
# (tests/test_torch_avif_container.py's container_files), as is
# AVIF_GRID_BAND: avif_band_u8 at AVIF_BAND_SIDE^2 with the footprint as
# alpha, stored as a 3 x 3 grid of 3072^2 8-bit 4:2:0 tiles at quantizer
# AVIF_GRID_BAND_QUANTIZER beside a 3 x 3 lossless alpha grid
# (grid_band_file, 1.58 MB, 25 s of aom here). The scale_ and sweep_8_ files
# (AVIF_SCALE_PREFIXES) hold frames libavif scales to their `ispe` and 8-bit
# sweeps of its own conversion, written by libavif 0.11.1 through
# tests/avif_encode.py and edited (tests/test_torch_avif_scale.py's
# scale_files), as is AVIF_SCALE_BAND: avif_band_u8 at
# AVIF_SCALE_BAND_SIDE^2 as RGBA with the footprint as alpha, saved by
# Pillow at quality AVIF_BAND_QUALITY, both items' `ispe` then set to
# AVIF_BAND_SIDE^2 and the `colr` matrix to SMPTE 240M (7) in limited
# range (scale_band_file, 0.09 MB, 6 s of aom here). The sr_ files
# (AVIF_SUPERRES_PREFIX) hold frames coded with AV1 superres, written by
# libaom 3.6.0 through tests/avif_encode.encode_av1 and spliced into libavif
# 0.11.1's container (tests/test_torch_avif_superres.py's superres_files),
# as is AVIF_SUPERRES_BAND: avif_band_u8 at AVIF_BAND_SIDE^2 as 8-bit 4:2:0
# with the footprint as alpha, both coded at superres denominator
# AVIF_SUPERRES_BAND_DENOMINATOR (4608 columns, upscaled to 9216) with CDEF
# and loop restoration on, speed 4, at quantizer
# AVIF_SUPERRES_BAND_QUANTIZER (superres_band_file, 0.65 MB, 35 s of aom
# here).
AVIF_DIR = ROOT / "tests" / "data" / "avif"
AVIF_BAND = ROOT / "tests" / "data" / "avif_band" / "sar_band_9216.avif"
AVIF_FILTERED_BAND = AVIF_BAND.with_name("sar_band_9216_filtered.avif")
AVIF_LA_BAND = AVIF_BAND.with_name("sar_band_9216_la.avif")
AVIF_GRAIN_BAND = AVIF_BAND.with_name("sar_band_9216_grain.avif")
AVIF_DEPTH_BAND = AVIF_BAND.with_name("sar_band_9216_12bit.avif")
AVIF_GRID_BAND = AVIF_BAND.with_name("sar_band_9216_grid.avif")
AVIF_SCALE_BAND = AVIF_BAND.with_name("sar_band_9216_scaled.avif")
AVIF_SUPERRES_BAND = AVIF_BAND.with_name("sar_band_9216_superres.avif")
AVIF_SEED = 21
AVIF_BAND_SIDE = 9216
AVIF_BAND_QUALITY = 10
AVIF_DEPTH_BAND_QUANTIZER = 47
AVIF_DEPTH_PREFIX = "hbd_"
AVIF_GRID_BAND_QUANTIZER = 54
# the grid items and image sequences (tests/test_torch_avif_container.py)
AVIF_CONTAINER_PREFIXES = ("grid_", "seq_")
# frames libavif scales to their `ispe`, and 8-bit sweeps through its own
# conversion (tests/test_torch_avif_scale.py)
AVIF_SCALE_PREFIXES = ("scale_", "sweep_8_")
# frames coded with AV1 superres (tests/test_torch_avif_superres.py)
AVIF_SUPERRES_PREFIX = "sr_"
AVIF_SUPERRES_BAND_QUANTIZER = 44
AVIF_SUPERRES_BAND_DENOMINATOR = 16
AVIF_SCALE_BAND_SIDE = 6144
AVIF_FIXTURES = {
    "s6_q10.avif": ("966c408207f06c5bfa8f8a653e78ab3c"
                    "0a675de42b0a9ceba9800899fec375ab"),
    "s6_q50.avif": ("27fdbe9119e6727871051556615746fb"
                    "cdc520bf9da01b6aa89065d105cb91bd"),
    "s6_q90.avif": ("9d1a136ebc59b2dafda51edf407a0783"
                    "04c0be15ca63d735056454ef19afe7f7"),
    "s6_q100.avif": ("19749f3b268ac4a930117703fbb14854"
                     "a6bec0c76ac7640107de193b62a84010"),
    "s8_q10.avif": ("982f85c54f9b8bb186b8a81afda27858"
                    "dcef934c23e77aa2577a724167577eae"),
    "s8_q50.avif": ("b406c24b19a3e01e6a3fb6d4a3ead8d0"
                    "8eb65dd51f459028e4d8fcd2285e7f3c"),
    "s8_q90.avif": ("bb9e75af462ae23b91590f90823b8f09"
                    "b383221f63a3ea6237ab526095cebe5f"),
    "s8_q100.avif": ("19749f3b268ac4a930117703fbb14854"
                     "a6bec0c76ac7640107de193b62a84010"),
    "s10_q10.avif": ("4ce37ed5ddda9c519f12547556c8f6c5"
                     "2df14f7487030bef6e647be58bcc7fa6"),
    "s10_q50.avif": ("a0ac1ea6c5dadd0f5b17437ba5c67891"
                     "c65351d9d3946e60d0163e92eaa2f57a"),
    "s10_q90.avif": ("6a3520e7b89d05b8885b72862e54fabc"
                     "820107de9f41f8d4292e25c547ca9bbd"),
    "s10_q100.avif": ("19749f3b268ac4a930117703fbb14854"
                      "a6bec0c76ac7640107de193b62a84010"),
    "size_1x1.avif": ("db15c5c5f52a9d72b0c9bd4e4e90744c"
                      "2830d4254479204ea7386f35d8fd4fa0"),
    "size_7x5.avif": ("1d2d8ca347ccdc7d898b38bd64cf8a76"
                      "411107f97eff96b0deed277e397e7a86"),
    "size_257x129.avif": ("df87f52156569782d5b118d3e4464fe0"
                          "5f1735d4e5e2e97d1221adaae96d6863"),
    "tiles_2x2.avif": ("1826c7cf3c5f57bb292f08d09c6f48d3"
                       "45fe8951da2a88703afb1b397bf8bedc"),
    "off_tx64.avif": ("786224f672fb6275e3d2dcda5c4f7c02"
                      "eba797ceaf208f1efae85ce0c3be65b6"),
    "off_dct_only.avif": ("462399c56bb79f96aa47054aab9c5212"
                          "a466030f2643ac4ba3fca8fb8459b9b3"),
    "off_smooth.avif": ("68e4537908c541d00b7dc925ba441205"
                        "8767ead786c781497556d5292770f462"),
    "off_paeth.avif": ("65cc97ed08334f96c1940072a0dc999e"
                       "3e1eb853d1247c63f3b494314bd27836"),
    "off_cfl.avif": ("bd29ad6ae823836c8d1a7ac416d1d752"
                     "535108791669cad7954f31f4793e9f85"),
    "off_filter_intra.avif": ("3fd4e933359bd81b01b2d0ec188af30e"
                              "94569cbd0932e03953e7634160780bd3"),
    "off_edge_filter.avif": ("cd1cededb3aabbed2dd597a4f5618b8e"
                             "0fd7092f1162c6f4c14555ed7b0c0246"),
    "off_directional.avif": ("94f7058041145bd1689d2363cc63414e"
                             "b88a223ed69ee2bbed640d31b3eef3e1"),
    "off_angle_delta.avif": ("eb5cc3eae5a8c6dc0af80a6c358f4500"
                             "f0831626e9ca69bc45b4a65989151256"),
    "off_reduced_tx_set.avif": ("5eac39e47fff85eec81e8ac1c0b5804b"
                                "4b1f7c5287198592147ca7c47175c29d"),
    "minimal.avif": ("e41bc9f0f11a3bcf0382d6dcadaa8626"
                     "e6c27ec600192dfc24608913907e2f20"),
    "metadata.avif": ("27fdbe9119e6727871051556615746fb"
                      "cdc520bf9da01b6aa89065d105cb91bd"),
    "limited_range.avif": ("ff73cb35f1f1e347e95821c24862c3dd"
                           "9e933c532dfd40ce0cd1ac0c5299150c"),
    "filter_deblocking.avif": ("5380f7cc25ccda6ee0272fd9ccd196e0"
                               "7956a5855703b1d397737808f49fcbbc"),
    "filter_cdef.avif": ("f35c2a660aec661b17a35b05fa981238"
                         "161b738deeb62cbbf8f3c3faaeca1e0a"),
    "filter_restoration.avif": ("1851c865bf8ebbcb94e1367656c3a7a5"
                                "7279d339327a93e65d7041e4449489ff"),
    "lf_s6_q10.avif": ("d6472b64e5706c05bb409e31fab476a8"
                       "b7c98259aef00b92e617637a3337e1b7"),
    "lf_s6_q50.avif": ("c4dd17597268bf5c25db476058d3347f"
                       "d16f1e815765cc01c47cdbdd3b28a5cc"),
    "lf_s6_q90.avif": ("9d1a136ebc59b2dafda51edf407a0783"
                       "04c0be15ca63d735056454ef19afe7f7"),
    "lf_s8_q10.avif": ("3edfd049ed9c73e57b3cc1c06d77c22f"
                       "83770375ba5710fff47b5cada4e143ed"),
    "lf_s8_q50.avif": ("bcc90c1fbe9f3d1e905a84af0fb7b333"
                       "6027872e6bfd7abfa132bb0b206e044a"),
    "lf_s8_q90.avif": ("bb9e75af462ae23b91590f90823b8f09"
                       "b383221f63a3ea6237ab526095cebe5f"),
    "lf_s10_q10.avif": ("1c0fd75c7c198c2c23d7733baab0590e"
                        "29b76b3ea8efda2d3012681514f89da1"),
    "lf_s10_q50.avif": ("c939d7f1a4ef4f27427e5cb8e7ccc5e0"
                        "ca576e5df6e2c1007e18c4176778d7aa"),
    "lf_s10_q90.avif": ("6a3520e7b89d05b8885b72862e54fabc"
                        "820107de9f41f8d4292e25c547ca9bbd"),
    "lf_s0_switchable.avif": ("976f8690b73be39990dc6e6a9cd36eed"
                              "372538ade9090052e92fa9a34b07c5a1"),
    "lf_s2.avif": ("3da845d6090bc8fbfc89a6d41f11a471"
                   "a1611b3c89e6cddb633a72e4ee433928"),
    "lf_s4.avif": ("976e7de5ce10e61dfa556b6e938a4d37"
                   "587ed28c48f197072d2a57fbb602490b"),
    "lf_cdef_s4.avif": ("9668385254f5dfce932fd5629e44f9f9"
                        "846a930a3fb10bb5c10dfec1f31bf2c0"),
    "lf_cdef_s6.avif": ("8ac8cca7b88464cac7ab6742b6ab2025"
                        "02c5387e9d7a1c5885b77fde909aebe9"),
    "lf_sharpness3.avif": ("106a85894e35f2213c0757381a2dea9e"
                           "f5147fd58194d4af8d7078e5f194a01e"),
    "lf_sharpness7.avif": ("5467f1e2cc97dbc4d90b76b34171ddfd"
                           "4f0dcfb2a6f1111716a6cf1714f413ed"),
    "lf_delta_lf.avif": ("2d61fe652244cf119ccafdfd2fc6a44b"
                         "55138ffc1b469b591b11573d1a81e806"),
    "lf_sb128.avif": ("43905babdf5dd8f66d719e942e4432bc"
                      "cb5785107619655b5a399d6a32668d67"),
    "lf_tiles_2x2.avif": ("7e52a3e6ab2bfa17c06b8ba80740bd5a"
                          "eb2361267e5c953ba43a6bdbfdbb6d42"),
    "lf_size_1x1.avif": ("01b9fd8d4a74f90b9b68eda23da16d1d"
                         "a50416be6af549965948dd3507995cfc"),
    "lf_size_7x5.avif": ("645c423d49110929e7e512f8341b463b"
                         "8b59c9d6b3281e5ce4fd1c297d0d9533"),
    "lf_size_257x129.avif": ("e465b594117fd68dbbf04e75929dfb69"
                             "984ea41f5a4cb5cf1f8cdd5ea1225c15"),
    "ss444_s6.avif": ("d69c7706505aaf62361c4f403d92da4d"
                     "c43497f2c80454ee8299799b43da6982"),
    "ss444_lf_s6.avif": ("54d3cda5755574cdc408b4126985174a"
                        "aedf6e18444c4d6177b90ed9f4d8a3b1"),
    "ss444_s10.avif": ("39a71b7e4ce2714936a283a65e4fc7ff"
                      "86e7c06612da9c5b98bd0f6b2b4559bc"),
    "ss444_lf_s10.avif": ("087d832279dcc7a8e0a03d54155855e3"
                         "ee6e32cf3abf9bb3e33464edce747dcb"),
    "ss444_cdef_s4.avif": ("0356c9c54b8d1be8b9e685d1a829c683"
                          "7acfdd231c44e579dbf43a59b7c318a9"),
    "ss422_s6.avif": ("de3bf76161a766f0e897e6979280e77f"
                     "b22e96ba687619a4fcc0056253c1614a"),
    "ss422_lf_s6.avif": ("875a9044615d567b2f7f9e3fc160c20f"
                        "c7eae221e8a223c220e8a451511cee51"),
    "ss422_s10.avif": ("c00961188d1bd1fd90d76c14674eeb0a"
                      "4455f36064be148bd0f9c6b3e616cf32"),
    "ss422_lf_s10.avif": ("592cfd6367fa24eb77d547b28287deaa"
                         "1f9097c1913e1fbf77905b82d23aacfa"),
    "ss422_cdef_s4.avif": ("e56d63fe7115e3d4f1893abd2983f38d"
                          "bc82e91b8244b620afea0889bffeda26"),
    "ss400_s6.avif": ("390dafa7fd9236a75c53ef6c699789c4"
                     "8e84dedfdc0da94b2101dde599343e90"),
    "ss400_lf_s6.avif": ("19b3441e7a978aed381e62e02382c5ba"
                        "ef10fab030d9304ae4c0246f1571d14a"),
    "ss400_s10.avif": ("72d38bc621967b5ef6dc067d66167523"
                      "c8c07dfe3d9ca596b88be225ce058a10"),
    "ss400_lf_s10.avif": ("0bf7d3caa6e5639a0fb32ebb539b1471"
                         "463e3f3ea20f68ef3ed933e86c1177a2"),
    "ss400_cdef_s4.avif": ("f0169e4d8dcf171696ab019e93b8be43"
                          "e4a17030f9df6496d2d49704d25da0ba"),
    "ss422_s0.avif": ("4d74de38c623bfec8e6887fc7aa54c17"
                     "f332b7008d1bfca83772c765897396ae"),
    "ss422_size_7x5.avif": ("f69ce3504492cfc834d0b92d5208dd1c"
                           "8788d85149211764d2488d94237402de"),
    "ss422_size_257x129.avif": ("a2c59b1fca9920f60848bc8969808bd1"
                               "bfa8dd8e2dfad56bb9b07eca31b52588"),
    "ss444_size_7x5.avif": ("b95c431ac62a84d317eb158a3a99a29b"
                           "75aef90201385a4f700fbd4c954e02cf"),
    "ss444_size_257x129.avif": ("1d742a3e51acb3105325adb810a3d60b"
                               "4dadcb976052401e226ec180dcb35a87"),
    "rgba_420.avif": ("151e550982a0c1eaabcbef7b737d0024"
                     "70e4a1f1a9f0f965a1ff3e2247a238ce"),
    "rgba_444.avif": ("9d0c36b72a6ecaf5410f0ba429f2d708"
                     "400561cbac82067e1dc2dd9f39e7ce13"),
    "rgba_400.avif": ("d11dbafc7ee6ffdb6a7af996e993f827"
                     "8fc6f8a00368bc8f5410a4d16ed80595"),
    "rgba_speckled.avif": ("4a8eed9f3ed627e9e9f27c54613cc453"
                          "116932fe36d9ae8af2c0e155e89438c0"),
    "la.avif": ("33e5bdbc7feb34ab1b417f7c8ddc1b53"
               "81d8b6375712376059384ab2730b972e"),
    "rgba_1x1.avif": ("8059c844c99432f42302621b8418a8a4"
                     "4712bb009a311d4f9b93675b40560973"),
    "was_refused_444.avif": ("4686784e8698f5f20f97f1502aa2424c"
                            "07ba3a26328209c16bb20e886580b9d5"),
    "was_refused_rgba.avif": ("f1e829457be94cd5da05513ea0c8584c"
                             "178aa913c3cc8fc2f5851a736f9bde23"),
    "was_refused_palette.avif": ("f553040ff5ef82860f8c28e6d8284e0f"
                                "ade404fe4495949a71123787ec8a5e1b"),
    "was_refused_qm.avif": ("30e220cfd89a295f7467de46f9e97efe"
                            "1a3d3b265b85bb16dbe38688564fea10"),
    "was_refused_film_grain.avif": ("1435803adf3ff26ff0230a97eba6d45a"
                                    "ffc5ecfbae46d0399727cc25160f2434"),
    "was_refused_prem.avif": ("487e0b21579e35c2d89bfe4264aa3307"
                              "cfebf518b1fe9073ab4195c9318050b0"),
    "was_refused_10bit.avif": ("08659849e81fdbfec892ba484cdb3ac3"
                               "1dfaa8e02dc3d64a5c9f0b8235d77a18"),
    "was_refused_ispe.avif": ("caff6796724f381e7753efee9a1c5c53"
                              "27f3318be9866d6cc248a7ef55753f24"),
    "qm_l0.avif": ("944aaede8b4effdbf4e6e842c22385a3"
                   "3c6515d3318216a0b2fcdbb2c95c1772"),
    "qm_l4.avif": ("5e616ff24f1d62154493c66cc786374f"
                   "9eae47c883161506b175f37e84bd42a4"),
    "qm_l8.avif": ("85ebbddba2c6a104642fead0064a5c0f"
                   "c97779306860e9136c05a782d8ecb17a"),
    "qm_l15.avif": ("c4dd17597268bf5c25db476058d3347f"
                    "d16f1e815765cc01c47cdbdd3b28a5cc"),
    "qm_deltaq.avif": ("ae0603047f9456ca6a79872652820f35"
                       "e596ae1bc379ad6f8344f82e44986deb"),
    "qm_delta_lf.avif": ("3b987a1a1ed85f5a956c1cd3a1a1996a"
                         "15e59300994e8509b74edc73ae556c2b"),
    "qm_444.avif": ("08b087373d73126a49359cb110444b54"
                    "b37bdf8b5bd395b4b545e8518d1385e5"),
    "qm_422.avif": ("c5f09cb94b0d5ca0d35ee86ca45baece"
                    "91aa0a080b4b21bab95df39348770fc5"),
    "qm_400.avif": ("85f401845804b56bc7e35490204cde25"
                    "05c57dc23c9200afe94eba58c66496af"),
    "qm_lossless.avif": ("19749f3b268ac4a930117703fbb14854"
                         "a6bec0c76ac7640107de193b62a84010"),
    "fg_test01.avif": ("6d1c62e0746391c73e238334ea82af76"
                       "335ea856b7eab912610e5584d2f34b77"),
    "fg_test02.avif": ("6627d1eb59bb45c8f80255a182300622"
                       "fae79728b42a28d12f820d853da8e31d"),
    "fg_test03.avif": ("cf1d5d960a2130374764f7082addcfcf"
                       "cc25ac768daa24c10a9679979ab49f62"),
    "fg_test04.avif": ("831fade9ec489a216106788ab370ab54"
                       "221f216823cbe355c19e42eac37ebff3"),
    "fg_test05.avif": ("e89cf511799b8af51676149aac6ddb28"
                       "83c86cfff57adcfae76f64697485cca2"),
    "fg_test06.avif": ("d9002a9345ecbdfe21e9fdfdf9964954"
                       "fa838025447be64f7d1acd6e6f49e333"),
    "fg_test07.avif": ("0f7427af9faa22cfac9645cb0e3fe9d7"
                       "3554d2d32f3e66bbf41f4f3f51c4c126"),
    "fg_test08.avif": ("90e3edf86aca0bf03b3c5c0642d238a9"
                       "0b4bd0ab58d7b3a9436c5669e43cd40f"),
    "fg_test09.avif": ("30cb52f2f08e8b337129fa4bfeeed9ab"
                       "241db37ab8aef90bb6b52f6267f4437d"),
    "fg_test10.avif": ("9498327c710c99e9991c4f07b802425d"
                       "72252f004c00f0ef1bffbe30272e71af"),
    "fg_test11.avif": ("e2f7acf62f528b6196769bcb4b0bfed1"
                       "b79eaefbb1e807e915b3772b69edf85e"),
    "fg_test12.avif": ("37e53682e6627e906ed782233b0ce3eb"
                       "20463aa55b6133604d79d110c888abfc"),
    "fg_test13.avif": ("01246cf2b017cec412dd50b83b73fd47"
                       "6cd97bf8d72e3c43ec3c3e920d640fae"),
    "fg_test14.avif": ("7e6c03dbce758fdb2c942ea937bd3704"
                       "100a9a05fb65c9a29b57338d9ef293d8"),
    "fg_test15.avif": ("42edd71afdca1087b56ec48570af4360"
                       "a13b630ab37bd603845d1579503c5693"),
    "fg_test16.avif": ("89f684d9f32d3750059ec75b35048f42"
                       "9b9f1a641d39f46bf1e419a24f0d912e"),
    "fg_denoise.avif": ("d91db6f2455e17f0e993a434d9b93b97"
                        "a391692879b68da6c55d1e8e100aaf5c"),
    "fg_size_7x5.avif": ("396db30afb02ed9e9ee648881d79019f"
                         "921e60ba3650ec72973d5cb3367e9797"),
    "fg_size_257x129.avif": ("9c06ad1ee1a16aac30829841b1c2fd28"
                             "2d18cba060e8296c4c62a7b534c991b8"),
    "fg_444.avif": ("232449ced7b80f37abac5539ad976c03"
                    "a9ca2205e030bb6d6f698fe303393396"),
    "fg_422.avif": ("ef2c4cbf46f42c0f260943fe818c6571"
                    "6d8a42bc212430229ff1b010b0963b93"),
    "fg_400.avif": ("2ddd0b2370834b501b605b95de148cda"
                    "cd5206c19390f6f9ab72d8fb26d27cbc"),
    "fg_rgba.avif": ("bd659df4dcee75964bc074c158b8203d"
                     "68db6edb8f2e50b87ae441f84a7f10a3"),
    "prem_rgba_420.avif": ("6eff151197c0124501c786bf4ed6988b"
                           "66c4b13f4fb18910288ca367ae49cd90"),
    "prem_la_420.avif": ("1d0901d0552d706b8bd34a3c3350f5e1"
                         "87e7f1547b959fa106386dc77af9d8d3"),
    "prem_rgba_444.avif": ("b881423ff426b0bb7e54913dc33537e9"
                           "826a2fe950f044d4ace167affcec2e8f"),
    "prem_la_444.avif": ("1d0901d0552d706b8bd34a3c3350f5e1"
                         "87e7f1547b959fa106386dc77af9d8d3"),
    "prem_rgba_400.avif": ("a3c2dc380b47f47ad831fc956c970b55"
                           "e8756d36374a53aa18ba37e1f89d145e"),
    "prem_la_400.avif": ("1d0901d0552d706b8bd34a3c3350f5e1"
                         "87e7f1547b959fa106386dc77af9d8d3"),
    "prem_grain_qm.avif": ("0a21388c194613100b5b983b7560b8c6"
                           "3199ddc9a0a2564e53cb21f2895d41d6"),
    "ibc_sar.avif": ("07a8cf7f3898e84ffd1ce6ea224abcb8"
                     "cdc54a323fdf9c6f487d80144b3e13a7"),
    "ibc_s4.avif": ("e71278cb013cd8fee4c879e2d9845534"
                    "4eaa30763d2afb6f73aa978046d7a39e"),
    "ibc_444.avif": ("9a112aafcd6b4a8345493655891c2881"
                     "6f3882fe55d172dfb9db2c0f122921d3"),
    "ibc_422.avif": ("8d6b67ca5074ae07daf6a30d4ebfc592"
                     "b97cea2cd66991dc20d0257d82f1d76e"),
    "ibc_400.avif": ("ba9bffa85aa4013a461fdd3734c1e955"
                     "d844247a7f3344c09829100a197a591a"),
    "ibc_sb128.avif": ("06e8ef0c8d34ec3a2bb0060505b19bd7"
                       "6aeb2b87d536999c63e5fa40086028a1"),
    "ibc_tiles_2x2.avif": ("14c0815527d32d96bc9225126c209b70"
                           "c1004b0d390f808a48d6b575f4f259e1"),
    "ibc_rgba.avif": ("db1ae0782270f5d0a037ab96b671f07c"
                      "8c76395c25d7b3542a764f70140e9054"),
    "hbd_10_420_full.avif": ("689f352d1a8e7216da512b20ca060ef3"
                             "35a3a8b7ce106dcb18ddf05e9026bad5"),
    "hbd_10_420_limited.avif": ("90c22cfcf462a9419510ae01d0c503be"
                                "99443edf815391ee9d2227f8f123baa7"),
    "hbd_10_422_full.avif": ("13f225438f5af403cab5b1ebf6ca7b24"
                             "0c88a45c9943647807ead486f78f908a"),
    "hbd_10_422_limited.avif": ("5ad4326728bee6397ad4c385c9217411"
                                "ccc2e24b1cb6c327c1fc1f8671ffa8e3"),
    "hbd_10_444_full.avif": ("ca7acece393d957c55821b99317aff24"
                             "478141cd0a680fcc621ca36290c93b60"),
    "hbd_10_444_limited.avif": ("4873e711b276490b32c808cf274b1a3c"
                                "52107994942a0e4a82c91e31619b465f"),
    "hbd_10_400_full.avif": ("97a418099a5065d7a4c0507086781dd9"
                             "c382f576b4a0c03bd2bfbe1d6892f15a"),
    "hbd_10_400_limited.avif": ("031796de745420b22e4ebf48a78784ff"
                                "8b7f86866a30437fb37e14a10049e6b4"),
    "hbd_10_lf0.avif": ("27ff6fe1739b1bf7dd3d1f941d0faaba"
                        "0919ed204bed669a2f25749100110096"),
    "hbd_10_cdef_s4.avif": ("72b55df0c40924536ee3c6893a83ae18"
                            "209154c5dcc67a257a3f36f3f4a003fd"),
    "hbd_10_lr_s0.avif": ("72492c24bd739cb8f189ee28329fa30a"
                          "5d2a8e88f84b59def66db66d3bbc7b93"),
    "hbd_10_lr_s2.avif": ("55bf20b5cf79ac3a78850cb8e4f346f3"
                          "492fc86ddee86ba18071558b67cefaed"),
    "hbd_10_screen_420.avif": ("0275542e4a3a5664079ebce1e8c2ff93"
                               "afcfa8a4409414f19a00ef85ab5c2457"),
    "hbd_10_screen_444.avif": ("f2dbd0dfc7273ca434e6791288816d83"
                               "bc72c953c4e13d636f411113e3023f84"),
    "hbd_10_qm.avif": ("ece42343fb78f06dde13fa7c030351e8"
                       "9e69138f64f5f11282a7c7c3337740c6"),
    "hbd_10_grain.avif": ("4a8462df2acc49ed40007fbc250343fc"
                          "16e2a5f92d0bdc383c87ac33d549e717"),
    "hbd_10_fg1.avif": ("83b5998d75410fffd488df86100e1a48"
                        "944a7e6acfaaaff75dfb17b9fd164a1f"),
    "hbd_10_fg15.avif": ("c0ff8067216e3280410237b0ca7f1bce"
                         "8e57d6cf924cbaf8e6d8f614479fc926"),
    "hbd_10_rgba_420.avif": ("a8d30ca0ab043465624f1e3023dfaf44"
                             "b0603b52dda5251fd4ec52b8a11701ec"),
    "hbd_10_rgba_422.avif": ("09d537c1425883a91f2945c4f3a7ff72"
                             "cd2e45919b129ed505b4549cc016b325"),
    "hbd_10_rgba_444.avif": ("307d5705c76086ca36209c551d45b881"
                             "c00c8a311889a49a482021a0402cf0de"),
    "hbd_10_la.avif": ("6ad225a8902452e25b58fbdb9690d210"
                       "9f11645bfaf629b8d67d646ca87250bb"),
    "hbd_10_rgba_speckled.avif": ("74dd26870a994072571ffc4a185edbfc"
                                  "636987d5bb405b8ff1845a6910f945df"),
    "hbd_10_prem_420.avif": ("4a69430e347a469961a0e0451111c241"
                             "f06e29034bfbf35877583b826d3c2365"),
    "hbd_10_prem_la.avif": ("7f81c78657738c89939c51ec751c9820"
                            "d6d4aefd7e028a31adc255c8a78e55a5"),
    "hbd_10_size_7x5.avif": ("6c49233d7b518163f5be5ed8403f6702"
                             "c4609ec11e0443d47bbb28a6f9bf4407"),
    "hbd_10_size_257x129.avif": ("d7883493b2937874870832804c80a8df"
                                 "064312d96a97d8ba57910bff07c46799"),
    "hbd_12_420_full.avif": ("0f39533077463e058c31bc42ab432ae8"
                             "9fd108835cf54a5214fd30456e7947c9"),
    "hbd_12_420_limited.avif": ("6e0bc0c689bb4590a951e53f2fc94a8a"
                                "8a03f619611d9baa4fdfea30e37ae367"),
    "hbd_12_422_full.avif": ("dab7a6a56c6b9568c5284e255a9d3b91"
                             "45b30d97e8078ff86e79fc6f036b9e69"),
    "hbd_12_422_limited.avif": ("21fae0214e770f4e35d32ae0f1f0bc51"
                                "167f895dcd90b8fe419d759e34d1e7b5"),
    "hbd_12_444_full.avif": ("b7ee3abd6109ed0ee12be4aa1497e00b"
                             "33e4b16a1b410f02a261f933c5820b70"),
    "hbd_12_444_limited.avif": ("74b703cbe5a4f2b1ab15c849470e40d1"
                                "566611ac54d31cff2ad3ba9348c01ed2"),
    "hbd_12_400_full.avif": ("1450052adb3526b665462c7196f33ab6"
                             "1e2e1ad457c3f7ea5a2d2e160c21bb76"),
    "hbd_12_400_limited.avif": ("ddafe0a8d37461b1541f4e332a90a4da"
                                "02dc8a15afcbc91adeb903cc804e302e"),
    "hbd_12_lf0.avif": ("ca9e7615de39ff9ab83e1df61252658e"
                        "b2f053d743fa0a08afc5963540317e12"),
    "hbd_12_cdef_s4.avif": ("344c4a27c5cde2e67b0d3c5d1b49d265"
                            "ccd70170ef375f2478052881495e7b0f"),
    "hbd_12_lr_s0.avif": ("d82240dd93ba986c955afb01703c6b30"
                          "ef3d35312410ba0ba100097dbcba1227"),
    "hbd_12_lr_s2.avif": ("a9bb21d968a88baffaff6fa637d59e58"
                          "a09a97f3beafc46e359dad1c4bc22643"),
    "hbd_12_screen_420.avif": ("eafb38cd8699a911d671227cbcd497a6"
                               "b9b86073b1f3920df6d1cb2c0ec23a6b"),
    "hbd_12_screen_444.avif": ("3c2f158c06b02bc07e264b502cda5be4"
                               "cc3bc2a80496692b11f1b5587e1a1f32"),
    "hbd_12_qm.avif": ("5cfb51a175784b4cf56d3cc74633b6e0"
                       "4c126b1435f13db3eadbe5dabd900212"),
    "hbd_12_grain.avif": ("76fd5cfc64a2f0c84247be2476efc3be"
                          "df7ca42a94bdc0379efdcef01fe6e276"),
    "hbd_12_fg1.avif": ("00fda72f45bf5417ec6acde0439507a9"
                        "2b92515d8aef1df28c32b9be1b278a31"),
    "hbd_12_fg15.avif": ("3b90f12c5ba05294e7d69bdaf2e59e64"
                         "47eea3c9d9fb9b88b2126a1807a80b89"),
    "hbd_12_rgba_420.avif": ("f9e255e195d25f23cee75b39697d82be"
                             "479f43c52b334b6631882224939758a1"),
    "hbd_12_rgba_422.avif": ("44c353d8c544f20f1f49e4689f286372"
                             "b7a0651eef303bea1b668438d0145fc1"),
    "hbd_12_rgba_444.avif": ("c3aca2dba76bab17ac1fc93105e190c5"
                             "ad6a69870ea9378071fdde7422212b7d"),
    "hbd_12_la.avif": ("1c436ccc6b6a48e79382eca44c15dd6d"
                       "dc2a4210a8e7b9f1827bd16aaa5c34ee"),
    "hbd_12_rgba_speckled.avif": ("773163569b88ef38e21c3954a944c766"
                                  "658806c80bc0ac9e9582e60f1f80a9aa"),
    "hbd_12_prem_420.avif": ("afb646cebf5cc1ac0d3f957ed3515c9e"
                             "e5f4293203d51b30676ed830ff7f5a3d"),
    "hbd_12_prem_la.avif": ("9f20b893a1a0b56a8916ace6d853af31"
                            "9b53f475b78138ea5cafb2f7f1d105ee"),
    "hbd_12_size_7x5.avif": ("e077c42620148b7abef7e27f4f81153f"
                             "37c42e08723813f132a09cd3db606c28"),
    "hbd_12_size_257x129.avif": ("c5d5c41c5455336d9c4e47aeb15848ad"
                                 "6a96ea7ead82021c808906daa6c9eb5f"),
    "hbd_rav1e_420.avif": ("4f6cf946958894370a9e37ba27f57710"
                           "e46e4c56de5df253a5480e9f6680dceb"),
    "hbd_svt_420.avif": ("de514237092ed2522ae2e89ff2c771ae"
                         "4e6a97c3215d654131f772a3df886ab2"),
    "hbd_sweep_10_420.avif": ("8f88537bb70c1d0bcf98d9176713d661"
                              "8b0aaeecf94da11b0513c5bcdb2e132a"),
    "hbd_sweep_10_420_a.avif": ("e0341a666e411e37f3bedf7aa9345be5"
                                "3378d7f26ae6e4681d61a41cddc3ece6"),
    "hbd_sweep_10_422.avif": ("9d936b93a301db08f484f7e0285d1958"
                              "449f1c76d2aa50a47b0b229e72d8ed34"),
    "hbd_sweep_10_422_a.avif": ("a8b5c476620264e864bf81e24b1c576b"
                                "65d50bd7a514d7cab1d333a666197744"),
    "hbd_sweep_10_444.avif": ("7127d89d7cbbe64d79381e4dadc860f2"
                              "6d384b58b75c893aab581cf8cde6ece6"),
    "hbd_sweep_10_444_a.avif": ("25e98644093ab3b54d673b0f591ea0a1"
                                "9552532663b682041b5a57bc57b3d1ae"),
    "hbd_sweep_10_400.avif": ("b27746206cddd157856a78c79b6a3f01"
                              "cd95822c2cd9fc9132cc5d923038cfce"),
    "hbd_sweep_10_400_a.avif": ("a9c9e9fb1da8bed180070c35faf624e2"
                                "94c4d3a9849b3896c5a9d335f79b5892"),
    "hbd_sweep_10_444_prem.avif": ("f577480c1e7b563b7c220af7ffd8d5ff"
                                   "4363d02e88b605ca86c5f25694429b73"),
    "hbd_sweep_10_400_prem.avif": ("60346749f3e87f263bb79083b0a1d4e9"
                                   "892e548256f4a61600d7aa21f73080ce"),
    "hbd_sweep_12_420.avif": ("8f88537bb70c1d0bcf98d9176713d661"
                              "8b0aaeecf94da11b0513c5bcdb2e132a"),
    "hbd_sweep_12_420_a.avif": ("e036fd8eb6bc00d54bca26234968cafb"
                                "2f4e38421074e98b40a0ce36e056747a"),
    "hbd_sweep_12_422.avif": ("9d936b93a301db08f484f7e0285d1958"
                              "449f1c76d2aa50a47b0b229e72d8ed34"),
    "hbd_sweep_12_422_a.avif": ("8ed6ebf55c78afcdf7a18934ef6d8aa9"
                                "422dd89c21b93ad6b4e8832f1f018eee"),
    "hbd_sweep_12_444.avif": ("7127d89d7cbbe64d79381e4dadc860f2"
                              "6d384b58b75c893aab581cf8cde6ece6"),
    "hbd_sweep_12_444_a.avif": ("f246442302254cbecc82130757767ac6"
                                "3000b3753340473f5269d76cc458abf6"),
    "hbd_sweep_12_400.avif": ("5d3371b6bd79c1b022b86343061db4f4"
                              "4bef8962807c5531ee11b0df01ec9ab9"),
    "hbd_sweep_12_400_a.avif": ("ed236a366abbf75415d5b2b878414951"
                                "b7abac59ca9adc816ef4e8aae0f109c6"),
    "hbd_sweep_12_444_prem.avif": ("878dac41daca51b83a70cf5e49120011"
                                   "763fa139b67f0fcd11d3ebf9832c3ccc"),
    "hbd_sweep_12_400_prem.avif": ("59ff7b0efe6de8f1f68f30d398d8652a"
                                   "2ede59fb854a078dee2c5ce8e1ed13e1"),
    "grid_420.avif": ("3696fe92fb1a1a2921de8ebbabccb9ca"
                      "f215339d27b8284fa36c73add4f0ed8b"),
    "grid_422.avif": ("7a09f7771da11e88429e753f5872b2d9"
                      "32db82a8937e49d7ecc48bc55348ecd5"),
    "grid_444.avif": ("7dcf4f8f65361ea0e741166669a2e932"
                      "69efed2b744e823549c3440e3252112f"),
    "grid_400.avif": ("edd582e219b87329f659d97566a4745b"
                      "7c03cf0db25bee1b532a26dc021f5524"),
    "grid_10_420.avif": ("0af36f4fa41e036caf07a6684ccbf4d8"
                         "936432b65b90e8c053e2e240073bf306"),
    "grid_10_422.avif": ("bb9c594eb5fcd92a19a69e37d8bf5fea"
                         "4ec237bf370fe17f1447697f860eee36"),
    "grid_10_444.avif": ("1a6781d252aad8ab5d8e598a1064dfd4"
                         "4685679792291ee6f50786526bd39fb5"),
    "grid_10_400.avif": ("fd3942846fb745757d3cb9f59fec3130"
                         "75b2bd07842d11a2854a195b587bc584"),
    "grid_12_420.avif": ("dc3fec212156b44951e66a829934f0e7"
                         "eb5a2b4f2e0bdc7eab4ce7db09aeedd4"),
    "grid_12_422.avif": ("079eb3d06e7edb0b28245cbf1542c045"
                         "4c81bd98a4dc33d99e604a4415875a91"),
    "grid_12_444.avif": ("c1307f905fa11e1f03da2f6cde59cc39"
                         "43b02fc424b5fbd6dce3a7bf9e820532"),
    "grid_12_400.avif": ("6b7f5fb1c3260b6848bf4c132a8e85fb"
                         "5a7c90d7a1d31dbd288e378aba883ce3"),
    "grid_rgba.avif": ("a6c9fda347e715906aeb747f985ed462"
                       "9ad3ca6a467f497df76034b6adeda909"),
    "grid_10_rgba_444.avif": ("f26f24e0641affdc6d77b167f5718e9f"
                              "3309272283a1035d5e78e8be692d0169"),
    "grid_12_la.avif": ("d4bc6cc6a6c7075da7b5b6397cfe34ac"
                        "5857d229bfc38288456a7e6d1a6f6317"),
    "grid_prem.avif": ("db122eec36636049bdc7b8e63cd604c1"
                       "56106f455386b359a346859026d28d12"),
    "grid_grain.avif": ("2fe890eb0a973626f034ee2eaca639b8"
                        "e3826bca43a42da50f38aaa57fc3aac3"),
    "grid_limited.avif": ("d2af93be22ac3dfd2423e98b4b9d8148"
                          "968753debe63cc454f7e543a5e9e3ad2"),
    "seq_pillow.avif": ("6af43bbe7afdaae6194057c16f5e2e4b"
                        "a761b85ea3d22bff2a51aca1e062462c"),
    "seq_pillow_rgba.avif": ("4ebbcb8ec8d4749992db559ce18b8e42"
                             "877848a5bdd88cfdf6247f524f5f4b72"),
    "seq_aom.avif": ("3456d75dd83db93c4dcbef4b5e549326"
                     "7fb159c3d9ec83c0e4c123390d68e3d0"),
    "seq_rav1e.avif": ("e940a20a0b17bdc038d0be4e089f0982"
                       "748271a727170bfd85a7a703946059b2"),
    "seq_svt.avif": ("e326becb7b47ad29eedaa7acceef8072"
                     "186a5b4f0073ee3e02912de66f0fc9aa"),
    "seq_rgba.avif": ("65479dd153df485a0d25a7ca5c9b88ff"
                      "fc643a5d60422ebd44f22978f153d99f"),
    "scale_8_420.avif": ("d1768c4677a13b079ce3ba49d15fd609"
                        "b71ef25ef1b2b940947377f29ad2eee8"),
    "scale_8_422.avif": ("dda443f8ebd09986db875f21924d3d4c"
                        "0e2954e91ab6a06d1f3eff3cd862416e"),
    "scale_8_444.avif": ("35ddd8461a9c98635ada6271223d3544"
                        "3d1001ab0fad8bee2b3c188c0dfc62fe"),
    "scale_8_400.avif": ("e52e4120e6fca0ca6eac6385f07f802b"
                        "0a1cba5dd33c0be95031b0a35e2e2e88"),
    "scale_8_rgba.avif": ("20ed042905834250ff8c6b910dcad859"
                         "3f1c5e42cdd5443d0b2531d9e9330531"),
    "scale_8_prem.avif": ("1c40979b535544f509099b715105c291"
                         "1ccc6748805b6e24afb1b3043d97cb9e"),
    "scale_10_420.avif": ("70f40e2c5b675ffe4fe2ef22d02eff24"
                         "c1b97dffc0a04350d356de6a7e977cdb"),
    "scale_10_422.avif": ("0c1fdf9e1b81bee570dd5895b176928d"
                         "17962c5bde8514a5b088ac69ae059e74"),
    "scale_10_rgba.avif": ("7d23cdbf9c8dcf4da36f06b5a9285d22"
                          "4653143bcd97f21ed07d089835db7276"),
    "scale_12_444.avif": ("c6233e6f3d5e4fc1b2faaf48c0e4bae1"
                         "1217dbba5382e018157d8a07e52b2c47"),
    "scale_12_400.avif": ("818cd386a76fa16c5772b93288096dae"
                         "de5ad899f03efdfbbe3c61ca48e652bb"),
    "scale_12_la.avif": ("59ca7d252c9066a5d7381b69cd991d21"
                        "254cb86fea1ae1063d56de6cae14be70"),
    "sweep_8_420.avif": ("8f88537bb70c1d0bcf98d9176713d661"
                        "8b0aaeecf94da11b0513c5bcdb2e132a"),
    "sweep_8_422.avif": ("9d936b93a301db08f484f7e0285d1958"
                        "449f1c76d2aa50a47b0b229e72d8ed34"),
    "sweep_8_444.avif": ("7127d89d7cbbe64d79381e4dadc860f2"
                        "6d384b58b75c893aab581cf8cde6ece6"),
    "sweep_8_400.avif": ("736a383a463494d7c25e95c17e967fc8"
                        "d4d788f88ac2dd91d36e29ca660bdac0"),
    "sweep_8_420_a.avif": ("c3cf0803630315e87723cb78aa9040a3"
                          "358b4225b9b129cd9018bd1eeff7e62c"),
    "sweep_8_444_prem.avif": ("be2a92f1b343db64f12ba32d985a1896"
                             "335f516f9eadf77994f2a22d05694863"),
    "sr_d9.avif": ("b143daf04bbce83c7d4da47a58f3f307"
                  "b949b51a14fdf49c19440f4cda0a9bfa"),
    "sr_d10.avif": ("fc171e368e31227f4baee7ad732b3f96"
                   "b77ac37461e458f80e15393619169b7d"),
    "sr_d11.avif": ("b50815f107bac26fa00d8fce341cdbe3"
                   "b8288f75eb9759f39f7b09347e097d77"),
    "sr_d12.avif": ("d1d4c7f86407b64a6e541c2a62938205"
                   "81487f26645bc8a1cf0144e0d649285e"),
    "sr_d13.avif": ("f6ef4fa1e8e74776c61824c5affb5904"
                   "2fe1accb383cf14fdd818cf0064db720"),
    "sr_d14.avif": ("293b9f2d0500e04959a574a7796260b6"
                   "b3545cb9c16858eebaccdce672b5ce41"),
    "sr_d15.avif": ("b7b11863022afd93ee08c5f205f7e0c8"
                   "48955865a4985699a9c5c21b2af6cd21"),
    "sr_d16.avif": ("5289db46562e037c0823d5ab8d03ac1c"
                   "1f7bd8541f80465b6dbdee3b6e260cfc"),
    "sr_444.avif": ("05b9150bd4742abc4127e72272c58655"
                   "5184e1e62868f410dc548e71f0a5cae1"),
    "sr_422.avif": ("abdd8836c167328685ad56cb30ca1261"
                   "7fe339eaae6270c844baa47fdd02509e"),
    "sr_400.avif": ("6cd2d2be0e22a699b3b1ad753e1f354d"
                   "909275b1c13697c120815de8b699352d"),
    "sr_10_420.avif": ("3403d068cda5f437253791b082c5fa92"
                      "74cdff6e81e8725f1b26c24f07e9059d"),
    "sr_12_420.avif": ("3114428efc73358bc9b6e39aad6e1876"
                      "a3e7a1d125a11318193c5711441742e5"),
    "sr_12_444.avif": ("7aeb2ee9ce943a17b4252dc138976238"
                      "0138ba9cf8af0d7a75a6a0b758a2a21e"),
    "sr_lf_off.avif": ("6fd419970beac270c7f8590bac0e01b9"
                      "2f8cd06b27e2025e2924d497605d0eb0"),
    "sr_deblocking.avif": ("5aef211189c49012a0ce149bed672bc3"
                          "61b7fe6c20f5028b187709580301d238"),
    "sr_cdef.avif": ("7839cd7169e079bfa0b85fe93e33e91d"
                    "3348210c929552ac561587c0e4aaa0d0"),
    "sr_restoration.avif": ("7358e6281d3b39ef679b38b1a687902a"
                           "d3a3299fa69fc01b6135e6a6fff3f5ee"),
    "sr_cdef_wiener.avif": ("ba51c0913391315e39320cac9811f853"
                           "a62549a6e6b550de749015fcb31dd091"),
    "sr_sgr.avif": ("abb336e9677f00ad93e57e0b45ffe160"
                   "ff5e201fbff1970c7116afc6881974ee"),
    "sr_switchable.avif": ("723b159af478e40e4cf2f194a9ab9adb"
                          "d73b943d3a9d1e8198777e968e45f0d4"),
    "sr_unit256.avif": ("a019223fede6d60442c1d44b413be5de"
                       "40377336971c13a6a4be65059fa19aa9"),
    "sr_sb128.avif": ("e3783789c5016240f90ef24fe29b31c5"
                     "0e1bc66850eeac9f5c6a8ac3378b595b"),
    "sr_tiles.avif": ("b949f2b5830d2aea7b1df170c41c2ef8"
                     "8efc086695898d6858fbf51109aeed87"),
    "sr_w17_d9.avif": ("7e41d564bd00bb709592bffe17fa2fe8"
                      "9d1dd65306082d9501aa08520ac1a191"),
    "sr_w24_d16.avif": ("cc1d962cf98aa45c68e7c42f28d9c9b3"
                       "d5f144786016f2787eb379b8199e7ce7"),
    "sr_w31_d12.avif": ("328c6147763ab33eab45a55e03fcd6db"
                       "cee029e49d4b2cc42f9a4dd028217891"),
    "sr_w40_d16.avif": ("9774e525f0ef80bde4914be828f02fe4"
                       "851a21c51265f940c3b12dc8b5dcda82"),
    "sr_w17_422.avif": ("baf09780cb8d4303817a15994b83dbef"
                       "9d0839fd18024238fde7be39eca77a4e"),
    "sr_grain.avif": ("aefb7755315d092f03451c4bd1fbd231"
                     "07fb7ee32b0209160c3b81a6c89aaf48"),
    "sr_grain_clip.avif": ("f338400c05dd9e24fefcbf683edd5873"
                          "51df39056870730a9de4327c40c20d0e"),
    "sr_grain_limited.avif": ("09becad46f61787ab66323aab1226bbc"
                             "e8c633d8395a63336b0b303ea2115f89"),
    "sr_allintra.avif": ("14cfaa6f8888f505962d3cee99f10f66"
                        "f14965b07b52d2261def4f6ad490dd56"),
    "sr_rgba.avif": ("fd495e856af5abf1a5b7b4b674ecaa46"
                    "fcafc5e0559774c16d7f8b7a1741f445"),
    "sr_grid.avif": ("a70d7c7e6e0eeb799e5f89ca5d58e247"
                    "0f1b3ea42c8a5b8b3528a9016e2d2533"),
    "sr_seq.avif": ("5edbc5d365f3903f720f405734b0aab5"
                   "b6bada45d4aa1a4d4bc5cd417bf8e72c"),
    "sr_ispe_160x90.avif": ("fd9f79be929636a87abc0d96a22cf1ce"
                           "060a71c9ee864a1dd3e80ed488f1bb99"),
    "sr_ispe_100x50.avif": ("b6ac4b547d55e1e8701af68210771e0d"
                           "5b64bb9343a8d8c7480030e318481776"),
}
AVIF_BAND_SHA256 = ("0fac26190af3efd4cf09c6ceaed08687"
                    "1078c04bb00ad9c2561349724e90840e")
AVIF_FILTERED_BAND_SHA256 = ("ce00375d6a3750493f0bc388db171aca"
                             "e6ba6871c1b210f90bf00c93cb58bf73")
AVIF_LA_BAND_SHA256 = ("ea4a3137586fde04f28075cba7c1406a"
                       "2fc633ea6cec55c96bb1d2e6131e792f")
AVIF_GRAIN_BAND_SHA256 = ("283ef3c1aa7c99bfc6b33ade0ce59e29"
                          "8ba2c76bce2f82bd8f1c4b0a139b9ad4")
AVIF_DEPTH_BAND_SHA256 = ("beb3fae87c53b15b698aed4b6836c63a"
                          "b4b6cdf082526c4fbc429fbfe45c5607")
AVIF_GRID_BAND_SHA256 = ("d24b93b4b0f95755cd9eaff39fa21d23"
                         "e5e8c8382d24baa7e5c6c61928850d79")
AVIF_SCALE_BAND_SHA256 = ("d4e8f953ca7b5df8d2d3ebe01b113f30"
                          "9eeba175a974e355dc4203ac6f84a436")
AVIF_SUPERRES_BAND_SHA256 = ("40bdf08e257568ae5e1a479c6b168b1b"
                             "cb5bd61260be1243a051f545fc9aae0e")
# the rasters phase's JPEG codings: tests/data/jpeg, written from JPEG_SEED
# on by libjpeg-turbo 3.1.3's own encoder (tests/ljt_encode.py) or Pillow
# (tests/test_torch_jpeg_coding.py): a SAR-like arithmetic-coded strip
# (SOF9, a restart every MCU row) and a lossless one (SOF3, a restart every
# row), each spliced restart interval by restart interval into an 80 MP
# band; an RGB 4:2:0 SOF10 file; a Pillow SOF2 and a SOF10 file cut after
# three scans, so that libjpeg block-smooths them. The SHA-256 of Pillow's
# decode of each, which the port's must match.
JPEG_DIR = ROOT / "tests" / "data" / "jpeg"
JPEG_SEED = 18
JPEG_SOF9_STRIP = "sar_sof9_8000x16.jpg"
JPEG_SOF3_STRIP = "sar_sof3_8000x20.jpg"
JPEG_FIXTURES = {
    "sar_sof9_8000x16.jpg": ("e638f9a881ea08d0f6979ccfb9eab2cc"
                            "7b8468307a59c5c4ee9301f00c1fc042"),
    "sar_sof3_8000x20.jpg": ("79944aa3140ed64abed71a5ca76595fb"
                            "363408b86e6ef03f7d2159d73d61b175"),
    "rgb_sof10_420.jpg": ("f66bd032d42c719894fcce46cc1c06d4"
                         "d55a68a9213518b80b1b48d1144e8928"),
    "sar_sof2_smoothed.jpg": ("4abbd4a1d2d22ab08cb18b76b2ad45b8"
                             "8bbfae1b5599a9800de4bb0fee324b46"),
    "sar_sof10_smoothed.jpg": ("65894daa9413ff668056817a41b5a089"
                              "9a0f24f12e118c2f2cd3f75abaee8253"),
}
# the formats phase: bands of make_safe's lognormal DN from FORMATS_SEED,
# written here without Pillow in the float, scientific and run-length
# formats Pillow reads (tests/test_torch_science_rasters.py and
# tests/test_torch_rle_rasters.py hold each writer to Pillow): 9216^2 (84.9
# MP) for the PFM, FITS, SGI RLE and TGA RLE bands and 10848^2 (117.7 MP:
# GOES-R ABI's 1 km full disk, inside Pillow's decompression-bomb warning
# band) for the McIdas AREA. The small files of tests/data/formats (written
# by those tests from FORMATS_SEED on) and the SHA-256 of Pillow's decode of
# each, which the port's must match.
FORMATS_SEED = 19
FORMATS_SIDE = 9216
MCIDAS_SIDE = 10848
FORMATS_DIR = ROOT / "tests" / "data" / "formats"
FORMATS_FIXTURES = {
    "sar_f32.pfm": ("db0d75025bec87860c7247b53569e639"
                    "454f2d43d68eb44cd0d4e6a9c7753afc"),
    "sar_cmyk.ppm": ("06c238f4237996ff641176f04bd25592"
                     "34b35b97241f341bd12e910d360b2acc"),
    "sar_i16.fits": ("ff3e64fb11c4645e20a674c2603a55d3"
                     "da8e66d0da110e1edf118336dff6c0c3"),
    "sar_f64.fits": ("c35d4c90dceb1c8d581b32a727e157b1"
                     "d9f77eb2c9b0417389232f336edfd3a8"),
    "sar_gzip.fits": ("140a07dd474c09bff02df6101a1b7d5a"
                      "419dd2a59374730eb09a0dcdbbab48b8"),
    "sar_u16.area": ("45a3974feca489b1c309eb20c9ae2ca7"
                     "228c1ac3f9a69a8752dca6e0b00ddcd1"),
    "sar_f32.spi": ("db0d75025bec87860c7247b53569e639"
                    "454f2d43d68eb44cd0d4e6a9c7753afc"),
    "sar_l12.im": ("7e4567ad7f677d2406b8a6bd59597c6b"
                   "fec37853282c67f655c286d2ca23b2b7"),
    "sar_f32.im": ("db0d75025bec87860c7247b53569e639"
                   "454f2d43d68eb44cd0d4e6a9c7753afc"),
    "sar_rgb.im": ("8ea266f15555ce033b7e5fa562fdd1d6"
                   "c3f02041a8d9417257426e2f7aa6116e"),
    "sar_rle_rgb.sgi": ("8ea266f15555ce033b7e5fa562fdd1d6"
                        "c3f02041a8d9417257426e2f7aa6116e"),
    "sar_u16.sgi": ("10042d2761052f09ff430a9a0208147f"
                    "694ebc88832000257feba1852920aa0f"),
    "sar_rle.tga": ("0d86c75d3224e3e39b6b4714b6b11c6a"
                    "bc580abf79d676033f19987a818c027e"),
    "sar_rle_rgba.tga": ("e1120601abe12e0fc6ed9577b71b48e3"
                         "d1ad1a28a7a83508a783dd50be31cd8d"),
    "sar_map16.tga": ("aff92d9fbd8acef910cd4944fbe7abfc"
                      "472cb2b312890641ff27750cebe5de59"),
    "sar_rgb.pcx": ("8ea266f15555ce033b7e5fa562fdd1d6"
                    "c3f02041a8d9417257426e2f7aa6116e"),
    "sar_planes.pcx": ("29ccecd7af183cb1992e5d58735e191e"
                       "8fe1a64156225d4e19c39acd9f5d687e"),
    "sar_two.dcx": ("0d86c75d3224e3e39b6b4714b6b11c6a"
                    "bc580abf79d676033f19987a818c027e"),
    "sar_rle.ras": ("b7eb69bdc458bb809ff7cc6bf5e9d9e8"
                    "ba4d8f6f03193180ee5bff8229bc5810"),
    "sar_rle_rgb.psd": ("8ea266f15555ce033b7e5fa562fdd1d6"
                        "c3f02041a8d9417257426e2f7aa6116e"),
    "sar_lab.psd": ("18dc0c4f4d2096c2d6ea01ebbf2e5344"
                    "f89addd378bc6181ae7484bb2b62162b"),
    "sar_rgba.qoi": ("e1120601abe12e0fc6ed9577b71b48e3"
                     "d1ad1a28a7a83508a783dd50be31cd8d"),
}
# the longtail phase: the small files of tests/data/formats in the formats
# of Pillow's long tail (written by tests/test_torch_legacy_rasters.py's
# longtail_fixture_files from FORMATS_SEED on) and the SHA-256 of Pillow's
# decode of each; and the SHA-256 of Pillow's decode of the phase's 9216^2
# bands (_longtail_bands at LONGTAIL_SIDE), computed on the CPU
LONGTAIL_SIDE = 9216
LONGTAIL_FIXTURES = {
    "sar.dib": ("0d86c75d3224e3e39b6b4714b6b11c6a"
                "bc580abf79d676033f19987a818c027e"),
    "sar_bmp.ico": ("4e25820cec0b0b4cf7881507f80bb611"
                    "80e0fd2fc111548966f2cfc92e68f10c"),
    "sar_png.ico": ("9350c6854674bfdce54f6a171dcd23c2"
                    "eaffeabcc765fc6df2f94784099183aa"),
    "sar.cur": ("8ea266f15555ce033b7e5fa562fdd1d6"
                "c3f02041a8d9417257426e2f7aa6116e"),
    "sar_rle.icns": ("a9ef69096f13fd62c319dec9097287b4"
                     "b4f47b63b21826228638cea7dadea310"),
    "sar_bc4.dds": ("4684cfe9cb8f8f5aff8bc58cd5a4b68d"
                    "b6903cac91adac74a1f112a92298c0cf"),
    "sar_bc7.dds": ("be860a5cb36e37ec828d1f5719f8b166"
                    "768099146fdcff5c280540cf69b9fe91"),
    "sar_bc6h.dds": ("7549573117da489b28083ded0ffc68c2"
                     "1b7ef3473885adf76e6f147e38ff9a6c"),
    "sar_dxt5.dds": ("106a0a6ffc0fe22f8cadb3f791dd0b28"
                     "84cd8feb5e23d5b4ab8d1112b5553cd4"),
    "sar_565.dds": ("5bb0e9907c3e685777aa6b04d8c77d45"
                    "32043a406dc8ce29de03757b6aab8543"),
    "sar_dxt1.ftc": ("c02367ceccb009bd23292e4f2bc272ea"
                     "837112f4518c12ef545aafafb8487e13"),
    "sar_pal.blp": ("83dbf4ab262a0a699de2753968ae928f"
                    "3306323ae7ee40aea4224e9533c254e4"),
    "sar_dxt5.blp": ("9120b77863a7216217b26f8da85de36e"
                     "0c45121b210361251012ccdff04d272e"),
    "sar.xbm": ("cb4cffbdfa85abb012270bdeb4196037"
                "7e61e5da16fec91b6a48768320eb58f0"),
    "sar.xpm": ("10948bcc11dedd0a1cc3efe969e19595"
                "27f3d3b0c8d6c79a2e39a105ebc35246"),
    "sar_rle.msp": ("cb4cffbdfa85abb012270bdeb4196037"
                    "7e61e5da16fec91b6a48768320eb58f0"),
    "sar.pxr": ("8ea266f15555ce033b7e5fa562fdd1d6"
                "c3f02041a8d9417257426e2f7aa6116e"),
    "sar.gbr": ("e1120601abe12e0fc6ed9577b71b48e3"
                "d1ad1a28a7a83508a783dd50be31cd8d"),
    "sar_brun.fli": ("b2bcb3d2a0235f609fdbd29332ab5b2f"
                     "0c88bd7d3268833b0de7b2b91873cb90"),
    "sar.xv": ("eba3887a497d67140a2ef3efc3b0b85f"
               "5501ad3c6ac7a768e709c058132ff323"),
    "sar.imt": ("0d86c75d3224e3e39b6b4714b6b11c6a"
                "bc580abf79d676033f19987a818c027e"),
    "sar_raw.iim": ("0d86c75d3224e3e39b6b4714b6b11c6a"
                    "bc580abf79d676033f19987a818c027e"),
}
LONGTAIL_BANDS = {
    "DDS BC4": ("58c602d9d06e23468f2805b7ca730e83"
                "ad35ce9923582575c95ec265bbb7eeef"),
    "DDS DX10 BC7": ("fa75d1a6dcbc7b074968669a386fe8a8"
                     "24a89b5334f7e385ff0b8302e578cccd"),
    "IMT L": ("d2befdd800797f4373bf2db5bd9cb2dc"
              "788f834f507df8f991cc84145ac55dc5"),
}
# the path whose launch count each kernel reports in the kernels line
REPORTED_PATH = {k: ("warm tamed cubic" if k == "resample_axis0"
                     else "warm clahe auto") for k in KERNELS}


def log(msg: str) -> None:
    print(msg, flush=True)


_SPIN_CYCLES_PER_MS: list = []


SPIN_TRIES = 4


def _syncs_host(fn) -> bool:
    """True when a call of `fn` waits for the card (a `.item()`, a copy to
    the host, `torch.bincount`'s size): no spin can then hold the card
    while its calls are queued."""
    import torch

    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        return True
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    return False


def device_ms(fn, reps: int = 20, strict: bool = False) -> float:
    """Device time of one call of `fn` (ms): one warm call, then one CUDA
    event before `reps` back-to-back calls and one after, over `reps`. A
    spin kernel queued ahead of the first event holds the card until all
    the calls are queued, so the host's cost per call (argument checks,
    allocation, ctypes) does not sit between the kernels. An event recorded
    right after the spin is queried once the calls are queued: if the spin
    had already ended, the host's queueing sat between the kernels, and the
    measurement is taken again with twice the spin: a `strict` call (a
    kernel's own time) up to SPIN_TRIES times, and then it fails; any other
    call twice, and then it is taken to wait for the card while it is
    queued (an allocation that frees cached blocks, say) and is timed by
    the profiler instead, with a line that says so. A function that waits for the card visibly (`_syncs_host`) is
    timed by the profiler at once (`profiled_ms`: its kernels, copies and
    memsets summed)."""
    import torch

    if not _SPIN_CYCLES_PER_MS:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS.append(10_000_000 / start.elapsed_time(end))
    fn()
    torch.cuda.synchronize()
    if _syncs_host(fn):
        return profiled_ms(fn)
    t0 = time.perf_counter()
    fn()  # the host's time to queue one call
    queue_ms = (time.perf_counter() - t0) * 1e3
    spin_ms = 2 * reps * queue_ms + 1
    for _ in range(SPIN_TRIES if strict else 2):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        spun = torch.cuda.Event()
        torch.cuda._sleep(int(_SPIN_CYCLES_PER_MS[0] * spin_ms))
        spun.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ended_early = spun.query()  # the spin ran out before the last call
        end.synchronize()
        if not ended_early:
            return start.elapsed_time(end) / reps
        spin_ms *= 2
    what = (f"device_ms: the spin ended before the {reps} calls were "
            f"queued, {SPIN_TRIES if strict else 2} times (last spin "
            f"{spin_ms / 2:.1f} ms)")
    if strict:
        raise RuntimeError(what)
    log(f"{what}: the calls wait for the card; timed by the profiler")
    return profiled_ms(fn)


# peak rates of the card (NVIDIA's data sheets, SXM parts): device
# memory bytes/s, and f32 operations/s outside the tensor cores
RATES = {"H200": (4.8e12, 67e12), "H100": (3.35e12, 67e12)}


def bound(nbytes: float, ops: float) -> tuple:
    """(least ms, "bytes" or "operations"): each input byte read once and
    each output byte written once at the memory rate, against the
    operations at the f32 rate; the larger bounds."""
    import torch

    name = torch.cuda.get_device_name(0)
    mem, f32 = next((r for k, r in RATES.items() if k in name),
                    RATES["H100"])
    tb, to = nbytes / mem * 1e3, ops / f32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def profiled_ms(fn, reps: int = 5) -> float:
    """Device time of one call of `fn` (ms) from a torch.profiler trace:
    the kernels, copies and memsets of `reps` calls, summed, over `reps`
    (the cross-check of device_ms, blind to the host's time)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    us = sum(e["dur"] for e in events
             if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
             and "dur" in e)
    return us / 1e3 / reps


def time_kernel(results, name: str, what: str, kernel, plain, moved: int,
                ops: float, library=None, main: bool = False) -> None:
    """Device times of a kernel, its plain version and, where one PyTorch
    call computes the same function, that call; printed beside the bound.
    `main` marks the shape the kernels line reports."""
    ms = device_ms(kernel, strict=True)
    pms = device_ms(plain)
    lms = device_ms(library) if library is not None else None
    b, by = bound(moved, ops)
    lib = (f"{lms:.4f} ms (profiler {profiled_ms(library):.4f})"
           if lms is not None else "none")
    log(f"time: {name}, {what}: kernel {ms:.4f} ms (profiler "
        f"{profiled_ms(kernel):.4f}), plain {pms:.4f} ms, bound {b:.4f} ms "
        f"by {by} ({moved / 1e6:.1f} MB, {ops / 1e9:.3f} Gop) = "
        f"{100 * b / ms:.1f} % of it, library {lib}")
    if main:
        results[name].update(ms=ms, plain_ms=pms, bound_ms=b, bound_by=by,
                             library_ms=lms)


def phase_environment():
    if not (ROOT / "sarpro_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: the sarpro_tpu_torch package is not "
                         "beside this script")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi.splitlines()[0]


def _raster_build() -> None:
    from sarpro_tpu_torch import _native

    try:
        _native.raster_decoder()
    except RuntimeError:
        pass  # phase_build raises it again on its own thread


def phase_build():
    """The native codec (g++, by sarpro_tpu_torch._native) and the CUDA
    kernels (one nvcc per source, by ops._cuda), built at the same time."""
    import threading

    sys.path.insert(0, str(ROOT))
    from sarpro_tpu_torch import _native
    from sarpro_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    codec = threading.Thread(target=_native.available)
    codec.start()
    decoders = threading.Thread(target=_raster_build)
    decoders.start()
    _cuda.library()
    log(f"build: kernels {time.perf_counter() - t0:.1f} s")
    codec.join()
    decoders.join()
    if not _native.available():
        raise RuntimeError("the native codec did not build (g++ and "
                           "native/*.cpp)")
    _native.raster_decoder()  # raises with g++'s message if it failed
    log(f"build: native codec, raster decoders and kernels "
        f"{time.perf_counter() - t0:.1f} s")
    if _cuda.BUILD_INFO is not None:
        for line in _cuda.BUILD_INFO[1].splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                log(f"  ptxas: {line.strip()}")


def phase_kernels(results):
    import torch

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)
    for name in KERNELS:
        results[name] = {"max_abs_err": 0.0}

    def record(name, err):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           float(err))

    _kernels_histogram(dev, g, record, results)
    _kernels_synrgb(dev, g, record, results)
    _kernels_resample(dev, g, record, results)
    _kernels_clahe(dev, g, record, results)
    _kernels_chunk(dev, g, results)
    _kernels_warp(dev, g, record, results)


def _sar_u8(dev, g, n, mu):
    """(n,) u8 SAR-like band: lognormal values crowding a few bins near the
    water floor (median e^mu)."""
    import torch

    return torch.exp(torch.randn(n, device=dev, generator=g) * 0.8 + mu).clamp(
        0, 255).to(torch.uint8)


def _db_bins(dev, g, n, kind="sar"):
    """(n,) int32 4096-bin dB indices: crowded (2 % masked) or one bin."""
    import torch

    if kind == "one":
        return torch.full((n,), 1234, dtype=torch.int32, device=dev)
    idx = (torch.randn(n, device=dev, generator=g) * 300 + 2048).clamp(
        0, 4095).to(torch.int32)
    idx[torch.rand(n, device=dev, generator=g) < 0.02] = 4096
    return idx


# edge lengths of the histogram and synRGB kernels: every length 0..67, then
# one of every residue mod 16 past many vectors
EDGE_LENGTHS = tuple(range(68)) + tuple(100_000 + r for r in range(16))
# edge value sets of the histogram kernel: (what, dtype, num_bins, values);
# each is counted at every EDGE_LENGTHS from every base offset past 16 bytes
# (int32: 0..3 elements, u8: 0..15 bytes)
HIST_EDGES = (
    ("int32 negative, masked and past num_bins", "int32", 4096, "wild"),
    ("int32 one bin", "int32", 4096, "one"),
    ("int32 all masked", "int32", 4096, "masked"),
    ("u8, 256 bins", "u8", 256, "uniform"),
    ("u8 past num_bins (100 bins)", "u8", 100, "uniform"),
    ("u8 one bin", "u8", 256, "one"),
)
# two u8 streams of unequal length and alignment: lengths and base offsets
HIST_PAIRS = ((0, 1, 15, 16, 17, 67, 100_003), (0, 5, 33, 100_019),
              (0, 3, 15), (0, 1, 9))
# base offsets (b1, b2) of the synRGB edge views, in bytes past 16
SYNRGB_OFFSETS = ((0, 0), (1, 1), (5, 12), (15, 0), (0, 15), (7, 7))


def _edge_values(dev, g, dtype, num_bins, kind, n):
    import torch

    if kind == "wild":
        v = torch.randint(-300, num_bins + 300, (n,), device=dev, generator=g,
                          dtype=torch.int32)
    elif kind == "uniform":
        v = torch.randint(0, 256, (n,), device=dev, generator=g,
                          dtype=torch.int32)
    else:
        v = torch.full((n,), 77 if kind == "one" else num_bins,
                       dtype=torch.int32, device=dev)
    return v.to(torch.uint8) if dtype == "u8" else v


def _kernels_histogram(dev, g, record, results):
    """histogram at HIST_EDGES and HIST_PAIRS, at MAX_HIST_BINS and one bin,
    then timed at the routes' shapes: the 4096-bin dB stats of a 2048^2
    band, the 256-bin water floor over two 2048^2 u8 bands (uniform and
    SAR-like), and the full-resolution route's 10000^2 band (crowded, one
    bin, a ragged 9999 x 10001)."""
    import torch

    from sarpro_tpu_torch.ops import kernels

    def check(parts, num_bins, what):
        _check_equal(kernels.histogram(parts, num_bins),
                     kernels._histogram_plain(parts, num_bins),
                     f"histogram edge: {what}")

    longest = max(EDGE_LENGTHS) + 16
    for what, dtype, num_bins, kind in HIST_EDGES:
        src = _edge_values(dev, g, dtype, num_bins, kind, longest)
        offsets = range(4) if dtype == "int32" else range(16)
        for off in offsets:
            for n in EDGE_LENGTHS:
                v = src[off:off + n]
                check([v], num_bins, f"{what}, {n} from {v.data_ptr() % 16} "
                      "bytes past 16")
        log(f"histogram edge: {what}: bit-equal at {len(EDGE_LENGTHS)} "
            f"lengths x {len(offsets)} base offsets")
    src = _edge_values(dev, g, "u8", 256, "uniform", 2 * longest)
    lens1, lens2, offs1, offs2 = HIST_PAIRS
    for n1 in lens1:
        for n2 in lens2:
            for o1 in offs1:
                for o2 in offs2:
                    b = longest + o2
                    check([src[o1:o1 + n1], src[b:b + n2]], 256,
                          f"u8 pair {n1} + {o1}, {n2} + {o2}")
    log(f"histogram edge: two u8 streams of unequal length and alignment: "
        f"bit-equal at {math.prod(map(len, HIST_PAIRS))} pairs")
    src = torch.randint(-5, kernels.MAX_HIST_BINS + 5, (100_003,), device=dev,
                        generator=g, dtype=torch.int32)
    for num_bins in (kernels.MAX_HIST_BINS, 1):
        check([src[1:]], num_bins, f"{num_bins} bins")
    log(f"histogram edge: {kernels.MAX_HIST_BINS} bins (one 227 KB table) "
        "and 1 bin: bit-equal")
    record("histogram", 0)

    n = SIZE * SIZE
    idx = _db_bins(dev, g, n)
    got = kernels.histogram(idx, 4096)
    _check_equal(got, kernels._histogram_plain([idx], 4096), "histogram")
    # one PyTorch call of the same function: bincount with the masked bin
    time_kernel(results, "histogram", f"4096 bins over {n} int32",
                lambda: kernels.histogram(idx, 4096),
                lambda: kernels._histogram_plain([idx], 4096),
                nbytes(idx, got), n,
                library=lambda: torch.bincount(idx, minlength=4097),
                main=True)
    pairs = (("uniform", *(torch.randint(0, 256, (n,), device=dev, generator=g,
                                         dtype=torch.int32).to(torch.uint8)
                           for _ in range(2))),
             ("SAR-like", _sar_u8(dev, g, n, 2.8), _sar_u8(dev, g, n, 2.3)))
    for what, u1, u2 in pairs:
        got = kernels.histogram((u1, u2), 256)
        _check_equal(got, kernels._histogram_plain([u1, u2], 256),
                     f"histogram 256 bins, {what} pair")
        time_kernel(results, "histogram", f"256 bins over 2 x {n} u8, {what}",
                    lambda: kernels.histogram((u1, u2), 256),
                    lambda: kernels._histogram_plain([u1, u2], 256),
                    nbytes(u1, u2, got), 2 * n)
    log(f"histogram over {n} int32 and 2 x {n} u8 (uniform, SAR-like): "
        "bit-equal")
    zeros_ms = device_ms(lambda: torch.zeros(4096, dtype=torch.int32,
                                             device=dev))
    log("time: yardstick, the wrapper's torch.zeros of the 4096 counts alone "
        f"(part of every histogram time): {zeros_ms:.4f} ms")
    del idx, pairs, u1, u2
    for rows, cols, kind in ((EW_SIDE, EW_SIDE, "sar"),
                             (EW_SIDE, EW_SIDE, "one"),
                             (EW_SIDE - 1, EW_SIDE + 1, "sar"),
                             (EW_SIDE - 1, EW_SIDE + 1, "one")):
        n = rows * cols
        idx = _db_bins(dev, g, n, kind)
        got = kernels.histogram(idx, 4096)
        what = f"{rows} x {cols}" + (", one bin" if kind == "one" else "")
        _check_equal(got, kernels._histogram_plain([idx], 4096),
                     f"histogram {what}")
        log(f"histogram 4096 bins over {what} int32: bit-equal")
        time_kernel(results, "histogram", f"4096 bins over {what} int32",
                    lambda: kernels.histogram(idx, 4096),
                    lambda: kernels._histogram_plain([idx], 4096),
                    nbytes(idx, got), n,
                    library=lambda: torch.bincount(idx, minlength=4097))
        del idx
        torch.cuda.empty_cache()


def _kernels_synrgb(dev, g, record, results):
    """synrgb_lookup on every (b1, b2) pair for every floor 3..40 with and
    without the water mask, at EDGE_LENGTHS from SYNRGB_OFFSETS with each
    table set, then timed at 2048^2 on a uniform and a SAR-like pair."""
    import torch

    from sarpro_tpu_torch.core import fused, synthetic_rgb
    from sarpro_tpu_torch.ops import kernels

    sup = synthetic_rgb.suppressed_table_sets(dev)
    dflt = synthetic_rgb.default_table_set(dev)
    a = torch.arange(256, device=dev, dtype=torch.int32)
    p1 = a.repeat_interleave(256).to(torch.uint8)
    p2 = a.repeat(256).to(torch.uint8)
    for f in range(synthetic_rgb.FLOOR_MIN, synthetic_rgb.FLOOR_MAX + 1):
        fl = torch.tensor(f, dtype=torch.int32, device=dev)
        si = fl - synthetic_rgb.FLOOR_MIN
        for water in (None, fl):
            _check_equal(kernels.synrgb_lookup(p1, p2, sup, si, water),
                         kernels._synrgb_lookup_plain(p1, p2, sup, si, water),
                         f"synrgb_lookup floor {f}, water {water is not None}")
    for f in (-1, 255, 300):  # floors outside the ones the stages make
        fl = torch.tensor(f, dtype=torch.int32, device=dev)
        _check_equal(kernels.synrgb_lookup(p1, p2, sup, fl, fl),
                     kernels._synrgb_lookup_plain(p1, p2, sup, fl, fl),
                     f"synrgb_lookup floor {f}")
    log("synrgb_lookup 65536 pairs x 38 floors x water on/off, and water "
        "floors -1, 255, 300: bit-equal")
    fl = torch.tensor(20, dtype=torch.int32, device=dev)
    si = fl - synthetic_rgb.FLOOR_MIN
    sets = (("suppressed set + water mask", sup, si, fl),
            ("suppressed set", sup, si, None),
            ("default set", dflt, None, None))
    longest = max(EDGE_LENGTHS) + 32
    # values 0..63: a ninth of the pixels at or below the floor on both bands
    src = torch.randint(0, 64, (2, longest), device=dev, generator=g,
                        dtype=torch.int32).to(torch.uint8)
    for n in EDGE_LENGTHS:
        for o1, o2 in SYNRGB_OFFSETS:
            x1, x2 = src[0, o1:o1 + n], src[1, o2:o2 + n]
            for what, tb, s_, w_ in sets:
                _check_equal(kernels.synrgb_lookup(x1, x2, tb, s_, w_),
                             kernels._synrgb_lookup_plain(x1, x2, tb, s_, w_),
                             f"synrgb_lookup edge: {what}, {n} px from "
                             f"{x1.data_ptr() % 16}, {x2.data_ptr() % 16}")
    log(f"synrgb_lookup edges: {len(EDGE_LENGTHS)} lengths x "
        f"{len(SYNRGB_OFFSETS)} base offsets x (suppressed set with and "
        "without the water mask, default set): bit-equal")
    n = SIZE * SIZE
    u = [torch.randint(0, 256, (n,), device=dev, generator=g,
                       dtype=torch.int32).to(torch.uint8) for _ in range(2)]
    s = [_sar_u8(dev, g, n, 2.8), _sar_u8(dev, g, n, 2.3)]
    # the SAR-like pair's own water floor, as the combine stage finds it
    fs = fused._suppressed_floor(kernels.histogram(s, 256), 2 * n)
    fu = torch.tensor(7, dtype=torch.int32, device=dev)
    for what, (b1, b2), tb, s_, w_, main in (
            ("uniform pair, suppressed set + water mask", u, sup,
             fu - synthetic_rgb.FLOOR_MIN, fu, True),
            ("uniform pair, default set", u, dflt, None, None, False),
            (f"SAR-like pair, suppressed set + water mask (floor "
             f"{int(fs)})", s, sup, fs - synthetic_rgb.FLOOR_MIN, fs, False),
            ("SAR-like pair, default set", s, dflt, None, None, False)):
        got = kernels.synrgb_lookup(b1, b2, tb, s_, w_)
        _check_equal(got, kernels._synrgb_lookup_plain(b1, b2, tb, s_, w_),
                     f"synrgb_lookup {n} px, {what}")
        # the bytes: both bands, the one table set used, the rgb
        time_kernel(results, "synrgb_lookup", f"{n} px, {what}",
                    lambda: kernels.synrgb_lookup(b1, b2, tb, s_, w_),
                    lambda: kernels._synrgb_lookup_plain(b1, b2, tb, s_, w_),
                    nbytes(b1, b2, tb[0], got), 3 * n, main=main)
    log(f"synrgb_lookup over {n} px (uniform and SAR-like pairs, both sets): "
        "bit-equal")
    dst = torch.empty_like(got)
    log(f"time: yardstick, a device copy of the {nbytes(got) / 1e6:.1f} MB "
        f"rgb (read and written): {device_ms(lambda: dst.copy_(got)):.4f} ms")
    record("synrgb_lookup", 0)


def _check_equal(got, want, what):
    """Bit-equality of a kernel with its plain version (NaN never occurs in
    these outputs)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    if not torch.equal(got, want):
        d = (got.double() - want.double()).abs()
        raise AssertionError(f"{what}: kernel differs from plain, max|err| "
                             f"{d.max().item():.3g} on "
                             f"{(d > 0).sum().item()} elements")


def _check_close(got, want, what) -> float:
    """The resample kernel against its plain version within RESAMPLE_TOL;
    returns the max abs error (0: bit-equal)."""
    import torch

    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    torch.testing.assert_close(got, want, **RESAMPLE_TOL)
    return (got - want).abs().max().item()


# edge shapes of the resample kernel: (what, dtype, in_rows, cols, out_rows,
# filter); the slice's own shapes follow in _kernels_resample
RESAMPLE_EDGES = (
    ("1001 columns (not a multiple of 8, rows not 16-byte aligned), 300 "
     "rows (not a multiple of 32)", "u16", 1000, 1001, 300, "cubic"),
    ("1000 columns (a ragged last 32-column strip), lanczos", "u16", 1000,
     1000, 300, "lanczos"),
    ("in_rows 5 < 11 taps", "u16", 5, 64, 2, "cubic"),
    ("upsample 300 -> 1024 rows", "u16", 300, 256, 1024, "cubic"),
    ("f32, 333 columns", "f32", 999, 333, 128, "cubic"),
    ("f32, 16-byte rows, bilinear", "f32", 4096, 512, 1000, "bilinear"),
    ("u16 at an address 2 bytes past 16-byte alignment", "u16+2", 2000, 512,
     200, "average"),
    ("20000 -> 16 rows, 5001 taps: taps from device memory", "u16", 20000,
     64, 16, "cubic"),
)


def _kernels_resample(dev, g, record, results):
    """resample_axis0 at the edge shapes, then the slice's: the u16 20000^2
    row pass for each filter and the f32 transposed column pass."""
    import torch

    from sarpro_tpu_torch.core import resize
    from sarpro_tpu_torch.core.numerics import as_u16
    from sarpro_tpu_torch.ops import resample_kernel

    def source(dtype, rows, cols):
        if dtype == "f32":
            return torch.randn((rows, cols), device=dev, generator=g) * 100
        v = torch.randint(0, 65536, (rows * cols + 1,), device=dev,
                          generator=g, dtype=torch.int32)
        flat = as_u16(v)
        return (flat[1:] if dtype == "u16+2" else flat[:-1]).view(rows, cols)

    for what, dtype, rows, cols, out_rows, filt in RESAMPLE_EDGES:
        x = source(dtype, rows, cols)
        s, w = resize.device_coeffs(rows, out_rows, filt, dev)
        err = _check_close(resample_kernel.band_resample_axis0(
            x, rows, out_rows, filt), resize._resample_axis0(x, s, w),
            f"resample edge: {what}")
        log(f"resample edge: {what} ({w.shape[1]} taps): max|err| {err:.3g}")
        record("resample_axis0", err)

    x16 = source("u16", SIDE, SIDE)
    for filt in ("cubic", "average", "lanczos"):
        got = resample_kernel.band_resample_axis0(x16, SIDE, SIZE, filt)
        s, w = resize.device_coeffs(SIDE, SIZE, filt, dev)
        err = _check_close(got, resize._resample_axis0(x16, s, w),
                           f"resample {filt}")
        log(f"resample u16 {SIDE}^2 -> {SIZE} rows, {filt} ({w.shape[1]} "
            f"taps): max|err| {err:.3g}")
        record("resample_axis0", err)
        # u16 has no matmul: no one PyTorch call computes this function
        time_kernel(results, "resample_axis0",
                    f"u16 {SIDE}^2 -> {SIZE} rows, {filt}, {w.shape[1]} taps",
                    lambda: resample_kernel.band_resample_axis0(
                        x16, SIDE, SIZE, filt),
                    lambda: resize._resample_axis0(x16, s, w),
                    nbytes(x16, got, s, w), 2.0 * got.numel() * w.shape[1],
                    main=filt == "cubic")
    del x16
    xt = got.T.contiguous()  # a row pass, transposed: (20000, 2048)
    got = resample_kernel.band_resample_axis0(xt, SIDE, SIZE, "cubic")
    s, w = resize.device_coeffs(SIDE, SIZE, "cubic", dev)
    err = _check_close(got, resize._resample_axis0(xt, s, w),
                       "resample f32 column pass")
    log(f"resample f32 ({SIDE}, {SIZE}) -> {SIZE} rows, cubic: max|err| "
        f"{err:.3g}")
    record("resample_axis0", err)
    # the same function as one call: the dense (2048, 20000) coefficient
    # matrix times the source (clamped taps land on the edge rows)
    dense = torch.zeros((SIZE, SIDE), device=dev)
    taps = (s[:, None].long() + torch.arange(w.shape[1], device=dev)).clamp(
        0, SIDE - 1)
    dense.scatter_add_(1, taps, w)
    time_kernel(results, "resample_axis0",
                f"f32 ({SIDE}, {SIZE}) -> {SIZE} rows, cubic",
                lambda: resample_kernel.band_resample_axis0(
                    xt, SIDE, SIZE, "cubic"),
                lambda: resize._resample_axis0(xt, s, w),
                nbytes(xt, got, s, w), 2.0 * got.numel() * w.shape[1],
                library=lambda: torch.mm(dense, xt))
    del xt, got, dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _clahe_bins(dev, g, n, kind="sar"):
    """(n,) int32 CLAHE bins: SAR-like (crowding the middle of the 256, 2 %
    masked), one bin throughout (a flat or all-water band), all masked, or
    wild (negative and above n_bins among them)."""
    import torch

    if kind == "sar":
        bins = (torch.randn(n, device=dev, generator=g) * 40 + 128).clamp(
            0, 255).to(torch.int32)
        bins[torch.rand(n, device=dev, generator=g) < 0.02] = 256
        return bins
    if kind == "wild":
        return torch.randint(-300, 600, (n,), device=dev, generator=g,
                             dtype=torch.int32)
    return torch.full((n,), 128 if kind == "one" else 256, device=dev,
                      dtype=torch.int32)


# edge shapes of the CLAHE kernels: (what, rows, cols, bins, row_offset);
# with a row_offset the band is a chunk that starts `row_offset` rows into a
# larger one, so its base pointer lies cols * row_offset elements past the
# allocation's (not 16-byte aligned where that is not a multiple of 4)
CLAHE_EDGES = (
    ("cols % 4 == 3", 2048, 2047, "sar", 0),
    ("cols % 4 == 1", 600, 10001, "sar", 0),
    ("cols % 4 == 2", 700, 10002, "sar", 0),
    ("base 12 bytes past 16-byte alignment", 1001, 2047, "sar", 1),
    ("base 8 bytes past 16-byte alignment", 999, 2046, "sar", 1),
    ("rows < 8", 5, 1000, "sar", 0),
    ("cols < 8", 1000, 7, "sar", 0),
    ("3 x 3: tile_h = tile_w = 1, clamps", 3, 3, "sar", 0),
    ("1 x 1", 1, 1, "sar", 0),
    ("strips crossing tile rows (row_offset 37)", 2000, 2000, "sar", 37),
    ("one bin throughout", 2048, 2048, "one", 0),
    ("all masked", 2048, 2048, "masked", 0),
    ("bins negative and above n_bins", 1024, 1023, "wild", 0),
    ("row_offset 3, odd cols", 1200, 1001, "sar", 3),
    ("row_offset half the rows", 1024, 2048, "sar", 1024),
)


def _clahe_edge(dev, g, what, rows, cols, kind, off):
    """Both CLAHE kernels bit-equal to their plain versions on one edge
    shape, tiled as the grayscale program tiles a band of rows + off rows."""
    from sarpro_tpu_torch.core import clahe, fused
    from sarpro_tpu_torch.ops import kernels

    full = _clahe_bins(dev, g, (rows + off) * cols, kind)
    bins = full[off * cols:]
    th, tw = -(-(rows + off) // clahe.TILES_Y), -(-cols // clahe.TILES_X)
    grid = (cols, clahe.TILES_X, clahe.TILES_Y, th, tw)
    hist = kernels._tile_histogram_plain(bins, *grid, off, 256)
    _check_equal(kernels.tile_histogram(bins, *grid, row_offset=off), hist,
                 f"tile_histogram edge: {what}")
    cdfs = fused._clahe_cdfs(hist, rows + off, cols, th, tw)
    _check_equal(kernels.clahe_lookup(bins, cdfs, *grid, row_offset=off),
                 kernels._clahe_lookup_plain(bins, cdfs, *grid, off),
                 f"clahe_lookup edge: {what}")
    log(f"clahe edge: {what} ({rows} x {cols}, {th} x {tw} tiles, base "
        f"{bins.data_ptr() % 16} bytes past 16): both bit-equal")


def _kernels_clahe(dev, g, record, results):
    """tile_histogram and clahe_lookup at the edge shapes, at the slice's
    2048^2 band (SAR-like bins), then at the 100 MP full-resolution route's
    10000^2, a band of one bin there, and a ragged 9999 x 10001."""
    import torch

    from sarpro_tpu_torch.core import clahe, fused
    from sarpro_tpu_torch.ops import kernels

    for edge in CLAHE_EDGES:
        _clahe_edge(dev, g, *edge)
    # 4096 bins on a 2 x 2 grid: the tile histogram's 64 KB table (above
    # the 48 KB default) and the lookup's CDFs read from device memory
    nb, rows, cols = 4096, 1000, 999
    bins = torch.randint(-5, nb + 5, (rows * cols,), device=dev, generator=g,
                         dtype=torch.int32)
    grid = (cols, 2, 2, 500, 500)
    _check_equal(kernels.tile_histogram(bins, *grid, n_bins=nb),
                 kernels._tile_histogram_plain(bins, *grid, 0, nb),
                 "tile_histogram edge: 4096 bins")
    cdfs = torch.rand((4, nb), device=dev, generator=g)
    _check_equal(kernels.clahe_lookup(bins, cdfs, *grid),
                 kernels._clahe_lookup_plain(bins, cdfs, *grid, 0),
                 "clahe_lookup edge: 4096 bins")
    log(f"clahe edge: {nb} bins, 2 x 2 tiles of {rows} x {cols}: both "
        "bit-equal")
    n, tile = SIZE * SIZE, -(-SIZE // clahe.TILES_Y)
    bins = _clahe_bins(dev, g, n)
    grid = (SIZE, 8, 8, tile, tile)
    got = kernels.tile_histogram(bins, *grid)
    want = kernels._tile_histogram_plain(bins, *grid, 0, 256)
    _check_equal(got, want, "tile_histogram")
    # a row chunk placed by row_offset counts into its global tile rows
    half = SIZE // 2 * SIZE
    _check_equal(kernels.tile_histogram(bins[:half], *grid)
                 + kernels.tile_histogram(bins[half:], *grid,
                                          row_offset=SIZE // 2),
                 want, "tile_histogram with row_offset")
    for off in (SIZE // 2, 3):
        _check_equal(
            kernels.tile_histogram(bins[half:], *grid, row_offset=off),
            kernels._tile_histogram_plain(bins[half:], *grid, off, 256),
            f"tile_histogram row_offset={off}")
    log(f"tile_histogram 8x8 tiles x 256 bins over {n}: exact")
    record("tile_histogram", 0)
    time_kernel(results, "tile_histogram", f"8 x 8 x 256 over {n}, 2 % masked",
                lambda: kernels.tile_histogram(bins, *grid),
                lambda: kernels._tile_histogram_plain(bins, *grid, 0, 256),
                nbytes(bins, got), n, main=True)

    cdfs = fused._clahe_cdfs(want, SIZE, SIZE, tile, tile)
    got = kernels.clahe_lookup(bins, cdfs, *grid)
    _check_equal(got, kernels._clahe_lookup_plain(bins, cdfs, *grid, 0),
                 "clahe_lookup")
    _check_equal(kernels.clahe_lookup(bins[half:], cdfs, *grid,
                                      row_offset=SIZE // 2),
                 got[half:], "clahe_lookup with row_offset")
    _check_equal(kernels.clahe_lookup(bins[half:], cdfs, *grid, row_offset=3),
                 kernels._clahe_lookup_plain(bins[half:], cdfs, *grid, 3),
                 "clahe_lookup row_offset=3")
    log(f"clahe_lookup over {n}: bit-equal")
    record("clahe_lookup", 0)
    # a pixel's work: 4 CDF reads, 3 blends of 3 operations, the mask
    time_kernel(results, "clahe_lookup", f"{n} px, (64, 256) f32 CDFs",
                lambda: kernels.clahe_lookup(bins, cdfs, *grid),
                lambda: kernels._clahe_lookup_plain(bins, cdfs, *grid, 0),
                nbytes(bins, cdfs, got), 10 * n, main=True)

    # the full-resolution route's geometry: a 10000^2 band, 1250-row tiles;
    # then one bin throughout, and a ragged shape (rows not 16-byte aligned)
    del bins, got, want
    for rows, cols, kind in ((EW_SIDE, EW_SIDE, "sar"),
                             (EW_SIDE, EW_SIDE, "one"),
                             (EW_SIDE - 1, EW_SIDE + 1, "sar")):
        n = rows * cols
        th, tw = -(-rows // clahe.TILES_Y), -(-cols // clahe.TILES_X)
        bins = _clahe_bins(dev, g, n, kind)
        grid = (cols, 8, 8, th, tw)
        hist = kernels.tile_histogram(bins, *grid)
        _check_equal(hist, kernels._tile_histogram_plain(bins, *grid, 0, 256),
                     f"tile_histogram {rows} x {cols} {kind}")
        cdfs = fused._clahe_cdfs(hist, rows, cols, th, tw)
        got = kernels.clahe_lookup(bins, cdfs, *grid)
        _check_equal(got, kernels._clahe_lookup_plain(bins, cdfs, *grid, 0),
                     f"clahe_lookup {rows} x {cols} {kind}")
        what = f"{rows} x {cols}" + (", one bin" if kind == "one" else "")
        log(f"tile_histogram and clahe_lookup over {what} ({th} x {tw} "
            "tiles): bit-equal")
        time_kernel(results, "tile_histogram", f"8 x 8 x 256 over {what}",
                    lambda: kernels.tile_histogram(bins, *grid),
                    lambda: kernels._tile_histogram_plain(bins, *grid, 0,
                                                          256),
                    nbytes(bins, hist), n)
        if kind == "sar":  # the lookup's work does not depend on the bins
            time_kernel(results, "clahe_lookup", f"{what} px",
                        lambda: kernels.clahe_lookup(bins, cdfs, *grid),
                        lambda: kernels._clahe_lookup_plain(bins, cdfs, *grid,
                                                            0),
                        nbytes(bins, cdfs, got), 10 * n)
        if (rows, kind) == (EW_SIDE, "sar"):
            dst = torch.empty_like(got)
            log(f"time: yardstick, a device copy of the lookup's "
                f"{nbytes(bins, got) / 1e6:.1f} MB (its input read, its output "
                f"written): {device_ms(lambda: dst.copy_(got)):.4f} ms")
            del dst
        del bins, hist, got
        torch.cuda.empty_cache()


def _kernels_chunk(dev, g, results):
    """tile_histogram, clahe_lookup and the 4096-bin histogram at the
    streamed path's chunk shapes on the SIDE^2 scene: a full chunk at its
    row_offset (the second chunk) and the ragged tail, tiled as the whole
    band is."""
    import torch

    from sarpro_tpu_torch.core import clahe, fused, streamed
    from sarpro_tpu_torch.ops import kernels

    plan = streamed._chunk_starts(SIDE, streamed.CHUNK_ROWS)
    th, tw = -(-SIDE // clahe.TILES_Y), -(-SIDE // clahe.TILES_X)
    grid = (SIDE, clahe.TILES_X, clahe.TILES_Y, th, tw)
    for what, (off, rows) in (("chunk", plan[1]), ("tail", plan[-1])):
        n = rows * SIDE
        shape = f"a {rows} x {SIDE} {what} at row_offset {off}"
        bins = _clahe_bins(dev, g, n)
        hist = kernels.tile_histogram(bins, *grid, row_offset=off)
        _check_equal(hist, kernels._tile_histogram_plain(bins, *grid, off, 256),
                     f"tile_histogram, {shape}")
        time_kernel(results, "tile_histogram", f"8 x 8 x 256 over {shape}",
                    lambda: kernels.tile_histogram(bins, *grid, row_offset=off),
                    lambda: kernels._tile_histogram_plain(bins, *grid, off,
                                                          256),
                    nbytes(bins, hist), n)
        cdfs = fused._clahe_cdfs(hist, SIDE, SIDE, th, tw)
        got = kernels.clahe_lookup(bins, cdfs, *grid, row_offset=off)
        _check_equal(got, kernels._clahe_lookup_plain(bins, cdfs, *grid, off),
                     f"clahe_lookup, {shape}")
        time_kernel(results, "clahe_lookup", f"{shape}, (64, 256) f32 CDFs",
                    lambda: kernels.clahe_lookup(bins, cdfs, *grid,
                                                 row_offset=off),
                    lambda: kernels._clahe_lookup_plain(bins, cdfs, *grid,
                                                        off),
                    nbytes(bins, cdfs, got), 10 * n)
        del bins, hist, got
        idx = _db_bins(dev, g, n)
        got = kernels.histogram(idx, 4096)
        _check_equal(got, kernels._histogram_plain([idx], 4096),
                     f"histogram, {shape}")
        time_kernel(results, "histogram", f"4096 bins over {shape} int32",
                    lambda: kernels.histogram(idx, 4096),
                    lambda: kernels._histogram_plain([idx], 4096),
                    nbytes(idx, got), n,
                    library=lambda: torch.bincount(idx, minlength=4097))
        log(f"streamed kernels at {shape}: bit-equal")
        del idx, got
        torch.cuda.empty_cache()


def warp_grid(side_src: int, side_out: int, angle_deg: float = 12.0,
              margin: float = 0.08, nodes: int = 66):
    """A rotated, scaled inverse mapping over `nodes`^2 grid nodes that
    reaches `margin` of the source outside it on every side (numpy f64)."""
    import numpy as np

    t = np.linspace(-0.5, 0.5, nodes)
    u, v = np.meshgrid(t, t)
    a = np.deg2rad(angle_deg)
    span = side_src * (1 + 2 * margin)
    x = (np.cos(a) * u - np.sin(a) * v) * span + side_src / 2 - 0.5
    y = (np.sin(a) * u + np.cos(a) * v) * span + side_src / 2 - 0.5
    return x, y


def _affine_grid(out_rows, out_cols, gh, gw, scale, x_off=0.0, y_off=0.0):
    """Grid nodes evenly over the output that map output pixel p to source
    pixel (p + 0.5) * scale - 0.5 + offset (numpy f64)."""
    import numpy as np

    gx = (np.linspace(0, out_cols - 1, gw) + 0.5) * scale - 0.5 + x_off
    gy = (np.linspace(0, out_rows - 1, gh) + 0.5) * scale - 0.5 + y_off
    return np.meshgrid(gx, gy)


# edge cases of the warp kernel: (what, source side, output (rows, cols),
# grid maker -> (map_x, map_y))
def _warp_edges():
    import numpy as np

    def nan_grid():
        mx, my = warp_grid(600, 512, nodes=18)
        mx[2, 3] = my[9, 9] = np.nan
        mx[5, 5] = np.inf
        return mx, my

    return (
        ("identity", 400, (300, 400),
         lambda: _affine_grid(300, 400, 11, 14, 1.0)),
        ("4x shrink (footprints over the shared-memory budget)", 1024,
         (256, 256), lambda: _affine_grid(256, 256, 10, 10, 4.0)),
        ("NaN and inf nodes", 600, (512, 512), nan_grid),
        ("tiles wholly outside the source", 256, (512, 512),
         lambda: _affine_grid(512, 512, 18, 18, 1.0, x_off=-300.0,
                              y_off=-40.0)),
        ("1 x 1 output", 64, (1, 1),
         lambda: (np.array([[10.3, 11.0], [10.5, 11.2]]),
                  np.array([[20.7, 20.9], [21.4, 21.6]]))),
        ("33 x 97 output, 66^2 grid", 500, (33, 97),
         lambda: warp_grid(500, 97)),
    )


def _tile_shares(src, gx, gy, rows, cols, method) -> str:
    from sarpro_tpu_torch.ops import warp_kernel

    kinds = warp_kernel.tile_kinds(src, gx, gy, rows, cols, method)
    n = kinds.numel()
    return ", ".join(
        f"{name} {(kinds == i).sum().item() / n:.3f}"
        for i, name in enumerate(warp_kernel.TILE_KINDS)) + f" of {n} tiles"


def _kernels_warp(dev, g, record, results):
    """warp_sample at the edge cases, then on a 2380^2 f32 source -> 2048^2,
    rotated grid with an out-of-bounds margin and NaN nodes, for each
    method; with the share of tiles that took each branch."""
    import torch

    from sarpro_tpu_torch.io import warp
    from sarpro_tpu_torch.ops import warp_kernel

    def check(what, src, gx, gy, rows, cols, method):
        args = (src, gx, gy, rows, cols, method)
        got = warp_kernel.warp_sample(*args)
        _check_equal(got, warp_kernel._warp_sample_plain(*args),
                     f"warp_sample {method}, {what}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"warp_sample {method}, {what}: non-finite")
        log(f"warp edge: {method}, {what}: bit-equal; tiles "
            f"{_tile_shares(*args)}")
        return got

    for what, side, (rows, cols), make in _warp_edges():
        src = torch.exp(torch.randn((side, side), device=dev, generator=g)
                        * 1.1 + 5.0)
        gx, gy = warp.plan_grids_to_device(*make(), dev)
        for method in warp_kernel.METHODS:
            check(what, src, gx, gy, rows, cols, method)

    src = torch.exp(torch.randn((MID, MID), device=dev, generator=g) * 1.1
                    + 5.0)
    mx, my = warp_grid(MID, SIZE)
    mx[3, 5] = mx[40, 60] = float("nan")  # out-of-domain grid nodes
    my[10, 10] = float("nan")
    gx, gy = warp.plan_grids_to_device(mx, my, dev)
    # a pixel's work: two grid blends (18), then near 2, bilinear 4 taps
    # and their weights (about 22), cubic 8 Keys weights (72) and 16 taps
    # (64); a division for the two that renormalise
    ops = {"near": 20, "bilinear": 40, "cubic": 155}
    for method in ("near", "bilinear", "cubic"):
        args = (src, gx, gy, SIZE, SIZE, method)
        got = check(f"{MID}^2 -> {SIZE}^2, 66^2 grid, NaN nodes", *args)
        log(f"warp_sample {method}: share 0 (outside) "
            f"{(got == 0).float().mean().item():.3f}")
        # F.grid_sample samples a per-pixel grid with a = -0.75 and no
        # renormalisation: no one PyTorch call computes this function
        time_kernel(results, "warp_sample",
                    f"f32 {MID}^2 -> {SIZE}^2, {method}",
                    lambda: warp_kernel.warp_sample(*args),
                    lambda: warp_kernel._warp_sample_plain(*args),
                    nbytes(src, gx, gy, got), ops[method] * got.numel(),
                    main=method == "cubic")
    # row shards of the same warp: three blocks of ceil(2048 / 3) rows (the
    # last one ragged) and blocks that start and end inside a tile, each
    # bit-equal to its plain version and to its rows of the whole output
    block = -(-SIZE // 3)
    shards = [(k * block, min(block, SIZE - k * block)) for k in range(3)]
    for method in warp_kernel.METHODS:
        args = (src, gx, gy, SIZE, SIZE, method)
        whole = warp_kernel.warp_sample(*args)
        for row0, rows in shards + [(13, 77), (SIZE - 5, 5)]:
            what = f"warp_sample {method}, rows [{row0}, {row0 + rows})"
            got = warp_kernel.warp_sample(*args, row0=row0, rows=rows)
            _check_equal(got, warp_kernel._warp_sample_plain(*args, row0,
                                                             rows), what)
            _check_equal(got, whole[row0:row0 + rows],
                         f"{what} vs the whole output")
        log(f"warp row shards: {method}, {shards} + [(13, 77), "
            f"({SIZE - 5}, 5)]: bit-equal to the plain version and to the "
            "whole output's rows")
    record("warp_sample", 0)


def _zigzag():
    """zigzag k -> (row, col) of the JPEG scan order."""
    order = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda rc: (rc[0] + rc[1],
                                   rc[0] if (rc[0] + rc[1]) % 2 else rc[1]))
    return order


# ---------------------------------------------------------------------------
# Synthetic SAFE products: a copy of tests/fixtures.make_safe's GCP and affine
# products, written through the port's own TIFF writer, so that this script
# needs nothing of the JAX package (tests/test_torch_host_copies.py holds the
# two byte-identical)
# ---------------------------------------------------------------------------
MANIFEST_TEMPLATE = """<?xml version="1.0" encoding="UTF-8"?>
<xfdu:XFDU xmlns:xfdu="urn:ccsds:schema:xfdu:1">
  <metadataSection>
    <metadataObject ID="platform">
      <metadataWrap><xmlData>
        <safe:platform xmlns:safe="http://www.esa.int/safe/sentinel-1.0">
          <safe:familyName>SENTINEL-1</safe:familyName>
          <safe:number>A</safe:number>
          <safe:instrument>
            <safe:familyName abbreviation="SAR">Synthetic Aperture Radar</safe:familyName>
            <safe:extension>
              <s1sarl1:instrumentMode xmlns:s1sarl1="http://www.esa.int/safe/sentinel-1.0/sentinel-1/sar/level-1">
                <s1sarl1:mode>IW</s1sarl1:mode>
              </s1sarl1:instrumentMode>
            </safe:extension>
          </safe:instrument>
        </safe:platform>
      </xmlData></metadataWrap>
    </metadataObject>
    <metadataObject ID="acquisitionPeriod">
      <metadataWrap><xmlData>
        <safe:acquisitionPeriod xmlns:safe="http://www.esa.int/safe/sentinel-1.0">
          <safe:startTime>2025-07-06T20:43:46.579983</safe:startTime>
          <safe:stopTime>2025-07-06T20:44:11.578154</safe:stopTime>
        </safe:acquisitionPeriod>
      </xmlData></metadataWrap>
    </metadataObject>
    <metadataObject ID="measurementOrbitReference">
      <metadataWrap><xmlData>
        <safe:orbitReference xmlns:safe="http://www.esa.int/safe/sentinel-1.0">
          <safe:orbitNumber type="start">59968</safe:orbitNumber>
          <safe:extension>
            <s1:orbitProperties xmlns:s1="http://www.esa.int/safe/sentinel-1.0/sentinel-1">
              <s1:pass>{pass_direction}</s1:pass>
            </s1:orbitProperties>
          </safe:extension>
        </safe:orbitReference>
      </xmlData></metadataWrap>
    </metadataObject>
    <metadataObject ID="generalProductInformation">
      <metadataWrap><xmlData>
        <s1sarl1:standAloneProductInformation xmlns:s1sarl1="http://www.esa.int/safe/sentinel-1.0/sentinel-1/sar/level-1">
          <s1sarl1:instrumentConfigurationID>8</s1sarl1:instrumentConfigurationID>
          <s1sarl1:missionDataTakeID>487183</s1sarl1:missionDataTakeID>
          {polarisation_entries}
          <s1sarl1:productClass>S</s1sarl1:productClass>
          <s1sarl1:productType>{product_type}</s1sarl1:productType>
        </s1sarl1:standAloneProductInformation>
      </xmlData></metadataWrap>
    </metadataObject>
    <metadataObject ID="processing">
      <metadataWrap><xmlData>
        <safe:processing xmlns:safe="http://www.esa.int/safe/sentinel-1.0" name="SLC Post Processing">
          <safe:facility country="Germany" name="DLR-Oberpfaffenhofen" organisation="ESA" site="DLR-Oberpfaffenhofen">
            <safe:name>DLR-Oberpfaffenhofen</safe:name>
            <safe:software>
              <safe:name>Sentinel-1 IPF</safe:name>
              <safe:version>003.91</safe:version>
            </safe:software>
          </safe:facility>
        </safe:processing>
      </xmlData></metadataWrap>
    </metadataObject>
  </metadataSection>
</xfdu:XFDU>
"""

ANNOTATION_TEMPLATE = """<?xml version="1.0" encoding="UTF-8"?>
<product>
  <adsHeader>
    <missionId>S1A</missionId>
    <productType>{product_type}</productType>
    <polarisation>{pol}</polarisation>
    <mode>IW</mode>
    <startTime>2025-07-06T20:43:46.579983</startTime>
    <stopTime>2025-07-06T20:44:11.578154</stopTime>
    <absoluteOrbitNumber>59968</absoluteOrbitNumber>
    <missionDataTakeId>487183</missionDataTakeId>
  </adsHeader>
  <generalAnnotation>
    <productInformation>
      <pass>{pass_direction}</pass>
      <rangeSamplingRate>64345238.12571428</rangeSamplingRate>
      <radarFrequency>5405000454.33435</radarFrequency>
    </productInformation>
    <downlinkInformation>
      <prf>1717.128973878037</prf>
      <downlinkValues>
        <txPulseLength>5.240703971123505e-05</txPulseLength>
        <txPulseRampRate>1078230321255.894</txPulseRampRate>
      </downlinkValues>
    </downlinkInformation>
    <orbitList>
      <orbitStateVector>
        <vx>-1000.0</vx><vy>2000.0</vy><vz>7000.0</vz>
      </orbitStateVector>
      <orbitStateVector>
        <vx>-1100.0</vx><vy>2100.0</vy><vz>6900.0</vz>
      </orbitStateVector>
      <orbitStateVector>
        <vx>-1200.0</vx><vy>2200.0</vy><vz>6800.0</vz>
      </orbitStateVector>
    </orbitList>
  </generalAnnotation>
  <imageAnnotation>
    <imageInformation>
      <slantRangeTime>0.005331704801236436</slantRangeTime>
      <rangePixelSpacing>10.0</rangePixelSpacing>
      <azimuthPixelSpacing>10.0</azimuthPixelSpacing>
      <numberOfSamples>{samples}</numberOfSamples>
      <numberOfLines>{lines}</numberOfLines>
      <lines>{lines}</lines>
    </imageInformation>
  </imageAnnotation>{geolocation_block}
</product>
"""


def _write_measurement_tiff(path: Path, data, gcp_lon0=11.0, gcp_lat0=46.0,
                            span_deg=0.25):
    """u16 measurement GeoTIFF with a 5x5 WGS84 GCP lattice (like real S1
    GRD: no affine geotransform, only tiepoints)."""
    import numpy as np

    from sarpro_tpu_torch.io.tiffio import TiffWriter

    rows, cols = data.shape
    w = TiffWriter(path)
    n = 5
    ties = []
    for iy in range(n):
        for ix in range(n):
            px = ix * (cols - 1) / (n - 1)
            py = iy * (rows - 1) / (n - 1)
            lon = gcp_lon0 + span_deg * ix / (n - 1)
            lat = gcp_lat0 - span_deg * iy / (n - 1)
            ties.extend([px, py, 0.0, lon, lat, 0.0])
    w.set_projection("EPSG:4326")  # GCP SRS
    w.set_tiepoints(ties)
    w.write([data.astype(np.uint16)])


def make_safe(root: Path, name: str = "S1A_IW_GRDH_1SDV_20250706T204346.SAFE",
              pols=("vv", "vh"), shape=(96, 128), seed: int = 7,
              with_affine_geotransform: bool = False) -> Path:
    """A synthetic dual-pol GRD SAFE tree (lognormal DN from `seed`, 2 %
    zeros): GCP-georeferenced measurements, or an affine UTM 32N one."""
    import numpy as np

    from sarpro_tpu_torch.io.tiffio import TiffWriter

    rng = np.random.default_rng(seed)
    base = root / name
    (base / "annotation").mkdir(parents=True, exist_ok=True)
    (base / "measurement").mkdir(parents=True, exist_ok=True)
    pol_entries = "\n      ".join(
        f"<s1sarl1:transmitterReceiverPolarisation>{p.upper()}"
        f"</s1sarl1:transmitterReceiverPolarisation>" for p in pols)
    (base / "manifest.safe").write_text(MANIFEST_TEMPLATE.format(
        product_type="GRD", pass_direction="ASCENDING",
        polarisation_entries=pol_entries))
    rows, cols = shape
    for pol in pols:
        (base / "annotation" / f"s1a-iw-grd-{pol}-001.xml").write_text(
            ANNOTATION_TEMPLATE.format(
                product_type="GRD", pol=pol.upper(),
                pass_direction="ASCENDING", samples=cols, lines=rows,
                geolocation_block=""))
        dn = rng.lognormal(5.0 if pol in ("vv", "hh") else 4.2, 1.1, shape)
        dn = np.clip(dn, 0, 65535).astype(np.uint16)
        dn[rng.random(shape) < 0.02] = 0
        tif = base / "measurement" / f"s1a-iw-grd-{pol}-001.tiff"
        if with_affine_geotransform:
            w = TiffWriter(tif)
            w.set_geotransform([500000.0, 10.0, 0.0, 5100000.0, 0.0, -10.0])
            w.set_projection("EPSG:32632")
            w.write([dn])
        else:
            _write_measurement_tiff(tif, dn)
    return base


def _write_safe(work: Path, **kw) -> Path:
    """make_safe in a child process, whose numpy temporaries (~7 GB at
    20000^2) are returned when it exits."""
    args = ", ".join(f"{k}={v!r}" for k, v in kw.items())
    subprocess.run(
        [sys.executable, "-c",
         "import pathlib, sys; sys.path.insert(0, sys.argv[1]); "
         "import chip_smoke; "
         f"chip_smoke.make_safe(pathlib.Path(sys.argv[2]), {args})",
         str(ROOT), str(work)], check=True)
    return next(work.glob("*.SAFE"))


def _cli_wall(label: str, argv: list, out: Path) -> float:
    """Wall time (s, host clock) of one CLI run to `out`, the device's work
    included."""
    import torch

    from sarpro_tpu_torch import cli

    t0 = time.perf_counter()
    if cli.run(argv + ["-o", str(out)], device=DEVICE) != 0:
        raise RuntimeError(f"cli.run failed ({label})")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _drive(label: str, argv: list, out: Path):
    """One CLI run with the launch counts and the decimated-read routes set
    to 0 just before it and read just after; a run listed in PATHS must
    have launched each of its kernels. Returns (wall s, counts, routes)."""
    from sarpro_tpu_torch import ops
    from sarpro_tpu_torch.io import raster

    ops.reset_launch_counts()
    for k in raster.ROUTES:
        raster.ROUTES[k] = 0
    wall = _cli_wall(label, argv, out)
    counts, routes = ops.launch_counts(), dict(raster.ROUTES)
    DRIVEN[label] = (argv, out)
    DRIVE_LOG[label] = (wall, counts)
    log(f"slice: {label} wall {wall * 1e3:.1f} ms")
    if label in PATHS:
        log(f"slice: launches in the {label} run {counts}, decimated-read "
            f"routes {routes}")
        for k in PATHS[label]:
            if counts[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched by the "
                                     f"{label} run")
    return wall, counts, routes


def _check_jpeg(label: str, out: Path) -> bytes:
    blob = out.read_bytes()
    if blob[:2] != b"\xff\xd8" or blob[-2:] != b"\xff\xd9":
        raise AssertionError(f"{label}: output is not a JPEG (SOI/EOI)")
    for ext in (".jgw", ".json", ".prj"):
        if not out.with_suffix(ext).exists():
            raise AssertionError(f"{label}: missing sidecar {ext}")
    return blob


def _check_utm(label: str, out: Path) -> None:
    prj = out.with_suffix(".prj").read_text()
    if "UTM" not in prj:
        raise AssertionError(f"{label}: .prj names no UTM CRS: {prj[:80]}")
    log(f"slice: {label} .prj {prj.split(',')[0]}")


def phase_slice(work: Path):
    t0 = time.perf_counter()
    safe = _write_safe(work, shape=(SIDE, SIDE))
    log(f"slice: wrote {safe.name} ({SIDE}x{SIDE} u16 VV+VH) in "
        f"{time.perf_counter() - t0:.1f} s")
    base = ["-i", str(safe), "-f", "jpeg", "--polarization", "multiband",
            "--size", str(SIZE), "--pad", "--fast"]
    auto = ["--target-crs", "auto", "--resample-alg", "cubic"]
    runs = (("cold clahe auto", "clahe", auto),
            ("warm clahe auto", "clahe", auto),
            ("warm tamed auto", "tamed", auto),
            ("warm tamed cubic", "tamed", ["--resample-alg", "cubic"]),
            ("warm average", "tamed", []))
    walls, counts, blobs = {}, {}, {}
    for label, strategy, extra in runs:
        out = work / f"{label.replace(' ', '_')}.jpg"
        walls[label], counts[label], routes = _drive(
            label, base + ["--autoscale", strategy] + extra, out)
        blobs[label] = _check_jpeg(label, out)
        if "auto" in label:
            _check_utm(label, out)
        if label == "warm clahe auto" and routes["host_reduce"] != 2:
            raise AssertionError(f"{label}: the bands did not take the host "
                                 f"box reduce ({routes})")
    return safe, blobs, counts, walls


def _breakdown(scene, kw):
    """Device time of each stage (CUDA events), then the host's share: the
    coefficient copy back and the entropy coding."""
    import torch

    from sarpro_tpu_torch.core import fused
    from sarpro_tpu_torch.io.writers import jpeg

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    b1 = fused.synrgb_band_stage(scene.band1, copol=True, **kw)
    ev[1].record()
    b2 = fused.synrgb_band_stage(scene.band2, copol=False, **kw)
    ev[2].record()
    dct = fused.synrgb_combine_stage(b1, b2, kw["strategy"], None, "dct")
    ev[3].record()
    ev[3].synchronize()
    t0 = time.perf_counter()
    co = dct.cpu().numpy()
    t1 = time.perf_counter()
    n = SIZE + (-SIZE) % 8
    blob = jpeg._native.jpeg_encode_coeffs444(co[0], co[1], co[2], n, n)
    t2 = time.perf_counter()
    log(f"breakdown ({kw['strategy'].value}): device band1 "
        f"{ev[0].elapsed_time(ev[1]):.3f} ms, band2 "
        f"{ev[1].elapsed_time(ev[2]):.3f} ms, combine+dct "
        f"{ev[2].elapsed_time(ev[3]):.3f} ms; host copy-back "
        f"{(t1 - t0) * 1e3:.2f} ms, entropy coding {(t2 - t1) * 1e3:.2f} ms "
        f"({len(blob)} bytes)")


def _breakdown_warp(safe: Path):
    """The CLAHE auto-UTM path step by step, each step finished before the
    next (the CLI overlaps the chunked uploads with the host reduce): host
    read + box reduce, auto-CRS and plan, upload (host clock), device warp
    (CUDA events); then the band stages, combine, copy-back and entropy
    coding (_breakdown)."""
    import numpy as np
    import torch

    from sarpro_tpu_torch.core import fused
    from sarpro_tpu_torch.io import raster, safe as tsafe, warp
    from sarpro_tpu_torch.ops import warp_sample

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    meta = tsafe.parse_comprehensive_metadata(safe)
    crs = tsafe.geodesy.resolve_auto_target_crs(safe)
    t_plan = time.perf_counter() - t0
    vv, vh, _, _ = tsafe.identify_polarization_files(safe / "measurement",
                                                     meta.polarizations)
    t_reduce, t_up, ms_warp, bands = [], 0.0, 0.0, []
    for path in (vv, vh):
        t0 = time.perf_counter()
        reader = tsafe.RasterReader(path)
        plan = warp.plan_warp(reader, crs, "cubic", SIZE,
                              meta.geolocation_grid)
        mid_rows, mid_cols, mx, my = warp.two_stage_plan(
            plan, reader.metadata.size_x, reader.metadata.size_y)
        (ys, yc), (xs, xc) = raster._box_windows(reader, 1, mid_cols,
                                                 mid_rows, "average")
        t1 = time.perf_counter()
        t_plan += t1 - t0
        tif = reader._tiff
        part = torch.empty((mid_rows, mid_cols), dtype=torch.float32,
                           pin_memory=dev.type == "cuda")
        host = part.numpy()
        for o0 in range(0, mid_rows, 512):
            o1 = min(o0 + 512, mid_rows)
            r0, r1 = int(ys[o0]), int(ys[o1 - 1] + yc[o1 - 1])
            src = np.ascontiguousarray(tif.read_strip_range(r0, r1, 1),
                                       np.uint16)
            raster._native.box_reduce_u16(src, host[o0:o1], o0, o1, ys, yc, xs, xc,
                                   src_row0=r0)
        reader.close()
        t2 = time.perf_counter()
        t_reduce.append(t2 - t1)
        src_dev = part.to(dev)
        gx, gy = warp.plan_grids_to_device(mx, my, dev)
        torch.cuda.synchronize()
        t_up += time.perf_counter() - t2
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        bands.append(warp_sample(src_dev, gx, gy, plan.out_rows,
                                 plan.out_cols, plan.method))
        ev[1].record()
        ev[1].synchronize()
        ms_warp += ev[0].elapsed_time(ev[1])
    log(f"breakdown (warp path, {mid_rows}x{mid_cols} reduced source): host "
        f"read + box reduce {sum(t_reduce) * 1e3:.1f} ms (band1 "
        f"{t_reduce[0] * 1e3:.1f}, band2 {t_reduce[1] * 1e3:.1f}), auto-CRS "
        f"+ plan {t_plan * 1e3:.1f} ms, upload {t_up * 1e3:.2f} ms (host "
        f"clock); device warp {ms_warp:.3f} ms for both bands (CUDA events)")
    scene = tsafe.DualPolScene(meta, bands[0], bands[1], True)
    _breakdown(scene, dict(strategy=fused.AutoscaleStrategy.CLAHE,
                           target_size=SIZE, pad=True, resample_alg=None))


def _resident(label: str, scene, kw, blob: bytes, n_mcus: int = 256):
    """The band and combine stages on resident bands: no host sync with the
    kernels, the plain versions within 1, and the first `n_mcus` MCUs of the
    CLI run's JPEG hold the device's coefficient blocks, which it returns."""
    import torch

    from sarpro_tpu_torch.core import fused
    from sarpro_tpu_torch.ops import force_plain

    def stages():
        b1 = fused.synrgb_band_stage(scene.band1, copol=True, **kw)
        b2 = fused.synrgb_band_stage(scene.band2, copol=False, **kw)
        rgb = fused.synrgb_combine_stage(b1, b2, kw["strategy"], None, "rgb")
        dct = fused.synrgb_combine_stage(b1, b2, kw["strategy"], None, "dct")
        return b1, b2, rgb, dct

    stages()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.set_sync_debug_mode("error")  # any host sync raises
    try:
        start.record()
        k = stages()
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    end.synchronize()
    log(f"resident ({label}): band x2 + combine x2 on the device "
        f"{start.elapsed_time(end):.3f} ms (no host sync)")
    with force_plain():
        p = stages()
    torch.cuda.synchronize()
    for name, a, b in (("band1", k[0], p[0]), ("band2", k[1], p[1])):
        side = kw["target_size"]
        if a.shape != (side, side) or a.dtype != torch.uint8:
            raise AssertionError(f"{label} {name}: {a.dtype} {tuple(a.shape)}")
        d = (a.int() - b.int()).abs()
        share = (d > 0).float().mean().item()
        log(f"resident ({label}): {name} kernels vs plain max|diff| "
            f"{d.max().item()}, share differing {share:.3g}")
        if d.max().item() > 1:
            raise AssertionError(f"{label} {name} differs from plain by > 1")
    same = (k[0] == p[0]) & (k[1] == p[1])
    if not torch.equal(k[2][same], p[2][same]):
        raise AssertionError(f"{label}: rgb differs where both bands agree")
    _check_mcus(label, blob, k[3], 3, n_mcus)
    RESIDENT_RGB[label] = k[2].cpu().numpy().reshape(*k[0].shape, 3)
    return k[3]


def phase_resident(safe: Path, blobs):
    import torch

    from sarpro_tpu_torch.core import fused
    from sarpro_tpu_torch.io.safe import TargetCrsArg, open_dual_pol

    clahe = fused.AutoscaleStrategy.CLAHE
    scene = open_dual_pol(safe, DEVICE, SIZE, target_crs=TargetCrsArg.AUTO,
                          resample_alg="cubic")
    _resident("clahe auto", scene, dict(strategy=clahe, target_size=SIZE,
                                        pad=True, resample_alg=None),
              blobs["warm clahe auto"])
    del scene
    _breakdown_warp(safe)

    t0 = time.perf_counter()
    scene = open_dual_pol(safe, DEVICE, SIZE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host = scene.band1.cpu().numpy()
    t2 = time.perf_counter()
    torch.from_numpy(host).to(scene.band1.device)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"breakdown (no-warp path): read + upload of both bands "
        f"{(t1 - t0) * 1e3:.1f} ms, of which one band's upload from pageable "
        f"memory {(t3 - t2) * 1e3:.1f} ms (host clock)")
    del host
    kw = dict(strategy=fused.AutoscaleStrategy.TAMED, target_size=SIZE,
              pad=True, resample_alg="cubic")
    _breakdown(scene, kw)
    _resident("tamed cubic", scene, kw, blobs["warm tamed cubic"])


def _check_tiff(label: str, out: Path, dtype: str, side: int, bands: int,
                georeferenced: bool, pol: str):
    """Read a TIFF back: dtype, shape, band count, the GDAL metadata's
    polarization label, and a geotransform exactly where the reference
    writes one (a non-identity pixel grid: an affine product, not a
    GCP-georeferenced one left unwarped). Returns its bands."""
    from sarpro_tpu_torch.io import raster

    t = raster.TiffReader(out)
    try:
        arrs = [t.read(i) for i in range(1, t.samples + 1)]
        geo, meta = t.geo_info(), t.gdal_metadata()
    finally:
        t.close()
    got = (str(arrs[0].dtype), arrs[0].shape, len(arrs))
    if got != (dtype, (side, side), bands):
        raise AssertionError(f"{label}: TIFF {got}, expected "
                             f"{(dtype, (side, side), bands)}")
    if (geo.geotransform is not None) != georeferenced:
        raise AssertionError(f"{label}: geotransform {geo.geotransform}, "
                             f"expected {'one' if georeferenced else 'none'}")
    if meta.get("POLARIZATIONS") != pol:
        raise AssertionError(f"{label}: POLARIZATIONS "
                             f"{meta.get('POLARIZATIONS')!r}, expected {pol}")
    log(f"slice: {label} TIFF {got[0]} {side}x{side} x{bands}, geotransform "
        f"{geo.geotransform}, POLARIZATIONS {pol}")
    return arrs


def _check_mcus(label: str, blob: bytes, dct, ncomp: int,
                n_mcus: int = 256):
    """The JPEG's first MCUs entropy-decode to the device's coefficient
    blocks (`ncomp` planes of transposed 8 x 8 blocks)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from oracle import decode_baseline_jpeg_coeffs

    blocks, got = decode_baseline_jpeg_coeffs(blob, n_mcus)
    if got != ncomp:
        raise AssertionError(f"{label}: {got} JPEG components, expected "
                             f"{ncomp}")
    dct = dct.cpu().numpy().reshape(ncomp, -1, 8, 8)
    zz = _zigzag()
    for m in range(n_mcus):
        for c in range(ncomp):
            want = [int(dct[c, m][col, row]) for row, col in zz]
            if blocks[m * ncomp + c] != want:
                raise AssertionError(f"{label}: JPEG block {m}/{c} != "
                                     "device block")
    log(f"resident ({label}): first {n_mcus} MCUs of the JPEG decode to the "
        "device's coefficient blocks")


def _one_bin_bound(band, strategy, max_val: float) -> int:
    """Levels by which a band may move when one percentile of the 4096-bin
    histogram moves by a bin at each end of the window (through the
    strategy's gamma), plus 1 for the trunc."""
    from sarpro_tpu_torch.core import fused

    db, mask = fused._db_mask(band)
    s = fused._stats(db, mask)
    low, high, gamma = (float(v) for v in fused._window(s, strategy))
    step = (float(s["max"]) - float(s["min"])) / fused.NUM_BINS
    d = min(2 * step / max(high - low, 1.0), 1.0)
    return 1 + math.ceil(max_val * (d ** gamma if gamma < 1 else gamma * d))


def _resident_gray(label: str, band, kw, tiff_band, replot=None):
    """The grayscale program on a resident band: once to warm, once with
    host syncs made errors (it must equal the TIFF the CLI wrote), then
    under force_plain() on the same band, which must give the same values
    (the kernels equal their plain versions bit for bit). `replot`, when
    given, re-reads the band under force_plain() (the device resample in
    its plain version too): the u16 output then moves within
    `_one_bin_bound`, measured and printed."""
    import numpy as np
    import torch

    from sarpro_tpu_torch.core import fused
    from sarpro_tpu_torch.core.numerics import as_f32
    from sarpro_tpu_torch.ops import force_plain

    fused.grayscale_pipeline(band, **kw)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.set_sync_debug_mode("error")  # any host sync raises
    try:
        start.record()
        k = fused.grayscale_pipeline(band, **kw)
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    end.synchronize()
    log(f"resident ({label}): grayscale program on the device "
        f"{start.elapsed_time(end):.3f} ms (no host sync)")
    if not np.array_equal(k.cpu().numpy(), tiff_band):
        raise AssertionError(f"{label}: the TIFF does not hold the device's "
                             "band")
    with force_plain():
        p = fused.grayscale_pipeline(band, **kw)
    _check_equal(k, p, f"{label}: grayscale program on the same band")
    log(f"resident ({label}): {k.dtype} kernels vs plain on the same band: "
        "bit-equal")
    if replot is not None:
        with force_plain():
            p2 = fused.grayscale_pipeline(replot(), **kw)
        d = (as_f32(k) - as_f32(p2)).abs()
        bound = _one_bin_bound(band, kw["strategy"], kw["bit_depth"].max_val)
        log(f"resident ({label}): vs the plain route from the read on "
            f"(plain resample) max|diff| {d.max().item()} (bound {bound}), "
            f"share differing {(d > 0).float().mean().item():.3g}")
        if d.max().item() > bound:
            raise AssertionError(f"{label}: plain route differs by more than "
                                 f"{bound}")


def _breakdown_gray(safe: Path):
    """The single-band route step by step (VV, CLAHE, 2048), each step
    finished before the next: decimated read (host read + box reduce +
    upload, host clock), the grayscale program (CUDA events), copy back,
    and the TIFF write or, for the JPEG, the DCT tail's program and the
    entropy coding."""
    import torch

    from sarpro_tpu_torch.core import fast_path, fused
    from sarpro_tpu_torch.io import safe as tsafe
    from sarpro_tpu_torch.io.writers import jpeg

    t0 = time.perf_counter()
    meta, band = tsafe.open_band(safe, "vv", DEVICE, SIZE)
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t0
    kw = dict(strategy=fused.AutoscaleStrategy.CLAHE, target_size=SIZE)
    ms = {}
    outs = {}
    for tail in (False, True):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        outs[tail] = fused.grayscale_pipeline(band, jpeg_dct=tail, **kw)
        ev[1].record()
        ev[1].synchronize()
        ms[tail] = ev[0].elapsed_time(ev[1])
    t0 = time.perf_counter()
    arr = outs[False].cpu().numpy()
    t1 = time.perf_counter()
    out = safe.parent / "breakdown.tiff"
    fast_path._write_tiff(fast_path.write_tiff_u8(out, SIZE, SIZE, arr), meta,
                          None, None, None)
    t2 = time.perf_counter()
    co = outs[True].cpu().numpy()
    t3 = time.perf_counter()
    blob = jpeg._native.jpeg_encode_coeffs_gray(co, SIZE, SIZE)
    t4 = time.perf_counter()
    log(f"breakdown (single band, vv clahe {SIZE}): decimated read "
        f"{t_read * 1e3:.1f} ms (host clock); device {ms[False]:.3f} ms "
        f"(with the DCT tail {ms[True]:.3f} ms, CUDA events); copy-back "
        f"{(t1 - t0) * 1e3:.2f} ms (blocks {(t3 - t2) * 1e3:.2f} ms); TIFF "
        f"write {(t2 - t1) * 1e3:.1f} ms ({out.stat().st_size} bytes); "
        f"entropy coding {(t4 - t3) * 1e3:.2f} ms ({len(blob)} bytes)")


def phase_gray(safe: Path, work: Path):
    """GRAY_RUNS on the 20000^2 SAFE, then the resident checks."""
    from sarpro_tpu_torch.core import fused, ops as pol_ops
    from sarpro_tpu_torch.io import safe as tsafe

    AutoscaleStrategy, BitDepth = fused.AutoscaleStrategy, fused.BitDepth

    walls, counts, outs = {}, {}, {}
    for label, suffix, args in GRAY_RUNS:
        out = work / f"{label.replace(' ', '_')}.{suffix}"
        argv = ["-i", str(safe), "--size", str(SIZE), "--fast"] + args
        _drive(f"first {label}", argv, out)
        walls[label], counts[label], routes = _drive(label, argv, out)
        outs[label] = out
        if suffix == "jpg":
            _check_jpeg(label, out)
        if label == "ratio jpeg" and routes["host_reduce"] != 2:
            raise AssertionError(f"{label}: the bands did not take the host "
                                 f"box reduce ({routes})")
    _check_utm("gray auto", outs["gray auto"])
    synrgb = json.loads(outs["multiband robust jpeg"].with_suffix(
        ".json").read_text())
    log(f"slice: multiband robust jpeg sidecar synthetic_rgb_mode "
        f"{synrgb.get('synthetic_rgb_mode')!r}")
    clahe_tiff, = _check_tiff("gray clahe tiff", outs["gray clahe tiff"],
                              "uint8", SIZE, 1, False, "VV")
    u16_tiff, = _check_tiff("gray adaptive u16 cubic",
                            outs["gray adaptive u16 cubic"], "uint16", SIZE,
                            1, False, "VH")
    _check_tiff("multiband tiff", outs["multiband tiff"], "uint16", SIZE, 2,
                False, "MULTIBAND(VV, VH)")

    # resident: the grayscale program on the decimated bands the CLI read
    _, band = tsafe.open_band(safe, "vv", DEVICE, SIZE)
    _resident_gray("gray clahe tiff", band,
                   dict(strategy=AutoscaleStrategy.CLAHE,
                        bit_depth=BitDepth.U8, target_size=SIZE), clahe_tiff)
    args = (safe, "vh", DEVICE, SIZE)
    _, band = tsafe.open_band(*args, resample_alg="cubic")
    _resident_gray("gray adaptive u16 cubic", band,
                   dict(strategy=AutoscaleStrategy.ADAPTIVE,
                        bit_depth=BitDepth.U16, target_size=SIZE,
                        resample_alg="cubic"), u16_tiff,
                   replot=lambda: tsafe.open_band(*args,
                                                  resample_alg="cubic")[1])
    del band
    pair = tsafe.open_pair(safe, DEVICE, "Operation ratio", SIZE)
    ratio = pol_ops.ratio_arrays(pair.band1, pair.band2)
    _check_mcus("ratio jpeg", outs["ratio jpeg"].read_bytes(),
                fused.grayscale_pipeline(
                    ratio, strategy=AutoscaleStrategy.STANDARD,
                    target_size=SIZE, jpeg_dct=True), 1)
    del pair, ratio
    _, band = tsafe.open_band(safe, "vv", DEVICE, SIZE,
                              target_crs=tsafe.TargetCrsArg.AUTO,
                              resample_alg="cubic")
    _check_mcus("gray auto", outs["gray auto"].read_bytes(),
                fused.grayscale_pipeline(
                    band, strategy=AutoscaleStrategy.CLAHE,
                    target_size=SIZE, jpeg_dct=True), 1)
    del band
    scene = tsafe.open_dual_pol(safe, DEVICE, SIZE)
    _resident("robust default synRGB", scene,
              dict(strategy=AutoscaleStrategy.ROBUST, target_size=SIZE,
                   pad=True, resample_alg=None),
              outs["multiband robust jpeg"].read_bytes())
    del scene
    _breakdown_gray(safe)
    return walls, counts


def phase_jpeg_800(safe: Path, work: Path):
    """JPEG_800 on the 20000^2 SAFE, each driven once. Every MCU of each
    file decodes to the device's coefficient blocks, and so does every MCU
    of those blocks coded again on 16 threads (this host has fewer cores
    than the split that aborted needs)."""
    from sarpro_tpu_torch import _native
    from sarpro_tpu_torch.core import fused, ops as pol_ops
    from sarpro_tpu_torch.io import safe as tsafe

    blobs = {}
    for label, args in JPEG_800:
        out = work / f"{label.replace(' ', '_')}.jpg"
        _drive(label, ["-i", str(safe), "--size", str(SIZE_800), "--fast"]
               + args, out)
        blobs[label] = _check_jpeg(label, out)
    n_mcus = (SIZE_800 // 8) ** 2
    threads = _native.coder_threads(SIZE_800, 16)
    scene = tsafe.open_dual_pol(safe, DEVICE, SIZE_800)
    dct = _resident("multiband robust jpeg 800", scene,
                    dict(strategy=fused.AutoscaleStrategy.ROBUST,
                         target_size=SIZE_800, pad=True, resample_alg=None),
                    blobs["multiband robust jpeg 800"], n_mcus)
    co = dct.cpu().numpy()
    _check_mcus(f"multiband robust jpeg 800 coded on 16 threads ({threads} "
                "bands)", _native.jpeg_encode_coeffs444(
                    co[0], co[1], co[2], SIZE_800, SIZE_800, n_threads=16),
                dct, 3, n_mcus)
    del scene
    pair = tsafe.open_pair(safe, DEVICE, "Operation ratio", SIZE_800)
    dct = fused.grayscale_pipeline(
        pol_ops.ratio_arrays(pair.band1, pair.band2),
        strategy=fused.AutoscaleStrategy.STANDARD, target_size=SIZE_800,
        jpeg_dct=True)
    _check_mcus("ratio jpeg 800", blobs["ratio jpeg 800"], dct, 1, n_mcus)
    _check_mcus(f"ratio jpeg 800 coded on 16 threads ({threads} bands)",
                _native.jpeg_encode_coeffs_gray(dct.cpu().numpy(), SIZE_800,
                                                SIZE_800, n_threads=16),
                dct, 1, n_mcus)


class _CoderInput:
    """While active, records the planes each call of the native pixel JPEG
    entries is handed ((1, h, w) gray or (3, h, w) YCbCr u8), in order."""

    def __enter__(self):
        import numpy as np

        from sarpro_tpu_torch import _native

        self.planes = []
        self._orig = (_native.jpeg_encode_gray, _native.jpeg_encode_ycbcr444)
        gray, ycc = self._orig

        def rec_gray(y, n_threads=0):
            self.planes.append(np.array(y)[None])
            return gray(y, n_threads)

        def rec_ycc(y, cb, cr, n_threads=0):
            self.planes.append(np.stack([y, cb, cr]))
            return ycc(y, cb, cr, n_threads)

        _native.jpeg_encode_gray, _native.jpeg_encode_ycbcr444 = (rec_gray,
                                                                  rec_ycc)
        return self

    def __exit__(self, *exc):
        from sarpro_tpu_torch import _native

        _native.jpeg_encode_gray, _native.jpeg_encode_ycbcr444 = self._orig


def _check_mcus_f64(label: str, blob: bytes, planes, n_mcus: int):
    """The JPEG's first `n_mcus` MCUs entropy-decode to within +-1 of an f64
    DCT of the planes the pixel coder was handed (tests/oracle.py's
    jpeg_dct_oracle; the native FDCT's contract, tests/test_native.py:276).
    Returns the decoded blocks."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from oracle import decode_baseline_jpeg_coeffs, jpeg_dct_oracle

    ncomp, h, w = planes.shape
    blocks, got = decode_baseline_jpeg_coeffs(blob, n_mcus)
    if got != ncomp:
        raise AssertionError(f"{label}: {got} JPEG components, expected "
                             f"{ncomp}")
    pad = np.pad(planes, ((0, 0), (0, -h % 8), (0, -w % 8)), mode="edge")
    want = jpeg_dct_oracle(pad).reshape(ncomp, -1, 8, 8)[:, :n_mcus]
    zz = np.array(_zigzag())
    # the oracle's transposed blocks in zigzag order, MCU-interleaved
    want = want[:, :, zz[:, 1], zz[:, 0]].transpose(1, 0, 2).reshape(-1, 64)
    dec = np.array(blocks, np.int64)
    err = np.abs(dec - want).max()
    if err > 1:
        raise AssertionError(f"{label}: a JPEG coefficient is {err} from the "
                             "f64 DCT of the coder's input")
    log(f"exact ({label}): {n_mcus} MCUs of the JPEG within +-1 of the f64 "
        f"DCT of the coder's input (max |diff| {err})")
    return dec


def _count_syncs(fn, label: str = "") -> int:
    """Host syncs of one call of `fn`, as torch.cuda's sync debug mode
    reports them; with a `label`, each distinct report is printed."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own one-time notice (a prototype that "does not yet detect
    # all synchronizing operations") is not a sync
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    if label:
        for msg in sorted(set(syncs)):
            log(f"sync ({label}): {syncs.count(msg)} x {msg.splitlines()[0]}")
    return len(syncs)


def _exact_band_ms(label: str, band, strategy, bit_depth) -> None:
    """Exact mode's band pipeline on a resident band: its elapsed time on
    the device between two CUDA events (the host's round trips included),
    its kernels' time in a torch.profiler trace, and its host syncs
    (torch.cuda's sync debug mode, counted)."""
    import torch

    from sarpro_tpu_torch.core import pipeline

    def run():
        return pipeline.process_scalar_data_pipeline(band, bit_depth,
                                                     strategy)

    run()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    run()
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    syncs = _count_syncs(run)
    log(f"exact ({label}): band pipeline {start.elapsed_time(end):.3f} ms "
        f"between CUDA events (host {wall:.2f} ms), kernels "
        f"{profiled_ms(run, reps=3):.3f} ms (profiler), {syncs} host syncs "
        f"a band")


def _buffer_kernels_vs_plain(label: str, what: str, **kw):
    """process_safe_to_buffer on the card with the kernels (launch counts
    read), then under force_plain(): bit-equal arrays. Returns the first."""
    import numpy as np

    from sarpro_tpu_torch import api, ops

    ops.reset_launch_counts()
    a = api.process_safe_to_buffer(device=DEVICE, **kw)
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    with ops.force_plain():
        b = api.process_safe_to_buffer(device=DEVICE, **kw)
    x, y = getattr(a, what), getattr(b, what)
    if x is None or x.shape != y.shape or not np.array_equal(x, y):
        raise AssertionError(f"{label}: process_safe_to_buffer differs under "
                             "force_plain()")
    log(f"exact ({label}): process_safe_to_buffer {what} {x.dtype} "
        f"{x.shape} bit-equal with the kernels ({launched}) and under "
        "force_plain()")
    return x


def phase_exact(safe: Path, work: Path) -> Path:
    """EXACT_RUNS through the CLI without --fast (each run twice, the second
    with its launch counts checked against PATHS, then once with --fast),
    the files checked; process_safe_to_buffer with the kernels and under
    force_plain(); the band pipeline's device time and host syncs. Writes
    and returns the 10000^2 HH+HV product the full-resolution phase reuses."""
    import numpy as np
    import torch

    from sarpro_tpu_torch import _native
    from sarpro_tpu_torch.io import safe as tsafe
    from sarpro_tpu_torch.types import (
        AutoscaleStrategy,
        BitDepth,
        OutputFormat,
        Polarization,
    )

    t0 = time.perf_counter()
    # an affine geotransform, so the TIFF carries one
    ew = _write_safe(work / "ew", name=EW_NAME, pols=("hh", "hv"),
                     shape=(EW_SIDE, EW_SIDE), with_affine_geotransform=True)
    log(f"exact: wrote {ew.name} ({EW_SIDE}x{EW_SIDE} u16 HH+HV) in "
        f"{time.perf_counter() - t0:.1f} s")
    safes = {"main": safe, "ew": ew}
    outs, coded = {}, {}
    sizes = {"SIZE": SIZE, "SIZE_800": SIZE_800}
    for label, which, suffix, size, args in EXACT_RUNS:
        out = work / f"{label.replace(' ', '_')}.{suffix}"
        argv = ["-i", str(safes[which])] + args + (
            ["--size", str(sizes[size])] if size else [])
        with _CoderInput() as rec:
            _drive(f"first {label}", argv, out)
        first = out.read_bytes()
        torch.cuda.reset_peak_memory_stats()
        wall, _, _ = _drive(label, argv, out)
        peak = torch.cuda.max_memory_allocated()
        if out.read_bytes() != first:
            raise AssertionError(f"{label}: the second run wrote other bytes")
        fast = _cli_wall(f"fast {label}", argv + ["--fast"],
                         work / f"fast_{out.name}")
        log(f"exact: {label} warm wall {wall * 1e3:.1f} ms, the same "
            f"arguments with --fast {fast * 1e3:.1f} ms, device peak "
            f"{peak / 2**20:.0f} MiB (max_memory_allocated)")
        outs[label], coded[label] = out, rec.planes
        if suffix == "jpg":
            _check_jpeg(label, out)

    _check_utm("exact clahe auto jpeg", outs["exact clahe auto jpeg"])
    planes, = coded["exact clahe auto jpeg"]
    _check_mcus_f64("exact clahe auto jpeg",
                    outs["exact clahe auto jpeg"].read_bytes(), planes, 256)
    n_mcus = (SIZE_800 // 8) ** 2
    threads = _native.coder_threads(SIZE_800, 16)
    for label in ("exact ratio jpeg 800", "exact multiband robust jpeg 800"):
        planes, = coded[label]
        dec = _check_mcus_f64(label, outs[label].read_bytes(), planes, n_mcus)
        p = [np.ascontiguousarray(x) for x in planes]
        blob16 = (_native.jpeg_encode_gray(p[0], n_threads=16) if len(p) == 1
                  else _native.jpeg_encode_ycbcr444(*p, n_threads=16))
        dec16 = _check_mcus_f64(f"{label} coded on 16 threads ({threads} "
                                "bands)", blob16, planes, n_mcus)
        if not np.array_equal(dec, dec16):
            raise AssertionError(f"{label}: the 16-thread stream holds other "
                                 "coefficients")
    _check_tiff("exact adaptive u16 cubic tiff",
                outs["exact adaptive u16 cubic tiff"], "uint16", SIZE, 1,
                False, "VH")
    full_tiff, = _check_tiff("exact full clahe tiff",
                             outs["exact full clahe tiff"], "uint8", EW_SIDE,
                             1, True, "HH")

    clahe, u8 = AutoscaleStrategy.CLAHE, BitDepth.U8
    _buffer_kernels_vs_plain(
        "multiband clahe 2048 pad", "rgb", input=safe,
        polarization=Polarization.from_cli("multiband"), autoscale=clahe,
        bit_depth=u8, target_size=SIZE, pad=True,
        output_format=OutputFormat.JPEG)
    gray = _buffer_kernels_vs_plain(
        "hh clahe 100 MP", "gray", input=ew,
        polarization=Polarization.from_cli("hh"), autoscale=clahe,
        bit_depth=u8)
    if not np.array_equal(gray, full_tiff):
        raise AssertionError("exact full clahe tiff: the TIFF does not hold "
                             "process_safe_to_buffer's band")

    _, band = tsafe.open_band(safe, "vv", DEVICE, SIZE)
    _exact_band_ms(f"vv clahe u8 {SIZE}", band, clahe, u8)
    _exact_band_ms(f"vv adaptive u16 {SIZE}", band,
                   AutoscaleStrategy.ADAPTIVE, BitDepth.U16)
    _, band = tsafe.open_band(ew, "hh", DEVICE)
    _exact_band_ms(f"hh clahe u8 {EW_SIDE}", band, clahe, u8)
    del band
    torch.cuda.empty_cache()
    return ew


def phase_full(work: Path, ew: Path):
    """The CLI's defaults at original size on the 10000^2 HH+HV product,
    and its synRGB JPEG, in fast mode; the CLAHE kernels at 100 MP."""
    import torch

    from sarpro_tpu_torch.core import fused
    from sarpro_tpu_torch.io import safe as tsafe

    walls, counts = {}, {}
    tiff_argv = ["-i", str(ew), "--polarization", "hh", "--fast"]
    out = work / "full_clahe.tiff"
    _drive("first full clahe tiff", tiff_argv, out)
    walls["full clahe tiff"], counts["full clahe tiff"], _ = _drive(
        "full clahe tiff", tiff_argv, out)
    tiff_band, = _check_tiff("full clahe tiff", out, "uint8", EW_SIDE, 1,
                             True, "HH")
    jpg = work / "full_multiband.jpg"
    walls["full multiband jpeg"], counts["full multiband jpeg"], _ = _drive(
        "full multiband jpeg",
        ["-i", str(ew), "--polarization", "multiband", "-f", "jpeg",
         "--autoscale", "clahe", "--size", str(SIZE), "--pad", "--fast"], jpg)
    _check_jpeg("full multiband jpeg", jpg)
    label = json.loads(jpg.with_suffix(".json").read_text())
    log(f"full: multiband jpeg sidecar polarizations "
        f"{label.get('polarizations')!r}")
    _, band = tsafe.open_band(ew, "hh", DEVICE)
    _resident_gray("full clahe tiff", band,
                   dict(strategy=fused.AutoscaleStrategy.CLAHE,
                        bit_depth=fused.BitDepth.U8), tiff_band)
    del band
    torch.cuda.empty_cache()
    return walls, counts


def _streamed_launches(label: str) -> dict:
    """The launches a streamed route makes, from the chunk plan of its
    SIDE-row bands: per band and chunk one 4096-bin histogram, with CLAHE
    one tile_histogram and one clahe_lookup, and for the suppressed synRGB
    one 256-bin histogram of its u8 codes; per chunk of the compose one
    synrgb_lookup."""
    from sarpro_tpu_torch.core import streamed

    k = len(streamed._chunk_starts(SIDE, streamed.CHUNK_ROWS))
    return {
        "streamed exact clahe tiff": {"histogram": k, "tile_histogram": k,
                                      "clahe_lookup": k},
        "streamed synrgb jpeg": {"histogram": 4 * k, "tile_histogram": 2 * k,
                                 "clahe_lookup": 2 * k, "synrgb_lookup": k},
        "streamed adaptive u16 tiff": {"histogram": k},
    }[label]


def _peak_run(fn):
    """(result, device ms between CUDA events, host wall ms, device peak
    MiB) of one call of `fn` that ends with its result on the host or
    synchronized; the peak is `max_memory_allocated` over the call, the
    resident inputs included."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return (out, start.elapsed_time(end), wall,
            torch.cuda.max_memory_allocated() / 2**20)


def _streamed_vs_fused(label: str, streamed_fn, fused_fn, chunked_fn):
    """The streamed and the fused program on the same resident input: each
    side's device ms, wall and peak, bit-equality, the streamed side again
    under force_plain() (its peak: the plain versions' int64 temporaries at
    the chunk shape), and its host syncs at CHUNK_ROWS and at half of it
    (`chunked_fn(rows)`), which must be the same. Returns the streamed
    result."""
    from sarpro_tpu_torch.core import streamed
    from sarpro_tpu_torch.ops import force_plain

    got, ms, wall, peak = _peak_run(streamed_fn)
    want, f_ms, f_wall, f_peak = _peak_run(fused_fn)
    log(f"streamed ({label}): streamed {ms:.3f} ms on the device (host "
        f"{wall:.1f} ms), peak {peak:.0f} MiB; fused {f_ms:.3f} ms (host "
        f"{f_wall:.1f} ms), peak {f_peak:.0f} MiB")
    _check_equal(got, want, f"{label}: streamed vs fused")
    del want
    with force_plain():
        plain, p_ms, _, p_peak = _peak_run(streamed_fn)
    _check_equal(got, plain, f"{label}: streamed under force_plain()")
    del plain
    rows = streamed.CHUNK_ROWS
    for r in (rows, rows // 2):  # the first calls (allocator growth) uncounted
        chunked_fn(r)
    syncs = [_count_syncs(lambda: chunked_fn(r), f"{label}, {r} rows")
             for r in (rows, rows // 2)]
    if syncs[0] != syncs[1]:
        raise AssertionError(f"{label}: host syncs grow with the chunks "
                             f"({syncs})")
    log(f"streamed ({label}): bit-equal to the fused program and under "
        f"force_plain() ({p_ms:.1f} ms, peak {p_peak:.0f} MiB); {syncs[0]} "
        f"host syncs at {rows} and at {rows // 2} rows a chunk")
    return got


def phase_streamed(safe: Path, work: Path):
    """STREAMED_RUNS on the SIDE^2 SAFE at its original size, each driven
    once with its launch counts checked against the chunk plan, the files
    checked; then on the resident DN the streamed passes against the fused
    program (bit-equal; the synRGB floors compared first), under
    force_plain(), with each side's device peak, time and host syncs; and
    exact mode's band pipeline on the same band, for the budget that
    BIG_SCENE_PIXELS stands for."""
    import numpy as np
    import torch

    from sarpro_tpu_torch import _native
    from sarpro_tpu_torch.core import fused, pipeline, streamed
    from sarpro_tpu_torch.io import safe as tsafe
    from sarpro_tpu_torch.ops import histogram

    AutoscaleStrategy, BitDepth = fused.AutoscaleStrategy, fused.BitDepth
    if SIDE * SIDE <= streamed.BIG_SCENE_PIXELS:
        raise AssertionError(f"{SIDE}^2 is not above BIG_SCENE_PIXELS")
    walls, counts, outs = {}, {}, {}
    for label, suffix, args in STREAMED_RUNS:
        out = work / f"{label.replace(' ', '_')}.{suffix}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        walls[label], counts[label], _ = _drive(label, ["-i", str(safe)]
                                                + args, out)
        peak = torch.cuda.max_memory_allocated() / 2**20
        launched = {k: v for k, v in counts[label].items() if v}
        if launched != _streamed_launches(label):
            raise AssertionError(f"{label}: launches {launched}, the chunk "
                                 f"plan gives {_streamed_launches(label)}")
        log(f"streamed: {label} launches as the chunk plan gives, device "
            f"peak {peak:.0f} MiB (max_memory_allocated)")
        outs[label] = out
    blob = _check_jpeg("streamed synrgb jpeg", outs["streamed synrgb jpeg"])
    clahe_tiff, = _check_tiff("streamed exact clahe tiff",
                              outs["streamed exact clahe tiff"], "uint8",
                              SIDE, 1, False, "VV")
    u16_tiff, = _check_tiff("streamed adaptive u16 tiff",
                            outs["streamed adaptive u16 tiff"], "uint16",
                            SIDE, 1, False, "VH")

    t0 = time.perf_counter()
    scene = tsafe.open_dual_pol(safe, DEVICE)
    torch.cuda.synchronize()
    log(f"streamed: read + upload of both {SIDE}^2 bands "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock)")
    vv, vh = scene.band1, scene.band2
    clahe, adaptive = AutoscaleStrategy.CLAHE, AutoscaleStrategy.ADAPTIVE
    u8, u16 = BitDepth.U8, BitDepth.U16
    got = _streamed_vs_fused(
        "vv clahe u8",
        lambda: streamed.grayscale_streamed(vv, clahe),
        lambda: fused.grayscale_pipeline(vv, clahe, target_size=None),
        lambda r: streamed.grayscale_streamed(vv, clahe, chunk_rows=r))
    if not np.array_equal(got.cpu().numpy(), clahe_tiff):
        raise AssertionError("streamed exact clahe tiff: the TIFF does not "
                             "hold the device's band")
    got = _streamed_vs_fused(
        "vh adaptive u16",
        lambda: streamed.grayscale_streamed(vh, adaptive, u16),
        lambda: fused.grayscale_pipeline(vh, adaptive, u16, target_size=None),
        lambda r: streamed.grayscale_streamed(vh, adaptive, u16,
                                              chunk_rows=r))
    if not np.array_equal(got.cpu().numpy(), u16_tiff):
        raise AssertionError("streamed adaptive u16 tiff: the TIFF does not "
                             "hold the device's band")
    del got, clahe_tiff, u16_tiff

    # synRGB: the two floors first (fused: f32 cumsum and target; streamed:
    # int64 on the host, f64 target), on the fused program's bands, which
    # the streamed q16 codes must equal
    n = 2 * SIDE * SIDE
    bands = []
    for dn, copol in ((vv, True), (vh, False)):
        b = fused.synrgb_band_stage(dn, clahe, copol, None, False)
        q16, h, mn, mx = streamed.band_u8_streamed(
            dn, clahe, collect_hist=True, emit_q16=True)
        _check_equal(streamed._q16_u8_vals(q16, mn, mx, 0, SIDE), b,
                     "streamed q16 codes vs the fused band")
        _check_equal(h, histogram(b.reshape(-1), 256),
                     "streamed u8 histogram vs the fused band's")
        bands.append(b)
        del q16
    hist = histogram([b.reshape(-1) for b in bands], 256)
    floors = (int(fused._suppressed_floor(hist, n)),
              streamed._suppressed_floor_host(hist.cpu().numpy(), n))
    del bands, hist
    log(f"streamed (synrgb clahe): water floor fused {floors[0]}, streamed "
        f"{floors[1]}; bands and their histograms bit-equal")
    dct_fn = (lambda r=None: streamed.synrgb_streamed(
        vv, vh, clahe, layout="dct", chunk_rows=r))
    if floors[0] == floors[1]:
        dct = _streamed_vs_fused(
            "synrgb clahe dct", dct_fn,
            lambda: fused.synrgb_pipeline(vv, vh, clahe, target_size=None,
                                          channel_order="dct").cpu(), dct_fn)
    else:
        log("streamed (synrgb clahe dct): the floors differ, so the blocks "
            "are not compared with the fused program's")
        dct = dct_fn()
    _check_mcus("streamed synrgb jpeg", blob, dct, 3)
    co = dct.numpy()
    t0 = time.perf_counter()
    coded = _native.jpeg_encode_coeffs444(co[0], co[1], co[2], SIDE, SIDE)
    log(f"streamed: entropy coding of the {SIDE}^2 synRGB blocks "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({len(coded)} bytes, "
        f"{_native.coder_threads(SIDE)} threads; host clock)")
    del dct, co, coded

    for label, dn in (("vv", vv), ("vh", vh)):
        _, ms, wall, peak = _peak_run(
            lambda: pipeline.process_scalar_data_pipeline(dn, u8, clahe))
        log(f"streamed: exact mode's band pipeline on the {label} {SIDE}^2 "
            f"band (CLAHE u8) {ms:.3f} ms on the device (host {wall:.1f} ms), "
            f"peak {peak:.0f} MiB")
    del scene, vv, vh
    torch.cuda.empty_cache()
    return walls, counts


class _FixedClock:
    """Stands in for the `datetime` module of the SAFE parser during the
    batch phase: one conversion time for every parse, so the files of two
    runs compare by bytes."""

    import datetime as _dt

    timezone = _dt.timezone

    class datetime:
        @staticmethod
        def now(tz=None):
            import datetime

            return datetime.datetime(2025, 7, 6, 20, 43, 46, tzinfo=tz)


def _batch_dir(work: Path, safe: Path, ew: Path) -> Path:
    """The batch directory, from the products already written (hard links,
    no new raster of full size): the SIDE^2 IW product, a second one whose
    VV and VH rasters are exchanged (so a file written under the wrong
    scene's name shows), the EW product (another shape and pair), a small
    product whose VV raster is cut short (an error), an SLC product and a
    directory that is no SAFE (both skipped)."""
    import os

    d = work / "batch_in"
    d.mkdir()
    swap = {"-vv-": "-vh-", "-vh-": "-vv-"}
    for src, name, rename in ((safe, "a_iw.SAFE", {}),
                              (safe, "b_iw_swapped.SAFE", swap),
                              (ew, "c_ew.SAFE", {})):
        for f in src.rglob("*"):
            if f.is_dir():
                continue
            rel = f.relative_to(src)
            if rel.parts[0] == "measurement":
                rel = rel.with_name(next(
                    (rel.name.replace(a, b) for a, b in rename.items()
                     if a in rel.name), rel.name))
            (d / name / rel).parent.mkdir(parents=True, exist_ok=True)
            os.link(f, d / name / rel)
    cut = make_safe(d, name="d_cut.SAFE", shape=(1000, 1000), seed=3)
    vv = next((cut / "measurement").glob("*-vv-*"))
    os.truncate(vv, vv.stat().st_size // 2)
    slc = make_safe(d, name="e_slc.SAFE", shape=(64, 64), seed=4)
    for f in [slc / "manifest.safe", *(slc / "annotation").glob("*.xml")]:
        f.write_text(f.read_text().replace(">GRD<", ">SLC<"))
    (d / "f_notes").mkdir()
    (d / "f_notes" / "readme.txt").write_text("not a product")
    return d


def _batch_cli(argv: list) -> tuple:
    """One batch CLI run: (wall s with the device's work, (processed,
    skipped, errors) as the CLI prints them, launches, read routes)."""
    import contextlib
    import io

    import torch

    from sarpro_tpu_torch import cli, ops
    from sarpro_tpu_torch.io import raster

    ops.reset_launch_counts()
    for k in raster.ROUTES:
        raster.ROUTES[k] = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.run(argv, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"batch cli.run failed ({rc}): {argv}")
    lines = dict(line.split(": ") for line in buf.getvalue().splitlines()
                 if line.split(": ")[0] in ("Processed", "Skipped", "Errors"))
    counters = tuple(int(lines[k]) for k in ("Processed", "Skipped",
                                             "Errors"))
    return wall, counters, ops.launch_counts(), dict(raster.ROUTES)


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _batch_trace(label: str, argv: list, work: Path, smi: str) -> None:
    """A pipelined run under torch.profiler: every kernel launch and every
    copy the CUDA runtime saw came from one thread, the calling one (the
    wrappers' and Tensor.to's threads are recorded too), and the device's
    busy share of the run's wall."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sarpro_tpu_torch.ops import kernels, resample_kernel, warp_kernel

    threads, saved = [], []
    for mod in (kernels, resample_kernel, warp_kernel):
        real = mod.use_kernel
        saved.append((mod, real))
        mod.use_kernel = (lambda t, _real=real: threads.append(
            threading.get_ident()) or _real(t))
    real_to = torch.Tensor.to

    def to(self, *a, **k):
        threads.append(threading.get_ident())
        return real_to(self, *a, **k)

    torch.Tensor.to = to
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, counters, _, _ = _batch_cli(argv)
    finally:
        torch.Tensor.to = real_to
        for mod, real in saved:
            mod.use_kernel = real
    if set(threads) != {threading.get_ident()}:
        raise AssertionError(f"{label}: kernel wrappers or Tensor.to ran on "
                             f"{len(set(threads))} threads")
    path = work / "batch_trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    calls = {}
    for e in events:
        name = e.get("name", "")
        if (e.get("cat") in ("cuda_runtime", "cuda_driver")
                and ("LaunchKernel" in name or "Memcpy" in name)):
            calls.setdefault(e.get("tid"), []).append(name)
    cpu_tids = {e.get("tid") for e in events if e.get("cat") == "cpu_op"}
    if not calls:
        raise AssertionError(f"{label}: the trace holds no launch or copy")
    if set(calls) != {threading.get_native_id()}:
        raise AssertionError(
            f"{label}: launches and copies on threads "
            f"{ {t: len(v) for t, v in calls.items()} }, the consumer is "
            f"{threading.get_native_id()}")
    (tid, names), = calls.items()
    spans = {"kernel": [], "gpu_memcpy": [], "gpu_memset": []}
    for e in events:
        if e.get("cat") in spans and "dur" in e:
            spans[e["cat"]].append((e["ts"], e["ts"] + e["dur"]))
    busy = _busy_us([iv for v in spans.values() for iv in v]) / 1e3
    ms = {k: sum(b - a for a, b in v) / 1e3 for k, v in spans.items()}
    log(f"batch: {label} traced pipelined run {counters}: "
        f"{sum('LaunchKernel' in n for n in names)} launches and "
        f"{sum('Memcpy' in n for n in names)} copies in the CUDA runtime, "
        f"all on thread {tid}, the consumer's (trace threads of CPU ops "
        f"{sorted(map(str, cpu_tids))}); {len(threads)} wrapper and "
        f"Tensor.to calls on the consumer; wall {wall * 1e3:.1f} ms "
        f"(profiler on), device busy {busy:.1f} ms = "
        f"{100 * busy / (wall * 1e3):.2f} % ({len(spans['kernel'])} kernels "
        f"{ms['kernel']:.2f} ms, {len(spans['gpu_memcpy'])} copies "
        f"{ms['gpu_memcpy']:.2f} ms) on {smi}")


def phase_batch(safe: Path, ew: Path, work: Path, smi: str) -> dict:
    """BATCH_RUNS over the batch directory: each product through the
    single-scene CLI, then the batch CLI serial, pipelined and (bucketing
    routes) bucketed. Every batch run prints the expected counters,
    launches what the single-scene runs launched in all, and writes files
    byte-identical to the single-scene ones. One route runs again under
    force_plain() (the same files), and each synRGB route's pipelined run
    once more under torch.profiler (_batch_trace). Returns ({label: {mode:
    wall s}}, {label: the pipelined run's launches})."""
    import torch

    from sarpro_tpu_torch import cli, ops
    from sarpro_tpu_torch.io import safe as tsafe
    from sarpro_tpu_torch.ops import force_plain

    t0 = time.perf_counter()
    d = _batch_dir(work, safe, ew)
    log(f"batch: directory {sorted(p.name for p in d.iterdir())} in "
        f"{time.perf_counter() - t0:.1f} s")
    real_clock = tsafe.datetime
    tsafe.datetime = _FixedClock
    tsafe._parse_comprehensive_cached.cache_clear()
    walls, totals = {}, {}
    try:
        for label, args, kernels, buckets in BATCH_RUNS:
            args = [str(SIZE) if a == "SIZE" else a for a in args]
            multiband = "multiband" in args
            ext = "jpg" if "jpeg" in args else "tiff"
            names = (["a_iw.SAFE", "b_iw_swapped.SAFE", "c_ew.SAFE"]
                     if multiband else ["a_iw.SAFE", "b_iw_swapped.SAFE"])
            expect = (len(names), 5 - len(names), 1)
            tag = label.replace(" ", "_")
            single = work / f"{tag}_single"
            single.mkdir()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            for name in names:
                if cli.run(["-i", str(d / name), "-o",
                            str(single / f"{name}.{ext}")] + args,
                           device=DEVICE) != 0:
                    raise RuntimeError(f"{label}: single-scene run of {name}")
            torch.cuda.synchronize()
            walls[label] = {"single-scene": time.perf_counter() - t0}
            want, per_scene = _files(single), ops.launch_counts()
            for k in kernels:
                if per_scene[k] <= 0:
                    raise AssertionError(f"{label}: kernel {k} was not "
                                         f"launched")
            modes = [m for m in BATCH_MODES if buckets or m != "bucketed"]
            for mode in modes:
                out = work / f"{tag}_{mode}"
                argv = (["--input-dir", str(d), "--output-dir", str(out)]
                        + args + BATCH_MODES[mode])
                wall, counters, counts, routes = _batch_cli(argv)
                walls[label][mode] = wall
                if counters != expect:
                    raise AssertionError(f"{label} {mode}: counters "
                                         f"{counters}, expected {expect}")
                if counts != per_scene:
                    raise AssertionError(f"{label} {mode}: launches {counts}"
                                         f", the single-scene runs {per_scene}")
                got = _files(out)
                if got.keys() != want.keys() or any(
                        got[k] != want[k] for k in want):
                    raise AssertionError(f"{label} {mode}: files differ from "
                                         f"the single-scene CLI's")
                if mode == "pipelined":
                    totals[label] = counts
                log(f"batch: {label} {mode} {counters}, wall "
                    f"{wall * 1e3:.1f} ms, {len(names) / wall:.3f} scenes/s, "
                    f"launches {counts} equal to the single-scene runs', "
                    f"files byte-identical to the single-scene CLI's; read "
                    f"routes {routes} on {smi}")
            log(f"batch: {label} walls " + ", ".join(
                f"{m} {w * 1e3:.1f} ms" for m, w in walls[label].items())
                + f" for {len(names)} scenes on {smi}")
        label, args, _, _ = BATCH_RUNS[2]
        args = [str(SIZE) if a == "SIZE" else a for a in args]
        plain = work / "batch_plain"
        with force_plain():
            _, counters, counts, _ = _batch_cli(
                ["--input-dir", str(d), "--output-dir", str(plain)] + args)
        if any(counts.values()) or _files(plain) != _files(
                work / f"{label.replace(' ', '_')}_serial"):
            raise AssertionError(f"{label}: force_plain() files differ")
        log(f"batch: {label} under force_plain() {counters}: the same files")
        for label, args, _, _ in BATCH_RUNS[:2]:
            args = [str(SIZE) if a == "SIZE" else a for a in args]
            _batch_trace(label, ["--input-dir", str(d), "--output-dir",
                                 str(work / f"{label.replace(' ', '_')}"
                                     "_traced")]
                         + args + BATCH_MODES["pipelined"], work, smi)
    finally:
        tsafe.datetime = real_clock
        tsafe._parse_comprehensive_cached.cache_clear()
    return walls, totals

# the CUDA function of each kernel, as torch.profiler names it
KERNEL_SYMBOLS = {"histogram": r"\bhist_kernel\b",
                  "tile_histogram": r"\btile_hist_kernel\b",
                  "clahe_lookup": r"\bclahe_lookup_kernel\b",
                  "resample_axis0": r"\bresample_axis0_kernel\b",
                  "synrgb_lookup": r"\bsynrgb_kernel\b",
                  "warp_sample": r"\bwarp_kernel\b"}


class _GuiClient:
    """HTTP calls to the GUI server on this host."""

    def __init__(self, base: str):
        self.base = base
        self.polls = 0

    def call(self, path: str, body=None) -> tuple:
        """(content type, body bytes) of a GET, or of a POST of `body`."""
        import urllib.request

        req = urllib.request.Request(
            self.base + path, method="GET" if body is None else "POST",
            data=None if body is None else json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.headers["Content-Type"], r.read()

    def get(self, path: str):
        return json.loads(self.call(path)[1])

    def post(self, path: str, body: dict):
        return json.loads(self.call(path, body)[1])

    def job(self, state: dict, timeout: float = 600.0) -> tuple:
        """Set the state, start the job and poll as the page does while a
        job runs (static/index.html: /api/state, then /api/logs past its
        cursor, every 500 ms) until it has finished: (last_result, every
        batch progress the polls saw)."""
        self.post("/api/state", state)
        if not self.post("/api/process", {})["started"]:
            raise AssertionError("the GUI did not start the job")
        seen, deadline = [], time.monotonic() + timeout
        cursor = self.get("/api/logs?since=0")["next"]
        while time.monotonic() < deadline:
            time.sleep(0.5)
            s = self.get("/api/state")
            cursor = self.get(f"/api/logs?since={cursor}")["next"]
            self.polls += 1
            if s["progress"] is not None:
                seen.append(s["progress"])
            if not s["running"] and s["last_result"]:
                return s["last_result"], seen
        raise AssertionError(f"the GUI job did not finish in {timeout} s")


def _gui_state(argv: list, out: Path) -> dict:
    """The GUI state of a single-file CLI run's arguments."""
    from sarpro_tpu_torch import cli

    args = cli.build_parser().parse_args(argv + ["-o", str(out)])
    return {"mode": "single", "input_path": str(args.input),
            "output_path": str(out), "fast": args.fast, "shard_devices": 0,
            "params": cli._params_from_args(args).to_dict()}


def _same_files(label: str, got: dict, want: dict) -> None:
    if got.keys() != want.keys() or any(got[k] != want[k] for k in want):
        raise AssertionError(f"{label}: files {sorted(got)} differ from "
                             f"{sorted(want)}")


def _outputs(out: Path) -> dict:
    """An output and its sidecars, by suffix."""
    return {p.suffix: p.read_bytes() for p in out.parent.iterdir()
            if p.stem == out.stem}


def _check_gui_launches(label: str, counts: dict, want: dict,
                        kernels) -> None:
    if counts != want:
        raise AssertionError(f"{label}: GUI launches {counts}, the CLI's "
                             f"{want}")
    for k in kernels:
        if counts[k] <= 0:
            raise AssertionError(f"{label}: kernel {k} was not launched")


def _trace_kernels(trace_dir: Path) -> dict:
    """Kernel launches by name in the Chrome trace utils.profiling.trace
    wrote into `trace_dir`."""
    import re

    files = list(trace_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"utils.profiling.trace wrote {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(bool(re.search(sym, n)) for n in names)
            for k, sym in KERNEL_SYMBOLS.items()}


def phase_gui(safe: Path, ew: Path, work: Path, smi: str, blob: bytes):
    """The port's GUI server on the card (make_server("127.0.0.1", 0) in a
    thread of this process), driven over HTTP: the page, stats and CRS
    check; the warm CLAHE auto-UTM 2048 JPEG (twice, the second under
    utils.profiling.trace), the 100 MP exact CLAHE TIFF, the Tamed cubic
    batch over the batch directory and a sharded job. Launches equal the
    CLI's for each route, files equal the CLI's (one conversion time),
    previews equal the files, and every kernel wrapper call and device copy
    of a job runs on that job's worker thread. Then the root's SafeReader
    against open_pair on the EW product. Returns the launches of the three
    jobs, summed, and the walls."""
    import logging
    import threading

    import numpy as np
    import torch

    from sarpro_tpu_torch import ops
    from sarpro_tpu_torch.gui.server import make_server
    from sarpro_tpu_torch.io import png
    from sarpro_tpu_torch.io import safe as tsafe
    from sarpro_tpu_torch.io.tiffio import TiffReader
    from sarpro_tpu_torch.ops import kernels, resample_kernel, warp_kernel
    from sarpro_tpu_torch.utils import profiling

    srv = make_server("127.0.0.1", 0, device=DEVICE)
    if srv.worker.device != torch.device(DEVICE):
        raise AssertionError(f"the GUI runs on {srv.worker.device}")
    serving = threading.Thread(target=srv.serve_forever, args=(0.05,),
                               daemon=True)
    serving.start()
    gui = _GuiClient(f"http://127.0.0.1:{srv.server_address[1]}")
    calls, saved = [], []
    for mod in (kernels, resample_kernel, warp_kernel):
        real = mod.use_kernel
        saved.append((mod, real))
        mod.use_kernel = (lambda t, _real=real: calls.append(
            threading.current_thread()) or _real(t))
    real_to = torch.Tensor.to

    def to(self, *a, **k):
        calls.append(threading.current_thread())
        return real_to(self, *a, **k)

    sarpro_log = logging.getLogger("sarpro")
    level = sarpro_log.level
    sarpro_log.setLevel(logging.INFO)  # as the GUI's main() logs
    real_clock = tsafe.datetime
    tsafe.datetime = _FixedClock
    tsafe._parse_comprehensive_cached.cache_clear()
    torch.Tensor.to = to
    launched, walls, job_threads = {}, {}, []

    def run_job(label: str, state: dict) -> tuple:
        """One job with the launch counts and the thread record set to 0
        just before it: (result, launches, progress seen). Every call of
        the job lies on one worker thread, not seen before."""
        ops.reset_launch_counts()
        del calls[:]
        result, seen = gui.job(state)
        counts = ops.launch_counts()
        threads = set(calls)
        if len(threads) != 1:
            raise AssertionError(f"{label}: wrappers and copies on "
                                 f"{[t.name for t in threads]}")
        thread, = threads
        if (not thread.name.startswith("sarpro-gui-job-")
                or thread is threading.current_thread()
                or thread in job_threads):
            raise AssertionError(f"{label}: device work on {thread.name}")
        job_threads.append(thread)
        log(f"gui: {label}: {result}, launches {counts}, {len(calls)} "
            f"wrapper and Tensor.to calls, all on {thread.name}")
        return result, counts, seen

    try:
        # 1. the page and the host endpoints
        ctype, page = gui.call("/")
        stats = gui.get("/api/stats")
        crs = gui.get("/api/crs?value=auto")
        if (b"sarproUI" not in page or "GPU" not in page.decode()
                or "mem_total_mb" not in stats or crs.get("ok") is not True):
            raise AssertionError(f"gui: page {ctype}, stats {stats}, crs "
                                 f"{crs}")
        log(f"gui: / {len(page)} bytes {ctype}; stats {stats}; crs auto "
            f"{crs}")

        # 2. the warm CLAHE auto-UTM 2048 JPEG, beside the CLI's run
        label = "warm clahe auto"
        argv, _ = DRIVEN[label]
        cli_out = work / "gui_cli" / "clahe_auto.jpg"
        cli_out.parent.mkdir()
        wall, cli_counts, _ = _drive(f"gui cli {label}", argv, cli_out)
        walls["cli clahe auto"] = wall
        if cli_out.read_bytes() != blob:
            raise AssertionError(f"{label}: the CLI's JPEG differs from the "
                                 "slice phase's")
        cursor = gui.get("/api/logs?since=0")["next"]
        outs = {}
        for run in ("first", "traced"):
            out = work / f"gui_{run}" / "clahe_auto.jpg"
            out.parent.mkdir()
            trace_dir = work / "gui_trace"
            state = _gui_state(argv, out)
            torch.cuda.reset_peak_memory_stats()
            if run == "traced":
                with profiling.trace(str(trace_dir), device=DEVICE):
                    result, counts, _ = run_job(f"{label} ({run})", state)
            else:
                result, counts, _ = run_job(f"{label} ({run})", state)
            if not result["ok"] or result["output"] != str(out):
                raise AssertionError(f"{label}: {result}")
            _check_gui_launches(label, counts, cli_counts, PATHS[label])
            outs[run] = _outputs(out)
            _same_files(label, outs[run], _outputs(cli_out))
            walls[f"gui clahe auto ({run})"] = result["elapsed_s"]
            if run == "first":
                launched["single"] = counts
                ctype, preview = gui.call("/api/preview")
                if ctype != "image/jpeg" or preview != blob:
                    raise AssertionError(f"{label}: preview {ctype} is not "
                                         "the JPEG")
                events = gui.get(f"/api/logs?since={cursor}")["events"]
                messages = [e["message"] for e in events]
                if not any(m.startswith("Warping to target CRS")
                           for m in messages):
                    raise AssertionError(f"{label}: the log holds "
                                         f"{messages[:8]}")
                log(f"gui: {label} log: {len(events)} events since cursor "
                    f"{cursor}, e.g. {messages[:3]}")
        mem = profiling.device_memory_stats(DEVICE)
        log(f"gui: {label} device_memory_stats {mem}, "
            f"max_memory_allocated {torch.cuda.max_memory_allocated()} "
            f"(traced job)")
        if mem["peak_bytes_in_use"] != torch.cuda.max_memory_allocated():
            raise AssertionError(f"{label}: memory stats {mem}")
        named = _trace_kernels(trace_dir)
        log(f"gui: {label} traced job: kernels named in the trace {named}")
        for k in PATHS[label]:
            if named[k] <= 0:
                raise AssertionError(f"{label}: the trace names no {k} "
                                     f"kernel ({named})")

        # 3. the exact 100 MP CLAHE TIFF (the CLI's defaults), its preview
        label = "exact full clahe tiff"
        argv, exact_out = DRIVEN[label]
        cli_wall, cli_counts = DRIVE_LOG[label]
        walls["cli exact full clahe tiff"] = cli_wall
        out = work / "gui_exact" / "full_clahe.tiff"
        out.parent.mkdir()
        result, counts, _ = run_job(label, _gui_state(argv, out))
        if not result["ok"]:
            raise AssertionError(f"{label}: {result}")
        _check_gui_launches(label, counts, cli_counts, PATHS[label])
        launched["exact"] = counts
        walls["gui exact full clahe tiff"] = result["elapsed_s"]
        band = TiffReader(out).read(1)
        if not np.array_equal(band, TiffReader(exact_out).read(1)):
            raise AssertionError(f"{label}: the band differs from the CLI's")
        t0 = time.perf_counter()
        ctype, preview = gui.call("/api/preview")
        walls["preview 100 MP tiff"] = time.perf_counter() - t0
        step = -(-max(band.shape) // 1024)
        sub = band[::step, ::step].astype(np.float32)
        lo, hi = float(sub.min()), float(sub.max())
        want = np.clip((sub - lo) / (hi - lo) * 255.0 + 0.5, 0,
                       255).astype(np.uint8)
        got, _ = png.decode(preview)
        if ctype != "image/png" or not np.array_equal(got[..., 0], want):
            raise AssertionError(f"{label}: the preview ({ctype}) is not "
                                 f"the [::{step}, ::{step}] render")
        log(f"gui: {label} preview {got.shape[1]}x{got.shape[0]} PNG "
            f"({len(preview)} bytes) equal to the [::{step}, ::{step}] "
            f"min-max render, {walls['preview 100 MP tiff'] * 1e3:.1f} ms "
            f"over HTTP")

        # 4. the Tamed cubic batch, pipelined (prefetch 2), beside the CLI
        label, args, _, _ = BATCH_RUNS[1]
        args = [str(SIZE) if a == "SIZE" else a for a in args]
        d = work / "batch_in"
        cli_dir = work / "gui_cli_batch"
        cli_wall, counters, cli_counts, _ = _batch_cli(
            ["--input-dir", str(d), "--output-dir", str(cli_dir)] + args
            + ["--prefetch", "2"])
        walls["cli batch tamed cubic"] = cli_wall
        want_files = _files(work / f"{label.replace(' ', '_')}_pipelined")
        _same_files(f"{label} CLI", _files(cli_dir), want_files)
        out_dir = work / "gui_batch"
        params = _gui_state(["-i", "unused"] + args, out_dir)
        result, counts, seen = run_job(label, {
            "mode": "batch", "input_dir": str(d), "output_dir": str(out_dir),
            "prefetch": 2, "fast": True, "params": params["params"]})
        report = {"processed": 3, "skipped": 2, "errors": 1}
        if not result["ok"] or result.get("report") != report:
            raise AssertionError(f"{label}: {result}, expected {report}")
        if counters != (3, 2, 1):
            raise AssertionError(f"{label}: the CLI counted {counters}")
        _check_gui_launches(label, counts, cli_counts,
                            ("histogram", "resample_axis0", "synrgb_lookup"))
        launched["batch"] = counts
        _same_files(label, _files(out_dir), want_files)
        last = srv.worker.progress
        if last is None or last["total"] != 6 or last["done"] != 6:
            raise AssertionError(f"{label}: progress {last}")
        walls["gui batch tamed cubic"] = result["elapsed_s"]
        log(f"gui: {label} report {result['report']}, progress seen by "
            f"{len(seen)} polls {seen[:2]}..., last {last}; files equal "
            "to the batch phase's pipelined run and the CLI's")

        # 5. a sharded job, exact mode asked: fast mode over the card's
        # devices; on one card the unsharded route with the JAX package's
        # warning, the CLI's launches, and on any count the CLI's files
        label = "gui shard clahe auto"
        out = work / "gui_shard" / "clahe_auto.jpg"
        out.parent.mkdir()
        cursor = gui.get("/api/logs?since=0")["next"]
        result, counts, _ = run_job(label, dict(
            _gui_state(DRIVEN["warm clahe auto"][0], out), shard_devices=2,
            fast=False))
        if not result["ok"] or result["output"] != str(out):
            raise AssertionError(f"{label}: {result}")
        _same_files(label, _outputs(out), _outputs(cli_out))
        messages = [e["message"] for e in
                    gui.get(f"/api/logs?since={cursor}")["events"]]
        if torch.cuda.device_count() == 1:  # the CLI's, as step 2's job
            _check_gui_launches(label, counts, launched["single"],
                                PATHS["warm clahe auto"])
            if ONE_DEVICE_WARNING % 2 not in messages:
                raise AssertionError(f"{label}: no one-device warning in "
                                     f"{messages[:8]}")
        launched["shard"] = counts
        log(f"gui: {label}: {result}, files equal to the CLI's --fast run")

        # 6. the root's SafeReader on the card: the EW pair decimated on
        # read, as open_pair reads it
        import sarpro_tpu_torch

        reader = sarpro_tpu_torch.SafeReader.open_with_options(
            ew, "all_pairs", target_size=SIZE, device=DEVICE)
        pair = tsafe.open_pair(ew, DEVICE, "Multiband", SIZE)
        for got, want in ((reader.hh_data(), pair.band1),
                          (reader.hv_data(), pair.band2)):
            if got.device.type != torch.device(DEVICE).type or not \
                    torch.equal(got, want.to(torch.float32)):
                raise AssertionError("SafeReader: the bands differ from "
                                     "open_pair's")
        log(f"gui: SafeReader all_pairs at {SIZE}: "
            f"{reader.get_available_polarizations()} on {got.device}, equal "
            "to open_pair's bands")
        del reader, pair
    finally:
        torch.Tensor.to = real_to
        for mod, real in saved:
            mod.use_kernel = real
        tsafe.datetime = real_clock
        tsafe._parse_comprehensive_cached.cache_clear()
        sarpro_log.setLevel(level)
        srv.shutdown()
        srv.server_close()
        serving.join(10)
    log(f"gui: {gui.polls} polls of /api/state; jobs on threads "
        f"{[t.name for t in job_threads]}")
    log("gui: walls " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                                  for k, v in walls.items()) + f" on {smi}")
    totals = {k: sum(c[k] for c in launched.values()) for k in KERNELS}
    return totals, walls


def _shard_cli(work: Path, n_cards: int, messages: list) -> None:
    """Part 1 of the shard phase: the headline CLAHE auto-UTM 2048 JPEG and
    the 100 MP CLAHE TIFF through the CLI with a shard request (2 and -1
    with --fast, 2 without: exact mode asked), each file byte-equal to the
    --fast run's; on one card with the JAX package's one-device warning and
    the --fast run's launches."""
    d = work / "shard"
    d.mkdir()
    for name, driven in (("headline", "warm clahe auto"),
                         ("100 MP", "full clahe tiff")):
        argv, first = DRIVEN[driven]
        argv = [a for a in argv if a != "--fast"]
        stem = name.replace(" ", "_")
        ref = d / f"{stem}_fast{first.suffix}"
        _, want, _ = _drive(f"shard {name} --fast", argv + ["--fast"], ref)
        for i, extra in enumerate((["--fast", "--shard-devices", "2"],
                                   ["--fast", "--shard-devices", "-1"],
                                   ["--shard-devices", "2"])):
            label = f"shard {name} {' '.join(extra)}"
            out = d / f"{stem}_{i}{first.suffix}"
            del messages[:]
            wall, counts, _ = _drive(label, argv + extra, out)
            _same_files(label, _outputs(out), _outputs(ref))
            if n_cards == 1:
                req = "all" if extra[-1] == "-1" else extra[-1]
                if ONE_DEVICE_WARNING % req not in messages:
                    raise AssertionError(f"{label}: no one-device warning in "
                                         f"{messages[:6]}")
                if counts != want:
                    raise AssertionError(f"{label}: launches {counts}, the "
                                         f"--fast run's {want}")
            log(f"shard: {label}: files byte-equal to --fast, launches "
                f"{ {k: v for k, v in counts.items() if v} }")


def _warm_ms(fn) -> float:
    """Device ms between CUDA events of one more call of `fn`, with the
    caching allocator holding the blocks of the call before (`_peak_run`
    empties it first)."""
    import torch

    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _shard_run(label: str, fn, want, expected: dict, totals: dict) -> tuple:
    """One sharded call with the launch counts set to 0 just before it and
    read just after: bit-equal to `want` (the unsharded result), launching
    exactly `expected`; then one warm call. (device ms cold, warm, device
    peak MiB)."""
    import torch

    from sarpro_tpu_torch import ops

    ops.reset_launch_counts()
    got, ms, wall, peak = _peak_run(fn)
    counts = ops.launch_counts()
    for k, v in counts.items():
        totals[k] += v
    if got.dtype == torch.uint16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    _check_equal(got, want, f"shard: {label} vs unsharded")
    launched = {k: v for k, v in counts.items() if v}
    if launched != expected:
        raise AssertionError(f"shard: {label}: launches {launched}, expected "
                             f"{expected}")
    del got
    warm = _warm_ms(fn)
    log(f"shard: {label}: bit-equal to the unsharded run, launches "
        f"{launched}, {ms:.3f} ms on the device (host {wall:.1f} ms; warm "
        f"{warm:.3f}), peak {peak:.0f} MiB")
    return ms, warm, peak


def _unsharded_run(label: str, fn):
    """(result, device ms cold, warm, peak MiB) of the unsharded side."""
    got, ms, wall, peak = _peak_run(fn)
    warm = _warm_ms(fn)
    log(f"shard: {label} unsharded: {ms:.3f} ms on the device (host "
        f"{wall:.1f} ms; warm {warm:.3f}), peak {peak:.0f} MiB")
    return got, ms, warm, peak


def _shard_mesh_runs(safe: Path, ew: Path, devices: list, what: str,
                     totals: dict) -> None:
    """Part 2 of the shard phase on a mesh of `devices` (the card repeated,
    or the cards there are): the sharded programs, the streamed mesh mode
    and the sharded warp, each bit-equal to its unsharded run on the card,
    with its launches: the per-shard kernels x n."""
    import torch

    from sarpro_tpu_torch.core import fused, streamed
    from sarpro_tpu_torch.io import safe as tsafe
    from sarpro_tpu_torch.io import warp as twarp
    from sarpro_tpu_torch.ops import warp_kernel
    from sarpro_tpu_torch.parallel import mesh as pmesh
    from sarpro_tpu_torch.parallel import sharded
    from sarpro_tpu_torch.parallel import warp as pwarp

    S, B = fused.AutoscaleStrategy, fused.BitDepth
    n = len(devices)
    mesh = pmesh.make_mesh(devices=devices, shape=(1, n))
    half = pmesh.make_mesh(devices=devices[:2], shape=(1, 2))
    tag = f"{what}, {n}-way"

    # the 100 MP EW pair at original size
    pair = tsafe.open_pair(ew, DEVICE, "Multiband")
    band = pair.band1
    want, ms0, warm0, peak0 = _unsharded_run(
        "100 MP gray clahe u8", lambda: fused.grayscale_pipeline(band,
                                                                 S.CLAHE))
    ms, warm, peak = _shard_run(
        f"100 MP gray clahe u8 ({tag})",
        lambda: sharded.grayscale_batch(band[None], mesh, S.CLAHE)[0], want,
        {"histogram": n, "tile_histogram": n, "clahe_lookup": n}, totals)
    log(f"shard: 100 MP gray clahe u8 device ms {ms:.3f} (warm {warm:.3f}) "
        f"sharded {n}-way ({what}) against {ms0:.3f} (warm {warm0:.3f}) "
        f"unsharded, peak {peak:.0f} against {peak0:.0f} MiB")
    want, *_ = _unsharded_run("100 MP gray adaptive u16", lambda:
                                fused.grayscale_pipeline(band, S.ADAPTIVE,
                                                         B.U16))
    _shard_run(f"100 MP gray adaptive u16 ({tag})",
               lambda: sharded.grayscale_batch(band[None], mesh, S.ADAPTIVE,
                                               B.U16)[0], want,
               {"histogram": n}, totals)
    # 9996 rows: tiles of 1250 rows, row blocks of 2499 (4-way) and 4998
    # (2-way), so a CLAHE tile straddles every block boundary
    b1, b2 = pair.band1[:EW_SIDE - 4], pair.band2[:EW_SIDE - 4]
    want, *_ = _unsharded_run("100 MP synrgb clahe", lambda:
                                fused.synrgb_pipeline(b1, b2, S.CLAHE, None))
    for m in (mesh, half):
        k = m.shape["row"]
        _shard_run(f"100 MP synrgb clahe, tiles across blocks ({what}, "
                   f"{k}-way)",
                   lambda: sharded.synrgb_batch(b1[None], b2[None], m,
                                                S.CLAHE, None)[0], want,
                   {"histogram": 3 * k, "tile_histogram": 2 * k,
                    "clahe_lookup": 2 * k, "synrgb_lookup": k}, totals)
    del pair, band, b1, b2, want
    torch.cuda.empty_cache()

    # the 400 MP pair: the resample + pad 2048 config, and one band through
    # the streamed mesh mode
    scene = tsafe.open_dual_pol(safe, DEVICE)
    vv, vh = scene.band1, scene.band2
    kw = dict(strategy=S.CLAHE, target_size=SIZE, pad=True,
              channel_order="dct")
    want, *_ = _unsharded_run("400 MP synrgb clahe 2048 pad", lambda:
                                fused.synrgb_pipeline(vv, vh, **kw))
    _shard_run(f"400 MP synrgb clahe 2048 pad ({tag})",
               lambda: sharded.synrgb_batch(vv[None], vh[None], mesh,
                                            **kw)[0], want,
               {"resample_axis0": 2 * (n + 1), "histogram": 3,
                "tile_histogram": 2, "clahe_lookup": 2, "synrgb_lookup": 1},
               totals)
    want, ms0, warm0, peak0 = _unsharded_run(
        "400 MP streamed clahe u8", lambda: streamed.grayscale_streamed(
            vv, S.CLAHE))
    local = SIDE // n
    k = len(streamed._chunk_starts(local, min(streamed.CHUNK_ROWS, local)))
    ms, warm, peak = _shard_run(
        f"400 MP streamed clahe u8 ({tag})",
        lambda: streamed.grayscale_streamed(vv, S.CLAHE, mesh=mesh), want,
        {"histogram": k * n, "tile_histogram": k * n,
         "clahe_lookup": k * n}, totals)
    log(f"shard: 400 MP streamed band device ms {ms:.3f} (warm {warm:.3f}) "
        f"in the {n}-way mesh mode ({what}) against {ms0:.3f} (warm "
        f"{warm0:.3f}) unsharded, peak {peak:.0f} against {peak0:.0f} MiB")
    del scene, vv, vh, want
    torch.cuda.empty_cache()

    # the headline warp, 2380^2 -> 2048^2 with NaN nodes, over the mesh and
    # over 3 blocks (683, 683 and a ragged 682 rows)
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(1)
    src = torch.exp(torch.randn((MID, MID), device=dev, generator=g) * 1.1
                    + 5.0)
    mx, my = warp_grid(MID, SIZE)
    mx[3, 5] = my[10, 10] = float("nan")
    gx, gy = twarp.plan_grids_to_device(mx, my, dev)
    third = pmesh.make_mesh(devices=(devices * 3)[:3], shape=(1, 3))
    for method in warp_kernel.METHODS:
        want = warp_kernel.warp_sample(src, gx, gy, SIZE, SIZE, method)
        for m in (mesh, third):
            k = m.shape["row"]
            _shard_run(f"warp {method} {MID}^2 -> {SIZE}^2 ({what}, "
                       f"{k}-way)",
                       lambda: pwarp.warp_sample_sharded(
                           src, mx, my, SIZE, SIZE, method, m), want,
                       {"warp_sample": k}, totals)


def phase_shard(safe: Path, ew: Path, work: Path) -> dict:
    """The shard phase: the CLI's shard requests on the card(s) there are
    (`_shard_cli`), then every sharded program on a virtual mesh of the card
    repeated 4 times (`_shard_mesh_runs`), and on the real cards where
    there are 2 or more. Returns each kernel's launches in the mesh runs."""
    import logging

    import torch

    from sarpro_tpu_torch.io import safe as tsafe

    n_cards = torch.cuda.device_count()
    messages: list = []
    handler = logging.Handler()
    handler.emit = lambda r: messages.append(r.getMessage())
    sarpro_log = logging.getLogger("sarpro")
    level = sarpro_log.level
    sarpro_log.addHandler(handler)
    sarpro_log.setLevel(logging.INFO)
    real_clock = tsafe.datetime
    tsafe.datetime = _FixedClock
    tsafe._parse_comprehensive_cached.cache_clear()
    totals = {k: 0 for k in KERNELS}
    try:
        _shard_cli(work, n_cards, messages)
    finally:
        tsafe.datetime = real_clock
        tsafe._parse_comprehensive_cached.cache_clear()
        sarpro_log.removeHandler(handler)
        sarpro_log.setLevel(level)
    _shard_mesh_runs(safe, ew, [torch.device(DEVICE)] * 4, "one card",
                     totals)
    if n_cards >= 2:
        cards = [torch.device("cuda", i) for i in range(min(n_cards, 4))]
        _shard_mesh_runs(safe, ew, cards, f"{len(cards)} cards", totals)
    else:
        log("shard: one card: the copies between cards went unchecked")
    log(f"shard: launches in the mesh runs {totals}")
    return totals


def _host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it: its model name, or where a
    virtual machine reports none, its vendor, family, model and stepping;
    with the count of CPUs this process sees."""
    import os
    import platform

    fields: dict = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, sep, value = line.partition(":")
            if sep and key.strip() not in fields:
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    name = fields.get("model name", "")
    if not name or name.lower() == "unknown":
        name = " ".join(f"{k} {fields[k]}" for k in (
            "vendor_id", "cpu family", "model", "stepping") if k in fields)
    return f"{name or platform.machine()} ({os.cpu_count()} CPUs)"


def _raster_inputs(work: Path, band, synrgb: Path) -> dict:
    """The rasters phase's files, written without Pillow: the 80 MP band as
    a q100 gray JPEG (the port's native coder) with .jgw and .prj, as a
    24-bit BMP, a P5 PGM of maxval 4095 from its top-left corner, and the
    headline route's 2048 synRGB JPEG. name -> (path, the array the decode
    must hold (None: the composed RGB), the largest |difference| allowed,
    geotransform and EPSG where sidecars were written)."""
    import numpy as np

    from sarpro_tpu_torch.io.writers import jpeg as wjpeg
    from sarpro_tpu_torch.io.writers.worldfile import (
        write_prj_file,
        write_world_file,
    )

    d = work / "rasters"
    d.mkdir()
    rows, cols = band.shape
    gt = [500000.0, 10.0, 0.0, 5100000.0, 0.0, -10.0]
    files = {}
    t0 = time.perf_counter()
    jpg = d / "band.jpg"
    wjpeg.write_gray_jpeg(jpg, cols, rows, band)
    write_world_file(jpg, gt)
    write_prj_file(jpg, "EPSG:32632")
    files["gray jpeg 80 MP"] = (jpg, band, GRAY_Q100_ROUNDTRIP, gt, 32632)
    bmp = d / "band.bmp"
    stride = (cols * 3 + 3) & ~3
    head = (b"BM" + struct.pack("<IHHI", 54 + stride * rows, 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, cols, rows, 1, 24, 0,
                          stride * rows, 2835, 2835, 0, 0))
    px = np.zeros((rows, stride), np.uint8)
    px[:, :3 * cols] = np.repeat(band[::-1], 3, axis=1)
    with open(bmp, "wb") as fh:
        fh.write(head)
        fh.write(px.data)
    del px
    files["bmp 80 MP"] = (bmp, band, 0, None, None)
    dn = band[:PGM_ROWS, :PGM_COLS].astype(np.uint16) * 16 + 15
    pgm = d / "corner.pgm"
    pgm.write_bytes(f"P5\n{PGM_COLS} {PGM_ROWS}\n{PGM_MAXVAL}\n".encode()
                    + dn.astype(">u2").tobytes())
    # Pillow's PpmDecoder: min(65535, round(v / maxval * 65535)), as u16
    want = np.minimum(65535, np.rint(dn / PGM_MAXVAL * 65535)).astype(
        np.uint16)
    files["pgm maxval 4095"] = (pgm, want, 0, None, None)
    files["synrgb jpeg 2048"] = (synrgb, None, SYNRGB_Q100_ROUNDTRIP + 1,
                                 None, None)
    log(f"rasters: wrote the inputs in {time.perf_counter() - t0:.1f} s")
    return files


def j2k_band_tile(seed: int = J2K_BAND_SEED, side: int = 512):
    """The u16 tile of the JPEG 2000 band: make_safe's VV DN (lognormal,
    2 % zeros) from `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dn = np.clip(rng.lognormal(5.0, 1.1, (side, side)), 0, 65535).astype(
        np.uint16)
    dn[rng.random((side, side)) < 0.02] = 0
    return dn


def j2k_rgb_tile(seed: int = J2K_RGB_SEED, side: int = 256):
    """The u8 RGB tile of the JPEG 2000 colour band: gradients and gamma
    speckle from `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:side, 0:side]
    base = np.stack([(x + y) % 256, (2 * x) % 256, 255 - y % 256], -1)
    return np.clip(0.6 * base + rng.gamma(4.0, 8.0, (side, side, 3)), 0,
                   255).astype(np.uint8)


def j2k_sycc_tile(seed: int = J2K_SYCC_SEED, side: int = 256):
    """The u8 Y, Cb and Cr planes of the sYCC tile at full resolution (the
    encoder keeps every second Cb and Cr sample each way): a quick-look
    scene's luma (gradients and gamma speckle) and smooth chroma, from
    `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:side, 0:side]
    luma = 40 + 0.6 * ((x + 2 * y) % 256) + rng.gamma(4.0, 6.0, (side, side))
    cb = 128 + 40 * np.sin(x / 37.0) * np.cos(y / 53.0)
    cr = 128 + 35 * np.cos((x + y) / 41.0) + rng.normal(0, 2, (side, side))
    return np.clip(np.stack([luma, cb, cr], -1), 0, 255).astype(np.uint8)


def j2k_deep_tile(seed: int = J2K_DEEP_SEED, side: int = 256):
    """The 20-bit amplitude tile: lognormal speckle over a smooth field,
    2 % zeros, clipped to 2^20 - 1, from `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:side, 0:side]
    field = 9.5 + 1.5 * np.sin(x / 29.0) * np.cos(y / 31.0)
    amp = np.exp(field + rng.normal(0.0, 0.9, (side, side)))
    amp = np.clip(amp, 0, (1 << 20) - 1).astype(np.int32)
    amp[rng.random((side, side)) < 0.02] = 0
    return amp


def j2k_splice(code: bytes, nx: int, ny: int) -> bytes:
    """A codestream of nx x ny tiles from one whose image is one tile, or
    one row of k tiles, at the origin: SIZ's image size made nx x ny
    tiles, tile i the tile-parts of tile i % k with their tile index
    renumbered, then EOC. The tile's sides must be multiples of every
    component's sub-sampling, so each tile holds the same samples."""
    x, y, xo, yo, xt, yt, xto, yto = struct.unpack_from(">8I", code, 8)
    k = x // xt if xt else 0
    if (xo, yo, xto, yto) != (0, 0, 0, 0) or y != yt or k < 1 or x != k * xt:
        raise ValueError("the codestream is not one tile, or one row of "
                         "tiles, at the origin")
    for c in range(struct.unpack_from(">H", code, 40)[0]):
        dx, dy = code[43 + 3 * c], code[44 + 3 * c]
        if xt % dx or yt % dy:
            raise ValueError(f"a tile of {xt} x {yt} is not a multiple of "
                             f"component {c}'s sub-sampling {dx} x {dy}")
    pos = 2
    while struct.unpack_from(">H", code, pos)[0] != 0xFF90:
        pos += 2 + struct.unpack_from(">H", code, pos + 2)[0]
    head = bytearray(code[:pos])
    parts = [[] for _ in range(k)]
    while struct.unpack_from(">H", code, pos)[0] == 0xFF90:
        isot, psot = struct.unpack_from(">HI", code, pos + 4)
        if isot >= k or psot < 14:
            raise ValueError("a tile-part of no tile of the row, or of no "
                             "length")
        parts[isot].append(code[pos:pos + psot])
        pos += psot
    if code[pos:] != b"\xff\xd9" or not all(parts):
        raise ValueError("the codestream is not its tiles' tile-parts and "
                         "EOC")
    struct.pack_into(">II", head, 8, xt * nx, yt * ny)
    out = []
    for i in range(nx * ny):
        for part in parts[i % k]:
            part = bytearray(part)
            struct.pack_into(">H", part, 4, i)
            out.append(bytes(part))
    return bytes(head) + b"".join(out) + b"\xff\xd9"


def jp2_wrap(code: bytes, width: int, height: int, bands: int, bits: int,
             enumcs: int) -> bytes:
    """A JP2 file around `code`: signature, ftyp, jp2h (ihdr, enumerated
    colr) and jp2c boxes."""
    def box(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I4s", 8 + len(data), kind) + data

    ihdr = struct.pack(">IIHBBBB", height, width, bands, bits - 1, 7, 0, 0)
    colr = struct.pack(">BBBI", 1, 0, 0, enumcs)
    return (box(b"jP  ", b"\r\n\x87\n")
            + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", box(b"ihdr", ihdr) + box(b"colr", colr))
            + box(b"jp2c", code))


def phase_jpeg2000(work: Path, smi: str) -> dict:
    """io/jpeg2000 on the card's machine: the spliced 84.9 MP u16 JP2s (the
    default coding, the HTJ2K one and the styled one), the 4096^2 RGB
    codestream, the
    4096^2 sYCC 4:2:0 JP2 and the 4096^2 JP2 of 20-bit amplitude opened
    through RasterReader (decode timed on the host clock, median of 3),
    held to their tiles, each band but the RGB one read decimated to
    2048^2 on the card (bit-equal to the plain resample) and saved as a
    CLAHE gray JPEG that reads back. Returns the launches of the driven
    reads and saves."""
    import hashlib

    import numpy as np
    import torch

    from sarpro_tpu_torch import _native, api, ops
    from sarpro_tpu_torch.io import jpeg2000, raster
    from sarpro_tpu_torch.io.writers.worldfile import write_prj_file
    from sarpro_tpu_torch.ops import force_plain
    from sarpro_tpu_torch.types import (
        AutoscaleStrategy,
        BitDepth,
        OutputFormat,
    )

    _native.raster_decoder()  # built in phase_build; raises if it did not
    d = work / "jpeg2000"
    d.mkdir()
    tile = j2k_band_tile()
    band_code = (J2K_DIR / J2K_BAND).read_bytes()
    if not np.array_equal(jpeg2000.read(band_code).array, tile):
        raise AssertionError("jpeg2000: the u16 tile does not decode to its "
                             "seeded DN")
    side = tile.shape[0] * J2K_BAND_TILES
    band_path = d / "band.jp2"
    band_path.write_bytes(jp2_wrap(
        j2k_splice(band_code, J2K_BAND_TILES, J2K_BAND_TILES), side, side, 1,
        16, 17))
    gt = [500000.0, 10.0, 0.0, 5100000.0, 0.0, -10.0]
    band_path.with_suffix(".j2w").write_text(
        "10.0\n0.0\n0.0\n-10.0\n500005.0\n5099995.0\n")
    write_prj_file(band_path, "EPSG:32632")
    # the same band with HT code-blocks: the tile's own decode is lossless
    ht_code = (J2K_HT_DIR / J2K_HT).read_bytes()
    ht_tile = jpeg2000.read(ht_code).array
    digest = hashlib.sha256(ht_tile.tobytes()).hexdigest()
    if digest != J2K_HT_SHA256 or not np.array_equal(ht_tile, tile):
        raise AssertionError(f"jpeg2000: the HT tile decodes to SHA-256 "
                             f"{digest}, Pillow's is {J2K_HT_SHA256} (the "
                             f"seeded DN)")
    ht_path = d / "ht.jp2"
    ht_path.write_bytes(jp2_wrap(
        j2k_splice(ht_code, J2K_BAND_TILES, J2K_BAND_TILES), side, side, 1,
        16, 17))
    styled_code = (J2K_DIR / J2K_STYLED).read_bytes()
    styled = jpeg2000.read(styled_code).array
    digest = hashlib.sha256(styled.tobytes()).hexdigest()
    if digest != J2K_STYLED_SHA256 or not np.array_equal(
            styled, np.tile(tile, (1, 2))):
        raise AssertionError(f"jpeg2000: the styled codestream decodes to "
                             f"SHA-256 {digest}, Pillow's is "
                             f"{J2K_STYLED_SHA256} (the seeded tile twice)")
    styled_path = d / "styled.jp2"
    styled_path.write_bytes(jp2_wrap(
        j2k_splice(styled_code, J2K_BAND_TILES, J2K_BAND_TILES), side, side,
        1, 16, 17))
    for path in (styled_path, ht_path):
        path.with_suffix(".j2w").write_bytes(
            band_path.with_suffix(".j2w").read_bytes())
        write_prj_file(path, "EPSG:32632")
    rgb_code = (J2K_DIR / J2K_RGB).read_bytes()
    rgb_tile = jpeg2000.read(rgb_code).array
    digest = hashlib.sha256(rgb_tile.tobytes()).hexdigest()
    if digest != J2K_RGB_SHA256:
        raise AssertionError(f"jpeg2000: the RGB tile decodes to SHA-256 "
                             f"{digest}, Pillow's is {J2K_RGB_SHA256}")
    rgb_path = d / "rgb.j2k"
    rgb_path.write_bytes(j2k_splice(rgb_code, J2K_RGB_TILES, J2K_RGB_TILES))
    # the sYCC 4:2:0 and 20-bit tiles, each in its JP2, spliced to 4096^2;
    # each tile's own decode has the SHA-256 of Pillow's
    sub_tiles = {}
    for name, fname, pinned, bands, bits, enumcs in (
            ("sycc 4:2:0 9/7 16.8 MP", J2K_SYCC, J2K_SYCC_SHA256, 3, 8, 18),
            ("u16 of 20-bit band 16.8 MP", J2K_DEEP, J2K_DEEP_SHA256, 1, 20,
             17)):
        code = (J2K_DIR / fname).read_bytes()
        n = struct.unpack_from(">I", code, 8)[0]
        sub_tile = jpeg2000.read(jp2_wrap(code, n, n, bands, bits,
                                          enumcs)).array
        digest = hashlib.sha256(sub_tile.tobytes()).hexdigest()
        if digest != pinned:
            raise AssertionError(f"jpeg2000: the {name} tile decodes to "
                                 f"SHA-256 {digest}, Pillow's is {pinned}")
        path = d / (fname.split(".")[0] + ".jp2")
        path.write_bytes(jp2_wrap(
            j2k_splice(code, J2K_SUB_TILES, J2K_SUB_TILES),
            n * J2K_SUB_TILES, n * J2K_SUB_TILES, bands, bits, enumcs))
        sub_tiles[name] = (path, sub_tile if sub_tile.ndim == 3
                           else sub_tile[..., None])
    cpu = _host_cpu()
    totals = {k: 0 for k in ops.launch_counts()}
    decode_ms, decode_mps = {}, {}
    for name, path in (("u16 band 84.9 MP", band_path),
                       ("u16 styled band 84.9 MP", styled_path),
                       ("u16 HTJ2K band 84.9 MP", ht_path),
                       ("rgb 9/7 16.8 MP", rgb_path),
                       *((k, v[0]) for k, v in sub_tiles.items())):
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            reader = raster.RasterReader(path)
            walls.append(time.perf_counter() - t0)
        data = reader._tiff._data
        md = reader.metadata
        if name in sub_tiles:
            want = np.tile(sub_tiles[name][1],
                           (J2K_SUB_TILES, J2K_SUB_TILES, 1))
            if data.dtype != want.dtype or not np.array_equal(data, want):
                raise AssertionError(f"jpeg2000: {name}: the decode is not "
                                     f"np.tile of its tile's")
            log(f"jpeg2000: {name}: SHA-256 of the decode "
                f"{hashlib.sha256(data.tobytes()).hexdigest()}, np.tile of "
                f"the tile's, whose SHA-256 is Pillow's")
        elif name.startswith("u16"):
            want = np.tile(tile, (J2K_BAND_TILES, J2K_BAND_TILES))[..., None]
            if md.geotransform != gt or md.epsg != 32632:
                raise AssertionError(f"jpeg2000: {name}: geotransform "
                                     f"{md.geotransform}, EPSG {md.epsg}")
            if data.dtype != want.dtype or not np.array_equal(data, want):
                raise AssertionError(f"jpeg2000: {name}: the decode is not "
                                     f"np.tile of its seeded tile")
        else:
            n = rgb_tile.shape[0]
            want = np.tile(rgb_tile, (J2K_RGB_TILES, J2K_RGB_TILES, 1))
            if data.shape != want.shape or not np.array_equal(data, want):
                bad = [(i, j) for i in range(J2K_RGB_TILES)
                       for j in range(J2K_RGB_TILES)
                       if not np.array_equal(
                           data[i * n:(i + 1) * n, j * n:(j + 1) * n],
                           rgb_tile)]
                raise AssertionError(f"jpeg2000: {name}: tiles {bad[:8]} "
                                     f"differ from the tile's decode")
        wall = statistics.median(walls)
        decode_ms[name] = wall * 1e3
        mb = path.stat().st_size / 1e6
        mp = md.size_x * md.size_y / 1e6
        decode_mps[name] = mp / wall
        log(f"jpeg2000: {name} ({mb:.1f} MB, {data.dtype} "
            f"{tuple(data.shape)}): decode {wall * 1e3:.1f} ms (host clock, "
            f"median of 3; {', '.join(f'{w * 1e3:.1f}' for w in walls)}), "
            f"{mp / wall:.1f} MP/s, {mb / wall:.1f} MB/s, equal to its "
            f"tiles; {_native._threads()} decoder threads on host CPU {cpu}")
        if "styled" in name or "HTJ2K" in name:
            base = decode_ms["u16 band 84.9 MP"]
            which = "styled" if "styled" in name else "HTJ2K"
            log(f"jpeg2000: the {which} band decodes in {wall * 1e3:.1f} ms "
                f"against the default (Part-1) band's {base:.1f} ms in this "
                f"call ({wall * 1e3 / base:.3f} x; {mp / wall:.1f} against "
                f"{decode_mps['u16 band 84.9 MP']:.1f} MP/s; host clock, "
                f"medians of 3)")
        new = name in sub_tiles
        # the bands held to exact launch counts: two resamples, one of
        # each CLAHE kernel
        exact = new or "HTJ2K" in name
        if new:
            base = "u16 band 84.9 MP"
            log(f"jpeg2000: the {name} decodes at {mp / wall:.1f} MP/s "
                f"({wall * 1e3:.1f} ms) against the default band's "
                f"{decode_mps[base]:.1f} MP/s ({decode_ms[base]:.1f} ms) in "
                f"this call (host clock, medians of 3)")
        if name.startswith("rgb"):
            reader.close()
            del reader, data
            continue
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        dev = raster.read_band_resampled_to_device(reader, 1, SIZE, SIZE,
                                                   DEVICE, "cubic")
        end.record()
        end.synchronize()
        read_ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        if counts["resample_axis0"] <= 0 or (
                ("styled" in name or exact) and counts["resample_axis0"] != 2):
            raise AssertionError(f"jpeg2000: {name}: the decimated read "
                                 f"launched {counts['resample_axis0']} "
                                 f"resamples ({counts})")
        for k, v in counts.items():
            totals[k] += v
        with force_plain():
            plain = raster.read_band_resampled_to_device(
                reader, 1, SIZE, SIZE, DEVICE, "cubic")
        _check_equal(dev, plain, f"jpeg2000: {name} resample vs plain")
        log(f"jpeg2000: {name}: cubic read to {SIZE}^2 "
            f"{start.elapsed_time(end):.3f} ms between CUDA events "
            f"({read_ms:.1f} ms host), launches "
            f"{ {k: v for k, v in counts.items() if v} }, bit-equal to the "
            f"plain resample; on {smi}")
        reader.close()
        del reader, data, plain
        out = d / "clahe_gray.jpg"
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        api.save_image(dev + 1.0, out, OutputFormat.JPEG, BitDepth.U8,
                       autoscale=AutoscaleStrategy.CLAHE, device=DEVICE)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for k in ("histogram", "tile_histogram", "clahe_lookup"):
            if counts[k] <= 0 or (exact and counts[k] != 1):
                raise AssertionError(f"jpeg2000: the CLAHE gray save "
                                     f"launched no {k} ({counts})")
        for k, v in counts.items():
            totals[k] += v
        back = raster.RasterReader(out)
        if (back.metadata.size_x, back.metadata.size_y,
                back.metadata.bands) != (SIZE, SIZE, 1):
            raise AssertionError(f"jpeg2000: the CLAHE gray JPEG reads back "
                                 f"as {back.metadata}")
        log(f"jpeg2000: api.save_image CLAHE gray JPEG of the {name}'s "
            f"{SIZE}^2 read: {wall * 1e3:.1f} ms (host clock), launches "
            f"{ {k: v for k, v in counts.items() if v} }, read back "
            f"{SIZE} x {SIZE} x 1")
        del dev
    shutil.rmtree(d, ignore_errors=True)
    return totals


def jpeg_splice(blob: bytes, rows: int) -> bytes:
    """A JPEG `rows` tall from a single-scan strip whose restart intervals
    each code the same number of whole rows (an MCU row of a DCT frame, a
    row of a lossless one): the strip's intervals over and over, the RST
    markers renumbered, the frame's height set to `rows`. Every interval
    starts the coder, the predictions and (arithmetic) the statistics
    afresh, so the decode is the strip's, tiled down to `rows`."""
    import re

    sof = re.search(rb"\xff[\xc0-\xc3\xc9-\xcb]", blob).start()
    sos = blob.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(blob[sos + 2:sos + 4], "big")
    end = blob.rindex(b"\xff\xd9")
    intervals = re.split(rb"\xff[\xd0-\xd7]", blob[start:end])
    height = int.from_bytes(blob[sof + 5:sof + 7], "big")
    per = height // len(intervals)
    if per * len(intervals) != height:
        raise ValueError(f"{height} rows in {len(intervals)} intervals")
    count = -(-rows // per)
    head = blob[:sof + 5] + rows.to_bytes(2, "big") + blob[sof + 7:start]
    body = bytearray()
    for k in range(count):
        if k:
            body += bytes([0xFF, 0xD0 + ((k - 1) & 7)])
        body += intervals[k % len(intervals)]
    return head + bytes(body) + b"\xff\xd9"


def webp_band(seed: int, rows: int, cols: int):
    """A SAR-like u8 band: single-look speckle (exponential intensity) over
    a smooth backscatter field, in dB scaled to u8, from `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 6.0, rows, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 9.0, cols, dtype=np.float32)[None, :]
    field = np.float32(0.05) + np.float32(0.04) * (np.sin(y) * np.cos(x) + 1)
    intensity = rng.standard_exponential((rows, cols), np.float32)
    intensity *= field
    np.maximum(intensity, np.float32(1e-6), out=intensity)
    db = np.log10(intensity)
    db *= np.float32(80.0)
    db += np.float32(200.0)
    return np.clip(db, 0, 255).astype(np.uint8)


def webp_rgba_tile(seed: int, rows: int, cols: int):
    """A u8 RGBA tile: gradients and gamma speckle, with alpha a smooth ramp
    that is 0 over a corner block, from `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:rows, 0:cols]
    base = np.stack([(x + y) % 256, (2 * x) % 256, 255 - y % 256], -1)
    rgb = np.clip(0.6 * base + rng.gamma(4.0, 8.0, (rows, cols, 3)), 0, 255)
    alpha = np.clip(64 + (x * 160) // cols + (y * 31) // rows, 0, 255)
    alpha[:rows // 4, :cols // 4] = 0
    return np.dstack([rgb, alpha]).astype(np.uint8)


def vp8l_write(planes, width: int, height: int) -> bytes:
    """A WebP file of one VP8L image, written without Pillow: `planes` the
    red, green, blue and alpha channels, each a (height, width) u8 array or
    an int where the channel is constant. No transforms, no colour cache and
    one prefix-code group: a varying channel takes a code of 256 symbols of
    8 bits (each pixel's value bit-reversed, as canonical codes are read), a
    constant one a simple code of one symbol (no bits a pixel); the distance
    code is a simple one of one symbol. The alpha hint is set unless alpha
    is the constant 255."""
    import numpy as np

    head: list = []  # (value, bits), least significant bit first

    def put(value: int, bits: int) -> None:
        head.append((value, bits))

    r, g, b, a = planes
    put(0x2F, 8)
    put(width - 1, 14)
    put(height - 1, 14)
    put(0 if isinstance(a, int) and a == 255 else 1, 1)
    put(0, 3)  # version
    put(0, 1)  # no transform
    put(0, 1)  # no colour cache
    put(0, 1)  # no meta prefix codes
    varying = []
    for plane, alphabet in ((g, 280), (r, 256), (b, 256), (a, 256)):
        if isinstance(plane, int):  # simple code: one symbol of 8 bits
            put(1, 1)
            put(0, 1)
            put(1, 1)
            put(plane, 8)
            continue
        # normal code: a code-length code of one symbol, the length 8 (12th
        # in the code-length-code order), so each length costs no bits
        put(0, 1)
        put(12 - 4, 4)
        for i in range(12):
            put(1 if i == 11 else 0, 3)
        if alphabet == 280:  # lengths for the 256 literals only
            put(1, 1)
            put(3, 3)
            put(256 - 2, 8)
        else:
            put(0, 1)
        varying.append(plane)
    for value, bits in ((1, 1), (0, 1), (0, 1), (0, 1)):  # distance code
        put(value, bits)
    nbits = sum(bits for _, bits in head)
    acc = 0
    shift = 0
    for value, bits in head:
        acc |= value << shift
        shift += bits
    rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
    payload = np.empty((height, width, len(varying)), np.uint8)
    for k, plane in enumerate(varying):
        payload[..., k] = rev[plane]
    payload = payload.reshape(-1)
    k = nbits % 8
    head_bytes = acc.to_bytes((nbits + 7) // 8, "little")
    if k == 0:
        body = head_bytes + payload.tobytes()
    else:  # the pixels start k bits into the header's last byte
        out = np.empty(payload.size + 1, np.uint8)
        np.left_shift(payload, k, out=out[:-1])
        out[-1] = 0
        out[1:] |= payload >> (8 - k)
        out[0] |= head_bytes[-1]
        body = head_bytes[:-1] + out.tobytes()
    pad = b"\0" * (len(body) & 1)
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(body) + len(pad))
            + b"WEBPVP8L" + struct.pack("<I", len(body)) + body + pad)


def phase_webp(work: Path, smi: str) -> dict:
    """io/webp on the card's machine: the committed files decode to the
    SHA-256 of Pillow's decode; the 84.9 MP VP8L band with .wpw and .prj
    opens through RasterReader (decode timed on the host clock, median of
    3), equals the band written with its geotransform and EPSG, reads
    decimated to 2048^2 on the card (bit-equal to the plain resample) and is
    saved as a CLAHE gray JPEG that reads back. Returns the launches of the
    driven read and save."""
    import hashlib

    import numpy as np
    import torch

    from sarpro_tpu_torch import _native, api, ops
    from sarpro_tpu_torch.io import raster, webp
    from sarpro_tpu_torch.io.writers.worldfile import write_prj_file
    from sarpro_tpu_torch.ops import force_plain
    from sarpro_tpu_torch.types import (
        AutoscaleStrategy,
        BitDepth,
        OutputFormat,
    )

    _native.raster_decoder()  # built in phase_build; raises if it did not
    d = work / "webp"
    d.mkdir()
    for name, want in WEBP_FIXTURES.items():
        img = webp.read((WEBP_DIR / name).read_bytes())
        digest = hashlib.sha256(img.array.tobytes()).hexdigest()
        if digest != want:
            raise AssertionError(f"webp: {name} decodes to SHA-256 {digest}, "
                                 f"Pillow's is {want}")
        log(f"webp: {name}: {img.mode} {tuple(img.array.shape)}, the "
            f"SHA-256 of Pillow's decode")
    side = WEBP_BAND_SIDE
    t0 = time.perf_counter()
    band = webp_band(WEBP_SEED, side, side)
    path = d / "band.webp"
    path.write_bytes(vp8l_write((band, band, band, 255), side, side))
    gt = [500000.0, 10.0, 0.0, 5100000.0, 0.0, -10.0]
    path.with_suffix(".wpw").write_text(
        "10.0\n0.0\n0.0\n-10.0\n500005.0\n5099995.0\n")
    write_prj_file(path, "EPSG:32632")
    mb = path.stat().st_size / 1e6
    log(f"webp: wrote the {side}^2 VP8L band ({mb:.1f} MB) in "
        f"{time.perf_counter() - t0:.1f} s")
    walls = []
    for _ in range(3):
        reader = None  # the last decode's arrays go before the next one's
        t0 = time.perf_counter()
        reader = raster.RasterReader(path)
        walls.append(time.perf_counter() - t0)
    data = reader._tiff._data
    md = reader.metadata
    if md.geotransform != gt or md.epsg != 32632:
        raise AssertionError(f"webp: geotransform {md.geotransform}, EPSG "
                             f"{md.epsg}")
    if data.shape != (side, side, 3) or data.dtype != np.uint8 or not all(
            np.array_equal(data[..., k], band) for k in range(3)):
        raise AssertionError(f"webp: the band decodes to {data.dtype} "
                             f"{data.shape}, not the band written")
    wall = statistics.median(walls)
    mp = side * side / 1e6
    log(f"webp: VP8L band {mp:.1f} MP ({mb:.1f} MB, u8 {tuple(data.shape)}): "
        f"decode {wall * 1e3:.1f} ms (host clock, median of 3; "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}), {mp / wall:.1f} "
        f"MP/s, {mb / wall:.1f} MB/s, equal to the band written; host CPU "
        f"{_host_cpu()}")
    del data
    totals = {k: 0 for k in ops.launch_counts()}
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    dev = raster.read_band_resampled_to_device(reader, 1, SIZE, SIZE, DEVICE,
                                               "cubic")
    end.record()
    end.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    if counts["resample_axis0"] <= 0:
        raise AssertionError(f"webp: the decimated read launched no "
                             f"resample ({counts})")
    for k, v in counts.items():
        totals[k] += v
    with force_plain():
        plain = raster.read_band_resampled_to_device(reader, 1, SIZE, SIZE,
                                                     DEVICE, "cubic")
    _check_equal(dev, plain, "webp: VP8L band resample vs plain")
    log(f"webp: VP8L band: cubic read to {SIZE}^2 "
        f"{start.elapsed_time(end):.3f} ms between CUDA events "
        f"({read_ms:.1f} ms host), launches "
        f"{ {k: v for k, v in counts.items() if v} }, bit-equal to the "
        f"plain resample; on {smi}")
    reader.close()
    del reader, plain
    out = d / "clahe_gray.jpg"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    api.save_image(dev + 1.0, out, OutputFormat.JPEG, BitDepth.U8,
                   autoscale=AutoscaleStrategy.CLAHE, device=DEVICE)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for k in ("histogram", "tile_histogram", "clahe_lookup"):
        if counts[k] <= 0:
            raise AssertionError(f"webp: the CLAHE gray save launched no "
                                 f"{k} ({counts})")
    for k, v in counts.items():
        totals[k] += v
    back = raster.RasterReader(out)
    if (back.metadata.size_x, back.metadata.size_y,
            back.metadata.bands) != (SIZE, SIZE, 1):
        raise AssertionError(f"webp: the CLAHE gray JPEG reads back as "
                             f"{back.metadata}")
    log(f"webp: api.save_image CLAHE gray JPEG of the VP8L band's {SIZE}^2 "
        f"read: {wall * 1e3:.1f} ms (host clock), launches "
        f"{ {k: v for k, v in counts.items() if v} }, read back {SIZE} x "
        f"{SIZE} x 1")
    del dev
    shutil.rmtree(d, ignore_errors=True)
    return totals


def formats_dn(seed: int, rows: int, cols: int):
    """make_safe's DN at (rows, cols): lognormal(5.0, 1.1) from `seed`,
    clipped to u16, 2 % zeros, and a no-data border (the first and last
    sixteenth of the columns) of zeros, as a swath's edges have."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dn = rng.standard_normal((rows, cols), np.float32)
    dn *= np.float32(1.1)
    dn += np.float32(5.0)
    np.exp(dn, out=dn)
    np.minimum(dn, np.float32(65535.0), out=dn)
    out = dn.astype(np.uint16)
    del dn
    out[rng.random((rows, cols), np.float32) < 0.02] = 0
    edge = cols // 16
    out[:, :edge] = 0
    out[:, cols - edge:] = 0
    return out


def formats_u8(dn):
    """A u8 product of a DN band: 40 log10(DN) scaled to 0..255, 0 where the
    DN is 0."""
    import numpy as np

    db = np.log10(np.maximum(dn, 1).astype(np.float32))
    db *= np.float32(60.0)
    return np.clip(db, 0, 255).astype(np.uint8)


def avif_band_u8(side: int):
    """The avif phase's band: formats_u8 of formats_dn(AVIF_SEED, side,
    side), the u8 product of make_safe's DN."""
    return formats_u8(formats_dn(AVIF_SEED, side, side))


def pfm_write(band) -> bytes:
    """A little-endian "Pf" PFM of a float32 band (rows bottom-up, scale
    -1)."""
    import numpy as np

    rows, cols = band.shape
    return (f"Pf\n{cols} {rows}\n-1.0\n".encode()
            + np.ascontiguousarray(band[::-1], "<f4").tobytes())


FITS_DTYPES = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}


def fits_write(data, bitpix: int, cards: tuple = ()) -> bytes:
    """A primary-HDU FITS image: the header cards (`cards` added before
    END), padded to 2880 bytes, and `data` in FITS's big-endian samples of
    `bitpix`, padded likewise. FITS's first row is the image's bottom row
    for Pillow, which also reads the samples as little-endian (mode I;16 for
    BITPIX 16)."""
    import numpy as np

    rows, cols = data.shape

    def card(key, value):
        return f"{key:<8}= {value:>20}".ljust(80).encode()

    head = (card("SIMPLE", "T") + card("BITPIX", bitpix) + card("NAXIS", 2)
            + card("NAXIS1", cols) + card("NAXIS2", rows)
            + b"".join(card(k, v) for k, v in cards) + b"END".ljust(80))
    head += b" " * (-len(head) % 2880)
    body = np.ascontiguousarray(data, FITS_DTYPES[bitpix]).tobytes()
    return head + body + bytes(-len(body) % 2880)


def mcidas_write(data, prefix: int = 0) -> bytes:
    """A McIdas AREA file of one band: the 64-word directory (w[2] = 4, w[9]
    lines, w[10] elements, w[11] bytes a sample, w[14] one band, w[15] a
    `prefix` of bytes before each line, w[34] the data at 256) and the
    big-endian samples."""
    import numpy as np

    rows, cols = data.shape
    size = data.dtype.itemsize
    w = [0] * 65
    w[2], w[9], w[10], w[11], w[14], w[15], w[34] = (4, rows, cols, size, 1,
                                                      prefix, 256)
    lines = np.zeros((rows, prefix + cols * size), np.uint8)
    lines[:, prefix:] = np.ascontiguousarray(
        data, data.dtype.newbyteorder(">")).view(np.uint8).reshape(rows, -1)
    return struct.pack(">64i", *w[1:]) + lines.tobytes()


def sgi_rle_write(band, seg: int = 16) -> bytes:
    """An RLE SGI file of a u8 (rows, cols) or (rows, cols, 3 | 4) band
    without Pillow: each channel's rows bottom-up, each row cut into
    `seg`-pixel segments (the last one shorter), a run packet for a segment
    of one value and a literal one otherwise, then a 0; the start and
    length tables before the data; `seg` is at most 127."""
    import numpy as np

    assert 1 <= seg <= 127, seg
    planes = band[..., None] if band.ndim == 2 else band
    rows, cols, z = planes.shape
    # table order: channel 0's rows from the bottom, then channel 1's, ...
    lines = np.ascontiguousarray(planes[::-1].transpose(2, 0, 1)).reshape(
        z * rows, cols)
    n, full = lines.shape[0], cols // seg
    tail = cols - full * seg
    body = lines[:, :full * seg].reshape(n, full, seg)
    run = (body == body[:, :, :1]).all(axis=2)
    lengths = np.where(run, 2, 1 + seg)
    row_len = lengths.sum(axis=1) + (1 + tail if tail else 0) + 1
    table = 512 + 8 * n
    starts = table + np.concatenate([[0], np.cumsum(row_len)[:-1]])
    out = np.zeros(int(row_len.sum()), np.uint8)
    base = starts - table
    pos = base[:, None] + np.cumsum(lengths, axis=1) - lengths
    flat_run, flat_pos = run.reshape(-1), pos.reshape(-1)
    segs = body.reshape(-1, seg)
    out[flat_pos[flat_run]] = seg
    out[flat_pos[flat_run] + 1] = segs[flat_run, 0]
    lit = ~flat_run
    out[flat_pos[lit]] = 0x80 | seg
    out[flat_pos[lit, None] + 1 + np.arange(seg)] = segs[lit]
    if tail:
        tpos = base + lengths.sum(axis=1)
        out[tpos] = 0x80 | tail
        out[tpos[:, None] + 1 + np.arange(tail)] = lines[:, full * seg:]
    head = struct.pack(">hBBHHHHll4s80sl", 474, 1, 1, 3 if z > 1 else 2,
                       cols, rows, z, 0, 255, b"", b"", 0)
    head += bytes(512 - len(head))
    return (head + starts.astype(">u4").tobytes()
            + row_len.astype(">u4").tobytes() + out.tobytes())


def tga_rle_write(band, seg: int = 16, top_down: bool = True) -> bytes:
    """An RLE TGA file of a u8 gray (rows, cols) band without Pillow (image
    type 11, 8 bits): the pixels in file order cut into `seg`-pixel packets
    (the last one shorter) that run on across rows; a run packet for a
    segment of one value within one row, a literal one otherwise (Pillow
    splits a literal across rows, not a run); `seg` is at most 128."""
    import numpy as np

    assert 1 <= seg <= 128, seg
    rows, cols = band.shape
    order = band if top_down else band[::-1]
    flat = np.ascontiguousarray(order).reshape(-1)
    full = flat.size // seg
    tail = flat.size - full * seg
    segs = flat[:full * seg].reshape(full, seg)
    first = np.arange(full) * seg
    one_row = first // cols == (first + seg - 1) // cols
    run = (segs == segs[:, :1]).all(axis=1) & one_row
    lengths = np.where(run, 2, 1 + seg)
    pos = np.cumsum(lengths) - lengths
    total = int(lengths.sum()) + (1 + tail if tail else 0)
    out = np.zeros(total, np.uint8)
    out[pos[run]] = 0x80 | (seg - 1)
    out[pos[run] + 1] = segs[run, 0]
    lit = ~run
    out[pos[lit]] = seg - 1
    out[pos[lit, None] + 1 + np.arange(seg)] = segs[lit]
    if tail:
        at = total - 1 - tail
        out[at] = tail - 1
        out[at + 1:] = flat[full * seg:]
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 11, 0, 0, 0, 0, 0, cols, rows,
                       8, 0x20 if top_down else 0)
    return head + out.tobytes()


def _formats_bands(side: int, mcidas_side: int):
    """(label, file name, blob writer, what Pillow reads of it) of the
    formats phase's at-scale bands."""
    import numpy as np

    dn = formats_dn(FORMATS_SEED, side, side)
    u8 = formats_u8(dn)
    i16 = np.minimum(dn, 32767).astype(np.int16)
    del dn
    f32 = formats_dn(FORMATS_SEED + 1, side, side).astype(np.float32)
    area = formats_dn(FORMATS_SEED + 2, mcidas_side, mcidas_side)
    return (
        ("PFM f32", "band.pfm", lambda: pfm_write(f32), f32),
        # Pillow reads FITS's big-endian int16 as little-endian "I;16",
        # the last row first
        ("FITS BITPIX 16", "band.fits", lambda: fits_write(i16, 16),
         i16.astype(">i2").view("<u2")[::-1]),
        ("McIdas AREA u16", "band.area", lambda: mcidas_write(area), area),
        ("SGI RLE u8", "band.sgi", lambda: sgi_rle_write(u8), u8),
        ("TGA RLE u8", "band.tga", lambda: tga_rle_write(u8), u8),
    )


def _blocks4(band):
    """The 4 x 4 blocks of a u8 (rows, cols) band (sides multiples of 4),
    row by row: (blocks, 16) int32, in chunks of 2^18 blocks."""
    import numpy as np

    rows, cols = band.shape
    per = cols // 4
    step = max(1, (1 << 18) // per)
    for r in range(0, rows // 4, step):
        part = band[4 * r:4 * (r + step)]
        yield part.reshape(-1, 4, per, 4).transpose(0, 2, 1, 3).reshape(
            -1, 16).astype(np.int32)


def bc4_write(band) -> bytes:
    """The BC4 blocks of a u8 (rows, cols) band (sides multiples of 4): each
    block's end points its largest and smallest value, each pixel the step
    of the eight-level ramp between them it rounds to."""
    import numpy as np

    out = []
    order = np.array((0, 2, 3, 4, 5, 6, 7, 1), np.uint64)  # ramp step -> code
    for blocks in _blocks4(band):
        a0, a1 = blocks.max(1), blocks.min(1)
        span = np.maximum(a0 - a1, 1)[:, None]
        step = ((a0[:, None] - blocks) * 14 + span) // (2 * span)
        idx = order[step]
        bits = np.zeros(len(blocks), np.uint64)
        for i in range(16):
            bits |= idx[:, i] << np.uint64(3 * i)
        part = np.empty((len(blocks), 8), np.uint8)
        part[:, 0], part[:, 1] = a0, a1
        for b in range(6):
            part[:, 2 + b] = (bits >> np.uint64(8 * b)) & np.uint64(255)
        out.append(part.tobytes())
    return b"".join(out)


def bc7_mode6_write(band) -> bytes:
    """BC7 mode-6 blocks of a u8 gray (rows, cols) band (sides multiples of
    4): red, green and blue the band, end points the block's smallest and
    largest value (7 bits and a P-bit each, alpha 127 with the P-bit), each
    pixel the step of the sixteen it rounds to (the anchor pixel's index
    kept under 8 by swapping the end points)."""
    import numpy as np

    out = []
    for blocks in _blocks4(band):
        n = len(blocks)
        e0, e1 = blocks.min(1), blocks.max(1)
        span = np.maximum(e1 - e0, 1)[:, None]
        idx = ((blocks - e0[:, None]) * 30 + span) // (2 * span)
        swap = idx[:, 0] >= 8
        e0, e1 = np.where(swap, e1, e0), np.where(swap, e0, e1)
        idx = np.where(swap[:, None], 15 - idx, idx)
        fields = [(np.full(n, 1 << 6), 7)]
        for _ in range(3):
            fields += [(e0 >> 1, 7), (e1 >> 1, 7)]
        fields += [(np.full(n, 127), 7)] * 2
        fields += [(e0 & 1, 1), (e1 & 1, 1), (idx[:, 0], 3)]
        fields += [(idx[:, i], 4) for i in range(1, 16)]
        halves = [np.zeros(n, np.uint64), np.zeros(n, np.uint64)]
        pos = 0
        for value, bits in fields:
            v = value.astype(np.uint64) & np.uint64((1 << bits) - 1)
            half, at = divmod(pos, 64)
            halves[half] |= v << np.uint64(at)
            if at + bits > 64:  # the field runs into the high half
                halves[1] |= v >> np.uint64(64 - at)
            pos += bits
        out.append(np.stack(halves, 1).astype("<u8").tobytes())
    return b"".join(out)


def dds_write(width: int, height: int, data: bytes, fourcc: bytes,
              dxgi: int = 0) -> bytes:
    """A DDS file of block-compressed `data`: the 124-byte header with the
    FOURCC (and, for b"DX10", the extension naming the DXGI format)."""
    head = (b"DDS " + struct.pack("<7I", 124, 0x81007, height, width,
                                  len(data), 0, 0) + bytes(44)
            + struct.pack("<2I4s5I", 32, 4, fourcc, 0, 0, 0, 0, 0)
            + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    if fourcc == b"DX10":
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + data


def imt_write(band) -> bytes:
    """An IM Tools file of a u8 (rows, cols) band: its "width", "height"
    and "pixel n8" lines, a form feed, the rows."""
    rows, cols = band.shape
    return (b"width %d\nheight %d\npixel n8\n\x0c" % (cols, rows)
            + band.tobytes())


def _longtail_bands(side: int):
    """(label, file name, blob writer) of the longtail phase's bands."""
    u8 = formats_u8(formats_dn(FORMATS_SEED + 3, side, side))
    return (
        ("DDS BC4", "band.dds", lambda: dds_write(side, side, bc4_write(u8),
                                                   b"ATI1")),
        ("DDS DX10 BC7", "band7.dds", lambda: dds_write(
            side, side, bc7_mode6_write(u8), b"DX10", 98)),
        ("IMT L", "band.imt", lambda: imt_write(u8)),
    )


def decode_digest(data) -> str:
    """SHA-256 of a decoded array's samples (a bool array's as 0 / 1 bytes:
    Pillow's mode "1" arrays hold 0 / 255)."""
    import hashlib

    import numpy as np

    if data.dtype == bool:
        data = data.astype(np.uint8)
    return hashlib.sha256(np.ascontiguousarray(data).tobytes()).hexdigest()


def _read_and_save(tag: str, label: str, reader, path: Path, smi: str,
                   totals: dict, bands: tuple = (1,)) -> None:
    """The formats and longtail phases' drive of an opened band: the cubic
    read to SIZE^2 on the card of each of `bands` with the launch counts set
    to 0 just before and read just after (a resample launch required,
    bit-equal to the plain resample), then the CLAHE gray JPEG of the first
    through api.save_image (a launch of each CLAHE kernel required) read
    back beside `path`; the launches are added to `totals`, and `reader` is
    closed."""
    import torch

    from sarpro_tpu_torch import api, ops
    from sarpro_tpu_torch.io import raster
    from sarpro_tpu_torch.ops import force_plain
    from sarpro_tpu_torch.types import (
        AutoscaleStrategy,
        BitDepth,
        OutputFormat,
    )

    reads = []
    for band in bands:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        dev = raster.read_band_resampled_to_device(reader, band, SIZE, SIZE,
                                                   DEVICE, "cubic")
        end.record()
        end.synchronize()
        read_ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        if counts["resample_axis0"] <= 0:
            raise AssertionError(f"{tag}: {label}: the decimated read of band "
                                 f"{band} launched no resample ({counts})")
        for k, v in counts.items():
            totals[k] += v
        with force_plain():
            plain = raster.read_band_resampled_to_device(reader, band, SIZE,
                                                         SIZE, DEVICE, "cubic")
        _check_equal(dev, plain, f"{tag}: {label} band {band} resample vs "
                     "plain")
        log(f"{tag}: {label}: band {band} cubic read to {SIZE}^2 "
            f"{start.elapsed_time(end):.3f} ms between CUDA events "
            f"({read_ms:.1f} ms host), launches "
            f"{ {k: v for k, v in counts.items() if v} }, bit-equal to the "
            f"plain resample; on {smi}")
        reads.append(dev)
        del plain
    reader.close()
    dev = reads[0]
    del reads
    out = path.parent / f"{path.stem}_{path.suffix[1:]}_clahe_gray.jpg"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    api.save_image(dev + 1.0, out, OutputFormat.JPEG, BitDepth.U8,
                   autoscale=AutoscaleStrategy.CLAHE, device=DEVICE)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for k in ("histogram", "tile_histogram", "clahe_lookup"):
        if counts[k] <= 0:
            raise AssertionError(f"{tag}: {label}: the CLAHE gray save "
                                 f"launched no {k} ({counts})")
    for k, v in counts.items():
        totals[k] += v
    back = raster.RasterReader(out)
    if (back.metadata.size_x, back.metadata.size_y,
            back.metadata.bands) != (SIZE, SIZE, 1):
        raise AssertionError(f"{tag}: {label}: the CLAHE gray JPEG reads "
                             f"back as {back.metadata}")
    log(f"{tag}: {label}: api.save_image CLAHE gray JPEG of the {SIZE}^2 "
        f"read: {wall * 1e3:.1f} ms (host clock), launches "
        f"{ {k: v for k, v in counts.items() if v} }, read back {SIZE} x "
        f"{SIZE} x 1")


def phase_longtail(work: Path, smi: str) -> dict:
    """Pillow's long tail of formats on the card's machine: the small files
    of tests/data/formats that LONGTAIL_FIXTURES names decode to the SHA-256
    of Pillow's decode; each 9216^2 band (_longtail_bands, with a .wld and a
    .prj) opens through RasterReader (decode timed on the host clock, median
    of 3), decodes to the SHA-256 of Pillow's decode (LONGTAIL_BANDS), reads
    decimated to SIZE^2 on the card (bit-equal to the plain resample) and
    is saved as a CLAHE gray JPEG that reads back. Returns the launches of
    the driven reads and saves."""
    from sarpro_tpu_torch import _native, ops
    from sarpro_tpu_torch.io import raster
    from sarpro_tpu_torch.io.writers.worldfile import write_prj_file

    _native.raster_decoder()  # built in phase_build; raises if it did not
    for name, want in LONGTAIL_FIXTURES.items():
        reader = raster.RasterReader(FORMATS_DIR / name)
        digest = decode_digest(reader._tiff._data)
        reader.close()
        if digest != want:
            raise AssertionError(f"longtail: {name} decodes to SHA-256 "
                                 f"{digest}, Pillow's is {want}")
    log(f"longtail: {len(LONGTAIL_FIXTURES)} files of tests/data/formats "
        f"decode to the SHA-256 of Pillow's decode")
    d = work / "longtail"
    d.mkdir()
    totals = {k: 0 for k in ops.launch_counts()}
    gt = [500000.0, 10.0, 0.0, 5100000.0, 0.0, -10.0]
    try:
        for label, name, writer in _longtail_bands(LONGTAIL_SIDE):
            t0 = time.perf_counter()
            path = d / name
            path.write_bytes(writer())
            path.with_suffix(".wld").write_text(
                "10.0\n0.0\n0.0\n-10.0\n500005.0\n5099995.0\n")
            write_prj_file(path, "EPSG:32632")
            mb = path.stat().st_size / 1e6
            write_s = time.perf_counter() - t0
            walls = []
            for _ in range(3):
                reader = None  # the last decode goes before the next one
                t0 = time.perf_counter()
                reader = raster.RasterReader(path)
                walls.append(time.perf_counter() - t0)
            data = reader._tiff._data
            md = reader.metadata
            if md.geotransform != gt or md.epsg != 32632:
                raise AssertionError(f"longtail: {label}: geotransform "
                                     f"{md.geotransform}, EPSG {md.epsg}")
            digest = decode_digest(data)
            if digest != LONGTAIL_BANDS[label]:
                raise AssertionError(f"longtail: {label} decodes to SHA-256 "
                                     f"{digest}, Pillow's is "
                                     f"{LONGTAIL_BANDS[label]}")
            rows, cols, bands = data.shape
            wall = statistics.median(walls)
            mp = rows * cols / 1e6
            log(f"longtail: {label} {rows} x {cols} x {bands} ({mp:.1f} MP, "
                f"{mb:.1f} MB written in {write_s:.1f} s): decode "
                f"{wall * 1e3:.1f} ms (host clock, median of 3; "
                f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}), "
                f"{mp / wall:.1f} MP/s, {mb / wall:.1f} MB/s, equal to "
                f"Pillow's decode; host CPU {_host_cpu()}")
            del data
            _read_and_save("longtail", label, reader, path, smi, totals)
            path.unlink()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return totals


def phase_avif(work: Path, smi: str) -> dict:
    """io/avif on the card's machine: each file of AVIF_FIXTURES and the
    eight committed bands (each with a .wld and a .prj) opens through
    RasterReader (decode timed on the host clock, median of 3), decodes to
    the SHA-256 of Pillow's decode, reads decimated to SIZE^2 on the card
    (bit-equal to the plain resample; the alpha of the LA, grain, 12-bit,
    grid, scaled and superres bands too)
    and is saved as a CLAHE gray JPEG that reads back (but the 1 x 1 files:
    their read is a constant band, whose save launches no histogram).
    Returns the launches of the driven reads and saves."""
    from sarpro_tpu_torch import _native, ops
    from sarpro_tpu_torch.io import raster
    from sarpro_tpu_torch.io.writers.worldfile import write_prj_file

    _native.raster_decoder()  # built in phase_build; raises if it did not
    d = work / "avif"
    d.mkdir()
    totals = {k: 0 for k in ops.launch_counts()}
    gt = [500000.0, 10.0, 0.0, 5100000.0, 0.0, -10.0]
    files = []
    for name, want in AVIF_FIXTURES.items():  # copied: the saves go beside
        shutil.copyfile(AVIF_DIR / name, d / name)
        files.append((name, d / name, want))
    band_paths = []
    for label, src, want in (
            ("SAR band", AVIF_BAND, AVIF_BAND_SHA256),
            ("SAR band, filtered", AVIF_FILTERED_BAND,
             AVIF_FILTERED_BAND_SHA256),
            ("SAR band, LA", AVIF_LA_BAND, AVIF_LA_BAND_SHA256),
            ("SAR band, grain", AVIF_GRAIN_BAND, AVIF_GRAIN_BAND_SHA256),
            ("SAR band, 12-bit LA", AVIF_DEPTH_BAND, AVIF_DEPTH_BAND_SHA256),
            ("SAR band, 3 x 3 grid RGBA", AVIF_GRID_BAND,
             AVIF_GRID_BAND_SHA256),
            ("SAR band, RGBA scaled from 6144^2, SMPTE 240M",
             AVIF_SCALE_BAND, AVIF_SCALE_BAND_SHA256),
            ("SAR band, RGBA coded 4608 wide with superres",
             AVIF_SUPERRES_BAND, AVIF_SUPERRES_BAND_SHA256)):
        band = d / src.name
        shutil.copyfile(src, band)
        band.with_suffix(".wld").write_text(
            "10.0\n0.0\n0.0\n-10.0\n500005.0\n5099995.0\n")
        write_prj_file(band, "EPSG:32632")
        files.append((label, band, want))
        band_paths.append(band)
    try:
        for label, path, want in files:
            walls = []
            for _ in range(3):
                reader = None  # the last decode goes before the next one
                t0 = time.perf_counter()
                reader = raster.RasterReader(path)
                walls.append(time.perf_counter() - t0)
            data = reader._tiff._data
            digest = decode_digest(data)
            if digest != want:
                raise AssertionError(f"avif: {label} decodes to SHA-256 "
                                     f"{digest}, Pillow's is {want}")
            if path in band_paths:
                md = reader.metadata
                if md.geotransform != gt or md.epsg != 32632:
                    raise AssertionError(f"avif: {label}: geotransform "
                                         f"{md.geotransform}, EPSG {md.epsg}")
            rows, cols, bands = data.shape
            wall = statistics.median(walls)
            mp = rows * cols / 1e6
            mb = path.stat().st_size / 1e6
            log(f"avif: {label} {rows} x {cols} x {bands} ({mp:.4f} MP, "
                f"{mb:.4f} MB): decode {wall * 1e3:.2f} ms (host clock, "
                f"median of 3; {', '.join(f'{w * 1e3:.2f}' for w in walls)}"
                f"), {mp / wall:.2f} MP/s, equal to Pillow's decode; host "
                f"CPU {_host_cpu()}; on {smi}")
            del data
            # LA, grain, 12-bit, grid, scaled, superres
            with_alpha = path in band_paths[2:]
            if with_alpha and bands != 4:
                raise AssertionError(f"avif: {label} opens with {bands} "
                                     "bands, Pillow's RGBA has 4")
            if rows * cols > 1:
                _read_and_save("avif", label, reader, path, smi, totals,
                               (1, 4) if with_alpha else (1,))
            else:
                reader.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return totals


def phase_formats(work: Path, smi: str) -> dict:
    """io/pilraster's plugin loop and the float, scientific and run-length
    readers on the card's machine: the small files of tests/data/formats
    decode to the SHA-256 of Pillow's decode; each at-scale band
    (_formats_bands, with a .wld and a .prj) opens through RasterReader
    (decode timed on the host clock, median of 3), equals what Pillow reads
    of it, reads decimated to SIZE^2 on the card (bit-equal to the plain
    resample) and is saved as a CLAHE gray JPEG that reads back. The 117.7 MP
    McIdas band logs Pillow's decompression-bomb warning. Returns the
    launches of the driven reads and saves."""
    import hashlib
    import logging

    import numpy as np
    from sarpro_tpu_torch import _native, ops
    from sarpro_tpu_torch.io import raster
    from sarpro_tpu_torch.io.writers.worldfile import write_prj_file

    _native.raster_decoder()  # built in phase_build; raises if it did not
    for name, want in FORMATS_FIXTURES.items():
        reader = raster.RasterReader(FORMATS_DIR / name)
        data = reader._tiff._data
        digest = hashlib.sha256(data.tobytes()).hexdigest()
        if digest != want:
            raise AssertionError(f"formats: {name} decodes to SHA-256 "
                                 f"{digest}, Pillow's is {want}")
        reader.close()
    log(f"formats: {len(FORMATS_FIXTURES)} files of tests/data/formats "
        f"decode to the SHA-256 of Pillow's decode")
    d = work / "formats"
    d.mkdir()
    warnings = []

    class _Warnings(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    handler = _Warnings(logging.WARNING)
    logging.getLogger("sarpro").addHandler(handler)
    totals = {k: 0 for k in ops.launch_counts()}
    gt = [500000.0, 10.0, 0.0, 5100000.0, 0.0, -10.0]
    try:
        t0 = time.perf_counter()
        bands = _formats_bands(FORMATS_SIDE, MCIDAS_SIDE)
        log(f"formats: made the bands in {time.perf_counter() - t0:.1f} s")
        for label, name, writer, want in bands:
            t0 = time.perf_counter()
            path = d / name
            path.write_bytes(writer())
            path.with_suffix(".wld").write_text(
                "10.0\n0.0\n0.0\n-10.0\n500005.0\n5099995.0\n")
            write_prj_file(path, "EPSG:32632")
            mb = path.stat().st_size / 1e6
            write_s = time.perf_counter() - t0
            walls = []
            del warnings[:]
            for _ in range(3):
                reader = None  # the last decode goes before the next one
                t0 = time.perf_counter()
                reader = raster.RasterReader(path)
                walls.append(time.perf_counter() - t0)
            data = reader._tiff._data[..., 0]
            md = reader.metadata
            if md.geotransform != gt or md.epsg != 32632:
                raise AssertionError(f"formats: {label}: geotransform "
                                     f"{md.geotransform}, EPSG {md.epsg}")
            same = data.shape == want.shape and np.array_equal(
                data.view(f"u{data.itemsize}"),
                np.asarray(want, data.dtype).view(f"u{data.itemsize}"))
            if not same:
                raise AssertionError(f"formats: {label} decodes to "
                                     f"{data.dtype} {data.shape}, not what "
                                     f"Pillow reads of it")
            bomb = [w for w in warnings if "decompression bomb" in w]
            rows, cols = data.shape
            if (rows * cols > 89478485) != bool(bomb):
                raise AssertionError(f"formats: {label}: decompression-bomb "
                                     f"warnings {bomb}")
            wall = statistics.median(walls)
            mp = rows * cols / 1e6
            log(f"formats: {label} {rows} x {cols} ({mp:.1f} MP, {mb:.1f} "
                f"MB written in {write_s:.1f} s): decode {wall * 1e3:.1f} ms "
                f"(host clock, median of 3; "
                f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}), "
                f"{mp / wall:.1f} MP/s, {mb / wall:.1f} MB/s, {data.dtype}, "
                f"equal to Pillow's read{'; ' + bomb[0] if bomb else ''}; "
                f"host CPU {_host_cpu()}")
            del data
            _read_and_save("formats", label, reader, path, smi, totals)
            path.unlink()
    finally:
        logging.getLogger("sarpro").removeHandler(handler)
        shutil.rmtree(d, ignore_errors=True)
    return totals


def phase_rasters(work: Path, synrgb: Path, rgb, smi: str) -> dict:
    """The non-TIFF raster readers on the card's machine: each input opened
    through RasterReader (its decode timed on the host clock, median of 3),
    held to what was written, read decimated to 2048^2 on the card by the
    resample kernel (bit-equal to its plain version), and the 80 MP band's
    CLAHE gray JPEG written through api.save_image and read back. `rgb` is
    the headline route's composed RGB (the device's, host copy) that its
    JPEG coded. Returns the launches of the driven reads and save."""
    import numpy as np
    import torch

    from sarpro_tpu_torch import _native, api, ops
    from sarpro_tpu_torch.io import raster
    from sarpro_tpu_torch.ops import force_plain
    from sarpro_tpu_torch.types import (
        AutoscaleStrategy,
        BitDepth,
        OutputFormat,
    )

    _native.raster_decoder()  # built in phase_build; raises if it did not
    g = torch.Generator(device=DEVICE).manual_seed(12)
    band = (torch.empty(RASTER_ROWS, RASTER_COLS, device=DEVICE)
            .exponential_(generator=g).mul_(60.0).clamp_(0, 255)
            .to(torch.uint8).cpu().numpy())
    files = _raster_inputs(work, band, synrgb)
    totals = {k: 0 for k in ops.launch_counts()}
    cpu = _host_cpu()
    out_band = None
    huffman_ms = None
    for name, (path, want, tol, gt, epsg) in files.items():
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            reader = raster.RasterReader(path)
            walls.append(time.perf_counter() - t0)
        data = reader._tiff._data
        md = reader.metadata
        if want is None:  # the synRGB JPEG: the composed RGB it coded
            want = rgb
        shape = want.shape[:2]
        if (md.size_y, md.size_x) != shape or md.bands != data.shape[2]:
            raise AssertionError(f"rasters: {name}: {md.size_x} x "
                                 f"{md.size_y} x {md.bands}, wrote {shape}")
        if gt is not None and (md.geotransform != gt or md.epsg != epsg):
            raise AssertionError(f"rasters: {name}: geotransform "
                                 f"{md.geotransform}, EPSG {md.epsg}")
        ref = want if want.ndim == 3 else want[..., None]
        got = data if ref.shape[2] == data.shape[2] else data[..., :1]
        if got.dtype != ref.dtype:
            raise AssertionError(f"rasters: {name}: dtype {got.dtype}, "
                                 f"wrote {ref.dtype}")
        err = int(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max())
        if err > tol:
            raise AssertionError(f"rasters: {name}: decode differs by {err} "
                                 f"from what was written (bound {tol})")
        if name == "bmp 80 MP" and not (
                np.array_equal(data[..., 1], data[..., 0])
                and np.array_equal(data[..., 2], data[..., 0])):
            raise AssertionError(f"rasters: {name}: its bands differ")
        # the synRGB JPEG is SIZE^2 already: read it to half its side
        side = SIZE // 2 if name == "synrgb jpeg 2048" else SIZE
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        dev = raster.read_band_resampled_to_device(reader, 1, side, side,
                                                   DEVICE, "cubic")
        end.record()
        end.synchronize()
        read_ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        if counts["resample_axis0"] <= 0:
            raise AssertionError(f"rasters: {name}: the decimated read "
                                 f"launched no resample ({counts})")
        for k, v in counts.items():
            totals[k] += v
        with force_plain():
            plain = raster.read_band_resampled_to_device(
                reader, 1, side, side, DEVICE, "cubic")
        _check_equal(dev, plain, f"rasters: {name} resample vs plain")
        log(f"rasters: {name} ({path.stat().st_size / 1e6:.1f} MB, "
            f"{data.dtype} {tuple(data.shape)}): decode "
            f"{statistics.median(walls) * 1e3:.1f} ms (host clock, median "
            f"of 3; {', '.join(f'{w * 1e3:.1f}' for w in walls)}), max "
            f"|decode - written| {err} (bound {tol}); cubic read to {side}^2 "
            f"{start.elapsed_time(end):.3f} ms between CUDA events "
            f"({read_ms:.1f} ms host), launches "
            f"{ {k: v for k, v in counts.items() if v} }, bit-equal to the "
            f"plain resample; on {smi}, host CPU {cpu}")
        if name == "gray jpeg 80 MP":
            out_band = dev
            huffman_ms = statistics.median(walls) * 1e3
        reader.close()
        del reader, data, dev, plain
    out = work / "rasters" / "clahe_gray.jpg"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    api.save_image(out_band + 1.0, out, OutputFormat.JPEG, BitDepth.U8,
                   autoscale=AutoscaleStrategy.CLAHE, device=DEVICE)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for k in ("histogram", "tile_histogram", "clahe_lookup"):
        if counts[k] <= 0:
            raise AssertionError(f"rasters: the CLAHE gray save launched no "
                                 f"{k} ({counts})")
    for k, v in counts.items():
        totals[k] += v
    back = raster.RasterReader(out)
    if (back.metadata.size_x, back.metadata.size_y,
            back.metadata.bands) != (SIZE, SIZE, 1):
        raise AssertionError(f"rasters: the CLAHE gray JPEG reads back as "
                             f"{back.metadata}")
    log(f"rasters: api.save_image CLAHE gray JPEG of the 80 MP band's "
        f"{SIZE}^2 read: {wall * 1e3:.1f} ms (host clock), launches "
        f"{ {k: v for k, v in counts.items() if v} }, read back "
        f"{SIZE} x {SIZE} x 1")
    shutil.rmtree(work / "rasters", ignore_errors=True)
    for k, v in _jpeg_codings(work, huffman_ms, smi).items():
        totals[k] += v
    return totals


def _jpeg_codings(work: Path, huffman_ms: float, smi: str) -> dict:
    """Phase 13's arithmetic-coded, lossless and block-smoothed JPEGs: the
    committed files of tests/data/jpeg decode to the SHA-256 of Pillow's
    decode. Two bands with .jgw / .prj open through RasterReader: the SOF3
    strip spliced restart interval by restart interval into a RASTER_ROWS x
    8000 band, equal to np.tile of the strip's decode, and the SOF9 strip
    as it is (arithmetic-coded data past Pillow's first 64 KiB read opens
    in neither reader, so no larger SOF9 band exists). Each decode is timed
    on the host clock (median of 3) beside the Huffman band's; each band
    reads to SIZE^2 on the card (cubic: the device resample, counted from 0
    and bit-equal to the plain one) and is saved as a CLAHE gray JPEG that
    reads back. Returns the launches of the reads and saves."""
    import hashlib

    import numpy as np
    import torch

    from sarpro_tpu_torch import api, ops
    from sarpro_tpu_torch.io import jpeg, raster
    from sarpro_tpu_torch.io.writers.worldfile import write_prj_file
    from sarpro_tpu_torch.ops import force_plain
    from sarpro_tpu_torch.types import (
        AutoscaleStrategy,
        BitDepth,
        OutputFormat,
    )

    for name, want in JPEG_FIXTURES.items():
        img = jpeg.read((JPEG_DIR / name).read_bytes())
        digest = hashlib.sha256(img.array.tobytes()).hexdigest()
        if digest != want:
            raise AssertionError(f"rasters: {name} decodes to SHA-256 "
                                 f"{digest}, Pillow's is {want}")
        log(f"rasters: {name}: {img.mode} {tuple(img.array.shape)}, the "
            f"SHA-256 of Pillow's decode")
    d = work / "jpeg_codings"
    d.mkdir()
    totals = {k: 0 for k in ops.launch_counts()}
    cpu = _host_cpu()
    for label, name in (("SOF9", JPEG_SOF9_STRIP), ("SOF3", JPEG_SOF3_STRIP)):
        strip_blob = (JPEG_DIR / name).read_bytes()
        strip = jpeg.read(strip_blob).array
        rows = RASTER_ROWS if label == "SOF3" else strip.shape[0]
        cols = strip.shape[1]
        t0 = time.perf_counter()
        blob = jpeg_splice(strip_blob, rows)
        path = d / f"{label.lower()}_band.jpg"
        path.write_bytes(blob)
        path.with_suffix(".jgw").write_text(
            "10.0\n0.0\n0.0\n-10.0\n500005.0\n5099995.0\n")
        write_prj_file(path, "EPSG:32632")
        want = np.tile(strip, (-(-rows // strip.shape[0]), 1))[:rows]
        mb, mp = len(blob) / 1e6, rows * cols / 1e6
        log(f"rasters: {label} band {cols} x {rows} ({mb:.3f} MB) spliced "
            f"from {name} in {time.perf_counter() - t0:.1f} s")
        walls = []
        for _ in range(3):
            reader = None  # the last decode goes before the next one
            t0 = time.perf_counter()
            reader = raster.RasterReader(path)
            walls.append(time.perf_counter() - t0)
        md = reader.metadata
        if (md.geotransform != [500000.0, 10.0, 0.0, 5100000.0, 0.0,
                                -10.0] or md.epsg != 32632):
            raise AssertionError(f"rasters: {label} band geotransform "
                                 f"{md.geotransform}, EPSG {md.epsg}")
        data = reader._tiff._data[..., 0]
        if data.shape != want.shape or not np.array_equal(data, want):
            raise AssertionError(f"rasters: the {label} band does not decode "
                                 f"to the strip's decode tiled")
        wall = statistics.median(walls)
        log(f"rasters: {label} band {mp:.3f} MP: decode (RasterReader) "
            f"{wall * 1e3:.1f} ms (host clock, median of 3; "
            f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}), {mp / wall:.1f} "
            f"MP/s, {mb / wall:.1f} MB/s; the Huffman band's "
            f"{huffman_ms:.1f} ms, "
            f"{RASTER_ROWS * RASTER_COLS / 1e3 / huffman_ms:.1f} MP/s; equal "
            f"to the tiled strip; host CPU {cpu}")

        ops.reset_launch_counts()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        dev = raster.read_band_resampled_to_device(reader, 1, SIZE, SIZE,
                                                   DEVICE, "cubic")
        end.record()
        end.synchronize()
        read_ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        if counts["resample_axis0"] <= 0:
            raise AssertionError(f"rasters: the {label} band's read "
                                 f"launched no resample ({counts})")
        for k, v in counts.items():
            totals[k] += v
        with force_plain():
            plain = raster.read_band_resampled_to_device(
                reader, 1, SIZE, SIZE, DEVICE, "cubic")
        _check_equal(dev, plain, f"rasters: {label} band resample vs plain")
        log(f"rasters: {label} band: cubic read to {SIZE}^2 "
            f"{start.elapsed_time(end):.3f} ms between CUDA events "
            f"({read_ms:.1f} ms host), launches "
            f"{ {k: v for k, v in counts.items() if v} }, bit-equal to the "
            f"plain resample; on {smi}")
        reader.close()
        reader = None
        del data, plain
        out = d / f"{label.lower()}_clahe.jpg"
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        api.save_image(dev + 1.0, out, OutputFormat.JPEG, BitDepth.U8,
                       autoscale=AutoscaleStrategy.CLAHE, device=DEVICE)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for k in ("histogram", "tile_histogram", "clahe_lookup"):
            if counts[k] <= 0:
                raise AssertionError(f"rasters: the {label} band's CLAHE "
                                     f"save launched no {k} ({counts})")
        for k, v in counts.items():
            totals[k] += v
        back = raster.RasterReader(out)
        if (back.metadata.size_x, back.metadata.size_y,
                back.metadata.bands) != (SIZE, SIZE, 1):
            raise AssertionError(f"rasters: the {label} band's CLAHE JPEG "
                                 f"reads back as {back.metadata}")
        log(f"rasters: api.save_image CLAHE gray JPEG of the {label} band's "
            f"{SIZE}^2 read: {wall * 1e3:.1f} ms (host clock), launches "
            f"{ {k: v for k, v in counts.items() if v} }, read back "
            f"{SIZE} x {SIZE} x 1")
        del dev
    shutil.rmtree(d, ignore_errors=True)
    return totals


def _quartiles(xs):
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return q1, q2, q3


def _loader_wall(opener) -> float:
    """Wall (s) of one no-warp synRGB read: `opener(band_stage)` loads both
    bands (a loader that queues band 1's stage during the read, as the CLI's
    does, is handed it), then the Tamed band stages not yet run (the default
    filter), the device included."""
    import torch

    from sarpro_tpu_torch.core import fused

    kw = dict(strategy=fused.AutoscaleStrategy.TAMED, target_size=SIZE,
              pad=True, resample_alg=None)
    t0 = time.perf_counter()
    scene = opener(lambda b: fused.synrgb_band_stage(b, copol=True, **kw))
    if scene.staged_band1 is None:
        fused.synrgb_band_stage(scene.band1, copol=True, **kw)
    fused.synrgb_band_stage(scene.band2, copol=False, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    return busy


def _trace(label: str, work: Path) -> None:
    """One warm run of `label` under torch.profiler: its wall (profiler
    included), and the device's busy time, the union of its kernel, copy
    and memset intervals in the trace, over that wall."""
    from torch.profiler import ProfilerActivity, profile

    argv, out = DRIVEN[label]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _cli_wall(label, argv, out)
    path = work / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    spans = {"kernel": [], "gpu_memcpy": [], "gpu_memset": []}
    for e in events:
        if e.get("cat") in spans and "dur" in e:
            spans[e["cat"]].append((e["ts"], e["ts"] + e["dur"]))
    if not spans["kernel"]:
        raise AssertionError(f"trace of {label}: no kernel on the device")
    busy = _busy_us([iv for v in spans.values() for iv in v]) / 1e3
    ms = {k: sum(b - a for a, b in v) / 1e3 for k, v in spans.items()}
    log(f"trace: {label} wall {wall * 1e3:.1f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / (wall * 1e3):.2f} %): {len(spans['kernel'])} kernels"
        f" {ms['kernel']:.2f} ms, {len(spans['gpu_memcpy'])} copies "
        f"{ms['gpu_memcpy']:.2f} ms, memsets {ms['gpu_memset']:.2f} ms")


def phase_walls(reps: int, safe: Path, work: Path, smi: str) -> None:
    """--walls N: every warm path of PATHS run N times more, interleaved
    (one run of each path per round), and the two no-warp synRGB loaders in
    the same rounds: open_dual_pol's full-DN upload with the device resample
    against open_pair's decimated read. Medians and quartiles, then TRACED
    under torch.profiler."""
    from sarpro_tpu_torch.io import safe as tsafe

    loaders = {
        "loader full DN (open_dual_pol)":
            lambda stage: tsafe.open_dual_pol(safe, DEVICE, SIZE,
                                              band_stage=stage),
        "loader decimated (open_pair)":
            lambda stage: tsafe.open_pair(safe, DEVICE, "Multiband", SIZE)}
    walls = {label: [] for label in [*PATHS, *loaders]}
    for _ in range(reps):
        for label in PATHS:
            walls[label].append(_cli_wall(label, *DRIVEN[label]))
        for label, opener in loaders.items():
            walls[label].append(_loader_wall(opener))
    for label, xs in walls.items():
        q1, med, q3 = (v * 1e3 for v in _quartiles(xs))
        log(f"walls: {label} median {med:.1f} ms (quartiles {q1:.1f} / "
            f"{q3:.1f}) over {reps} interleaved runs on {smi}")
    for label in TRACED:
        _trace(label, work)


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "GPU (see the module's docstring).")
    ap.add_argument("--walls", type=int, default=0, metavar="N",
                    help="after the checks, run every warm path N (>= 3) "
                    "times more, interleaved, and trace four of them")
    args = ap.parse_args()
    if args.walls and args.walls < 3:
        ap.error("--walls needs 3 runs or more")
    t_start = time.perf_counter()

    def timed(phase, *a):
        """Run `phase`, logging its seconds and the script's so far."""
        t0 = time.perf_counter()
        out = phase(*a)
        t1 = time.perf_counter()
        log(f"time: {phase.__name__} {t1 - t0:.1f} s ({t1 - t_start:.1f} s "
            f"since the start)")
        return out

    smi = timed(phase_environment)
    timed(phase_build)
    results = {}
    timed(phase_kernels, results)
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        safe, blobs, counts, walls = timed(phase_slice, work)
        timed(phase_resident, safe, blobs)
        gray_walls, _ = timed(phase_gray, safe, work)
        timed(phase_jpeg_800, safe, work)
        ew = timed(phase_exact, safe, work)
        full_walls, _ = timed(phase_full, work, ew)
        streamed_walls, _ = timed(phase_streamed, safe, work)
        _, batch_launches = timed(phase_batch, safe, ew, work, smi)
        gui_launches, _ = timed(phase_gui, safe, ew, work, smi,
                                blobs["warm clahe auto"])
        shard_launches = timed(phase_shard, safe, ew, work)
        raster_launches = timed(phase_rasters, work,
                                DRIVEN["warm clahe auto"][1],
                                RESIDENT_RGB["clahe auto"], smi)
        j2k_launches = timed(phase_jpeg2000, work, smi)
        webp_launches = timed(phase_webp, work, smi)
        formats_launches = timed(phase_formats, work, smi)
        longtail_launches = timed(phase_longtail, work, smi)
        avif_launches = timed(phase_avif, work, smi)
        if args.walls:
            timed(phase_walls, args.walls, safe, work, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    jax_package = [m for m in sys.modules
                   if m == "sarpro_tpu" or m.startswith("sarpro_tpu.")]
    if jax_package:
        raise AssertionError(f"the JAX package was imported: {jax_package}")
    import torch

    log("slice: warm walls " + ", ".join(
        f"{label} {wall * 1e3:.1f} ms" for label, wall in walls.items()
        if label.startswith("warm")) + f" on {smi}")
    log("slice: warm walls of the gray, operation and TIFF routes " + ", ".join(
        f"{label} {wall * 1e3:.1f} ms" for label, wall in
        {**gray_walls, **full_walls, **streamed_walls}.items())
        + f" on {smi}")
    kernels = []
    for name, (src, rep, *also) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep,
                 "launches": counts[REPORTED_PATH[name]][name],
                 **{k: results[name][k] for k in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms")}}
        entry["batch_launches"] = sum(c[name]
                                      for c in batch_launches.values())
        entry["gui_launches"] = gui_launches[name]
        entry["shard_launches"] = shard_launches[name]
        entry["raster_launches"] = raster_launches[name]
        entry["jpeg2000_launches"] = j2k_launches[name]
        entry["webp_launches"] = webp_launches[name]
        entry["formats_launches"] = formats_launches[name]
        entry["longtail_launches"] = longtail_launches[name]
        entry["avif_launches"] = avif_launches[name]
        if also:
            entry["also_replaces"] = also[0]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
