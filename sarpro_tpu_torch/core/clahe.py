"""CLAHE constants of the port (copies of sarpro_tpu/core/clahe.py:33-36,
whose module imports jax; a test holds the copies equal).

Reference semantics (autoscale.rs:220-345): 8x8 tiles, 256 bins, clip
limit 2.0 x the average bin count, uniform redistribution of the excess
with a round-robin remainder, normalised CDFs, then a bilinear blend of the
4 neighbouring tile CDFs at each pixel. The fast-mode program that uses
them is `core/fused._clahe`; the exact mode's host-f64 split is not ported
yet.
"""
TILES_X = 8
TILES_Y = 8
CLIP_LIMIT = 2.0
CLAHE_BINS = 256
