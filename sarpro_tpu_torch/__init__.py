"""SARPRO on PyTorch and CUDA: the port of `sarpro_tpu` to an NVIDIA H100.

The JAX package stays the reference; this package runs its device work as
PyTorch tensor code plus hand-written CUDA kernels for Hopper (`ops/`,
`csrc/`), and reuses the JAX package's host-only modules (SAFE metadata,
TIFF codec, writers, native JPEG entropy coder), which import neither jax
nor Pillow.

Ported so far: fast mode (`python -m sarpro_tpu_torch.cli ... --fast`) on
one device, every route of it: single bands, the five polarization
operations, multiband GeoTIFF and synthetic-RGB JPEG, grayscale JPEG, every
autoscale strategy, u8 or u16, with or without reprojection. Exact mode,
streamed full-resolution scenes above 192 MP, sharding and batch raise
NotImplementedError naming their ROADMAP item.
"""
