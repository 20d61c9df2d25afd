"""SARPRO on PyTorch and CUDA: the port of `sarpro_tpu` to an NVIDIA H100.

The JAX package stays the reference; this package runs its device work as
PyTorch tensor code plus hand-written CUDA kernels for Hopper (`ops/`,
`csrc/`), and reuses the JAX package's host-only modules (SAFE metadata,
TIFF codec, writers, native JPEG entropy coder), which import neither jax
nor Pillow.

Ported so far: the dual-pol SAFE -> Tamed or CLAHE suppressed
synthetic-RGB JPEG product, with or without reprojection
(`python -m sarpro_tpu_torch.cli ... -f jpeg --polarization multiband
--autoscale clahe --target-crs auto --fast`).
"""
