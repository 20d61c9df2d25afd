"""SARPRO on PyTorch and CUDA: the port of `sarpro_tpu` to an NVIDIA H100.

The JAX package stays the reference; this package runs its device work as
PyTorch tensor code plus hand-written CUDA kernels for Hopper (`ops/`,
`csrc/`). It imports nothing of the JAX package: the host modules it needs
(errors, types, params, the SAFE parser, TIFF codec, geodesy, writers, the
native codec's bindings) are its own copies, held equal to the originals by
tests/test_torch_host_copies.py.

Ported so far, on one device: exact mode (the default of
`python -m sarpro_tpu_torch.cli`, and the in-memory API) and fast mode
(`--fast`), every route of each: single bands, the five polarization
operations, multiband GeoTIFF and synthetic-RGB JPEG, grayscale JPEG, every
autoscale strategy, u8 or u16, with or without reprojection. A
full-resolution scene above 192 MP a band runs in both modes as chunked
passes over row chunks (`core/streamed`), equal to the fused programs' output.
Sharding and batch raise NotImplementedError naming their ROADMAP item.
"""

# the JAX package's version, which `--version` and the sidecars carry
__version__ = "0.5.0"
