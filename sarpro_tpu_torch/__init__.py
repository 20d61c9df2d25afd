"""SARPRO on PyTorch and CUDA: the port of `sarpro_tpu` to an NVIDIA H100.

The JAX package stays the reference; this package runs its device work as
PyTorch tensor code plus hand-written CUDA kernels for Hopper (`ops/`,
`csrc/`). It imports nothing of the JAX package: the host modules it needs
(errors, types, params, the SAFE parser, TIFF codec, geodesy, writers, the
native codec's bindings, the logging ring, the netCDF reader) are its own
copies, held equal to the originals by tests/test_torch_host_copies.py.

Ported, on one device: exact mode (the default of
`python -m sarpro_tpu_torch.cli`, and the in-memory API) and fast mode
(`--fast`), every route of each: single bands, the five polarization
operations, multiband GeoTIFF and synthetic-RGB JPEG, grayscale JPEG, every
autoscale strategy, u8 or u16, with or without reprojection. A
full-resolution scene above 192 MP a band runs in both modes as chunked
passes over row chunks (`core/streamed`), equal to the fused programs'
output. Batch mode (`--input-dir`, `api.process_directory_to_path`,
`parallel/batch`) runs the same routes over a directory. The GUI server
(`sarpro-gui-torch`, `gui/`) runs every single-file and batch route on the
card; `utils/` holds the logging ring and the profiler. `RasterReader`
opens TIFF, netCDF classic and PNG. `--shard-devices N` (or
`shard_devices=`) splits a scene's rows over a mesh of devices
(`parallel/`), byte-equal to the unsharded fast route.

Public API mirrors the JAX package's root (and the reference's crate root
re-exports, src/lib.rs:217-240): the types, errors and ProcessingParams at
once, the rest on first use.
"""

# the JAX package's version, which `--version` and the sidecars carry
__version__ = "0.5.0"

from .types import (  # noqa: F401,E402
    AutoscaleStrategy,
    BitDepth,
    BitDepthArg,
    InputFormat,
    OutputFormat,
    Polarization,
    PolarizationOperation,
    ProcessingOperation,
    SyntheticRgbMode,
)
from .errors import (  # noqa: F401,E402
    ExternalError,
    IncompleteDataPair,
    InvalidArgument,
    MissingArgument,
    ProcessingError,
    SarproError,
    ZeroSize,
)
from .params import ProcessingParams  # noqa: F401,E402


def __getattr__(name):
    # Lazy heavyweight imports (pull in torch) — keep `import
    # sarpro_tpu_torch` fast.
    _api_names = {
        "ProcessedImage", "BatchReport", "process_safe_to_path",
        "process_safe_to_buffer", "process_safe_to_buffer_with_mode",
        "process_directory_to_path", "process_safe_with_options",
        "iterate_safe_products", "save_image", "save_multiband_image",
        "load_polarization", "load_operation",
    }
    if name in _api_names:
        from . import api

        return getattr(api, name)
    if name in ("SafeReader", "SafeMetadata", "TargetCrsArg"):
        from .io import safe

        return getattr(safe, name)
    # reader/writer helpers re-exported at the crate root in the reference
    # (src/lib.rs:227-234)
    if name in ("RasterReader", "RasterMetadata"):
        from .io import raster

        return getattr(raster, name)
    if name in ("create_jpeg_metadata_sidecar", "embed_tiff_metadata",
                "extract_metadata_fields"):
        from .io.writers import metadata as _md

        return getattr(_md, name)
    if name in ("SafeError", "RasterError", "UnsupportedProduct"):
        from . import errors as _errors

        return getattr(_errors, name)
    raise AttributeError(
        f"module 'sarpro_tpu_torch' has no attribute {name!r}")
