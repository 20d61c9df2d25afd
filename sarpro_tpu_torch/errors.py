"""Structured error hierarchy (reference: src/error.rs:6-47, src/io/sentinel1.rs:19-35).

Semantic variants mirror the reference so library users can catch the same
classes of failure; messages follow the reference's display formats.
"""
# A copy of sarpro_tpu/errors.py, so that the port imports nothing of the JAX
# package; tests/test_torch_host_copies.py holds the two equal.
from __future__ import annotations


class SarproError(Exception):
    """Base class for all SARPRO-TPU errors (reference: src/error.rs:9)."""


class IoError(SarproError):
    """Filesystem / OS error (reference: src/error.rs:10-11)."""


class SafeError(SarproError):
    """SAFE reader error (reference: src/io/sentinel1.rs:19-35)."""


class SafeMissingField(SafeError):
    """Missing field in SAFE metadata / missing directory or measurement file
    (reference: sentinel1.rs:27-28)."""

    def __init__(self, field: str):
        self.field = field
        super().__init__(f"Missing field `{field}` in SAFE metadata")


class UnsupportedProduct(SafeError):
    """Non-GRD product (reference: sentinel1.rs:29-30)."""

    def __init__(self, product_type: str):
        self.product_type = product_type
        super().__init__(f"Unsupported SAFE product type: {product_type}")


class SafeParseError(SafeError):
    """XML / raster parse error (reference: sentinel1.rs:31-32)."""


class RasterError(SarproError):
    """Raster I/O error — the slot the reference fills with GDAL errors
    (reference: src/error.rs:13-14)."""


class InvalidArgument(SarproError):
    """reference: src/error.rs:19-20."""

    def __init__(self, arg: str, value: str):
        self.arg = arg
        self.value = value
        super().__init__(f"Invalid argument: {arg}={value}")


class ZeroSize(SarproError):
    """reference: src/error.rs:22-23."""

    def __init__(self, size: int):
        self.size = size
        super().__init__(f"Size must be greater than 0, got: {size}")


class MissingArgument(SarproError):
    """reference: src/error.rs:25-26."""

    def __init__(self, arg: str):
        self.arg = arg
        super().__init__(f"Missing required argument: {arg}")


class IncompleteDataPair(SarproError):
    """reference: src/error.rs:28-34."""

    def __init__(self, operation: str, available: str):
        self.operation = operation
        self.available = available
        super().__init__(
            f"No complete polarization data available for operation: "
            f"{operation}. Available: {available}"
        )


class ProcessingError(SarproError):
    """reference: src/error.rs:36-37."""


class ExternalError(SarproError):
    """reference: src/error.rs:39-46."""
