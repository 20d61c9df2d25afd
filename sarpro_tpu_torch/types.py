"""Shared types and enums used across SARPRO-TPU.

Mirrors the reference type surface (reference: src/types.rs:8-193) — the same
enums, the same CLI spellings, the same display names — re-expressed as Python
enums. These are pure host-side types; device code receives plain scalars.
"""
# A copy of sarpro_tpu/types.py, so that the port imports nothing of the JAX
# package; tests/test_torch_host_copies.py holds the two equal.
from __future__ import annotations

import enum


class PolarizationOperation(enum.Enum):
    """Dual-pol pixelwise operation (reference: src/types.rs:8-27)."""

    SUM = "sum"
    DIFF = "diff"
    RATIO = "ratio"
    NDIFF = "n-diff"
    LOG_RATIO = "log-ratio"

    @property
    def display(self) -> str:
        return {
            PolarizationOperation.SUM: "Sum",
            PolarizationOperation.DIFF: "Diff",
            PolarizationOperation.RATIO: "Ratio",
            PolarizationOperation.NDIFF: "NDiff",
            PolarizationOperation.LOG_RATIO: "LogRatio",
        }[self]

    @property
    def metadata_label(self) -> str:
        """Label used in save orchestration (reference: src/core/processing/save.rs:35-48)."""
        return {
            PolarizationOperation.SUM: "sum",
            PolarizationOperation.DIFF: "difference",
            PolarizationOperation.RATIO: "ratio",
            PolarizationOperation.NDIFF: "normalized_diff",
            PolarizationOperation.LOG_RATIO: "log_ratio",
        }[self]


class Polarization:
    """Polarization selector: vv/vh/hh/hv, multiband, or an operation.

    The reference models this as a Rust enum with an `OP(PolarizationOperation)`
    variant (src/types.rs:29-37). Here: singletons for the band selectors plus
    instances wrapping an operation.
    """

    __slots__ = ("kind", "op")

    def __init__(self, kind: str, op: PolarizationOperation | None = None):
        self.kind = kind
        self.op = op

    def __eq__(self, other):
        return (
            isinstance(other, Polarization)
            and self.kind == other.kind
            and self.op == other.op
        )

    def __hash__(self):
        return hash((self.kind, self.op))

    def __repr__(self):
        if self.kind == "op":
            return f"Polarization.OP({self.op.display})"
        return f"Polarization.{self.kind.upper()}"

    @property
    def display(self) -> str:
        if self.kind == "op":
            return self.op.display
        return self.kind.capitalize()

    # CLI spellings (reference: src/types.rs:75-98)
    @property
    def cli_value(self) -> str:
        if self.kind == "op":
            return self.op.value
        return self.kind

    @classmethod
    def from_cli(cls, s: str) -> "Polarization":
        s = s.lower()
        if s in ("vv", "vh", "hh", "hv", "multiband"):
            return _POL_SINGLETONS[s]
        for op in PolarizationOperation:
            if op.value == s:
                return cls("op", op)
        raise ValueError(f"invalid polarization: {s!r}")

    @classmethod
    def cli_choices(cls) -> list[str]:
        return ["vv", "vh", "hh", "hv", "multiband"] + [
            op.value for op in PolarizationOperation
        ]


_POL_SINGLETONS = {k: Polarization(k) for k in ("vv", "vh", "hh", "hv", "multiband")}
Polarization.VV = _POL_SINGLETONS["vv"]
Polarization.VH = _POL_SINGLETONS["vh"]
Polarization.HH = _POL_SINGLETONS["hh"]
Polarization.HV = _POL_SINGLETONS["hv"]
Polarization.MULTIBAND = _POL_SINGLETONS["multiband"]
Polarization.OP = staticmethod(lambda op: Polarization("op", op))


class ProcessingOperation:
    """What produced the saved image (reference: src/types.rs:40-56)."""

    __slots__ = ("kind", "op")

    def __init__(self, kind: str, op: PolarizationOperation | None = None):
        self.kind = kind
        self.op = op

    def __eq__(self, other):
        return (
            isinstance(other, ProcessingOperation)
            and self.kind == other.kind
            and self.op == other.op
        )

    def __hash__(self):
        return hash((self.kind, self.op))

    def __repr__(self):
        if self.kind == "polar_op":
            return f"ProcessingOperation.PolarOp({self.op.display})"
        return f"ProcessingOperation.{self.kind}"

    @property
    def metadata_label(self) -> str | None:
        """Operation label passed to metadata writers (reference: save.rs:35-48)."""
        if self.kind == "single_band":
            return None
        if self.kind == "multiband_vv_vh":
            return "multiband_vv_vh"
        if self.kind == "multiband_hh_hv":
            return "multiband_hh_hv"
        return self.op.metadata_label


ProcessingOperation.SINGLE_BAND = ProcessingOperation("single_band")
ProcessingOperation.MULTIBAND_VV_VH = ProcessingOperation("multiband_vv_vh")
ProcessingOperation.MULTIBAND_HH_HV = ProcessingOperation("multiband_hh_hv")
ProcessingOperation.PolarOp = staticmethod(
    lambda op: ProcessingOperation("polar_op", op)
)


class AutoscaleStrategy(enum.Enum):
    """Autoscale strategy (reference: src/types.rs:114-137)."""

    STANDARD = "standard"
    ROBUST = "robust"
    ADAPTIVE = "adaptive"
    EQUALIZED = "equalized"
    CLAHE = "clahe"
    TAMED = "tamed"
    DEFAULT = "default"

    @property
    def display(self) -> str:
        return self.name.capitalize()


class InputFormat(enum.Enum):
    """Input container (reference: src/types.rs:139-142). Only SAFE."""

    SAFE = "safe"


class BitDepthArg(enum.Enum):
    """CLI-facing bit depth (reference: src/types.rs:144-148)."""

    U8 = "u8"
    U16 = "u16"

    def to_bit_depth(self) -> "BitDepth":
        return BitDepth.U8 if self is BitDepthArg.U8 else BitDepth.U16


class OutputFormat(enum.Enum):
    """Output container (reference: src/types.rs:150-165)."""

    TIFF = "tiff"
    JPEG = "jpeg"

    @property
    def extension(self) -> str:
        # Batch naming uses .tiff / .jpg (reference: src/cli/runner.rs:300-307)
        return "tiff" if self is OutputFormat.TIFF else "jpg"


class BitDepth(enum.Enum):
    """Internal bit depth (reference: src/types.rs:167-173)."""

    U8 = "u8"
    U16 = "u16"

    @property
    def max_val(self) -> float:
        return 255.0 if self is BitDepth.U8 else 65535.0


class SyntheticRgbMode(enum.Enum):
    """Synthetic RGB composition mode (reference: src/types.rs:175-193).

    All modes currently alias Default, deliberately preserved
    (reference: src/core/processing/synthetic_rgb.rs:72-79, CHANGELOG.md:70-71).
    """

    DEFAULT = "default"
    RGB_RATIO = "rgb-ratio"
    SAR_URBAN = "sar-urban"
    ENHANCED = "enhanced"

    @property
    def display(self) -> str:
        return {
            SyntheticRgbMode.DEFAULT: "Default",
            SyntheticRgbMode.RGB_RATIO: "RgbRatio",
            SyntheticRgbMode.SAR_URBAN: "SarUrban",
            SyntheticRgbMode.ENHANCED: "Enhanced",
        }[self]
