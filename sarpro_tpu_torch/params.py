"""Processing parameters for config files / presets (reference: src/core/params.rs:6-41).

JSON round-trip uses the same field names and the same enum spellings as the
reference's serde output, so presets are interchangeable.
"""
# A copy of sarpro_tpu/params.py, so that the port imports nothing of the JAX
# package; tests/test_torch_host_copies.py holds the two equal.
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from .types import (
    AutoscaleStrategy,
    BitDepthArg,
    InputFormat,
    OutputFormat,
    Polarization,
    PolarizationOperation,
    SyntheticRgbMode,
)

# serde spellings for enums (reference derives Serialize on variant names)
_FORMAT_SER = {OutputFormat.TIFF: "TIFF", OutputFormat.JPEG: "JPEG"}
_INPUT_SER = {InputFormat.SAFE: "Safe"}
_BITDEPTH_SER = {BitDepthArg.U8: "U8", BitDepthArg.U16: "U16"}
_AUTOSCALE_SER = {s: s.name.capitalize() for s in AutoscaleStrategy}
_SYNRGB_SER = {
    SyntheticRgbMode.DEFAULT: "Default",
    SyntheticRgbMode.RGB_RATIO: "RgbRatio",
    SyntheticRgbMode.SAR_URBAN: "SarUrban",
    SyntheticRgbMode.ENHANCED: "Enhanced",
}
_OP_SER = {
    PolarizationOperation.SUM: "Sum",
    PolarizationOperation.DIFF: "Diff",
    PolarizationOperation.RATIO: "Ratio",
    PolarizationOperation.NDIFF: "NDiff",
    PolarizationOperation.LOG_RATIO: "LogRatio",
}


def _ser_polarization(p: Polarization):
    if p.kind == "op":
        return {"OP": _OP_SER[p.op]}
    return p.kind.capitalize() if p.kind != "multiband" else "Multiband"


def _de_polarization(v) -> Polarization:
    if isinstance(v, dict):
        (op_name,) = v.get("OP") and [v["OP"]] or [None]
        for op, name in _OP_SER.items():
            if name == op_name:
                return Polarization.OP(op)
        raise ValueError(f"invalid polarization op: {v!r}")
    return Polarization.from_cli(str(v).lower())


def _de_enum(table: dict, v: str):
    for k, name in table.items():
        if name == v or name.lower() == str(v).lower():
            return k
    raise ValueError(f"invalid enum value: {v!r}")


@dataclasses.dataclass
class ProcessingParams:
    """Typed parameter aggregate (reference: src/core/params.rs:8-24).

    Defaults mirror the reference (params.rs:26-41): TIFF, SAFE, U8, Vv, Clahe,
    Default synRGB, original size, no pad, no target CRS, lanczos resampling.
    """

    format: OutputFormat = OutputFormat.TIFF
    input_format: InputFormat = InputFormat.SAFE
    bit_depth: BitDepthArg = BitDepthArg.U8
    polarization: Polarization = Polarization.VV
    autoscale: AutoscaleStrategy = AutoscaleStrategy.CLAHE
    synrgb_mode: SyntheticRgbMode = SyntheticRgbMode.DEFAULT
    size: Optional[int] = None
    pad: bool = False
    target_crs: Optional[str] = None
    resample_alg: Optional[str] = "lanczos"

    def to_dict(self) -> dict:
        return {
            "format": _FORMAT_SER[self.format],
            "input_format": _INPUT_SER[self.input_format],
            "bit_depth": _BITDEPTH_SER[self.bit_depth],
            "polarization": _ser_polarization(self.polarization),
            "autoscale": _AUTOSCALE_SER[self.autoscale],
            "synrgb_mode": _SYNRGB_SER[self.synrgb_mode],
            "size": self.size,
            "pad": self.pad,
            "target_crs": self.target_crs,
            "resample_alg": self.resample_alg,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ProcessingParams":
        p = cls()
        if "format" in d:
            p.format = _de_enum(_FORMAT_SER, d["format"])
        if "input_format" in d:
            p.input_format = _de_enum(_INPUT_SER, d["input_format"])
        if "bit_depth" in d:
            p.bit_depth = _de_enum(_BITDEPTH_SER, d["bit_depth"])
        if "polarization" in d:
            p.polarization = _de_polarization(d["polarization"])
        if "autoscale" in d:
            p.autoscale = _de_enum(_AUTOSCALE_SER, d["autoscale"])
        if "synrgb_mode" in d:
            p.synrgb_mode = _de_enum(_SYNRGB_SER, d["synrgb_mode"])
        p.size = d.get("size", p.size)
        p.pad = bool(d.get("pad", p.pad))
        p.target_crs = d.get("target_crs", p.target_crs)
        p.resample_alg = d.get("resample_alg", p.resample_alg)
        return p

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "ProcessingParams":
        """Parse JSON, tolerating a `//`-comment header by seeking the first
        '{' (the reference's GUI preset format — src/gui/models.rs:278-309)."""
        start = text.find("{")
        if start < 0:
            raise ValueError("no JSON object found")
        return cls.from_dict(json.loads(text[start:]))
