"""NTv2 (.gsb) grid-shift reader — distortion-grid datum transformations.

The reference reaches these through GDAL/PROJ (`gdalwarp` consults the
installed PROJ grids when an EPSG op is grid-based, e.g. DHDN→ETRS89 via
BETA2007; reference: src/io/sentinel1.rs:988-1003 shells out to gdalwarp).
This is a self-contained parser for the public NTv2 binary format:

  * 11 overview records of 16 bytes (8-byte name + 8-byte value),
  * per-subgrid 11 header records, then GS_COUNT nodes of 4 float32
    (lat shift, lon shift, two accuracies), all in arc-seconds,
  * longitudes are POSITIVE WEST (so east longitudes appear negated),
  * nodes run row-major from (S_LAT, E_LONG), longitude index increasing
    westward, latitude rows increasing northward.

Both byte orders are handled (NUM_OREC must parse as 11). Grids are looked
up in $PROJ_DATA, /usr/share/proj, and ~/.local/share/proj — the same
locations PROJ uses — so the framework matches what cs2cs/gdalwarp do on
the same machine, and degrades to the datum's ECEF Helmert fallback when
the grid file is absent (PROJ's own grid-free behavior).
"""
# A copy of sarpro_tpu/io/ntv2.py, so that the port imports nothing of the JAX
# package; tests/test_torch_host_copies.py holds the two equal.
from __future__ import annotations

import dataclasses
import os
import struct
from pathlib import Path
from typing import Optional

import numpy as np

def _search_dirs():
    # evaluated per lookup so PROJ_DATA set after import still works
    return (
        os.environ.get("PROJ_DATA") or os.environ.get("PROJ_LIB"),
        "/usr/share/proj",
        str(Path.home() / ".local" / "share" / "proj"),
    )


@dataclasses.dataclass
class _SubGrid:
    name: str
    parent: str
    s_lat: float      # arc-seconds
    n_lat: float
    e_long: float     # arc-seconds, positive WEST
    w_long: float
    lat_inc: float
    lon_inc: float
    shifts: np.ndarray  # (nrows, ncols, 2) f32: lat shift, west-lon shift

    def contains(self, lat_sec, west_sec):
        return ((lat_sec >= self.s_lat) & (lat_sec <= self.n_lat)
                & (west_sec >= self.e_long) & (west_sec <= self.w_long))

    @property
    def cell_area(self) -> float:
        return self.lat_inc * self.lon_inc


class Ntv2Grid:
    """One parsed .gsb file; `shift(lon, lat)` interpolates arc-second
    shifts in the SOURCE datum's coordinates."""

    def __init__(self, path):
        data = Path(path).read_bytes()
        for endian in ("<", ">"):
            if struct.unpack(endian + "i", data[8:12])[0] == 11:
                break
        else:
            raise ValueError(f"not an NTv2 grid: {path}")

        def _records(off, n):
            out = {}
            for i in range(n):
                rec = data[off + 16 * i: off + 16 * (i + 1)]
                out[rec[:8].decode("ascii", "replace").strip()] = rec[8:16]
            return out

        def _d(rec):
            return struct.unpack(endian + "d", rec)[0]

        def _i(rec):
            return struct.unpack(endian + "i", rec[:4])[0]

        head = _records(0, 11)
        n_sub = _i(head["NUM_FILE"])
        self.source = head["SYSTEM_F"].decode("ascii", "replace").strip()
        self.target = head["SYSTEM_T"].decode("ascii", "replace").strip()
        self.subgrids: list[_SubGrid] = []
        off = 11 * 16
        for _ in range(n_sub):
            sub = _records(off, 11)
            off += 11 * 16
            count = _i(sub["GS_COUNT"])
            vals = np.frombuffer(
                data, dtype=np.dtype(endian + "f4"), count=count * 4,
                offset=off,
            ).reshape(count, 4)
            off += count * 16
            g = _SubGrid(
                name=sub["SUB_NAME"].decode("ascii", "replace").strip(),
                parent=sub["PARENT"].decode("ascii", "replace").strip(),
                s_lat=_d(sub["S_LAT"]), n_lat=_d(sub["N_LAT"]),
                e_long=_d(sub["E_LONG"]), w_long=_d(sub["W_LONG"]),
                lat_inc=_d(sub["LAT_INC"]), lon_inc=_d(sub["LONG_INC"]),
                shifts=np.ascontiguousarray(vals[:, :2]).reshape(
                    round((_d(sub["N_LAT"]) - _d(sub["S_LAT"]))
                          / _d(sub["LAT_INC"])) + 1,
                    round((_d(sub["W_LONG"]) - _d(sub["E_LONG"]))
                          / _d(sub["LONG_INC"])) + 1, 2),
            )
            self.subgrids.append(g)

    def shift(self, lon_deg, lat_deg):
        """Bilinear (dlat_sec, dwest_sec) at source-datum lon/lat; NaN for
        points outside every subgrid (caller falls back to Helmert)."""
        lon = np.asarray(lon_deg, np.float64)
        lat = np.asarray(lat_deg, np.float64)
        lat_sec = lat * 3600.0
        west_sec = -lon * 3600.0
        out = np.full(np.broadcast(lon, lat).shape + (2,), np.nan)
        # finest (smallest-cell) containing subgrid wins, densest first
        for g in sorted(self.subgrids, key=lambda s: s.cell_area):
            m = g.contains(lat_sec, west_sec) & np.isnan(out[..., 0])
            if not np.any(m):
                continue
            r = (np.asarray(lat_sec)[m] - g.s_lat) / g.lat_inc
            c = (np.asarray(west_sec)[m] - g.e_long) / g.lon_inc
            nrows, ncols = g.shifts.shape[:2]
            r0 = np.clip(np.floor(r).astype(int), 0, nrows - 2)
            c0 = np.clip(np.floor(c).astype(int), 0, ncols - 2)
            fr = r - r0
            fc = c - c0
            s = g.shifts
            val = ((1 - fr)[:, None] * (1 - fc)[:, None] * s[r0, c0]
                   + (1 - fr)[:, None] * fc[:, None] * s[r0, c0 + 1]
                   + fr[:, None] * (1 - fc)[:, None] * s[r0 + 1, c0]
                   + fr[:, None] * fc[:, None] * s[r0 + 1, c0 + 1])
            out[m] = val
        return out[..., 0], out[..., 1]

    def apply(self, lon_deg, lat_deg, forward: bool = True):
        """Source→target (forward) or target→source datum shift in degrees.
        Returns (lon, lat, valid_mask); invalid points are passed through.
        The inverse iterates the forward grid (shifts are smooth, a few
        fixed-point steps reach well under the grid's accuracy)."""
        lon = np.asarray(lon_deg, np.float64)
        lat = np.asarray(lat_deg, np.float64)
        if forward:
            dlat, dwest = self.shift(lon, lat)
            ok = ~np.isnan(dlat)
            lon2 = np.where(ok, lon - np.nan_to_num(dwest) / 3600.0, lon)
            lat2 = np.where(ok, lat + np.nan_to_num(dlat) / 3600.0, lat)
            return lon2, lat2, ok
        src_lon, src_lat = lon.copy(), lat.copy()
        ok = np.ones(np.broadcast(lon, lat).shape, bool)
        for _ in range(4):
            dlat, dwest = self.shift(src_lon, src_lat)
            ok = ~np.isnan(dlat)
            src_lon = np.where(ok, lon + np.nan_to_num(dwest) / 3600.0, lon)
            src_lat = np.where(ok, lat - np.nan_to_num(dlat) / 3600.0, lat)
        return src_lon, src_lat, ok


_CACHE: dict = {}


def load_grid(filename: str) -> Optional[Ntv2Grid]:
    """Locate + parse a grid by filename via the PROJ search paths; None
    when absent or unreadable (any parse failure — truncated headers raise
    KeyError/IndexError, bad node counts ValueError — degrades to the
    caller's Helmert fallback). Parsed grids are cached by resolved path;
    misses are NOT cached, so grids installed (or PROJ_DATA set) after
    first use are picked up."""
    for d in _search_dirs():
        if not d:
            continue
        p = Path(d) / filename
        if not p.is_file():
            continue
        key = str(p)
        if key in _CACHE:
            return _CACHE[key]
        try:
            grid = Ntv2Grid(p)
        except Exception:  # noqa: BLE001 — malformed binary, any shape
            grid = None
        _CACHE[key] = grid
        return grid
    return None
