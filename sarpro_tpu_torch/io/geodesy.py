"""Geodesy: UTM/UPS projection math, EPSG↔WKT, auto-CRS resolution, TPS fitting.

Replaces the reference's gdalwarp/gdalinfo subprocess dependencies
(src/io/sentinel1.rs:988-1071, :1613-1808) with self-contained math:

  * Transverse Mercator via 6th-order Krüger series (Karney 2011) — sub-mm
    agreement with proj's etmerc for UTM use;
  * Polar Stereographic (UPS) for the polar EPSG codes the auto-resolver emits;
  * `lonlat_to_epsg` with the UPS poles and Norway/Svalbard exceptions
    (reference: sentinel1.rs:1766-1808);
  * `resolve_auto_target_crs` from measurement GCP centroids
    (reference: sentinel1.rs:1613-1764);
  * thin-plate-spline fitting from GCPs (the host half of the on-device warp,
    standing in for `gdalwarp -tps`, reference: sentinel1.rs:1016-1028).

Everything here is host-side float64; the device warp kernel consumes only
the small mapping grids this module produces.
"""
# A copy of sarpro_tpu/io/geodesy.py, so that the port imports nothing of the
# JAX package; tests/test_torch_host_copies.py holds the two equal.
from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("sarpro")

# WGS84
_A = 6378137.0
_F = 1.0 / 298.257223563
_N = _F / (2.0 - _F)
_E2 = _F * (2.0 - _F)
_E = np.sqrt(_E2)

_n = _N


def _alpha_coeffs(n):
    """Krüger forward series coefficients (order 6) for third flattening n."""
    return np.array([
        n / 2 - 2 * n**2 / 3 + 5 * n**3 / 16 + 41 * n**4 / 180
        - 127 * n**5 / 288 + 7891 * n**6 / 37800,
        13 * n**2 / 48 - 3 * n**3 / 5 + 557 * n**4 / 1440 + 281 * n**5 / 630
        - 1983433 * n**6 / 1935360,
        61 * n**3 / 240 - 103 * n**4 / 140 + 15061 * n**5 / 26880
        + 167603 * n**6 / 181440,
        49561 * n**4 / 161280 - 179 * n**5 / 168 + 6601661 * n**6 / 7257600,
        34729 * n**5 / 80640 - 3418889 * n**6 / 1995840,
        212378941 * n**6 / 319334400,
    ])


def _beta_coeffs(n):
    """Krüger inverse series coefficients (order 6)."""
    return np.array([
        n / 2 - 2 * n**2 / 3 + 37 * n**3 / 96 - n**4 / 360
        - 81 * n**5 / 512 + 96199 * n**6 / 604800,
        n**2 / 48 + n**3 / 15 - 437 * n**4 / 1440 + 46 * n**5 / 105
        - 1118711 * n**6 / 3870720,
        17 * n**3 / 480 - 37 * n**4 / 840 - 209 * n**5 / 4480
        + 5569 * n**6 / 90720,
        4397 * n**4 / 161280 - 11 * n**5 / 504 - 830251 * n**6 / 7257600,
        4583 * n**5 / 161280 - 108847 * n**6 / 3991680,
        20648693 * n**6 / 638668800,
    ])


def _delta_coeffs(n):
    """Conformal → geodetic latitude series coefficients (order 6)."""
    return np.array([
        2 * n - 2 * n**2 / 3 - 2 * n**3 + 116 * n**4 / 45
        + 26 * n**5 / 45 - 2854 * n**6 / 675,
        7 * n**2 / 3 - 8 * n**3 / 5 - 227 * n**4 / 45 + 2704 * n**5 / 315
        + 2323 * n**6 / 945,
        56 * n**3 / 15 - 136 * n**4 / 35 - 1262 * n**5 / 105
        + 73814 * n**6 / 2835,
        4279 * n**4 / 630 - 332 * n**5 / 35 - 399572 * n**6 / 14175,
        4174 * n**5 / 315 - 144838 * n**6 / 6237,
        601676 * n**6 / 22275,
    ])


# Rectifying radius
_A_REC = _A / (1 + _n) * (1 + _n**2 / 4 + _n**4 / 64 + _n**6 / 256)
_ALPHA = _alpha_coeffs(_n)
_BETA = _beta_coeffs(_n)
_DELTA = _delta_coeffs(_n)

UTM_K0 = 0.9996
UTM_FE = 500000.0
UTM_FN_SOUTH = 10000000.0
UPS_K0 = 0.994
UPS_FE = 2000000.0
UPS_FN = 2000000.0


def tm_forward(lon_deg, lat_deg, lon0_deg: float):
    """Transverse Mercator forward (no scale/false offsets): returns (x, y)
    in meters relative to the central meridian. Array-friendly f64.
    Delegates to the generic-ellipsoid Krüger series on WGS84 — one copy of
    the order-6 series math."""
    return tm_forward_e(lon_deg, lat_deg, lon0_deg, "wgs84")


def tm_inverse(x, y, lon0_deg: float):
    """Transverse Mercator inverse: meters (relative) → (lon, lat) degrees."""
    return tm_inverse_e(x, y, lon0_deg, "wgs84")


def utm_forward(lon_deg, lat_deg, zone: int, south: bool):
    """UTM forward: (lon, lat)° → (easting, northing) m."""
    lon0 = zone * 6.0 - 183.0
    x, y = tm_forward(lon_deg, lat_deg, lon0)
    e = UTM_K0 * x + UTM_FE
    n = UTM_K0 * y + (UTM_FN_SOUTH if south else 0.0)
    return e, n


def utm_inverse(easting, northing, zone: int, south: bool):
    lon0 = zone * 6.0 - 183.0
    x = (np.asarray(easting, np.float64) - UTM_FE) / UTM_K0
    y = (np.asarray(northing, np.float64) - (UTM_FN_SOUTH if south else 0.0)) / UTM_K0
    return tm_inverse(x, y, lon0)


def ups_forward(lon_deg, lat_deg, north: bool):
    """Polar stereographic (UPS, EPSG method 9810 variant A) forward.

    The easting term is FE + ρ·sin(λ−λ0) for BOTH aspects; only the
    northing's cos term flips sign for south. (Round 1 negated λ for the
    south aspect, mirroring eastings — invisible to round-trip tests,
    caught against the EPSG worked example.)"""
    lon = np.radians(np.asarray(lon_deg, np.float64))
    sign = 1.0 if north else -1.0
    lat = sign * np.radians(np.asarray(lat_deg, np.float64))
    s = np.sin(lat)
    t = np.tan(np.pi / 4 - lat / 2) * ((1 + _E * s) / (1 - _E * s)) ** (_E / 2)
    rho = 2 * _A * UPS_K0 * t / np.sqrt((1 + _E) ** (1 + _E) * (1 - _E) ** (1 - _E))
    x = UPS_FE + rho * np.sin(lon)
    y = UPS_FN - sign * rho * np.cos(lon)
    return x, y


def webmercator_forward(lon_deg, lat_deg):
    """EPSG:3857 Pseudo-Mercator forward (spherical formulas on WGS84
    lon/lat, per the EPSG 1024 method gdalwarp uses for -t_srs EPSG:3857)."""
    lon = np.radians(np.asarray(lon_deg, np.float64))
    lat = np.radians(np.asarray(lat_deg, np.float64))
    return _A * lon, _A * np.log(np.tan(np.pi / 4 + lat / 2))


def webmercator_inverse(x, y):
    lon = np.degrees(np.asarray(x, np.float64) / _A)
    lat = np.degrees(2 * np.arctan(np.exp(np.asarray(y, np.float64) / _A)) - np.pi / 2)
    return lon, lat


def mercator_forward(lon_deg, lat_deg):
    """EPSG:3395 World Mercator forward (ellipsoidal, isometric latitude)."""
    lon = np.radians(np.asarray(lon_deg, np.float64))
    lat = np.radians(np.asarray(lat_deg, np.float64))
    s = np.sin(lat)
    psi = np.arctanh(s) - _E * np.arctanh(_E * s)
    return _A * lon, _A * psi


def mercator_inverse(x, y):
    """Ellipsoidal Mercator inverse via the conformal→geodetic series."""
    chi = 2 * np.arctan(np.exp(np.asarray(y, np.float64) / _A)) - np.pi / 2
    lat = chi.copy()
    for j in range(6):
        lat = lat + _DELTA[j] * np.sin(2.0 * (j + 1) * chi)
    return np.degrees(np.asarray(x, np.float64) / _A), np.degrees(lat)


def _polar_stereo_scale(lat_ts, k0, a, e, e2):
    """ρ/t multiplier for variant B (lat_ts) or variant A (k0 at the pole,
    EPSG method 9810)."""
    if lat_ts is not None and abs(abs(lat_ts) - 90.0) > 1e-9:
        lat_c = abs(np.radians(lat_ts))
        sc = np.sin(lat_c)
        t_c = np.tan(np.pi / 4 - lat_c / 2) * (
            (1 + e * sc) / (1 - e * sc)) ** (e / 2)
        m_c = np.cos(lat_c) / np.sqrt(1 - e2 * sc * sc)
        return a * m_c / t_c
    return (2.0 * a * (k0 if k0 is not None else 1.0)
            / np.sqrt((1 + e) ** (1 + e) * (1 - e) ** (1 - e)))


def polar_stereo_forward(lon_deg, lat_deg, lat_ts, lon0: float,
                         fe: float, fn: float, north: bool,
                         k0=None, a: float = _A, e: float = _E,
                         e2: float = _E2):
    """Polar Stereographic variant B (EPSG method 9829, scale defined by a
    standard parallel `lat_ts`) or variant A (9810, `k0` at the pole when
    `lat_ts` is None). Covers the polar-science grids (EPSG:3413/3976
    NSIDC, EPSG:3031 Antarctic) and the dynamic `+proj=stere` family."""
    sign = 1.0 if north else -1.0
    # easting uses λ−λ0 unmirrored for both aspects (EPSG method 9829; cf.
    # the ups_forward note on the round-1 south-aspect mirror bug)
    lon = np.radians(np.asarray(lon_deg, np.float64) - lon0)
    lat = sign * np.radians(np.asarray(lat_deg, np.float64))
    s = np.sin(lat)
    t = np.tan(np.pi / 4 - lat / 2) * ((1 + e * s) / (1 - e * s)) ** (e / 2)
    rho = _polar_stereo_scale(lat_ts, k0, a, e, e2) * t
    x = fe + rho * np.sin(lon)
    y = fn - sign * rho * np.cos(lon)
    return x, y


def polar_stereo_inverse(x, y, lat_ts, lon0: float, fe: float,
                         fn: float, north: bool, k0=None, a: float = _A,
                         e: float = _E, e2: float = _E2):
    sign = 1.0 if north else -1.0
    dx = np.asarray(x, np.float64) - fe
    dy = sign * (fn - np.asarray(y, np.float64))
    rho = np.hypot(dx, dy)
    t = rho / _polar_stereo_scale(lat_ts, k0, a, e, e2)
    lat = np.pi / 2 - 2 * np.arctan(t)
    for _ in range(8):
        s = np.sin(lat)
        lat = np.pi / 2 - 2 * np.arctan(
            t * ((1 - e * s) / (1 + e * s)) ** (e / 2)
        )
    lon = np.degrees(np.arctan2(dx, dy)) + lon0
    lon = (lon + 180.0) % 360.0 - 180.0  # wrap for nonzero lon0
    return lon, sign * np.degrees(lat)


# GRS80 (ETRS89 / EPSG:3035); datum shift vs WGS84 is sub-decimeter and far
# below a GRD ground sample — treated as zero like gdalwarp's default path
_A80 = 6378137.0
_F80 = 1.0 / 298.257222101
_E2_80 = _F80 * (2.0 - _F80)
_E80 = np.sqrt(_E2_80)


def _authalic_q(lat, e, e2):
    s = np.sin(lat)
    return (1 - e2) * (s / (1 - e2 * s * s)
                       - (1.0 / (2 * e)) * np.log((1 - e * s) / (1 + e * s)))


def laea_forward(lon_deg, lat_deg, lat0: float, lon0: float, fe: float,
                 fn: float, a: float = _A80, e: float = _E80,
                 e2: float = _E2_80):
    """Lambert Azimuthal Equal Area, ellipsoidal (EPSG method 9820) — the
    EPSG:3035 ETRS89-LAEA Europe grid."""
    lon = np.radians(np.asarray(lon_deg, np.float64) - lon0)
    lat = np.radians(np.asarray(lat_deg, np.float64))
    phi0 = np.radians(lat0)
    q = _authalic_q(lat, e, e2)
    q0 = _authalic_q(phi0, e, e2)
    qp = _authalic_q(np.pi / 2, e, e2)
    if abs(lat0) >= 90.0 - 1e-9:
        # polar aspect (EPSG 9820 / Snyder 24-23..24-25): the oblique D
        # constant degenerates at the pole
        sign = 1.0 if lat0 > 0 else -1.0
        rho = a * np.sqrt(np.maximum(qp - sign * q, 0.0))
        return (fe + rho * np.sin(lon), fn - sign * rho * np.cos(lon))
    beta = np.arcsin(np.clip(q / qp, -1.0, 1.0))
    beta0 = np.arcsin(np.clip(q0 / qp, -1.0, 1.0))
    rq = a * np.sqrt(qp / 2.0)
    s0 = np.sin(phi0)
    m0 = np.cos(phi0) / np.sqrt(1 - e2 * s0 * s0)
    d = a * m0 / (rq * np.cos(beta0))
    b = rq * np.sqrt(np.maximum(
        2.0 / (1 + np.sin(beta0) * np.sin(beta)
               + np.cos(beta0) * np.cos(beta) * np.cos(lon)), 0.0))
    x = fe + b * d * np.cos(beta) * np.sin(lon)
    y = fn + (b / d) * (np.cos(beta0) * np.sin(beta)
                        - np.sin(beta0) * np.cos(beta) * np.cos(lon))
    return x, y


def laea_inverse(x, y, lat0: float, lon0: float, fe: float, fn: float,
                 a: float = _A80, e: float = _E80, e2: float = _E2_80):
    phi0 = np.radians(lat0)
    q0 = _authalic_q(phi0, e, e2)
    qp = _authalic_q(np.pi / 2, e, e2)
    if abs(lat0) >= 90.0 - 1e-9:
        sign = 1.0 if lat0 > 0 else -1.0
        dx = np.asarray(x, np.float64) - fe
        dy = np.asarray(y, np.float64) - fn
        rho = np.hypot(dx, dy)
        q = sign * (qp - (rho / a) ** 2)
        beta = np.arcsin(np.clip(q / qp, -1.0, 1.0))
        lat = (beta
               + (e2 / 3 + 31 * e2**2 / 180 + 517 * e2**3 / 5040)
               * np.sin(2 * beta)
               + (23 * e2**2 / 360 + 251 * e2**3 / 3780) * np.sin(4 * beta)
               + (761 * e2**3 / 45360) * np.sin(6 * beta))
        lon = np.degrees(np.arctan2(dx, -sign * dy)) + lon0
        lon = (lon + 180.0) % 360.0 - 180.0
        return lon, np.degrees(lat)
    beta0 = np.arcsin(np.clip(q0 / qp, -1.0, 1.0))
    rq = a * np.sqrt(qp / 2.0)
    s0 = np.sin(phi0)
    m0 = np.cos(phi0) / np.sqrt(1 - e2 * s0 * s0)
    d = a * m0 / (rq * np.cos(beta0))
    dx = (np.asarray(x, np.float64) - fe) / d
    dy = (np.asarray(y, np.float64) - fn) * d
    rho = np.hypot(dx, dy)
    with np.errstate(invalid="ignore"):
        ce = 2 * np.arcsin(np.clip(rho / (2.0 * rq), -1.0, 1.0))
        beta = np.where(
            rho == 0, beta0,
            np.arcsin(np.clip(
                np.cos(ce) * np.sin(beta0)
                + np.where(rho == 0, 0.0, dy * np.sin(ce) * np.cos(beta0)
                           / np.maximum(rho, 1e-300)), -1.0, 1.0)),
        )
        lon = np.arctan2(dx * np.sin(ce),
                         rho * np.cos(beta0) * np.cos(ce)
                         - dy * np.sin(beta0) * np.sin(ce))
    # authalic -> geodetic latitude (series in e2; EPSG guidance 7-2)
    lat = (beta
           + (e2 / 3 + 31 * e2**2 / 180 + 517 * e2**3 / 5040)
           * np.sin(2 * beta)
           + (23 * e2**2 / 360 + 251 * e2**3 / 3780) * np.sin(4 * beta)
           + (761 * e2**3 / 45360) * np.sin(6 * beta))
    return np.degrees(lon) + lon0, np.degrees(lat)


# EPSG polar-science / equal-area grids: parameter tables
_POLAR_STEREO = {
    3413: dict(lat_ts=70.0, lon0=-45.0, fe=0.0, fn=0.0, north=True),
    3976: dict(lat_ts=-70.0, lon0=0.0, fe=0.0, fn=0.0, north=False),
    3031: dict(lat_ts=-71.0, lon0=0.0, fe=0.0, fn=0.0, north=False),
}
_LAEA = {
    3035: dict(lat0=52.0, lon0=10.0, fe=4321000.0, fn=3210000.0),
}


def ups_inverse(easting, northing, north: bool):
    sign = 1.0 if north else -1.0
    dx = np.asarray(easting, np.float64) - UPS_FE
    dy = sign * (UPS_FN - np.asarray(northing, np.float64))
    rho = np.hypot(dx, dy)
    t = rho * np.sqrt((1 + _E) ** (1 + _E) * (1 - _E) ** (1 - _E)) / (2 * _A * UPS_K0)
    chi = np.pi / 2 - 2 * np.arctan(t)
    lat = chi
    for _ in range(8):
        s = np.sin(lat)
        lat = np.pi / 2 - 2 * np.arctan(
            t * ((1 - _E * s) / (1 + _E * s)) ** (_E / 2)
        )
    lon = np.arctan2(dx, dy)
    return np.degrees(lon), sign * np.degrees(lat)


# ---------------------------------------------------------------------------
# National grids: generic-ellipsoid TM, Lambert Conformal Conic (1SP/2SP),
# Albers Equal Area, and the Helmert datum shifts they need.
#
# gdalwarp accepts any PROJ-known `-t_srs` (reference: sentinel1.rs:988-1003);
# these three projection methods + the ellipsoid/datum layer cover the most
# common national grids (Lambert-93, CONUS Albers, British National Grid,
# TM35FIN, ETRS89-UTM, …). Parameters match `projinfo EPSG:<code>`; outputs
# are oracle-tested against cs2cs (tests/test_warp.py).
# ---------------------------------------------------------------------------
_ELLPS = {
    "wgs84": (6378137.0, 1.0 / 298.257223563),
    "grs80": (6378137.0, 1.0 / 298.257222101),
    "airy": (6377563.396, 1.0 / 299.3249646),
    "mod_airy": (6377340.189, 1.0 / 299.3249646),
    "bessel": (6377397.155, 1.0 / 299.1528128),
    "clrk66": (6378206.4, 1.0 / 294.978698213898),
    "clrk80ign": (6378249.2, 1.0 / 293.466021293627),
    # additional PROJ-named ellipsoids reachable through the dynamic
    # projinfo resolver (values = PROJ's ellps registry)
    "intl": (6378388.0, 1.0 / 297.0),
    "krass": (6378245.0, 1.0 / 298.3),
    "grs67": (6378160.0, 1.0 / 298.247167427),
    "aust_sa": (6378160.0, 1.0 / 298.25),
    "clrk80": (6378249.145, 1.0 / 293.465),
    "wgs72": (6378135.0, 1.0 / 298.26),
    "helmert": (6378200.0, 1.0 / 298.3),
    "evrst30": (6377276.345, 1.0 / 300.8017),
}

_TM_SERIES_CACHE: dict = {}


def _tm_series(ellps: str):
    """(a, e, e2, A_rec, alpha, beta, delta) for an ellipsoid key."""
    cached = _TM_SERIES_CACHE.get(ellps)
    if cached is None:
        a, f = _ELLPS[ellps]
        n = f / (2.0 - f)
        e2 = f * (2.0 - f)
        a_rec = a / (1 + n) * (1 + n**2 / 4 + n**4 / 64 + n**6 / 256)
        cached = (a, np.sqrt(e2), e2, a_rec, _alpha_coeffs(n),
                  _beta_coeffs(n), _delta_coeffs(n))
        _TM_SERIES_CACHE[ellps] = cached
    return cached


def tm_forward_e(lon_deg, lat_deg, lon0_deg: float, ellps: str = "wgs84"):
    """Krüger-series TM forward on an arbitrary registered ellipsoid."""
    _, e, _, a_rec, alpha, _, _ = _tm_series(ellps)
    lon = np.radians(np.asarray(lon_deg, np.float64) - lon0_deg)
    lat = np.radians(np.asarray(lat_deg, np.float64))
    s = np.sin(lat)
    conf = np.arctanh(s) - e * np.arctanh(e * s)
    t = np.sinh(conf)
    xi = np.arctan2(t, np.cos(lon))
    eta = np.arcsinh(np.sin(lon) / np.sqrt(t * t + np.cos(lon) ** 2))
    xi_s = xi.copy()
    eta_s = eta.copy()
    for j in range(6):
        k = 2.0 * (j + 1)
        xi_s = xi_s + alpha[j] * np.sin(k * xi) * np.cosh(k * eta)
        eta_s = eta_s + alpha[j] * np.cos(k * xi) * np.sinh(k * eta)
    return a_rec * eta_s, a_rec * xi_s


def tm_inverse_e(x, y, lon0_deg: float, ellps: str = "wgs84"):
    _, _, _, a_rec, _, beta, delta = _tm_series(ellps)
    eta = np.asarray(x, np.float64) / a_rec
    xi = np.asarray(y, np.float64) / a_rec
    xi_p = xi.copy()
    eta_p = eta.copy()
    for j in range(6):
        k = 2.0 * (j + 1)
        xi_p = xi_p - beta[j] * np.sin(k * xi) * np.cosh(k * eta)
        eta_p = eta_p - beta[j] * np.cos(k * xi) * np.sinh(k * eta)
    chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))
    lat = chi.copy()
    for j in range(6):
        k = 2.0 * (j + 1)
        lat = lat + delta[j] * np.sin(k * chi)
    lon = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    return np.degrees(lon) + lon0_deg, np.degrees(lat)


# --- Helmert 7-parameter datum shifts (WGS84 ↔ local geodetic) -------------
# Parameters are the PROJ-default transformations for the grids below (the
# same ones cs2cs/gdalwarp pick when no NTv2 grid file is installed):
#   osgb36: "OSGB36 to WGS 84 (6)" (position vector), stored as published
#   jad69:  "JAD69 to WGS 84 (3)"  (coordinate frame), stored as published
# Each entry states the LOCAL→WGS84 transform verbatim; WGS84→local applies
# the exact inverse of it (do NOT flip parameter signs here).
_DATUM_TO_WGS84 = {
    "osgb36": dict(t=(446.448, -125.157, 542.06), r=(0.15, 0.247, 0.842),
                   s=-20.489, convention="position_vector", ellps="airy"),
    "jad69": dict(t=(-33.722, 153.789, 94.959), r=(8.581, 4.478, -4.54),
                  s=8.95, convention="coordinate_frame", ellps="clrk66"),
    # "TM65 to WGS 84 (2)" — PROJ's +towgs84 default for Irish Grid
    "tm65": dict(t=(482.5, -130.6, 564.6), r=(-1.042, -0.214, -0.631),
                 s=8.15, convention="position_vector", ellps="mod_airy"),
    # "CH1903+ to WGS 84 (1)" — geocentric translation only
    "ch1903plus": dict(t=(674.374, 15.056, 405.346), r=(0.0, 0.0, 0.0),
                       s=0.0, convention="position_vector", ellps="bessel"),
    # "CH1903 to WGS 84 (2)" — same translation (PROJ's grid-free pick;
    # the CHENyx06 grid op needs a .tif PROJ does not map from the
    # installed .gsb)
    "ch1903": dict(t=(674.374, 15.056, 405.346), r=(0.0, 0.0, 0.0),
                   s=0.0, convention="position_vector", ellps="bessel"),
    # "S-JTSK to WGS 84 (5)" (EPSG:5239, 1.0 m, Czechia) — the op cs2cs
    # late-binding picks for Czech points, NOT the 6 m (3) translation
    # that EPSG:5514's +towgs84 string advertises
    "sjtsk": dict(t=(572.213, 85.334, 461.94),
                  r=(-4.9732, -1.529, -5.2484),
                  s=3.5378, convention="coordinate_frame", ellps="bessel"),
    # "NTF to WGS 84 (1)" — geocentric translation only
    "ntf": dict(t=(-168.0, -60.0, 320.0), r=(0.0, 0.0, 0.0),
                s=0.0, convention="position_vector", ellps="clrk80ign"),
    # "DHDN to WGS 84 (4)": the BETA2007 NTv2 distortion grid (what
    # cs2cs/gdalwarp use when the grid file is installed); the Helmert
    # parameters are the grid-free "(2)" fallback for points outside the
    # grid or hosts without it
    "dhdn": dict(t=(598.1, 73.7, 418.2), r=(0.202, 0.045, -2.455),
                 s=6.7, convention="position_vector", ellps="bessel",
                 grid="BETA2007.gsb"),
}

_ARCSEC = np.pi / (180.0 * 3600.0)


def _helmert_rotation(r, convention: str) -> np.ndarray:
    rx, ry, rz = (v * _ARCSEC for v in r)
    if convention == "coordinate_frame":
        rx, ry, rz = -rx, -ry, -rz
    return np.array([
        [1.0, -rz, ry],
        [rz, 1.0, -rx],
        [-ry, rx, 1.0],
    ])


def _geodetic_to_ecef(lon_deg, lat_deg, ellps: str):
    a, _, e2, *_ = _tm_series(ellps)
    lon = np.radians(np.asarray(lon_deg, np.float64))
    lat = np.radians(np.asarray(lat_deg, np.float64))
    s = np.sin(lat)
    nu = a / np.sqrt(1 - e2 * s * s)
    return (nu * np.cos(lat) * np.cos(lon),
            nu * np.cos(lat) * np.sin(lon),
            nu * (1 - e2) * s)


def _ecef_to_geodetic(x, y, z, ellps: str):
    a, _, e2, *_ = _tm_series(ellps)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1 - e2))
    for _ in range(6):
        s = np.sin(lat)
        nu = a / np.sqrt(1 - e2 * s * s)
        lat = np.arctan2(z + e2 * nu * s, p)
    return np.degrees(np.arctan2(y, x)), np.degrees(lat)


def _datum_shift(lon, lat, datum, to_wgs84: bool):
    """Shift geodetic coordinates between WGS84 and a local datum via an
    NTv2 distortion grid when the datum declares one and the file is
    installed (what cs2cs/gdalwarp do), else via ECEF Helmert (heights
    treated as 0 and discarded — PROJ's push/pop v_3). `datum` is a name
    into _DATUM_TO_WGS84 or an inline parameter dict (dynamic CRSs)."""
    d = datum if isinstance(datum, dict) else _DATUM_TO_WGS84[datum]
    if "grid" in d:
        from .ntv2 import load_grid

        names = d["grid"] if isinstance(d["grid"], (list, tuple)) \
            else [d["grid"]]
        grid = None
        for name in names:
            grid = load_grid(name)
            if grid is not None:
                break
        if grid is not None:
            lon2, lat2, ok = grid.apply(lon, lat, forward=to_wgs84)
            if bool(np.all(ok)):
                return lon2, lat2
            # points outside the grid: Helmert fallback just for those
            hl, hb = _helmert_shift(lon, lat, d, to_wgs84)
            return np.where(ok, lon2, hl), np.where(ok, lat2, hb)
    return _helmert_shift(lon, lat, d, to_wgs84)


def _helmert_shift(lon, lat, d: dict, to_wgs84: bool):
    """`d["sense"]` says which direction the stored parameters express:
    "to_wgs84" (default, like every _DATUM_TO_WGS84 entry) or "from_wgs84"
    (pipeline-extracted dynamic datums); the opposite direction applies the
    exact inverse via solve."""
    scale = 1.0 + d["s"] * 1e-6
    rot = _helmert_rotation(d["r"], d["convention"])
    t = np.asarray(d["t"])
    params_to_wgs84 = d.get("sense", "to_wgs84") == "to_wgs84"
    src = d["ellps"] if to_wgs84 else "wgs84"
    dst = "wgs84" if to_wgs84 else d["ellps"]
    xyz = np.stack(_geodetic_to_ecef(lon, lat, src), axis=0).reshape(3, -1)
    if to_wgs84 == params_to_wgs84:
        out = scale * (rot @ xyz) + t[:, None]
    else:
        out = np.linalg.solve(rot, (xyz - t[:, None]) / scale)
    lon2, lat2 = _ecef_to_geodetic(*out, ellps=dst)
    shape = np.shape(np.asarray(lon, np.float64))
    return lon2.reshape(shape), lat2.reshape(shape)


# --- projected-grid parameter tables (from `projinfo EPSG:<code>`) ----------
_TM_GRIDS = {
    27700: dict(lat0=49.0, lon0=-2.0, k0=0.9996012717, fe=400000.0,
                fn=-100000.0, ellps="airy", datum="osgb36",
                name="OSGB36 / British National Grid"),
    3067: dict(lat0=0.0, lon0=27.0, k0=0.9996, fe=500000.0, fn=0.0,
               ellps="grs80", datum=None, name="ETRS89 / TM35FIN(E,N)"),
    25832: dict(lat0=0.0, lon0=9.0, k0=0.9996, fe=500000.0, fn=0.0,
                ellps="grs80", datum=None, name="ETRS89 / UTM zone 32N"),
    25833: dict(lat0=0.0, lon0=15.0, k0=0.9996, fe=500000.0, fn=0.0,
                ellps="grs80", datum=None, name="ETRS89 / UTM zone 33N"),
    25835: dict(lat0=0.0, lon0=27.0, k0=0.9996, fe=500000.0, fn=0.0,
                ellps="grs80", datum=None, name="ETRS89 / UTM zone 35N"),
    2193: dict(lat0=0.0, lon0=173.0, k0=0.9996, fe=1600000.0, fn=10000000.0,
               ellps="grs80", datum=None,
               name="NZGD2000 / New Zealand Transverse Mercator 2000"),
    29902: dict(lat0=53.5, lon0=-8.0, k0=1.000035, fe=200000.0, fn=250000.0,
                ellps="mod_airy", datum="tm65", name="TM65 / Irish Grid"),
    # German Gauss-Krüger zones (NTv2 BETA2007 grid-shift datum)
    31466: dict(lat0=0.0, lon0=6.0, k0=1.0, fe=2500000.0, fn=0.0,
                ellps="bessel", datum="dhdn",
                name="DHDN / 3-degree Gauss-Kruger zone 2"),
    31467: dict(lat0=0.0, lon0=9.0, k0=1.0, fe=3500000.0, fn=0.0,
                ellps="bessel", datum="dhdn",
                name="DHDN / 3-degree Gauss-Kruger zone 3"),
    31468: dict(lat0=0.0, lon0=12.0, k0=1.0, fe=4500000.0, fn=0.0,
                ellps="bessel", datum="dhdn",
                name="DHDN / 3-degree Gauss-Kruger zone 4"),
    2157: dict(lat0=53.5, lon0=-8.0, k0=0.99982, fe=600000.0, fn=750000.0,
               ellps="grs80", datum=None,
               name="IRENET95 / Irish Transverse Mercator"),
}
_LCC_GRIDS = {
    # lat1 == lat2 (or lat2 absent) selects the 1SP method (EPSG 9801)
    2154: dict(lat0=46.5, lon0=3.0, lat1=49.0, lat2=44.0, k0=1.0,
               fe=700000.0, fn=6600000.0, ellps="grs80", datum=None,
               name="RGF93 v1 / Lambert-93"),
    3347: dict(lat0=63.390675, lon0=-91.86666666666667, lat1=49.0, lat2=77.0,
               k0=1.0, fe=6200000.0, fn=3000000.0, ellps="grs80", datum=None,
               name="NAD83 / Statistics Canada Lambert"),
    24200: dict(lat0=18.0, lon0=-77.0, lat1=18.0, lat2=18.0, k0=1.0,
                fe=250000.0, fn=150000.0, ellps="clrk66", datum="jad69",
                name="JAD69 / Jamaica National Grid"),
    3978: dict(lat0=49.0, lon0=-95.0, lat1=49.0, lat2=77.0, k0=1.0,
               fe=0.0, fn=0.0, ellps="grs80", datum=None,
               name="NAD83 / Canada Atlas Lambert"),
    # Paris prime meridian expressed as a Greenwich-shifted lon0
    # (0 grad Paris = 2.33722917 deg E Greenwich); lat0 52 gr = 46.8 deg
    27572: dict(lat0=46.8, lon0=2.337229166666667, lat1=46.8, lat2=46.8,
                k0=0.99987742, fe=600000.0, fn=2200000.0,
                ellps="clrk80ign", datum="ntf",
                name="NTF (Paris) / Lambert zone II"),
}
_SOMERC_GRIDS = {
    2056: dict(lat0=46.95240555555556, lon0=7.439583333333333, k0=1.0,
               fe=2600000.0, fn=1200000.0, ellps="bessel",
               datum="ch1903plus", name="CH1903+ / LV95"),
    21781: dict(lat0=46.95240555555556, lon0=7.439583333333333, k0=1.0,
                fe=600000.0, fn=200000.0, ellps="bessel",
                datum="ch1903", name="CH1903 / LV03"),
}
_KROVAK_GRIDS = {
    # East-North variant (EPSG 1041): E = -Westing, N = -Southing
    5514: dict(lat0=49.5, lon0=24.833333333333333, alpha=30.2881397527778,
               psi1=78.5, k0=0.9999, fe=0.0, fn=0.0, ellps="bessel",
               datum="sjtsk", name="S-JTSK / Krovak East North"),
}
_ALBERS_GRIDS = {
    5070: dict(lat0=23.0, lon0=-96.0, lat1=29.5, lat2=45.5, fe=0.0, fn=0.0,
               ellps="grs80", datum=None, name="NAD83 / Conus Albers"),
    3577: dict(lat0=0.0, lon0=132.0, lat1=-18.0, lat2=-36.0, fe=0.0, fn=0.0,
               ellps="grs80", datum=None, name="GDA94 / Australian Albers"),
    3310: dict(lat0=0.0, lon0=-120.0, lat1=34.0, lat2=40.5, fe=0.0,
               fn=-4000000.0, ellps="grs80", datum=None,
               name="NAD83 / California Albers"),
}


def tmerc_grid_forward(lon, lat, p: dict):
    """Generic TM grid (EPSG 9807): k0/false offsets/non-zero lat0/datum."""
    if p["datum"]:
        lon, lat = _datum_shift(lon, lat, p["datum"], to_wgs84=False)
    x, y = tm_forward_e(lon, lat, p["lon0"], p["ellps"])
    m0 = tm_forward_e(p["lon0"], p["lat0"], p["lon0"], p["ellps"])[1]
    return p["fe"] + p["k0"] * x, p["fn"] + p["k0"] * (y - m0)


def tmerc_grid_inverse(easting, northing, p: dict):
    m0 = tm_forward_e(p["lon0"], p["lat0"], p["lon0"], p["ellps"])[1]
    x = (np.asarray(easting, np.float64) - p["fe"]) / p["k0"]
    y = (np.asarray(northing, np.float64) - p["fn"]) / p["k0"] + m0
    lon, lat = tm_inverse_e(x, y, p["lon0"], p["ellps"])
    if p["datum"]:
        lon, lat = _datum_shift(lon, lat, p["datum"], to_wgs84=True)
    return lon, lat


def _somerc_consts(p: dict):
    """Swiss Oblique Mercator constants (EPSG 9815 with azimuth = rectified
    grid angle = 90°, PROJ `somerc`): conformal double projection
    ellipsoid → Gaussian sphere → rotated equatorial Mercator
    (Swisstopo's published formulation)."""
    a, e, e2, *_ = _tm_series(p["ellps"])
    phi0 = np.radians(p["lat0"])
    s0 = np.sin(phi0)
    r_gauss = p["k0"] * a * np.sqrt(1 - e2) / (1 - e2 * s0 * s0)
    alpha = np.sqrt(1 + e2 / (1 - e2) * np.cos(phi0) ** 4)
    b0 = np.arcsin(s0 / alpha)
    k_const = (np.log(np.tan(np.pi / 4 + b0 / 2))
               - alpha * np.log(np.tan(np.pi / 4 + phi0 / 2))
               + alpha * e * np.arctanh(e * s0))
    return e, r_gauss, alpha, b0, k_const


def somerc_forward(lon_deg, lat_deg, p: dict):
    lon, lat = lon_deg, lat_deg
    if p["datum"]:
        lon, lat = _datum_shift(lon, lat, p["datum"], to_wgs84=False)
    e, r, alpha, b0, k_const = _somerc_consts(p)
    phi = np.radians(np.asarray(lat, np.float64))
    lam = np.radians(np.asarray(lon, np.float64) - p["lon0"])
    s_iso = (alpha * np.log(np.tan(np.pi / 4 + phi / 2))
             - alpha * e * np.arctanh(e * np.sin(phi)) + k_const)
    b = 2 * (np.arctan(np.exp(s_iso)) - np.pi / 4)     # sphere latitude
    li = alpha * lam                                    # sphere longitude
    # rotate the projection center to the sphere equator
    b_bar = np.arcsin(np.cos(b0) * np.sin(b)
                      - np.sin(b0) * np.cos(b) * np.cos(li))
    l_bar = np.arctan2(np.cos(b) * np.sin(li),
                       np.cos(b0) * np.cos(b) * np.cos(li)
                       + np.sin(b0) * np.sin(b))
    return (p["fe"] + r * l_bar,
            p["fn"] + r * np.arctanh(np.sin(b_bar)))


def somerc_inverse(easting, northing, p: dict):
    e, r, alpha, b0, k_const = _somerc_consts(p)
    l_bar = (np.asarray(easting, np.float64) - p["fe"]) / r
    b_bar = 2 * (np.arctan(np.exp(
        (np.asarray(northing, np.float64) - p["fn"]) / r)) - np.pi / 4)
    b = np.arcsin(np.cos(b0) * np.sin(b_bar)
                  + np.sin(b0) * np.cos(b_bar) * np.cos(l_bar))
    li = np.arctan2(np.cos(b_bar) * np.sin(l_bar),
                    np.cos(b0) * np.cos(b_bar) * np.cos(l_bar)
                    - np.sin(b0) * np.sin(b_bar))
    q = (np.log(np.tan(np.pi / 4 + b / 2)) - k_const) / alpha
    phi = b.copy()
    for _ in range(8):
        phi = 2 * (np.arctan(np.exp(q + e * np.arctanh(e * np.sin(phi))))
                   - np.pi / 4)
    lon = np.degrees(li / alpha) + p["lon0"]
    lat = np.degrees(phi)
    if p["datum"]:
        lon, lat = _datum_shift(lon, lat, p["datum"], to_wgs84=True)
    return lon, lat


def _sterea_consts(p: dict):
    """Oblique (double) Stereographic constants (EPSG method 9809, PROJ
    `sterea`): conformal sphere at φ0, then equatorial stereographic on
    the sphere (EPSG Guidance Note 7-2 formulation). Covers RD New
    (EPSG:28992) and the Pulkovo sterea grids."""
    a, e, e2, *_ = _tm_series(p["ellps"])
    phi0 = np.radians(p["lat0"])
    s0 = np.sin(phi0)
    rho0 = a * (1 - e2) / (1 - e2 * s0 * s0) ** 1.5
    nu0 = a / np.sqrt(1 - e2 * s0 * s0)
    r = np.sqrt(rho0 * nu0)
    n = np.sqrt(1 + e2 * np.cos(phi0) ** 4 / (1 - e2))
    s1 = (1 + s0) / (1 - s0)
    s2 = (1 - e * s0) / (1 + e * s0)
    w1 = (s1 * s2**e) ** n
    sin_chi00 = (w1 - 1) / (w1 + 1)
    c = ((n + s0) * (1 - sin_chi00)) / ((n - s0) * (1 + sin_chi00))
    w2 = c * w1
    chi0 = np.arcsin((w2 - 1) / (w2 + 1))
    return a, e, e2, r, n, c, chi0


def sterea_forward(lon_deg, lat_deg, p: dict):
    lon, lat = lon_deg, lat_deg
    if p["datum"]:
        lon, lat = _datum_shift(lon, lat, p["datum"], to_wgs84=False)
    _, e, _, r, n, c, chi0 = _sterea_consts(p)
    k0 = p["k0"]
    phi = np.radians(np.asarray(lat, np.float64))
    s = np.sin(phi)
    w = c * (((1 + s) / (1 - s)) * ((1 - e * s) / (1 + e * s)) ** e) ** n
    chi = np.arcsin((w - 1) / (w + 1))
    dlam = n * np.radians(np.asarray(lon, np.float64) - p["lon0"])
    b = 1 + np.sin(chi) * np.sin(chi0) + np.cos(chi) * np.cos(chi0) \
        * np.cos(dlam)
    x = p["fe"] + 2 * r * k0 * np.cos(chi) * np.sin(dlam) / b
    y = p["fn"] + 2 * r * k0 * (np.sin(chi) * np.cos(chi0)
                                - np.cos(chi) * np.sin(chi0)
                                * np.cos(dlam)) / b
    return x, y


def sterea_inverse(easting, northing, p: dict):
    _, e, e2, r, n, c, chi0 = _sterea_consts(p)
    k0 = p["k0"]
    de = np.asarray(easting, np.float64) - p["fe"]
    dn = np.asarray(northing, np.float64) - p["fn"]
    g = 2 * r * k0 * np.tan(np.pi / 4 - chi0 / 2)
    h = 4 * r * k0 * np.tan(chi0) + g
    i = np.arctan2(de, h + dn)
    j = np.arctan2(de, g - dn) - i
    chi = chi0 + 2 * np.arctan((dn - de * np.tan(j / 2)) / (2 * r * k0))
    dlam = j + 2 * i
    lon = np.degrees(dlam / n) + p["lon0"]
    # conformal-sphere isometric latitude back to geodetic (iterative)
    psi = 0.5 * np.log((1 + np.sin(chi)) / (c * (1 - np.sin(chi)))) / n
    phi = 2 * np.arctan(np.exp(psi)) - np.pi / 2
    for _ in range(8):
        s = np.sin(phi)
        psi_i = np.log(np.tan(phi / 2 + np.pi / 4)
                       * ((1 - e * s) / (1 + e * s)) ** (e / 2))
        phi = phi - (psi_i - psi) * np.cos(phi) * (1 - e2 * s * s) / (1 - e2)
    lat = np.degrees(phi)
    if p["datum"]:
        lon, lat = _datum_shift(lon, lat, p["datum"], to_wgs84=True)
    return lon, lat


def _krovak_consts(p: dict):
    """Krovak constants (EPSG method 9819): conformal sphere + oblique cone
    through the pseudo standard parallel (EPSG Guidance Note 7-2)."""
    a, e, e2, *_ = _tm_series(p["ellps"])
    phic = np.radians(p["lat0"])
    sc = np.sin(phic)
    big_a = a * np.sqrt(1 - e2) / (1 - e2 * sc * sc)
    big_b = np.sqrt(1 + e2 * np.cos(phic) ** 4 / (1 - e2))
    gamma0 = np.arcsin(sc / big_b)
    t0 = (np.tan(np.pi / 4 + gamma0 / 2)
          * ((1 + e * sc) / (1 - e * sc)) ** (e * big_b / 2)
          / np.tan(np.pi / 4 + phic / 2) ** big_b)
    psi1 = np.radians(p["psi1"])
    n = np.sin(psi1)
    r0 = p["k0"] * big_a / np.tan(psi1)
    return e, big_b, t0, n, r0, psi1, np.radians(p["alpha"])


def krovak_forward(lon_deg, lat_deg, p: dict):
    """Krovak oblique conformal conic forward, East-North axes (EPSG 1041)."""
    lon, lat = lon_deg, lat_deg
    if p["datum"]:
        lon, lat = _datum_shift(lon, lat, p["datum"], to_wgs84=False)
    e, big_b, t0, n, r0, psi1, alpha = _krovak_consts(p)
    phi = np.radians(np.asarray(lat, np.float64))
    s = np.sin(phi)
    u = 2 * (np.arctan(t0 * np.tan(np.pi / 4 + phi / 2) ** big_b
                       / ((1 + e * s) / (1 - e * s)) ** (e * big_b / 2))
             - np.pi / 4)
    v = big_b * np.radians(p["lon0"] - np.asarray(lon, np.float64))
    t = np.arcsin(np.cos(alpha) * np.sin(u)
                  + np.sin(alpha) * np.cos(u) * np.cos(v))
    d = np.arcsin(np.cos(u) * np.sin(v) / np.cos(t))
    theta = n * d
    r = r0 * np.tan(np.pi / 4 + psi1 / 2) ** n \
        / np.tan(np.pi / 4 + t / 2) ** n
    southing = r * np.cos(theta)
    westing = r * np.sin(theta)
    return p["fe"] - westing, p["fn"] - southing


def krovak_inverse(easting, northing, p: dict):
    e, big_b, t0, n, r0, psi1, alpha = _krovak_consts(p)
    westing = p["fe"] - np.asarray(easting, np.float64)
    southing = p["fn"] - np.asarray(northing, np.float64)
    r = np.hypot(westing, southing)
    theta = np.arctan2(westing, southing)
    d = theta / n
    t = 2 * (np.arctan((r0 / r) ** (1.0 / n)
                       * np.tan(np.pi / 4 + psi1 / 2)) - np.pi / 4)
    u = np.arcsin(np.cos(alpha) * np.sin(t)
                  - np.sin(alpha) * np.cos(t) * np.cos(d))
    v = np.arcsin(np.cos(t) * np.sin(d) / np.cos(u))
    phi = u.copy()
    for _ in range(8):
        s = np.sin(phi)
        phi = 2 * (np.arctan(
            t0 ** (-1.0 / big_b)
            * np.tan(np.pi / 4 + u / 2) ** (1.0 / big_b)
            * ((1 + e * s) / (1 - e * s)) ** (e / 2)) - np.pi / 4)
    lon = p["lon0"] - np.degrees(v / big_b)
    lat = np.degrees(phi)
    if p["datum"]:
        lon, lat = _datum_shift(lon, lat, p["datum"], to_wgs84=True)
    return lon, lat


def _lcc_m_t(lat, e, e2):
    s = np.sin(lat)
    m = np.cos(lat) / np.sqrt(1 - e2 * s * s)
    t = np.tan(np.pi / 4 - lat / 2) / ((1 - e * s) / (1 + e * s)) ** (e / 2)
    return m, t


def _lcc_consts(p: dict):
    a, e, e2, *_ = _tm_series(p["ellps"])
    phi0 = np.radians(p["lat0"])
    phi1 = np.radians(p["lat1"])
    phi2 = np.radians(p["lat2"])
    m1, t1 = _lcc_m_t(phi1, e, e2)
    _, t0 = _lcc_m_t(phi0, e, e2)
    if abs(p["lat1"] - p["lat2"]) < 1e-12:
        # 1SP (EPSG 9801): cone constant from the single parallel
        n = np.sin(phi1)
    else:
        m2, t2 = _lcc_m_t(phi2, e, e2)
        n = (np.log(m1) - np.log(m2)) / (np.log(t1) - np.log(t2))
    f = m1 / (n * t1**n)
    rho0 = a * f * t0**n * p["k0"]
    return a, e, e2, n, f, rho0


def lcc_forward(lon_deg, lat_deg, p: dict):
    """Lambert Conformal Conic forward (EPSG 9801 1SP / 9802 2SP)."""
    lon, lat = lon_deg, lat_deg
    if p["datum"]:
        lon, lat = _datum_shift(lon, lat, p["datum"], to_wgs84=False)
    a, e, e2, n, f, rho0 = _lcc_consts(p)
    phi = np.radians(np.asarray(lat, np.float64))
    _, t = _lcc_m_t(phi, e, e2)
    rho = a * f * t**n * p["k0"]
    theta = n * np.radians(np.asarray(lon, np.float64) - p["lon0"])
    return (p["fe"] + rho * np.sin(theta),
            p["fn"] + rho0 - rho * np.cos(theta))


def lcc_inverse(easting, northing, p: dict):
    a, e, e2, n, f, rho0 = _lcc_consts(p)
    dx = np.asarray(easting, np.float64) - p["fe"]
    dy = rho0 - (np.asarray(northing, np.float64) - p["fn"])
    rho = np.sign(n) * np.hypot(dx, dy)
    t = (rho / (a * f * p["k0"])) ** (1.0 / n)
    phi = np.pi / 2 - 2 * np.arctan(t)
    for _ in range(8):
        s = np.sin(phi)
        phi = np.pi / 2 - 2 * np.arctan(
            t * ((1 - e * s) / (1 + e * s)) ** (e / 2))
    theta = np.arctan2(np.sign(n) * dx, np.sign(n) * dy)
    lon = np.degrees(theta / n) + p["lon0"]
    lat = np.degrees(phi)
    if p["datum"]:
        lon, lat = _datum_shift(lon, lat, p["datum"], to_wgs84=True)
    return lon, lat


def albers_forward(lon_deg, lat_deg, p: dict):
    """Albers Equal Area forward (EPSG 9822)."""
    lon, lat = lon_deg, lat_deg
    if p["datum"]:
        lon, lat = _datum_shift(lon, lat, p["datum"], to_wgs84=False)
    a, e, e2, *_ = _tm_series(p["ellps"])
    phi = np.radians(np.asarray(lat, np.float64))
    phi0 = np.radians(p["lat0"])
    phi1 = np.radians(p["lat1"])
    phi2 = np.radians(p["lat2"])
    m1, _ = _lcc_m_t(phi1, e, e2)
    m2, _ = _lcc_m_t(phi2, e, e2)
    q = _authalic_q(phi, e, e2)
    q0 = _authalic_q(phi0, e, e2)
    q1 = _authalic_q(phi1, e, e2)
    q2 = _authalic_q(phi2, e, e2)
    n = (m1 * m1 - m2 * m2) / (q2 - q1)
    c = m1 * m1 + n * q1
    rho = a * np.sqrt(np.maximum(c - n * q, 0.0)) / n
    rho0 = a * np.sqrt(max(c - n * q0, 0.0)) / n
    theta = n * np.radians(np.asarray(lon, np.float64) - p["lon0"])
    return (p["fe"] + rho * np.sin(theta),
            p["fn"] + rho0 - rho * np.cos(theta))


def albers_inverse(easting, northing, p: dict):
    a, e, e2, *_ = _tm_series(p["ellps"])
    phi0 = np.radians(p["lat0"])
    phi1 = np.radians(p["lat1"])
    phi2 = np.radians(p["lat2"])
    m1, _ = _lcc_m_t(phi1, e, e2)
    m2, _ = _lcc_m_t(phi2, e, e2)
    q1 = _authalic_q(phi1, e, e2)
    q2 = _authalic_q(phi2, e, e2)
    q0 = _authalic_q(phi0, e, e2)
    qp = _authalic_q(np.pi / 2, e, e2)
    n = (m1 * m1 - m2 * m2) / (q2 - q1)
    c = m1 * m1 + n * q1
    rho0 = a * np.sqrt(max(c - n * q0, 0.0)) / n
    dx = np.asarray(easting, np.float64) - p["fe"]
    dy = rho0 - (np.asarray(northing, np.float64) - p["fn"])
    rho = np.sign(n) * np.hypot(dx, dy)
    q = (c - (rho * n / a) ** 2) / n
    beta = np.arcsin(np.clip(q / qp, -1.0, 1.0))
    lat = (beta
           + (e2 / 3 + 31 * e2**2 / 180 + 517 * e2**3 / 5040)
           * np.sin(2 * beta)
           + (23 * e2**2 / 360 + 251 * e2**3 / 3780) * np.sin(4 * beta)
           + (761 * e2**3 / 45360) * np.sin(6 * beta))
    theta = np.arctan2(np.sign(n) * dx, np.sign(n) * dy)
    lon = np.degrees(theta / n) + p["lon0"]
    lat = np.degrees(lat)
    if p["datum"]:
        lon, lat = _datum_shift(lon, lat, p["datum"], to_wgs84=True)
    return lon, lat


# ---------------------------------------------------------------------------
# EPSG plumbing
# ---------------------------------------------------------------------------
def parse_epsg_code(crs: str) -> Optional[int]:
    crs = (crs or "").strip()
    if crs.startswith("+") and "+proj=" in crs:
        return register_proj_string(crs)
    if crs.upper().startswith("EPSG:"):
        try:
            return int(crs.split(":")[1])
        except ValueError:
            return None
    key = 'AUTHORITY["EPSG","'
    idx = crs.rfind(key)
    if idx >= 0:
        start = idx + len(key)
        end = crs.find('"', start)
        try:
            return int(crs[start:end])
        except ValueError:
            return None
    if crs.startswith(("PROJCS[", "GEOGCS[", "PROJCRS[", "GEOGCRS[")):
        # authority-less WKT (gdalwarp accepts any CRS text): convert to a
        # PROJ string via projinfo and register like a +proj target
        out = _run_projinfo(["-o", "PROJ", "--single-line", "-q", crs])
        for line in (out or "").splitlines():
            line = line.strip()
            if line.startswith("+proj="):
                return register_proj_string(line)
    return None


def epsg_kind(code: int) -> Optional[dict]:
    """Classify the EPSG codes this framework projects natively."""
    if code == 4326:
        return {"kind": "geographic"}
    if 32601 <= code <= 32660:
        return {"kind": "utm", "zone": code - 32600, "south": False}
    if 32701 <= code <= 32760:
        return {"kind": "utm", "zone": code - 32700, "south": True}
    if code == 32661:
        return {"kind": "ups", "north": True}
    if code == 32761:
        return {"kind": "ups", "north": False}
    if code == 3857:
        return {"kind": "webmercator"}
    if code == 3395:
        return {"kind": "mercator"}
    if code in _POLAR_STEREO:
        return {"kind": "polar_stereo", **_POLAR_STEREO[code]}
    if code in _LAEA:
        return {"kind": "laea", **_LAEA[code]}
    if code in _TM_GRIDS:
        return {"kind": "tm_grid", "code": code, **_TM_GRIDS[code]}
    if code in _LCC_GRIDS:
        return {"kind": "lcc", "code": code, **_LCC_GRIDS[code]}
    if code in _ALBERS_GRIDS:
        return {"kind": "albers", "code": code, **_ALBERS_GRIDS[code]}
    if code in _SOMERC_GRIDS:
        return {"kind": "somerc", "code": code, **_SOMERC_GRIDS[code]}
    if code in _KROVAK_GRIDS:
        return {"kind": "krovak", "code": code, **_KROVAK_GRIDS[code]}
    return _resolve_epsg_dynamic(code)


SUPPORTED_CRS_FAMILIES = (
    "EPSG:4326 (geographic), EPSG:326xx/327xx (UTM WGS84 N/S), "
    "EPSG:32661/32761 (UPS), EPSG:3857 (Web Mercator), "
    "EPSG:3395 (World Mercator), EPSG:3413/3976/3031 (polar "
    "stereographic science grids), EPSG:3035 (ETRS89-LAEA Europe), "
    "EPSG:2154 (Lambert-93), EPSG:3347 (StatCan Lambert), "
    "EPSG:24200 (Jamaica LCC 1SP), EPSG:5070 (CONUS Albers), "
    "EPSG:3577 (Australian Albers), EPSG:27700 (British National Grid), "
    "EPSG:3067 (TM35FIN), EPSG:2193 (NZTM 2000), EPSG:3978 (Canada Atlas "
    "Lambert), EPSG:3310 (California Albers), "
    "EPSG:25832/25833/25835 (ETRS89 UTM), EPSG:29902 (Irish Grid), "
    "EPSG:2157 (Irish TM), EPSG:2056 (Swiss LV95 oblique Mercator), "
    "EPSG:5514 (Czech Krovak), EPSG:27572 (NTF Paris / Lambert II), "
    "EPSG:31466/31467/31468 (DHDN Gauss-Kruger, NTv2 grid datum), "
    "EPSG:21781 (Swiss LV03); plus ANY other EPSG code PROJ's `projinfo` "
    "resolves to an implemented method (tmerc/utm/lcc/aea/laea/"
    "polar stere/somerc/merc/longlat), incl. Helmert and NTv2 datum legs; "
    "and with PROJ's cs2cs installed, ANY remaining PROJ-known CRS or "
    "+proj= string (omerc, cassini, polyconic, eqc, moll, ... — full "
    "gdalwarp -t_srs breadth) via piped coarse-grid transforms"
)


# ---------------------------------------------------------------------------
# dynamic EPSG resolution via PROJ's `projinfo` — host tooling, the same
# pattern as the reference's gdalinfo/gdalwarp subprocesses
# (sentinel1.rs:988-1003 accepts any PROJ-known -t_srs; this closes that
# breadth gap for every code whose projection method we implement natively)
# ---------------------------------------------------------------------------
_DYN_KIND_CACHE: dict = {}
_DYN_WKT_CACHE: dict = {}
_DYN_UNSUPPORTED: dict = {}

_PROJ_UNITS = {"m": 1.0, "us-ft": 1200.0 / 3937.0, "ft": 0.3048,
               "km": 1000.0}


def _run_projinfo(args) -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(["projinfo", *args], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout if out.returncode == 0 else None


def _proj_tokens(s: str) -> dict:
    d = {}
    for tok in s.split():
        if tok.startswith("+"):
            k, _, v = tok[1:].partition("=")
            d[k] = v if v else True
    return d


def _ellps_from_tokens(p: dict) -> str:
    name = p.get("ellps")
    if isinstance(name, str):
        key = name.lower().replace("-", "_")
        if key not in _ELLPS:
            raise ValueError(f"unknown ellipsoid +ellps={name}")
        return key
    if p.get("datum") == "WGS84":
        return "wgs84"
    if "a" in p:
        a = float(p["a"])
        if "rf" in p:
            f = 1.0 / float(p["rf"])
        elif "b" in p:
            f = (a - float(p["b"])) / a
        else:
            f = 0.0
        if f <= 0.0:
            raise ValueError("spherical/degenerate +a ellipsoid unsupported")
        key = f"dyn_{a:.6f}_{f:.12e}"
        _ELLPS[key] = (a, f)
        return key
    return "wgs84"  # PROJ's default when nothing is given


def _advertised_datum(p: dict, ellps: str) -> Optional[dict]:
    """Inline datum dict from a +towgs84 clause (PROJ's position-vector
    convention), None when absent or all-zero."""
    tw = p.get("towgs84")
    if not isinstance(tw, str):
        return None
    vals = [float(v) for v in tw.split(",")]
    if not any(vals):
        return None
    vals += [0.0] * (7 - len(vals))
    return dict(t=tuple(vals[:3]), r=tuple(vals[3:6]), s=vals[6],
                convention="position_vector", ellps=ellps)


def _first_pipeline(text: str) -> Optional[str]:
    idx = text.find("+proj=pipeline")
    if idx < 0:
        return None
    lines = []
    for line in text[idx:].splitlines():
        if lines and not line.strip().startswith("+"):
            break
        lines.append(line.strip())
    return " ".join(lines)


def _grid_name_candidates(name: str) -> list:
    """PROJ pipelines name modern .tif grids; our reader parses the classic
    NTv2 .gsb files PROJ also ships. Try the name as-is, its .gsb twin, and
    the agency-prefix-stripped .gsb (de_adv_BETA2007.tif -> BETA2007.gsb)."""
    from pathlib import PurePosixPath

    base = PurePosixPath(name).name
    cands = [base]
    if base.endswith(".tif"):
        stem = base[:-4]
        cands.append(stem + ".gsb")
        parts = stem.split("_")
        if len(parts) > 2:
            cands.append("_".join(parts[2:]) + ".gsb")
    return cands


def _datum_from_pipeline(text: str, advert: Optional[dict],
                         ellps: str) -> Optional[dict]:
    """Extract the geodetic datum leg (Helmert and/or grid shift) from the
    first candidate operation of a `projinfo -s EPSG:4326 -t <crs>` listing.
    This reproduces PROJ's own late-bound pick — the op cs2cs/gdalwarp
    would apply — instead of trusting the CRS string's advertised +towgs84
    (see the S-JTSK/DHDN notes on _DATUM_TO_WGS84)."""
    pipe = _first_pipeline(text)
    if not pipe:
        return advert
    steps = [_proj_tokens(s) for s in pipe.split("+step")[1:]]
    local = ellps
    for s in steps:
        if s.get("proj") == "cart":
            k = str(s.get("ellps", "WGS84")).lower().replace("-", "_")
            if k != "wgs84" and k in _ELLPS:
                local = k
    helm = next((s for s in steps if s.get("proj") == "helmert"), None)
    grid = next((s for s in steps if s.get("proj") == "hgridshift"), None)
    d = None
    if helm is not None:
        d = dict(
            t=(float(helm.get("x", 0)), float(helm.get("y", 0)),
               float(helm.get("z", 0))),
            r=(float(helm.get("rx", 0)), float(helm.get("ry", 0)),
               float(helm.get("rz", 0))),
            s=float(helm.get("s", 0)),
            convention=helm.get("convention", "position_vector"),
            ellps=local,
            # a forward step in the 4326->target pipeline maps WGS84->local;
            # +inv flips it to the to_wgs84 sense our tables use
            sense="to_wgs84" if helm.get("inv") else "from_wgs84",
        )
    elif advert is not None:
        d = dict(advert)
    if grid is not None and isinstance(grid.get("grids"), str):
        if d is None:
            d = dict(t=(0.0, 0.0, 0.0), r=(0.0, 0.0, 0.0), s=0.0,
                     convention="position_vector", ellps=local)
        d["grid"] = _grid_name_candidates(grid["grids"])
    return d


_WGS84_COMPATIBLE_ELLPS = ("wgs84", "grs80")

# synthetic code namespace for raw +proj= target strings (gdalwarp accepts
# non-EPSG -t_srs; we register each distinct string under a pseudo-code so
# the code-keyed dispatch works unchanged)
_PROJ_STRING_BASE = 990000
_PROJ_STRING_CODES: dict = {}


def _dynamic_datum(code: int, p: dict, ellps: str) -> Optional[dict]:
    advert = _advertised_datum(p, ellps)
    ng = p.get("nadgrids")
    if isinstance(ng, str) and ng != "@null":
        base = advert or dict(t=(0.0, 0.0, 0.0), r=(0.0, 0.0, 0.0), s=0.0,
                              convention="position_vector", ellps=ellps)
        cands = []
        for nm in ng.split(","):
            nm = nm.lstrip("@")
            if nm and nm != "null":
                cands.extend(_grid_name_candidates(nm))
        if cands:
            base["grid"] = cands
        advert = base
    if code >= _PROJ_STRING_BASE:
        # raw proj-string CRS: only the string's own datum info applies
        # (gdalwarp behaves the same for a proj4 -t_srs)
        return advert
    if advert is None and ellps in _WGS84_COMPATIBLE_ELLPS:
        return None
    out = _run_projinfo(["-s", "EPSG:4326", "-t", f"EPSG:{code}",
                         "--spatial-test", "intersects", "-o", "PROJ"])
    if out:
        return _datum_from_pipeline(out, advert, ellps)
    return advert


def register_proj_string(s: str) -> int:
    """Register a raw PROJ string as a target CRS under a synthetic code
    (gdalwarp parity for non-EPSG `-t_srs`). Resolution failures are
    recorded like any dynamic code — epsg_kind returns None and the
    unsupported_reason explains why."""
    norm = " ".join(sorted(t for t in s.split() if t.startswith("+")
                           and not t.startswith("+type=")))
    if norm in _PROJ_STRING_CODES:
        return _PROJ_STRING_CODES[norm]
    code = _PROJ_STRING_BASE + len(_PROJ_STRING_CODES) + 1
    _PROJ_STRING_CODES[norm] = code
    try:
        try:
            kind = _kind_from_proj_tokens(_proj_tokens(s), code)
        except ValueError as native_exc:
            # +axis strings reorder/flip axes — derive the normalizer from
            # the WKT2 axis list; plain proj strings are east,north already
            wkt2 = (norm + " +type=crs") if "+axis=" in norm else None
            # cs2cs's classic `+to` parser needs +proj= as the first token
            toks = sorted(norm.split(),
                          key=lambda t: not t.startswith("+proj="))
            kind = _pipe_kind(code, ["+to", *toks], wkt2, str(native_exc))
            if kind is None:
                raise
        wkt_out = _run_projinfo(["--single-line", "-o", "WKT1_GDAL", "-q",
                                 norm + " +type=crs"])
        wkt = None
        for line in (wkt_out or "").splitlines():
            line = line.strip()
            if line.startswith(("PROJCS[", "GEOGCS[")):
                wkt = line
                break
        # last resort the string itself — GDAL also understands proj4 text
        _DYN_WKT_CACHE[code] = wkt or norm
        if wkt:
            name_end = wkt.find('"', wkt.find('"') + 1)
            kind["name"] = wkt[wkt.find('"') + 1:name_end]
        logger.info("registered proj-string CRS as code %d: %s", code, norm)
    except ValueError as exc:
        _DYN_UNSUPPORTED[code] = str(exc)
        logger.info("proj-string CRS unsupported: %s", exc)
        kind = None
    _DYN_KIND_CACHE[code] = kind
    return code


def _kind_from_proj_tokens(p: dict, code: int) -> dict:
    proj = p.get("proj")
    if not isinstance(proj, str):
        raise ValueError("no +proj method in PROJ string")
    if "pm" in p:
        raise ValueError("non-Greenwich prime meridian not supported "
                         "dynamically")
    to_m = 1.0
    if "to_meter" in p:
        to_m = float(p["to_meter"])
    elif isinstance(p.get("units"), str):
        if p["units"] not in _PROJ_UNITS:
            raise ValueError(f"unsupported unit +units={p['units']}")
        to_m = _PROJ_UNITS[p["units"]]

    def f(key, dflt=0.0):
        return float(p.get(key, dflt))

    base = {"dynamic": True, "code": code}
    if to_m != 1.0:
        base["to_meter"] = to_m

    if proj == "longlat":
        ellps = _ellps_from_tokens(p)
        return {**base, "kind": "geographic",
                "datum": _dynamic_datum(code, p, ellps)}
    if proj == "webmerc":
        return {**base, "kind": "webmercator", "datum": None}
    if proj == "merc":
        if "a" in p and "b" in p and p["a"] == p["b"]:
            return {**base, "kind": "webmercator", "datum": None}
        ellps = _ellps_from_tokens(p)
        if (ellps in _WGS84_COMPATIBLE_ELLPS and f("lat_ts") == 0.0
                and f("k", f("k_0", 1.0)) == 1.0 and f("x_0") == 0.0
                and f("y_0") == 0.0 and f("lon_0") == 0.0):
            return {**base, "kind": "mercator",
                    "datum": _dynamic_datum(code, p, ellps)}
        raise ValueError("general ellipsoidal Mercator variants not "
                         "implemented (only EPSG:3395-style)")
    ellps = _ellps_from_tokens(p)
    datum = _dynamic_datum(code, p, ellps)
    if proj == "utm":
        zone = int(p["zone"])
        return {**base, "kind": "tm_grid", "lat0": 0.0,
                "lon0": float(zone * 6 - 183), "k0": 0.9996, "fe": 500000.0,
                "fn": 10000000.0 if "south" in p else 0.0, "ellps": ellps,
                "datum": datum}
    if proj == "tmerc":
        return {**base, "kind": "tm_grid", "lat0": f("lat_0"),
                "lon0": f("lon_0"), "k0": f("k", f("k_0", 1.0)),
                "fe": f("x_0"), "fn": f("y_0"), "ellps": ellps,
                "datum": datum}
    if proj == "lcc":
        lat1 = f("lat_1", f("lat_0"))
        return {**base, "kind": "lcc", "lat0": f("lat_0"), "lon0": f("lon_0"),
                "lat1": lat1, "lat2": f("lat_2", lat1),
                "k0": f("k", f("k_0", 1.0)), "fe": f("x_0"), "fn": f("y_0"),
                "ellps": ellps, "datum": datum}
    if proj == "aea":
        return {**base, "kind": "albers", "lat0": f("lat_0"),
                "lon0": f("lon_0"), "lat1": f("lat_1"), "lat2": f("lat_2"),
                "fe": f("x_0"), "fn": f("y_0"), "ellps": ellps,
                "datum": datum}
    if proj == "laea":
        return {**base, "kind": "laea", "lat0": f("lat_0"),
                "lon0": f("lon_0"), "fe": f("x_0"), "fn": f("y_0"),
                "ellps": ellps, "datum": datum}
    if proj == "stere":
        lat0 = f("lat_0")
        if abs(lat0) < 90.0 - 1e-9:
            raise ValueError("oblique stereographic (+proj=stere away from "
                             "the poles) not implemented")
        lat_ts = float(p["lat_ts"]) if "lat_ts" in p else None
        return {**base, "kind": "polar_stereo", "lat_ts": lat_ts,
                "k0": f("k", f("k_0", 1.0)), "lon0": f("lon_0"),
                "fe": f("x_0"), "fn": f("y_0"), "north": lat0 > 0,
                "ellps": ellps, "datum": datum}
    if proj == "somerc":
        return {**base, "kind": "somerc", "lat0": f("lat_0"),
                "lon0": f("lon_0"), "k0": f("k", f("k_0", 1.0)),
                "fe": f("x_0"), "fn": f("y_0"), "ellps": ellps,
                "datum": datum}
    if proj == "sterea":
        return {**base, "kind": "sterea", "lat0": f("lat_0"),
                "lon0": f("lon_0"), "k0": f("k", f("k_0", 1.0)),
                "fe": f("x_0"), "fn": f("y_0"), "ellps": ellps,
                "datum": datum}
    raise ValueError(
        f"projection method '+proj={proj}' not implemented (implemented: "
        f"tmerc/utm/lcc/aea/laea/stere(polar)/sterea/somerc/merc/webmerc/"
        f"longlat)")


# ---------------------------------------------------------------------------
# cs2cs-piped generic backend — any PROJ-known CRS (gdalwarp -t_srs breadth)
# ---------------------------------------------------------------------------
# The reference shells out to gdalwarp for every warp (sentinel1.rs:988-1041)
# and therefore accepts any CRS PROJ knows. The native projection tables
# above cover the mainstream methods; a CRS whose method is NOT implemented
# natively (omerc, cass, poly, eqc, moll, oblique stere, south-west-axis
# Krovak, non-Greenwich prime meridians, ...) falls back to piping the
# warp's coarse mapping grids through `cs2cs` — the same subprocess pattern
# as the reference, run once per grid (tens of ms), never per pixel. cs2cs
# late-binds the datum operation per point exactly like gdalwarp does.

_CS2CS_AXIS_RE = None  # compiled lazily (keeps `re` out of the hot imports)
_CS2CS_TIMEOUT = 120.0


def _cs2cs_available() -> bool:
    import shutil

    return shutil.which("cs2cs") is not None


def _pipe_axes(wkt2_spec: Optional[str]):
    """Normalize a CRS's authority axis order/directions to GIS east,north
    (what gdalwarp's traditional-order geotransforms — and ours — use).

    Returns (((col_of_x, sign_x), (col_of_y, sign_y)), bbox, ang_scale) where
    col_* index the cs2cs output columns, sign −1 flips westing/southing
    axes, bbox is the WKT2 area-of-use (south, west, north, east) or None,
    and ang_scale converts cs2cs's decimal-degree angular output into the
    CRS's own angular unit (grads for EPSG:4807-style CRS; None when the
    unit is degrees or the CS is Cartesian — cs2cs already emits authority
    LINEAR units). A None spec (raw proj strings without +axis) is already
    east,north degrees."""
    global _CS2CS_AXIS_RE
    if wkt2_spec is None:
        return ((0, 1.0), (1, 1.0)), None, None
    import re

    if _CS2CS_AXIS_RE is None:
        _CS2CS_AXIS_RE = re.compile(
            r'AXIS\["[^"]*",\s*(east|west|north|south)')
    out = _run_projinfo(["-q", "-o", "WKT2:2019", "--single-line", wkt2_spec])
    if not out:
        return None, None, None
    cs = out.rfind("CS[")
    tail = out[max(cs, 0):]
    dirs = _CS2CS_AXIS_RE.findall(tail)[:2]
    bbox = None
    m = re.search(r"BBOX\[([-\d.]+),([-\d.]+),([-\d.]+),([-\d.]+)\]", out)
    if m:
        bbox = tuple(float(g) for g in m.groups())
    ang_scale = None
    if tail.startswith("CS[ellipsoidal"):
        mu = re.search(r'ANGLEUNIT\["[^"]*",([-\d.eE]+)', tail)
        if mu:
            rad_per_unit = float(mu.group(1))
            if rad_per_unit > 0 and abs(rad_per_unit - np.pi / 180) > 1e-15:
                ang_scale = (np.pi / 180.0) / rad_per_unit
    if len(dirs) != 2:
        return None, bbox, ang_scale
    axes = [None, None]  # x, y
    for col, d in enumerate(dirs):
        if d in ("east", "west"):
            axes[0] = (col, 1.0 if d == "east" else -1.0)
        else:
            axes[1] = (col, 1.0 if d == "north" else -1.0)
    if axes[0] is None or axes[1] is None:  # two same-family axes — malformed
        return None, bbox, ang_scale
    return (axes[0], axes[1]), bbox, ang_scale


def _cs2cs_points(a, b, target_argv, axes, inverse: bool,
                  ang_scale: Optional[float] = None):
    """Pipe points through `cs2cs EPSG:4326 <target>` (or its -I inverse).

    forward: a=lon°, b=lat° → (x, y) in CRS units, GIS east,north.
    inverse: a=x, b=y (GIS east,north) → (lon, lat)°.
    ang_scale converts cs2cs's decimal-degree angular I/O to/from the
    target's own angular unit (non-degree geographic CRS).
    Non-finite inputs and out-of-domain outputs (`*`/inf) map to nan.
    Runtime subprocess failures raise ExternalError (SarproError), the same
    contract as the reference's gdalwarp subprocess failures."""
    import subprocess

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    shape = np.broadcast(a, b).shape
    af = np.ascontiguousarray(np.broadcast_to(a, shape)).ravel()
    bf = np.ascontiguousarray(np.broadcast_to(b, shape)).ravel()
    if inverse and ang_scale:
        af = af / ang_scale  # CRS angular units → degrees for the pipe
        bf = bf / ang_scale
    ok = np.isfinite(af) & np.isfinite(bf)
    (ix, sx), (iy, sy) = axes
    lines = []
    for i in np.flatnonzero(ok):
        if inverse:
            cols = [0.0, 0.0]
            cols[ix] = af[i] * sx  # back to the authority axis direction
            cols[iy] = bf[i] * sy
            lines.append(f"{cols[0]:.12f} {cols[1]:.12f}")
        else:
            lines.append(f"{bf[i]:.12f} {af[i]:.12f}")  # EPSG:4326 = lat lon
    o0 = np.full(af.shape, np.nan)
    o1 = np.full(af.shape, np.nan)
    if lines:
        argv = ["cs2cs", "-f", "%.12f"]
        if inverse:
            argv.append("-I")
        argv += ["EPSG:4326", *target_argv]
        from ..errors import ExternalError

        try:
            r = subprocess.run(argv, input="\n".join(lines) + "\n",
                               capture_output=True, text=True,
                               timeout=_CS2CS_TIMEOUT)
        except (OSError, subprocess.SubprocessError) as e:
            raise ExternalError(f"cs2cs transform failed: {e}") from e
        rows = r.stdout.splitlines()
        if r.returncode != 0 or len(rows) != len(lines):
            raise ExternalError(
                f"cs2cs transform failed (rc={r.returncode}): "
                f"{(r.stderr or '').strip()[:200]}")
        vals0 = np.empty(len(rows))
        vals1 = np.empty(len(rows))
        for j, row in enumerate(rows):
            t = row.split()
            try:
                v0, v1 = float(t[0]), float(t[1])
            except (IndexError, ValueError):
                v0 = v1 = np.nan
            vals0[j] = v0 if np.isfinite(v0) else np.nan
            vals1[j] = v1 if np.isfinite(v1) else np.nan
        o0[ok] = vals0
        o1[ok] = vals1
    if inverse:  # EPSG:4326 output order is lat lon
        return o1.reshape(shape), o0.reshape(shape)
    cols = (o0, o1)
    x, y = sx * cols[ix], sy * cols[iy]
    if ang_scale:
        x, y = x * ang_scale, y * ang_scale  # degrees → CRS angular units
    return x.reshape(shape), y.reshape(shape)


def _pipe_kind(code: int, target_argv, wkt2_spec: Optional[str],
               reason: str) -> Optional[dict]:
    """Build a proj_pipe kind for a PROJ-known CRS we cannot evaluate
    natively, after a one-point smoke transform proves the plumbing."""
    from ..errors import ExternalError

    if not _cs2cs_available():
        return None
    axes, bbox, ang_scale = _pipe_axes(wkt2_spec)
    if axes is None:
        return None
    if bbox is not None:
        smoke = ((bbox[1] + bbox[3]) / 2.0, (bbox[0] + bbox[2]) / 2.0)
    else:
        smoke = (0.0, 0.0)
    kind = {"dynamic": True, "kind": "proj_pipe", "code": code,
            "cs2cs": list(target_argv), "axes": axes, "datum": None,
            "pipe_reason": reason}
    if ang_scale:
        kind["ang_scale"] = ang_scale
    try:
        x, y = _cs2cs_points(np.asarray([smoke[0]]), np.asarray([smoke[1]]),
                             kind["cs2cs"], axes, inverse=False,
                             ang_scale=ang_scale)
    except ExternalError:
        return None
    if bbox is not None and not (np.isfinite(x[0]) and np.isfinite(y[0])):
        # the CRS's own area-of-use center failing to transform means this
        # PROJ build cannot actually evaluate the method (e.g. Krovak
        # Modified on PROJ < 9.2) — reject rather than emit all-nan warps
        return None
    # without a bbox (raw proj strings), nan is fine — (0,0) may simply sit
    # outside the method's domain; the subprocess accepting the CRS spec is
    # what the probe establishes
    logger.info("CRS %s: projection method not implemented natively (%s); "
                "transforms will pipe through cs2cs like the reference's "
                "gdalwarp subprocess", code, reason)
    return kind


def _resolve_epsg_dynamic(code: int) -> Optional[dict]:
    if code in _DYN_KIND_CACHE:
        return _DYN_KIND_CACHE[code]
    kind = None
    try:
        out = _run_projinfo(["-o", "PROJ", "-q", f"EPSG:{code}"])
        proj_line = None
        for line in (out or "").splitlines():
            line = line.strip()
            if line.startswith("+proj="):
                proj_line = line
                break
        if proj_line is None:
            # PROJ may know the code yet have no PROJ-string export for its
            # method (e.g. Krovak Modified, Polar Stereographic variant C) —
            # the pipe backend only needs the EPSG code, so try it before
            # declaring the code unknown
            kind = _pipe_kind(code, [f"EPSG:{code}"], f"EPSG:{code}",
                              "method has no PROJ-string export")
            if kind is None:
                if _run_projinfo(["-q", "-o", "WKT2:2019", "--single-line",
                                  f"EPSG:{code}"]):
                    raise ValueError(
                        f"EPSG:{code} is known to PROJ but its projection "
                        f"method is not evaluable by this PROJ build")
                raise ValueError(f"EPSG:{code} not known to PROJ")
        else:
            try:
                kind = _kind_from_proj_tokens(_proj_tokens(proj_line), code)
            except ValueError as native_exc:
                kind = _pipe_kind(code, [f"EPSG:{code}"], f"EPSG:{code}",
                                  str(native_exc))
                if kind is None:
                    raise
        wkt_out = _run_projinfo(["-o", "WKT1_GDAL", "--single-line", "-q",
                                 f"EPSG:{code}"])
        wkt = None
        for line in (wkt_out or "").splitlines():
            line = line.strip()
            if line.startswith(("PROJCS[", "GEOGCS[")):
                wkt = line
                break
        _DYN_WKT_CACHE[code] = wkt
        if wkt:
            name_end = wkt.find('"', wkt.find('"') + 1)
            kind["name"] = wkt[wkt.find('"') + 1:name_end]
        logger.info("dynamic CRS EPSG:%d resolved via projinfo: %s",
                    code, kind.get("name", kind["kind"]))
    except ValueError as exc:
        _DYN_UNSUPPORTED[code] = str(exc)
        logger.info("dynamic CRS EPSG:%d unsupported: %s", code, exc)
        kind = None
    except Exception as exc:  # noqa: BLE001 — subprocess/parse breakage
        _DYN_UNSUPPORTED[code] = f"projinfo resolution failed: {exc}"
        logger.warning("dynamic CRS EPSG:%d resolution failed: %s",
                       code, exc)
        kind = None
    _DYN_KIND_CACHE[code] = kind
    return kind


def unsupported_reason(code: int) -> Optional[str]:
    """Why a dynamic EPSG code could not be resolved (for error messages)."""
    return _DYN_UNSUPPORTED.get(code)


def refine_dynamic_crs_area(code: int, lon: float, lat: float) -> None:
    """Re-resolve a dynamic CRS's datum leg with the scene's area of
    interest so PROJ late-binds the area-specific transformation — the
    same per-point op choice cs2cs/gdalwarp make (PROJ's default listing
    without an area can pick a ballpark or wide-area op instead)."""
    info = _DYN_KIND_CACHE.get(code)
    if not info or info.get("_area_refined"):
        return
    if info["kind"] == "proj_pipe":
        return  # cs2cs late-binds the datum op per point on its own
    info["_area_refined"] = True
    ellps = info.get("ellps", "wgs84")
    if info.get("datum") is None and ellps in _WGS84_COMPATIBLE_ELLPS:
        return
    out = _run_projinfo([
        "-s", "EPSG:4326", "-t", f"EPSG:{code}",
        "--spatial-test", "intersects", "-o", "PROJ",
        "--bbox", f"{lon - 0.5:.4f},{lat - 0.5:.4f},"
                  f"{lon + 0.5:.4f},{lat + 0.5:.4f}",
    ])
    if out:
        d = _datum_from_pipeline(out, info.get("datum"), ellps)
        if d is not None:
            info["datum"] = d


_WKT_GEOGCS = (
    'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,'
    '298.257223563,AUTHORITY["EPSG","7030"]],AUTHORITY["EPSG","6326"]],'
    'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
    'AUTHORITY["EPSG","4326"]]'
)

_WKT_ANGULAR = (
    'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]]'
)
_WKT_SPHEROID_GRS80 = ('SPHEROID["GRS 1980",6378137,298.257222101,'
                       'AUTHORITY["EPSG","7019"]]')
# base geographic CRS per datum of the national grids
_WKT_GEOGCS_BY_DATUM = {
    "etrs89": (
        f'GEOGCS["ETRS89",DATUM["European_Terrestrial_Reference_System_1989",'
        f'{_WKT_SPHEROID_GRS80},AUTHORITY["EPSG","6258"]],{_WKT_ANGULAR},'
        f'AUTHORITY["EPSG","4258"]]'
    ),
    "rgf93": (
        f'GEOGCS["RGF93 v1",DATUM["Reseau_Geodesique_Francais_1993_v1",'
        f'{_WKT_SPHEROID_GRS80},AUTHORITY["EPSG","6171"]],{_WKT_ANGULAR},'
        f'AUTHORITY["EPSG","4171"]]'
    ),
    "nad83": (
        f'GEOGCS["NAD83",DATUM["North_American_Datum_1983",'
        f'{_WKT_SPHEROID_GRS80},AUTHORITY["EPSG","6269"]],{_WKT_ANGULAR},'
        f'AUTHORITY["EPSG","4269"]]'
    ),
    "nzgd2000": (
        f'GEOGCS["NZGD2000",DATUM["New_Zealand_Geodetic_Datum_2000",'
        f'{_WKT_SPHEROID_GRS80},AUTHORITY["EPSG","6167"]],{_WKT_ANGULAR},'
        f'AUTHORITY["EPSG","4167"]]'
    ),
    "gda94": (
        f'GEOGCS["GDA94",DATUM["Geocentric_Datum_of_Australia_1994",'
        f'{_WKT_SPHEROID_GRS80},AUTHORITY["EPSG","6283"]],{_WKT_ANGULAR},'
        f'AUTHORITY["EPSG","4283"]]'
    ),
    "osgb36": (
        f'GEOGCS["OSGB36",DATUM["OSGB_1936",'
        f'SPHEROID["Airy 1830",6377563.396,299.3249646,'
        f'AUTHORITY["EPSG","7001"]],'
        f'TOWGS84[446.448,-125.157,542.06,0.15,0.247,0.842,-20.489],'
        f'AUTHORITY["EPSG","6277"]],{_WKT_ANGULAR},'
        f'AUTHORITY["EPSG","4277"]]'
    ),
    "jad69": (
        # TOWGS84 uses the position-vector convention: the EPSG (3)
        # transform is coordinate-frame, so its rotations flip sign here
        f'GEOGCS["JAD69",DATUM["Jamaica_1969",'
        f'SPHEROID["Clarke 1866",6378206.4,294.978698213898,'
        f'AUTHORITY["EPSG","7008"]],'
        f'TOWGS84[-33.722,153.789,94.959,-8.581,-4.478,4.54,8.95],'
        f'AUTHORITY["EPSG","6242"]],{_WKT_ANGULAR},'
        f'AUTHORITY["EPSG","4242"]]'
    ),
    "tm65": (
        f'GEOGCS["TM65",DATUM["TM65",'
        f'SPHEROID["Airy Modified 1849",6377340.189,299.3249646,'
        f'AUTHORITY["EPSG","7002"]],'
        f'TOWGS84[482.5,-130.6,564.6,-1.042,-0.214,-0.631,8.15],'
        f'AUTHORITY["EPSG","6299"]],{_WKT_ANGULAR},'
        f'AUTHORITY["EPSG","4299"]]'
    ),
    "irenet95": (
        f'GEOGCS["IRENET95",DATUM["IRENET95",'
        f'{_WKT_SPHEROID_GRS80},AUTHORITY["EPSG","6173"]],{_WKT_ANGULAR},'
        f'AUTHORITY["EPSG","4173"]]'
    ),
    "ch1903plus": (
        f'GEOGCS["CH1903+",DATUM["CH1903+",'
        f'SPHEROID["Bessel 1841",6377397.155,299.1528128,'
        f'AUTHORITY["EPSG","7004"]],'
        f'TOWGS84[674.374,15.056,405.346,0,0,0,0],'
        f'AUTHORITY["EPSG","6150"]],{_WKT_ANGULAR},'
        f'AUTHORITY["EPSG","4150"]]'
    ),
    "ch1903": (
        f'GEOGCS["CH1903",DATUM["CH1903",'
        f'SPHEROID["Bessel 1841",6377397.155,299.1528128,'
        f'AUTHORITY["EPSG","7004"]],'
        f'TOWGS84[674.374,15.056,405.346,0,0,0,0],'
        f'AUTHORITY["EPSG","6149"]],{_WKT_ANGULAR},'
        f'AUTHORITY["EPSG","4149"]]'
    ),
    "dhdn": (
        # TOWGS84 carries the grid-free Helmert fallback; the NTv2
        # BETA2007 grid (when installed) supersedes it at transform time
        f'GEOGCS["DHDN",DATUM["Deutsches_Hauptdreiecksnetz",'
        f'SPHEROID["Bessel 1841",6377397.155,299.1528128,'
        f'AUTHORITY["EPSG","7004"]],'
        f'TOWGS84[598.1,73.7,418.2,0.202,0.045,-2.455,6.7],'
        f'AUTHORITY["EPSG","6314"]],{_WKT_ANGULAR},'
        f'AUTHORITY["EPSG","4314"]]'
    ),
    "sjtsk": (
        # TOWGS84 is position-vector: the EPSG (5) op is coordinate-frame,
        # so its rotations flip sign here
        f'GEOGCS["S-JTSK",'
        f'DATUM["System_of_the_Unified_Trigonometrical_Cadastral_Network",'
        f'SPHEROID["Bessel 1841",6377397.155,299.1528128,'
        f'AUTHORITY["EPSG","7004"]],'
        f'TOWGS84[572.213,85.334,461.94,4.9732,1.529,5.2484,3.5378],'
        f'AUTHORITY["EPSG","6156"]],{_WKT_ANGULAR},'
        f'AUTHORITY["EPSG","4156"]]'
    ),
}
# which base GEOGCS each national-grid code sits on
_GRID_BASE_DATUM = {
    27700: "osgb36", 3067: "etrs89", 25832: "etrs89", 25833: "etrs89",
    25835: "etrs89", 2154: "rgf93", 3347: "nad83", 24200: "jad69",
    5070: "nad83", 3577: "gda94", 2193: "nzgd2000", 3978: "nad83",
    3310: "nad83", 29902: "tm65", 2157: "irenet95", 2056: "ch1903plus",
    5514: "sjtsk", 31466: "dhdn", 31467: "dhdn", 31468: "dhdn",
    21781: "ch1903",
}
_WKT_UNIT_AXES = ('UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
                  'AXIS["Easting",EAST],AXIS["Northing",NORTH]')


# grids whose official WKT uses non-degree units / non-Greenwich prime
# meridians (grad + Paris): emitted as GDAL-matching literals, since the
# generic emitter formats parameters in degrees
_WKT_LITERAL = {
    27572: (
        'PROJCS["NTF (Paris) / Lambert zone II",GEOGCS["NTF (Paris)",'
        'DATUM["Nouvelle_Triangulation_Francaise_Paris",'
        'SPHEROID["Clarke 1880 (IGN)",6378249.2,293.466021293627,'
        'AUTHORITY["EPSG","7011"]],'
        'TOWGS84[-168,-60,320,0,0,0,0],'
        'AUTHORITY["EPSG","6807"]],'
        'PRIMEM["Paris",2.33722917,AUTHORITY["EPSG","8903"]],'
        'UNIT["grad",0.0157079632679489,AUTHORITY["EPSG","9105"]],'
        'AUTHORITY["EPSG","4807"]],'
        'PROJECTION["Lambert_Conformal_Conic_1SP"],'
        'PARAMETER["latitude_of_origin",52],'
        'PARAMETER["central_meridian",0],'
        'PARAMETER["scale_factor",0.99987742],'
        'PARAMETER["false_easting",600000],'
        'PARAMETER["false_northing",2200000],'
        'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
        'AXIS["Easting",EAST],AXIS["Northing",NORTH],'
        'AUTHORITY["EPSG","27572"]]'
    ),
}


def epsg_to_wkt(code: int) -> Optional[str]:
    """WKT1 for the CRS family we emit (EPSG:4326, UTM WGS84, UPS)."""
    if code in _WKT_LITERAL:
        return _WKT_LITERAL[code]
    info = epsg_kind(code)
    if info is None:
        return None
    if info.get("dynamic"):
        # dynamically resolved CRS: emit projinfo's own WKT1_GDAL (cached
        # during resolution) — exact GDAL parity incl. units/axis clauses
        return _DYN_WKT_CACHE.get(code)
    if info["kind"] == "geographic":
        return _WKT_GEOGCS
    if info["kind"] == "utm":
        zone = info["zone"]
        south = info["south"]
        hemi = "S" if south else "N"
        lon0 = zone * 6 - 183
        fn = UTM_FN_SOUTH if south else 0
        return (
            f'PROJCS["WGS 84 / UTM zone {zone}{hemi}",{_WKT_GEOGCS},'
            f'PROJECTION["Transverse_Mercator"],'
            f'PARAMETER["latitude_of_origin",0],'
            f'PARAMETER["central_meridian",{lon0}],'
            f'PARAMETER["scale_factor",0.9996],'
            f'PARAMETER["false_easting",500000],'
            f'PARAMETER["false_northing",{fn:.0f}],'
            f'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
            f'AXIS["Easting",EAST],AXIS["Northing",NORTH],'
            f'AUTHORITY["EPSG","{code}"]]'
        )
    if info["kind"] == "webmercator":
        return (
            f'PROJCS["WGS 84 / Pseudo-Mercator",{_WKT_GEOGCS},'
            f'PROJECTION["Mercator_1SP"],'
            f'PARAMETER["central_meridian",0],'
            f'PARAMETER["scale_factor",1],'
            f'PARAMETER["false_easting",0],'
            f'PARAMETER["false_northing",0],'
            f'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
            f'AXIS["Easting",EAST],AXIS["Northing",NORTH],'
            f'EXTENSION["PROJ4","+proj=merc +a=6378137 +b=6378137 '
            f'+lat_ts=0 +lon_0=0 +x_0=0 +y_0=0 +k=1 +units=m '
            f'+nadgrids=@null +wktext +no_defs"],'
            f'AUTHORITY["EPSG","3857"]]'
        )
    if info["kind"] == "mercator":
        return (
            f'PROJCS["WGS 84 / World Mercator",{_WKT_GEOGCS},'
            f'PROJECTION["Mercator_1SP"],'
            f'PARAMETER["central_meridian",0],'
            f'PARAMETER["scale_factor",1],'
            f'PARAMETER["false_easting",0],'
            f'PARAMETER["false_northing",0],'
            f'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
            f'AXIS["Easting",EAST],AXIS["Northing",NORTH],'
            f'AUTHORITY["EPSG","3395"]]'
        )
    if info["kind"] == "polar_stereo":
        names = {3413: "WGS 84 / NSIDC Sea Ice Polar Stereographic North",
                 3976: "WGS 84 / NSIDC Sea Ice Polar Stereographic South",
                 3031: "WGS 84 / Antarctic Polar Stereographic"}
        return (
            f'PROJCS["{names[code]}",{_WKT_GEOGCS},'
            f'PROJECTION["Polar_Stereographic"],'
            f'PARAMETER["latitude_of_origin",{info["lat_ts"]:g}],'
            f'PARAMETER["central_meridian",{info["lon0"]:g}],'
            f'PARAMETER["false_easting",{info["fe"]:.10g}],'
            f'PARAMETER["false_northing",{info["fn"]:.10g}],'
            f'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
            f'AUTHORITY["EPSG","{code}"]]'
        )
    if info["kind"] == "laea":
        return (
            f'PROJCS["ETRS89-extended / LAEA Europe",'
            f'GEOGCS["ETRS89",DATUM["European_Terrestrial_Reference_'
            f'System_1989",SPHEROID["GRS 1980",6378137,298.257222101,'
            f'AUTHORITY["EPSG","7019"]],AUTHORITY["EPSG","6258"]],'
            f'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
            f'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
            f'AUTHORITY["EPSG","4258"]],'
            f'PROJECTION["Lambert_Azimuthal_Equal_Area"],'
            f'PARAMETER["latitude_of_center",{info["lat0"]:g}],'
            f'PARAMETER["longitude_of_center",{info["lon0"]:g}],'
            f'PARAMETER["false_easting",{info["fe"]:.10g}],'
            f'PARAMETER["false_northing",{info["fn"]:.10g}],'
            f'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
            f'AUTHORITY["EPSG","{code}"]]'
        )
    if info["kind"] in ("tm_grid", "lcc", "albers", "somerc", "krovak"):
        geogcs = _WKT_GEOGCS_BY_DATUM[_GRID_BASE_DATUM[code]]
        if info["kind"] == "tm_grid":
            proj = (
                f'PROJECTION["Transverse_Mercator"],'
                f'PARAMETER["latitude_of_origin",{info["lat0"]:g}],'
                f'PARAMETER["central_meridian",{info["lon0"]:g}],'
                f'PARAMETER["scale_factor",{info["k0"]:.10g}],'
                f'PARAMETER["false_easting",{info["fe"]:.10g}],'
                f'PARAMETER["false_northing",{info["fn"]:.10g}]'
            )
        elif info["kind"] == "lcc":
            if abs(info["lat1"] - info["lat2"]) < 1e-12:
                proj = (
                    f'PROJECTION["Lambert_Conformal_Conic_1SP"],'
                    f'PARAMETER["latitude_of_origin",{info["lat0"]:g}],'
                    f'PARAMETER["central_meridian",{info["lon0"]:g}],'
                    f'PARAMETER["scale_factor",{info["k0"]:.10g}],'
                    f'PARAMETER["false_easting",{info["fe"]:.10g}],'
                    f'PARAMETER["false_northing",{info["fn"]:.10g}]'
                )
            else:
                proj = (
                    f'PROJECTION["Lambert_Conformal_Conic_2SP"],'
                    f'PARAMETER["standard_parallel_1",{info["lat1"]:g}],'
                    f'PARAMETER["standard_parallel_2",{info["lat2"]:g}],'
                    f'PARAMETER["latitude_of_origin",{info["lat0"]:.9g}],'
                    f'PARAMETER["central_meridian",{info["lon0"]:.15g}],'
                    f'PARAMETER["false_easting",{info["fe"]:.10g}],'
                    f'PARAMETER["false_northing",{info["fn"]:.10g}]'
                )
        elif info["kind"] == "krovak":
            proj = (
                f'PROJECTION["Krovak"],'
                f'PARAMETER["latitude_of_center",{info["lat0"]:.15g}],'
                f'PARAMETER["longitude_of_center",{info["lon0"]:.15g}],'
                f'PARAMETER["azimuth",{info["alpha"]:.15g}],'
                f'PARAMETER["pseudo_standard_parallel_1",{info["psi1"]:.10g}],'
                f'PARAMETER["scale_factor",{info["k0"]:.10g}],'
                f'PARAMETER["false_easting",{info["fe"]:.10g}],'
                f'PARAMETER["false_northing",{info["fn"]:.10g}]'
            )
        elif info["kind"] == "somerc":
            proj = (
                f'PROJECTION["Hotine_Oblique_Mercator_Azimuth_Center"],'
                f'PARAMETER["latitude_of_center",{info["lat0"]:.15g}],'
                f'PARAMETER["longitude_of_center",{info["lon0"]:.15g}],'
                f'PARAMETER["azimuth",90],'
                f'PARAMETER["rectified_grid_angle",90],'
                f'PARAMETER["scale_factor",{info["k0"]:.10g}],'
                f'PARAMETER["false_easting",{info["fe"]:.10g}],'
                f'PARAMETER["false_northing",{info["fn"]:.10g}]'
            )
        else:
            proj = (
                f'PROJECTION["Albers_Conic_Equal_Area"],'
                f'PARAMETER["latitude_of_center",{info["lat0"]:g}],'
                f'PARAMETER["longitude_of_center",{info["lon0"]:g}],'
                f'PARAMETER["standard_parallel_1",{info["lat1"]:g}],'
                f'PARAMETER["standard_parallel_2",{info["lat2"]:g}],'
                f'PARAMETER["false_easting",{info["fe"]:.10g}],'
                f'PARAMETER["false_northing",{info["fn"]:.10g}]'
            )
        return (f'PROJCS["{info["name"]}",{geogcs},{proj},{_WKT_UNIT_AXES},'
                f'AUTHORITY["EPSG","{code}"]]')
    north = info["north"]
    name = "WGS 84 / UPS North (N,E)" if north else "WGS 84 / UPS South (N,E)"
    lat0 = 90 if north else -90
    return (
        f'PROJCS["{name}",{_WKT_GEOGCS},'
        f'PROJECTION["Polar_Stereographic"],'
        f'PARAMETER["latitude_of_origin",{lat0}],'
        f'PARAMETER["central_meridian",0],'
        f'PARAMETER["scale_factor",0.994],'
        f'PARAMETER["false_easting",2000000],'
        f'PARAMETER["false_northing",2000000],'
        f'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
        f'AUTHORITY["EPSG","{code}"]]'
    )


_KIND_LABELS = {
    "geographic": "geographic (lon/lat)",
    "utm": "Transverse Mercator (UTM)",
    "ups": "Polar Stereographic (UPS)",
    "webmercator": "Web Mercator",
    "mercator": "Mercator",
    "polar_stereo": "Polar Stereographic",
    "laea": "Lambert Azimuthal Equal Area",
    "tm_grid": "Transverse Mercator",
    "lcc": "Lambert Conformal Conic",
    "albers": "Albers Equal Area",
    "somerc": "Swiss Oblique Mercator",
    "sterea": "Oblique Stereographic",
    "krovak": "Krovak",
    "proj_pipe": "generic (cs2cs)",
}


def describe_crs(value: str) -> dict:
    """Human description of a --target-crs value, for interactive surfaces
    (the GUI validates the field live with this). Returns
    {ok, name?, method?, backend?, reason?} without raising."""
    v = (value or "").strip()
    if not v or v.lower() == "none":
        return {"ok": True, "name": "no reprojection", "method": "none",
                "backend": "—"}
    if v.lower() == "auto":
        return {"ok": True, "name": "auto (UTM/UPS from scene centroid, "
                                    "Norway/Svalbard exceptions)",
                "method": "auto", "backend": "native"}
    if v.startswith("+"):
        # interactive hint path for +proj= strings: classify WITHOUT
        # registering a synthetic code or spawning projinfo/cs2cs — the GUI
        # calls this per debounced keystroke and registration caches are
        # process-lifetime (real registration happens at processing time)
        try:
            kind = _kind_from_proj_tokens(_proj_tokens(v), _PROJ_STRING_BASE)
            return {"ok": True, "name": v,
                    "method": _KIND_LABELS.get(kind["kind"], kind["kind"]),
                    "backend": "native projection math (proj string)"}
        except ValueError as exc:
            if _cs2cs_available():
                return {"ok": True, "name": v, "method": "generic (cs2cs)",
                        "backend": "cs2cs pipe (one subprocess per warp "
                                   "grid)"}
            return {"ok": False, "reason": str(exc)}
    try:
        code = parse_epsg_code(v)
    except Exception as e:  # noqa: BLE001 — malformed WKT/proj strings
        return {"ok": False, "reason": str(e)}
    if code is None:
        return {"ok": False,
                "reason": "not an EPSG:XXXX code, +proj= string, or WKT"}
    info = epsg_kind(code)
    if info is None:
        return {"ok": False,
                "reason": unsupported_reason(code) or "unresolvable CRS"}
    if info["kind"] == "proj_pipe":
        backend = "cs2cs pipe (one subprocess per warp grid)"
    elif info.get("dynamic"):
        backend = "projinfo-resolved, native projection math"
    else:
        backend = "native tables"
    name = info.get("name")
    if not name and code < _PROJ_STRING_BASE:
        name = f"EPSG:{code}"
    return {"ok": True, "name": name or v,
            "method": _KIND_LABELS.get(info["kind"], info["kind"]),
            "backend": backend}


def _unsupported_crs_error(code: int) -> ValueError:
    reason = _DYN_UNSUPPORTED.get(code)
    why = f" ({reason})" if reason else ""
    return ValueError(
        f"unsupported target CRS EPSG:{code}{why}; supported: "
        f"{SUPPORTED_CRS_FAMILIES}")


# kinds whose projection functions do NOT apply p["datum"] internally —
# the dispatch wrappers handle the (dynamic-CRS-only) datum leg for them
_DISPATCH_DATUM_KINDS = ("geographic", "webmercator", "mercator",
                         "polar_stereo", "laea")


def _project_forward_core(lon, lat, info: dict):
    if info["kind"] == "geographic":
        return np.asarray(lon, np.float64), np.asarray(lat, np.float64)
    if info["kind"] == "utm":
        return utm_forward(lon, lat, info["zone"], info["south"])
    if info["kind"] == "webmercator":
        return webmercator_forward(lon, lat)
    if info["kind"] == "mercator":
        return mercator_forward(lon, lat)
    if info["kind"] == "polar_stereo":
        extra = {}
        if "ellps" in info:
            a, e, e2, *_ = _tm_series(info["ellps"])
            extra = dict(a=a, e=e, e2=e2)
        return polar_stereo_forward(lon, lat, info["lat_ts"], info["lon0"],
                                    info["fe"], info["fn"], info["north"],
                                    k0=info.get("k0"), **extra)
    if info["kind"] == "laea":
        extra = {}
        if "ellps" in info:
            a, e, e2, *_ = _tm_series(info["ellps"])
            extra = dict(a=a, e=e, e2=e2)
        return laea_forward(lon, lat, info["lat0"], info["lon0"],
                            info["fe"], info["fn"], **extra)
    if info["kind"] == "tm_grid":
        return tmerc_grid_forward(lon, lat, info)
    if info["kind"] == "lcc":
        return lcc_forward(lon, lat, info)
    if info["kind"] == "albers":
        return albers_forward(lon, lat, info)
    if info["kind"] == "somerc":
        return somerc_forward(lon, lat, info)
    if info["kind"] == "sterea":
        return sterea_forward(lon, lat, info)
    if info["kind"] == "krovak":
        return krovak_forward(lon, lat, info)
    return ups_forward(lon, lat, info["north"])


def project_forward(lon, lat, code: int):
    """(lon, lat)° → target CRS coordinates for any supported EPSG code."""
    info = epsg_kind(code)
    if info is None:
        raise _unsupported_crs_error(code)
    if info["kind"] == "proj_pipe":
        # cs2cs handles the datum leg and emits CRS units directly
        return _cs2cs_points(lon, lat, info["cs2cs"], info["axes"],
                             inverse=False,
                             ang_scale=info.get("ang_scale"))
    if info.get("datum") and info["kind"] in _DISPATCH_DATUM_KINDS:
        lon, lat = _datum_shift(lon, lat, info["datum"], to_wgs84=False)
    x, y = _project_forward_core(lon, lat, info)
    tm = info.get("to_meter")
    if tm:
        x, y = np.asarray(x) / tm, np.asarray(y) / tm
    return x, y


def _project_inverse_core(x, y, info: dict):
    if info["kind"] == "geographic":
        return np.asarray(x, np.float64), np.asarray(y, np.float64)
    if info["kind"] == "utm":
        return utm_inverse(x, y, info["zone"], info["south"])
    if info["kind"] == "webmercator":
        return webmercator_inverse(x, y)
    if info["kind"] == "mercator":
        return mercator_inverse(x, y)
    if info["kind"] == "polar_stereo":
        extra = {}
        if "ellps" in info:
            a, e, e2, *_ = _tm_series(info["ellps"])
            extra = dict(a=a, e=e, e2=e2)
        return polar_stereo_inverse(x, y, info["lat_ts"], info["lon0"],
                                    info["fe"], info["fn"], info["north"],
                                    k0=info.get("k0"), **extra)
    if info["kind"] == "laea":
        extra = {}
        if "ellps" in info:
            a, e, e2, *_ = _tm_series(info["ellps"])
            extra = dict(a=a, e=e, e2=e2)
        return laea_inverse(x, y, info["lat0"], info["lon0"],
                            info["fe"], info["fn"], **extra)
    if info["kind"] == "tm_grid":
        return tmerc_grid_inverse(x, y, info)
    if info["kind"] == "lcc":
        return lcc_inverse(x, y, info)
    if info["kind"] == "albers":
        return albers_inverse(x, y, info)
    if info["kind"] == "somerc":
        return somerc_inverse(x, y, info)
    if info["kind"] == "sterea":
        return sterea_inverse(x, y, info)
    if info["kind"] == "krovak":
        return krovak_inverse(x, y, info)
    return ups_inverse(x, y, info["north"])


def project_inverse(x, y, code: int):
    """Target CRS coordinates → (lon, lat)°."""
    info = epsg_kind(code)
    if info is None:
        raise _unsupported_crs_error(code)
    if info["kind"] == "proj_pipe":
        return _cs2cs_points(x, y, info["cs2cs"], info["axes"], inverse=True,
                             ang_scale=info.get("ang_scale"))
    tm = info.get("to_meter")
    if tm:
        x, y = np.asarray(x, np.float64) * tm, np.asarray(y, np.float64) * tm
    lon, lat = _project_inverse_core(x, y, info)
    if info.get("datum") and info["kind"] in _DISPATCH_DATUM_KINDS:
        lon, lat = _datum_shift(lon, lat, info["datum"], to_wgs84=True)
    return lon, lat


# ---------------------------------------------------------------------------
# lon/lat -> EPSG (reference: sentinel1.rs:1766-1808)
# ---------------------------------------------------------------------------
def lonlat_to_epsg(lon: float, lat: float) -> str:
    """UTM zone with UPS poles and Norway/Svalbard exceptions."""
    if lat >= 84.0:
        return "EPSG:32661"
    if lat <= -80.0:
        return "EPSG:32761"
    lon_norm = lon
    if lon_norm < -180.0 or lon_norm >= 180.0:
        lon_norm = ((lon_norm + 180.0) % 360.0 + 360.0) % 360.0 - 180.0
    norway = 56.0 <= lat < 64.0 and 3.0 <= lon_norm < 12.0
    svalbard = 72.0 <= lat < 84.0
    if norway:
        zone = 32
    elif svalbard:
        if 0.0 <= lon_norm < 9.0:
            zone = 31
        elif 9.0 <= lon_norm < 21.0:
            zone = 33
        elif 21.0 <= lon_norm < 33.0:
            zone = 35
        elif 33.0 <= lon_norm < 42.0:
            zone = 37
        else:
            zone = min(max(int(np.floor((lon_norm + 180.0) / 6.0)) + 1, 1), 60)
    else:
        zone = min(max(int(np.floor((lon_norm + 180.0) / 6.0)) + 1, 1), 60)
    if lat >= 0.0:
        return f"EPSG:326{zone:02d}"
    return f"EPSG:327{zone:02d}"


def resolve_auto_target_crs(safe_dir: str | Path) -> Optional[str]:
    """Pick a UTM/UPS CRS from the measurement GCP centroid
    (reference: sentinel1.rs:1613-1764). Uses the native GCP reader instead
    of `gdalinfo -json`."""
    from .raster import RasterReader

    base = Path(safe_dir)
    measurement = base / "measurement"
    if not measurement.is_dir():
        logger.warning("AUTO-CRS: measurement directory not found: %s", measurement)
        return None
    candidate: Optional[Path] = None
    for path in sorted(measurement.iterdir()):
        if path.suffix.lower() not in (".tiff", ".tif"):
            continue
        name = path.name.lower()
        if "_warped.tif" in name or "_warped.tiff" in name:
            continue
        if "vv" in name or "vh" in name:
            candidate = path
            break
        if "hh" in name or "hv" in name:
            candidate = path
        elif candidate is None:
            candidate = path
    if candidate is None:
        logger.warning("AUTO-CRS: no measurement TIFF found in %s", measurement)
        return None
    logger.info("AUTO-CRS: candidate measurement: %s", candidate.name)
    try:
        reader = RasterReader(candidate)
    except Exception as e:
        logger.warning("AUTO-CRS: open failed for candidate: %s", e)
        return None
    lonlat = None
    gcps = reader.gcps
    if gcps is not None and len(gcps) and reader.geo.gcp_is_geographic:
        lon = float(np.mean(gcps[:, 2]))
        lat = float(np.mean(gcps[:, 3]))
        lonlat = (lon, lat)
        logger.info("AUTO-CRS: centroid from GCPs: lon=%.6f, lat=%.6f", lon, lat)
    elif reader.metadata.epsg == 4326 and reader.geo.geotransform:
        gt = reader.geo.geotransform
        w, h = reader.metadata.size_x, reader.metadata.size_y
        lon = gt[0] + gt[1] * w / 2 + gt[2] * h / 2
        lat = gt[3] + gt[4] * w / 2 + gt[5] * h / 2
        lonlat = (lon, lat)
        logger.info("AUTO-CRS: centroid from extent: lon=%.6f, lat=%.6f", lon, lat)
    reader.close()
    if lonlat is None:
        # GCP-less measurement TIFF: annotation geolocation grid centroid
        try:
            from .safe import parse_comprehensive_metadata

            meta = parse_comprehensive_metadata(base)
            grid = meta.geolocation_grid
        except Exception as e:  # noqa: BLE001 — any parse failure → no auto CRS
            logger.warning("AUTO-CRS: annotation parse failed: %s", e)
            grid = None
        if grid is not None and len(grid):
            lonlat = (float(np.mean(grid[:, 2])), float(np.mean(grid[:, 3])))
            logger.info(
                "AUTO-CRS: centroid from annotation geolocation grid: "
                "lon=%.6f, lat=%.6f", *lonlat)
    if lonlat is None:
        logger.warning("AUTO-CRS: could not compute lon/lat from GCPs or extent")
        return None
    epsg = lonlat_to_epsg(*lonlat)
    logger.info("AUTO-CRS: resolved target CRS = %s", epsg)
    return epsg


# ---------------------------------------------------------------------------
# Thin plate spline (the `gdalwarp -tps` equivalent, fitted host-side)
# ---------------------------------------------------------------------------
class ThinPlateSpline2D:
    """TPS mapping (u,v) → (x,y) fitted on control points.

    Fit is host f64 (N ≈ a few hundred GCPs → small dense solve); evaluation
    coefficients are exported for the on-device warp kernel, where the RBF
    sum is a (pixels × N) matmul on the MXU.
    """

    def __init__(self, src: np.ndarray, dst: np.ndarray, reg: float = 0.0):
        src = np.asarray(src, np.float64)
        dst = np.asarray(dst, np.float64)
        n = len(src)
        if n < 3:
            raise ValueError("TPS requires >= 3 control points")
        # normalize source domain for conditioning
        self._mean = src.mean(axis=0)
        self._scale = max(float(np.abs(src - self._mean).max()), 1e-12)
        s = (src - self._mean) / self._scale
        d2 = np.sum((s[:, None, :] - s[None, :, :]) ** 2, axis=-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            K = 0.5 * d2 * np.log(d2)
        K[~np.isfinite(K)] = 0.0
        if reg:
            K += reg * np.eye(n)
        P = np.concatenate([np.ones((n, 1)), s], axis=1)
        A = np.zeros((n + 3, n + 3))
        A[:n, :n] = K
        A[:n, n:] = P
        A[n:, :n] = P.T
        b = np.zeros((n + 3, 2))
        b[:n] = dst
        coeffs, *_ = np.linalg.lstsq(A, b, rcond=None)
        self.centers = s
        self.w = coeffs[:n]       # (n, 2) RBF weights
        self.affine = coeffs[n:]  # (3, 2): 1, u, v

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        pts = (np.asarray(pts, np.float64) - self._mean) / self._scale
        d2 = np.sum((pts[:, None, :] - self.centers[None, :, :]) ** 2, axis=-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            U = 0.5 * d2 * np.log(d2)
        U[~np.isfinite(U)] = 0.0
        out = U @ self.w
        out += self.affine[0] + pts[:, :1] * self.affine[1] + pts[:, 1:2] * self.affine[2]
        return out
