"""The port's AVIF reader on the coding tools past Pillow's defaults, against
the JAX package's RasterReader (Pillow 12.1, libavif 1.3.0, dav1d 1.5.1,
libyuv) on the CPU: quantizer matrices, film grain, premultiplied alpha
(`prem`) and intra block copy. Every band bit-equal, dtype included; no
tolerance anywhere.

Inputs are the committed files of tests/data/avif whose names start with
TOOL_PREFIXES (chip_smoke.py's avif phase decodes them on the card; they are
held equal here to what Pillow writes from AVIF_SEED, `tools_files`):

  * quantizer matrices (`enable-qm 1`): `qm-min` = `qm-max` at levels 0, 4,
    8 and 15, with delta-q (`deltaq-mode 3`) and delta-LF (`deltaq-mode 2`,
    `delta-lf-mode 1`), on 4:4:4, 4:2:2 and 4:0:0, and lossless (every
    segment at the flat level 15). aom writes no segmentation for a still
    image here: `aq-mode` 1 to 3 at speeds 2 to 8 leave it off;
  * film grain: aom's `film-grain-test` vectors 1 to 16 (AR lags 0 to 3,
    chroma scaling from luma, overlap, clipping to the restricted range), a
    grain model aom estimates from speckle (`denoise-noise-level 25`), sizes
    of 7 x 5 and 257 x 129, every layout, and RGBA (the alpha item's stream
    carries grain too, and libavif lets dav1d apply it);
  * `prem`: RGBA and "LA" in 4:2:0, 4:4:4 and 4:0:0 with alpha ramps from 0
    to 255, and one with quantizer matrices and grain as well;
  * intra block copy (aom writes it with `tune-content screen` on periodic
    content: tiles of a SAR band and of a scene, in every layout, at speeds
    4 and 6, 128 x 128 superblocks and 2 x 2 tiles, and RGBA).

Beside them: every (colour, alpha) pair of libavif's unpremultiply, flips of
a grain file's headers, a decimated read of a grain file, and the one film
grain header aom 3.12.1 writes that the port refuses by name (4:0:0 with
`denoise-noise-level`: see test_monochrome_denoise_is_refused_by_name)."""
import hashlib
import io
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu_torch.errors import RasterError  # noqa: E402
from sarpro_tpu_torch.io import avif  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from test_torch_avif import (  # noqa: E402
    AVIF_DIR,
    TOOL_PREFIXES,
    Items,
    _bit_flips,
    _box,
    _decimated_read_equals_jax,
    _equal_to_jax,
    _save,
    _write,
    alpha_plane,
    chip_smoke,
    footprint,
    scene,
)

SCREEN = {"tune-content": "screen"}
DENOISE = {"denoise-noise-level": "25"}
QM = {"enable-qm": "1"}


def _la(gray: np.ndarray, alpha: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.dstack([gray, alpha]), "LA").save(buf, format="AVIF",
                                                          **kw)
    return buf.getvalue()


def tools_files() -> dict:
    """The tool fixtures of tests/data/avif as Pillow writes them from
    chip_smoke's AVIF_SEED, in the order of chip_smoke.AVIF_FIXTURES."""
    s = chip_smoke.AVIF_SEED
    base = scene(s, 67, 130)
    out = {}
    for level in (0, 4, 8, 15):
        out[f"qm_l{level}.avif"] = _save(base, quality=50, speed=6, advanced={
            **QM, "qm-min": str(level), "qm-max": str(level)})
    big = scene(s + 2, 129, 257)
    out["qm_deltaq.avif"] = _save(big, quality=40, speed=6,
                                  advanced={**QM, "deltaq-mode": "3"})
    out["qm_delta_lf.avif"] = _save(big, quality=40, speed=6, advanced={
        **QM, "deltaq-mode": "2", "delta-lf-mode": "1"})
    for ss in ("4:4:4", "4:2:2", "4:0:0"):
        out[f"qm_{ss.replace(':', '')}.avif"] = _save(
            base, quality=40, speed=6, subsampling=ss,
            advanced={**QM, "qm-min": "2", "qm-max": "6"})
    out["qm_lossless.avif"] = _save(base, quality=100, speed=6, advanced=QM)
    for v in range(1, 17):
        out[f"fg_test{v:02d}.avif"] = _save(
            base, quality=50, speed=6, advanced={"film-grain-test": str(v)})
    sar = chip_smoke.avif_band_u8(96)
    out["fg_denoise.avif"] = _save(np.dstack([sar] * 3), quality=30,
                                   speed=6, advanced=DENOISE)
    for rows, cols in ((5, 7), (129, 257)):
        out[f"fg_size_{cols}x{rows}.avif"] = _save(
            scene(s + 50 + rows, rows, cols), quality=40, speed=6,
            advanced={"film-grain-test": "3"})
    for ss in ("4:4:4", "4:2:2", "4:0:0"):
        out[f"fg_{ss.replace(':', '')}.avif"] = _save(
            base, quality=40, speed=6, subsampling=ss,
            advanced={"film-grain-test": "10"})
    out["fg_rgba.avif"] = _save(np.dstack([base, alpha_plane(67, 130)]),
                                quality=50, speed=6,
                                advanced={"film-grain-test": "1"})
    for ss in ("4:2:0", "4:4:4", "4:0:0"):
        tag = ss.replace(":", "")
        out[f"prem_rgba_{tag}.avif"] = _save(
            np.dstack([base, alpha_plane(67, 130)]), quality=50, speed=6,
            subsampling=ss, alpha_premultiplied=True)
        out[f"prem_la_{tag}.avif"] = _la(
            base[..., 1], alpha_plane(67, 130), quality=50, speed=6,
            subsampling=ss, alpha_premultiplied=True)
    out["prem_grain_qm.avif"] = _save(
        np.dstack([base, alpha_plane(67, 130, s)]), quality=30, speed=6,
        alpha_premultiplied=True,
        advanced={**QM, "film-grain-test": "16"})
    tile = np.tile(chip_smoke.avif_band_u8(48), (5, 5))[:230, :230]
    out["ibc_sar.avif"] = _save(np.dstack([tile] * 3), quality=40, speed=6,
                                advanced=SCREEN)
    periodic = np.tile(scene(s, 37, 41), (6, 6, 1))[:200, :240]
    out["ibc_s4.avif"] = _save(periodic, quality=50, speed=4,
                               advanced=SCREEN)
    for ss in ("4:4:4", "4:2:2", "4:0:0"):
        out[f"ibc_{ss.replace(':', '')}.avif"] = _save(
            periodic, quality=50, speed=6, subsampling=ss, advanced=SCREEN)
    out["ibc_sb128.avif"] = _save(periodic, quality=50, speed=4,
                                  advanced={**SCREEN, "sb-size": "128"})
    out["ibc_tiles_2x2.avif"] = _save(periodic, quality=50, speed=6,
                                      tile_rows=1, tile_cols=1,
                                      advanced=SCREEN)
    alpha = np.tile(alpha_plane(37, 41, s), (6, 6))[:200, :240]
    out["ibc_rgba.avif"] = _save(np.dstack([periodic, alpha]), quality=50,
                                 speed=6, advanced=SCREEN)
    return out


def grain_band_file() -> bytes:
    """chip_smoke.AVIF_GRAIN_BAND as Pillow writes it: avif_band_u8 at
    AVIF_BAND_SIDE^2 as RGBA with footprint() as its alpha, premultiplied,
    speed 6, AVIF_BAND_QUALITY, autotiling, `enable-qm 1` and
    `denoise-noise-level 25` (aom estimates a grain model from the speckle
    of the colour, none from the flat alpha; 160 s and 2.7 GB here, not run
    by the tests)."""
    side = chip_smoke.AVIF_BAND_SIDE
    gray = chip_smoke.avif_band_u8(side)
    return _save(np.dstack([gray, gray, gray, footprint(side)]),
                 quality=chip_smoke.AVIF_BAND_QUALITY, speed=6,
                 autotiling=True, alpha_premultiplied=True,
                 advanced={**QM, **DENOISE})


def test_grain_band_equals_pillows_decode():
    """The committed 9216^2 grain band (chip_smoke's avif phase): RGBA with
    `prem`, under 1 MB, and the port's decode and Pillow's both hash to
    AVIF_GRAIN_BAND_SHA256."""
    blob = chip_smoke.AVIF_GRAIN_BAND.read_bytes()
    assert len(blob) < 1 << 20
    p = avif.parse(blob)
    side = chip_smoke.AVIF_BAND_SIDE
    assert (p.width, p.height, p.alpha_size, p.premultiplied) == (
        side, side, (side, side), True)
    with Image.open(io.BytesIO(blob)) as im:
        assert im.mode == "RGBA"
        want = hashlib.sha256(np.asarray(im).tobytes()).hexdigest()
    assert want == chip_smoke.AVIF_GRAIN_BAND_SHA256
    got = avif.read(blob).load().array
    assert hashlib.sha256(got.tobytes()).hexdigest() == want
    assert (got[..., 3] == 0).any() and (got[..., 3] == 255).any()
    assert (got[got[..., 3] == 0][:, :3] == 0).all()


TOOL_NAMES = [n for n in chip_smoke.AVIF_FIXTURES
              if n.startswith(TOOL_PREFIXES)]


def test_tool_fixtures_are_pillows():
    """The tool fixtures of tests/data/avif are what Pillow writes from the
    seed, each opening to the SHA-256 chip_smoke pins (AVIF_FIXTURES)."""
    files = tools_files()
    assert list(files) == TOOL_NAMES
    for name, blob in files.items():
        assert (AVIF_DIR / name).read_bytes() == blob, name
        with Image.open(io.BytesIO(blob)) as im:
            digest = hashlib.sha256(np.asarray(im).tobytes()).hexdigest()
        assert digest == chip_smoke.AVIF_FIXTURES[name], name


@pytest.mark.parametrize("name", TOOL_NAMES)
def test_tool_fixture_equals_jax(name):
    got = _equal_to_jax(AVIF_DIR / name)
    with Image.open(AVIF_DIR / name) as im:
        bands = len(im.mode)
    assert got.dtype == np.uint8 and got.shape[2] == bands
    assert hashlib.sha256(got.tobytes()).hexdigest() == \
        chip_smoke.AVIF_FIXTURES[name]


@pytest.mark.parametrize("chunk", range(4))
def test_bit_flips_of_grain_header_agree_with_jax(tmp_path, chunk):
    """200 single-bit flips in the first 160 bytes of the AV1 data of a file
    with film grain (fg_test16: 8 luma and 8 + 8 chroma points, lag 3,
    overlap; its film_grain_params end 140 bytes in), 50 a case: a flipped
    seed, point, AR coefficient, shift or flag leaves the tiles in step and
    opens with other grain, bit-equal to the JAX reader's; dav1d's refusals
    (points out of order, too many points, one 4:2:0 chroma plane without
    points) are the port's."""
    seen = _bit_flips(tmp_path, "fg_test16.avif", 2400 + chunk, head=160)
    assert seen["open"] >= 5, seen


@pytest.mark.parametrize("alg", ["average", "cubic", "nearest"])
def test_decimated_read_of_grain_file_equals_jax(alg):
    """The decimated read (band 2) of a file with film grain on every
    plane."""
    _decimated_read_equals_jax("fg_size_257x129.avif", 2, 100, 50, alg)


def _probe_pairs() -> tuple:
    """A lossless 4:4:4 RGBA file whose green, read with the identity
    matrix, runs 0 to 255 along the rows and whose alpha runs 0 to 255 down
    the columns, without and with a `prem` reference."""
    x = np.arange(256, dtype=np.uint8)
    img = np.zeros((256, 256, 4), np.uint8)
    img[..., :3] = x[None, :, None]
    img[..., 3] = x[:, None]
    f = Items(_save(img, quality=100, subsampling="4:4:4", speed=6))
    f.prop(b"colr", b"nclx" + struct.pack(">HHHB", 1, 13, 0, 0x80), 1)
    plain = f.build()
    f.refs += _box(b"prem", struct.pack(">HHH", 1, 1, 2))
    return plain, f.build()


def test_unpremultiply_of_every_pair_equals_jax(tmp_path):
    """libavif's unpremultiply (libyuv's ARGBUnattenuate) over all 65536
    (colour, alpha) pairs, colour above alpha and alpha 0 included:
    bit-equal to the JAX reader; alpha 0 gives 0, alpha 255 the colour,
    and alpha 1 saturates colours from 128 up to 0 (libyuv's signed
    16-bit words)."""
    plain, prem = _probe_pairs()
    a = _equal_to_jax(_write(tmp_path, plain, "plain.avif"))
    b = _equal_to_jax(_write(tmp_path, prem, "prem.avif"))
    c, al = a[..., 1].astype(int), a[..., 3].astype(int)
    assert len(np.unique(c * 256 + al)) == 65536
    assert np.array_equal(a[..., 3], b[..., 3])
    out = b[..., 1].astype(int)
    assert (out[al == 0] == 0).all()
    assert np.array_equal(out[al == 255], c[al == 255])
    assert (out[(al == 1) & (c >= 128)] == 0).all()
    assert (out[(al == 1) & (c > 0) & (c < 128)] == 255).all()


REFERENCES = {
    "prem": ([(b"auxl", 2, (1,)), (b"prem", 1, (2,))], 4),
    "prem from the alpha": ([(b"auxl", 2, (1,)), (b"prem", 2, (1,))], 4),
    "prem, then to another item": ([(b"auxl", 2, (1,)), (b"prem", 1, (2,)),
                                    (b"prem", 1, (7,))], 4),
    "prem to another item, then to the alpha": (
        [(b"auxl", 2, (1,)), (b"prem", 1, (7,)), (b"prem", 1, (2,))], 4),
    "prem to the alpha and another in one box": (
        [(b"auxl", 2, (1,)), (b"prem", 1, (2, 7))], 4),
    "auxl, then to another item": ([(b"auxl", 2, (1,)), (b"auxl", 2, (7,))],
                                   3),
    "auxl to another item, then to the colour": (
        [(b"auxl", 2, (7,)), (b"auxl", 2, (1,))], 4),
    "auxl to another and the colour in one box": ([(b"auxl", 2, (7, 1))],
                                                  4),
}


@pytest.mark.parametrize("case", list(REFERENCES))
def test_item_references_equal_jax(tmp_path, case):
    """libavif keeps the last reference of each type an item has: a `prem`
    counts where the colour item's last one is to its alpha item, and an
    `auxl` makes the alpha item where its last one is to the colour item
    (the mode, RGBA or RGB, follows)."""
    refs, bands = REFERENCES[case]
    f = Items((AVIF_DIR / "prem_rgba_444.avif").read_bytes())
    f.refs = b"\0\0\0\0" + b"".join(
        _box(kind, struct.pack(f">HH{len(to)}H", frm, len(to), *to))
        for kind, frm, to in refs)
    got = _equal_to_jax(_write(tmp_path, f.build()))
    assert got.shape[2] == bands


def test_monochrome_denoise_is_refused_by_name(tmp_path):
    """aom 3.12.1 writes a 4:0:0 frame whose grain model it estimates
    (`denoise-noise-level`) with the chroma planes' AR coefficients and
    multipliers, which a monochrome frame header does not have: a decoder
    reads the tile data from the wrong byte. dav1d decodes that to garbage
    (what the JAX reader opens); the port names the tile data that does not
    end in the spec's trailing bits."""
    sar = chip_smoke.avif_band_u8(64)
    path = _write(tmp_path, _save(np.dstack([sar] * 3), quality=30, speed=6,
                                  subsampling="4:0:0", advanced=DENOISE))
    r = jraster.RasterReader(path)
    try:
        decoded = r._tiff._data
    finally:
        r.close()
    assert np.abs(decoded[..., 1].astype(int) - sar).mean() > 25
    with pytest.raises(RasterError, match="tile data that does not end in "
                       "the spec's trailing bits are not read by the port "
                       "yet"):
        traster.RasterReader(path)


@pytest.mark.parametrize("chunk", range(2))
def test_bit_flips_of_intrabc_file_agree_with_jax(tmp_path, chunk):
    """100 single-bit flips of a file whose blocks copy from the frame (50
    a case), anywhere in it: a flipped DV or transform split desyncs the
    tile, which both readers refuse or the port names; flips in the
    container agree."""
    _bit_flips(tmp_path, "ibc_s4.avif", 2500 + chunk)
