"""The port's HTJ2K reader (HT code-blocks of ISO/IEC 15444-15 in
_native/j2kdec.cpp, its tables in _native/ht_tables.h) against the JAX
package's RasterReader, which opens the same files through Pillow 12.1 and
OpenJPEG 2.5.4 (ht_dec.c), on the CPU: every band bit-equal (dtype
included), and RasterError where the JAX reader raises. The lossless
files also equal the arrays coded, which holds Pillow's decode to the
source too, whatever the encoder.

The codestreams are written by tests/htj2k_encode.py (no library here
encodes HT code-blocks): cleanup-only 5/3 blocks of u8, u16 and 12-bit
samples at every code-block shape and 0-5 levels, one or more tiles;
cleanup + SigProp + MagRef blocks with and without VSC; 9/7 and RGB (RCT,
ICT); HT tiles in a JP2; what OpenJPEG refuses or warns on (more than 3
passes, placeholder passes of no bytes, an RGN shift, the mixed style, a
damaged Scup); and bit flips of block data and headers. The committed
tiles of tests/data/jpeg2000_ht (chip_smoke.py's jpeg2000 phase) are
re-encoded here from their seeds."""
import hashlib
import io
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
import htj2k_encode  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu_torch._native import ht_tables  # noqa: E402
from sarpro_tpu_torch.errors import RasterError  # noqa: E402
from sarpro_tpu_torch.io import jpeg2000  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from test_torch_decoders import (  # noqa: E402
    RESAMPLE_TOL,
    _both_refuse,
    _equal_to_jax,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _scene(rng, shape, hi=255):
    """Speckled gradients: busy code-blocks in every band."""
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    g = (x * 5 + y * 3) % (hi + 1)
    return np.clip(0.6 * g + rng.gamma(4.0, hi / 32, shape), 0,
                   hi).astype(np.int64)


def _sparse(rng, shape, hi=255, p=0.06):
    """Mostly zeros: SigProp's neighbourhoods hold few members, so a
    sample's context (VSC or not) decides whether it is coded."""
    return np.where(rng.random(shape) < p, rng.integers(1, hi + 1, shape),
                    0).astype(np.int64)


def _write(tmp_path, blob: bytes, name: str = "h.j2k") -> Path:
    path = tmp_path / name
    path.write_bytes(blob)
    return path


def _source(a: np.ndarray, prec: int) -> np.ndarray:
    """The array Pillow's unpacker makes of samples of `prec` bits: 8
    bits as they are, more shifted to 16."""
    return a if prec <= 8 else a << (16 - prec)


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------
def test_ht_tables_equal_libopenjp2():
    """ht_tables.h is the generator's rendering of the tables it finds in
    Pillow's libopenjp2 by their shape and first words: two VLC tables of
    8 contexts x 128 windows whose entries repeat with their codeword's
    period, and the 13 MEL exponents."""
    lib = ht_tables.default_library()
    if lib is None:
        pytest.skip("Pillow's libopenjp2 is not installed here")
    tables = ht_tables.extract(lib)
    assert Path(ht_tables.HEADER).read_text() == ht_tables.render(tables)
    for name, first in ht_tables.VLC_FIRST.items():
        t = tables[name]
        assert ht_tables.vlc_shape_ok(t)
        assert tuple(int(v) for v in t[:8]) == first
        assert set(int(v) & 7 for v in t) <= set(range(1, 8))
    assert tuple(int(v) for v in tables["MEL_EXP"]) == ht_tables.MEL_EXP
    assert not ht_tables.vlc_shape_ok(np.zeros(1024, np.uint16))


# ---------------------------------------------------------------------------
# lossless 5/3 cleanup-only files
# ---------------------------------------------------------------------------
LOSSLESS = {
    "u8 64x64 5 levels": (8, (40, 52), dict(levels=5, cblk=(64, 64))),
    "u8 16x16 0 levels": (8, (37, 29), dict(levels=0, cblk=(16, 16))),
    "u8 32x128 1 level": (8, (70, 45), dict(levels=1, cblk=(32, 128))),
    "u8 4x1024 2 levels": (8, (33, 50), dict(levels=2, cblk=(4, 1024))),
    "u8 1024x4 3 levels": (8, (33, 50), dict(levels=3, cblk=(1024, 4))),
    "u16 64x64 4 levels": (16, (48, 61), dict(levels=4, cblk=(64, 64))),
    "u16 32x32 3 levels": (16, (64, 64), dict(levels=3, cblk=(32, 32))),
    "u16 8x8 2 levels": (16, (21, 19), dict(levels=2, cblk=(8, 8))),
    "12 bits 64x64 5 levels": (12, (40, 52), dict(levels=5)),
    "12 bits 16x64 2 levels": (12, (40, 52), dict(levels=2, cblk=(16, 64))),
    "two tiles": (8, (40, 52), dict(levels=2, cblk=(16, 16),
                                    tile=(32, 40))),
    "six tiles u16": (16, (50, 70), dict(levels=3, cblk=(32, 32),
                                         tile=(32, 24))),
    "1 x 1": (8, (1, 1), dict(levels=0)),
    "1 x 9": (8, (1, 9), dict(levels=1, cblk=(4, 4))),
    "9 x 1": (16, (9, 1), dict(levels=1, cblk=(4, 4))),
}


@pytest.mark.parametrize("case", list(LOSSLESS))
def test_lossless_ht_equals_jax_and_source(tmp_path, rng, case):
    prec, shape, kw = LOSSLESS[case]
    a = _scene(rng, shape, (1 << prec) - 1)
    code = htj2k_encode.encode([a], prec=prec, **kw)
    got = _equal_to_jax(_write(tmp_path, code))
    assert np.array_equal(got[..., 0].astype(np.int64), _source(a, prec))


def test_extreme_magnitudes_are_lossless(tmp_path, rng):
    """Full-range u16 noise: U-VLC suffixes of every length, MagSgn words
    of up to 18 bits, stuffing after 0xFF in each stream."""
    a = rng.integers(0, 65536, (48, 64)).astype(np.int64)
    a[::7] = 65535
    code = htj2k_encode.encode([a], prec=16, levels=2, cblk=(32, 32))
    got = _equal_to_jax(_write(tmp_path, code))
    assert np.array_equal(got[..., 0].astype(np.int64), a)


# ---------------------------------------------------------------------------
# SigProp and MagRef
# ---------------------------------------------------------------------------
REFINED = {
    "busy": (False, False, None),
    "busy vsc": (False, True, None),
    "sparse": (True, False, None),
    "sparse vsc": (True, True, None),
    "sparse sigprop only": (True, False, 2),
    "sparse vsc sigprop only": (True, True, 2),
}


@pytest.mark.parametrize("case", list(REFINED))
def test_refinement_passes_equal_jax(tmp_path, rng, case):
    """Cleanup above plane 1, then SigProp (and MagRef) of plane 0: the
    port's decode is the JAX reader's, and differs from the decode of the
    cleanup pass alone (the same blocks with a refinement segment of no
    bytes, which OpenJPEG decodes as cleanup-only after a warning)."""
    sparse, vsc, passes = REFINED[case]
    shape = (45, 38)
    a = _sparse(rng, shape) if sparse else _scene(rng, shape)
    kw = dict(levels=0 if sparse else 2, cblk=(16, 16), refine=True,
              vsc=vsc, passes=passes)
    got = _equal_to_jax(_write(tmp_path, htj2k_encode.encode([a], **kw)))
    alone = _equal_to_jax(_write(tmp_path, htj2k_encode.encode(
        [a], **kw, empty_refinement=True), "c.j2k"))
    assert not np.array_equal(got, alone)
    if passes is None and not sparse:
        assert np.array_equal(got[..., 0].astype(np.int64), a)


def test_vsc_changes_what_sigprop_codes(rng):
    """Stripe-causal contexts: the same sparse blocks code other SigProp
    bits with VSC than without it (samples whose only significant
    neighbour lies in the next stripe), and both decode in the port as in
    Pillow."""
    a = _sparse(rng, (48, 40))
    on, off = (htj2k_encode.encode([a], levels=0, cblk=(16, 16),
                                   refine=True, vsc=v) for v in (True, False))
    assert on != off
    for code in (on, off):
        pil = np.asarray(Image.open(io.BytesIO(code)))
        assert np.array_equal(jpeg2000.read(code).array, pil)


# ---------------------------------------------------------------------------
# 9/7 and three components
# ---------------------------------------------------------------------------
IRREVERSIBLE = {
    "u8 9/7": (8, 1, dict(levels=3, irreversible=True, step=0.6)),
    "u16 9/7 coarse": (16, 1, dict(levels=4, irreversible=True, step=40.0,
                                   cblk=(32, 32))),
    "12 bits 9/7 refined": (12, 1, dict(levels=2, irreversible=True,
                                        step=3.0, refine=True)),
    "rgb rct": (8, 3, dict(levels=3, cblk=(32, 32))),
    "rgb ict": (8, 3, dict(levels=3, irreversible=True, step=0.8)),
    "rgb ict refined vsc": (8, 3, dict(levels=2, irreversible=True,
                                       step=0.5, refine=True, vsc=True)),
    "rgb without mct": (8, 3, dict(levels=2, mct=False)),
}


@pytest.mark.parametrize("case", list(IRREVERSIBLE))
def test_irreversible_and_rgb_equal_jax(tmp_path, rng, case):
    prec, nc, kw = IRREVERSIBLE[case]
    planes = [_scene(rng, (41, 53), (1 << prec) - 1) for _ in range(nc)]
    code = htj2k_encode.encode(planes, prec=prec, **kw)
    got = _equal_to_jax(_write(tmp_path, code))
    if not kw.get("irreversible"):
        assert np.array_equal(got, np.stack(planes, -1))


def test_ht_tiles_in_a_jp2_with_world_file(tmp_path, rng):
    """Two HT tiles of u16 in chip_smoke's JP2 box with a .j2w and a
    .prj: bands, georeferencing and samples as the JAX reader reads them,
    the samples as written."""
    a = _scene(rng, (40, 64), 65535)
    code = htj2k_encode.encode([a], prec=16, levels=3, cblk=(16, 16),
                               tile=(32, 40))
    path = _write(tmp_path, chip_smoke.jp2_wrap(code, 64, 40, 1, 16, 17),
                  "ht.jp2")
    path.with_suffix(".j2w").write_text(
        "10.0\n0.0\n0.0\n-10.0\n500005.0\n5099995.0\n")
    path.with_suffix(".prj").write_text("EPSG:32632")
    got = _equal_to_jax(path)
    assert np.array_equal(got[..., 0], a.astype(np.uint16))


# ---------------------------------------------------------------------------
# what OpenJPEG refuses or warns on
# ---------------------------------------------------------------------------
FAULTS = {
    # refused: ht_dec.c's errors, j2k.c's mixed style
    "more than 3 passes": (dict(passes=4), "more than 3 coding passes"),
    "more than 3 passes refined": (dict(passes=5, refine=True),
                                   "more than 3 coding passes"),
    "rgn shift": (dict(rgn=2), "ROI"),
    "mixed style": (dict(style_bits=0x80), "HTJ2K mixed"),
    "scup 1": (dict(scup=1), "Scup"),
    "scup past lcup": (dict(scup=4000), "Scup"),
    # decoded: a warning and the cleanup pass alone, or style bits HT
    # blocks do not read
    "placeholder passes": (dict(empty_refinement=True), None),
    "placeholder passes refined": (dict(empty_refinement=True, refine=True),
                                   None),
    "bypass and termall bits": (dict(style_bits=0x05, refine=True), None),
    "reset and segsym bits": (dict(style_bits=0x22), None),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_behave_as_in_jax(tmp_path, rng, fault):
    """Each fault behaves in the port as in the JAX reader: refused by
    both, the port naming it, or decoded by both to the same pixels."""
    kw, match = FAULTS[fault]
    code = htj2k_encode.encode([_scene(rng, (24, 32))], levels=2,
                               cblk=(16, 16), **kw)
    path = _write(tmp_path, code)
    if match is None:
        _equal_to_jax(path)
    else:
        _both_refuse(path, match)


# what the port refuses by design and names (ROADMAP.md): a flipped header
# can ask for it where OpenJPEG decodes on
BY_DESIGN = ("Part-2", "above 31 bits")


def _outcome(path) -> str:
    """"open" where both readers open the file bit-equal, "refused" where
    both refuse it, "named" where only the port refuses it, naming a
    feature it refuses by design."""
    try:
        jraster.RasterReader(path).close()
    except jraster.RasterError:
        with pytest.raises(RasterError):
            traster.RasterReader(path)
        return "refused"
    try:
        traster.RasterReader(path).close()
    except RasterError as e:
        assert any(k in str(e) for k in BY_DESIGN), str(e)
        return "named"
    _equal_to_jax(path)
    return "open"


FLIPPED = {
    "cleanup u8": lambda rng: htj2k_encode.encode(
        [_scene(rng, (40, 52))], levels=2, cblk=(16, 16)),
    "cleanup u16 64x64": lambda rng: htj2k_encode.encode(
        [_scene(rng, (48, 40), 65535)], prec=16, levels=1),
    "refined vsc": lambda rng: htj2k_encode.encode(
        [_sparse(rng, (40, 36))], levels=0, cblk=(16, 16), refine=True,
        vsc=True),
    "rgb ict refined": lambda rng: htj2k_encode.encode(
        [_scene(rng, (32, 40)) for _ in range(3)], levels=2, cblk=(16, 16),
        irreversible=True, step=0.7, refine=True),
}


@pytest.mark.parametrize("where", ["blocks", "headers"])
@pytest.mark.parametrize("case", list(FLIPPED))
def test_bit_flips_agree_with_jax(tmp_path, rng, case, where):
    """60 single-bit flips of a codestream's packet data (block bytes and
    packet headers) or of its marker segments: both readers open the file
    bit-equal, or both refuse it, or (a header flipped into a Part-2
    coding) the port names what it refuses by design."""
    code = FLIPPED[case](rng)
    sod = code.index(b"\xff\x93") + 2
    lo, hi = (sod, len(code) - 2) if where == "blocks" else (2, sod - 2)
    seen = {"open": 0, "refused": 0, "named": 0}
    for k in range(60):
        b = bytearray(code)
        b[int(rng.integers(lo, hi))] ^= 1 << int(rng.integers(0, 8))
        seen[_outcome(_write(tmp_path, bytes(b), f"f{k}.j2k"))] += 1
    print(f"{case} {where}: {seen}")
    assert sum(seen.values()) == 60 and seen["named"] <= 10, seen


# ---------------------------------------------------------------------------
# the decoded band onto the device (the CPU here)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alg", ["average", "cubic"])
def test_decimated_read_of_ht_band_equals_jax(tmp_path, rng, alg):
    """read_band_resampled(1, 30, 20, ...) of an HT band: the port's device
    route against the JAX package's."""
    a = _scene(rng, (60, 90), 65535)
    path = _write(tmp_path, htj2k_encode.encode([a], prec=16, levels=3,
                                                cblk=(32, 32)))
    t, j = traster.RasterReader(path), jraster.RasterReader(path)
    try:
        got = traster.read_band_resampled_to_device(t, 1, 30, 20, "cpu", alg)
        want = j.read_band_resampled(1, 30, 20, alg)
    finally:
        t.close()
        j.close()
    assert got.dtype == torch.float32 and tuple(got.shape) == (20, 30)
    np.testing.assert_allclose(got.numpy(), want, **RESAMPLE_TOL)


# ---------------------------------------------------------------------------
# the committed codestreams
# ---------------------------------------------------------------------------
SMALL_SEED = 29


def small_fixtures() -> dict:
    """tests/data/jpeg2000_ht's small files as htj2k_encode writes them
    from SMALL_SEED: a sparse u8 band with SigProp and MagRef under VSC,
    and an RGB 9/7 (ICT) band with refinement passes; each with the
    SHA-256 of Pillow's decode."""
    rng = np.random.default_rng(SMALL_SEED)
    return {
        "sparse_refined_vsc_64.j2k": htj2k_encode.encode(
            [_sparse(rng, (64, 64))], levels=1, cblk=(32, 32), refine=True,
            vsc=True),
        "rgb_97_refined_64.j2k": htj2k_encode.encode(
            [_scene(rng, (64, 64)) for _ in range(3)], levels=3,
            cblk=(16, 16), irreversible=True, step=0.6, refine=True),
    }


SMALL_SHA256 = {
    "sparse_refined_vsc_64.j2k": ("8c6a82c88b7645503c19712a729e2abf"
                                  "d28743f70b5b3997d40af84b6bf5903e"),
    "rgb_97_refined_64.j2k": ("fe26849edccf8342c20838f431601ae3"
                              "f86badb9369ab765a29cb4ecf78b10b0"),
}


def test_committed_small_files_are_the_encoders(tmp_path):
    """The committed small files are htj2k_encode's output from the seed;
    Pillow's decode of each has its pinned SHA-256, and the port's equals
    Pillow's."""
    for name, blob in small_fixtures().items():
        assert (chip_smoke.J2K_HT_DIR / name).read_bytes() == blob, name
        pil = np.asarray(Image.open(io.BytesIO(blob)))
        assert hashlib.sha256(pil.tobytes()).hexdigest() == \
            SMALL_SHA256[name], name
        _equal_to_jax(_write(tmp_path, blob, name))


def test_committed_ht_tile_is_the_encoders(tmp_path):
    """chip_smoke's HT tile: htj2k_encode's lossless coding of the seeded
    512^2 u16 tile (5/3, 5 levels, 64^2 blocks); Pillow decodes it to the
    tile, whose SHA-256 chip_smoke.py pins, and so does the port."""
    tile = chip_smoke.j2k_band_tile()
    blob = htj2k_encode.encode([tile], prec=16, levels=5, cblk=(64, 64))
    assert (chip_smoke.J2K_HT_DIR / chip_smoke.J2K_HT).read_bytes() == blob
    assert len(blob) < 1 << 19
    assert struct.unpack_from(">H", blob, 6)[0] & 0x4000  # Rsiz: Part 15
    pil = np.asarray(Image.open(io.BytesIO(blob)))
    assert np.array_equal(pil, tile)
    assert hashlib.sha256(pil.tobytes()).hexdigest() == \
        chip_smoke.J2K_HT_SHA256
    got = _equal_to_jax(_write(tmp_path, blob, "ht.j2k"))
    assert np.array_equal(got[..., 0], tile)


def test_spliced_ht_band_equals_jax(tmp_path):
    """chip_smoke's splice of the HT tile, at 3 x 2 tiles here, in its JP2
    box with its world file: Pillow and the port decode it to np.tile of
    the seeded tile."""
    code = (chip_smoke.J2K_HT_DIR / chip_smoke.J2K_HT).read_bytes()
    tile = chip_smoke.j2k_band_tile()
    side = tile.shape[0]
    path = _write(tmp_path, chip_smoke.jp2_wrap(
        chip_smoke.j2k_splice(code, 3, 2), 3 * side, 2 * side, 1, 16, 17),
        "band.jp2")
    path.with_suffix(".j2w").write_text(
        "10.0\n0.0\n0.0\n-10.0\n500005.0\n5099995.0\n")
    path.with_suffix(".prj").write_text("EPSG:32632")
    got = _equal_to_jax(path)
    assert np.array_equal(got[..., 0], np.tile(tile, (2, 3)))


def test_mel_reader_alignment_as_openjpeg(tmp_path, rng):
    """ht_dec.c's MEL reader refuses a byte above 0x8F after a 0xFF only
    among the bytes it reads singly, up to the next 4-byte boundary of
    their address (the block's offset in the tile's data, as OpenJPEG
    allocates it): a block whose MEL starts 0xFF 0x90 is refused by both
    readers where that boundary is two or more bytes on, and read alike by
    both where it is one byte on."""
    seen = set()
    for _ in range(24):
        a = _scene(rng, (int(rng.integers(8, 40)), int(rng.integers(8, 40))))
        code = htj2k_encode.encode([a], levels=0, cblk=(64, 64))
        # the one block: the DC-shifted samples, Mb = 8 + 2 guard bits - 1
        _, segs = htj2k_encode.encode_block(np.abs(a - 128), a < 128, 9)
        seg = segs[0][1]
        at = code.find(seg)
        sod = code.index(b"\xff\x93") + 2
        scup = (seg[-1] << 4) | (seg[-2] & 0xF)
        mel = at + len(seg) - scup
        assert at > sod and scup >= 2
        b = bytearray(code)
        b[mel:mel + 2] = b"\xff\x90"
        boundary = 4 - ((mel - sod) & 3)
        path = _write(tmp_path, bytes(b), f"m{len(seen)}.j2k")
        if boundary >= 2:
            _both_refuse(path, "MEL")
        else:
            assert _outcome(path) in ("open", "refused")
        seen.add(boundary >= 2)
        if seen == {True, False}:
            break
    assert seen == {True, False}, seen
