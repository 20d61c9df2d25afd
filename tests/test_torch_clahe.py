"""The port's CLAHE against the JAX package's, on the CPU: the tile
histogram and CDF lookup (their plain PyTorch versions) against the XLA
fallbacks and the Pallas kernel bodies in interpret mode, the CDF build,
the strategy windows, and the CLAHE band stage.

Tolerances. Integer outputs (tile histograms) and pieces fed identical
inputs are exact. XLA on the CPU contracts the lookup's bilinear blends into
FMAs, PyTorch rounds each step: the lookup is exact where no step rounds
(dyadic tile sizes and CDFs) and within 1e-6 otherwise (measured 2.4e-7 to
7.2e-7). From raw DN, XLA's f32 log (off by an ulp on about 2 % of values,
where PyTorch's is nearly correctly rounded) can move a percentile of the
4096-bin histogram by one bin and so the CLAHE window; a pixel whose CLAHE
bin moves by one changes by at most one CDF step, below 3/256 at clip limit
2 (3 u8 levels), plus 1 for the rounding: the DN-to-u8 band stage is held
to 4 and the CLAHE chain fed the JAX package's own dB and window to 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sarpro_tpu.core import clahe as jclahe  # noqa: E402
from sarpro_tpu.core import fused as jf  # noqa: E402
from sarpro_tpu.ops import kernels as JK  # noqa: E402
from sarpro_tpu.types import AutoscaleStrategy as JStrategy  # noqa: E402
from sarpro_tpu_torch import ops  # noqa: E402
from sarpro_tpu_torch.core import clahe as tclahe  # noqa: E402
from sarpro_tpu_torch.core import fused as tf  # noqa: E402
from sarpro_tpu_torch.types import AutoscaleStrategy  # noqa: E402

# each package takes its own enums
CLAHE = AutoscaleStrategy.CLAHE


def _j(strategy):
    return JStrategy(strategy.value)

LOOKUP_BOUND = 1e-6
# one CLAHE bin of window shift (CDF step < 3/256 -> 3 u8 levels) + rounding
BAND_BOUND = 1 + int(np.ceil(255 * (tclahe.CLIP_LIMIT + 1)
                             / tclahe.CLAHE_BINS))


def _t(a):
    return torch.from_numpy(np.array(a))


def _bins(rng, n, masked=0.05):
    b = rng.integers(0, 256, n).astype(np.int32)
    return np.where(rng.random(n) < masked, 256, b).astype(np.int32)


def test_constants_equal_jax_package():
    for name in ("TILES_X", "TILES_Y", "CLIP_LIMIT", "CLAHE_BINS"):
        assert getattr(tclahe, name) == getattr(jclahe, name), name


# rows, cols, tiles, tile_h, tile_w, row_offset: ragged tiles (rows or cols
# not divisible by the grid), a row chunk placed by row_offset, and shapes
# that drive the Pallas kernel's banded and unbanded windows
TILE_CASES = [
    (37, 45, 8, 5, 6, 0),
    (37, 45, 8, 5, 6, 13),
    (144, 512, 8, 18, 64, 0),
    (64, 96, 4, 32, 24, 64),
    (100, 1, 8, 13, 1, 7),
]


@pytest.mark.parametrize("rows,cols,tiles,tile_h,tile_w,off", TILE_CASES)
def test_tile_histogram_matches_xla_and_pallas(rng, rows, cols, tiles,
                                               tile_h, tile_w, off):
    b = _bins(rng, rows * cols)
    b[:3] = 256  # masked pixels are not counted
    grid = (cols, tiles, tiles, tile_h, tile_w)
    got = ops.tile_histogram(_t(b), *grid, row_offset=off).numpy()
    assert got.dtype == np.int32 and got.shape == (tiles * tiles * 256,)
    np.testing.assert_array_equal(got, np.asarray(JK._tile_histogram_xla(
        jnp.asarray(b), *grid, 256, row_offset=off)))
    assert got.sum() == int((b < 256).sum())
    with JK.pallas_interpret():
        want = np.asarray(JK.tile_histogram(jnp.asarray(b), *grid,
                                            row_offset=jnp.int32(off)))
    np.testing.assert_array_equal(got, want)


def test_tile_histogram_chunks_add_up(rng):
    """Row chunks counted with their row_offset sum to the whole image's
    histogram (the streamed and sharded use of the argument)."""
    rows, cols = 90, 70
    b = _t(_bins(rng, rows * cols))
    grid = (cols, 8, 8, 12, 9)
    whole = ops.tile_histogram(b, *grid)
    parts = sum(ops.tile_histogram(b[r0 * cols:r1 * cols], *grid,
                                   row_offset=r0)
                for r0, r1 in ((0, 25), (25, 61), (61, 90)))
    assert torch.equal(whole, parts)


def test_tile_histogram_rejects_bad_input():
    b = torch.zeros(12, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.tile_histogram(b.to(torch.int64), 4, 2, 2, 2, 2)
    with pytest.raises(ValueError):
        ops.tile_histogram(b, 5, 2, 2, 2, 2)  # not whole rows
    with pytest.raises(ValueError):
        ops.tile_histogram(b, 4, 2, 2, 2, 2, row_offset=-1)
    with pytest.raises(ValueError):
        ops.tile_histogram(b, 4, 32, 32, 1, 1, n_bins=256)  # above 227 KB


@pytest.mark.parametrize("rows,cols,tile_h,tile_w", [
    (64, 128, 8, 16), (256, 256, 32, 32), (40, 24, 8, 4)])
def test_clahe_lookup_exact_where_nothing_rounds(rng, rows, cols, tile_h,
                                                 tile_w):
    """Power-of-two tile sizes and CDFs in 1/256 steps make every product
    and sum exact, so the FMA contraction of XLA cannot show: equal bits."""
    b = _bins(rng, rows * cols)
    cd = (np.floor(rng.random((64, 256)) * 256) / 256).astype(np.float32)
    grid = (cols, 8, 8, tile_h, tile_w)
    for off in (0, 3 * tile_h):
        got = ops.clahe_lookup(_t(b), _t(cd), *grid, row_offset=off).numpy()
        want = np.asarray(JK._clahe_lookup_xla(
            jnp.asarray(b), jnp.asarray(cd), *grid, row_offset=off))
        np.testing.assert_array_equal(got, want)
        assert np.all(got[b == 256] == 0.0)


@pytest.mark.parametrize("rows,cols,tile_h,tile_w", [
    (37, 45, 5, 6), (160, 512, 20, 64), (333, 517, 42, 65)])
def test_clahe_lookup_matches_xla_within_fma_bound(rng, rows, cols, tile_h,
                                                   tile_w):
    b = _bins(rng, rows * cols)
    cd = rng.random((64, 256)).astype(np.float32)
    grid = (cols, 8, 8, tile_h, tile_w)
    got = ops.clahe_lookup(_t(b), _t(cd), *grid).numpy()
    want = np.asarray(JK._clahe_lookup_xla(jnp.asarray(b), jnp.asarray(cd),
                                           *grid))
    d = np.abs(got - want)
    print(f"clahe_lookup vs XLA: max|diff| {d.max():.3g}, share differing "
          f"{(d > 0).mean():.3f}")
    assert d.max() <= LOOKUP_BOUND
    assert np.all(got[b == 256] == 0.0)


@pytest.mark.parametrize("rows,cols,tile_h,tile_w,off", [
    (160, 512, 20, 64, 0), (48, 80, 12, 10, 24)])
def test_clahe_lookup_matches_pallas_interpret(rng, rows, cols, tile_h,
                                               tile_w, off):
    """Against the TPU kernel body: its bf16 hi/lo CDF split is documented
    to 2e-5 (tests/test_pallas_interpret.py)."""
    b = _bins(rng, rows * cols)
    cd = rng.random((64, 256)).astype(np.float32)
    grid = (cols, 8, 8, tile_h, tile_w)
    got = ops.clahe_lookup(_t(b), _t(cd), *grid, row_offset=off).numpy()
    with JK.pallas_interpret():
        want = np.asarray(JK.clahe_lookup(jnp.asarray(b), jnp.asarray(cd),
                                          *grid, row_offset=jnp.int32(off)))
    np.testing.assert_allclose(got, want, atol=2e-5)


# geometries the CUDA kernels branch on (rows, cols, row_offset, bins): row
# widths of each residue mod 4 (rows that do not start on 16 bytes), bands
# under 8 pixels a side (1-pixel tiles, where the clamps act), odd row
# offsets, a band of one bin (a warp's single-atomic path) and an all-masked
# band; the kernels themselves are held to these on the card (chip_smoke.py)
EDGE_CASES = [
    (40, 45, 0, "sar"),
    (40, 46, 3, "sar"),
    (40, 47, 0, "sar"),
    (5, 64, 0, "sar"),
    (64, 7, 1, "sar"),
    (3, 3, 0, "sar"),
    (48, 52, 0, "one"),
    (48, 52, 5, "masked"),
]


def _edge_bins(rng, n, kind):
    if kind == "one":
        return np.full(n, 128, np.int32)
    if kind == "masked":
        return np.full(n, 256, np.int32)
    return _bins(rng, n)


def _edge_grid(rows, cols, off):
    """The grayscale program's tiling of a band of rows + off rows."""
    return (cols, 8, 8, -(-(rows + off) // 8), -(-cols // 8))


@pytest.mark.parametrize("rows,cols,off,kind", EDGE_CASES)
def test_tile_histogram_edge_geometries(rng, rows, cols, off, kind):
    b = _edge_bins(rng, rows * cols, kind)
    grid = _edge_grid(rows, cols, off)
    got = ops.tile_histogram(_t(b), *grid, row_offset=off).numpy()
    np.testing.assert_array_equal(got, np.asarray(JK._tile_histogram_xla(
        jnp.asarray(b), *grid, 256, row_offset=off)))
    assert got.sum() == int((b < 256).sum())


@pytest.mark.parametrize("rows,cols,off,kind", EDGE_CASES)
def test_clahe_lookup_edge_geometries(rng, rows, cols, off, kind):
    b = _edge_bins(rng, rows * cols, kind)
    cd = rng.random((64, 256)).astype(np.float32)
    grid = _edge_grid(rows, cols, off)
    got = ops.clahe_lookup(_t(b), _t(cd), *grid, row_offset=off).numpy()
    want = np.asarray(JK._clahe_lookup_xla(jnp.asarray(b), jnp.asarray(cd),
                                           *grid, row_offset=off))
    assert np.abs(got - want).max() <= LOOKUP_BOUND
    assert np.all(got[b == 256] == 0.0)


def test_clahe_lookup_rejects_bad_input():
    b = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.clahe_lookup(b, torch.zeros((63, 256)), 4, 8, 8, 1, 1)
    with pytest.raises(ValueError):
        ops.clahe_lookup(b, torch.zeros((64, 256), dtype=torch.float64), 4,
                         8, 8, 1, 1)


def _hists(rng, rows, cols, tile_h, tile_w, skew):
    """Tile histograms of a bin image with SAR-like crowding (`skew` > 1
    piles counts into few bins, so the clip and the redistribution run)."""
    b = np.clip(rng.normal(128, 128 / skew, rows * cols), 0, 255)
    b = np.where(rng.random(rows * cols) < 0.03, 256, b).astype(np.int32)
    return np.asarray(JK._tile_histogram_xla(jnp.asarray(b), cols, 8, 8,
                                             tile_h, tile_w, 256))


@pytest.mark.parametrize("rows,cols,skew", [
    (256, 256, 1.0), (256, 256, 12.0), (193, 300, 6.0), (61, 37, 20.0)])
def test_clahe_cdfs_exact(rng, rows, cols, skew):
    tile_h, tile_w = -(-rows // 8), -(-cols // 8)
    h = _hists(rng, rows, cols, tile_h, tile_w, skew)
    want = np.asarray(jax.jit(jf._clahe_cdfs, static_argnums=(1, 2, 3, 4))(
        jnp.asarray(h), rows, cols, tile_h, tile_w))
    got = tf._clahe_cdfs(_t(h), rows, cols, tile_h, tile_w).numpy()
    assert got.shape == (64, 256) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _stats_dicts(rng):
    """Stats dicts (the keys _window reads) that drive every branch of every
    strategy: narrow and wide ranges, small and large IQR, skew and tails."""
    out = []
    for spread, skew in ((10.0, 0.0), (60.0, 0.0), (30.0, 8.0), (30.0, -8.0),
                         (3.0, 0.0), (45.0, 0.3)):
        p = np.sort(rng.normal(-12.0, spread / 6, 11)).astype(np.float32)
        p[6:] += np.float32(abs(skew))  # a long upper tail
        d = dict(zip(jf._PCT_ORDER, p))
        d.update(min=np.float32(p[0] - spread / 4),
                 max=np.float32(p[-1] + spread / 4),
                 mean=np.float32(p[5] + skew), std=np.float32(spread / 5),
                 count=np.int32(1000))
        out.append(d)
    return out


@pytest.mark.parametrize("strategy", list(AutoscaleStrategy))
def test_window_exact_every_strategy(rng, strategy):
    """Exact, except that XLA on the CPU fuses standard's and robust's
    `p - 2.5 * iqr` and `min + 0.02 * range` into FMAs: there the two differ
    by one rounding of the product, an ulp of the largest stat at most."""
    fused_madd = strategy in (AutoscaleStrategy.STANDARD,
                              AutoscaleStrategy.ROBUST)
    for d in _stats_dicts(rng):
        want = jax.jit(jf._window, static_argnums=1)(
            {k: jnp.asarray(v) for k, v in d.items()}, _j(strategy))
        got = tf._window({k: _t(v) for k, v in d.items()}, strategy)
        ulp = max(np.spacing(np.abs(np.float32(v)))
                  for k, v in d.items() if k != "count")
        for w, g in zip(want, got):
            assert g.dtype == torch.float32
            if fused_madd:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                           atol=ulp)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("lo,hi", [(0, 255), (17, 200), (40, 40),
                                   (0, 142), (5, 651), (0, 65535)])
def test_scale_u16_to_u8_exact(rng, lo, hi):
    """Ranges 142 and 646 are ones where a rounded-reciprocal scale would
    move a level."""
    q = rng.integers(lo, hi + 1, (50, 60)).astype(np.uint16)
    q.flat[:hi - lo + 1] = np.arange(lo, hi + 1)[:q.size]  # every value
    want = np.asarray(jax.jit(jf._scale_u16_to_u8)(q))
    got = tf._scale_u16_to_u8(_t(q.astype(np.float32))).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_clahe_norm_and_bins_exact(rng):
    db = rng.normal(-12, 6, (70, 90)).astype(np.float32)
    mask = rng.random((70, 90)) > 0.04
    low, high = np.float32(-21.5), np.float32(-2.25)
    norm_j = np.asarray(jax.jit(jf._clahe_norm)(db, mask, low, high))
    norm_t = tf._clahe_norm(_t(db), _t(mask), _t(low), _t(high))
    np.testing.assert_array_equal(norm_t.numpy(), norm_j)
    bins_j = np.asarray(jf._clahe_bins(jnp.asarray(norm_j), mask, 0, 0, 0, 0))
    bins_t = tf._clahe_bins(norm_t, _t(mask)).numpy()
    assert bins_t.dtype == np.int32
    np.testing.assert_array_equal(bins_t, bins_j)


def _dn(rng, shape, mean):
    dn = np.clip(rng.lognormal(mean, 1.1, shape), 0, 65535).astype(np.uint16)
    dn[rng.random(shape) < 0.02] = 0
    return dn


@pytest.mark.parametrize("shape", [(256, 256), (193, 300), (61, 37)])
def test_clahe_chain_on_identical_db_within_one(rng, shape):
    """`_clahe` + `_scale_u16_to_u8` fed the JAX package's own dB, mask and
    window: only the lookup's FMA rounding differs."""
    x = _dn(rng, shape, 5.0).astype(np.float32)
    db, mask = (np.asarray(a) for a in jax.jit(jf._db_mask)(x))
    s = jax.jit(jf._stats)(db, mask)
    low, high = np.float32(s["p01"]), np.float32(s["p99"])
    want = np.asarray(jax.jit(
        lambda d, m, lo, hi: jf._scale_u16_to_u8(jf._clahe(
            d, m, lo, hi, jnp.float32(255.0), *shape)))(db, mask, low, high))
    got = tf._scale_u16_to_u8(tf._clahe(_t(db), _t(mask), _t(low), _t(high),
                                        255.0, *shape)).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    print(f"{shape}: CLAHE chain share differing {(d > 0).mean():.2e}")
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("shape,size,alg,pad", [
    ((1100, 1300), 256, "cubic", True),
    ((1100, 1300), 512, None, False),
    ((333, 517), 300, None, True),
    ((601, 377), None, None, False),
    ((601, 377), 512, "average", True),
])
def test_band_stage_clahe(rng, shape, size, alg, pad):
    for copol, mean in ((True, 5.0), (False, 4.2)):
        dn = _dn(rng, shape, mean)
        kw = dict(copol=copol, target_size=size, pad=pad, resample_alg=alg)
        want = np.asarray(jf.synrgb_band_stage(dn, strategy=_j(CLAHE), **kw))
        got = tf.synrgb_band_stage(_t(dn), strategy=CLAHE, **kw).numpy()
        assert got.shape == want.shape and got.dtype == np.uint8
        d = np.abs(got.astype(int) - want.astype(int))
        print(f"{shape} -> {size} {alg} pad={pad} copol={copol}: max|diff| "
              f"{d.max()}, share differing {(d > 0).mean():.2e}, by more "
              f"than 1 {(d > 1).mean():.2e}")
        assert d.max() <= BAND_BOUND


def test_strategies_needing_quantize_raise():
    """The strategies that go through `_quantize` in the synRGB band stage
    run (the parity bounds are in tests/test_torch_gray.py); on a band
    whose pixels are all masked each gives the JAX program's all-zero u8."""
    dn = np.zeros((64, 64), dtype=np.uint16)
    for s in set(AutoscaleStrategy) - {CLAHE, AutoscaleStrategy.TAMED}:
        kw = dict(copol=True, target_size=None, pad=False)
        got = tf.synrgb_band_stage(_t(dn), strategy=s, **kw).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jf.synrgb_band_stage(dn, strategy=_j(s), **kw)))
        assert got.dtype == np.uint8 and not got.any()
