"""The port's fused-program pieces against the JAX package's, on the CPU.

Pieces fed identical inputs are held exactly (percentiles to one f32 ulp,
histogram-derived moments to f32 sum-order noise). f32 log differs by an
ulp between XLA and PyTorch on some values, so `_db_mask` is held to 1e-5 dB
and a whole band stage to +-1 on the u8 output."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sarpro_tpu.core import fused as jf  # noqa: E402
from sarpro_tpu.core import numerics as jnum  # noqa: E402
from sarpro_tpu.types import AutoscaleStrategy as JStrategy  # noqa: E402
from sarpro_tpu_torch.core import fused as tf  # noqa: E402
from sarpro_tpu_torch.core import numerics as tnum  # noqa: E402
from sarpro_tpu_torch.types import AutoscaleStrategy  # noqa: E402

# each package takes its own enums
TAMED, J_TAMED = AutoscaleStrategy.TAMED, JStrategy.TAMED


def _t(a):
    return torch.from_numpy(np.array(a))


def _dn(rng, shape, mean=5.0):
    dn = np.clip(rng.lognormal(mean, 1.1, shape), 0, 65535).astype(np.uint16)
    dn[rng.random(shape) < 0.02] = 0
    return dn


def _db(rng, n=50_000):
    """dB values as the band stage sees them, with masked pixels."""
    x = rng.lognormal(5.0, 1.1, n).astype(np.float32)
    x[rng.random(n) < 0.03] = 0.0
    db, mask = jax.jit(jf._db_mask)(jnp.asarray(x))
    return x, np.asarray(db), np.asarray(mask)


def test_round_half_up_nonneg(rng):
    x = np.concatenate([rng.random(1000).astype(np.float32) * 300,
                        np.arange(0, 20, 0.5, dtype=np.float32)])
    np.testing.assert_array_equal(
        tnum.round_half_up_nonneg(_t(x)).numpy(),
        np.asarray(jnum.round_half_up_nonneg(jnp.asarray(x))))


def test_db_mask_within_log_ulp(rng):
    x, db_j, mask_j = _db(rng)
    db_t, mask_t = tf._db_mask(_t(x))
    assert np.abs(db_t.numpy() - db_j).max() <= 1e-5
    np.testing.assert_array_equal(mask_t.numpy(), mask_j)


def _scalar_stats(db, mask):
    mn = np.float32(db[mask].min())
    mx = np.float32(db[mask].max())
    return mn, mx


def test_db_bin_index_exact(rng):
    _, db, mask = _db(rng)
    mn, mx = _scalar_stats(db, mask)
    want = np.asarray(jax.jit(jf._db_bin_index)(db, mask, mn, mx))
    got = tf._db_bin_index(_t(db), _t(mask), _t(mn), _t(mx)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["sar", "degenerate", "empty"])
def test_stats_finalize(rng, case):
    _, db, mask = _db(rng)
    if case == "degenerate":
        db = np.full_like(db, -12.5)
    if case == "empty":
        mask = np.zeros_like(mask)
    count = np.int32(mask.sum())
    mn, mx = _scalar_stats(db, mask) if count else (np.float32(0),) * 2
    idx = np.asarray(jax.jit(jf._db_bin_index)(db, mask, mn, mx))
    hist = np.bincount(idx, minlength=4097)[:4096].astype(np.int32)
    want = jax.jit(jf._stats_finalize)(hist, count, mn, mx)
    got = tf._stats_finalize(_t(hist), _t(count), _t(mn), _t(mx))
    for k in jf._PCT_ORDER:
        np.testing.assert_array_max_ulp(got[k].numpy(), np.asarray(want[k]),
                                        maxulp=1)
    for k in ("count", "min", "max"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("mean", "std"):  # bin-centre sums, reduced in another order
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


def test_tamed_quantize_exact(rng):
    _, db, mask = _db(rng)
    low, high = np.float32(-3.5), np.float32(31.25)
    want = np.asarray(jax.jit(jf._tamed_quantize_u8)(db, mask, low, high))
    got = tf._tamed_quantize_u8(_t(db), _t(mask), _t(low), _t(high)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dark", [0.0, 0.3, 1.0])
def test_suppressed_floor_exact(rng, dark):
    hist = rng.integers(0, 500, 256).astype(np.int32)
    hist[:20] = (hist[:20] * dark).astype(np.int32)  # floor moves with it
    total = int(hist.sum()) + 17
    want = float(jax.jit(jf._suppressed_floor, static_argnums=1)(hist, total))
    got = tf._suppressed_floor(_t(hist), total)
    assert got.dtype == torch.int32 and int(got) == want


@pytest.mark.parametrize("shape", [(30, 50), (50, 30), (40, 40)])
def test_pad_square_exact(rng, shape):
    x = rng.integers(0, 256, shape).astype(np.uint8)
    x3 = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    for a in (x, x3):
        np.testing.assert_array_equal(
            tf._pad_square(_t(a), *shape).numpy(),
            np.asarray(jf._pad_square(jnp.asarray(a), *shape)))


def test_plan_read_dims_equal():
    for dims in [(20000, 20000), (1200, 1600), (16000, 25000), (9, 7)]:
        for size in (None, 256, 512, 2048, 30000):
            for alg in (None, "cubic"):
                assert tf._plan_read_dims(*dims, size, alg) == \
                    jf._plan_read_dims(*dims, size, alg)


def test_ycbcr_planes_exact(rng):
    rgb = rng.integers(0, 256, (64, 80, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        tf.ycbcr_planes(_t(rgb)).numpy(),
        np.asarray(jax.jit(jf.ycbcr_planes)(rgb)))


@pytest.mark.parametrize("shape", [(40, 48), (37, 42)])
def test_jpeg_dct_planes_within_one(rng, shape):
    """f32 matmul vs the JAX program's 3-term bf16 split: +-1 per
    coefficient (the contract of tests/test_native.py:276)."""
    planes = rng.integers(0, 256, (3,) + shape).astype(np.uint8)
    want = np.asarray(jax.jit(jf.jpeg_dct_planes)(planes))
    got = tf.jpeg_dct_planes(_t(planes)).numpy()
    assert got.shape == want.shape and got.dtype == np.int16
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("alg,size,pad", [
    ("cubic", 256, True), ("average", 256, False),
    ("cubic", 512, False), ("average", 512, True),
])
def test_band_stage_within_one(rng, alg, size, pad):
    for copol, mean in ((True, 5.0), (False, 4.2)):
        dn = _dn(rng, (1100, 1300), mean)
        want = np.asarray(jf.synrgb_band_stage(
            dn, strategy=J_TAMED, copol=copol, target_size=size, pad=pad,
            resample_alg=alg))
        got = tf.synrgb_band_stage(
            _t(dn), strategy=TAMED, copol=copol, target_size=size, pad=pad,
            resample_alg=alg).numpy()
        assert got.shape == want.shape and got.dtype == np.uint8
        d = np.abs(got.astype(int) - want.astype(int))
        print(f"{alg} {size} pad={pad} copol={copol}: "
              f"share differing {(d > 0).mean():.2e}")
        assert d.max() <= 1


def test_combine_stage_on_identical_bands(rng):
    dn1, dn2 = _dn(rng, (600, 700)), _dn(rng, (600, 700), 4.2)
    kw = dict(strategy=J_TAMED, target_size=160, pad=True,
              resample_alg="cubic")
    b1 = np.asarray(jf.synrgb_band_stage(dn1, copol=True, **kw))
    b2 = np.asarray(jf.synrgb_band_stage(dn2, copol=False, **kw))
    for order in ("rgb", "ycbcr", "dct"):
        want = np.asarray(jf.synrgb_combine_stage(
            b1, b2, strategy=J_TAMED, suppressed=None, channel_order=order))
        got = tf.synrgb_combine_stage(
            _t(b1), _t(b2), strategy=TAMED, suppressed=None,
            channel_order=order).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        if order == "dct":
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(got, want)


def test_unported_routes_raise():
    """What the fused programs refuse: a channel order other than rgb, bgr,
    ycbcr and dct, and the JPEG front end on a u16 band."""
    from sarpro_tpu_torch.types import BitDepth

    b = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="channel order"):
        tf.synrgb_combine_stage(b, b, TAMED, None, channel_order="rgba")
    dn = torch.zeros((64, 64), dtype=torch.uint16)
    with pytest.raises(ValueError, match="u8"):
        tf.grayscale_pipeline(dn, bit_depth=BitDepth.U16, jpeg_dct=True)
