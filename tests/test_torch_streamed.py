"""The port's streamed full-resolution path (sarpro_tpu_torch/core/streamed)
on the CPU: against the port's fused program, bit for bit, and against the
JAX package's streamed path within the fused bounds.

Chunk sizes cut CLAHE tiles mid-tile and leave a ragged tail: 200 rows in
chunks of 48 are 4 x 48 + 8; the DCT cases are 196 rows (8-aligned chunk
boundaries, 4 rows of true bottom edge); the gray DCT case is 120 x 88,
padded, in chunks of 40.

Tolerances against the JAX package (ROADMAP queue 3 #2): the bands within 1
u8 for Tamed, 4 levels for CLAHE from DN, `_level_bound` (one 4096-bin
window step through the gamma, plus 1) for the other strategies; the synRGB
floor exact and the RGB equal wherever both bands agree; the DCT blocks
within 1 wherever the RGB agree on the whole block. Pieces fed identical
inputs are exact: a chunk's CLAHE bins and tile histograms with its
row_offset, `_stats_finalize_host` on an int64 histogram past 2^31 and
`_suppressed_floor_host`.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sarpro_tpu.core import fused as jf  # noqa: E402
from sarpro_tpu.core import streamed as js  # noqa: E402
from sarpro_tpu.ops import tile_histogram as j_tile_histogram  # noqa: E402
from sarpro_tpu import types as jtypes  # noqa: E402
from sarpro_tpu_torch.core import clahe as tclahe  # noqa: E402
from sarpro_tpu_torch.core import fused as tf  # noqa: E402
from sarpro_tpu_torch.core.numerics import pow_f32  # noqa: E402
from sarpro_tpu_torch.core import streamed as ts  # noqa: E402
from sarpro_tpu_torch.ops import tile_histogram  # noqa: E402
from sarpro_tpu_torch.types import AutoscaleStrategy, BitDepth  # noqa: E402
from test_stats import sar_like  # noqa: E402
from test_torch_gray import _level_bound  # noqa: E402

S = AutoscaleStrategy
STRATEGIES = list(AutoscaleStrategy)
SHAPE, CHUNK = (200, 176), 48


def _j(e):
    """The JAX package's member of the enum member `e` names."""
    return getattr(jtypes, type(e).__name__)(e.value)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return sar_like(rng, shape), sar_like(rng, shape)


def _equal(got, want):
    """Bit-equality of two port outputs (uint16 through its int16 view)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.uint16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# streamed == fused, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_synrgb_streamed_equals_fused(strategy, pad):
    vv, vh = map(_t, _pair(1))
    want = tf.synrgb_pipeline(vv, vh, strategy=strategy, target_size=None,
                              pad=pad)
    got = ts.synrgb_streamed(vv, vh, strategy=strategy, pad=pad,
                             chunk_rows=CHUNK)
    assert got.shape == ((200, 200, 3) if pad else (200, 176, 3))
    _equal(got, want)


@pytest.mark.parametrize("strategy,suppressed", [(S.ROBUST, True),
                                                 (S.CLAHE, False),
                                                 (S.TAMED, False)])
def test_synrgb_streamed_mode_override(strategy, suppressed):
    """The suppressed mode asked of a default-mode strategy and back."""
    vv, vh = map(_t, _pair(2, (80, 128)))  # rectangular: pad adds rows
    kw = dict(strategy=strategy, suppressed=suppressed, pad=True)
    want = tf._synrgb_combine(
        *(tf.synrgb_band_stage(d, copol=c, strategy=strategy,
                               target_size=None, pad=True)
          for d, c in ((vv, True), (vh, False))), strategy, suppressed, "rgb")
    _equal(ts.synrgb_streamed(vv, vh, chunk_rows=32, **kw), want)


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("bit_depth", list(BitDepth))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_grayscale_streamed_equals_fused(strategy, bit_depth, pad):
    x = _t(_pair(3)[0])
    kw = dict(strategy=strategy, bit_depth=bit_depth, pad=pad)
    _equal(ts.grayscale_streamed(x, chunk_rows=CHUNK, **kw),
           tf.grayscale_pipeline(x, target_size=None, **kw))


def test_pow_does_not_hang_on_how_the_band_is_cut():
    """The gamma's pow on the CPU gives an element one value wherever it
    lies: at any offset, length, 2-D view or thread count (PyTorch's own
    f32 pow runs each loop's last length-mod-32 elements through the scalar
    std::pow, an ulp off the vector pow on some inputs; the port's takes it
    in f64 and rounds once)."""
    g = torch.Generator().manual_seed(5)
    x = torch.rand(70000, generator=g)
    threads = torch.get_num_threads()
    try:
        for gamma in (torch.tensor(0.9), torch.tensor(1.1)):
            ref = pow_f32(x, gamma)
            for k in (1, 7, 16, 31, 33):
                assert torch.equal(pow_f32(x[k:].clone(), gamma), ref[k:])
            for t in (1, 3, 8):
                torch.set_num_threads(t)
                for n in (35200, 8448, 65537):
                    assert torch.equal(pow_f32(x[:n], gamma), ref[:n])
                assert torch.equal(pow_f32(x.view(175, 400)[:, 3:], gamma),
                                   ref.view(175, 400)[:, 3:])
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", [(200, 175), (201, 173)])
@pytest.mark.parametrize("strategy", [S.STANDARD, S.ADAPTIVE])
def test_gamma_strategies_streamed_equal_fused_at_odd_widths(strategy, shape):
    """Chunks whose lengths are not multiples of 32 (48 rows of 175 or
    173 pixels): the gamma windows still stream bit-equal to the fused
    program."""
    x = _t(_pair(6, shape)[0])
    kw = dict(strategy=strategy, bit_depth=BitDepth.U16)
    _equal(ts.grayscale_streamed(x, chunk_rows=CHUNK, **kw),
           tf.grayscale_pipeline(x, target_size=None, **kw))


def test_u16_dn_and_one_chunk_equal_fused():
    """u16 DN as the reader loads it, and a chunk taller than the band."""
    vv, vh = (np.clip(a, 0, 65535).astype(np.uint16) for a in _pair(4))
    vv, vh = _t(vv), _t(vh)
    want = tf.synrgb_pipeline(vv, vh, strategy=S.CLAHE, target_size=None)
    for chunk in (CHUNK, 4096):
        _equal(ts.synrgb_streamed(vv, vh, strategy=S.CLAHE, chunk_rows=chunk),
               want)
    _equal(ts.grayscale_streamed(vv, S.CLAHE, BitDepth.U16, chunk_rows=7),
           tf.grayscale_pipeline(vv, S.CLAHE, BitDepth.U16, target_size=None))


@pytest.mark.parametrize("strategy", [S.CLAHE, S.ROBUST])
def test_synrgb_dct_layout_equals_fused(strategy):
    """layout="dct" is the fused program's channel_order="dct", with 8-row
    aligned chunk boundaries and a ragged bottom (196 rows)."""
    vv, vh = map(_t, _pair(5, (196, 176)))
    want = tf.synrgb_pipeline(vv, vh, strategy=strategy, target_size=None,
                              channel_order="dct")
    for chunk in (CHUNK, 44):  # 44 -> 40-row DCT chunks
        got = ts.synrgb_streamed(vv, vh, strategy=strategy, chunk_rows=chunk,
                                 layout="dct")
        assert got.device.type == "cpu"
        _equal(got, want)
    with pytest.raises(ValueError, match="layout"):
        ts.synrgb_streamed(vv, vh, layout="bgr")


def test_grayscale_dct_padded_equals_fused():
    x = _t(_pair(6, (120, 88))[0])
    kw = dict(strategy=S.ROBUST, bit_depth=BitDepth.U8, pad=True)
    got = ts.grayscale_streamed(x, chunk_rows=40, jpeg_dct=True, **kw)
    assert got.shape == (15, 15, 8, 8)
    _equal(got, tf.grayscale_pipeline(x, target_size=None, jpeg_dct=True,
                                      **kw))
    with pytest.raises(ValueError, match="u8"):
        ts.grayscale_streamed(x, bit_depth=BitDepth.U16, jpeg_dct=True)


@pytest.mark.parametrize("strategy", [S.CLAHE, S.TAMED, S.ADAPTIVE])
def test_int64_branch_equals_fused(monkeypatch, strategy):
    """Bands above _DEVICE_ACC_MAX_PIXELS (lowered): int64 folds, the
    statistics copied back once, CLAHE applied from the DN, synRGB through
    u8 planes; the same output."""
    monkeypatch.setattr(ts, "_DEVICE_ACC_MAX_PIXELS", 1000)
    vv, vh = map(_t, _pair(7))
    want = tf.synrgb_pipeline(vv, vh, strategy=strategy, target_size=None,
                              pad=True)
    _equal(ts.synrgb_streamed(vv, vh, strategy=strategy, pad=True,
                              chunk_rows=CHUNK), want)
    for bd in BitDepth:
        _equal(ts.grayscale_streamed(vv, strategy, bd, chunk_rows=CHUNK),
               tf.grayscale_pipeline(vv, strategy, bd, target_size=None))
    u8, hist = ts.band_u8_streamed(vv, strategy, True, chunk_rows=CHUNK,
                                   collect_hist=True)
    assert hist.dtype == torch.int64
    assert torch.equal(hist, torch.bincount(u8.reshape(-1).long(),
                                            minlength=256))
    with pytest.raises(ValueError, match="emit_q16"):
        ts.band_u8_streamed(vv, strategy, emit_q16=True)


def test_int64_branch_host_finalize(monkeypatch):
    """Past int32 valid pixels the percentiles invert on the host: forced
    here by lowering the int32 limit the branch compares the count with."""
    monkeypatch.setattr(ts, "_DEVICE_ACC_MAX_PIXELS", 1000)
    x = _t(_pair(8)[0])
    want = ts.grayscale_streamed(x, S.ROBUST, chunk_rows=CHUNK)
    calls = []
    orig = ts._stats_finalize_host
    monkeypatch.setattr(ts, "_INT32_MAX", 1000)
    monkeypatch.setattr(ts, "_stats_finalize_host",
                        lambda *a: calls.append(a[1]) or orig(*a))
    got = ts.grayscale_streamed(x, S.ROBUST, chunk_rows=CHUNK)
    assert calls == [int((x > 0).sum())]  # zeros are the invalid pixels
    # the f64 inversion moves a window end by ulps at most
    assert (got.int() - want.int()).abs().max() <= 1


def test_band_q16_route_and_histogram():
    """emit_q16: the int16-held q16 buffer and its range stretch to the
    fused band, and its histogram is the band's."""
    x = _t(_pair(9)[0])
    for strategy, copol in ((S.CLAHE, None), (S.TAMED, True)):
        buf, hist, mn, mx = ts.band_u8_streamed(
            x, strategy, copol, chunk_rows=CHUNK, collect_hist=True,
            emit_q16=True)
        assert buf.dtype == torch.int16
        u8 = ts._q16_u8_vals(buf, mn, mx, 0, SHAPE[0])
        _equal(u8, tf.synrgb_band_stage(x, strategy, bool(copol), None, False))
        assert torch.equal(hist.long(), torch.bincount(u8.reshape(-1).long(),
                                                       minlength=256))


def test_mesh_raises(monkeypatch):
    """A mesh (the name is the test's from before the mesh mode was ported,
    when it raised): a 2-way split of 16 rows and a 1-device mesh give the
    unsharded passes' bytes, both entry points."""
    from sarpro_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(tmesh, "HOST_DEVICE_COUNT", 2)
    x, y = map(_t, _pair(10, (16, 16)))
    for mesh in (tmesh.make_mesh(2, shape=(1, 2), device="cpu"),
                 tmesh.make_mesh(1, shape=(1, 1), device="cpu")):
        _equal(ts.grayscale_streamed(x, chunk_rows=4, mesh=mesh),
               ts.grayscale_streamed(x, chunk_rows=4))
        _equal(ts.synrgb_streamed(x, y, chunk_rows=4, mesh=mesh),
               ts.synrgb_streamed(x, y, chunk_rows=4))


def test_chunk_plan():
    assert ts._chunk_starts(200, 48) == [(0, 48), (48, 48), (96, 48),
                                         (144, 48), (192, 8)]
    assert ts._chunk_starts(20000, 4096)[-1] == (16384, 3616)
    assert len(ts._chunk_starts(20000, 4096)) == 5
    assert ts._chunk_starts(96, 48) == js._chunk_starts(96, 48)
    assert ts._plan(200, 48) == js._plan(200, 48) == (4, 8)


# ---------------------------------------------------------------------------
# pieces fed identical inputs: exact
# ---------------------------------------------------------------------------
def test_chunk_tile_histograms_exact():
    """Each chunk's CLAHE bins and tile histograms (row_offset = its first
    row) from the JAX package's dB, equal to the JAX package's, and their
    sum the whole band's."""
    x = _pair(11)[0]
    rows, cols = SHAPE
    db, mask = (np.asarray(a) for a in jax.jit(jf._db_mask)(x))
    low, high = np.float32(12.5), np.float32(31.25)
    th, tw = -(-rows // 8), -(-cols // 8)
    total = torch.zeros(8 * 8 * 256, dtype=torch.int32)
    for r0, n in ts._chunk_starts(rows, CHUNK):
        d, m = db[r0:r0 + n], mask[r0:r0 + n]
        jb = jf._clahe_bins(jf._clahe_norm(d, m, low, high), m, n, cols, th,
                            tw, row_offset=r0)
        jh = j_tile_histogram(jb.ravel(), cols, 8, 8, th, tw, row_offset=r0,
                              n_bins=256)
        tb = tclahe._clahe_bins(tf._clahe_norm(_t(d), _t(m), _t(low),
                                               _t(high)), _t(m)).reshape(-1)
        h = tile_histogram(tb, cols, 8, 8, th, tw, row_offset=r0, n_bins=256)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb).ravel())
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        total += h
    whole = tclahe._clahe_bins(tf._clahe_norm(_t(db), _t(mask), _t(low),
                                              _t(high)), _t(mask))
    assert torch.equal(total, tile_histogram(whole.reshape(-1), cols, 8, 8,
                                             th, tw, n_bins=256))


def test_stats_finalize_host_past_int32_exact():
    rng = np.random.default_rng(12)
    hist = rng.integers(0, 1_500_000, jf.NUM_BINS).astype(np.int64)
    hist[1000:1100] += 30_000_000  # 3e9 px: past int32
    count = int(hist.sum())
    assert count > np.iinfo(np.int32).max
    got = ts._stats_finalize_host(hist, count, -41.5, 12.75)
    want = js._stats_finalize_host(hist, count, -41.5, 12.75)
    assert set(got) == set(want)
    for k, v in want.items():
        assert float(got[k]) == float(np.asarray(v)), k
    assert got["count"].dtype == torch.int32
    assert int(got["count"]) == np.iinfo(np.int32).max


def test_stats_finalize_host_mirrors_device():
    rng = np.random.default_rng(13)
    hist = rng.integers(0, 100000, tf.NUM_BINS).astype(np.int64)
    count = int(hist.sum())
    dev = tf._stats_finalize(_t(hist.astype(np.int32)),
                             torch.tensor(count, dtype=torch.int32),
                             torch.tensor(-42.0), torch.tensor(-7.5))
    host = ts._stats_finalize_host(hist, count, -42.0, -7.5)
    for k in tf._PCT_ORDER + ("mean", "std", "min", "max"):
        np.testing.assert_allclose(float(host[k]), float(dev[k]), rtol=1e-5,
                                   atol=1e-4)


def test_suppressed_floor_host_exact():
    rng = np.random.default_rng(14)
    for _ in range(20):
        hist = rng.integers(0, 10000, 256).astype(np.int64)
        hist[rng.integers(0, 60)] += rng.integers(0, 10**6)
        total = int(hist.sum())
        fc = ts._suppressed_floor_host(hist, total)
        assert fc == float(np.asarray(js._suppressed_floor_host(hist, total)))
        # the fused program's f32 floor agrees while the counts are exact
        assert fc == int(tf._suppressed_floor(_t(hist.astype(np.int32)),
                                              total))
    big = np.zeros(256, np.int64)
    big[0] = big[50] = 3_000_000_000  # past int32: no wrap
    assert ts._suppressed_floor_host(big, int(big.sum())) == 3
    big[0] = 10
    assert ts._suppressed_floor_host(big, int(big.sum())) == 40  # capped


# ---------------------------------------------------------------------------
# against the JAX package's streamed path
# ---------------------------------------------------------------------------
def _band_bound(x, strategy, bit_depth=BitDepth.U8):
    return 1 if strategy is S.TAMED else _level_bound(x, strategy, bit_depth)


@pytest.mark.parametrize("strategy,pad", [(S.CLAHE, False), (S.CLAHE, True),
                                          (S.TAMED, False),
                                          (S.ROBUST, False)])
def test_synrgb_streamed_vs_jax(strategy, pad):
    vv, vh = _pair(15)
    rows, cols = SHAPE
    jb, tb = [], []
    for d, c in ((vv, True), (vh, False)):
        copol = c if strategy is S.TAMED else None
        jb.append(np.asarray(js.band_u8_streamed(d, _j(strategy), copol,
                                                 chunk_rows=CHUNK)))
        tb.append(ts.band_u8_streamed(_t(d), strategy, copol,
                                      chunk_rows=CHUNK).numpy())
    for j, t, d in zip(jb, tb, (vv, vh)):
        diff = np.abs(j.astype(int) - t.astype(int))
        print(f"{strategy.value}: band max|diff| {diff.max()}, share "
              f"differing {(diff > 0).mean():.2e}")
        assert diff.max() <= _band_bound(d, strategy)
    suppressed = strategy in (S.TAMED, S.CLAHE)
    if pad:
        jb = [np.asarray(jf._pad_square(b, rows, cols)) for b in jb]
        tb = [tf._pad_square(_t(b), rows, cols).numpy() for b in tb]
    if suppressed:
        fl = [ts._suppressed_floor_host(np.bincount(
            np.concatenate([b[0].ravel(), b[1].ravel()]), minlength=256),
            2 * b[0].size) for b in (jb, tb)]
        assert fl[0] == fl[1] < 40  # the JAX in-graph tables differ at 40
    kw = dict(pad=pad, chunk_rows=CHUNK)
    j_rgb = np.asarray(js.synrgb_streamed(vv, vh, strategy=_j(strategy), **kw))
    t_rgb = ts.synrgb_streamed(_t(vv), _t(vh), strategy=strategy, **kw)
    both = (jb[0] == tb[0]) & (jb[1] == tb[1])
    np.testing.assert_array_equal(t_rgb.numpy()[both], j_rgb[both])


@pytest.mark.parametrize("bit_depth", list(BitDepth))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_grayscale_streamed_vs_jax(strategy, bit_depth):
    x = _pair(16)[0]
    want = np.asarray(js.grayscale_streamed(x, _j(strategy), _j(bit_depth),
                                            chunk_rows=CHUNK))
    got = ts.grayscale_streamed(_t(x), strategy, bit_depth,
                                chunk_rows=CHUNK).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    bound = _level_bound(x, strategy, bit_depth)
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    print(f"{strategy.value} {bit_depth.value}: max|diff| {d.max()} (bound "
          f"{bound}), share differing {(d > 0).mean():.2e}")
    assert d.max() <= bound


def test_dct_blocks_vs_jax():
    """The chunked JPEG front end against the JAX package's on the two
    packages' streamed CLAHE synRGB: within 1 wherever the RGB agree on
    the whole block."""
    vv, vh = _pair(17, (196, 176))
    kw = dict(chunk_rows=CHUNK)
    j = [np.asarray(js.synrgb_streamed(vv, vh, strategy=_j(S.CLAHE),
                                       layout=lay, **kw))
         for lay in ("rgb", "dct")]
    t = [ts.synrgb_streamed(_t(vv), _t(vh), strategy=S.CLAHE, layout=lay,
                            **kw).numpy() for lay in ("rgb", "dct")]
    assert t[1].shape == j[1].shape == (3, 25, 22, 8, 8)
    same = np.all(t[0] == j[0], axis=-1)
    same = np.pad(same, ((0, 4), (0, 0)), mode="edge")
    agree = same.reshape(25, 8, 22, 8).all(axis=(1, 3))
    assert agree.mean() > 0.2
    assert np.abs(t[1].astype(int) - j[1].astype(int))[:, agree].max() <= 1
