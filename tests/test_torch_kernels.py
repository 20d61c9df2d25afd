"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package: its XLA fallbacks, and its Pallas kernel bodies run
in interpret mode. The Hopper kernels themselves are checked against these
plain versions on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sarpro_tpu.core import resize as jresize  # noqa: E402
from sarpro_tpu.core import synthetic_rgb as jsyn  # noqa: E402
from sarpro_tpu.ops import kernels as JK  # noqa: E402
from sarpro_tpu.ops import resample_kernel as JRK  # noqa: E402
from sarpro_tpu_torch import ops  # noqa: E402
from sarpro_tpu_torch.core import synthetic_rgb as tsyn  # noqa: E402
from sarpro_tpu_torch.ops import _cuda  # noqa: E402
from sarpro_tpu_torch.ops.kernels import MAX_HIST_BINS  # noqa: E402

# f32 sum order differs (the JAX package's own bound,
# tests/test_pallas_interpret.py:204)
RESAMPLE_TOL = dict(rtol=2e-6, atol=2e-2)


@pytest.mark.parametrize("num_bins", [4096, 256])
def test_histogram_matches_xla_and_pallas(rng, num_bins):
    n = 70_000
    bins = rng.integers(0, num_bins, n).astype(np.int32)
    idx = np.where(rng.random(n) < 0.9, bins, num_bins).astype(np.int32)
    idx[:5] = num_bins + 7  # past the overflow index: dropped as well
    got = ops.histogram(torch.from_numpy(idx), num_bins).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.asarray(JK._histogram_xla(jnp.asarray(idx), num_bins)))
    with JK.pallas_interpret():
        want = np.asarray(JK.histogram(jnp.asarray(idx), num_bins))
    np.testing.assert_array_equal(got, want)


def test_histogram_two_u8_bands_equal_concatenated(rng):
    b1 = rng.integers(0, 256, (37, 41)).astype(np.uint8)
    b2 = rng.integers(0, 256, (37, 41)).astype(np.uint8)
    got = ops.histogram((torch.from_numpy(b1).reshape(-1),
                         torch.from_numpy(b2).reshape(-1)), 256).numpy()
    both = np.concatenate([b1.ravel(), b2.ravel()]).astype(np.int32)
    np.testing.assert_array_equal(
        got, np.asarray(JK._histogram_xla(jnp.asarray(both), 256)))


# lengths of every residue mod 16, short and past many 16-byte vectors: the
# head, body and tail split of the card's kernel (chip_smoke.EDGE_LENGTHS)
EDGE_LENGTHS = [0, 1, 2, 3, 15, 16, 17, 31, 33, 67] + [
    1000 + r for r in range(16)]


def _xla_counts(values, num_bins):
    """The JAX fallback's counts. It wraps a negative index Python-style
    (the JAX package never passes one); the port drops it, as it does
    every value outside [0, num_bins)."""
    v = np.asarray(values).astype(np.int64)
    v = np.where(v < 0, num_bins, v)
    return np.asarray(JK._histogram_xla(jnp.asarray(v.astype(np.int32)),
                                        num_bins))


@pytest.mark.parametrize("off", [0, 1, 3])
@pytest.mark.parametrize("n", EDGE_LENGTHS)
def test_histogram_int32_views_match_xla(rng, n, off):
    """int32 views from 0..3 elements past the buffer's start, with negative,
    masked and past-the-end values among the bins."""
    buf = rng.integers(-300, 4400, n + 3).astype(np.int32)
    buf[::7] = 4096
    view = torch.from_numpy(buf)[off:off + n]
    got = ops.histogram(view, 4096).numpy()
    np.testing.assert_array_equal(got, _xla_counts(buf[off:off + n], 4096))


@pytest.mark.parametrize("off", [0, 1, 7, 15])
@pytest.mark.parametrize("n", EDGE_LENGTHS)
def test_histogram_u8_views_match_xla(rng, n, off):
    """u8 views 0..15 bytes past the buffer's start, counted into 100 bins
    (so values past num_bins occur)."""
    buf = rng.integers(0, 256, n + 15).astype(np.uint8)
    view = torch.from_numpy(buf)[off:off + n]
    got = ops.histogram(view, 100).numpy()
    np.testing.assert_array_equal(got, _xla_counts(buf[off:off + n], 100))


@pytest.mark.parametrize("kind", ["one bin", "all masked", "max bins",
                                  "1 bin"])
def test_histogram_special_streams_match_xla(rng, kind):
    n = 70_001
    if kind == "one bin":
        idx, num_bins = np.full(n, 1234, np.int32), 4096
    elif kind == "all masked":
        idx, num_bins = np.full(n, 4096, np.int32), 4096
    else:
        num_bins = MAX_HIST_BINS if kind == "max bins" else 1
        idx = rng.integers(-5, num_bins + 5, n).astype(np.int32)
    got = ops.histogram(torch.from_numpy(idx)[1:], num_bins).numpy()
    np.testing.assert_array_equal(got, _xla_counts(idx[1:], num_bins))


@pytest.mark.parametrize("n1, o1, n2, o2", [
    (0, 0, 33, 1), (1, 3, 0, 0), (17, 15, 1000, 9), (1003, 1, 67, 0),
    (100_003, 5, 100_019, 12)])
def test_histogram_two_u8_streams_equal_concatenated(rng, n1, o1, n2, o2):
    """Two u8 streams of unequal length and alignment count as their
    concatenation does."""
    buf = rng.integers(0, 256, n1 + n2 + 40).astype(np.uint8)
    t = torch.from_numpy(buf)
    a, b = t[o1:o1 + n1], t[n1 + 20 + o2:n1 + 20 + o2 + n2]
    got = ops.histogram((a, b), 256).numpy()
    both = np.concatenate([a.numpy(), b.numpy()])
    np.testing.assert_array_equal(got, _xla_counts(both, 256))


def test_histogram_rejects_bad_input():
    with pytest.raises(TypeError):
        ops.histogram(torch.zeros(4, dtype=torch.float32), 16)
    with pytest.raises(TypeError):
        ops.histogram((torch.zeros(4, dtype=torch.int32),
                       torch.zeros(4, dtype=torch.uint8)), 16)
    with pytest.raises(ValueError):
        ops.histogram(torch.zeros(4, dtype=torch.int32), 1 << 20)


def _all_pairs():
    a = np.arange(256, dtype=np.uint8)
    return np.repeat(a, 256), np.tile(a, 256)


def test_synrgb_lookup_every_pair_every_floor():
    p1, p2 = _all_pairs()
    t1, t2 = torch.from_numpy(p1), torch.from_numpy(p2)
    sets = tsyn.suppressed_table_sets(torch.device("cpu"))
    for f in range(3, 41):
        si = torch.tensor(f - 3, dtype=torch.int32)
        got = ops.synrgb_lookup(t1, t2, sets, set_index=si).numpy()
        lr, lg, lb = jsyn.suppressed_luts(f)
        want = np.asarray(JK._synrgb_lookup_xla(
            jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(lr),
            jnp.asarray(lg), jnp.asarray(lb)))
        np.testing.assert_array_equal(got, want, err_msg=f"floor {f}")


@pytest.mark.parametrize("floor", [3, 11, 40])
def test_synrgb_lookup_matches_formula_kernel_interpret(floor):
    """The TPU route (formula + correction list, Pallas interpret mode) and
    the port's table lookup give the same bytes, water mask included."""
    p1, p2 = _all_pairs()
    with JK.pallas_interpret():
        rgb = np.asarray(JK.synrgb_lookup_formula(
            jnp.asarray(p1), jnp.asarray(p2),
            *jsyn.suppressed_formula_tables(floor), guard_b2=False))
    want = np.asarray(jsyn._water_mask(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(rgb), floor))
    fl = torch.tensor(floor, dtype=torch.int32)
    got = ops.synrgb_lookup(
        torch.from_numpy(p1), torch.from_numpy(p2),
        tsyn.suppressed_table_sets(torch.device("cpu")),
        set_index=fl - 3, water_floor=fl).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["suppressed + water", "suppressed",
                                  "default"])
@pytest.mark.parametrize("o1, o2", [(0, 0), (1, 1), (5, 12), (15, 0)])
@pytest.mark.parametrize("n", EDGE_LENGTHS)
def test_synrgb_lookup_views_match_xla(rng, n, o1, o2, mode):
    """Ragged lengths and band views 0..15 bytes past the buffer's start,
    with values 0..63 (a ninth of the pixels at or below the floor 20 on
    both bands) against the JAX lookup and water mask."""
    floor = 20
    buf = rng.integers(0, 64, (2, n + 15)).astype(np.uint8)
    b1, b2 = buf[0, o1:o1 + n], buf[1, o2:o2 + n]
    if mode == "default":
        sets = tsyn.default_table_set(torch.device("cpu"))
        luts, kw = jsyn.default_luts(), {}
    else:
        sets = tsyn.suppressed_table_sets(torch.device("cpu"))
        luts = jsyn.suppressed_luts(floor)
        fl = torch.tensor(floor, dtype=torch.int32)
        kw = dict(set_index=fl - 3,
                  water_floor=fl if mode == "suppressed + water" else None)
    got = ops.synrgb_lookup(torch.from_numpy(buf[0])[o1:o1 + n],
                            torch.from_numpy(buf[1])[o2:o2 + n], sets,
                            **kw).numpy()
    want = JK._synrgb_lookup_xla(jnp.asarray(b1), jnp.asarray(b2),
                                 *map(jnp.asarray, luts))
    if mode == "suppressed + water":
        want = jsyn._water_mask(jnp.asarray(b1), jnp.asarray(b2), want, floor)
    assert got.shape == (n, 3)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_synrgb_lookup_rejects_bad_input():
    b = torch.zeros(8, dtype=torch.uint8)
    sets = tsyn.suppressed_table_sets(torch.device("cpu"))
    with pytest.raises(TypeError):
        ops.synrgb_lookup(b.to(torch.int32), b, sets)
    with pytest.raises(ValueError):
        ops.synrgb_lookup(b, b, sets[:, :256])
    with pytest.raises(TypeError):
        ops.synrgb_lookup(b, b, sets, set_index=torch.tensor(0))


def _resample_input(rng, dtype, shape):
    if dtype == "u16":
        return rng.integers(0, 65535, shape).astype(np.uint16)
    return (rng.lognormal(5.0, 1.1, shape)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["u16", "f32"])
@pytest.mark.parametrize("filt", ["cubic", "average", "lanczos", "bilinear"])
def test_resample_matches_tap_loop_and_banded_kernel(rng, dtype, filt):
    in_size, out_size, cols = 512, 120, 256
    x = _resample_input(rng, dtype, (in_size, cols))
    got = ops.band_resample_axis0(torch.from_numpy(x), in_size, out_size,
                                  filt).numpy()
    s, w = jresize._build_coeffs(in_size, out_size, filt)
    want = np.asarray(jresize._resample_axis0(jnp.asarray(x), jnp.asarray(s),
                                              jnp.asarray(w)))
    assert got.shape == want.shape == (out_size, cols)
    np.testing.assert_allclose(got, want, **RESAMPLE_TOL)
    with JK.pallas_interpret():
        kern = JRK.band_resample_axis0(jnp.asarray(x), in_size, out_size,
                                       filt)
    assert kern is not None
    np.testing.assert_allclose(got, np.asarray(kern), **RESAMPLE_TOL)


def test_resample_any_shape_and_upsample(rng):
    """Shapes the TPU kernel declines (ragged columns, few rows, upsampling)
    go through the same wrapper."""
    x = _resample_input(rng, "f32", (37, 5))
    for out_size in (9, 80):
        got = ops.band_resample_axis0(torch.from_numpy(x), 37, out_size,
                                      "lanczos").numpy()
        s, w = jresize._build_coeffs(37, out_size, "lanczos")
        want = np.asarray(jresize._resample_axis0(
            jnp.asarray(x), jnp.asarray(s), jnp.asarray(w)))
        np.testing.assert_allclose(got, want, **RESAMPLE_TOL)


def test_cpu_tensors_take_plain_path_without_launches(rng):
    ops.reset_launch_counts()
    idx = torch.from_numpy(rng.integers(0, 300, 1000).astype(np.int32))
    ops.histogram(idx, 256)
    x = torch.from_numpy(rng.integers(0, 999, (40, 8)).astype(np.uint16))
    ops.band_resample_axis0(x, 40, 10, "cubic")
    ops.tile_histogram(idx, 40, 8, 8, 4, 5)
    ops.clahe_lookup(idx, torch.zeros((64, 256)), 40, 8, 8, 4, 5)
    g = torch.zeros((2, 2))
    ops.warp_sample(x.to(torch.float32), g, g, 5, 5, "cubic")
    assert ops.launch_counts() == {
        "histogram": 0, "resample_axis0": 0, "synrgb_lookup": 0,
        "tile_histogram": 0, "clahe_lookup": 0, "warp_sample": 0}


def test_force_plain_nests_and_restores():
    assert not _cuda.plain_forced()
    with ops.force_plain():
        with ops.force_plain():
            assert _cuda.plain_forced()
        assert _cuda.plain_forced()
    assert not _cuda.plain_forced()


def test_force_plain_holds_for_its_own_thread_only():
    """force_plain() on one thread leaves another thread's wrappers (a GUI
    job's) on their kernels."""
    import threading

    seen = {}
    with ops.force_plain():
        t = threading.Thread(
            target=lambda: seen.update(other=_cuda.plain_forced()))
        t.start()
        t.join(10)
        seen["own"] = _cuda.plain_forced()
    assert not t.is_alive()
    assert seen == {"other": False, "own": True}
