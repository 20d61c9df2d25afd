"""The port's polarization operations against the JAX package's, on the CPU.

Element-wise f32 arithmetic with the same guards: bit-equal, including
zero, tiny and negative denominators and the log-ratio == ratio quirk."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sarpro_tpu.core import ops as jops  # noqa: E402
from sarpro_tpu_torch.core import ops as tops  # noqa: E402


def _operands(rng, n=20_000):
    """SAR-like intensities plus the guard's edge cases: exact zeros, values
    at and around +-1e-10, negative values (a difference of bands), and
    pairs whose sum cancels."""
    a = rng.lognormal(5.0, 1.1, n).astype(np.float32)
    b = rng.lognormal(4.2, 1.1, n).astype(np.float32)
    edge = np.array([0.0, 1e-10, -1e-10, 1.0000001e-10, 9.999999e-11, -3.0,
                     -1e-12, 2.5, np.float32(1e-10) * 2], np.float32)
    b[:edge.size] = edge
    a[edge.size:2 * edge.size] = -b[edge.size:2 * edge.size]  # a + b == 0
    a[2 * edge.size:3 * edge.size] = -b[2 * edge.size:3 * edge.size] + 1e-11
    neg = rng.random(n) < 0.1
    b[neg] = -b[neg]
    return a, b


def test_constants_and_keys_equal_jax_package():
    assert tops.ZERO_GUARD == jops.ZERO_GUARD
    assert list(tops.OPERATIONS) == list(jops.OPERATIONS)


@pytest.mark.parametrize("name", list(jops.OPERATIONS))
def test_operation_bit_equal(rng, name):
    a, b = _operands(rng)
    want = np.asarray(jops.OPERATIONS[name](a, b))
    got = tops.OPERATIONS[name](torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("name", list(jops.OPERATIONS))
def test_operation_on_u16_dn_bit_equal(rng, name):
    """Full-resolution bands reach the operation as u16 DN (the JAX reader
    hands it f32): the cast happens inside, with the same values."""
    a = rng.integers(0, 3000, (60, 70)).astype(np.uint16)
    b = rng.integers(0, 3000, (60, 70)).astype(np.uint16)
    b[:5] = 0
    want = np.asarray(jops.OPERATIONS[name](a.astype(np.float32),
                                            b.astype(np.float32)))
    got = tops.OPERATIONS[name](torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_log_ratio_is_ratio(rng):
    a, b = _operands(rng, 1000)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(tops.log_ratio_arrays(ta, tb), tops.ratio_arrays(ta, tb))
