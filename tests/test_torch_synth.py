"""The port's decoder synthesis (``zigflac_tpu_torch/ops/synth.py``) on the
CPU against the JAX package: ``synthesize_batch`` (there the plain version
of the CUDA kernel) against the JAX scan and against the scalar
``decoder._synthesize``, and ``recombine_stereo`` against the JAX function.
Inputs are made with numpy from a seed and handed to both sides.

Tolerance: exact equality (int64, wrap included)."""

import numpy as np
import pytest
import torch

from zigflac_tpu.decoder import FIXED_COEFFS, _synthesize
from zigflac_tpu.ops import synth as jax_synth
from zigflac_tpu_torch.ops import synth


def _subframes(rng, m, b, bits=33, qbits=15, max_order=32, stable=False):
    """Random normalized subframes: orders 0..max_order with coefficients
    zero beyond the order, shifts 0-15, wasted 0-3. ``stable`` keeps the sum
    of |q| under 2^shift / 2, so the recurrence cannot diverge."""
    order = rng.integers(0, max_order + 1, m)
    shift = rng.integers(0, 16, m)
    q = rng.integers(-(1 << (qbits - 1)), 1 << (qbits - 1), (m, 32))
    if stable:
        order = np.minimum(order, b)
        q = rng.integers(-3, 4, (m, 32)) * ((1 << shift) // 256)[:, None]
    q[np.arange(32)[None, :] >= order[:, None]] = 0
    values = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (m, b))
    return values, q, shift, order, rng.integers(0, 4, m)


def _port(args):
    synth.reset_counts()
    got = synth.synthesize_batch(*[torch.from_numpy(a) for a in args])
    assert (synth.KERNEL_LAUNCHES, synth.PLAIN_CALLS) == (0, 1)
    assert got.dtype == torch.int64
    return got.numpy()


@pytest.mark.parametrize("b", [1, 5, 256, 4096])
@pytest.mark.parametrize("m", [1, 7, 37])
def test_synthesize_equals_jax_scan(m, b):
    """Full-scale 33-bit values, orders 0-32 (orders above the block
    included), M not a power of two: diverging rows wrap on both sides."""
    args = _subframes(np.random.default_rng(1000 * m + b), m, b)
    np.testing.assert_array_equal(_port(args), np.asarray(jax_synth.synthesize_batch(*args)))


@pytest.mark.parametrize("b", [5, 256, 4096])
def test_synthesize_equals_scalar_decoder(b):
    """Against the scalar host synthesis, subframe by subframe, on stable
    predictors (the scalar loop raises once a sample passes 2^40) and on
    the fixed predictors' binomial coefficients."""
    rng = np.random.default_rng(b)
    values, q, shift, order, wasted = _subframes(rng, 11, b, stable=True)
    signal = rng.integers(-(1 << 15), 1 << 15, (5, b))
    for i in range(5):  # rows 0-4: the fixed predictors of order 0-4 on a 16-bit signal
        order[i], shift[i], wasted[i] = min(i, b), 0, 0
        q[i] = 0
        q[i, : order[i]] = FIXED_COEFFS[order[i]]
        values[i] = signal[i]
        values[i, order[i]:] = np.diff(signal[i], n=order[i])  # its order-th difference
    got = _port((values, q, shift, order, wasted))
    np.testing.assert_array_equal(got[:5], signal)
    for i in range(values.shape[0]):
        o = int(order[i])
        want = _synthesize(values[i, :o], values[i, o:], [int(c) for c in q[i, :o]],
                           int(shift[i])) << int(wasted[i])
        np.testing.assert_array_equal(got[i], want, err_msg=f"row {i} order {o}")


def test_synthesize_wraps_as_xla_does():
    """62-bit values and coefficients: every sum passes 2^63."""
    args = _subframes(np.random.default_rng(63), 9, 300, bits=62, qbits=62)
    want = np.asarray(jax_synth.synthesize_batch(*args))
    assert np.abs(want).max() > 1 << 62
    np.testing.assert_array_equal(_port(args), want)


def test_small_integer_vectors_are_taken():
    """shift, order and wasted as int32 columns of one [M, 3] array, as the
    decoder hands them over."""
    values, q, shift, order, wasted = _subframes(np.random.default_rng(3), 6, 64)
    sow = torch.from_numpy(np.stack([shift, order, wasted], 1).astype(np.int32))
    got = synth.synthesize_batch(torch.from_numpy(values), torch.from_numpy(q),
                                 sow[:, 0], sow[:, 1], sow[:, 2])
    want = np.asarray(jax_synth.synthesize_batch(values, q, shift, order, wasted))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("what,err", [("values int32", TypeError), ("qcoeffs width", ValueError),
                                      ("shift 64", ValueError), ("wasted -1", ValueError),
                                      ("order shape", ValueError), ("shift float", TypeError)])
def test_wrapper_refuses(what, err):
    v, q, sh, o, w = [torch.from_numpy(a) for a in _subframes(np.random.default_rng(4), 4, 16)]
    args = {
        "values int32": (v.to(torch.int32), q, sh, o, w),
        "qcoeffs width": (v, q[:, :8], sh, o, w),
        "shift 64": (v, q, sh + 64, o, w),
        "wasted -1": (v, q, sh, o, w - 4),
        "order shape": (v, q, sh, o[:2], w),
        "shift float": (v, q, sh.to(torch.float32), o, w),
    }[what]
    with pytest.raises(err):
        synth.synthesize_batch(*args)


@pytest.mark.parametrize("code", [0, 1, 8, 9, 10])
def test_recombine_equals_jax(code):
    """One channel code over the whole batch: independent (0, 1), left-side,
    side-right and mid-side, 33-bit sides both odd and even."""
    rng = np.random.default_rng(code)
    wire = rng.integers(-(1 << 32), 1 << 32, (6, 2, 50))
    wire[0, 1] |= 1   # an odd side plane
    wire[1, 1] &= ~1  # an even one
    ch = np.full(6, code, np.int32)
    got = synth.recombine_stereo(torch.from_numpy(wire), torch.from_numpy(ch)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_synth.recombine_stereo(wire, ch)))
    if code < 8:
        np.testing.assert_array_equal(got, wire)


def test_recombine_mixed_codes_equal_jax():
    rng = np.random.default_rng(99)
    wire = rng.integers(-(1 << 32), 1 << 32, (40, 2, 33))
    ch = rng.choice([1, 8, 9, 10], 40).astype(np.int32)
    got = synth.recombine_stereo(torch.from_numpy(wire), torch.from_numpy(ch)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_synth.recombine_stereo(wire, ch)))
    # and the inverse of the encoder's decorrelation: mid = (l + r) >> 1, side = l - r
    left, right = wire[:, 0] >> 1, wire[:, 1] >> 1
    ms = np.stack([(left + right) >> 1, left - right], 1)
    back = synth.recombine_stereo(torch.from_numpy(ms),
                                  torch.full((40,), 10, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(back, np.stack([left, right], 1))
