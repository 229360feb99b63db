"""The port's LPC functions (zigflac_tpu_torch/ops/lpc.py) against the JAX
package's (zigflac_tpu/ops/lpc.py): the Q8 window, the exact lag sums at
every tier's extremes, the Q28 Levinson, the candidate choice and the
residual, on the same numpy inputs made from a seed.

Tolerance: exact equality. Every value is an integer (the window bytes
included)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigflac_tpu.ops import lpc as jlpc
from zigflac_tpu_torch.ops import lpc as tlpc


@pytest.mark.parametrize("B", [1, 16, 4095, 4096])
def test_tukey_qw_bytes(B):
    want = jlpc.tukey_qw(B)
    assert tlpc.tukey_qw(B).tobytes() == want.tobytes()
    assert tlpc._window(B, torch.device("cpu")).numpy().tobytes() == want.tobytes()


def _extreme_planes(rng, depth, B):
    """Full-scale rows of a depth-bit plane and of its side plane (one bit
    more): constant at the negative limit, alternating between the limits,
    and uniform noise."""
    rows = []
    for lim in (1 << (depth - 1), 1 << depth):
        rows.append(np.full(B, -lim))
        rows.append(np.where(np.arange(B) % 2 == 0, -lim, lim - 1))
        rows.append(rng.integers(-lim, lim, B))
    return np.stack(rows).astype(np.int64)


@pytest.mark.parametrize("B", [16, 256, 1024, 4096])
@pytest.mark.parametrize("depth", [8, 12, 16, 20, 24, 32])
def test_lag_sums_at_tier_extremes(rng, depth, B):
    """The port's one limb form equals the JAX package's numpy mirror and
    its jnp form at the tier the depth selects (depth 32: 33-bit side
    rows), and the general limb tier."""
    planes = _extreme_planes(rng, depth, B)
    got = tlpc.lag_sums(torch.from_numpy(planes), 8).numpy()
    np.testing.assert_array_equal(got, jlpc.lag_sums_np(planes, 8, depth))
    np.testing.assert_array_equal(got, jlpc.lag_sums_np(planes, 8, None))
    np.testing.assert_array_equal(got, np.asarray(jlpc.lag_sums(jnp.asarray(planes), 8, depth)))


def _exact_lag_sums(planes, order):
    """The windowed lag sums in Python integers, as the limb triple."""
    B = planes.shape[-1]
    x = (planes * jlpc.tukey_qw(B)).astype(object)
    m24 = (1 << 24) - 1
    out = np.zeros(planes.shape[:-1] + (order + 1, 3), np.int64)
    for r in range(planes.shape[0]):
        for k in range(order + 1):
            v = int(np.dot(x[r, k:], x[r, : B - k]))
            out[r, k] = (v >> 48, (v >> 24) & m24, v & m24)
    return out


@pytest.mark.parametrize("B", [32769, 65535])
@pytest.mark.parametrize("depth", [12, 16, 20, 24, 32])
def test_lag_sums_large_blocks(rng, depth, B):
    """Blocks over 2^15 samples, up to the format's largest, with quiet rows
    at a negative DC (every windowed sample a small negative number) beside
    the full-scale ones. The port equals Python-integer sums at every depth,
    and the JAX package's at the tier its depth selects where that tier is
    exact (12-20 bits; the JAX general limb tier, taken at 24 and 32 bits,
    wraps in int64 past 2^15 samples)."""
    quiet = np.stack([np.full(B, -3), rng.integers(-20, 0, B)])
    planes = np.concatenate([_extreme_planes(rng, depth, B), quiet]).astype(np.int64)
    got = tlpc.lag_sums(torch.from_numpy(planes), 8).numpy()
    np.testing.assert_array_equal(got, _exact_lag_sums(planes, 8))
    if depth <= 20:
        np.testing.assert_array_equal(got, jlpc.lag_sums_np(planes, 8, depth))


def _levinson_planes(rng, B=4096):
    """Silence, a constant, AR(2) tones at 16 and 24 bits, noise, and a
    33-bit tone."""
    t = np.arange(B)
    e = rng.normal(0, 600, B)
    ar2 = np.zeros(B)
    for i in range(2, B):
        ar2[i] = 1.6 * ar2[i - 1] - 0.68 * ar2[i - 2] + e[i]
    rows = [
        np.zeros(B),
        np.full(B, -1234.0),
        np.clip(ar2, -32768, 32767),
        np.clip(9000 * np.sin(2 * np.pi * 441.3 * t / 44100) + rng.normal(0, 37, B),
                -32768, 32767) * 256,
        rng.normal(0, 12000, B),
        4e9 * np.sin(2 * np.pi * 97 * t / 44100),
    ]
    return np.round(np.stack(rows)).astype(np.int64)


@pytest.mark.parametrize("precision", [2, 12, 14, 15])
@pytest.mark.parametrize("lpc_order", [1, 8, 12, 32])
def test_levinson_and_selection(rng, lpc_order, precision):
    planes = _levinson_planes(rng)
    lags = jlpc.lag_sums_np(planes, lpc_order)
    orders = jlpc.lpc_candidate_orders(lpc_order)
    assert tlpc.lpc_candidate_orders(lpc_order) == orders
    want = jlpc.fixed_point_levinson(lags, orders, precision, np)
    got = tlpc.fixed_point_levinson(torch.from_numpy(lags), orders)
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a.numpy(), b)
    w_sel = jlpc.select_lpc_candidate(want, 4096, precision, np)
    g_sel = tlpc.select_lpc_candidate(got, 4096, precision)
    for a, b in zip(g_sel, w_sel):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("wide", [False, True], ids=["depth24", "side33"])
@pytest.mark.parametrize("max_order", [1, 8, 32])
def test_lpc_residuals(rng, max_order, wide):
    """Residuals of the selected candidate and, on the last row, of
    full-scale coefficients that drive a plane out of int32; ``fits`` is
    computed dynamically on both sides."""
    depth = 32 if wide else 24
    lim = 1 << (depth if wide else depth - 1)
    B = 1024
    t = np.arange(B)
    planes = np.stack([
        np.round(0.6 * lim * np.sin(2 * np.pi * 440 * t / 44100) + rng.normal(0, 300, B)),
        rng.integers(-lim, lim, B),
        np.where(t % 2 == 0, -lim, lim - 1),
    ]).astype(np.int64)
    lags = jlpc.lag_sums_np(planes, max_order)
    pre = jlpc.fixed_point_levinson(lags, jlpc.lpc_candidate_orders(max_order), 15, np)
    order, qc, shift, _ = jlpc.select_lpc_candidate(pre, B, 15, np)
    qc[2, :max_order] = np.where(np.arange(max_order) % 2 == 0, -(1 << 14), (1 << 14) - 1)
    order[2], shift[2] = max_order, 0
    want = jlpc.lpc_residuals(planes, qc, shift, order, max_order, np)
    got = tlpc.lpc_residuals(*(torch.from_numpy(np.asarray(a, np.int64))
                               for a in (planes, qc, shift, order)), max_order)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert not got[1][2]  # the full-scale row leaves int32
