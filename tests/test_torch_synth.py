"""The port's decoder synthesis (``zigflac_tpu_torch/ops/synth.py``) on the
CPU against the JAX package: ``synthesize_batch`` (there the plain version
of the CUDA kernel) against the JAX scan and against the scalar
``decoder._synthesize``, and ``recombine_stereo`` against the JAX function.
The CUDA kernel's step arithmetic (``csrc/synth_steps.cuh``: int32 multiplies
while every sample fits, 64-bit from the tile where one does not) is built
for the host with g++ behind the kernel's per-warp tile loop and held against
both. Inputs are made with numpy from a seed and handed to every side.

Tolerance: exact equality (int64, wrap included)."""

import ctypes
import shutil
import subprocess
from pathlib import Path

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


# -- the CUDA kernel's step arithmetic, built for the host ---------------------

CSRC = Path(__file__).resolve().parent.parent / "zigflac_tpu_torch" / "csrc"

# The computing warp of csrc/synth.cu with its lanes run one after another:
# the votes become loops over the block's rows, the tiles plain arrays.
HOST_HARNESS = r"""
#include "synth_steps.cuh"
extern "C" void zf_synth_host(const int64_t* values, const int64_t* qcoeffs,
                              const int64_t* shift, const int64_t* order,
                              const int64_t* wasted, int64_t m_total, int64_t b,
                              int64_t* out, int32_t* report) {
  const int64_t tiles = (b + kZfTile - 1) / kZfTile;
  for (int64_t row0 = 0, blk = 0; row0 < m_total; row0 += 32, ++blk) {
    const int rows = (int)(m_total - row0 < 32 ? m_total - row0 : 32);
    static uint64_t q[32][kZfTile], h[32][kZfTile];
    static int32_t qn[32][kZfTile], hn[32][kZfTile], saved[32][kZfTile];
    int need = 0;
    bool narrow = true;
    int64_t warm_end = 0;
    for (int l = 0; l < rows; ++l) {
      for (int j = 0; j < kZfTile; ++j) {
        q[l][j] = (uint64_t)qcoeffs[(row0 + l) * kZfTile + j];
        qn[l][j] = (int32_t)(uint32_t)q[l][j];
        hn[l][j] = saved[l][j] = 0;
      }
      const int n = zf_taps_needed(q[l]);
      need = n > need ? n : need;
      narrow = narrow && zf_all_fit_i32(q[l]);
      int64_t ord = order[row0 + l];
      ord = ord < 0 ? 0 : ord > b ? b : ord;
      warm_end = ord > warm_end ? ord : warm_end;
    }
    const int taps = zf_round_taps(need);
    bool sh0 = true;
    for (int l = 0; l < rows; ++l) sh0 = sh0 && shift[row0 + l] == 0;
    int64_t k = 0;
    uint64_t in[kZfTile] = {0}, res[32][kZfTile];
    auto geometry = [&](int64_t k, int l, int* width, bool* full, int* warm) {
      const int64_t left = b - k * kZfTile;
      *width = left < kZfTile ? (int)left : kZfTile;
      *full = *width == kZfTile && k * kZfTile >= warm_end;
      const int64_t w = order[row0 + l] - k * kZfTile;
      *warm = w < 0 ? 0 : w > kZfTile ? kZfTile : (int)w;
      for (int t = 0; t < *width; ++t)
        in[t] = (uint64_t)values[(row0 + l) * b + k * kZfTile + t];
    };
    auto store = [&](int64_t k, int width) {
      for (int l = 0; l < rows; ++l)
        for (int t = 0; t < width; ++t)
          out[(row0 + l) * b + k * kZfTile + t] = (int64_t)(res[l][t] << wasted[row0 + l]);
    };
    int width, warm;
    bool full;
    if (narrow) {
      for (; k < tiles; ++k) {
        uint32_t bad = 0;
        for (int l = 0; l < rows; ++l) {
          geometry(k, l, &width, &full, &warm);
          bad |= zf_run_narrow(taps, full, sh0, qn[l], hn[l], saved[l], in, res[l], width, warm,
                               (int)shift[row0 + l]);
        }
        if (bad) {
          for (int l = 0; l < rows; ++l) zf_undo_narrow(taps, full, hn[l], saved[l]);
          break;
        }
        store(k, width);
      }
    }
    const int64_t wide_at = k < tiles ? k : -1;
    if (k < tiles)
      for (int l = 0; l < rows; ++l) zf_widen(hn[l], h[l]);
    for (; k < tiles; ++k) {
      for (int l = 0; l < rows; ++l) {
        geometry(k, l, &width, &full, &warm);
        zf_run_wide(taps, full, q[l], h[l], in, res[l], width, warm, (int)shift[row0 + l]);
      }
      store(k, width);
    }
    report[3 * blk] = taps;
    report[3 * blk + 1] = wide_at >= 0;
    report[3 * blk + 2] = (int32_t)wide_at;
  }
}
"""


@pytest.fixture(scope="module")
def host_synth(tmp_path_factory):
    """synth_steps.cuh built for the host with g++, behind the kernel's tile
    loop. Returns (samples, the per-block variant report)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel's step arithmetic cannot be built on the host")
    d = tmp_path_factory.mktemp("synth_host")
    (d / "host.cpp").write_text(HOST_HARNESS)
    so = d / "host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-Wno-unknown-pragmas", "-shared",
         "-fPIC", "-I", str(CSRC), "-o", str(so), str(d / "host.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.zf_synth_host.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [
        ctypes.c_void_p, ctypes.c_void_p]

    def run(values, q, shift, order, wasted):
        a = [np.ascontiguousarray(x, dtype=np.int64) for x in (values, q, shift, order, wasted)]
        m, b = a[0].shape
        out = np.zeros((m, b), np.int64)
        report = np.full((-(-m // 32), 3), -7, np.int32)
        lib.zf_synth_host(*(x.ctypes.data for x in a), m, b, out.ctypes.data,
                          report.ctypes.data)
        return out, report

    return run


def _check_host(host_synth, args):
    """The host build against the plain version and the JAX scan; returns
    its variant report."""
    got, report = host_synth(*args)
    np.testing.assert_array_equal(got, _port(args))
    np.testing.assert_array_equal(got, np.asarray(jax_synth.synthesize_batch(*args)))
    return report


def _quiet(rng, m, b, order, shift=12, wasted=0):
    """m stable subframes of one order: 16-bit values, coefficients whose
    magnitudes sum to under 2^shift with the last one non-zero, so every
    sample stays far inside int32."""
    q = np.zeros((m, 32), np.int64)
    if order:
        q[:, :order] = rng.integers(-100, 101, (m, order))
        q[:, order - 1] = rng.choice([-7, 9], m)
    values = rng.integers(-(1 << 15), 1 << 15, (m, b))
    return (values, q, np.full(m, shift), np.full(m, min(order, b)), np.full(m, wasted))


def _fixed(rng, m, b, max_order=4):
    """Fixed predictors as a stream's batch has them: orders 0-max_order
    mixed (row 0 has the largest), binomial coefficients, shift 0, and as
    values the order-th differences of a 15-bit signal."""
    order = rng.integers(0, max_order + 1, m)
    order[0] = max_order
    q = np.zeros((m, 32), np.int64)
    values = rng.integers(-(1 << 14), 1 << 14, (m, b))
    for i in range(m):
        o = min(int(order[i]), b)
        q[i, :o] = FIXED_COEFFS[o]
        values[i, o:] = np.diff(values[i], n=o)
    return values, q, np.zeros(m, np.int64), np.minimum(order, b), np.zeros(m, np.int64)


NARROW, WIDE = 0, 1


@pytest.mark.parametrize("b", [1, 31, 32, 33, 4096])
def test_host_steps_block_lengths(host_synth, b):
    """33-bit values and orders 0-32 over one tile, a ragged tile, and many:
    rows diverge and leave int32 wherever they do."""
    args = _subframes(np.random.default_rng(b), 40, b)
    report = _check_host(host_synth, args)
    assert report.shape == (2, 3) and (report[:, 0] == 32).all()


@pytest.mark.parametrize("order", [0, 1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 23, 24, 25, 31, 32])
def test_host_steps_every_tap_count(host_synth, order):
    """Orders just below, at and above each compiled tap count; the block
    runs the smallest count that covers its taps, and stays narrow."""
    args = _quiet(np.random.default_rng(order), 33, 100, order)
    report = _check_host(host_synth, args)
    want = order if order <= 4 else 8 if order <= 8 else 16 if order <= 16 else \
        24 if order <= 24 else 32
    assert report.tolist() == [[want, NARROW, -1]] * 2


def test_host_steps_taps_follow_the_last_nonzero_coefficient(host_synth):
    """A declared order of 12 whose coefficients beyond the third are zero
    runs three taps; one row of 32 taps lifts its whole block."""
    rng = np.random.default_rng(12)
    values, q, shift, order, wasted = _quiet(rng, 64, 70, 3)
    order[:] = 12
    q[40] = rng.integers(1, 50, 32)
    report = _check_host(host_synth, (values, q, shift, order, wasted))
    assert report.tolist() == [[3, NARROW, -1], [32, NARROW, -1]]


@pytest.mark.parametrize("coeff,start", [
    ((1 << 31) - 1, NARROW), (-(1 << 31) + 1, NARROW), (-(1 << 31), NARROW),
    (1 << 31, WIDE), (-(1 << 31) - 1, WIDE), (1 << 40, WIDE), (-(1 << 62), WIDE)])
def test_host_steps_coefficient_width(host_synth, coeff, start):
    """A block is narrow from its first tile exactly if every coefficient
    fits int32; with small values a full-scale coefficient and a shift of
    31 keeps the samples inside int32."""
    rng = np.random.default_rng(abs(coeff) % 1000)
    values, q, shift, order, wasted = _quiet(rng, 9, 80, 2, shift=31)
    q[4, 0] = coeff
    q[4, 1] = 1
    values[4] = rng.integers(-3, 4, 80)
    report = _check_host(host_synth, (values, q, shift, order, wasted))
    assert report[0, 1] == start and report[0, 2] == (0 if start == WIDE else -1)


@pytest.mark.parametrize("b,at", [(100, 0), (100, 5), (200, 32 * 3 + 17), (200, 32 * 3 + 31),
                                  (200, 32 * 4), (110, 32 * 3 + 9)],
                         ids=["first_sample", "first_tile", "mid_tile", "tile_end",
                              "tile_start", "ragged_tile"])
@pytest.mark.parametrize("back", [False, True], ids=["stays_out", "comes_back"])
def test_host_steps_sample_leaves_int32(host_synth, b, at, back):
    """One row is a running sum (order 1, coefficient 1) that steps to 2^31
    at position ``at``, and with ``back`` returns below it three positions
    on; the other rows are quiet. Its block goes wide in that tile, the
    other block never does."""
    rng = np.random.default_rng(at)
    values, q, shift, order, wasted = _quiet(rng, 64, b, 2)
    values[7] = 0
    values[7, at] = 1 << 31
    if back and at + 3 < b:
        values[7, at + 3] = -(1 << 31) - 5
    q[7] = 0
    q[7, 0], shift[7], order[7] = 1, 0, min(1, at)
    report = _check_host(host_synth, (values, q, shift, order, wasted))
    assert report.tolist() == [[2, WIDE, at // 32], [2, NARROW, -1]]


@pytest.mark.parametrize("value", [(1 << 31) - 1, -(1 << 31), 1 << 31, -(1 << 31) - 1, 1 << 32,
                                   -(1 << 32)])
def test_host_steps_int32_edge_values(host_synth, value):
    """Literal samples at the edges of int32 and of the 33-bit side channel:
    the block leaves the narrow arithmetic exactly for those past int32."""
    rng = np.random.default_rng(abs(value) % 997)
    values, q, shift, order, wasted = _quiet(rng, 5, 70, 4)
    values[2, 40] = value
    q[2], order[2] = 0, 0  # verbatim: the sample is the value
    report = _check_host(host_synth, (values, q, shift, order, wasted))
    fits = -(1 << 31) <= value < (1 << 31)
    assert report.tolist() == [[4, NARROW, -1] if fits else [4, WIDE, 1]]


@pytest.mark.parametrize("max_order", [1, 2, 3, 4])
@pytest.mark.parametrize("at", [None, 3, 40, 95, 130], ids=lambda at: f"leaves_at_{at}")
def test_host_steps_fixed_predictors(host_synth, max_order, at):
    """A block whose shifts are all 0 takes the low word of each sample from
    a 32-bit multiply-add of its own: orders up to each of 1-4, quiet, and
    with a row whose value at ``at`` is 2^32 too large (in the first tile, in
    full tiles, in the ragged last one)."""
    rng = np.random.default_rng(10 * max_order + (at or 0))
    values, q, shift, order, wasted = _fixed(rng, 40, 140, max_order)
    if at is not None:
        values[5, at] += 1 << 32
    report = _check_host(host_synth, (values, q, shift, order, wasted))
    want = [max_order, NARROW, -1] if at is None else [max_order, WIDE, at // 32]
    assert report.tolist() == [want, [int(order[32:].max()), NARROW, -1]]


def test_host_steps_wrap_past_2_63(host_synth):
    """62-bit values and coefficients: wide from the first tile, every sum
    wraps."""
    args = _subframes(np.random.default_rng(63), 9, 300, bits=62, qbits=62)
    report = _check_host(host_synth, args)
    assert report.tolist() == [[32, WIDE, 0]]


@pytest.mark.parametrize("wasted", [1, 7, 40])
def test_host_steps_constant_and_verbatim_with_wasted_bits(host_synth, wasted):
    """Order 0 (no taps at all: a copy) shifted left by the wasted bits."""
    rng = np.random.default_rng(wasted)
    args = _quiet(rng, 6, 65, 0, wasted=wasted)
    args[0][0] = 1234  # a constant subframe
    report = _check_host(host_synth, args)
    assert report.tolist() == [[0, NARROW, -1]]
    np.testing.assert_array_equal(host_synth(*args)[0], args[0] << wasted)


@pytest.mark.parametrize("row", [17, 37])
def test_host_steps_ragged_last_block(host_synth, row):
    """40 subframes are a block of 32 and one of 8: a row that leaves int32
    takes only its own block wide."""
    rng = np.random.default_rng(row)
    values, q, shift, order, wasted = _quiet(rng, 40, 100, 8)
    values[row, 50] = 1 << 33
    report = _check_host(host_synth, (values, q, shift, order, wasted))
    want = [[8, NARROW, -1], [8, NARROW, -1]]
    want[row // 32] = [8, WIDE, 1]
    assert report.tolist() == want


def test_host_steps_order_above_the_taps(host_synth):
    """Orders above 32 (no stream has them; the function is defined): the
    warmup reaches past the first tile."""
    rng = np.random.default_rng(77)
    values, q, shift, order, wasted = _quiet(rng, 4, 120, 6)
    order[:] = [40, 64, 6, 500]
    _check_host(host_synth, (values, q, shift, order, wasted))


def test_variant_counts_sums_up_reports(host_synth):
    """The summary of the per-block reports, on the host build's report of
    two launches: three quiet blocks, then one wide from its first tile and
    one that goes wide in its second."""
    rng = np.random.default_rng(5)
    first = host_synth(*_quiet(rng, 96, 70, 3))[1]
    values, q, shift, order, wasted = _quiet(rng, 64, 70, 8)
    q[3, 0] = 1 << 35
    values[40, 33] = 1 << 34
    second = host_synth(values, q, shift, order, wasted)[1]
    got = synth.variant_counts([torch.from_numpy(first), torch.from_numpy(second)])
    assert got == {"blocks": 5, "narrow": 3, "wide_from_start": 1, "went_wide": 1,
                   "taps": {3: 3, 8: 2}}
    assert synth.variant_counts([])["blocks"] == 0


def test_cpu_tensors_record_no_variants(monkeypatch):
    """STATS is the kernel's: the plain version on CPU tensors adds nothing."""
    monkeypatch.setattr(synth, "STATS", {})
    _port(_subframes(np.random.default_rng(8), 3, 40))
    assert synth.STATS == {}
