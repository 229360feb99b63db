"""The port's frame analysis (zigflac_tpu_torch/ops/analyze.py) against the
JAX package's: every FrameWirePlan field of plan_frames(speculate=False)
and every PlaneAnalysis field of analyze_planes, on the same numpy PCM made
from a seed.

Tolerance: exact equality. Every field is an integer decision."""

from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

from conftest import make_signal
from zigflac_tpu.ops import analyze as jan
from zigflac_tpu.utils.config import EncoderConfig as JaxConfig
from zigflac_tpu_torch.ops import analyze as tan
from zigflac_tpu_torch.utils.config import EncoderConfig

KINDS = ("silence", "constant", "sine", "noise", "alternating", "extreme", "mixed")
PLAN_FIELDS = ("channels_code", "kind", "order", "method", "part_order", "sample_size",
               "params", "planes", "residuals", "qcoeffs", "qshift", "wasted")


@lru_cache(maxsize=None)
def _jax_plan(cfg: JaxConfig, depth: int):
    return jax.jit(lambda x: jan.plan_frames(x, depth, cfg, speculate=False))


def _frames(rng, B, channels, depth, per_kind=2, shift=0):
    """[N, C, B] int32: ``per_kind`` frames of every content kind."""
    out = []
    for kind in KINDS:
        for _ in range(per_kind):
            x = make_signal(rng, B, channels=channels, depth=depth - shift, kind=kind)
            out.append(x.astype(np.int64) << shift)
    return np.stack(out).astype(np.int32)


def _compare_plans(frames, depth, **fields):
    want = _jax_plan(JaxConfig(**fields), depth)(frames)
    got = tan.plan_frames(torch.from_numpy(frames), depth, EncoderConfig(**fields))
    for name in PLAN_FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )
    # the JAX plan's flag for its speculative sweep, which the port has not
    assert not bool(np.asarray(want.sweep_unsafe))
    return got


@pytest.mark.parametrize("depth", [8, 12, 16, 20, 24])
def test_stereo_plan_depths(rng, depth):
    _compare_plans(_frames(rng, 4096, 2, depth), depth)


@pytest.mark.parametrize("channels", [1, 2, 8])
def test_independent_plan_channels(rng, channels):
    _compare_plans(_frames(rng, 4096, channels, 16, per_kind=1), 16, channels=channels)


@pytest.mark.parametrize("stereo", [True, False])
def test_wasted_bits_plan(rng, stereo):
    """Content with 3 common trailing zero bits, shaved (extension)."""
    frames = _frames(rng, 4096, 2, 16, per_kind=1, shift=3)
    channels = "stereo_auto" if stereo else 2
    _compare_plans(frames, 16, channels=channels, wasted_bits=True)


def test_block_1024_plan(rng):
    _compare_plans(_frames(rng, 1024, 2, 16), 16, block_size=1024)


@pytest.mark.parametrize("B", [5, 6, 8, 9, 12, 16, 17, 24, 31, 32, 33, 48, 63, 64, 70])
def test_ragged_block_plan(rng, B):
    """Ragged tail sizes: odd sizes (partition order 0) and powers of two,
    whose order-3 first partition at the deepest order has fewer samples
    than the predictor order."""
    _compare_plans(_frames(rng, B, 2, 16), 16, block_size=B)


@pytest.mark.parametrize("depth,max_rice_param", [(16, 30), (24, 30), (24, 14)])
def test_analyze_planes_fields(rng, depth, max_rice_param):
    """PlaneAnalysis of single planes; at depth 24 the JAX sweep is exact
    u64, at 16 its proven u32 split with the under-half fixup."""
    planes = np.concatenate([
        _frames(rng, 4096, 1, depth, per_kind=2)[:, 0],
        # quiet partitions: zigzag sums below half the partition size
        rng.integers(-1, 2, (4, 4096)).astype(np.int32),
    ])
    cfg = dict(max_rice_param=max_rice_param)
    want = jax.jit(lambda x: jan.analyze_planes(x, 32, depth, 4096, JaxConfig(**cfg)))(planes)
    got = tan.analyze_planes(torch.from_numpy(planes), 32, depth, 4096, EncoderConfig(**cfg))
    for name in tan.PlaneAnalysis._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )


def test_bit_length_ladder():
    x = torch.tensor([0, 1, 2, 3, 255, 256, 2**31 - 1, 2**31, 2**32 - 1])
    assert tan.bit_length(x).tolist() == [v.bit_length() for v in x.tolist()]


def test_argmin_tie_rules():
    s = torch.tensor([[3, 1, 2], [1, 1, 5], [1, 0, 2]])
    assert tan.argmin_first(s).tolist() == [1, 2, 0]
    assert tan.argmin_last(s).tolist() == [2, 2, 2]


LPC_CASES = {
    # id: (block, channels, depth, fields)
    "stereo16_o8": (4096, 2, 16, dict(lpc_order=8)),
    "stereo24_o32": (4096, 2, 24, dict(lpc_order=32)),
    "mono16_o12_b1024_wasted": (1024, 1, 16, dict(lpc_order=12, channels=1, wasted_bits=True)),
    "eight16_o1_b256": (256, 8, 16, dict(lpc_order=1, channels=8)),
    "tail9_o8": (9, 2, 16, dict(lpc_order=8, channels=2)),
    "tail40_o8_wasted": (40, 2, 24, dict(lpc_order=8, wasted_bits=True)),
}


@pytest.mark.parametrize("case", list(LPC_CASES))
def test_lpc_plan(rng, case):
    """Every FrameWirePlan field with LPC prediction, qcoeffs and qshift
    included; in every case some plane picks the LPC candidate."""
    B, channels, depth, fields = LPC_CASES[case]
    shift = 2 if fields.get("wasted_bits") else 0
    plan = _compare_plans(_frames(rng, B, channels, depth, per_kind=1, shift=shift), depth,
                          block_size=B, prediction="lpc", **fields)
    assert (plan.kind == 3).any()


def test_lpc_plan_largest_block(rng):
    """LPC at the format's largest block, 65535 samples, with a quiet
    negative-DC frame (small negative windowed samples, whose lag sums run
    past 2^15 products) beside sine and noise frames."""
    B = 65535
    frames = _frames(rng, B, 2, 16, per_kind=1)[2:4]
    quiet = (-4 + rng.integers(-2, 3, (1, 2, B))).astype(np.int32)
    plan = _compare_plans(np.concatenate([frames, quiet]), 16, block_size=B,
                          prediction="lpc", lpc_order=8)
    assert (plan.kind[-1] == 3).any()


def _depth32_frames(rng, B, shift=0):
    """Full-scale 32-bit content: every kind of _frames, then L = -2^31
    against R = 2^31 - 1 (a 33-bit side plane) constant and alternating, so
    the side's differences leave int32."""
    frames = _frames(rng, B, 2, 32, per_kind=1).astype(np.int64)
    lo, hi = -(1 << 31), (1 << 31) - 1
    alt = np.where(np.arange(B) % 2 == 0, lo, hi)
    extra = np.stack([np.stack([np.full(B, lo), np.full(B, hi)]), np.stack([alt, alt[::-1]]),
                      np.stack([alt, np.full(B, hi)])])
    frames = np.concatenate([frames, extra]) >> shift << shift
    return frames.astype(np.int32)


@pytest.mark.parametrize(
    "prediction,channels,wasted",
    [("fixed", "stereo_auto", False), ("lpc", "stereo_auto", False),
     ("fixed", 2, False), ("lpc", 2, True)],
)
def test_depth32_plan(rng, prediction, channels, wasted):
    """Depth 32: L/R/M as int32 and the 33-bit side plane as int64, both
    wide; the wire planes of stereo frames are int64."""
    B = 1024
    frames = _depth32_frames(rng, B, shift=3 if wasted else 0)
    plan = _compare_plans(frames, 32, block_size=B, prediction=prediction,
                          channels=channels, wasted_bits=wasted)
    if channels == "stereo_auto":
        assert plan.planes.dtype == torch.int64
        assert (plan.sample_size == 33).any()  # a side channel on the wire


@pytest.mark.parametrize("B", [4096, 256])
def test_rice_estimate_lpc_orders(rng, B):
    """The partition-order limit for every predictor order 0..32: orders
    17-31 at these blocks allow partitions shorter than the order, whose
    first partition is all warmup (size <= 0, sum 0)."""
    order = np.arange(33).repeat(2)
    res = rng.integers(-3000, 3000, (order.size, B)).astype(np.int32)
    res[np.arange(B)[None, :] < order[:, None]] = 0
    res[1::2] >>= 10  # quiet rows: sums below half the partition size
    want = jax.jit(lambda r, o: jan.rice_estimate(r, o, B, 8, 30))(res, order.astype(np.int32))
    got = tan.rice_estimate(torch.from_numpy(res), torch.from_numpy(order), B, 8, 30)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
