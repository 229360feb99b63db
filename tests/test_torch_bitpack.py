"""The port's header, symbol stream, packing, CRC-16 and compaction
(zigflac_tpu_torch/ops/{header,bitpack,crc16}.py) against the JAX
package's, on the same numpy PCM made from a seed.

Tolerance: exact equality. Every value is an integer or a byte."""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_signal
from test_pallas import _mk
from zigflac_tpu import crc as jcrc
from zigflac_tpu.ops import analyze as jan, bitpack as jbp, crc16 as jcrc16, header as jhd
from zigflac_tpu.utils.config import EncoderConfig as JaxConfig
from zigflac_tpu_torch.ops import analyze as tan, bitpack as tbp, crc16 as tcrc16, header as thd
from zigflac_tpu_torch.utils.config import EncoderConfig

FRAME_NUMBERS = [0, 1, 127, 128, 2047, 2048, 65535, 65536, 2**21 - 1, 2**21,
                 2**26 - 1, 2**26, 2**31 - 1, 2**31, 2**36 - 1]


@pytest.mark.parametrize(
    "block,rate,depth",
    [(4096, 44100, 16), (1000, 22050, 24), (37, 12345, 12), (192, 100, 8),
     (4608, 700000, 20), (65535, 96000, 17)],
)
def test_build_headers(block, rate, depth):
    """Every UTF-8 frame-number length, channel code and uncommon
    block-size / sample-rate tail, with the header CRC-8."""
    static = jhd.header_static(block, rate, depth)
    assert thd.header_static(block, rate, depth) == static
    fns = np.array(FRAME_NUMBERS, np.int64)
    codes = np.arange(len(fns), dtype=np.int32) % 11
    want_b, want_len = jhd.build_headers(jnp.asarray(fns), jnp.asarray(codes), static)
    got_b, got_len = thd.build_headers(torch.from_numpy(fns), torch.from_numpy(codes), static)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    for row, n in zip(got_b.numpy(), got_len.numpy()):
        assert jcrc.crc8(bytes(row[: n - 1].astype(np.uint8))) == row[n - 1]


def _pcm(rng, B, channels, depth, shift=0):
    kinds = ("silence", "constant", "sine", "noise", "extreme", "mixed", "quiet_noise")
    return np.stack([
        make_signal(rng, B, channels=channels, depth=depth - shift, kind=k).astype(np.int64)
        << shift for k in kinds
    ]).astype(np.int32)


@lru_cache(maxsize=None)
def _jax_pack(cfg: JaxConfig, depth: int, max_words: int):
    B = cfg.block_size
    hstatic = jhd.header_static(B, 44100, depth)

    def run(frames, fns):
        plan = jan.plan_frames(frames, depth, cfg)
        dep_cum, total_bits, val_parts, nbv = jbp.frame_symbol_stream(
            plan, fns, hstatic, B, cfg.max_rice_order
        )
        val = jnp.concatenate([v.astype(jnp.uint64) for v in val_parts], axis=1)
        words, tb, _ = jbp.pack_frames(plan, fns, hstatic, B, cfg.max_rice_order, max_words)
        byte_len = (tb + 7) >> 3
        crcs = jcrc16.crc16_words(words, byte_len)
        return dep_cum, total_bits, val, nbv, words, crcs, jbp.deposit_crc16(words, byte_len, crcs)

    return jax.jit(run)


@pytest.mark.parametrize(
    "B,channels,depth,fields,budget",
    [
        (4096, 2, 16, {}, None),
        (4096, 1, 24, {"channels": 1}, None),
        (1024, 2, 16, {"block_size": 1024}, None),
        (4096, 2, 16, {"wasted_bits": True}, None),
        (37, 2, 16, {"block_size": 37}, None),
        (4096, 2, 16, {}, 256),  # word budget below most frames: deposits dropped
    ],
)
def test_symbols_pack_crc(rng, B, channels, depth, fields, budget):
    frames = _pcm(rng, B, channels, depth, shift=3 if fields.get("wasted_bits") else 0)
    n = frames.shape[0]
    fns = np.arange(1000, 1000 + n, dtype=np.int64)
    hstatic = jhd.header_static(B, 44100, depth)
    n_wire = 2 if channels == 2 else channels
    max_words = budget or jbp.max_frame_words(B, n_wire, depth)
    want = [np.asarray(x) for x in _jax_pack(JaxConfig(**fields), depth, max_words)(
        frames, fns)]
    w_cum, w_total, w_val, w_nbv, w_words, w_crcs, w_final = want

    plan = tan.plan_frames(torch.from_numpy(frames), depth, EncoderConfig(**fields))
    t_fns = torch.from_numpy(fns)
    cfg = EncoderConfig(**fields)
    dep_cum, total_bits, val, nbv = tbp.frame_symbol_stream(
        plan, t_fns, hstatic, B, cfg.max_rice_order, tan.lpc_order_of(cfg), cfg.lpc_precision
    )
    np.testing.assert_array_equal(dep_cum.numpy(), w_cum)
    np.testing.assert_array_equal(total_bits.numpy(), w_total)
    np.testing.assert_array_equal(nbv.numpy(), w_nbv)
    np.testing.assert_array_equal(val.numpy(), w_val.astype(np.int64))

    words, tb = tbp.pack_frames(plan, t_fns, hstatic, B, 8, max_words, tan.lpc_order_of(cfg),
                                cfg.lpc_precision)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), w_words)
    byte_len = (tb + 7) >> 3
    crcs = tcrc16.crc16_words(words, byte_len)
    final = tbp.deposit_crc16(words, byte_len, crcs)
    np.testing.assert_array_equal(final.numpy().view(np.uint32), w_final)
    if budget is None:  # whole frames: the CRC is the frame's CRC-16
        np.testing.assert_array_equal(crcs.numpy(), w_crcs)
        be = words.numpy().view(np.uint32).astype(">u4")
        for i in range(n):
            assert crcs[i] == jcrc.crc16(be[i].tobytes()[: int(byte_len[i])])


@lru_cache(maxsize=None)
def _jax_pack_plan(B: int, depth: int, max_words: int, lpc_order: int, lpc_precision: int):
    """The JAX symbol stream and segment-sum words of a given plan."""
    hstatic = jhd.header_static(B, 44100, depth)
    kw = dict(lpc_order=lpc_order, lpc_precision=lpc_precision)

    def run(plan, fns):
        dep_cum, total_bits, val_parts, nbv = jbp.frame_symbol_stream(
            plan, fns, hstatic, B, 8, **kw)
        val = jnp.concatenate([v.astype(jnp.uint64) for v in val_parts], axis=1)
        words, _, _ = jbp.pack_frames(plan, fns, hstatic, B, 8, max_words, depth=depth, **kw)
        return dep_cum, total_bits, val, nbv, words

    return jax.jit(run)


def _jax_plan_of(plan):
    """The port's plan as the JAX package's FrameWirePlan, in its dtypes."""
    f = {name: getattr(plan, name).numpy() for name in tan.FrameWirePlan._fields}
    for name in f:
        if name == "params":
            f[name] = f[name].astype(np.uint8)
        elif name != "planes" or f[name].dtype != np.int64:
            f[name] = f[name].astype(np.int32)
    return jan.FrameWirePlan(**f, sweep_unsafe=np.False_)


@pytest.mark.parametrize(
    "B,channels,depth,fields",
    [
        (4096, 2, 16, dict(prediction="lpc")),
        (1024, 2, 24, dict(prediction="lpc", channels=2, lpc_order=32, lpc_precision=15,
                           wasted_bits=True)),
        (1024, 2, 32, dict(prediction="fixed")),
        (1024, 2, 32, dict(prediction="lpc", lpc_order=12, wasted_bits=True)),
    ],
    ids=["lpc16", "lpc24_o32_indep", "fixed32", "lpc32"],
)
def test_symbols_and_words_lpc_depth32(rng, B, channels, depth, fields):
    """LPC subframes (precision/shift and coefficient symbols, up to 32
    warmup samples) and depth-32 frames (33-bit side samples): one plan
    through the JAX package's symbol stream and segment-sum packer and
    through the port's."""
    cfg = EncoderConfig(block_size=B, **fields)
    frames = _pcm(rng, B, channels, depth, shift=2 if cfg.wasted_bits else 0)
    if depth == 32:  # a constant 33-bit side plane, a verbatim side plane
        lo, hi = -(1 << 31), (1 << 31) - 1
        extra = [[np.full(B, lo), np.full(B, hi)],
                 [np.where(np.arange(B) % 2 == 0, lo, hi), rng.integers(lo, hi, B)]]
        frames = np.concatenate([frames, np.array(extra, np.int64).astype(np.int32)])
    fns = np.arange(len(frames), dtype=np.int64)
    plan = tan.plan_frames(torch.from_numpy(frames), depth, cfg)
    assert (plan.kind == (3 if cfg.prediction == "lpc" else 1)).any()
    n_wire = plan.kind.shape[0]
    max_words = tbp.max_frame_words(B, n_wire, depth)
    lpc_order = tan.lpc_order_of(cfg)
    want = [np.asarray(x) for x in _jax_pack_plan(B, depth, max_words, lpc_order,
                                                  cfg.lpc_precision)(_jax_plan_of(plan), fns)]
    hstatic = thd.header_static(B, 44100, depth)
    t_fns = torch.from_numpy(fns)
    got = tbp.frame_symbol_stream(plan, t_fns, hstatic, B, 8, lpc_order, cfg.lpc_precision)
    for g, w in zip(got, want[:4]):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
    words, _ = tbp.pack_frames(plan, t_fns, hstatic, B, 8, max_words, lpc_order=lpc_order,
                               lpc_precision=cfg.lpc_precision)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want[4])


@pytest.mark.parametrize("n,w_mult", [(4, 1), (16, 5), (64, 3)])
def test_compact_stream_aligned(rng, n, w_mult):
    words, fbj, fb = _mk(rng, n, w_mult * tbp.ALIGN_W)
    gcnt = (fb + 4 * tbp.ALIGN_W - 1) // (4 * tbp.ALIGN_W)
    capw = int(gcnt.sum() + 2) * tbp.ALIGN_W
    w_out, w_total = jbp.compact_stream_aligned(words, fbj, capw)
    t_out, t_total = tbp.compact_stream_aligned(
        torch.from_numpy(np.array(words).view(np.int32)),
        torch.from_numpy(fb.astype(np.int64)), capw,
    )
    assert int(t_total) == int(w_total)
    np.testing.assert_array_equal(t_out.numpy().view(np.uint32), np.asarray(w_out))


@pytest.mark.parametrize("block,n_wire,depth,ratio", [
    (4096, 2, 16, None), (4096, 2, 16, 1.25), (37, 8, 24, None), (65535, 1, 8, 1.25),
    (4096, 2, 32, None), (4096, 2, 32, 1.25),
])
def test_max_frame_words(block, n_wire, depth, ratio):
    assert tbp.max_frame_words(block, n_wire, depth, ratio) == jbp.max_frame_words(
        block, n_wire, depth, ratio
    )
