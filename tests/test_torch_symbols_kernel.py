"""The frame symbols kernel's arithmetic (zigflac_tpu_torch/csrc/symbols_steps.cuh)
built for the host with g++, behind a loop that runs csrc/symbols.cu's block
(the header, the groups' fields, the escapes' keys, then the column tiles
with their warps, rounds and lanes in turn, the widths scanned in 32 bits
and summed in 64) one frame after another, called through the wrapper's own
argument marshalling (ops/symbols.launch). It is held
against the port's plain version (bitpack.frame_symbol_stream) and the JAX
package's (ops/bitpack.frame_symbol_stream) on plans made from a seed with
numpy, synthetic and real: escapes, the N1 fallback, Rice codes of
thousands of bits, 32-bit stream ends, every frame-number length, uncommon
rates and block sizes, blocks of 1 to 65,535 samples, 1-8 channels, LPC
orders 1-32 and the 33-bit side plane, codes of ~2^32 bits across warps'
runs and tiles; the division by multiply-high for every block size; then
the wrapper's routing and checks, and all 22 pinned corpus encodes with the
harness in the kernel's place.

Tolerance: exact equality of every column of dep_cum, val and nbv, and of
total_bits."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from dataclasses import asdict
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zigflac_tpu_torch
from conftest import make_signal
from test_regression_corpus import CASES, VEC_DIR, _case_config, _wav_bytes
from test_torch_bitpack import _jax_plan_of
from zigflac_tpu.ops import bitpack as jbp, header as jhd
from zigflac_tpu_torch import EncoderConfig
from zigflac_tpu_torch.ops import analyze as tan, bitpack as tbp, symbols as tsym
from zigflac_tpu_torch.ops.header import header_static

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "zigflac_tpu_torch" / "csrc"
sys.path.insert(0, str(ROOT))
from chip_smoke import (SYMBOL_FRAME_NUMBERS as FRAME_NUMBERS,  # noqa: E402
                        SYMBOL_LONG_CODES as LONG_CODES, SYMBOL_RATES as RATES,
                        SYMBOL_WATCH as WATCH, long_code_plan, synthetic_plan)

# csrc/symbols.cu's block with its warps and lanes in turn: phase one (warp
# 0's header a byte a lane and lane 0's CRC-8, the channels, the groups'
# fields), the escapes' keys and fields, then the tiles: kRounds rounds of 32
# neighbouring columns a warp (rounds aligned to 32 elements of the outputs,
# the frame's first columns in a partial round), each round's widths scanned
# in 32 bits, the warps' totals before each warp and the carry from tile to
# tile mod 2^32, each lane's widths summed in 64 bits. Same C signature as
# zf_frame_symbols.
HOST_HARNESS = r"""
#include <algorithm>
#include <cassert>
#include "symbols_steps.cuh"

static constexpr ZfCrc8Table kCrc8 = zf_crc8_make_table();
static constexpr int kThreads = 256, kWarps = kThreads / 32, kRounds = 4;  // symbols.cu's
static constexpr int32_t kTile = kThreads * kRounds;

template <typename T>
static void frame(const ZfSymArgs<T>& a, int64_t f) {
  const ZfSymLayout& L = a.lay;
  ZfSymHeader hdr = {};
  ZfSymChannel<T> chan[kZfSymMaxChannels];
  static ZfSymGroup groups[kZfSymMaxChannels * kZfSymParamCols];
  static uint32_t keys[kZfSymMaxChannels * kZfSymParamCols];
  const int64_t fn = a.frame_numbers[f];
  for (int lane = 0; lane < kZfSymHeaderCols; ++lane)
    hdr.bytes[lane] = zf_sym_header_byte(lane, fn, a.channels_code[f], a.hs);
  zf_sym_header_crc(hdr, zf_sym_header_crc_pos(fn, a.hs), kCrc8);
  for (int c = 0; c < L.w; ++c) chan[c] = zf_sym_channel(a, c, f);
  bool esc = false;
  for (int t = 0; t < kThreads; ++t)
    esc |= zf_sym_group_fields(a, f, chan, groups, keys, false, t, kThreads);
  if (esc) {
    for (int c = 0; c < L.w; ++c) {
      const ZfSymChannel<T>& ch = chan[c];
      if (!zf_sym_pred(ch.kind)) continue;
      const int64_t wn = c * a.n + f, esc_param = ((int64_t)1 << (4 + ch.method)) - 1;
      for (uint32_t i = 0; i < (uint32_t)L.b; ++i) {
        const uint32_t p = (L.g == 1 ? i : zf_sym_div(i, L.d_g)) >> ch.ds;
        if (groups[c * kZfSymParamCols + (p << ch.ds)].y != kZfSymPending) continue;
        assert(a.params[wn * kZfSymParamCols + p] == esc_param);
        uint32_t& key = keys[c * kZfSymParamCols + p];
        key = std::max(key, zf_sym_key(ch.res[(int64_t)i * a.rs_b]));
      }
    }
    for (int t = 0; t < kThreads; ++t)
      zf_sym_group_fields(a, f, chan, groups, keys, true, t, kThreads);
  }
  const int64_t row = f * L.s;
  const uint32_t s = (uint32_t)L.s, lead = (uint32_t)row & 31u;
  uint32_t carry = 0;
  static uint64_t bits[kThreads];
  static uint32_t incl[kThreads][kRounds];
  std::fill(bits, bits + kThreads, 0);
  for (int32_t tile = -(int32_t)lead; tile < (int32_t)s; tile += kTile) {
    uint32_t warp_sum[kWarps];
    for (int warp = 0; warp < kWarps; ++warp) {
      uint32_t run = 0;
      for (int j = 0; j < kRounds; ++j) {
        uint32_t x = 0;  // the round's inclusive scan, lane by lane
        for (int lane = 0; lane < 32; ++lane) {
          const uint32_t col = (uint32_t)tile + warp * (32 * kRounds) + lane + 32 * j;
          ZfSym sym = zf_sym_make(0, 0, 0);
          if (col < s) {
            sym = zf_sym_frame_column(a, f, col, hdr, chan, groups);
            a.val[row + col] = (int64_t)sym.val;
            a.nbv[row + col] = (int32_t)sym.nbv;
          }
          bits[warp * 32 + lane] += sym.nb;
          x += (uint32_t)sym.nb;
          incl[warp * 32 + lane][j] = run + x;
        }
        run += x;
      }
      warp_sum[warp] = run;
    }
    uint32_t total = 0;
    for (int warp = 0; warp < kWarps; ++warp) {
      const uint32_t before = carry + total;
      for (int lane = 0; lane < 32; ++lane)
        for (int j = 0; j < kRounds; ++j) {
          const uint32_t col = (uint32_t)tile + warp * (32 * kRounds) + lane + 32 * j;
          if (col < s) a.dep_cum[row + col] = (int32_t)(before + incl[warp * 32 + lane][j]);
        }
      total += warp_sum[warp];
    }
    carry += total;
  }
  uint64_t total = 0;
  for (int t = 0; t < kThreads; ++t) total += bits[t];
  a.total_bits[f] = (int64_t)total;
}

extern "C" int zf_frame_symbols_host(
    const void* frame_numbers, const void* channels_code, const void* kind, const void* order,
    const void* method, const void* part_order, const void* sample_size, const void* qshift,
    const void* wasted, const void* params, const void* qcoeffs, const void* planes,
    int planes_wide, int64_t pl_w, int64_t pl_n, int64_t pl_b, const void* residuals,
    int64_t rs_w, int64_t rs_n, int64_t rs_b, int64_t n, int64_t w, int64_t b,
    int64_t max_rice_order, int64_t lpc_order, int64_t lpc_precision, int64_t byte2,
    int64_t depth_code, int64_t tail, int64_t ntail, void* dep_cum, void* val, void* nbv,
    void* total_bits, void*) {
  const ZfSymLayout lay = zf_sym_layout(w, b, max_rice_order, lpc_order, lpc_precision);
  if (w > kZfSymMaxChannels || ((int64_t)1 << lay.po_top) > kZfSymParamCols) return 1;
  const ZfSymHeaderStatic hs = {byte2, depth_code, tail, ntail};
#define ZF_SYM_ARGS(T)                                                                      \
  ZfSymArgs<T> {                                                                            \
    (const int64_t*)frame_numbers, (const int64_t*)channels_code, (const int64_t*)kind,     \
        (const int64_t*)order, (const int64_t*)method, (const int64_t*)part_order,          \
        (const int64_t*)sample_size, (const int64_t*)qshift, (const int64_t*)wasted,        \
        (const int64_t*)params, (const int64_t*)qcoeffs, (const T*)planes, pl_w, pl_n,      \
        pl_b, (const int32_t*)residuals, rs_w, rs_n, rs_b, n, lay, hs, (int32_t*)dep_cum,   \
        (int64_t*)val, (int32_t*)nbv, (int64_t*)total_bits                                  \
  }
  for (int64_t f = 0; f < n; ++f) {
    if (planes_wide) frame(ZF_SYM_ARGS(int64_t), f);
    else frame(ZF_SYM_ARGS(int32_t), f);
  }
  return 0;
}

extern "C" int64_t zf_symbol_columns_host(int64_t w, int64_t b, int64_t mro, int64_t lpc_order) {
  return zf_sym_layout(w, b, mro, lpc_order, 0).s;
}

// q / d by zf_sym_div at both ends of every quotient k the kernel takes,
// q = k d and q = k d + d - 1: (q m >> 32) >> s grows with q, so where both
// ends give k every q between does. Returns the ends that differ from q / d.
static int64_t div_faults(int64_t d, int64_t q_end, int64_t* checked) {
  if (d < 2) return 0;  // the kernel divides by G only where G >= 2
  const ZfSymDiv v = zf_sym_divider(d);
  int64_t bad = 0;
  for (int64_t k = 0; k * d < q_end; ++k) {
    const int64_t lo = k * d, hi = std::min(k * d + d - 1, q_end - 1);
    bad += zf_sym_div((uint32_t)lo, v) != (uint64_t)k;
    bad += zf_sym_div((uint32_t)hi, v) != (uint64_t)k;
    *checked += 2;
  }
  return bad;
}

// Every division of zf_sym_layout's frames of 8 wire channels, blocks
// b_lo..b_hi, every top partition order 0..min(15, ctz(B)) (every
// max_rice_order) and LPC orders 0-32: samples by G, residual sections by
// G + 1, frame columns by the channel's columns. Returns the faults and
// writes the ends checked.
extern "C" int64_t zf_sym_division_faults(int64_t b_lo, int64_t b_hi, int64_t* checked) {
  int64_t bad = 0;
  *checked = 0;
  for (int64_t b = b_lo; b <= b_hi; ++b)
    for (int64_t po = 0; po <= std::min<int64_t>(15, zf_sym_ctz(b)); ++po) {
      const ZfSymLayout l = zf_sym_layout(8, b, po, 0, 0);
      bad += div_faults(l.g, b, checked);
      bad += div_faults(l.g + 1, l.chan_cols - l.r0, checked);
      for (int64_t lpc = 0; lpc <= 32; ++lpc) {
        const ZfSymLayout m = zf_sym_layout(8, b, po, lpc, 15);
        bad += div_faults(m.chan_cols, m.s - kZfSymHeaderCols, checked);
      }
    }
  return bad;
}
"""

@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """symbols_steps.cuh built for the host with g++ behind the kernel's block
    loop: host(plan, frame_numbers, hstatic, B, max_rice_order, lpc_order,
    lpc_precision) -> (dep_cum, total_bits, val, nbv), through
    ops/symbols.launch as the kernel is called."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel's arithmetic cannot be built on the host")
    d = tmp_path_factory.mktemp("symbols_host")
    (d / "host.cpp").write_text(HOST_HARNESS)
    so = d / "host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-Wno-unknown-pragmas", "-shared",
         "-fPIC", "-I", str(CSRC), "-o", str(so), str(d / "host.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.zf_frame_symbols_host.argtypes = [ptr] * 12 + [i32] + [i64] * 3 + [ptr] + [i64] * 13 + [
        ptr] * 5
    lib.zf_frame_symbols_host.restype = ctypes.c_int
    lib.zf_symbol_columns_host.argtypes = [i64] * 4
    lib.zf_symbol_columns_host.restype = i64
    lib.zf_sym_division_faults.argtypes = [i64, i64, ctypes.POINTER(i64)]
    lib.zf_sym_division_faults.restype = i64

    def run(plan, frame_numbers, hstatic, B, max_rice_order, lpc_order, lpc_precision):
        err, out = tsym.launch(lib.zf_frame_symbols_host, plan, frame_numbers, hstatic, B,
                               max_rice_order, lpc_order, lpc_precision, None)
        assert err == 0
        return out

    run.lib = lib
    return run


def _plain(plan, fns, hs, B, mro, lpc_order, prec):
    d, tb, v, nb = tbp.frame_symbol_stream(plan, fns, hs, B, mro, lpc_order, prec)
    return d.to(torch.int32), tb, v, nb.to(torch.int32)


def _assert_equal(got, want):
    for g, w, name in zip(got, want, ("dep_cum", "total_bits", "val", "nbv")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if not torch.equal(g, w):
            at = (g != w).nonzero()[0].tolist()
            raise AssertionError(f"{name} differs first at {at}: {g[tuple(at)]} != "
                                 f"{w[tuple(at)]}")


def _check(host, plan, fns, hs, B, mro=8, lpc_order=0, prec=15):
    got = host(plan, fns, hs, B, mro, lpc_order, prec)
    _assert_equal(got, _plain(plan, fns, hs, B, mro, lpc_order, prec))
    assert got[0].shape[1] == tsym.symbol_columns(plan.kind.shape[0], B, mro, lpc_order)
    return got


@pytest.mark.parametrize("n,w,B,mro,lpc_order,depth,side,wasted", WATCH,
                         ids=[f"B{c[2]}_w{c[1]}_mro{c[3]}_lpc{c[4]}_d{c[5]}" for c in WATCH])
def test_synthetic_plans(host, n, w, B, mro, lpc_order, depth, side, wasted):
    """Every subframe kind, escapes, the N1 fallback and impulses, on the
    watch list's blocks, channel counts, partition orders, LPC orders and
    depths (33-bit side planes in int64), with every frame-number length,
    channel code and an uncommon rate."""
    rng = np.random.default_rng(B * 31 + w * 7 + mro + lpc_order + depth)
    plan = synthetic_plan(rng, n, w, B, mro, lpc_order, depth, side, wasted)
    fns = torch.tensor([FRAME_NUMBERS[(i * 3) % len(FRAME_NUMBERS)] for i in range(n)])
    hs = header_static(B, RATES[B % len(RATES)], depth)
    _check(host, plan, fns, hs, B, mro, lpc_order)


def test_escape_fallback_and_long_codes(host):
    """Under 4-bit params an escape partition of bps 32 writes the value 30
    in 4 bits (N1, unmasked), a live escape (param << 5) | bps in 9 bits,
    and one Rice code is over 256 bits; the frames' sums pass 2^32, so
    dep_cum wraps as the plain version's int32."""
    # frame 0, channel 0: fixed order 0, one partition, param 0, and the two
    # residuals of the widest zigzag: two codes of ~2^32 bits
    plan = long_code_plan(256, 0)
    hs = header_static(256, 44100, 16)
    dep_cum, total, val, nbv = _check(host, plan, torch.arange(16), hs, 256, 2)
    widths = torch.diff(dep_cum.to(torch.int64), dim=1) % (1 << 32)
    assert (nbv[nbv > 0] <= 33).all()
    assert ((val == 30) & (nbv == 4)).any()            # N1: 30 in a 4-bit field
    assert ((nbv == 9) & ((val & 31) > 0)).any()        # a live escape param
    assert (widths > 256).any() and (total >= 1 << 32).any()


@pytest.mark.parametrize("b,at", LONG_CODES[1:], ids=["across_warps", "across_tiles"])
def test_long_codes_across_warps_and_tiles(host, b, at):
    """The two ~2^32-bit codes in frame columns 127 and 128 (the last of warp
    0's run and the first of warp 1's) and 1023 and 1024 (the last of the
    first tile and the first of the next): the 32-bit scan carries them
    across the warps' totals and the tiles' carry, the 64-bit total holds
    them whole."""
    plan = long_code_plan(b, at)
    dep_cum, total, _, nbv = _check(host, plan, torch.arange(16), header_static(b, 44100, 16),
                                    b, 2)
    widths = torch.diff(dep_cum[0].to(torch.int64)) % (1 << 32)
    col = 16 + 7 + at + at // (b >> 2) + 1  # sample at's column (G = b / 4)
    # widths 2^32 and 2^32 - 1 (zigzags 2^32 - 1 and 2^32 - 2, param 0), mod 2^32
    assert (int(widths[col - 1]), int(widths[col])) == (0, (1 << 32) - 1)
    assert int(total[0]) >= (1 << 33) - 1
    assert int(nbv[0, col]) == int(nbv[0, col + 1]) == 1


def test_division_by_multiply(host):
    """zf_sym_div (the high word of q * ceil(2^k / d), shifted by k - 32)
    equals q // d for every quotient
    the kernel takes, on every block of 1 to 65,535 samples and every top
    partition order (every max_rice_order), LPC orders 0-32, 8 channels:
    samples by G, residual sections by G + 1, frame columns by the channel's
    columns; checked at both ends of each quotient, which bound every q
    between (the product grows with q)."""
    checked = ctypes.c_int64()
    assert host.lib.zf_sym_division_faults(1, 65535, ctypes.byref(checked)) == 0
    assert checked.value > 60_000_000


def test_n1_smallest_input(host):
    """ROADMAP's N1 case: mono 32-bit, block 5, max_rice_param 14."""
    x = np.array([[[20307570, 660849485, -1463004301, -295378865, 1646815274]]], np.int32)
    cfg = EncoderConfig(block_size=5, channels=1, max_rice_param=14)
    plan = tan.plan_frames(torch.from_numpy(x), 32, cfg)
    _, _, val, nbv = _check(host, plan, torch.arange(1), header_static(5, 44100, 32), 5, 8, 0, 14)
    assert ((val == 30) & (nbv == 4)).any()  # the escape's fallback param


def test_headers(host):
    """Every frame-number length and channel code, with and without
    uncommon block-size and rate tail bytes: the header columns equal the
    JAX package's build_headers (bytes, CRC-8 last) and the port's."""
    for B, rate in ((4096, 44100), (1000, 22050), (37, 12345), (192, 100), (4608, 700000),
                    (65535, 96000), (4096, 0)):
        n = len(FRAME_NUMBERS)
        plan = synthetic_plan(np.random.default_rng(B), n, 1, 64, 0)
        fns = np.array(FRAME_NUMBERS, np.int64)
        codes = np.arange(n) % 11
        plan = plan._replace(channels_code=torch.from_numpy(codes))
        static = header_static(B, rate, 16)
        got = _check(host, plan, torch.from_numpy(fns), static, 64, 0)
        jb, jl = jhd.build_headers(jnp.asarray(fns), jnp.asarray(codes.astype(np.int32)), static)
        jb, jl = np.asarray(jb), np.asarray(jl)
        live = np.arange(16)[None, :] < jl[:, None]
        np.testing.assert_array_equal(got[1].numpy() >= 8 * jl, True)
        np.testing.assert_array_equal(got[2][:, :16].numpy(), np.where(live, jb, 0))
        np.testing.assert_array_equal(got[3][:, :16].numpy(), np.where(live, 8, 0))


def test_layout_matches_the_plain_version(host):
    lib = host.lib
    for w, B, mro, lpc in ((2, 4096, 8, 0), (1, 1, 8, 0), (8, 65535, 8, 32), (2, 2304, 12, 8),
                           (3, 3, 0, 12), (2, 4096, 8, 8)):
        assert lib.zf_symbol_columns_host(w, B, mro, lpc) == tsym.symbol_columns(w, B, mro, lpc)
    assert tsym.symbol_columns(2, 4096, 8, 0) == 8734
    assert tsym.symbol_columns(2, 4096, 8, 8) == 8760


# -- real plans: the analysis's, against the plain version and the JAX package


def _signal_plan(rng, B, channels, depth, cfg, n=6):
    kinds = ("silence", "constant", "sine", "noise", "extreme", "mixed", "quiet_noise")
    shift = 2 if cfg.wasted_bits else 0
    frames = np.stack([make_signal(rng, B, channels, depth - shift, kind=kinds[i % len(kinds)])
                       .astype(np.int64) << shift for i in range(n)]).astype(np.int32)
    return tan.plan_frames(torch.from_numpy(frames), depth, cfg)


@lru_cache(maxsize=None)
def _jax_symbols(B, depth, rate, lpc_order, lpc_precision):
    hstatic = jhd.header_static(B, rate, depth)

    def run(plan, fns):
        d, tb, vparts, nbv = jbp.frame_symbol_stream(plan, fns, hstatic, B, 8,
                                                     lpc_order=lpc_order,
                                                     lpc_precision=lpc_precision)
        return d, tb, jnp.concatenate([v.astype(jnp.uint64) for v in vparts], 1), nbv

    return jax.jit(run)


REAL = [
    (4096, 2, 16, dict()),
    (1152, 1, 8, dict(channels=1, block_size=1152)),
    (1024, 3, 12, dict(channels=3, block_size=1024, wasted_bits=True)),
    (1024, 2, 20, dict(block_size=1024, prediction="lpc", lpc_order=32, lpc_precision=15)),
    (1024, 2, 32, dict(block_size=1024, prediction="lpc", lpc_order=12, wasted_bits=True)),
    (1024, 8, 24, dict(channels=8, block_size=1024, max_rice_param=14)),
]


@pytest.mark.parametrize("B,channels,depth,fields", REAL,
                         ids=[f"B{c[0]}_ch{c[1]}_d{c[2]}_{c[3].get('prediction', 'fixed')}"
                              for c in REAL])
def test_real_plans_equal_plain_and_jax(host, B, channels, depth, fields):
    """The analysis's plans (depths 8-32, 1-8 channels and stereo_auto, fixed
    and LPC, wasted bits, 4-bit params) through the harness, the plain
    version and the JAX package's frame_symbol_stream."""
    rng = np.random.default_rng(B + channels + depth)
    cfg = EncoderConfig(**fields)
    plan = _signal_plan(rng, B, channels, depth, cfg)
    fns = np.array(FRAME_NUMBERS[: plan.kind.shape[1]], np.int64)
    lpc_order = tan.lpc_order_of(cfg)
    got = _check(host, plan, torch.from_numpy(fns), header_static(B, 44100, depth), B, 8,
                 lpc_order, cfg.lpc_precision)
    want = _jax_symbols(B, depth, 44100, lpc_order, cfg.lpc_precision)(_jax_plan_of(plan),
                                                                       jnp.asarray(fns))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_synthetic_plan_equals_jax(host):
    """A synthetic plan with escapes, the N1 fallback and impulses, through
    the JAX package too. Its frames stay under 2^24 bits, the limit of the
    JAX package's float32 prefix sum (_cumsum_bits_exact), which no frame of
    a real encode reaches."""
    rng = np.random.default_rng(0x1A)
    plan = synthetic_plan(rng, 6, 2, 1024, 8, 8, 24, side=True, wasted=True,
                          impulses=(1 << 13,))
    fns = np.array(FRAME_NUMBERS[:6], np.int64)
    got = _check(host, plan, torch.from_numpy(fns), header_static(1024, 44100, 24), 1024, 8,
                 8, 15)
    assert int(got[1].max()) < 1 << 24
    want = _jax_symbols(1024, 24, 44100, 8, 15)(_jax_plan_of(plan), jnp.asarray(fns))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_planes_read_through_their_strides(host):
    """A plan whose planes and residuals are views (independent channels'
    planes are): the harness reads them through their strides."""
    rng = np.random.default_rng(3)
    plan = synthetic_plan(rng, 4, 3, 64, 8)
    planes = plan.planes.transpose(0, 1).contiguous().transpose(0, 1)
    res = plan.residuals.transpose(0, 1).contiguous().transpose(0, 1)
    assert not planes.is_contiguous()
    got = host(plan._replace(planes=planes, residuals=res), torch.arange(4),
               header_static(64, 44100, 16), 64, 8, 0, 15)
    _assert_equal(got, _plain(plan, torch.arange(4), header_static(64, 44100, 16), 64, 8, 0, 15))


# -- the wrapper ------------------------------------------------------------------


def test_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(4)
    plan = synthetic_plan(rng, 3, 2, 64, 8)
    hs = header_static(64, 44100, 16)
    tsym.reset_counts()
    got = tsym.frame_symbols(plan, torch.arange(3, dtype=torch.int32), hs, 64, 8, 0, 15)
    _assert_equal(got, _plain(plan, torch.arange(3), hs, 64, 8, 0, 15))
    assert (tsym.KERNEL_LAUNCHES, tsym.PLAIN_CALLS) == (0, 1)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(5)
    plan = synthetic_plan(rng, 3, 2, 64, 8)
    hs = header_static(64, 44100, 16)
    fns = torch.arange(3)
    bad = [
        ((plan._replace(params=plan.params[..., :128]), fns, hs, 64), ValueError),
        ((plan._replace(kind=plan.kind.to(torch.int32)), fns, hs, 64), TypeError),
        ((plan._replace(residuals=plan.residuals.to(torch.int64)), fns, hs, 64), TypeError),
        ((plan._replace(planes=plan.planes.to(torch.int16)), fns, hs, 64), TypeError),
        ((plan, fns[:2], hs, 64), ValueError),
        ((plan, fns, hs, 32), ValueError),
        ((plan, fns, hs._replace(tail_bytes=[1, 2, 3, 4, 5]), 64), ValueError),
        ((synthetic_plan(rng, 3, 9, 64, 8), fns, hs, 64), ValueError),
        ((tan.FrameWirePlan(*(t.to("meta") for t in plan)), fns.to("meta"), hs, 64),
         NotImplementedError),
    ]
    for args, exc in bad:
        with pytest.raises(exc):
            tsym.frame_symbols(*args, 8, 0, 15)
    # more than 256 grid groups (po_top 9), as the analysis refuses them
    plan = synthetic_plan(rng, 3, 2, 512, 8)
    with pytest.raises(ValueError, match="partition order 9"):
        tsym.frame_symbols(plan, fns, header_static(512, 44100, 16), 512, 9, 0, 15)


# -- whole encodes with the harness in the kernel's place ----------------------------


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_corpus_streams_through_the_harness(host, monkeypatch, name):
    """Every pinned corpus stream (the JAX package's bytes) with the symbols
    harness in the kernel's place: pack_frames takes it for every batch and
    tail."""
    case = next(c for c in CASES if c["name"] == name)
    calls = []

    def frame_symbols(*args):
        calls.append(1)
        return host(*args)

    monkeypatch.setattr(tsym, "frame_symbols", frame_symbols)
    flac = zigflac_tpu_torch.encode_wav_bytes(
        _wav_bytes(case), config=EncoderConfig(**asdict(_case_config(case))), device="cpu")
    with open(os.path.join(VEC_DIR, name + ".flac"), "rb") as f:
        assert hashlib.sha256(flac).digest() == hashlib.sha256(f.read()).digest()
    assert calls
