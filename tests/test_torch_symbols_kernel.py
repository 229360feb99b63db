"""The frame symbols kernel's arithmetic (zigflac_tpu_torch/csrc/symbols_steps.cuh)
built for the host with g++, behind a loop that runs csrc/symbols.cu's block
(the header, then each wire channel's partition keys and columns in turn,
the widths summed in 64 bits) one frame after another, called through the
wrapper's own argument marshalling (ops/symbols.launch). It is held
against the port's plain version (bitpack.frame_symbol_stream) and the JAX
package's (ops/bitpack.frame_symbol_stream) on plans made from a seed with
numpy, synthetic and real: escapes, the N1 fallback, Rice codes of
thousands of bits, 32-bit stream ends, every frame-number length, uncommon
rates and block sizes, blocks of 1 to 65,535 samples, 1-8 channels, LPC
orders 1-32 and the 33-bit side plane; then the wrapper's routing and
checks, and all 22 pinned corpus encodes with the harness in the kernel's
place.

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
from chip_smoke import (SYMBOL_FRAME_NUMBERS as FRAME_NUMBERS, SYMBOL_RATES as RATES,  # noqa: E402
                        SYMBOL_WATCH as WATCH, synthetic_plan)

# csrc/symbols.cu's block with its work done in order: the header, then per
# channel the largest key of each partition and the columns, the running
# 64-bit sum stored in its low 32 bits. Same C signature as zf_frame_symbols.
HOST_HARNESS = r"""
#include "symbols_steps.cuh"

static constexpr ZfCrc8Table kCrc8 = zf_crc8_make_table();

template <typename T>
static void frames(const int64_t* fns, const int64_t* codes, const int64_t* const* fld,
                   const int64_t* params, const int64_t* qcoeffs, const T* planes, int64_t pl_w,
                   int64_t pl_n, int64_t pl_b, const int32_t* res, int64_t rs_w, int64_t rs_n,
                   int64_t rs_b, int64_t n, const ZfSymLayout& L, const ZfSymHeaderStatic& hs,
                   int32_t* dep_cum, int64_t* val, int32_t* nbv, int64_t* total_bits) {
  for (int64_t f = 0; f < n; ++f) {
    int64_t sum = 0;
    auto put = [&](int64_t col, const ZfSym& s) {
      sum += s.nb;
      dep_cum[f * L.s + col] = (int32_t)(uint32_t)(uint64_t)sum;
      val[f * L.s + col] = s.val;
      nbv[f * L.s + col] = s.nbv;
    };
    const ZfSymHeader h = zf_sym_header(fns[f], codes[f], hs, kCrc8);
    for (int64_t j = 0; j < kZfSymHeaderCols; ++j) put(j, zf_sym_header_column(h, j));
    for (int64_t c = 0; c < L.w; ++c) {
      const int64_t wn = c * n + f;
      const ZfSymChannel ch = {fld[0][wn], fld[1][wn], fld[2][wn], fld[3][wn],
                               fld[4][wn], fld[5][wn], fld[6][wn]};
      const T* plane = planes + c * pl_w + f * pl_n;
      const int32_t* r = res + c * rs_w + f * rs_n;
      uint32_t keys[kZfSymParamCols] = {};
      const uint32_t psize = (uint32_t)(L.b >> ch.part_order);
      if (zf_sym_pred(ch) && psize > 0)
        for (int64_t i = 0; i < L.b; ++i) {
          const uint32_t p = (uint32_t)i / psize, k = zf_sym_key(r[i * rs_b]);
          keys[p] = k > keys[p] ? k : keys[p];
        }
      for (int64_t col = 0; col < L.chan_cols; ++col)
        put(kZfSymHeaderCols + c * L.chan_cols + col,
            zf_sym_column(L, ch, col, plane, pl_b, r, rs_b, params + wn * kZfSymParamCols,
                          qcoeffs + wn * kZfSymCoeffCols, keys));
    }
    total_bits[f] = sum;
  }
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
  const ZfSymLayout L = zf_sym_layout(w, b, max_rice_order, lpc_order, lpc_precision);
  const ZfSymHeaderStatic hs = {byte2, depth_code, tail, ntail};
  const int64_t* fld[7] = {(const int64_t*)kind, (const int64_t*)order,
                           (const int64_t*)method, (const int64_t*)part_order,
                           (const int64_t*)sample_size, (const int64_t*)qshift,
                           (const int64_t*)wasted};
  if (planes_wide)
    frames((const int64_t*)frame_numbers, (const int64_t*)channels_code, fld,
           (const int64_t*)params, (const int64_t*)qcoeffs, (const int64_t*)planes, pl_w, pl_n,
           pl_b, (const int32_t*)residuals, rs_w, rs_n, rs_b, n, L, hs, (int32_t*)dep_cum,
           (int64_t*)val, (int32_t*)nbv, (int64_t*)total_bits);
  else
    frames((const int64_t*)frame_numbers, (const int64_t*)channels_code, fld,
           (const int64_t*)params, (const int64_t*)qcoeffs, (const int32_t*)planes, pl_w, pl_n,
           pl_b, (const int32_t*)residuals, rs_w, rs_n, rs_b, n, L, hs, (int32_t*)dep_cum,
           (int64_t*)val, (int32_t*)nbv, (int64_t*)total_bits);
  return 0;
}

extern "C" int64_t zf_symbol_columns_host(int64_t w, int64_t b, int64_t mro, int64_t lpc_order) {
  return zf_sym_layout(w, b, mro, lpc_order, 0).s;
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
    rng = np.random.default_rng(0x5E)
    plan = synthetic_plan(rng, 16, 2, 256, 2, methods=(0,))
    # frame 0, channel 0: fixed order 0, one partition, param 0, and the two
    # residuals of the widest zigzag: two codes of ~2^32 bits
    for name, v in (("kind", 2), ("order", 0), ("method", 0), ("part_order", 0)):
        getattr(plan, name)[0, 0] = v
    plan.params[0, 0, 0] = 0
    plan.residuals[0, 0, :2] = torch.tensor([-(1 << 31), (1 << 31) - 1], dtype=torch.int32)
    hs = header_static(256, 44100, 16)
    dep_cum, total, val, nbv = _check(host, plan, torch.arange(16), hs, 256, 2)
    widths = torch.diff(dep_cum.to(torch.int64), dim=1) % (1 << 32)
    assert (nbv[nbv > 0] <= 33).all()
    assert ((val == 30) & (nbv == 4)).any()            # N1: 30 in a 4-bit field
    assert ((nbv == 9) & ((val & 31) > 0)).any()        # a live escape param
    assert (widths > 256).any() and (total >= 1 << 32).any()


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
        ((tan.FrameWirePlan(*(t.to("meta") for t in plan)), fns.to("meta"), hs, 64),
         NotImplementedError),
    ]
    for args, exc in bad:
        with pytest.raises(exc):
            tsym.frame_symbols(*args, 8, 0, 15)


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
