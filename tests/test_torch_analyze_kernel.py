"""The analysis kernel's arithmetic (zigflac_tpu_torch/csrc/analyze_steps.cuh)
built for the host with g++, behind a loop that runs csrc/analyze.cu's block
(256 threads, pass 1, pass 2, the pyramid, the level sweep) one thread after
another. It is held against the port's plain versions (best_fixed_order,
residuals_for_order, rice_estimate) and the JAX package's functions on the
same numpy inputs made from a seed; then the kernel wrappers' routing and
checks, and whole encodes with the harness in the kernel's place.

Tolerance: exact equality. Every output is an integer."""

import ctypes
import hashlib
import io
import os
import shutil
import subprocess
from dataclasses import asdict
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import zigflac_tpu
import zigflac_tpu_torch
from conftest import make_signal
from test_regression_corpus import CASES, VEC_DIR, _case_config, _wav_bytes
from zigflac_tpu.ops import analyze as jan
from zigflac_tpu.utils.config import EncoderConfig as JaxConfig
from zigflac_tpu.wav import write_wav
from zigflac_tpu_torch import EncoderConfig
from zigflac_tpu_torch.ops import analyze as tan

CSRC = Path(__file__).resolve().parent.parent / "zigflac_tpu_torch" / "csrc"
U64_MAX = (1 << 64) - 1
I64_MAX = (1 << 63) - 1

# csrc/analyze.cu's block with its threads run in turn, through the same
# analyze_steps.cuh helpers: each warp's runs of kZfRun samples with their
# predecessors, the warp's narrow/wide choice, each thread's run in pass 1
# and pass 2 (the split sums or the pieces of a run), then the pyramid and
# every node's Rice param; the Rice entry's runs of residuals with their
# split sums or pieces, without the order search. The kernel sums a warp's
# lanes of one partition or one level before it adds them; the sums are the
# same. stats counts, per call: warps in the narrow arithmetic, all warps.
HOST_HARNESS = r"""
#include <algorithm>
#include <vector>
#include "analyze_steps.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kTile = kThreads * kZfRun;

void rice_sweep(std::vector<uint64_t>& pyr, int b, int po_top, int64_t order, int max_param,
                int64_t* bits, int64_t* method, int64_t* part_order, int64_t* params) {
  for (int s = 1; s <= 5 && s <= po_top; ++s) {  // the kernel's shuffle levels
    const int po = po_top - s;
    for (int j = 0; j < (1 << po); ++j)
      pyr[zf_level_offset(po) + j] =
          pyr[zf_level_offset(po + 1) + 2 * j] + pyr[zf_level_offset(po + 1) + 2 * j + 1];
  }
  const int nodes = zf_nodes(po_top), l5 = po_top - 5;
  std::vector<uint8_t> kbest(nodes);
  ZfLevelAcc lv[kZfMaxPartOrder + 1] = {};
  for (int n = 0; n < nodes; ++n) {
    const int po = zf_ilog2(n + 1), j = n + 1 - (1 << po);
    uint64_t s = 0;
    if (po >= l5) {
      s = pyr[n];
    } else {
      const int w = 1 << (l5 - po);
      for (int m = 0; m < w; ++m) s += pyr[zf_level_offset(l5) + j * w + m];
    }
    int k;
    int64_t bc;
    zf_rice_node((int64_t)s, zf_node_psz(b, po, j, order), max_param, &k, &bc);
    kbest[n] = (uint8_t)k;
    zf_level_acc_add(lv[po], k, bc);
  }
  const int dyn = zf_dyn_max_po(order, b, po_top);
  int methods[kZfMaxPartOrder + 1];
  int64_t totals[kZfMaxPartOrder + 1];
  uint32_t key = ~0u;
  for (int po = 0; po <= po_top; ++po) {
    zf_level_total(lv[po], po, dyn, max_param, &methods[po], &totals[po]);
    key = std::min(key, zf_part_order_key(totals[po], po));
  }
  const int best = zf_part_order_of_key(key);
  *bits = totals[best];
  *method = methods[best];
  *part_order = best;
  for (int j = 0; j < kZfParamCols; ++j)
    params[j] = j < (1 << best) ? kbest[zf_level_offset(best) + j] : 0;
}

// A warp's 32 runs of one tile and the warp's narrow/wide choice.
template <typename T>
bool load_warp(const T* x, int b, int base, T (&v)[32][kZfRun], T (&p)[32][4]) {
  uint32_t m = 0;
  for (int l = 0; l < 32; ++l) {
    for (int r = 0; r < kZfRun; ++r) {
      const int i = base + l * kZfRun + r;
      v[l][r] = i < b ? x[i] : T(0);
    }
    for (int q = 0; q < 4; ++q) {
      const int i = base + l * kZfRun - 1 - q;
      p[l][q] = i >= 0 && i < b ? x[i] : T(0);
    }
    if (sizeof(T) == 4) {
      for (int r = 0; r < kZfRun; ++r) m = std::max(m, zf_abs_u32((int32_t)v[l][r]));
      for (int q = 0; q < 4; ++q) m = std::max(m, zf_abs_u32((int32_t)p[l][q]));
    }
  }
  return sizeof(T) == 4 && zf_narrow_ok(m);
}

template <typename T>
void pass1_run(const T (&v)[kZfRun], const T (&p)[4], int start, int b, bool narrow, T first,
               ZfFixedAcc& acc) {
  if (start >= b) return;
  const bool masked = start < 4 || start + kZfRun > b;
  if (narrow) {
    int32_t v32[kZfRun], p32[4];
    for (int r = 0; r < kZfRun; ++r) v32[r] = (int32_t)v[r];
    for (int q = 0; q < 4; ++q) p32[q] = (int32_t)p[q];
    if (masked) zf_run_fixed_narrow<kZfRun, true>(v32, p32, start, b, (int32_t)first, acc);
    else zf_run_fixed_narrow<kZfRun, false>(v32, p32, start, b, (int32_t)first, acc);
  } else if (masked) {
    zf_run_fixed_wide<kZfRun, true>(v, p, start, b, (int64_t)first, acc);
  } else {
    zf_run_fixed_wide<kZfRun, false>(v, p, start, b, (int64_t)first, acc);
  }
}

// A run's zigzag sums into the top-level partitions: split at the
// partition boundary where partitions hold at least a run (32-bit sums for
// a narrow warp), else piece by piece.
void add_run_sums(const int32_t (&r)[kZfRun], int start, bool narrow, uint64_t* top, int psz) {
  if (psz >= kZfRun) {
    const int key = start / psz;
    const int split = std::min((key + 1) * psz - start, kZfRun);
    uint64_t a, c;
    if (narrow) {
      uint32_t a32, c32;
      zf_run_split_sums<uint32_t>(r, split, &a32, &c32);
      a = a32;
      c = c32;
    } else {
      zf_run_split_sums<uint64_t>(r, split, &a, &c);
    }
    if (a) top[key] += a;
    if (c) top[key + 1] += c;
  } else {
    zf_run_pieces(r, start, psz, [&](int key, uint64_t s) {
      if (s) top[key] += s;
    });
  }
}

template <typename T>
void pass2_run(const T (&v)[kZfRun], const T (&p)[4], int start, int b, bool narrow, int order,
               int32_t* res, uint64_t* top, int psz) {
  int32_t r[kZfRun];
  const bool masked = start < 4 || start + kZfRun > b;
  if (narrow) {
    if (masked) zf_run_residual<int32_t, kZfRun, true>(v, p, start, b, order, r);
    else zf_run_residual<int32_t, kZfRun, false>(v, p, start, b, order, r);
  } else {
    if (masked) zf_run_residual<uint64_t, kZfRun, true>(v, p, start, b, order, r);
    else zf_run_residual<uint64_t, kZfRun, false>(v, p, start, b, order, r);
  }
  if (start >= b) return;
  for (int q = 0; q < kZfRun && start + q < b; ++q) res[start + q] = r[q];
  add_run_sums(r, start, narrow, top, psz);
}

template <typename T>
void analyze_fixed(const T* planes, int64_t np, int b, bool wide, int po_top, int max_param,
                   int64_t* order, uint8_t* ok, int32_t* residuals, int64_t* bits,
                   int64_t* method, int64_t* part_order, int64_t* params, uint8_t* all_eq,
                   int64_t* stats) {
  std::vector<uint64_t> pyr(zf_nodes(po_top));
  T v[32][kZfRun], p[32][4];
  const int ntiles = (b + kTile - 1) / kTile, psz = b >> po_top;
  for (int64_t q = 0; q < np; ++q) {
    const T* x = planes + q * b;
    ZfFixedAcc all;
    zf_fixed_acc_init(all);
    for (int tile = 0; tile < ntiles; ++tile) {
      for (int w = 0; w < kThreads / 32; ++w) {
        const int base = tile * kTile + w * 32 * kZfRun;
        const bool narrow = load_warp(x, b, base, v, p);
        stats[0] += narrow;
        stats[1] += 1;
        for (int l = 0; l < 32; ++l) {
          ZfFixedAcc acc;
          zf_fixed_acc_init(acc);
          pass1_run(v[l], p[l], base + l * kZfRun, b, narrow, x[0], acc);
          zf_fixed_acc_merge(all, acc);
        }
      }
    }
    int o;
    bool usable;
    zf_choose_fixed_order(all, wide, &o, &usable);
    std::fill(pyr.begin(), pyr.end(), 0);
    uint64_t* top = pyr.data() + zf_level_offset(po_top);
    for (int tile = 0; tile < ntiles; ++tile) {
      for (int w = 0; w < kThreads / 32; ++w) {
        const int base = tile * kTile + w * 32 * kZfRun;
        const bool narrow = load_warp(x, b, base, v, p);
        for (int l = 0; l < 32; ++l)
          pass2_run(v[l], p[l], base + l * kZfRun, b, narrow, o, residuals + q * b, top, psz);
      }
    }
    rice_sweep(pyr, b, po_top, o, max_param, bits + q, method + q, part_order + q,
               params + q * kZfParamCols);
    order[q] = o;
    ok[q] = usable;
    all_eq[q] = all.all_eq;
  }
}
}  // namespace

extern "C" void zf_analyze_fixed_host(const void* planes, int planes_i64, int64_t p, int64_t b,
                                      int wide, int64_t max_rice_order, int64_t max_param,
                                      int64_t* order, uint8_t* ok, int32_t* residuals,
                                      int64_t* bits, int64_t* method, int64_t* part_order,
                                      int64_t* params, uint8_t* all_eq, int64_t* stats) {
  const int po_top = zf_po_top(b, (int)max_rice_order);
  if (planes_i64)
    analyze_fixed((const int64_t*)planes, p, (int)b, wide != 0, po_top, (int)max_param, order,
                  ok, residuals, bits, method, part_order, params, all_eq, stats);
  else
    analyze_fixed((const int32_t*)planes, p, (int)b, wide != 0, po_top, (int)max_param, order,
                  ok, residuals, bits, method, part_order, params, all_eq, stats);
}

extern "C" void zf_rice_estimate_host(const int32_t* residuals, const int64_t* order, int64_t p,
                                      int64_t b, int64_t max_rice_order, int64_t max_param,
                                      int64_t* bits, int64_t* method, int64_t* part_order,
                                      int64_t* params) {
  const int po_top = zf_po_top(b, (int)max_rice_order);
  const int ntiles = (int)((b + kTile - 1) / kTile), psz = (int)(b >> po_top);
  std::vector<uint64_t> pyr(zf_nodes(po_top));
  for (int64_t q = 0; q < p; ++q) {
    std::fill(pyr.begin(), pyr.end(), 0);
    uint64_t* top = pyr.data() + zf_level_offset(po_top);
    const int32_t* x = residuals + q * b;
    for (int tile = 0; tile < ntiles; ++tile) {
      for (int t = 0; t < kThreads; ++t) {
        const int start = tile * kTile + t * kZfRun;
        if (start >= b) continue;
        int32_t r[kZfRun];
        for (int i = 0; i < kZfRun; ++i) r[i] = start + i < b ? x[start + i] : 0;
        add_run_sums(r, start, false, top, psz);
      }
    }
    rice_sweep(pyr, (int)b, po_top, order[q], (int)max_param, bits + q, method + q,
               part_order + q, params + q * kZfParamCols);
  }
}

extern "C" void zf_rice_node_host(const int64_t* s, const int64_t* psz, const int32_t* max_param,
                                  int64_t n, int32_t* k, int64_t* bc) {
  for (int64_t i = 0; i < n; ++i) zf_rice_node(s[i], psz[i], max_param[i], &k[i], &bc[i]);
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """analyze_steps.cuh built for the host with g++ behind the kernel's
    block loop. Returns an object with the two kernels' entry points on
    numpy arrays, giving torch tensors as the wrappers do."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel's arithmetic cannot be built on the host")
    d = tmp_path_factory.mktemp("analyze_host")
    (d / "host.cpp").write_text(HOST_HARNESS)
    so = d / "host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-Wno-unknown-pragmas", "-shared",
         "-fPIC", "-I", str(CSRC),
         "-o", str(so), str(d / "host.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.zf_analyze_fixed_host.argtypes = [ptr, i32, i64, i64, i32, i64, i64] + [ptr] * 9
    lib.zf_rice_estimate_host.argtypes = [ptr, ptr, i64, i64, i64, i64] + [ptr] * 4
    lib.zf_rice_node_host.argtypes = [ptr, ptr, ptr, i64, ptr, ptr]

    class Host:
        # analyze_fixed's last call: warps in the narrow arithmetic, warps
        stats = None

        @staticmethod
        def analyze_fixed(planes, wide, max_rice_order, max_param):
            x = np.ascontiguousarray(planes)
            assert x.dtype in (np.int32, np.int64)
            *batch, b = x.shape
            p = int(np.prod(batch, dtype=np.int64))
            out = [np.empty(p, np.int64), np.empty(p, np.uint8), np.empty((p, b), np.int32)]
            out += [np.empty(p, np.int64) for _ in range(3)]
            out += [np.empty((p, 256), np.int64), np.empty(p, np.uint8)]
            Host.stats = np.zeros(2, np.int64)
            lib.zf_analyze_fixed_host(x.ctypes.data, x.dtype == np.int64, p, b, bool(wide),
                                      max_rice_order, max_param, *(o.ctypes.data for o in out),
                                      Host.stats.ctypes.data)
            shapes = [batch, batch, batch + [b], batch, batch, batch, batch + [256], batch]
            t = [torch.from_numpy(o.reshape(s)) for o, s in zip(out, shapes)]
            t[1], t[7] = t[1].bool(), t[7].bool()
            return tan.FixedAnalysis(*t)

        @staticmethod
        def rice(residuals, order, max_rice_order, max_param):
            r = np.ascontiguousarray(residuals, np.int32)
            o = np.ascontiguousarray(order, np.int64)
            *batch, b = r.shape
            p = int(np.prod(batch, dtype=np.int64))
            out = [np.empty(p, np.int64) for _ in range(3)] + [np.empty((p, 256), np.int64)]
            lib.zf_rice_estimate_host(r.ctypes.data, o.ctypes.data, p, b, max_rice_order,
                                      max_param, *(x.ctypes.data for x in out))
            shapes = [batch, batch, batch, batch + [256]]
            return tuple(torch.from_numpy(x.reshape(s)) for x, s in zip(out, shapes))

        @staticmethod
        def rice_node(s, psz, max_param):
            s, psz = np.ascontiguousarray(s, np.int64), np.ascontiguousarray(psz, np.int64)
            mp = np.ascontiguousarray(max_param, np.int32)
            k, bc = np.empty(s.size, np.int32), np.empty(s.size, np.int64)
            lib.zf_rice_node_host(s.ctypes.data, psz.ctypes.data, mp.ctypes.data, s.size,
                                  k.ctypes.data, bc.ctypes.data)
            return k, bc

    return Host


def _jax_u64(x):
    """A JAX u64 cost as the port carries it: u64::MAX is I64_MAX."""
    x = np.asarray(x).astype(np.uint64)
    return np.where(x == np.uint64(U64_MAX), I64_MAX, x.astype(np.int64))


def _check_fixed(host, planes, wide, max_rice_order=8, max_param=30, jax_too=True):
    """Harness == plain, field by field; and == the JAX functions."""
    got = host.analyze_fixed(planes, wide, max_rice_order, max_param)
    want = tan.analyze_fixed_plain(torch.from_numpy(planes), wide, max_rice_order, max_param)
    for name in tan.FixedAnalysis._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name).numpy(),
                                      err_msg=name)
    if jax_too:
        B = planes.shape[-1]
        j_order, j_ok, _ = jan.best_fixed_order(planes, wide)
        j_res = jan.residuals_for_order(planes, j_order)
        j_bits, j_method, j_po, j_params, _ = jan.rice_estimate(
            j_res, j_order, B, max_rice_order, max_param)
        for name, w in (("order", j_order), ("ok", j_ok), ("residuals", j_res),
                        ("bits", _jax_u64(j_bits)), ("method", j_method),
                        ("part_order", j_po), ("params", j_params)):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(w).astype(getattr(got, name).numpy().dtype),
                                          err_msg=f"jax {name}")
    return got


def _check_rice(host, residuals, order, max_rice_order=8, max_param=30, jax_too=True):
    got = host.rice(residuals, order, max_rice_order, max_param)
    B = residuals.shape[-1]
    want = tan.rice_estimate(torch.from_numpy(residuals), torch.from_numpy(order), B,
                             max_rice_order, max_param)
    for name, g, w in zip(("bits", "method", "part_order", "params"), got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    if jax_too:
        jw = jan.rice_estimate(residuals, order.astype(np.int32), B, max_rice_order, max_param)
        for name, g, w in zip(("bits", "method", "part_order", "params"), got,
                              (_jax_u64(jw[0]), *jw[1:4])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64),
                                          err_msg=f"jax {name}")
    return got


KINDS = ("silence", "constant", "sine", "noise", "alternating", "extreme", "mixed", "ramp",
         "quiet_noise")


def _planes(rng, B, depth, per_kind=1):
    return np.concatenate([make_signal(rng, B, channels=per_kind, depth=depth, kind=k)
                           for k in KINDS])


@pytest.mark.parametrize("depth", [8, 16, 24, 28, 32])
def test_fixed_random_planes_by_depth(host, rng, depth):
    """Every content kind at each depth; from depth 28 on the search is wide
    (bits_of_t 32), as analyze_planes makes it."""
    max_param = 30 if depth > 16 else 14
    _check_fixed(host, _planes(rng, 4096, depth), wide=depth >= 28, max_param=max_param)


def test_fixed_33_bit_side_plane(host, rng):
    """The int64 side plane of a 32-bit stream: L - R of full-scale content,
    differences up to 2^37, analyzed wide."""
    lr = _planes(rng, 4096, 32, per_kind=2).astype(np.int64).reshape(-1, 2, 4096)
    side = lr[:, 0] - lr[:, 1]
    lo, hi = -(1 << 31), (1 << 31) - 1
    alt = np.where(np.arange(4096) % 2 == 0, lo, hi).astype(np.int64)
    side = np.concatenate([side, [np.full(4096, lo - hi), alt - alt[::-1], alt]])
    got = _check_fixed(host, side, wide=True)
    assert not got.ok.all() and got.ok.any()


@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_wide_disqualifies_each_order(host, rng, k, dtype):
    """Alternating +-A with 2^k A just past 2^31 - 1: orders k..4 leave
    int32 and cost I64_MAX; at k = 0 no order is usable. Beside it a
    constant 2^32 (int64 only): order 0 is out, order 1 wins at 0."""
    a = -(-(1 << 31) // (1 << k))
    alt = np.where(np.arange(300) % 2 == 0, a, -a)
    rows = [alt, alt + rng.integers(-3, 4, 300), np.roll(alt, 1)]
    if dtype == np.int64:
        rows.append(np.full(300, 1 << 32))
    elif a >= 1 << 31:  # k = 0: +-2^31 is not an int32
        rows = [np.clip(r, -(1 << 31), (1 << 31) - 1) for r in rows]
    got = _check_fixed(host, np.stack(rows).astype(dtype), wide=True)
    assert got.ok[0].item() == (k > 0)
    if dtype == np.int64:
        assert (got.order[-1].item(), got.ok[-1].item()) == (1, True)


def test_all_equal_zero_and_single_sample_planes(host, rng):
    planes = np.stack([np.zeros(64), np.full(64, -7), np.full(64, 1 << 20),
                       np.r_[np.full(63, 5), 6], rng.integers(-9, 9, 64)]).astype(np.int32)
    got = _check_fixed(host, planes, wide=False)
    assert got.all_eq.tolist() == [True, True, True, False, False]
    one = rng.integers(-1000, 1000, (4, 1)).astype(np.int32)
    one[0] = 0
    got = _check_fixed(host, one, wide=False)
    assert got.all_eq.all()


@pytest.mark.parametrize("B", [1, 5, 17, 1972, 4608])
def test_fixed_block_sizes(host, rng, B):
    """Odd and ragged blocks (partition order 0), 4608 (partition sizes of
    18, not a power of two)."""
    planes = np.concatenate([_planes(rng, B, 16), _planes(rng, B, 24)[:3]])
    _check_fixed(host, planes, wide=False, jax_too=B > 1)


def test_fixed_largest_block(host, rng):
    planes = _planes(rng, 65535, 16)[[2, 3, 6]]
    _check_fixed(host, planes, wide=False, jax_too=False)


@pytest.mark.parametrize("max_rice_order,max_param", [(0, 14), (0, 30), (8, 14), (3, 30)])
def test_fixed_rice_limits(host, rng, max_rice_order, max_param):
    _check_fixed(host, _planes(rng, 1024, 16), wide=False, max_rice_order=max_rice_order,
                 max_param=max_param)


def test_negative_first_partition(host):
    """Fixed order 3 at B = 512, partition order 8: the first partition has
    2 - 3 = -1 samples, all warmup, its sum 0."""
    i = np.arange(512, dtype=np.int64)
    cube = i**3 // 60  # third differences small, fourth ones larger
    planes = np.stack([(3 * i * i - 7 * i) // 4, i**3 // 6 + (i % 5 == 0), cube,
                       cube + (i % 11 == 0)]).astype(np.int32)
    got = _check_fixed(host, planes, wide=False)
    assert (got.order == 3).all() and (got.residuals != 0).any(1).all()


def _quiet_partitions(rng, n_part, psz, order):
    """Residual rows whose top partitions (psz samples) have zigzag sums
    s = floor(psz_eff/2) - 1, floor(psz_eff/2), + 1, 0 and 1, with psz_eff
    the partition's size (the first one loses ``order`` warmup slots)."""
    B = n_part * psz
    rows = []
    for delta in (-1, 0, 1):
        r = np.zeros(B, np.int32)
        for p in range(n_part):
            lo = p * psz + (order if p == 0 else 0)
            size = (p + 1) * psz - lo
            target = max(size // 2 + delta, 0)
            ones = rng.permutation(np.arange(lo, lo + size))  # zigzag 2 (r = 1) or 1 (r = -1)
            r[ones[: target // 2]] = 1
            if target % 2:
                r[ones[target // 2]] = -1
        rows.append(r)
    r = np.zeros(B, np.int32)
    r[rng.integers(order, B, 3)] = -1
    rows += [np.zeros(B, np.int32), r]
    return np.stack(rows)


@pytest.mark.parametrize("psz,order", [(16, 2), (17, 1), (18, 3), (3, 1), (5, 0)])
def test_rice_sums_about_half_the_partition(host, rng, psz, order):
    """Partition sums at psz/2 - 1, psz/2 and psz/2 + 1 (the wrap of the
    reference's u64 subtraction and its fix), odd psz, zero partitions."""
    for n_part in (1, 4, 16):
        res = _quiet_partitions(rng, n_part, psz, order)
        B = res.shape[1]
        _check_rice(host, res, np.full(res.shape[0], order, np.int64),
                    max_rice_order=8, max_param=30 if order % 2 else 14, jax_too=B >= 4)


@pytest.mark.parametrize("B", [4096, 256])
def test_rice_lpc_orders(host, rng, B):
    """Orders 0..32 through the Rice entry; at these blocks orders 17-31
    allow partitions shorter than the order (size <= 0, sum 0)."""
    order = np.arange(33).repeat(2)
    res = rng.integers(-3000, 3000, (order.size, B)).astype(np.int32)
    res[np.arange(B)[None, :] < order[:, None]] = 0
    res[1::2] >>= 10
    _check_rice(host, res, order)


@pytest.mark.parametrize("B,max_rice_order", [
    (1, 8), (3, 8), (5, 8), (18, 8), (66, 8), (100, 8), (1152, 8), (1972, 8), (4098, 8),
    (4608, 8), (8192, 8), (65535, 8), (4096, 0), (1024, 3)])
def test_rice_block_sizes(host, rng, B, max_rice_order):
    """The Rice entry's runs against every partition shape: B not a multiple
    of 4 or 16 (3, 5, 18, 66, 1972, 4098, 65535), partitions shorter than a
    run (66 and 100 at order 1 and 2: 33 and 25; 1152 at order 7: 9),
    partitions of whole runs across lanes (8192 at order 8: 32), one
    partition for the whole block (max_rice_order 0), more than one tile
    (4098, 4608, 8192, 65535); orders 0-32 with their warmup slots holding
    residuals, which every sum takes in (plain version only), then zeroed
    as the encoder leaves them (the JAX package too)."""
    order = rng.integers(0, 33, 12 if B < 65535 else 3)
    order[:3] = (0, 32, min(B, 32))
    res = rng.integers(-40000, 40000, (order.size, B)).astype(np.int32)
    res[1::3] >>= 11
    res[2::3] >>= 15
    _check_rice(host, res, order, max_rice_order=max_rice_order, jax_too=False)
    res[np.arange(B)[None, :] < order[:, None]] = 0
    _check_rice(host, res, order, max_rice_order=max_rice_order,
                jax_too=4 <= B < 65535)


def test_rice_wide_values(host, rng):
    """Residuals over the whole int32 range (zigzags up to 2^32 - 1). With
    the warmup slots not zeroed (no caller passes such rows; the JAX
    package's u64 sizes read them otherwise) the kernel still equals the
    plain version."""
    res = rng.integers(-(1 << 31), 1 << 31, (6, 4096)).astype(np.int32)
    res[0] = -(1 << 31)
    res[1, ::3] = (1 << 31) - 1
    order = np.array([0, 1, 2, 8, 31, 32], np.int64)
    _check_rice(host, res, order, jax_too=False)
    res[np.arange(4096)[None, :] < order[:, None]] = 0
    _check_rice(host, res, order)


def test_partition_order_above_8(rng):
    """max_rice_order 12 at B = 4096 (po_top 12): the params hold partition
    orders 0-8 only. The JAX package's rice_estimate raises ValueError (its
    params pad goes negative); the port's plain versions and both wrappers
    raise it too, on the same input, before any work (no plain call
    counted)."""
    x = np.zeros((2, 4096), np.int32)
    x[:, ::2] = (1 << 20) + rng.integers(-5, 5, (2, 2048))
    order = np.zeros(2, np.int64)
    with pytest.raises(ValueError):
        jan.rice_estimate(x, order.astype(np.int32), 4096, 12, 30)
    t, o = torch.from_numpy(x), torch.from_numpy(order)
    tan.reset_counts()
    for call in (lambda: tan.analyze_fixed_plain(t, False, 12, 30),
                 lambda: tan.rice_estimate(t, o, 4096, 12, 30),
                 lambda: tan.analyze_fixed(t, False, 12, 30),
                 lambda: tan.rice_estimate_planes(t, o, 12, 30)):
        with pytest.raises(ValueError, match="partition order 12"):
            call()
    assert tan.PLAIN_CALLS == 0


def _f5_wav(rng, n):
    t = np.arange(n)
    x = 9000 * np.sin(2 * np.pi * 440 * t / 44100) + rng.normal(0, 120, (2, n))
    buf = io.BytesIO()
    write_wav(buf, np.clip(np.round(x), -32768, 32767).astype(np.int64), 44100, 16)
    return buf.getvalue()


def test_encode_refuses_partition_order_above_8(rng):
    """max_rice_order 12 at block 4096 (partition order 12): the JAX
    package's encode raises ValueError, and the port's raises it too, before
    any analysis runs."""
    wav = _f5_wav(rng, 2 * 4096 + 100)
    with pytest.raises(ValueError):
        zigflac_tpu.encode_wav_bytes(wav, config=JaxConfig(block_size=4096, max_rice_order=12))
    tan.reset_counts()
    with pytest.raises(ValueError, match="partition order 12"):
        zigflac_tpu_torch.encode_wav_bytes(
            wav, config=EncoderConfig(block_size=4096, max_rice_order=12), device="cpu")
    assert tan.PLAIN_CALLS == 0


def test_encode_refuses_a_tail_of_partition_order_above_8(rng):
    """Block 2304 (ctz 8: legal at max_rice_order 12) with a 2048-sample
    tail (ctz 11: partition order 11): the JAX package's device encode
    raises ValueError, and the port's raises it too, naming the tail's
    block size, before any analysis runs."""
    wav = _f5_wav(rng, 2 * 2304 + 2048)
    with pytest.raises(ValueError):
        zigflac_tpu.encode_wav_bytes(wav, config=JaxConfig(block_size=2304, max_rice_order=12))
    tan.reset_counts()
    with pytest.raises(ValueError, match="block size 2048"):
        zigflac_tpu_torch.encode_wav_bytes(
            wav, config=EncoderConfig(block_size=2304, max_rice_order=12), device="cpu")
    assert tan.PLAIN_CALLS == 0


def test_encode_max_rice_order_above_8_where_legal(rng):
    """max_rice_order 12 at block 1152 (ctz 7: partition order 7) is legal
    in both packages, and both write the same bytes."""
    wav = _f5_wav(rng, 3 * 1152 + 77)
    want = zigflac_tpu.encode_wav_bytes(wav, config=JaxConfig(block_size=1152, max_rice_order=12))
    got = zigflac_tpu_torch.encode_wav_bytes(
        wav, config=EncoderConfig(block_size=1152, max_rice_order=12), device="cpu")
    assert got == want


@pytest.mark.parametrize("lim", [(1 << 23) - 1, 1 << 23])
@pytest.mark.parametrize("wide", [False, True])
def test_narrow_arithmetic_limit(host, rng, lim, wide):
    """int32 planes whose largest |x| is the narrow arithmetic's limit
    (2^23 - 1: every warp narrow) and one past it (the warps holding it go
    wide): alternation at +-lim (the largest differences), a constant -lim,
    and noise with one sample at -lim in the second warp."""
    t = np.arange(4096)
    noise = rng.integers(-lim + 1, lim, 4096)
    noise[700] = -lim
    planes = np.stack([np.where(t % 2 == 0, lim, -lim), np.full(4096, -lim), noise])
    _check_fixed(host, planes.astype(np.int32), wide=wide, max_param=30)
    narrow, warps = host.stats[:2]
    assert warps == 3 * 8
    assert narrow == (24 if lim < 1 << 23 else 7)


@pytest.mark.parametrize("total", [(1 << 32) - 1, 1 << 32])
def test_rice_sum_about_2_32(host, total):
    """One partition (max_rice_order 0) whose zigzag sum is 2^32 - 1 or 2^32,
    where a 32-bit sum would end: residuals of 2^19, one of them -2^19 for
    the odd sum."""
    res = np.full((2, 4096), 1 << 19, np.int32)
    if total % 2:
        res[:, 100] = -(1 << 19)
    order = np.array([0, 3], np.int64)
    for max_param in (14, 30):
        _check_rice(host, res, order, max_rice_order=0, max_param=max_param)


def _sweep(s, psz, max_param):
    """The plain version's k-sweep of rice_estimate, per node, in numpy."""
    half = np.floor_divide(psz, 2)
    lhs = np.maximum(s - half, 0)
    best_bc, best_k = psz + lhs, np.zeros_like(s)
    for k in range(1, max_param.max() + 2):
        bc = psz * (k + 1) + (lhs >> k)
        smaller = (bc < best_bc) & (k <= max_param + 1)
        best_k, best_bc = np.where(smaller, k, best_k), np.where(smaller, bc, best_bc)
    best_bc = np.where(best_k == max_param + 1, psz * (max_param + 1), best_bc)
    under = (s < half) & (s != 0)
    best_k, best_bc = np.where(under, 0, best_k), np.where(under, psz - half + s, best_bc)
    zero = s == 0
    return np.where(zero, max_param + 1, best_k), np.where(zero, 5, best_bc)


def test_rice_node_closed_form_equals_the_sweep(host, rng):
    """zf_rice_node's closed form (no sweep) == the plain k-sweep's first
    minimum with its three fixes: sums from 0 to 2^48 on both sides of every
    power of two and of psz * 2^k, sizes from -40 to 65535, params 0-30."""
    n = 200_000
    psz = np.concatenate([rng.integers(-40, 65536, n // 2), rng.integers(-2, 40, n // 2)])
    e = rng.integers(0, 48, n)
    s = np.concatenate([rng.integers(0, 1 << 48, n // 4) >> rng.integers(0, 48, n // 4),
                        (np.int64(1) << e[: n // 4]) + rng.integers(-2, 3, n // 4),
                        np.maximum(psz[n // 2 : 3 * n // 4], 0) * (np.int64(1) << (
                            e[n // 2 : 3 * n // 4] % 31)) + rng.integers(-3, 4, n // 4),
                        rng.integers(0, 100, n // 4)])
    s = np.maximum(s, 0)
    max_param = rng.integers(0, 31, n).astype(np.int32)
    got_k, got_bc = host.rice_node(s, psz, max_param)
    want_k, want_bc = _sweep(s, psz, max_param.astype(np.int64))
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_bc, want_bc)
    assert np.abs(got_bc).max() < 1 << 22  # the kernel's 32-bit level sums


@pytest.mark.parametrize("B,max_rice_order", [
    (4096, 8), (4096, 4), (8192, 8), (256, 8), (64, 8), (1152, 8), (4608, 8), (1972, 8),
    (65535, 8)])
def test_partitions_against_runs(host, rng, B, max_rice_order):
    """Top partitions of one run (4096 at order 8: 16 samples), of whole
    runs (256 and 32 samples: a segmented sum across lanes, two tiles at
    8192), shorter than a run (256 and 64 at order 8: one sample; 1152: 9)
    and neither (4608: 18; 1972: 493; 65535: the whole block, 16 tiles)."""
    planes = np.concatenate([_planes(rng, B, 16)[[1, 2, 3, 6]], _planes(rng, B, 24)[[3, 6]]])
    _check_fixed(host, planes, wide=False, max_rice_order=max_rice_order, max_param=30,
                 jax_too=B < 65535)


# -- the wrappers ----------------------------------------------------------------


def test_wrappers_take_the_plain_version_on_the_cpu(rng):
    planes = torch.from_numpy(_planes(rng, 256, 16))
    tan.reset_counts()
    got = tan.analyze_fixed(planes, False, 8, 14)
    want = tan.analyze_fixed_plain(planes, False, 8, 14)
    for name in tan.FixedAnalysis._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    bits = tan.rice_estimate_planes(got.residuals, got.order, 8, 14)
    assert all(torch.equal(a, b) for a, b in zip(
        bits, tan.rice_estimate(got.residuals, got.order, 256, 8, 14)))
    assert (tan.KERNEL_LAUNCHES, tan.RICE_KERNEL_LAUNCHES, tan.PLAIN_CALLS) == (0, 0, 2)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    p = torch.zeros((3, 64), dtype=torch.int32)
    o = torch.zeros(3, dtype=torch.int64)
    bad_fixed = [
        ((p.float(), False, 8, 14), TypeError),
        ((p.to(torch.int16), False, 8, 14), TypeError),
        ((torch.zeros((64, 3), dtype=torch.int32).t(), False, 8, 14), ValueError),
        ((torch.zeros((3, 0), dtype=torch.int32), False, 8, 14), ValueError),
        ((torch.zeros((1, 65536), dtype=torch.int32), False, 8, 14), ValueError),
        ((p, False, 16, 14), ValueError),
        ((p, False, 8, 31), ValueError),
        ((p.to("meta"), False, 8, 14), NotImplementedError),
    ]
    for args, exc in bad_fixed:
        with pytest.raises(exc):
            tan.analyze_fixed(*args)
    bad_rice = [
        ((p.to(torch.int64), o, 8, 14), TypeError),
        ((p, o.to(torch.int32), 8, 14), TypeError),
        ((p, o[:2], 8, 14), ValueError),
        ((p, o, -1, 14), ValueError),
        ((p.to("meta"), o.to("meta"), 8, 14), NotImplementedError),
    ]
    for args, exc in bad_rice:
        with pytest.raises(exc):
            tan.rice_estimate_planes(*args)


# -- the slice as a whole, with the harness in the kernels' place ------------------


def _patch_kernels(monkeypatch, host):
    """analyze_fixed and rice_estimate_planes take the g++ harness: the
    kernels' arithmetic through analyze_planes and the whole encode."""
    launches = {"fixed": 0, "rice": 0}

    def fixed(planes, wide, max_rice_order, max_param):
        launches["fixed"] += 1
        return host.analyze_fixed(planes.numpy(), wide, max_rice_order, max_param)

    def rice(residuals, order, max_rice_order, max_param):
        launches["rice"] += 1
        return host.rice(residuals.numpy(), order.numpy(), max_rice_order, max_param)

    monkeypatch.setattr(tan, "analyze_fixed", fixed)
    monkeypatch.setattr(tan, "rice_estimate_planes", rice)
    return launches


@pytest.mark.parametrize("depth,bits_of_t,fields", [
    (16, 32, dict()), (24, 32, dict(max_rice_param=14)), (32, 32, dict()), (32, 64, dict()),
    (16, 32, dict(prediction="lpc", lpc_order=8)),
])
def test_analyze_planes_through_the_harness_equals_jax(host, rng, monkeypatch, depth,
                                                       bits_of_t, fields):
    planes = _planes(rng, 1024, depth, per_kind=2)
    if bits_of_t == 64:
        planes = planes.astype(np.int64) * 2  # 33-bit values
    launches = _patch_kernels(monkeypatch, host)
    got = tan.analyze_planes(torch.from_numpy(planes), bits_of_t, depth, 1024,
                             EncoderConfig(block_size=1024, **fields))
    want = jax.jit(lambda x: jan.analyze_planes(
        x, bits_of_t, depth, 1024, JaxConfig(block_size=1024, **fields)))(planes)
    for name in tan.PlaneAnalysis._fields:
        w = np.asarray(getattr(want, name))
        if name == "residuals" and want.res_lpc is not None:
            # the JAX package keeps the LPC candidate's apart, the port merges
            w = np.where(np.asarray(want.kind)[:, None] == 3, np.asarray(want.res_lpc), w)
        np.testing.assert_array_equal(getattr(got, name).numpy(), w, err_msg=name)
    assert launches == {"fixed": 1, "rice": int("lpc_order" in fields)}


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_corpus_streams_through_the_harness(host, monkeypatch, name):
    """Every pinned corpus stream (the JAX package's bytes) with the
    analysis harness in the kernels' place."""
    case = next(c for c in CASES if c["name"] == name)
    launches = _patch_kernels(monkeypatch, host)
    flac = zigflac_tpu_torch.encode_wav_bytes(
        _wav_bytes(case), config=EncoderConfig(**asdict(_case_config(case))), device="cpu")
    with open(os.path.join(VEC_DIR, name + ".flac"), "rb") as f:
        assert hashlib.sha256(flac).digest() == hashlib.sha256(f.read()).digest()
    assert launches["fixed"] > 0 and (launches["rice"] > 0) == bool(case.get("lpc"))
