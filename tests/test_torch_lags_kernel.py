"""The lag sums kernel's arithmetic (zigflac_tpu_torch/csrc/lags_steps.cuh)
built for the host with g++, behind a loop that runs csrc/lags.cu's block
(128 threads, runs of 32 samples, lag groups, tiles of 4096, the warp and
block sums) one thread after another. It is held against the port's plain
lag_sums, Python-integer sums and the JAX package's lag_sums_np on the same
numpy inputs made from a seed; then the wrapper's routing and checks, and
whole encodes with the harness in the kernel's place.

Tolerance: exact equality. Every output is an integer."""

import ctypes
import hashlib
import io
import os
import shutil
import subprocess
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

import zigflac_tpu_torch
from conftest import make_signal
from test_regression_corpus import CASES, VEC_DIR, _case_config, _wav_bytes
from zigflac_tpu.ops import lpc as jlpc
from zigflac_tpu.wav import write_wav
from zigflac_tpu_torch import EncoderConfig
from zigflac_tpu_torch.ops import lpc as tlpc
from zigflac_tpu_torch.utils import stages
from zigflac_tpu_torch.utils.apodization import TUKEY_HALF, windows_of

CSRC = Path(__file__).resolve().parent.parent / "zigflac_tpu_torch" / "csrc"
FLAC8 = ("tukey(5e-1)", "partial_tukey(2)", "punchout_tukey(3)")
SIX = windows_of(EncoderConfig(apodization=FLAC8))

# csrc/lags.cu's block with its threads run in turn, through the same
# lags_steps.cuh helpers: for each plane and lag group, each window and
# tile, the tile and the window staged (zero past the plane), each thread's
# run of kZfLagRun samples, each warp's partials summed through their 21-bit
# limbs in 32 bits as the warp reductions add them, the four warps' sums,
# and the totals' triples. stats counts, per call: CTAs (planes x lag
# groups), and tiles staged of the plane.
HOST_HARNESS = r"""
#include <algorithm>
#include <vector>
#include "lags_steps.cuh"

namespace {
constexpr int kWarps = kZfLagThreads / 32;

template <typename T, bool kNarrow, int G>
void lag_sums(const T* planes, const int16_t* windows, int nwin, int b, int order, int64_t np,
              int64_t* out, int64_t* stats) {
  constexpr int kParts = kNarrow ? 1 : 3;
  std::vector<T> s_sm(kZfLagStageSlots);
  std::vector<int16_t> w_sm(kZfLagStageSlots16);
  const int ntiles = (b + kZfLagTile - 1) / kZfLagTile;
  const auto xs = [&](int i) {
    if constexpr (kNarrow) return (int32_t)s_sm[zf_lag_pad(i)] * (int32_t)w_sm[zf_lag_pad16(i)];
    else return (int64_t)s_sm[zf_lag_pad(i)] * (int64_t)w_sm[zf_lag_pad16(i)];
  };
  for (int64_t pl = 0; pl < np; ++pl) {
    const T* x = planes + pl * b;
    for (int grp = 0; grp < zf_lag_groups(order); ++grp) {
      const int k0 = grp * G;
      stats[0] += 1;
      for (int w = 0; w < nwin; ++w) {
        int64_t tot[G][3] = {};
        const int16_t* wv = windows + (int64_t)w * b;
        for (int tile = 0; tile < ntiles; ++tile) {
          const int base = tile * kZfLagTile;
          const int len = std::min(kZfLagTile, b - base);
          const int span = (len + kZfLagRun - 1) / kZfLagRun * kZfLagRun + k0 + G - 1;
          if (ntiles > 1 || w == 0) {
            stats[1] += 1;
            for (int i = 0; i < span; ++i) s_sm[zf_lag_pad(i)] = base + i < b ? x[base + i] : T(0);
          }
          for (int i = 0; i < span; ++i)
            w_sm[zf_lag_pad16(i)] = base + i < b ? wv[base + i] : int16_t(0);
          int64_t wsum[kWarps][kParts * G];
          for (int warp = 0; warp < kWarps; ++warp) {
            uint32_t sa[kParts * G] = {}, sb[kParts * G] = {};
            uint32_t sc[kParts * G] = {};
            for (int lane = 0; lane < 32; ++lane) {
              const int start = (warp * 32 + lane) * kZfLagRun;
              int64_t acc[kParts][G] = {};
              const bool same = G == kZfLagSmallGroup || k0 == 0;
              if (start < len) {
                if constexpr (kNarrow) {
                  if (same) zf_lag_run_narrow<G, true>(xs, start, 0, acc[0]);
                  else zf_lag_run_narrow<G, false>(xs, start, k0, acc[0]);
                } else {
                  if (same) zf_lag_run_wide<G, true>(xs, start, 0, acc[0], acc[1], acc[2]);
                  else zf_lag_run_wide<G, false>(xs, start, k0, acc[0], acc[1], acc[2]);
                }
              }
              for (int c = 0; c < kParts; ++c)
                for (int g = 0; g < G; ++g) {
                  uint32_t a, bb;
                  int32_t cc;
                  zf_lag_limbs21(acc[c][g], &a, &bb, &cc);
                  sa[c * G + g] += a;
                  sb[c * G + g] += bb;
                  sc[c * G + g] += (uint32_t)cc;
                }
            }
            for (int v = 0; v < kParts * G; ++v)
              wsum[warp][v] = zf_lag_join21(sa[v], sb[v], (int32_t)sc[v]);
          }
          for (int g = 0; g < G; ++g)
            for (int c = 0; c < kParts; ++c) {
              int64_t s = 0;
              for (int q = 0; q < kWarps; ++q) s += wsum[q][c * G + g];
              if constexpr (kNarrow) zf_lag_narrow_add(s, &tot[g][0], &tot[g][1]);
              else tot[g][c] += s;
            }
        }
        for (int g = 0; g < G; ++g) {
          const int k = k0 + g;
          if (k > order) continue;
          int64_t* o = out + (((int64_t)w * np + pl) * (order + 1) + k) * 3;
          if constexpr (kNarrow) zf_lag_narrow_triple(tot[g][0], tot[g][1], o);
          else zf_lag_wide_triple(tot[g][0], tot[g][1], tot[g][2], o);
        }
      }
    }
  }
}

template <typename T, bool kNarrow>
void dispatch(const void* planes, const int16_t* windows, int nwin, int b, int order, int64_t np,
              int64_t* out, int64_t* stats) {
  if (zf_lag_group(order) == kZfLagSmallGroup)
    lag_sums<T, kNarrow, kZfLagSmallGroup>((const T*)planes, windows, nwin, b, order, np, out, stats);
  else
    lag_sums<T, kNarrow, kZfLagGroup>((const T*)planes, windows, nwin, b, order, np, out, stats);
}
}  // namespace

extern "C" void zf_lag_sums_host(const void* planes, int planes_i64, int narrow,
                                 const int16_t* windows, int64_t nwin, int64_t p, int64_t b,
                                 int64_t order, int64_t* out, int64_t* stats) {
  if (planes_i64)
    dispatch<int64_t, false>(planes, windows, (int)nwin, (int)b, (int)order, p, out, stats);
  else if (narrow)
    dispatch<int32_t, true>(planes, windows, (int)nwin, (int)b, (int)order, p, out, stats);
  else
    dispatch<int32_t, false>(planes, windows, (int)nwin, (int)b, (int)order, p, out, stats);
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """lags_steps.cuh built for the host with g++ behind the kernel's block
    loop. ``host.lag_sums(planes, order, windows, narrow)`` on numpy arrays
    returns int64 [W, ..., order+1, 3]; ``host.stats`` holds the last call's
    CTAs and plane tiles staged."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel's arithmetic cannot be built on the host")
    d = tmp_path_factory.mktemp("lags_host")
    (d / "host.cpp").write_text(HOST_HARNESS)
    so = d / "host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-Wno-unknown-pragmas", "-shared",
         "-fPIC", "-I", str(CSRC), "-o", str(so), str(d / "host.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.zf_lag_sums_host.argtypes = [ptr, i32, i32, ptr, i64, i64, i64, i64, ptr, ptr]

    class Host:
        stats = None

        @staticmethod
        def lag_sums(planes, order, windows, narrow):
            x = np.ascontiguousarray(planes)
            w = np.ascontiguousarray(windows)
            assert x.dtype in (np.int32, np.int64) and w.dtype == np.int16
            assert not (narrow and x.dtype == np.int64)
            *batch, b = x.shape
            p = int(np.prod(batch, dtype=np.int64))
            out = np.empty((w.shape[0], p, order + 1, 3), np.int64)
            Host.stats = np.zeros(2, np.int64)
            lib.zf_lag_sums_host(x.ctypes.data, x.dtype == np.int64, bool(narrow), w.ctypes.data,
                                 w.shape[0], p, b, order, out.ctypes.data, Host.stats.ctypes.data)
            return out.reshape((w.shape[0], *batch, order + 1, 3))

    return Host


def _windows(wins, B):
    return tlpc.windows_tensor(tuple(wins), B, torch.device("cpu")).numpy()


def _plain(planes, order, windows):
    """The plain version, through its wrapper on the CPU."""
    return tlpc.lag_sums_planes(torch.from_numpy(planes), order,
                                torch.from_numpy(windows)).numpy()


def _exact(planes, order, windows):
    """The windowed lag sums in Python integers, as limb triples."""
    W, B = windows.shape
    m24 = (1 << 24) - 1
    out = np.zeros((W,) + planes.shape[:-1] + (order + 1, 3), np.int64)
    flat = planes.reshape(-1, B).astype(object)
    for w in range(W):
        for r in range(flat.shape[0]):
            x = flat[r] * windows[w].astype(object)
            for k in range(order + 1):
                v = int(np.dot(x[k:], x[: B - k])) if k < B else 0
                out[(w,) + np.unravel_index(r, planes.shape[:-1]) + (k,)] = (
                    v >> 48, (v >> 24) & m24, v & m24)
    return out


def _check(host, planes, order, wins, sample_bits=None, jax_depth=False, exact=False):
    """Harness == plain version, in the tier the wrapper picks and, where
    the planes allow the narrow tier, in both; and == the JAX package's
    lag_sums_np under the one Tukey(0.5) (its general limb tier up to 2^15
    samples; ``jax_depth``: also at the tier the JAX package picks for that
    depth), and == Python integers (``exact``)."""
    B = planes.shape[-1]
    windows = _windows(wins, B)
    want = _plain(planes, order, windows)
    narrow = tlpc.narrow_tier(torch.from_numpy(planes).dtype, sample_bits)
    got = host.lag_sums(planes, order, windows, narrow)
    np.testing.assert_array_equal(got, want)
    if narrow:
        np.testing.assert_array_equal(host.lag_sums(planes, order, windows, False), want)
    if tuple(wins) == (TUKEY_HALF,):
        if B <= 1 << 15:  # the JAX general limb tier wraps in int64 past 2^15 samples
            np.testing.assert_array_equal(got[0], jlpc.lag_sums_np(planes, order, None))
        if jax_depth:
            np.testing.assert_array_equal(got[0], jlpc.lag_sums_np(planes, order, jax_depth))
    if exact:
        np.testing.assert_array_equal(got, _exact(planes, order, windows))
    return got


def _extreme_planes(rng, bits, B):
    """Rows of ``bits``-bit samples at their limits: constant at the negative
    limit, alternating between the limits, uniform noise, and a plain
    tone with noise."""
    lim = 1 << (bits - 1)
    t = np.arange(B)
    return np.stack([np.full(B, -lim), np.where(t % 2 == 0, -lim, lim - 1),
                     rng.integers(-lim, lim, B),
                     np.clip(np.round(0.6 * lim * np.sin(t / 7.0) + rng.normal(0, lim >> 6, B)),
                             -lim, lim - 1)]).astype(np.int64)


@pytest.mark.parametrize("depth", [4, 8, 12, 16, 20, 24, 28, 32])
def test_depths_and_side_planes(host, rng, depth):
    """Planes of each depth and their side planes (one bit more, int64 at
    depth 32), in the int32 or int64 storage the analysis gives them, at
    order 8 under the one Tukey(0.5): the harness equals the plain version
    and the JAX package's general limb tier and the tier its depth picks."""
    planes = np.concatenate([_extreme_planes(rng, depth, 4096),
                             _extreme_planes(rng, depth + 1, 4096)])
    dtype = np.int64 if depth == 32 else np.int32
    _check(host, planes.astype(dtype), 8, (TUKEY_HALF,), sample_bits=depth + 1,
           jax_depth=depth)


@pytest.mark.parametrize("order", [1, 8, 12, 32])
@pytest.mark.parametrize("wins", ["tukey", "flac8"])
def test_orders_and_windows(host, rng, order, wins):
    """Orders 1, 8 (one group of 9 lags), 12 (one of 13) and 32 (three
    groups of 13, the last starting at lag 26) under the one Tukey(0.5) and
    under flac -8's six windows (the partial windows' zero spans, the
    punchout windows' zero middles), on 16-bit planes and the 17-bit side
    (the narrow tier) and on 24-bit planes (the limbs)."""
    ws = (TUKEY_HALF,) if wins == "tukey" else SIX
    p16 = np.concatenate([make_signal(rng, 4096, 3, 16, k) for k in ("sine", "noise", "mixed")])
    _check(host, np.concatenate([p16, _extreme_planes(rng, 17, 4096)]).astype(np.int32),
           order, ws, sample_bits=17)
    p24 = np.concatenate([make_signal(rng, 4096, 2, 24, k) for k in ("sine", "extreme")])
    _check(host, p24, order, ws, sample_bits=25)


@pytest.mark.parametrize("B", [1, 16, 31, 33, 100, 4095, 4097, 4608])
def test_block_sizes(host, rng, B):
    """Blocks shorter than a run or than the lags (B = 1, 16: the lags at and
    past B are 0), not a multiple of a run, one sample past a tile (two
    tiles, the plane staged again for every window) and flac's 4608."""
    planes = np.concatenate([make_signal(rng, B, 2, 16, k) for k in ("sine", "noise")])
    planes = np.concatenate([planes, _extreme_planes(rng, 17, B)]).astype(np.int32)
    got = _check(host, planes, 12, SIX, sample_bits=17)
    assert host.stats[1] == (planes.shape[0] * 6 * 2 if B > 4096 else planes.shape[0])
    if B <= 12:
        assert not got[..., B:, :].any()


@pytest.mark.parametrize("B", [32769, 65535])
@pytest.mark.parametrize("bits,dtype", [(17, np.int32), (25, np.int32), (33, np.int64)])
def test_large_blocks(host, rng, B, bits, dtype):
    """Blocks over 2^15 samples up to the format's largest (16 tiles): the
    narrow tier's totals pass 2^63 on full-scale rows (B x 2^48), the limbs'
    hh, hl and ll sums reach their bounds; quiet rows at a negative DC
    beside them. Held to Python integers as well."""
    planes = np.concatenate([_extreme_planes(rng, bits, B)[:2],
                             np.stack([np.full(B, -3), rng.integers(-20, 0, B)])]).astype(dtype)
    _check(host, planes, 8, (TUKEY_HALF,), sample_bits=bits, exact=True,
           jax_depth=bits - 1 if bits <= 21 else False)


@pytest.mark.parametrize("lim", [1 << 16, (1 << 16) + 1])
def test_narrow_tier_boundary(host, lim):
    """The narrow tier's limit, |s| <= 2^16 (x up to 2^24, a run's partial
    up to 2^53): samples at -2^16 and +2^16 under the flat top of a Tukey
    window, the largest products, in both tiers (one past the limit the
    narrow tier is not taken: only the limbs). Held to Python integers."""
    B = 4096
    t = np.arange(B)
    planes = np.stack([np.full(B, -lim), np.full(B, lim), np.where(t % 2 == 0, -lim, lim),
                       np.where(t % 3 == 0, lim, -lim)]).astype(np.int32)
    bits = 17 if lim == 1 << 16 else 18
    assert tlpc.narrow_tier(torch.int32, bits) == (lim == 1 << 16)
    _check(host, planes, 12, (TUKEY_HALF,) + SIX[1:2], sample_bits=bits, exact=True)


def test_wide_tier_boundary(host, rng):
    """The limbs at their widest: 33-bit side samples (+-2^32) and 2^38 - 1,
    whose windowed values reach 2^46 where the window is 256, at order 32
    (the third lag group's successors past the run)."""
    B = 4096
    t = np.arange(B)
    big = (1 << 38) - 1
    planes = np.stack([np.full(B, -(1 << 32)), np.where(t % 2 == 0, -(1 << 32), (1 << 32) - 1),
                       np.where(t % 2 == 0, -big, big), rng.integers(-big, big, B)])
    _check(host, planes.astype(np.int64), 32, (TUKEY_HALF,), exact=True)


def test_rows_of_zero_windows(host, rng):
    """A plane whose windows leave only a few samples: punchout windows of
    32 parts zero all but the ends, partial windows all but one part."""
    ws = windows_of(EncoderConfig(apodization=("partial_tukey(32)",)))
    planes = make_signal(rng, 2048, 3, 16, "mixed")
    _check(host, planes, 12, ws, sample_bits=17)
    ws = windows_of(EncoderConfig(apodization=("punchout_tukey(32)",)))
    _check(host, planes, 8, ws, sample_bits=17)


def test_lag_groups_and_tiles_staged(host, rng):
    """The CTAs a launch runs: one a plane up to order 12, two at 13-25,
    three at 26-32; a plane of one tile is staged once for all windows."""
    planes = make_signal(rng, 1024, 4, 16, "sine")
    windows = _windows(SIX, 1024)
    for order, groups in ((1, 1), (8, 1), (9, 1), (12, 1), (13, 2), (25, 2), (26, 3), (32, 3)):
        host.lag_sums(planes, order, windows, True)
        assert tuple(host.stats) == (4 * groups, 4 * groups), order


# -- the wrapper ------------------------------------------------------------------


def test_wrapper_takes_the_plain_version_on_the_cpu(rng):
    planes = torch.from_numpy(make_signal(rng, 1024, 6, 16, "mixed")).reshape(2, 3, 1024)
    wins = tlpc.windows_tensor(SIX, 1024, torch.device("cpu"))
    assert wins.dtype == torch.int16 and int(wins.min()) >= 0 and int(wins.max()) <= 256
    tlpc.reset_counts()
    stages.COUNTS = {}
    try:
        got = tlpc.lag_sums_planes(planes, 12, wins, 17)
    finally:
        counts, stages.COUNTS = stages.COUNTS, None
    want = tlpc.lag_sums(planes.unsqueeze(0), 12, wins.long().view(6, 1, 1, 1024))
    assert got.shape == (6, 2, 3, 13, 3) and torch.equal(got, want)
    assert (tlpc.LAG_KERNEL_LAUNCHES, tlpc.PLAIN_CALLS) == (0, 1)
    assert "lpc.lag_kernel_evals" not in counts  # counted on the card only


def test_wrapper_refuses_what_the_kernel_does_not_take():
    p = torch.zeros((3, 64), dtype=torch.int32)
    w = tlpc.windows_tensor((TUKEY_HALF,), 64, torch.device("cpu"))
    bad = [
        ((p.float(), 8, w), TypeError),
        ((p.to(torch.int16), 8, w), TypeError),
        ((p, 8, w.long()), TypeError),
        ((torch.zeros((64, 3), dtype=torch.int32).t(), 8, w), ValueError),
        ((torch.zeros((3, 0), dtype=torch.int32), 8, w[:, :0]), ValueError),
        ((torch.zeros((1, 65536), dtype=torch.int32), 8,
          torch.zeros((1, 65536), dtype=torch.int16)), ValueError),
        ((p, 0, w), ValueError),
        ((p, 33, w), ValueError),
        ((p, 8, w[:, :63]), ValueError),
        ((p, 8, w[0]), ValueError),
        ((p, 8, w.expand(33, 64).contiguous()), ValueError),
        ((p, 8, torch.zeros((2, 128), dtype=torch.int16)[:, ::2]), ValueError),
        ((p, 8, w, 0), ValueError),
        ((p.to("meta"), 8, w.to("meta")), NotImplementedError),
    ]
    tlpc.reset_counts()
    for args, exc in bad:
        with pytest.raises(exc):
            tlpc.lag_sums_planes(*args)
    assert tlpc.PLAIN_CALLS == 0


# -- the slice as a whole, with the harness in the kernel's place ------------------


def _patch_kernel(monkeypatch, host):
    """lag_sums_planes takes the g++ harness, in the tier the wrapper would
    pick: the kernel's arithmetic through analyze_planes and the whole
    encode. Returns the calls as (planes x windows, narrow)."""
    calls = []

    def harness(planes, order, windows, sample_bits=None):
        narrow = tlpc.narrow_tier(planes.dtype, sample_bits)
        calls.append((planes.numel() // planes.shape[-1] * windows.shape[0], narrow))
        return torch.from_numpy(host.lag_sums(planes.numpy(), order, windows.numpy(), narrow))

    monkeypatch.setattr(tlpc, "lag_sums_planes", harness)
    return calls


@pytest.mark.parametrize("name", [c["name"] for c in CASES if c.get("lpc")])
def test_corpus_lpc_streams_through_the_harness(host, monkeypatch, name):
    """Every pinned LPC corpus stream (the JAX package's bytes: orders 8 and
    12, 16 and 24 bits) with the harness in the kernel's place, in the tier
    the wrapper picks (narrow at 16 bits, the limbs at 24)."""
    case = next(c for c in CASES if c["name"] == name)
    calls = _patch_kernel(monkeypatch, host)
    flac = zigflac_tpu_torch.encode_wav_bytes(
        _wav_bytes(case), config=EncoderConfig(**asdict(_case_config(case))), device="cpu")
    with open(os.path.join(VEC_DIR, name + ".flac"), "rb") as f:
        assert hashlib.sha256(flac).digest() == hashlib.sha256(f.read()).digest()
    assert calls and all(narrow == (case["depth"] == 16) for _, narrow in calls)


def _wav(rng, n, depth):
    t = np.arange(n)
    lim = 1 << (depth - 1)
    x = 0.3 * lim * np.sin(2 * np.pi * 440 * t / 44100) + rng.normal(0, lim >> 8, (2, n))
    x[1, n // 3: n // 2] = -x[0, n // 3: n // 2]  # antiphase: the side plane's extra bit
    buf = io.BytesIO()
    write_wav(buf, np.clip(np.round(x), -lim, lim - 1).astype(np.int64), 44100, depth)
    return buf.getvalue()


@pytest.mark.parametrize("depth,fields", [
    (16, dict(lpc_order=12, lpc_precision=12, max_rice_order=6, apodization=FLAC8)),
    (32, dict(lpc_order=8)),
], ids=["flac8", "depth32"])
def test_encodes_through_the_harness_equal_the_plain_path(host, rng, monkeypatch, depth,
                                                          fields):
    """flac -8's six-window search at 16 bits (narrow) and a 32-bit LPC
    encode (int32 planes and the int64 side plane, the limbs) with the
    harness in the kernel's place write the plain path's bytes."""
    wav = _wav(rng, 2 * 4096 + 1500, depth)
    cfg = EncoderConfig(prediction="lpc", **fields)
    want = zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cpu")
    calls = _patch_kernel(monkeypatch, host)
    assert zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cpu") == want
    if depth == 16:
        assert calls and all(n % 6 == 0 and narrow for n, narrow in calls)
    else:
        assert {narrow for _, narrow in calls} == {False} and len(calls) >= 2
