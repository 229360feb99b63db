"""The frame CRC kernel's arithmetic (zigflac_tpu_torch/csrc/crc16_steps.cuh)
built for the host with g++, behind a loop that runs csrc/crc16.cu's block
(kZfCrcLanes lanes a frame, each folding its 16-byte chunks, the lanes'
terms XORed, the first lane's deposit) one lane after another, through the
int4 branch and the word branch. It is held against the port's plain
version (crc16_words + bitpack.deposit_crc16), the JAX package's
(ops/crc16.crc16_words, ops/bitpack.deposit_crc16) and crc.crc16 of the
frame's bytes, on numpy inputs made from a seed and on real frame rows; its
compile-time tables against square and multiply and crc.xpow_shift_table;
then the wrapper's routing and checks, and whole encodes with the harness
in the kernel's place.

Tolerance: exact equality of CRCs and words."""

import ctypes
import hashlib
import io
import os
import shutil
import subprocess
from dataclasses import asdict
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zigflac_tpu_torch
from conftest import make_signal
from test_regression_corpus import CASES, VEC_DIR, _case_config, _wav_bytes
from zigflac_tpu import crc as jcrc
from zigflac_tpu.ops import bitpack as jbp, crc16 as jcrc16
from zigflac_tpu_torch import EncoderConfig
from zigflac_tpu_torch.models import pipeline
from zigflac_tpu_torch.ops import analyze as tan, bitpack as tbp, crc16 as tcrc16
from zigflac_tpu_torch.ops.header import header_static
from zigflac_tpu_torch.wav import write_wav

CSRC = Path(__file__).resolve().parent.parent / "zigflac_tpu_torch" / "csrc"

# csrc/crc16.cu's block with its lanes run in turn. vec: the kernel's int4
# branch where the rows allow it (as zf_crc16_frames decides), else words.
HOST_HARNESS = r"""
#include <string.h>
#include "crc16_steps.cuh"

static constexpr ZfCrcTables kTables = zf_crc16_make_tables();
static constexpr ZfCrcShifts kShifts = zf_crc16_make_shifts();

extern "C" void zf_crc16_frames_host(uint32_t* words, const int64_t* byte_len, int64_t n,
                                     int64_t w, int write, int vec_ok, int64_t* crcs) {
  const bool vec = vec_ok && (uintptr_t)words % 16 == 0 && w % 4 == 0;
  for (int64_t f = 0; f < n; ++f) {
    uint32_t* row = words + f * w;
    const int64_t nb = byte_len[f];
    uint32_t crc = 0, old[2] = {0, 0};
    for (int lane = 0; lane < kZfCrcLanes; ++lane)
      crc ^= zf_crc16_lane(row, w, vec, nb, lane, kTables, kShifts.e, [&] {
        if (write && lane == 0) zf_crc16_deposit_read(row, w, nb, old);
      });
    crcs[f] = crc;
    if (write) zf_crc16_deposit_write(row, w, nb, crc, old);
  }
}

extern "C" int zf_crc16_lanes_host() { return kZfCrcLanes; }
extern "C" void zf_crc16_tables_host(uint16_t* tables, uint16_t* shifts) {
  memcpy(tables, &kTables, sizeof kTables);
  memcpy(shifts, &kShifts, sizeof kShifts);
}
extern "C" uint32_t zf_xpow8_host(uint64_t e) { return zf_xpow8(e); }
extern "C" uint32_t zf_mulmod_host(uint32_t a, uint32_t b) { return zf_gf2_mulmod(a, b); }
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """crc16_steps.cuh built for the host with g++ behind the kernel's block
    loop: host(words int32 [N, W], byte_len [N], write, vec) -> (crcs int64
    [N], words), the words a new array (16-byte aligned, so vec takes the
    int4 branch where W % 4 == 0)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel's arithmetic cannot be built on the host")
    d = tmp_path_factory.mktemp("crc_host")
    (d / "host.cpp").write_text(HOST_HARNESS)
    so = d / "host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-Wno-unknown-pragmas", "-shared",
         "-fPIC", "-I", str(CSRC), "-o", str(so), str(d / "host.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.zf_crc16_frames_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
    lib.zf_crc16_tables_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.zf_xpow8_host.argtypes = [ctypes.c_uint64]
    lib.zf_xpow8_host.restype = ctypes.c_uint32
    lib.zf_mulmod_host.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.zf_mulmod_host.restype = ctypes.c_uint32

    def run(words, byte_len, write=True, vec=True):
        w = np.array(words, np.int32, order="C", copy=True)
        assert w.ctypes.data % 16 == 0
        bl = np.ascontiguousarray(byte_len, np.int64)
        crcs = np.empty(w.shape[0], np.int64)
        lib.zf_crc16_frames_host(w.ctypes.data, bl.ctypes.data, w.shape[0], w.shape[1],
                                 bool(write), bool(vec), crcs.ctypes.data)
        return crcs, w

    run.lib = lib
    return run


def _check(host, words, byte_len):
    """Harness == plain == JAX for both write modes; returns the CRCs."""
    crcs, out = host(words, byte_len)
    t_crcs, t_out = tcrc16.crc16_frames_plain(torch.from_numpy(words),
                                              torch.from_numpy(byte_len))
    np.testing.assert_array_equal(crcs, t_crcs.numpy())
    np.testing.assert_array_equal(out, t_out.numpy())
    # the JAX package's CRC of a frame over its row is another value that
    # no caller reads (its padding index is not clamped)
    inside = byte_len <= 4 * words.shape[1]
    j_words, j_len = jnp.asarray(words), jnp.asarray(byte_len)
    j_crcs = jcrc16.crc16_words(j_words, j_len)
    np.testing.assert_array_equal(crcs[inside], np.asarray(j_crcs)[inside])
    np.testing.assert_array_equal(out, np.asarray(jbp.deposit_crc16(j_words, j_len, j_crcs)))
    crcs_ro, same = host(words, byte_len, write=False)
    np.testing.assert_array_equal(crcs_ro, crcs)
    np.testing.assert_array_equal(same, words)
    # the word branch (rows not on 16 bytes, or W % 4 != 0) gives the same
    crcs_w, out_w = host(words, byte_len, vec=False)
    np.testing.assert_array_equal(crcs_w, crcs)
    np.testing.assert_array_equal(out_w, out)
    return crcs


def _rows(rng, byte_len, w):
    """Random rows, zero at and past each frame's byte_len (as the deposit
    leaves them)."""
    words = rng.integers(-(1 << 31), 1 << 31, (len(byte_len), w)).astype(np.int32)
    be = words.astype(">i4").view(np.uint8).reshape(len(byte_len), 4 * w)
    for i, n in enumerate(byte_len):
        be[i, min(n, 4 * w):] = 0
    return be.view(">i4").astype(np.int32), np.asarray(byte_len, np.int64)


def _frame_bytes(words, n):
    return words.astype(">i4").tobytes()[:n]


@pytest.mark.parametrize("w", [1, 2, 3, 8, 37, 300, 3100])
def test_random_rows(host, rng, w):
    """Lengths 0-20 (every residue mod 4 and mod 16, and 0-3), every length
    about a round of the frame's lanes (16 x 64 bytes), a lane's batch of
    loads (four rounds) and their doubles, and the last 17 bytes of the
    row: the CRC bytes both inside, one past the row, both past it. W = 1,
    2, 3, 37 and 3100 take the word branch, 8 and 300 the int4 branch too."""
    ends = [1024 * k + d for k in (1, 2, 4, 8) for d in (-1, 0, 1, 15, 16, 17)]
    lens = sorted({n for n in (*range(21), 255, 256, 257, *ends, *range(4 * w - 16, 4 * w + 1))
                   if 0 <= n <= 4 * w})
    words, byte_len = _rows(rng, lens, w)
    crcs = _check(host, words, byte_len)
    for i, n in enumerate(lens):
        assert crcs[i] == jcrc.crc16(_frame_bytes(words[i], n))


def test_frames_over_the_row(host, rng):
    """byte_len past the row (a frame over its word budget): the CRC of the
    whole row, as the plain version's, and nothing written."""
    words, _ = _rows(rng, [40] * 3, 10)
    words[:, :] = rng.integers(-(1 << 31), 1 << 31, words.shape).astype(np.int32)
    byte_len = np.array([41, 100, 1 << 20], np.int64)
    crcs = _check(host, words, byte_len)
    assert (crcs == jcrc.crc16(_frame_bytes(words[0], 40))).tolist()[0]
    assert (host(words, byte_len)[1] == words).all()


def test_negative_lengths(host, rng):
    """A negative byte_len counts as 0: the CRC of no bytes, whatever the
    row holds, and nothing written; on rows zero past byte_len (as the
    deposit leaves them, and as the plain version assumes) the plain
    version's."""
    byte_len = np.array([-1, -2, -9], np.int64)
    words = rng.integers(-(1 << 31), 1 << 31, (3, 8)).astype(np.int32)
    zeros = np.zeros_like(words)
    for write in (True, False):
        for vec in (True, False):
            crcs, out = host(words, byte_len, write, vec)
            assert (crcs == 0).all() and (out == words).all()
            crcs, out = host(zeros, byte_len, write, vec)
            want = tcrc16.crc16_frames_plain(torch.from_numpy(zeros), torch.from_numpy(byte_len),
                                             write)
            np.testing.assert_array_equal(crcs, want[0].numpy())
            np.testing.assert_array_equal(out, want[1].numpy())


def test_gf2_powers_equal_the_tables(host):
    lib = host.lib
    for e in (0, 1, 2, 3, 7, 255, 256, 5503, 22016, 73_727, 1 << 20, (1 << 33) + 5):
        assert lib.zf_xpow8_host(e) == jcrc.xpow_mod(8 * e)
    rng = np.random.default_rng(5)
    for a, b in rng.integers(0, 1 << 16, (50, 2)):
        assert lib.zf_mulmod_host(int(a), int(b)) == jcrc.gf2_mulmod16(int(a), int(b))
    table = [jcrc.CRC16_TABLE[b] for b in range(256)]
    assert all(jcrc.crc16(bytes([b])) == table[b] for b in range(256))


def test_tables_equal_the_powers(host):
    """Each compile-time table against square and multiply (zf_xpow8,
    crc.xpow_mod) and crc.xpow_shift_table: a chunk table's entry for one
    bit is x^(its degree in the chunk + 16), every entry the XOR of its
    bits'; the Horner table's x^(shift + 128 G); the shift table's
    x^(8 (k - 15)), its negative powers inverting the positive ones."""
    lib = host.lib
    lanes = lib.zf_crc16_lanes_host()
    tables = np.zeros((4 * 6 + 3) * 64, np.uint16)
    shifts = np.zeros(16 * lanes, np.uint16)
    lib.zf_crc16_tables_host(tables.ctypes.data, shifts.ctypes.data)
    chunk, horner = tables[:4 * 6 * 64].reshape(4, 6, 64), tables[4 * 6 * 64:].reshape(3, 64)
    word_fields = [(26, 6), (20, 6), (14, 6), (8, 6), (2, 6), (0, 2)]
    shift_table = jcrc.xpow_shift_table(16)
    v = np.arange(64)
    for m in range(4):
        for f, (shift, width) in enumerate(word_fields):
            for b in range(width):
                e = 32 * (3 - m) + shift + b + 16
                assert chunk[m, f, 1 << b] == jcrc.xpow_mod(e)
                if (e - 16) % 8 == 0:
                    assert chunk[m, f, 1 << b] == shift_table[(e - 16) // 8]
            bits = [chunk[m, f, 1 << b] if b < width else 0 for b in range(6)]
            want = np.bitwise_xor.reduce([np.where((v >> b) & 1, bits[b], 0) for b in range(6)])
            np.testing.assert_array_equal(chunk[m, f, :1 << width], want[:1 << width])
    for f, (shift, width) in enumerate([(10, 6), (4, 6), (0, 4)]):
        for b in range(width):
            assert horner[f, 1 << b] == jcrc.xpow_mod(shift + b + 128 * lanes)
    for k in range(16 * lanes):
        if k >= 15:
            assert shifts[k] == lib.zf_xpow8_host(k - 15)
        else:
            assert lib.zf_mulmod_host(int(shifts[k]), lib.zf_xpow8_host(15 - k)) == 1
    assert (shifts[17:17 + 16] == shift_table).all()


def _packed_rows(rng, depth, B, n, tier_ratio, kind="mixed"):
    """Real frame rows: n frames through the port's CPU plan and pack, at
    the word budget of a capacity tier (None: the exact tier)."""
    frames = np.stack([make_signal(rng, B, 2, depth, kind) for _ in range(n)])
    cfg = EncoderConfig(block_size=B)
    plan = tan.plan_frames(torch.from_numpy(frames), depth, cfg)
    max_words = tbp.max_frame_words(B, 2, depth, tier_ratio)
    words, total_bits = tbp.pack_frames(plan, torch.arange(n), header_static(B, 44100, depth),
                                        B, cfg.max_rice_order, max_words, 0, cfg.lpc_precision)
    return words.numpy(), ((total_bits + 7) >> 3).numpy()


@pytest.mark.parametrize("depth,ratio,kind", [(16, 1.25, "mixed"), (24, 1.25, "sine"),
                                              (32, None, "noise"), (16, 0.1, "noise")])
def test_real_frame_rows(host, rng, depth, ratio, kind):
    """Rows of packed frames: config 1's tier-0 budget, 24-bit, 32-bit noise
    at the exact tier (73 KB rows at B = 4096), and a budget the noise
    overflows (frames over the row)."""
    words, byte_len = _packed_rows(rng, depth, 4096, 4, ratio, kind)
    if ratio is None:
        assert words.shape[1] * 4 > 73_000
    crcs = _check(host, words, byte_len)
    for i, n in enumerate(byte_len):
        if n <= words.shape[1] * 4:
            assert crcs[i] == jcrc.crc16(_frame_bytes(words[i], int(n)))
    assert (byte_len > words.shape[1] * 4).any() == (ratio == 0.1)


# -- the wrapper -------------------------------------------------------------------


def test_wrapper_takes_the_plain_version_on_the_cpu(rng):
    words, byte_len = _rows(rng, [0, 7, 30, 40], 10)
    tw, tb = torch.from_numpy(words), torch.from_numpy(byte_len)
    tcrc16.reset_counts()
    crcs, out = tcrc16.crc16_frames(tw, tb)
    want = tcrc16.crc16_frames_plain(tw, tb)
    assert torch.equal(crcs, want[0]) and torch.equal(out, want[1])
    assert torch.equal(tw, torch.from_numpy(words))  # the plain version copies
    crcs_ro, same = tcrc16.crc16_frames(tw, tb, write=False)
    assert same is tw and torch.equal(crcs_ro, crcs)
    assert (tcrc16.KERNEL_LAUNCHES, tcrc16.PLAIN_CALLS) == (0, 2)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    w = torch.zeros((3, 8), dtype=torch.int32)
    b = torch.zeros(3, dtype=torch.int64)
    bad = [
        ((w.to(torch.int64), b), TypeError),
        ((w, b.to(torch.int32)), TypeError),
        ((w[:, ::2], b), ValueError),
        ((w, b[:2]), ValueError),
        ((w[0], b[:1]), ValueError),
        ((torch.zeros((3, 0), dtype=torch.int32), b), ValueError),
        ((w.to("meta"), b.to("meta")), NotImplementedError),
    ]
    for args, exc in bad:
        with pytest.raises(exc):
            tcrc16.crc16_frames(*args)


# -- whole encodes with the harness in the kernel's place ------------------------------


def _patch_kernel(monkeypatch, host):
    calls = {"write": 0, "read": 0}

    def crc16_frames(words, byte_len, write=True):
        calls["write" if write else "read"] += 1
        crcs, out = host(words.numpy(), byte_len.numpy(), write)
        return torch.from_numpy(crcs), torch.from_numpy(out)

    monkeypatch.setattr(pipeline, "crc16_frames", crc16_frames)
    return calls


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_corpus_streams_through_the_harness(host, monkeypatch, name):
    """Every pinned corpus stream (the JAX package's bytes) with the CRC
    harness in the kernel's place."""
    case = next(c for c in CASES if c["name"] == name)
    calls = _patch_kernel(monkeypatch, host)
    flac = zigflac_tpu_torch.encode_wav_bytes(
        _wav_bytes(case), config=EncoderConfig(**asdict(_case_config(case))), device="cpu")
    with open(os.path.join(VEC_DIR, name + ".flac"), "rb") as f:
        assert hashlib.sha256(flac).digest() == hashlib.sha256(f.read()).digest()
    assert calls["write"] > 0


def test_exact_words_path_through_the_harness(host, rng, monkeypatch):
    """A batch past every capacity tier: the exact words path takes the CRCs
    without writing them (the host assembles each frame), and the bytes
    equal the plain run's."""
    x = rng.integers(-(1 << 31), 1 << 31, (2, 2 * 1024 + 99))
    buf = io.BytesIO()
    write_wav(buf, x, 44100, 32)
    cfg = EncoderConfig(block_size=1024)
    want = zigflac_tpu_torch.encode_wav_bytes(buf.getvalue(), config=cfg, device="cpu")
    monkeypatch.setattr(pipeline, "CAPACITY_LADDER", ((0.05, 0.1), (0.1, 0.2)))
    calls = _patch_kernel(monkeypatch, host)
    assert zigflac_tpu_torch.encode_wav_bytes(buf.getvalue(), config=cfg, device="cpu") == want
    assert calls["read"] > 0 and calls["write"] > 0
