"""The port's frame CRC-16 kernel alone on one CUDA card: build, check, time,
disassemble. Under a minute; chip_smoke.py owns the checks of the encode's
batches and the launch counts of the main path, this tool the times of
zf_crc16_frames' launches alone.

    python3 tools/torch_crc_kernel.py [--sass-out build/crc_kernel.sass]

Prints JSON lines:
  card   the card's name and power limit (nvidia-smi);
  build  nvcc's seconds and ptxas's registers, shared memory and spills of
         crc16_kernel (when this process built the library);
  check  kernel == plain version (crc16_words + deposit_crc16), CRCs and
         words, in both write modes, on watch cases: frame lengths 0-20
         (every residue mod 4 and mod 16), about a round of a frame's lanes
         and about the row's end, frames over the row (byte_len > 4W), rows
         of one to three words, W % 4 != 0, and rows that do not start on
         16 bytes;
  time   CUDA-event ms of the kernel's launches alone, back to back after a
         warm-up (mean of 50; graph_ms: the same 50 launches captured in one
         CUDA graph, without the host's issue of each), on the deposited rows of one 1024-frame batch
         each of config 1 (bench.py's recipe, seed 0xBEEF, tier 0, written
         in place as the encode does), config 3 (LPC) and 32-bit noise at
         the exact tier (write=False, as the exact-words path reads it);
         beside each, an empty kernel of the same grid (the floor of any
         launch), the bound of chip_smoke.crc_bound and the share of it;
         each timed input is checked against the plain version first;
  sass   from cuobjdump's disassembly of the library that was timed: the
         kernel's instructions by opcode and its largest straight-line
         blocks.

It imports nothing of JAX. It runs on an older checkout too (copy this file
and tools/torch_analyze_kernel.py into it): the C entry point is the same,
and the grid of the empty kernel is given for both kernels' shapes (one CTA
a frame, and four frames a CTA). Numbers hold for the card it ran on:
compare two kernels within one run.
"""

import argparse
import io
import json
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "tools"))
KERNELS = ("crc16_kernel",)


def log(what, **kv):
    print(json.dumps({"what": what, **kv}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass-out", default=None, help="write the kernel library's SASS here")
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("torch_crc_kernel: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke
    from chip_smoke import (BLOCK, CONFIG1_SECONDS, CONFIG3_SAMPLES, RATE, bench_wav, crc_bound,
                            cuda_ms)
    from torch_analyze_kernel import empty_launcher, graph_ms, sass_functions
    from zigflac_tpu_torch import EncoderConfig
    from zigflac_tpu_torch.models import pipeline as pl
    from zigflac_tpu_torch.ops import _build, analyze, bitpack, crc16, deposit
    from zigflac_tpu_torch.wav import WavReader, write_wav

    def smi(fields):
        return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()

    log("card", smi=smi("name,power.limit"))
    lib = _build.library()
    log("build", nvcc_s=_build.BUILD_SECONDS, kernels=chip_smoke.ptxas_of(KERNELS))

    dev = torch.device("cuda")
    rng = np.random.default_rng(0xC3C1)

    def check(words, byte_len, what):
        """Kernel == plain in both write modes; the write on a copy at the
        same offset from 16 bytes as ``words``."""
        want = crc16.crc16_frames_plain(words, byte_len)
        got_ro, same = crc16.crc16_frames(words, byte_len, write=False)
        off = (words.data_ptr() % 16) // 4  # torch.empty starts on 512 bytes
        buf = torch.empty(words.numel() + off, dtype=torch.int32, device=dev)
        copy = buf[off:].view(words.shape)
        copy.copy_(words)
        got, out = crc16.crc16_frames(copy, byte_len)
        if not (torch.equal(got_ro, want[0]) and torch.equal(got, want[0])
                and torch.equal(out, want[1]) and same is words):
            raise AssertionError(f"CRC kernel != plain on {what}")

    checked = []
    for w, offset in ((1, 0), (2, 0), (3, 0), (5, 0), (37, 0), (300, 0), (5504, 0), (5504, 1),
                      (5504, 2), (18432, 3)):
        ends = [1024 * k + d for k in (1, 2, 4, 8) for d in (-1, 0, 1, 15, 16, 17)]
        lens = np.array(sorted({n for n in (*range(21), *ends, *range(4 * w - 16, 4 * w + 1),
                                            4 * w + 9) if n >= 0}))
        be = rng.integers(0, 256, (lens.size, 4 * w), dtype=np.uint8)
        be[np.arange(4 * w)[None, :] >= lens[:, None]] = 0
        flat = torch.from_numpy(np.concatenate([np.zeros(offset, np.int32),
                                                be.view(">i4").astype(np.int32).ravel()]))
        words = flat.to(dev)[offset:].view(lens.size, w)
        check(words, torch.from_numpy(lens).to(dev), f"w {w} offset {offset}")
        checked.append(f"w{w}+{offset}")
    log("check", equal=checked)

    # -- the timed inputs: deposited rows of one batch each ----------------
    def batch_rows(wav, cfg, tier):
        r = WavReader.from_bytes(wav)
        s = r.planar_samples()
        n = min(1024, s.shape[1] // BLOCK)
        frames = torch.from_numpy(
            s[:, : n * BLOCK].reshape(2, n, BLOCK).transpose(1, 0, 2).copy()).to(dev)
        hs, max_words, _ = pl.compact_shape(cfg, r.bit_depth, 2, BLOCK, RATE, tier, n)
        plan = analyze.plan_frames(frames, r.bit_depth, cfg)
        d_cum, _, d_val, d_nbv = bitpack.frame_symbol_stream(
            plan, torch.arange(n, device=dev), hs, BLOCK, cfg.max_rice_order,
            analyze.lpc_order_of(cfg), cfg.lpc_precision)
        words = deposit.deposit_words(d_cum.to(torch.int32), d_val, d_nbv.to(torch.int32),
                                      max_words)
        return words, (d_cum[:, -1].to(torch.int64) + 7) >> 3

    noise = np.random.default_rng(0x3232).integers(-(1 << 31), 1 << 31, (2, 1024 * BLOCK))
    buf = io.BytesIO()
    write_wav(buf, noise, RATE, 32)
    cfg1 = EncoderConfig.default(2)
    cfg_lpc = replace(cfg1, prediction="lpc")
    cases = {
        "config1": (bench_wav(write_wav, CONFIG1_SECONDS * RATE), cfg1, 0, True),
        "config3_lpc": (bench_wav(write_wav, CONFIG3_SAMPLES), cfg_lpc, 0, True),
        "noise32_exact": (buf.getvalue(), cfg1, None, False),
    }
    stream = torch.cuda.current_stream().cuda_stream
    empty = empty_launcher(torch)
    out = {}
    for name, (wav, cfg, tier, write) in cases.items():
        words, byte_len = batch_rows(wav, cfg, tier)
        check(words, byte_len, name)
        n, w = words.shape
        crcs = torch.empty(n, dtype=torch.int64, device=dev)
        args = (words.data_ptr(), byte_len.data_ptr(), n, w, write, crcs.data_ptr())

        def run(s=stream):
            err = lib.zf_crc16_frames(*args, s)
            if err:
                raise RuntimeError(f"zf_crc16_frames: {lib.zf_error_string(err).decode()}")

        ms = cuda_ms(torch, run, reps=50)
        nbytes, bound_ms, bound_by, ops_ms = crc_bound(byte_len.cpu().numpy(), w)
        out[name] = {
            "rows": [n, w], "write": write, "frame_bytes": int(byte_len.sum()),
            "kernel_ms": ms, "graph_ms": graph_ms(torch, run), "bound_bytes": nbytes,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_ops_ms": ops_ms,
            "share_of_bound": bound_ms / ms,
            "empty_ms": {f"{g} x 256": cuda_ms(torch, lambda: empty(g, 256), reps=50)
                         for g in (n, (n + 3) // 4)},
            "empty_graph_ms": {f"{g} x 256": graph_ms(torch, lambda st: empty(g, 256, st))
                               for g in (n, (n + 3) // 4)}}
    log("time", clocks=smi("clocks.sm,clocks.max.sm"), **out)

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib._name], capture_output=True, text=True,
                          check=True).stdout
    if opts.sass_out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.sass_out)), exist_ok=True)
        with open(opts.sass_out, "w") as f:
            f.write(sass)
    log("sass", functions=sass_functions(sass, KERNELS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
