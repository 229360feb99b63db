"""The port's frame symbols kernel alone on one CUDA card: build, check, time,
disassemble. About a minute; chip_smoke.py owns the checks of the encode's
batches and the launch counts of the main path, this tool the times of
zf_frame_symbols' launches alone.

    python3 tools/torch_symbols_kernel.py [--sass-out build/symbols_kernel.sass]

Prints JSON lines:
  card   the card's name and power limit (nvidia-smi);
  build  nvcc's seconds and ptxas's registers, shared memory and spills of
         both instances of symbols_kernel (int32 and int64 planes), when
         this process built the library;
  check  kernel == plain version (bitpack.frame_symbol_stream), every
         column of dep_cum, val and nbv and total_bits, on the synthetic
         plans of chip_smoke.SYMBOL_WATCH;
  time   CUDA-event ms of the kernel's launches alone, back to back after a
         warm-up (mean of 50; graph_ms: the same 50 launches captured in
         one CUDA graph, without the host's issue of each), on the plans of
         one 1024-frame batch each of config 1 (bench.py's recipe, seed
         0xBEEF), config 3 (LPC), the 32-bit input (LPC, 33-bit side plane
         in int64) and 32-bit noise at the exact tier (verbatim subframes,
         as the exact tier's re-encode sees them); the wrapper's time (frame_symbols,
         with its checks and allocations) and the plain version's beside
         them; an empty kernel of the same grid (the floor of any launch),
         the bound of chip_smoke.symbols_bound and the share of it; each
         timed input is checked against the plain version first;
  sass   from cuobjdump's disassembly of the library that was timed: the
         kernel's instructions by opcode and its largest straight-line
         blocks.

It imports nothing of JAX. It needs tools/torch_analyze_kernel.py beside it
(the empty kernel, the graph timer, the SASS counter). Numbers hold for the
card it ran on: compare two kernels within one run.
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
KERNELS = ("symbols_kernel",)


def log(what, **kv):
    print(json.dumps({"what": what, **kv}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass-out", default=None, help="write the kernel library's SASS here")
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("torch_symbols_kernel: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke
    from chip_smoke import (BLOCK, CONFIG1_SECONDS, CONFIG3_SAMPLES, DEPTH32_SAMPLES,
                            SYMBOL_FRAME_NUMBERS, SYMBOL_RATES, SYMBOL_WATCH, bench_wav,
                            cuda_ms, symbols_bound, synthetic_plan)
    from torch_analyze_kernel import empty_launcher, graph_ms, sass_functions
    from zigflac_tpu_torch import EncoderConfig
    from zigflac_tpu_torch.models import pipeline as pl
    from zigflac_tpu_torch.ops import _build, analyze, bitpack, symbols
    from zigflac_tpu_torch.ops.header import header_static
    from zigflac_tpu_torch.wav import WavReader, write_wav

    def smi(fields):
        return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()

    log("card", smi=smi("name,power.limit"))
    lib = _build.library()
    log("build", nvcc_s=_build.BUILD_SECONDS, kernels=chip_smoke.ptxas_of(KERNELS))
    dev = torch.device("cuda")

    def check(plan, fns, hs, b, mro, lpc_order, prec, what):
        got = symbols.frame_symbols(plan, fns, hs, b, mro, lpc_order, prec)
        d, tb, v, nb = bitpack.frame_symbol_stream(plan, fns, hs, b, mro, lpc_order, prec)
        for g, w in zip(got, (d.to(torch.int32), tb, v, nb.to(torch.int32))):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"symbols kernel != plain on {what}")
        return got

    checked = []
    for n, w, b, mro, lpc_order, depth, side, wasted in SYMBOL_WATCH:
        rng = np.random.default_rng(b * 31 + w * 7 + mro + lpc_order + depth)
        plan = analyze.FrameWirePlan(*(t.to(dev) for t in synthetic_plan(
            rng, n, w, b, mro, lpc_order, depth, side, wasted)))
        fns = torch.tensor([SYMBOL_FRAME_NUMBERS[(i * 3) % len(SYMBOL_FRAME_NUMBERS)]
                            for i in range(n)], device=dev)
        hs = header_static(b, SYMBOL_RATES[b % len(SYMBOL_RATES)], depth)
        check(plan, fns, hs, b, mro, lpc_order, 15, f"watch {b} {w}")
        checked.append(f"B{b} w{w} mro{mro} lpc{lpc_order} d{depth}")
    torch.cuda.synchronize()
    log("check", equal=checked)

    def batch_plan(wav, cfg, tier):
        r = WavReader.from_bytes(wav)
        s = r.planar_samples()
        n = min(1024, s.shape[1] // BLOCK)
        frames = torch.from_numpy(
            s[:, : n * BLOCK].reshape(2, n, BLOCK).transpose(1, 0, 2).copy()).to(dev)
        hs, _, _ = pl.compact_shape(cfg, r.bit_depth, 2, BLOCK, r.sample_rate, tier, n)
        return analyze.plan_frames(frames, r.bit_depth, cfg), torch.arange(n, device=dev), hs

    cfg1 = EncoderConfig.default(2)
    cfg_lpc = replace(cfg1, prediction="lpc")
    noise = np.random.default_rng(0x3232).integers(-(1 << 31), 1 << 31, (2, 1024 * BLOCK))
    buf = io.BytesIO()
    write_wav(buf, noise, 44100, 32)
    cases = {
        "config1": (bench_wav(write_wav, CONFIG1_SECONDS * 44100), cfg1, 0),
        "config3_lpc": (bench_wav(write_wav, CONFIG3_SAMPLES), cfg_lpc, 0),
        "depth32_lpc": (bench_wav(write_wav, DEPTH32_SAMPLES, depth=32), cfg_lpc, 0),
        "noise32_exact": (buf.getvalue(), cfg1, None),
    }
    stream = torch.cuda.current_stream().cuda_stream
    empty = empty_launcher(torch)
    out = {}
    for name, (wav, cfg, tier) in cases.items():
        plan, fns, hs = batch_plan(wav, cfg, tier)
        lpc_order = analyze.lpc_order_of(cfg)
        args = (plan, fns, hs, BLOCK, cfg.max_rice_order, lpc_order, cfg.lpc_precision)
        got = check(*args, name)
        n = plan.kind.shape[1]
        outs = []

        def run(s=stream):
            err, o = symbols.launch(lib.zf_frame_symbols, *args, s)
            if err:
                raise RuntimeError(f"zf_frame_symbols: {lib.zf_error_string(err).decode()}")
            outs[:] = [o]  # alive until the next launch is enqueued

        nbytes, bound_ms, bound_by, ops_ms = symbols_bound(plan, got[0].shape[1])
        ms = cuda_ms(torch, run, reps=50)
        out[name] = {
            "frames": n, "columns": got[0].shape[1], "planes": str(plan.planes.dtype),
            "kernel_ms": ms, "graph_ms": graph_ms(torch, run),
            "wrapper_ms": cuda_ms(torch, lambda: symbols.frame_symbols(*args), reps=20),
            "plain_ms": cuda_ms(torch, lambda: bitpack.frame_symbol_stream(*args), reps=3),
            "bound_bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ops_ms": ops_ms, "share_of_bound": bound_ms / ms,
            "empty_ms": cuda_ms(torch, lambda: empty(n, 256), reps=50),
            "empty_graph_ms": graph_ms(torch, lambda st: empty(n, 256, st))}
        del plan, got, outs
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
