"""Where one CTA of zf_frame_symbols spends its time, on one CUDA card.

    python3 tools/torch_symbols_phases.py

Copies csrc/symbols.cu under build/symbols_phases/, inserts clock64()
stamps that thread 0 of each CTA takes at the end of each phase (the
cycles since its last stamp go to that phase), builds that copy with nvcc
beside the real library and runs it on the plans of config 1's first batch
(1024 frames of 2 x 4096 samples, bench.py's recipe, seed 0xBEEF). Prints
one JSON line: for 132 frames (one CTA an SM: the chain alone) and for all
1024 (as the encode runs it), the mean cycles per frame of each phase, as
thread 0 sees them --

  header  thread 0 builds the frame header and its CRC-8
  fields  the subframe fields and partition params read, and the barrier
          after them
  keys    the escape partitions' largest residual keys, and its barriers
  tiles   the columns computed and val / nbv stored (thread 0's share)
  scan    the tile's barrier and the offsets: dep_cum stored

-- and the launch's CUDA-event ms (the stamps cost time of their own: take
the real kernel's time from tools/torch_symbols_kernel.py). It knows the
anchors of two layouts of symbols.cu, so it runs from an older checkout
too: the one-CTA-a-frame kernel with four neighbouring columns a thread,
and the column-a-lane kernel that replaced it. It stops with KeyError
where an anchor is gone. It imports nothing of JAX.
"""

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("header", "fields", "keys", "tiles", "scan")
# each layout: (a line only that layout has, [(anchor, "after" or "before",
# phase), ...]); an anchor is searched from the previous one on, so the
# list follows the source's order, and "end" marks where the CTA's sums
# are added to the totals (before its anchor)
LAYOUTS = {
    "four columns a thread": ("constexpr int kCols = 4;", [
        ("if (t == 0) hdr = zf_sym_header(", "after", "header"),
        ("for (int i = t; i < kZfSymParamCols; i += kThreads) keys[i] = 0u;", "after", None),
        ("__syncthreads();", "after", "fields"),
        ("__syncthreads();  // the header (c < 0) or the keys are in place", "after", "keys"),
        ("if (lane == 31) warp_sum[buf][warp] = x;", "after", "tiles"),
        ("buf ^= 1;", "after", "scan"),
        ("if (t == 0) a.total_bits[f] = carry;", "before", "end"),
    ]),
    "a column a lane": ("constexpr int kRounds = 4;", [
        ("if (lane == 0) zf_sym_header_crc(hdr,", "after", "header"),
        ("const bool any_esc = __syncthreads_or(esc);", "after", "fields"),
        ("const int64_t row = f * L.s;", "before", "keys"),
        ("if (lane == 0) warp_sum[buf][warp] = run;", "after", "tiles"),
        ("if (t == 0) carry[buf ^ 1] = carry[buf] + total;", "after", "scan"),
        ("if (t == 0) {", "before", "end"),
    ]),
}


def instrument(lines):
    """symbols.cu with the stamps of its layout, and their sums into g_ph."""
    layout = next((v for k, (mark, v) in LAYOUTS.items() if any(mark in ln for ln in lines)),
                  None)
    if layout is None:
        raise KeyError("no known layout of symbols.cu")
    ins, at = {}, 0
    for pat, where, phase in layout:
        at = next((i for i in range(at, len(lines)) if pat in lines[i]), None)
        if at is None:
            raise KeyError(pat)
        if phase == "end":
            ins.setdefault(at, []).append(
                "  if (threadIdx.x == 0) { for (int q = 0; q < %d; ++q) atomicAdd(&g_ph[q], "
                "zt_s[q]); atomicAdd(&g_ph[15], 1ull); }" % len(PHASES))
        elif phase:
            ins.setdefault(at + (where == "after"), []).append(
                "  if (threadIdx.x == 0) { const long long zt_n = clock64(); zt_s[%d] += "
                "zt_n - zt_s[15]; zt_s[15] = zt_n; }" % PHASES.index(phase))
        at += 1
    out = []
    for i, ln in enumerate(lines):
        out += ins.get(i, [])
        out.append(ln)
    src = "\n".join(out)
    # thread 0's sums and last stamp in shared memory (registers are the
    # kernel's limit), from the kernel's first line
    head = src.index("{", src.index("symbols_kernel(")) + 1
    src = (src[:head] + "\n  __shared__ long long zt_s[16]; if (threadIdx.x == 0) { for (int q "
           "= 0; q < 15; ++q) zt_s[q] = 0; zt_s[15] = clock64(); }" + src[head:])
    return src.replace("namespace {\n", "__device__ unsigned long long g_ph[16];\nnamespace {\n",
                       1) + r'''
extern "C" int phases_read(unsigned long long* o) {
  return cudaMemcpyFromSymbol(o, g_ph, sizeof(g_ph));
}
extern "C" int phases_reset() {
  unsigned long long z[16] = {};
  return cudaMemcpyToSymbol(g_ph, z, sizeof z);
}
'''


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("torch_symbols_phases: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from chip_smoke import BLOCK, CONFIG1_SECONDS, RATE, bench_wav, cuda_ms
    from zigflac_tpu_torch import EncoderConfig
    from zigflac_tpu_torch.models import pipeline as pl
    from zigflac_tpu_torch.ops import _build, analyze, symbols
    from zigflac_tpu_torch.wav import WavReader, write_wav

    csrc = os.path.join(HERE, "zigflac_tpu_torch", "csrc")
    with open(os.path.join(csrc, "symbols.cu")) as f:
        src = instrument(f.read().split("\n"))
    out_dir = os.path.join(HERE, "build", "symbols_phases")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "symbols_phases.cu"), os.path.join(out_dir, "phases.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                           "-I", csrc, cu, "-o", so], capture_output=True, text=True)
    if proc.returncode:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.zf_frame_symbols.argtypes = [ptr] * 12 + [i32] + [i64] * 3 + [ptr] + [i64] * 13 + [
        ptr] * 5
    lib.zf_frame_symbols.restype = ctypes.c_int

    dev = torch.device("cuda")
    cfg = EncoderConfig.default(2)
    r = WavReader.from_bytes(bench_wav(write_wav, CONFIG1_SECONDS * RATE))
    s = r.planar_samples()
    frames = torch.from_numpy(
        s[:, : 1024 * BLOCK].reshape(2, 1024, BLOCK).transpose(1, 0, 2).copy()).to(dev)
    hs, _, _ = pl.compact_shape(cfg, r.bit_depth, 2, BLOCK, r.sample_rate, 0, 1024)
    plan = analyze.plan_frames(frames, r.bit_depth, cfg)
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for n in (132, 1024):
        sub = analyze.FrameWirePlan(*(t[:n] if t.dim() == 1 else t[:, :n] for t in plan))
        fns = torch.arange(n, device=dev)
        outs = []

        def run():
            err, o = symbols.launch(lib.zf_frame_symbols, sub, fns, hs, BLOCK,
                                    cfg.max_rice_order, 0, cfg.lpc_precision, stream)
            if err:
                raise RuntimeError(f"zf_frame_symbols (stamped) failed: {err}")
            outs[:] = [o]

        ms = cuda_ms(torch, run, reps=20)
        lib.phases_reset()
        run()
        torch.cuda.synchronize()
        ph = (ctypes.c_ulonglong * 16)()
        lib.phases_read(ph)
        res[n] = {"ms": ms, "cycles_per_frame": {
            k: round(ph[q] / ph[15]) for q, k in enumerate(PHASES)}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    print(json.dumps({"what": "phases", "card": smi, "ptxas": regs, "frames": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
