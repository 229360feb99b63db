"""Where one CTA of zf_analyze_fixed spends its time, on one CUDA card.

    python3 tools/torch_analyze_phases.py

Copies csrc/analyze.cu under build/analyze_phases/, inserts clock64() stamps
that thread 0 of each CTA takes at the phase boundaries of the
one-CTA-a-plane kernel (and in its Rice sweep), builds that copy with nvcc
beside the real library and runs it on config 1's planes (4 x 1024 x 4096
int32, bench.py's recipe, seed 0xBEEF). Prints one JSON line: for 132
planes (one CTA an SM: the chain alone) and for all 4096 (four CTAs an SM,
as the encode runs it), the mean cycles per plane of each phase --

  pass1   the loads, the narrow/wide choice and pass 1
  order   the warp sums, the barrier and the order choice
  pass2   the residuals, their stores, the partition sums and a barrier
  nodes   every node's Rice param and the level shares (rice_sweep)
  B4      the barrier after them
  totals  warp 0's level totals
  choice  the partition order
  params  the params row and the scalars

-- and the launch's CUDA-event ms (the stamps cost time of their own: take
the real kernel's time from tools/torch_analyze_kernel.py). The stamps'
anchors are lines of analyze.cu; it stops with KeyError where one is gone.
It imports nothing of JAX.
"""

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("pass1", "order", "pass2", "nodes", "B4", "totals", "choice", "params")


def instrument(lines):
    """analyze.cu with the stamps, and their accumulation into g_ph."""
    def find(pat, after=0):
        for i in range(after, len(lines)):
            if pat in lines[i]:
                return i
        raise KeyError(pat)

    stamp = lambda k: f"  if (threadIdx.x == 0) zt_s[{k}] = clock64();"
    acc = ("  if (threadIdx.x == 0) { for (int q = 0; q < %d; ++q) atomicAdd(&g_ph[q], "
           "(unsigned long long)(zt_s[q + 1] - zt_s[q])); atomicAdd(&g_ph[15], 1ull); }"
           % len(PHASES))
    ins = {}

    def put(i, *xs):
        ins.setdefault(i, []).extend(xs)

    g = find("analyze_fixed_kernel(const T*")
    put(find("sweep_zero(sh, po_top);", g) + 1, stamp(0))
    put(find("int order;", g), stamp(1))
    i2 = find("block_order(acc, part", g)
    put(i2 + 1, stamp(2))
    i3 = find("__syncthreads();", i2)
    put(i3 + 1, stamp(3))
    put(find("params + pl * kZfParamCols);", i3) + 1, stamp(8), acc)
    r = find("__device__ __forceinline__ void rice_sweep(")
    r1 = find("  __syncthreads();", r)
    put(r1, stamp(4))
    put(r1 + 1, stamp(5))
    f = find("__device__ __forceinline__ void rice_finish(", r1)
    put(find("  const int best = zf_part_order_of_key(", f), stamp(6))
    put(find("  const uint8_t* kb", f), stamp(7))
    out = []
    for i, ln in enumerate(lines):
        out += ins.get(i, [])
        out.append(ln)
    src = "\n".join(out).replace(
        "namespace {\n",
        "__device__ unsigned long long g_ph[16];\n__shared__ long long zt_s[16];\nnamespace {\n", 1)
    return src + r'''
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
        print("torch_analyze_phases: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from chip_smoke import BLOCK, CONFIG1_SECONDS, RATE, bench_wav, cuda_ms
    from zigflac_tpu_torch.ops import _build
    from zigflac_tpu_torch.wav import WavReader, write_wav

    csrc = os.path.join(HERE, "zigflac_tpu_torch", "csrc")
    with open(os.path.join(csrc, "analyze.cu")) as f:
        src = instrument(f.read().split("\n"))
    out_dir = os.path.join(HERE, "build", "analyze_phases")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "analyze_phases.cu"), os.path.join(out_dir, "phases.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", csrc, cu,
                           "-o", so], capture_output=True, text=True)
    if proc.returncode:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    lib.zf_analyze_fixed.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                                     ctypes.c_int64] + [ctypes.c_void_p] * 9

    dev = torch.device("cuda")
    s = WavReader.from_bytes(bench_wav(write_wav, CONFIG1_SECONDS * RATE)).planar_samples()
    fr = torch.from_numpy(s[:, :1024 * BLOCK].reshape(2, 1024, BLOCK).copy()).to(dev)
    left, right = fr[0].long(), fr[1].long()
    x = torch.stack([left, right, (left + right) >> 1, left - right]).int().contiguous()
    p = x.numel() // BLOCK
    i64 = dict(dtype=torch.int64, device=dev)
    outs = [torch.empty(p, **i64), torch.empty(p, dtype=torch.bool, device=dev),
            torch.empty((p, BLOCK), dtype=torch.int32, device=dev), torch.empty(p, **i64),
            torch.empty(p, **i64), torch.empty(p, **i64), torch.empty((p, 256), **i64),
            torch.empty(p, dtype=torch.bool, device=dev)]
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for planes in (132, p):
        args = [x.data_ptr(), 0, planes, BLOCK, 0, 8, 14, *(o.data_ptr() for o in outs), stream]
        ms = cuda_ms(torch, lambda: lib.zf_analyze_fixed(*args), reps=20)
        lib.phases_reset()
        lib.zf_analyze_fixed(*args)
        torch.cuda.synchronize()
        ph = (ctypes.c_ulonglong * 16)()
        lib.phases_read(ph)
        res[planes] = {"ms": ms, "cycles_per_plane": {
            k: round(ph[q] / ph[15]) for q, k in enumerate(PHASES)}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"what": "phases", "card": smi, "planes": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
