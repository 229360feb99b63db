"""The port's analysis kernels alone on one CUDA card: build, check, time,
disassemble. About a minute, where chip_smoke.py takes minutes; it owns the
times of zf_analyze_fixed's launches alone, chip_smoke.py the checks of the
encode's batches and the launch counts of the main path.

    python3 tools/torch_analyze_kernel.py [--sass-out build/analyze_kernel.sass]

Prints JSON lines:
  card   the card's name and power limit (nvidia-smi);
  build  nvcc's seconds, and ptxas's registers, shared memory and spills of
         every instance of zf_analyze_fixed's and zf_rice_estimate's kernels;
  check  kernel == plain version, every output field, on small watch cases:
         depths 8-32 and the int64 side plane, wide mode, blocks of 1 to
         65535 samples, partition orders 0-8, params up to 14 and 30, planes
         that do not start on 16 bytes, planes on both sides of the narrow
         arithmetic's limit, and the Rice entry on orders 0-32 at blocks
         of 66 to 65535 samples and on rows that do not start on 16 bytes;
  time   CUDA-event ms of zf_analyze_fixed's launches alone, back to back
         after a warm-up (mean of 50; graph_ms: the same 50 launches
         captured in one CUDA graph, without the host's issue), on config 1's batch (4 x 1024 planes
         of 4096 int32, 16-bit content from bench.py's recipe, seed 0xBEEF),
         the same shape of 24-bit content, the int64 side plane of 32-bit
         content (1 x 1024 x 4096), and config 1's 1,972-sample tail; and
         zf_rice_estimate on config 3's LPC residuals, beside an empty
         kernel of its grid (4096 CTAs of 256 threads), the floor of any
         launch. Beside each, the bound of chip_smoke.analysis_bound and the
         share of it; each timed input is checked against the plain version
         first;
  sass   from cuobjdump's disassembly of the library that was timed: for each
         instance of the two kernels, its instructions by opcode and its
         largest straight-line blocks (the unrolled runs of samples).

It imports nothing of JAX. It runs on an older checkout too (the parent's
kernel takes a trailing scratch pointer, passed as null). Numbers hold for
the card it ran on: compare two kernels within one run.
"""

import argparse
import collections
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("analyze_fixed_kernel", "rice_estimate_kernel")


def log(what, **kv):
    print(json.dumps({"what": what, **kv}), flush=True)


EMPTY_SOURCE = r"""
__global__ void zf_empty_kernel() {}
extern "C" int zf_empty_launch(unsigned grid, unsigned threads, void* stream) {
  zf_empty_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def empty_launcher(torch):
    """launch(grid, threads): an empty kernel's launch on the current stream,
    built with nvcc into the port's build directory: the floor under any
    kernel of the same grid."""
    import ctypes

    from zigflac_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "zf_empty_kernel.so"
    if not out.exists():
        src = _build.BUILD_DIR / "zf_empty_kernel.cu"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(EMPTY_SOURCE)
        _build._compile([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                         "-shared", "-Xcompiler", "-fPIC", str(src)], out)
    lib = ctypes.CDLL(str(out))
    lib.zf_empty_launch.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]

    def launch(grid, threads, stream=None):
        if stream is None:
            stream = torch.cuda.current_stream().cuda_stream
        if lib.zf_empty_launch(grid, threads, stream):
            raise RuntimeError("empty kernel launch failed")
    return launch


def graph_ms(torch, launch, reps=50):
    """Mean device milliseconds of launch(stream) over ``reps`` launches
    captured in one CUDA graph and replayed (after a warm-up replay): the
    kernel's time without the host's issue of each launch, which back to
    back ctypes launches of a short kernel wait on."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(side.cuda_stream)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(reps):
            launch(stream)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sass_functions(text, kernels=KERNELS, top=3):
    """Per instance of the named kernels: instruction count by opcode and
    the ``top`` largest branch-free blocks with their opcodes."""
    out, block, blocks, ops, name = {}, [], [], collections.Counter(), None

    def close():
        if block:
            blocks.append(list(block))
        block.clear()

    def finish():
        close()
        if name is not None:
            big = sorted(blocks, key=len, reverse=True)[:top]
            out[name] = {"instructions": sum(ops.values()), "ops": dict(ops.most_common()),
                         "largest_blocks": [{"instructions": len(b),
                                             "ops": dict(collections.Counter(b).most_common())}
                                            for b in big]}
        blocks.clear()
        ops.clear()

    for line in text.splitlines():
        if "Function :" in line:
            finish()
            fn = line.split("Function :")[1].strip()
            name = fn if any(k in fn for k in kernels) else None
            continue
        if name is None:
            continue
        if re.match(r"\s*\.L_", line):
            close()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if not m:
            continue
        op = m.group(1)
        ops[op] += 1
        block.append(op)
        if op.split(".")[0] in ("BRA", "BRX", "EXIT", "RET", "BSYNC", "BAR", "WARPSYNC", "CALL"):
            close()
    finish()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass-out", default=None, help="write the kernel library's SASS here")
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("torch_analyze_kernel: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke
    from chip_smoke import (BLOCK, CONFIG1_SECONDS, CONFIG3_SAMPLES, RATE, _analysis_planes,
                            analysis_bound, bench_wav, cuda_ms)
    from zigflac_tpu_torch import EncoderConfig
    from zigflac_tpu_torch.ops import _build, analyze, lpc
    from zigflac_tpu_torch.wav import WavReader, write_wav

    def smi(fields):
        return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()

    log("card", smi=smi("name,power.limit"))
    lib = _build.library()
    # an older checkout's chip_smoke has no ptxas_of
    ptxas_of = getattr(chip_smoke, "ptxas_of", lambda kernels: "not reported")
    log("build", nvcc_s=_build.BUILD_SECONDS, kernels=ptxas_of(KERNELS))

    dev = torch.device("cuda")
    rng = np.random.default_rng(0xA7A2)
    parent_abi = hasattr(lib, "zf_shared_max_po")  # a trailing scratch pointer

    def fields_equal(got, want):
        return all(torch.equal(g, w) for g, w in zip(got, want))

    def check_fixed(x, wide, mro=8, max_param=14):
        x = x if torch.is_tensor(x) else torch.from_numpy(x).to(dev)
        got = analyze.analyze_fixed(x, wide, mro, max_param)
        if not fields_equal(got, analyze.analyze_fixed_plain(x, wide, mro, max_param)):
            raise AssertionError(f"analysis kernel != plain on {tuple(x.shape)} {x.dtype}, "
                                 f"wide {wide}, {mro}, {max_param}")

    def check_rice(res, order, mro=8, max_param=14):
        r = res if torch.is_tensor(res) else torch.from_numpy(res).to(dev)
        o = order if torch.is_tensor(order) else torch.from_numpy(order).to(dev)
        got = analyze.rice_estimate_planes(r, o, mro, max_param)
        if not fields_equal(got, analyze.rice_estimate(r, o, r.shape[-1], mro, max_param)):
            raise AssertionError(f"Rice kernel != plain on {tuple(r.shape)}, {mro}, {max_param}")

    checked = []
    for depth in (8, 16, 24, 28, 32, 33):
        check_fixed(_analysis_planes(rng, 20, BLOCK, depth), depth >= 28, 8,
                    30 if depth > 16 else 14)
        checked.append(f"depth{depth}")
    for b in (1, 5, 17, 64, 256, 1152, 1972, 4608, 65535):
        check_fixed(_analysis_planes(rng, 3 if b == 65535 else 10, b, 16), False)
        checked.append(f"b{b}")
    for mro, max_param in ((0, 14), (3, 30), (8, 30)):
        check_fixed(_analysis_planes(rng, 10, BLOCK, 24), False, mro, max_param)
        checked.append(f"rice{mro}/{max_param}")
    # a plane that does not start on 16 bytes (the one-CTA-a-plane kernel)
    flat = torch.from_numpy(_analysis_planes(rng, 11, BLOCK, 16).reshape(-1)).to(dev)
    check_fixed(flat[1:1 + 10 * BLOCK].view(10, BLOCK), False)
    checked.append("unaligned")
    # planes at the narrow arithmetic's limit of |x| (2^24 - 1) and one past
    for lim in ((1 << 24) - 1, 1 << 24):
        t = np.arange(BLOCK)
        rows = [np.where(t % 2 == 0, lim, -lim), np.full(BLOCK, -lim),
                np.clip(rng.integers(-lim, lim + 1, BLOCK), -lim, lim)]
        rows[2][17] = lim
        for wide in (False, True):
            check_fixed(np.stack(rows).astype(np.int32), wide, 8, 30)
        checked.append(f"limit{lim}")
    orders = np.arange(33).repeat(2)
    for b in (4096, 256, 66, 1972, 4098, 65535):
        res = rng.integers(-3000, 3000, (orders.size, b)).astype(np.int32)
        res[np.arange(b)[None, :] < orders[:, None]] = 0
        res[1::2] >>= 10
        for max_param in (14, 30):
            check_rice(res, orders, 8, max_param)
        checked.append(f"rice_orders_b{b}")
    # residual rows that do not start on 16 bytes (the runs' word loads)
    flat = torch.from_numpy(rng.integers(-3000, 3000, orders.size * BLOCK + 1)
                            .astype(np.int32)).to(dev)
    check_rice(flat[1:].view(orders.size, BLOCK), orders)
    checked.append("rice_unaligned")
    log("check", equal=checked)

    # -- the timed inputs --------------------------------------------------------
    def stereo_planes(wav, n_frames, tail=False):
        s = WavReader.from_bytes(wav).planar_samples()
        if tail:
            full = s.shape[1] // BLOCK * BLOCK
            fr = torch.from_numpy(s[:, full:][:, None].copy()).to(dev)
        else:
            fr = torch.from_numpy(s[:, : n_frames * BLOCK].reshape(2, n_frames, BLOCK)
                                  .copy()).to(dev)
        left, right = fr[0].to(torch.int64), fr[1].to(torch.int64)
        return left, right, (left + right) >> 1, left - right

    def lrms32(wav, n_frames=1024, tail=False):
        return torch.stack(stereo_planes(wav, n_frames, tail)).to(torch.int32).contiguous()

    wav1 = bench_wav(write_wav, CONFIG1_SECONDS * RATE)
    wav24 = bench_wav(write_wav, 1024 * BLOCK, depth=24)
    wav32 = bench_wav(write_wav, 1024 * BLOCK, depth=32)
    wav3 = bench_wav(write_wav, CONFIG3_SAMPLES)
    cases = {
        "config1": (lrms32(wav1), False, 14),
        "depth24": (lrms32(wav24), False, 30),
        "side33_int64": (stereo_planes(wav32, 1024)[3][None].contiguous(), True, 30),
        "config1_tail1972": (lrms32(wav1, tail=True), False, 14),
    }
    stream = torch.cuda.current_stream().cuda_stream

    def raw_fixed(x, wide, max_param):
        """The kernel's launch alone, on outputs made once."""
        *batch, b = x.shape
        p = x.numel() // b
        i64 = dict(dtype=torch.int64, device=dev)
        outs = [torch.empty(p, **i64), torch.empty(p, dtype=torch.bool, device=dev),
                torch.empty((p, b), dtype=torch.int32, device=dev),
                torch.empty(p, **i64), torch.empty(p, **i64), torch.empty(p, **i64),
                torch.empty((p, 256), **i64), torch.empty(p, dtype=torch.bool, device=dev)]
        args = [x.data_ptr(), x.dtype == torch.int64, p, b, bool(wide), 8, max_param,
                *(o.data_ptr() for o in outs)]
        if parent_abi:
            args.append(None)

        def run(s=stream, outs=outs):  # the outputs live as long as run
            err = lib.zf_analyze_fixed(*args, s)
            if err:
                raise RuntimeError(f"zf_analyze_fixed: {lib.zf_error_string(err).decode()}")
        return run

    out = {}
    for name, (x, wide, max_param) in cases.items():
        check_fixed(x, wide, 8, max_param)
        run = raw_fixed(x, wide, max_param)
        ms = cuda_ms(torch, run, reps=50)
        b = x.shape[-1]
        nbytes, bound_ms, bound_by, ops_ms = analysis_bound(x.numel() // b, b, x.element_size(),
                                                            True)
        out[name] = {"planes": list(x.shape), "dtype": str(x.dtype), "wide": wide,
                     "kernel_ms": ms, "graph_ms": graph_ms(torch, run), "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_ops_ms": ops_ms,
                     "share_of_bound": bound_ms / ms}

    cfg = EncoderConfig.default(2)
    l_order, l_res, *_ = lpc.analyze_lpc(lrms32(wav3), cfg.lpc_order, cfg.lpc_precision)
    check_rice(l_res, l_order)
    r_args = [l_res.data_ptr(), l_order.data_ptr(), l_order.numel(), BLOCK, 8, 14]
    r_outs = [torch.empty(l_order.numel(), dtype=torch.int64, device=dev) for _ in range(3)]
    r_outs.append(torch.empty((l_order.numel(), 256), dtype=torch.int64, device=dev))
    r_args += [o.data_ptr() for o in r_outs] + ([None] if parent_abi else [])
    r_run = lambda s=stream: lib.zf_rice_estimate(*r_args, s)
    ms = cuda_ms(torch, r_run, reps=50)
    nbytes, bound_ms, bound_by, ops_ms = analysis_bound(l_order.numel(), BLOCK, 4, False)
    empty = empty_launcher(torch)
    p3 = l_order.numel()
    out["config3_lpc_rice"] = {"residuals": list(l_res.shape), "kernel_ms": ms,
                               "graph_ms": graph_ms(torch, r_run), "bound_ms": bound_ms,
                               "bound_by": bound_by, "bound_ops_ms": ops_ms,
                               "share_of_bound": bound_ms / ms,
                               "empty_grid_ms": cuda_ms(torch, lambda: empty(p3, 256), reps=50),
                               "empty_grid_graph_ms": graph_ms(
                                   torch, lambda s: empty(p3, 256, s))}
    log("time", clocks=smi("clocks.sm,clocks.max.sm"), **out)

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib._name], capture_output=True, text=True,
                          check=True).stdout
    if opts.sass_out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.sass_out)), exist_ok=True)
        with open(opts.sass_out, "w") as f:
            f.write(sass)
    log("sass", functions=sass_functions(sass))
    return 0


if __name__ == "__main__":
    sys.exit(main())
