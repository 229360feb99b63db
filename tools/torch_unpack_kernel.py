"""The port's PCM unpack kernel alone on one CUDA card: build, check, time.
Under a minute; chip_smoke.py owns the checks of the encode and the launch
counts of the main path, this tool the times of zf_unpack_pcm's launches
alone and of the host work on either side of the card-fed route.

    python3 tools/torch_unpack_kernel.py [--sass-out build/unpack_kernel.sass]

Prints JSON lines:
  card   the card's name and power limit (nvidia-smi);
  build  nvcc's seconds and ptxas's registers, shared memory and spills of
         every unpack_kernel instance (when this process built the library);
  check  kernel == plain version at every depth 4-32 (1-8 channels, bucket
         rows past nreal, one-sample and 4095-sample tail rows);
  time   on the bytes of one 1024-frame batch of config 1 (bench.py's
         recipe, 16-bit / 44.1 kHz stereo) and of config 2 (24-bit / 96 kHz
         stereo), each checked against the host de-interleave first:
         CUDA-event ms of the kernel's launches alone, back to back after a
         warm-up (mean of 50; graph_ms: the same 50 launches in one CUDA
         graph), through the wrapper, the plain version, the int16 -> int32
         cast of the planar route (config 1) and an empty kernel of the same
         grid, beside the bound of chip_smoke.unpack_bound and the share of
         it; and the host's milliseconds (median of 5) of the planar route's
         feed (the de-interleave, the int16 narrowing of the batch view and
         its pinned copy) against the card-fed route's staging (one memcpy
         into pinned memory and the copy's issue);
  sass   from cuobjdump's disassembly of the library that was timed: each
         instance's instructions by opcode.

It imports nothing of JAX. Numbers hold for the card it ran on: compare two
kernels within one run.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "tools"))
KERNELS = ("unpack_kernel",)


def log(what, **kv):
    print(json.dumps({"what": what, **kv}), flush=True)


def host_ms(fn, reps=5):
    """Median wall milliseconds of fn() on the host, after a warm-up."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass-out", default=None, help="write the kernel library's SASS here")
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("torch_unpack_kernel: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke
    from chip_smoke import (CONFIG1_SECONDS, CONFIG2_RATE, CONFIG2_SAMPLES, RATE, bench_wav,
                            cuda_ms, unpack_batch, unpack_bound)
    from torch_analyze_kernel import empty_launcher, graph_ms, sass_functions
    from zigflac_tpu_torch import EncoderConfig
    from zigflac_tpu_torch.models import pipeline as pl
    from zigflac_tpu_torch.ops import _build, unpack
    from zigflac_tpu_torch.wav import WavReader, write_wav

    def smi(fields):
        return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()

    log("card", smi=smi("name,power.limit"))
    lib = _build.library()
    log("build", nvcc_s=_build.BUILD_SECONDS, kernels=chip_smoke.ptxas_of(KERNELS))

    dev = torch.device("cuda")
    rng = np.random.default_rng(0x0A9C)
    checked = 0
    for depth in range(4, 33):
        nb, c = (depth + 7) // 8, 1 + depth % 8
        data = torch.from_numpy(rng.integers(0, 256, 6 * 4095 * c * nb, dtype=np.uint8)).to(dev)
        for block, nreal, n in ((4095, 6, 8), (1, 1, 1), (4095, 1, 1)):
            if not torch.equal(unpack.unpack_pcm(data, c, nb, depth, block, nreal, n),
                               unpack.unpack_pcm_plain(data, c, nb, depth, block, nreal, n)):
                raise AssertionError(f"unpack kernel != plain at depth {depth}, {c} channels, "
                                     f"block {block}, {nreal} of {n} rows")
            checked += 1
    log("check", equal=checked)

    stream = torch.cuda.current_stream().cuda_stream
    empty = empty_launcher(torch)
    cases = {"config1": bench_wav(write_wav, CONFIG1_SECONDS * RATE),
             "config2": bench_wav(write_wav, CONFIG2_SAMPLES, depth=24, rate=CONFIG2_RATE)}
    out = {}
    for name, wav in cases.items():
        pcm, c, nb, depth, block, n = unpack_batch(WavReader, wav)
        data = torch.from_numpy(pcm.copy()).to(dev)
        frames = torch.empty((n, c, block), dtype=torch.int32, device=dev)
        r = WavReader.from_bytes(wav)
        planar = r.planar_samples()[:, : n * block]
        view = planar.reshape(c, n, block).transpose(1, 0, 2)
        if not np.array_equal(unpack.unpack_pcm(data, c, nb, depth, block, n, n).cpu().numpy(),
                              view):
            raise AssertionError(f"unpack kernel != the host de-interleave on {name}")

        def run(s=stream):
            err = lib.zf_unpack_pcm(data.data_ptr(), frames.data_ptr(), c, nb, depth, block, n,
                                    n, s)
            if err:
                raise RuntimeError(f"zf_unpack_pcm: {lib.zf_error_string(err).decode()}")

        ms = cuda_ms(torch, run, reps=50)
        nbytes, bound_ms, bound_by, ops_ms = unpack_bound(n, c, block, nb)
        grid = ((block + 255) // 256) * n
        pipe = pl.DevicePipeline(EncoderConfig.default(c), depth, dev)
        mv = r.raw_pcm_bytes()[: pcm.size]
        entry = {
            "frames": [n, c, block], "nb": nb, "kernel_ms": ms, "graph_ms": graph_ms(torch, run),
            "wrapper_ms": cuda_ms(torch, lambda: unpack.unpack_pcm(data, c, nb, depth, block,
                                                                   n, n), reps=50),
            "plain_ms": cuda_ms(torch, lambda: unpack.unpack_pcm_plain(data, c, nb, depth, block,
                                                                       n, n), reps=5),
            "bound_bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ops_ms": ops_ms, "share_of_bound": bound_ms / ms,
            "empty_ms": {f"{grid} x 256": cuda_ms(torch, lambda: empty(grid, 256), reps=50)},
            "empty_graph_ms": {f"{grid} x 256": graph_ms(torch, lambda st: empty(grid, 256, st))},
            "host_ms": {
                "planar_deinterleave": host_ms(
                    lambda: WavReader(r.sample_rate, depth, c, nb, n * block, mv)
                    .planar_samples()),
                "planar_narrow_and_pin": host_ms(
                    lambda: torch.from_numpy(np.require(pipe._narrow(view), requirements="CW"))
                    .pin_memory()),
                "card_fed_stage": host_ms(lambda: pipe._stage_pcm(mv)),
            }}
        if depth <= 16:
            planes16 = torch.from_numpy(view.astype(np.int16)).to(dev)
            entry["cast_ms"] = cuda_ms(torch, lambda: planes16.to(torch.int32), reps=50)
        out[name] = entry
        del data, frames
        torch.cuda.synchronize()
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
