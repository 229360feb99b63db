"""The port's lag sums kernel (zf_lag_sums, csrc/lags.cu) alone on one CUDA
card: build, check, time, disassemble. About two and a half minutes with
the build (the plain version's timings take most); chip_smoke.py times the
kernel through its wrapper and counts its launches on the main path.

    python3 tools/torch_lags_kernel.py [--sass-out build/lags_kernel.sass]

Prints JSON lines:
  card   the card's name and power limit (nvidia-smi);
  build  nvcc's seconds, and ptxas's registers, shared memory and spills of
         every instance of lag_sums_kernel (int32 narrow, int32 and int64
         limbs; 9 and 13 lags a thread);
  check  kernel == plain lag_sums, every triple, on watch cases: depths 4-32
         and the side planes (int64 at 33 bits), blocks of 1 to 65535
         samples (shorter than the lags, one past a tile, 16 tiles), orders
         1, 8, 9, 12, 13, 26 and 32 (one, two and three lag groups), one, six
         and 32 windows (flac -8's, and partial_tukey(32)'s zero spans), both
         tiers at their limits (|s| = 2^16 narrow; 2^38 - 1 in the limbs),
         and planes that do not start on 16 bytes;
  time   CUDA-event ms of the kernel's launches alone, back to back after a
         warm-up (mean of 50; graph_ms: the same launches in one CUDA
         graph, without the host's issue), on config 3's batch (4 x 1024
         planes of 4096, 16-bit content from bench.py's recipe, the one
         Tukey(0.5), order 8), flac -8's (the same planes, six windows,
         order 12), those two in the limbs, the 24-bit batch of config 2's
         content (limbs, order 8) and the int64 side plane of 32-bit content
         (1024 x 4096, order 8); beside each the plain lag_sums on the card
         (mean of 3), chip_smoke.lags_bound and the share of it, and an
         empty kernel of the grid (the floor of any launch);
  sass   instructions by opcode of every instance, and its largest
         straight-line blocks (the unrolled runs), from cuobjdump.

It imports nothing of JAX. Numbers hold for the card it ran on.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("lag_sums_kernel",)


def log(what, **kv):
    print(json.dumps({"what": what, **kv}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass-out", default=None, help="write the kernel library's SASS here")
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import torch

    if not torch.cuda.is_available():
        print("torch_lags_kernel: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from chip_smoke import (BLOCK, CONFIG3_SAMPLES, FLAC8_APODIZATION, bench_wav, cuda_ms,
                            lags_bound, ptxas_of)
    from torch_analyze_kernel import empty_launcher, graph_ms, sass_functions
    from zigflac_tpu_torch import EncoderConfig
    from zigflac_tpu_torch.ops import _build, lpc
    from zigflac_tpu_torch.utils.apodization import TUKEY_HALF, windows_of
    from zigflac_tpu_torch.wav import WavReader, write_wav

    def smi(fields):
        return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()

    log("card", smi=smi("name,power.limit"))
    lib = _build.library()
    log("build", nvcc_s=_build.BUILD_SECONDS, kernels=ptxas_of(KERNELS))

    dev = torch.device("cuda")
    rng = np.random.default_rng(0x1A65)
    six = windows_of(EncoderConfig(apodization=FLAC8_APODIZATION))
    many = windows_of(EncoderConfig(apodization=("partial_tukey(32)",)))

    def plain(x, order, wt):
        return lpc.lag_sums(x.unsqueeze(0), order,
                            wt.view((wt.shape[0],) + (1,) * (x.dim() - 1) + (x.shape[-1],)))

    def check(x, order, wins, sample_bits):
        x = x if torch.is_tensor(x) else torch.from_numpy(x).to(dev)
        wt = lpc.windows_tensor(tuple(wins), x.shape[-1], dev)
        got = lpc.lag_sums_planes(x, order, wt, sample_bits)
        if not torch.equal(got, plain(x, order, wt)):
            raise AssertionError(f"lag sums kernel != plain on {tuple(x.shape)} {x.dtype}, "
                                 f"order {order}, {len(wins)} windows, bits {sample_bits}")

    def rows(bits, b, n=6):
        lim = 1 << (bits - 1)
        t = np.arange(b)
        out = [np.full(b, -lim), np.where(t % 2 == 0, -lim, lim - 1), rng.integers(-lim, lim, b),
               np.clip(np.round(0.6 * lim * np.sin(t / 9.0) + rng.normal(0, lim >> 7, b)),
                       -lim, lim - 1), np.zeros(b), rng.integers(-3, 0, b)]
        return np.stack(out[:n]).astype(np.int64 if bits > 32 else np.int32)

    checked = []
    for depth in (4, 8, 12, 16, 20, 24, 28, 32):
        for bits in (depth, depth + 1):
            for sample_bits in ({bits, None} if bits <= 17 else {bits}):
                check(rows(bits, BLOCK), 8, (TUKEY_HALF,), sample_bits)
        checked.append(f"depth{depth}")
    for b in (1, 16, 31, 100, 4095, 4097, 4608, 32769, 65535):
        for bits in (17, 25, 33):
            check(rows(bits, b, 3 if b > 30000 else 6), 12, six, bits)
        checked.append(f"b{b}")
    for order in (1, 8, 9, 12, 13, 26, 32):
        check(rows(17, BLOCK), order, six, 17)
        check(rows(24, BLOCK), order, (TUKEY_HALF,), 24)
        checked.append(f"order{order}")
    check(rows(17, 2048), 12, many, 17)
    check(rows(25, 2048), 32, many, 25)
    checked.append("windows32")
    b = BLOCK
    t = np.arange(b)
    lim = 1 << 16
    check(np.stack([np.full(b, -lim), np.full(b, lim), np.where(t % 2 == 0, -lim, lim)])
          .astype(np.int32), 12, six, 17)
    big = (1 << 38) - 1
    check(np.stack([np.full(b, -big), np.where(t % 2 == 0, -big, big),
                    rng.integers(-big, big, b)]), 32, six, None)
    checked.append("tier_limits")
    flat = torch.from_numpy(rows(17, BLOCK).reshape(-1)).to(dev)
    check(flat[1:1 + 5 * BLOCK].view(5, BLOCK), 12, six, 17)
    checked.append("unaligned")
    log("check", equal=checked)

    # -- the timed inputs --------------------------------------------------------
    def lrms(wav, n_frames=1024):
        s = WavReader.from_bytes(wav).planar_samples()
        fr = torch.from_numpy(s[:, : n_frames * BLOCK].reshape(2, n_frames, BLOCK).copy()).to(dev)
        left, right = fr[0].to(torch.int64), fr[1].to(torch.int64)
        return left, right, (left + right) >> 1, left - right

    x3 = torch.stack(lrms(bench_wav(write_wav, CONFIG3_SAMPLES))).to(torch.int32).contiguous()
    x24 = torch.stack(lrms(bench_wav(write_wav, 1024 * BLOCK, depth=24))).to(torch.int32)
    side33 = lrms(bench_wav(write_wav, 1024 * BLOCK, depth=32))[3].contiguous()
    cases = {
        "config3_tukey_order8": (x3, (TUKEY_HALF,), 8, 17),
        "flac8_six_order12": (x3, six, 12, 17),
        "config3_tukey_order8_limbs": (x3, (TUKEY_HALF,), 8, None),
        "flac8_six_order12_limbs": (x3, six, 12, None),
        "depth24_tukey_order8": (x24.contiguous(), (TUKEY_HALF,), 8, 25),
        "side33_int64_order8": (side33, (TUKEY_HALF,), 8, 33),
    }
    stream = torch.cuda.current_stream().cuda_stream
    empty = empty_launcher(torch)
    out = {}
    for name, (x, wins, order, sample_bits) in cases.items():
        check(x, order, wins, sample_bits)
        wt = lpc.windows_tensor(wins, BLOCK, dev)
        p, nwin = x.numel() // BLOCK, len(wins)
        res = torch.empty((nwin, p, order + 1, 3), dtype=torch.int64, device=dev)
        narrow = lpc.narrow_tier(x.dtype, sample_bits)
        args = (x.data_ptr(), x.dtype == torch.int64, narrow, wt.data_ptr(), nwin, p, BLOCK,
                order, res.data_ptr())

        def run(s=stream, args=args, res=res):  # the output lives as long as run
            err = lib.zf_lag_sums(*args, s)
            if err:
                raise RuntimeError(f"zf_lag_sums: {lib.zf_error_string(err).decode()}")

        ms = cuda_ms(torch, run, reps=50)
        nbytes, bound_ms, bound_by, ops_ms = lags_bound(p, BLOCK, nwin, order, x.element_size(),
                                                        narrow)
        groups = (order + (9 if order <= 8 else 13)) // (9 if order <= 8 else 13)
        out[name] = {"planes": list(x.shape), "dtype": str(x.dtype), "windows": nwin,
                     "order": order, "narrow": narrow, "kernel_ms": ms,
                     "graph_ms": graph_ms(torch, run),
                     "plain_ms": cuda_ms(torch, lambda: plain(x, order, wt), reps=3),
                     "bound_ms": bound_ms, "bound_by": bound_by, "bound_ops_ms": ops_ms,
                     "bound_bytes": nbytes, "share_of_bound": bound_ms / ms,
                     "empty_grid_ms": cuda_ms(torch, lambda: empty(p * groups, 128), reps=50)}
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
