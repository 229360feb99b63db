"""Host time to issue config 1's encode on one CUDA card, and its wall.

    python3 tools/torch_dispatch_time.py [--reps 7]

Run from the root of a checkout: it times that checkout's zigflac_tpu_torch
(its own ``build/`` is where the kernels are built). Config 1 is bench.py's
285 s of 16-bit / 44.1 kHz stereo (chip_smoke.py's recipe, seed 0xBEEF); the
encode must give the pinned bytes. Each repetition, with the card idle
before it:

* ``dispatch_s``: host seconds from the first ``DevicePipeline.dispatch_batch``
  to the return of the last dispatch (three 1024-frame batches and the
  tail), before any collect, as ``encode_frames_stream`` issues them;
* ``collect_s``: the host seconds ``collect_batch`` takes after that;
* ``encode_wall_s``: a whole warm ``encode_wav_bytes`` (WAV parse, dispatch,
  MD5, collect, metadata).

Prints the card's name and power limit, then one JSON line with every
repetition's numbers and their medians. Needs a card.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_dispatch_time: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import zigflac_tpu_torch as zt
    from chip_smoke import BLOCK, CONFIG1_FLAC_SHA, CONFIG1_SECONDS, RATE, bench_wav
    from zigflac_tpu_torch.models import pipeline as pl
    from zigflac_tpu_torch.wav import WavReader, write_wav

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    wav = bench_wav(write_wav, CONFIG1_SECONDS * RATE)
    flac = zt.encode_wav_bytes(wav, device="cuda")  # builds the kernels; warm-up
    if hashlib.sha256(flac).hexdigest() != CONFIG1_FLAC_SHA:
        raise AssertionError("config 1 differs from its pinned stream")
    s = WavReader.from_bytes(wav).planar_samples()
    nfull = s.shape[1] // BLOCK
    frames = s[:, : nfull * BLOCK].reshape(2, nfull, BLOCK).transpose(1, 0, 2)
    info = zt.StreamInfo(RATE, 2, 16, s.shape[1], BLOCK, BLOCK)
    pipe = pl.DevicePipeline(zt.EncoderConfig.default(2), 16, "cuda")
    out = {"dispatch_s": [], "collect_s": [], "encode_wall_s": []}
    for rep in range(args.reps + 1):  # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = [pipe.dispatch_batch(frames[i : i + 1024],
                                       np.arange(i, min(i + 1024, nfull), dtype=np.int64), info)
                   for i in range(0, nfull, 1024)]
        pending.append(pipe.dispatch_tail(s[:, nfull * BLOCK :], nfull, info))
        t1 = time.perf_counter()
        stream = b"".join(pipe.collect_batch(p, info)[0] for p in pending)
        t2 = time.perf_counter()
        if not flac.endswith(stream):
            raise AssertionError("the dispatched frames differ from the pinned stream's")
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        zt.encode_wav_bytes(wav, device="cuda")
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        if rep:
            out["dispatch_s"].append(t1 - t0)
            out["collect_s"].append(t2 - t1)
            out["encode_wall_s"].append(t4 - t3)
    out["median"] = {k: float(np.median(v)) for k, v in out.items()}
    out["dispatches"] = len(pending)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
