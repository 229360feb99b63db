"""Encode-side fuzz of zigflac_tpu_torch (not collected by pytest).

Each case draws a configuration and content from the seed: bit depth (8,
12, 16, 20, 24, 32), channels (1-8, stereo as stereo_auto), block size
(1 to 4608, odd ones too) and a ragged tail (none, 1-3 samples, a
block less one, any), prediction (fixed, LPC, none), max_rice_order
(0-15), max_rice_param (14 or 30), LPC order (1-32) and precision
(5-15), wasted bits, and content (silence, a tone, full-scale and quiet
noise, tone and noise, impulses in silence, ramps), shifted left for
wasted bits. Then:

  --device cpu   the port's bytes (encode_wav_bytes on the CPU) against
                 the JAX package's golden oracle (zigflac_tpu.golden,
                 through its encode_wav_bytes with backend="golden"),
                 and each stream decoded by the port's decoder back to
                 the WAV's samples (as WavReader reads them) with its MD5 (imports the JAX
                 package, on the CPU);
  --device cuda  the card's bytes (encode_wav_bytes on cuda: the
                 analysis, symbols, deposit and CRC kernels) against the
                 CPU port's, with the symbols kernel's launches counted
                 (imports nothing of JAX).

Every case falls in one class, printed per case with --verbose and
summed at the end as one JSON line:

  ok          bytes equal and (cpu) the stream decodes to the input;
  N1          ROADMAP sec. 3 N1: depth 32 with 4-bit Rice params, bytes
              equal to the reference's, a stream no decoder reads;
  N2          ROADMAP sec. 3 N2: the port refuses a tail whose partition
              order exceeds 8 (ValueError), where the golden oracle writes
              a stream;
  refused     F5: the port refuses partition orders above 8 in the full
              blocks, as the JAX package's device path does (the golden
              oracle may write a stream);
  mismatch, decode, error   faults: bytes differ, the port's stream does
              not decode to the input, or an unexpected exception.

    JAX_PLATFORMS=cpu python3 tools/torch_fuzz_encode.py --cases 200 --seed 1
    python3 tools/torch_fuzz_encode.py --device cuda --cases 500 --seed 1

Exits 1 if any case is a fault, printing each fault's (seed, case) and
configuration so that it reproduces with --seed S --only CASE.
"""

import argparse
import io
import json
import os
import sys
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEPTHS = (8, 12, 16, 20, 24, 32)
FAULTS = ("mismatch", "decode", "error")


def draw_case(rng):
    """(config fields, depth, channels, samples int64 [C, n], rate)."""
    depth = int(rng.choice(DEPTHS))
    channels = int(rng.choice([1, 2, 2, 2, 3, 4, 6, 8]))
    block = int(rng.choice([1, 2, 3, 5, 16, 37, 192, 576, 1024, 1152, 2304, 4095, 4096,
                            4608, int(rng.integers(1, 4609))]))
    full = int(rng.integers(0, 4))
    tail = int(rng.choice([0, 1, 2, 3, max(0, block - 1), int(rng.integers(0, block + 1))]))
    n = max(1, full * block + tail)
    prediction = str(rng.choice(["fixed", "fixed", "lpc", "lpc", "none"]))
    fields = dict(
        block_size=block,
        channels="stereo_auto" if channels == 2 else channels,
        prediction=prediction,
        max_rice_order=int(rng.choice([0, 2, 4, 6, 8, 8, 8, int(rng.integers(0, 16))])),
        max_rice_param=int(rng.choice([14, 30])),
        lpc_order=int(rng.integers(1, 33)),
        lpc_precision=int(rng.integers(5, 16)),
        wasted_bits=bool(rng.random() < 0.3),
    )
    shift = int(rng.integers(1, min(4, depth - 4) + 1)) if fields["wasted_bits"] else 0
    x = _signal(rng, n, channels, depth - shift).astype(np.int64) << shift
    return fields, depth, channels, x, int(rng.choice([44100, 48000, 96000, 22050, 12345]))


def _signal(rng, n, channels, depth):
    lo, hi = -(1 << (depth - 1)), (1 << (depth - 1)) - 1
    kind = int(rng.integers(0, 7))
    t = np.arange(n)
    if kind == 0:
        x = np.full((channels, n), float(rng.integers(lo, hi + 1)))
    elif kind == 1:
        x = 0.5 * hi * np.sin(2 * np.pi * rng.uniform(20, 8000) * t / 44100)[None].repeat(
            channels, 0)
    elif kind == 2:
        x = rng.uniform(lo, hi, (channels, n))
    elif kind == 3:
        x = rng.normal(0, max(2.0, hi * 1e-4), (channels, n))
    elif kind == 4:
        x = 0.3 * hi * np.sin(2 * np.pi * rng.uniform(50, 2000) * t / 44100) + rng.normal(
            0, hi * 0.01, (channels, n))
    elif kind == 5:
        x = np.zeros((channels, n))
        for _ in range(max(1, n // 64)):
            x[rng.integers(0, channels), rng.integers(0, n)] = rng.integers(lo, hi + 1)
    else:
        x = (t * rng.uniform(0.1, 50))[None].repeat(channels, 0) % (hi - max(lo, -hi)) + lo / 2
    return np.clip(np.round(x), lo, hi)


def _wav(x, rate, depth):
    from zigflac_tpu_torch.wav import write_wav

    buf = io.BytesIO()
    write_wav(buf, x, rate, depth)
    return buf.getvalue()


def _refusal(fields, n, err):
    """The class of the port's refusal: F5 ("refused") where the full
    blocks' top partition order exceeds 8, N2 where only the tail's does,
    else an error."""
    b, mro = fields["block_size"], fields["max_rice_order"]
    ctz = lambda v: (v & -v).bit_length() - 1
    if "partition order" not in str(err):
        return "error"
    if n >= b and min(mro, ctz(b)) > 8:
        return "refused"
    return "N2" if n % b and min(mro, ctz(n % b)) > 8 else "error"


def _encode(fn):
    """(bytes, None) or (None, the exception)."""
    try:
        return fn(), None
    except (ValueError, NotImplementedError) as e:
        return None, e


def run_cpu(fields, depth, x, rate):
    import zigflac_tpu_torch as zt
    from zigflac_tpu.models.encoder import encode_wav_bytes as golden_encode
    from zigflac_tpu.utils.config import EncoderConfig as GoldenConfig

    wav = _wav(x, rate, depth)
    port, port_err = _encode(lambda: zt.encode_wav_bytes(
        wav, config=zt.EncoderConfig(**fields), device="cpu"))
    ref, ref_err = _encode(lambda: golden_encode(wav, config=GoldenConfig(**fields),
                                                 backend="golden"))
    if port is None:
        cls = _refusal(fields, x.shape[1], port_err)
        if ref is None and cls != "refused":
            cls = "error"
        return cls, f"{port_err}" + ("" if ref is None else "; the oracle wrote a stream")
    if ref is None:
        return "error", f"the port wrote a stream the oracle refuses: {ref_err}"
    if port != ref:
        return "mismatch", f"{len(port)} bytes against the oracle's {len(ref)}"
    try:
        dec = zt.decode_flac(port, device="cpu")
        pcm = zt.WavReader.from_bytes(wav).planar_samples()  # the encoder's input
        good = dec.md5_ok and np.array_equal(dec.samples, pcm)
    except Exception as e:  # noqa: BLE001 - a stream that does not decode is a class
        good, why = False, f"{type(e).__name__}: {e}"
    else:
        why = "samples or MD5 differ"
    if good:
        return "ok", ""
    n1 = depth == 32 and fields["max_rice_param"] == 14
    return ("N1" if n1 else "decode"), why


def run_cuda(fields, depth, x, rate):
    import torch

    import zigflac_tpu_torch as zt
    from zigflac_tpu_torch.ops import symbols

    wav = _wav(x, rate, depth)
    cfg = zt.EncoderConfig(**fields)
    cpu, cpu_err = _encode(lambda: zt.encode_wav_bytes(wav, config=cfg, device="cpu"))
    symbols.reset_counts()
    card, card_err = _encode(lambda: zt.encode_wav_bytes(wav, config=cfg, device="cuda"))
    torch.cuda.synchronize()
    if cpu is None and card is None:
        same = type(cpu_err) is type(card_err) and str(cpu_err) == str(card_err)
        return (_refusal(fields, x.shape[1], cpu_err) if same else "error"), f"{cpu_err}"
    if cpu is None or card is None:
        return "error", f"cpu: {cpu_err}; card: {card_err}"
    if card != cpu:
        return "mismatch", f"{len(card)} bytes on the card against the CPU port's {len(cpu)}"
    if symbols.KERNEL_LAUNCHES == 0 or symbols.PLAIN_CALLS:
        return "error", (f"{symbols.KERNEL_LAUNCHES} symbols launches, "
                         f"{symbols.PLAIN_CALLS} plain calls")
    n1 = depth == 32 and fields["max_rice_param"] == 14
    return ("N1" if n1 and not zt.verify_flac(card, device="cuda") else "ok"), ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--only", type=int, default=None, help="run this case index alone")
    ap.add_argument("--verbose", action="store_true")
    opts = ap.parse_args()
    if opts.device == "cpu":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    else:
        import torch

        if not torch.cuda.is_available():
            print("torch_fuzz_encode: torch.cuda.is_available() is false", file=sys.stderr)
            return 1
    run = run_cpu if opts.device == "cpu" else run_cuda
    classes, faults = Counter(), []
    for i in range(opts.cases):
        rng = np.random.default_rng([opts.seed, i])
        fields, depth, channels, x, rate = draw_case(rng)
        if opts.only is not None and i != opts.only:
            continue
        try:
            cls, why = run(fields, depth, x, rate)
        except Exception as e:  # noqa: BLE001 - every failure is reported with its case
            cls, why = "error", f"{type(e).__name__}: {e}"
        classes[cls] += 1
        line = dict(seed=opts.seed, case=i, cls=cls, depth=depth, channels=channels,
                    samples=int(x.shape[1]), rate=rate, config=fields, why=why)
        if cls in FAULTS:
            faults.append(line)
        if opts.verbose or cls in FAULTS:
            print(json.dumps(line), flush=True)
    print(json.dumps({"device": opts.device, "seed": opts.seed, "cases": sum(classes.values()),
                      "classes": dict(classes), "faults": len(faults)}), flush=True)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
