"""Entry: ``zigflac_tpu_torch.decode_flac(data, device=...)``, FLAC bytes in,
verified PCM out (every frame's CRC and the STREAMINFO MD5 checked).

Set-up encodes the pool with the program (``encode_wav_bytes``) to make
the streams; the check holds those streams byte for byte to the plain
reference's, so the window's input (subframe kinds, LPC orders, Rice
coding) cannot drift with the encoder. The check of the outputs: every
call's MD5 verdict, which must be true; the first ``check.per_item``
decodes of each item drawn before the window sample for sample against the
PCM the benchmark made, every other decode at sample positions drawn from
the seed. All are exact counts, so their limits are 0.

The control: the plain reference's decisions for the same PCM restored
with the prediction summed in float32, one step of precision below the
exact integer sum the stream's depth needs.
"""

from __future__ import annotations

import hashlib
import sys
from collections import Counter
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from harness import roofline, signal, spec

# the later decodes' samples compared, at positions drawn from the seed
PROBES = 4096


@dataclass
class Decoded:
    samples: np.ndarray
    md5_ok: bool


@dataclass
class Kept:
    """What the window keeps of one decode: its MD5 verdict and shape, its
    samples at the probed positions, and all of them where it is compared
    in full."""
    md5_ok: bool
    shape: tuple
    probe: np.ndarray
    full: Optional[np.ndarray]


def spans():
    from zigflac_tpu_torch import decoder

    return [(decoder, "_parse_metadata", "decoder.metadata"),
            (decoder, "_decode_batch", "decoder.batch"),
            (decoder, "_verify_md5", "decoder.md5")]


def prepare(run) -> None:
    import zigflac_tpu_torch as zt

    cfg = zt.EncoderConfig(**run.config["encoder"])
    run.state["zt"] = zt
    run.state["flac"] = [zt.encode_wav_bytes(item.wav, cfg, device=run.device)
                         for item in run.pool]
    rng = np.random.default_rng(signal.sub_seed(run.seed, 5))
    run.state["probes"] = [rng.integers(0, item.samples, PROBES) for item in run.pool]


def call(run, i: int):
    return run.state["zt"].decode_flac(run.state["flac"][i], device=run.device)


def control(run, i: int) -> Decoded:
    item = run.pool[i]
    pcm = torch.from_numpy(item.pcm).to(run.device, torch.int64)
    ref = spec.reference(run.config)
    got = ref.decode_samples(pcm, item.depth, run.config["encoder"], torch.float32).cpu().numpy()
    nb = (item.depth + 7) // 8
    raw = (got.T.astype("<i8")[..., None].view(np.uint8)[..., :nb]).tobytes()
    return Decoded(got, hashlib.md5(raw).digest() == run.state["flac"][i][26:42])


def keep(run, i: int, out, full: bool) -> Kept:
    got = np.asarray(out.samples)
    pos = run.state["probes"][i]
    probe = got[:, pos] if got.shape == run.pool[i].pcm.shape else None
    return Kept(bool(out.md5_ok), got.shape, probe, got if full else None)


def work(run, i: int, out) -> dict:
    item = run.pool[i]
    enc = run.config["encoder"]
    order = enc["lpc_order"] if enc.get("prediction") == "lpc" else 4
    return roofline.decode_work(item.samples, item.channels, item.depth,
                                roofline.flac_frame_bytes(run.state["flac"][i]), order)


def release(run) -> None:
    run.state.pop("zt", None)


def check(run) -> dict:
    wrong = probe_wrong = md5_failed = 0
    full = probed = 0
    for (i, k), c in zip(run.outputs, run.calls):
        if not c.ok:
            continue
        want = run.pool[i].pcm
        md5_failed += not k.md5_ok
        if k.shape != want.shape:
            wrong += want.size
        elif k.full is not None:
            full += 1
            wrong += int(np.count_nonzero(k.full != want))
        else:
            probed += 1
            probe_wrong += int(np.count_nonzero(k.probe != want[:, run.state["probes"][i]]))
    print(f"compared with the PCM: {full} decodes in full, {probed} at {PROBES} positions",
          file=sys.stderr)
    # the window's input: the program's streams against the reference's
    reference = spec.reference(run.config)
    tally, wav, flac = Counter(), 0, 0
    stream_wrong = 0
    for i, item in enumerate(run.pool):
        pcm = torch.from_numpy(item.pcm).to(run.device, torch.int64)
        head, ref = reference.encode_parts(pcm, item.rate, item.depth, run.config["encoder"],
                                           item.raw_pcm, tally=tally)
        del pcm
        got = run.state["flac"][i]
        stream_wrong += got[: len(head)] != head
        pos = len(head)
        for f in ref:
            stream_wrong += got[pos : pos + len(f)] != f
            pos += len(f)
        stream_wrong += len(got) != pos
        wav, flac = wav + len(item.raw_pcm), flac + pos
    print(f"input streams compared with the reference: {len(run.pool)}", file=sys.stderr)
    print(reference.describe(tally, flac / wav), file=sys.stderr)
    return {"samples_wrong": (wrong, 0), "probe_wrong": (probe_wrong, 0),
            "md5_failed": (md5_failed, 0), "stream_wrong": (stream_wrong, 0)}
