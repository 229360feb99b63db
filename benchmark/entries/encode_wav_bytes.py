"""Entry: ``zigflac_tpu_torch.encode_wav_bytes``, WAV bytes in, FLAC bytes out
(the WAV parse, the MD5, the device work and the stream's assembly).

The check: every output's STREAMINFO MD5 against the MD5 of its item's PCM;
then, for each item drawn before the window (``run.checked``), its first
``check.per_item`` outputs byte for byte against the plain reference's
stream: the metadata (STREAMINFO with its frame sizes and MD5, the
VorbisComment), each frame at the reference's offset (header with CRC-8,
stereo mode, each subframe's choice, order, coefficients and shift, Rice
partitions and escapes, CRC-16), and the length; its later outputs by their
length and by the bytes at offsets drawn from the seed. Every number is an
exact count, so its limit is 0. The reference's compression ratio and
subframe mix over the checked items go to stderr.

The control: the reference in the program's place with the configuration's
``control`` settings, one of its stated guarantees broken.
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


# the later outputs' bytes compared: at these fractions of the stream
PROBES = 256


@dataclass
class Kept:
    """What the window keeps of one output: its STREAMINFO MD5, length,
    frame bytes and probed bytes, and the whole stream where it is compared
    in full."""
    md5: bytes
    length: int
    frame_bytes: int
    probe: bytes
    full: Optional[bytes]


def probe(run, data: bytes) -> bytes:
    return bytes(data[int(f * len(data))] for f in run.state["fracs"])


def spans():
    """Host work named in a traced window's idle gaps."""
    from zigflac_tpu_torch import native
    from zigflac_tpu_torch.models import encoder, pipeline

    pipe = pipeline.DevicePipeline
    return [(encoder.WavReader, "from_bytes", "wav.parse"),
            (encoder.WavReader, "planar_samples", "wav.planar_samples"),
            (native, "md5", "session.md5"),
            (pipe, "dispatch_batch", "pipeline.dispatch_batch"),
            (pipe, "dispatch_tail", "pipeline.dispatch_tail"),
            (pipe, "collect_batch", "pipeline.collect_batch")]


def prepare(run) -> None:
    import zigflac_tpu_torch as zt

    run.state["zt"] = zt
    run.state["cfg"] = zt.EncoderConfig(**run.config["encoder"])
    run.state["fracs"] = np.random.default_rng(signal.sub_seed(run.seed, 5)).random(PROBES)


def call(run, i: int) -> bytes:
    zt = run.state["zt"]
    return zt.encode_wav_bytes(run.pool[i].wav, run.state["cfg"], device=run.device)


def control(run, i: int) -> bytes:
    item = run.pool[i]
    settings = dict(run.config["encoder"], **run.config["control"])
    pcm = torch.from_numpy(item.pcm).to(run.device, torch.int64)
    ref = spec.reference(run.config)
    return ref.encode(pcm, item.rate, item.depth, settings, item.raw_pcm)


def keep(run, i: int, out: bytes, full: bool) -> Kept:
    return Kept(out[26:42], len(out), roofline.flac_frame_bytes(out), probe(run, out),
                out if full else None)


def work(run, i: int, out: Kept) -> dict:
    item = run.pool[i]
    return roofline.encode_work(item.samples, item.channels, item.depth, out.frame_bytes,
                                run.config["encoder"])


def release(run) -> None:
    run.state.pop("cfg", None)
    run.state.pop("zt", None)


def check(run) -> dict:
    done = [(i, k) for (i, k), c in zip(run.outputs, run.calls) if c.ok]
    md5 = {}
    md5_wrong = 0
    for i, k in done:
        if i not in md5:
            md5[i] = hashlib.md5(run.pool[i].raw_pcm).digest()
        md5_wrong += k.md5 != md5[i]
    header_wrong = frames_wrong = length_wrong = probe_wrong = 0
    streams = frames = probed = 0
    reference = spec.reference(run.config)
    tally, wav, flac = Counter(), 0, 0
    called = {i for i, _ in done}
    for i in run.checked:
        if i not in called:
            continue
        item = run.pool[i]
        pcm = torch.from_numpy(item.pcm).to(run.device, torch.int64)
        head, ref = reference.encode_parts(pcm, item.rate, item.depth, run.config["encoder"],
                                           item.raw_pcm, tally=tally)
        del pcm
        whole = head + b"".join(ref)
        wav, flac = wav + len(item.raw_pcm), flac + len(whole)
        want = probe(run, whole)
        for j, k in done:
            if j != i:
                continue
            length_wrong += k.length != len(whole)
            if k.full is None:
                probed += 1
                probe_wrong += k.probe != want
                continue
            out = k.full
            streams += 1
            header_wrong += out[: len(head)] != head
            pos = len(head)
            for f in ref:
                frames_wrong += out[pos : pos + len(f)] != f
                pos += len(f)
            frames += len(ref)
    print(f"compared with the reference: {streams} streams, {frames} frames; {probed} "
          f"streams by {PROBES} bytes and length; MD5 of {len(done)} streams", file=sys.stderr)
    if wav:
        print(reference.describe(tally, flac / wav), file=sys.stderr)
    return {"md5_wrong": (md5_wrong, 0), "header_wrong": (header_wrong, 0),
            "frames_wrong": (frames_wrong, 0), "length_wrong": (length_wrong, 0),
            "probe_wrong": (probe_wrong, 0)}
