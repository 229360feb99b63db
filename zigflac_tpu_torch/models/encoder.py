"""Encoder orchestrator — the wav2flac session on a torch device.

Mirrors the reference session protocol (src/wav2flac.zig:11-78): metadata
header + VorbisComment, per-frame encode, MD5 over the raw PCM byte stream,
min/max frame-size tracking, and the finalized STREAMINFO written first in
the output (assembled in memory, or seeked back to in a file). Every frame,
ragged tail included, goes through ``models/pipeline.DevicePipeline`` on the
given device.

Entry points: ``encode_wav_bytes`` (bytes in, bytes out), ``encode_file``
(file to file, O(device batch) host memory, native FLAC or Ogg-FLAC),
``encode_files`` / ``encode_wav_bytes_many`` (BASELINE config 4: full frames
of same-format files fused into shared device batches) and
``encode_to_file`` (planar samples to a seekable file).
"""

from __future__ import annotations

import contextlib
import io
import os
from collections import deque
from dataclasses import replace
from typing import List, Optional

import numpy as np
import torch

from .. import native
from ..metadata import (
    HEADER_SIZE,
    StreamInfo,
    build_seekpoints,
    padding_block,
    seek_table_block,
    set_last_flag,
    streaminfo_block,
    vorbis_comment_block,
)
from ..ogg import OggStreamSink
from ..utils import stages
from ..utils.config import EncoderConfig
from ..wav import WavReader, WavStreamReader, reconstruct_raw_bytes
from .pipeline import TAIL_DEVICE_MIN, DevicePipeline


def _check_seek_interval(seek_interval: Optional[int]) -> None:
    if seek_interval is not None and seek_interval <= 0:
        raise ValueError(f"seek_interval must be positive, got {seek_interval}")


def _tail_on_device(rem: int) -> bool:
    """Whether a ragged tail of ``rem`` samples is dispatched to the device.
    The port has no host oracle: every non-empty tail encodes on the device
    at its exact block size (``TAIL_DEVICE_MIN`` is 1). The single-file,
    streaming and fused paths all ask here."""
    return rem >= TAIL_DEVICE_MIN


class Encoder:
    """FLAC stream encoder over planar int32 samples.

    Surface of the reference ``libFLAC.Encoder`` (libFLAC/Encoder.zig:55-419):
    construct with a config, a bit depth and a device (the card unless the
    caller asks for the CPU), then ``encode_stream`` produces the complete
    FLAC byte stream (signature, STREAMINFO, VorbisComment, frames).
    """

    def __init__(
        self,
        config: EncoderConfig,
        bit_depth: int,
        device: torch.device = "cuda",
    ) -> None:
        self.config = config
        self.bit_depth = bit_depth
        self.pipeline = DevicePipeline(config, bit_depth, device)

    # -- frame-level API ----------------------------------------------------

    def encode_frames_batch(
        self, frames: np.ndarray, first_frame_number: int, info: StreamInfo
    ) -> List[bytes]:
        """Encode ``[n_frames, channels, block_size]`` full frames."""
        return self.pipeline.encode_frames(frames, first_frame_number, info)

    def encode_frame(
        self, planes: List[np.ndarray], frame_number: int, info: StreamInfo
    ) -> bytes:
        """One frame of any length up to the block size, on the device: one
        tail dispatch at its exact block size, then its collect."""
        pending = self.pipeline.dispatch_tail(np.stack(planes), frame_number, info)
        return self.pipeline.collect_batch(pending, info)[0]

    # -- stream-level API ---------------------------------------------------

    def encode_stream(
        self,
        samples: np.ndarray,
        info: StreamInfo,
        raw_pcm_bytes: Optional[bytes] = None,
        tags: Optional[List] = None,
        seek_interval: Optional[int] = None,
        padding: int = 0,
        extra_metadata: Optional[List[bytes]] = None,
    ) -> bytes:
        """Planar ``[channels, n] int32`` -> complete FLAC stream.

        ``raw_pcm_bytes`` is the little-endian interleaved byte stream the
        STREAMINFO MD5 covers; when None it is reconstructed from samples.
        ``seek_interval`` (samples) adds a SEEKTABLE block with a point at
        most every that many samples; ``padding`` adds a PADDING block of
        that many zero bytes; ``extra_metadata`` takes pre-built blocks
        (built with is_last=False) — the last-block flag is fixed up here.
        """
        _check_seek_interval(seek_interval)
        with stages.entry("encode.call"):
            stream, sizes, md5 = self._encode_samples(samples, info, raw_pcm_bytes)
            return self._finish(stream, sizes, md5, info, tags, seek_interval, padding,
                                extra_metadata)

    def encode_pcm(
        self,
        pcm: memoryview,
        bytes_per_sample: int,
        info: StreamInfo,
        tags: Optional[List] = None,
        seek_interval: Optional[int] = None,
        padding: int = 0,
        extra_metadata: Optional[List[bytes]] = None,
    ) -> bytes:
        """``encode_stream`` of a WAV's interleaved little-endian PCM bytes
        (``WavReader.raw_pcm_bytes()``, ``bytes_per_sample`` bytes a
        sample) in place of planar samples: the bytes cross to the device
        once and are unpacked there (``DevicePipeline.encode_pcm_stream``),
        and the MD5 hashes them where they are. ``encode_wav_bytes`` takes
        this route where the pipeline is ``card_fed``."""
        _check_seek_interval(seek_interval)
        with stages.entry("encode.call"):
            md5_box = {}

            def _md5_work():
                with stages.span("session.md5"):
                    md5_box["md5"] = native.md5(pcm)

            stream, sizes = self.pipeline.encode_pcm_stream(pcm, bytes_per_sample, info,
                                                            overlap_work=_md5_work)
            return self._finish(stream, sizes, md5_box["md5"], info, tags, seek_interval,
                                padding, extra_metadata)

    def _finish(self, stream: bytes, sizes: np.ndarray, md5: bytes, info: StreamInfo,
                tags, seek_interval, padding, extra_metadata) -> bytes:
        """The metadata blocks, with the finalized STREAMINFO, before the
        frame stream."""
        with stages.span("session.finish"):
            info.update_frame_sizes(sizes)
            info.md5 = md5

            blocks = [streaminfo_block(info, is_last=False)]
            if seek_interval:
                pts = build_seekpoints(sizes, self.config.block_size, seek_interval,
                                       info.interchannel_samples)
                blocks.append(seek_table_block(pts, is_last=False))
            blocks.append(vorbis_comment_block(is_last=False, tags=tags))
            for extra in extra_metadata or []:
                blocks.append(extra)
            if padding > 0:
                blocks.append(padding_block(padding, is_last=False))
            blocks[-1] = set_last_flag(blocks[-1])
            return b"".join(blocks) + stream

    def _encode_samples(self, samples: np.ndarray, info: StreamInfo,
                        raw_pcm_bytes: Optional[bytes]):
        """Every frame of planar samples: (frame-stream bytes, sizes, MD5).
        The MD5 runs while the device encodes the dispatched batches."""
        c, n = samples.shape
        block = self.config.block_size
        n_full = n // block
        rem = n - n_full * block
        md5_box = {}

        def _md5_work():
            with stages.span("session.md5"):
                raw = (raw_pcm_bytes if raw_pcm_bytes is not None
                       else reconstruct_raw_bytes(samples, self.bit_depth))
                md5_box["md5"] = native.md5(raw)

        batch = samples[:, : n_full * block].reshape(c, n_full, block).transpose(1, 0, 2)
        stream, sizes = self.pipeline.encode_frames_stream(
            batch, 0, info,
            tail=samples[:, n_full * block :] if _tail_on_device(rem) else None,
            overlap_work=_md5_work,
        )
        return stream, sizes, md5_box["md5"]


def encode_to_file(
    out_file,
    samples: np.ndarray,
    info: StreamInfo,
    config: Optional[EncoderConfig] = None,
    device: torch.device = "cuda",
    raw_pcm_bytes: Optional[bytes] = None,
) -> StreamInfo:
    """Streaming file-output variant of the reference's two-pass protocol
    (src/wav2flac.zig:30-47): write a zeroed header region, stream the
    VorbisComment + frames, then seek back and write the finalized
    signature + STREAMINFO (MD5, min/max frame sizes).

    ``out_file`` must be a seekable binary file object.
    """
    with stages.entry("encode.call"):
        with stages.span("session.setup"):
            cfg = config or EncoderConfig.default(samples.shape[0])
            enc = Encoder(cfg, info.bit_depth, device)

        out_file.write(b"\x00" * HEADER_SIZE)  # skipHeader
        out_file.write(vorbis_comment_block(is_last=True))
        stream, sizes, md5 = enc._encode_samples(samples, info, raw_pcm_bytes)
        out_file.write(stream)
        info.update_frame_sizes(sizes)
        info.md5 = md5

        out_file.flush()
        out_file.seek(0)
        out_file.write(streaminfo_block(info, is_last=False)[:HEADER_SIZE])
        out_file.flush()
        return info


def _default_meta_chain(info: StreamInfo):
    """The default-metadata chain (STREAMINFO + empty VorbisComment) as
    Ogg-sink blocks: streaminfo_block's leading 'fLaC' magic lives in the
    mapping header inside Ogg, so it is stripped here."""
    return [
        streaminfo_block(info, is_last=False)[4:],
        vorbis_comment_block(is_last=True),
    ]


class _FileJob:
    """Per-file bookkeeping for the fused multi-file encode: the output
    stream (placeholder header already written), incremental MD5, collected
    frame sizes, and the outstanding-dispatch counter that gates the closing
    seek-back. With an Ogg ``sink`` the same two-pass protocol runs at page
    granularity (ogg.OggStreamSink) and frames packetize as they collect."""

    __slots__ = (
        "info", "out", "md5", "sizes", "frame_no", "reading_done",
        "queued", "inflight", "finalized", "sink", "samples_emitted",
    )

    def __init__(self, info: StreamInfo, out, sink=None) -> None:
        self.info = info
        self.out = out
        self.md5 = native.Md5Stream()
        self.sizes: List[np.ndarray] = []
        self.frame_no = 0
        self.reading_done = False
        self.queued = 0    # accumulator runs + tails not yet dispatched
        self.inflight = 0  # dispatched segments not yet collected
        self.finalized = False
        self.sink = sink
        self.samples_emitted = 0

    def _frame_samples(self, k: int) -> List[int]:
        """Sample counts of the next ``k`` sequential frames (frames
        collect in order per file; only the last one is ragged)."""
        block = self.info.max_block_size
        out = []
        for _ in range(k):
            ns = min(block, self.info.interchannel_samples - self.samples_emitted)
            self.samples_emitted += ns
            out.append(ns)
        return out

    def write_frames(self, buf, sizes) -> None:
        if self.sink is not None:
            self.sink.add_frames(buf, sizes, self._frame_samples(len(sizes)))
        else:
            self.out.write(buf)

    def finalize_if_done(self) -> None:
        if self.finalized or not self.reading_done or self.queued or self.inflight:
            return
        all_sizes = np.concatenate(self.sizes) if self.sizes else np.zeros(0, np.int64)
        self.info.update_frame_sizes(all_sizes)
        self.info.md5 = self.md5.digest()
        if self.sink is not None:
            self.sink.finalize(_default_meta_chain(self.info))
            self.finalized = True
            return
        self.out.flush()
        self.out.seek(0)
        self.out.write(streaminfo_block(self.info, is_last=False)[:HEADER_SIZE])
        self.out.flush()
        self.finalized = True


def _encode_group_fused(
    idxs: List[int],
    open_in,
    open_out,
    infos: List[Optional[StreamInfo]],
    cfg: EncoderConfig,
    enc: Encoder,
    frames_per_chunk: Optional[int],
    ogg: bool = False,
) -> None:
    """Core of the multi-file encode: stream every file in ``idxs`` through
    one shared pipeline, fusing full frames across file boundaries into
    device batches (per-file frame numbering preserved). Host memory stays
    O(device batch): one input file is open at a time, at most ``window``
    batches are in flight, and each file's output finalizes (seek-back
    STREAMINFO) as soon as its last frame collects."""
    pipe = enc.pipeline
    block = cfg.block_size
    bs = frames_per_chunk or pipe.batch_size
    window = 2  # in-flight batches (matches encode_file_streaming)

    jobs: dict = {}
    pending: deque = deque()  # (rec, segments); segment = (file_idx, nframes)
    acc: List[np.ndarray] = []  # [k, C, B] pieces
    acc_fns: List[np.ndarray] = []
    acc_owners: List[tuple] = []
    acc_n = 0
    tails_after: List[tuple] = []  # (file_idx, samples [C, rem], frame_no)

    def drain_one() -> None:
        rec, segments = pending.popleft()
        stream, sizes = pipe.collect_batch(rec, jobs[segments[0][0]].info)
        pos_b = 0
        pos_f = 0
        for fi, cnt in segments:
            job = jobs[fi]
            fsz = sizes[pos_f : pos_f + cnt]
            nb = int(fsz.sum())
            job.write_frames(stream[pos_b : pos_b + nb], fsz)
            job.sizes.append(fsz)
            job.inflight -= 1
            pos_b += nb
            pos_f += cnt
            job.finalize_if_done()

    def flush() -> None:
        nonlocal acc_n
        if acc_n:
            fused = np.concatenate(acc, axis=0) if len(acc) > 1 else acc[0]
            fns = np.concatenate(acc_fns) if len(acc_fns) > 1 else acc_fns[0]
            # merge adjacent runs of the same file into one segment
            segments: List[List] = []
            for fi, cnt in acc_owners:
                jobs[fi].queued -= 1
                if segments and segments[-1][0] == fi:
                    segments[-1][1] += cnt
                else:
                    segments.append([fi, cnt])
                    jobs[fi].inflight += 1
            rec = pipe.dispatch_batch(fused, fns, jobs[segments[0][0]].info)
            pending.append((rec, [tuple(s) for s in segments]))
            acc.clear()
            acc_fns.clear()
            acc_owners.clear()
            acc_n = 0
        for fi, tail, tfn in tails_after:
            jobs[fi].queued -= 1
            jobs[fi].inflight += 1
            trec = pipe.dispatch_tail(tail, tfn, jobs[fi].info)
            pending.append((trec, [(fi, 1)]))
        tails_after.clear()
        while len(pending) > window:
            drain_one()

    for i in idxs:
        with WavStreamReader(open_in(i), _close=True) as wav:
            info = wav.flac_streaminfo(block)
            infos[i] = info
            out = open_out(i)
            if ogg:
                sink = OggStreamSink(out)
                job = _FileJob(info, out, sink=sink)
                sink.write_headers(_default_meta_chain(info))
            else:
                out.write(b"\x00" * HEADER_SIZE)
                out.write(vorbis_comment_block(is_last=True))
                job = _FileJob(info, out)
            jobs[i] = job
            c = wav.channels
            while True:
                raw, planar = wav.read_samples(bs * block)
                if planar.shape[1] == 0:
                    break
                job.md5.update(raw)
                m = planar.shape[1]
                n_full = m // block
                rem = m - n_full * block
                taken = 0
                while taken < n_full:
                    take = min(bs - acc_n, n_full - taken)
                    piece = (
                        planar[:, taken * block : (taken + take) * block]
                        .reshape(c, take, block)
                        .transpose(1, 0, 2)
                    )
                    acc.append(piece)
                    acc_fns.append(job.frame_no + np.arange(take, dtype=np.int64))
                    acc_owners.append((i, take))
                    job.queued += 1
                    acc_n += take
                    job.frame_no += take
                    taken += take
                    if acc_n == bs:
                        flush()
                if _tail_on_device(rem):  # only on the final chunk of the file
                    # queued until the accumulator batch holding this file's
                    # last full frames has been dispatched, so per-file byte
                    # order is preserved
                    tails_after.append((i, planar[:, n_full * block :].copy(), job.frame_no))
                    job.queued += 1
                    job.frame_no += 1
            job.reading_done = True
            job.finalize_if_done()  # zero-frame files complete immediately
    flush()
    while pending:
        drain_one()
    for job in jobs.values():
        job.finalize_if_done()
        if not job.finalized:
            raise RuntimeError("multi-file pipeline left a job unfinalized")


def encode_files(
    in_paths: List[str],
    out_paths: List[str],
    config: Optional[EncoderConfig] = None,
    device: torch.device = "cuda",
    frames_per_chunk: Optional[int] = None,
    ogg: bool = False,
) -> List[StreamInfo]:
    """Streaming multi-file wav2flac (BASELINE config 4): every input
    encodes to its output path with full frames from same-format files
    fused into shared device batches, so the Rice/partition sweeps and bit
    packing amortize across files. Files group by (rate, depth, channels);
    host memory stays O(device batch) across any number of files (one input
    open at a time, bounded in-flight window, outputs finalized as their
    last frames collect). Each file's ragged tail encodes on the device
    after the batch that holds that file's last full frames.

    Byte-identical per file to ``encode_file`` / ``encode_wav_bytes`` with
    default metadata (two-pass STREAMINFO + empty VorbisComment).
    ``ogg=True`` writes each output as Ogg-FLAC in the same single
    streaming pass (byte-identical to transmuxing the native stream)."""
    with stages.entry("encode.call"):
        return _encode_files_core(
            in_paths,
            lambda i: open(in_paths[i], "rb"),
            lambda i: open(out_paths[i], "wb"),
            close_out=True,
            config=config,
            device=device,
            frames_per_chunk=frames_per_chunk,
            ogg=ogg,
        )


def _encode_files_core(
    keys_source,
    open_in,
    open_out,
    close_out: bool,
    config: Optional[EncoderConfig],
    device: torch.device,
    frames_per_chunk: Optional[int],
    ogg: bool = False,
) -> List[StreamInfo]:
    n = len(keys_source)
    groups: dict = {}
    for i in range(n):
        with WavStreamReader(open_in(i), _close=True) as probe:
            key = (probe.sample_rate, probe.bit_depth, probe.channels)
        groups.setdefault(key, []).append(i)

    infos: List[Optional[StreamInfo]] = [None] * n
    for (_rate, depth, channels), idxs in groups.items():
        if config is None:
            cfg = EncoderConfig.default(channels)
        else:
            # adapt the channel mode to each format group: a shared config
            # can't force stereo_auto onto mono files or vice versa
            cfg = replace(config, channels="stereo_auto" if channels == 2 else channels)
        enc = Encoder(cfg, depth, device)
        outs = {}

        def open_out_tracked(i):
            outs[i] = open_out(i)
            return outs[i]

        try:
            _encode_group_fused(idxs, open_in, open_out_tracked, infos, cfg, enc,
                                frames_per_chunk, ogg=ogg)
        finally:
            if close_out:
                for f in outs.values():
                    f.close()
    return infos  # type: ignore[return-value]


def encode_wav_bytes_many(
    wav_bytes_list: List[bytes],
    config: Optional[EncoderConfig] = None,
    device: torch.device = "cuda",
) -> List[bytes]:
    """Batched multi-file encode over in-memory WAV blobs (BASELINE
    config 4): the bytes-in/bytes-out convenience wrapper around the
    streaming fused core (``encode_files`` is the file-to-file form with
    O(device batch) host memory)."""
    with stages.entry("encode.call"):
        sinks = [io.BytesIO() for _ in wav_bytes_list]
        _encode_files_core(
            wav_bytes_list,
            lambda i: io.BytesIO(wav_bytes_list[i]),
            lambda i: sinks[i],
            close_out=False,
            config=config,
            device=device,
            frames_per_chunk=None,
        )
        return [s.getvalue() for s in sinks]


def encode_wav_bytes(
    wav_bytes: bytes,
    config: Optional[EncoderConfig] = None,
    *,
    device: torch.device = "cuda",
    tags: Optional[List] = None,
    seek_interval: Optional[int] = None,
    padding: int = 0,
    extra_metadata: Optional[List[bytes]] = None,
) -> bytes:
    """The wav2flac path: WAV bytes in, FLAC bytes out
    (src/main.zig + src/wav2flac.zig), encoded on ``device`` (the card
    unless the caller asks for the CPU; without a card, cuda raises). On a
    single CUDA device the WAV's PCM bytes go to the card as they are
    (``Encoder.encode_pcm``); on a mesh or the CPU the host de-interleaves
    them first."""
    with stages.entry("encode.call"):
        with stages.span("wav.parse"):
            wav = WavReader.from_bytes(wav_bytes)
        with stages.span("session.setup"):
            cfg = config or EncoderConfig.default(wav.channels)
            info = wav.flac_streaminfo(cfg.block_size)
            enc = Encoder(cfg, wav.bit_depth, device)
        if enc.pipeline.card_fed:
            return enc.encode_pcm(
                wav.raw_pcm_bytes(), wav.bytes_per_sample, info, tags=tags,
                seek_interval=seek_interval, padding=padding, extra_metadata=extra_metadata,
            )
        with stages.span("wav.planar_samples"):
            samples = wav.planar_samples()
        with stages.span("wav.raw_copy"):
            raw = bytes(wav.raw_pcm_bytes())
        return enc.encode_stream(
            samples, info, raw_pcm_bytes=raw, tags=tags, seek_interval=seek_interval,
            padding=padding, extra_metadata=extra_metadata,
        )


def _count_seekpoints(total_samples: int, block: int, interval: int) -> int:
    """How many seek points ``build_seekpoints`` will emit — derivable from
    the geometry alone (points land on the first frame at or past each
    interval threshold), so the streaming writer can reserve the SEEKTABLE
    region before any frame is encoded."""
    count = 0
    next_at = 0
    while True:
        # first frame-start sample at or past the threshold
        sample = ((next_at + block - 1) // block) * block
        if sample >= total_samples:  # no frame starts there
            return count
        count += 1
        next_at = sample + interval


def encode_file_streaming(
    input_path: str,
    output_path: str,
    config: Optional[EncoderConfig] = None,
    device: torch.device = "cuda",
    tags: Optional[List] = None,
    seek_interval: Optional[int] = None,
    padding: int = 0,
    extra_metadata: Optional[List[bytes]] = None,
    frames_per_chunk: Optional[int] = None,
    ogg: bool = False,
) -> StreamInfo:
    """O(chunk)-memory wav2flac: the host never materializes more than one
    device batch of samples (plus the in-flight pipeline window), however
    large the file — the streaming analog of src/wav2flac.zig:64-75, which
    encodes 2^36-sample streams in O(frame) memory.

    Byte-identical to the in-memory ``encode_wav_bytes`` path: the same
    metadata chain is written up front (SEEKTABLE reserved at its exact final
    size and patched on the closing seek-back, alongside the reference's
    two-pass STREAMINFO protocol, src/wav2flac.zig:30-47), frames stream out
    as each device batch collects, and the MD5 accumulates incrementally
    (native.Md5Stream). A failure deletes the partial output.

    ``ogg=True`` writes Ogg-FLAC in the same single pass: header pages go
    out with placeholder STREAMINFO/SEEKTABLE payloads, frames packetize
    per batch, and the closing seek-back rewrites the header pages (Ogg
    lacing depends only on packet lengths, which the two-pass protocol
    keeps fixed — ogg.OggStreamSink).
    """
    # _count_seekpoints never terminates for interval <= 0 and a negative
    # interval passes the truthiness gates below
    _check_seek_interval(seek_interval)

    with stages.entry("encode.call"), WavStreamReader.open(input_path) as wav:
        with stages.span("session.setup"):
            cfg = config or EncoderConfig.default(wav.channels)
            info = wav.flac_streaminfo(cfg.block_size)
            enc = Encoder(cfg, wav.bit_depth, device)
        block = cfg.block_size
        if frames_per_chunk is None:
            frames_per_chunk = enc.pipeline.batch_size

        try:
            info = _stream_frames_to_file(
                wav, enc, info, output_path, block, frames_per_chunk,
                tags, seek_interval, padding, extra_metadata, ogg=ogg,
            )
        except BaseException:
            # never leave a partially written .flac behind (the in-memory
            # path fails before creating output; match that contract)
            with contextlib.suppress(OSError):
                os.unlink(output_path)
            raise
    return info


def _stream_frames_to_file(
    wav, enc, info, output_path, block, frames_per_chunk,
    tags, seek_interval, padding, extra_metadata, ogg: bool = False,
) -> StreamInfo:
    """The body of ``encode_file_streaming`` once the feeder and encoder are
    set up: writes the metadata chain, streams frames batch by batch (at
    most 2 batches in flight), and patches STREAMINFO + SEEKTABLE on the
    closing seek-back. Split out so the caller can delete the partial
    output on any failure."""

    def meta_chain(si_block, seekpoints):
        """The full metadata chain for the Ogg sink (native writes it
        piecewise below so it can seek-patch blocks individually).
        streaminfo_block's output carries the 'fLaC' stream magic (the
        native HEADER_SIZE covers it); inside Ogg the magic lives in
        packet 1's mapping header instead, so strip it here."""
        if si_block[:4] == b"fLaC":
            si_block = si_block[4:]
        blocks = [si_block]
        if seek_interval:
            blocks.append(seek_table_block(seekpoints, is_last=False))
        blocks.append(vorbis_comment_block(is_last=False, tags=tags))
        for extra in extra_metadata or []:
            blocks.append(extra)
        if padding > 0:
            blocks.append(padding_block(padding, is_last=False))
        blocks[-1] = set_last_flag(blocks[-1])
        return blocks

    pipe = enc.pipeline
    with open(output_path, "wb") as out:
        # -- metadata chain (STREAMINFO + SEEKTABLE patched at the end) --
        seek_pos = None
        n_points = 0
        if seek_interval:
            n_points = _count_seekpoints(info.interchannel_samples, block, seek_interval)
        sink = None
        if ogg:
            sink = OggStreamSink(out)
            sink.write_headers(
                meta_chain(streaminfo_block(info, is_last=False), [(0, 0, 0)] * n_points)
            )
        else:
            out.write(b"\x00" * HEADER_SIZE)
            if seek_interval:
                seek_pos = out.tell()
                out.write(seek_table_block([(0, 0, 0)] * n_points, is_last=False))
            blocks = [vorbis_comment_block(is_last=False, tags=tags)]
            for extra in extra_metadata or []:
                blocks.append(extra)
            if padding > 0:
                blocks.append(padding_block(padding, is_last=False))
            blocks[-1] = set_last_flag(blocks[-1])
            for b in blocks:
                out.write(b)

        # -- stream frames chunk by chunk --------------------------------
        md5 = native.Md5Stream()
        sizes: List[np.ndarray] = []
        pending: deque = deque()
        spf_pending: deque = deque()  # per-batch per-frame sample counts
        frame_no = 0

        def drain_one():
            frame_bytes, frame_sizes = pipe.collect_batch(pending.popleft(), info)
            samples_per_frame = spf_pending.popleft()
            if sink is not None:
                sink.add_frames(frame_bytes, frame_sizes, samples_per_frame)
            else:
                out.write(frame_bytes)
            sizes.append(np.asarray(frame_sizes, np.int64))

        while True:
            raw, planar = wav.read_samples(frames_per_chunk * block)
            if planar.shape[1] == 0:
                break
            md5.update(raw)
            c, m = planar.shape
            n_full = m // block
            rem = m - n_full * block
            if n_full:
                chunk = planar[:, : n_full * block].reshape(c, n_full, block).transpose(1, 0, 2)
                fns = frame_no + np.arange(n_full, dtype=np.int64)
                pending.append(pipe.dispatch_batch(chunk, fns, info))
                spf_pending.append(np.full(n_full, block, np.int64))
            if _tail_on_device(rem):  # ragged tails only end the final chunk
                pending.append(pipe.dispatch_tail(planar[:, n_full * block :],
                                                  frame_no + n_full, info))
                spf_pending.append(np.array([rem], np.int64))
            # keep at most 2 batches in flight: the window bounds host
            # memory while device compute overlaps disk reads
            while len(pending) > 2:
                drain_one()
            frame_no += n_full + (1 if rem else 0)
        while pending:
            drain_one()

        all_sizes = np.concatenate(sizes) if sizes else np.zeros(0, np.int64)
        info.update_frame_sizes(all_sizes)
        info.md5 = md5.digest()

        # -- closing seek-back: STREAMINFO + SEEKTABLE -------------------
        pts = []
        if seek_interval:
            pts = build_seekpoints(all_sizes, block, seek_interval, info.interchannel_samples)
            if len(pts) != n_points:
                raise RuntimeError("seekpoint geometry mismatch")
        if sink is not None:
            sink.finalize(meta_chain(streaminfo_block(info, is_last=False), pts))
        else:
            out.flush()
            out.seek(0)
            out.write(streaminfo_block(info, is_last=False)[:HEADER_SIZE])
            if seek_pos is not None:
                out.seek(seek_pos)
                out.write(seek_table_block(pts, is_last=False))
            out.flush()
    return info


def encode_file(
    input_path: str,
    output_path: str,
    config: Optional[EncoderConfig] = None,
    device: torch.device = "cuda",
    tags: Optional[List] = None,
    seek_interval: Optional[int] = None,
    padding: int = 0,
    extra_metadata: Optional[List[bytes]] = None,
    ogg: bool = False,
) -> StreamInfo:
    """File-to-file wav2flac (src/main.zig + src/wav2flac.zig). Streams:
    host memory stays O(device batch) regardless of file size. ``ogg=True``
    writes Ogg-FLAC in the same single pass."""
    return encode_file_streaming(
        input_path, output_path, config=config, device=device, tags=tags,
        seek_interval=seek_interval, padding=padding,
        extra_metadata=extra_metadata, ogg=ogg,
    )
