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
``encode_to_file`` (planar samples to a seekable file). The file entry
points share one streaming writer (``_encode_group_fused``), and every
entry point builds its metadata chain with ``_metadata_blocks``.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
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
from .pipeline import DevicePipeline


def _check_seek_interval(seek_interval: Optional[int]) -> None:
    if seek_interval is not None and seek_interval <= 0:
        raise ValueError(f"seek_interval must be positive, got {seek_interval}")


# The STREAMINFO MD5's worker: one thread a process, started by the first
# encode that needs it, so each call's hash runs beside its dispatch and
# collect and the call waits for the digest only where STREAMINFO takes it.
_md5_pool: Optional[ThreadPoolExecutor] = None
_md5_pool_lock = threading.Lock()


def _forget_md5_pool() -> None:
    """A forked child has no worker thread: it starts its own."""
    global _md5_pool, _md5_pool_lock
    _md5_pool, _md5_pool_lock = None, threading.Lock()


os.register_at_fork(after_in_child=_forget_md5_pool)


def _md5_job(raw, samples: Optional[np.ndarray], bit_depth: int):
    """On the worker: the MD5 of ``raw`` (of ``samples`` serialized at
    ``bit_depth`` where ``raw`` is None) and the nanoseconds the job took.
    It opens no span and counts nothing: the tracer assumes one thread."""
    t0 = time.perf_counter_ns()
    if raw is None:
        raw = reconstruct_raw_bytes(samples, bit_depth)
    digest = hashlib.md5(raw).digest()  # releases the GIL while it hashes
    return digest, time.perf_counter_ns() - t0


def _start_md5(raw, samples: Optional[np.ndarray] = None, bit_depth: int = 0) -> Future:
    """Queue ``_md5_job`` on the worker; ``_md5_digest`` waits for it."""
    global _md5_pool
    with _md5_pool_lock:
        if _md5_pool is None:
            _md5_pool = ThreadPoolExecutor(1, thread_name_prefix="zigflac-md5")
        return _md5_pool.submit(_md5_job, raw, samples, bit_depth)


def _md5_digest(job: Future) -> bytes:
    """The digest of ``job``, waited for on the calling thread: the
    ``session.md5`` span is that wait, and ``session.md5_hash_ns`` counts
    the job's own time. The job's exception, if it raised, is raised here."""
    with stages.span("session.md5"):
        digest, hash_ns = job.result()
    stages.count("session.md5_hash_ns", hash_ns)
    return digest


def _metadata_blocks(info: StreamInfo, seekpoints=None, tags: Optional[List] = None,
                     extra_metadata: Optional[List[bytes]] = None,
                     padding: int = 0) -> List[bytes]:
    """The metadata chain of every entry point: STREAMINFO (after the
    'fLaC' magic), a SEEKTABLE of ``seekpoints`` where they are not None,
    the VorbisComment of ``tags``, ``extra_metadata`` (blocks built with
    is_last=False) and ``padding`` bytes of PADDING, the last-block flag on
    the final block."""
    blocks = [streaminfo_block(info, is_last=False)]
    if seekpoints is not None:
        blocks.append(seek_table_block(seekpoints, is_last=False))
    blocks.append(vorbis_comment_block(is_last=False, tags=tags))
    blocks.extend(extra_metadata or [])
    if padding > 0:
        blocks.append(padding_block(padding, is_last=False))
    blocks[-1] = set_last_flag(blocks[-1])
    return blocks


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
        md5_job: Optional[Future] = None,
    ) -> bytes:
        """Planar ``[channels, n] int32`` -> complete FLAC stream.

        ``raw_pcm_bytes`` is the little-endian interleaved byte stream the
        STREAMINFO MD5 covers; when None it is reconstructed from samples.
        ``md5_job``, internal, is that MD5 already started (``_start_md5``).
        ``seek_interval`` (samples) adds a SEEKTABLE block with a point at
        most every that many samples; ``padding`` adds a PADDING block of
        that many zero bytes; ``extra_metadata`` takes pre-built blocks
        (built with is_last=False) — the last-block flag is fixed up here.
        """
        _check_seek_interval(seek_interval)
        with stages.entry("encode.call"):
            stream, sizes, md5_job = self._encode_samples(samples, info, raw_pcm_bytes, md5_job)
            return self._finish(stream, sizes, md5_job, info, tags, seek_interval, padding,
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
        md5_job: Optional[Future] = None,
    ) -> bytes:
        """``encode_stream`` of a WAV's interleaved little-endian PCM bytes
        (``WavReader.raw_pcm_bytes()``, ``bytes_per_sample`` bytes a
        sample) in place of planar samples: the bytes cross to the device
        once and are unpacked there (``DevicePipeline.encode_pcm_stream``),
        and the MD5 worker hashes them where they are (``md5_job``, internal:
        the job ``encode_wav_bytes`` started at the parse; started here where
        None). On a mesh the pipeline de-interleaves each batch on the host
        instead. ``encode_wav_bytes`` always takes this route."""
        _check_seek_interval(seek_interval)
        with stages.entry("encode.call"):
            if md5_job is None:
                md5_job = _start_md5(pcm)
            stream, sizes = self.pipeline.encode_pcm_stream(pcm, bytes_per_sample, info)
            return self._finish(stream, sizes, md5_job, info, tags, seek_interval,
                                padding, extra_metadata)

    def _finish(self, stream: bytes, sizes: np.ndarray, md5_job: Future, info: StreamInfo,
                tags, seek_interval, padding, extra_metadata) -> bytes:
        """The metadata blocks, with the finalized STREAMINFO (its MD5
        waited for first), before the frame stream."""
        md5 = _md5_digest(md5_job)
        with stages.span("session.finish"):
            info.update_frame_sizes(sizes)
            info.md5 = md5
            pts = None
            if seek_interval:
                pts = build_seekpoints(sizes, self.config.block_size, seek_interval,
                                       info.interchannel_samples)
            return b"".join(_metadata_blocks(info, pts, tags, extra_metadata, padding)) + stream

    def _encode_samples(self, samples: np.ndarray, info: StreamInfo,
                        raw_pcm_bytes: Optional[bytes], md5_job: Optional[Future] = None):
        """Every frame of planar samples: (frame-stream bytes, sizes, the
        MD5's job). The job, started here unless the caller started it,
        hashes on the worker while this thread dispatches and collects."""
        if md5_job is None:
            md5_job = _start_md5(raw_pcm_bytes, samples, self.bit_depth)
        c, n = samples.shape
        block = self.config.block_size
        n_full = n // block
        rem = n - n_full * block
        batch = samples[:, : n_full * block].reshape(c, n_full, block).transpose(1, 0, 2)
        stream, sizes = self.pipeline.encode_frames_stream(
            batch, 0, info,
            tail=samples[:, n_full * block :] if rem else None,
        )
        return stream, sizes, md5_job


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

        out_file.write(bytes(HEADER_SIZE) + b"".join(_metadata_blocks(info)[1:]))  # skipHeader
        stream, sizes, md5_job = enc._encode_samples(samples, info, raw_pcm_bytes)
        out_file.write(stream)
        info.update_frame_sizes(sizes)
        info.md5 = _md5_digest(md5_job)

        out_file.flush()
        out_file.seek(0)
        out_file.write(_metadata_blocks(info)[0])
        out_file.flush()
        return info


class _FileJob:
    """Per-file bookkeeping of the streaming file encode: the output stream
    (its metadata chain already written, STREAMINFO and any SEEKTABLE as
    placeholders), incremental MD5, collected frame sizes, and the
    outstanding-dispatch counter that gates the closing seek-back. With
    ``ogg`` the same two-pass protocol runs at page granularity
    (ogg.OggStreamSink) and frames packetize as they collect. The SEEKTABLE
    (every ``seek_interval`` samples) is reserved at its exact final size,
    derived from the geometry alone."""

    __slots__ = (
        "info", "out", "md5", "sizes", "frame_no", "reading_done", "queued", "inflight",
        "finalized", "sink", "samples_emitted", "seek_interval", "n_points", "meta",
    )

    def __init__(self, info: StreamInfo, out, ogg: bool = False, tags: Optional[List] = None,
                 seek_interval: Optional[int] = None, padding: int = 0,
                 extra_metadata: Optional[List[bytes]] = None) -> None:
        self.info = info
        self.out = out
        self.md5 = native.Md5Stream()
        self.sizes: List[np.ndarray] = []
        self.frame_no = 0
        self.reading_done = False
        self.queued = 0    # accumulator runs + tails not yet dispatched
        self.inflight = 0  # dispatched segments not yet collected
        self.finalized = False
        self.sink = OggStreamSink(out) if ogg else None
        self.samples_emitted = 0
        self.seek_interval = seek_interval
        self.n_points = (_count_seekpoints(info.interchannel_samples, info.max_block_size,
                                           seek_interval) if seek_interval else 0)
        self.meta = (tags, extra_metadata, padding)
        chain = self._chain([(0, 0, 0)] * self.n_points if seek_interval else None)
        if self.sink is not None:
            self.sink.write_headers(chain)
        else:
            out.write(bytes(HEADER_SIZE) + b"".join(chain[1:]))  # skipHeader

    def _chain(self, seekpoints) -> List[bytes]:
        """The metadata chain; inside Ogg the 'fLaC' magic lives in packet
        1's mapping header, so STREAMINFO's block drops it."""
        blocks = _metadata_blocks(self.info, seekpoints, *self.meta)
        if self.sink is not None:
            blocks[0] = blocks[0][4:]
        return blocks

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
        pts = None
        if self.seek_interval:
            pts = build_seekpoints(all_sizes, self.info.max_block_size, self.seek_interval,
                                   self.info.interchannel_samples)
            if len(pts) != self.n_points:
                raise RuntimeError("seekpoint geometry mismatch")
        chain = self._chain(pts)
        if self.sink is not None:
            self.sink.finalize(chain)
        else:
            self.out.flush()
            self.out.seek(0)
            # STREAMINFO, then the SEEKTABLE where there is one
            self.out.write(b"".join(chain[: 1 if pts is None else 2]))
            self.out.flush()
        self.finalized = True


def _encode_group_fused(
    idxs: List[int],
    open_in,
    open_out,
    infos: List[Optional[StreamInfo]],
    enc: Encoder,
    frames_per_chunk: Optional[int],
    ogg: bool = False,
    meta: Optional[dict] = None,
) -> None:
    """Core of every file encode: stream every file in ``idxs`` (``open_in``
    gives its ``WavStreamReader``, ``open_out`` its output) through one
    shared pipeline, fusing full frames across file boundaries into device
    batches (per-file frame numbering preserved). Host memory stays
    O(device batch): one input file is open at a time, at most ``window``
    batches are in flight, and each file's output finalizes (seek-back
    STREAMINFO) as soon as its last frame collects. ``meta`` holds
    ``_FileJob``'s metadata arguments; without it each file gets the
    default chain."""
    pipe = enc.pipeline
    block = enc.config.block_size
    bs = frames_per_chunk or pipe.batch_size
    window = 2  # in-flight batches: bounds host memory while the device overlaps reads

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
        with open_in(i) as wav:
            info = infos[i] = wav.flac_streaminfo(block)
            job = jobs[i] = _FileJob(info, open_out(i), ogg, **(meta or {}))
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
                if rem:  # only on the final chunk of the file
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
            lambda i: WavStreamReader.open(in_paths[i]),
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
        with open_in(i) as probe:
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
            _encode_group_fused(idxs, open_in, open_out_tracked, infos, enc, frames_per_chunk,
                                ogg=ogg)
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
            lambda i: WavStreamReader(io.BytesIO(wav_bytes_list[i])),
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
    unless the caller asks for the CPU; without a card, cuda raises). The
    STREAMINFO MD5 of the WAV's PCM bytes starts on the worker as soon as
    they are parsed, and the bytes go to the pipeline as they are
    (``Encoder.encode_pcm``): a single device unpacks them there, a mesh
    has the host de-interleave each batch."""
    with stages.entry("encode.call"):
        with stages.span("wav.parse"):
            wav = WavReader.from_bytes(wav_bytes)
        md5_job = _start_md5(wav.raw_pcm_bytes())
        with stages.span("session.setup"):
            cfg = config or EncoderConfig.default(wav.channels)
            info = wav.flac_streaminfo(cfg.block_size)
            enc = Encoder(cfg, wav.bit_depth, device)
        return enc.encode_pcm(
            wav.raw_pcm_bytes(), wav.bytes_per_sample, info, tags=tags,
            seek_interval=seek_interval, padding=padding, extra_metadata=extra_metadata,
            md5_job=md5_job,
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
    (native.Md5Stream). It is the multi-file core (``_encode_group_fused``)
    over one file. A failure deletes the partial output.

    ``ogg=True`` writes Ogg-FLAC in the same single pass: header pages go
    out with placeholder STREAMINFO/SEEKTABLE payloads, frames packetize
    per batch, and the closing seek-back rewrites the header pages (Ogg
    lacing depends only on packet lengths, which the two-pass protocol
    keeps fixed — ogg.OggStreamSink).
    """
    # _count_seekpoints never terminates for interval <= 0 and a negative
    # interval passes the truthiness gates of the writer
    _check_seek_interval(seek_interval)

    with stages.entry("encode.call"), WavStreamReader.open(input_path) as wav:
        with stages.span("session.setup"):
            cfg = config or EncoderConfig.default(wav.channels)
            wav.flac_streaminfo(cfg.block_size)  # refuses the WAV before any output exists
            enc = Encoder(cfg, wav.bit_depth, device)
        infos: List[Optional[StreamInfo]] = [None]
        meta = dict(tags=tags, seek_interval=seek_interval, padding=padding,
                    extra_metadata=extra_metadata)
        try:
            with open(output_path, "wb") as out:
                _encode_group_fused([0], lambda i: wav, lambda i: out, infos, enc,
                                    frames_per_chunk, ogg=ogg, meta=meta)
        except BaseException:
            # never leave a partially written .flac behind (the in-memory
            # path fails before creating output; match that contract)
            with contextlib.suppress(OSError):
                os.unlink(output_path)
            raise
    return infos[0]


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
