"""FLAC decoder on a torch device — the round-trip correctness check (and
BASELINE config 5).

Counterpart of ``zigflac_tpu/decoder.py``: parse metadata and frames,
Rice-decode residuals, run fixed/LPC synthesis, check frame CRC-8/CRC-16 and
the STREAMINFO MD5 against the reconstructed PCM. The serial bit parse runs
on the host in C++ (``parse_frames`` of ``native/zf_native.cpp``, built at
first use by ``ops/_build.native_module``; when it cannot be built the
decoder raises, there is no Python bit parser here), and the synthesis of
every batch of frames runs on the ``torch.device``: the CUDA card unless the
caller asks for the CPU, one launch of the kernel in ``csrc/synth.cu`` for
all subframes of the batch. ``backend="native"`` is the all-C++ path
instead (parse, synthesis and PCM serialization on the host, optionally on
several threads); it is never taken unless asked for.

Supports everything the encoder emits: constant/verbatim/fixed(0-4)/LPC
subframes, 4+5-bit Rice methods with escape partitions, all stereo modes,
UTF-8-coded frame numbers, uncommon block sizes.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .metadata import StreamInfo
from .utils import stages


class FlacDecodeError(ValueError):
    pass


@dataclass
class DecodedStream:
    info: StreamInfo
    samples: np.ndarray  # [channels, n] int64 (covers 33-bit side math)
    vendor: Optional[bytes]
    frame_count: int
    md5_ok: bool
    tags: Optional[list] = None
    seektable: Optional[list] = None


def parse_vorbis_body(body: bytes):
    """VorbisComment block body -> (vendor bytes, comment strings).

    Loops are bounded by the REAL body, never the claimed tag count: a
    corrupted count (up to 2^32) over an exhausted body would otherwise
    spin ~forever on zero-length reads (found by tools/fuzz_decode.py).
    Shared by the metadata parser and the CLI --list printer."""
    vlen = int.from_bytes(body[0:4], "little")
    vendor = body[4 : 4 + vlen]
    p = 4 + vlen
    ntags = int.from_bytes(body[p : p + 4], "little")
    p += 4
    comments = []
    for _ in range(ntags):
        if p + 4 > len(body):
            raise FlacDecodeError("truncated VorbisComment block")
        clen = int.from_bytes(body[p : p + 4], "little")
        p += 4
        comments.append(body[p : p + clen].decode("utf-8", "replace"))
        p += clen
    return vendor, comments


def _parse_metadata(data: bytes):
    if data[:4] != b"fLaC":
        raise FlacDecodeError("bad signature")
    pos = 4
    info: Optional[StreamInfo] = None
    vendor: Optional[bytes] = None
    tags: list = []
    seektable: list = []
    while True:
        hdr = data[pos]
        is_last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = data[pos + 4 : pos + 4 + length]
        pos += 4 + length
        if btype == 0:  # STREAMINFO
            if length != 34:
                raise FlacDecodeError("bad STREAMINFO length")
            min_block = int.from_bytes(body[0:2], "big")
            max_block = int.from_bytes(body[2:4], "big")
            min_frame = int.from_bytes(body[4:7], "big")
            max_frame = int.from_bytes(body[7:10], "big")
            packed = int.from_bytes(body[10:18], "big")
            sample_rate = packed >> 44
            channels = ((packed >> 41) & 0x7) + 1
            bit_depth = ((packed >> 36) & 0x1F) + 1
            total = packed & ((1 << 36) - 1)
            info = StreamInfo(
                sample_rate=sample_rate,
                channels=channels,
                bit_depth=bit_depth,
                interchannel_samples=total,
                min_block_size=min_block,
                max_block_size=max_block,
                md5=body[18:34],
                min_frame_size=min_frame,
                max_frame_size=max_frame,
            )
        elif btype == 3:  # SeekTable
            for p in range(0, length, 18):
                seektable.append((
                    int.from_bytes(body[p : p + 8], "big"),
                    int.from_bytes(body[p + 8 : p + 16], "big"),
                    int.from_bytes(body[p + 16 : p + 18], "big"),
                ))
        elif btype == 4:  # VorbisComment
            vendor, comments = parse_vorbis_body(body)
            tags.extend(
                tuple(c.split("=", 1)) for c in comments if "=" in c
            )
        if is_last:
            break
    if info is None:
        raise FlacDecodeError("no STREAMINFO")
    return info, vendor, tags, seektable, pos


BLOCK_NAMES = {
    0: "STREAMINFO", 1: "PADDING", 2: "APPLICATION", 3: "SEEKTABLE",
    4: "VORBIS_COMMENT", 5: "CUESHEET", 6: "PICTURE",
}


def metadata_blocks(data):
    """Walk the raw metadata chain of a native FLAC stream: yields
    ``(block_type, body bytes)`` per block, STREAMINFO first (the block
    layout of libFLAC/metadata.zig:3-18). ``data`` may be bytes or an mmap;
    only the metadata head is touched."""
    if bytes(data[:4]) != b"fLaC":
        raise FlacDecodeError("bad signature")
    pos = 4
    while True:
        if pos + 4 > len(data):
            # a chain whose last block lacks the last-flag runs off the
            # end — typed error, not IndexError (--edit exit-2 contract)
            raise FlacDecodeError("truncated metadata chain")
        hdr = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = bytes(data[pos + 4 : pos + 4 + length])
        if len(body) < length:
            raise FlacDecodeError("truncated metadata block")
        yield hdr & 0x7F, body
        pos += 4 + length
        if hdr & 0x80:
            break


_BATCH_FRAMES = 512
_BACKENDS = ("device", "native")
_TORCH_DTYPE = {np.int64: torch.int64, np.int32: torch.int32}

# While this is a dict, every batch of the device backend adds to it: the
# host parse's seconds ("parse_s") and, on a CUDA device, one (start, end)
# CUDA event pair around each synthesis launch ("synth_events"). None, the
# default, records nothing. The bytes copied to and from the device and the
# batches are the tracer's counters ``decoder.h2d_bytes``,
# ``decoder.d2h_bytes`` and ``decoder.batches`` (``utils/stages.py``).
STATS: Optional[dict] = None


def _parser():
    from .ops._build import native_module

    return native_module()


def _resolve(device, backend: str):
    """The torch device of the device backend; None for the all-C++
    backend, which touches no device."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
    if backend == "native":
        return None
    from .models.pipeline import resolve_device

    return resolve_device(device)


def _to_device(buf, np_dtype, shape, device: torch.device) -> torch.Tensor:
    """A parser output buffer as a tensor on ``device``: one host copy into
    a staging tensor (pinned for a CUDA device, so the transfer does not wait
    for the work already queued), then the copy to the device."""
    with stages.span("decoder.h2d"):
        a = np.frombuffer(buf, np_dtype).reshape(shape)
        staged = torch.empty(shape, dtype=_TORCH_DTYPE[np_dtype],
                             pin_memory=device.type == "cuda")
        staged.numpy()[...] = a
        stages.count("decoder.h2d_bytes", a.nbytes)
        return staged.to(device, non_blocking=True)


def _decode_batch(
    data: bytes, pos: int, info: StreamInfo, check_crc: bool,
    device: Optional[torch.device], max_frames: int = _BATCH_FRAMES,
):
    """C++ parse + batched synthesis for up to _BATCH_FRAMES consecutive
    frames sharing one block size. Returns (samples [C, m] int64, n_frames,
    end_pos). The serial bit extraction runs in C++ (``parse_frames``),
    normalizing every subframe to one predictor form; synthesis then runs
    either on ``device`` as one launch over all ``n * C`` subframes
    (ops/synth.py — the decoding dual of the encoder's frames-as-batch
    design) or, when ``device`` is None, in the C++ runtime (no device
    transfers). Both produce identical samples."""
    _n = _parser()
    C = info.channels
    with stages.span("decoder.parse"):
        t0 = time.perf_counter()
        try:
            (n, end, B, vb, qb, sb, cb, fb, kb, eb) = _n.parse_frames(
                data, pos, max_frames, info.bit_depth, C
            )
        except ValueError as e:
            raise FlacDecodeError(str(e)) from e
        if STATS is not None:
            STATS["parse_s"] = STATS.get("parse_s", 0.0) + time.perf_counter() - t0
    if n == 0:
        return np.zeros((C, 0), np.int64), 0, pos
    ch_code = np.frombuffer(cb, np.int32)
    crc_ok = np.frombuffer(kb, np.uint8)
    if check_crc and not crc_ok.all():
        bad = int(np.argmin(crc_ok))
        raise FlacDecodeError(f"frame CRC mismatch (frame {bad} of batch)")

    if device is None:
        with stages.span("decoder.synth"):
            samples = np.frombuffer(
                _n.synthesize(vb, qb, sb, cb, n, C, B), np.int64
            ).reshape(n, C, B)
    else:
        from .ops.synth import _synthesize_unchecked, recombine_stereo

        M = n * C
        # synthesize_batch's range check, made here on the host, so the
        # synthesis call never waits for the device
        sow = np.frombuffer(sb, np.int32).reshape(M, 3)
        if ((sow[:, 0] < 0) | (sow[:, 0] > 63) | (sow[:, 2] < 0) | (sow[:, 2] > 63)).any():
            raise FlacDecodeError("shift and wasted must lie in 0..63")
        values = _to_device(vb, np.int64, (M, B), device)
        qco = _to_device(qb, np.int64, (M, 32), device)
        sow = _to_device(sb, np.int32, (M, 3), device).to(torch.int64)
        with stages.span("decoder.synth"):
            timed = STATS is not None and device.type == "cuda"
            if timed:
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            wire = _synthesize_unchecked(values, qco, sow[:, 0], sow[:, 1], sow[:, 2])
            if timed:
                stop.record()
                STATS.setdefault("synth_events", []).append((start, stop))
            wire = wire.reshape(n, C, B)
            if C == 2 and (ch_code >= 8).any():
                wire = recombine_stereo(wire, _to_device(cb, np.int32, (n,), device))
            if info.bit_depth <= 24:
                # samples fit i32 (depth+1 side headroom <= 25 bits): halve the
                # device->host bytes, then widen on host (the decoder's public
                # dtype is int64 for the 33-bit depth-32 case)
                wire = wire.to(torch.int32)
        with stages.span("decoder.d2h"):  # waits for the synthesis, then copies
            got = wire.cpu().numpy()
        stages.count("decoder.d2h_bytes", got.nbytes)
        stages.count("decoder.batches")
    with stages.span("decoder.widen"):
        if device is not None:
            samples = got.astype(np.int64)
        if np.abs(samples).max(initial=0) >= (1 << 40):
            raise FlacDecodeError("synthesis diverged — corrupt stream")
        return samples.transpose(1, 0, 2).reshape(C, n * B), n, end


def decode_flac(
    data: bytes, check_crc: bool = True, device="cuda", backend: str = "device"
) -> DecodedStream:
    """Decode a FLAC stream.

    ``backend="device"`` batches frames through the C++ bit parser and runs
    the synthesis on ``device`` (``cuda`` without a card raises; ``cpu`` runs
    the kernel's plain version); ``backend="native"`` uses the same parser
    with C++ IIR synthesis and touches no device. Both produce identical
    samples (tests/test_torch_decoder.py).
    """
    with stages.entry("decode.call"):
        device = _resolve(device, backend)
        with stages.span("decoder.metadata"):
            info, vendor, tags, seektable, pos = _parse_metadata(data)
        chunks: List[np.ndarray] = []
        frame_count = 0
        total = 0
        while total < info.interchannel_samples and pos < len(data):
            samples, nfr, pos = _decode_batch(data, pos, info, check_crc, device)
            if nfr == 0:
                break
            frame_count += nfr
            chunks.append(samples)
            total += samples.shape[1]
        if total != info.interchannel_samples:
            raise FlacDecodeError(
                f"decoded {total} samples, STREAMINFO says {info.interchannel_samples}"
            )
        with stages.span("decoder.concat"):
            samples = np.concatenate(chunks, axis=1) if chunks else np.zeros(
                (info.channels, 0), dtype=np.int64
            )
        md5_ok = _verify_md5(samples, info)
        return DecodedStream(
            info, samples, vendor, frame_count, md5_ok, tags, seektable or None
        )


def _verify_md5(samples: np.ndarray, info: StreamInfo) -> bool:
    """Re-derive the raw little-endian PCM byte stream and compare its MD5
    with STREAMINFO's (which the encoder computed over the raw WAV bytes,
    src/WavReader.zig:69). Uses the same serialization helper as the encoder
    (wav.reconstruct_raw_bytes), covering every 4-32-bit depth (sub-byte
    and non-byte-aligned depths use the left-justified container stride
    with the 1-byte read-quirk inverse)."""
    from .wav import reconstruct_raw_bytes

    if info.md5 == b"\x00" * 16:
        return True
    with stages.span("decoder.md5"):
        with stages.span("decoder.md5.serialize"):
            raw = reconstruct_raw_bytes(samples, info.bit_depth)
        with stages.span("decoder.md5.hash"):
            return hashlib.md5(raw).digest() == info.md5


def decode_file(
    input_path: str,
    output_path: str,
    check_crc: bool = True,
    device="cuda",
    verify: bool = False,
    backend: str = "device",
    threads: int | None = None,
) -> StreamInfo:
    """Streaming flac2wav: decode a FLAC file to a PCM WAV with host memory
    bounded by one frame batch — the decode-side counterpart of the
    encoder's streaming feeder. The input maps via mmap (the C++ parser
    reads straight from the mapping, page cache evictable), the WAV header
    is written up front from STREAMINFO, and each decoded batch's samples
    stream out immediately; MD5 accumulates incrementally when ``verify``.

    Returns the STREAMINFO. Raises FlacDecodeError on CRC/MD5/format
    failure (``verify=True`` adds the MD5 check).

    ``threads`` belongs to ``backend="native"``, whose single C++ pass does
    parse, synthesis and PCM serialization: the frame-parallel worker count;
    ``None`` uses the host CPU count. Frames are independent once their byte
    boundaries are known, so workers speculatively start at sync-scan
    candidates and the stitcher verifies the spans chain exactly, falling
    back to serial decode from the last verified byte on any mismatch — the
    output is byte-identical to single-threaded decode by construction.
    """
    import mmap
    import os as _os

    from . import native as _native
    from .wav import reconstruct_raw_bytes, wav_header_bytes, wav_pcm_bytes

    device = _resolve(device, backend)
    fused = backend == "native"
    if threads is not None and not fused:
        raise ValueError('threads belongs to backend="native"')
    if threads is None:
        threads = _os.cpu_count() or 1
    mt = fused and threads > 1
    _n = _parser() if fused else None
    with stages.entry("decode.call"), open(input_path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            if mm[:4] == b"OggS":
                # Ogg-FLAC input: strip the container first (page CRCs
                # verified). The native stream is held in memory for the
                # decode — unlike the mmap path this is O(file), which is
                # fine for the container use case; a page-streaming
                # transmux can bound it later if needed.
                from .ogg import ogg_to_flac

                try:
                    native_stream = ogg_to_flac(bytes(mm), verify_crc=check_crc)
                except ValueError as e:
                    raise FlacDecodeError(str(e)) from e
                mm.close()
                mm = native_stream  # bytes quack enough for the loop below
            info, _vendor, _tags, _seek, pos = _parse_metadata(mm)
            md5 = _native.Md5Stream() if verify else None
            total = 0
            nb = (info.bit_depth + 7) // 8
            # MT path: a bigger per-call budget amortizes the per-batch
            # sync scan + thread spawn; bounded so the batch's PCM buffer
            # stays ~<=64 MB at the nominal 4096 block
            batch_frames = _BATCH_FRAMES
            if mt:
                byte_cap = (64 << 20) // max(4096 * info.channels * nb, 1)
                batch_frames = max(
                    _BATCH_FRAMES, min(threads * _BATCH_FRAMES, byte_cap)
                )
            try:
                # raises ValueError when a (possibly corrupt) STREAMINFO
                # claims more PCM than RIFF's u32 sizes can carry — keep
                # the CLI's typed-error contract (exit 2, no traceback)
                wav_hdr = wav_header_bytes(
                    info.interchannel_samples, info.channels,
                    info.sample_rate, info.bit_depth,
                )
            except ValueError as e:
                raise FlacDecodeError(str(e)) from e
            with open(output_path, "wb") as out:
                out.write(wav_hdr)
                while total < info.interchannel_samples and pos < len(mm):
                    if fused:
                        # single native pass: parse + synthesis + container
                        # serialization (the PCM bytes come out ready to
                        # write, and — for multi-byte containers — ready to
                        # MD5: reconstruct_raw_bytes == wav_pcm_bytes there)
                        if mt:
                            nfr, pos, _B, pcm, bad, maxabs = (
                                _n.decode_frames_pcm_mt(
                                    mm, pos, batch_frames, info.bit_depth,
                                    info.channels, threads,
                                )
                            )
                        else:
                            nfr, pos, _B, pcm, bad, maxabs = (
                                _n.decode_frames_pcm(
                                    mm, pos, _BATCH_FRAMES, info.bit_depth,
                                    info.channels,
                                )
                            )
                        if nfr == 0:
                            break
                        if check_crc and bad >= 0:
                            raise FlacDecodeError(
                                f"frame CRC mismatch (frame {bad} of batch)"
                            )
                        if maxabs >= 1 << 40:
                            raise FlacDecodeError(
                                "synthesis diverged — corrupt stream"
                            )
                        m = len(pcm) // (info.channels * nb)
                        total += m
                        if total > info.interchannel_samples:
                            cut = (total - info.interchannel_samples) * (
                                info.channels * nb
                            )
                            pcm = pcm[: len(pcm) - cut]
                            total = info.interchannel_samples
                        out.write(pcm)
                        if md5 is not None:
                            if nb == 1:
                                # 1-byte container: MD5 covers the quirk
                                # inverse (value+1 left-justified,
                                # src/WavReader.zig:74-81); the WAV
                                # container byte is value<<pad + 128, so
                                # rebias by (1<<pad) - 128 (mod 256)
                                pad = 8 - info.bit_depth
                                md5.update(
                                    (
                                        np.frombuffer(pcm, np.uint8)
                                        + np.uint8(((1 << pad) - 128) & 0xFF)
                                    ).tobytes()
                                )
                            else:
                                md5.update(pcm)
                        continue
                    samples, nfr, pos = _decode_batch(
                        mm, pos, info, check_crc, device
                    )
                    if nfr == 0:
                        break
                    total += samples.shape[1]
                    if total > info.interchannel_samples:
                        # trim padding of the final frame batch
                        samples = samples[
                            :, : samples.shape[1]
                            - (total - info.interchannel_samples)
                        ]
                        total = info.interchannel_samples
                    out.write(wav_pcm_bytes(samples, info.bit_depth))
                    if md5 is not None:
                        md5.update(
                            reconstruct_raw_bytes(samples, info.bit_depth)
                        )
            if total != info.interchannel_samples:
                raise FlacDecodeError(
                    f"decoded {total} samples, STREAMINFO says "
                    f"{info.interchannel_samples}"
                )
            if md5 is not None and info.md5 != b"\x00" * 16:
                if md5.digest() != info.md5:
                    raise FlacDecodeError("MD5 mismatch")
            return info
        finally:
            if hasattr(mm, "close"):  # bytes after an Ogg transmux
                mm.close()


def decode_range(
    data: bytes, start_sample: int, n_samples: int, check_crc: bool = True,
    device="cuda", backend: str = "device",
) -> np.ndarray:
    """Random-access decode: ``[channels, n_samples]`` starting at
    ``start_sample``, using the SEEKTABLE (when present) to skip ahead —
    only the frames covering the range are parsed and synthesized.

    Seek points map sample numbers to byte offsets from the first frame
    (metadata.build_seekpoints); without a SEEKTABLE decoding starts at the
    first frame. Frames before the target that the nearest seek point cannot
    skip are decoded and discarded (FLAC frames are independent, so this is
    exact). Batch sizes are capped near the range so little work happens
    past its end."""
    with stages.entry("decode.call"):
        device = _resolve(device, backend)
        with stages.span("decoder.metadata"):
            info, _vendor, _tags, seektable, pos = _parse_metadata(data)
        if start_sample < 0 or start_sample + n_samples > info.interchannel_samples:
            raise FlacDecodeError("requested range outside the stream")
        first_frame_pos = pos
        cur_sample = 0
        best = None
        for sample, offset, _ns in seektable or []:
            if sample <= start_sample and (best is None or sample > best[0]):
                best = (sample, offset)
        if best is not None:
            cur_sample = best[0]
            pos = first_frame_pos + best[1]

        out: List[np.ndarray] = []
        got = 0
        block_hint = info.max_block_size or 4096
        while got < n_samples and pos < len(data):
            # bound the batch to the frames the range can still need
            need = start_sample + n_samples - cur_sample
            maxf = min(_BATCH_FRAMES, -(-need // max(block_hint, 1)) + 1)
            samples, nfr, pos = _decode_batch(
                data, pos, info, check_crc, device, max_frames=maxf
            )
            if nfr == 0:
                break
            block_hint = samples.shape[1] // nfr
            bs = samples.shape[1]
            if cur_sample + bs <= start_sample:
                cur_sample += bs
                continue
            lo = max(0, start_sample + got - cur_sample)
            hi = min(bs, start_sample + n_samples - cur_sample)
            out.append(samples[:, lo:hi])
            got += hi - lo
            cur_sample += bs
        if got != n_samples:
            raise FlacDecodeError("stream ended inside the requested range")
        return np.concatenate(out, axis=1)


def verify_flac(data: bytes, device="cuda", backend: str = "device") -> bool:
    """Decode + verify CRCs and MD5; True iff everything checks out.
    Ogg-FLAC input is stripped transparently (page CRCs count too).

    Truncated input surfaces as IndexError from the metadata parser or as
    the parser's ValueError rather than FlacDecodeError — treat those as a
    clean verification failure, not a crash. A device that is not there is
    not a verdict on the stream: that error is raised."""
    device = _resolve(device, backend)
    with stages.entry("decode.call"):
        try:
            if data[:4] == b"OggS":
                from .ogg import ogg_to_flac

                data = ogg_to_flac(data)
            dec = decode_flac(data, check_crc=True, device=device, backend=backend)
        except (FlacDecodeError, EOFError, IndexError, ValueError):
            return False
        return dec.md5_ok
