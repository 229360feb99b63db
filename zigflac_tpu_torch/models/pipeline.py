"""DevicePipeline — the batched encode path on a torch device.

frames [N, C, B] PCM  ──(device)──>  dense frame-stream words + sizes
                                       │
                          (host) slice + write — no per-frame work

On a single CUDA device ``encode_pcm_stream`` takes a WAV's interleaved
PCM bytes as they are: each batch's bytes cross to the card once and the
PCM unpack kernel (``ops/unpack.py``) makes its frames there.

One batch function covers plane construction, stereo-mode and subframe
selection, the Rice search (the CUDA analysis kernel on the card), bit
packing (the CUDA deposit kernel), CRC-16 (the CUDA CRC kernel) and stream
compaction — everything between the WAV feeder and
the output bytes. Outputs come back as one dense stream sized by a capacity
ladder (compressed-size budget -> verbatim-size budget -> exact padded
words). Batches are dispatched before any is collected, so on a CUDA device
the host work that follows overlaps the device's.

With a mesh (``parallel/mesh.py``) each batch is split over several devices
or processes: every shard runs the same batch function on its own rows and
device, and an overflowing shard re-encodes alone through the ladder.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from ..metadata import StreamInfo
from ..native import assemble_frames, assemble_ranges
from ..ops.analyze import check_partition_order, lpc_order_of, plan_frames
from ..ops.bitpack import ALIGN_W, compact_stream_aligned, max_frame_words, pack_frames
from ..ops.crc16 import crc16_frames
from ..ops.header import HeaderStatic, header_static
from ..ops.unpack import unpack_pcm
from ..utils import stages
from ..utils.config import EncoderConfig

DEFAULT_BATCH = 1024

# Ragged tails of every length encode on the device at their exact block
# size. (The JAX package sends tails under 64 samples to its host oracle:
# its symbol builder slices four warmup columns, which fails for 1-3
# samples; this port slices min(B, max(4, lpc_order)), and a frame of
# B <= max(4, lpc_order) samples is always constant or verbatim.)
TAIL_DEVICE_MIN = 1

# capacity ladder: (output-stream budget, per-frame word budget) as
# fractions of raw PCM bytes. Tier 0 covers typical audio; tier 1 covers
# all-verbatim frames; the exact-worst-case padded-words path is the final
# fallback. Packing and CRC cost scale with the word budget.
CAPACITY_LADDER = ((0.75, 1.25), (1.15, None))


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 1 else 1


def compact_shape(config: EncoderConfig, depth: int, c: int, block_size: int,
                  sample_rate: int, tier, batch: int):
    """(hstatic, max_words, capb) of one program shape; tier None is the
    exact-capacity words path."""
    hstatic = header_static(block_size, sample_rate, depth)
    n_wire = 2 if config.stereo_auto else c
    if tier is None:
        return hstatic, max_frame_words(block_size, n_wire, depth), None
    stream_ratio, words_ratio = CAPACITY_LADDER[tier]
    max_words = max_frame_words(block_size, n_wire, depth, words_ratio)
    raw_bytes = batch * block_size * c * max(depth, 8) // 8
    # slack: per-frame ALIGN_W-group round-up (4*ALIGN_W bytes) + headroom
    capb = int(raw_bytes * stream_ratio) + (4 * ALIGN_W + 32) * batch
    return hstatic, max_words, capb


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; from pinned memory on a CUDA device,
    so the copy does not wait for the work already queued. Counts the
    bytes as ``pipeline.h2d_bytes`` (``utils/stages.py``); its callers
    time it as the ``pipeline.h2d`` span."""
    stages.count("pipeline.h2d_bytes", a.nbytes)
    t = torch.from_numpy(np.require(a, requirements="CW"))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _product_mesh(device: torch.device):
    """The mesh the pipeline shards over (None: a single device): the
    processes of a ``torch.distributed`` group, each with its own device,
    or, in one process, every visible card when ``device`` is ``cuda``
    with no index and more than one card is visible. ZIGFLAC_MESH=0
    forces a single device."""
    if os.environ.get("ZIGFLAC_MESH", "1") == "0":
        return None
    from ..parallel import distributed
    from ..parallel.mesh import default_mesh

    if distributed.process_count() > 1:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return default_mesh([device])
    if device.type == "cuda" and device.index is None and torch.cuda.device_count() > 1:
        return default_mesh()
    return None


def resolve_device(device) -> torch.device:
    """The explicit device; a CUDA device without a card raises (there is
    no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device is cuda but torch.cuda.is_available() is false")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def _encode_batch(
    frames: torch.Tensor,
    frame_numbers: torch.Tensor,
    *,
    config: EncoderConfig,
    depth: int,
    hstatic: HeaderStatic,
    block_size: int,
    max_words: int,
):
    """Words path: (words int32 [N, max_words], total_bits), before the
    CRC-16."""
    stages.mark("begin")
    plan = plan_frames(frames, depth, config)
    stages.mark("analysis")
    return pack_frames(
        plan, frame_numbers, hstatic, block_size, config.max_rice_order, max_words,
        lpc_order_of(config), config.lpc_precision,
    )


def _encode_batch_compact(
    frames: torch.Tensor,
    frame_numbers: torch.Tensor,
    *,
    config: EncoderConfig,
    depth: int,
    hstatic: HeaderStatic,
    block_size: int,
    max_words: int,
    capb: int,
):
    """Compact path: (stream int32 [~capb / 4], meta int64 [N + 1] =
    [frame_bytes..., total_words])."""
    words, total_bits = _encode_batch(
        frames, frame_numbers, config=config, depth=depth, hstatic=hstatic,
        block_size=block_size, max_words=max_words,
    )
    byte_len = (total_bits + 7) >> 3
    _, words = crc16_frames(words, byte_len)
    stages.mark("crc")
    frame_bytes = byte_len + 2
    stream, total_words = compact_stream_aligned(words, frame_bytes, capb // 4)
    stages.mark("compaction")
    return stream, torch.cat([frame_bytes, total_words[None]])


def _collect_aligned(stream: torch.Tensor, meta: torch.Tensor, nreal: int, frame_cap: int):
    """Fetch one batch's word-aligned compact stream and tighten it to the
    exact frame-byte concatenation. None on capacity overflow. The fetch of
    ``meta`` is where the host waits for the batch's device work."""
    with stages.span("pipeline.wait"):
        meta = meta.cpu().numpy()
    stages.count("pipeline.d2h_bytes", meta.nbytes)
    fsz = meta[:nreal]
    if int(fsz.max()) > frame_cap:
        return None  # some frame out-sized its per-frame word budget
    # frames start on ALIGN_W-word groups in the compact stream (mirrors
    # ops/bitpack.compact_stream_aligned's layout)
    gcnt = (fsz + 4 * ALIGN_W - 1) // (4 * ALIGN_W)
    woff = (np.cumsum(gcnt) - gcnt) * ALIGN_W
    need = int((woff[-1] // ALIGN_W + gcnt[-1]) * ALIGN_W)
    # real frames are the stream prefix; padded tail frames may overflow
    if need > stream.shape[0]:
        return None
    with stages.span("pipeline.d2h"):
        sw = stream[:need].cpu().numpy()
    stages.count("pipeline.d2h_bytes", sw.nbytes)
    with stages.span("pipeline.assemble"):
        return assemble_ranges(sw.astype(">i4").tobytes(), woff, fsz), fsz


class DevicePipeline:
    """Static config for one (config, bit_depth) on one device, or sharded
    over a mesh: ``mesh`` if given, else the default rule of
    ``_product_mesh``."""

    def __init__(
        self,
        config: EncoderConfig,
        bit_depth: int,
        device: torch.device = "cuda",
        batch_size: int = DEFAULT_BATCH,
        mesh=None,
    ) -> None:
        self.config = config
        self.bit_depth = bit_depth
        self.device = resolve_device(device)
        self.batch_size = batch_size
        # None: a single device
        self._mesh = mesh if mesh is not None else _product_mesh(self.device)

    @property
    def card_fed(self) -> bool:
        """Whether ``encode_wav_bytes`` hands this pipeline the WAV's own
        bytes (``encode_pcm_stream``): a single CUDA device. A mesh takes
        host chunks, and the CPU device planar samples."""
        return self._mesh is None and self.device.type == "cuda"

    def _bucket(self, nreal: int) -> int:
        """The rows a batch of ``nreal`` frames is padded to: a power of
        two, on a mesh then a multiple of its size."""
        ndev = self._mesh.size if self._mesh is not None else 1
        bucket = min(self.batch_size, _next_pow2(nreal))
        if bucket % ndev:  # shard evenly over the mesh
            bucket += ndev - bucket % ndev
        return bucket

    def _to_device(self, a: np.ndarray, device=None) -> torch.Tensor:
        with stages.span("pipeline.h2d"):
            return to_device(a, self.device if device is None else device)

    def _narrow(self, chunk: np.ndarray) -> np.ndarray:
        if self.bit_depth <= 16:
            chunk = chunk.astype(np.int16)  # halves the h2d volume
        return chunk

    def _feed(self, chunk: np.ndarray, device=None) -> torch.Tensor:
        with stages.span("pipeline.h2d"):
            dev = self.device if device is None else device
            return to_device(self._narrow(chunk), dev).to(torch.int32)

    def _stage_pcm(self, pcm: memoryview) -> torch.Tensor:
        """A batch's packed PCM bytes on the device. On a CUDA device they
        go through pinned memory from torch's caching host allocator,
        which reuses a block only once the copy out of it has run."""
        with stages.span("pipeline.h2d"):
            stages.count("pipeline.h2d_bytes", len(pcm))
            host = torch.empty(len(pcm), dtype=torch.uint8,
                               pin_memory=self.device.type == "cuda")
            host.numpy()[:] = np.frombuffer(pcm, np.uint8)
            return host.to(self.device, non_blocking=True)

    def _frames(self, rec: dict) -> torch.Tensor:
        """A batch's int32 frames on its device: those the PCM unpack made
        at the dispatch (kept for re-encodes), else the host chunk fed
        now. Counts the rows from the unpack as ``pipeline.frames_unpacked``."""
        frames = rec.get("frames")
        stages.count("pipeline.frames_unpacked", 0 if frames is None else frames.shape[0])
        if frames is None:
            frames = self._feed(rec["chunk"], rec.get("device"))  # a shard's device, on a mesh
        return frames

    def _run_compact(self, rec: dict, tier: int):
        frames = self._frames(rec)
        n, c, B = frames.shape
        hstatic, max_words, capb = compact_shape(self.config, self.bit_depth, c, B,
                                                 rec["rate"], tier, n)
        stages.count("pipeline.frames_real", rec["nreal"])
        stages.count("pipeline.frames_encoded", n)
        stream, meta = _encode_batch_compact(
            frames,
            self._to_device(rec["fns"].astype(np.int64), frames.device),
            config=self.config, depth=self.bit_depth, hstatic=hstatic,
            block_size=B, max_words=max_words, capb=capb,
        )
        return stream, meta, max_words * 4

    # -- public API ---------------------------------------------------------

    def encode_frames_stream(
        self,
        frames: np.ndarray,
        first_frame_number: int,
        info: StreamInfo,
        frame_numbers: np.ndarray | None = None,
        tail: np.ndarray | None = None,
    ) -> Tuple[bytes, np.ndarray]:
        """[F, C, B] PCM int32 full frames -> (frame-stream bytes, sizes).

        ``frame_numbers`` overrides the default consecutive numbering.
        ``tail`` is an optional ragged final frame ``[C, rem]`` (rem < B),
        encoded at its exact block size and numbered after the full frames.
        A tail whose partition order the analysis cannot hold is refused
        before any batch runs.
        """
        f = frames.shape[0]
        bs = self.batch_size
        if tail is not None:
            check_partition_order(tail.shape[-1], self.config.max_rice_order)
        if frame_numbers is None:
            frame_numbers = first_frame_number + np.arange(f, dtype=np.int64)
        pending = []
        for start in range(0, f, bs):
            chunk = frames[start : start + bs]
            fns = frame_numbers[start : start + chunk.shape[0]]
            pending.append(self.dispatch_batch(chunk, fns, info))
        if tail is not None:
            pending.append(self.dispatch_tail(tail, first_frame_number + f, info))
        return self._collect_all(pending, info)

    def encode_pcm_stream(self, pcm: memoryview, bytes_per_sample: int,
                          info: StreamInfo) -> Tuple[bytes, np.ndarray]:
        """``encode_frames_stream`` of every frame of a WAV's interleaved
        little-endian PCM bytes ``pcm`` (``info.interchannel_samples``
        sample frames of ``info.channels`` samples, ``bytes_per_sample``
        bytes each): each batch's bytes, and the ragged tail's, cross to
        the device as they are (``dispatch_pcm``). A single device only."""
        n = info.interchannel_samples
        block = self.config.block_size
        n_full, rem = divmod(n, block)
        step = block * info.channels * bytes_per_sample  # bytes a full frame
        if rem >= TAIL_DEVICE_MIN:
            check_partition_order(rem, self.config.max_rice_order)
        pending = []
        for start in range(0, n_full, self.batch_size):
            stop = min(start + self.batch_size, n_full)
            pending.append(self.dispatch_pcm(pcm[start * step : stop * step], bytes_per_sample,
                                             block, np.arange(start, stop, dtype=np.int64),
                                             info))
        if rem >= TAIL_DEVICE_MIN:
            pending.append(self.dispatch_pcm(pcm[n_full * step :], bytes_per_sample, rem,
                                             np.array([n_full], np.int64), info))
        return self._collect_all(pending, info)

    def _collect_all(self, pending: list, info) -> Tuple[bytes, np.ndarray]:
        """Collect every dispatched batch in order and join their bytes and
        sizes."""
        chunks: List[bytes] = []
        sizes: List[np.ndarray] = []
        for p in pending:
            got = self.collect_batch(p, info)
            chunks.append(got[0])
            sizes.append(got[1])
        with stages.span("pipeline.join"):
            return b"".join(chunks), (
                np.concatenate(sizes) if sizes else np.zeros(0, np.int64)
            )

    def dispatch_batch(self, chunk: np.ndarray, fns: np.ndarray, info) -> dict:
        """Dispatch one batch of full frames ``[n<=bs, C, B]`` at tier-0
        capacity. Returns a pending handle for ``collect_batch``. The batch
        is padded to a power of two (on a mesh, then to a multiple of its
        size) by repeating its last frame. Raises ValueError, before any
        device work, for a block whose partition order the analysis cannot
        hold (``check_partition_order``)."""
        with stages.span("pipeline.dispatch_batch"):
            check_partition_order(chunk.shape[-1], self.config.max_rice_order)
            nreal = chunk.shape[0]
            bucket = self._bucket(nreal)
            if nreal < bucket:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], bucket - nreal, 0)])
                fns = np.concatenate([fns, np.repeat(fns[-1:], bucket - nreal)])
            rec = {"chunk": chunk, "nreal": nreal, "fns": fns, "rate": info.sample_rate}
            if self._mesh is None:
                rec["out"] = self._run_compact(rec, 0)
            else:
                from ..parallel.mesh import encode_compact_sharded

                rec["rows"] = encode_compact_sharded(
                    self._narrow(chunk), fns, self.config, self.bit_depth, info.sample_rate,
                    0, self._mesh, nreal=nreal)
            return rec

    def dispatch_pcm(self, pcm: memoryview, bytes_per_sample: int, block: int,
                     fns: np.ndarray, info) -> dict:
        """``dispatch_batch`` of ``len(fns)`` frames of ``block`` samples
        given as interleaved little-endian PCM bytes (``info.channels``
        samples of ``bytes_per_sample`` bytes a sample frame): the bytes
        cross to the device as they are and ``unpack_pcm`` makes the int32
        frames there, padded to the bucket as ``dispatch_batch`` pads. The
        pending handle keeps them for a re-encode. A ragged tail (``block``
        under the configured block size) is timed as
        ``pipeline.dispatch_tail``. A single device only; refused as
        ``dispatch_batch``."""
        tail = block < self.config.block_size
        with stages.span("pipeline.dispatch_tail" if tail else "pipeline.dispatch_batch"):
            check_partition_order(block, self.config.max_rice_order)
            nreal = len(fns)
            bucket = self._bucket(nreal)
            if nreal < bucket:
                fns = np.concatenate([fns, np.repeat(fns[-1:], bucket - nreal)])
            frames = unpack_pcm(self._stage_pcm(pcm), info.channels, bytes_per_sample,
                                self.bit_depth, block, nreal, bucket)
            rec = {"frames": frames, "nreal": nreal, "fns": fns, "rate": info.sample_rate}
            rec["out"] = self._run_compact(rec, 0)
            return rec

    def dispatch_tail(self, tail: np.ndarray, frame_number: int, info) -> dict:
        """Dispatch a ragged final frame ``[C, rem]`` at its exact block
        size, numbered ``frame_number``; refused as ``dispatch_batch``."""
        with stages.span("pipeline.dispatch_tail"):
            check_partition_order(tail.shape[-1], self.config.max_rice_order)
            rec = {"chunk": tail[None, ...], "nreal": 1,
                   "fns": np.array([frame_number], np.int64), "rate": info.sample_rate}
            rec["out"] = self._run_compact(rec, 0)
            return rec

    def collect_batch(self, pending: dict, info) -> Tuple[bytes, np.ndarray]:
        """Fetch one dispatched batch's frame bytes + sizes, re-encoding
        through the capacity ladder on overflow. A sharded batch collects
        each of this process's shards like a single-device batch, and ONLY
        overflowing shards re-encode, each on its own device with its own
        rows; then the processes exchange their parts."""
        with stages.span("pipeline.collect_batch"):
            if "rows" in pending:
                return self._collect_sharded(pending)
            stream, meta, frame_cap = pending["out"]
            got = _collect_aligned(stream, meta, pending["nreal"], frame_cap)
            if got is None:
                got = self._encode_overflow(pending)
            return got

    def _collect_sharded(self, pending: dict) -> Tuple[bytes, np.ndarray]:
        from ..parallel import distributed

        rows, frame_cap = pending["rows"]
        nreal = pending["nreal"]
        per = pending["chunk"].shape[0] // self._mesh.size
        parts: List[bytes] = []
        szs: List[np.ndarray] = []
        for s in sorted(rows):  # padding-only shards have no row
            stream, meta = rows[s]
            local_real = min(per, nreal - s * per)
            got = _collect_aligned(stream, meta[:-1], local_real, frame_cap)
            if got is None:  # this shard's rows only, through the ladder
                lo = s * per
                got = self._encode_overflow({
                    "chunk": pending["chunk"][lo : lo + per], "nreal": local_real,
                    "fns": pending["fns"][lo : lo + per], "rate": pending["rate"],
                    "device": self._mesh.entries[s][1]})
            parts.append(got[0])
            szs.append(got[1])
        payload = b"".join(parts)
        sizes = np.concatenate(szs) if szs else np.zeros(0, np.int64)
        if distributed.process_count() > 1:
            payload, sizes = distributed.allgather_parts(payload, sizes)
        return payload, sizes

    def _encode_overflow(self, rec: dict):
        """Capacity-ladder fallback for batches that out-size tier 0."""
        nreal = rec["nreal"]
        for tier in range(1, len(CAPACITY_LADDER)):
            stream, meta, frame_cap = self._run_compact(rec, tier)
            got = _collect_aligned(stream, meta, nreal, frame_cap)
            if got is not None:
                return got
        # exact worst case: the padded words path
        frames = self._frames(rec)
        n, c, B = frames.shape
        hstatic, max_words, _ = compact_shape(self.config, self.bit_depth, c, B, rec["rate"],
                                              None, n)
        stages.count("pipeline.frames_real", nreal)
        stages.count("pipeline.frames_encoded", n)
        words, total_bits = _encode_batch(
            frames,
            self._to_device(rec["fns"].astype(np.int64), frames.device),
            config=self.config, depth=self.bit_depth, hstatic=hstatic,
            block_size=B, max_words=max_words,
        )
        byte_len = (total_bits + 7) >> 3
        # the host assembles each frame with its CRC
        crcs, _ = crc16_frames(words, byte_len, write=False)
        with stages.span("pipeline.d2h"):
            words = words[:nreal].cpu().numpy().view(np.uint32)
            byte_len = byte_len[:nreal].cpu().numpy()
            crcs = crcs[:nreal].cpu().numpy()
        stages.count("pipeline.d2h_bytes", words.nbytes + byte_len.nbytes + crcs.nbytes)
        if (byte_len > words.shape[1] * 4).any():
            raise RuntimeError("frame exceeded hard packer capacity")
        return assemble_frames(words, byte_len, crcs), byte_len + 2

    def encode_frames(
        self, frames: np.ndarray, first_frame_number: int, info: StreamInfo
    ) -> List[bytes]:
        """[F, C, B] int32 full frames -> list of frame byte strings."""
        stream, sizes = self.encode_frames_stream(frames, first_frame_number, info)
        out: List[bytes] = []
        pos = 0
        for L in sizes.tolist():
            out.append(stream[pos : pos + int(L)])
            pos += int(L)
        return out
