"""Multi-device scaling: frame-axis data parallelism over a list of devices.

Counterpart of ``zigflac_tpu/parallel/mesh.py``. Frames are independent, so
the design keeps cross-shard traffic minimal: packed bytes stay with their
shard (the host assembles per shard, in frame order), and the one
collective is the capacity-overflow any-reduce, so every shard's metadata
row reports whether ANY shard tripped its budget. STREAMINFO's min/max
frame sizes intentionally stay on host: the reference's running-max update
rule (metadata.zig quirk) is order-dependent, so a plain cross-shard
min/max would be wrong.

torch has no global arrays and no ``shard_map``, so three things differ
from the JAX package:

* a ``Mesh`` is the ordered global list of ``(process index, torch
  device)`` entries, process-major; a device may repeat (``[cuda:0,
  cuda:0]`` is a two-shard mesh on one card);
* one shard is one run of the port's unchanged ``_encode_batch_compact``
  on that shard's device, on that shard's rows, and a process runs only
  the shards it owns;
* the any-reduce is a max over the process's shards on one device, then
  one ``all_reduce(MAX)`` across processes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..utils.config import EncoderConfig
from . import distributed

FRAME_AXIS = "frames"


@dataclass(frozen=True)
class Mesh:
    """The frame axis: shard ``s`` holds rows ``[s * per, (s + 1) * per)``
    of an ``N``-frame batch (``per = N // size``) and runs on
    ``entries[s]``'s device in process ``entries[s][0]``."""

    entries: Tuple[Tuple[int, torch.device], ...]

    @property
    def size(self) -> int:
        return len(self.entries)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(d for _, d in self.entries)


def _local_devices():
    """This process's cards: the rank's current card in a group of
    processes, every visible card in a single process. Without a card it
    raises, as ``pipeline.resolve_device("cuda")`` does: a CPU mesh is built
    only from devices the caller lists."""
    if not torch.cuda.is_available():
        raise RuntimeError("default_mesh() takes the visible cards, but "
                           "torch.cuda.is_available() is false: list the devices")
    if distributed.process_count() > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_mesh(devices=None) -> Mesh:
    """1-D frame-axis mesh over every process's devices, process-major, so
    each process owns one CONTIGUOUS frame-row range
    (distributed.local_row_bounds relies on this). ``devices`` lists this
    process's devices, in order (default: the rank's current card in a
    group of processes, every visible card in a single process; without a
    card the default raises). In a group, every process calls this at the same
    point: the lists are exchanged once (``all_gather_object``)."""
    local = [torch.device(d) for d in (devices if devices is not None else _local_devices())]
    if not local:
        raise ValueError("a mesh needs at least one device")
    if distributed.process_count() == 1:
        return Mesh(tuple((0, d) for d in local))
    import torch.distributed as dist

    gathered = [None] * distributed.process_count()
    dist.all_gather_object(gathered, [str(d) for d in local])
    return Mesh(tuple((p, torch.device(d)) for p, ds in enumerate(gathered) for d in ds))


def encode_compact_sharded(
    frames: np.ndarray,
    frame_numbers: np.ndarray,
    config: EncoderConfig,
    depth: int,
    sample_rate: int,
    tier: int,
    mesh: Mesh,
    *,
    nreal: int | None = None,
):
    """Sharded encode of host frames ``[N, C, B]`` (``N`` divisible by the
    mesh size; int16 or int32) and their ``[N]`` frame numbers -> ``(rows,
    frame_cap)``. ``rows`` maps every shard this process owns that holds a
    real frame (the first ``nreal`` rows are real, default all; the rest
    are batch padding) to ``(stream, meta)`` on the shard's device, meta =
    ``[frame_bytes..., total_words, overflow_local, overflow_any]``: the
    single-device pipeline's metadata vector, the shard's own capacity
    overflow over its real rows (the test ``_collect_aligned`` makes), and
    the max of that flag over every shard of the mesh. The host collects
    each row like a single-device batch, and re-encodes only overflowing
    shards through the capacity ladder. ``frame_cap`` is the per-frame
    byte budget of the tier's capacity shape at ``N / size`` frames a
    shard. In a ``torch.distributed`` group every process enters the one
    collective once per call, whatever its own flags say."""
    from ..models.pipeline import _encode_batch_compact, compact_shape, to_device
    from ..ops.bitpack import ALIGN_W
    from ..utils import stages

    n, c, B = frames.shape
    ndev = mesh.size
    if n % ndev != 0:
        raise ValueError(f"frame count {n} not divisible by mesh size {ndev}")
    per = n // ndev
    nreal = n if nreal is None else nreal
    hstatic, max_words, capb = compact_shape(config, depth, c, B, sample_rate, tier, per)
    frame_cap = max_words * 4
    lo, hi = distributed.local_row_bounds(mesh, n)
    rows, flags = {}, {}
    for s in range(lo // per, hi // per):
        local_real = min(per, nreal - s * per)
        if local_real <= 0:
            continue  # batch padding only: nothing to collect
        dev = mesh.entries[s][1]
        with stages.span("pipeline.h2d"):
            rows_in = to_device(frames[s * per : (s + 1) * per], dev).to(torch.int32)
            fns_in = to_device(frame_numbers[s * per : (s + 1) * per].astype(np.int64), dev)
        stages.count("pipeline.frames_real", local_real)
        stages.count("pipeline.frames_encoded", per)
        stream, meta = _encode_batch_compact(
            rows_in, fns_in,
            config=config, depth=depth, hstatic=hstatic, block_size=B,
            max_words=max_words, capb=capb,
        )
        fsz = meta[:local_real]
        groups = (fsz + 4 * ALIGN_W - 1) // (4 * ALIGN_W)
        flags[s] = (fsz.max() > frame_cap) | (groups.sum() * ALIGN_W > stream.shape[0])
        rows[s] = (stream, meta)
    # the any-reduce: over this process's shards on one device, then across
    # the processes of the group, if there is one (on the host under gloo,
    # which waits for the shards)
    group = distributed.is_initialized()
    home = distributed.collective_device() if group else mesh.entries[lo // per][1]
    ovf_any = torch.zeros((), dtype=torch.int64, device=home)
    for f in flags.values():
        ovf_any = torch.maximum(ovf_any, f.to(home, torch.int64))
    if group:
        import torch.distributed as dist

        dist.all_reduce(ovf_any, op=dist.ReduceOp.MAX)
    for s, (stream, meta) in rows.items():
        tail = torch.stack([flags[s].to(torch.int64), ovf_any.to(meta.device)])
        rows[s] = (stream, torch.cat([meta, tail]))
    return rows, frame_cap
