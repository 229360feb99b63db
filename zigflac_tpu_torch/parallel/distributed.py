"""Multi-process scaling over ``torch.distributed``.

Counterpart of ``zigflac_tpu/parallel/distributed.py``, with the same
function names. After ``initialize()`` (an idempotent wrapper over
``torch.distributed.init_process_group``) every process builds the same
process-major mesh (``parallel.mesh.default_mesh``) and encodes its own
contiguous range of each batch's frame rows:

* inputs: every process reads the whole input and slices its own rows on
  the host (``local_row_bounds``), so PCM never crosses the network. The
  JAX package's ``make_global_batch`` has no counterpart: torch has no
  global arrays, and a rank hands its rows straight to its own device;
* compute: unchanged (``mesh.encode_compact_sharded``); the one
  cross-shard collective, the capacity-overflow any-reduce, is one
  ``all_reduce(MAX)`` across processes;
* outputs: each process byte-collects its own shards' rows and the
  per-process FLAC byte strings are exchanged once (``allgather_parts``),
  so every process assembles the identical file.

The backend is NCCL for ranks on CUDA cards and gloo on the CPU. NCCL needs
one card per rank (it refuses two ranks on one card as a duplicate GPU);
ranks that share a card pass ``backend="gloo"``, whose collectives run on
the host.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    backend: str | None = None,
) -> bool:
    """Idempotent ``torch.distributed.init_process_group`` wrapper.

    Arguments default to torchrun's variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``coordinator_address`` is ``host:port`` or a
    ``tcp://`` URL), ``WORLD_SIZE``, ``RANK``, and ``LOCAL_RANK`` for the
    card a rank uses (``local_device_ids``: its first entry; otherwise the
    rank modulo the visible cards). With no process count, or one, the
    call is a single-process no-op. ``backend`` defaults to ``"nccl"``
    where CUDA is available, the rank's card then made the current device,
    and to ``"gloo"`` otherwise; a backend that fails to start raises.
    Returns True when the process joined a multi-process group, False when
    the call was a no-op."""
    import torch.distributed as dist

    if is_initialized():
        return process_count() > 1
    env = os.environ
    if num_processes is None and env.get("WORLD_SIZE") is not None:
        num_processes = int(env["WORLD_SIZE"])
    if num_processes is None or num_processes <= 1:
        return False
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        if local_device_ids:
            index = int(list(local_device_ids)[0])
        else:
            index = int(env.get("LOCAL_RANK", process_id)) % torch.cuda.device_count()
        torch.cuda.set_device(index)
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return process_count() > 1


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if is_initialized() else 0


def collective_device() -> torch.device:
    """Where this process's collective tensors live: its current card under
    NCCL, the host under gloo."""
    import torch.distributed as dist

    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_row_bounds(mesh, n_rows: int) -> Tuple[int, int]:
    """[start, stop) of the global frame rows this process feeds/owns for
    an ``n_rows``-frame batch over ``mesh``. Requires the mesh's frame
    axis to be process-major (``default_mesh`` orders entries that way) so
    every process owns one contiguous row range."""
    ndev = mesh.size
    if n_rows % ndev:
        raise ValueError(f"{n_rows} rows not divisible by mesh size {ndev}")
    per = n_rows // ndev
    me = process_index()
    mine = [i for i, (p, _) in enumerate(mesh.entries) if p == me]
    if not mine:
        raise ValueError("mesh has no devices for this process")
    if mine[-1] - mine[0] + 1 != len(mine):
        raise ValueError(
            "mesh frame axis is not process-major; build it with "
            "parallel.mesh.default_mesh"
        )
    return mine[0] * per, (mine[-1] + 1) * per


def _all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    import torch.distributed as dist

    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return [o.cpu() for o in out]


def allgather_parts(payload: bytes, sizes: np.ndarray) -> Tuple[bytes, np.ndarray]:
    """Exchange per-process (frame bytes, frame sizes) so every process
    holds the full stream, in process (= global frame) order. Payload
    lengths differ per process, so lengths gather first and the byte/size
    payloads pad to the max: one round for the lengths, one for the data.
    A process with no frames contributes an empty part. Without a group it
    is the identity."""
    sizes = np.asarray(sizes, np.int64)
    if not is_initialized():
        return payload, sizes
    dev = collective_device()
    lens = torch.stack(_all_gather(
        torch.tensor([len(payload), sizes.size], dtype=torch.int64, device=dev))).numpy()
    maxb, maxs = int(lens[:, 0].max()), int(lens[:, 1].max())
    buf = np.zeros(max(maxb, 1), np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    szp = np.zeros(max(maxs, 1), np.int64)
    szp[: sizes.size] = sizes
    allb = _all_gather(torch.from_numpy(buf).to(dev))
    allsz = _all_gather(torch.from_numpy(szp).to(dev))
    parts: List[bytes] = []
    sz_parts: List[np.ndarray] = []
    for p in range(lens.shape[0]):
        parts.append(allb[p][: lens[p, 0]].numpy().tobytes())
        sz_parts.append(allsz[p][: lens[p, 1]].numpy())
    return b"".join(parts), np.concatenate(sz_parts)
