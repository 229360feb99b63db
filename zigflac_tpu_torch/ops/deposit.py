"""The frame bit deposit: the hand-written CUDA kernel and its plain version.

Counterpart of ``zigflac_tpu/ops/pallas_deposit.py``. Input is the
unmerged symbol stream of a batch of frames: ``d_cum`` (int32 [N, S], each
field's end bit), ``val`` (int64 [N, S], the field's value in its low
``nbv`` bits) and ``nbv`` (int32 [N, S], 0..64). Output is int32
[N, max_words] holding each frame's MSB-first u32 words; deposits past
``max_words`` are dropped.

``deposit_words`` routes by device: a CUDA tensor launches the kernel in
``csrc/deposit.cu`` (or raises), a CPU tensor takes ``deposit_words_plain``.
``KERNEL_LAUNCHES`` and ``PLAIN_CALLS`` count each; ``GLOBAL_ROW_LAUNCHES``
counts the launches whose rows are over the kernel's shared-memory row
(``shared_row_bytes()``) and so take its global-memory branch.
"""

from __future__ import annotations

import torch

KERNEL_LAUNCHES = 0
GLOBAL_ROW_LAUNCHES = 0
PLAIN_CALLS = 0


def reset_counts() -> None:
    global KERNEL_LAUNCHES, GLOBAL_ROW_LAUNCHES, PLAIN_CALLS
    KERNEL_LAUNCHES = 0
    GLOBAL_ROW_LAUNCHES = 0
    PLAIN_CALLS = 0


def deposit_words_plain(
    d_cum: torch.Tensor, val: torch.Tensor, nbv: torch.Tensor, max_words: int
) -> torch.Tensor:
    """The deposit as a scatter-add over int64 (fields are disjoint, so add
    equals or), then the low 32 bits of each word."""
    n = d_cum.shape[0]
    d_end = d_cum.to(torch.int64)
    nb = nbv.to(torch.int64)
    d_start = d_end - nb
    live = (nb > 0) & (nb <= 64) & (d_start >= 0)
    w0 = d_start >> 5
    acc = torch.zeros((n, max_words + 1), dtype=torch.int64, device=d_cum.device)
    for k in range(3):
        j = w0 + k
        lo = torch.maximum(d_start, 32 * j)
        hi = torch.minimum(d_end, 32 * j + 32)
        width = (hi - lo).clamp(0, 32)
        # bits [d_end - hi, d_end - lo) of the value land at word bits
        # [32j + 32 - hi, ...); an arithmetic shift is exact under the mask
        part = (val >> (d_end - hi).clamp(0, 63)) & ((1 << width) - 1)
        part = part << (32 * j + 32 - hi).clamp(0, 31)
        ok = live & (width > 0) & (j < max_words)
        acc.scatter_add_(1, torch.where(ok, j, max_words), torch.where(ok, part, 0))
    w = acc[:, :max_words]
    return (w - ((w >> 31) & 1) * (1 << 32)).to(torch.int32)


def _check(d_cum, val, nbv, max_words) -> None:
    if d_cum.dim() != 2 or d_cum.shape != val.shape or d_cum.shape != nbv.shape:
        raise ValueError(
            f"d_cum, val, nbv must share one [N, S] shape, got "
            f"{tuple(d_cum.shape)}, {tuple(val.shape)}, {tuple(nbv.shape)}"
        )
    for name, t, dt in (("d_cum", d_cum, torch.int32), ("val", val, torch.int64),
                        ("nbv", nbv, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != d_cum.device:
            raise ValueError(f"{name} is on {t.device}, d_cum on {d_cum.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max_words < 1:
        raise ValueError(f"max_words must be positive, got {max_words}")


def deposit_words(
    d_cum: torch.Tensor, val: torch.Tensor, nbv: torch.Tensor, max_words: int
) -> torch.Tensor:
    """Deposit on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    global KERNEL_LAUNCHES, GLOBAL_ROW_LAUNCHES, PLAIN_CALLS
    _check(d_cum, val, nbv, max_words)
    if d_cum.device.type == "cpu":
        PLAIN_CALLS += 1
        return deposit_words_plain(d_cum, val, nbv, max_words)
    if d_cum.device.type != "cuda":
        raise NotImplementedError(f"no deposit kernel for device {d_cum.device}")
    from ._build import library

    lib = library()
    n, s = d_cum.shape
    out = torch.zeros((n, max_words), dtype=torch.int32, device=d_cum.device)
    with torch.cuda.device(d_cum.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.zf_deposit_words(
            d_cum.data_ptr(), val.data_ptr(), nbv.data_ptr(), n, s, max_words,
            out.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(
            f"deposit kernel launch failed: {lib.zf_error_string(err).decode()}"
        )
    KERNEL_LAUNCHES += 1
    GLOBAL_ROW_LAUNCHES += max_words * 4 > lib.zf_shared_row_bytes()
    return out


def shared_row_bytes() -> int:
    """The largest row, in bytes, that the kernel builds in shared memory
    (``kSharedRowBytes``, read from the built library); larger rows take
    its global-memory branch."""
    from ._build import library

    return library().zf_shared_row_bytes()
