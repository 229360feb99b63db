"""Batch synthesis, the decoder's compute stage: the hand-written CUDA kernel
and its plain version, and the stereo recombination.

Counterpart of ``zigflac_tpu/ops/synth.py``. The host parser
(``parse_frames`` of ``native/zf_native.cpp``) normalizes every subframe
type to one predictor form: ``values`` (warmup samples then residuals, or
literal samples for constant and verbatim), integer ``qcoeffs`` (q[j]
multiplies s[i-1-j]; binomial coefficients for fixed orders, quantized LPC
coefficients otherwise, zeros beyond the order), ``shift``, ``order`` and
``wasted``. Synthesis is the recurrence
s[i] = v[i] + (sum_j q[j] * s[i-1-j] >> shift) in wrapping int64, a true
sequential scan per subframe (the per-step arithmetic shift is nonlinear),
with all M subframes of a batch independent of each other.

``synthesize_batch`` routes by device: a CUDA tensor launches the kernel in
``csrc/synth.cu`` (or raises), a CPU tensor takes ``synthesize_batch_plain``.
Its checks end in a wait for the device (the range of ``shift`` and
``wasted``); the decoder makes that check on the host and calls
``_synthesize_unchecked``, which does not wait.
``KERNEL_LAUNCHES`` and ``PLAIN_CALLS`` count each. The kernel chooses its
arithmetic per block of ``BLOCK_ROWS`` subframes (how many taps it sums,
int32 or 64-bit multiplies); while ``STATS`` is a dict every launch records
what each block chose, and ``variant_counts`` sums that up.
``recombine_stereo`` is elementwise (the inverse of the encoder's stereo
decorrelation) and plain torch on either device.
"""

from __future__ import annotations

from typing import Optional

import torch

TAPS = 32
# Subframes to a block of the kernel (kRows in csrc/synth.cu): one to a lane
# of its computing warp.
BLOCK_ROWS = 32

KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0

# While this is a dict, every kernel launch appends to STATS["variants"] an
# int32 [blocks, 3] tensor on the launch's device, one row per block of
# BLOCK_ROWS subframes: the taps it summed (0-4, 8, 16, 24 or 32), 1 if
# it ended in 64-bit arithmetic, and the 32-position tile at which it left
# the int32 arithmetic (0: it never ran narrow; -1: it never left). None,
# the default, records nothing.
STATS: Optional[dict] = None


def variant_counts(variants) -> dict:
    """Sums up STATS["variants"]: blocks that stayed narrow, that were wide
    from their first tile and that went wide midway, and blocks per tap
    count. Copies the tensors to the host, so it waits for their launches."""
    rows = torch.cat([v.cpu() for v in variants] + [torch.zeros((0, 3), dtype=torch.int32)])
    taps, wide, at = rows[:, 0], rows[:, 1] != 0, rows[:, 2]
    return {
        "blocks": int(rows.shape[0]),
        "narrow": int((~wide).sum()),
        "wide_from_start": int((wide & (at == 0)).sum()),
        "went_wide": int((wide & (at > 0)).sum()),
        "taps": {int(t): int((taps == t).sum()) for t in taps.unique()},
    }


def reset_counts() -> None:
    global KERNEL_LAUNCHES, PLAIN_CALLS
    KERNEL_LAUNCHES = 0
    PLAIN_CALLS = 0


def synthesize_batch_plain(
    values: torch.Tensor, qcoeffs: torch.Tensor, shift: torch.Tensor,
    order: torch.Tensor, wasted: torch.Tensor,
) -> torch.Tensor:
    """The scan as a loop over the B sample positions with the [M, 32]
    history of every subframe as its state, newest sample first."""
    m, b = values.shape
    state = torch.zeros((m, TAPS), dtype=torch.int64, device=values.device)
    outs = torch.empty_like(values)
    for i in range(b):
        v = values[:, i]
        pred = (state * qcoeffs).sum(dim=-1) >> shift
        out = torch.where(i < order, v, v + pred)
        state = torch.cat([out[:, None], state[:, :-1]], dim=1)
        outs[:, i] = out
    return outs << wasted[:, None]


def _check(values, qcoeffs, shift, order, wasted) -> None:
    if values.dim() != 2:
        raise ValueError(f"values must be [M, B], got {tuple(values.shape)}")
    m = values.shape[0]
    if tuple(qcoeffs.shape) != (m, TAPS):
        raise ValueError(f"qcoeffs must be [{m}, {TAPS}], got {tuple(qcoeffs.shape)}")
    for name, t in (("values", values), ("qcoeffs", qcoeffs)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
    for name, t in (("qcoeffs", qcoeffs), ("shift", shift), ("order", order),
                    ("wasted", wasted)):
        if t.device != values.device:
            raise ValueError(f"{name} is on {t.device}, values on {values.device}")
    for name, t in (("shift", shift), ("order", order), ("wasted", wasted)):
        if tuple(t.shape) != (m,):
            raise ValueError(f"{name} must be [{m}], got {tuple(t.shape)}")
        if t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool:
            raise TypeError(f"{name} must be an integer tensor, got {t.dtype}")
    # a shift by the full width is undefined in C++ and in torch alike
    if m and bool(((shift < 0) | (shift > 63) | (wasted < 0) | (wasted > 63)).any()):
        raise ValueError("shift and wasted must lie in 0..63")


def synthesize_batch(
    values: torch.Tensor, qcoeffs: torch.Tensor, shift: torch.Tensor,
    order: torch.Tensor, wasted: torch.Tensor,
) -> torch.Tensor:
    """[M, B] normalized subframes -> [M, B] int64 decoded wire samples, on
    the tensors' device: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. ``shift``, ``order`` and ``wasted`` are [M] integer
    vectors of any width."""
    _check(values, qcoeffs, shift, order, wasted)
    return _synthesize_unchecked(values, qcoeffs, shift, order, wasted)


def _synthesize_unchecked(
    values: torch.Tensor, qcoeffs: torch.Tensor, shift: torch.Tensor,
    order: torch.Tensor, wasted: torch.Tensor,
) -> torch.Tensor:
    """``synthesize_batch`` without its checks, for a caller that has made
    them itself: the decoder checks ``shift`` and ``wasted`` on the host
    before their copy to the device, so its calls never wait for the
    device."""
    global KERNEL_LAUNCHES, PLAIN_CALLS
    shift, order, wasted = (t.to(torch.int64).contiguous() for t in (shift, order, wasted))
    if values.device.type == "cpu":
        PLAIN_CALLS += 1
        return synthesize_batch_plain(values, qcoeffs, shift, order, wasted)
    if values.device.type != "cuda":
        raise NotImplementedError(f"no synthesis kernel for device {values.device}")
    if not (values.is_contiguous() and qcoeffs.is_contiguous()):
        raise ValueError("values and qcoeffs must be contiguous")
    from ._build import library

    lib = library()
    m, b = values.shape
    out = torch.empty_like(values)
    if m == 0 or b == 0:
        return out
    report = None
    if STATS is not None:
        report = torch.empty((-(-m // BLOCK_ROWS), 3), dtype=torch.int32,
                             device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.zf_synthesize(
            values.data_ptr(), qcoeffs.data_ptr(), shift.data_ptr(), order.data_ptr(),
            wasted.data_ptr(), m, b, out.data_ptr(),
            None if report is None else report.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(
            f"synthesis kernel launch failed: {lib.zf_error_string(err).decode()}"
        )
    KERNEL_LAUNCHES += 1
    if report is not None:
        STATS.setdefault("variants", []).append(report)
    return out


def recombine_stereo(wire: torch.Tensor, ch_code: torch.Tensor) -> torch.Tensor:
    """Invert stereo decorrelation for a [F, 2, B] int64 wire-sample batch;
    ``ch_code`` is the [F] frame channel code."""
    a, b = wire[:, 0], wire[:, 1]
    cc = ch_code.to(torch.int64)[:, None]
    # 8 left-side: (left, side) -> (left, left - side)
    # 9 side-right: (side, right) -> (side + right, right)
    # 10 mid-side: (mid, side); left = mid + ((side + (side & 1)) >> 1)
    left = torch.where(
        cc == 8, a,
        torch.where(cc == 9, a + b, torch.where(cc == 10, a + ((b + (b & 1)) >> 1), a)),
    )
    right = torch.where(
        cc == 8, a - b,
        torch.where(cc == 9, b, torch.where(cc == 10, left - b, b)),
    )
    return torch.stack([left, right], dim=1)
