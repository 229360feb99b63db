"""The frame symbols stage: every frame's header, subframe fields and codes,
and the prefix sum of their widths, as the deposit's inputs.

Counterpart of ``zigflac_tpu/ops/bitpack.py`` ``frame_symbol_stream`` with
``zigflac_tpu/ops/header.py`` ``build_headers``. ``frame_symbols`` routes by
device: a CUDA plan launches the hand-written kernel ``zf_frame_symbols``
(``csrc/symbols.cu``, one CTA a frame, a column a lane) or raises, a CPU
plan takes the plain version ``bitpack.frame_symbol_stream``. Both give the deposit's arrays
(``ops/deposit.py``): ``dep_cum`` int32 [N, S] (each field's end bit, the low
32 bits of the 64-bit sum), ``total_bits`` int64 [N], ``val`` int64 [N, S]
and ``nbv`` int32 [N, S], with the column layout ``symbol_columns`` counts.
``KERNEL_LAUNCHES`` and ``PLAIN_CALLS`` count each route.

The kernel path never waits for the card: it reads shapes, not values.
"""

from __future__ import annotations

import torch

from . import bitpack
from .analyze import FrameWirePlan, PARAM_COLS, check_partition_order
from .header import MAX_HEADER_BYTES, HeaderStatic
from ..utils.config import MAX_FIXED_ORDER

KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0

# FLAC's channel limit, the kernel's (kZfSymMaxChannels in csrc/symbols_steps.cuh)
MAX_WIRE_CHANNELS = 8
# the plan's [W, N] fields, in the kernel's argument order
_FIELDS = ("kind", "order", "method", "part_order", "sample_size", "qshift", "wasted")


def reset_counts() -> None:
    global KERNEL_LAUNCHES, PLAIN_CALLS
    KERNEL_LAUNCHES = 0
    PLAIN_CALLS = 0


def symbol_columns(n_wire: int, block_size: int, max_rice_order: int, lpc_order: int) -> int:
    """S, the columns of one frame's stream: 16 header columns, then per wire
    channel the subframe header, wasted bits, min(B, max(4, lpc_order))
    warmup columns, 1 + lpc_order LPC columns where LPC is on, the method,
    and 2^po_top groups of one param and B >> po_top residual columns."""
    po_top = min(max_rice_order, (block_size & -block_size).bit_length() - 1)
    mw = min(block_size, max(MAX_FIXED_ORDER, lpc_order))
    lpc = 1 + lpc_order if lpc_order else 0
    chan = 3 + mw + lpc + (1 << po_top) * ((block_size >> po_top) + 1)
    return MAX_HEADER_BYTES + n_wire * chan


def _check(plan: FrameWirePlan, frame_numbers: torch.Tensor, hstatic: HeaderStatic,
           block_size: int) -> None:
    dev = plan.kind.device
    w, n = plan.kind.shape
    if w > MAX_WIRE_CHANNELS:
        raise ValueError(f"at most {MAX_WIRE_CHANNELS} wire channels, got {w}")
    want = {name: (w, n) for name in _FIELDS}
    want.update(params=(w, n, PARAM_COLS), qcoeffs=(w, n, 32), planes=(w, n, block_size),
                residuals=(w, n, block_size), channels_code=(n,))
    for name, shape in want.items():
        t = getattr(plan, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"plan.{name} must be {list(shape)}, got {list(t.shape)}")
        if t.device != dev:
            raise ValueError(f"plan.{name} is on {t.device}, plan.kind on {dev}")
        dt = (torch.int32, torch.int64) if name == "planes" else (
            (torch.int32,) if name == "residuals" else (torch.int64,))
        if t.dtype not in dt:
            raise TypeError(f"plan.{name} must be {' or '.join(map(str, dt))}, got {t.dtype}")
    if tuple(frame_numbers.shape) != (n,):
        raise ValueError(f"frame_numbers must be [{n}], got {list(frame_numbers.shape)}")
    if frame_numbers.device != dev:
        raise ValueError(f"frame_numbers is on {frame_numbers.device}, the plan on {dev}")
    if len(hstatic.tail_bytes) > 4:
        raise ValueError(f"at most 4 header tail bytes, got {len(hstatic.tail_bytes)}")


def frame_symbols(
    plan: FrameWirePlan,
    frame_numbers: torch.Tensor,
    hstatic: HeaderStatic,
    block_size: int,
    max_rice_order: int,
    lpc_order: int,
    lpc_precision: int,
):
    """(dep_cum int32 [N, S], total_bits int64 [N], val int64 [N, S], nbv
    int32 [N, S]) of a batch's plan: the kernel on a CUDA plan, the plain
    version on a CPU plan. ``lpc_order`` is ``analyze.lpc_order_of(config)``."""
    global KERNEL_LAUNCHES, PLAIN_CALLS
    _check(plan, frame_numbers, hstatic, block_size)
    check_partition_order(block_size, max_rice_order)
    dev = plan.kind.device
    if dev.type == "cpu":
        PLAIN_CALLS += 1
        dep_cum, total_bits, val, nbv = bitpack.frame_symbol_stream(
            plan, frame_numbers, hstatic, block_size, max_rice_order, lpc_order, lpc_precision)
        return dep_cum.to(torch.int32), total_bits, val, nbv.to(torch.int32)
    if dev.type != "cuda":
        raise NotImplementedError(f"no symbols kernel for device {dev}")
    from ._build import library

    lib = library()
    with torch.cuda.device(dev):
        err, out = launch(lib.zf_frame_symbols, plan, frame_numbers, hstatic, block_size,
                          max_rice_order, lpc_order, lpc_precision,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"symbols kernel launch failed: {lib.zf_error_string(err).decode()}")
    KERNEL_LAUNCHES += 1
    return out


def launch(entry, plan: FrameWirePlan, frame_numbers: torch.Tensor, hstatic: HeaderStatic,
           block_size: int, max_rice_order: int, lpc_order: int, lpc_precision: int, stream):
    """Allocates the outputs on the plan's device and calls ``entry``, the C
    entry point ``zf_frame_symbols`` (or a host build of it, in the tests),
    with the plan's tensors as they come: the [W, N] fields, params and
    qcoeffs contiguous (``.contiguous()`` copies nothing where they are), the
    planes and residuals through their strides. Returns (entry's error code,
    (dep_cum, total_bits, val, nbv))."""
    dev = plan.kind.device
    w, n = plan.kind.shape
    s = symbol_columns(w, block_size, max_rice_order, lpc_order)
    dep_cum = torch.empty((n, s), dtype=torch.int32, device=dev)
    val = torch.empty((n, s), dtype=torch.int64, device=dev)
    nbv = torch.empty((n, s), dtype=torch.int32, device=dev)
    total_bits = torch.empty(n, dtype=torch.int64, device=dev)
    fields = [getattr(plan, name).contiguous() for name in _FIELDS]
    params, qcoeffs = plan.params.contiguous(), plan.qcoeffs.contiguous()
    fns, codes = frame_numbers.to(torch.int64).contiguous(), plan.channels_code.contiguous()
    tail = 0
    for i, b in enumerate(hstatic.tail_bytes):
        tail |= (b & 0xFF) << (8 * i)
    err = entry(
        fns.data_ptr(), codes.data_ptr(), *(f.data_ptr() for f in fields), params.data_ptr(),
        qcoeffs.data_ptr(), plan.planes.data_ptr(), plan.planes.dtype == torch.int64,
        *plan.planes.stride(), plan.residuals.data_ptr(), *plan.residuals.stride(), n, w,
        block_size, max_rice_order, lpc_order, lpc_precision, hstatic.byte2,
        hstatic.depth_code, tail, len(hstatic.tail_bytes), dep_cum.data_ptr(), val.data_ptr(),
        nbv.data_ptr(), total_bits.data_ptr(), stream)
    return err, (dep_cum, total_bits, val, nbv)
