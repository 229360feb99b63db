"""Batched frame analysis on torch tensors: the encoder's decisions.

Counterpart of ``zigflac_tpu/ops/analyze.py``. Every per-frame hot loop
of the reference runs as integer tensor ops over a batch of planes:

* fixed-predictor order search: five difference abs-sums and a first-min
  argmin (libFLAC/fixed.zig:88-168);
* the residual of the chosen order, warmup slots zeroed
  (libFLAC/fixed.zig:27-74);
* the Rice estimate: zigzag partition-sum pyramid, then the flake cost
  sweep under wrapping-u64 rules, smallest-param and largest-partition-order
  tie-breaks (libFLAC/rice.zig:237-375);
* Constant/Verbatim/Fixed selection with strict ``<`` and the stereo-mode
  first-min (libFLAC/Encoder.zig:248-376);
* the LPC candidate (``ops/lpc.py``, an extension: the reference stubs it),
  which competes with the best fixed order on estimated bits plus its
  coefficient overhead; where the configuration lists other apodization
  windows than the one Tukey(0.5), the cheapest window's candidate
  (``lpc_window_search``).

Depth 32 runs wide: the 33-bit side plane is int64 and analyzed with
``bits_of_t = 64``, as the reference's i64 side samples are.

The order search, the residual and the Rice sweep of every plane are one
hand-written CUDA kernel on the card (``csrc/analyze.cu``): ``analyze_fixed``
and ``rice_estimate_planes`` route by device, a CUDA tensor to the kernel
(or a raise), a CPU tensor to the plain versions ``best_fixed_order``,
``residuals_for_order`` and ``rice_estimate``. ``KERNEL_LAUNCHES`` counts
``zf_analyze_fixed`` launches, ``RICE_KERNEL_LAUNCHES`` ``zf_rice_estimate``
launches and ``PLAIN_CALLS`` the plain routes of both wrappers. The LPC
candidate's lag sums, every window's in one launch, are
``lpc.lag_sums_planes`` (``csrc/lags.cu`` on the card).

Integer policy: every unsigned quantity travels as int64 (torch has no
uint32/uint64 arithmetic on the CPU). Sums of zigzags stay below 2^48, so
the only place the u64 wrap matters is the Rice cost of a partition whose
sum is below half its size; ``rice_estimate`` reproduces that case exactly.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from ..utils import stages
from ..utils.apodization import TUKEY_HALF, windows_of
from ..utils.config import EncoderConfig, MAX_FIXED_ORDER, MAX_RICE_PARAM_4BIT
from . import lpc

# stands in for u64::MAX: a disqualified candidate's cost
I64_MAX = torch.iinfo(torch.int64).max
# params columns of a plane (the partitions of order 8)
PARAM_COLS = 256
# the largest partition order the params hold
MAX_PART_ORDER = 8

KERNEL_LAUNCHES = 0
RICE_KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0


def reset_counts() -> None:
    global KERNEL_LAUNCHES, RICE_KERNEL_LAUNCHES, PLAIN_CALLS
    KERNEL_LAUNCHES = 0
    RICE_KERNEL_LAUNCHES = 0
    PLAIN_CALLS = 0

# res_k[i] = sum_m BINOM[k][m] * s[i-m] (libFLAC/fixed.zig:9-15)
BINOM = (
    (1, 0, 0, 0, 0),
    (1, -1, 0, 0, 0),
    (1, -2, 1, 0, 0),
    (1, -3, 3, -1, 0),
    (1, -4, 6, -4, 1),
)


class PlaneAnalysis(NamedTuple):
    """Per-plane decisions; leading dims match the input's batch dims."""

    kind: torch.Tensor        # i64: 0 constant, 1 verbatim, 2 fixed, 3 lpc
    est_bits: torch.Tensor    # i64: header-less size estimate
    order: torch.Tensor       # i64: predictor order (fixed 0..4, lpc 1..32)
    method: torch.Tensor      # i64: 0 = 4-bit rice params, 1 = 5-bit
    part_order: torch.Tensor  # i64: rice partition order 0..8
    params: torch.Tensor      # i64 [..., 256]: rice param per partition
    residuals: torch.Tensor   # i32 [..., B]: the LPC candidate's where
                              # kind == 3, else the fixed order's; first
                              # ``order`` slots are 0
    qcoeffs: torch.Tensor     # i64 [..., 32]: quantized LPC coefficients
    qshift: torch.Tensor      # i64: LPC coefficient shift
    wasted: torch.Tensor      # i64: shaved trailing zero bits (extension)


class FrameWirePlan(NamedTuple):
    """Everything the packer needs, per frame, in wire-channel order.

    Arrays are wire-major ``[W, N, ...]`` (``channels_code`` alone is
    ``[N]``), as in the JAX package, so the tests compare like with like.
    """

    channels_code: torch.Tensor  # i64 [N]
    kind: torch.Tensor           # i64 [W, N]
    order: torch.Tensor
    method: torch.Tensor
    part_order: torch.Tensor
    sample_size: torch.Tensor    # i64 [W, N]: depth (+1 for side) - wasted
    params: torch.Tensor         # i64 [W, N, 256]
    planes: torch.Tensor         # i32 [W, N, B] (i64 at depth 32 stereo),
                                 # wasted bits shaved
    residuals: torch.Tensor      # i32 [W, N, B]
    qcoeffs: torch.Tensor        # i64 [W, N, 32]
    qshift: torch.Tensor         # i64 [W, N]
    wasted: torch.Tensor         # i64 [W, N]


def _ilog2(v: int) -> int:
    return v.bit_length() - 1


def _ctz(v: int) -> int:
    return (v & -v).bit_length() - 1


def check_partition_order(block_size: int, max_rice_order: int) -> None:
    """Refuse a block whose top partition order, min(max_rice_order,
    ctz(block_size)), exceeds MAX_PART_ORDER: its params do not fit the 256
    columns. The JAX package raises ValueError on the same condition (its
    params pad goes negative), so the port raises it too, before any work."""
    po_top = min(max_rice_order, _ctz(block_size))
    if po_top > MAX_PART_ORDER:
        raise ValueError(
            f"partition order {po_top} (max_rice_order {max_rice_order}, block size "
            f"{block_size}) exceeds {MAX_PART_ORDER}: the params hold {PARAM_COLS} partitions")


def bit_length(x: torch.Tensor, bits: int = 32) -> torch.Tensor:
    """Exact bit length of non-negative ``x < 2**bits`` (``bits`` <= 63) by
    a compare ladder (torch has no clz; a float log2 would round)."""
    n = torch.zeros_like(x)
    for k in range(bits):
        n += (x >= (1 << k)).to(x.dtype)
    return n


def argmin_first(stack: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along dim 0 (strict ``<``)."""
    best, idx = stack[0], torch.zeros_like(stack[0])
    for k in range(1, stack.shape[0]):
        smaller = stack[k] < best
        idx = torch.where(smaller, k, idx)
        best = torch.where(smaller, stack[k], best)
    return idx


def argmin_last(stack: torch.Tensor) -> torch.Tensor:
    """Index of the last minimum along dim 0 (``<=``)."""
    best, idx = stack[0], torch.zeros_like(stack[0])
    for k in range(1, stack.shape[0]):
        le = stack[k] <= best
        idx = torch.where(le, k, idx)
        best = torch.where(le, stack[k], best)
    return idx


def tree_or(x: torch.Tensor) -> torch.Tensor:
    """OR-reduce the last axis (torch has no OR reduction)."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.nn.functional.pad(x, (0, 1))
        half = x.shape[-1] // 2
        x = x[..., :half] | x[..., half:]
    return x[..., 0]


def zigzag_u32(res: torch.Tensor) -> torch.Tensor:
    """u32 zigzag of i32 residuals with the i32 wrapping shift
    (libFLAC/rice.zig:268-271), as int64 in [0, 2^32)."""
    r = res.to(torch.int64)
    return ((r << 1) ^ (r >> 31)) & 0xFFFFFFFF


def best_fixed_order(planes: torch.Tensor, wide: bool):
    """(order, ok) per plane: first-min argmin of sum |k-th difference|;
    wide mode disqualifies an order whose differences leave i32 and
    reports whether the winner is usable (libFLAC/fixed.zig:88-168)."""
    x = planes.to(torch.int64)
    B = x.shape[-1]
    totals = []
    for k in range(MAX_FIXED_ORDER + 1):
        dk = None
        for m in range(k + 1):
            c = BINOM[k][m]
            term = c * x[..., k - m : B - m]
            dk = term if dk is None else dk + term
        a = dk.abs()
        total = a.sum(dim=-1)
        if wide:
            total = torch.where(a.amax(dim=-1) > (1 << 31) - 1, I64_MAX, total)
        totals.append(total)
    tstack = torch.stack(totals)
    order = argmin_first(tstack)
    if wide:
        ok = tstack.gather(0, order[None]).squeeze(0) != I64_MAX
    else:
        ok = torch.ones_like(order, dtype=torch.bool)
    return order, ok


def residuals_for_order(planes: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Residuals of each plane's chosen order as i32 (wrapping, as the
    reference's i32 arithmetic), the first ``order`` slots zeroed. Planes
    may be int32 or int64 (the 33-bit side plane)."""
    B = planes.shape[-1]
    p = planes.to(torch.int64)
    coeffs = torch.tensor(BINOM, dtype=torch.int64, device=planes.device)[order]
    acc = torch.zeros_like(p)
    for m in range(MAX_FIXED_ORDER + 1):
        shifted = torch.nn.functional.pad(p, (m, 0))[..., :B] if m else p
        acc += coeffs[..., m : m + 1] * shifted
    idx = torch.arange(B, device=planes.device)
    acc = torch.where(idx < order[..., None], 0, acc)
    return acc.to(torch.int32)


def rice_sums_pyramid(zz: torch.Tensor, po_top: int) -> List[torch.Tensor]:
    """sums[po][..., p]: zigzag sum of partition p at order po. The warmup
    slots are already zero, which equals the reference's explicit warmup
    subtraction (libFLAC/rice.zig:295-297)."""
    B = zz.shape[-1]
    sums = [None] * (po_top + 1)
    sums[po_top] = zz.reshape(*zz.shape[:-1], 1 << po_top, B >> po_top).sum(-1)
    for po in range(po_top - 1, -1, -1):
        prev = sums[po + 1]
        sums[po] = prev[..., 0::2] + prev[..., 1::2]
    return sums


def rice_estimate(
    residuals: torch.Tensor,
    order: torch.Tensor,
    block_size: int,
    max_rice_order: int,
    max_param: int,
):
    """(bits, method, part_order, params [..., 256]) per plane, with every
    reference tie-break (libFLAC/rice.zig:237-375).

    Per partition the cost of param k is ``psz*(k+1) + ((s -% psz/2) >> k)``
    in wrapping u64. Where ``s >= psz/2`` nothing wraps and int64 is exact.
    Where ``0 < s < psz/2`` the subtraction wraps to near 2^64, every
    k >= 1 costs at least 2^33, so k = 0 wins with the wrapped cost
    ``psz - psz/2 + s``; that case is set after the sweep. All-zero
    partitions cost 5 with the escape param, the escape param otherwise
    costs ``psz*param``, and partition-order ties keep the larger order.
    """
    B = block_size
    check_partition_order(B, max_rice_order)
    po_top = min(max_rice_order, _ctz(B))
    dev = residuals.device
    sums = rice_sums_pyramid(zigzag_u32(residuals), po_top)
    s = torch.cat(sums, dim=-1)  # [..., 511] level 0 first

    col_po = torch.cat(
        [torch.full((1 << po,), po, dtype=torch.int64) for po in range(po_top + 1)]
    ).to(dev)
    col_first = torch.cat(
        [torch.arange(1 << po) == 0 for po in range(po_top + 1)]
    ).to(dev)
    psz = torch.where(col_first, (B >> col_po) - order[..., None], B >> col_po)

    half = psz // 2  # psz < 0 only on all-zero partitions, fixed below
    lhs = (s - half).clamp(min=0)
    best_bc = psz + lhs
    best_k = torch.zeros_like(s)
    for k in range(1, max_param + 2):
        bc = psz * (k + 1) + (lhs >> k)
        smaller = bc < best_bc
        best_k = torch.where(smaller, k, best_k)
        best_bc = torch.where(smaller, bc, best_bc)
    best_bc = torch.where(best_k == max_param + 1, psz * (max_param + 1), best_bc)
    under = (s < half) & (s != 0)
    best_k = torch.where(under, 0, best_k)
    best_bc = torch.where(under, psz - half + s, best_bc)
    zero = s == 0
    best_k = torch.where(zero, max_param + 1, best_k)
    best_bc = torch.where(zero, 5, best_bc)

    L = _ilog2(B)
    limit_by_order = torch.tensor(
        [15] + [L - _ilog2(k) for k in range(1, lpc.MAX_LPC_ORDER + 1)],
        dtype=torch.int64, device=dev,
    )
    dyn_max_po = limit_by_order[order].clamp(max=po_top)

    totals, methods, params = [], [], []
    start = 0
    for po in range(po_top + 1):
        nparts = 1 << po
        k_lvl = best_k[..., start : start + nparts]
        if max_param > MAX_RICE_PARAM_4BIT:
            method = (k_lvl > MAX_RICE_PARAM_4BIT).any(dim=-1).to(torch.int64)
        else:
            method = torch.zeros_like(order)
        total = best_bc[..., start : start + nparts].sum(-1) + (method + 4) * nparts
        totals.append(torch.where(dyn_max_po >= po, total, I64_MAX))
        methods.append(method)
        params.append(torch.nn.functional.pad(k_lvl, (0, 256 - nparts)))
        start += nparts

    best_po = argmin_last(torch.stack(totals))
    pick = lambda xs: torch.stack(xs).gather(0, best_po[None]).squeeze(0)
    p_all = torch.stack(params)  # [PO+1, ..., 256]
    idx = best_po[None, ..., None].expand(1, *best_po.shape, 256)
    return pick(totals), pick(methods), best_po, p_all.gather(0, idx).squeeze(0)


class FixedAnalysis(NamedTuple):
    """The best fixed order of each plane and its Rice estimate; leading
    dims match the planes' batch dims."""

    order: torch.Tensor       # i64: 0..4, the first minimum
    ok: torch.Tensor          # bool: the order is usable (wide mode)
    residuals: torch.Tensor   # i32 [..., B]: the order's, warmup slots 0
    bits: torch.Tensor        # i64: rice_estimate's, before the ok test
    method: torch.Tensor      # i64
    part_order: torch.Tensor  # i64
    params: torch.Tensor      # i64 [..., 256]
    all_eq: torch.Tensor      # bool: every sample equals the first


def analyze_fixed_plain(
    planes: torch.Tensor, wide: bool, max_rice_order: int, max_param: int
) -> FixedAnalysis:
    """``analyze_fixed`` as plain torch ops."""
    check_partition_order(planes.shape[-1], max_rice_order)
    order, ok = best_fixed_order(planes, wide)
    residuals = residuals_for_order(planes, order)
    bits, method, part_order, params = rice_estimate(
        residuals, order, planes.shape[-1], max_rice_order, max_param
    )
    all_eq = (planes == planes[..., :1]).all(dim=-1)
    return FixedAnalysis(order, ok, residuals, bits, method, part_order, params, all_eq)


def _check_rice_args(B: int, max_rice_order: int, max_param: int) -> None:
    if not 1 <= B <= 65535:
        raise ValueError(f"block size must be 1..65535, got {B}")
    if not 0 <= max_rice_order <= 15:
        raise ValueError(f"max_rice_order must be 0..15, got {max_rice_order}")
    if not 0 <= max_param <= 30:
        raise ValueError(f"max_param must be 0..30, got {max_param}")
    check_partition_order(B, max_rice_order)


def _check_tensor(name: str, t: torch.Tensor, dtypes, device) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(lib, fn, name: str, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: {lib.zf_error_string(err).decode()}")


def _int64_outputs(batch_shape, scalars: int, dev):
    """``scalars`` int64 tensors of ``batch_shape`` and the params
    ``batch_shape + (256,)``, contiguous pieces of one allocation (a launch's
    host time is mostly its allocations)."""
    p = 1
    for d in batch_shape:
        p *= d
    flat = torch.empty(p * (scalars + PARAM_COLS), dtype=torch.int64, device=dev)
    out = [flat[i * p:(i + 1) * p].view(batch_shape) for i in range(scalars)]
    return (*out, flat[scalars * p:].view(batch_shape + (PARAM_COLS,)))


def analyze_fixed(
    planes: torch.Tensor, wide: bool, max_rice_order: int, max_param: int
) -> FixedAnalysis:
    """Order search, residual and Rice estimate of planes ``[..., B]``
    (int32, or int64 for the 33-bit side plane) on their device: the CUDA
    kernel ``zf_analyze_fixed`` for CUDA tensors, ``analyze_fixed_plain``
    for CPU tensors. ``wide`` disqualifies an order whose differences leave
    int32; ``max_param`` is 14 or 30 (at most 30)."""
    global KERNEL_LAUNCHES, PLAIN_CALLS
    B = planes.shape[-1] if planes.dim() else 0
    _check_rice_args(B, max_rice_order, max_param)
    _check_tensor("planes", planes, (torch.int32, torch.int64), planes.device)
    if planes.device.type == "cpu":
        PLAIN_CALLS += 1
        return analyze_fixed_plain(planes, wide, max_rice_order, max_param)
    if planes.device.type != "cuda":
        raise NotImplementedError(f"no analysis kernel for device {planes.device}")
    from ._build import library

    lib = library()
    dev = planes.device
    batch_shape = tuple(planes.shape[:-1])
    order, bits, method, part_order, params = _int64_outputs(batch_shape, 4, dev)
    ok, all_eq = torch.empty((2,) + batch_shape, dtype=torch.bool, device=dev)
    residuals = torch.empty(planes.shape, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(lib, lib.zf_analyze_fixed, "analysis",
                planes.data_ptr(), planes.dtype == torch.int64, planes.numel() // B, B,
                bool(wide), max_rice_order, max_param, order.data_ptr(), ok.data_ptr(),
                residuals.data_ptr(), bits.data_ptr(), method.data_ptr(),
                part_order.data_ptr(), params.data_ptr(), all_eq.data_ptr())
    KERNEL_LAUNCHES += 1
    return FixedAnalysis(order, ok, residuals, bits, method, part_order, params, all_eq)


def rice_estimate_planes(
    residuals: torch.Tensor, order: torch.Tensor, max_rice_order: int, max_param: int
):
    """``rice_estimate`` of int32 residuals ``[..., B]`` with their predictor
    orders (int64, 0..32) on their device: the CUDA kernel
    ``zf_rice_estimate`` for CUDA tensors, ``rice_estimate`` for CPU
    tensors. Returns (bits, method, part_order, params [..., 256])."""
    global RICE_KERNEL_LAUNCHES, PLAIN_CALLS
    B = residuals.shape[-1] if residuals.dim() else 0
    _check_rice_args(B, max_rice_order, max_param)
    _check_tensor("residuals", residuals, (torch.int32,), residuals.device)
    _check_tensor("order", order, (torch.int64,), residuals.device)
    if tuple(order.shape) != tuple(residuals.shape[:-1]):
        raise ValueError(f"order must be {tuple(residuals.shape[:-1])}, "
                         f"got {tuple(order.shape)}")
    if residuals.device.type == "cpu":
        PLAIN_CALLS += 1
        return rice_estimate(residuals, order, B, max_rice_order, max_param)
    if residuals.device.type != "cuda":
        raise NotImplementedError(f"no Rice kernel for device {residuals.device}")
    from ._build import library

    lib = library()
    bits, method, part_order, params = _int64_outputs(tuple(order.shape), 3, residuals.device)
    with torch.cuda.device(residuals.device):
        _launch(lib, lib.zf_rice_estimate, "Rice",
                residuals.data_ptr(), order.data_ptr(), order.numel(), B, max_rice_order,
                max_param, bits.data_ptr(), method.data_ptr(), part_order.data_ptr(),
                params.data_ptr())
    RICE_KERNEL_LAUNCHES += 1
    return bits, method, part_order, params


class LpcSearch(NamedTuple):
    """The cheapest window's LPC candidate of each plane."""

    window: torch.Tensor      # i64: its index in the window list
    order: torch.Tensor       # i64
    residuals: torch.Tensor   # i32 [..., B]
    qcoeffs: torch.Tensor     # i64 [..., 32]
    shift: torch.Tensor       # i64
    ok: torch.Tensor          # bool: some window gave a usable candidate
    cost: torch.Tensor        # i64: Rice bits + 9 + order * precision
    method: torch.Tensor      # i64
    part_order: torch.Tensor  # i64
    params: torch.Tensor      # i64 [..., 256]


def lpc_window_search(
    planes: torch.Tensor,
    windows: torch.Tensor,
    lpc_order: int,
    precision: int,
    max_rice_order: int,
    max_param: int,
    sample_bits: Optional[int] = None,
) -> LpcSearch:
    """Every window of ``windows`` (Q8 int16 [W, B], ``lpc.windows_tensor``)
    over every plane ``[..., B]`` at once, along a leading window axis: the
    lag sums (``lpc.lag_sums_planes``, which ``sample_bits`` serves), the
    Levinson candidates, the choice, the quantization, the residual and its
    Rice estimate, each as for one window. A window whose candidate is
    unusable costs ``I64_MAX``; the cheapest wins, the first in list order
    on a tie (strict ``<``)."""
    W, B = windows.shape
    x = planes.unsqueeze(0)
    lags = lpc.lag_sums_planes(planes.contiguous(), lpc_order, windows, sample_bits)
    pre = lpc.fixed_point_levinson(lags, lpc.lpc_candidate_orders(lpc_order))
    order, qc, shift, ok = lpc.select_lpc_candidate(pre, B, precision)
    res, fits = lpc.lpc_residuals(x.expand((W,) + tuple(planes.shape)), qc, shift, order,
                                  lpc_order)
    ok = ok & fits
    bits, method, part_order, params = rice_estimate_planes(res, order, max_rice_order,
                                                           max_param)
    cost = torch.where(ok, bits + 9 + order * precision, I64_MAX)
    best = argmin_first(cost)

    def pick(t):
        idx = best.view((1,) + best.shape + (1,) * (t.dim() - 1 - best.dim()))
        return t.gather(0, idx.expand((1,) + t.shape[1:])).squeeze(0)

    return LpcSearch(best, *(pick(t) for t in (order, res, qc, shift, ok, cost, method,
                                                part_order, params)))


def lpc_order_of(config: EncoderConfig) -> int:
    """The largest LPC order the analysis may pick: the configured one
    when the prediction is LPC, else 0 (no LPC subframes)."""
    return config.lpc_order if config.prediction == "lpc" else 0


def _apply_wasted(planes: torch.Tensor, sample_size: int, config: EncoderConfig):
    """Wasted-bits shave (extension; the reference always writes 0): the
    plane's common trailing zero bits come off and the samples encode at a
    reduced width. Trailing zeros count over the plane's own width (64 bits
    for the 33-bit side plane)."""
    batch_shape = planes.shape[:-1]
    if not config.wasted_bits:
        return planes, torch.zeros(batch_shape, dtype=torch.int64, device=planes.device)
    ored = tree_or(planes.to(torch.int64))
    if planes.dtype == torch.int64:
        ctz = bit_length(ored & -ored, 63) - 1
    else:
        ored = ored & 0xFFFFFFFF
        ctz = bit_length(ored & -ored) - 1
    wasted = torch.where(ored != 0, ctz, 0).clamp(0, sample_size - 1)
    return planes >> wasted[..., None].to(planes.dtype), wasted


def analyze_planes(
    planes: torch.Tensor,
    bits_of_t: int,
    sample_size: int,
    block_size: int,
    config: EncoderConfig,
) -> PlaneAnalysis:
    """Full per-plane subframe decision (libFLAC/Encoder.zig:320-376).

    ``planes``: [..., B] int32, or int64 for the 33-bit side plane of a
    32-bit stream. ``bits_of_t`` is 32 or 64: the reference compares
    against ``@bitSizeOf(SampleT)``. ``sample_size`` is the STREAMINFO
    depth (not +1 for side planes, as the reference passes it).
    """
    B = block_size
    if planes.shape[-1] != B:
        raise ValueError(f"planes hold {planes.shape[-1]} samples, expected {B}")
    batch_shape = planes.shape[:-1]
    dev = planes.device
    wide = not (sample_size < 28 and bits_of_t == 32)

    planes, wasted = _apply_wasted(planes, sample_size, config)
    verb_bits = B * bits_of_t
    z = torch.zeros(batch_shape, dtype=torch.int64, device=dev)
    zq = torch.zeros(batch_shape + (lpc.MAX_LPC_ORDER,), dtype=torch.int64, device=dev)

    lpc_order = lpc_order_of(config)
    if B <= max(MAX_FIXED_ORDER, lpc_order) or config.prediction == "none":
        all_eq = (planes == planes[..., :1]).all(dim=-1)
        return PlaneAnalysis(
            kind=torch.where(all_eq, 0, 1),
            est_bits=torch.where(all_eq, bits_of_t, verb_bits),
            order=z, method=z, part_order=z,
            params=torch.zeros(batch_shape + (256,), dtype=torch.int64, device=dev),
            residuals=torch.zeros(batch_shape + (B,), dtype=torch.int32, device=dev),
            qcoeffs=zq, qshift=z, wasted=wasted,
        )

    max_param = min(
        30 if sample_size > 16 else MAX_RICE_PARAM_4BIT, config.max_rice_param
    )
    planes = planes.contiguous()  # as the kernels read them
    order, ok, residuals, rice_bits, method, part_order, params, all_eq = analyze_fixed(
        planes, wide, config.max_rice_order, max_param
    )
    # a wide-mode overflow disqualifies the fixed candidate entirely
    rice_bits = torch.where(ok, rice_bits, I64_MAX)
    use_lpc = torch.zeros_like(ok)
    qcoeffs, qshift = zq, z
    if lpc_order:
        # one LPC candidate per plane (the cheapest window's, where several
        # are listed) competes with the best fixed order on estimated bits
        # plus its coefficient overhead (strict <)
        windows = windows_of(config)
        stages.count("lpc.window_evals", planes.numel() // B * len(windows))
        search_start = stages.search_start(dev)
        searched = windows != (TUKEY_HALF,)
        # every plane is within sample_size + 1 bits (the side plane's)
        if not searched:
            l_order, res_lpc, l_q, l_shift, l_ok = lpc.analyze_lpc(
                planes, lpc_order, config.lpc_precision, sample_size + 1
            )
            l_bits, l_method, l_po, l_params = rice_estimate_planes(
                res_lpc, l_order, config.max_rice_order, max_param
            )
            l_cost = l_bits + 9 + l_order * config.lpc_precision
        else:
            found = lpc_window_search(
                planes, lpc.windows_tensor(windows, B, dev), lpc_order, config.lpc_precision,
                config.max_rice_order, max_param, sample_size + 1,
            )
            l_order, res_lpc, l_q, l_shift, l_ok = (
                found.order, found.residuals, found.qcoeffs, found.shift, found.ok)
            l_cost, l_method, l_po, l_params = (
                found.cost, found.method, found.part_order, found.params)
        stages.search_end(search_start)
        use_lpc = l_ok & (l_cost < rice_bits)
        rice_bits = torch.where(use_lpc, l_cost, rice_bits)
        method = torch.where(use_lpc, l_method, method)
        part_order = torch.where(use_lpc, l_po, part_order)
        params = torch.where(use_lpc[..., None], l_params, params)
        order = torch.where(use_lpc, l_order, order)
        qcoeffs = torch.where(use_lpc[..., None], l_q, qcoeffs)
        qshift = torch.where(use_lpc, l_shift, qshift)

    use_pred = (ok | use_lpc) & (rice_bits < verb_bits) & ~all_eq
    kind = torch.where(all_eq, 0, torch.where(use_pred, torch.where(use_lpc, 3, 2), 1))
    if lpc_order:
        residuals = torch.where((kind == 3)[..., None], res_lpc, residuals)
        if searched:
            stages.tally_windows(windows, found.window, kind == 3)
    return PlaneAnalysis(
        kind=kind,
        est_bits=torch.where(
            all_eq, bits_of_t, torch.where(use_pred, rice_bits, verb_bits)
        ),
        order=order,
        method=method,
        part_order=part_order,
        params=params,
        residuals=residuals,
        qcoeffs=qcoeffs,
        qshift=qshift,
        wasted=wasted,
    )


def plan_frames_indep(
    frames: torch.Tensor, depth: int, config: EncoderConfig
) -> FrameWirePlan:
    """Independent channels, each analyzed and written as-is
    (libFLAC/Encoder.zig:242-247)."""
    n, c, B = frames.shape
    pm = frames.movedim(1, 0)  # [c, n, B] plane-major
    a = analyze_planes(pm, 32, depth, B, config)
    return FrameWirePlan(
        channels_code=torch.full((n,), c - 1, dtype=torch.int64, device=frames.device),
        kind=a.kind,
        order=a.order,
        method=a.method,
        part_order=a.part_order,
        sample_size=depth - a.wasted,
        params=a.params,
        planes=pm >> a.wasted[..., None].to(pm.dtype),
        residuals=a.residuals,
        qcoeffs=a.qcoeffs,
        qshift=a.qshift,
        wasted=a.wasted,
    )


def plan_frames_stereo(
    frames: torch.Tensor, depth: int, config: EncoderConfig
) -> FrameWirePlan:
    """stereo_auto: analyze the L/R/M/S planes, pick the first-min of
    {L+R, L+S, S+R, M+S} and emit the two wire channels
    (libFLAC/Encoder.zig:248-314). At depth 32 the side plane is 33 bits:
    it stays int64 and is analyzed wide (``bits_of_t = 64``), and the wire
    planes are int64."""
    n, c, B = frames.shape
    if c != 2:
        raise ValueError(f"stereo_auto needs 2 channels, got {c}")
    left = frames[:, 0].to(torch.int64)
    right = frames[:, 1].to(torch.int64)
    mid = (left + right) >> 1
    side = left - right
    if depth == 32:
        lrm = torch.stack([left, right, mid]).to(torch.int32)  # [3, n, B]
        a3 = analyze_planes(lrm, 32, depth, B, config)
        a_s = analyze_planes(side, 64, depth, B, config)
        a = PlaneAnalysis(*[torch.cat([x, y[None]]) for x, y in zip(a3, a_s)])
        lrms = torch.cat([lrm.to(torch.int64), side[None]])  # [4, n, B] i64
    else:
        lrms = torch.stack([left, right, mid, side]).to(torch.int32)  # [4, n, B]
        a = analyze_planes(lrms, 32, depth, B, config)
    planes_w = lrms >> a.wasted[..., None].to(lrms.dtype)

    est = a.est_bits  # [4, n] in plane order L, R, M, S
    sums = torch.stack(
        [est[0] + est[1], est[0] + est[3], est[3] + est[1], est[2] + est[3]]
    )
    ch_type = argmin_first(sums)  # [n]

    # wire planes per mode (L, R, M, S = 0..3): wire0 = [L, L, S, M],
    # wire1 = [R, S, R, S]
    # (index arithmetic, not a table: a table would be copied to the device
    # and wait for it)
    w0_src = torch.where(ch_type < 2, 0, 5 - ch_type)
    w1_src = 1 + 2 * (ch_type % 2)
    cols = torch.arange(n, device=frames.device)

    def gather_ch(x):
        return torch.stack([x[w0_src, cols], x[w1_src, cols]])

    wasted_w = gather_ch(a.wasted)
    ss0 = depth + (ch_type == 2).to(torch.int64) - wasted_w[0]
    ss1 = depth + ((ch_type == 1) | (ch_type == 3)).to(torch.int64) - wasted_w[1]
    return FrameWirePlan(
        channels_code=torch.where(ch_type == 0, 1, ch_type + 7),
        kind=gather_ch(a.kind),
        order=gather_ch(a.order),
        method=gather_ch(a.method),
        part_order=gather_ch(a.part_order),
        sample_size=torch.stack([ss0, ss1]),
        params=gather_ch(a.params),
        planes=gather_ch(planes_w),
        residuals=gather_ch(a.residuals),
        qcoeffs=gather_ch(a.qcoeffs),
        qshift=gather_ch(a.qshift),
        wasted=wasted_w,
    )


def plan_frames(frames: torch.Tensor, depth: int, config: EncoderConfig) -> FrameWirePlan:
    if config.stereo_auto:
        return plan_frames_stereo(frames, depth, config)
    return plan_frames_indep(frames, depth, config)
