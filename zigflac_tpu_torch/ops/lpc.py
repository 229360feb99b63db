"""LPC subframes on torch tensors: the windowed autocorrelation, the Q28
fixed-point Levinson, the candidate choice, the quantization and the
integer prediction residual.

Counterpart of ``zigflac_tpu/ops/lpc.py``. Every value that decides bytes
is an exact integer, so the port computes the same integers as the JAX
package on any device:

* the Q8 Tukey(0.5) window is built on the host in float64 numpy, exactly
  as the JAX package builds it, and only then moved to the device as int64
  (a float recomputation on the card could round a value on a 1/2 boundary
  the other way);
* each lag sum is carried as three int64 limb partial sums over 24-bit
  limbs, one form for every depth and every block size the format allows
  (exact for |windowed sample| <= 2^46, which covers the 33-bit side plane
  of a 32-bit stream, and B < 2^16). The JAX
  package's cheaper tiers and narrow storage exist for the TPU's emulated
  int64; the normalized limb triple is unique, so every tier equals this
  form wherever that tier is exact (the JAX general limb tier takes its
  low limb unsigned and wraps past 2^15 samples);
* the Levinson recursion, the candidate score and the quantization are
  int64 adds, products, arithmetic shifts and floor divisions (torch's
  int64 ``//`` floors and its ``>>`` is arithmetic, as XLA's);
* the residual is one int64 tap loop with a dynamic int32 range check.

Where a configuration lists other windows than the one Tukey(0.5)
(``flac -8``'s ``tukey(0.5)``, ``partial_tukey(2)`` and
``punchout_tukey(3)``; ``utils/apodization.py``), each window is built on
the host in Q8 the same way, and the analysis runs every window over every
plane (``analyze.lpc_window_search``); the JAX package has the Tukey(0.5)
alone.

The lag sums of every plane under every window are one hand-written CUDA
kernel on the card (``csrc/lags.cu``): ``lag_sums_planes`` routes by
device, a CUDA tensor to the kernel (or a raise), a CPU tensor to the plain
version ``lag_sums``. ``LAG_KERNEL_LAUNCHES`` counts ``zf_lag_sums``
launches and ``PLAIN_CALLS`` the plain route.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import stages
from ..utils.apodization import MAX_WINDOWS, PART_OVERLAP, TUKEY_HALF, Window

MAX_LPC_ORDER = 32
WINDOW_Q = 8  # window fixed-point fraction bits
_LIMB = 24    # limb width of the lag sums
_Q = 28       # Levinson fixed-point fraction bits

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
# the widest samples (bits, two's complement) the kernel's narrow tier takes
NARROW_BITS = 17

LAG_KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0


def reset_counts() -> None:
    global LAG_KERNEL_LAUNCHES, PLAIN_CALLS
    LAG_KERNEL_LAUNCHES = 0
    PLAIN_CALLS = 0


@lru_cache(maxsize=32)
def tukey_window(n: int, alpha: float = 0.5) -> np.ndarray:
    """Tukey (tapered cosine) window, float64."""
    if n == 1:
        return np.ones(1)
    t = np.linspace(0.0, 1.0, n)
    w = np.ones(n)
    edge = alpha / 2.0
    lo = t < edge
    hi = t >= 1.0 - edge
    w[lo] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * t[lo] / alpha - 1.0)))
    w[hi] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * t[hi] / alpha - 2.0 / alpha + 1.0)))
    return w


@lru_cache(maxsize=32)
def tukey_qw(n: int) -> np.ndarray:
    """The window the encoder uses: Q8 fixed point, int64."""
    return np.round(tukey_window(n) * float(1 << WINDOW_Q)).astype(np.int64)


def _tukey_span(w: np.ndarray, a: int, b: int, taper: int) -> None:
    """libFLAC's taper on ``w[a:b]``: a raised cosine up over its first
    ``taper`` samples (the i-th at 0.5 - 0.5 cos(pi i / taper), i from 1),
    ones, and the mirror image down over its last ``taper``."""
    w[a:b] = 1.0
    if taper > 0:
        i = np.arange(1, taper + 1)
        ramp = 0.5 - 0.5 * np.cos(np.pi * i / taper)
        w[a : a + taper] = ramp
        w[b - taper : b] = ramp[::-1]


def _part_window(win: Window, n: int) -> np.ndarray:
    """libFLAC's ``FLAC__window_partial_tukey`` (the part kept, zero
    elsewhere) and ``FLAC__window_punchout_tukey`` (the part zeroed, a
    tapered span on each side), in float64, over the part's span
    [start, end) = [m, m + 1 + u) / (parts + u) of the block, u = 1 / (1 -
    overlap) - 1, each end truncated to a sample."""
    u = 1.0 / (1.0 - PART_OVERLAP[win.kind]) - 1.0
    start = int(win.part / (win.parts + u) * n)
    end = int((win.part + 1 + u) / (win.parts + u) * n)
    w = np.zeros(n)
    if win.kind == "partial_tukey":
        _tukey_span(w, start, end, int(win.param / 2.0 * (end - start)))
    else:
        _tukey_span(w, 0, start, int(win.param / 2.0 * start))
        _tukey_span(w, end, n, int(win.param / 2.0 * (n - end)))
    return w


@lru_cache(maxsize=64)
def window_qw(win: Window, n: int) -> np.ndarray:
    """A window in Q8 fixed point, int64 in [0, 256], rounded half to even
    from float64 as ``tukey_qw``."""
    w = tukey_window(n, win.param) if win.kind == "tukey" else _part_window(win, n)
    return np.round(w * float(1 << WINDOW_Q)).astype(np.int64)


@lru_cache(maxsize=32)
def _window(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(tukey_qw(n)).to(device)


@lru_cache(maxsize=32)
def windows_tensor(wins: Tuple[Window, ...], n: int, device: torch.device) -> torch.Tensor:
    """The windows' Q8 values stacked, narrowed to int16 [W, n] (they lie in
    [0, 256]), on ``device``: what ``lag_sums_planes`` reads."""
    return torch.from_numpy(np.stack([window_qw(w, n) for w in wins]).astype(np.int16)).to(
        device)


def lag_sums(planes: torch.Tensor, order: int,
             window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact windowed autocorrelation: ``planes`` int [..., B] -> int64
    [..., order+1, 3], lag k's value being ``l0*2^48 + l1*2^24 + l2`` with
    l1, l2 in [0, 2^24).

    The windowed samples split into 24-bit limbs with a signed low limb
    (hi = (x + 2^23) >> 24, lo = x - hi * 2^24 in [-2^23, 2^23)), so every
    product is at most 2^46 in magnitude for |x| <= 2^46 (a 33-bit side
    sample times the Q8 window is under 2^41). The hi*hi, hi*lo + lo*hi and
    lo*lo product sums then fit int64 for every block below 2^16 samples,
    and the floor carries normalize the low two limbs. ``window`` (Q8, int16
    or int64, broadcast against the planes) replaces the Q8 Tukey(0.5). The
    plain version of ``lag_sums_planes``."""
    B = planes.shape[-1]
    w = _window(B, planes.device) if window is None else window
    x = planes.to(torch.int64) * w
    m24 = (1 << _LIMB) - 1
    hi = (x + (1 << (_LIMB - 1))) >> _LIMB
    lo = x - (hi << _LIMB)
    out = []
    for k in range(order + 1):
        ah, al = hi[..., k:], lo[..., k:]
        bh, bl = hi[..., : B - k], lo[..., : B - k]
        hh = (ah * bh).sum(-1)
        hl = (ah * bl).sum(-1) + (al * bh).sum(-1)
        ll = (al * bl).sum(-1)
        hl2 = hl + (ll >> _LIMB)
        out.append(torch.stack([hh + (hl2 >> _LIMB), hl2 & m24, ll & m24], -1))
    return torch.stack(out, -2)


def narrow_tier(dtype: torch.dtype, sample_bits: Optional[int]) -> bool:
    """Whether ``zf_lag_sums`` takes its narrow arithmetic for planes of
    ``dtype`` whose samples ``sample_bits`` bounds."""
    return dtype == torch.int32 and sample_bits is not None and sample_bits <= NARROW_BITS


def lag_sums_planes(planes: torch.Tensor, order: int, windows: torch.Tensor,
                    sample_bits: Optional[int] = None) -> torch.Tensor:
    """``lag_sums`` of planes ``[..., B]`` (int32, or int64 for the 33-bit
    side plane) under each of the Q8 ``windows`` (int16 [W, B], as
    ``windows_tensor`` gives them) on their device: int64 [W, ..., order+1,
    3]. The CUDA kernel ``zf_lag_sums`` for CUDA tensors, one launch for
    every plane and window; ``lag_sums`` for CPU tensors. ``sample_bits``,
    where given, bounds the samples: each is a ``sample_bits``-bit two's
    complement integer; int32 planes of at most ``NARROW_BITS`` take the
    kernel's narrow arithmetic, every other plane its 24-bit limbs (the same
    values)."""
    global LAG_KERNEL_LAUNCHES, PLAIN_CALLS
    B = planes.shape[-1] if planes.dim() else 0
    if not 1 <= B <= 65535:
        raise ValueError(f"block size must be 1..65535, got {B}")
    if not 1 <= order <= MAX_LPC_ORDER:
        raise ValueError(f"LPC order must be 1..{MAX_LPC_ORDER}, got {order}")
    if sample_bits is not None and not 1 <= sample_bits <= 64:
        raise ValueError(f"sample_bits must be 1..64, got {sample_bits}")
    for name, t, dtypes in (("planes", planes, (torch.int32, torch.int64)),
                            ("windows", windows, (torch.int16,))):
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
        if t.device != planes.device:
            raise ValueError(f"{name} is on {t.device}, expected {planes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    W = windows.shape[0] if windows.dim() == 2 else 0
    if not 1 <= W <= MAX_WINDOWS or windows.shape[-1] != B:
        raise ValueError(f"windows must be [1..{MAX_WINDOWS}, {B}], got {tuple(windows.shape)}")
    if planes.device.type == "cpu":
        PLAIN_CALLS += 1
        return lag_sums(planes.unsqueeze(0), order,
                        windows.view((W,) + (1,) * (planes.dim() - 1) + (B,)))
    if planes.device.type != "cuda":
        raise NotImplementedError(f"no lag sums kernel for device {planes.device}")
    from ._build import library

    lib = library()
    batch = tuple(planes.shape[:-1])
    p = planes.numel() // B
    out = torch.empty((W,) + batch + (order + 1, 3), dtype=torch.int64, device=planes.device)
    narrow = narrow_tier(planes.dtype, sample_bits)
    with torch.cuda.device(planes.device):
        err = lib.zf_lag_sums(planes.data_ptr(), planes.dtype == torch.int64, narrow,
                              windows.data_ptr(), W, p, B, order, out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"lag sums kernel launch failed: {lib.zf_error_string(err).decode()}")
    LAG_KERNEL_LAUNCHES += 1
    stages.count("lpc.lag_kernel_evals", p * W)
    return out


def _bitlen_nonneg(x: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 by an integer binary search."""
    n = torch.zeros_like(x)
    for sh in (32, 16, 8, 4, 2, 1):
        big = (x >> sh) > 0
        n = n + torch.where(big, sh, 0)
        x = torch.where(big, x >> sh, x)
    return n + (x > 0).to(torch.int64)


def _lags_q28(lags: torch.Tensor) -> torch.Tensor:
    """Limb lag sums -> Q28 normalized autocorrelation r_k = v_k / v_0:
    each v_k >> s with s = bitlen(v_0) - 30 (so every shifted value fits
    ~31 bits), then (vs_k << 28) // vs_0."""
    a = lags[..., 0]
    lo48 = (lags[..., 1] << _LIMB) + lags[..., 2]  # [0, 2^48)
    a0, lo0 = a[..., 0:1], lo48[..., 0:1]
    bl = torch.where(a0 > 0, 48 + _bitlen_nonneg(a0), _bitlen_nonneg(lo0))
    s = (bl - 30).clamp(min=0)
    vs = torch.where(
        s >= 48,
        a >> (s - 48).clamp(0, 63),
        (a << (48 - s).clamp(min=0)) + (lo48 >> s.clamp(max=47)),
    )
    return (vs << _Q) // vs[..., 0:1].clamp(min=1)  # r_0 == 2^28 exactly


def fixed_point_levinson(lags: torch.Tensor, orders: Tuple[int, ...]):
    """Limb lag sums -> one ``(order, C [..., max_order] Q28 coefficients,
    cmax, ok, err)`` per candidate order, from one Q28 recursion.

    Magnitudes are clamped (|k| <= 2, |c| <= 32, |acc| <= 64 in Q28) so no
    product leaves int64; an unstable recursion gives valid but poor
    coefficients or trips ``ok``."""
    r = _lags_q28(lags)
    max_order = max(orders)
    batch = r.shape[:-1]
    one = 1 << _Q
    k_clip, c_clip, a_clip = 2 << _Q, 32 << _Q, 64 << _Q
    err = torch.full(batch, one, dtype=torch.int64, device=r.device)
    C = torch.zeros(batch + (max_order,), dtype=torch.int64, device=r.device)
    out = []
    for i in range(max_order):
        acc = r[..., i + 1]
        if i:
            rr = r[..., 1 : i + 1].flip(-1)  # r[i-j], j = 0..i-1
            acc = acc - ((C[..., :i] * rr) >> _Q).sum(-1)
        acc = acc.clamp(-a_clip, a_clip)
        k = ((acc << _Q) // err.clamp(min=1)).clamp(-k_clip, k_clip)
        if i:
            upd = (C[..., :i] - ((k[..., None] * C[..., :i].flip(-1)) >> _Q)).clamp(
                -c_clip, c_clip
            )
            C = torch.cat([upd, k[..., None], C[..., i + 1 :]], -1)
        else:
            C = torch.cat([k[..., None], C[..., 1:]], -1)
        err = (err * (one - ((k * k) >> _Q)).clamp(min=1)) >> _Q
        if (i + 1) in orders:
            cmax = C[..., : i + 1].abs().amax(-1)
            # all-zero coefficients (silence) and runaway magnitudes
            # disqualify the candidate
            ok = (cmax > 0) & (cmax < (1 << 48))
            out.append((i + 1, C, cmax, ok, err))
    return out


def _log2_q8(e: torch.Tensor) -> torch.Tensor:
    """Integer log2 with 8 fraction bits (linear mantissa) of positive
    int64 <= 2^40."""
    top = (_bitlen_nonneg(e) - 1).clamp(min=0)
    return (top << 8) + ((e << 8) >> top) - 256


def _quantize_selected(coeffs, cmax, order, max_order: int, precision: int):
    """Quantize the selected candidate's Q28 coefficients to ``precision``
    signed bits with error feedback: shift = precision - 1 -
    (floor(log2 cmax) + 1) in [0, 15], q_j = clamp((t + 2^27) >> 28) with
    t = (c_j << shift) + feedback (round half up); q_j = 0 for j >=
    order."""
    shift = ((precision - 1) - (_bitlen_nonneg(cmax) - _Q)).clamp(0, 15)
    qmax, qmin = (1 << (precision - 1)) - 1, -(1 << (precision - 1))
    half = 1 << (_Q - 1)
    fb = torch.zeros_like(cmax)
    qs = []
    for j in range(max_order):
        target = (coeffs[..., j] << shift) + fb
        q = ((target + half) >> _Q).clamp(qmin, qmax)
        fb = target - (q << _Q)
        qs.append(torch.where(j < order, q, 0))
    return torch.stack(qs, -1), shift


def select_lpc_candidate(pre, block_size: int, precision: int):
    """One candidate order per plane, by the estimated bits
    ``B * log2_q8(err) / 2 + (9 + order * precision) << 8``, first-min over
    ascending orders (strict ``<``); only the chosen candidate is
    quantized. Returns (order [...], qcoeffs [..., 32], shift, ok): ``ok``
    is False when no candidate is usable."""
    max_order = max(o for o, *_ in pre)
    score = None
    for o, c_C, c_cmax, c_ok, c_err in pre:
        s = (block_size * _log2_q8(c_err.clamp(min=1))) >> 1
        s = torch.where(c_ok, s + ((9 + o * precision) << 8), 1 << 62)
        if score is None:
            score, order = s, torch.full_like(s, o)
            coeffs, cmax, ok = c_C, c_cmax, c_ok
        else:
            better = s < score
            score = torch.where(better, s, score)
            order = torch.where(better, o, order)
            coeffs = torch.where(better[..., None], c_C, coeffs)
            cmax = torch.where(better, c_cmax, cmax)
            ok = ok | c_ok
    qc, shift = _quantize_selected(coeffs, cmax, order, max_order, precision)
    return order, torch.nn.functional.pad(qc, (0, MAX_LPC_ORDER - max_order)), shift, ok


def lpc_residuals(
    planes: torch.Tensor,
    qcoeffs: torch.Tensor,
    shift: torch.Tensor,
    order: torch.Tensor,
    max_order: int,
):
    """r[i] = s[i] - ((sum_j q_j * s[i-1-j]) >> shift) for i >= order, the
    first ``order`` slots zeroed, in int64 and accumulated tap by tap.
    Returns (residuals int32 [..., B], fits [...]): ``fits`` says every
    residual of the plane is an int32."""
    B = planes.shape[-1]
    p = planes.to(torch.int64)
    pred = torch.zeros_like(p)
    for j in range(min(max_order, B - 1)):
        pred[..., j + 1 :] += qcoeffs[..., j : j + 1] * p[..., : B - j - 1]
    res = p - (pred >> shift[..., None])
    res = torch.where(torch.arange(B, device=p.device) < order[..., None], 0, res)
    fits = ((res >= _I32_MIN) & (res <= _I32_MAX)).all(-1)
    return res.to(torch.int32), fits


def lpc_candidate_orders(lpc_order: int) -> Tuple[int, ...]:
    """Candidate orders: the powers of two below the configured maximum,
    and the maximum itself."""
    cands = {lpc_order}
    o = 1
    while o < lpc_order:
        cands.add(o)
        o *= 2
    return tuple(sorted(cands))


def analyze_lpc(planes: torch.Tensor, lpc_order: int, precision: int,
                sample_bits: Optional[int] = None):
    """The LPC candidate of each plane under the Q8 Tukey(0.5) window:
    (order, residuals int32 [..., B], qcoeffs [..., 32], shift, ok).
    ``sample_bits`` bounds the samples as ``lag_sums_planes`` takes it."""
    wins = windows_tensor((TUKEY_HALF,), planes.shape[-1], planes.device)
    lags = lag_sums_planes(planes.contiguous(), lpc_order, wins, sample_bits)[0]
    pre = fixed_point_levinson(lags, lpc_candidate_orders(lpc_order))
    order, qc, shift, ok = select_lpc_candidate(pre, planes.shape[-1], precision)
    res, fits = lpc_residuals(planes, qc, shift, order, lpc_order)
    return order, res, qc, shift, ok & fits

