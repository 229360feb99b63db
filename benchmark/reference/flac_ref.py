"""Plain reference FLAC encoder of the benchmark: the bytes an encode must
give, worked out again from the PCM alone.

Plain PyTorch integer ops (any device), vectorised over frames, written
from the codec's rules as the upstream encoder states them (toastori
zig-flac, libFLAC/Encoder.zig, fixed.zig, rice.zig, FrameWriter.zig) and
from the codec's own integer LPC definition (Q8 Tukey window, exact lag
sums, Q28 Levinson, error-based order choice, quantisation with error
feedback). It imports nothing of the program under test and takes nothing
it made: every decision (stereo mode, constant / verbatim / fixed / LPC,
order, coefficients and shift, Rice partition order, parameters and
escapes) and every byte (frame headers with CRC-8, CRC-16, STREAMINFO with
its frame sizes and MD5, the VorbisComment) is derived here.

``encode(pcm, rate, depth, cfg, raw_pcm)`` gives the whole stream;
``plan_frames`` the per-subframe decisions, which ``synthesize`` turns back
into samples (the decode cell's control runs it in float32).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

I64 = torch.int64
I64_MAX = (1 << 63) - 1
MAX_FIXED_ORDER = 4
MAX_RICE_PARAM_4BIT = 14
VENDOR = b"toastori FLAC 0.0.0"
WINDOW_Q = 8
LIMB = 24
Q = 28

# kinds of subframe
CONSTANT, VERBATIM, FIXED, LPC = 0, 1, 2, 3
RATE_CODES = {0: 0, 88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
              24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}
DEPTH_CODES = {8: 2, 12: 4, 16: 8, 20: 10, 24: 12, 32: 14}


def _crc_table(poly: int, width: int) -> List[int]:
    top, mask = 1 << (width - 1), (1 << width) - 1
    table = []
    for byte in range(256):
        c = byte << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if c & top else (c << 1)
        table.append(c & mask)
    return table


CRC8 = _crc_table(0x07, 8)
CRC16 = _crc_table(0x8005, 16)


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = CRC8[c ^ b]
    return c


def crc16_bytes(data: bytes) -> int:
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ CRC16[(c >> 8) ^ b]
    return c


_CRC16_DIST = np.array([CRC16], np.int64)


def crc16_distance_table(longest: int) -> np.ndarray:
    """T[d, b]: the CRC-16 register after byte ``b`` and ``d`` zero bytes,
    from a zero register. The CRC is linear, so a message's CRC is the XOR
    of T[length - 1 - i, byte i] over its bytes."""
    global _CRC16_DIST
    t = _CRC16_DIST
    if t.shape[0] < longest:
        t1 = np.array(CRC16, np.int64)
        rows = [t]
        last = t[-1]
        for _ in range(longest - t.shape[0]):
            last = ((last << 8) & 0xFFFF) ^ t1[last >> 8]
            rows.append(last[None])
        _CRC16_DIST = t = np.concatenate(rows)
    return t[:longest]


# -- configuration -------------------------------------------------------------


@dataclass(frozen=True)
class Settings:
    block_size: int = 4096
    prediction: str = "fixed"        # "fixed", "lpc" or "none"
    channels: object = "stereo_auto"  # "stereo_auto" or a count
    max_rice_order: int = 8
    max_rice_param: int = 30
    lpc_order: int = 8
    lpc_precision: int = 14

    @staticmethod
    def of(d: Dict) -> "Settings":
        keys = Settings.__dataclass_fields__
        return Settings(**{k: v for k, v in d.items() if k in keys})


def _ilog2(v: int) -> int:
    return v.bit_length() - 1


def _ctz(v: int) -> int:
    return (v & -v).bit_length() - 1


# -- fixed prediction (fixed.zig) --------------------------------------------


def fixed_search(x: torch.Tensor, wide: bool):
    """First-min order over sums of |k-th difference| for k = 0..4, per
    plane of ``x`` [P, B] int64; wide mode disqualifies an order whose
    residuals leave int32, and a disqualified winner gives order -1.
    Returns (order [P], residuals [P, B] with the first ``order`` zeroed)."""
    e = x
    best_total = best = None
    cascade = [x]
    for k in range(MAX_FIXED_ORDER + 1):
        if k:
            e = e[:, 1:] - e[:, :-1]
            cascade.append(e)
        a = e.abs()
        total = a.sum(1)
        if wide:
            total = torch.where(a.amax(1) > (1 << 31) - 1, I64_MAX, total)
        if best is None:
            best_total, best = total, torch.zeros_like(total)
        else:
            better = total < best_total
            best_total = torch.where(better, total, best_total)
            best = torch.where(better, k, best)
    res = torch.zeros_like(x)
    for k in range(MAX_FIXED_ORDER + 1):
        sel = best == k
        if bool(sel.any()):
            res[sel, k:] = cascade[k][sel]
    if wide:
        best = torch.where(best_total == I64_MAX, -1, best)
    return best, res


# -- Rice parameters (rice.zig) ------------------------------------------------


def zigzag(r: torch.Tensor) -> torch.Tensor:
    return torch.where(r >= 0, 2 * r, -2 * r - 1)


def rice_choice(res: torch.Tensor, order: torch.Tensor, depth: int, s: Settings):
    """Rice coding of residuals [P, B] at predictor orders [P] (flake-style
    estimate of rice.zig, unsigned 64-bit wrap included): returns
    (bits [P], part_order [P], params [P, 2^max] (escape = max_param + 1),
    method [P])."""
    P, B = res.shape
    dev = res.device
    max_param = min(30 if depth > 16 else MAX_RICE_PARAM_4BIT, s.max_rice_param)
    top = min(s.max_rice_order, _ctz(B))
    # each plane's own ceiling: ilog2(B) - ilog2(order) when predicting
    own_max = torch.where(order > 0, _ilog2(B) - (_bitlen(order) - 1), 15)
    own_max = own_max.clamp(max=top)
    z = zigzag(res)  # warm-up slots are zero, so they add nothing
    sums = z[:, : (B >> top) << top].reshape(P, 1 << top, B >> top).sum(2)
    ks = torch.arange(max_param + 2, device=dev)
    best_bits = torch.full((P,), I64_MAX, dtype=I64, device=dev)
    best_po = torch.zeros(P, dtype=I64, device=dev)
    best_params = torch.zeros(P, 1 << top, dtype=I64, device=dev)
    best_method = torch.zeros(P, dtype=I64, device=dev)
    level = sums
    levels = {top: sums}
    for po in range(top - 1, -1, -1):
        level = level[:, 0::2] + level[:, 1::2]
        levels[po] = level
    for po in range(top + 1):
        psum = levels[po]                       # [P, 2^po]
        ps = B >> po
        size = torch.full_like(psum, ps)
        size[:, 0] = ps - order
        lhs = psum - size // 2
        # lhs >= 0: first-min over k of size * (k + 1) + (lhs >> k)
        cost = size[..., None] * (ks + 1) + (lhs.clamp(min=0)[..., None] >> ks)
        bits, k = cost[..., 0], torch.zeros_like(psum)
        for kk in range(1, max_param + 2):   # first min
            better = cost[..., kk] < bits
            bits = torch.where(better, cost[..., kk], bits)
            k = torch.where(better, kk, k)
        bits = torch.where(k == max_param + 1, size * k, bits)
        # lhs < 0 wraps to 2^64 + lhs: k = 0 costs size + lhs, every other k
        # at least 2^33 more
        k = torch.where(lhs < 0, 0, k)
        bits = torch.where(lhs < 0, size + lhs, bits)
        zero = psum == 0
        k = torch.where(zero, max_param + 1, k)
        bits = torch.where(zero, 5, bits)
        method = ((k > MAX_RICE_PARAM_4BIT).any(1) & (max_param > MAX_RICE_PARAM_4BIT)).long()
        total = bits.sum(1) + (method + 4) * (1 << po)
        take = (total <= best_bits) & (po <= own_max)
        best_bits = torch.where(take, total, best_bits)
        best_po = torch.where(take, po, best_po)
        best_method = torch.where(take, method, best_method)
        wide_k = k.repeat_interleave(1 << (top - po), dim=1)
        best_params = torch.where(take[:, None], wide_k, best_params)
    return best_bits, best_po, best_params, best_method


# -- LPC: the codec's integer derivation ---------------------------------------


def tukey_q8(n: int) -> np.ndarray:
    """The Q8 Tukey(0.5) window, int64 (round half to even of the float64
    window times 256)."""
    if n == 1:
        w = np.ones(1)
    else:
        t = np.linspace(0.0, 1.0, n)
        w = np.ones(n)
        lo, hi = t < 0.25, t >= 0.75
        w[lo] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * t[lo] / 0.5 - 1.0)))
        w[hi] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * t[hi] / 0.5 - 4.0 + 1.0)))
    return np.round(w * float(1 << WINDOW_Q)).astype(np.int64)


def lag_limbs(x: torch.Tensor, order: int) -> torch.Tensor:
    """Exact windowed autocorrelation at lags 0..order of planes [P, B], as
    normalised limbs [P, order + 1, 3]: value = l0 * 2^48 + l1 * 2^24 + l2,
    with l1 and l2 in [0, 2^24)."""
    B = x.shape[1]
    xw = x * torch.from_numpy(tukey_q8(B)).to(x.device)
    m24 = (1 << LIMB) - 1
    hi, lo = xw >> LIMB, xw & m24
    out = []
    for k in range(order + 1):
        ah, al = hi[:, k:], lo[:, k:]
        bh, bl = hi[:, : B - k], lo[:, : B - k]
        hh = (ah * bh).sum(1)
        hl = (ah * bl).sum(1) + (al * bh).sum(1)
        ll = (al * bl).sum(1)
        hl2 = hl + (ll >> LIMB)
        out.append(torch.stack([hh + (hl2 >> LIMB), hl2 & m24, ll & m24], -1))
    return torch.stack(out, 1)


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    n = torch.zeros_like(x)
    for sh in (32, 16, 8, 4, 2, 1):
        big = (x >> sh) > 0
        n = n + torch.where(big, sh, 0)
        x = torch.where(big, x >> sh, x)
    return n + (x > 0).long()


def _fdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _q28(lags: torch.Tensor) -> torch.Tensor:
    """Limbs -> r_k = v_k / v_0 in Q28 (v_k shifted to ~30 bits first)."""
    a = lags[..., 0]
    lo48 = (lags[..., 1] << LIMB) + lags[..., 2]
    a0, lo0 = a[:, :1], lo48[:, :1]
    bl = torch.where(a0 > 0, 48 + _bitlen(a0), _bitlen(lo0))
    s = (bl - 30).clamp(min=0)
    vs = torch.where(s >= 48, a >> (s - 48).clamp(0, 63),
                     (a << (48 - s).clamp(min=0)) + (lo48 >> s.clamp(max=47)))
    return _fdiv(vs << Q, vs[:, :1].clamp(min=1))


def candidate_orders(lpc_order: int):
    c = {lpc_order}
    o = 1
    while o < lpc_order:
        c.add(o)
        o *= 2
    return sorted(c)


def _log2_q8(e: torch.Tensor) -> torch.Tensor:
    top = (_bitlen(e) - 1).clamp(min=0)
    return (top << 8) + ((e << 8) >> top) - 256


def lpc_analysis(x: torch.Tensor, s: Settings):
    """(order [P], qcoeffs [P, max_order], shift [P], ok [P]) of planes
    [P, B]: Q28 Levinson over the exact lags, the candidate with the least
    estimated bits (B * log2(err) / 2 + 9 + order * precision, first min),
    its coefficients quantised to ``precision`` bits with error feedback."""
    P, B = x.shape
    orders = candidate_orders(s.lpc_order)
    mo = max(orders)
    r = _q28(lag_limbs(x, mo))
    one = 1 << Q
    err = torch.full((P,), one, dtype=I64, device=x.device)
    C = torch.zeros(P, mo, dtype=I64, device=x.device)
    score = order = coeffs = cmax = ok = None
    for i in range(mo):
        acc = r[:, i + 1]
        if i:
            acc = acc - ((C[:, :i] * r[:, 1 : i + 1].flip(1)) >> Q).sum(1)
        acc = acc.clamp(-(64 << Q), 64 << Q)
        k = _fdiv(acc << Q, err.clamp(min=1)).clamp(-(2 << Q), 2 << Q)
        if i:
            upd = (C[:, :i] - ((k[:, None] * C[:, :i].flip(1)) >> Q)).clamp(-(32 << Q), 32 << Q)
            C = torch.cat([upd, k[:, None], C[:, i + 1 :]], 1)
        else:
            C = torch.cat([k[:, None], C[:, 1:]], 1)
        err = (err * (one - ((k * k) >> Q)).clamp(min=1)) >> Q
        o = i + 1
        if o not in orders:
            continue
        c_max = C[:, :o].abs().amax(1)
        c_ok = (c_max > 0) & (c_max < (1 << 48))
        sc = (B * _log2_q8(err.clamp(min=1))) >> 1
        sc = torch.where(c_ok, sc + ((9 + o * s.lpc_precision) << 8), 1 << 62)
        if score is None:
            score, order = sc, torch.full_like(sc, o)
            coeffs, cmax, ok = C, c_max, c_ok
        else:
            better = sc < score
            score = torch.where(better, sc, score)
            order = torch.where(better, o, order)
            coeffs = torch.where(better[:, None], C, coeffs)
            cmax = torch.where(better, c_max, cmax)
            ok = ok | c_ok
    prec = s.lpc_precision
    shift = ((prec - 1) - (_bitlen(cmax) - 1 - Q + 1)).clamp(0, 15)
    qmax, qmin = (1 << (prec - 1)) - 1, -(1 << (prec - 1))
    fb = torch.zeros_like(cmax)
    qs = []
    for j in range(mo):
        target = (coeffs[:, j] << shift) + fb
        q = ((target + (1 << (Q - 1))) >> Q).clamp(qmin, qmax)
        fb = target - (q << Q)
        qs.append(torch.where(j < order, q, 0))
    return order, torch.stack(qs, 1), shift, ok


def lpc_residuals(x: torch.Tensor, q: torch.Tensor, shift: torch.Tensor, order: torch.Tensor):
    """r[i] = x[i] - (sum_j q_j x[i-1-j] >> shift) for i >= order, the first
    ``order`` zeroed; ``fits``: every residual in int32."""
    P, B = x.shape
    pred = torch.zeros_like(x)
    for j in range(q.shape[1]):
        pred[:, j + 1 :] += q[:, j : j + 1] * x[:, : B - j - 1]
    res = x - (pred >> shift[:, None])
    idx = torch.arange(B, device=x.device)
    res = torch.where(idx < order[:, None], 0, res)
    fits = ((res <= (1 << 31) - 1) & (res >= -(1 << 31))).all(1)
    return res, fits


# -- subframe choice (Encoder.zig:320-376) --------------------------------------


@dataclass
class Subframes:
    """Decisions for planes [P, B]: kind, estimated bits, order, residuals
    and their Rice coding, LPC coefficients and shift."""
    kind: torch.Tensor
    est: torch.Tensor
    order: torch.Tensor
    res: torch.Tensor
    part_order: torch.Tensor
    params: torch.Tensor
    method: torch.Tensor
    qcoeffs: torch.Tensor
    shift: torch.Tensor


def choose(x: torch.Tensor, bits_of_t: int, depth: int, s: Settings) -> Subframes:
    P, B = x.shape
    dev = x.device
    const = (x[:, 1:] == x[:, :1]).all(1) if B > 1 else torch.ones(P, dtype=torch.bool, device=dev)
    verbatim_bits = B * bits_of_t
    lpc_order = s.lpc_order if s.prediction == "lpc" else 0
    zeros = torch.zeros(P, dtype=I64, device=dev)
    top = min(s.max_rice_order, _ctz(B))
    out = Subframes(
        kind=torch.where(const, CONSTANT, VERBATIM),
        est=torch.where(const, bits_of_t, verbatim_bits).to(I64),
        order=zeros.clone(), res=torch.zeros_like(x), part_order=zeros.clone(),
        params=torch.zeros(P, 1 << top, dtype=I64, device=dev), method=zeros.clone(),
        qcoeffs=torch.zeros(P, max(lpc_order, 1), dtype=I64, device=dev), shift=zeros.clone())
    if B <= max(MAX_FIXED_ORDER, lpc_order) or s.prediction == "none":
        return out
    wide = not (depth < 28 and bits_of_t == 32)
    order, res = fixed_search(x, wide)
    usable = order >= 0
    order = order.clamp(min=0)
    bits, po, params, method = rice_choice(res, order, depth, s)
    best_bits = torch.where(usable, bits, I64_MAX)
    best_kind = torch.full_like(order, FIXED)
    best = dict(order=order, res=res, po=po, params=params, method=method)
    qc = out.qcoeffs
    shift = zeros
    if s.prediction == "lpc":
        l_ord, l_q, l_shift, l_ok = lpc_analysis(x, s)
        l_res, fits = lpc_residuals(x, l_q, l_shift, l_ord)
        l_ok = l_ok & fits
        l_bits, l_po, l_params, l_method = rice_choice(l_res, l_ord, depth, s)
        l_cost = l_bits + 9 + l_ord * s.lpc_precision
        take = l_ok & (l_cost < best_bits)
        best_bits = torch.where(take, l_cost, best_bits)
        best_kind = torch.where(take, LPC, best_kind)
        best = dict(order=torch.where(take, l_ord, order),
                    res=torch.where(take[:, None], l_res, res),
                    po=torch.where(take, l_po, po),
                    params=torch.where(take[:, None], l_params, params),
                    method=torch.where(take, l_method, method))
        qc, shift = torch.where(take[:, None], l_q, 0), torch.where(take, l_shift, 0)
        usable = usable | take
    pred = ~const & usable & (best_bits < verbatim_bits)
    out.kind = torch.where(pred, best_kind, out.kind)
    out.est = torch.where(pred, best_bits, out.est)
    out.order = torch.where(pred, best["order"], 0)
    out.res = torch.where(pred[:, None], best["res"], 0)
    out.part_order = torch.where(pred, best["po"], 0)
    out.params = torch.where(pred[:, None], best["params"], 0)
    out.method = torch.where(pred, best["method"], 0)
    out.qcoeffs = torch.where(pred[:, None] & (out.kind == LPC)[:, None], qc, 0)
    out.shift = torch.where(pred & (out.kind == LPC), shift, 0)
    return out


@dataclass
class FramePlan:
    """One group of frames of ``B`` samples: the channel code of each frame
    [F], and its wire subframes [F, W] (planes, their sample sizes and the
    decisions, flattened frame-major)."""
    B: int
    ch_code: torch.Tensor
    planes: torch.Tensor     # [F * W, B]
    sample_size: torch.Tensor  # [F * W]
    sub: Subframes
    W: int
    frame0: int = 0
    prec: int = 0


def _take(sub: Subframes, idx: torch.Tensor) -> Subframes:
    return Subframes(**{k: getattr(sub, k)[idx] for k in Subframes.__dataclass_fields__})


def plan_group(frames: torch.Tensor, depth: int, s: Settings) -> FramePlan:
    """processChannels (Encoder.zig:233-317) for frames [F, C, B] int64."""
    F, C, B = frames.shape
    if s.channels != "stereo_auto":
        sub = choose(frames.reshape(F * C, B), 32, depth, s)
        ss = torch.full((F * C,), depth, dtype=I64, device=frames.device)
        return FramePlan(B, torch.full((F,), C - 1, dtype=I64, device=frames.device),
                         frames.reshape(F * C, B), ss, sub, C)
    left, right = frames[:, 0], frames[:, 1]
    mid, side = (left + right) >> 1, left - right
    side_t = 64 if depth == 32 else 32
    lr = choose(torch.cat([left, right, mid]), 32, depth, s)
    sd = choose(side, side_t, depth, s)
    eL, eR, eM = lr.est[:F], lr.est[F : 2 * F], lr.est[2 * F :]
    sums = torch.stack([eL + eR, eL + sd.est, sd.est + eR, eM + sd.est], 1)
    ch = torch.zeros(F, dtype=I64, device=frames.device)
    best = sums[:, 0]
    for m in (1, 2, 3):
        better = sums[:, m] < best
        best = torch.where(better, sums[:, m], best)
        ch = torch.where(better, m, ch)
    # every plane in one list: L, R, M (0..3F), S (3F..4F)
    allsub = Subframes(**{k: torch.cat([getattr(lr, k), getattr(sd, k)])
                          for k in Subframes.__dataclass_fields__})
    planes = torch.cat([left, right, mid, side])
    f = torch.arange(F, device=frames.device)
    L, R, M, S = f, F + f, 2 * F + f, 3 * F + f
    first = torch.stack([L, L, S, M])[ch, f]
    second = torch.stack([R, S, R, S])[ch, f]
    idx = torch.stack([first, second], 1).reshape(-1)
    ss = torch.where(idx >= 3 * F, depth + 1, depth)
    return FramePlan(B, torch.where(ch == 0, 1, ch + 7), planes[idx], ss, _take(allsub, idx), 2)


# -- the bit stream ------------------------------------------------------------


def utf8_number(n: int) -> bytes:
    if n <= 0x7F:
        return bytes([n])
    out = []
    first_max = 0x3F
    while n > first_max:
        out.append(0x80 | (n & 0x3F))
        n >>= 6
        first_max >>= 1
    lead = (0xFE << (6 - len(out))) & 0xFF | n
    return bytes([lead] + out[::-1])


def frame_header(B: int, rate: int, ch_code: int, depth: int, number: int) -> bytes:
    """Frame header with its CRC-8 (FrameWriter.zig:136-247), the uncommon
    rate's field carrying the block size as the upstream encoder writes it."""
    bits = [(16, 0xFFF8)]
    tail = []
    c = _ctz(B)
    if B == (1 << c) and 8 <= c <= 15:
        bits.append((4, c))
    elif B == 192:
        bits.append((4, 1))
    elif (B >> c) == 144 and 2 <= c <= 5:
        bits.append((4, c))
    elif B < 0x100:
        bits.append((4, 0b0110))
        tail.append((8, B - 1))
    else:
        bits.append((4, 0b0111))
        tail.append((16, B - 1))
    if rate in RATE_CODES:
        bits.append((4, RATE_CODES[rate]))
        rtail = []
    elif rate <= 255:
        bits.append((4, 12))
        rtail = [(8, B & 0xFF)]
    elif rate <= 65535:
        bits.append((4, 13))
        rtail = [(16, B & 0xFFFF)]
    else:
        bits.append((4, 14))
        rtail = [(16, (B // 10) & 0xFFFF)]
    bits += [(4, ch_code), (4, DEPTH_CODES.get(depth, 0))]
    v, n = 0, 0
    for w, x in bits:
        v, n = (v << w) | x, n + w
    head = v.to_bytes(n // 8, "big") + utf8_number(number)
    v, n = 0, 0
    for w, x in tail + rtail:
        v, n = (v << w) | x, n + w
    head += v.to_bytes(n // 8, "big") if n else b""
    return head + bytes([crc8(head)])


class Fields:
    """Bit fields gathered out of order, then sorted into the stream by an
    int64 key (frame, subframe, slot): ``width`` bits end at the field's
    end, the last ``pw`` of them holding ``value`` (a Rice code's quotient
    is the zeros before them)."""

    def __init__(self, device):
        self.parts = []
        self.device = device

    def add(self, key, width, value, pw=None):
        key = torch.as_tensor(key, device=self.device)
        width = torch.as_tensor(width, dtype=I64, device=self.device).expand_as(key)
        value = torch.as_tensor(value, dtype=I64, device=self.device).expand_as(key)
        pw = width if pw is None else torch.as_tensor(pw, dtype=I64, device=self.device).expand_as(key)
        self.parts.append((key.reshape(-1), width.reshape(-1), value.reshape(-1), pw.reshape(-1)))

    def sorted(self):
        key, width, value, pw = (torch.cat(t) for t in zip(*self.parts))
        order = torch.sort(key, stable=True).indices
        return key[order], width[order], value[order], pw[order]


SUB_SHIFT = 20          # slot bits below the subframe (slots < 128 + 8 * 65536)
FRAME_SHIFT = SUB_SHIFT + 4


def subframe_fields(fd: Fields, plan: FramePlan, frame0: int):
    """Every subframe's bits (FrameWriter.zig:260-377) as keyed fields."""
    sub, B, W = plan.sub, plan.B, plan.W
    n = sub.kind.shape[0]
    dev = sub.kind.device
    s_idx = torch.arange(n, device=dev)
    base = ((frame0 + s_idx // W) << FRAME_SHIFT) + ((1 + s_idx % W) << SUB_SHIFT)
    ss = plan.sample_size
    head = torch.stack([torch.zeros_like(sub.order), torch.full_like(sub.order, 2),
                        (8 | sub.order) << 1, (0x20 | (sub.order - 1)) << 1])
    fd.add(base, 8, head.gather(0, sub.kind[None])[0])
    x = plan.planes
    kind = sub.kind
    # constant: the first sample; verbatim: every sample; warm-up samples
    c = kind == CONSTANT
    fd.add(base[c] + 1, ss[c], x[c, 0] & ((1 << ss[c]) - 1))
    v = kind == VERBATIM
    if bool(v.any()):
        j = torch.arange(B, device=dev)
        fd.add(base[v, None] + 1 + j, ss[v, None], x[v] & ((1 << ss[v, None]) - 1))
    p = kind >= FIXED
    if not bool(p.any()):
        return
    bp, ssp, xp, order = base[p], ss[p], x[p], sub.order[p]
    mo = int(order.max())
    j = torch.arange(mo, device=dev)
    warm = j < order[:, None]
    fd.add((bp[:, None] + 1 + j)[warm], ssp[:, None].expand(-1, mo)[warm],
           (xp[:, :mo] & ((1 << ssp[:, None]) - 1))[warm])
    lp = sub.kind[p] == LPC
    if bool(lp.any()):
        prec = plan.prec
        bl, ol = bp[lp], order[lp]
        fd.add(bl + 40, 4, prec - 1)
        fd.add(bl + 41, 5, sub.shift[p][lp])
        q = sub.qcoeffs[p][lp]
        jq = torch.arange(q.shape[1], device=dev)
        live = jq < ol[:, None]
        fd.add((bl[:, None] + 42 + jq)[live], prec, (q & ((1 << prec) - 1))[live])
    # residuals: method and partition order, then each partition
    po, method, params = sub.part_order[p], sub.method[p], sub.params[p]
    fd.add(bp + 80, 6, (method << 4) | po)
    res = sub.res[p]
    P = res.shape[0]
    ps = B >> po                                   # partition size
    parts = 1 << po
    top = params.shape[1]
    pi = torch.arange(top, device=dev)
    live_part = pi < parts[:, None]
    # params are stored at the finest grid: partition q of order po is
    # params[:, q << (top_order - po)]
    top_order = top.bit_length() - 1
    par = params.gather(1, (pi[None, :] << (top_order - po[:, None])).clamp(max=top - 1))
    esc_code = torch.where(method == 1, 31, 15)
    escape = par == esc_code[:, None]
    i = torch.arange(B, device=dev)
    written = i[None, :] >= torch.minimum(order, ps)[:, None]
    part_of = i[None, :] // ps[:, None]
    # the escaped partitions' widths: bits of the largest magnitude, plus sign
    r32 = res
    mag = r32 ^ (r32 >> 63)
    start = torch.where(pi[None, :] == 0, torch.minimum(order, ps)[:, None], pi[None, :] * ps[:, None])
    or_mag = torch.zeros(P, top, dtype=I64, device=dev)
    or_all = torch.zeros(P, top, dtype=I64, device=dev)
    wi = written & (part_of < top)
    rows = torch.arange(P, device=dev)[:, None].expand(-1, B)
    flat = rows[wi] * top + part_of[wi]
    or_mag.view(-1).scatter_reduce_(0, flat, mag[wi], "amax")
    or_all.view(-1).scatter_add_(0, flat, (r32[wi] != 0).long())
    bps = torch.where(or_all == 0, 0, torch.where(or_mag == 0, 1, _bitlen(or_mag) + 1))
    fallback = escape & (bps >= 32)   # no 32-bit escape: Rice parameter 30
    par = torch.where(fallback, 30, par)
    escape = escape & ~fallback
    plen = method + 4
    # slots: partition 0's code and width at 8 * start (+1), a later
    # partition's at +2 (+3), residual i at 8 * i + 4; partition 0 may hold
    # no residual and start where partition 1 does
    hkey = bp[:, None] + 128 + 8 * start + torch.where(pi == 0, 0, 2)[None, :]
    fd.add(hkey[live_part], plen[:, None].expand(-1, top)[live_part], par[live_part])
    e = escape & live_part
    fd.add(hkey[e] + 1, 5, bps[e])
    k = par.gather(1, part_of.clamp(max=top - 1))
    esc_i = escape.gather(1, part_of.clamp(max=top - 1)) & written
    rice_i = written & ~esc_i
    rkey = bp[:, None] + 128 + 8 * i[None, :] + 4
    bw = bps.gather(1, part_of.clamp(max=top - 1))
    fd.add(rkey[esc_i], bw[esc_i], res[esc_i] & ((1 << bw[esc_i]) - 1))
    z = zigzag(res)
    kr, zr = k[rice_i], z[rice_i]
    fd.add(rkey[rice_i], (zr >> kr) + kr + 1, (1 << kr) | (zr & ((1 << kr) - 1)), kr + 1)


def deposit(total_bytes: int, start: torch.Tensor, width: torch.Tensor, value: torch.Tensor,
            pw: torch.Tensor) -> torch.Tensor:
    """OR every field's payload into a zeroed byte buffer: the payload's
    ``pw`` bits (at most 32) end where the field ends."""
    dev = start.device
    buf = torch.zeros(total_bytes + 8, dtype=I64, device=dev)
    p = start + width - pw
    b, r = p >> 3, p & 7
    word = (value & ((1 << pw) - 1)) << (40 - r - pw)
    for j in range(5):
        buf.index_add_(0, b + j, (word >> (32 - 8 * j)) & 0xFF)
    return buf[:total_bytes]


def crc16_frames(buf: torch.Tensor, off: torch.Tensor, length: torch.Tensor,
                 block: int = 1 << 22) -> torch.Tensor:
    """CRC-16 of every frame's bytes [off, off + length): the XOR over each
    frame of its bytes' distance-table entries, taken bit by bit as the
    parity of per-frame sums."""
    dev = buf.device
    F = off.shape[0]
    table = torch.from_numpy(crc16_distance_table(int(length.max()))).to(dev)
    fid = torch.repeat_interleave(torch.arange(F, device=dev), length)
    first = torch.repeat_interleave(off, length)
    pos = torch.arange(fid.shape[0], device=dev) - torch.repeat_interleave(
        torch.cumsum(length, 0) - length, length)
    dist = length[fid] - 1 - pos
    bit = torch.arange(16, device=dev)
    counts = torch.zeros(F, 16, dtype=I64, device=dev)
    for a in range(0, fid.shape[0], block):
        v = table[dist[a : a + block], buf[first[a : a + block] + pos[a : a + block]]]
        counts.index_add_(0, fid[a : a + block], (v[:, None] >> bit) & 1)
    return ((counts & 1) << bit).sum(1)


# -- the stream ------------------------------------------------------------------


def plan_frames(pcm: torch.Tensor, depth: int, s: Settings, chunk: int = 512) -> List[FramePlan]:
    """Decisions for every frame of planar ``pcm`` [C, n] int64: full frames
    in groups of ``chunk`` (so the work fits), then the ragged tail."""
    C, n = pcm.shape
    B = s.block_size
    nf = n // B
    out = []
    for f0 in range(0, nf, chunk):
        f1 = min(nf, f0 + chunk)
        frames = pcm[:, f0 * B : f1 * B].reshape(C, f1 - f0, B).transpose(0, 1)
        out.append(plan_group(frames, depth, s))
        out[-1].frame0 = f0
    if n - nf * B:
        out.append(plan_group(pcm[:, nf * B :][None], depth, s))
        out[-1].frame0 = nf
    for p in out:
        p.prec = s.lpc_precision
    return out


def frames_bytes(plans: List[FramePlan], rate: int, depth: int) -> List[bytes]:
    """The frames of each group, header to CRC-16, as one list of bytes."""
    frames: List[bytes] = []
    for plan in plans:
        dev = plan.planes.device
        F = plan.ch_code.shape[0]
        fd = Fields(dev)
        heads = [frame_header(plan.B, rate, int(c), depth, plan.frame0 + f)
                 for f, c in enumerate(plan.ch_code.tolist())]
        hb = [torch.tensor(list(h), dtype=I64) for h in heads]
        hl = torch.tensor([len(h) for h in heads])
        hf = torch.repeat_interleave(torch.arange(F), hl)
        hj = torch.cat([torch.arange(int(x)) for x in hl])
        fd.add(((plan.frame0 + hf) << FRAME_SHIFT) + hj.to(I64), 8, torch.cat(hb))
        subframe_fields(fd, plan, plan.frame0)
        key, width, value, pw = fd.sorted()
        key, width, value, pw = key.to(dev), width.to(dev), value.to(dev), pw.to(dev)
        fid = (key >> FRAME_SHIFT) - plan.frame0
        bits = torch.zeros(F, dtype=I64, device=dev).index_add_(0, fid, width)
        nbytes = (bits + 7) >> 3
        flen = nbytes + 2
        foff = torch.cumsum(flen, 0) - flen
        csum = torch.cumsum(width, 0) - width          # start of each field, stream-wide
        fstart = torch.zeros(F, dtype=I64, device=dev).scatter_reduce_(
            0, fid, csum, "amin", include_self=False)
        start = csum - fstart[fid] + 8 * foff[fid]
        total = int(flen.sum())
        buf = deposit(total, start, width, value, pw)
        crc = crc16_frames(buf, foff, nbytes)
        end = foff + nbytes
        buf[end] = crc >> 8
        buf[end + 1] = crc & 0xFF
        data = buf.to(torch.uint8).cpu().numpy().tobytes()
        offs, lens = foff.tolist(), flen.tolist()
        frames += [data[o : o + ln] for o, ln in zip(offs, lens)]
    return frames


def streaminfo(rate: int, channels: int, depth: int, n: int, block: int,
               sizes: List[int], md5: bytes) -> bytes:
    """fLaC + STREAMINFO (metadata.zig:42-68); a frame that raises the
    largest size never lowers the smallest in the same step (metadata.zig:35-40)."""
    lo, hi = (1 << 24) - 1, 0
    for sz in sizes:
        if sz > hi:
            hi = sz
        elif sz < lo:
            lo = sz
    v = block
    v = (v << 16) | block
    v = (v << 24) | lo
    v = (v << 24) | hi
    v = (v << 20) | rate
    v = (v << 3) | (channels - 1)
    v = (v << 5) | (depth - 1)
    v = (v << 36) | n
    return b"fLaC" + bytes([0]) + (34).to_bytes(3, "big") + v.to_bytes(18, "big") + md5


def vorbis_comment(last: bool = True) -> bytes:
    body = len(VENDOR).to_bytes(4, "little") + VENDOR + (0).to_bytes(4, "little")
    return bytes([(0x80 if last else 0) | 4]) + len(body).to_bytes(3, "big") + body


KIND_NAMES = {CONSTANT: "constant", VERBATIM: "verbatim", FIXED: "fixed", LPC: "lpc"}
CHANNEL_NAMES = {1: "independent", 8: "left-side", 9: "right-side", 10: "mid-side"}


def count_plans(plans: List[FramePlan], tally) -> None:
    """Add each wire subframe's kind and order (``fixed2``, ``lpc8``,
    ``constant``) and each frame's channel mode to the Counter ``tally``."""
    for p in plans:
        key = p.sub.kind * 64 + torch.where(p.sub.kind >= FIXED, p.sub.order, 0)
        for k, c in zip(*[t.tolist() for t in torch.unique(key, return_counts=True)]):
            kind, order = KIND_NAMES[k // 64], k % 64
            tally["subframe " + (f"{kind}{order}" if k // 64 >= FIXED else kind)] += c
        for k, c in zip(*[t.tolist() for t in torch.unique(p.ch_code, return_counts=True)]):
            tally["frame " + CHANNEL_NAMES.get(k, f"channels{k + 1}")] += c


def describe(tally, ratio: float) -> str:
    """One line: the compression ratio and the shares of the tally."""
    parts = []
    for group in ("subframe", "frame"):
        items = {k: v for k, v in tally.items() if k.startswith(group + " ")}
        total = sum(items.values()) or 1
        parts.append(f"{group}s: " + ", ".join(
            f"{k.split(' ', 1)[1]} {100.0 * v / total:.2f}%" for k, v in sorted(items.items())))
    return f"reference streams: FLAC/WAV bytes {ratio:.4f}; " + "; ".join(parts)


def encode_parts(pcm: torch.Tensor, rate: int, depth: int, settings: Dict, raw_pcm,
                 chunk: int = 512, tally=None):
    """(metadata bytes, [frame bytes, ...]) of planar ``pcm`` [C, n] (int64,
    on any device) whose little-endian interleaved bytes are ``raw_pcm``:
    fLaC, STREAMINFO and the VorbisComment, then every frame. ``tally``, a
    Counter, gets the stream's subframe kinds and channel modes."""
    s = Settings.of(settings)
    if depth > 24:
        raise ValueError("the reference covers depths up to 24 bits")
    C, n = pcm.shape
    plans = plan_frames(pcm, depth, s, chunk)
    if tally is not None:
        count_plans(plans, tally)
    frames = frames_bytes(plans, rate, depth)
    head = streaminfo(rate, C, depth, n, s.block_size, [len(f) for f in frames],
                      hashlib.md5(raw_pcm).digest())
    return head + vorbis_comment(), frames


def encode(pcm: torch.Tensor, rate: int, depth: int, settings: Dict, raw_pcm,
           chunk: int = 512) -> bytes:
    """The whole FLAC stream (``encode_parts`` joined)."""
    head, frames = encode_parts(pcm, rate, depth, settings, raw_pcm, chunk)
    return head + b"".join(frames)


def decode_samples(pcm: torch.Tensor, depth: int, settings: Dict, dtype=torch.int64,
                   chunk: int = 512) -> torch.Tensor:
    """Planar samples [C, n] restored from the reference's own decisions for
    ``pcm`` (what a decoder reads from the stream those decisions make),
    the prediction summed in ``dtype``: ``pcm`` again in int64."""
    s = Settings.of(settings)
    out = []
    for plan in plan_frames(pcm, depth, s, chunk):
        F = plan.ch_code.shape[0]
        w = synthesize(plan, dtype).reshape(F, plan.W, plan.B)
        if plan.W == 2 and s.channels == "stereo_auto":
            a, b = w[:, 0], w[:, 1]
            code = plan.ch_code[:, None]
            m2 = (a << 1) | (b & 1)
            left = torch.where(code == 9, a + b, torch.where(code == 10, (m2 + b) >> 1, a))
            right = torch.where(code == 8, a - b, torch.where(code == 10, (m2 - b) >> 1, b))
            w = torch.stack([left, right], 1)
        out.append(w.transpose(0, 1).reshape(w.shape[1], -1))
    return torch.cat(out, 1)


def synthesize(plan: FramePlan, dtype=torch.int64) -> torch.Tensor:
    """The samples of a group's wire subframes [F * W, B] back from their
    decisions, the prediction summed in ``dtype``: exact in int64; float32
    is the decode cell's control (a prediction sum past 2^24 rounds)."""
    sub, B = plan.sub, plan.B
    x = plan.planes
    out = torch.where((sub.kind <= VERBATIM)[:, None], x, 0).clone()
    pred = sub.kind >= FIXED
    if not bool(pred.any()):
        return out
    fixed_taps = torch.tensor([[0, 0, 0, 0], [1, 0, 0, 0], [2, -1, 0, 0], [3, -3, 1, 0],
                               [4, -6, 4, -1]], dtype=I64, device=x.device)
    mo = max(4, sub.qcoeffs.shape[1])
    taps = torch.zeros(x.shape[0], mo, dtype=I64, device=x.device)
    taps[:, :4] = fixed_taps[sub.order.clamp(max=4)]
    lpc = sub.kind == LPC
    taps[lpc] = 0
    taps[lpc, : sub.qcoeffs.shape[1]] = sub.qcoeffs[lpc]
    shift = torch.where(lpc, sub.shift, 0)
    rows = pred.nonzero()[:, 0]
    y = torch.zeros(len(rows), B, dtype=I64, device=x.device)
    order = sub.order[rows]
    y[:, :mo] = torch.where(torch.arange(mo, device=x.device) < order[:, None], x[rows, :mo], 0)
    t, sh, r = taps[rows], shift[rows], sub.res[rows]
    for i in range(B):
        j = min(i, mo)
        hist = y[:, i - j : i].flip(1)
        if dtype == torch.int64:
            acc = (t[:, :j] * hist).sum(1)
        else:
            acc = (t[:, :j].to(dtype) * hist.to(dtype)).sum(1).floor().to(I64)
        y[:, i] = torch.where(i >= order, r[:, i] + (acc >> sh), y[:, i])
    out[rows] = y
    return out
