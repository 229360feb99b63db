"""The least time the card could take for a window's codec work: the larger
of its bytes over the HBM rate and its INT32 operations over the INT32 rate.

The work is counted from the algorithm at the window's shapes, never from
what one implementation reads or launches, so a later change that fuses,
removes or moves a kernel leaves the count as it is:

* bytes: each PCM byte once, at its packed width (ceil(depth / 8) bytes a
  sample), as the device receives it on encode or writes it on decode; each
  FLAC frame byte once, written on encode and read on decode;
* operations per channel-sample, below, derived from the FLAC algorithm
  (one INT32 operation per add, subtract, shift, compare-select, absolute
  value or multiply, 64-bit products counted once: a lower count, so the
  share is never overstated).

Peaks of one NVIDIA H100 SXM at its 700 W limit: 3.35 TB/s of HBM
(NVIDIA's data sheet), and 16.7 T INT32 operations a second, which is not a
published figure: 132 SMs x 64 INT32 lanes x 1.98 GHz.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# -- encode, per sample of one plane ------------------------------------------
# the fixed-order search: orders 1-4 as differences (4 subtracts), |e_k| for
# k = 0..4 (5) and their sums (5)
FIXED_SEARCH_OPS = 14
# a chosen order's Rice estimate: zigzag (2) and the partition sum (1)
RICE_ESTIMATE_OPS = 3
# LPC of order p: the window (1), lags 0..p as multiply-adds (2 (p + 1)),
# the residual (2 p multiply-adds, a shift, a subtract) and its Rice
# estimate (3)
def lpc_ops(order: int) -> int:
    return 1 + 2 * (order + 1) + (2 * order + 2) + RICE_ESTIMATE_OPS


# a partition's parameter in closed form, over the 2^(o+1) - 1 partitions of
# orders 0..o
PARTITION_OPS = 10
# mid and side from left and right: an add, a shift and a subtract a pair
STEREO_OPS_PER_PAIR = 3
# a written residual's Rice code: zigzag (2), quotient and low bits (2), its
# length (2), the bit offset's prefix sum (1) and the deposit (2)
PACK_OPS = 9
# CRC-16 of a written byte: a table step
CRC_OPS_PER_BYTE = 4

# -- decode, per channel-sample -------------------------------------------------
# a Rice code read: the unary run (2), the low bits (2), unzigzag (2)
RICE_DECODE_OPS = 6


def synth_ops(order: int) -> int:
    """Restoring a predicted sample: order multiply-adds, a shift, an add."""
    return 2 * order + 2


def _least(nbytes: float, ops: float) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return {"bytes": nbytes, "ops": ops, "s": max(t_bytes, t_ops),
            "bound": "bytes" if t_bytes >= t_ops else "operations"}


def encode_work(samples: int, channels: int, depth: int, frame_bytes: int, cfg: dict) -> dict:
    """Bytes, operations and least seconds of encoding ``samples`` per channel
    of ``channels`` at ``depth`` into ``frame_bytes`` of FLAC frames under
    the encoder settings ``cfg``."""
    stereo = cfg.get("channels") == "stereo_auto" and channels == 2
    planes = 4 if stereo else channels          # planes searched a frame
    cs = samples * channels
    per_plane = FIXED_SEARCH_OPS + RICE_ESTIMATE_OPS
    if cfg.get("prediction") == "lpc":
        per_plane += lpc_ops(cfg["lpc_order"])
    block = cfg["block_size"]
    parts = (2 << cfg["max_rice_order"]) - 1
    frames = -(-samples // block)
    ops = (samples * planes * per_plane
           + frames * planes * parts * PARTITION_OPS
           + (samples * STEREO_OPS_PER_PAIR if stereo else 0)
           + cs * PACK_OPS + frame_bytes * CRC_OPS_PER_BYTE)
    nbytes = cs * ((depth + 7) // 8) + frame_bytes
    return _least(nbytes, ops)


def decode_work(samples: int, channels: int, depth: int, frame_bytes: int, order: int) -> dict:
    """The same for decoding ``frame_bytes`` of frames back into ``samples``
    per channel, the predictor of order ``order`` (the configuration's
    largest) restoring each."""
    cs = samples * channels
    ops = cs * (RICE_DECODE_OPS + synth_ops(order)) + (samples * STEREO_OPS_PER_PAIR
                                                       if channels == 2 else 0)
    nbytes = frame_bytes + cs * ((depth + 7) // 8)
    return _least(nbytes, ops)


def flac_frame_bytes(flac: bytes) -> int:
    """Bytes of a FLAC stream after its metadata blocks."""
    pos = 4
    while True:
        last, length = flac[pos] & 0x80, int.from_bytes(flac[pos + 1 : pos + 4], "big")
        pos += 4 + length
        if last:
            return len(flac) - pos
