"""The PCM unpack: a WAV's interleaved little-endian sample bytes into the
int32 ``[n, C, block]`` frames of an encode batch, on the device.

``data`` (uint8 [>= nreal * block * C * nb]) holds ``nreal * block`` sample
frames of ``C`` samples, each ``nb`` container bytes (1-4), as a WAV's data
chunk has them. Each sample is read as ``WavReader.planar_samples`` reads it
(``native.deinterleave``): the bytes in the top of a u32, ``128 >> (8 -
depth)`` subtracted in u32 for ``nb == 1``, an arithmetic shift by ``32 -
depth`` unless ``depth == 32``. Frame ``f`` of row ``r`` is sample frame ``r
* block + f``; rows ``nreal..n-1`` repeat row ``nreal - 1`` (the bucket
padding of ``DevicePipeline.dispatch_batch``).

``unpack_pcm`` routes by device: a CUDA tensor launches the hand-written
kernel ``zf_unpack_pcm`` (``csrc/unpack.cu``) or raises, a CPU tensor takes
``unpack_pcm_plain``. ``KERNEL_LAUNCHES`` and ``PLAIN_CALLS`` count each.
"""

from __future__ import annotations

import torch

KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0


def reset_counts() -> None:
    global KERNEL_LAUNCHES, PLAIN_CALLS
    KERNEL_LAUNCHES = 0
    PLAIN_CALLS = 0


def unpack_pcm_plain(data: torch.Tensor, channels: int, nb: int, depth: int, block: int,
                     nreal: int, n: int) -> torch.Tensor:
    """``unpack_pcm`` as plain torch ops, in int64."""
    b = data[: nreal * block * channels * nb].reshape(nreal, block, channels, nb).to(torch.int64)
    v = b[..., 0] << (8 * (4 - nb))
    for k in range(1, nb):
        v |= b[..., k] << (8 * (4 - nb + k))
    if nb == 1:
        v = (v - (128 >> (8 - depth))) & 0xFFFFFFFF
    v -= (v >> 31) << 32  # the u32 bit pattern as an int32 value
    if depth != 32:
        v >>= 32 - depth
    frames = v.to(torch.int32).transpose(1, 2)  # [nreal, C, block]
    if n > nreal:
        frames = torch.cat([frames, frames[-1:].expand(n - nreal, -1, -1)])
    return frames.contiguous()


def unpack_pcm(data: torch.Tensor, channels: int, nb: int, depth: int, block: int,
               nreal: int, n: int) -> torch.Tensor:
    """int32 [n, channels, block]: the frames of ``data``'s first ``nreal *
    block`` sample frames, padded to ``n`` rows (module docstring)."""
    global KERNEL_LAUNCHES, PLAIN_CALLS
    if data.dtype != torch.uint8 or data.dim() != 1 or not data.is_contiguous():
        raise TypeError(f"data must be contiguous uint8 [bytes], got {data.dtype} "
                        f"{tuple(data.shape)}")
    if not (1 <= channels <= 8 and 1 <= nb <= 4 and 1 <= depth <= min(8 * nb, 32)):
        raise ValueError(f"unsupported layout: {channels} channels, {nb} bytes a sample, "
                         f"depth {depth}")
    if not (block >= 1 and 1 <= nreal <= n):
        raise ValueError(f"need block >= 1 and 1 <= nreal <= n, got {block}, {nreal}, {n}")
    if data.numel() < nreal * block * channels * nb:
        raise ValueError(f"{data.numel()} bytes hold fewer than {nreal} x {block} sample "
                         f"frames of {channels} x {nb} bytes")
    if data.device.type == "cpu":
        PLAIN_CALLS += 1
        return unpack_pcm_plain(data, channels, nb, depth, block, nreal, n)
    if data.device.type != "cuda":
        raise NotImplementedError(f"no PCM unpack kernel for device {data.device}")
    from ._build import library

    lib = library()
    out = torch.empty((n, channels, block), dtype=torch.int32, device=data.device)
    with torch.cuda.device(data.device):
        err = lib.zf_unpack_pcm(data.data_ptr(), out.data_ptr(), channels, nb, depth, block,
                                nreal, n, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"PCM unpack kernel launch failed: "
                           f"{lib.zf_error_string(err).decode()}")
    KERNEL_LAUNCHES += 1
    return out
