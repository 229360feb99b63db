"""zigflac_tpu_torch — the FLAC encoder of ``zigflac_tpu`` on PyTorch and CUDA.

The same encoder as the JAX package beside it, byte for byte: frames are
the batch axis, and every per-frame decision and the bit packing run as
integer tensor ops on a ``torch.device``: the CUDA card unless the caller
asks for the CPU. On a CUDA device the bit deposit is a hand-written kernel
(``csrc/deposit.cu``); on the CPU it is the kernel's plain torch version.
This package imports neither jax nor ``zigflac_tpu``.

Covered: fixed prediction (orders 0-4) and LPC (orders 1-32, precision
2-15) with ``stereo_auto`` or 1-8 independent channels, depths 8 to 32,
any block size, ragged tails, wasted bits, MD5 + STREAMINFO +
VorbisComment.
"""

from .metadata import StreamInfo
from .models.encoder import Encoder, encode_wav_bytes
from .utils.config import EncoderConfig
from .wav import WavFormatError, WavReader

__all__ = [
    "Encoder",
    "EncoderConfig",
    "StreamInfo",
    "WavFormatError",
    "WavReader",
    "encode_wav_bytes",
]
