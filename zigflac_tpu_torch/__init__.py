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
VorbisComment (+ SEEKTABLE, PADDING, PICTURE, CUESHEET); bytes in memory
(``encode_wav_bytes``), file to file with O(device batch) host memory
(``encode_file``), many files fused into shared device batches
(``encode_files``, ``encode_wav_bytes_many``), native FLAC or Ogg-FLAC
output, and the ``wav2flac`` CLI's encode modes
(``python -m zigflac_tpu_torch.cli``). Not covered yet: the decoder.
"""

from .metadata import StreamInfo
from .models.encoder import (
    Encoder,
    encode_file,
    encode_file_streaming,
    encode_files,
    encode_to_file,
    encode_wav_bytes,
    encode_wav_bytes_many,
)
from .utils.config import EncoderConfig
from .wav import WavFormatError, WavReader, WavStreamReader

__all__ = [
    "Encoder",
    "EncoderConfig",
    "StreamInfo",
    "WavFormatError",
    "WavReader",
    "WavStreamReader",
    "encode_file",
    "encode_file_streaming",
    "encode_files",
    "encode_to_file",
    "encode_wav_bytes",
    "encode_wav_bytes_many",
]
