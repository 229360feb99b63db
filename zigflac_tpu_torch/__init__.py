"""zigflac_tpu_torch — the FLAC codec of ``zigflac_tpu`` on PyTorch and CUDA.

The same encoder as the JAX package beside it, byte for byte, and its
decoder, sample for sample: frames are the batch axis, and every per-frame
decision, the bit packing and the decoder's synthesis run as integer tensor
ops on a ``torch.device``: the CUDA card unless the caller asks for the
CPU. On a CUDA device the bit deposit and the synthesis scan are
hand-written kernels (``csrc/deposit.cu``, ``csrc/synth.cu``); on the CPU
each is its kernel's plain torch version. This package imports neither jax
nor ``zigflac_tpu``.

Covered: fixed prediction (orders 0-4) and LPC (orders 1-32, precision
2-15, one Q8 window or a list of them searched per plane) with ``stereo_auto`` or 1-8 independent channels, depths 8 to 32,
any block size, ragged tails, wasted bits, MD5 + STREAMINFO +
VorbisComment (+ SEEKTABLE, PADDING, PICTURE, CUESHEET); bytes in memory
(``encode_wav_bytes``), file to file with O(device batch) host memory
(``encode_file``), many files fused into shared device batches
(``encode_files``, ``encode_wav_bytes_many``), native FLAC or Ogg-FLAC
output; FLAC or Ogg-FLAC back to PCM with frame CRCs and the STREAMINFO
MD5 checked (``decode_flac``, ``decode_file``, ``decode_range``,
``verify_flac``), the frame bit parse on the host in C++ (built with g++ at
first use); and the ``wav2flac`` CLI's encode, decode, test, list and
verify modes and the metadata editor (``python -m zigflac_tpu_torch.cli``,
``-e``); every batch sharded over several cards or ``torch.distributed``
processes (``parallel/``), byte for byte as on one device.
"""

from .decoder import decode_file, decode_flac, decode_range, verify_flac

from .metadata import BlockType, StreamInfo
from .models.encoder import (
    Encoder,
    encode_file,
    encode_file_streaming,
    encode_files,
    encode_to_file,
    encode_wav_bytes,
    encode_wav_bytes_many,
)
from .utils.apodization import EncoderConfig
from .wav import WavFormatError, WavReader, WavStreamReader

__version__ = "0.1.0"

__all__ = [
    "BlockType",
    "Encoder",
    "EncoderConfig",
    "StreamInfo",
    "WavFormatError",
    "WavReader",
    "WavStreamReader",
    "decode_file",
    "decode_flac",
    "decode_range",
    "encode_file",
    "encode_file_streaming",
    "encode_files",
    "encode_to_file",
    "encode_wav_bytes",
    "encode_wav_bytes_many",
    "verify_flac",
    "__version__",
]
