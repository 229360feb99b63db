"""Encoder orchestrator — the wav2flac session on a torch device.

Mirrors the reference session protocol (src/wav2flac.zig:11-78): metadata
header + VorbisComment, per-frame encode, MD5 over the raw PCM byte stream,
min/max frame-size tracking, and the finalized STREAMINFO written first in
the output. Every frame, ragged tail included, goes through
``models/pipeline.DevicePipeline`` on the given device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import native
from ..metadata import (
    StreamInfo,
    build_seekpoints,
    padding_block,
    seek_table_block,
    set_last_flag,
    streaminfo_block,
    vorbis_comment_block,
)
from ..utils.config import EncoderConfig
from ..wav import WavReader, reconstruct_raw_bytes
from .pipeline import TAIL_DEVICE_MIN, DevicePipeline


class Encoder:
    """FLAC stream encoder over planar int32 samples.

    Surface of the reference ``libFLAC.Encoder`` (libFLAC/Encoder.zig:55-419):
    construct with a config, a bit depth and a device (the card unless the
    caller asks for the CPU), then ``encode_stream`` produces the complete
    FLAC byte stream (signature, STREAMINFO, VorbisComment, frames).
    """

    def __init__(
        self,
        config: EncoderConfig,
        bit_depth: int,
        device: torch.device = "cuda",
    ) -> None:
        self.config = config
        self.bit_depth = bit_depth
        self.pipeline = DevicePipeline(config, bit_depth, device)

    def encode_stream(
        self,
        samples: np.ndarray,
        info: StreamInfo,
        raw_pcm_bytes: Optional[bytes] = None,
        tags: Optional[List] = None,
        seek_interval: Optional[int] = None,
        padding: int = 0,
        extra_metadata: Optional[List[bytes]] = None,
    ) -> bytes:
        """Planar ``[channels, n] int32`` -> complete FLAC stream.

        ``raw_pcm_bytes`` is the little-endian interleaved byte stream the
        STREAMINFO MD5 covers; when None it is reconstructed from samples.
        ``seek_interval`` (samples) adds a SEEKTABLE block with a point at
        most every that many samples; ``padding`` adds a PADDING block of
        that many zero bytes; ``extra_metadata`` takes pre-built blocks
        (built with is_last=False) — the last-block flag is fixed up here.
        """
        if seek_interval is not None and seek_interval <= 0:
            raise ValueError(f"seek_interval must be positive, got {seek_interval}")
        c, n = samples.shape
        block = self.config.block_size
        n_full = n // block
        rem = n - n_full * block
        md5_box = {}

        def _md5_work():
            # the MD5 runs while the device encodes the dispatched batches
            raw = (raw_pcm_bytes if raw_pcm_bytes is not None
                   else reconstruct_raw_bytes(samples, self.bit_depth))
            md5_box["md5"] = native.md5(raw)

        batch = samples[:, : n_full * block].reshape(c, n_full, block).transpose(1, 0, 2)
        stream, sizes = self.pipeline.encode_frames_stream(
            batch, 0, info,
            tail=samples[:, n_full * block :] if rem >= TAIL_DEVICE_MIN else None,
            overlap_work=_md5_work,
        )
        info.update_frame_sizes(sizes)
        info.md5 = md5_box["md5"]

        blocks = [streaminfo_block(info, is_last=False)]
        if seek_interval:
            pts = build_seekpoints(sizes, block, seek_interval, info.interchannel_samples)
            blocks.append(seek_table_block(pts, is_last=False))
        blocks.append(vorbis_comment_block(is_last=False, tags=tags))
        for extra in extra_metadata or []:
            blocks.append(extra)
        if padding > 0:
            blocks.append(padding_block(padding, is_last=False))
        blocks[-1] = set_last_flag(blocks[-1])
        return b"".join(blocks) + stream


def encode_wav_bytes(
    wav_bytes: bytes,
    config: Optional[EncoderConfig] = None,
    *,
    device: torch.device = "cuda",
    tags: Optional[List] = None,
    seek_interval: Optional[int] = None,
    padding: int = 0,
    extra_metadata: Optional[List[bytes]] = None,
) -> bytes:
    """The wav2flac path: WAV bytes in, FLAC bytes out
    (src/main.zig + src/wav2flac.zig), encoded on ``device`` (the card
    unless the caller asks for the CPU; without a card, cuda raises)."""
    wav = WavReader.from_bytes(wav_bytes)
    cfg = config or EncoderConfig.default(wav.channels)
    info = wav.flac_streaminfo(cfg.block_size)
    enc = Encoder(cfg, wav.bit_depth, device)
    return enc.encode_stream(
        wav.planar_samples(), info, raw_pcm_bytes=bytes(wav.raw_pcm_bytes()),
        tags=tags, seek_interval=seek_interval, padding=padding,
        extra_metadata=extra_metadata,
    )
