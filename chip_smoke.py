"""Smoke run of zigflac_tpu_torch on one CUDA card: build, check, encode,
decode.

    python3 chip_smoke.py

Phases:
  0. torch/CUDA versions and the card's name and power limit; a missing
     card is an error.
  1. Build the CUDA kernels from the package's sources (nvcc, sm_90a) and,
     beside them, the C++ frame parser (g++), both at once. Prints whether
     the host runtime (``native.py``) runs in C++ (``HAVE_NATIVE``) and
     which build it took: the in-place ``_zf_native`` or the port's own.
  2. The deposit kernel against its plain torch version on the card: random
     symbol streams (33- and 64-bit values, masked and odd columns, the
     word-budget clamp, a row too large for shared memory) and the real
     streams of one 1024-frame batch each of config 1, of config 3 (LPC
     coefficient symbols), of the 32-bit input (33-bit side samples) and of
     32-bit white noise at the exact tier (73 KB rows, the kernel's
     global-memory branch). Words must be equal; each is timed with CUDA
     events, and config 1's batch, timed again in turns with the plain
     version, gives the kernel's times and bound. 2-crc: the CRC-16 kernel
     against its plain version (crc16_words + deposit_crc16) on watch cases
     (lengths 0-20, every residue mod 4 and 16, about a round of a frame's
     lanes and about the row's end, frames over the row, rows of one to
     three words and rows that do not start on 16 bytes) and on the same
     four batches' words, the 73 KB exact-tier rows among them, in both
     write modes, and against crc.crc16 of three frames' bytes each; config
     1's batch timed in turns with the plain version, beside its bound.
     2-symbols: the frame symbols kernel against its plain version
     (bitpack.frame_symbol_stream), dep_cum, total_bits, val and nbv all
     equal, on synthetic plans of its watch list (SYMBOL_WATCH: blocks of 1
     to 65,535 samples, 1-8 channels, every subframe kind, escapes and the
     N1 fallback, Rice codes of thousands of bits, frames past 2^32 bits
     with their two widest codes inside a warp's run of columns, across two
     warps' runs and across two tiles, channels whose columns are not a
     multiple of 32, LPC orders up to 32, wasted bits, 33-bit side planes,
     max_rice_order 0-12, every frame-number length and uncommon rates), on
     the analysis's plans of signals at depths 8-32 and 1-8 channels and of
     ROADMAP's N1 input, and on the real plans of the batches above and of
     config 2;
     config 1's batch timed in turns with the plain version, beside
     symbols_bound.
     2-unpack: the PCM unpack kernel against its plain version at every
     depth 4-32 (1-8 channels, bucket rows past nreal, one-sample and
     777-sample tail rows), then on the bytes of the first 1024 frames of
     config 1 (16 bits) and config 2 (24 bits), equal to the host
     de-interleave too, each timed beside its plain version and
     unpack_bound.
     2-analysis: the analysis kernels against their plain versions, every
     output field equal: zf_analyze_fixed on random planes at depths 8-32
     and the 33-bit int64 side plane, a wide-mode disqualification of each
     order, equal, zero and one-sample planes, a first partition of
     negative size (order 3 at B = 512), blocks of 1 to 65535 samples
     (partitions of one 16-sample run, of whole runs, shorter than a run and
     neither), partition orders 0, 4 and 8 with params up to 14 and 30,
     max_rice_order 12 at B = 2304, planes at the narrow arithmetic's limit
     of |x| and one past it; partition order 15 refused (ValueError, as the
     JAX package) by both kernels' wrappers and by an encode at
     max_rice_order 12, before any launch; zf_rice_estimate on partitions
     about half full and all zero, on orders 0-32, on blocks not a multiple
     of 4 and on rows that do not start on 16 bytes; then the planes of one
     batch each of config 1, config 2, config 3 and the 32-bit input as
     analyze_planes hands them over, and config 3's LPC candidate through
     the Rice entry; config 1's batch and the LPC batch timed in turns with
     the plain versions, config 2's 24-bit batch and the 32-bit input's int64
     side plane beside them, with their bounds and ptxas's registers and
     spills of every analysis kernel instance. The synthesis kernel's half
     of this phase (2-synth) runs after phase 6, once the FLAC streams it
     parses exist. Kernel == plain, with the arithmetic that each block
     of 32 subframes chose read back (taps summed, int32 or 64-bit
     multiplies, the tile at which it left int32), on: random subframes
     (orders 0-32, blocks of 1 to 65535 samples, sums that wrap); the
     boundaries of the int32 arithmetic (coefficients at and past +-2^31, a
     sample that leaves int32 in the first tile, inside, at the end and at
     the start of a tile and in a ragged last tile, and comes back; fixed
     predictors with every shift 0; 33-bit verbatim samples); every order
     0-32 against the tap count it must run; order 0 with wasted bits; 16
     and 8 subframes to a block. Then each compiled tap count at M = 1024,
     B = 4096, in int32 and (4, 8, 16, 32 taps) 64-bit arithmetic, equal
     on its first 512 positions and timed, through the wrapper and as
     launches alone; the launch
     shape (32, 16, 8 subframes to a block) and 1024 to 16,896 subframes,
     timed; and the first parsed batch (512 frames) of config 1's FLAC,
     config 3's (LPC), the 32-bit LPC stream's and a 32-bit stream in
     antiphase (33-bit side samples), each equal and timed beside its plain
     version and its bound: through ``synthesize_batch`` (whose range check
     waits for the card) and through the decoder's call, which checks on
     the host and does not wait. Configs 1 and 3 must run in int32 only,
     the antiphase stream must not.
  3. All 22 pinned corpus streams of tests/vectors/corpus (fixed and LPC,
     depths 8 to 32) encoded on the card, byte for byte.
  4. Config 1 at full size: 285 s of 16-bit/44.1 kHz stereo (bench.py's
     recipe, seed 0xBEEF) must give the pinned FLAC bytes. Prints the warm
     wall time, x-realtime, peak device memory, the per-stage CUDA-event
     times the pipeline records (utils/stages.py), the device's busy time
     under torch.profiler, and the host seconds from the first
     dispatch_batch to the last (dispatch_s: every batch and the tail
     dispatched through DevicePipeline's public methods before any is
     collected, as encode_frames_stream does; the frames must equal the
     pinned stream's).
  5. Config 3 at full size: bench.py's config-3 input (1024 frames, LPC)
     and then the 285 s input with LPC must give their pinned bytes. Prints
     the warm wall time, x-realtime, the stage times, and the LPC pieces of
     one batch's analysis (lag sums, Levinson, residuals, Rice estimate;
     the fixed analysis and the LPC Rice estimate as plain ops and as
     kernels); the lag sums kernel (zf_lag_sums) equal to the plain
     lag_sums and timed through its wrapper beside lags_bound, on that
     batch under the one Tukey(0.5) at order 8 and under flac -8's six
     windows at order 12, in its narrow arithmetic and in its limbs; then
     flac -8 on 65 frames through encode_wav_bytes, equal to the CPU
     port's bytes. Then film-5.1-48k-24bit's settings (six independent
     24-bit channels at 48 kHz, flac -8's windows, 15-bit coefficients): a
     1024-frame batch's lag sums (in limbs) and deposit (95,744 B rows, over
     the kernel's shared row) equal to their plain versions and timed beside
     their bounds, its CRC-16, and 24 frames and a tail through
     encode_wav_bytes equal to the CPU port's bytes, every deposit launch on
     the global-memory branch, and back through decode_flac. The film
     batch's times and bounds go into the last lines' lag sums and deposit
     entries (``film_batch``).
  6. Depth 32: bench.py's 32-bit input with fixed and with LPC prediction
     must give the pinned bytes; a batch of 32-bit white noise overflows
     tier 0, re-encodes at the exact tier through the kernel's
     global-memory branch and must equal the port's bytes on the CPU. A
     64-frame 32-bit stream in antiphase is encoded for the decode phases.
  7. Config 2 at full size: bench.py's 24-bit / 96 kHz input (1024 frames,
     43.7 s) through encode_wav_bytes must give the pinned bytes. Prints
     the warm wall time, x-realtime and the stage times.
  8. Config 4: an album directory of 10 WAVs in two format groups (the
     config-1 and config-2 inputs and eight 16-bit tracks of 176-315 s,
     ~37 minutes) through one encode_files call. The config-1 and config-2
     outputs must give their pinned bytes, every other file its in-memory
     encode's. Prints the wall time, x-realtime and the batch, tail and
     mixed-file batch dispatch counts, which must be those of full fusion.
     Then the shortest track as Ogg-FLAC, equal to the CPU port's.
  9. Streaming: a 40-minute WAV (~423 MB, written in pieces; 26 batches)
     through encode_file with a SEEKTABLE, a tag and PADDING must equal its
     in-memory encode.
 10. Decode on the card: decode_flac of the FLAC streams of config 1, config
     2, config 3 and the 32-bit LPC input must give back the samples of the
     WAV each was encoded from, with the MD5 verified. Prints the warm wall
     time, x-realtime, the host parse's seconds, the synthesis kernel's ms
     per batch, how many of its blocks ran in int32 or 64-bit arithmetic
     (configs 1-3: int32 only; the 32-bit antiphase stream, decoded here
     too: not) and the bytes copied each way; beside it config 1 through
     backend="native" (all C++, no device). decode_file of config 1 must
     write the input WAV byte for byte, and decode_range of 10 s from the
     middle of the 40-minute FLAC (by its SEEKTABLE) the WAV's slice.
 11. ``python -m zigflac_tpu_torch.cli`` as subprocesses on the card, six at
     a time: one block (the fixed cost of a process on the card), config 1
     (pinned bytes), the 40-minute file (equal to encode_file's),
     ``--batch`` over the album (equal to phase 8's), ``--ogg`` on config 3
     with LPC (equal to the CPU port's CLI), config 1 with ``--verify``
     (prints ``verify: ok``), ``-d`` on config 1's FLAC (the input WAV byte
     for byte), ``-t`` on it (exit 0), on a copy with a frame byte flipped
     (exit 2) and on one with an MD5 byte flipped (exit 3), ``-l`` (exit
     0), and ``-e`` with ``--remove-tag`` and ``--import-tags-from`` on a
     copy of config 1's FLAC (equal to the in-process edit_metadata_bytes;
     ``-t`` on the edited file must pass). Each subprocess's wall time and
     peak RSS are printed; the 40-minute run's peak RSS must exceed the
     config-1 run's by less than a quarter of the difference of their WAV
     sizes.
 12. Multi-GPU on the one card. (a) One process, a mesh of cuda:0 twice:
     config 1 through an Encoder whose pipeline shards over it (the pinned
     bytes; the deposit kernel launched once a shard a batch), a ragged
     batch of 2 x 2 + 3 frames, the first shard's four of them noise (only
     that shard re-encodes, with its own rows, beside the shard that holds
     padding; bytes equal the unsharded pipeline's), and phase 6's 32-bit
     LPC input (both shards overflow tier 0; the pinned bytes), each wall
     beside the single device's. (b) Two processes sharing the card in a gloo group, each
     encoding config 1 with encode_wav_bytes over the default mesh (two
     ranks, one shard each): both must give the pinned bytes. (c) A
     one-process NCCL group: allgather_parts and the overflow any-reduce
     on CUDA tensors, through encode_compact_sharded on config 1's first
     batch (equal to the unsharded pipeline's) and on a batch of noise
     (the flag set).

Every encode or decode path under test in this process (phases 3-10 and
12; not the runs it is compared with, nor the CLI subprocesses) runs with the
kernels' counts set to 0 just before it and read just after: it must have
launched its kernels (for an encode the analysis, symbols, deposit and
CRC-16 kernels, and the Rice and lag sums kernels with LPC, whose counter
lpc.lag_kernel_evals must equal lpc.window_evals; for a decode the
synthesis) and never called a plain version. The PCM unpack kernel must have launched
once a dispatch on a path that took the card-fed route (every
encode_wav_bytes on the card, each of whose encoded rows must come from
it) and never on any other path. Any failure raises, so the exit code is
not 0. Phases 8 to 11 work in a temporary directory, removed at the end.
The last line is one JSON object naming the card; the line before it lists
each kernel's launches, error against its plain version, times and bound.
"""

import hashlib
import io
import json
import os
import subprocess
import sys
import time
from dataclasses import replace
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MANIFEST = os.path.join(ROOT, "tests", "vectors", "corpus", "manifest.json")

RATE = 44100
BLOCK = 4096
CONFIG1_SECONDS = 285
CONFIG1_WAV_SHA = "8cd5bf65e8eba271a47d4c29b5bd743b4fa3d975b7d27cf50e05c5a93d5905aa"
CONFIG1_FLAC_SHA = "a7532b4007129ac7493a86029b4144fe89977a742580be8c6a1fc244ecb227f7"
CONFIG1_FLAC_BYTES = 31_404_217
CONFIG1_LPC_FLAC_SHA = "d2590d930d0f84e1f395758cf00cdf5876e27fc3fbc7c78c649398b042cc4970"
CONFIG1_LPC_FLAC_BYTES = 29_785_722
CONFIG3_SAMPLES = 1024 * BLOCK
CONFIG3_WAV_SHA = "90df0cb39e47ec5b9de53ff042da21eb929a6adc20b950785b488214eaa7df51"
CONFIG3_FLAC_SHA = "1d7809cff19abf1ce02f6b95d1056d88e0dc737d9f1ab26d1cde2e61d86aee3a"
CONFIG3_FLAC_BYTES = 9_939_659
DEPTH32_SAMPLES = 1024 * BLOCK + 1000
DEPTH32_WAV_SHA = "e0f0b1b00e745d4e4454bd1170cf0148ace5465ea5f7143c975e01498f8f9154"
DEPTH32_FLAC = {  # prediction -> (bytes, sha256)
    "fixed": (27_263_601, "b1ea46f368432399c7886c158c5ba4b377e4a6cbdfa28907be7da8c486956e56"),
    "lpc": (26_723_366, "46f5c76620ba637e5ca0a0614e7ab07a31234cac035339057c48a8b31f271e24"),
}
NOISE32_FRAMES = 64
# film-5.1-48k-24bit's format: six independent 24-bit channels at 48 kHz
FILM_RATE, FILM_DEPTH, FILM_CHANNELS = 48000, 24, 6
# its short encode: 24 frames and a 3,000-sample tail, whose row (70,656 B at
# tier 0) is over the deposit's shared row too
FILM_SHORT_SAMPLES = 24 * BLOCK + 3000
# config 2: bench.py's hires input, 24-bit / 96 kHz stereo, pinned with the
# JAX package on the CPU
CONFIG2_SAMPLES = 1024 * BLOCK
CONFIG2_RATE = 96000
CONFIG2_WAV_SHA = "c03d03182acabde6d12d1559b03233e165eb6f1dc59e532e7b6957361644e086"
CONFIG2_FLAC_SHA = "a8862d4d28285611ed876ec9813121a28ac1dd459ad5015266a7e0f665f0e7b9"
CONFIG2_FLAC_BYTES = 18_831_512
# config 4's album: eight 16-bit / 44.1 kHz tracks, bench recipe with seed
# 0xBEEF + 1 + i, beside the config-1 and config-2 files. Each is (seconds,
# tail): the seconds cut down to whole blocks, then a ragged tail of that
# many samples: none, 1, under 64 (where the JAX package takes its host
# oracle), 64, and a block less one
ALBUM_TRACKS = [(187, 0), (203, 1), (241, 63), (262, 64), (298, 1000), (315, 4095),
                (176, 2048), (229, 17)]
ALBUM_OGG_TRACKS = ("track07.wav",)  # the shortest
# the streaming file: 40 minutes of the bench recipe (seed 0xBEEF) plus 777
# samples (26 batches: the 2-batch window, the seek-back and the SEEKTABLE
# all at work, and long enough that a quarter of its size over config 1's
# stands clear of the ~40 MB by which two CLI processes' peaks differ
# anyway), encoded with a SEEKTABLE point every 10 s, one tag and PADDING
LONG_SAMPLES = 2400 * RATE + 777
LONG_FLAGS = ["--seek-interval", "10", "--tag", "TITLE=forty minutes", "--padding", "4096"]
LONG_KW = dict(seek_interval=10 * RATE, tags=[("TITLE", "forty minutes")], padding=4096)
# decode: frames a batch, as decoder._BATCH_FRAMES
DECODE_BATCH_FRAMES = 512
# streams whose every sample fits int32: the synthesis kernel must run all
# their blocks in its int32 arithmetic
NARROW_STREAMS = ("config1", "config2", "config3")
# 32-bit stereo in antiphase (a tone on the left, its negative on the right,
# the same noise on both), so that the encoder codes a side channel, whose
# samples need 33 bits
ANTIPHASE32_FRAMES = 64
CLI_CHILDREN_AT_ONCE = 6
# the tags file of phase 11's -e child
EDIT_TAGS = "ALBUM=smoke test\nTITLE=edited\n"
# phase 12: shards a mesh on the one card has
SHARDS_ON_ONE_CARD = 2

# H100 SXM data sheet: HBM rate
HBM_BYTES_PER_S = 3.35e12
# H100 SXM INT32 rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
# (Hopper architecture whitepaper); the deposit's operations are integer
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# INT32 operations per symbol in csrc/deposit_bits.cuh: each 64-bit add,
# compare or shift is two to four INT32 operations; the split (start bit,
# value mask, three window words of a 64-bit shift and select) is ~35, the
# three word pieces' bound checks, addresses and ors ~27, the loads and the
# loop ~10
DEPOSIT_INT32_OPS_PER_SYMBOL = 72
# H100 SXM boost clock (Hopper architecture whitepaper)
BOOST_HZ = 1.98e9
# INT32 operations per 64-bit multiply-add in csrc/synth.cu: one wide
# multiply-add of the low halves and two multiply-adds into the high half,
# and a share of the loads, shifts and stores
SYNTH_INT32_OPS_PER_MAC = 4
# cycles of the dependent chain from one sample to the next, from the SASS of
# csrc/synth.cu's int32 tiles (tools/torch_synth_kernel.py prints their
# instructions), at 5 cycles for each fixed-latency integer instruction.
# Where every shift is 0 (fixed predictors) only the low word's 32-bit
# multiply-add (one IMAD) lies between two samples; otherwise IMAD.WIDE with
# the older taps' sum as its addend, the funnel shift's low word and the
# 32-bit add.
SYNTH_CHAIN_CYCLES_SHIFT0 = 5
SYNTH_CHAIN_CYCLES_PER_STEP = 15
# INT32 operations the fixed analysis needs a sample of a plane: five
# differences in 64-bit arithmetic, their absolute values, sums and maxima,
# the residual's zigzag and its partition sum (two to four INT32
# operations for each 64-bit one)
ANALYSIS_INT32_OPS_PER_SAMPLE = 40
# the Rice estimate alone: the zigzag and its partition sum
RICE_INT32_OPS_PER_SAMPLE = 5
# CRC-16 by table: a load, a shift, two xors and a mask a byte
CRC_INT32_OPS_PER_BYTE = 4
# the lag sums (csrc/lags_steps.cuh): a 32 x 32 -> 64-bit multiply-add a
# sample, lag and window in the narrow arithmetic, four in the limbs
LAG_INT32_OPS_PER_MAC = 3
# flac -8's list of LPC windows (six)
FLAC8_APODIZATION = ("tukey(5e-1)", "partial_tukey(2)", "punchout_tukey(3)")
LAG_WIDE_INT32_OPS_PER_MAC = 12
# per plane, the scalar outputs (order, bits, method, part_order int64; ok,
# all_eq bool) and the 256 int64 params
ANALYSIS_OUT_BYTES_PER_PLANE = 4 * 8 + 2 + 256 * 8


def deposit_bound(n_frames: int, n_sym: int, max_words: int):
    """(bytes, ms, bound_by, ops_ms): the least time the card could take
    for one deposit, the larger of the bytes (each input read once: i32
    end bit, i64 value, i32 width per symbol; each output word written
    once) over the HBM rate and the INT32 operations over the INT32 rate
    (``ops_ms``)."""
    nbytes = 16 * n_sym + 4 * n_frames * max_words
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = DEPOSIT_INT32_OPS_PER_SYMBOL * n_sym / INT32_OPS_PER_S
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return nbytes, max(t_bytes, t_ops) * 1e3, bound_by, t_ops * 1e3


def synth_bound(m: int, b: int, order_sum: int, max_order: int, shift0: bool):
    """(bytes, ms, bound_by, parts): the least time the card could take for
    one synthesis of m subframes of b positions, the largest of three: the
    bytes (values read once, samples written once, 32 coefficients and
    three int64 scalars per subframe) over the HBM rate; the multiply-adds
    that these subframes' orders need (order x b each), at
    SYNTH_INT32_OPS_PER_MAC INT32 operations, over the INT32 rate; and the
    dependent chain, b steps of SYNTH_CHAIN_CYCLES_PER_STEP cycles
    (SYNTH_CHAIN_CYCLES_SHIFT0 if ``shift0``: every shift is 0) at the
    boost clock wherever any subframe predicts at all. The chain is a bound
    on operations: it is reported as such, with ``parts`` naming it."""
    nbytes = 16 * m * b + (8 * 32 + 24) * m
    chain = SYNTH_CHAIN_CYCLES_SHIFT0 if shift0 else SYNTH_CHAIN_CYCLES_PER_STEP
    parts = {
        "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "ops_ms": SYNTH_INT32_OPS_PER_MAC * order_sum * b / INT32_OPS_PER_S * 1e3,
        "chain_ms": (b * chain / BOOST_HZ * 1e3) if max_order else 0.0,
    }
    largest = max(parts, key=parts.get)
    parts["largest"] = largest
    return nbytes, parts[largest], "bytes" if largest == "bytes_ms" else "operations", parts


def _bound(nbytes: int, ops: float):
    """(ms, bound_by, ops_ms): the larger of the bytes over the HBM rate and
    the INT32 operations over the INT32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", t_ops * 1e3


def analysis_bound(p: int, b: int, in_bytes_per_sample: int, fixed: bool):
    """(bytes, ms, bound_by, ops_ms) of one analysis launch over p planes of
    b samples: each input read once (the planes, or the residuals and an
    int64 order a plane), each output written once (the int32 residuals
    for the fixed entry; ANALYSIS_OUT_BYTES_PER_PLANE, less order, ok and
    all_eq for the Rice entry); the operations at
    ANALYSIS_INT32_OPS_PER_SAMPLE or RICE_INT32_OPS_PER_SAMPLE."""
    if fixed:
        nbytes = p * b * (in_bytes_per_sample + 4) + p * ANALYSIS_OUT_BYTES_PER_PLANE
        ops = ANALYSIS_INT32_OPS_PER_SAMPLE * p * b
    else:
        nbytes = p * b * in_bytes_per_sample + p * 8 + p * (ANALYSIS_OUT_BYTES_PER_PLANE - 10)
        ops = RICE_INT32_OPS_PER_SAMPLE * p * b
    return (nbytes, *_bound(nbytes, ops))


def lags_bound(p: int, b: int, nwin: int, order: int, elem: int, narrow: bool):
    """(bytes, ms, bound_by, ops_ms) of one lag sums launch: p planes of b
    samples (``elem`` bytes each) and the nwin int16 windows read once, the
    triples written once; (order + 1) multiply-adds a sample and window at
    LAG_INT32_OPS_PER_MAC (narrow) or LAG_WIDE_INT32_OPS_PER_MAC."""
    nbytes = p * b * elem + nwin * b * 2 + nwin * p * (order + 1) * 3 * 8
    per_mac = LAG_INT32_OPS_PER_MAC if narrow else LAG_WIDE_INT32_OPS_PER_MAC
    return (nbytes, *_bound(nbytes, per_mac * nwin * p * b * (order + 1)))


def crc_bound(byte_len: np.ndarray, w: int):
    """(bytes, ms, bound_by, ops_ms) of one CRC launch: each frame's bytes
    inside its row and its byte_len read, its CRC (int64) and two CRC bytes
    written; CRC_INT32_OPS_PER_BYTE operations a byte read."""
    frame_bytes = int(np.minimum(byte_len, 4 * w).sum())
    nbytes = frame_bytes + byte_len.size * (8 + 8 + 2)
    return (nbytes, *_bound(nbytes, CRC_INT32_OPS_PER_BYTE * frame_bytes))


# INT32 operations of csrc/unpack_steps.cuh zf_unpack_sample: a load, a shift
# and an OR a container byte; the subtract, shift and store a sample
UNPACK_INT32_OPS_PER_BYTE = 3
UNPACK_INT32_OPS_PER_SAMPLE = 3


def unpack_bound(n: int, c: int, b: int, nb: int):
    """(bytes, ms, bound_by, ops_ms) of one PCM unpack launch into [n, c, b]
    int32: each output sample written once (4 B) and its nb container bytes
    read once."""
    samples = n * c * b
    nbytes = samples * (nb + 4)
    ops = samples * (UNPACK_INT32_OPS_PER_BYTE * nb + UNPACK_INT32_OPS_PER_SAMPLE)
    return (nbytes, *_bound(nbytes, ops))


def unpack_batch(WavReader, wav: bytes, frames: int = 1024, block: int = BLOCK):
    """(data uint8 numpy, channels, nb, depth, block, n) of a WAV's first
    ``frames`` full frames, as ``DevicePipeline.dispatch_pcm`` sends them."""
    r = WavReader.from_bytes(wav)
    n = min(frames, r.samples_count // block)
    pcm = np.frombuffer(r.raw_pcm_bytes(), np.uint8)[: n * block * r.channels * r.bytes_per_sample]
    return pcm, r.channels, r.bytes_per_sample, r.bit_depth, block, n


# INT32 operations a column in csrc/symbols_steps.cuh zf_sym_column: the
# region tests, the 32-bit division into grid groups, the partition's fields,
# the zigzag and the Rice code in 64-bit arithmetic (two to four INT32
# operations each), three stores and a share of the tile's scan
SYMBOLS_INT32_OPS_PER_COLUMN = 60
# the partition keys: a load, the key, the division into partitions and the
# warp's match and reduction, a residual of a predicted subframe
SYMBOLS_INT32_OPS_PER_SAMPLE = 12


def symbols_bound(plan, n_cols: int):
    """(bytes, ms, bound_by, ops_ms) of one symbols launch, counted from the
    plan's data: every column's int32 end bit, int64 value and int32 width
    written, and total_bits; read once what the columns need: a predicted
    subframe's residuals, warmup samples, 2^part_order params (and LPC
    coefficients), a verbatim subframe's samples, a constant's first, each
    subframe's seven int64 fields, the frame numbers and channel codes.
    Operations: SYMBOLS_INT32_OPS_PER_COLUMN a column and
    SYMBOLS_INT32_OPS_PER_SAMPLE a predicted residual."""
    w, n = plan.kind.shape
    b = plan.planes.shape[-1]
    kind, order, po = (getattr(plan, f).cpu().numpy() for f in ("kind", "order", "part_order"))
    pred = kind >= 2
    samples = np.where(kind == 1, b, np.where(kind == 0, 1, np.where(pred, order, 0)))
    nbytes = (16 * n * n_cols + 8 * n + 16 * n + 7 * 8 * w * n
              + plan.planes.element_size() * int(samples.sum())
              + 4 * b * int(pred.sum()) + 8 * int(np.where(pred, 1 << po, 0).sum())
              + 8 * int(np.where(kind == 3, order, 0).sum()))
    ops = SYMBOLS_INT32_OPS_PER_COLUMN * n * n_cols + SYMBOLS_INT32_OPS_PER_SAMPLE * b * int(
        pred.sum())
    return (nbytes, *_bound(nbytes, ops))


# the symbols kernel's watch list: (frames, wire channels, block size,
# max_rice_order, LPC order, depth, 33-bit side channel, wasted bits), for
# synthetic_plan
SYMBOL_WATCH = [
    (8, 2, 4096, 8, 0, 16, True, False),
    (6, 1, 1, 8, 0, 16, False, False),
    (6, 2, 2, 8, 0, 24, True, False),
    (6, 3, 3, 8, 8, 16, False, False),
    (6, 1, 5, 8, 0, 32, False, False),
    (4, 2, 192, 8, 32, 16, True, True),
    (4, 8, 4095, 8, 12, 24, False, True),
    (3, 4, 4096, 8, 32, 20, False, False),
    (4, 2, 2304, 0, 0, 16, True, False),
    (4, 2, 2304, 4, 0, 12, True, False),
    (4, 2, 2304, 8, 0, 8, True, False),
    (4, 2, 2304, 12, 0, 16, True, False),
    (4, 2, 1024, 8, 8, 32, True, True),
    (2, 2, 65535, 8, 32, 24, True, False),
    # channels of 1,015 and 23 columns (not multiples of 32), tiles ending
    # inside groups; an LPC preamble over three rounds; int64 planes past a tile
    (3, 3, 1000, 8, 0, 16, False, False),
    (4, 5, 12, 8, 0, 16, False, False),
    (3, 6, 300, 8, 32, 24, False, True),
    (2, 2, 1025, 8, 0, 32, True, False),
]
# (block, first sample) of long_code_plan: two ~2^32-bit codes inside a
# warp's run, across two warps' runs (frame columns 127 and 128) and across
# two tiles (columns 1023 and 1024)
SYMBOL_LONG_CODES = [(256, 0), (1024, 103), (1024, 996)]
# frame numbers of every UTF-8 length, and sample rates in RATE_CODES and out
# (8-bit, 16-bit and /10 tail bytes, and 0)
SYMBOL_FRAME_NUMBERS = [0, 0x7F, 0x80, 1 << 11, 1 << 16, 1 << 21, 1 << 26, (1 << 31) - 1]
SYMBOL_RATES = [44100, 96000, 8000, 100, 12345, 700000, 0]


def synthetic_plan(rng, n, w, b, max_rice_order=8, lpc_order=0, depth=16, side=False,
                   wasted=False, methods=(0, 1),
                   impulses=(1 << 13, -(1 << 31), (1 << 31) - 1)):
    """A random FrameWirePlan on the CPU (int64 fields, int32 planes, or
    int64 where a 33-bit side channel is asked at depth 32) of every
    subframe kind, drawn from ``rng``: escape params, partitions of zeros,
    of small values, of values that take the N1 fallback (bps 32 under an
    escape), and of one impulse from ``impulses`` that a small Rice param
    codes in thousands of bits (or, at the residual's ends, in up to 2^32);
    warmup residuals zero, channel codes 0-10."""
    import torch
    from zigflac_tpu_torch.ops.analyze import FrameWirePlan

    po_top = min(max_rice_order, (b & -b).bit_length() - 1)
    kinds = [0, 1] + ([2] if b > 1 else []) + ([3] if lpc_order and b > 1 else [])
    kind = rng.choice(kinds, (w, n))
    order = np.where(kind == 2, rng.integers(0, min(4, b - 1) + 1, (w, n)), 0)
    if lpc_order:
        order = np.where(kind == 3, rng.integers(1, min(lpc_order, b - 1) + 1, (w, n)), order)
    pred = kind >= 2
    method = np.where(pred, rng.choice(methods, (w, n)), 0)
    part_order = np.where(pred, rng.integers(0, po_top + 1, (w, n)), 0)
    shaved = (rng.integers(1, 4, (w, n)) * (rng.random((w, n)) < 0.5) if wasted
              else np.zeros((w, n), np.int64))
    extra = np.zeros((w, n), np.int64)
    if side:
        extra[-1] = 1
    ss = depth + extra - shaved
    esc = (1 << (4 + method)) - 1
    params = np.zeros((w, n, 256), np.int64)
    res = np.zeros((w, n, b), np.int64)
    for c in range(w):
        for f in range(n):
            psize = b >> part_order[c, f]
            for p in range(1 << part_order[c, f]):
                cls = rng.integers(0, 5)
                seg = slice(p * psize, (p + 1) * psize)
                if cls == 1:
                    res[c, f, seg] = rng.integers(-300, 300, psize)
                elif cls == 2:
                    res[c, f, seg] = rng.integers(-(1 << 31), 1 << 31, psize)
                elif cls == 3:
                    res[c, f, seg] = rng.integers(-2, 3, psize)
                    res[c, f, p * psize + rng.integers(0, psize)] = rng.choice(impulses)
                elif cls == 4:
                    res[c, f, seg] = rng.integers(-(1 << 9), 1 << 9, psize)
                params[c, f, p] = (esc[c, f] if cls in (2, 4) or rng.random() < 0.2
                                   else rng.integers(0, esc[c, f] + 1))
            res[c, f, : order[c, f]] = 0
    hi = 1 << (ss[..., None] - 1)
    planes = np.floor(rng.random((w, n, b)) * (2 * hi)).astype(np.int64) - hi
    prec = 15
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64))
    return FrameWirePlan(
        channels_code=t(rng.integers(0, 11, n)), kind=t(kind), order=t(order),
        method=t(method), part_order=t(part_order), sample_size=t(ss), params=t(params),
        planes=torch.from_numpy(planes if depth + side > 32 else planes.astype(np.int32)),
        residuals=torch.from_numpy(res.astype(np.int32)),
        qcoeffs=t(rng.integers(-(1 << (prec - 1)), 1 << (prec - 1), (w, n, 32))),
        qshift=t(rng.integers(0, 16, (w, n))), wasted=t(shaved))


def long_code_plan(b, at):
    """A synthetic plan of 16 frames of 2 channels of ``b`` samples with
    4-bit params only (max_rice_order 2), whose frame 0, channel 0 is fixed
    order 0 in one partition of param 0 with the two widest zigzags at
    samples ``at`` and ``at + 1``: two codes of ~2^32 bits, so the frame's
    sum passes 2^32 and dep_cum wraps as the plain version's int32."""
    import torch

    plan = synthetic_plan(np.random.default_rng(0x5E), 16, 2, b, 2, methods=(0,))
    for name, v in (("kind", 2), ("order", 0), ("method", 0), ("part_order", 0)):
        getattr(plan, name)[0, 0] = v
    plan.params[0, 0, 0] = 0
    plan.residuals[0, 0, at:at + 2] = torch.tensor([-(1 << 31), (1 << 31) - 1],
                                                   dtype=torch.int32)
    return plan


def ptxas_of(kernels):
    """ptxas's registers, shared memory and spills of every compiled
    instance of the named kernels, from this process's nvcc run."""
    from zigflac_tpu_torch.ops import _build

    lines = _build.BUILD_LOG.splitlines()
    return [{"function": ln.split("'")[1],
             "ptxas": [x.strip() for x in lines[i + 1:i + 4] if "Used" in x or "spill" in x]}
            for i, ln in enumerate(lines)
            if "Compiling entry function" in ln and any(k in ln for k in kernels)]


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _log(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


# -- inputs -------------------------------------------------------------------

def bench_wav(write_wav, n, depth=16, rate=RATE, seed=0xBEEF) -> bytes:
    """bench.py's make_wav_bytes recipe: two tones and noise, stereo."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    scale = 2.0 ** (depth - 16)
    base = scale * (9000 * np.sin(2 * np.pi * 440 * t / rate)
                    + 3000 * np.sin(2 * np.pi * 97 * t / rate))
    noise = rng.normal(0, 120 * scale, size=(2, n))
    x = np.stack([base + noise[0], 0.8 * base + noise[1]])
    lim = float(1 << (depth - 1))
    samples = np.clip(np.round(x), -lim, lim - 1).astype(np.int64)
    buf = io.BytesIO()
    write_wav(buf, samples, rate, depth)
    return buf.getvalue()


def film_wav(write_wav, n, seed=0xF11) -> bytes:
    """Six 24-bit channels at 48 kHz (5.1's FL FR FC LFE BL BR): a tone of
    its own a channel, over noise of its own."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = np.stack([2.0e6 * 0.8 ** c * np.sin(2 * np.pi * (97 + 61 * c) * t / FILM_RATE + c)
                  + rng.normal(0, 400 * (c + 1), n) for c in range(FILM_CHANNELS)])
    lim = float(1 << (FILM_DEPTH - 1))
    buf = io.BytesIO()
    write_wav(buf, np.clip(np.round(x), -lim, lim - 1).astype(np.int64), FILM_RATE, FILM_DEPTH)
    return buf.getvalue()


def write_bench_wav(path, n, depth=16, rate=RATE, seed=0xBEEF, piece=1 << 21) -> int:
    """bench_wav's bytes written to ``path`` piece by piece, so a long file
    is never whole in memory. bench_wav draws the left channel's n normals
    and then the right's from one generator; here a second generator of the
    same seed skips the first n draws. Returns the file's size."""
    from zigflac_tpu_torch.wav import wav_header_bytes, wav_pcm_bytes

    scale = 2.0 ** (depth - 16)
    lim = float(1 << (depth - 1))
    rng_l, rng_r = np.random.default_rng(seed), np.random.default_rng(seed)
    for s in range(0, n, piece):
        rng_r.normal(0, 120 * scale, min(piece, n - s))
    with open(path, "wb") as f:
        f.write(wav_header_bytes(n, 2, rate, depth))
        for s in range(0, n, piece):
            m = min(piece, n - s)
            t = np.arange(s, s + m)
            base = scale * (9000 * np.sin(2 * np.pi * 440 * t / rate)
                            + 3000 * np.sin(2 * np.pi * 97 * t / rate))
            x = np.stack([base + rng_l.normal(0, 120 * scale, m),
                          0.8 * base + rng_r.normal(0, 120 * scale, m)])
            f.write(wav_pcm_bytes(np.clip(np.round(x), -lim, lim - 1).astype(np.int64), depth))
        return f.tell()


class DispatchSpy:
    """While active, counts the pipeline's batch and tail dispatches, and
    the batches whose frame numbers are not one consecutive run: exactly
    those holding frames of more than one file, since every file numbers
    its frames from 0."""

    def __init__(self, pipeline_cls):
        self.cls = pipeline_cls
        self.batches = self.mixed = self.tails = 0

    def __enter__(self):
        batch, tail = self.cls.dispatch_batch, self.cls.dispatch_tail
        self._saved = batch, tail

        def spy_batch(pipe, chunk, fns, info):
            self.batches += 1
            self.mixed += bool(np.any(np.diff(fns) != 1))
            return batch(pipe, chunk, fns, info)

        def spy_tail(pipe, samples, frame_number, info):
            self.tails += 1
            return tail(pipe, samples, frame_number, info)

        self.cls.dispatch_batch, self.cls.dispatch_tail = spy_batch, spy_tail
        return self

    def __exit__(self, *exc):
        self.cls.dispatch_batch, self.cls.dispatch_tail = self._saved


# The CLI as ``python -m zigflac_tpu_torch.cli`` runs it, then its peak
# resident memory, sampled every 5 ms from /proc/self/statm by a thread of
# its own. (ru_maxrss cannot measure a child of this script: Linux carries
# the forking parent's peak over exec into the child's, so every child
# reads at least this process's peak; and VmHWM is not offered on every
# machine.)
_CLI_WITH_PEAK = (
    "import os, sys, threading, time\n"
    "page = os.sysconf('SC_PAGE_SIZE')\n"
    "peak = [0]\n"
    "def rss():\n"
    "    with open('/proc/self/statm') as f:\n"
    "        return int(f.read().split()[1]) * page\n"
    "def sample():\n"
    "    while True:\n"
    "        peak[0] = max(peak[0], rss())\n"
    "        time.sleep(0.005)\n"
    "threading.Thread(target=sample, daemon=True).start()\n"
    "from zigflac_tpu_torch.cli import main\n"
    "rc = main(sys.argv[1:])\n"
    "print('peak_rss_bytes', max(peak[0], rss()))\n"
    "sys.exit(rc)\n"
)


def run_cli(args, timeout=600, expect=0):
    """One wav2flac CLI subprocess: (wall seconds, its peak RSS in bytes,
    its output). Raises on another exit code than ``expect``, or at the
    timeout after killing it."""
    proc = subprocess.Popen([sys.executable, "-c", _CLI_WITH_PEAK, *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    try:
        text = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    wall = time.perf_counter() - t0
    if proc.returncode != expect:
        raise RuntimeError(f"wav2flac {args} exited {proc.returncode}, expected {expect}:\n"
                           f"{text[-4000:]}")
    peak = [line.split()[1] for line in text.splitlines() if line.startswith("peak_rss_bytes")]
    return wall, int(peak[-1]), text


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def phase5_film(env, frames=1024) -> dict:
    """film-5.1-48k-24bit's settings (six independent 24-bit channels at 48
    kHz, flac -8's six windows at order 12, 15-bit coefficients): one batch
    of ``frames`` frames through the lag sums kernel (in its limbs) and the
    deposit kernel (rows over its shared-memory row: the global-memory
    branch), each against its plain version and timed beside its bound, and
    the CRC-16 kernel over those rows; then a short film WAV through
    encode_wav_bytes on the counted paths, equal to the CPU port's bytes with
    every deposit launch on the global-memory branch, and back through
    decode_flac. Returns the lag sums' and the deposit's batch entries."""
    from zigflac_tpu_torch.utils.apodization import windows_of

    torch, dev, zt, lpc, deposit = env.torch, env.dev, env.zt, env.lpc, env.deposit
    cfg = zt.EncoderConfig(prediction="lpc", channels=FILM_CHANNELS, lpc_order=12,
                           lpc_precision=15, max_rice_order=6, apodization=FLAC8_APODIZATION)
    s = env.WavReader.from_bytes(film_wav(env.write_wav, frames * BLOCK)).planar_samples()
    fr = torch.from_numpy(
        s.reshape(FILM_CHANNELS, frames, BLOCK).transpose(1, 0, 2).copy()).to(dev)
    del s

    def entry(kernel_ms, plain_ms, bound):
        return dict(kernel_ms=kernel_ms, plain_ms=plain_ms, bound_bytes=bound[0],
                    bound_ms=bound[1], bound_by=bound[2], bound_ops_ms=bound[3],
                    share_of_bound=bound[1] / kernel_ms)

    # the lag sums of every plane under the six windows, as the search takes
    # them (sample_bits 25: the limbs)
    planes = fr.movedim(1, 0).contiguous()
    wt = lpc.windows_tensor(windows_of(cfg), BLOCK, dev)
    nwin = wt.shape[0]
    run = lambda: lpc.lag_sums_planes(planes, cfg.lpc_order, wt, FILM_DEPTH + 1)
    plain = lambda: lpc.lag_sums(planes.unsqueeze(0), cfg.lpc_order, wt.view(nwin, 1, 1, BLOCK))
    if not torch.equal(run(), plain()):
        raise AssertionError("lag sums kernel (limbs) != plain on film's batch")
    lags = dict(planes=list(planes.shape), windows=nwin, order=cfg.lpc_order, **entry(
        cuda_ms(torch, run), cuda_ms(torch, plain, reps=3),
        lags_bound(planes.numel() // BLOCK, BLOCK, nwin, cfg.lpc_order, 4, False)))
    del planes

    # the batch's symbol stream at tier 0, the cell's word budget
    plan = env.analyze.plan_frames(fr, FILM_DEPTH, cfg)
    hs, mw, _ = env.pl.compact_shape(cfg, FILM_DEPTH, FILM_CHANNELS, BLOCK, FILM_RATE, 0, frames)
    dep_cum, _, dv, dn = env.bitpack.frame_symbol_stream(
        plan, torch.arange(frames, device=dev), hs, BLOCK, cfg.max_rice_order, cfg.lpc_order,
        cfg.lpc_precision)
    del plan, fr
    dc, dn = dep_cum.to(torch.int32), dn.to(torch.int32)
    del dep_cum
    if mw * 4 <= deposit.shared_row_bytes():
        raise AssertionError("film's rows fit the deposit's shared row")
    env.compare(dc, dv, dn, mw)
    words = deposit.deposit_words(dc, dv, dn, mw)
    env.compare_crc(words, (dc[:, -1].to(torch.int64) + 7) >> 3)
    dep = dict(symbols=list(dc.shape), max_words=mw, row_bytes=mw * 4, **entry(
        cuda_ms(torch, lambda: deposit.deposit_words(dc, dv, dn, mw)),
        cuda_ms(torch, lambda: deposit.deposit_words_plain(dc, dv, dn, mw), reps=3),
        deposit_bound(frames, dc.numel(), mw)))
    del words, dc, dv, dn
    _log("5-film-batch", frames=frames, lag_sums=lags, deposit=dep)

    wav = film_wav(env.write_wav, FILM_SHORT_SAMPLES)
    want = zt.encode_wav_bytes(wav, config=cfg, device="cpu")
    flac, k, g = env.counted("film", lambda: zt.encode_wav_bytes(wav, config=cfg, device=dev),
                             lpc=True, fed=True)
    if flac != want:
        raise AssertionError("film: the card's bytes differ from the CPU port's")
    if g != k:
        raise AssertionError(f"film: {g} of {k} deposit launches took the global-memory branch")
    back, ks = env.counted_decode("film decode", lambda: zt.decode_flac(flac, device=dev))
    if not (back.md5_ok and np.array_equal(back.samples,
                                           env.WavReader.from_bytes(wav).planar_samples())):
        raise AssertionError("film: decode_flac did not give the samples back")
    _log("5-film", samples=FILM_SHORT_SAMPLES, flac_bytes=len(flac), ratio=len(flac) / len(wav),
         kernel_launches=k, global_row_launches=g, synth_launches=ks)
    return {"lag_sums": lags, "deposit": dep}


def phase7_config2(env, write_wav) -> bytes:
    """Config 2 at full size through encode_wav_bytes; returns its WAV and
    its FLAC."""
    wav2 = bench_wav(write_wav, CONFIG2_SAMPLES, depth=24, rate=CONFIG2_RATE)
    if _sha(wav2) != CONFIG2_WAV_SHA:
        raise AssertionError("config 2 input synthesis drifted")
    (flac, wall, per_batch), k, _ = env.counted(
        "config 2", lambda: env.timed_encode(wav2, None), fed=True)
    env.check("config 2", flac, CONFIG2_FLAC_BYTES, CONFIG2_FLAC_SHA)
    _log("7", flac_bytes=len(flac), ratio=len(flac) / len(wav2), wall_s=wall,
         x_realtime=CONFIG2_SAMPLES / CONFIG2_RATE / wall, kernel_launches=k, plain_calls=0,
         stages_ms=per_batch)
    return wav2, flac


def phase8_album(env, tmp, wav1, wav2, want) -> dict:
    """Config 4: a 10-file album directory through one encode_files call.
    ``want`` maps the config-1 and config-2 file names to their pinned
    sha256. Returns the paths the CLI phase reuses."""
    zt, dev = env.zt, env.dev
    indir, outdir = os.path.join(tmp, "album"), os.path.join(tmp, "album_flac")
    os.makedirs(indir)
    os.makedirs(outdir)
    samples, rates = {}, {}
    for name, wav, n, rate in (("config1.wav", wav1, CONFIG1_SECONDS * RATE, RATE),
                               ("config2.wav", wav2, CONFIG2_SAMPLES, CONFIG2_RATE)):
        with open(os.path.join(indir, name), "wb") as f:
            f.write(wav)
        samples[name], rates[name] = n, rate
    t0 = time.perf_counter()
    for i, (secs, extra) in enumerate(ALBUM_TRACKS):
        name = f"track{i + 1:02d}.wav"
        samples[name], rates[name] = secs * RATE // BLOCK * BLOCK + extra, RATE
        write_bench_wav(os.path.join(indir, name), samples[name], seed=0xBEEF + 1 + i)
    synth_s = time.perf_counter() - t0
    names = sorted(samples)
    ins = [os.path.join(indir, f) for f in names]
    outs = [os.path.join(outdir, f[:-4] + ".flac") for f in names]
    audio_s = sum(samples[f] / rates[f] for f in names)

    with DispatchSpy(env.pipeline_cls) as spy:
        t0 = time.perf_counter()
        _, k, _ = env.counted("config 4 album", lambda: zt.encode_files(ins, outs, device=dev))
        wall = time.perf_counter() - t0
    # fusion: per format group, ceil(all full frames / 1024) batches
    full16 = sum(samples[f] // BLOCK for f in names if f != "config2.wav")
    want_batches = -(-full16 // 1024) + -(-(samples["config2.wav"] // BLOCK) // 1024)
    want_tails = sum(bool(samples[f] % BLOCK) for f in names)
    if (spy.batches, spy.tails) != (want_batches, want_tails):
        raise AssertionError(f"album: {spy.batches} batches, {spy.tails} tails, expected "
                             f"{want_batches} and {want_tails}")
    for name, out in zip(names, outs):
        got = _read(out)
        if name in want:
            if _sha(got) != want[name]:
                raise AssertionError(f"album {name}: sha256 {_sha(got)}")
        elif got != zt.encode_wav_bytes(_read(os.path.join(indir, name)), device=dev):
            raise AssertionError(f"album {name}: differs from its in-memory encode")
    wav_bytes = sum(os.path.getsize(p) for p in ins)
    flac_bytes = sum(os.path.getsize(p) for p in outs)
    _log("8", files=len(names), audio_s=audio_s, wav_bytes=wav_bytes, flac_bytes=flac_bytes,
         synth_s=synth_s, wall_s=wall, x_realtime=audio_s / wall, batch_dispatches=spy.batches,
         tail_dispatches=spy.tails, mixed_batches=spy.mixed, kernel_launches=k, plain_calls=0,
         each_equals_in_memory=True)

    # Ogg-FLAC on the shortest track, against the CPU port
    ogg_in = [os.path.join(indir, f) for f in ALBUM_OGG_TRACKS]
    ogg_out = [os.path.join(tmp, f[:-4] + ".oga") for f in ALBUM_OGG_TRACKS]
    ogg_cpu = [os.path.join(tmp, f[:-4] + ".cpu.oga") for f in ALBUM_OGG_TRACKS]
    t0 = time.perf_counter()
    _, k, _ = env.counted("config 4 ogg", lambda: zt.encode_files(ogg_in, ogg_out, device=dev,
                                                                   ogg=True))
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    zt.encode_files(ogg_in, ogg_cpu, device="cpu", ogg=True)
    cpu_wall = time.perf_counter() - t0
    for a, b in zip(ogg_out, ogg_cpu):
        got = _read(a)
        if got[:4] != b"OggS" or got != _read(b):
            raise AssertionError(f"ogg {a}: differs from the CPU port")
    _log("8-ogg", files=len(ogg_in), audio_s=sum(samples[f] / RATE for f in ALBUM_OGG_TRACKS),
         wall_s=wall, cpu_port_wall_s=cpu_wall, kernel_launches=k, plain_calls=0,
         equals_cpu=True)
    return dict(indir=indir, outs=dict(zip(names, outs)))


def phase9_stream(env, tmp) -> dict:
    """The 40-minute file through encode_file against its in-memory encode.
    Returns the paths and sizes the later phases reuse."""
    zt, dev = env.zt, env.dev
    long_wav, out = os.path.join(tmp, "long.wav"), os.path.join(tmp, "long.flac")
    t0 = time.perf_counter()
    long_size = write_bench_wav(long_wav, LONG_SAMPLES)
    synth_s = time.perf_counter() - t0
    audio_s = LONG_SAMPLES / RATE
    t0 = time.perf_counter()
    _, k, _ = env.counted("40-minute encode_file",
                          lambda: zt.encode_file(long_wav, out, device=dev, **LONG_KW))
    wall = time.perf_counter() - t0
    streamed = _read(out)
    t0 = time.perf_counter()
    wav = _read(long_wav)
    in_memory = zt.encode_wav_bytes(wav, device=dev, **LONG_KW)
    env.sync()
    mem_wall = time.perf_counter() - t0
    del wav
    if streamed != in_memory:
        raise AssertionError("40-minute encode_file differs from its in-memory encode")
    _log("9", wav_bytes=long_size, audio_s=audio_s, synth_s=synth_s, flac_bytes=len(streamed),
         sha256=_sha(streamed), encode_file_wall_s=wall, x_realtime=audio_s / wall,
         in_memory_wall_s=mem_wall, in_memory_x_realtime=audio_s / mem_wall,
         kernel_launches=k, plain_calls=0, equals_in_memory=True)
    return dict(wav=long_wav, flac=out, wav_size=long_size, audio_s=audio_s)


def _subframes(rng, m, b, max_order=32, wrap=False):
    """Random normalized subframes as the parser would hand them over:
    orders 0..max_order with coefficients zero beyond the order, shifts
    0-15, wasted 0-3, 33-bit values; ``wrap`` takes 62-bit values and
    coefficients, so every sum passes 2^63."""
    order = rng.integers(0, max_order + 1, m)
    bits = 62 if wrap else 15
    q = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (m, 32))
    q[np.arange(32)[None, :] >= order[:, None]] = 0
    vbits = 62 if wrap else 33
    values = rng.integers(-(1 << (vbits - 1)), 1 << (vbits - 1), (m, b))
    return values, q, rng.integers(0, 16, m), order, rng.integers(0, 4, m)


def _quiet_subframes(rng, m, b, order, shift=12, wasted=0):
    """m stable subframes of one order: 16-bit values and coefficients whose
    magnitudes sum to under 2^shift, the last one non-zero, so every sample
    stays far inside int32 and the kernel sums exactly ``order`` taps."""
    q = np.zeros((m, 32), np.int64)
    if order:
        q[:, :order] = rng.integers(-100, 101, (m, order))
        q[:, order - 1] = rng.choice([-7, 9], m)
    values = rng.integers(-(1 << 15), 1 << 15, (m, b))
    return [values, q, np.full(m, shift), np.full(m, min(order, b)), np.full(m, wasted)]


def _fixed_subframes(rng, m, b, max_order):
    """Fixed predictors as a stream's batch has them: orders 0-max_order
    mixed (row 0 has the largest), binomial coefficients, shift 0, and as
    values the order-th differences of a 15-bit signal."""
    binomial = [[], [1], [2, -1], [3, -3, 1], [4, -6, 4, -1]]
    order = rng.integers(0, max_order + 1, m)
    order[0] = max_order
    q = np.zeros((m, 32), np.int64)
    values = rng.integers(-(1 << 14), 1 << 14, (m, b))
    for i in range(m):
        q[i, :order[i]] = binomial[order[i]]
        values[i, order[i]:] = np.diff(values[i], n=order[i])
    return [values, q, np.zeros(m, np.int64), order, np.zeros(m, np.int64)]


def _analysis_planes(rng, p, b, depth):
    """Planes of every kind the encoder meets, p rows of b samples: noise, a
    tone with noise, a constant, full-scale alternation, quiet +-1. Depth 33
    gives int64 planes (the side plane of a 32-bit stream)."""
    lim = 1 << (depth - 1)
    t = np.arange(b)
    tone = 0.4 * lim * np.sin(2 * np.pi * 440 * t / RATE)
    rows = [rng.integers(-lim, lim, b), np.round(tone + rng.normal(0, lim >> 8, b)),
            np.full(b, lim // 3), np.where(t % 2 == 0, lim - 1, -lim), rng.integers(-1, 2, b)]
    x = np.stack([rows[i % len(rows)] for i in range(p)])
    return np.clip(x, -lim, lim - 1).astype(np.int64 if depth > 32 else np.int32)


def _quiet_residuals(rng, rows, b, order):
    """Residual rows of sparse +-1 (zigzag sums about half a partition's
    size, where the reference's u64 cost wraps), every third row zero, the
    warmup slots zero."""
    res = np.where(rng.random((rows, b)) < rng.random((rows, 1)),
                   rng.choice([-1, 1], (rows, b)), 0).astype(np.int32)
    res[::3] = 0
    res[np.arange(b)[None, :] < np.asarray(order)[:, None]] = 0
    return res


def phase2_analysis(env, batches, lpc_batch):
    """The analysis kernels against their plain versions on the card, every
    output field equal: zf_analyze_fixed on random planes at depths 8-32 and
    the int64 side plane, a wide-mode disqualification of each order, equal,
    zero and one-sample planes, a first partition of negative size, blocks
    of 1 to 65535 samples, partition orders 0, 4 and 8 and params up to 14
    and 30, max_rice_order 12 at B = 2304, planes at the narrow arithmetic's
    limit and one past it; partition order 15 refused before any launch;
    zf_rice_estimate on partitions about half full and all zero, on
    orders 0-32, on blocks not a multiple of 4 and on rows that do not start
    on 16 bytes; then the real planes of one batch each of ``batches``
    (name -> [(planes, wide, max_param)], the calls analyze_planes makes)
    and the LPC candidate's residuals of ``lpc_batch`` (residuals, orders).
    Config 1's batch and the LPC batch are timed in turns with the plain
    versions, config 2's batch and the 32-bit input's side plane beside
    them. Returns the two kernels' entries for the last lines."""
    torch, dev, analyze = env.torch, env.dev, env.analyze
    rng = np.random.default_rng(0xA7A1)
    max_err = {"fixed": 0, "rice": 0}

    def diff(got, want):
        """0 if every field is equal, else the largest |difference| (>= 1)."""
        err = 0
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                err = max(err, 1, int((g.double() - w.double()).abs().max()))
        return err

    def fixed(planes, wide, mro=8, max_param=14):
        x = planes if torch.is_tensor(planes) else torch.from_numpy(planes).to(dev)
        got = analyze.analyze_fixed(x, wide, mro, max_param)
        err = diff(got, analyze.analyze_fixed_plain(x, wide, mro, max_param))
        torch.cuda.synchronize()
        max_err["fixed"] = max(max_err["fixed"], err)
        if err:
            raise AssertionError(f"analysis kernel != plain (max |diff| {err}) on "
                                 f"{tuple(x.shape)} {x.dtype}, wide {wide}, {mro}, {max_param}")
        return got

    def rice(res, order, mro=8, max_param=14):
        r = res if torch.is_tensor(res) else torch.from_numpy(res).to(dev)
        o = order if torch.is_tensor(order) else torch.from_numpy(order).to(dev)
        got = analyze.rice_estimate_planes(r, o, mro, max_param)
        err = diff(got, analyze.rice_estimate(r, o, r.shape[-1], mro, max_param))
        torch.cuda.synchronize()
        max_err["rice"] = max(max_err["rice"], err)
        if err:
            raise AssertionError(f"Rice kernel != plain (max |diff| {err}) on {tuple(r.shape)}")
        return got

    analyze.reset_counts()
    for depth in (8, 16, 24, 28, 32, 33):
        fixed(_analysis_planes(rng, 20, BLOCK, depth), depth >= 28, 8, 30 if depth > 16 else 14)
    ok = []
    for k in range(5):  # |d_k| just past 2^31 - 1 from order k on
        a = -(-(1 << 31) // (1 << k))
        alt = np.where(np.arange(300) % 2 == 0, a, -a).astype(np.int64)
        ok.append(fixed(np.stack([alt, alt + 1, np.full(300, 1 << 32)]), True, 8, 30)
                  .ok.tolist())
    if ok != [[k > 0, k > 0, True] for k in range(5)]:
        raise AssertionError(f"wide-mode disqualification: usable {ok}")
    eq = fixed(np.stack([np.zeros(64), np.full(64, -7), np.r_[np.full(63, 5), 6]])
               .astype(np.int32), False).all_eq.tolist()
    if eq != [True, True, False]:
        raise AssertionError(f"all_eq {eq}")
    fixed(rng.integers(-999, 999, (9, 1)).astype(np.int32), False)
    i = np.arange(512, dtype=np.int64)
    cube = np.stack([i**3 // 60, i**3 // 60 + (i % 11 == 0)]).astype(np.int32)
    if fixed(cube, False).order.tolist() != [3, 3]:  # order 3, po 8: first size 2 - 3
        raise AssertionError("the negative first partition case lost its order 3")
    for b in (1, 5, 17, 64, 256, 1152, 1972, 4096, 4608, 8192, 65535):
        fixed(_analysis_planes(rng, 3 if b == 65535 else 10, b, 16), False)
    for mro, max_param in ((0, 14), (4, 30), (8, 30)):
        fixed(_analysis_planes(rng, 10, BLOCK, 24), False, mro, max_param)
    # partition orders above 8 are refused (ValueError, as the JAX package
    # raises) before any launch; max_rice_order 12 at B = 2304 (ctz 8) is legal
    refused = []
    x15 = torch.from_numpy(_analysis_planes(rng, 10, BLOCK, 24)).to(dev)
    launches = (analyze.KERNEL_LAUNCHES, analyze.RICE_KERNEL_LAUNCHES)
    for call in (lambda: analyze.analyze_fixed(x15, False, 15, 14),
                 lambda: analyze.analyze_fixed(x15, False, 15, 30),
                 lambda: analyze.rice_estimate_planes(
                     x15, torch.zeros(10, dtype=torch.int64, device=dev), 15, 30)):
        try:
            call()
        except ValueError:
            refused.append(True)
    if refused != [True] * 3 or launches != (analyze.KERNEL_LAUNCHES,
                                             analyze.RICE_KERNEL_LAUNCHES):
        raise AssertionError(f"partition order 15 not refused before a launch: {refused}")
    fixed(_analysis_planes(rng, 10, 2304, 24), False, 12, 30)
    # planes at the narrow arithmetic's limit of |x| (2^23 - 1) and one past
    t = np.arange(BLOCK)
    for lim in ((1 << 23) - 1, 1 << 23):
        noise = rng.integers(-lim + 1, lim, BLOCK)
        noise[700] = -lim
        edge = np.stack([np.where(t % 2 == 0, lim, -lim), np.full(BLOCK, -lim), noise])
        for wide in (False, True):
            fixed(edge.astype(np.int32), wide, 8, 30)
    for b, order in ((4096, 2), (272, 1), (48, 1), (4608, 3)):
        orders = np.full(30, order, np.int64)
        rice(_quiet_residuals(rng, 30, b, orders), orders, 8, 30)
    orders = np.arange(33).repeat(2)
    for b in (4096, 256):  # orders 17-31 at po 8 of 256: partitions shorter than the order
        res = rng.integers(-3000, 3000, (orders.size, b)).astype(np.int32)
        res[np.arange(b)[None, :] < orders[:, None]] = 0
        res[1::2] >>= 10
        for max_param in (14, 30):
            rice(res, orders, 8, max_param)
    rice(_quiet_residuals(rng, 66, 2304, orders), orders, 12, 30)
    # B not a multiple of 4 (the runs' word loads), partitions shorter than
    # a run (66 at order 1), several tiles (4098), rows off 16 bytes
    for b in (66, 1972, 4098):
        res = rng.integers(-3000, 3000, (orders.size, b)).astype(np.int32)
        res[np.arange(b)[None, :] < orders[:, None]] = 0
        rice(res, orders, 8, 30)
    flat = rng.integers(-3000, 3000, orders.size * BLOCK + 1).astype(np.int32)
    rice(torch.from_numpy(flat).to(dev)[1:].view(orders.size, BLOCK), orders, 8, 14)

    out = {}
    for name, calls in batches.items():
        out[name] = [dict(planes=list(x.shape), dtype=str(x.dtype), wide=wide,
                          part_orders=np.bincount(fixed(x, wide, 8, mp).part_order.cpu()
                                                  .flatten().numpy(), minlength=9).tolist())
                     for x, wide, mp in calls]
    res, order = lpc_batch
    got = rice(res, order)
    out["config3_lpc_rice"] = dict(residuals=list(res.shape), orders=np.bincount(
        order.cpu().flatten().numpy()).tolist(), part_orders=np.bincount(
        got[2].cpu().flatten().numpy(), minlength=9).tolist())

    # config 1's batch and the LPC candidate's, in turns with the plain versions;
    # the 24-bit batch (config 2's) and the int64 side plane of the 32-bit
    # input through the kernel beside them
    shapes = {}
    for name, (x, wide, mp) in (("config2_24bit", batches["config2"][0]),
                                ("depth32_side_int64", batches["depth32"][1])):
        run = lambda: analyze.analyze_fixed(x, wide, 8, mp)
        b = analysis_bound(x.numel() // BLOCK, BLOCK, x.element_size(), True)
        shapes[name] = dict(planes=list(x.shape), dtype=str(x.dtype), kernel_ms=cuda_ms(torch, run),
                            bound_ms=b[1], bound_by=b[2])
    x1 = batches["config1"][0][0]
    run = lambda: analyze.analyze_fixed(x1, False, 8, 14)
    run_plain = lambda: analyze.analyze_fixed_plain(x1, False, 8, 14)
    f_plain, f_kernel = [cuda_ms(torch, run_plain, reps=5)], [cuda_ms(torch, run)]
    f_kernel.append(cuda_ms(torch, run))
    f_plain.append(cuda_ms(torch, run_plain, reps=5))
    r_run = lambda: analyze.rice_estimate_planes(res, order, 8, 14)
    r_plain_run = lambda: analyze.rice_estimate(res, order, BLOCK, 8, 14)
    r_plain, r_kernel = [cuda_ms(torch, r_plain_run, reps=5)], [cuda_ms(torch, r_run)]
    r_kernel.append(cuda_ms(torch, r_run))
    r_plain.append(cuda_ms(torch, r_plain_run, reps=5))
    p1 = x1.numel() // BLOCK
    fb = analysis_bound(p1, BLOCK, x1.element_size(), True)
    rb = analysis_bound(order.numel(), BLOCK, 4, False)
    _log("2-analysis", max_abs_err=max_err, batches=out, shapes=shapes, config1_kernel_ms=f_kernel,
         config1_plain_ms=f_plain, config1_bound_bytes=fb[0], config1_bound_ms=fb[1],
         config1_bound_by=fb[2], config1_bound_ops_ms=fb[3], lpc_rice_kernel_ms=r_kernel,
         lpc_rice_plain_ms=r_plain, lpc_rice_bound_bytes=rb[0], lpc_rice_bound_ms=rb[1],
         lpc_rice_bound_by=rb[2], lpc_rice_bound_ops_ms=rb[3],
         launches_here=[analyze.KERNEL_LAUNCHES, analyze.RICE_KERNEL_LAUNCHES],
         ptxas=ptxas_of(("analyze_fixed_kernel", "rice_estimate_kernel")))
    entry = lambda name, line, err, k, p, b: {
        "name": name, "route": "cuda", "source": "zigflac_tpu_torch/csrc/analyze.cu",
        "replaces": f"zigflac_tpu/ops/analyze.py:{line}", "max_abs_err": err,
        "ms": sum(k) / len(k), "plain_ms": sum(p) / len(p), "bound_ms": b[1],
        "bound_by": b[2], "library_ms": None}
    return (entry("analyze_fixed", 118, max_err["fixed"], f_kernel, f_plain, fb),
            entry("rice_estimate", 197, max_err["rice"], r_kernel, r_plain, rb))


def _signal_frames(rng, n, channels, b, depth, shift=0, antiphase=False):
    """n frames [n, channels, b] of a tone and noise at ``depth`` bits (the
    low ``shift`` bits zero), int32; ``antiphase``: the second channel the
    first's negative, so that a stereo side channel needs depth + 1 bits."""
    lim = 1 << (depth - shift - 1)
    t = np.arange(n * b)
    x = 0.6 * lim * np.sin(2 * np.pi * 440 * t / RATE)
    chans = [x + rng.normal(0, lim / 64, t.size) for _ in range(channels)]
    if antiphase:
        chans[1] = -chans[0]
    x = np.clip(np.round(np.stack(chans)), -lim, lim - 1).astype(np.int64) << shift
    return x.reshape(channels, n, b).transpose(1, 0, 2).astype(np.int32)


def phase2_symbols(env, batches):
    """The symbols kernel against its plain version on the card, dep_cum,
    total_bits, val and nbv all equal: synthetic plans of the watch list
    (SYMBOL_WATCH: blocks of 1 to 65,535 samples, 1-8 channels, every
    subframe kind, escapes and the N1 fallback, Rice codes of thousands of
    bits, channels whose columns are not a multiple of 32, LPC orders up to
    32, wasted bits, 33-bit side planes, max_rice_order 0-12, 4- and 5-bit
    params) with every frame-number length, channel code and uncommon rate;
    frames past 2^32 bits (SYMBOL_LONG_CODES: two ~2^32-bit codes inside a
    warp's run, across two warps' runs, across two tiles); the analysis's
    plans of signals at depths 8-32, 1-8 channels and stereo_auto, fixed and
    LPC (order 32, precision 15), wasted bits, 4-bit params, independent
    channels' strided planes and a 33-bit side plane, and of ROADMAP's N1
    input; then the real plans of one batch each of ``batches`` (name ->
    (plan, frame numbers, header static, lpc_order, lpc_precision)).
    Config 1's batch is timed in turns with the plain version, beside
    symbols_bound. Returns the kernel's entry for the last lines."""
    torch, dev, symbols, bitpack, analyze = env.torch, env.dev, env.symbols, env.bitpack, \
        env.analyze
    from zigflac_tpu_torch.ops.header import header_static

    err, checked = 0, []
    on_card = lambda plan: analyze.FrameWirePlan(*(t.to(dev) for t in plan))

    def compare(what, plan, fns, hs, b, mro, lpc_order, prec):
        nonlocal err
        fns = torch.as_tensor(fns, dtype=torch.int64).to(dev)
        got = symbols.frame_symbols(plan, fns, hs, b, mro, lpc_order, prec)
        d, tb, v, nb = bitpack.frame_symbol_stream(plan, fns, hs, b, mro, lpc_order, prec)
        want = (d.to(torch.int32), tb, v, nb.to(torch.int32))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"symbols kernel on {what}: {g.dtype} {list(g.shape)} "
                                     f"against {w.dtype} {list(w.shape)}")
            if not torch.equal(g, w):
                err = max(err, 1, int((g.double() - w.double()).abs().max()))
        if err:
            raise AssertionError(f"symbols kernel != plain on {what} (max |diff| {err})")
        checked.append(what)
        return got

    for n, w, b, mro, lpc_order, depth, side, wasted in SYMBOL_WATCH:
        rng = np.random.default_rng(b * 31 + w * 7 + mro + lpc_order + depth)
        plan = on_card(synthetic_plan(rng, n, w, b, mro, lpc_order, depth, side, wasted))
        fns = [SYMBOL_FRAME_NUMBERS[(i * 3) % len(SYMBOL_FRAME_NUMBERS)] for i in range(n)]
        hs = header_static(b, SYMBOL_RATES[b % len(SYMBOL_RATES)], depth)
        compare(f"watch B{b} w{w} mro{mro} lpc{lpc_order} d{depth}", plan, fns, hs, b, mro,
                lpc_order, 15)
    # 4-bit params only, and one frame of two ~2^32-bit codes (sums past
    # 2^32) inside a warp's run, across two warps' runs and across two tiles
    for b, at in SYMBOL_LONG_CODES:
        _, total, val, nbv = compare(f"4-bit params, 2^32-bit codes at B{b} sample {at}",
                                     on_card(long_code_plan(b, at)), list(range(16)),
                                     header_static(b, RATE, 16), b, 2, 0, 15)
        if not (int(total.max()) >= 1 << 32 and bool(((val == 30) & (nbv == 4)).any())):
            raise AssertionError("symbols watch: no frame past 2^32 bits or no N1 fallback")
    rng = np.random.default_rng(0x51)
    for depth, ch, fields, anti in (
            (8, 1, dict(channels=1, block_size=1152), False),
            (12, 3, dict(channels=3, block_size=1024, wasted_bits=True), False),
            (16, 2, dict(), False),
            (20, 2, dict(block_size=1024, prediction="lpc", lpc_order=32, lpc_precision=15),
             False),
            (24, 8, dict(channels=8, block_size=1024, max_rice_param=14), False),
            (32, 2, dict(block_size=1024, prediction="lpc", lpc_order=12, wasted_bits=True),
             False),
            (32, 2, dict(block_size=1024), True)):
        cfg = env.zt.EncoderConfig(**fields)
        frames = _signal_frames(rng, 6, ch, cfg.block_size, depth, 2 if cfg.wasted_bits else 0,
                                anti)
        plan = analyze.plan_frames(torch.from_numpy(frames).to(dev), depth, cfg)
        if anti and plan.planes.dtype != torch.int64:
            raise AssertionError("the antiphase frames have no 33-bit side plane")
        compare(f"signal d{depth} ch{ch} {fields}", plan, SYMBOL_FRAME_NUMBERS[:6],
                header_static(cfg.block_size, RATE, depth), cfg.block_size, cfg.max_rice_order,
                analyze.lpc_order_of(cfg), cfg.lpc_precision)
    n1 = torch.tensor([[[20307570, 660849485, -1463004301, -295378865, 1646815274]]],
                      dtype=torch.int32, device=dev)
    plan = analyze.plan_frames(n1, 32, env.zt.EncoderConfig(block_size=5, channels=1,
                                                             max_rice_param=14))
    _, _, val, nbv = compare("N1", plan, [0], header_static(5, RATE, 32), 5, 8, 0, 14)
    if not bool(((val == 30) & (nbv == 4)).any()):
        raise AssertionError("the N1 input took no fallback param")

    out = {}
    for name, (plan, fns, hs, lpc_order, prec) in batches.items():
        got = compare(name, plan, fns, hs, BLOCK, 8, lpc_order, prec)
        out[name] = dict(columns=list(got[0].shape), planes=str(plan.planes.dtype),
                         max_frame_bits=int(got[1].max()),
                         bound_ms=symbols_bound(plan, got[0].shape[1])[1])
    plan, fns, hs, lpc_order, prec = batches["config1"]
    fns = fns.to(dev)
    run = lambda: symbols.frame_symbols(plan, fns, hs, BLOCK, 8, lpc_order, prec)
    run_plain = lambda: bitpack.frame_symbol_stream(plan, fns, hs, BLOCK, 8, lpc_order, prec)
    s_plain, s_kernel = [cuda_ms(torch, run_plain, reps=5)], [cuda_ms(torch, run)]
    s_kernel.append(cuda_ms(torch, run))
    s_plain.append(cuda_ms(torch, run_plain, reps=5))
    b = symbols_bound(plan, symbols.symbol_columns(plan.kind.shape[0], BLOCK, 8, lpc_order))
    _log("2-symbols", max_abs_err=err, checked=len(checked), batches=out,
         config1_kernel_ms=s_kernel, config1_plain_ms=s_plain, config1_bound_bytes=b[0],
         config1_bound_ms=b[1], config1_bound_by=b[2], config1_bound_ops_ms=b[3],
         launches_here=symbols.KERNEL_LAUNCHES, ptxas=ptxas_of(("symbols_kernel",)))
    return {"name": "frame_symbols", "route": "cuda",
            "source": "zigflac_tpu_torch/csrc/symbols.cu",
            "replaces": "zigflac_tpu/ops/bitpack.py:472", "max_abs_err": err,
            "ms": sum(s_kernel) / len(s_kernel), "plain_ms": sum(s_plain) / len(s_plain),
            "bound_ms": b[1], "bound_by": b[2], "library_ms": None}


# positions at which a boundary case's running sum leaves int32, by block
# length: the first sample, the first tile, the middle, the last and the
# first position of a 32-position tile, and a ragged last tile
SYNTH_LEAVE_AT = [(100, 0), (100, 5), (200, 113), (200, 127), (200, 128), (110, 105)]
# tap counts the kernel compiles
SYNTH_TAP_COUNTS = (0, 1, 2, 3, 4, 8, 16, 24, 32)


def phase2_synth(env, streams) -> dict:
    """The synthesis kernel against its plain version on the card, with the
    arithmetic each block chose read back: random subframes; the boundaries
    of the int32 arithmetic; every compiled tap count in int32 and in 64-bit
    arithmetic, all on short blocks; then the first parsed batch of each
    FLAC in ``streams`` (name -> (FLAC bytes, bit depth)), timed. Returns
    the kernel's entry for the last lines: config 1's batch through the
    decoder's call, timed in turns with the checked wrapper and beside the
    plain version. tools/torch_synth_kernel.py times each variant alone."""
    torch, dev, synth = env.torch, env.dev, env.synth
    rng = np.random.default_rng(0x5CA7)
    max_err = 0

    def on_card(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    def compare(args):
        """Kernel == plain; returns the variant report of the launch as
        [taps, ended wide, tile at which it went wide or -1] per block of 32
        subframes."""
        nonlocal max_err
        synth.STATS = {}
        try:
            got = synth.synthesize_batch(*args)
        finally:
            stats, synth.STATS = synth.STATS, None
        want = synth.synthesize_batch_plain(*args)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"synthesis kernel != plain (max |diff| {err})")
        return stats["variants"]

    def expect(what, variants, want):
        got = variants[0].cpu().tolist()
        if got != want:
            raise AssertionError(f"synthesis variants, {what}: {got}, expected {want}")

    cases = [dict(m=100, b=4096), dict(m=3001, b=257), dict(m=37, b=1), dict(m=1, b=33),
             dict(m=5, b=65535), dict(m=64, b=1000, wrap=True), dict(m=40, b=31),
             dict(m=40, b=32)]
    counts = {}
    for kw in cases:
        v = compare(on_card(_subframes(rng, **kw)))
        counts["m{m}_b{b}".format(**kw) + ("_wrap" if kw.get("wrap") else "")] = (
            synth.variant_counts(v))
    if counts["m64_b1000_wrap"]["wide_from_start"] != 2 or counts["m100_b4096"]["narrow"] == 4:
        raise AssertionError(f"random subframes took unexpected variants: {counts}")

    # the boundaries of the narrow arithmetic, two blocks each: [taps, wide, tile]
    narrow, wide = 0, 1
    for coeff, start in (((1 << 31) - 1, narrow), (-(1 << 31), narrow), (1 << 31, wide),
                         (-(1 << 31) - 1, wide), (-(1 << 62), wide)):
        a = _quiet_subframes(rng, 64, 80, 2, shift=31)
        a[1][36, 0], a[1][36, 1] = coeff, 1
        a[0][36] = rng.integers(-3, 4, 80)
        expect(f"coefficient {coeff}", compare(on_card(a)),
               [[2, narrow, -1], [2, start, 0 if start else -1]])
    for b, at in SYNTH_LEAVE_AT:
        for back in (False, True):
            a = _quiet_subframes(rng, 64, b, 2)
            # row 7: a running sum that steps to 2^31 at ``at`` (and back)
            a[0][7] = 0
            a[0][7, at] = 1 << 31
            if back and at + 3 < b:
                a[0][7, at + 3] = -(1 << 31) - 5
            a[1][7] = 0
            a[1][7, 0], a[2][7], a[3][7] = 1, 0, min(1, at)
            expect(f"leaves int32 at {at} of {b}", compare(on_card(a)),
                   [[2, wide, at // 32], [2, narrow, -1]])
    for max_order in (1, 2, 3, 4):  # shifts all 0: the low word's own 32-bit multiply-add
        for at in (None, 3, 40, 95, 130):
            a = _fixed_subframes(rng, 40, 140, max_order)
            if at is not None:
                a[0][5, at] += 1 << 32
            expect(f"fixed predictors to order {max_order}, leaving int32 at {at}",
                   compare(on_card(a)),
                   [[max_order, narrow, -1] if at is None else [max_order, wide, at // 32],
                    [int(a[3][32:].max()), narrow, -1]])
    for value in ((1 << 31) - 1, -(1 << 31), 1 << 31, -(1 << 32)):  # 33-bit side samples
        a = _quiet_subframes(rng, 5, 70, 4)
        a[0][2, 40], a[1][2], a[3][2] = value, 0, 0
        fits = -(1 << 31) <= value < (1 << 31)
        expect(f"verbatim {value}", compare(on_card(a)),
               [[4, narrow, -1] if fits else [4, wide, 1]])
    for order in range(33):  # just below, at and above every compiled tap count
        taps = min(t for t in SYNTH_TAP_COUNTS if t >= order)
        expect(f"order {order}",
               compare(on_card(_quiet_subframes(rng, 33, 100, order))),
               [[taps, narrow, -1]] * 2)
    a = _quiet_subframes(rng, 6, 65, 0, wasted=7)  # constant and verbatim: a copy, shifted
    a[0][0] = 1234
    expect("order 0 with wasted bits", compare(on_card(a)), [[0, narrow, -1]])
    for taps in SYNTH_TAP_COUNTS:  # 64-bit from the first tile: a sample past int32 at its head
        a = _quiet_subframes(rng, 40, 100, taps)
        a[0][3, 0] = 1 << 40
        expect(f"{taps} taps in 64 bits", compare(on_card(a)),
               [[taps, wide, 0], [taps, narrow, -1]])

    parser = env.build.native_module()
    out = {}
    for name, (flac, depth) in streams.items():
        pos = env.decoder._parse_metadata(flac)[4]
        n, _, b, vb, qb, sb, *_ = parser.parse_frames(flac, pos, DECODE_BATCH_FRAMES, depth, 2)
        m = n * 2
        sow = np.frombuffer(sb, np.int32).reshape(m, 3).astype(np.int64)
        args = [torch.from_numpy(np.frombuffer(vb, np.int64).reshape(m, b).copy()).to(dev),
                torch.from_numpy(np.frombuffer(qb, np.int64).reshape(m, 32).copy()).to(dev),
                *(torch.from_numpy(sow[:, i].copy()).to(dev) for i in range(3))]
        variants = synth.variant_counts(compare(args))
        order = sow[:, 1]
        nbytes, bound_ms, bound_by, parts = synth_bound(
            m, b, int(order.sum()), int(order.max()), shift0=not sow[:, 0].any())
        run_kernel = lambda: synth.synthesize_batch(*args)
        run_decoders = lambda: synth._synthesize_unchecked(*args)
        run_plain = lambda: synth.synthesize_batch_plain(*args)
        # compare() has warmed both up; the plain loop is slow, so one run
        # of it on either side of the kernel's for config 1, one elsewhere.
        # The decoder's call and the checked wrapper, in turns
        plain = [cuda_ms(torch, run_plain, reps=1, warm=False)]
        kernel, unchecked = [cuda_ms(torch, run_kernel)], [cuda_ms(torch, run_decoders)]
        unchecked.append(cuda_ms(torch, run_decoders))
        kernel.append(cuda_ms(torch, run_kernel))
        if name == "config1":
            plain.append(cuda_ms(torch, run_plain, reps=1, warm=False))
        out[name] = dict(
            subframes=m, block=b, orders=np.bincount(order, minlength=1).tolist(),
            max_abs_value_bits=int(np.abs(np.frombuffer(vb, np.int64)).max()).bit_length(),
            variants=variants, kernel_ms=kernel, unchecked_ms=unchecked, plain_ms=plain,
            bound_bytes=nbytes,
            bound_ms=bound_ms, bound_by=bound_by, bound_parts=parts)
        del args
    if sum(out["config3"]["orders"][5:]) == 0:  # fixed predictors stop at order 4
        raise AssertionError("config 3's batch has no LPC subframe")
    for name in ("config1", "config3"):
        if out[name]["variants"]["narrow"] != out[name]["variants"]["blocks"]:
            raise AssertionError(f"{name}: a block left the int32 arithmetic: {out[name]}")
    if out["antiphase32"]["variants"]["narrow"] == out["antiphase32"]["variants"]["blocks"]:
        raise AssertionError("the 33-bit side channel never left the int32 arithmetic")
    _log("2-synth", random_cases=cases, random_variants=counts, boundary_cases_equal=True,
         streams=out, max_abs_err=max_err)
    c1 = out["config1"]
    return {
        "name": "synthesize_batch",
        "route": "cuda",
        "source": "zigflac_tpu_torch/csrc/synth.cu",
        "replaces": "zigflac_tpu/ops/synth.py:29",
        "max_abs_err": max_err,
        "ms": sum(c1["unchecked_ms"]) / len(c1["unchecked_ms"]),
        "checked_ms": sum(c1["kernel_ms"]) / len(c1["kernel_ms"]),
        "plain_ms": sum(c1["plain_ms"]) / len(c1["plain_ms"]),
        "bound_ms": c1["bound_ms"],
        "bound_by": c1["bound_by"],
        "bound_detail": c1["bound_parts"],
        "library_ms": None,
    }


def phase10_decode(env, tmp, cases, long_file) -> int:
    """Decode on the card. ``cases`` maps a name to (FLAC bytes, the WAV it
    was encoded from). Returns the synthesis kernel's launches over the
    counted decode paths."""
    zt, dev, decoder, torch = env.zt, env.dev, env.decoder, env.torch
    from zigflac_tpu_torch.utils import stages
    from zigflac_tpu_torch.wav import WavReader, wav_header_bytes

    launches = 0
    for name, (flac, wav) in cases.items():
        want = WavReader.from_bytes(wav).planar_samples()
        zt.decode_flac(flac, device=dev)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, k = env.counted_decode(name, lambda: zt.decode_flac(flac, device=dev))
        wall = time.perf_counter() - t0
        launches += k
        if not got.md5_ok or not np.array_equal(got.samples, want):
            raise AssertionError(f"decode {name}: samples or MD5 differ from the WAV's")
        decoder.STATS, env.synth.STATS, stages.COUNTS = {}, {}, {}
        zt.decode_flac(flac, device=dev)
        torch.cuda.synchronize()
        stats, decoder.STATS = decoder.STATS, None
        counts, stages.COUNTS = stages.COUNTS, None
        stats.update(h2d_bytes=counts["decoder.h2d_bytes"], d2h_bytes=counts["decoder.d2h_bytes"],
                     batches=counts["decoder.batches"])
        variants, env.synth.STATS = env.synth.variant_counts(env.synth.STATS["variants"]), None
        if name in NARROW_STREAMS and variants["narrow"] != variants["blocks"]:
            raise AssertionError(f"decode {name}: a block left the int32 arithmetic: {variants}")
        if name == "antiphase32" and variants["narrow"] == variants["blocks"]:
            raise AssertionError(f"decode {name}: no block left the int32 arithmetic")
        kernel_ms = [a.elapsed_time(b) for a, b in stats.pop("synth_events")]
        t0 = time.perf_counter()  # the MD5 and its byte serialization, part of every decode
        decoder._verify_md5(got.samples, got.info)
        stats["md5_s"] = time.perf_counter() - t0
        audio_s = got.info.interchannel_samples / got.info.sample_rate
        _log("10", stream=name, flac_bytes=len(flac), frames=got.frame_count, audio_s=audio_s,
             wall_s=wall, x_realtime=audio_s / wall, kernel_launches=k, plain_calls=0,
             md5_ok=True, equals_wav=True, kernel_ms_per_batch=kernel_ms,
             kernel_blocks=variants, **stats)
        del got, want

    flac1, wav1 = cases["config1"]
    audio_s = CONFIG1_SECONDS
    zt.decode_flac(flac1, backend="native")
    t0 = time.perf_counter()
    got = zt.decode_flac(flac1, backend="native")
    native_wall = time.perf_counter() - t0
    if not got.md5_ok or not np.array_equal(
            got.samples, WavReader.from_bytes(wav1).planar_samples()):
        raise AssertionError("decode config1 (native): samples or MD5 differ from the WAV's")
    del got
    src, out = os.path.join(tmp, "config1.flac"), os.path.join(tmp, "config1.decoded.wav")
    with open(src, "wb") as f:
        f.write(flac1)
    t0 = time.perf_counter()
    _, k = env.counted_decode("decode_file config1",
                              lambda: zt.decode_file(src, out, device=dev, verify=True))
    file_wall = time.perf_counter() - t0
    launches += k
    if _read(out) != wav1:
        raise AssertionError("decode_file config1: the WAV differs from the input")

    # 10 s from the middle of the 40-minute FLAC, by its SEEKTABLE
    start, n = LONG_SAMPLES // 2 + 321, 10 * RATE
    head = len(wav_header_bytes(LONG_SAMPLES, 2, RATE, 16))
    with open(long_file["wav"], "rb") as f:
        f.seek(head + 4 * start)
        want = np.frombuffer(f.read(4 * n), "<i2").reshape(n, 2).T
    long_flac = _read(long_file["flac"])
    if not decoder._parse_metadata(long_flac)[3]:
        raise AssertionError("the 40-minute FLAC has no SEEKTABLE")
    t0 = time.perf_counter()
    got, k = env.counted_decode(
        "decode_range", lambda: zt.decode_range(long_flac, start, n, device=dev))
    range_wall = time.perf_counter() - t0
    launches += k
    if not np.array_equal(got, want):
        raise AssertionError("decode_range: the slice differs from the WAV's")
    _log("10-more", native_config1_wall_s=native_wall, native_x_realtime=audio_s / native_wall,
         decode_file_config1_wall_s=file_wall, decode_file_x_realtime=audio_s / file_wall,
         decode_file_equals_wav=True, decode_range_start=start, decode_range_samples=n,
         decode_range_wall_s=range_wall, decode_range_launches=k, decode_range_equals_wav=True)
    return launches


def phase11_cli(env, tmp, album, long_file, wav3, want1):
    """The CLI as subprocesses on the card, CLI_CHILDREN_AT_ONCE at a time,
    with each one's wall and peak RSS. ``tmp`` holds config1.flac (phase
    10 wrote it)."""
    from concurrent.futures import ThreadPoolExecutor

    import resource

    device = ["--device", str(env.dev)]
    wav1_path = os.path.join(album["indir"], "config1.wav")
    flac1_path = os.path.join(tmp, "config1.flac")
    flac1 = _read(flac1_path)
    one = os.path.join(tmp, "one_block.wav")
    write_bench_wav(one, BLOCK)
    wav3_path = os.path.join(tmp, "config3.wav")
    with open(wav3_path, "wb") as f:
        f.write(wav3)
    pos = env.decoder._parse_metadata(flac1)[4]
    for name, at in (("config1.badframe.flac", pos + (len(flac1) - pos) // 2),
                     ("config1.badmd5.flac", 26)):  # 26: inside STREAMINFO's MD5
        bad = bytearray(flac1)
        bad[at] ^= 0xFF
        with open(os.path.join(tmp, name), "wb") as f:
            f.write(bytes(bad))
    p = lambda name: os.path.join(tmp, name)
    lpc_ogg = ["--ogg", "--prediction", "lpc"]
    jobs = {  # name -> (arguments, expected exit code)
        # the fixed cost: torch, the CUDA context and one one-frame batch
        "one_block": ([one, p("one_block.flac"), *device], 0),
        "a_config1": ([wav1_path, p("cli_a.flac"), *device], 0),
        "b_long": ([long_file["wav"], p("cli_b.flac"), *LONG_FLAGS, *device], 0),
        "c_batch": (["--batch", album["indir"], p("cli_batch"), *device], 0),
        "d_config3_ogg": ([wav3_path, p("cli_d.oga"), *lpc_ogg, *device], 0),
        "e_verify": ([wav1_path, p("cli_e.flac"), "--verify", *device], 0),
        "f_decode": (["-d", flac1_path, p("cli_f.wav"), *device], 0),
        "g_test": (["-t", flac1_path, *device], 0),
        "h_test_bad_frame": (["-t", p("config1.badframe.flac"), *device], 2),
        "i_test_bad_md5": (["-t", p("config1.badmd5.flac"), *device], 3),
        "j_list": (["-l", flac1_path], 0),
        # the metadata editor: needs no card
        "k_edit": ([p("config1.edit.flac"), "-e", "--remove-tag", "TITLE",
                    "--import-tags-from", p("tags.txt")], 0),
    }
    with open(p("config1.edit.flac"), "wb") as f:
        f.write(flac1)
    with open(p("tags.txt"), "w") as f:
        f.write(EDIT_TAGS)
    from zigflac_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    with ThreadPoolExecutor(CLI_CHILDREN_AT_ONCE) as pool:
        futures = {name: pool.submit(run_cli, args, expect=code)
                   for name, (args, code) in jobs.items()}
        # (d)'s reference from the CPU port, in this process meanwhile
        if cli_main([wav3_path, p("cli_d.cpu.oga"), *lpc_ogg, "--device", "cpu"]) != 0:
            raise AssertionError("the CPU port's CLI failed on config 3")
        done = {name: f.result() for name, f in futures.items()}
    pool_wall = time.perf_counter() - t0
    cli = {name: dict(wall_s=w, peak_rss_bytes=r, exit=jobs[name][1])
           for name, (w, r, _) in done.items()}

    if _sha(_read(p("cli_a.flac"))) != want1 or _sha(_read(p("cli_e.flac"))) != want1:
        raise AssertionError("cli (a, e): config 1 differs from the pinned stream")
    if _read(p("cli_b.flac")) != _read(long_file["flac"]):
        raise AssertionError("cli (b): the 40-minute file differs from encode_file's")
    rss_a, rss_b = cli["a_config1"]["peak_rss_bytes"], cli["b_long"]["peak_rss_bytes"]
    rss_room = (long_file["wav_size"] - os.path.getsize(wav1_path)) / 4
    if rss_b - rss_a >= rss_room:
        raise AssertionError(f"cli (b) peak RSS {rss_b} B exceeds (a)'s {rss_a} B by a "
                             f"quarter of the WAV size difference or more")
    for name, path in album["outs"].items():
        if _read(os.path.join(p("cli_batch"), name[:-4] + ".flac")) != _read(path):
            raise AssertionError(f"cli (c): {name} differs from encode_files'")
    got = _read(p("cli_d.oga"))
    if got[:4] != b"OggS" or got != _read(p("cli_d.cpu.oga")):
        raise AssertionError("cli (d): config 3 Ogg-FLAC differs from the CPU port's")
    if "verify: ok" not in done["e_verify"][2].splitlines():
        raise AssertionError(f"cli (e): no 'verify: ok' line:\n{done['e_verify'][2][-2000:]}")
    if _read(p("cli_f.wav")) != _read(wav1_path):
        raise AssertionError("cli (f): the decoded WAV differs from the input")
    for name, word in (("g_test", ": ok ("), ("h_test_bad_frame", ": FAILED ("),
                       ("i_test_bad_md5", "FAILED (MD5 mismatch)"), ("j_list", "STREAMINFO"),
                       ("k_edit", "+2 tag(s)")):
        if word not in done[name][2]:
            raise AssertionError(f"cli ({name}): no {word!r} in\n{done[name][2][-2000:]}")
    from zigflac_tpu_torch.metaedit import edit_metadata_bytes, parse_tags_file

    if _read(p("config1.edit.flac")) != edit_metadata_bytes(
            flac1, add_tags=parse_tags_file(EDIT_TAGS), remove_tags=["TITLE"])[0]:
        raise AssertionError("cli (k): the edited file differs from edit_metadata_bytes'")
    if cli_main(["-t", p("config1.edit.flac"), *device]) != 0:
        raise AssertionError("cli (k): -t fails on the edited file")
    # RUSAGE_CHILDREN reads at least this process's own peak (see
    # _CLI_WITH_PEAK), printed beside it; the check uses each child's own peak
    _log("11-cli", at_once=CLI_CHILDREN_AT_ONCE, pool_wall_s=pool_wall, runs=cli,
         rusage_children_max_rss=resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss * 1024,
         this_process_max_rss=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
         rss_b_minus_a=rss_b - rss_a, rss_room=rss_room, all_equal=True)


# One rank of phase 12b's gloo group on the shared card: argv = rank, port,
# the config-1 WAV. A warm-up encode, then a timed one with the deposit and
# symbols kernels' counts set to 0 before it; prints one line of JSON.
_RANK_CHILD = (
    "import hashlib, json, sys, time\n"
    "import torch\n"
    "import zigflac_tpu_torch as zt\n"
    "from zigflac_tpu_torch.models import pipeline\n"
    "from zigflac_tpu_torch.ops import deposit, symbols\n"
    "from zigflac_tpu_torch.parallel import distributed\n"
    "rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]\n"
    "t0 = time.perf_counter()\n"
    "assert distributed.initialize(f'127.0.0.1:{port}', 2, rank, backend='gloo')\n"
    "mesh = pipeline.DevicePipeline(zt.EncoderConfig.default(2), 16, 'cuda:0')._mesh\n"
    "with open(path, 'rb') as f:\n"
    "    wav = f.read()\n"
    "zt.encode_wav_bytes(wav, device='cuda:0')\n"
    "torch.cuda.synchronize()\n"
    "deposit.reset_counts()\n"
    "symbols.reset_counts()\n"
    "t1 = time.perf_counter()\n"
    "flac = zt.encode_wav_bytes(wav, device='cuda:0')\n"
    "torch.cuda.synchronize()\n"
    "wall = time.perf_counter() - t1\n"
    "print('RANK ' + json.dumps(dict(rank=rank, sha256=hashlib.sha256(flac).hexdigest(),\n"
    "    wall_s=wall, start_to_warm_s=t1 - t0, kernel_launches=deposit.KERNEL_LAUNCHES,\n"
    "    symbols_launches=symbols.KERNEL_LAUNCHES,\n"
    "    plain_calls=deposit.PLAIN_CALLS + symbols.PLAIN_CALLS,\n"
    "    mesh=[[p, str(d)] for p, d in mesh.entries])), flush=True)\n"
    "torch.distributed.destroy_process_group()\n"
)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase12_multi(env, album, wav1, wav32, cfg_lpc):
    """Multi-GPU on the one card: a two-shard mesh in this process (12a),
    two processes sharing the card over gloo (12b), and a one-process NCCL
    group (12c). Each wall beside the single device's, from this call."""
    import datetime

    import torch.distributed as tdist
    from zigflac_tpu_torch.parallel import distributed
    from zigflac_tpu_torch.parallel.mesh import default_mesh, encode_compact_sharded

    zt, dev, torch, pl = env.zt, env.dev, env.torch, env.pl
    mesh = default_mesh([torch.device("cuda", 0)] * SHARDS_ON_ONE_CARD)

    def sharded(wav, cfg=None):
        """encode_wav_bytes, with an Encoder whose pipeline shards over the mesh."""
        r = env.WavReader.from_bytes(wav)
        cfg = cfg or zt.EncoderConfig.default(r.channels)
        enc = zt.Encoder(cfg, r.bit_depth, dev)
        enc.pipeline = pl.DevicePipeline(cfg, r.bit_depth, dev, mesh=mesh)
        return enc.encode_stream(r.planar_samples(), r.flac_streaminfo(cfg.block_size),
                                 raw_pcm_bytes=bytes(r.raw_pcm_bytes()))

    def timed(path, fn, lpc=False):
        fn()  # warm-up
        env.sync()
        t0 = time.perf_counter()
        out, k, _ = env.counted(path, fn, lpc=lpc)
        return out, k, time.perf_counter() - t0

    calls = []
    real_overflow = pl.DevicePipeline._encode_overflow

    def spy(self, rec):
        calls.append([int(rec["chunk"].shape[0]), int(rec["nreal"])])
        return real_overflow(self, rec)

    # -- 12a: one process, two shards on the card ------------------------------
    flac, k, wall = timed("12a config 1, 2 shards", lambda: sharded(wav1))
    env.check("12a config 1", flac, CONFIG1_FLAC_BYTES, CONFIG1_FLAC_SHA)
    batches = -(-(CONFIG1_SECONDS * RATE // BLOCK) // 1024)
    if k != SHARDS_ON_ONE_CARD * batches + 1:  # and one for the tail
        raise AssertionError(f"12a: {k} deposit launches for {batches} batches on "
                             f"{SHARDS_ON_ONE_CARD} shards and a tail")
    _, k1, wall1 = timed("12a config 1, single device", lambda: zt.encode_wav_bytes(wav1, device=dev))
    cfg1 = zt.EncoderConfig.default(2)
    nf = 2 * SHARDS_ON_ONE_CARD + 3
    frames = env.WavReader.from_bytes(wav1).planar_samples()[:, : nf * BLOCK]
    frames = frames.reshape(2, nf, BLOCK).transpose(1, 0, 2).copy()
    per = (1 << (nf - 1).bit_length()) // SHARDS_ON_ONE_CARD  # 7 frames pad to 8: 4 a shard
    frames[:per] = np.random.default_rng(11).integers(-32768, 32768, (per, 2, BLOCK))
    info = zt.StreamInfo(RATE, 2, 16, nf * BLOCK, BLOCK, BLOCK)
    pl.DevicePipeline._encode_overflow = spy
    try:
        (rstream, rsizes), kr, _ = env.counted("12a ragged", lambda: pl.DevicePipeline(
            cfg1, 16, dev, mesh=mesh).encode_frames_stream(frames, 0, info))
    finally:
        pl.DevicePipeline._encode_overflow = real_overflow
    ragged_calls, calls[:] = list(calls), []
    sstream, ssizes = pl.DevicePipeline(cfg1, 16, dev).encode_frames_stream(frames, 0, info)
    if rstream != sstream or rsizes.tolist() != ssizes.tolist():
        raise AssertionError("12a ragged: the sharded stream differs from the single device's")
    # the first shard's four noise frames overflow tier 0; the second
    # shard's three tonal frames and padding do not
    if ragged_calls != [[per, per]]:
        raise AssertionError(f"12a ragged: ladder re-encodes {ragged_calls}, expected "
                             f"{[[per, per]]}")
    pl.DevicePipeline._encode_overflow = spy
    try:
        flac, k32, wall32 = timed("12a 32-bit LPC, 2 shards", lambda: sharded(wav32, cfg_lpc),
                                  lpc=True)
    finally:
        pl.DevicePipeline._encode_overflow = real_overflow
    lpc32_calls, calls[:] = [c for c in calls if c[0] > 1], []
    env.check("12a 32-bit LPC", flac, *DEPTH32_FLAC["lpc"])
    if lpc32_calls[-2:] != [[512, 512], [512, 512]]:  # the timed run's: each shard overflows
        raise AssertionError(f"12a 32-bit LPC: ladder re-encodes {lpc32_calls}")
    _, k32s, wall32s = timed("12a 32-bit LPC, single device",
                             lambda: zt.encode_wav_bytes(wav32, config=cfg_lpc, device=dev),
                             lpc=True)
    _log("12a", shards=[str(d) for d in mesh.devices], config1_wall_s=wall,
         config1_single_wall_s=wall1, config1_launches=k, config1_single_launches=k1,
         config1_sha256=CONFIG1_FLAC_SHA, ragged_frames=nf, ragged_launches=kr,
         ragged_overflow_reencodes=ragged_calls, ragged_equals_single=True,
         lpc32_wall_s=wall32, lpc32_single_wall_s=wall32s, lpc32_launches=k32,
         lpc32_single_launches=k32s, lpc32_overflow_reencodes=lpc32_calls[-2:])

    # -- 12b: two processes sharing the card, gloo ------------------------------
    port = _free_port()
    wav1_path = os.path.join(album["indir"], "config1.wav")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_CHILD, str(r), str(port), wav1_path],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            proc.kill()
    pool_wall = time.perf_counter() - t0
    ranks = []
    for r, (proc, text) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            raise AssertionError(f"12b rank {r} exited {proc.returncode}:\n{text[-4000:]}")
        ranks.append(json.loads(next(ln for ln in text.splitlines()
                                     if ln.startswith("RANK "))[5:]))
    for got in ranks:
        if got["sha256"] != CONFIG1_FLAC_SHA or len(got["mesh"]) != 2:
            raise AssertionError(f"12b: rank {got['rank']} gave {got}")
        if (got["kernel_launches"] != batches + 1 or got["symbols_launches"] != batches + 1
                or got["plain_calls"]):
            raise AssertionError(f"12b: rank {got['rank']}: {got['kernel_launches']} launches")
    _log("12b", processes=2, backend="gloo", pool_wall_s=pool_wall, ranks=ranks,
         single_device_wall_s=wall1, all_equal_pinned=True)

    # -- 12c: a one-process NCCL group ---------------------------------------
    port = _free_port()
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                             rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        if distributed.collective_device().type != "cuda":
            raise AssertionError("12c: the NCCL group's collectives are not on the card")
        t0 = time.perf_counter()
        payload, sizes = distributed.allgather_parts(b"zigflac" * 1000, np.arange(7))
        gather_s = time.perf_counter() - t0
        if payload != b"zigflac" * 1000 or sizes.tolist() != list(range(7)):
            raise AssertionError("12c: allgather_parts over NCCL changed its part")
        one = default_mesh()
        n = 1024
        batch = env.WavReader.from_bytes(wav1).planar_samples()[:, : n * BLOCK]
        batch = batch.reshape(2, n, BLOCK).transpose(1, 0, 2).astype(np.int16)
        fns = np.arange(n, dtype=np.int64)
        (rows, cap), kc, _ = env.counted("12c encode_compact_sharded", lambda: encode_compact_sharded(
            batch, fns, cfg1, 16, RATE, 0, one))
        stream, meta = rows[0]
        got = pl._collect_aligned(stream, meta[:-1], n, cap)
        want = pl.DevicePipeline(cfg1, 16, dev).encode_frames_stream(
            batch.astype(np.int32), 0, zt.StreamInfo(RATE, 2, 16, n * BLOCK, BLOCK, BLOCK))
        if meta[-2:].tolist() != [0, 0] or got is None or got[0] != want[0]:
            raise AssertionError("12c: config 1's batch differs from the unsharded pipeline's")
        noise = np.random.default_rng(12).integers(-32768, 32768, (64, 2, BLOCK)).astype(np.int16)
        rows, _ = encode_compact_sharded(noise, np.arange(64), cfg1, 16, RATE, 0, one)
        flags = rows[0][1][-2:].tolist()
        if flags != [1, 1]:
            raise AssertionError(f"12c: noise batch overflow flags {flags}, expected [1, 1]")
    finally:
        tdist.destroy_process_group()
    _log("12c", backend="nccl", world_size=1, allgather_s=gather_s, launches=kc,
         config1_batch_equals_single=True, noise_overflow_flags=flags,
         note="world size 1: a scaling number needs a machine with more than one card")


# the cases of tests/test_regression_corpus.py with their synthesis recipe
CORPUS = [
    dict(name="tonal_16_2", kind="tonal", depth=16, channels=2, n=2 * BLOCK + 1500, seed=1),
    dict(name="noise_16_2", kind="noise", depth=16, channels=2, n=BLOCK + 777, seed=2),
    dict(name="silence_16_2", kind="silence", depth=16, channels=2, n=BLOCK + 100),
    dict(name="dc_16_2", kind="dc", depth=16, channels=2, n=BLOCK + 64),
    dict(name="impulse_16_2", kind="impulse", depth=16, channels=2, n=2 * BLOCK + 1111, seed=3),
    dict(name="ramp_16_2", kind="ramp", depth=16, channels=2, n=BLOCK),
    dict(name="alt_max_16_2", kind="alt_max", depth=16, channels=2, n=BLOCK + 333),
    dict(name="quiet_16_2", kind="quiet_noise", depth=16, channels=2, n=BLOCK + 2048, seed=4),
    dict(name="speech_16_2", kind="speech", depth=16, channels=2, n=2 * BLOCK, seed=5),
    dict(name="tonal_8_2", kind="tonal", depth=8, channels=2, n=BLOCK + 500, seed=6),
    dict(name="tonal_24_2", kind="tonal", depth=24, channels=2, n=BLOCK + 500, seed=7,
         rate=96000),
    dict(name="noise_32_2", kind="noise", depth=32, channels=2, n=BLOCK + 200, seed=8),
    dict(name="tonal_32_2", kind="tonal", depth=32, channels=2, n=BLOCK + 64, seed=9),
    dict(name="tonal_12_2", kind="tonal", depth=12, channels=2, n=BLOCK + 96, seed=19),
    dict(name="tonal_16_1", kind="tonal", depth=16, channels=1, n=BLOCK + 900, seed=10),
    dict(name="tonal_16_8", kind="tonal", depth=16, channels=8, n=BLOCK + 128, seed=11),
    dict(name="lpc_tonal_16_2", kind="tonal", depth=16, channels=2, n=2 * BLOCK + 1500,
         seed=1, lpc=True),
    dict(name="lpc_speech_16_2", kind="speech", depth=16, channels=2, n=2 * BLOCK, seed=5,
         lpc=True, order=12),
    dict(name="lpc_tonal_24_2", kind="tonal", depth=24, channels=2, n=BLOCK + 500, seed=7,
         lpc=True),
    dict(name="tiny_tail_16_2", kind="tonal", depth=16, channels=2, n=BLOCK + 63, seed=12),
    dict(name="exact_16_2", kind="tonal", depth=16, channels=2, n=2 * BLOCK, seed=13),
    dict(name="block1024_16_2", kind="tonal", depth=16, channels=2, n=3 * 1024 + 200,
         seed=14, block=1024),
]


def _corpus_pcm(case) -> np.ndarray:
    n, depth, ch, kind = case["n"], case["depth"], case["channels"], case["kind"]
    lim = 1 << (depth - 1)
    if kind == "silence":
        x = np.zeros((ch, n))
    elif kind == "dc":
        x = np.full((ch, n), -(lim // 3), dtype=np.float64)
    elif kind == "impulse":
        x = np.zeros((ch, n))
        for c in range(ch):
            x[c, (n * (c + 1)) // (ch + 1)] = (lim - 1) * (-1 if c % 2 else 1)
    elif kind == "ramp":
        x = np.tile(np.arange(n, dtype=np.float64) % 2048 - 1024, (ch, 1))
    elif kind == "alt_max":
        x = np.tile(np.where(np.arange(n) % 2 == 0, lim - 1, -lim).astype(np.float64), (ch, 1))
    elif kind in ("noise", "quiet_noise"):
        frac = 2.0 ** -10 if kind == "quiet_noise" else 1.0
        rng = np.random.default_rng(case["seed"])
        x = rng.uniform(-(lim - 1) * frac, (lim - 1) * frac, size=(ch, n))
    elif kind == "tonal":
        rng = np.random.default_rng(case["seed"])
        t = np.arange(n)
        scale = 2.0 ** (depth - 16)
        base = scale * (9000.0 * np.sin(2 * np.pi * 440 * t / 44100)
                        + 9000.0 / 3 * np.sin(2 * np.pi * 97 * t / 44100))
        x = np.stack([(1.0 - 0.1 * c) * base + rng.normal(0, 120.0 * scale, n)
                      for c in range(ch)])
    elif kind == "speech":
        rng = np.random.default_rng(case["seed"])
        e = rng.normal(0, 2.0 ** (depth - 16) * 600, size=(ch, n))
        e *= (np.arange(n) // 3000) % 3 != 2
        x = np.zeros_like(e)
        for i in range(2, n):
            x[:, i] = 1.6 * x[:, i - 1] - 0.68 * x[:, i - 2] + e[:, i]
    else:
        raise AssertionError(kind)
    return np.clip(np.round(x), -lim, lim - 1).astype(np.int64)


def _rand_stream(rng, n, s, max_nbv=20, gap=4, kill=0.0, full64=False):
    """Random deposit stream: field widths nb >= value widths nbv."""
    nbv = rng.integers(0, max_nbv, (n, s))
    if kill:
        nbv = np.where(rng.random((n, s)) < kill, 0, nbv)
    nb = np.where(nbv > 0, nbv + rng.integers(0, gap, (n, s)), 0)
    d_cum = np.cumsum(nb, axis=1)
    val = rng.integers(-(2**63), 2**63 - 1, (n, s), dtype=np.int64, endpoint=True)
    if not full64:  # values already cut to their width
        val &= np.where(nbv >= 64, -1, (np.int64(1) << np.minimum(nbv, 63)) - 1)
    return d_cum.astype(np.int32), val, nbv.astype(np.int32)


# -- timing -------------------------------------------------------------------

def cuda_ms(torch, fn, reps=20, warm=True):
    """Mean milliseconds of fn() over reps launches, after one warm-up
    unless the caller has already made it."""
    if warm:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    # -- phase 0 --------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: needs exactly one visible card, found "
              f"{torch.cuda.device_count()} (set CUDA_VISIBLE_DEVICES)", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _log("0", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    print(smi, flush=True)

    import zigflac_tpu_torch as zt
    from zigflac_tpu_torch.models import pipeline as pl
    from zigflac_tpu_torch import native
    from zigflac_tpu_torch.native import md5
    from zigflac_tpu_torch import decoder
    from zigflac_tpu_torch.crc import crc16 as crc16_bytes
    from zigflac_tpu_torch.ops import (_build, analyze, bitpack, crc16, deposit, lpc, symbols,
                                       synth, unpack)
    from zigflac_tpu_torch.utils import stages
    from zigflac_tpu_torch.utils.apodization import TUKEY_HALF, windows_of
    from zigflac_tpu_torch.wav import WavReader, write_wav

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- phase 1 --------------------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    # nvcc and g++ side by side, and the inputs made meanwhile
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(2)
    builds = [pool.submit(_build.library), pool.submit(_build.native_module)]

    # -- inputs ---------------------------------------------------------------
    wav1 = bench_wav(write_wav, CONFIG1_SECONDS * RATE)
    wav3 = bench_wav(write_wav, CONFIG3_SAMPLES)
    wav32 = bench_wav(write_wav, DEPTH32_SAMPLES, depth=32)
    for name, wav, sha in (("config 1", wav1, CONFIG1_WAV_SHA), ("config 3", wav3, CONFIG3_WAV_SHA),
                           ("32-bit", wav32, DEPTH32_WAV_SHA)):
        if _sha(wav) != sha:
            raise AssertionError(f"{name} input synthesis drifted")
    noise = np.random.default_rng(0x3232).integers(
        -(1 << 31), 1 << 31, (2, NOISE32_FRAMES * BLOCK))
    buf = io.BytesIO()
    write_wav(buf, noise, RATE, 32)
    wav_noise = buf.getvalue()
    t = np.arange(ANTIPHASE32_FRAMES * BLOCK)
    left = np.round(1.9e9 * np.sin(2 * np.pi * 440 * t / RATE)).astype(np.int64)
    hiss = np.random.default_rng(0x33).integers(-(1 << 20), 1 << 20, len(t))
    buf = io.BytesIO()
    write_wav(buf, np.stack([left + hiss, -left + hiss]), RATE, 32)
    wav_anti = buf.getvalue()
    cfg1 = zt.EncoderConfig.default(2)
    cfg_lpc = replace(cfg1, prediction="lpc")
    inputs_s = time.perf_counter() - t0
    for b in builds:
        b.result()
    pool.shutdown()
    _log("1", build_and_inputs_s=round(time.perf_counter() - t0, 3), inputs_s=inputs_s,
         nvcc_s=_build.BUILD_SECONDS, gxx_s=_build.NATIVE_BUILD_SECONDS,
         have_native=native.HAVE_NATIVE, native_module=getattr(native._n, "__name__", None),
         ptxas=[ln for ln in _build.BUILD_LOG.splitlines() if "Used" in ln or "spill" in ln])

    # -- phase 2: kernel against plain on the card ----------------------------
    rng = np.random.default_rng(0xF1AC)
    max_err = 0

    def compare(d_cum, val, nbv, max_words):
        nonlocal max_err
        got = deposit.deposit_words(d_cum, val, nbv, max_words)
        want = deposit.deposit_words_plain(d_cum, val, nbv, max_words)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"deposit kernel != plain (max |diff| {err})")

    def compare_np(d_cum, val, nbv, max_words):
        compare(*[torch.from_numpy(a).to(dev) for a in (d_cum, val, nbv)], max_words)

    cases = [
        dict(n=3, s=200), dict(n=2, s=513), dict(n=1, s=64),
        dict(n=2, s=150, max_nbv=34),               # 33-bit side samples
        dict(n=2, s=151, max_nbv=18, kill=0.4),     # masked, odd columns
        dict(n=3, s=300, max_nbv=65, gap=9),        # values up to 64 bits
        dict(n=2, s=300, max_nbv=65, full64=True),  # bits above nbv ignored
    ]
    for kw in cases:
        d_cum, val, nbv = _rand_stream(rng, **kw)
        compare_np(d_cum, val, nbv, int(d_cum.max()) // 32 + 3)
    d_cum, val, nbv = _rand_stream(rng, 2, 300)
    compare_np(d_cum, val, nbv, int(d_cum.max()) // 32 // 2)  # word-budget clamp
    d_cum, val, nbv = _rand_stream(rng, 4, 20000, max_nbv=40, gap=12)
    big = int(d_cum.max()) // 32 + 3
    if big * 4 <= deposit.shared_row_bytes():
        raise AssertionError("the oversized-row case fits shared memory")
    compare_np(d_cum, val, nbv, big)  # global-memory branch

    sym_batches = {}  # the plans, for phase 2-symbols

    def batch_stream(name, wav, cfg, tier):
        """The symbol stream of a wav's first 1024 full frames, and the
        word budget of capacity tier ``tier`` (None: the exact tier); the
        plan is kept in sym_batches under ``name``."""
        r = WavReader.from_bytes(wav)
        s = r.planar_samples()
        n = min(1024, s.shape[1] // BLOCK)
        frames = torch.from_numpy(
            s[:, : n * BLOCK].reshape(2, n, BLOCK).transpose(1, 0, 2).copy()).to(dev)
        hs, max_words, _ = pl.compact_shape(cfg, r.bit_depth, 2, BLOCK, r.sample_rate, tier, n)
        plan = analyze.plan_frames(frames, r.bit_depth, cfg)
        fns = torch.arange(n, device=dev)
        dep_cum, _, dep_val, dep_nbv = bitpack.frame_symbol_stream(
            plan, fns, hs, BLOCK, cfg.max_rice_order, analyze.lpc_order_of(cfg),
            cfg.lpc_precision)
        sym_batches[name] = (plan, fns, hs, analyze.lpc_order_of(cfg), cfg.lpc_precision)
        return dep_cum.to(torch.int32), dep_val, dep_nbv.to(torch.int32), max_words, plan

    crc_err = 0

    def compare_crc(words, byte_len, copy=None):
        """CRC kernel == plain (it ORs into ``words`` in place: give it
        ``copy``, equal to ``words``, or a clone), and == crc.crc16 of the
        bytes of a few frames."""
        nonlocal crc_err
        want = crc16.crc16_frames_plain(words, byte_len)
        got_ro, _ = crc16.crc16_frames(words, byte_len, write=False)
        got = crc16.crc16_frames(words.clone() if copy is None else copy, byte_len)
        torch.cuda.synchronize()
        for g, w in ((got_ro, want[0]), *zip(got, want)):
            if not torch.equal(g, w):
                crc_err = max(crc_err, 1, int((g.double() - w.double()).abs().max()))
        if crc_err:
            raise AssertionError(f"CRC kernel != plain (max |diff| {crc_err})")
        rows = words.cpu().numpy().astype(">i4")
        for f in (0, rows.shape[0] // 2, rows.shape[0] - 1):
            n = int(byte_len[f])
            if n <= 4 * rows.shape[1] and crc16_bytes(rows[f].tobytes()[:n]) != int(got[0][f]):
                raise AssertionError(f"CRC kernel: frame {f} differs from crc.crc16")

    # the CRC kernel's watch cases: lengths 0-20 (every residue mod 4 and
    # 16), about a round of a frame's lanes and about the row's end, frames
    # over the row, rows of one to three words, rows off 16 bytes (the
    # kernel's word branch, written in place there too)
    for w, offset in ((1, 0), (2, 0), (3, 0), (37, 0), (5504, 0), (5504, 1), (18432, 3)):
        lens = np.array(sorted({*range(21), 1023, 1024, 1025, 4095, 4096, 4097, 4 * w - 1,
                                4 * w, 4 * w + 9}))
        be = rng.integers(0, 256, (lens.size, 4 * w), dtype=np.uint8)
        be[np.arange(4 * w)[None, :] >= lens[:, None]] = 0
        flat = np.concatenate([np.zeros(offset, np.int32),
                               be.view(">i4").astype(np.int32).ravel()])
        rows, copy = (torch.from_numpy(flat).to(dev)[offset:].view(lens.size, w) for _ in "ab")
        compare_crc(rows, torch.from_numpy(lens).to(dev), copy)
    crc_watch = crc_err == 0

    streams, crc_streams = {}, {}
    for name, wav, cfg, tier in (("config1", wav1, cfg1, 0), ("config3", wav3, cfg_lpc, 0),
                                 ("depth32_lpc", wav32, cfg_lpc, 0),
                                 ("noise32_exact", wav_noise, cfg1, None)):
        dc, dv, dn, mw, plan = batch_stream(name, wav, cfg, tier)
        compare(dc, dv, dn, mw)
        words = deposit.deposit_words(dc, dv, dn, mw)
        byte_len = (dc[:, -1].to(torch.int64) + 7) >> 3
        compare_crc(words, byte_len)
        scratch = words.clone()
        crc_streams[name] = dict(
            rows=list(words.shape), frame_bytes_max=int(byte_len.max()),
            bound_ms=crc_bound(byte_len.cpu().numpy(), mw)[1],
            kernel_ms=cuda_ms(torch, lambda: crc16.crc16_frames(scratch, byte_len)),
            plain_ms=cuda_ms(torch, lambda: crc16.crc16_frames_plain(words, byte_len), reps=5))
        if name == "config1":
            crc_timed = (words, byte_len, mw)
        del scratch
        streams[name] = dict(
            symbols=list(dc.shape), max_words=mw, max_value_bits=int(dn.max()),
            lpc_subframes=int((plan.kind == 3).sum()),
            bound_ms=deposit_bound(dc.shape[0], dc.numel(), mw)[1],
            bound_ops_ms=deposit_bound(dc.shape[0], dc.numel(), mw)[3],
            kernel_ms=cuda_ms(torch, lambda: deposit.deposit_words(dc, dv, dn, mw)),
            plain_ms=cuda_ms(torch, lambda: deposit.deposit_words_plain(dc, dv, dn, mw), reps=5),
        )
        if name == "config1":
            timed = (dc, dv, dn, mw)
        del dc, dv, dn, plan
    if streams["config3"]["lpc_subframes"] == 0:
        raise AssertionError("config 3's batch has no LPC subframe")
    if streams["depth32_lpc"]["max_value_bits"] < 33:
        raise AssertionError("the 32-bit batch has no 33-bit side sample")
    if streams["noise32_exact"]["max_words"] * 4 <= deposit.shared_row_bytes():
        raise AssertionError("the exact-tier 32-bit rows fit shared memory")
    dc32, dep_val, nbv32, max_words = timed
    run_kernel = lambda: deposit.deposit_words(dc32, dep_val, nbv32, max_words)
    run_plain = lambda: deposit.deposit_words_plain(dc32, dep_val, nbv32, max_words)
    plain_a, kern_a = cuda_ms(torch, run_plain), cuda_ms(torch, run_kernel)
    kern_b, plain_b = cuda_ms(torch, run_kernel), cuda_ms(torch, run_plain)
    kernel_ms, plain_ms = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
    bound_bytes, bound_ms, bound_by, bound_ops_ms = deposit_bound(
        dc32.shape[0], dc32.numel(), max_words)
    _log("2", streams=streams, max_abs_err=max_err, kernel_ms=[kern_a, kern_b],
         plain_ms=[plain_a, plain_b], bound_bytes=bound_bytes, bound_ms=bound_ms,
         bound_ops_ms=bound_ops_ms)
    del timed, dc32, dep_val, nbv32

    # -- phase 2-crc: config 1's batch timed in turns with the plain version
    words, byte_len, mw = crc_timed
    scratch = words.clone()
    run_kernel = lambda: crc16.crc16_frames(scratch, byte_len)
    run_plain = lambda: crc16.crc16_frames_plain(words, byte_len)
    c_plain, c_kernel = [cuda_ms(torch, run_plain, reps=5)], [cuda_ms(torch, run_kernel)]
    c_kernel.append(cuda_ms(torch, run_kernel))
    c_plain.append(cuda_ms(torch, run_plain, reps=5))
    crc_b = crc_bound(byte_len.cpu().numpy(), mw)
    _log("2-crc", watch_cases_equal=crc_watch, streams=crc_streams, max_abs_err=crc_err,
         kernel_ms=c_kernel,
         plain_ms=c_plain, bound_bytes=crc_b[0], bound_ms=crc_b[1], bound_by=crc_b[2],
         bound_ops_ms=crc_b[3])
    crc_entry = {
        "name": "crc16_frames", "route": "cuda", "source": "zigflac_tpu_torch/csrc/crc16.cu",
        "replaces": "zigflac_tpu/ops/crc16.py:54", "max_abs_err": crc_err,
        "ms": sum(c_kernel) / len(c_kernel), "plain_ms": sum(c_plain) / len(c_plain),
        "bound_ms": crc_b[1], "bound_by": crc_b[2], "library_ms": None}
    del crc_timed, words, byte_len, scratch

    # -- phase 2-symbols: the watch cases and the batches' real plans ---------
    wav2_in = bench_wav(write_wav, CONFIG2_SAMPLES, depth=24, rate=CONFIG2_RATE)
    batch_stream("config2", wav2_in, cfg1, 0)
    symbols_entry = phase2_symbols(SimpleNamespace(
        torch=torch, dev=dev, zt=zt, symbols=symbols, bitpack=bitpack, analyze=analyze),
        sym_batches)
    del sym_batches

    # -- phase 2-unpack: every depth, then config 1's and config 2's batches ---
    unpack_watch = 0
    for depth in range(4, 33):
        nb, c = (depth + 7) // 8, 1 + depth % 8
        data = torch.from_numpy(np.random.default_rng(depth).integers(
            0, 256, 5 * 777 * c * nb, dtype=np.uint8)).to(dev)
        for block, nreal, n in ((777, 5, 8), (1, 1, 1), (777, 1, 1)):
            got = unpack.unpack_pcm(data, c, nb, depth, block, nreal, n)
            want = unpack.unpack_pcm_plain(data, c, nb, depth, block, nreal, n)
            if not torch.equal(got, want):
                raise AssertionError(f"unpack: kernel != plain at depth {depth}, {c} channels, "
                                     f"block {block}, {nreal} of {n} rows")
            unpack_watch += 1
    unpack_streams = {}
    for name, wav in (("config1", wav1), ("config2", wav2_in)):
        pcm, c, nb, depth, block, n = unpack_batch(WavReader, wav)
        data = torch.from_numpy(pcm.copy()).to(dev)
        got = unpack.unpack_pcm(data, c, nb, depth, block, n, n)
        planar = WavReader.from_bytes(wav).planar_samples()[:, : n * block]
        if not (torch.equal(got, unpack.unpack_pcm_plain(data, c, nb, depth, block, n, n))
                and np.array_equal(got.cpu().numpy(),
                                   planar.reshape(c, n, block).transpose(1, 0, 2))):
            raise AssertionError(f"unpack: {name}'s batch differs from the host de-interleave")
        b = unpack_bound(n, c, block, nb)
        unpack_streams[name] = dict(
            shape=[n, c, block], nb=nb,
            kernel_ms=[cuda_ms(torch, lambda: unpack.unpack_pcm(data, c, nb, depth, block, n, n))
                       for _ in range(2)],
            plain_ms=cuda_ms(torch, lambda: unpack.unpack_pcm_plain(data, c, nb, depth, block,
                                                                    n, n), reps=5),
            bound_bytes=b[0], bound_ms=b[1], bound_by=b[2], bound_ops_ms=b[3])
        del data, got, planar
    _log("2-unpack", watch_cases_equal=unpack_watch, streams=unpack_streams)
    u1 = unpack_streams["config1"]
    unpack_entry = {
        "name": "unpack_pcm", "route": "cuda", "source": "zigflac_tpu_torch/csrc/unpack.cu",
        "replaces": None, "max_abs_err": 0, "ms": sum(u1["kernel_ms"]) / 2,
        "plain_ms": u1["plain_ms"], "bound_ms": u1["bound_ms"], "bound_by": u1["bound_by"],
        "library_ms": None}

    # -- phase 2-analysis: the planes analyze_planes hands the kernel ---------
    def batch_planes(wav, depth):
        """One batch's (planes, wide, max_param) as plan_frames_stereo makes
        them: L/R/M/S int32, or at depth 32 L/R/M int32 and the side int64."""
        s = WavReader.from_bytes(wav).planar_samples()
        n = min(1024, s.shape[1] // BLOCK)
        fr = torch.from_numpy(s[:, : n * BLOCK].reshape(2, n, BLOCK).copy()).to(dev)
        left, right = fr[0].to(torch.int64), fr[1].to(torch.int64)
        mid, side = (left + right) >> 1, left - right
        max_param = 30 if depth > 16 else 14
        if depth == 32:
            return [(torch.stack([left, right, mid]).to(torch.int32), True, max_param),
                    (side, True, max_param)]
        return [(torch.stack([left, right, mid, side]).to(torch.int32), False, max_param)]

    an_batches = {"config1": batch_planes(wav1, 16), "config3": batch_planes(wav3, 16),
                  "depth32": batch_planes(wav32, 32),
                  "config2": batch_planes(wav2_in, 24)}
    l_order, l_res, *_ = lpc.analyze_lpc(an_batches["config3"][0][0], cfg_lpc.lpc_order,
                                         cfg_lpc.lpc_precision)
    fixed_entry, rice_entry = phase2_analysis(
        SimpleNamespace(torch=torch, dev=dev, analyze=analyze), an_batches, (l_res, l_order))
    del an_batches, l_order, l_res
    # the encode refuses a partition order above 8 as the JAX package does
    # (ValueError), before any device work
    counts = (analyze.KERNEL_LAUNCHES, symbols.KERNEL_LAUNCHES, deposit.KERNEL_LAUNCHES,
              crc16.KERNEL_LAUNCHES)
    try:
        zt.encode_wav_bytes(wav3, config=replace(cfg1, max_rice_order=12), device="cuda")
        raise AssertionError("max_rice_order 12 at block 4096 was not refused")
    except ValueError:
        pass
    if counts != (analyze.KERNEL_LAUNCHES, symbols.KERNEL_LAUNCHES, deposit.KERNEL_LAUNCHES,
                  crc16.KERNEL_LAUNCHES):
        raise AssertionError("the refused encode launched a kernel")

    # the port's first-min / last-min tie rules on the card
    ties = torch.tensor([[3, 1, 2], [1, 1, 5], [1, 0, 2]], device=dev)
    if (analyze.argmin_first(ties).tolist(), analyze.argmin_last(ties).tolist()) != (
            [1, 2, 0], [2, 2, 2]):
        raise AssertionError("argmin tie rule differs on the card")

    # the CPU port's bytes for phase 6's noise batch, made before any counted path
    noise_cpu = zt.encode_wav_bytes(wav_noise, device="cpu")

    launches = {"total": 0, "global_rows": 0, "analysis": 0, "rice": 0, "crc": 0, "symbols": 0,
                "unpack": 0, "lags": 0}
    lpc_ops = lpc  # counted() takes a flag of that name

    def counted(path, fn, lpc=False, fed=False):
        """Run one encode path with the counts at 0 before it; it must
        launch the analysis, symbols, deposit and CRC kernels (and, with
        ``lpc``, the Rice and lag sums kernels, the lag sums for every plane
        and window the search counts) and never call a plain version. The PCM
        unpack must launch once a dispatch where the path took the card-fed
        route (``fed``: it must, and encode every row from the unpack's
        frames), else never."""
        for m in (deposit, synth, analyze, crc16, symbols, unpack, lpc_ops):
            m.reset_counts()
        armed = stages.SPANS is None
        if armed:
            stages.SPANS, stages.COUNTS = [], {}
        try:
            out = fn()
            torch.cuda.synchronize()
            spans, counts = stages.totals(), dict(stages.COUNTS)
        finally:
            if armed:
                stages.SPANS = stages.COUNTS = None
        k, g, p = deposit.KERNEL_LAUNCHES, deposit.GLOBAL_ROW_LAUNCHES, deposit.PLAIN_CALLS
        ka, kr, kc = analyze.KERNEL_LAUNCHES, analyze.RICE_KERNEL_LAUNCHES, crc16.KERNEL_LAUNCHES
        ks, kl = symbols.KERNEL_LAUNCHES, lpc_ops.LAG_KERNEL_LAUNCHES
        plain = (p + synth.PLAIN_CALLS + analyze.PLAIN_CALLS + crc16.PLAIN_CALLS
                 + symbols.PLAIN_CALLS + unpack.PLAIN_CALLS + lpc_ops.PLAIN_CALLS)
        if (k == 0 or ka == 0 or kc == 0 or ks == 0 or (lpc and (kr == 0 or kl == 0))
                or plain != 0):
            raise AssertionError(f"{path}: {k} deposit, {ka} analysis, {ks} symbols, {kr} Rice, "
                                 f"{kl} lag sums and {kc} CRC launches, {plain} plain calls")
        evals = (counts.get("lpc.lag_kernel_evals", 0), counts.get("lpc.window_evals", 0))
        if evals[0] != evals[1]:
            raise AssertionError(f"{path}: the lag sums kernel ran {evals[0]} planes x windows "
                                 f"of the search's {evals[1]}")
        unpacked = counts.get("pipeline.frames_unpacked", 0)
        dispatches = sum(spans[n][0] for n in ("pipeline.dispatch_batch",
                                               "pipeline.dispatch_tail") if n in spans)
        ku = unpack.KERNEL_LAUNCHES
        if (fed and unpacked != counts.get("pipeline.frames_encoded")) or (
                ku != (dispatches if unpacked else 0)):
            raise AssertionError(f"{path}: {ku} unpack launches in {dispatches} dispatches, "
                                 f"{unpacked} rows unpacked of "
                                 f"{counts.get('pipeline.frames_encoded')} encoded")
        launches["unpack"] += ku
        launches["total"] += k
        launches["global_rows"] += g
        launches["analysis"] += ka
        launches["rice"] += kr
        launches["crc"] += kc
        launches["symbols"] += ks
        launches["lags"] += kl
        return out, k, g

    def counted_decode(path, fn):
        """Run one decode path with the counts at 0 before it; it must
        launch the synthesis kernel and never call a plain version."""
        for m in (deposit, synth, analyze, crc16, symbols):
            m.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        k, p = synth.KERNEL_LAUNCHES, synth.PLAIN_CALLS + deposit.PLAIN_CALLS
        if k == 0 or p != 0:
            raise AssertionError(f"{path}: {k} synthesis launches, {p} plain calls")
        return out, k

    def check(path, flac, want_bytes, want_sha):
        if len(flac) != want_bytes or _sha(flac) != want_sha:
            raise AssertionError(f"{path}: {len(flac)} bytes, sha256 {_sha(flac)}")

    def timed_encode(wav, cfg):
        """Warm wall time of one encode, and its per-batch stage times."""
        zt.encode_wav_bytes(wav, config=cfg, device=dev)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flac = zt.encode_wav_bytes(wav, config=cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stages.EVENTS = []
        zt.encode_wav_bytes(wav, config=cfg, device=dev)
        torch.cuda.synchronize()
        per_batch = stages.batch_ms(stages.EVENTS)
        stages.EVENTS = None
        return flac, wall, per_batch

    def median_stages(per_batch):
        full = per_batch[:-1] if len(per_batch) > 1 else per_batch
        return {k: float(np.median([b[k] for b in full])) for k in full[0]}

    # -- phase 3: corpus byte identity on the card -----------------------------
    with open(MANIFEST) as f:
        manifest = json.load(f)["cases"]
    for case in CORPUS:
        buf = io.BytesIO()
        write_wav(buf, _corpus_pcm(case), case.get("rate", 44100), case["depth"])
        wav = buf.getvalue()
        ent = manifest[case["name"]]
        if _sha(wav) != ent["wav_sha256"]:
            raise AssertionError(f"{case['name']}: corpus input synthesis drifted")
        cfg = zt.EncoderConfig.default(case["channels"])
        if case.get("block"):
            cfg = replace(cfg, block_size=case["block"])
        if case.get("lpc"):
            cfg = replace(cfg, prediction="lpc", lpc_order=case.get("order", 8))
        flac, _, _ = counted(case["name"], lambda: zt.encode_wav_bytes(wav, config=cfg, device=dev),
                             lpc=bool(case.get("lpc")), fed=True)
        if _sha(flac) != ent["flac_sha256"]:
            raise AssertionError(f"{case['name']}: FLAC differs from the pinned stream")
    _log("3", corpus_cases=len(CORPUS), identical=True)

    # -- phase 4: config 1 at full size ----------------------------------------
    zt.encode_wav_bytes(wav1, device=dev)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (flac, k, _) = counted("config 1", lambda: zt.encode_wav_bytes(wav1, device=dev), fed=True)
    wall = time.perf_counter() - t0
    check("config 1", flac, CONFIG1_FLAC_BYTES, CONFIG1_FLAC_SHA)
    flac1 = flac
    _log("4", flac_bytes=len(flac), ratio=len(flac) / len(wav1), wall_s=wall,
         x_realtime=CONFIG1_SECONDS / wall,
         peak_mem_bytes=torch.cuda.max_memory_allocated(), kernel_launches=k, plain_calls=0)

    # where the wall time goes: the pipeline's own per-stage CUDA events ...
    stages.EVENTS = []
    zt.encode_wav_bytes(wav1, device=dev)
    torch.cuda.synchronize()
    per_batch = stages.batch_ms(stages.EVENTS)
    stages.EVENTS = None
    _log("4-stages", batches=len(per_batch), full_batch_median_ms=median_stages(per_batch),
         per_batch_ms=per_batch)

    # ... the host pieces alone, and the device's busy time over one more
    # encode under the profiler
    t0 = time.perf_counter()
    r = WavReader.from_bytes(wav1)
    r.planar_samples()
    t1 = time.perf_counter()
    md5(bytes(r.raw_pcm_bytes()))
    t2 = time.perf_counter()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t3 = time.perf_counter()
        zt.encode_wav_bytes(wav1, device=dev)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t3
    from torch.autograd import DeviceType

    # busy = the union of the device-side activity intervals (kernels,
    # copies, memsets); host-side op entries, which carry their kernels'
    # time too, are left out
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    busy_us, hi = 0.0, float("-inf")
    for a, b in spans:  # sorted by start: count only what extends the union
        busy_us += max(0.0, b - max(a, hi))
        hi = max(hi, b)
    busy_s = busy_us / 1e6
    dev_ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(dev_ops, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    del prof

    # the host's issue time: every batch dispatched through DevicePipeline's
    # public methods before any is collected, as encode_frames_stream does
    s1 = r.planar_samples()
    nfull = s1.shape[1] // BLOCK
    frames1 = s1[:, : nfull * BLOCK].reshape(2, nfull, BLOCK).transpose(1, 0, 2)
    info1 = zt.StreamInfo(RATE, 2, 16, s1.shape[1], BLOCK, BLOCK)
    pipe1 = pl.DevicePipeline(cfg1, 16, dev)

    def dispatch_collect():
        t0 = time.perf_counter()
        pending = [pipe1.dispatch_batch(frames1[i : i + 1024],
                                        np.arange(i, min(i + 1024, nfull), dtype=np.int64), info1)
                   for i in range(0, nfull, 1024)]
        pending.append(pipe1.dispatch_tail(s1[:, nfull * BLOCK :], nfull, info1))
        t1 = time.perf_counter()
        parts = [pipe1.collect_batch(p, info1)[0] for p in pending]
        return b"".join(parts), t1 - t0, time.perf_counter() - t1

    dispatch_collect()  # warm-up
    torch.cuda.synchronize()
    (stream1, dispatch_s, collect_s), _, _ = counted("4 dispatch", dispatch_collect)
    if not flac1.endswith(stream1):
        raise AssertionError("4 dispatch: the frames differ from config 1's pinned stream")
    _log("4-breakdown", wav_parse_s=t1 - t0, md5_s=t2 - t1, profiled_wall_s=prof_wall,
         device_events=len(spans), device_busy_s=busy_s,
         device_idle_share=1 - busy_s / prof_wall,
         top_device_ops=[[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top],
         dispatches=len(range(0, nfull, 1024)) + 1, dispatch_s=dispatch_s,
         collect_after_dispatch_s=collect_s)
    del s1, frames1, stream1

    # -- phase 5: config 3 (LPC) at full size ---------------------------------
    (flac, wall, per_batch), k, _ = counted(
        "config 3", lambda: timed_encode(wav3, cfg_lpc), lpc=True, fed=True)
    check("config 3", flac, CONFIG3_FLAC_BYTES, CONFIG3_FLAC_SHA)
    flac3 = flac
    seconds3 = CONFIG3_SAMPLES / RATE
    _log("5", flac_bytes=len(flac), ratio=len(flac) / len(wav3), wall_s=wall,
         x_realtime=seconds3 / wall, kernel_launches=k, stages_ms=per_batch)

    # the LPC pieces of one config-3 batch's analysis, on its L/R/M/S planes
    s3 = WavReader.from_bytes(wav3).planar_samples()
    fr = torch.from_numpy(s3.reshape(2, 1024, BLOCK).copy()).to(dev).to(torch.int64)
    planes = torch.stack([fr[0], fr[1], (fr[0] + fr[1]) >> 1, fr[0] - fr[1]]).to(torch.int32)
    del fr
    orders = lpc.lpc_candidate_orders(cfg_lpc.lpc_order)
    lags = lpc.lag_sums(planes, cfg_lpc.lpc_order)
    sel = lpc.select_lpc_candidate(lpc.fixed_point_levinson(lags, orders), BLOCK,
                                   cfg_lpc.lpc_precision)
    res, _ = lpc.lpc_residuals(planes, sel[1], sel[2], sel[0], cfg_lpc.lpc_order)

    def fixed_part():
        order, _ = analyze.best_fixed_order(planes, False)
        r = analyze.residuals_for_order(planes, order)
        return analyze.rice_estimate(r, order, BLOCK, 8, 14)

    pieces = {
        "fixed_order_residual_rice": cuda_ms(torch, fixed_part, reps=5),
        "lpc_lag_sums": cuda_ms(torch, lambda: lpc.lag_sums(planes, cfg_lpc.lpc_order), reps=5),
        "lpc_levinson_select": cuda_ms(torch, lambda: lpc.select_lpc_candidate(
            lpc.fixed_point_levinson(lags, orders), BLOCK, cfg_lpc.lpc_precision), reps=5),
        "lpc_residuals": cuda_ms(torch, lambda: lpc.lpc_residuals(
            planes, sel[1], sel[2], sel[0], cfg_lpc.lpc_order), reps=5),
        "lpc_rice": cuda_ms(torch, lambda: analyze.rice_estimate(
            res, sel[0], BLOCK, 8, 14), reps=5),
        "fixed_kernel": cuda_ms(torch, lambda: analyze.analyze_fixed(planes, False, 8, 14)),
        "lpc_rice_kernel": cuda_ms(torch, lambda: analyze.rice_estimate_planes(
            res, sel[0], 8, 14)),
    }
    _log("5-lpc-pieces", planes=list(planes.shape), ms=pieces)

    # the lag sums kernel on that batch, under the one Tukey(0.5) at config
    # 3's order and under flac -8's six windows at order 12, in its narrow
    # arithmetic (16-bit planes and the 17-bit side) and in its limbs: equal
    # to the plain lag_sums, timed through the wrapper (its launches alone
    # and in a CUDA graph: tools/torch_lags_kernel.py)
    six = windows_of(zt.EncoderConfig(apodization=FLAC8_APODIZATION))
    lag_times = {}
    for name, wins, order in (("config3_tukey", (TUKEY_HALF,), cfg_lpc.lpc_order),
                              ("flac8_six_windows", six, 12)):
        wt = lpc.windows_tensor(wins, BLOCK, dev)
        plain_fn = lambda: lpc.lag_sums(planes.unsqueeze(0), order,
                                        wt.view(len(wins), 1, 1, BLOCK))
        want = plain_fn()
        entry = {"windows": len(wins), "order": order,
                 "plain_ms": cuda_ms(torch, plain_fn, reps=3)}
        for tier, bits in (("narrow", 17), ("limbs", None)):
            fn = lambda: lpc.lag_sums_planes(planes, order, wt, bits)
            if not torch.equal(fn(), want):
                raise AssertionError(f"lag sums kernel ({tier}) != plain on {name}")
            nbytes, bound_ms, bound_by, ops_ms = lags_bound(
                planes.numel() // BLOCK, BLOCK, len(wins), order, 4, bits is not None)
            ms = cuda_ms(torch, fn)
            entry[tier] = dict(kernel_ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                               bound_ops_ms=ops_ms, bound_bytes=nbytes,
                               share_of_bound=bound_ms / ms)
        lag_times[name] = entry
        del want
    _log("5-lag-sums", planes=list(planes.shape), ptxas=ptxas_of(("lag_sums_kernel",)),
         **lag_times)
    flac8_lags = lag_times["flac8_six_windows"]
    lags_entry = {"name": "lag_sums", "route": "cuda", "source": "zigflac_tpu_torch/csrc/lags.cu",
                  "replaces": "zigflac_tpu/ops/lpc.py:195", "max_abs_err": 0,
                  "ms": flac8_lags["narrow"]["kernel_ms"], "plain_ms": flac8_lags["plain_ms"],
                  "bound_ms": flac8_lags["narrow"]["bound_ms"],
                  "bound_by": flac8_lags["narrow"]["bound_by"], "library_ms": None}
    del planes, lags, sel, res

    (flac, wall, _), k, _ = counted("config 1 with LPC", lambda: timed_encode(wav1, cfg_lpc),
                                    lpc=True, fed=True)
    check("config 1 with LPC", flac, CONFIG1_LPC_FLAC_BYTES, CONFIG1_LPC_FLAC_SHA)
    _log("5-285s", flac_bytes=len(flac), ratio=len(flac) / len(wav1), wall_s=wall,
         x_realtime=CONFIG1_SECONDS / wall, kernel_launches=k)

    # flac -8's six-window search through encode_wav_bytes on 64 frames and
    # a tail, against the CPU port's bytes: one lag sums launch a dispatch
    cfg8 = zt.EncoderConfig(prediction="lpc", lpc_order=12, lpc_precision=12,
                            max_rice_order=6, apodization=FLAC8_APODIZATION)
    wav8 = bench_wav(write_wav, 64 * BLOCK + 777)
    flac8_cpu = zt.encode_wav_bytes(wav8, config=cfg8, device="cpu")
    flac, k, _ = counted("flac -8", lambda: zt.encode_wav_bytes(wav8, config=cfg8, device=dev),
                         lpc=True, fed=True)
    if flac != flac8_cpu:
        raise AssertionError("flac -8: the card's bytes differ from the CPU port's")
    _log("5-flac8", frames=65, flac_bytes=len(flac), kernel_launches=k,
         lag_kernel_launches=lpc.LAG_KERNEL_LAUNCHES)
    film = phase5_film(SimpleNamespace(
        torch=torch, dev=dev, zt=zt, lpc=lpc, deposit=deposit, analyze=analyze, bitpack=bitpack,
        pl=pl, WavReader=WavReader, write_wav=write_wav, compare=compare, compare_crc=compare_crc,
        counted=counted, counted_decode=counted_decode))
    film_line = lambda e: {k: e[k] for k in ("kernel_ms", "plain_ms", "bound_ms", "bound_by")}
    lags_entry["film_batch"] = film_line(film["lag_sums"])

    # -- phase 6: depth 32 -----------------------------------------------------
    seconds32 = DEPTH32_SAMPLES / RATE
    for pred, (nbytes, sha) in DEPTH32_FLAC.items():
        (flac, wall, per_batch), k, g = counted(
            f"32-bit {pred}", lambda: timed_encode(wav32, replace(cfg1, prediction=pred)),
            lpc=pred == "lpc", fed=True)
        check(f"32-bit {pred}", flac, nbytes, sha)
        flac32 = flac  # the last one, LPC, goes on to the decode phases
        _log("6", prediction=pred, flac_bytes=len(flac), ratio=len(flac) / len(wav32),
             wall_s=wall, x_realtime=seconds32 / wall, kernel_launches=k,
             global_row_launches=g, stages_ms=per_batch)
    flac, k, g = counted("32-bit noise", lambda: zt.encode_wav_bytes(wav_noise, device=dev),
                         fed=True)
    if flac != noise_cpu:
        raise AssertionError("32-bit noise: the card's bytes differ from the CPU port's")
    if g == 0:
        raise AssertionError("32-bit noise never reached the exact tier's wide rows")
    _log("6-noise", frames=NOISE32_FRAMES, flac_bytes=len(flac), equals_cpu=True,
         kernel_launches=k, global_row_launches=g)
    flac_anti, k, _ = counted("32-bit antiphase", lambda: zt.encode_wav_bytes(
        wav_anti, config=cfg_lpc, device=dev), lpc=True, fed=True)
    _log("6-antiphase", frames=ANTIPHASE32_FRAMES, flac_bytes=len(flac_anti), kernel_launches=k)

    # -- phase 2, the synthesis kernel's half, and phases 7-11 ----------------
    import tempfile

    env = SimpleNamespace(zt=zt, dev=dev, torch=torch, counted=counted,
                          counted_decode=counted_decode, check=check,
                          timed_encode=timed_encode, sync=torch.cuda.synchronize,
                          pipeline_cls=pl.DevicePipeline, pl=pl, decoder=decoder, synth=synth,
                          build=_build, WavReader=WavReader)
    synth_entry = phase2_synth(env, {"config1": (flac1, 16), "config3": (flac3, 16),
                                     "depth32_lpc": (flac32, 32),
                                     "antiphase32": (flac_anti, 32)})
    wav2, flac2 = phase7_config2(env, write_wav)
    with tempfile.TemporaryDirectory(prefix="zf_smoke_") as tmp:
        album = phase8_album(env, tmp, wav1, wav2, {"config1.wav": CONFIG1_FLAC_SHA,
                                                   "config2.wav": CONFIG2_FLAC_SHA})
        long_file = phase9_stream(env, tmp)
        synth_entry["launches"] = phase10_decode(
            env, tmp, {"config1": (flac1, wav1), "config2": (flac2, wav2),
                       "config3": (flac3, wav3), "depth32_lpc": (flac32, wav32),
                       "antiphase32": (flac_anti, wav_anti)}, long_file)
        phase11_cli(env, tmp, album, long_file, wav3, CONFIG1_FLAC_SHA)
        phase12_multi(env, album, wav1, wav32, cfg_lpc)
    _log("end", wall_s=time.perf_counter() - t_start)

    fixed_entry["launches"] = launches["analysis"]
    rice_entry["launches"] = launches["rice"]
    crc_entry["launches"] = launches["crc"]
    symbols_entry["launches"] = launches["symbols"]
    unpack_entry["launches"] = launches["unpack"]
    lags_entry["launches"] = launches["lags"]
    print(json.dumps({"kernels": [synth_entry, fixed_entry, rice_entry, symbols_entry, crc_entry,
                                  unpack_entry, lags_entry, {
        "name": "deposit_words",
        "route": "cuda",
        "source": "zigflac_tpu_torch/csrc/deposit.cu",
        "replaces": "zigflac_tpu/ops/pallas_deposit.py:149",
        "launches": launches["total"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "film_batch": film_line(film["deposit"]),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
