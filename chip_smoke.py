"""Smoke run of zigflac_tpu_torch on one CUDA card: build, check, encode.

    python3 chip_smoke.py

Phases:
  0. torch/CUDA versions and the card's name and power limit; a missing
     card is an error.
  1. Build the CUDA kernels from the package's sources (nvcc, sm_90a).
  2. The deposit kernel against its plain torch version on the card: random
     symbol streams (33- and 64-bit values, masked and odd columns, the
     word-budget clamp, a row too large for shared memory) and the real
     streams of one 1024-frame batch each of config 1, of config 3 (LPC
     coefficient symbols), of the 32-bit input (33-bit side samples) and of
     32-bit white noise at the exact tier (73 KB rows, the kernel's
     global-memory branch). Words must be equal; each is timed with CUDA
     events, and config 1's batch, timed again in turns with the plain
     version, gives the kernel's times and bound.
  3. All 22 pinned corpus streams of tests/vectors/corpus (fixed and LPC,
     depths 8 to 32) encoded on the card, byte for byte.
  4. Config 1 at full size: 285 s of 16-bit/44.1 kHz stereo (bench.py's
     recipe, seed 0xBEEF) must give the pinned FLAC bytes. Prints the warm
     wall time, x-realtime, peak device memory, the per-stage CUDA-event
     times the pipeline records (utils/stages.py) and the device's busy time
     under torch.profiler.
  5. Config 3 at full size: bench.py's config-3 input (1024 frames, LPC)
     and then the 285 s input with LPC must give their pinned bytes. Prints
     the warm wall time, x-realtime, the stage times, and the LPC pieces of
     one batch's analysis (lag sums, Levinson, residuals, Rice estimate).
  6. Depth 32: bench.py's 32-bit input with fixed and with LPC prediction
     must give the pinned bytes; a batch of 32-bit white noise overflows
     tier 0, re-encodes at the exact tier through the kernel's
     global-memory branch and must equal the port's bytes on the CPU.
  7. Config 2 at full size: bench.py's 24-bit / 96 kHz input (1024 frames,
     43.7 s) through encode_wav_bytes must give the pinned bytes. Prints
     the warm wall time, x-realtime and the stage times.
  8. Config 4: an album directory of 10 WAVs in two format groups (the
     config-1 and config-2 inputs and eight 16-bit tracks of 176-315 s,
     ~37 minutes) through one encode_files call. The config-1 and config-2
     outputs must give their pinned bytes, every other file its in-memory
     encode's. Prints the wall time, x-realtime and the batch, tail and
     mixed-file batch dispatch counts, which must be those of full fusion.
     Then three tracks as Ogg-FLAC, equal to the CPU port's.
  9. Streaming: a 1-hour WAV (~635 MB, written in pieces) through
     encode_file with a SEEKTABLE, a tag and PADDING must equal its
     in-memory encode. Then ``python -m zigflac_tpu_torch.cli`` as
     subprocesses on the card: one block (the fixed cost of a process on
     the card), config 1 (pinned bytes), the 1-hour file
     (equal to encode_file's), ``--batch`` over the album (equal to
     phase 8's) and ``--ogg`` on config 3 with LPC (equal to the CPU port's
     CLI). Each subprocess's wall time and peak RSS are printed; the
     1-hour run's peak RSS must exceed the config-1 run's by less than a
     quarter of the difference of their WAV sizes.

Every encode path under test in this process (phases 3-9; not the encodes
it is compared with, nor the CLI subprocesses) runs with the kernel's counts
set to 0 just before it and read just after: it must have launched the
kernel and never called the plain version. Any failure raises, so the exit
code is not 0. Phases 8 and 9 work in a temporary directory, removed at the
end.
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
ALBUM_OGG_TRACKS = ("track07.wav", "track01.wav", "track02.wav")  # the three shortest
# the streaming file: one hour of the bench recipe (seed 0xBEEF) plus 777
# samples, encoded with a SEEKTABLE point every 10 s, one tag and PADDING
HOUR_SAMPLES = 3600 * RATE + 777
HOUR_FLAGS = ["--seek-interval", "10", "--tag", "TITLE=one hour", "--padding", "4096"]
HOUR_KW = dict(seek_interval=10 * RATE, tags=[("TITLE", "one hour")], padding=4096)

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


def run_cli(args, timeout=600):
    """One wav2flac CLI subprocess: (wall seconds, its peak RSS in bytes,
    its output). Raises on a non-zero exit, or at the timeout after killing
    it."""
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
    if proc.returncode != 0:
        raise RuntimeError(f"wav2flac {args} exited {proc.returncode}:\n{text[-4000:]}")
    peak = [line.split()[1] for line in text.splitlines() if line.startswith("peak_rss_bytes")]
    return wall, int(peak[-1]), text


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def phase7_config2(env, write_wav) -> bytes:
    """Config 2 at full size through encode_wav_bytes; returns its WAV."""
    wav2 = bench_wav(write_wav, CONFIG2_SAMPLES, depth=24, rate=CONFIG2_RATE)
    if _sha(wav2) != CONFIG2_WAV_SHA:
        raise AssertionError("config 2 input synthesis drifted")
    (flac, wall, per_batch), k, _ = env.counted(
        "config 2", lambda: env.timed_encode(wav2, None))
    env.check("config 2", flac, CONFIG2_FLAC_BYTES, CONFIG2_FLAC_SHA)
    _log("7", flac_bytes=len(flac), ratio=len(flac) / len(wav2), wall_s=wall,
         x_realtime=CONFIG2_SAMPLES / CONFIG2_RATE / wall, kernel_launches=k, plain_calls=0,
         stages_ms=per_batch)
    return wav2


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

    # Ogg-FLAC on three tracks, against the CPU port
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


def phase9_stream_and_cli(env, tmp, album, wav3, want1):
    """The 1-hour file through encode_file against its in-memory encode, then
    the CLI as subprocesses on the card, with each one's peak RSS."""
    zt, dev = env.zt, env.dev
    hour, out = os.path.join(tmp, "hour.wav"), os.path.join(tmp, "hour.flac")
    t0 = time.perf_counter()
    hour_size = write_bench_wav(hour, HOUR_SAMPLES)
    synth_s = time.perf_counter() - t0
    audio_s = HOUR_SAMPLES / RATE
    t0 = time.perf_counter()
    _, k, _ = env.counted("1-hour encode_file",
                          lambda: zt.encode_file(hour, out, device=dev, **HOUR_KW))
    wall = time.perf_counter() - t0
    streamed = _read(out)
    t0 = time.perf_counter()
    wav = _read(hour)
    in_memory = zt.encode_wav_bytes(wav, device=dev, **HOUR_KW)
    env.sync()
    mem_wall = time.perf_counter() - t0
    del wav
    if streamed != in_memory:
        raise AssertionError("1-hour encode_file differs from its in-memory encode")
    del in_memory
    _log("9", wav_bytes=hour_size, audio_s=audio_s, synth_s=synth_s, flac_bytes=len(streamed),
         sha256=_sha(streamed), encode_file_wall_s=wall, x_realtime=audio_s / wall,
         in_memory_wall_s=mem_wall, in_memory_x_realtime=audio_s / mem_wall,
         kernel_launches=k, plain_calls=0, equals_in_memory=True)

    import resource

    device = ["--device", str(dev)]
    wav1_path = os.path.join(album["indir"], "config1.wav")
    # the fixed cost: torch, the CUDA context and one one-frame batch
    one = os.path.join(tmp, "one_block.wav")
    write_bench_wav(one, BLOCK)
    wall_0, rss_0, _ = run_cli([one, os.path.join(tmp, "one_block.flac"), *device])
    cli = {"one_block": dict(wall_s=wall_0, peak_rss_bytes=rss_0)}
    out_a = os.path.join(tmp, "cli_a.flac")
    wall_a, rss_a, _ = run_cli([wav1_path, out_a, *device])
    children_a = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss * 1024
    if _sha(_read(out_a)) != want1:
        raise AssertionError("cli (a): config 1 differs from the pinned stream")
    cli["a_config1"] = dict(wall_s=wall_a, peak_rss_bytes=rss_a)
    out_b = os.path.join(tmp, "cli_b.flac")
    wall_b, rss_b, _ = run_cli([hour, out_b, *HOUR_FLAGS, *device])
    children_b = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss * 1024
    if _read(out_b) != streamed:
        raise AssertionError("cli (b): the 1-hour file differs from encode_file's")
    cli["b_hour"] = dict(wall_s=wall_b, peak_rss_bytes=rss_b, x_realtime=audio_s / wall_b)
    del streamed
    rss_room = (hour_size - os.path.getsize(wav1_path)) / 4
    if rss_b - rss_a >= rss_room:
        raise AssertionError(f"cli (b) peak RSS {rss_b} B exceeds (a)'s {rss_a} B by a "
                             f"quarter of the WAV size difference or more")
    cli_dir = os.path.join(tmp, "cli_batch")
    wall_c, rss_c, _ = run_cli(["--batch", album["indir"], cli_dir, *device])
    for name, path in album["outs"].items():
        if _read(os.path.join(cli_dir, name[:-4] + ".flac")) != _read(path):
            raise AssertionError(f"cli (c): {name} differs from encode_files'")
    cli["c_batch"] = dict(wall_s=wall_c, peak_rss_bytes=rss_c, files=len(album["outs"]))
    wav3_path = os.path.join(tmp, "config3.wav")
    with open(wav3_path, "wb") as f:
        f.write(wav3)
    lpc_ogg = ["--ogg", "--prediction", "lpc"]
    out_d, out_cpu = os.path.join(tmp, "cli_d.oga"), os.path.join(tmp, "cli_d.cpu.oga")
    wall_d, rss_d, _ = run_cli([wav3_path, out_d, *lpc_ogg, *device])
    from zigflac_tpu_torch.cli import main as cli_main

    if cli_main([wav3_path, out_cpu, *lpc_ogg, "--device", "cpu"]) != 0:
        raise AssertionError("the CPU port's CLI failed on config 3")
    got = _read(out_d)
    if got[:4] != b"OggS" or got != _read(out_cpu):
        raise AssertionError("cli (d): config 3 Ogg-FLAC differs from the CPU port's")
    cli["d_config3_ogg"] = dict(wall_s=wall_d, peak_rss_bytes=rss_d)
    # RUSAGE_CHILDREN reads at least this process's own peak (see
    # _CLI_WITH_PEAK), printed beside it; the check uses each child's own peak
    _log("9-cli", runs=cli, rusage_children_max_rss_after_a=children_a,
         rusage_children_max_rss_after_b=children_b,
         this_process_max_rss=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
         rss_b_minus_a=rss_b - rss_a, rss_room=rss_room, all_equal=True)


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

def cuda_ms(torch, fn, reps=20):
    """Mean milliseconds of fn() over reps launches, after one warm-up."""
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
    from zigflac_tpu_torch.native import md5
    from zigflac_tpu_torch.ops import _build, analyze, bitpack, deposit, lpc
    from zigflac_tpu_torch.utils import stages
    from zigflac_tpu_torch.wav import WavReader, write_wav

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- phase 1 --------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    _log("1", build_s=round(time.perf_counter() - t0, 3), nvcc_s=_build.BUILD_SECONDS,
         ptxas=_build.BUILD_LOG.strip().splitlines()[-4:])

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
    cfg1 = zt.EncoderConfig.default(2)
    cfg_lpc = replace(cfg1, prediction="lpc")

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

    def batch_stream(wav, cfg, tier):
        """The symbol stream of a wav's first 1024 full frames, and the
        word budget of capacity tier ``tier`` (None: the exact tier)."""
        r = WavReader.from_bytes(wav)
        s = r.planar_samples()
        n = min(1024, s.shape[1] // BLOCK)
        frames = torch.from_numpy(
            s[:, : n * BLOCK].reshape(2, n, BLOCK).transpose(1, 0, 2).copy()).to(dev)
        hs, max_words, _ = pl.DevicePipeline(cfg, r.bit_depth, dev)._shape(
            2, BLOCK, RATE, tier, n)
        plan = analyze.plan_frames(frames, r.bit_depth, cfg)
        dep_cum, _, dep_val, dep_nbv = bitpack.frame_symbol_stream(
            plan, torch.arange(n, device=dev), hs, BLOCK, cfg.max_rice_order,
            analyze.lpc_order_of(cfg), cfg.lpc_precision)
        return dep_cum.to(torch.int32), dep_val, dep_nbv.to(torch.int32), max_words, plan

    streams = {}
    for name, wav, cfg, tier in (("config1", wav1, cfg1, 0), ("config3", wav3, cfg_lpc, 0),
                                 ("depth32_lpc", wav32, cfg_lpc, 0),
                                 ("noise32_exact", wav_noise, cfg1, None)):
        dc, dv, dn, mw, plan = batch_stream(wav, cfg, tier)
        compare(dc, dv, dn, mw)
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

    # the port's first-min / last-min tie rules on the card
    ties = torch.tensor([[3, 1, 2], [1, 1, 5], [1, 0, 2]], device=dev)
    if (analyze.argmin_first(ties).tolist(), analyze.argmin_last(ties).tolist()) != (
            [1, 2, 0], [2, 2, 2]):
        raise AssertionError("argmin tie rule differs on the card")

    # the CPU port's bytes for phase 6's noise batch, made before any counted path
    noise_cpu = zt.encode_wav_bytes(wav_noise, device="cpu")

    launches = {"total": 0, "global_rows": 0}

    def counted(path, fn):
        """Run one encode path with the counts at 0 before it; it must
        launch the kernel and never call the plain version."""
        deposit.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        k, g, p = deposit.KERNEL_LAUNCHES, deposit.GLOBAL_ROW_LAUNCHES, deposit.PLAIN_CALLS
        if k == 0 or p != 0:
            raise AssertionError(f"{path}: {k} kernel launches, {p} plain calls")
        launches["total"] += k
        launches["global_rows"] += g
        return out, k, g

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
        flac, _, _ = counted(case["name"], lambda: zt.encode_wav_bytes(wav, config=cfg, device=dev))
        if _sha(flac) != ent["flac_sha256"]:
            raise AssertionError(f"{case['name']}: FLAC differs from the pinned stream")
    _log("3", corpus_cases=len(CORPUS), identical=True)

    # -- phase 4: config 1 at full size ----------------------------------------
    zt.encode_wav_bytes(wav1, device=dev)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (flac, k, _) = counted("config 1", lambda: zt.encode_wav_bytes(wav1, device=dev))
    wall = time.perf_counter() - t0
    check("config 1", flac, CONFIG1_FLAC_BYTES, CONFIG1_FLAC_SHA)
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
    _log("4-breakdown", wav_parse_s=t1 - t0, md5_s=t2 - t1, profiled_wall_s=prof_wall,
         device_events=len(spans), device_busy_s=busy_s,
         device_idle_share=1 - busy_s / prof_wall,
         top_device_ops=[[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top])
    del prof

    # -- phase 5: config 3 (LPC) at full size ---------------------------------
    (flac, wall, per_batch), k, _ = counted(
        "config 3", lambda: timed_encode(wav3, cfg_lpc))
    check("config 3", flac, CONFIG3_FLAC_BYTES, CONFIG3_FLAC_SHA)
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
    }
    _log("5-lpc-pieces", planes=list(planes.shape), ms=pieces)
    del planes, lags, sel, res

    (flac, wall, _), k, _ = counted("config 1 with LPC", lambda: timed_encode(wav1, cfg_lpc))
    check("config 1 with LPC", flac, CONFIG1_LPC_FLAC_BYTES, CONFIG1_LPC_FLAC_SHA)
    _log("5-285s", flac_bytes=len(flac), ratio=len(flac) / len(wav1), wall_s=wall,
         x_realtime=CONFIG1_SECONDS / wall, kernel_launches=k)

    # -- phase 6: depth 32 -----------------------------------------------------
    seconds32 = DEPTH32_SAMPLES / RATE
    for pred, (nbytes, sha) in DEPTH32_FLAC.items():
        (flac, wall, per_batch), k, g = counted(
            f"32-bit {pred}", lambda: timed_encode(wav32, replace(cfg1, prediction=pred)))
        check(f"32-bit {pred}", flac, nbytes, sha)
        _log("6", prediction=pred, flac_bytes=len(flac), ratio=len(flac) / len(wav32),
             wall_s=wall, x_realtime=seconds32 / wall, kernel_launches=k,
             global_row_launches=g, stages_ms=per_batch)
    flac, k, g = counted("32-bit noise", lambda: zt.encode_wav_bytes(wav_noise, device=dev))
    if flac != noise_cpu:
        raise AssertionError("32-bit noise: the card's bytes differ from the CPU port's")
    if g == 0:
        raise AssertionError("32-bit noise never reached the exact tier's wide rows")
    _log("6-noise", frames=NOISE32_FRAMES, flac_bytes=len(flac), equals_cpu=True,
         kernel_launches=k, global_row_launches=g)

    # -- phases 7-9: config 2, the config-4 album, streaming and the CLI ------
    import tempfile
    from types import SimpleNamespace

    env = SimpleNamespace(zt=zt, dev=dev, counted=counted, check=check,
                          timed_encode=timed_encode, sync=torch.cuda.synchronize,
                          pipeline_cls=pl.DevicePipeline)
    wav2 = phase7_config2(env, write_wav)
    with tempfile.TemporaryDirectory(prefix="zf_smoke_") as tmp:
        album = phase8_album(env, tmp, wav1, wav2, {"config1.wav": CONFIG1_FLAC_SHA,
                                                   "config2.wav": CONFIG2_FLAC_SHA})
        phase9_stream_and_cli(env, tmp, album, wav3, CONFIG1_FLAC_SHA)
    _log("end", wall_s=time.perf_counter() - t_start)

    print(json.dumps({"kernels": [{
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
