"""wav2flac CLI on a torch device: the encode modes.

``python -m zigflac_tpu_torch.cli in_file.wav out_file.flac [--device cpu]``

Matches the reference CLI contract (src/main.zig:9-42): exit 1 on usage or
file error, exit 2 on a WAV format FLAC cannot represent. The encode flags
are the JAX package's (block size, prediction mode, Rice limits, LPC order,
wasted bits, tags, SEEKTABLE, PADDING, PICTURE, CUESHEET, Ogg-FLAC output,
``--batch`` over a directory); ``--device`` picks the torch device, the
card unless the caller asks for the CPU. The decode-side modes are not
here yet.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .utils.config import EncoderConfig


class _Parser(argparse.ArgumentParser):
    def error(self, message):  # reference exits 1 on usage errors (main.zig:21)
        self.print_usage(sys.stderr)
        print(f"wav2flac: error: {message}", file=sys.stderr)
        raise SystemExit(1)


def build_parser() -> argparse.ArgumentParser:
    p = _Parser(
        prog="wav2flac",
        description="FLAC encoder on a torch device (zigflac_tpu_torch)",
    )
    p.add_argument("input", help="input WAV file (a directory of WAVs with --batch)")
    p.add_argument("output", help="output FLAC file (output directory with --batch)")
    p.add_argument(
        "--batch", action="store_true",
        help="encode every .wav in the input directory into the output "
        "directory, frames of all files fused into shared device batches",
    )
    p.add_argument("--block-size", type=int, default=4096)
    p.add_argument("--prediction", choices=["fixed", "none", "lpc"], default="fixed")
    p.add_argument("--max-rice-order", type=int, default=8)
    p.add_argument("--max-rice-param", type=int, default=30, choices=[14, 30])
    p.add_argument("--lpc-order", type=int, default=8)
    p.add_argument(
        "--wasted-bits", action="store_true",
        help="detect and shave common trailing zero bits per subframe",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device to encode on (default cuda; without a card it is "
        "an error, never a fallback to the CPU)",
    )
    p.add_argument("--stats", action="store_true", help="print throughput stats")
    p.add_argument(
        "--tag", action="append", default=[], metavar="NAME=VALUE",
        help="add a Vorbis comment tag (repeatable)",
    )
    p.add_argument(
        "--seek-interval", type=float, default=None, metavar="SECONDS",
        help="write a SEEKTABLE with a point at most every SECONDS",
    )
    p.add_argument(
        "--padding", type=int, default=None, metavar="BYTES",
        help="append a PADDING metadata block of BYTES zero bytes",
    )
    p.add_argument(
        "--picture", metavar="IMAGE", default=None,
        help="embed a front-cover PICTURE block (jpeg/png file)",
    )
    p.add_argument(
        "--cuesheet", metavar="FILE.cue", default=None,
        help="import a standard .cue sheet as a CUESHEET metadata block",
    )
    p.add_argument(
        "--ogg", action="store_true",
        help="write Ogg-FLAC (.oga) instead of native FLAC. Implied by a "
        ".oga/.ogg output extension",
    )
    p.add_argument(
        "--profile", metavar="DIR", default=None,
        help="write a torch.profiler trace of the encode to DIR/trace.json",
    )
    return p


def _batch_main(args, cfg_kwargs, device) -> int:
    """Multi-file encode (BASELINE config 4): every .wav under the input
    directory streams into <name>.flac in the output directory, with frames
    of same-format files fused into shared device batches (encode_files —
    host memory stays O(device batch) however many files there are)."""
    from .models.encoder import encode_files
    from .wav import WavFormatError

    if not os.path.isdir(args.input):
        print(f"error: --batch expects a directory: {args.input}", file=sys.stderr)
        return 1
    names = sorted(f for f in os.listdir(args.input) if f.lower().endswith(".wav"))
    if not names:
        print(f"error: no .wav files in {args.input}", file=sys.stderr)
        return 1
    os.makedirs(args.output, exist_ok=True)
    ext = ".oga" if args.ogg else ".flac"
    in_paths = [os.path.join(args.input, f) for f in names]
    out_paths = [os.path.join(args.output, os.path.splitext(f)[0] + ext) for f in names]
    t0 = time.perf_counter()
    try:
        # ogg outputs write in the same single streaming pass (per-file
        # OggStreamSink inside the fused pipeline) — no transmux stage
        encode_files(
            in_paths, out_paths,
            config=EncoderConfig(channels="stereo_auto", **cfg_kwargs),
            device=device, ogg=args.ogg,
        )
    except WavFormatError as e:
        print(f"format: flac does not support this wav format ({e})", file=sys.stderr)
        return 2
    dt = time.perf_counter() - t0
    total_in = sum(os.path.getsize(p) for p in in_paths)
    total_out = sum(os.path.getsize(p) for p in out_paths)
    if args.stats:
        print(
            f"encoded {len(names)} files, {total_in/1e6:.2f} MB -> "
            f"{total_out/1e6:.2f} MB (ratio {total_out/max(total_in,1):.3f}) "
            f"in {dt*1e3:.1f} ms"
        )
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    from .models.encoder import encode_file
    from .models.pipeline import resolve_device
    from .wav import WavFormatError, WavStreamReader

    try:
        # before any file is opened: a cuda request without a card is an
        # error here, never a quiet fallback
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    cfg_kwargs = dict(
        block_size=args.block_size,
        prediction=args.prediction,
        max_rice_order=args.max_rice_order,
        max_rice_param=args.max_rice_param,
        lpc_order=args.lpc_order,
        wasted_bits=args.wasted_bits,
    )

    if args.batch:
        return _batch_main(args, cfg_kwargs, device)

    try:
        # header-only parse: the encode itself streams the data chunk, so
        # the CLI never holds the file in memory
        with WavStreamReader.open(args.input) as wav:
            pass
        cfg = EncoderConfig(
            channels="stereo_auto" if wav.channels == 2 else wav.channels,
            **cfg_kwargs,
        )
        tags = []
        for t in args.tag:
            if "=" not in t:
                print(f"error: --tag expects NAME=VALUE, got {t!r}", file=sys.stderr)
                return 1
            tags.append(tuple(t.split("=", 1)))
        seek_interval = (
            int(args.seek_interval * wav.sample_rate) if args.seek_interval else None
        )
        extra = []
        if args.picture:
            from .metadata import picture_block

            with open(args.picture, "rb") as imf:
                img = imf.read()
            mime = "image/png" if img[:8] == b"\x89PNG\r\n\x1a\n" else "image/jpeg"
            extra.append(picture_block(img, mime, is_last=False))
        if args.cuesheet:
            from .metadata import parse_cue_sheet

            with open(args.cuesheet, "r", encoding="utf-8", errors="replace") as cf:
                cue_text = cf.read()
            try:
                extra.append(parse_cue_sheet(cue_text, wav.sample_rate, wav.samples_count))
            except ValueError as e:
                print(f"error: bad cue sheet ({e})", file=sys.stderr)
                return 1
        extra = extra or None
        want_ogg = args.ogg or args.output.lower().endswith((".oga", ".ogg"))
        profiler = None
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
            profiler.start()
        t0 = time.perf_counter()
        # ogg writes in the same single streaming pass (ogg.OggStreamSink:
        # placeholder header pages, per-batch frame packets, seek-back
        # header-page rewrite)
        encode_file(
            args.input, args.output, config=cfg, device=device,
            tags=tags or None, seek_interval=seek_interval,
            padding=args.padding or 0, extra_metadata=extra, ogg=want_ogg,
        )
        dt = time.perf_counter() - t0
        if profiler is not None:
            profiler.stop()
            os.makedirs(args.profile, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(args.profile, "trace.json"))
            print(f"profile trace written to {args.profile}", file=sys.stderr)
    except WavFormatError as e:
        print(f"format: flac does not support this wav format ({e})", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.stats:
        in_bytes = os.path.getsize(args.input)
        out_bytes = os.path.getsize(args.output)
        pcm_bytes = wav.samples_count * wav.channels * wav.bytes_per_sample
        realtime = wav.samples_count / wav.sample_rate if wav.sample_rate else 0
        print(
            f"encoded {in_bytes/1e6:.2f} MB -> {out_bytes/1e6:.2f} MB "
            f"(ratio {out_bytes/max(in_bytes,1):.3f}) in {dt*1e3:.1f} ms "
            f"= {pcm_bytes/dt/1e6:.1f} MB/s"
            + (f" = {realtime/dt:.0f}x realtime" if realtime else "")
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
