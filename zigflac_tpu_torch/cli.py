"""wav2flac CLI on a torch device: encode, decode, test, list and verify.

``python -m zigflac_tpu_torch.cli in_file.wav out_file.flac [--device cpu]``

Matches the reference CLI contract (src/main.zig:9-42): exit 1 on usage or
file error, exit 2 on a WAV format FLAC cannot represent or a malformed
FLAC stream, exit 3 on a verification failure. The flags are the JAX
package's: the encode flags (block size, prediction mode, Rice limits, LPC
order, wasted bits, tags, SEEKTABLE, PADDING, PICTURE, CUESHEET, Ogg-FLAC
output, ``--batch`` over a directory, ``--verify``) and the decode-side
modes (``-d/--decode`` with ``--range`` and ``--verify``, ``-t/--test``,
``-l/--list``) and the metadata editor (``-e/--edit`` with its options).
``--device`` picks the torch device, the card unless the caller asks for
the CPU; ``--threads N`` decodes on the all-C++ path with N worker threads
instead, which touches no device. ``-l`` and ``-e`` touch no device either.
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
        description="FLAC encoder and decoder on a torch device (zigflac_tpu_torch)",
    )
    p.add_argument(
        "input",
        help="input WAV file (FLAC with --decode; a directory of WAVs with --batch)",
    )
    p.add_argument(
        "output", nargs="?", default=None,
        help="output FLAC file (WAV with --decode; output directory with "
        "--batch; omitted with --list, --test and --edit)",
    )
    p.add_argument(
        "-d", "--decode", action="store_true",
        help="decode FLAC to WAV instead of encoding (flac2wav)",
    )
    p.add_argument(
        "-l", "--list", action="store_true", dest="list_meta",
        help="print the metadata of a FLAC / Ogg-FLAC file (no output "
        "file) and exit",
    )
    p.add_argument(
        "-t", "--test", action="store_true",
        help="verify a FLAC / Ogg-FLAC file (every frame CRC + the "
        "STREAMINFO MD5) without writing any output; exit 0 ok, 2 "
        "malformed, 3 verification failure",
    )
    p.add_argument(
        "-e", "--edit", action="store_true",
        help="edit the metadata of an existing FLAC file in place "
        "(metaflac-style; uses --tag/--remove-tag/--import-tags-from/"
        "--picture/--remove-pictures/--export-picture/--set-application/"
        "--remove-application/--cuesheet/--remove-cuesheet/--padding; "
        "reuses PADDING slack so the audio frames are not rewritten when "
        "the new chain fits)",
    )
    p.add_argument(
        "--remove-tag", action="append", default=[], metavar="NAME",
        dest="remove_tags",
        help="with --edit: remove every Vorbis comment with this field "
        "name (case-insensitive, repeatable)",
    )
    p.add_argument(
        "--remove-pictures", action="store_true",
        help="with --edit: drop all PICTURE blocks",
    )
    p.add_argument(
        "--export-picture", metavar="OUT", default=None,
        help="with --edit: write the first embedded picture's image "
        "bytes to OUT (no other change unless combined with edit flags)",
    )
    p.add_argument(
        "--import-tags-from", metavar="FILE", default=None,
        dest="import_tags_from",
        help="with --edit: append Vorbis comments read from FILE "
        "(one NAME=VALUE per line, metaflac format)",
    )
    p.add_argument(
        "--set-application", action="append", default=[],
        metavar="ID=FILE", dest="set_applications",
        help="with --edit: set the APPLICATION block with 4-char id ID "
        "to FILE's bytes, replacing an existing block with that id "
        "(repeatable)",
    )
    p.add_argument(
        "--remove-application", action="append", default=[],
        metavar="ID", dest="remove_applications",
        help="with --edit: drop APPLICATION blocks with this 4-char id "
        "(repeatable)",
    )
    p.add_argument(
        "--remove-cuesheet", action="store_true",
        help="with --edit: drop the CUESHEET block",
    )
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
        help="torch device to encode and decode on (default cuda; without a "
        "card it is an error, never a fallback to the CPU)",
    )
    p.add_argument(
        "--verify", action="store_true",
        help="decode the output and verify CRCs + MD5 round-trip",
    )
    p.add_argument(
        "--threads", type=int, default=None, metavar="N",
        help="with --decode or --test: decode on the all-C++ path with N "
        "worker threads instead of the device; output is byte-identical at "
        "any thread count",
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
        help="append a PADDING metadata block of BYTES zero bytes "
        "(with --edit: set the padding to exactly BYTES, forcing a "
        "rewrite if it changes the chain size)",
    )
    p.add_argument(
        "--picture", metavar="IMAGE", default=None,
        help="embed a front-cover PICTURE block (jpeg/png file)",
    )
    p.add_argument(
        "--cuesheet", metavar="FILE.cue", default=None,
        help="import a standard .cue sheet as a CUESHEET metadata block "
        "(at encode time, or into an existing file with --edit)",
    )
    p.add_argument(
        "--range", metavar="START:END", default=None, dest="time_range",
        help="with --decode: decode only this time range (seconds), using "
        "the SEEKTABLE to skip ahead when present",
    )
    p.add_argument(
        "--ogg", action="store_true",
        help="write Ogg-FLAC (.oga) instead of native FLAC (encode side; "
        "decode auto-detects the container). Implied by a .oga/.ogg "
        "output extension",
    )
    p.add_argument(
        "--profile", metavar="DIR", default=None,
        help="write a torch.profiler trace of the encode to DIR/trace.json",
    )
    return p


def _decode_range_main(args, device, backend) -> int:
    """--decode --range START:END — random-access decode (decoder.
    decode_range rides the SEEKTABLE + the C++ batch parser) of a time
    slice, written as a standalone WAV."""
    from .decoder import FlacDecodeError, _parse_metadata, decode_range
    from .ogg import is_ogg, ogg_to_flac
    from .wav import write_wav

    try:
        a, _, b = args.time_range.partition(":")
        t0s, t1s = float(a), float(b)
        if t1s <= t0s or t0s < 0:
            raise ValueError
    except ValueError:
        print(f"error: --range expects START:END seconds, got "
              f"{args.time_range!r}", file=sys.stderr)
        return 1
    try:
        with open(args.input, "rb") as f:
            data = f.read()
        if is_ogg(data):
            data = ogg_to_flac(data)
        info, _v, _t, _s, _pos = _parse_metadata(data)
        start = int(t0s * info.sample_rate)
        n = min(
            int(round((t1s - t0s) * info.sample_rate)),
            info.interchannel_samples - start,
        )
        if n <= 0:
            raise FlacDecodeError("range starts past the stream end")
        samples = decode_range(data, start, n, device=device, backend=backend)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except (FlacDecodeError, EOFError, IndexError, ValueError) as e:
        print(f"error: invalid FLAC stream ({e})", file=sys.stderr)
        return 2
    write_wav(args.output, samples.astype("int32"), info.sample_rate,
              info.bit_depth)
    print(f"decoded samples [{start}, {start + n}) "
          f"({t0s:.3f}s..{t0s + n / info.sample_rate:.3f}s)")
    return 0


def _decode_main(args, device, backend) -> int:
    """flac2wav: streaming decode + verify, write PCM WAV (decoder
    round-trip, BASELINE config 5 — the reference has no decoder at all).
    Host memory stays O(frame batch) via decoder.decode_file."""
    from .decoder import FlacDecodeError, decode_file

    if args.time_range is not None:
        return _decode_range_main(args, device, backend)
    t0 = time.perf_counter()
    try:
        info = decode_file(
            args.input, args.output, check_crc=True, verify=args.verify,
            device=device, backend=backend, threads=args.threads,
        )
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except (FlacDecodeError, EOFError, IndexError) as e:
        if "MD5 mismatch" in str(e):
            print("verify: FAILED (MD5 mismatch)", file=sys.stderr)
            return 3
        print(f"error: invalid FLAC stream ({e})", file=sys.stderr)
        return 2
    dt = time.perf_counter() - t0
    if args.stats:
        realtime = (
            info.interchannel_samples / info.sample_rate
            if info.sample_rate
            else 0
        )
        print(
            f"decoded {os.path.getsize(args.input)/1e6:.2f} MB -> "
            f"{os.path.getsize(args.output)/1e6:.2f} MB in {dt*1e3:.1f} ms"
            + (f" = {realtime/dt:.0f}x realtime" if realtime else "")
        )
    if args.verify:
        print("verify: ok")
    return 0


def _list_main(args) -> int:
    """metaflac-style metadata dump: every block of a native or Ogg-FLAC
    file, with decoded STREAMINFO / tags / seek points / picture fields
    (the blocks metadata.zig packs; the reference ships no reader)."""
    import mmap

    from .decoder import (
        BLOCK_NAMES,
        FlacDecodeError,
        metadata_blocks,
        parse_vorbis_body,
    )

    try:
        f = open(args.input, "rb")
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    with f:
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        container = "FLAC"
        if bytes(data[:4]) == b"OggS":
            from .ogg import flac_streams, ogg_to_flac

            container = "Ogg-FLAC"
            try:
                streams = flac_streams(bytes(data))
                if len(streams) > 1:
                    container += (
                        f" ({len(streams)} logical streams; first shown)"
                    )
                data = ogg_to_flac(bytes(data))
            except ValueError as e:
                print(f"error: invalid stream ({e})", file=sys.stderr)
                return 2
        print(f"{args.input}: {container}, "
              f"{os.path.getsize(args.input)} bytes")
        try:
            for btype, body in metadata_blocks(data):
                name = BLOCK_NAMES.get(btype, f"RESERVED({btype})")
                print(f"  {name}: {len(body)} bytes")
                if btype == 0 and len(body) == 34:
                    packed = int.from_bytes(body[10:18], "big")
                    rate = packed >> 44
                    ch = ((packed >> 41) & 7) + 1
                    depth = ((packed >> 36) & 0x1F) + 1
                    total = packed & ((1 << 36) - 1)
                    secs = total / rate if rate else 0.0
                    print(f"    {rate} Hz, {ch} ch, {depth}-bit, "
                          f"{total} samples ({secs:.3f} s)")
                    print(
                        "    block size "
                        f"{int.from_bytes(body[0:2], 'big')}.."
                        f"{int.from_bytes(body[2:4], 'big')}, frame size "
                        f"{int.from_bytes(body[4:7], 'big')}.."
                        f"{int.from_bytes(body[7:10], 'big')} bytes"
                    )
                    print(f"    MD5 {body[18:34].hex()}")
                elif btype == 3:
                    print(f"    {len(body) // 18} seek points")
                elif btype == 4:
                    vendor, comments = parse_vorbis_body(body)
                    print(f"    vendor: {vendor.decode('utf-8', 'replace')}")
                    for c in comments:
                        print(f"    {c}")
                elif btype == 2 and len(body) >= 4:
                    print(
                        "    id "
                        f"{body[:4].decode('ascii', 'replace')!r}, "
                        f"{len(body) - 4} data bytes"
                    )
                elif btype == 5 and len(body) >= 396:
                    cat = body[:128].rstrip(b"\x00").decode("ascii", "replace")
                    print(f"    {body[395]} tracks"
                          + (f", catalog {cat}" if cat else ""))
                elif btype == 6 and len(body) >= 32:
                    p = 4
                    mlen = int.from_bytes(body[p : p + 4], "big")
                    mime = body[p + 4 : p + 4 + mlen].decode("ascii", "replace")
                    p += 4 + mlen
                    dlen = int.from_bytes(body[p : p + 4], "big")
                    p += 4 + dlen
                    w = int.from_bytes(body[p : p + 4], "big")
                    h = int.from_bytes(body[p + 4 : p + 8], "big")
                    ilen = int.from_bytes(body[p + 16 : p + 20], "big")
                    print(f"    {mime}, {w}x{h}, {ilen} image bytes")
        except (FlacDecodeError, IndexError, EOFError) as e:
            print(f"error: invalid FLAC stream ({e})", file=sys.stderr)
            return 2
    return 0


def _test_main(args, device, backend) -> int:
    """`flac -t` equivalent: streaming decode-and-verify (every frame CRC,
    page CRCs for Ogg input, STREAMINFO MD5) with no output written."""
    from .decoder import FlacDecodeError, decode_file

    t0 = time.perf_counter()
    try:
        info = decode_file(
            args.input, os.devnull, check_crc=True, verify=True,
            device=device, backend=backend, threads=args.threads,
        )
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except (FlacDecodeError, EOFError, IndexError) as e:
        if "MD5 mismatch" in str(e):
            print(f"{args.input}: FAILED (MD5 mismatch)", file=sys.stderr)
            return 3
        print(f"{args.input}: FAILED ({e})", file=sys.stderr)
        return 2
    dt = time.perf_counter() - t0
    secs = (
        info.interchannel_samples / info.sample_rate if info.sample_rate else 0
    )
    print(f"{args.input}: ok ({info.interchannel_samples} samples, "
          f"{secs:.3f} s, verified in {dt*1e3:.0f} ms)")
    return 0


def _edit_main(args) -> int:
    """--edit: metaflac-style in-place metadata editing of an existing
    FLAC file (the reference only writes metadata at encode time,
    libFLAC/metadata.zig; re-tagging finished files is the other half of
    that surface)."""
    from .metaedit import (
        MetaEditError,
        edit_metadata_file,
        export_pictures,
    )

    if args.output is not None:
        print("error: --edit works in place; no output path", file=sys.stderr)
        return 1
    tags = []
    for t in args.tag:
        if "=" not in t:
            print(f"error: --tag expects NAME=VALUE, got {t!r}",
                  file=sys.stderr)
            return 1
        tags.append(tuple(t.split("=", 1)))
    picture = None
    if args.picture:
        with open(args.picture, "rb") as imf:
            img = imf.read()
        mime = (
            "image/png" if img[:8] == b"\x89PNG\r\n\x1a\n" else "image/jpeg"
        )
        picture = (img, mime)
    set_apps = []
    for spec in args.set_applications:
        if "=" not in spec:
            print(f"error: --set-application expects ID=FILE, got {spec!r}",
                  file=sys.stderr)
            return 1
        app_id, app_file = spec.split("=", 1)
        try:
            with open(app_file, "rb") as af:
                set_apps.append((app_id.encode("ascii"), af.read()))
        except (FileNotFoundError, UnicodeEncodeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    cuesheet_text = None
    if args.cuesheet:
        try:
            with open(args.cuesheet, "r", encoding="utf-8",
                      errors="replace") as cf:
                cuesheet_text = cf.read()
        except FileNotFoundError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    import_tags = []
    if args.import_tags_from:
        from .metaedit import parse_tags_file

        try:
            with open(args.import_tags_from, "r", encoding="utf-8",
                      errors="replace") as tf:
                import_tags = parse_tags_file(tf.read())
        except FileNotFoundError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        except MetaEditError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    try:
        remove_apps = [a.encode("ascii") for a in args.remove_applications]
    except UnicodeEncodeError as e:
        print(f"error: application IDs must be ASCII: {e}", file=sys.stderr)
        return 1
    try:
        if args.export_picture:
            with open(args.input, "rb") as f:
                pics = export_pictures(f.read())
            if not pics:
                print("error: no PICTURE block in stream", file=sys.stderr)
                return 1
            mime, image = pics[0]
            with open(args.export_picture, "wb") as out:
                out.write(image)
            print(f"exported {len(image)} bytes ({mime}) "
                  f"to {args.export_picture}")
            if not (tags or import_tags or args.remove_tags or picture
                    or args.remove_pictures or set_apps
                    or args.remove_applications or cuesheet_text is not None
                    or args.remove_cuesheet or args.padding is not None):
                return 0
        plan = edit_metadata_file(
            args.input,
            add_tags=tags + import_tags,
            remove_tags=args.remove_tags,
            picture=picture,
            remove_pictures=args.remove_pictures,
            padding=args.padding,
            set_applications=set_apps,
            remove_applications=remove_apps,
            cuesheet=cuesheet_text,
            remove_cuesheet=args.remove_cuesheet,
        )
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except MetaEditError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    changes = []
    if plan.tags_added:
        changes.append(f"+{plan.tags_added} tag(s)")
    if plan.tags_removed:
        changes.append(f"-{plan.tags_removed} tag(s)")
    if plan.picture_added:
        changes.append("+picture")
    if plan.pictures_removed:
        changes.append(f"-{plan.pictures_removed} picture(s)")
    if plan.applications_set:
        changes.append(f"+{plan.applications_set} application(s)")
    if plan.applications_removed:
        changes.append(f"-{plan.applications_removed} application(s)")
    if plan.cuesheet_set:
        changes.append("+cuesheet")
    if plan.cuesheet_removed:
        changes.append("-cuesheet")
    how = "in place" if plan.in_place else "rewritten"
    print(f"{args.input}: {', '.join(changes) or 'no change'} "
          f"({how}, padding {plan.padding})")
    return 0


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
    if args.verify:
        from .decoder import verify_flac

        bad = []
        for f, p in zip(names, out_paths):
            with open(p, "rb") as fh:
                if not verify_flac(fh.read(), device=device):  # Ogg-aware
                    bad.append(f)
        if bad:
            print(f"verify: FAILED ({', '.join(bad)})", file=sys.stderr)
            return 3
        print(f"verify: ok ({len(names)} files)")
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

    if args.list_meta:
        return _list_main(args)
    if args.edit and not args.test:  # -t wins over -e, as in the JAX CLI
        return _edit_main(args)

    from .models.encoder import encode_file
    from .models.pipeline import resolve_device
    from .wav import WavFormatError, WavStreamReader

    # --threads asks for the all-C++ decode, which touches no device
    native = (args.decode or args.test) and args.threads is not None
    backend = "native" if native else "device"
    device = None
    if backend == "device":
        try:
            # before any file is opened: a cuda request without a card is
            # an error here, never a quiet fallback
            device = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    if args.test:
        return _test_main(args, device, backend)
    if args.output is None:
        parser.error("output path required (omit it only with --list/--test/--edit)")
    if args.decode:
        return _decode_main(args, device, backend)

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

    if args.verify:
        from .decoder import verify_flac

        with open(args.output, "rb") as f:
            ok = verify_flac(f.read(), device=device)  # Ogg-aware
        if not ok:
            print("verify: FAILED", file=sys.stderr)
            return 3
        print("verify: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
