"""The port's wav2flac CLI (``python -m zigflac_tpu_torch.cli``) on the CPU,
called in-process with ``--device cpu``, against the JAX package's CLI on
its device backend under JAX_PLATFORMS=cpu: single file with the metadata
flags, ``--batch`` over a directory, Ogg-FLAC output, ``--stats``, the exit
codes, the decode-side modes (``-d`` with ``--range``, ``--verify`` and
``--threads``, ``-t``, ``-l``, ``--verify`` after an encode), and the
metadata editor (``-e`` with every option), which touches no device.

Tolerance: exact equality of the output bytes, and of the printed lines
once the milliseconds they report are masked."""

import re

import numpy as np
import pytest
import torch

import zigflac_tpu_torch as zt
from conftest import make_signal
from zigflac_tpu import cli as jax_cli
from zigflac_tpu_torch import cli
from zigflac_tpu_torch.wav import wav_header_bytes, write_wav

BLOCK = ["--block-size", "1024"]


def _write(path, rng, n, channels=2, kind="mixed"):
    write_wav(str(path), make_signal(rng, n, channels=channels, kind=kind), 44100, 16)
    return str(path)


def test_single_file_equals_jax_cli(tmp_path, rng):
    wav = _write(tmp_path / "in.wav", rng, 5 * 1024 + 37)
    png = tmp_path / "cover.png"
    png.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(100))
    flags = [*BLOCK, "--tag", "TITLE=cli", "--tag", "ARTIST=zf", "--seek-interval", "0.05",
             "--padding", "100", "--picture", str(png)]
    got, want = tmp_path / "port.flac", tmp_path / "jax.flac"
    assert cli.main([wav, str(got), "--device", "cpu", *flags]) == 0
    assert jax_cli.main([wav, str(want), "--backend", "device", *flags]) == 0
    assert got.read_bytes() == want.read_bytes()


def test_batch_directory_equals_jax_cli(tmp_path, rng):
    indir = tmp_path / "wavs"
    indir.mkdir()
    for i, (n, kind) in enumerate([(3 * 1024 + 5, "sine"), (1024 + 40, "mixed"),
                                   (2 * 1024, "noise")]):
        _write(indir / f"f{i}.wav", rng, n, kind=kind)
    (indir / "notes.txt").write_text("not a wav")
    assert cli.main(["--batch", str(indir), str(tmp_path / "port"), "--device", "cpu",
                     *BLOCK]) == 0
    assert jax_cli.main(["--batch", str(indir), str(tmp_path / "jax"), "--backend", "device",
                         *BLOCK]) == 0
    for i in range(3):
        got = (tmp_path / "port" / f"f{i}.flac").read_bytes()
        assert got == (tmp_path / "jax" / f"f{i}.flac").read_bytes()
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "f0.flac", "f1.flac", "f2.flac"]


@pytest.mark.parametrize("how", ["--ogg", ".oga", "--batch --ogg"])
def test_ogg_output_equals_jax_cli(tmp_path, rng, how):
    """``--ogg``, an .oga output name, and ``--batch --ogg`` (.oga names)."""
    indir = tmp_path / "wavs"
    indir.mkdir()
    wav = _write(indir / "a.wav", rng, 2 * 1024 + 9)
    if how == "--batch --ogg":
        args = ["--batch", str(indir), "{out}", "--ogg"]
        name = "a.oga"
    else:
        name = "a.flac" if how == "--ogg" else "a.oga"
        args = [wav, "{out}/" + name] + (["--ogg"] if how == "--ogg" else [])
    for side, run, dev in (("port", cli.main, ["--device", "cpu"]),
                           ("jax", jax_cli.main, ["--backend", "device"])):
        (tmp_path / side).mkdir()
        assert run([a.format(out=tmp_path / side) for a in args] + dev + BLOCK) == 0
    got = (tmp_path / "port" / name).read_bytes()
    assert got[:4] == b"OggS" and got == (tmp_path / "jax" / name).read_bytes()


def test_stats_prints_its_line(tmp_path, rng, capsys):
    wav = _write(tmp_path / "in.wav", rng, 2 * 1024 + 9)
    out = tmp_path / "o.flac"
    assert cli.main([wav, str(out), "--device", "cpu", "--stats", *BLOCK]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith("encoded ") and "MB/s" in line and "x realtime" in line
    with open(wav, "rb") as f:
        assert out.read_bytes() == zt.encode_wav_bytes(
            f.read(), config=zt.EncoderConfig(block_size=1024), device="cpu")


def _unsupported_wav(path):
    """A WAV whose codec field says IEEE float (3): FLAC cannot hold it."""
    hdr = bytearray(wav_header_bytes(4, 2, 44100, 16))
    hdr[20:22] = (3).to_bytes(2, "little")
    path.write_bytes(bytes(hdr) + bytes(16))
    return str(path)


@pytest.mark.parametrize("case,code", [("missing file", 1), ("bad tag", 1),
                                       ("batch of a file", 1), ("unsupported wav", 2)])
def test_exit_codes(tmp_path, rng, case, code):
    wav = _write(tmp_path / "in.wav", rng, 1000)
    out = tmp_path / "o.flac"
    argv = {
        "missing file": [str(tmp_path / "nope.wav"), str(out)],
        "bad tag": [wav, str(out), "--tag", "NOEQUALS"],
        "batch of a file": ["--batch", wav, str(tmp_path / "outdir")],
        "unsupported wav": [_unsupported_wav(tmp_path / "float.wav"), str(out)],
    }[case]
    assert cli.main(argv + ["--device", "cpu"]) == code
    assert not out.exists()


@pytest.mark.parametrize("flag", [["-e"], ["--edit"], ["--remove-tag", "A"],
                                  ["--remove-pictures"], ["--export-picture", "p.png"],
                                  ["--import-tags-from", "t.txt"],
                                  ["--set-application", "abcd=f"],
                                  ["--remove-application", "abcd"], ["--remove-cuesheet"],
                                  ["-e", "--tag", "A=b"]])
def test_unported_modes_are_refused(tmp_path, rng, flag, capsys):
    """The edit mode and its options, once refused, are now taken as the
    JAX CLI takes them: with an input and an output path ``-e`` exits 1
    (it edits in place) and writes nothing, and the edit options alone are
    ignored by an encode. Same exit code, same printed lines, same file."""
    wav = _write(tmp_path / "in.wav", rng, 1000)
    port_rc, jax_rc = _both(capsys, [wav, str(tmp_path / "p.flac"), "--device", "cpu", *flag],
                            [wav, str(tmp_path / "j.flac"), "--backend", "golden", *flag])
    assert port_rc == jax_rc == (1 if flag[0] in ("-e", "--edit") else 0)
    if port_rc == 0:
        assert (tmp_path / "p.flac").read_bytes() == (tmp_path / "j.flac").read_bytes()
    else:
        assert not (tmp_path / "p.flac").exists() and not (tmp_path / "j.flac").exists()


@pytest.mark.parametrize("batch", [False, True])
def test_cuda_without_a_card_exits_nonzero(tmp_path, rng, monkeypatch, capsys, batch):
    """The default device is cuda; without a card the CLI says so and writes
    nothing, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav = _write(tmp_path / "in.wav", rng, 1000)
    out = tmp_path / "out"
    argv = ["--batch", str(tmp_path), str(out)] if batch else [wav, str(out)]
    assert cli.main(argv) == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
    assert not out.exists()


def test_profile_writes_a_torch_trace(tmp_path, rng):
    """``--profile DIR`` writes a torch.profiler trace of the encode, and
    the output bytes do not change."""
    wav = _write(tmp_path / "in.wav", rng, 1024 + 9)
    out, prof = tmp_path / "o.flac", tmp_path / "prof"
    assert cli.main([wav, str(out), "--device", "cpu", "--profile", str(prof), *BLOCK]) == 0
    assert (prof / "trace.json").stat().st_size > 0
    with open(wav, "rb") as f:
        assert out.read_bytes() == zt.encode_wav_bytes(
            f.read(), config=zt.EncoderConfig(block_size=1024), device="cpu")


# -- the decode-side modes -----------------------------------------------------

def _masked(text):
    """The printed lines with the times they report masked."""
    return re.sub(r"[0-9.]+ ms|[0-9]+x realtime", "T", text)


def _both(capsys, port_argv, jax_argv):
    """Run the port's CLI and the JAX package's; returns their exit codes
    after holding the printed lines of the two against each other."""
    capsys.readouterr()
    port_rc = cli.main(port_argv)
    port_out = capsys.readouterr()
    jax_rc = jax_cli.main(jax_argv)
    jax_out = capsys.readouterr()
    assert _masked(port_out.out) == _masked(jax_out.out)
    assert _masked(port_out.err) == _masked(jax_out.err)
    return port_rc, jax_rc


@pytest.fixture(scope="module")
def flac_file(tmp_path_factory):
    """A WAV and its FLAC from the port's CLI (tags, SEEKTABLE, PADDING and a
    PICTURE), and damaged copies: a flipped frame byte, a flipped MD5."""
    d = tmp_path_factory.mktemp("cli_decode")
    rng = np.random.default_rng(0xD3C0)
    wav = _write(d / "in.wav", rng, 9 * 1024 + 77)
    png = d / "cover.png"
    png.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(64))
    flac = d / "a.flac"
    assert cli.main([wav, str(flac), "--device", "cpu", *BLOCK, "--tag", "TITLE=decode me",
                     "--seek-interval", "0.05", "--padding", "64", "--picture", str(png)]) == 0
    data = flac.read_bytes()
    for name, at in (("crc.flac", len(data) // 2), ("md5.flac", 26)):
        bad = bytearray(data)
        bad[at] ^= 0xFF
        (d / name).write_bytes(bytes(bad))
    oga = d / "a.oga"
    assert cli.main([wav, str(oga), "--device", "cpu", *BLOCK, "--tag", "TITLE=ogg"]) == 0
    return d


@pytest.mark.parametrize("how", [["--device", "cpu"], ["--threads", "1"], ["--threads", "3"],
                                 ["--device", "cpu", "--verify", "--stats"]],
                         ids=["device", "threads1", "threads3", "verify_stats"])
@pytest.mark.parametrize("name", ["a.flac", "a.oga"])
def test_decode_writes_the_jax_cli_wav(flac_file, tmp_path, capsys, name, how):
    """``-d`` on the device backend, on the all-C++ path, and with
    ``--verify --stats``: the input WAV comes back byte for byte."""
    src = str(flac_file / name)
    jax_how = [a for a in how if a not in ("--device", "cpu")]
    rcs = _both(capsys, ["-d", src, str(tmp_path / "port.wav"), *how],
                ["-d", src, str(tmp_path / "jax.wav"), *jax_how])
    assert rcs == (0, 0)
    got = (tmp_path / "port.wav").read_bytes()
    assert got == (tmp_path / "jax.wav").read_bytes() == (flac_file / "in.wav").read_bytes()


@pytest.mark.parametrize("name,code", [("a.flac", 0), ("a.oga", 0), ("crc.flac", 2),
                                       ("md5.flac", 3), ("missing.flac", 1), ("in.wav", 2)])
@pytest.mark.parametrize("how", [["--device", "cpu"], ["--threads", "2"]], ids=["device", "native"])
def test_test_mode_equals_jax_cli(flac_file, capsys, name, code, how):
    """``-t``: the verdict line and the exit code (0 ok, 2 malformed or a
    frame CRC, 3 an MD5 mismatch, 1 no such file) are the JAX CLI's."""
    src = str(flac_file / name)
    assert _both(capsys, ["-t", src, *how], ["-t", src]) == (code, code)


def test_decode_with_verify_reports_an_md5_mismatch(flac_file, tmp_path, capsys):
    src = str(flac_file / "md5.flac")
    assert _both(capsys, ["-d", src, str(tmp_path / "p.wav"), "--device", "cpu", "--verify"],
                 ["-d", src, str(tmp_path / "j.wav"), "--verify"]) == (3, 3)
    # without --verify the MD5 is not looked at
    assert cli.main(["-d", src, str(tmp_path / "p.wav"), "--device", "cpu"]) == 0
    assert (tmp_path / "p.wav").read_bytes() == (flac_file / "in.wav").read_bytes()
    assert _both(capsys, ["-d", str(flac_file / "crc.flac"), str(tmp_path / "p.wav"),
                          "--device", "cpu"],
                 ["-d", str(flac_file / "crc.flac"), str(tmp_path / "j.wav")]) == (2, 2)


@pytest.mark.parametrize("batch", [False, True], ids=["single", "batch"])
@pytest.mark.parametrize("ogg", [False, True], ids=["flac", "ogg"])
def test_verify_after_encode_equals_jax_cli(tmp_path, rng, capsys, batch, ogg):
    """``--verify`` decodes what was just written with the port's own
    decoder and prints ``verify: ok``."""
    indir = tmp_path / "wavs"
    indir.mkdir()
    for i in range(2):
        _write(indir / f"f{i}.wav", rng, 2 * 1024 + 9 + i)
    flags = [*BLOCK, "--verify"] + (["--ogg"] if ogg else [])
    if batch:
        port, jax = ["--batch", str(indir), str(tmp_path / "p")], ["--batch", str(indir),
                                                                   str(tmp_path / "j")]
    else:
        port, jax = [str(indir / "f0.wav"), str(tmp_path / "p.flac")], [str(indir / "f0.wav"),
                                                                       str(tmp_path / "j.flac")]
    assert _both(capsys, port + flags + ["--device", "cpu"],
                 jax + flags + ["--backend", "device"]) == (0, 0)
    cli.main(port + flags + ["--device", "cpu"])
    assert capsys.readouterr().out == ("verify: ok (2 files)\n" if batch else "verify: ok\n")


def test_verify_failure_exits_3(tmp_path, rng, capsys, monkeypatch):
    """A stream that does not verify after the encode: exit 3, as the JAX
    CLI (the damage is done by a decoder that rejects everything)."""
    from zigflac_tpu_torch import decoder

    wav = _write(tmp_path / "in.wav", rng, 1024 + 9)
    monkeypatch.setattr(decoder, "verify_flac", lambda data, **kw: False)
    assert cli.main([wav, str(tmp_path / "o.flac"), "--device", "cpu", "--verify", *BLOCK]) == 3
    assert capsys.readouterr().err == "verify: FAILED\n"
    assert cli.main(["--batch", str(tmp_path), str(tmp_path / "out"), "--device", "cpu",
                     "--verify", *BLOCK]) == 3
    assert capsys.readouterr().err == "verify: FAILED (in.wav)\n"


@pytest.mark.parametrize("name,code", [("a.flac", 0), ("a.oga", 0), ("md5.flac", 0),
                                       ("in.wav", 2), ("missing.flac", 1)])
def test_list_equals_jax_cli(flac_file, capsys, monkeypatch, name, code):
    """``-l`` prints the JAX CLI's block listing, and needs no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = str(flac_file / name)
    assert _both(capsys, ["-l", src], ["-l", src]) == (code, code)
    if name == "a.flac":
        cli.main(["-l", src])
        out = capsys.readouterr().out
        for part in ("STREAMINFO: 34 bytes", "44100 Hz, 2 ch, 16-bit, 9293 samples",
                     "SEEKTABLE", "TITLE=decode me", "PICTURE", "PADDING: 64 bytes"):
            assert part in out


@pytest.mark.parametrize("span,code", [("0.05:0.1", 0), ("0:0.01", 0), ("0.2:9", 0),
                                       ("0.1:0.05", 1), ("abc", 1), ("5:6", 2)])
@pytest.mark.parametrize("name", ["a.flac", "a.oga"])
def test_range_equals_jax_cli(flac_file, tmp_path, capsys, name, span, code):
    """``-d --range``: the slice's WAV and the printed line are the JAX
    CLI's; a malformed range exits 1 and one past the stream's end 2."""
    src = str(flac_file / name)
    rcs = _both(capsys, ["-d", src, str(tmp_path / "p.wav"), "--range", span, "--device", "cpu"],
                ["-d", src, str(tmp_path / "j.wav"), "--range", span])
    assert rcs == (code, code)
    if code == 0:
        assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    else:
        assert not (tmp_path / "p.wav").exists()


def test_decode_needs_an_output_path(flac_file, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["-d", str(flac_file / "a.flac"), "--device", "cpu"])
    assert exc.value.code == 1 and "output path required" in capsys.readouterr().err


@pytest.mark.parametrize("mode", [["-d"], ["-t"], ["-d", "--range", "0:0.1"]],
                         ids=["decode", "test", "range"])
def test_decode_modes_without_a_card_exit_nonzero(flac_file, tmp_path, monkeypatch, capsys, mode):
    """The decode-side modes default to cuda too; ``--threads`` asks for the
    all-C++ path, which needs no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [*mode, str(flac_file / "a.flac")] + ([] if mode == ["-t"] else [str(tmp_path / "o.wav")])
    assert cli.main(argv) == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
    assert not (tmp_path / "o.wav").exists()
    assert cli.main(argv + ["--threads", "2"]) == 0


# -- the metadata editor --------------------------------------------------------

@pytest.fixture(scope="module")
def edit_inputs(tmp_path_factory):
    """A FLAC with a tag and PADDING, an Ogg-FLAC, and the side files the
    edit options read."""
    d = tmp_path_factory.mktemp("cli_edit")
    wav = _write(d / "in.wav", np.random.default_rng(0xED17), 3 * 1024 + 5)
    assert cli.main([wav, str(d / "a.flac"), "--device", "cpu", *BLOCK, "--tag", "TITLE=first",
                     "--padding", "512"]) == 0
    assert cli.main([wav, str(d / "a.oga"), "--device", "cpu", *BLOCK]) == 0
    (d / "cover.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"fakepng" * 30)
    (d / "tags.txt").write_text("ALBUM=someday\nTITLE=track one\n")
    (d / "bad_tags.txt").write_text("oops\n")
    (d / "app.bin").write_bytes(b"\x01\x02\x03opaque")
    (d / "x.cue").write_text("TRACK 01 AUDIO\nINDEX 01 00:00:00\n")
    return d


# each: the edits made in turn on one copy of a.flac (or a.oga), with the
# exit code each must give
EDITS = {
    "tags and picture": [(["--tag", "ALBUM=a", "--remove-tag", "TITLE", "--picture",
                           "cover.png"], 0)],
    "export picture": [(["--picture", "cover.png"], 0), (["--export-picture", "out.png"], 0),
                       (["--export-picture", "out2.png", "--tag", "A=b"], 0)],
    "no picture to export": [(["--export-picture", "out.png"], 1)],
    "remove pictures": [(["--picture", "cover.png"], 0), (["--remove-pictures"], 0)],
    "metaflac long tail": [(["--import-tags-from", "tags.txt", "--set-application",
                             "Ztst=app.bin", "--cuesheet", "x.cue"], 0),
                           (["--remove-application", "Ztst", "--remove-cuesheet"], 0)],
    "rewrite past the padding": [(["--tag", "LYRICS=" + "x" * 2048], 0)],
    "padding resize": [(["--padding", "4096"], 0), (["--tag", "A=b"], 0)],
    "bad tag": [(["--tag", "NOEQUALS"], 1)],
    "application without a file": [(["--set-application", "nofile"], 1)],
    "missing application file": [(["--set-application", "Ztst=nope.bin"], 1)],
    "bad tags file": [(["--import-tags-from", "bad_tags.txt"], 2)],
    "missing tags file": [(["--import-tags-from", "nope.txt"], 1)],
    "missing cue sheet": [(["--cuesheet", "nope.cue"], 1)],
    "non-ASCII application id": [(["--remove-application", "Zt\u00e9"], 1)],
    "bad application id": [(["--set-application", "toolong=app.bin"], 2)],
    "no change": [([], 0)],
    "ogg input": [(["--tag", "A=b"], 2)],
    "missing input": [(["--tag", "A=b"], 1)],
    "output path": [(["--tag", "A=b"], 1)],
}


@pytest.mark.parametrize("case", list(EDITS))
def test_edit_equals_jax_cli(edit_inputs, tmp_path, monkeypatch, capsys, case):
    """``-e`` with every option the JAX CLI's takes: the same exit code,
    printed lines and file bytes (the edited file, an exported picture),
    without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = "a.oga" if case == "ogg input" else "a.flac"
    name = "nope.flac" if case == "missing input" else "x" + src[1:]
    files = {}
    for side, run in (("port", cli.main), ("jax", jax_cli.main)):
        d = tmp_path / side
        d.mkdir()
        for f in edit_inputs.iterdir():
            (d / f.name).write_bytes(f.read_bytes())
        (d / ("x" + src[1:])).write_bytes((edit_inputs / src).read_bytes())
        monkeypatch.chdir(d)
        out = ["other.flac"] if case == "output path" else []
        files[side] = [(run([name, *out, "-e", *flags]), capsys.readouterr())
                       for flags, _ in EDITS[case]]
        files[side].append({f.name: f.read_bytes() for f in sorted(d.iterdir())})
    for (port_rc, port_out), (jax_rc, jax_out), (_, code) in zip(
            files["port"][:-1], files["jax"][:-1], EDITS[case]):
        assert port_rc == jax_rc == code
        assert (port_out.out, port_out.err) == (jax_out.out, jax_out.err)
    assert files["port"][-1] == files["jax"][-1]


def test_edited_file_still_verifies(edit_inputs, tmp_path, capsys):
    """After ``-e``, ``-t`` on the port's CLI passes: only the head changed."""
    flac = tmp_path / "a.flac"
    flac.write_bytes((edit_inputs / "a.flac").read_bytes())
    assert cli.main([str(flac), "-e", "--remove-tag", "TITLE", "--import-tags-from",
                     str(edit_inputs / "tags.txt")]) == 0
    assert cli.main(["-t", str(flac), "--device", "cpu"]) == 0
    assert ": ok (" in capsys.readouterr().out
