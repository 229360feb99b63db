"""The port's wav2flac CLI (``python -m zigflac_tpu_torch.cli``) on the CPU,
called in-process with ``--device cpu``, against the JAX package's CLI on
its device backend under JAX_PLATFORMS=cpu: single file with the metadata
flags, ``--batch`` over a directory, Ogg-FLAC output, ``--stats``, the exit
codes, and the flags whose modes are not ported.

Tolerance: exact equality of the output bytes."""

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


@pytest.mark.parametrize("flag", [["-d"], ["--decode"], ["-l"], ["--list"], ["-t"], ["--test"],
                                  ["-e"], ["--edit"], ["--verify"], ["--range", "0:1"],
                                  ["--threads", "2"], ["--remove-tag", "A"]])
def test_unported_modes_are_refused(tmp_path, rng, flag, capsys):
    """The decode-side and edit modes are not defined yet: argparse refuses
    them with exit 1 and nothing is written."""
    wav = _write(tmp_path / "in.wav", rng, 1000)
    out = tmp_path / "o.flac"
    with pytest.raises(SystemExit) as exc:
        cli.main([wav, str(out), "--device", "cpu", *flag])
    assert exc.value.code == 1
    assert "unrecognized arguments" in capsys.readouterr().err
    assert not out.exists()


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
