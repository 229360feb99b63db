"""The port's metadata editor (``zigflac_tpu_torch.metaedit``, a copy of
``zigflac_tpu.metaedit``) against the JAX package's, case by case over
tests/test_metaedit.py: tag edits, the in-place rewrite into PADDING, the
temp-file rewrite when the chain grows, pictures, explicit padding,
APPLICATION and CUESHEET blocks, the tags-file parser and the typed errors.
Every case runs on both packages' modules from the same input FLACs (the
JAX package's golden oracle wrote them), and keeps its own checks on each.

Tolerance: exact equality of every output byte and returned value."""

import io
import os
from types import SimpleNamespace

import numpy as np
import pytest

import zigflac_tpu

PNG_SIG = b"\x89PNG\r\n\x1a\n" + b"fakepng-payload" * 20
CUE = ("CATALOG 1234567890123\n"
       "TRACK 01 AUDIO\nINDEX 01 00:00:00\n"
       "TRACK 02 AUDIO\nINDEX 01 00:00:50\n")


def _side(name: str) -> SimpleNamespace:
    """One package's modules; ``verify`` checks every frame CRC and the MD5
    (the port's on its all-C++ path, which needs no device)."""
    if name == "jax":
        from zigflac_tpu import decoder, metadata, metaedit, ogg

        verify = decoder.verify_flac
    else:
        from zigflac_tpu_torch import decoder, metadata, metaedit, ogg

        verify = lambda data: decoder.verify_flac(data, backend="native")  # noqa: E731
    return SimpleNamespace(decoder=decoder, metadata=metadata, metaedit=metaedit, ogg=ogg,
                           verify=verify, BT=metadata.BlockType)


def _wav_bytes(seconds=0.3, rate=44100, seed=11):
    from zigflac_tpu.wav import write_wav

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate))
    x = 6000 * np.sin(2 * np.pi * 330 * t / rate) + rng.normal(0, 70, (2, t.size))
    buf = io.BytesIO()
    write_wav(buf, np.clip(np.round(x), -32768, 32767).astype(np.int32), rate, 16)
    return buf.getvalue()


@pytest.fixture(scope="module")
def flacs():
    enc = zigflac_tpu.encode_wav_bytes
    from zigflac_tpu.metadata import application_block

    return {
        "tagged": enc(_wav_bytes(), backend="golden",
                      tags=[("TITLE", "orig"), ("ARTIST", "someone")], padding=256),
        "bare": enc(_wav_bytes(seed=7), backend="golden"),
        "plain": enc(_wav_bytes(seed=31), backend="golden"),
        "long": enc(_wav_bytes(seconds=1.2, seed=33), backend="golden"),
        "dup_apps": enc(_wav_bytes(seed=37), backend="golden",
                        extra_metadata=[application_block(b"Xabc", b"one", False),
                                        application_block(b"Xabc", b"two", False)]),
    }


def _frames(m, data):
    pos = 4
    for _btype, body in m.decoder.metadata_blocks(data):
        pos += 4 + len(body)
    return data[pos:]


def _tags(m, data):
    for btype, body in m.decoder.metadata_blocks(data):
        if btype == m.BT.VorbisComment:
            return m.decoder.parse_vorbis_body(body)[1]
    return []


def _types(m, data):
    return [int(t) for t, _ in m.decoder.metadata_blocks(data)]


def _apps(m, data):
    return [bytes(b) for t, b in m.decoder.metadata_blocks(data) if t == m.BT.Application]


def _plan(plan):
    return (plan.tags_added, plan.tags_removed, plan.picture_added, plan.pictures_removed,
            plan.applications_set, plan.applications_removed, plan.cuesheet_set,
            plan.cuesheet_removed, plan.in_place, plan.padding)


def _raises(exc_name, fn):
    """The message of the expected typed error (its type checked by name,
    each package having its own class)."""
    with pytest.raises(ValueError) as info:  # both typed errors are ValueErrors
        fn()
    assert type(info.value).__name__ == exc_name
    return str(info.value)


# -- the cases: each takes one package's modules, a directory of its own and
# the input FLACs, and returns what must equal across the packages ---------------

def add_and_remove_tags(m, tmp, f):
    out, plan = m.metaedit.edit_metadata_bytes(
        f["tagged"], add_tags=[("ALBUM", "new"), ("TITLE", "second")], remove_tags=["artist"])
    assert plan.tags_added == 2 and plan.tags_removed == 1
    assert _tags(m, out) == ["TITLE=orig", "ALBUM=new", "TITLE=second"]
    assert _frames(m, out) == _frames(m, f["tagged"]) and m.verify(out)
    return out, _plan(plan)


def preserves_vendor_and_order(m, tmp, f):
    out, plan = m.metaedit.edit_metadata_bytes(f["tagged"], add_tags=[("X", "1")])
    vendors = [m.decoder.parse_vorbis_body(b)[0] for data in (out, f["tagged"])
               for t, b in m.decoder.metadata_blocks(data) if t == m.BT.VorbisComment]
    assert vendors[0] == vendors[1]
    types = _types(m, out)
    assert types[:2] == [m.BT.StreamInfo, m.BT.VorbisComment] and types[-1] == m.BT.Padding
    return out, _plan(plan)


def in_place_uses_padding_slack(m, tmp, f):
    p = tmp / "a.flac"
    p.write_bytes(f["tagged"])
    plan = m.metaedit.edit_metadata_file(str(p), add_tags=[("COMMENT", "hi" * 20)])
    assert plan.in_place  # grew into the 256-byte padding
    data = p.read_bytes()
    assert _frames(m, data) == _frames(m, f["tagged"])
    assert "COMMENT=" + "hi" * 20 in _tags(m, data) and m.verify(data)
    return data, _plan(plan)


def rewrite_when_chain_outgrows_padding(m, tmp, f):
    p = tmp / "b.flac"
    p.write_bytes(f["tagged"])
    big = "x" * 2048  # larger than the 256-byte padding slack
    plan = m.metaedit.edit_metadata_file(str(p), add_tags=[("LYRICS", big)])
    assert not plan.in_place and plan.padding == 256
    data = p.read_bytes()
    assert f"LYRICS={big}" in _tags(m, data) and _frames(m, data) == _frames(m, f["tagged"])
    return data, _plan(plan), sorted(os.listdir(tmp))  # no temporary file left


def picture_roundtrip(m, tmp, f):
    p = tmp / "c.flac"
    p.write_bytes(f["tagged"])
    plan1 = m.metaedit.edit_metadata_file(str(p), picture=(PNG_SIG, "image/png"))
    with_pic = p.read_bytes()
    assert m.metaedit.export_pictures(with_pic) == [("image/png", PNG_SIG)]
    plan2 = m.metaedit.edit_metadata_file(str(p), remove_pictures=True)
    assert plan2.pictures_removed == 1 and m.metaedit.export_pictures(p.read_bytes()) == []
    assert _frames(m, p.read_bytes()) == _frames(m, f["tagged"])
    return with_pic, p.read_bytes(), _plan(plan1), _plan(plan2)


def explicit_padding_resize(m, tmp, f):
    p = tmp / "d.flac"
    p.write_bytes(f["tagged"])
    plan = m.metaedit.edit_metadata_file(str(p), padding=4096)
    assert plan.padding == 4096 and not plan.in_place
    resized = p.read_bytes()
    assert [len(b) for t, b in m.decoder.metadata_blocks(resized) if t == m.BT.Padding] == [4096]
    plan2 = m.metaedit.edit_metadata_file(str(p), add_tags=[("A", "b")])
    assert plan2.in_place and m.verify(p.read_bytes())
    return resized, p.read_bytes(), _plan(plan), _plan(plan2)


def no_vc_block_created_on_demand(m, tmp, f):
    bare = f["bare"]
    stripped = b"fLaC" + m.metaedit._serialize_chain(
        [(t, b) for t, b in m.decoder.metadata_blocks(bare) if t != m.BT.VorbisComment]
    ) + _frames(m, bare)
    out, plan = m.metaedit.edit_metadata_bytes(stripped, add_tags=[("TITLE", "t")])
    assert plan.tags_added == 1 and _tags(m, out) == ["TITLE=t"]
    assert _types(m, out)[:2] == [m.BT.StreamInfo, m.BT.VorbisComment] and m.verify(out)
    return stripped, out, _plan(plan)


def ogg_rejected(m, tmp, f):
    buf = io.BytesIO()
    m.ogg.flac_to_ogg(f["bare"], buf)
    return _raises("MetaEditError", lambda: m.metaedit.edit_metadata_bytes(
        buf.getvalue(), add_tags=[("A", "b")]))


def truncated_chain_typed_error(m, tmp, f):
    chain = bytearray()
    for btype, body in m.decoder.metadata_blocks(f["bare"]):
        chain.append(int(btype))  # last-flag bit clear
        chain += len(body).to_bytes(3, "big") + body
    bad = b"fLaC" + bytes(chain)  # no frames: the walker runs off the end
    return (_raises("FlacDecodeError", lambda: list(m.decoder.metadata_blocks(bad))),
            _raises("MetaEditError",
                    lambda: m.metaedit.edit_metadata_bytes(bad, add_tags=[("A", "b")])))


def oversized_block_bodies_typed_errors(m, tmp, f):
    big = bytes(1 << 24)  # the body exceeds 2^24-1 with its headers
    with pytest.raises(ValueError, match="too large"):
        m.metadata.picture_block(big, "image/png", False)
    return _raises("MetaEditError",
                   lambda: m.metaedit._serialize_chain([(int(m.BT.Picture), big)]))


def cue_sheet_strict_increase(m, tmp, f):
    parse = m.metadata.parse_cue_sheet
    ok = [parse("TRACK 01 AUDIO\nINDEX 01 00:00:00\nINDEX 02 00:30:00\n"
                "TRACK 02 AUDIO\nINDEX 01 01:00:00\n", 44100, 44100 * 120),
          parse("TRACK 01 AUDIO\nINDEX 01 00:00:00\nINDEX 02 00:10:00\n"
                "TRACK 02 AUDIO\nINDEX 01 00:20:00\n", 44100, 44100 * 60)]
    errors = []
    for sheet, match in (
            ("TRACK 01 AUDIO\nINDEX 01 00:30:00\nINDEX 02 01:00:00\nINDEX 03 00:45:00\n",
             "strictly increase"),
            ("TRACK 01 AUDIO\nINDEX 01 00:00:00\nINDEX 01 00:30:00\n", "INDEX numbers"),
            ("TRACK 01 AUDIO\nINDEX 01 01:00:00\nTRACK 02 AUDIO\nINDEX 01 00:30:00\n",
             "strictly increase")):
        with pytest.raises(ValueError, match=match) as info:
            parse(sheet, 44100, 44100 * 120)
        errors.append(str(info.value))
    return ok, errors


def application_set_replace_remove(m, tmp, f):
    edit = m.metaedit.edit_metadata_bytes
    out, plan = edit(f["plain"], set_applications=[(b"aTst", b"payload-1"), (b"bTst", b"other")])
    assert plan.applications_set == 2 and [a[:4] for a in _apps(m, out)] == [b"aTst", b"bTst"]
    out2, plan2 = edit(out, set_applications=[(b"aTst", b"payload-2-longer")])
    assert _apps(m, out2) == [b"aTstpayload-2-longer", b"bTstother"]
    out3, plan3 = edit(out2, remove_applications=[b"aTst"])
    assert plan3.applications_removed == 1 and _apps(m, out3) == [b"bTstother"]
    assert m.verify(out3)
    errors = [_raises("MetaEditError", lambda: edit(f["plain"], set_applications=[
                  (b"toolong", b"")])),
              _raises("MetaEditError", lambda: edit(f["plain"], remove_applications=[b"x"]))]
    return out, out2, out3, _plan(plan), _plan(plan2), _plan(plan3), errors


def cuesheet_import_and_remove(m, tmp, f):
    edit = m.metaedit.edit_metadata_bytes
    out, plan = edit(f["long"], cuesheet=CUE)
    cues = [b for t, b in m.decoder.metadata_blocks(out) if t == m.BT.CueSheet]
    assert plan.cuesheet_set and len(cues) == 1 and cues[0][395] == 3
    cue2 = "TRACK 01 AUDIO\nINDEX 01 00:00:00\n"
    out2, plan2 = edit(out, cuesheet=cue2)
    cues2 = [b for t, b in m.decoder.metadata_blocks(out2) if t == m.BT.CueSheet]
    rate, total = m.metaedit._streaminfo_fields(list(m.decoder.metadata_blocks(f["long"])))
    assert len(cues2) == 1 and cues2[0] == m.metadata.parse_cue_sheet(cue2, rate, total)[4:]
    out3, plan3 = edit(out2, remove_cuesheet=True)
    assert plan3.cuesheet_removed and m.BT.CueSheet not in _types(m, out3) and m.verify(out3)
    error = _raises("MetaEditError", lambda: edit(f["long"], cuesheet="TRACK xx AUDIO\n"))
    return out, out2, out3, _plan(plan), _plan(plan2), _plan(plan3), error


def import_tags_file_parse(m, tmp, f):
    parse = m.metaedit.parse_tags_file
    assert parse("A=1\n\nB=two words\n") == [("A", "1"), ("B", "two words")]
    return (parse("A=1\n\nB=two words\n"),
            _raises("MetaEditError", lambda: parse("A=1\nnot-a-tag\n")),
            _raises("MetaEditError", lambda: parse("=value\n")))


def application_block_builder(m, tmp, f):
    blk = m.metadata.application_block(b"riff", b"\x00\x01", False)
    assert blk[0] == int(m.BT.Application) and blk[4:8] == b"riff" and blk[8:] == b"\x00\x01"
    with pytest.raises(ValueError):
        m.metadata.application_block(b"abc", b"", False)
    return blk


def application_set_duplicate_id_last_wins(m, tmp, f):
    edit = m.metaedit.edit_metadata_bytes
    out, plan = edit(f["plain"], set_applications=[(b"Xabc", b"a"), (b"Xabc", b"b")])
    assert plan.applications_set == 1 and _apps(m, out) == [b"Xabcb"]
    assert [a[:4] for a in _apps(m, f["dup_apps"])] == [b"Xabc", b"Xabc"]
    out2, plan2 = edit(f["dup_apps"], set_applications=[(b"Xabc", b"final")])
    assert plan2.applications_set == 1 and _apps(m, out2) == [b"Xabcfinal"] and m.verify(out2)
    return out, out2, _plan(plan), _plan(plan2)


CASES = [add_and_remove_tags, preserves_vendor_and_order, in_place_uses_padding_slack,
         rewrite_when_chain_outgrows_padding, picture_roundtrip, explicit_padding_resize,
         no_vc_block_created_on_demand, ogg_rejected, truncated_chain_typed_error,
         oversized_block_bodies_typed_errors, cue_sheet_strict_increase,
         application_set_replace_remove, cuesheet_import_and_remove, import_tags_file_parse,
         application_block_builder, application_set_duplicate_id_last_wins]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_edit_equals_jax(case, flacs, tmp_path):
    got = {}
    for name in ("jax", "torch"):
        (tmp_path / name).mkdir()
        got[name] = case(_side(name), tmp_path / name, flacs)
    assert got["torch"] == got["jax"]
