"""In-place metadata editing of existing FLAC files (metaflac parity).

The reference stops at writing metadata at encode time
(libFLAC/metadata.zig; Vorbis comments sat on its queued list,
readme.md:31); real FLAC tooling also needs to RE-tag files that already
exist — metaflac's --set-tag/--remove-tag/--import-picture-from/
--export-picture-to surface. This module edits the metadata chain of a
finished .flac without re-encoding:

* the chain is parsed with the decoder's `metadata_blocks` walker and
  rebuilt with the encoder's own block builders (one serializer per
  block type in metadata.py — no second implementation),
* when the new chain fits the old chain's byte span (shrinking, or
  growing into an existing PADDING block), only the head of the file is
  rewritten IN PLACE — the audio frames are never read or copied
  (metaflac's padding-reuse behaviour; O(metadata) I/O on a
  multi-gigabyte file),
* otherwise the file is rewritten through a temp file + atomic rename.

Tag semantics follow Vorbis-comment convention: field names are
case-insensitive, `remove_tags` drops every comment whose name matches,
`add_tags` appends (so repeated fields remain possible), and the
existing vendor string is preserved.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from .metadata import BlockType, block_header_byte, picture_block


class MetaEditError(ValueError):
    """Malformed input or an edit that cannot be applied."""


def _parse_chain(data) -> Tuple[List[Tuple[int, bytes]], int]:
    """-> ([(block_type, body)...], frames_offset). Native FLAC only:
    Ogg-FLAC pages checksum their payload, so an in-place head edit would
    corrupt the container — callers get a typed error instead."""
    from .decoder import FlacDecodeError, metadata_blocks

    head = bytes(data[:4])
    if head == b"OggS":
        raise MetaEditError(
            "cannot edit Ogg-FLAC in place (page CRCs cover the metadata); "
            "decode and re-encode, or edit the native .flac"
        )
    blocks = []
    pos = 4
    try:
        for btype, body in metadata_blocks(data):
            blocks.append((btype, body))
            pos += 4 + len(body)
    except FlacDecodeError as e:
        raise MetaEditError(str(e)) from e
    return blocks, pos


def _serialize_chain(blocks: List[Tuple[int, bytes]]) -> bytes:
    out = bytearray()
    for i, (btype, body) in enumerate(blocks):
        if len(body) > 0xFFFFFF:
            raise MetaEditError(
                f"{BlockType(btype).name} block body too large for a "
                f"24-bit length ({len(body)} > {0xFFFFFF} bytes)"
            )
        last = i == len(blocks) - 1
        out.append(block_header_byte(BlockType(btype), last))
        out += len(body).to_bytes(3, "big")
        out += body
    return bytes(out)


def _tag_name(comment: str) -> str:
    return comment.split("=", 1)[0].upper()


@dataclass
class EditPlan:
    """What an edit did — returned for CLI reporting / tests."""

    tags_removed: int = 0
    tags_added: int = 0
    pictures_removed: int = 0
    picture_added: bool = False
    applications_set: int = 0
    applications_removed: int = 0
    cuesheet_set: bool = False
    cuesheet_removed: bool = False
    in_place: bool = False
    padding: int = 0


def _streaminfo_fields(blocks: List[Tuple[int, bytes]]) -> Tuple[int, int]:
    """(sample_rate, total_samples) out of a parsed chain's STREAMINFO —
    needed to resolve .cue MM:SS:FF timestamps and the lead-out offset."""
    for btype, body in blocks:
        if btype == BlockType.StreamInfo and len(body) >= 18:
            packed = int.from_bytes(body[10:18], "big")
            return packed >> 44, packed & ((1 << 36) - 1)
    raise MetaEditError("stream has no STREAMINFO block")


def parse_tags_file(text: str) -> List[Tuple[str, str]]:
    """metaflac --import-tags-from format: one NAME=VALUE per line, blank
    lines skipped (metaflac rejects comment syntax too — a line without
    '=' is an error, matching its 'malformed vorbis comment' message)."""
    tags = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if "=" not in line:
            raise MetaEditError(
                f"malformed tag at line {lineno} (expected NAME=VALUE): "
                f"{line!r}"
            )
        name, value = line.split("=", 1)
        if not name:
            raise MetaEditError(f"empty tag name at line {lineno}")
        tags.append((name, value))
    return tags


def _edit_blocks(
    blocks: List[Tuple[int, bytes]],
    add_tags: Iterable[Tuple[str, str]] = (),
    remove_tags: Iterable[str] = (),
    picture: Optional[Tuple[bytes, str]] = None,
    remove_pictures: bool = False,
    set_applications: Iterable[Tuple[bytes, bytes]] = (),
    remove_applications: Iterable[bytes] = (),
    cuesheet: Optional[str] = None,
    remove_cuesheet: bool = False,
) -> Tuple[List[Tuple[int, bytes]], EditPlan]:
    """Apply the edit to a parsed chain; padding is stripped here and
    re-added by the writer (it is the fit slack, not content).

    ``set_applications``: (4-byte id, data) pairs — replaces the existing
    APPLICATION block with the same id in its slot, else appends (metaflac
    --set-application semantics). ``remove_applications``: 4-byte ids to
    drop. ``cuesheet``: .cue text replacing/adding the CUESHEET block
    (metaflac --import-cuesheet-from); timestamps resolve against the
    chain's own STREAMINFO."""
    from .decoder import parse_vorbis_body

    plan = EditPlan()
    add_tags = list(add_tags)
    remove = {n.upper() for n in remove_tags}
    for name, _ in add_tags:
        if "=" in name:
            raise MetaEditError(f"tag name contains '=': {name!r}")
    # one block per id, last spec wins (metaflac-style set semantics)
    set_apps: Dict[bytes, bytes] = {}
    for app_id, app_data in set_applications:
        if len(app_id) != 4:
            raise MetaEditError(
                f"APPLICATION id must be exactly 4 bytes, got {app_id!r}"
            )
        set_apps[bytes(app_id)] = bytes(app_data)
    remove_apps = {bytes(a) for a in remove_applications}
    for app_id in remove_apps:
        if len(app_id) != 4:
            raise MetaEditError(
                f"APPLICATION id must be exactly 4 bytes, got {app_id!r}"
            )
    cue_body = None
    if cuesheet is not None:
        from .metadata import parse_cue_sheet

        rate, total = _streaminfo_fields(blocks)
        try:
            cue_body = parse_cue_sheet(cuesheet, rate, total)[4:]
        except ValueError as e:
            raise MetaEditError(f"bad cue sheet: {e}") from e

    out: List[Tuple[int, bytes]] = []
    vendor = None
    comments: List[str] = []
    seen_vc = False
    seen_cue = False
    replaced_apps = set()
    for btype, body in blocks:
        if btype == BlockType.VorbisComment and not seen_vc:
            seen_vc = True
            vendor, comments = parse_vorbis_body(body)
            comments = list(comments)
            continue  # re-emitted (possibly edited) below, same slot
        if btype == BlockType.Padding:
            continue  # slack, re-added by the writer
        if btype == BlockType.Picture and remove_pictures:
            plan.pictures_removed += 1
            continue
        if btype == BlockType.Application and len(body) >= 4:
            app_id = bytes(body[:4])
            if app_id in remove_apps:
                plan.applications_removed += 1
                continue
            if app_id in set_apps:
                if app_id in replaced_apps:
                    continue  # collapse duplicates of a set id
                out.append((btype, app_id + set_apps[app_id]))  # same slot
                replaced_apps.add(app_id)
                plan.applications_set += 1
                continue
        if btype == BlockType.CueSheet:
            if remove_cuesheet:
                plan.cuesheet_removed = True
                continue
            if cue_body is not None and not seen_cue:
                seen_cue = True
                out.append((btype, cue_body))  # same slot
                plan.cuesheet_set = True
                continue
        out.append((btype, body))  # duplicate VC blocks pass untouched

    for app_id, app_data in set_apps.items():
        if app_id not in replaced_apps:
            out.append((int(BlockType.Application), app_id + app_data))
            plan.applications_set += 1
    if cue_body is not None and not seen_cue:
        out.append((int(BlockType.CueSheet), cue_body))
        plan.cuesheet_set = True

    if remove:
        kept = [c for c in comments if _tag_name(c) not in remove]
        plan.tags_removed = len(comments) - len(kept)
        comments = kept
    if add_tags:
        comments.extend(f"{n}={v}" for n, v in add_tags)
        plan.tags_added = len(add_tags)

    # rebuild the VC block in its original slot (right after STREAMINFO
    # when newly created — the reference's own block order,
    # libFLAC/Encoder.zig:394-419)
    if seen_vc or comments:
        from .metadata import VENDOR_STRING

        # serialize the comment strings directly (NOT via the name=value
        # builder) so pre-existing comments survive byte-for-byte even
        # when they lack an '=' separator
        vc = bytearray()
        ven = vendor if vendor is not None else VENDOR_STRING
        vc += len(ven).to_bytes(4, "little") + ven
        vc += len(comments).to_bytes(4, "little")
        for c in comments:
            cb = c.encode("utf-8")
            vc += len(cb).to_bytes(4, "little") + cb
        vc_block = (int(BlockType.VorbisComment), bytes(vc))
        if seen_vc:
            # original position: after the blocks that preceded it
            idx = next(
                (i for i, (bt, _) in enumerate(blocks)
                 if bt == BlockType.VorbisComment), None)
            insert_at = sum(
                1 for bt, _ in blocks[:idx]
                if bt not in (BlockType.Padding,)
                and not (bt == BlockType.Picture and remove_pictures))
            out.insert(min(insert_at, len(out)), vc_block)
        else:
            out.insert(1 if out and out[0][0] == BlockType.StreamInfo
                       else 0, vc_block)

    if picture is not None:
        image, mime = picture
        out.append(
            (int(BlockType.Picture), picture_block(image, mime, False)[4:])
        )
        plan.picture_added = True
    return out, plan


def export_pictures(data) -> List[Tuple[str, bytes]]:
    """All PICTURE blocks of a stream -> [(mime, image bytes)...]."""
    blocks, _ = _parse_chain(data)
    out = []
    for btype, body in blocks:
        if btype != BlockType.Picture:
            continue
        mlen = int.from_bytes(body[4:8], "big")
        mime = body[8 : 8 + mlen].decode("ascii", "replace")
        p = 8 + mlen
        dlen = int.from_bytes(body[p : p + 4], "big")
        p += 4 + dlen  # description
        p += 16  # width/height/depth/colors
        ilen = int.from_bytes(body[p : p + 4], "big")
        out.append((mime, body[p + 4 : p + 4 + ilen]))
    return out


def edit_metadata_bytes(
    data: bytes,
    add_tags: Iterable[Tuple[str, str]] = (),
    remove_tags: Iterable[str] = (),
    picture: Optional[Tuple[bytes, str]] = None,
    remove_pictures: bool = False,
    padding: Optional[int] = None,
    set_applications: Iterable[Tuple[bytes, bytes]] = (),
    remove_applications: Iterable[bytes] = (),
    cuesheet: Optional[str] = None,
    remove_cuesheet: bool = False,
) -> Tuple[bytes, EditPlan]:
    """Pure-bytes edit: returns the complete new stream (head rebuilt,
    frames copied verbatim) and the plan. ``padding`` sets the PADDING
    body size (None keeps the old chain's total padding)."""
    blocks, frames_off = _parse_chain(data)
    if padding is None:
        padding = sum(len(b) + 4 for t, b in blocks
                      if t == BlockType.Padding)
        padding = max(0, padding - 4) if padding else 0
    new_blocks, plan = _edit_blocks(
        blocks, add_tags, remove_tags, picture, remove_pictures,
        set_applications, remove_applications, cuesheet, remove_cuesheet,
    )
    if padding:
        new_blocks.append((int(BlockType.Padding), b"\x00" * padding))
    plan.padding = padding
    chain = _serialize_chain(new_blocks)
    return b"fLaC" + chain + bytes(data[frames_off:]), plan


def edit_metadata_file(
    path: str,
    add_tags: Iterable[Tuple[str, str]] = (),
    remove_tags: Iterable[str] = (),
    picture: Optional[Tuple[bytes, str]] = None,
    remove_pictures: bool = False,
    padding: Optional[int] = None,
    set_applications: Iterable[Tuple[bytes, bytes]] = (),
    remove_applications: Iterable[bytes] = (),
    cuesheet: Optional[str] = None,
    remove_cuesheet: bool = False,
) -> EditPlan:
    """Edit ``path`` in place. If the new chain fits the old head span
    (using PADDING as slack, metaflac-style) only the head bytes are
    rewritten; otherwise the whole file streams through a temp file and
    atomically replaces the original."""
    import mmap

    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        blocks, frames_off = _parse_chain(mm)
        old_span = frames_off - 4  # chain bytes between signature & frames

        new_blocks, plan = _edit_blocks(
            blocks, add_tags, remove_tags, picture, remove_pictures,
            set_applications, remove_applications, cuesheet, remove_cuesheet,
        )
        base = _serialize_chain(new_blocks)
        want_pad = padding
        # minimum chain if we must add a PADDING block for in-place fit
        need = len(base)
        fits = (
            want_pad is None
            and (need == old_span  # exact, no padding needed
                 or need + 4 <= old_span)  # room for a PADDING block
        )
        if want_pad is not None:
            chain = _serialize_chain(
                new_blocks + [(int(BlockType.Padding), b"\x00" * want_pad)]
            )
            fits = len(chain) == old_span
            plan.padding = want_pad
        elif fits and need < old_span:
            pad_body = old_span - need - 4
            chain = _serialize_chain(
                new_blocks + [(int(BlockType.Padding), b"\x00" * pad_body)]
            )
            plan.padding = pad_body
        else:
            chain = base
            if fits:
                plan.padding = 0

        if fits:
            mm.close()
            with open(path, "r+b") as g:
                g.seek(4)
                g.write(chain)
            plan.in_place = True
            return plan

        # full rewrite: stream the frame bytes, never hold them whole
        if want_pad is None:
            # keep the old chain's padding allotment on a rewrite too
            old_pad = sum(len(b) + 4 for t, b in blocks
                          if t == BlockType.Padding)
            pad_body = max(0, old_pad - 4) if old_pad else 0
            if pad_body:
                chain = _serialize_chain(
                    new_blocks
                    + [(int(BlockType.Padding), b"\x00" * pad_body)]
                )
            plan.padding = pad_body
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as g:
                g.write(b"fLaC")
                g.write(chain)
                pos = frames_off
                while pos < len(mm):
                    g.write(mm[pos : pos + (1 << 20)])
                    pos += 1 << 20
            mm.close()
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        plan.in_place = False
        return plan
