"""Ogg-FLAC container support (Ogg encapsulation mapping 1.0).

The reference tool is WAV -> native-FLAC only (its readme lists no
container work); this module is a framework extension: lossless
transmuxing between native FLAC streams and Ogg-FLAC (.oga), in both
directions.

Mapping summary (xiph Ogg-FLAC mapping 1.0):

* packet 1 (alone on the first page, BOS): ``0x7F 'FLAC' <major=1>
  <minor=0> <u16be header-packet count> 'fLaC' <STREAMINFO block incl.
  4-byte block header>``
* one packet per remaining metadata block (the count above)
* one packet per FLAC frame; a page's granule position is the number of
  samples completed by the last packet that ends on it (-1 if none ends)
* pages carry the Ogg CRC-32 (poly 0x04C11DB7, init 0, no final xor) over
  the whole page with the CRC field zeroed

Frame boundaries for the FLAC->Ogg direction come from the native batch
parser (zf_native.parse_frames reports per-frame end offsets), so the
transmux fully CRC-verifies every frame it wraps.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

OGG_MAGIC = b"OggS"
_MAX_SEGS = 255


def _crc_table() -> np.ndarray:
    poly = 0x04C11DB7
    tbl = np.zeros(256, np.uint32)
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ poly if r & 0x80000000 else r << 1) & 0xFFFFFFFF
        tbl[i] = r
    return tbl


_OGG_CRC = _crc_table()


def ogg_crc(data: bytes, crc: int = 0) -> int:
    """Ogg page CRC-32: MSB-first, init 0, no final xor. C++ slice-by-8
    when the native runtime is present; table-driven Python otherwise."""
    from . import native as _native

    if _native.HAVE_NATIVE and hasattr(_native._n, "crc32_ogg"):
        return _native._n.crc32_ogg(data, crc)
    for v in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ int(_OGG_CRC[((crc >> 24) ^ v) & 0xFF])
    return crc


class OggPageWriter:
    """Packs packets into Ogg pages (handles lacing, continuation, BOS/EOS,
    granule bookkeeping) and writes them to a file-like object."""

    def __init__(self, out, serial: int = 0x464C4143) -> None:
        self.out = out
        self.serial = serial & 0xFFFFFFFF
        self.page_seq = 0
        self._segs: List[int] = []
        self._data: List[bytes] = []
        self._granule = -1  # granule of the last packet completed this page
        self._bos_pending = True
        self._cont = False  # current page continues a packet

    def _flush(self, eos: bool = False) -> None:
        if not self._segs and not eos:
            return
        hdr_type = (
            (0x01 if self._cont else 0)
            | (0x02 if self._bos_pending else 0)
            | (0x04 if eos else 0)
        )
        granule = self._granule if self._granule >= 0 else (2**64 - 1)
        header = (
            OGG_MAGIC
            + struct.pack(
                "<BBQIIi", 0, hdr_type, granule, self.serial, self.page_seq, 0
            )
            + bytes([len(self._segs)])
            + bytes(self._segs)
        )
        body = b"".join(self._data)
        crc = ogg_crc(header + body)
        page = header[:22] + struct.pack("<I", crc) + header[26:] + body
        self.out.write(page)
        self.page_seq += 1
        self._segs = []
        self._data = []
        self._granule = -1
        self._bos_pending = False
        # continuation state for the NEXT page is set by add_packet when it
        # flushes mid-packet; a normal flush starts a fresh page
        self._cont = False

    def add_packet(self, data: bytes, granule: int, flush: bool = False) -> None:
        """Append one packet; ``granule`` is the stream position (total
        samples) after this packet, recorded if the packet ends on a page.
        """
        n = len(data)
        # lacing: floor(n/255) full segments then n%255 — a packet whose
        # length is a multiple of 255 ends with a 0 lacing value
        lacing = [255] * (n // 255) + [n % 255]
        off = 0
        for take in lacing:
            if len(self._segs) == _MAX_SEGS:
                # page full mid-packet: emit and continue on the next page
                self._flush()
                self._cont = True
            self._segs.append(take)
            self._data.append(data[off : off + take])
            off += take
        self._granule = granule
        if flush or len(self._segs) >= 200:
            self._flush()

    def close(self, final_granule: int) -> None:
        self._granule = max(self._granule, final_granule)
        self._flush(eos=True)


def _build_first_packet(streaminfo_block: bytes, n_header_packets: int) -> bytes:
    return (
        b"\x7fFLAC\x01\x00"
        + struct.pack(">H", n_header_packets)
        + b"fLaC"
        + streaminfo_block
    )


def _split_metadata(flac: bytes) -> Tuple[List[bytes], int]:
    """Native stream -> ([metadata blocks incl. 4-byte headers], frame_pos).
    The first block is always STREAMINFO (decoder validates)."""
    if flac[:4] != b"fLaC":
        raise ValueError("bad FLAC signature")
    pos = 4
    blocks = []
    while True:
        hdr = flac[pos]
        length = int.from_bytes(flac[pos + 1 : pos + 4], "big")
        blocks.append(flac[pos : pos + 4 + length])
        pos += 4 + length
        if hdr & 0x80:
            break
    return blocks, pos


def flac_to_ogg(flac, out, serial: int = 0) -> None:
    """Transmux a native FLAC stream into Ogg-FLAC, verifying every frame
    CRC along the way (the boundary scan is the native batch parser).
    ``flac`` may be bytes or any sliceable buffer (e.g. an mmap) — the
    transmux touches it in frame-batch windows, so memory stays bounded
    for file inputs."""
    from ._host_runtime import module as _n

    from .decoder import FlacDecodeError, _parse_metadata

    info, _vendor, _tags, _seek, first_frame = _parse_metadata(flac)
    blocks, pos0 = _split_metadata(flac)
    assert pos0 == first_frame
    streaminfo = blocks[0]
    others = blocks[1:]
    # inside Ogg the STREAMINFO is never the chain terminator unless it is
    # alone; the last header packet carries the last-metadata flag
    def set_last(block: bytes, last: bool) -> bytes:
        b0 = (block[0] & 0x7F) | (0x80 if last else 0)
        return bytes([b0]) + block[1:]

    streaminfo = set_last(streaminfo, not others)
    if others:
        others = [set_last(b, False) for b in others[:-1]] + [
            set_last(others[-1], True)
        ]

    w = OggPageWriter(out, serial=serial or 0x464C4143)
    w.add_packet(_build_first_packet(streaminfo, len(others)), 0, flush=True)
    for b in others:
        w.add_packet(b, 0)
    if others:
        w._flush()  # header packets end before the first audio page

    pos = first_frame
    samples = 0
    B = info.max_block_size
    while pos < len(flac):
        (n, end, bs, _vb, _qb, _sb, _cb, _fb, kb, eb) = _n.parse_frames(
            flac, pos, 4096, info.bit_depth, info.channels
        )
        if n == 0:
            raise FlacDecodeError("unparseable frame data in transmux")
        if not np.frombuffer(kb, np.uint8).all():
            raise FlacDecodeError("frame CRC mismatch in transmux")
        ends = np.frombuffer(eb, np.int64)
        for i in range(n):
            samples += bs
            if samples > info.interchannel_samples:
                samples = info.interchannel_samples  # ragged tail frame
            w.add_packet(
                flac[pos : int(ends[i])], min(samples, info.interchannel_samples)
            )
            pos = int(ends[i])
    w.close(info.interchannel_samples)


class OggPageReader:
    """Iterates (packets, granule) from an Ogg stream, CRC-checking pages
    and reassembling packets across page boundaries. Handles multiplexed
    containers (pages of several logical streams interleaved by serial
    number, RFC 3533 §6) and chained containers (a finished stream followed
    by a fresh BOS): ``packets`` follows ONE logical stream — by default
    the first one in the file — skipping other serials' pages and stopping
    at the selected stream's EOS page."""

    def __init__(self, data: bytes, verify_crc: bool = True) -> None:
        self.data = data
        self.verify_crc = verify_crc

    def pages(self):
        """Yield raw pages as (htype, granule, serial, segs, body bytes)."""
        data = self.data
        pos = 0
        while pos < len(data):
            if data[pos : pos + 4] != OGG_MAGIC:
                raise ValueError("bad Ogg page magic")
            if len(data) < pos + 27:
                raise ValueError("truncated Ogg page header")
            (ver, htype, granule, serial, _seq, crc) = struct.unpack(
                "<BBQIIi", data[pos + 4 : pos + 26]
            )
            if ver != 0:
                raise ValueError("unsupported Ogg version")
            nsegs = data[pos + 26]
            segs = data[pos + 27 : pos + 27 + nsegs]
            body_off = pos + 27 + nsegs
            body_len = int(np.frombuffer(segs, np.uint8).sum())
            page = data[pos : body_off + body_len]
            if len(page) != 27 + nsegs + body_len:
                raise ValueError("truncated Ogg page")
            if self.verify_crc:
                zeroed = page[:22] + b"\x00\x00\x00\x00" + page[26:]
                if ogg_crc(zeroed) != crc & 0xFFFFFFFF:
                    raise ValueError("Ogg page CRC mismatch")
            yield htype, granule, serial, segs, data[body_off : body_off + body_len]
            pos = body_off + body_len

    def logical_streams(self):
        """(serial, first-packet prefix) of every BOS page, in file order —
        chained links and multiplexed streams both appear once each."""
        out = []
        for htype, _g, serial, _segs, body in self.pages():
            if htype & 0x02:
                out.append((serial, bytes(body[:16])))
        return out

    def packets(
        self,
        serial: int | None = None,
        bos_prefix: bytes = b"",
        link: int = 0,
    ):
        """Packets of ONE logical stream. ``link`` selects among chained
        links that reuse the same serial number (0 = first): a legal RFC
        3533 chain of two files written by this package's own writer uses
        the default serial twice, so (serial, link) — not serial alone —
        identifies a stream."""
        partial = b""
        ended = False
        cur_link = -1  # chain-link index of the current pages of our serial
        for htype, granule, pserial, segs, body in self.pages():
            if serial is None:
                # lock onto the first stream in the file — or, with a
                # ``bos_prefix``, the first whose BOS packet starts with it
                # (skips other codecs' streams in a multiplexed container)
                if bos_prefix and not (
                    (htype & 0x02) and body.startswith(bos_prefix)
                ):
                    continue
                serial = pserial
            if pserial != serial:
                continue
            if ended:
                break
            if htype & 0x02:
                cur_link += 1
            elif cur_link < 0:
                cur_link = 0  # malformed: data before any BOS = link 0
            if cur_link < link:
                continue
            if cur_link > link:
                break  # malformed: next link began without our EOS
            if not (htype & 0x01) and partial:
                raise ValueError("lost packet continuation")
            boff = 0
            for s in segs:
                partial += body[boff : boff + s]
                boff += s
                if s < 255:
                    yield partial, granule
                    partial = b""
            if htype & 0x04:
                ended = True
        if partial:
            raise ValueError("stream ends mid-packet")


def flac_streams(data: bytes, verify_crc: bool = True) -> list:
    """``(serial, link)`` of every FLAC logical stream in the container,
    in file order. ``link`` counts chained links that REUSE a serial (this
    package's own writer always uses the default serial, so two
    concatenated .oga files are (S, 0) and (S, 1))."""
    r = OggPageReader(data, verify_crc=verify_crc)
    seen: dict = {}
    out = []
    for s, head in r.logical_streams():
        if head[:5] == b"\x7fFLAC":
            out.append((s, seen.get(s, 0)))
            seen[s] = seen.get(s, 0) + 1
    return out


def flac_serials(data: bytes, verify_crc: bool = True) -> list:
    """Serial numbers of every FLAC logical stream in the container
    (multiplexed streams and chained links alike), in file order; repeats
    when chained links reuse a serial (see flac_streams)."""
    return [s for s, _link in flac_streams(data, verify_crc=verify_crc)]


def ogg_to_flac_all(data: bytes, verify_crc: bool = True) -> list:
    """Every FLAC logical stream of a (possibly chained/multiplexed) Ogg
    container as native FLAC byte streams, in file order — including
    chained links that reuse one serial number. (Each stream re-walks the
    container's pages: O(k·n) for k streams — chains are short in
    practice.)"""
    return [
        ogg_to_flac(data, verify_crc=verify_crc, serial=s, link=k)
        for s, k in flac_streams(data, verify_crc=verify_crc)
    ]


def ogg_to_flac(
    data: bytes,
    verify_crc: bool = True,
    serial: int | None = None,
    link: int = 0,
) -> bytes:
    """Transmux Ogg-FLAC back to a native FLAC stream (page CRCs checked).
    The metadata chain's last-block flags are rebuilt. ``serial`` selects a
    logical stream of a multiplexed/chained container (by default the first
    FLAC stream in the file; other codecs' streams are skipped); ``link``
    selects among chained links that reuse that serial."""
    it = OggPageReader(data, verify_crc=verify_crc).packets(
        serial, bos_prefix=b"\x7fFLAC" if serial is None else b"", link=link
    )
    first_g = next(it, None)
    if first_g is None:
        raise ValueError("not an Ogg-FLAC stream (no FLAC logical stream)")
    first, _g = first_g
    if first[:5] != b"\x7fFLAC":
        raise ValueError("not an Ogg-FLAC stream (bad first packet)")
    if first[5] != 1:
        raise ValueError("unsupported Ogg-FLAC mapping version")
    n_hdr = struct.unpack(">H", first[7:9])[0]
    if first[9:13] != b"fLaC":
        raise ValueError("missing fLaC signature in first packet")
    streaminfo = first[13:]
    if (streaminfo[0] & 0x7F) != 0:
        raise ValueError("first packet must carry STREAMINFO")
    metas = [streaminfo]
    for _ in range(n_hdr):
        pkt, _g = next(it)
        metas.append(pkt)
    # rebuild last-block flags for the native chain
    out = [b"fLaC"]
    for i, b in enumerate(metas):
        last = i == len(metas) - 1
        out.append(bytes([(b[0] & 0x7F) | (0x80 if last else 0)]) + b[1:])
    for pkt, _g in it:
        out.append(pkt)
    return b"".join(out)


def is_ogg(data: bytes) -> bool:
    return data[:4] == OGG_MAGIC


class OggStreamSink:
    """Single-pass streaming Ogg-FLAC writer for the encoder: header pages
    go out immediately with placeholder STREAMINFO/SEEKTABLE payloads,
    frames packetize as each device batch collects, and ``finalize``
    seek-rewrites the header pages with the final metadata — byte-layout
    identical because Ogg lacing depends only on packet LENGTHS, which the
    two-pass protocol keeps fixed (STREAMINFO is 38 bytes with its block
    header; the SEEKTABLE is sized by its point count up front).

    The write target must be seekable. The encoder's existing seek-back
    protocol (src/wav2flac.zig:30-47's two-pass STREAMINFO) maps onto Ogg
    unchanged: same placeholder-then-patch dance, at page granularity.
    """

    def __init__(self, out, serial: int = 0) -> None:
        self.out = out
        self.serial = serial or 0x464C4143
        self._w = OggPageWriter(out, serial=self.serial)
        self._hdr_start = None   # file offset of the first header page
        self._hdr_layout = None  # metadata block lengths written at start
        self._samples = 0

    def write_headers(self, meta_blocks) -> None:
        """``meta_blocks``: the native metadata chain (STREAMINFO first,
        each with its 4-byte block header; last-flags as in the native
        stream). Placeholder contents are fine — lengths are binding."""
        streaminfo = meta_blocks[0]
        others = list(meta_blocks[1:])
        self._hdr_layout = [len(b) for b in meta_blocks]
        self._emit_headers(streaminfo, others)

    def _emit_headers(self, streaminfo, others) -> None:
        def set_last(block, last):
            return bytes([(block[0] & 0x7F) | (0x80 if last else 0)]) + block[1:]

        streaminfo = set_last(streaminfo, not others)
        if others:
            others = [set_last(b, False) for b in others[:-1]] + [
                set_last(others[-1], True)
            ]
        self._w.add_packet(
            _build_first_packet(streaminfo, len(others)), 0, flush=True
        )
        if self._hdr_start is None:
            self._hdr_start = self.out.tell()
        for b in others:
            self._w.add_packet(b, 0)
        if others:
            self._w._flush()

    def add_frames(self, buf: bytes, sizes, samples_per_frame) -> None:
        """One collected batch: ``buf`` is the concatenated frame bytes,
        ``sizes`` their lengths, ``samples_per_frame`` the per-frame sample
        counts (block size, except a ragged tail)."""
        off = 0
        for fsz, ns in zip(sizes, samples_per_frame):
            self._samples += int(ns)
            self._w.add_packet(buf[off : off + int(fsz)], self._samples)
            off += int(fsz)

    def finalize(self, meta_blocks) -> None:
        """Close the stream (EOS page), then seek-rewrite page 0 and the
        header pages with the final metadata. Lengths must match the
        placeholders from ``write_headers`` exactly."""
        assert [len(b) for b in meta_blocks] == self._hdr_layout, (
            "metadata block sizes changed between placeholder and patch"
        )
        self._w.close(self._samples)
        end = self.out.tell()
        # replay the header pages deterministically over the placeholders
        self.out.seek(0)
        self._w = OggPageWriter(self.out, serial=self.serial)
        self._emit_headers(meta_blocks[0], list(meta_blocks[1:]))
        self.out.seek(end)
        self.out.flush()
