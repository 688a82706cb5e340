"""TLZ: the device-planned LZ-class compressor ("tlz" in the registry).

Counterpart of ceph_tpu/compress/tlz.py.  Finding matches is
data-parallel and runs as batched device dispatches
(ceph_tpu_torch.device.lzkernel); sequential token emission stays on
the host and is a pure function of the planned (candidate,
match-length) arrays.  The device program and the numpy oracle compute
the identical plan, so `compress_async` and `compress_host` emit
byte-identical blobs.  The sync interface (`compress_host`,
`TlzCompressor`) is the format's host semantics and the oracle, as the
EC codecs' sync `encode` is; no failure of the card selects it.

Container format (self-describing, decompressible by `decompress`
alone):

    magic  b"TLZ1"
    u32le  raw length
    u32le  block size (TLZ_BLOCK at write time)
    per block (ceil(raw/block) blocks, in order):
        u16le  csize
        csize == 0 -> the block is STORED: raw block bytes follow
                      (incompressible blocks never expand past 2B)
        csize  > 0 -> csize bytes of token stream follow

Token stream (LZ4-flavored, bounded by the block's raw length so no
end marker is needed):

    token byte: hi nibble = literal run length, lo nibble =
                match length - MIN_MATCH; value 15 in either nibble
                extends with 255-continuation bytes
    literal bytes
    u16le match offset (1..pos, within the block) — present unless
    the literals completed the block (the final literals-only token)

Matches never cross block boundaries (blocks are independent lanes of
one dispatch) and never exceed ``MAX_MATCH`` (the kernel's
vectorization depth — the cap is part of the format: host and device
emit identical tokens because both plan with the same cap).
"""

from __future__ import annotations

import struct

import numpy as np

from ..device.lzkernel import (_MAX_LANES, K_BACKGROUND, MIN_MATCH,
                               TLZ_BLOCK, _stage_blocks, match_batch,
                               match_plan_host)
from ..device.runtime import DeviceRuntime
from . import Compressor, CompressorError

MAGIC = b"TLZ1"
_HDR = struct.Struct("<II")
_CSIZE = struct.Struct("<H")
_OFF = struct.Struct("<H")


# -- token emission (host, cheap, identical for both plan paths) ----------


def _put_ext(out: bytearray, v: int) -> None:
    while v >= 255:
        out.append(255)
        v -= 255
    out.append(v)


def _emit_seq(out: bytearray, lits, offset: int, mlen: int,
              min_match: int) -> None:
    ll = len(lits)
    ml = (mlen - min_match) if offset else 0
    out.append((min(ll, 15) << 4) | min(ml, 15))
    if ll >= 15:
        _put_ext(out, ll - 15)
    out += lits
    if offset:
        out += _OFF.pack(offset)
        if ml >= 15:
            _put_ext(out, ml - 15)


def _emit_block(block: bytes, cand, mlen, min_match: int) -> bytes:
    """Greedy tokenization of one block from its planned
    (candidate, match-length) rows.  The literal-skip uses the plan's
    eligibility mask, so the loop iterates once per MATCH, not per
    byte — incompressible blocks degenerate to one stored check."""
    n = len(block)
    out = bytearray()
    elig = np.flatnonzero((cand[:n] >= 0) & (mlen[:n] >= min_match))
    i = 0
    anchor = 0
    while True:
        nxt = np.searchsorted(elig, i)
        if nxt >= elig.size:
            break
        i = int(elig[nxt])
        ln = min(int(mlen[i]), n - i)
        if ln < min_match:
            i += 1
            continue
        _emit_seq(out, block[anchor:i], i - int(cand[i]), ln,
                  min_match)
        i += ln
        anchor = i
    if anchor < n:
        _emit_seq(out, block[anchor:n], 0, 0, min_match)
    return bytes(out)


def _assemble(data: bytes, cand: np.ndarray,
              mlen: np.ndarray) -> bytes:
    """The container from the per-block plans: tokenize each block,
    store raw whenever tokens would not shrink it."""
    out = bytearray(MAGIC)
    out += _HDR.pack(len(data), TLZ_BLOCK)
    for bi, off in enumerate(range(0, len(data), TLZ_BLOCK)):
        raw = data[off:off + TLZ_BLOCK]
        tok = _emit_block(raw, cand[bi], mlen[bi], MIN_MATCH)
        if len(tok) < len(raw):
            out += _CSIZE.pack(len(tok))
            out += tok
        else:
            out += _CSIZE.pack(0)
            out += raw
    return bytes(out)


def _blocks_of(data: bytes) -> list[bytes]:
    return [data[off:off + TLZ_BLOCK]
            for off in range(0, len(data), TLZ_BLOCK)]


# -- compression entry points ---------------------------------------------


def compress_host(data: bytes) -> bytes:
    """The numpy reference: plans matches with `match_plan_host` and
    emits the container `compress_async` produces.  Blocks are
    independent, so it plans _MAX_LANES blocks at a time (bounded
    memory at 4 MiB objects) with the reference's result."""
    data = bytes(data)
    segs = _blocks_of(data)
    if not segs:
        return _assemble(data, np.zeros((0, 0), np.int32),
                         np.zeros((0, 0), np.int32))
    cands, mlens = [], []
    for lo in range(0, len(segs), _MAX_LANES):
        part = segs[lo:lo + _MAX_LANES]
        c, m = match_plan_host(*_stage_blocks(part, len(part)))
        cands.append(c)
        mlens.append(m)
    return _assemble(data, np.concatenate(cands), np.concatenate(mlens))


async def compress_async(data: bytes, chip: int | None = None,
                         klass: str | None = None, device=None
                         ) -> tuple[bytes, str]:
    """Device-planned compression on the caller's affinity chip of
    `device` (default: the card) under the background class; returns
    (blob, "device"), the bytes `compress_host` emits.  Empty data
    dispatches nothing (path "host", as the reference).  DeviceBusy and
    a failed dispatch (IOError) fail the call.  Accounted on the chip's
    ``device_compress_bytes_in`` / ``_out`` gauges."""
    data = bytes(data)
    target = DeviceRuntime.get(device).route(chip)
    segs = _blocks_of(data)
    if not segs:
        return _assemble(data, np.zeros((0, 0), np.int32),
                         np.zeros((0, 0), np.int32)), "host"
    cand, mlen, path = await match_batch(
        segs, chip=chip, klass=klass or K_BACKGROUND, device=device)
    blob = _assemble(data, cand, mlen)
    target.note_compress(len(data), len(blob))
    return blob, path


def decompress(blob: bytes) -> bytes:
    """Sequential host decode; integrity-checked (magic, block
    structure, offsets, declared raw length) — a truncated or
    corrupted stream raises CompressorError, never returns short
    bytes."""
    blob = bytes(blob)
    if len(blob) < len(MAGIC) + _HDR.size or \
            blob[:len(MAGIC)] != MAGIC:
        raise CompressorError("tlz: bad magic")
    raw_len, block = _HDR.unpack_from(blob, len(MAGIC))
    if block <= 0:
        raise CompressorError("tlz: bad block size %d" % block)
    p = len(MAGIC) + _HDR.size
    out = bytearray()
    while len(out) < raw_len:
        if p + _CSIZE.size > len(blob):
            raise CompressorError("tlz: truncated container")
        (csize,) = _CSIZE.unpack_from(blob, p)
        p += _CSIZE.size
        want = min(block, raw_len - len(out))
        if csize == 0:
            if p + want > len(blob):
                raise CompressorError("tlz: truncated stored block")
            out += blob[p:p + want]
            p += want
            continue
        tok = blob[p:p + csize]
        if len(tok) < csize:
            raise CompressorError("tlz: truncated token block")
        p += csize
        out += _decode_block(tok, want, MIN_MATCH)
    if len(out) != raw_len or p != len(blob):
        raise CompressorError(
            "tlz: length mismatch (decoded %d of %d, %d trailing)"
            % (len(out), raw_len, len(blob) - p))
    return bytes(out)


def _decode_block(tok: bytes, raw_len: int, min_match: int) -> bytes:
    out = bytearray()
    p = 0
    n = len(tok)
    while len(out) < raw_len:
        if p >= n:
            raise CompressorError("tlz: token stream underrun")
        t = tok[p]
        p += 1
        ll = t >> 4
        if ll == 15:
            while True:
                if p >= n:
                    raise CompressorError("tlz: bad literal length")
                b = tok[p]
                p += 1
                ll += b
                if b != 255:
                    break
        if p + ll > n:
            raise CompressorError("tlz: literal overrun")
        out += tok[p:p + ll]
        p += ll
        if len(out) > raw_len:
            raise CompressorError("tlz: block overflow")
        if len(out) == raw_len:
            break
        if p + _OFF.size > n:
            raise CompressorError("tlz: missing match offset")
        (off,) = _OFF.unpack_from(tok, p)
        p += _OFF.size
        ml = t & 15
        if ml == 15:
            while True:
                if p >= n:
                    raise CompressorError("tlz: bad match length")
                b = tok[p]
                p += 1
                ml += b
                if b != 255:
                    break
        ml += min_match
        if off <= 0 or off > len(out):
            raise CompressorError("tlz: bad match offset %d at %d"
                                  % (off, len(out)))
        if len(out) + ml > raw_len:
            raise CompressorError("tlz: match overflows block")
        src = len(out) - off
        want = ml
        while want > 0:                 # overlap-safe chunked copy
            chunk = out[src:src + want]
            out += chunk
            want -= len(chunk)
    if p != n:
        raise CompressorError("tlz: %d trailing token bytes" % (n - p))
    return bytes(out)


class TlzCompressor(Compressor):
    """Registry plugin: the synchronous interface is the host
    reference; the OSD write path calls `compress_async` for device
    planning.  Both produce the same bytes."""

    name = "tlz"

    def compress(self, data: bytes) -> bytes:
        return compress_host(data)

    def decompress(self, blob: bytes) -> bytes:
        return decompress(blob)
