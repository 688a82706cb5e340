"""denc: deterministic binary encoding for plain Python values.

The framework's analog of the reference's encode/decode bufferlist
layer (src/include/encoding.h; checked by ceph-dencoder against the
object corpus): a small, versionless, deterministic TLV format for
None/bool/int/float/bytes/str/list/tuple/dict, used by the durable
KStore records, the wire protocol frames, and map (de)serialization.

Integers up to 64-bit signed encode fixed-width ('i'); larger ones fall
back to decimal text ('I').  Dicts encode in insertion order — callers
that need canonical bytes sort first.
"""

from __future__ import annotations

import struct

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def encode(v, out: bytearray | None = None) -> bytes:
    buf = bytearray() if out is None else out
    _enc(v, buf)
    return bytes(buf)


def _enc(v, buf: bytearray) -> None:
    if v is None:
        buf += b"N"
    elif v is True:
        buf += b"T"
    elif v is False:
        buf += b"F"
    elif isinstance(v, int):
        if _I64_MIN <= v <= _I64_MAX:
            buf += b"i"
            buf += struct.pack(">q", v)
        else:
            s = str(v).encode()
            buf += b"I"
            buf += struct.pack(">I", len(s))
            buf += s
    elif isinstance(v, float):
        buf += b"f"
        buf += struct.pack(">d", v)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        buf += b"b"
        buf += struct.pack(">I", len(b))
        buf += b
    elif isinstance(v, str):
        b = v.encode()
        buf += b"s"
        buf += struct.pack(">I", len(b))
        buf += b
    elif isinstance(v, list):
        buf += b"l"
        buf += struct.pack(">I", len(v))
        for item in v:
            _enc(item, buf)
    elif isinstance(v, tuple):
        buf += b"t"
        buf += struct.pack(">I", len(v))
        for item in v:
            _enc(item, buf)
    elif isinstance(v, dict):
        buf += b"d"
        buf += struct.pack(">I", len(v))
        for k, val in v.items():
            _enc(k, buf)
            _enc(val, buf)
    else:
        raise TypeError("denc: cannot encode %r" % type(v))


def decode(data: bytes | memoryview):
    v, off = _dec(memoryview(data), 0)
    if off != len(data):
        raise ValueError("denc: %d trailing bytes" % (len(data) - off))
    return v


def decode_prefix(data: bytes | memoryview, off: int = 0):
    """Decode one value starting at off; returns (value, next_off)."""
    return _dec(memoryview(data), off)


def _dec(mv: memoryview, off: int):
    tag = mv[off:off + 1].tobytes()
    off += 1
    if tag == b"N":
        return None, off
    if tag == b"T":
        return True, off
    if tag == b"F":
        return False, off
    if tag == b"i":
        return struct.unpack_from(">q", mv, off)[0], off + 8
    if tag == b"I":
        n = struct.unpack_from(">I", mv, off)[0]
        off += 4
        return int(mv[off:off + n].tobytes()), off + n
    if tag == b"f":
        return struct.unpack_from(">d", mv, off)[0], off + 8
    if tag == b"b":
        n = struct.unpack_from(">I", mv, off)[0]
        off += 4
        return mv[off:off + n].tobytes(), off + n
    if tag == b"s":
        n = struct.unpack_from(">I", mv, off)[0]
        off += 4
        return mv[off:off + n].tobytes().decode(), off + n
    if tag in (b"l", b"t"):
        n = struct.unpack_from(">I", mv, off)[0]
        off += 4
        items = []
        for _ in range(n):
            item, off = _dec(mv, off)
            items.append(item)
        return (items if tag == b"l" else tuple(items)), off
    if tag == b"d":
        n = struct.unpack_from(">I", mv, off)[0]
        off += 4
        d = {}
        for _ in range(n):
            k, off = _dec(mv, off)
            val, off = _dec(mv, off)
            d[k] = val
        return d, off
    raise ValueError("denc: bad tag %r at %d" % (tag, off - 1))


# -- versioned struct envelope (ENCODE_START/DECODE_START semantics) --


class IncompatibleEncoding(ValueError):
    """The blob requires a newer decoder (compat > supported) —
    the reference's buffer::malformed_input on DECODE_START."""


_VHDR = struct.Struct(">BBI")           # version, compat, payload len


def encode_versioned(value, version: int, compat: int = 1) -> bytes:
    """src/include/encoding.h ENCODE_START analog: a struct payload
    framed with (version, compat, length).

    * ``version`` — what this writer produced;
    * ``compat`` — the oldest decoder that can still make sense of it
      (bump only on breaking layout changes);
    * the LENGTH makes newer-minor payloads skippable by old readers
      (they decode what they understand and seek past the rest),
      which is what makes rolling upgrades possible.
    """
    payload = encode(value)
    return (b"V" + _VHDR.pack(version, compat, len(payload))
            + payload)


def decode_versioned(data: bytes | memoryview,
                     supported: int) -> tuple[int, object]:
    """DECODE_START analog: returns (writer_version, value).  Raises
    IncompatibleEncoding when the writer says even ``supported`` is
    too old (compat gate); tolerates payloads LONGER than one value
    (a newer writer's extra trailing fields are skipped via the
    length header)."""
    mv = memoryview(data)
    if mv[:1].tobytes() != b"V":
        raise ValueError("not a versioned encoding")
    version, compat, length = _VHDR.unpack_from(mv, 1)
    if compat > supported:
        raise IncompatibleEncoding(
            "encoding v%d requires decoder >= v%d (have v%d)"
            % (version, compat, supported))
    payload = mv[1 + _VHDR.size:1 + _VHDR.size + length]
    value, off = _dec(payload, 0)
    # bytes past the first value inside the framed payload belong to
    # a newer minor version: skipped by design
    return version, value
