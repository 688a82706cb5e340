"""Message base class + wire codec.

The framework's analog of the reference's Message hierarchy
(src/msg/Message.h): every message is a typed record with a small,
declarative field list, encoded with the deterministic denc TLV format
into the payload segment of a v2-style frame (src/msg/async/frames_v2.h
puts header/payload segments inside a CRC-checked envelope; here the
envelope lives in ceph_tpu.msg.messenger).

A registry keyed by the wire TYPE string replaces the reference's
numeric message-type switch in decode_message (src/msg/Message.cc:256).
"""

from __future__ import annotations

from ..utils import denc

_REGISTRY: dict[str, type["Message"]] = {}


def register(cls: type["Message"]) -> type["Message"]:
    """Class decorator: adds the message type to the wire registry."""
    if not cls.TYPE:
        raise ValueError("message class %s has no TYPE" % cls.__name__)
    if cls.TYPE in _REGISTRY:
        raise ValueError("duplicate message TYPE %r" % cls.TYPE)
    _REGISTRY[cls.TYPE] = cls
    return cls


class Message:
    """Base message: subclasses declare TYPE and FIELDS.

    Fields must be denc-encodable values; messages carrying richer
    structures (pg_t, OSDMap) convert in to_wire/from_wire overrides.
    """

    TYPE = ""
    FIELDS: tuple[str, ...] = ()

    def __init__(self, **kw):
        for f in self.FIELDS:
            setattr(self, f, kw.pop(f, None))
        if kw:
            raise TypeError("%s: unknown fields %r"
                            % (type(self).__name__, sorted(kw)))
        # stamped by the messenger on send/receive
        self.seq = 0
        self.src = ""
        # optional trace id (reqid_t role): set by the sender to tie
        # this message into a cross-daemon op timeline; propagated in
        # the envelope, never interpreted by the transport
        self.trace = None
        # optional tenant key: the client stamps it on ops (and the
        # primary re-stamps sub-ops) so every layer — op tracking,
        # the mClock tag books, device admission, the flight
        # recorder — can attribute the work to a tenant.  Rides the
        # envelope like `trace`; never interpreted by the transport
        self.tenant = None

    def to_wire(self) -> dict:
        return {f: getattr(self, f) for f in self.FIELDS}

    @classmethod
    def from_wire(cls, d: dict) -> "Message":
        # drop fields from NEWER peers (mixed-version clusters: an
        # old daemon keeps the fields it knows; unknown message TYPES
        # are handled by UnknownMessage in decode_message)
        return cls(**{k: v for k, v in d.items() if k in cls.FIELDS})

    def __repr__(self) -> str:
        kv = ", ".join("%s=%r" % (f, getattr(self, f))
                       for f in self.FIELDS)
        return "%s(%s)" % (type(self).__name__, kv)


# message envelope version (frame-level ENCODE_START): bump compat
# only if the [type, seq, src, fields] layout itself changes
MSG_STRUCT_V = 1
MSG_STRUCT_COMPAT = 1


def encode_message(msg: Message, stamp: float | None = None) -> bytes:
    # the trace id rides as a 5th envelope element, the sender's
    # monotonic send stamp as a 6th, and the tenant key as a 7th: old
    # decoders slice row[:4] and ignore the tail, so no compat bump
    # is needed.  Untraced, unstamped, untenanted messages keep the
    # exact 4-element envelope (byte-stable for the pinned dencoder
    # corpus); the messenger passes `stamp` on live frames so
    # receivers can estimate per-peer clock offsets (the multi-host
    # span-merge prerequisite).
    row = [msg.TYPE, msg.seq, msg.src, msg.to_wire()]
    trace = getattr(msg, "trace", None)
    tenant = getattr(msg, "tenant", None)
    if trace is not None or stamp is not None or tenant is not None:
        row.append(trace)
    if stamp is not None or tenant is not None:
        row.append(stamp)
    if tenant is not None:
        row.append(tenant)
    return denc.encode_versioned(row, MSG_STRUCT_V, MSG_STRUCT_COMPAT)


class UnknownMessage(Message):
    """Placeholder for a type missing from the local registry (version
    skew): carries seq so the transport can ack + drop it instead of
    faulting the session into a replay livelock."""

    TYPE = "__unknown__"
    FIELDS = ("wire_type",)


def decode_message(data: bytes | memoryview) -> Message:
    trace = None
    stamp = None
    tenant = None
    if bytes(data[:1]) == b"V":
        _v, row = denc.decode_versioned(data, MSG_STRUCT_V)
        mtype, seq, src, fields = row[:4]
        if len(row) > 4:
            trace = row[4]
        if len(row) > 5:
            stamp = row[5]
        if len(row) > 6:
            tenant = row[6]
    else:                               # legacy unversioned frame
        mtype, seq, src, fields = denc.decode(data)
    cls = _REGISTRY.get(mtype)
    if cls is None:
        msg = UnknownMessage(wire_type=mtype)
    else:
        msg = cls.from_wire(fields)
    msg.seq = seq
    msg.src = src
    msg.trace = trace
    msg.send_stamp = stamp
    msg.tenant = tenant
    return msg
