"""Asyncio messenger: v2-style framed transport with policies.

The framework's L3 — the analog of AsyncMessenger + ProtocolV2
(src/msg/Messenger.cc:31, src/msg/async/ProtocolV2.cc,
src/msg/Policy.h), re-expressed on asyncio instead of epoll threads:

* one Messenger per daemon endpoint, bound to a TCP addr (DCN path;
  ICI never carries the RADOS protocol — it lives inside device
  kernels, see SURVEY §2.3);
* Connections perform a banner + identification handshake, then
  exchange CRC-checked frames (tag, length, crc32, payload);
* Policy decides lossy vs lossless semantics: lossy connections die
  with the socket (clients resend via Objecter epoch logic, as in the
  reference); lossless peers keep a session — unacked messages are
  replayed after reconnect and the receiver drops duplicates by seq
  (ProtocolV2 session reconnect, ProtocolV2.cc:2143 reuse path); a
  peer presenting a new nonce is a restarted daemon and gets a fresh
  session (reset_session semantics);
* Dispatchers receive ms_dispatch / ms_handle_reset callbacks.

Structure: every Connection is owned by ONE supervisor task that loops
{acquire transport -> run session (reader+writer subtasks) -> decide
redial/die} — no fire-and-forget task chains, so faults can't orphan
state.

Fault injection: set ``inject_socket_failures`` to N>0 to abort roughly
one in N frame writes (ms_inject_socket_failures,
src/common/options/global.yaml.in:1242), driven by each connection's
seeded RNG so a failure schedule replays.  For richer, per-peer-pair
faults (drop/delay/duplicate/reorder/partition) install a
``faults.FaultInjector`` on ``messenger.fault_injector`` — the
thrasher's lever.  On connections with a resend policy, drop and
reorder are escalated to transport aborts (the frame is withheld and
the session replay path redelivers it): silently losing a frame there
would break the lossless contract the session machinery guarantees.
"""

from __future__ import annotations

import asyncio
import random
import struct
import time
import zlib

from .message import (Message, UnknownMessage, decode_message,
                      encode_message)

BANNER = b"ceph-tpu v2\n"

# frame tags
TAG_MSG = 1
TAG_ACK = 2
TAG_CLOSE = 4

_HDR = struct.Struct(">BII")  # tag, length, crc32

# wire-accounting switch: bench.py --net A/Bs the cost of the
# telemetry plane, so disabling must short-circuit every hot-path
# accounting touch (per-type dicts, queue-wait stamps)
_ACCOUNTING = True


def set_net_accounting(on: bool) -> None:
    global _ACCOUNTING
    _ACCOUNTING = bool(on)


class WireStats:
    """Per-peer wire accounting for one Connection (folded into the
    Messenger's per-peer aggregate when the connection dies, so
    counters survive connection churn and session reconnects).

    Dump keys are registered in ``trace.registry.NET_STAGES`` and
    consumed by the mgr exporter, ``collect_diagnostics()`` and the
    ``bench.py --net`` leg.
    """

    __slots__ = ("tx_msgs", "tx_bytes", "rx_msgs", "rx_bytes",
                 "by_type_tx", "by_type_rx", "queue_wait_s",
                 "queue_wait_n", "queue_wait_max_s", "resends",
                 "replays", "mark_downs", "handshakes", "handshake_s",
                 "backoff_s")

    def __init__(self):
        self.tx_msgs = 0
        self.tx_bytes = 0
        self.rx_msgs = 0
        self.rx_bytes = 0
        self.by_type_tx: dict[str, list] = {}   # type -> [msgs, bytes]
        self.by_type_rx: dict[str, list] = {}
        self.queue_wait_s = 0.0
        self.queue_wait_n = 0
        self.queue_wait_max_s = 0.0
        self.resends = 0            # lossless payloads requeued
        self.replays = 0            # duplicate frames absorbed by seq
        self.mark_downs = 0
        self.handshakes = 0
        self.handshake_s = 0.0      # last completed handshake latency
        self.backoff_s = 0.0        # active redial ramp (0 = healthy)

    def note_tx(self, mtype: str, nbytes: int) -> None:
        self.tx_msgs += 1
        self.tx_bytes += nbytes
        row = self.by_type_tx.get(mtype)
        if row is None:
            row = self.by_type_tx[mtype] = [0, 0]
        row[0] += 1
        row[1] += nbytes

    def note_rx(self, mtype: str, nbytes: int) -> None:
        self.rx_msgs += 1
        self.rx_bytes += nbytes
        row = self.by_type_rx.get(mtype)
        if row is None:
            row = self.by_type_rx[mtype] = [0, 0]
        row[0] += 1
        row[1] += nbytes

    def note_queue_wait(self, wait_s: float) -> None:
        self.queue_wait_s += wait_s
        self.queue_wait_n += 1
        if wait_s > self.queue_wait_max_s:
            self.queue_wait_max_s = wait_s

    def note_handshake(self, latency_s: float) -> None:
        self.handshakes += 1
        self.handshake_s = latency_s

    def fold(self, other: "WireStats") -> None:
        self.tx_msgs += other.tx_msgs
        self.tx_bytes += other.tx_bytes
        self.rx_msgs += other.rx_msgs
        self.rx_bytes += other.rx_bytes
        for src, dst in ((other.by_type_tx, self.by_type_tx),
                         (other.by_type_rx, self.by_type_rx)):
            for mtype, (n, b) in src.items():
                row = dst.get(mtype)
                if row is None:
                    row = dst[mtype] = [0, 0]
                row[0] += n
                row[1] += b
        self.queue_wait_s += other.queue_wait_s
        self.queue_wait_n += other.queue_wait_n
        self.queue_wait_max_s = max(self.queue_wait_max_s,
                                    other.queue_wait_max_s)
        self.resends += other.resends
        self.replays += other.replays
        self.mark_downs += other.mark_downs
        self.handshakes += other.handshakes
        if other.handshakes:
            self.handshake_s = other.handshake_s
        self.backoff_s = max(self.backoff_s, other.backoff_s)

    def dump(self, queue_depth: int = 0) -> dict:
        return {
            "tx_msgs": self.tx_msgs,
            "tx_bytes": self.tx_bytes,
            "rx_msgs": self.rx_msgs,
            "rx_bytes": self.rx_bytes,
            "by_type_tx": {t: list(v)
                           for t, v in sorted(self.by_type_tx.items())},
            "by_type_rx": {t: list(v)
                           for t, v in sorted(self.by_type_rx.items())},
            "queue_depth": queue_depth,
            "queue_wait_s": self.queue_wait_s,
            "queue_wait_n": self.queue_wait_n,
            "queue_wait_max_s": self.queue_wait_max_s,
            "resends": self.resends,
            "replays": self.replays,
            "mark_downs": self.mark_downs,
            "handshakes": self.handshakes,
            "handshake_s": self.handshake_s,
            "backoff_s": self.backoff_s,
        }


def ms_compress_from_conf(conf) -> list[str]:
    """Wire-compression preference list from conf (ms_compress),
    filtered to locally-available algorithms — a node must never
    ADVERTISE what it cannot run, or the two ends of a connection
    would disagree about the frame format."""
    try:
        raw = conf["ms_compress"]
    except Exception:
        return []
    from ..compress import available

    have = set(available())
    return [a.strip() for a in raw.split(",")
            if a.strip() and a.strip() in have]


def _pick_compressor(acceptor_prefs, initiator_algos):
    """Common wire compressor, acceptor's preference order deciding
    (both sides compute the same answer from the exchanged idents).
    Returns a Compressor instance or None."""
    common = [a for a in acceptor_prefs if a in (initiator_algos or [])]
    if not common:
        return None
    from ..compress import CompressorError, create

    try:
        return create(common[0])
    except CompressorError:
        return None


class Policy:
    """Connection semantics per peer type (src/msg/Policy.h)."""

    __slots__ = ("lossy", "resend")

    def __init__(self, lossy: bool, resend: bool):
        self.lossy = lossy
        self.resend = resend

    @classmethod
    def lossy_client(cls) -> "Policy":
        return cls(lossy=True, resend=False)

    @classmethod
    def lossless_peer(cls) -> "Policy":
        return cls(lossy=False, resend=True)


class ConnectionError_(Exception):
    pass


class _PeerClosed(Exception):
    """Peer sent TAG_CLOSE: orderly teardown, not a fault."""


async def _write_frame(writer: asyncio.StreamWriter, tag: int,
                       payload: bytes) -> None:
    writer.write(_HDR.pack(tag, len(payload), zlib.crc32(payload)))
    writer.write(payload)
    await writer.drain()


async def _read_frame(reader: asyncio.StreamReader) -> tuple[int, bytes]:
    hdr = await reader.readexactly(_HDR.size)
    tag, length, crc = _HDR.unpack(hdr)
    payload = await reader.readexactly(length)
    if zlib.crc32(payload) != crc:
        raise ConnectionError_("frame crc mismatch (tag %d)" % tag)
    return tag, payload


class Connection:
    """One logical session with a peer entity.

    Survives TCP reconnects when the policy is lossless: out_seq /
    in_seq and the unacked replay queue persist across transports.
    """

    def __init__(self, msgr: "Messenger", peer_addr: str | None,
                 policy: Policy):
        self.msgr = msgr
        self.peer_addr = peer_addr      # dial address (None on inbound)
        self.peer_entity = ""           # learned in handshake
        self.peer_nonce = -1            # detects peer restarts
        self.policy = policy
        # per-connection seeded RNG: inject_socket_failures draws from
        # it so a failure schedule is replayable per peer pair
        self.rng = msgr._conn_rng(peer_addr or "inbound")
        self.out_seq = 0
        self.in_seq = 0
        self.stats = WireStats()
        self.unacked: list[tuple[int, bytes]] = []
        self.out_q: asyncio.Queue = asyncio.Queue()
        self._open = True
        self._transports: asyncio.Queue = asyncio.Queue()  # inbound only
        self._supervisor: asyncio.Task | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._framer = None             # AEAD bound to live transport

    # -- public API --------------------------------------------------------

    def send(self, msg: Message) -> None:
        """Queue a message (fire and forget, like Messenger::
        send_message). Dropped silently once the connection is down
        (lossy semantics surface as resets, not send errors)."""
        if not self._open:
            return
        self.out_seq += 1
        msg.seq = self.out_seq
        msg.src = self.msgr.entity
        # frames carry the sender's monotonic clock so the receiver
        # can estimate this peer's clock offset (multi-host span merge)
        data = encode_message(msg, stamp=self.msgr.now())
        if self.policy.resend:
            self.unacked.append((msg.seq, data))
        if _ACCOUNTING:
            self.stats.note_tx(msg.TYPE, len(data))
            # queue-wait is SAMPLED 1-in-16: the clock-stamp pair
            # (monotonic at enqueue + at pop) is the most expensive
            # accounting instruction on this path, and the estimator
            # only ever reports averages and maxima — both survive
            # sampling.  Third element = enqueue stamp.
            if self.out_seq & 0xF == 0:
                self.out_q.put_nowait((TAG_MSG, data,
                                       time.monotonic()))
            else:
                self.out_q.put_nowait((TAG_MSG, data))
        else:
            self.out_q.put_nowait((TAG_MSG, data))

    def mark_down(self) -> None:
        """Administrative teardown: no reset callback fires."""
        if not self._open:
            return
        self._open = False
        self.stats.mark_downs += 1
        if self._writer is not None:
            # a partition must also block the graceful CLOSE: the peer
            # has to see a transport fault (dead host semantics, and
            # lossless replay stays armed), never an orderly shutdown
            # crossing a cut
            inj = self.msgr.fault_injector
            send_close = (inj is None or inj.on_control(
                self.msgr.entity, self.peer_entity or "?"))
            try:
                if send_close:
                    # best-effort graceful close so the peer resets
                    # promptly; sealed under the transport AEAD so a
                    # close is only believed when it came from the
                    # key holder
                    payload = b""
                    if self._framer is not None:
                        payload = self._framer.seal(
                            payload, bytes([TAG_CLOSE]))
                    self._writer.write(_HDR.pack(
                        TAG_CLOSE, len(payload), zlib.crc32(payload))
                        + payload)
                self._writer.close()
            except Exception:
                pass
        self._drain_transports()
        if self._supervisor is not None:
            self._supervisor.cancel()
        self.msgr._forget(self)

    def _drain_transports(self) -> None:
        """Close transports accepted for this session but never run —
        an abandoned open socket would wedge Server.wait_closed()."""
        while not self._transports.empty():
            try:
                _r, w = self._transports.get_nowait()[:2]
                w.close()
            except Exception:
                pass

    @property
    def is_open(self) -> bool:
        return self._open

    # -- supervisor --------------------------------------------------------

    def _start(self) -> None:
        runner = (self._run_outbound if self.peer_addr is not None
                  else self._run_inbound)
        self._supervisor = self.msgr.spawn(runner())

    async def _run_outbound(self) -> None:
        from ..utils.backoff import ExpBackoff

        # a dedicated RNG keyed off the peer: the redial jitter must
        # not perturb this connection's seeded failure schedule
        bo = ExpBackoff(base=0.02, cap=2.0,
                        rng=self.msgr._conn_rng(
                            "%s|backoff" % self.peer_addr))
        while self._open:
            writer = None
            try:
                t0 = time.monotonic()
                host, port = self.peer_addr.rsplit(":", 1)
                reader, writer = await asyncio.open_connection(
                    host, int(port))
                framer, comp = await self.msgr._handshake_out(
                    self, reader, writer)
            except asyncio.CancelledError:
                if writer is not None:
                    writer.close()
                return
            except Exception:
                if writer is not None:
                    writer.close()
                if self.policy.lossy:
                    await self._die()
                    return
                delay = bo.next_delay()
                # telemetry reads the ramp position off the stats
                # block while the dial is down (ExpBackoff.state())
                self.stats.backoff_s = bo.state()["interval_s"]
                await asyncio.sleep(delay)
                continue
            bo.reset()
            self.stats.backoff_s = 0.0
            self.stats.note_handshake(time.monotonic() - t0)
            closed = await self._session(reader, writer, framer, comp)
            if closed or self.policy.lossy:
                await self._die()
                return
            await asyncio.sleep(0.01)

    async def _run_inbound(self) -> None:
        try:
            while self._open:
                try:
                    reader, writer, framer, comp = \
                        await self._transports.get()
                except asyncio.CancelledError:
                    return
                closed = await self._session(reader, writer, framer,
                                             comp)
                if closed or self.policy.lossy:
                    await self._die()
                    return
        finally:
            self._drain_transports()

    async def _session(self, reader, writer, framer=None,
                       comp=None) -> bool:
        """Run one transport until it faults. Returns True when the
        peer closed gracefully (no replay should follow).  The AEAD
        framer is BOUND to this transport (derived from this
        handshake's nonces), so counters restart exactly when the
        peer's do."""
        self._writer = writer
        self._framer = framer
        if self.policy.resend:
            self._replay_unacked()
        rt = asyncio.ensure_future(
            self._read_frames(reader, framer, comp))
        wt = asyncio.ensure_future(
            self._write_frames(writer, framer, comp))
        try:
            done, pending = await asyncio.wait(
                {rt, wt}, return_when=asyncio.FIRST_COMPLETED)
        except asyncio.CancelledError:
            rt.cancel()
            wt.cancel()
            await asyncio.gather(rt, wt, return_exceptions=True)
            raise
        for t in (rt, wt):
            t.cancel()
        results = await asyncio.gather(rt, wt, return_exceptions=True)
        try:
            writer.close()
        except Exception:
            pass
        self._writer = None
        self._framer = None
        return any(isinstance(r, _PeerClosed) for r in results)

    async def _die(self) -> None:
        if not self._open:
            return
        self._open = False
        self.msgr._forget(self)
        await self.msgr._reset(self)

    # -- frame loops (subtasks of _session) ---------------------------------

    async def _write_frames(self, writer, framer=None,
                            comp=None) -> None:
        async def emit(tag: int, payload: bytes) -> None:
            if comp is not None and tag == TAG_MSG:
                # compress-then-encrypt; 1-byte flag says whether
                # this frame actually compressed (small or
                # incompressible payloads ride raw)
                if len(payload) >= 512:
                    blob = comp.compress(payload)
                    payload = (b"\x01" + blob
                               if len(blob) < len(payload)
                               else b"\x00" + payload)
                else:
                    payload = b"\x00" + payload
            if framer is not None:
                # the tag rides as AEAD associated data: relabeled
                # frames fail the MAC at the receiver
                payload = framer.seal(payload, bytes([tag]))
            await _write_frame(writer, tag, payload)

        held: list[tuple[int, bytes]] = []  # reordered frames
        while True:
            if held and self.out_q.empty():
                # nothing left to overtake the held frames: flush now
                # rather than strand them behind an idle queue
                try:
                    flush, held = held, []
                    for htag, hpayload in flush:
                        await emit(htag, hpayload)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    return
            item = await self.out_q.get()
            tag, payload = item[0], item[1]
            if len(item) > 2 and _ACCOUNTING:
                # queue wait: enqueue stamp -> pop (injected delays
                # and socket drain are wire time, not queue time)
                self.stats.note_queue_wait(time.monotonic() - item[2])
            try:
                act = None
                if tag == TAG_ACK:
                    inj = self.msgr.fault_injector
                    if inj is not None and not inj.on_control(
                            self.msgr.entity,
                            self.peer_entity or "?"):
                        # partitioned: the ACK is withheld (it would
                        # retire unacked lossless entries across the
                        # cut); it regenerates on the next delivered
                        # MSG after heal
                        continue
                if tag == TAG_MSG:
                    if (self.msgr.inject_socket_failures and
                            self.rng.randrange(
                                self.msgr.inject_socket_failures) == 0):
                        raise ConnectionError_(
                            "injected socket failure")
                    inj = self.msgr.fault_injector
                    if inj is not None:
                        act = inj.on_send(self.msgr.entity,
                                          self.peer_entity or "?")
                        if act.abort:
                            raise ConnectionError_("injected abort")
                        if act.drop or act.reorder:
                            if self.policy.resend:
                                # a lossless session may not silently
                                # lose or reorder a seq: withhold the
                                # frame and fault the transport — the
                                # reconnect replay redelivers it in
                                # order (ProtocolV2 semantics)
                                raise ConnectionError_(
                                    "injected drop (lossless: "
                                    "escalated to transport fault)")
                            if act.drop:
                                continue
                            held.append((tag, payload))
                            continue
                        if act.delay:
                            # head-of-line latency: later frames queue
                            # behind (a slow link, not a lost one)
                            await asyncio.sleep(act.delay)
                await emit(tag, payload)
                if act is not None and act.dup:
                    # re-seal: AEAD counters make byte-identical
                    # replays unverifiable, so a duplicate is a fresh
                    # frame carrying the same message (same seq — the
                    # receiver's dedup absorbs it)
                    await emit(tag, payload)
                if held:
                    flush, held = held, []
                    for htag, hpayload in flush:
                        await emit(htag, hpayload)
            except asyncio.CancelledError:
                raise
            except Exception:
                # resend policy: the popped payload is still in unacked
                # and will be replayed on the next transport
                return

    async def _read_frames(self, reader, framer=None,
                           comp=None) -> None:
        while True:
            try:
                tag, payload = await _read_frame(reader)
                if framer is not None:
                    # every tag is authenticated, TAG_CLOSE included:
                    # an unverifiable close is a transport fault (so
                    # lossless replay still runs), never an orderly
                    # shutdown an attacker could forge
                    payload = framer.open(payload, bytes([tag]))
                if comp is not None and tag == TAG_MSG:
                    flag, payload = payload[:1], payload[1:]
                    if flag == b"\x01":
                        payload = comp.decompress(payload)
            except asyncio.CancelledError:
                raise
            except Exception:
                return  # transport fault (incl. AEAD reject) -> ends
            if tag == TAG_MSG:
                inj = self.msgr.fault_injector
                if inj is not None and not inj.on_recv(
                        self.peer_entity or "?", self.msgr.entity):
                    # receive-side partition drop: a single injector
                    # enforces BOTH directions of a cut even when the
                    # peer has none installed
                    if self.policy.resend:
                        return      # transport fault: replay later
                    continue        # lossy: the frame vanishes
                msg = decode_message(payload)  # poison frame = fault
                # received payload size: the ingest bytes accounting
                # (mgr report telemetry) reads it off the message
                msg.wire_bytes = len(payload)
                if _ACCOUNTING:
                    self.stats.note_rx(msg.TYPE, len(payload))
                self.msgr.note_peer_clock(
                    msg.src, getattr(msg, "send_stamp", None))
                # dedup: a lossless session replays after reconnect,
                # so anything at-or-below in_seq is a replay dup.  A
                # lossy transport has no replay — its only duplicate
                # source is injected back-to-back dup frames, and a
                # window-based check would misread injected
                # REORDERING as duplication and silently drop frames
                dup = (msg.seq <= self.in_seq if self.policy.resend
                       else msg.seq == self.in_seq)
                if dup and self.policy.resend and _ACCOUNTING:
                    # a session-replay duplicate absorbed by seq
                    self.stats.replays += 1
                self.in_seq = max(self.in_seq, msg.seq)
                if self.policy.resend:
                    # ack duplicates too: the original ack may have
                    # been lost with the previous transport
                    self.out_q.put_nowait(
                        (TAG_ACK, struct.pack(">Q", self.in_seq)))
                if not dup:
                    if isinstance(msg, UnknownMessage):
                        continue  # acked + dropped (registry skew)
                    try:
                        await self.msgr._dispatch(self, msg)
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        # dispatcher bug: drop the transport so the
                        # fault is visible, but never silently
                        import traceback

                        traceback.print_exc()
                        return
            elif tag == TAG_ACK:
                inj = self.msgr.fault_injector
                if inj is not None and not inj.on_control(
                        self.peer_entity or "?", self.msgr.entity):
                    return      # partitioned: transport fault
                (seq,) = struct.unpack(">Q", payload)
                self.unacked = [(s, d) for s, d in self.unacked
                                if s > seq]
            elif tag == TAG_CLOSE:
                inj = self.msgr.fault_injector
                if inj is not None and not inj.on_control(
                        self.peer_entity or "?", self.msgr.entity):
                    # a CLOSE crossing a partition must read as a
                    # transport fault, not an orderly shutdown —
                    # lossless sessions keep their replay state
                    return
                raise _PeerClosed()

    def _replay_unacked(self) -> None:
        """Requeue unacked payloads ahead of pending traffic so the new
        transport replays them in seq order (receiver dedupes by seq)."""
        pending = []
        while not self.out_q.empty():
            item = self.out_q.get_nowait()
            if item[0] == TAG_MSG:
                pending.append(item)
        replay = {d: None for _, d in self.unacked}
        if replay and _ACCOUNTING:
            self.stats.resends += len(replay)
        for d in replay:
            if _ACCOUNTING:
                self.out_q.put_nowait((TAG_MSG, d, time.monotonic()))
            else:
                self.out_q.put_nowait((TAG_MSG, d))
        for item in pending:
            if item[1] not in replay:
                self.out_q.put_nowait(item)


class Messenger:
    """Endpoint owning connections + the dispatch path."""

    def __init__(self, entity: str, nonce: int = 0, auth=None,
                 compress: list[str] | None = None,
                 seed: int | None = None):
        self.entity = entity
        self.auth = auth            # AuthContext or None (DummyAuth)
        # on-wire compression preferences (msgr2 compression_onwire
        # role): advertised in the ident, the ACCEPTOR's order picks
        # the common algorithm; empty/None disables
        self.compress_algos = list(compress or [])
        # seeded mode: every RNG this messenger owns (nonce,
        # per-connection failure schedules) derives deterministically
        # from (seed, entity), so a fault run replays exactly
        self.seed = seed
        self.rng = (random.Random("%s|%s" % (seed, entity))
                    if seed is not None else random.Random())
        # the nonce identifies this messenger *instance*: a restarted
        # daemon must present a different one so peers reset sessions
        self.nonce = nonce if nonce else self.rng.getrandbits(63)
        self.addr: str | None = None
        self.dispatchers: list = []
        self.inject_socket_failures = 0
        # optional FaultInjector (msg.faults): per-peer-pair frame
        # drop/delay/dup/reorder rules + bidirectional partitions
        self.fault_injector = None
        self._server: asyncio.AbstractServer | None = None
        self._conns: dict[str, Connection] = {}     # by dial addr
        self._inbound: list[Connection] = []
        # strong refs: the event loop only weakly references tasks, so
        # fire-and-forget tasks would be GC'd mid-await
        self._tasks: set = set()
        # every accepted transport, so shutdown can force-close ones
        # still mid-handshake (weak: sessions own live writers)
        import weakref

        self._in_writers: weakref.WeakSet = weakref.WeakSet()
        self._shutting_down = False
        self.default_policy = Policy.lossy_client()
        self.peer_policy: dict[str, Policy] = {}    # by entity type
        # clock-offset estimation (the cephadm time-sync / OSD
        # heartbeat skew-check role, minimally): every received frame
        # carries the sender's monotonic send stamp; `stamp - now()`
        # underestimates (peer_clock - my_clock) by the network
        # latency, so new maxima are adopted immediately — but a pure
        # max never decays, so a peer whose clock DRIFTS back down
        # would stay pinned at its stale high-water mark.  Lower
        # estimates therefore blend in with an EWMA: fresh frames
        # pull the estimate down at CLOCK_DECAY per frame, bounded
        # below only by the (sub-ms on loopback) latency noise floor.
        # `clock_skew` shifts THIS daemon's advertised clock (test
        # hook for injected skew/drift).
        self.clock_skew = 0.0
        self.clock_offsets: dict[str, float] = {}   # peer entity -> s
        # per-peer wire accounting folded from dead connections (live
        # connections keep their own WireStats; net_dump merges both)
        self.net_folded: dict[str, WireStats] = {}
        # optional crash capture: when set, an exception escaping a
        # spawned task is handed here (the daemon writes a crash
        # report) instead of dying unobserved as an "exception was
        # never retrieved" warning at GC time
        self.crash_hook = None

    # per-frame EWMA weight for downward (drift) corrections; upward
    # corrections apply immediately (strictly better information)
    CLOCK_DECAY = 0.2

    def now(self) -> float:
        """This daemon's (possibly skewed) monotonic clock."""
        return time.monotonic() + self.clock_skew

    def note_peer_clock(self, src: str, stamp) -> None:
        if stamp is None or not src or src == self.entity:
            return
        est = float(stamp) - self.now()
        cur = self.clock_offsets.get(src)
        if cur is None or est > cur:
            self.clock_offsets[src] = est
        else:
            self.clock_offsets[src] = \
                cur + self.CLOCK_DECAY * (est - cur)

    # -- lifecycle ---------------------------------------------------------

    def _conn_rng(self, peer_key: str) -> random.Random:
        """A connection's RNG: deterministic per (seed, entity, peer)
        in seeded mode so each peer pair has an independent,
        replayable schedule; independent entropy otherwise."""
        if self.seed is not None:
            return random.Random("%s|%s|%s" % (self.seed, self.entity,
                                               peer_key))
        return random.Random(self.rng.getrandbits(64))

    def spawn(self, coro) -> asyncio.Task:
        """ensure_future with a strong reference held until done."""
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)

        def _done(t: asyncio.Task) -> None:
            self._tasks.discard(t)
            if self.crash_hook is None or t.cancelled():
                return      # no hook: keep asyncio's GC-time warning
            exc = t.exception()
            if exc is not None:
                try:
                    self.crash_hook(exc)
                except Exception:
                    pass    # the crash path must never crash

        task.add_done_callback(_done)
        return task

    async def bind(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self._server = await asyncio.start_server(
            self._accept, host=host, port=port)
        sock = self._server.sockets[0]
        self.addr = "%s:%d" % sock.getsockname()[:2]
        return self.addr

    async def shutdown(self) -> None:
        self._shutting_down = True
        if self._server is not None:
            self._server.close()
        # accept handlers may still complete concurrently and (before
        # _shutting_down was set) spawn supervisors: cancel in passes
        # until the task set drains
        for _pass in range(10):
            for conn in (list(self._conns.values())
                         + list(self._inbound)):
                conn.mark_down()
            for t in list(self._tasks):
                t.cancel()
            if not self._tasks:
                break
            await asyncio.gather(*list(self._tasks),
                                 return_exceptions=True)
        for w in list(self._in_writers):
            try:
                w.close()
            except Exception:
                pass
        if self._server is not None:
            # py3.12 wait_closed() waits for every accepted connection;
            # _accept closes on all refusal paths so this terminates —
            # the bound is a backstop so a leak can never hang a daemon
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                pass

    def add_dispatcher(self, d) -> None:
        self.dispatchers.append(d)

    # -- policies ----------------------------------------------------------

    def policy_for(self, entity: str) -> Policy:
        etype = entity.split(".", 1)[0]
        return self.peer_policy.get(etype, self.default_policy)

    # -- outbound ----------------------------------------------------------

    def connect_to(self, addr: str, entity_hint: str = "") -> Connection:
        """Get (or create) the connection to addr. The TCP dial happens
        lazily in the supervisor; sends queue meanwhile."""
        conn = self._conns.get(addr)
        if conn is not None and conn.is_open:
            return conn
        policy = self.policy_for(entity_hint) if entity_hint \
            else self.default_policy
        conn = Connection(self, addr, policy)
        self._conns[addr] = conn
        conn._start()
        return conn

    def send_to(self, addr: str, msg: Message,
                entity_hint: str = "") -> None:
        self.connect_to(addr, entity_hint).send(msg)

    async def _handshake_out(self, conn, reader, writer) -> None:
        from ..utils import denc

        writer.write(BANNER)
        # "ack" mirrors ProtocolV2's reconnect msg_seq exchange
        # (ProtocolV2.cc ReconnectFrame): each side tells the other how
        # much it already received, so replay covers only the gap
        ident = denc.encode({"entity": self.entity, "nonce": self.nonce,
                             "addr": self.addr or "",
                             "ack": conn.in_seq,
                             "comp": self.compress_algos})
        writer.write(struct.pack(">I", len(ident)) + ident)
        await writer.drain()
        banner = await reader.readexactly(len(BANNER))
        if banner != BANNER:
            raise ConnectionError_("bad banner %r" % banner)
        (n,) = struct.unpack(">I", await reader.readexactly(4))
        peer_blob = await reader.readexactly(n)
        peer = denc.decode(peer_blob)
        if self.fault_injector is not None and \
                self.fault_injector.partitioned(
                    self.entity, peer.get("entity", "?")):
            # partitioned peers cannot complete a handshake: redials
            # during a cut fail like an unreachable host would
            raise ConnectionError_("partitioned from %s"
                                   % peer.get("entity"))
        # acceptor's preference order picks the wire compressor
        comp = _pick_compressor(peer.get("comp") or [],
                                self.compress_algos)
        # the idents are unauthenticated at this point: they travel as
        # transcript bind material in the key proofs, and NO session
        # state (nonce, in_seq, unacked purge) moves until the peer has
        # proven the cluster key — a forged ident must not be able to
        # drop queued lossless messages (mirror of the acceptor's
        # READ-ONLY session peek)
        framer = await self._auth_out(reader, writer,
                                      bind=ident + peer_blob)
        conn.peer_entity = peer["entity"]
        nonce = peer.get("nonce", 0)
        if conn.peer_nonce >= 0 and conn.peer_nonce != nonce:
            # peer restarted: its seq numbering starts over
            conn.in_seq = 0
        conn.peer_nonce = nonce
        ack = peer.get("ack", 0)
        conn.unacked = [(s, d) for s, d in conn.unacked if s > ack]
        return framer, comp

    @staticmethod
    async def _read_auth_blob(reader, cap: int = 4096,
                              timeout: float = 5.0) -> bytes:
        """Pre-auth reads are fully bounded (time AND size): this is
        attacker-reachable surface."""
        (n,) = struct.unpack(">I", await asyncio.wait_for(
            reader.readexactly(4), timeout))
        if n > cap:
            raise ConnectionError_("auth blob too large (%d)" % n)
        return await asyncio.wait_for(reader.readexactly(n), timeout)

    async def _auth_out(self, reader, writer, bind: bytes = b""):
        """Initiator side of the cluster-auth exchange (the cephx
        authorizer round): mutual HMAC challenge-response over the
        shared key, with the pre-auth ident transcript mixed into the
        proofs (``bind``) so ident tampering fails auth.  Returns the
        transport's AEAD framer (secure mode) or None."""
        if self.auth is None:
            return None
        from ..utils import denc
        from .auth import SecureFramer
        ncb, hello = self.auth.client_hello()
        blob = denc.encode(hello)
        writer.write(struct.pack(">I", len(blob)) + blob)
        await writer.drain()
        challenge = denc.decode(await self._read_auth_blob(reader))
        nsb, reply = self.auth.client_verify(ncb, challenge, bind)
        blob = denc.encode(reply)
        writer.write(struct.pack(">I", len(blob)) + blob)
        await writer.drain()
        if self.auth.secure:
            return SecureFramer(self.auth.session_key(ncb, nsb),
                                initiator=True)
        return None

    # -- inbound -----------------------------------------------------------

    async def _accept(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        """Inbound handler.  EVERY exit path must either hand the
        transport to a Connection or close the writer: an abandoned
        open socket makes Server.wait_closed() (which waits on all
        accepted connections in py3.12) hang shutdown forever."""
        handed_off = False
        self._in_writers.add(writer)
        try:
            handed_off = await self._accept_inner(reader, writer)
        finally:
            if not handed_off:
                # single close point: any refusal/exception path that
                # did not hand the transport to a Connection closes it
                # (an abandoned socket wedges Server.wait_closed)
                try:
                    writer.close()
                except Exception:
                    pass

    async def _accept_inner(self, reader, writer) -> bool:
        """Returns True only when the transport was handed off to a
        Connection; every other outcome is a refusal and _accept
        closes the writer."""
        from ..utils import denc

        t0 = time.monotonic()
        try:
            # pre-auth reads are time-bounded: an idle dialer must not
            # pin an accept handler (and thus shutdown) indefinitely
            banner = await asyncio.wait_for(
                reader.readexactly(len(BANNER)), 10.0)
            if banner != BANNER:
                return False
            peer_blob = await self._read_auth_blob(reader,
                                                   timeout=10.0)
            peer = denc.decode(peer_blob)
            entity = peer["entity"]
        except (ConnectionError, OSError, asyncio.IncompleteReadError,
                asyncio.TimeoutError, ValueError, KeyError,
                struct.error, RecursionError, ConnectionError_):
            return False
        if self.fault_injector is not None and \
                self.fault_injector.partitioned(self.entity, entity):
            return False    # partitioned: refuse like a dead host
        nonce = peer.get("nonce", 0)
        policy = self.policy_for(entity)
        # READ-ONLY session peek: the ident reply advertises the
        # session's in_seq, but NO session state may change before the
        # peer proves the cluster key (an unauthenticated ident could
        # otherwise tear down live sessions or purge replay queues)
        existing = None
        if not policy.lossy:
            for c in list(self._inbound):
                if c.peer_entity == entity and c.is_open:
                    existing = c
                    break
        ack_out = (existing.in_seq
                   if existing is not None
                   and existing.peer_nonce == nonce else 0)
        try:
            writer.write(BANNER)
            ident = denc.encode({"entity": self.entity,
                                 "nonce": self.nonce,
                                 "addr": self.addr or "",
                                 "ack": ack_out,
                                 "comp": self.compress_algos})
            writer.write(struct.pack(">I", len(ident)) + ident)
            await writer.drain()
        except (ConnectionError, OSError):
            return False
        comp = _pick_compressor(self.compress_algos,
                                peer.get("comp") or [])
        ok, framer = await self._auth_in(reader, writer,
                                         bind=peer_blob + ident)
        if not ok:
            return False    # unauthenticated peer: refused
        if self._shutting_down:
            # a handshake completing after shutdown()'s task snapshot
            # must not spawn a supervisor nobody will ever cancel
            return False
        # authenticated: now apply session-reuse semantics
        # (ProtocolV2 reconnect/reset_session)
        conn = None
        if not policy.lossy and existing is not None \
                and existing.is_open:
            if existing.peer_nonce == nonce:
                conn = existing
            else:
                existing.mark_down()
                await self._reset(existing)
        if conn is None:
            conn = Connection(self, None, policy)
            conn.peer_entity = entity
            conn.peer_nonce = nonce
            self._inbound.append(conn)
            conn._start()
        conn.unacked = [(s, d) for s, d in conn.unacked
                        if s > peer.get("ack", 0)]
        if not conn.is_open:
            return False    # raced mark_down: nobody will run this
        conn.stats.note_handshake(time.monotonic() - t0)
        conn._transports.put_nowait((reader, writer, framer, comp))
        return True

    async def _auth_in(self, reader, writer, bind: bytes = b""):
        """Acceptor side: refuse any peer that cannot prove the key
        (AuthRegistry's cephx_cluster_required gate).  Returns
        (authenticated, framer)."""
        if self.auth is None:
            return True, None
        from ..utils import denc
        from .auth import AuthError, SecureFramer
        try:
            hello = denc.decode(await self._read_auth_blob(reader))
            ncb, nsb, challenge = self.auth.server_challenge(
                hello, bind)
            blob = denc.encode(challenge)
            writer.write(struct.pack(">I", len(blob)) + blob)
            await writer.drain()
            self.auth.server_verify(ncb, nsb, denc.decode(
                await self._read_auth_blob(reader)), bind)
        except (AuthError, asyncio.TimeoutError, ConnectionError,
                ConnectionError_, OSError,
                asyncio.IncompleteReadError, ValueError, KeyError,
                struct.error, RecursionError):
            try:
                writer.close()
            except Exception:
                pass
            return False, None
        if self.auth.secure:
            return True, SecureFramer(
                self.auth.session_key(ncb, nsb), initiator=False)
        return True, None

    # -- dispatch ----------------------------------------------------------

    async def _dispatch(self, conn: Connection, msg: Message) -> None:
        try:
            for d in self.dispatchers:
                handler = getattr(d, "ms_dispatch", None)
                if handler is None:
                    continue
                res = handler(conn, msg)
                if asyncio.iscoroutine(res):
                    res = await res
                if res:
                    return
        except Exception as exc:
            # the SYNCHRONOUS dispatch path: an unhandled handler
            # exception here never reaches spawn()'s done callback, so
            # without this hook call it would drop the transport with
            # no post-mortem artifact (spawned-task exceptions already
            # route through the same hook)
            if self.crash_hook is not None:
                try:
                    self.crash_hook(exc)
                except Exception:
                    pass
            raise

    async def _reset(self, conn: Connection) -> None:
        for d in self.dispatchers:
            handler = getattr(d, "ms_handle_reset", None)
            if handler is not None:
                res = handler(conn)
                if asyncio.iscoroutine(res):
                    await res

    def _forget(self, conn: Connection) -> None:
        # fold the dying connection's wire accounting into the
        # per-peer aggregate (counters survive connection churn); the
        # stats block is replaced so a second _forget cannot
        # double-count
        key = conn.peer_entity or conn.peer_addr or "?"
        agg = self.net_folded.get(key)
        if agg is None:
            agg = self.net_folded[key] = WireStats()
        agg.fold(conn.stats)
        conn.stats = WireStats()
        if conn.peer_addr is not None:
            if self._conns.get(conn.peer_addr) is conn:
                del self._conns[conn.peer_addr]
        elif conn in self._inbound:
            self._inbound.remove(conn)

    # -- wire telemetry ------------------------------------------------------

    def net_dump(self, cap: int | None = None) -> dict:
        """Per-peer wire telemetry: folded dead-connection aggregates
        merged with live connections.  Keys per peer are the
        NET_STAGES-registered WireStats dump fields plus the live
        send-queue depth.  With ``cap``, only the busiest ``cap - 1``
        peers (by tx bytes) keep their own row and the tail folds
        into ``"other"`` — the tenant-label cardinality rule applied
        to peers (many short-lived clients must not grow the report
        without bound)."""
        merged: dict[str, WireStats] = {}
        for key, st in self.net_folded.items():
            agg = merged.setdefault(key, WireStats())
            agg.fold(st)
        depth: dict[str, int] = {}
        for conn in list(self._conns.values()) + list(self._inbound):
            key = conn.peer_entity or conn.peer_addr or "?"
            agg = merged.setdefault(key, WireStats())
            agg.fold(conn.stats)
            depth[key] = depth.get(key, 0) + conn.out_q.qsize()
        if cap is not None and len(merged) > cap:
            keep = sorted(merged, key=lambda k:
                          (-merged[k].tx_bytes, k))[:max(cap - 1, 1)]
            other = WireStats()
            other_depth = 0
            for key in list(merged):
                if key not in keep:
                    other.fold(merged.pop(key))
                    other_depth += depth.pop(key, 0)
            merged["other"] = other
            depth["other"] = other_depth
        return {key: st.dump(queue_depth=depth.get(key, 0))
                for key, st in sorted(merged.items())}

    def prune_peer_state(self, live, prefix: str = "osd.") -> None:
        """Drop dead peers' clock-offset and folded-wire entries.
        Both tables are keyed by peer entity and otherwise grow
        forever across thrash kill/revive cycles (every revived
        daemon dials back from a fresh nonce).  Only entities under
        ``prefix`` are considered — client/mon entries are someone
        else's liveness to judge."""
        live = set(live)
        for table in (self.clock_offsets, self.net_folded):
            for key in list(table):
                if key.startswith(prefix) and key not in live:
                    del table[key]
