"""Monitor: the cluster control plane (map authority).

Analog of src/mon/Monitor.cc + OSDMonitor.cc as one asyncio daemon:
the authoritative OSDMap evolves only through Incrementals committed
via the Paxos log (PaxosService::propose_pending pattern), and every
committed epoch is pushed to subscribers (clients and OSDs follow maps,
never each other).

Implemented service logic (OSDMonitor):
* boot      — MOSDBoot marks the osd EXISTS|UP at its addr and adds it
              to the default CRUSH root (OSDMonitor::preprocess_boot).
* failure   — MOSDFailure reports gated by reporter count + grace
              (OSDMonitor::check_failure, mon/OSDMonitor.cc:3171),
              then the osd is marked down in a new epoch.
* auto-out  — down for mon_osd_down_out_interval -> weight 0
              (OSDMonitor::tick, "will mark out" flow).
* pools     — create/rm/set replicated and erasure pools; erasure
              profiles live in the map (OSDMap::erasure_code_profiles).
* commands  — MMonCommand dict protocol ("osd pool create", "status",
              "osd out/in/down", "osd dump" ...), the mon CLI surface.

Map persistence: every commit stores the Incremental in the paxos log
and the full map at osdmap:full:<epoch> (OSDMonitor's full/inc dual
storage), so a restarted monitor resumes at its last epoch.
"""

from __future__ import annotations

import asyncio
import time

from ..models.crushmap import (CHOOSE_FIRSTN, CHOOSE_INDEP, EMIT, STRAW2,
                               TAKE, CrushMap)
from ..msg import Messenger
from ..msg.messenger import ms_compress_from_conf
from ..msg.messages import (MMonCommand, MMonCommandAck, MMonElection,
                            MMonGetMap, MMonPaxos, MMonSubscribe,
                            MOSDAlive, MOSDBoot, MOSDFailure,
                            MOSDMapMsg, MOSDOp)
from ..osd.osdmap import (CEPH_OSD_OUT, OSD_EXISTS, OSD_UP,
                          POOL_TYPE_ERASURE, POOL_TYPE_REPLICATED,
                          Incremental, OSDMap, PGPool)
from ..store.kv import KeyValueDB, MemKV
from ..utils import denc
from ..utils.context import Context
from .elector import LEADER, Elector
from .paxos import MultiPaxos, Paxos

DEFAULT_EC_PROFILE = {"plugin": "jerasure", "k": "2", "m": "1",
                      "technique": "reed_sol_van"}


class FailureReport:
    __slots__ = ("first", "last", "failed_for")

    def __init__(self, now: float, failed_for: float):
        self.first = now
        self.last = now
        self.failed_for = failed_for


class Monitor:
    """One monitor daemon.  monmap is the fixed list of
    (name, "host:port") pairs defining ranks (MonMap.h: rank = index);
    a single-entry (or omitted) monmap runs the synchronous
    quorum-of-one paxos, a larger one runs the full
    collect/begin/accept/commit/lease exchange with elections."""

    def __init__(self, ctx: Context | None = None, name: str = "mon.0",
                 store: KeyValueDB | None = None, fsid: str = "tpu",
                 monmap: list[tuple[str, str]] | None = None):
        self.ctx = ctx or Context("mon")
        self.name = name
        self.fsid = fsid
        self.store = store or MemKV()
        self.store.open()
        self.monmap = monmap or [(name, "")]
        self.rank = next((i for i, (n, _a) in enumerate(self.monmap)
                          if n == name), 0)
        self.paxos = Paxos(self.store, rank=self.rank)
        self.multi = len(self.monmap) > 1
        if self.multi:
            strategy = self.ctx.conf["mon_election_strategy"]
            disallowed = self._parse_disallowed(
                self.ctx.conf["mon_disallowed_leaders"])
            if strategy == "classic" and disallowed:
                # classic ignores the disallow list (reference
                # behavior; the option documents its scope) — honor
                # that rather than silently barring leaders
                self.ctx.log.info(
                    "mon", "mon_disallowed_leaders ignored under the"
                    " classic election strategy")
                disallowed = set()
            self.elector = Elector(self, strategy=strategy,
                                   disallowed=disallowed)
        else:
            self.elector = None
        self.mpaxos = (MultiPaxos(self, self.paxos) if self.multi
                       else None)
        self._proposal_wake = asyncio.Event() if self.multi else None
        self._proposal_waiters: list = []
        self._last_proposal = None
        from ..msg.auth import AuthContext
        self.msgr = Messenger(
            name, auth=AuthContext.from_conf(self.ctx.conf),
            compress=ms_compress_from_conf(self.ctx.conf))
        self.msgr.add_dispatcher(self)
        self.osdmap = OSDMap()
        self.osdmap.fsid = fsid
        self.pending_inc: Incremental | None = None
        # conn -> epoch already sent (subscription state)
        self.subscribers: dict = {}
        # proposal batch window state (scale plane): boot storms and
        # clog appends fold into one proposal per window instead of
        # one commit (+ full-map encode) per message
        self._batch_flush_scheduled = False
        # crush membership caches: committed root items (invalidated
        # when the crush object changes) + the pending map's additions
        self._crush_set: set[int] = set()
        self._crush_set_src = None
        self._pending_crush_set: set[int] = set()
        # map-publication traffic counters (the late-joiner test and
        # `bench --scale` publication-cost figure)
        self.full_maps_sent = 0
        self.inc_epochs_sent = 0
        # target osd -> reporter osd -> FailureReport
        self.failure_info: dict[int, dict[int, FailureReport]] = {}
        self.down_pending_out: dict[int, float] = {}
        # osd -> (slow_op_count, monotonic stamp) from MOSDBeacons:
        # derived soft state every mon keeps; the LEADER additionally
        # commits transitions into the health service's paxos state so
        # a freshly elected leader reports SLOW_OPS / DEVICE_LOST
        # immediately instead of waiting one beacon round (PR-2 gap)
        self.osd_slow_ops: dict[int, tuple[int, float]] = {}
        # osd -> ({tenant: slow count}, monotonic stamp): the
        # per-tenant slice of the slow counts (SLOW_OPS detail names
        # the worst tenant from it)
        self.osd_slow_tenants: dict[int, tuple[dict, float]] = {}
        # osd -> (device_lost flag, monotonic stamp)
        self.osd_device_lost: dict[int, tuple[int, float]] = {}
        # osd -> (beacon net slice {"rtt_ms": {peer: ms},
        # "slow": [peers]}, monotonic stamp): the heartbeat RTT view
        # behind OSD_SLOW_PING_TIME and `net status`; the leader
        # commits pair-list transitions into the health svc state
        self.osd_net: dict[int, tuple[dict, float]] = {}
        # latest PGMap digest from the mgr (MMonMgrDigest): soft state
        # every mon keeps (broadcast like beacons); feeds status/df/
        # pool-stats and the PG_DEGRADED / PG_AVAILABILITY checks; the
        # leader commits raise/clear edges into the health svc state
        self.mgr_digest: dict | None = None
        self.mgr_digest_stamp = 0.0
        # mon-side op tracking (MMonCommand requests)
        from ..trace import LogClient, OpTracker
        self.optracker = OpTracker(self.ctx, name)
        # the mon's own cluster-log handle: boot/mark-down/auto-out
        # and health-edge events ride the same seq/ack/resend path as
        # every other daemon's clog (a peon forwards to the leader)
        self.clog = LogClient(self.ctx, name,
                              send_fn=self._clog_send)
        # who -> conn that last delivered its MLog / MCrashReport:
        # the ack route back once the paxos commit applies here
        self._log_ack_routes: dict = {}
        self._crash_ack_routes: dict = {}
        self._tick_task = None
        # PaxosService quintet (ConfigMonitor/AuthMonitor/
        # HealthMonitor/LogMonitor/CrashMonitor analogs): their
        # mutations ride the same paxos stream as map changes via
        # pending_svc
        from .services import (AuthMonitor, ConfigMonitor,
                               CrashMonitor, EventMonitor,
                               HealthMonitor, LogMonitor)

        self.config_mon = ConfigMonitor(self)
        self.auth_mon = AuthMonitor(self)
        self.health_mon = HealthMonitor(self)
        self.log_mon = LogMonitor(self)
        self.crash_mon = CrashMonitor(self)
        self.event_mon = EventMonitor(self)
        self.pending_svc: dict[str, list] = {}
        # event-bus subscribers: conn -> last seq sent (each mon
        # serves ITS subscribers from the replicated event log)
        self.event_subs: dict = {}
        # leader-side progress-row memory: digest key -> last
        # fraction, the edge detector behind progress_start/finish
        # events (soft state — a new leader re-announces in-flight
        # flows, which a cursor dedups by seq, not by content)
        self._progress_seen: dict = {}
        # mon-side history rings: every mon folds each arriving mgr
        # digest into its own store and serves `perf history` locally
        # — no mon<->mgr query protocol, survives leader elections,
        # and a dead mgr leaves explicit bucket gaps
        from ..mgr.history import HistoryStore
        self.history = HistoryStore(self.ctx)
        # service state loads BEFORE _load(): crash recovery replays
        # a pending blob through the same apply path, which rewrites
        # the persisted service images — replaying onto empty dicts
        # would erase everything but the replayed ops
        self.config_mon.load()
        self.auth_mon.load()
        self.log_mon.load()
        self.health_mon.load()
        self.crash_mon.load()
        self.event_mon.load()
        self._load()

    def _parse_disallowed(self, raw: str) -> set[int]:
        """mon_disallowed_leaders accepts ranks or monitor names;
        unknown tokens are ignored with a warning (a typo must not
        stop the daemon), but barring EVERY rank is a configuration
        that can never form a quorum and is rejected outright."""
        out: set[int] = set()
        names = {n: i for i, (n, _a) in enumerate(self.monmap)}
        for tok in (raw or "").split(","):
            tok = tok.strip()
            if not tok:
                continue
            if tok in names:
                out.add(names[tok])
            else:
                try:
                    out.add(int(tok))
                except ValueError:
                    self.ctx.log.info(
                        "mon", "ignoring unknown disallowed leader"
                        " %r" % tok)
        if out >= set(range(len(self.monmap))):
            raise ValueError(
                "mon_disallowed_leaders bars every rank: no quorum"
                " could ever form")
        return out

    # -- persistence -------------------------------------------------------

    def _load(self) -> None:
        raw = self.store.get(b"osdmap:last_epoch")
        if raw is not None:
            epoch = denc.decode(raw)
            full = self.store.get(b"osdmap:full:%016d" % epoch)
            if full is not None:
                self.osdmap = OSDMap.decode(full)
        # a crash between paxos commit and map apply leaves a committed
        # blob the map never reflected: recover() replays it through
        # the same apply+persist path as a live commit.  Quorum-of-one
        # only: in a multi-mon cluster a locally-pending value may
        # never have been chosen — it must go through leader_collect's
        # OP_LAST exchange, not be self-committed.
        self.paxos.on_commit.append(self._on_paxos_commit)
        if not self.multi:
            self.paxos.recover()

    def _on_paxos_commit(self, version: int, blob: bytes) -> None:
        payload = denc.decode(blob)
        svc = payload.get("svc") or {}
        if svc:
            # service mutations apply on EVERY monitor (leader, peons,
            # recovery replay) in one KV transaction
            tx = self.store.get_transaction()
            if svc.get("config"):
                self.config_mon.apply(svc["config"], tx)
            if svc.get("auth"):
                self.auth_mon.apply(svc["auth"], tx)
            if svc.get("log"):
                self.log_mon.apply(svc["log"], tx)
            if svc.get("health"):
                self.health_mon.apply(svc["health"], tx)
            if svc.get("crash"):
                self.crash_mon.apply(svc["crash"], tx)
            if svc.get("events"):
                self.event_mon.apply(svc["events"], tx)
            self.store.submit_transaction(tx)
            # committed events fan out from EVERY mon to its own
            # watch-events subscribers (seqs are identical cluster-
            # wide, so a client that re-subscribes elsewhere after an
            # election resumes its cursor without gaps or dups)
            if svc.get("events"):
                self._push_events()
            if svc.get("config"):
                self.config_mon.push_all()
            # committed = durable on a quorum: ack clog entries and
            # crash reports back to their senders (every mon applies
            # the commit; whichever holds the sender's conn acks)
            if svc.get("log"):
                self._ack_log_commit(svc["log"])
            if svc.get("crash"):
                self._ack_crash_commit(svc["crash"])
        inc_d = payload.get("osdmap_inc")
        if inc_d is None:
            return
        inc = Incremental.from_dict(inc_d)
        if inc.epoch != self.osdmap.epoch + 1:
            return  # already reflected in the stored full map
        self.osdmap.apply_incremental(inc)
        self._store_map(inc)
        self._publish()   # peons push replicated epochs to their subs

    def _store_map(self, inc: Incremental) -> None:
        tx = self.store.get_transaction()
        tx.set(b"osdmap:inc:%016d" % inc.epoch, inc.encode())
        tx.set(b"osdmap:full:%016d" % self.osdmap.epoch,
               self.osdmap.encode())
        tx.set(b"osdmap:last_epoch", denc.encode(self.osdmap.epoch))
        self.store.submit_transaction(tx)

    # -- lifecycle ---------------------------------------------------------

    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> str:
        if self.multi:
            maddr = self.monmap[self.rank][1]
            host, p = maddr.rsplit(":", 1)
            port = int(p)
        addr = await self.msgr.bind(host, port)
        self._tick_task = self.msgr.spawn(self._tick_loop())
        if self.multi:
            self.msgr.spawn(self._proposal_loop())
            self.elector.start_election()
        self.ctx.log.info("mon", "%s serving at %s epoch %d"
                          % (self.name, addr, self.osdmap.epoch))
        return addr

    async def shutdown(self) -> None:
        if self.elector is not None:
            self.elector.stop()
        await self.msgr.shutdown()
        self.store.close()

    @property
    def addr(self) -> str:
        return self.msgr.addr

    # -- quorum plumbing (election + paxos transport) ----------------------

    def is_leader(self) -> bool:
        return (not self.multi) or self.elector.state == LEADER

    def quorum_ranks(self) -> list[int]:
        return list(range(len(self.monmap)))

    def _rank_addr(self, rank: int) -> str:
        return self.monmap[rank][1]

    def send_election(self, op: str, epoch: int, to_rank=None,
                      quorum=None) -> None:
        from .elector import CONNECTIVITY

        scores = (self.elector.tracker.wire()
                  if self.elector.strategy == CONNECTIVITY else None)
        msg = MMonElection(op=op, epoch=epoch, rank=self.rank,
                           quorum=quorum, scores=scores)
        targets = ([to_rank] if to_rank is not None else
                   [r for r in self.quorum_ranks() if r != self.rank])
        for r in targets:
            self.msgr.send_to(self._rank_addr(r), msg,
                              entity_hint="mon.%d" % r)

    def send_paxos(self, rank: int, op: str, **fields) -> None:
        epoch = self.elector.epoch if self.elector is not None else 0
        self.msgr.send_to(
            self._rank_addr(rank),
            MMonPaxos(op=op, rank=self.rank, epoch=epoch, **fields),
            entity_hint="mon.%d" % rank)

    def request_catchup(self, rank: int) -> None:
        self.send_paxos(rank, "catchup",
                        last_committed=self.paxos.last_committed)

    def on_win(self, epoch: int, quorum: set[int]) -> None:
        async def lead():
            try:
                await self.mpaxos.leader_collect(reign_epoch=epoch)
            except (IOError, asyncio.TimeoutError) as e:
                self.mpaxos.active = False
                if "reign superseded" in str(e):
                    # a newer election already ran while this reign's
                    # collect waited: its winner recovers; another
                    # election here would only churn
                    return
                self.ctx.log.info("mon", "%s collect failed: %s"
                                  % (self.name, e))
                self.elector.start_election()
                return
            self._publish()
            self._proposal_wake.set()

        self.msgr.spawn(lead())

    def on_lose(self, leader: int, epoch: int) -> None:
        self.mpaxos.active = False

    def readable(self) -> bool:
        """Consistent reads require leadership or a live lease
        (Paxos.h lease semantics) — a partitioned minority refuses."""
        if not self.multi:
            return True
        if self.is_leader():
            return self.mpaxos.active
        return self.mpaxos.lease_valid()

    # -- pending incremental / commit -------------------------------------

    def _pending(self) -> Incremental:
        if self.pending_inc is None:
            self.pending_inc = self.osdmap.new_incremental()
        return self.pending_inc

    def queue_svc_op(self, svc: str, op: tuple) -> None:
        """Stage a service mutation (config/auth/log) for the next
        paxos round (PaxosService pending analog).  Rides the batch
        window: a boot storm's clog appends fold into the same few
        commits as the boots themselves."""
        self.pending_svc.setdefault(svc, []).append(list(op))
        self._propose_soon()

    def _propose_soon(self) -> None:
        """Commit the pending state — now, or after the configured
        batch window (mon_propose_batch_window) so storm-prone
        fire-and-forget mutations (MOSDBoot floods at shell-cluster
        scale) fold into a handful of epochs instead of paying one
        paxos commit + full-map encode each.  Multi-mon mode already
        serializes through the proposal loop (its in-flight round IS
        the batch window); commands keep calling _propose_pending
        directly, so their synchronous-ack contract is unchanged."""
        window = float(self.ctx.conf.get("mon_propose_batch_window",
                                         0.0) or 0.0)
        if window <= 0 or self.multi:
            self._propose_pending()
            return
        if self._batch_flush_scheduled:
            return
        self._batch_flush_scheduled = True

        async def flush() -> None:
            try:
                await asyncio.sleep(window)
            finally:
                self._batch_flush_scheduled = False
            self._propose_pending()

        self.msgr.spawn(flush())

    def _take_svc(self) -> dict:
        svc, self.pending_svc = self.pending_svc, {}
        return svc

    def _propose_pending(self) -> None:
        """PaxosService::propose_pending: commit the pending Incremental
        and/or service ops through paxos, apply, persist, publish.
        Multi-mon: wake the serialized proposal loop (a second mutation
        arriving while a round is in flight folds into the next
        pending proposal)."""
        if self.multi:
            if self.pending_inc is not None or self.pending_svc:
                fut = asyncio.get_event_loop().create_future()
                self._proposal_waiters.append(fut)
                self._last_proposal = fut
                self._proposal_wake.set()
            return
        inc = self.pending_inc
        svc = self._take_svc()
        if inc is None and not svc:
            return
        self.pending_inc = None
        payload: dict = {}
        if inc is not None:
            payload["osdmap_inc"] = inc.to_dict()
        if svc:
            payload["svc"] = svc
        # the on_commit hook applies the payload to the map/services
        # and persists (same path live and during crash recovery)
        self.paxos.propose(denc.encode(payload))
        self.ctx.log.debug("mon", "committed epoch %d"
                           % self.osdmap.epoch)
        if inc is not None:
            self._publish()

    async def _proposal_loop(self) -> None:
        """Leader-side serialized proposer: one paxos round in flight;
        the pending Incremental is re-stamped against the current map
        just before encoding (mutations that landed during the
        previous round fold into one epoch)."""
        while True:
            await self._proposal_wake.wait()
            self._proposal_wake.clear()
            if self.pending_inc is None and not self.pending_svc:
                continue
            if not (self.is_leader() and self.mpaxos.active):
                continue    # re-woken after the next election win
            inc = self.pending_inc
            waiters = self._proposal_waiters
            self.pending_inc = None
            self._proposal_waiters = []
            payload: dict = {}
            if inc is not None:
                inc.epoch = self.osdmap.epoch + 1
                payload["osdmap_inc"] = inc.to_dict()
            svc = self._take_svc()
            if svc:
                payload["svc"] = svc
            blob = denc.encode(payload)
            try:
                await self.mpaxos.propose(blob)
            except (IOError, asyncio.TimeoutError) as e:
                self.ctx.log.info("mon", "%s proposal failed: %s"
                                  % (self.name, e))
                for w in waiters:
                    if not w.done():
                        w.set_exception(IOError("no quorum"))
                self.elector.start_election()
                continue
            for w in waiters:
                if not w.done():
                    w.set_result(None)
            self.ctx.log.debug("mon", "committed epoch %d"
                               % self.osdmap.epoch)
            self._publish()

    def _publish(self) -> None:
        """Push incrementals to every subscriber past its known epoch.
        The store reads are memoized per distinct `have` — at shell-
        cluster scale most of the fleet sits at the same epoch, so one
        commit's fan-out does O(distinct epochs) store walks, not
        O(subscribers)."""
        memo: dict[int, list[bytes]] = {}
        for conn, have in list(self.subscribers.items()):
            if not conn.is_open:
                del self.subscribers[conn]
                continue
            if have >= self.osdmap.epoch:
                continue
            incs = memo.get(have)
            if incs is None:
                incs = memo[have] = self._collect_incs(have)
            conn.send(MOSDMapMsg(fsid=self.fsid, full=None,
                                 incrementals=incs))
            self.inc_epochs_sent += len(incs)
            self.subscribers[conn] = self.osdmap.epoch

    def _collect_incs(self, have: int) -> list[bytes]:
        out = []
        for e in range(have + 1, self.osdmap.epoch + 1):
            raw = self.store.get(b"osdmap:inc:%016d" % e)
            if raw is None:
                return []  # gap: caller falls back to full map
            out.append(raw)
        return out

    # -- event bus (EventMonitor fan-out) ----------------------------------

    def emit_event(self, etype: str, message: str,
                   data: dict | None = None) -> None:
        """Stage one cluster event for the paxos-committed event log
        (leader-only; EventMonitor.emit guards).  The single funnel
        every emission site — health edges, boots, mark-downs,
        progress transitions — goes through."""
        self.event_mon.emit(etype, message, data=data)

    def _push_events(self) -> None:
        """Incremental fan-out after an events commit: each
        subscriber gets exactly the committed rows past its cursor."""
        from ..msg.messages import MMonEvents
        for conn, have in list(self.event_subs.items()):
            if not conn.is_open:
                del self.event_subs[conn]
                continue
            rows = self.event_mon.after(have)
            if not rows:
                continue
            conn.send(MMonEvents(events=rows,
                                 last_seq=self.event_mon.last_seq))
            self.event_subs[conn] = int(rows[-1]["seq"])

    def _diff_progress(self, progress: dict) -> None:
        """Leader-side edge detector over the digest's progress rows:
        a new key emits progress_start, reaching 1.0 (or vanishing
        short of it — daemon died, rows pruned) emits
        progress_finish.  Exactly one finish per flow: a row that
        lingers at 1.0 until the osd prunes it stays silent."""
        seen = self._progress_seen
        for key, row in progress.items():
            frac = float(row.get("fraction") or 0.0)
            prev = seen.get(key)
            if prev is None:
                self.emit_event(
                    "progress_start", "%s %s started"
                    % (row.get("kind"), key),
                    data={"key": key, "kind": row.get("kind")})
                seen[key] = frac
                if frac >= 1.0:
                    # the flow ran start-to-finish between two
                    # digests: the bar never showed partial progress,
                    # but the start/finish pair still must
                    self.emit_event(
                        "progress_finish", "%s %s complete"
                        % (row.get("kind"), key),
                        data={"key": key, "kind": row.get("kind"),
                              "fraction": 1.0})
            elif prev < 1.0 and frac >= 1.0:
                self.emit_event(
                    "progress_finish", "%s %s complete"
                    % (row.get("kind"), key),
                    data={"key": key, "kind": row.get("kind"),
                          "fraction": 1.0})
                seen[key] = frac
            else:
                seen[key] = max(prev, frac)
        for key in [k for k in seen if k not in progress]:
            if seen[key] < 1.0:
                self.emit_event(
                    "progress_finish", "%s ended at %d%%"
                    % (key, int(seen[key] * 100)),
                    data={"key": key,
                          "fraction": round(seen[key], 4)})
            del seen[key]

    def _send_map(self, conn, have: int = -1) -> None:
        if 0 <= have < self.osdmap.epoch:
            # bounded incremental catch-up: a subscriber a few epochs
            # behind gets the contiguous delta, but one N epochs back
            # (a late joiner against a long history) gets ONE full
            # map — shipping the whole incremental history would cost
            # O(history) wire per fresh subscriber at scale
            cap = int(self.ctx.conf.get("mon_map_catchup_max", 64))
            if self.osdmap.epoch - have <= cap:
                incs = self._collect_incs(have)
                if incs:
                    conn.send(MOSDMapMsg(fsid=self.fsid, full=None,
                                         incrementals=incs))
                    self.inc_epochs_sent += len(incs)
                    return
        conn.send(MOSDMapMsg(fsid=self.fsid, full=self.osdmap.encode(),
                             incrementals=[]))
        self.full_maps_sent += 1

    # -- dispatch ----------------------------------------------------------

    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, MMonElection):
            if self.elector is not None:
                self.elector.handle(msg.rank, msg.op, msg.epoch,
                                    msg.quorum,
                                    getattr(msg, "scores", None))
            return True
        if isinstance(msg, MMonPaxos):
            if self.elector is not None:
                self.elector.tracker.saw(msg.rank)
            if self.mpaxos is not None:
                self.mpaxos.handle(msg.rank, msg.op, {
                    f: getattr(msg, f)
                    for f in ("pn", "version", "blob",
                              "last_committed", "first_committed",
                              "lease_until", "uncommitted", "epoch",
                              "accepted_pn")})
            return True
        from ..msg.messages import (MCrashReport, MLog, MLogAck,
                                    MMonMgrDigest, MMonWatchEvents,
                                    MOSDBeacon, MOSDPGTemp)
        if isinstance(msg, MMonWatchEvents):
            # watch-events subscription (subscribe AND cursor renewal
            # both land here): record the client's cursor and serve
            # any committed backlog past it immediately
            self.event_subs[conn] = int(msg.start or 0)
            rows = self.event_mon.after(int(msg.start or 0))
            if rows:
                from ..msg.messages import MMonEvents
                conn.send(MMonEvents(
                    events=rows, last_seq=self.event_mon.last_seq))
                self.event_subs[conn] = int(rows[-1]["seq"])
            return True
        if isinstance(msg, MLog):
            self._handle_log(conn, msg.entries or [])
            return True
        if isinstance(msg, MLogAck):
            # ack for entries this (peon) mon forwarded to the leader
            self.clog.handle_ack(msg.who, int(msg.last or 0),
                                 inc=getattr(msg, "inc", None))
            return True
        if isinstance(msg, MCrashReport):
            self._handle_crash_report(conn, msg.reports or [])
            return True
        if isinstance(msg, MMonMgrDigest):
            self.mgr_digest = msg.digest or {}
            self.mgr_digest_stamp = time.monotonic()
            # EVERY mon folds the digest into its local history rings
            # (wall clock keys the buckets — a dead mgr leaves a hole,
            # and whichever mon serves `perf history` has the data)
            self.history.ingest(time.time(), self.mgr_digest)
            if self.is_leader() and \
                    (not self.multi or self.mpaxos.active):
                totals = self.mgr_digest.get("totals") or {}
                self.health_mon.maybe_commit_digest(
                    int(totals.get("degraded") or 0),
                    int(self.mgr_digest.get("inactive_pgs") or 0),
                    scrub_errors=int(
                        totals.get("scrub_errors") or 0),
                    damaged_pgs=int(
                        self.mgr_digest.get("inconsistent_pgs")
                        or 0))
                # tenant SLO edges: commit the violating-tenant sets
                # so SLO_LATENCY/SLO_BURN survive a leader change
                slo = self.mgr_digest.get("slo") or {}
                self.health_mon.maybe_commit_slo(
                    [t for t, v in slo.items()
                     if v.get("latency_violation")],
                    [t for t, v in slo.items()
                     if v.get("burn_alert")])
                # history-plane anomaly edges: commit the shifted
                # series names so PERF_ANOMALY survives elections
                self.health_mon.maybe_commit_anomaly(
                    self.mgr_digest.get("anomalies") or {})
                # progress-row edges -> progress_start/finish events
                self._diff_progress(
                    self.mgr_digest.get("progress") or {})
            return True
        if isinstance(msg, MOSDBeacon):
            # beacons are derived soft state: EVERY mon records them,
            # so whichever mon leads next already holds the picture —
            # and the current LEADER commits transitions into the
            # health service's replicated state, so even a mon that
            # never saw a beacon (fresh boot, healed partition)
            # reports the warnings immediately on election
            now = time.monotonic()
            slow = int(msg.slow_ops or 0)
            # chip-loss state is chip-encoded: 0 = on-device,
            # 1+chip = that mesh chip lost (the health detail names
            # it; an old beacon without the field reads as chip 0)
            flb = int(msg.device_lost or 0)
            if flb:
                flb = 1 + int(getattr(msg, "device_chip", 0) or 0)
            self.osd_slow_ops[msg.osd] = (slow, now)
            # per-tenant slice (SLOW_OPS worst-tenant detail); soft
            # state only — the committed count covers fresh leaders
            self.osd_slow_tenants[msg.osd] = (
                dict(getattr(msg, "slow_tenants", None) or {}), now)
            self.osd_device_lost[msg.osd] = (flb, now)
            # heartbeat-RTT slice (the network plane): soft state on
            # every mon; the leader commits slow-pair transitions so
            # OSD_SLOW_PING_TIME survives elections.  Legacy beacons
            # carry no net field and simply leave the matrix sparse.
            self.osd_net[msg.osd] = (
                dict(getattr(msg, "net", None) or {}), now)
            if self.is_leader() and \
                    (not self.multi or self.mpaxos.active):
                self.health_mon.maybe_commit(msg.osd, slow, flb)
                self.health_mon.maybe_commit_slow_ping(
                    self._slow_ping_pairs(now))
            return True
        if isinstance(msg, (MOSDBoot, MOSDFailure, MOSDAlive,
                            MOSDPGTemp)) \
                and self.multi and not self.is_leader():
            return True   # OSDs broadcast to every mon; leader acts
        if isinstance(msg, MOSDPGTemp):
            self._handle_pg_temp(msg)
            return True
        if isinstance(msg, MMonGetMap):
            self._send_map(conn, msg.have)
        elif isinstance(msg, MMonSubscribe):
            have = msg.start - 1
            if have < self.osdmap.epoch or have <= 0:
                # behind us (or a fresh session, which must get SOME
                # map back — connect() proves the link by it even on
                # an epoch-0 cluster)
                self._send_map(conn, have)
                self.subscribers[conn] = self.osdmap.epoch
            else:
                # renewal from a subscriber at (or past) our epoch:
                # nothing to send — record ITS epoch so publication
                # resumes from there once we catch up (a lagging
                # ex-partitioned mon must not replay stale epochs)
                self.subscribers[conn] = have
            # centralized config rides the subscription (MConfig on
            # session open, ConfigMonitor::check_sub)
            self.config_mon.push(conn, conn.peer_entity or "client")
        elif isinstance(msg, MOSDBoot):
            self._handle_boot(conn, msg)
        elif isinstance(msg, MOSDFailure):
            self._handle_failure(conn, msg)
        elif isinstance(msg, MOSDAlive):
            self.failure_info.pop(msg.osd, None)
            self._handle_alive_up_thru(msg)
        elif isinstance(msg, MMonCommand):
            self._handle_command(conn, msg)
        else:
            return False
        return True

    def ms_handle_reset(self, conn) -> None:
        self.subscribers.pop(conn, None)
        self.event_subs.pop(conn, None)
        if self.multi and conn.peer_entity.startswith("mon."):
            try:
                rank = int(conn.peer_entity.split(".", 1)[1])
            except ValueError:
                return
            if rank != self.rank:
                self.elector.peer_lost(rank)

    # -- cluster log + crash telemetry (LogClient -> LogMonitor /
    # MCrashReport -> CrashMonitor pipelines) ------------------------------

    def _clog_send(self, msg) -> None:
        """The mon's OWN clog route: the leader commits locally; a
        peon forwards to the leader over the mon-mon link (entries
        stay pending in the LogClient and the tick re-flush retries
        until a leader is known and acks)."""
        if self.is_leader() and (not self.multi
                                 or self.mpaxos.active):
            self._handle_log(None, msg.entries or [])
            return
        leader = (self.elector.leader
                  if self.elector is not None else None)
        if leader is not None and leader != self.rank:
            self.msgr.send_to(self._rank_addr(leader), msg,
                              entity_hint="mon.%d" % leader)

    def _handle_log(self, conn, entries: list) -> None:
        """One daemon's MLog batch: every mon records the ack route;
        only the active leader queues unseen entries through paxos
        (dedup against both the committed last_seq and the not-yet-
        proposed pending queue, so a re-flush racing its own proposal
        stacks nothing)."""
        def key(e) -> tuple[int, int]:
            # dedup key: (boot incarnation, seq) — a wiped-and-reborn
            # daemon's fresh incarnation re-keys its restarted seqs
            return (int(e.get("inc") or 0), int(e.get("seq") or 0))

        by_who: dict[str, list] = {}
        for e in entries:
            who = e.get("who")
            if who:
                by_who.setdefault(who, []).append(e)
        leading = self.is_leader() and (not self.multi
                                        or self.mpaxos.active)
        for who, batch in by_who.items():
            if conn is not None:
                self._log_ack_routes[who] = conn
            committed = self.log_mon.committed_floor(who)
            top = max(key(e) for e in batch)
            if committed >= top:
                # resend raced (or outlived) its ack: re-ack now
                self._send_log_ack(who, committed[1],
                                   inc=committed[0])
                continue
            if not leading:
                continue
            pend = max((key(op[1])
                        for op in self.pending_svc.get("log", [])
                        if op[0] == "append"
                        and op[1].get("who") == who),
                       default=(0, 0))
            base = max(committed, pend)
            for e in sorted(batch, key=key):
                if key(e) > base:
                    self.queue_svc_op("log", ("append", dict(e)))
                    # daemon-originated ERR/WRN entries mirror onto
                    # the event bus (the fresh-entry queue point is
                    # the natural resend dedup).  Mon-self lines stay
                    # off it — their transitions already ride as
                    # dedicated health_edge / osd_* / progress types.
                    if (e.get("level") in ("ERR", "WRN")
                            and who != self.name):
                        self.emit_event(
                            "clog", str(e.get("message", "")),
                            data={"who": who,
                                  "level": e.get("level")})

    def _ack_log_commit(self, ops: list) -> None:
        tops: dict[str, tuple[int, int]] = {}
        for op in ops:
            if op[0] == "append":
                who = op[1].get("who")
                seq = int(op[1].get("seq") or 0)
                inc = int(op[1].get("inc") or 0)
                if who and seq:
                    tops[who] = max(tops.get(who, (0, 0)),
                                    (inc, seq))
        for who, (inc, seq) in tops.items():
            self._send_log_ack(who, seq, inc=inc)

    def _send_log_ack(self, who: str, last: int,
                      inc: int = 0) -> None:
        from ..msg.messages import MLogAck
        if who == self.name:
            self.clog.handle_ack(who, last, inc=inc)
            return
        conn = self._log_ack_routes.get(who)
        if conn is not None and conn.is_open:
            conn.send(MLogAck(who=who, last=last, inc=inc))

    def _handle_crash_report(self, conn, reports: list) -> None:
        """Pending crash reports from a rebooted daemon: ack ids the
        committed table already holds (the resend path), and — on the
        leader — commit unseen ones plus the cluster-log event that
        makes the crash operator-visible in `log last`."""
        from ..msg.messages import MCrashReportAck
        known: list[str] = []
        fresh: list[dict] = []
        pend = {op[1].get("crash_id")
                for op in self.pending_svc.get("crash", [])
                if op[0] == "add"}
        for r in reports:
            cid = r.get("crash_id")
            if not cid:
                continue
            if conn is not None:
                self._crash_ack_routes[cid] = conn
            if cid in self.crash_mon.reports:
                known.append(cid)
            elif cid not in pend:
                fresh.append(r)
        if known and conn is not None and conn.is_open:
            conn.send(MCrashReportAck(crash_ids=known))
        if not (self.is_leader()
                and (not self.multi or self.mpaxos.active)):
            return
        for r in fresh:
            self.queue_svc_op("crash", ("add", dict(r)))
            self.log_mon.append(
                "WRN", "daemon %s crashed: %s: %s (crash id %s)"
                % (r.get("entity"), r.get("exc_type"),
                   r.get("exc_msg"), r.get("crash_id")))
        if fresh:
            # commit-time retention sweep rides the same proposal
            self.crash_mon.maybe_prune()

    def _ack_crash_commit(self, ops: list) -> None:
        from ..msg.messages import MCrashReportAck
        by_conn: dict = {}
        for op in ops:
            if op[0] != "add":
                continue
            cid = op[1].get("crash_id")
            conn = self._crash_ack_routes.pop(cid, None)
            if conn is not None and conn.is_open:
                by_conn.setdefault(id(conn), (conn, []))[1].append(cid)
        for conn, cids in by_conn.values():
            conn.send(MCrashReportAck(crash_ids=cids))

    def _handle_pg_temp(self, msg) -> None:
        """OSDMonitor::prepare_pgtemp: commit requested pg_temp
        mappings (a primary pinning the previous acting set while
        backfill runs) and clears (backfill done)."""
        from ..osd.osdmap import pg_t
        changed = False
        for pool, ps, want in (msg.pgs or []):
            pgid = pg_t(int(pool), int(ps))
            want = [int(o) for o in (want or [])]
            cur = self.osdmap.pg_temp.get(pgid, [])
            pend = (self.pending_inc.new_pg_temp.get(pgid)
                    if self.pending_inc is not None else None)
            now = pend if pend is not None else cur
            if list(now) == want:
                continue
            self._pending().new_pg_temp[pgid] = want
            changed = True
        if changed:
            self._propose_pending()

    # -- boot --------------------------------------------------------------

    def _handle_boot(self, conn, msg: MOSDBoot) -> None:
        osd, addr = msg.osd, msg.addr
        if (osd < self.osdmap.max_osd and self.osdmap.is_up(osd)
                and self.osdmap.osd_addrs.get(osd) == addr):
            return  # already up at that addr (preprocess_boot dup)
        inc = self._pending()
        if osd >= self.osdmap.max_osd and osd >= inc.new_max_osd:
            inc.new_max_osd = osd + 1
        known = osd < self.osdmap.max_osd
        cur_state = self.osdmap.osd_state[osd] if known else 0
        inc.new_up_client[osd] = addr
        if not (cur_state & OSD_EXISTS) or not known \
                or self.osdmap.is_out(osd):
            inc.new_weight[osd] = 0x10000
        self._ensure_in_crush(osd)
        self.failure_info.pop(osd, None)
        self.down_pending_out.pop(osd, None)
        # batched (mon_propose_batch_window): a boot STORM folds into
        # a handful of epochs instead of one commit each
        self._propose_soon()
        self.ctx.log.info("mon", "osd.%d booted at %s (epoch %d)"
                          % (osd, addr, self.osdmap.epoch))
        self.log_mon.append("INF", "osd.%d boot (epoch %d)"
                            % (osd, self.osdmap.epoch))
        self.emit_event("osd_boot", "osd.%d booted at %s"
                        % (osd, addr), data={"osd": osd})

    def _cmd_pg_scrub(self, prefix: str, cmd: dict) -> dict:
        """`ceph pg scrub|deep-scrub|repair <pgid>` (OSDMonitor
        forwards the request to the PG's primary; the scrub itself
        runs asynchronously there).  pgid = "<pool>.<ps-hex>"."""
        from ..msg.messages import MOSDScrub
        from ..osd.osdmap import pg_t

        pgid_s = str(cmd.get("pgid", ""))
        try:
            pool_s, ps_s = pgid_s.split(".", 1)
            pgid = pg_t(int(pool_s), int(ps_s, 16))
        except ValueError:
            raise ValueError("bad pgid %r (want <pool>.<ps-hex>)"
                             % pgid_s) from None
        if pgid.pool not in self.osdmap.pools:
            raise ValueError("no pool %d" % pgid.pool)
        _up, _upp, _acting, primary = \
            self.osdmap.pg_to_up_acting_osds(pgid)
        if primary < 0 or not self.osdmap.is_up(primary):
            raise ValueError("pg %s has no live primary" % pgid_s)
        addr = self.osdmap.osd_addrs.get(primary)
        self.msgr.send_to(addr, MOSDScrub(
            pool=pgid.pool, ps=pgid.ps,
            deep=prefix in ("pg deep-scrub", "pg repair"),
            repair=prefix == "pg repair"),
            entity_hint="osd.%d" % primary)
        return {"scheduled": True, "primary": primary}

    def _handle_alive_up_thru(self, msg) -> None:
        """OSDMonitor::prepare_alive: record that the osd was alive
        and primary-capable through the requested epoch.  Peering
        logic later uses up_thru >= interval_start as the witness
        that the interval could have served writes."""
        want = getattr(msg, "want_up_thru", None)
        if not want:
            return
        osd = msg.osd
        if not (osd < self.osdmap.max_osd and self.osdmap.is_up(osd)):
            return
        cur = self.osdmap.get_up_thru(osd)
        inc = self._pending()
        pend = inc.new_up_thru.get(osd, 0)
        if want > max(cur, pend):
            inc.new_up_thru[osd] = want
            self._propose_pending()

    def _crush_osds(self) -> set[int]:
        """Committed crush root membership as a set (cached per crush
        object — the per-boot `osd in root.items` list walk is O(n)
        and a 10k-osd boot storm would pay it n times)."""
        crush = self.osdmap.crush
        if self._crush_set_src is not crush:
            self._crush_set = set(self._crush_members(crush))
            self._crush_set_src = crush
        return self._crush_set

    def _ensure_in_crush(self, osd: int) -> None:
        """Make sure `osd` is in the (pending or committed) crush
        map.  The first addition of a proposal window builds the
        pending map once; later boots in the SAME window append to it
        in place — never O(n) rebuilds per boot."""
        inc = self._pending()
        if inc.new_crush is not None:
            if osd in self._pending_crush_set:
                return
            self._crush_append_osd(inc.new_crush, osd)
            self._pending_crush_set.add(osd)
            return
        if osd in self._crush_osds():
            return
        inc.new_crush = self._crush_with(osd)
        self._pending_crush_set = set(self._crush_members(
            inc.new_crush))

    @staticmethod
    def _crush_members(crush: CrushMap) -> list[int]:
        return [o for b in crush.buckets.values()
                for o in b.items if o >= 0]

    def _osds_per_host(self) -> int:
        return int(self.ctx.conf.get("mon_crush_osds_per_host", 0)
                   or 0)

    def _crush_append_osd(self, crush: CrushMap, osd: int) -> None:
        """In-place append to the PENDING crush map (O(1)-ish per
        boot): flat maps grow the root, host-grouped maps grow (or
        create) the osd's host bucket and roll its weight up to the
        root."""
        per_host = self._osds_per_host()
        root = crush.buckets.get(-1)
        if per_host <= 0:
            root.items.append(osd)
            root.item_weights.append(0x10000)
            root.weight += 0x10000
            return
        hid = -(2 + osd // per_host)
        hb = crush.buckets.get(hid)
        if hb is None:
            hb = crush.add_bucket(STRAW2, 1, [osd], [0x10000],
                                  id=hid,
                                  name="host-%d" % (osd // per_host))
            root.items.append(hid)
            root.item_weights.append(hb.weight)
        else:
            hb.items.append(osd)
            hb.item_weights.append(0x10000)
            hb.weight += 0x10000
            root.item_weights[root.items.index(hid)] += 0x10000
        root.weight += 0x10000

    def _crush_with(self, osd: int) -> CrushMap:
        """Default map rebuild.  Flat shape (the vstart dev-cluster
        default): one straw2 root holding every known osd, choose
        over devices.  With `mon_crush_osds_per_host` > 0 (the scale
        plane's shape): osds grouped into straw2 host buckets under
        the root, chooseleaf over hosts — real failure domains, and
        each placement draw hashes O(hosts + per_host) items instead
        of O(osds)."""
        known = set()
        known.update(self._crush_osds())
        pending = self.pending_inc
        if pending is not None:
            known.update(pending.new_up_client)
        known.add(osd)
        items = sorted(known)
        per_host = self._osds_per_host()
        crush = CrushMap()
        if per_host > 0:
            from ..models.crushmap import (CHOOSELEAF_FIRSTN,
                                           CHOOSELEAF_INDEP)
            hosts: dict[int, list[int]] = {}
            for o in items:
                hosts.setdefault(o // per_host, []).append(o)
            host_ids = []
            for h, its in sorted(hosts.items()):
                b = crush.add_bucket(STRAW2, 1, its,
                                     [0x10000] * len(its),
                                     id=-(2 + h), name="host-%d" % h)
                host_ids.append(b.id)
            crush.add_bucket(STRAW2, 2, host_ids,
                             [crush.buckets[h].weight
                              for h in host_ids], id=-1)
            crush.add_rule([(TAKE, -1, 0),
                            (CHOOSELEAF_FIRSTN, 0, 1), (EMIT, 0, 0)],
                           id=0, name="replicated_rule")
            crush.add_rule([(TAKE, -1, 0),
                            (CHOOSELEAF_INDEP, 0, 1), (EMIT, 0, 0)],
                           id=1, name="erasure_rule")
            return crush
        crush.add_bucket(STRAW2, 1, items, [0x10000] * len(items),
                         id=-1)
        crush.add_rule([(TAKE, -1, 0), (CHOOSE_FIRSTN, 0, 0),
                        (EMIT, 0, 0)], id=0, name="replicated_rule")
        crush.add_rule([(TAKE, -1, 0), (CHOOSE_INDEP, 0, 0),
                        (EMIT, 0, 0)], id=1, name="erasure_rule")
        return crush

    # -- failure detection (OSDMonitor.cc:3171 check_failure) --------------

    def _handle_failure(self, conn, msg: MOSDFailure) -> None:
        target = msg.target
        reporter = int(msg.src.split(".", 1)[1]) if "." in msg.src else -1
        if (target >= self.osdmap.max_osd
                or not self.osdmap.is_up(target)):
            return
        now = time.monotonic()
        reports = self.failure_info.setdefault(target, {})
        rep = reports.get(reporter)
        if rep is None:
            reports[reporter] = FailureReport(now, msg.failed_for)
        else:
            rep.last = now
            rep.failed_for = max(rep.failed_for, msg.failed_for)
        self._check_failure(target)

    def _check_failure(self, target: int) -> None:
        reports = self.failure_info.get(target, {})
        min_reporters = self.ctx.conf["mon_osd_min_down_reporters"]
        grace = self.ctx.conf["heartbeat_grace"]
        if len(reports) < min_reporters:
            return
        if max(r.failed_for for r in reports.values()) < grace:
            return
        self.ctx.log.info("mon", "marking osd.%d down (%d reporters)"
                          % (target, len(reports)))
        self.log_mon.append("WRN", "osd.%d marked down (%d reporters)"
                            % (target, len(reports)))
        self.emit_event("osd_down", "osd.%d marked down (%d "
                        "reporters)" % (target, len(reports)),
                        data={"osd": target})
        inc = self._pending()
        inc.new_state[target] = OSD_UP  # xor clears UP
        del self.failure_info[target]
        self.down_pending_out[target] = time.monotonic()
        self._propose_pending()

    async def _tick_loop(self) -> None:
        while True:
            await asyncio.sleep(1.0)
            self._tick()

    def _tick(self) -> None:
        """Auto-out down osds after the down-out interval; decay +
        persist connectivity scores and probe peer liveness."""
        if self.elector is not None:
            from .elector import CONNECTIVITY

            self.elector.tracker.tick()
            if self.elector.strategy == CONNECTIVITY:
                # all-pairs liveness probes: the reference's Elector
                # pings keep scores meaningful between elections
                # (steady-state paxos is a leader-centred star)
                self.send_election("ping", self.elector.epoch)
        # re-flush unacked clog entries: a leader election or dropped
        # frame between emit and commit loses nothing
        self.clog.flush()
        # crash-table retention: the leader queues committed rm ops
        # for archived reports past mon_crash_retention
        if self.is_leader() and (not self.multi
                                 or self.mpaxos.active):
            self.crash_mon.maybe_prune()
        now = time.monotonic()
        interval = self.ctx.conf["mon_osd_down_out_interval"]
        changed = False
        for osd, down_at in list(self.down_pending_out.items()):
            if self.osdmap.is_up(osd):
                del self.down_pending_out[osd]
                continue
            if now - down_at >= interval and self.osdmap.is_in(osd):
                self._pending().new_weight[osd] = CEPH_OSD_OUT
                del self.down_pending_out[osd]
                changed = True
                self.ctx.log.info("mon", "marking osd.%d out" % osd)
                self.log_mon.append("WRN", "osd.%d auto-out" % osd)
                self.emit_event("osd_out", "osd.%d auto-out" % osd,
                                data={"osd": osd})
        if changed:
            self._propose_pending()

    # -- commands ----------------------------------------------------------

    def _handle_command(self, conn, msg: MMonCommand) -> None:
        cmd = msg.cmd or {}
        prefix = cmd.get("prefix", "")
        top = self.optracker.create(
            "mon_command(%s from %s)" % (prefix, msg.src),
            trace=getattr(msg, "trace", None))
        if self.multi and not self.is_leader():
            # peons redirect to the leader (the reference forwards;
            # redirect keeps the routing stateless).  -EHOSTDOWN tells
            # the client to retry elsewhere; a live lease could serve
            # pure reads, but commands are rare enough to centralise.
            leader = self.elector.leader
            out = {"leader": (self._rank_addr(leader)
                              if leader is not None else None)}
            conn.send(MMonCommandAck(tid=msg.tid, result=-112,
                                     out=out))
            top.finish("redirected")
            return
        if self.multi and not self.mpaxos.active:
            conn.send(MMonCommandAck(tid=msg.tid, result=-112,
                                     out={"leader": None}))
            top.finish("redirected_inactive")
            return
        if self.multi:
            # mutating commands must ack only after the paxos commit
            # lands (the single-mon path commits synchronously)
            self.msgr.spawn(self._command_async(conn, msg, prefix,
                                                cmd, top))
            return
        try:
            out = self._run_command(prefix, cmd)
            conn.send(MMonCommandAck(tid=msg.tid, result=0, out=out))
            top.finish("done")
        except Exception as e:
            conn.send(MMonCommandAck(tid=msg.tid, result=-22,
                                     out={"error": str(e)}))
            top.finish("error")

    async def _command_async(self, conn, msg, prefix, cmd,
                             top=None) -> None:
        try:
            self._last_proposal = None
            out = self._run_command(prefix, cmd)
            fut = self._last_proposal
            self._last_proposal = None
            if fut is not None:
                if top is not None:
                    top.mark_event("proposal_queued")
                await asyncio.wait_for(fut, 15.0)
            conn.send(MMonCommandAck(tid=msg.tid, result=0, out=out))
            if top is not None:
                top.finish("done")
        except (IOError, asyncio.TimeoutError):
            # quorum lost mid-round: the proposal MAY still commit
            # under a later reign, so a retryable redirect would make
            # clients re-run possibly-committed (non-idempotent)
            # commands — report ETIMEDOUT and let the caller decide
            conn.send(MMonCommandAck(
                tid=msg.tid, result=-110,
                out={"error": "proposal timed out; may have "
                              "committed"}))
            if top is not None:
                top.finish("proposal_timeout")
        except Exception as e:
            conn.send(MMonCommandAck(tid=msg.tid, result=-22,
                                     out={"error": str(e)}))
            if top is not None:
                top.finish("error")

    def _run_command(self, prefix: str, cmd: dict) -> dict:
        # service command surfaces (ConfigMonitor/AuthMonitor/
        # HealthMonitor/LogMonitor/CrashMonitor/EventMonitor)
        for svc in (self.config_mon, self.auth_mon, self.health_mon,
                    self.log_mon, self.crash_mon, self.event_mon):
            out = svc.command(prefix, cmd)
            if out is not None:
                return out
        if prefix == "perf history":
            # read-only history query against THIS mon's rings (the
            # digest broadcast feeds every mon identically modulo
            # arrival time); no series -> the retained inventory
            series = cmd.get("series")
            if not series:
                return {"series": [[s, lb] for s, lb
                                   in self.history.series_names()],
                        "stats": self.history.stats()}
            return self.history.query(
                str(series), label=cmd.get("label"),
                window=float(cmd.get("window") or 600.0))
        if prefix == "net status":
            # read-only network surface (like `perf history`, not
            # audited): heartbeat RTT matrix from beacon soft state
            # plus per-daemon wire rates from the digest
            return self._cmd_net_status()
        if prefix in _AUDIT_PREFIXES:
            # command provenance on the audit channel (the reference
            # mon's audit clog): only state-mutating prefixes — an
            # audit entry per status poll would burn a paxos round
            # each
            self.log_mon.append(
                "INF", "cmd: %s %s" % (prefix, {
                    k: v for k, v in cmd.items() if k != "prefix"}),
                channel="audit")
        if prefix == "osd pool create":
            return self._cmd_pool_create(cmd)
        if prefix == "osd pool rm":
            name = cmd["pool"]
            pid = self._pool_id(name)
            inc = self._pending()
            inc.old_pools.append(pid)
            self._propose_pending()
            self.log_mon.append("INF", "pool '%s' (id %d) removed"
                                % (name, pid))
            return {}
        if prefix == "osd pool set":
            return self._cmd_pool_set(cmd)
        if prefix == "osd erasure-code-profile set":
            inc = self._pending()
            inc.new_erasure_code_profiles[cmd["name"]] = dict(
                cmd.get("profile", {}))
            self._propose_pending()
            return {}
        if prefix == "osd out":
            inc = self._pending()
            inc.new_weight[int(cmd["id"])] = CEPH_OSD_OUT
            self._propose_pending()
            return {}
        if prefix == "osd in":
            inc = self._pending()
            inc.new_weight[int(cmd["id"])] = 0x10000
            self._propose_pending()
            return {}
        if prefix == "osd down":
            osd = int(cmd["id"])
            if self.osdmap.is_up(osd):
                inc = self._pending()
                inc.new_state[osd] = OSD_UP
                self.down_pending_out[osd] = time.monotonic()
                self._propose_pending()
            return {}
        if prefix == "mgr register":
            # MgrMonitor's role: record the active manager's address
            # in the map so daemons know where to send MMgrReports
            inc = self._pending()
            inc.new_mgr_addr = str(cmd["addr"])
            self._propose_pending()
            return {}
        if prefix == "osd pg-upmap-items":
            # the balancer's apply channel (OSDMonitor pg-upmap-items)
            from ..osd.osdmap import pg_t as _pg_t
            pgid = _pg_t(int(cmd["pool"]), int(cmd["ps"]))
            items = [(int(a), int(b)) for a, b in cmd["mappings"]]
            inc = self._pending()
            inc.new_pg_upmap_items[pgid] = items
            self._propose_pending()
            return {}
        if prefix == "osd rm-pg-upmap-items":
            from ..osd.osdmap import pg_t as _pg_t
            pgid = _pg_t(int(cmd["pool"]), int(cmd["ps"]))
            inc = self._pending()
            inc.new_pg_upmap_items[pgid] = []
            self._propose_pending()
            return {}
        if prefix == "osd pool mksnap":
            return self._cmd_pool_mksnap(cmd)
        if prefix == "osd pool rmsnap":
            return self._cmd_pool_rmsnap(cmd)
        if prefix == "osd snap create":
            return self._cmd_selfmanaged_snap_create(cmd)
        if prefix == "osd snap rm":
            return self._cmd_selfmanaged_snap_rm(cmd)
        if prefix in ("pg scrub", "pg deep-scrub", "pg repair"):
            return self._cmd_pg_scrub(prefix, cmd)
        if prefix == "status":
            return self._cmd_status()
        if prefix == "df":
            return self._cmd_df()
        if prefix == "osd pool stats":
            return self._cmd_pool_stats(cmd)
        if prefix == "osd dump":
            return self.osdmap.to_dict()
        raise ValueError("unknown command %r" % prefix)

    # -- cluster stats surfaces (PGMap digest consumers) -------------------

    def _digest_fresh(self) -> dict | None:
        """The mgr's PGMap digest when recent enough to serve (stale
        digests — mgr dead, never registered — surface as absent
        sections, never as frozen numbers)."""
        if self.mgr_digest is None:
            return None
        ttl = self.health_mon.SOFT_TTL
        if time.monotonic() - self.mgr_digest_stamp > ttl:
            return None
        return self.mgr_digest

    def _slow_ping_pairs(self, now: float | None = None) -> list:
        """Sorted "osd.A-osd.B" pair names any FRESH beacon net
        slice flags slow — the OSD_SLOW_PING_TIME commit value (the
        leader calls this per beacon; edges-only dedup in the health
        monitor keeps steady state free of paxos rounds)."""
        if now is None:
            now = time.monotonic()
        ttl = self.health_mon.SOFT_TTL
        pairs: set[str] = set()
        for osd, (nrow, stamp) in self.osd_net.items():
            if now - stamp >= ttl:
                continue
            for peer in (nrow or {}).get("slow") or []:
                try:
                    p = int(peer)
                except (TypeError, ValueError):
                    continue
                pairs.add("osd.%d-osd.%d"
                          % (min(osd, p), max(osd, p)))
        return sorted(pairs)

    def _cmd_net_status(self) -> dict:
        """`net status` (the `rados netstat` backend): the cluster
        heartbeat RTT matrix from beacon soft state plus per-daemon
        wire rates from the mgr digest — read-only, served from THIS
        mon's view like `perf history`."""
        now = time.monotonic()
        ttl = self.health_mon.SOFT_TTL
        matrix: dict[str, dict] = {}
        for osd, (nrow, stamp) in sorted(self.osd_net.items()):
            if now - stamp >= ttl:
                continue
            row: dict[str, float] = {}
            for peer, ms in ((nrow or {}).get("rtt_ms")
                             or {}).items():
                try:
                    row["osd.%d" % int(peer)] = round(
                        float(ms), 3)
                except (TypeError, ValueError):
                    continue
            matrix["osd.%d" % osd] = row
        dig = self._digest_fresh()
        net = (dig.get("net") or {}) if dig else {}
        daemons = {
            str(d): {
                "tx_Bps": float(row.get("tx_Bps") or 0.0),
                "rx_Bps": float(row.get("rx_Bps") or 0.0),
                "resends": int(row.get("resends") or 0),
                "replays": int(row.get("replays") or 0),
                "queue_depth": int(row.get("queue_depth") or 0),
                "resend_rate": float(
                    row.get("resend_rate") or 0.0),
                "rtt_avg_ms": float(row.get("rtt_avg_ms") or 0.0),
                "rtt_max_ms": float(row.get("rtt_max_ms") or 0.0),
            } for d, row in sorted(net.items())}
        return {"rtt_ms": matrix,
                "slow_pairs": self._slow_ping_pairs(now),
                "reporting": len(matrix),
                "daemons": daemons,
                "daemons_available": dig is not None}

    def _cmd_status(self) -> dict:
        """`ceph -s`: mon/osd summary plus the PGMap data/io sections
        the digest carries (pg states, object+byte totals, client IO
        and recovery rates)."""
        up = sum(1 for o in range(self.osdmap.max_osd)
                 if self.osdmap.is_up(o))
        inn = sum(1 for o in range(self.osdmap.max_osd)
                  if self.osdmap.is_in(o))
        out = {"epoch": self.osdmap.epoch, "fsid": self.fsid,
               "num_osds": self.osdmap.max_osd, "num_up_osds": up,
               "num_in_osds": inn,
               "pools": sorted(self.osdmap.pools)}
        health = self.health_mon.command("health", {})
        out["health"] = health["status"]
        out["checks"] = sorted(health["checks"])
        dig = self._digest_fresh()
        if dig is None:
            # a digest-less mon (mgr dead / never registered / digest
            # past TTL) says so EXPLICITLY instead of silently
            # omitting the section — absent data must never read as
            # "zero activity"
            out["pgmap"] = {
                "available": False,
                "status": "unavailable (no mgr digest)",
            }
            # instead of the panels simply vanishing, serve the last
            # retained history-ring cell for the io rates and
            # device_util, each annotated with its age — stale data
            # clearly labeled stale beats no data (ROADMAP
            # carry-forward)
            io_last: dict = {}
            age_max = 0.0
            for key, series in (("read_ops_s", "io.read_ops_s"),
                                ("write_ops_s", "io.write_ops_s"),
                                ("read_bytes_s", "io.read_bytes_s"),
                                ("write_bytes_s",
                                 "io.write_bytes_s")):
                cell = self.history.latest(series)
                if cell is not None:
                    io_last[key] = cell[0]
                    age_max = max(age_max, cell[1])
            if io_last:
                io_last["stale"] = True
                io_last["age_s"] = round(age_max, 1)
                out["pgmap"]["io_last"] = io_last
            du_last: dict = {}
            du_age = 0.0
            for chip in self.history.labels_for("device.busy_frac"):
                cell = self.history.latest("device.busy_frac",
                                           label=chip)
                if cell is None:
                    continue
                du_last[chip] = {"busy_frac": cell[0]}
                du_age = max(du_age, cell[1])
            if du_last:
                out["device_util_last"] = {
                    "stale": True, "age_s": round(du_age, 1),
                    "chips": du_last}
        else:
            totals = dig.get("totals") or {}
            out["pgmap"] = {
                "available": True,
                "num_pgs": dig.get("num_pgs", 0),
                "pg_states": dict(dig.get("pg_states") or {}),
                "data": {
                    "objects": int(totals.get("objects") or 0),
                    "bytes": int(totals.get("bytes") or 0),
                    "degraded": int(totals.get("degraded") or 0),
                    "misplaced": int(totals.get("misplaced") or 0),
                    "unfound": int(totals.get("unfound") or 0),
                },
                "io": {
                    "read_ops_s": float(
                        totals.get("read_ops_s") or 0.0),
                    "write_ops_s": float(
                        totals.get("write_ops_s") or 0.0),
                    "read_bytes_s": float(
                        totals.get("read_bytes_s") or 0.0),
                    "write_bytes_s": float(
                        totals.get("write_bytes_s") or 0.0),
                    "recovery_ops_s": float(
                        totals.get("recovery_ops_s") or 0.0),
                    "recovery_bytes_s": float(
                        totals.get("recovery_bytes_s") or 0.0),
                },
            }
            # report-freshness line: how stale the digest's inputs
            # are (daemon count, worst report age + who, daemons past
            # the staleness window, visible prune totals) — absent
            # reporters must never read as "all healthy and idle"
            rep = dig.get("reports")
            if rep:
                out["pgmap"]["reports"] = {
                    "daemons": int(rep.get("daemons") or 0),
                    "max_age": float(rep.get("max_age") or 0.0),
                    "max_age_daemon": rep.get("max_age_daemon"),
                    "stale": int(rep.get("stale") or 0),
                    "pruned_rows": (
                        int(rep.get("pruned_stale_rows") or 0)
                        + int(rep.get("pruned_pool_rows") or 0)),
                }
            # device-utilization line: per-chip windowed busy /
            # queue-wait / idle fractions from the digest, so chip
            # saturation is visible in one `status` call cluster-wide
            du = dig.get("device_util") or {}
            if du:
                out["device_util"] = {
                    int(chip): dict(row)
                    for chip, row in sorted(du.items(),
                                            key=lambda kv:
                                            int(kv[0]))}
            # cross-codec repair-bytes panel: the digest's per-codec
            # recovery-traffic totals rendered beside device_util, so
            # the locality win (LRC local repairs vs RS k-fetches) is
            # a `status` line, not a bench-only figure
            rt = dig.get("repair_traffic") or {}
            if rt:
                out["repair_traffic"] = {
                    str(codec): {
                        "read": int(row.get("read") or 0),
                        "moved": int(row.get("moved") or 0),
                        "objects": int(row.get("objects") or 0),
                        "targeted": int(row.get("targeted") or 0),
                        "full": int(row.get("full") or 0),
                    }
                    for codec, row in sorted(rt.items())}
            # data-reduction panel: the digest's per-pool dedup
            # totals (chunks stored vs deduped, logical bytes saved)
            # rendered beside repair_traffic — the dedup win is a
            # `status` line, not a bench-only figure
            # progress panel: in-flight background flows (recovery
            # drains, scrub sweeps) as fraction-complete rows — the
            # reference's `ceph -s` progress section
            prog = dig.get("progress") or {}
            if prog:
                out["progress"] = {
                    str(k): {"kind": row.get("kind"),
                             "done": int(row.get("done") or 0),
                             "total": int(row.get("total") or 0),
                             "fraction": float(
                                 row.get("fraction") or 0.0)}
                    for k, row in sorted(prog.items())}
            dd = dig.get("dedup_pools") or {}
            if dd:
                out["dedup"] = {
                    str(pid): {
                        "chunks_stored": int(
                            row.get("chunks_stored") or 0),
                        "chunks_deduped": int(
                            row.get("chunks_deduped") or 0),
                        "bytes_stored": int(
                            row.get("bytes_stored") or 0),
                        "bytes_saved": int(
                            row.get("bytes_saved") or 0),
                    }
                    for pid, row in sorted(dd.items())}
        return out

    def _pool_digest_rows(self) -> list[dict]:
        dig = self._digest_fresh()
        pools_dig = (dig.get("pools") or {}) if dig else {}
        rows = []
        for pid in sorted(self.osdmap.pools):
            pool = self.osdmap.pools[pid]
            row = {"id": pid, "name": pool.name}
            st = pools_dig.get(pid) or pools_dig.get(str(pid)) or {}
            for k in ("objects", "bytes", "degraded", "misplaced",
                      "unfound", "num_pgs"):
                row[k] = int(st.get(k) or 0)
            for k in ("read_ops_s", "write_ops_s", "read_bytes_s",
                      "write_bytes_s", "recovery_ops_s",
                      "recovery_bytes_s"):
                row[k] = float(st.get(k) or 0.0)
            rows.append(row)
        return rows

    def _cmd_df(self) -> dict:
        """`rados df`: real per-pool usage from the PGMap digest (the
        pre-stats build aliased `status` here), plus the per-OSD
        raw-capacity axis (store statfs riding MMgrReport)."""
        rows = self._pool_digest_rows()
        total = {k: sum(r[k] for r in rows)
                 for k in ("objects", "bytes", "degraded",
                           "misplaced", "unfound")}
        dig = self._digest_fresh()
        osd_rows = []
        for daemon, sf in sorted(
                ((dig.get("osd_stats") or {}) if dig else {}).items()):
            t = int(sf.get("total") or 0)
            u = int(sf.get("used") or 0)
            osd_rows.append({"name": daemon, "total": t, "used": u,
                             "available": max(0, t - u),
                             "util": (float(u) / t) if t else 0.0})
        return {"pools": rows, "total": total, "osds": osd_rows,
                "raw_total": sum(r["total"] for r in osd_rows),
                "raw_used": sum(r["used"] for r in osd_rows),
                "stats_available": dig is not None}

    def _cmd_pool_stats(self, cmd: dict) -> dict:
        """`ceph osd pool stats [pool]`: per-pool client IO and
        recovery rates."""
        rows = self._pool_digest_rows()
        want = cmd.get("pool")
        if want:
            rows = [r for r in rows if r["name"] == want]
            if not rows:
                raise ValueError("pool %r does not exist" % want)
        return {"pools": rows}

    def _pool_id(self, name: str) -> int:
        for pid, pool in self.osdmap.pools.items():
            if pool.name == name:
                return pid
        raise ValueError("pool %r does not exist" % name)

    def _cmd_pool_create(self, cmd: dict) -> dict:
        name = cmd["pool"]
        for pool in self.osdmap.pools.values():
            if pool.name == name:
                return {"pool_id": pool.id}  # idempotent
        ptype = cmd.get("pool_type", "replicated")
        pid = max(self.osdmap.pool_max, 0) + 1
        if self.pending_inc is not None and self.pending_inc.new_pools:
            pid = max(pid, max(self.pending_inc.new_pools) + 1)
        conf = self.ctx.conf
        pg_num = int(cmd.get("pg_num",
                             conf["osd_pool_default_pg_num"]))
        if ptype == "erasure":
            pname = cmd.get("erasure_code_profile", "default")
            profile = self.osdmap.erasure_code_profiles.get(pname)
            if profile is None and pname == "default":
                profile = dict(DEFAULT_EC_PROFILE)
                self._pending().new_erasure_code_profiles[pname] = \
                    profile
            if profile is None:
                raise ValueError("no erasure profile %r" % pname)
            k = int(profile.get("k", 2))
            m = int(profile.get("m", 1))
            n = k + m
            try:
                # the codec is the authority on shard count: LRC's
                # mapping adds local parities beyond k+m, so sizing
                # from the profile ints would under-provision the
                # acting set
                from ..ec.plugin import ErasureCodePluginRegistry
                codec = ErasureCodePluginRegistry.instance().factory(
                    profile.get("plugin", "jerasure"), dict(profile))
                k = codec.get_data_chunk_count()
                n = codec.get_chunk_count()
            except Exception:
                pass
            pool = PGPool(id=pid, name=name, type=POOL_TYPE_ERASURE,
                          size=n, min_size=k, pg_num=pg_num,
                          crush_rule=int(cmd.get("crush_rule", 1)),
                          erasure_code_profile=pname)
        else:
            pool = PGPool(id=pid, name=name,
                          type=POOL_TYPE_REPLICATED,
                          size=int(cmd.get("size",
                                           conf["osd_pool_default_size"])),
                          min_size=conf["osd_pool_default_min_size"],
                          pg_num=pg_num,
                          crush_rule=int(cmd.get("crush_rule", 0)))
        inc = self._pending()
        inc.new_pools[pid] = pool
        self._propose_pending()
        self.log_mon.append(
            "INF", "pool '%s' created (id %d, %s, pg_num %d)"
            % (name, pid, ptype, pg_num))
        return {"pool_id": pid}

    # -- snapshots (OSDMonitor pool snap / selfmanaged snap commands,
    # src/mon/OSDMonitor.cc prepare_command pool mksnap/rmsnap and
    # blocked-by-pool-type checks; snapids are pool-global and shared
    # between pool snaps and selfmanaged snaps, pg_pool_t::snap_seq) --

    def _pool_pending_copy(self, pid: int):
        """Deep copy of the pool folding in any not-yet-committed
        pending mutation (two snap creates in one proposal window must
        not hand out the same snapid)."""
        import copy
        base = None
        if self.pending_inc is not None:
            base = self.pending_inc.new_pools.get(pid)
        if base is None:
            base = self.osdmap.pools[pid]
        return copy.deepcopy(base)

    def _cmd_pool_mksnap(self, cmd: dict) -> dict:
        pid = self._pool_id(cmd["pool"])
        snapname = cmd["snap"]
        pool = self._pool_pending_copy(pid)
        if snapname in pool.snaps.values():
            sid = next(s for s, n in pool.snaps.items()
                       if n == snapname)
            return {"snapid": sid}     # idempotent
        sid = pool.snap_seq + 1
        pool.snap_seq = sid
        pool.snaps[sid] = snapname
        pool.last_change = self.osdmap.epoch + 1
        inc = self._pending()
        inc.new_pools[pid] = pool
        self._propose_pending()
        return {"snapid": sid}

    def _cmd_pool_rmsnap(self, cmd: dict) -> dict:
        pid = self._pool_id(cmd["pool"])
        snapname = cmd["snap"]
        pool = self._pool_pending_copy(pid)
        sid = next((s for s, n in pool.snaps.items()
                    if n == snapname), None)
        if sid is None:
            raise ValueError("snap %r does not exist" % snapname)
        del pool.snaps[sid]
        pool.removed_snaps.append(sid)
        pool.last_change = self.osdmap.epoch + 1
        inc = self._pending()
        inc.new_pools[pid] = pool
        self._propose_pending()
        return {}

    def _cmd_selfmanaged_snap_create(self, cmd: dict) -> dict:
        pid = self._pool_id(cmd["pool"])
        pool = self._pool_pending_copy(pid)
        sid = pool.snap_seq + 1
        pool.snap_seq = sid
        pool.last_change = self.osdmap.epoch + 1
        inc = self._pending()
        inc.new_pools[pid] = pool
        self._propose_pending()
        return {"snapid": sid}

    def _cmd_selfmanaged_snap_rm(self, cmd: dict) -> dict:
        pid = self._pool_id(cmd["pool"])
        sid = int(cmd["snapid"])
        pool = self._pool_pending_copy(pid)
        if sid in pool.removed_snaps:
            return {}
        pool.removed_snaps.append(sid)
        pool.snaps.pop(sid, None)
        pool.last_change = self.osdmap.epoch + 1
        inc = self._pending()
        inc.new_pools[pid] = pool
        self._propose_pending()
        return {}

    def _cmd_pool_set(self, cmd: dict) -> dict:
        pid = self._pool_id(cmd["pool"])
        import copy

        pool = copy.copy(self.osdmap.pools[pid])
        key, val = cmd["var"], cmd["val"]
        if key == "size":
            pool.size = int(val)
        elif key == "min_size":
            pool.min_size = int(val)
        elif key == "pg_num":
            # growth only, and pgp_num stays: children keep their
            # parent's placement (OSDs split in place — the reference
            # workflow of raising pg_num first, pgp_num later).  A
            # shrink would need PG merge machinery this build lacks.
            if int(val) < pool.pg_num:
                raise ValueError("pg_num can only grow "
                                 "(%d -> %s)" % (pool.pg_num, val))
            pool.pg_num = int(val)
        elif key == "pgp_num":
            if not 0 < int(val) <= pool.pg_num:
                raise ValueError("pgp_num must be in (0, pg_num]")
            pool.pgp_num = int(val)
        elif key == "erasure_code_profile":
            # profile swap: only onto a profile with the identical
            # coding parameters (same k/m/technique/w => same matrix).
            # Swapping the matrix under stored shards would corrupt
            # every future reconstruction; this is the rename/rollout
            # path (new profile object, same math), which exercises
            # codec-cache invalidation on every OSD.
            new = self.osdmap.erasure_code_profiles.get(str(val))
            if new is None:
                raise ValueError("no erasure profile %r" % val)
            if not pool.erasure_code_profile:
                raise ValueError("pool %s is not erasure" % pool.name)
            cur = self.osdmap.erasure_code_profiles.get(
                pool.erasure_code_profile, {})
            for fld in ("plugin", "k", "m", "technique", "w"):
                if str(cur.get(fld, "")) != str(new.get(fld, "")):
                    raise ValueError(
                        "profile %r differs from the pool's in %r — "
                        "swap requires identical coding parameters"
                        % (val, fld))
            pool.erasure_code_profile = str(val)
        elif key == "crush_rule":
            pool.crush_rule = int(val)
        elif key == "compression_mode":
            if val not in ("none", "force"):
                raise ValueError("compression_mode: none|force")
            pool.compression_mode = val
        elif key == "compression_algorithm":
            from ..compress import available

            if val not in available():
                raise ValueError("no compressor %r (have %s)"
                                 % (val, available()))
            pool.compression_algorithm = val
        elif key == "dedup_chunk_pool":
            if val in ("", "none", "-1", -1):
                pool.dedup_chunk_pool = -1
            else:
                cid = self._pool_id(str(val))
                chunk = self.osdmap.pools[cid]
                # the chunk store must be a plain replicated pool:
                # content-addressed chunk bytes under compression or
                # EC stripes would break the scrub's fingerprint
                # verification, and a dedup'd chunk pool would recurse
                if cid == pid:
                    raise ValueError("pool cannot dedup into itself")
                if pool.is_erasure() \
                        or pool.compression_mode != "none":
                    raise ValueError(
                        "dedup requires a plain replicated base pool"
                        " (no EC, compression off)")
                if chunk.is_erasure() \
                        or chunk.compression_mode != "none" \
                        or chunk.dedup_chunk_pool >= 0:
                    raise ValueError(
                        "chunk pool must be plain replicated"
                        " (no EC/compression/dedup)")
                pool.dedup_chunk_pool = cid
        else:
            raise ValueError("cannot set %r" % key)
        pool.last_change = self.osdmap.epoch + 1
        inc = self._pending()
        inc.new_pools[pid] = pool
        self._propose_pending()
        if key == "erasure_code_profile":
            self.log_mon.append(
                "INF", "pool '%s' erasure profile rolled to '%s'"
                % (pool.name, val))
        return {}


# state-mutating command prefixes that leave an audit-channel clog
# entry (the reference mon logs every command to the audit channel;
# read-only polls are exempt here — each audit entry costs a paxos
# commit)
_AUDIT_PREFIXES = frozenset((
    "osd pool create", "osd pool rm", "osd pool set",
    "osd erasure-code-profile set", "osd out", "osd in", "osd down",
    "osd pool mksnap", "osd pool rmsnap", "osd snap create",
    "osd snap rm", "config set", "config rm", "crash archive",
    "crash archive-all", "crash rm", "mgr register",
))
