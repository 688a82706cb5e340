"""Paxos commit log over a KeyValueDB.

The reference's monitor consensus (src/mon/Paxos.{h,cc}): one Paxos
instance per monitor replicates a single totally-ordered log of
transaction blobs; services (OSDMonitor etc.) encode their pending
state into one blob per round and apply it on commit
(src/mon/PaxosService.cc propose_pending -> Paxos::propose_new_value).

Store layout mirrors the reference (Paxos.cc get_store() keys):
    paxos:first_committed / paxos:last_committed  (u64 as denc int)
    paxos:<version>                               (tx blob)
    paxos:accepted_pn / paxos:pending_v / paxos:pending_pn

This class implements the proposer/acceptor state machine for a quorum
of size 1 synchronously (the collect/begin/accept/commit round degrades
to: bump pn, write pending, commit) while keeping the phase structure
and durable bookkeeping, so the multi-mon message exchange
(OP_COLLECT/OP_BEGIN/OP_ACCEPT/OP_COMMIT/OP_LEASE, Paxos.h:24-104) can
be layered on without changing the storage contract or callers.
"""

from __future__ import annotations

import asyncio
from typing import Callable

from ..store.kv import KeyValueDB, KVTransaction
from ..utils import denc

PREFIX = b"paxos:"


def _k(name: str) -> bytes:
    return PREFIX + name.encode()


def _kv(version: int) -> bytes:
    return PREFIX + b"v%016d" % version


class Paxos:
    """Durable, ordered log of committed transaction blobs."""

    def __init__(self, store: KeyValueDB, rank: int = 0,
                 quorum: int = 1):
        self.store = store
        self.rank = rank
        self.quorum = quorum
        self.first_committed = self._get_int("first_committed", 0)
        self.last_committed = self._get_int("last_committed", 0)
        self.accepted_pn = self._get_int("accepted_pn", 0)
        # commit subscribers (the services' refresh hook)
        self.on_commit: list[Callable[[int, bytes], None]] = []

    # -- storage helpers ---------------------------------------------------

    def _get_int(self, name: str, default: int) -> int:
        raw = self.store.get(_k(name))
        return denc.decode(raw) if raw is not None else default

    def get_version(self, version: int) -> bytes | None:
        return self.store.get(_kv(version))

    # -- proposer ----------------------------------------------------------

    def _next_pn(self) -> int:
        """Proposal numbers are globally unique per rank
        (Paxos::get_new_proposal_number)."""
        pn = (self.accepted_pn // 100 + 1) * 100 + self.rank
        return pn

    def propose(self, blob: bytes) -> int:
        """Run one consensus round for the next version; returns the
        committed version.  Quorum of one: the collect/begin/accept
        phases are all local, but every durable step is taken in the
        same order as the reference so recovery semantics match."""
        # phase 1 (collect): adopt a higher pn
        pn = self._next_pn()
        self.accepted_pn = pn
        version = self.last_committed + 1
        tx = self.store.get_transaction()
        tx.set(_k("accepted_pn"), denc.encode(pn))
        # phase 2 (begin): persist the pending value
        tx.set(_k("pending_v"), denc.encode(version))
        tx.set(_k("pending_pn"), denc.encode(pn))
        tx.set(_kv(version), blob)
        self.store.submit_transaction(tx)
        # phase 3 (commit): quorum of one has already accepted
        tx = self.store.get_transaction()
        tx.set(_k("last_committed"), denc.encode(version))
        if self.first_committed == 0:
            self.first_committed = 1
            tx.set(_k("first_committed"), denc.encode(1))
        tx.rmkey(_k("pending_v"))
        tx.rmkey(_k("pending_pn"))
        self.store.submit_transaction(tx)
        self.last_committed = version
        for cb in self.on_commit:
            cb(version, blob)
        return version

    def recover(self) -> None:
        """Crash recovery: an uncommitted pending value at
        last_committed+1 is re-committed (quorum of one: it was
        accepted by a majority, namely us — Paxos.cc handle_last
        uncommitted handling)."""
        raw = self.store.get(_k("pending_v"))
        if raw is None:
            return
        version = denc.decode(raw)
        if version != self.last_committed + 1:
            return
        blob = self.get_version(version)
        if blob is None:
            return
        tx = self.store.get_transaction()
        tx.set(_k("last_committed"), denc.encode(version))
        tx.rmkey(_k("pending_v"))
        tx.rmkey(_k("pending_pn"))
        self.store.submit_transaction(tx)
        self.last_committed = version
        for cb in self.on_commit:
            cb(version, blob)

    def trim(self, keep: int = 500) -> None:
        """Drop log entries older than keep versions
        (Paxos::trim, paxos_max_join_drift semantics simplified)."""
        floor = self.last_committed - keep
        if floor <= self.first_committed:
            return
        tx = self.store.get_transaction()
        tx.rm_range(_kv(self.first_committed), _kv(floor))
        tx.set(_k("first_committed"), denc.encode(floor))
        self.store.submit_transaction(tx)
        self.first_committed = floor

    # -- storage steps shared with the multi-mon protocol ------------------

    def store_pending(self, version: int, pn: int, blob: bytes) -> None:
        """OP_BEGIN's durable step on every quorum member."""
        tx = self.store.get_transaction()
        tx.set(_k("accepted_pn"), denc.encode(pn))
        tx.set(_k("pending_v"), denc.encode(version))
        tx.set(_k("pending_pn"), denc.encode(pn))
        tx.set(_kv(version), blob)
        self.store.submit_transaction(tx)
        self.accepted_pn = pn

    def store_commit(self, version: int, blob: bytes) -> None:
        """OP_COMMIT's durable step; fires the service refresh hook."""
        if version <= self.last_committed:
            return
        tx = self.store.get_transaction()
        tx.set(_kv(version), blob)
        tx.set(_k("last_committed"), denc.encode(version))
        if self.first_committed == 0:
            self.first_committed = 1
            tx.set(_k("first_committed"), denc.encode(1))
        tx.rmkey(_k("pending_v"))
        tx.rmkey(_k("pending_pn"))
        self.store.submit_transaction(tx)
        self.last_committed = version
        for cb in self.on_commit:
            cb(version, blob)

    def store_accepted_pn(self, pn: int) -> None:
        tx = self.store.get_transaction()
        tx.set(_k("accepted_pn"), denc.encode(pn))
        self.store.submit_transaction(tx)
        self.accepted_pn = pn

    def uncommitted(self) -> tuple[int, int, bytes] | None:
        """(version, pn, blob) of a pending-but-uncommitted value."""
        raw = self.store.get(_k("pending_v"))
        if raw is None:
            return None
        version = denc.decode(raw)
        if version != self.last_committed + 1:
            return None
        blob = self.get_version(version)
        if blob is None:
            return None
        pn = self._get_int("pending_pn", self.accepted_pn)
        return version, pn, blob


class PaxosRound:
    """Leader-side bookkeeping for one collect or begin phase."""

    __slots__ = ("pn", "version", "acks", "done", "uncommitted",
                 "peer_max_lc", "superseded")

    def __init__(self, pn: int, version: int | None = None):
        self.pn = pn
        self.version = version
        self.acks: set[int] = set()
        self.done = asyncio.Future()
        self.uncommitted: tuple[int, int, bytes] | None = None
        self.peer_max_lc = 0
        # highest accepted_pn a peer reported ABOVE our pn: a reign
        # we were partitioned through promised higher — retry the
        # collect from a pn past it (Paxos.cc handle_collect OP_LAST
        # with higher pn semantics)
        self.superseded = 0


class MultiPaxos:
    """The OP_COLLECT/OP_LAST/OP_BEGIN/OP_ACCEPT/OP_COMMIT/OP_LEASE
    exchange (Paxos.h:24-104) over a quorum, layered on the durable
    Paxos storage contract.

    The Monitor drives it: `mon` supplies rank, quorum membership and
    send_paxos(rank, op, **fields).  Only the elected leader proposes;
    peons answer collects/begins and learn commits.  The leader extends
    a read lease to the quorum (OP_LEASE); a monitor without a live
    lease (and not the leader) refuses consistent reads, which is what
    makes a partitioned minority unusable (Paxos.h lease comments)."""

    LEASE = 5.0
    LEASE_RENEW = 2.0

    def __init__(self, mon, paxos: Paxos):
        self.mon = mon
        self.px = paxos
        self.active = False          # leader: recovery done
        self.lease_until = 0.0       # peon: leader's lease
        self._round: PaxosRound | None = None
        self._reign_pn = 0           # pn latched by OUR collect phase
        self._lease_task = None
        self._lock = asyncio.Lock()

    # -- quorum helpers ----------------------------------------------------

    def _peers(self):
        return [r for r in self.mon.quorum_ranks()
                if r != self.mon.rank]

    def _majority(self) -> int:
        return len(self.mon.monmap) // 2 + 1

    # -- leader ------------------------------------------------------------

    async def leader_collect(self, reign_epoch: int | None = None
                             ) -> None:
        """Recovery phase after winning an election.  Retries with a
        higher pn when a peer's OP_LAST reveals a bigger accepted_pn
        (an interim reign we were partitioned through promised past
        us — without the retry every collect is silently ignored and
        recovery livelocks in 10s election churn).  ``reign_epoch``
        fences stale queued collects: if another election superseded
        this reign while we waited for the lock, abort instead of
        collecting for a dead reign."""
        async with self._lock:
            el = getattr(self.mon, "elector", None)
            for _attempt in range(4):
                if el is not None and reign_epoch is not None \
                        and el.epoch != reign_epoch:
                    raise IOError("paxos: reign superseded")
                pn = self.px._next_pn()
                self.px.store_accepted_pn(pn)
                # Latch this reign's pn: _begin proposes at exactly
                # this pn and refuses if a rival collect has moved
                # accepted_pn past it (Paxos.cc keeps begin at the
                # collect-phase pn; a stale co-leader re-using a
                # rival's pn could otherwise commit a different value
                # at the same version — split brain).
                self._reign_pn = pn
                rnd = PaxosRound(pn)
                rnd.acks.add(self.mon.rank)
                self._round = rnd
                for r in self._peers():
                    self.mon.send_paxos(
                        r, "collect", pn=pn,
                        last_committed=self.px.last_committed,
                        first_committed=self.px.first_committed)
                if len(rnd.acks) < self._majority():
                    await asyncio.wait_for(rnd.done, timeout=10.0)
                if rnd.superseded > pn:
                    # adopt the higher promise base and re-collect
                    self.px.store_accepted_pn(rnd.superseded)
                    continue
                # a peer ahead of us means a previous reign committed
                # past our log: its OP_LAST triggered a catch-up; wait
                # for those commits to land before taking over
                # (otherwise we would re-propose a stale value at an
                # already-taken version and livelock in election churn)
                deadline = asyncio.get_event_loop().time() + 10.0
                while self.px.last_committed < rnd.peer_max_lc:
                    if asyncio.get_event_loop().time() > deadline:
                        self._round = None
                        raise IOError("paxos: catch-up from peers "
                                      "timed out")
                    await asyncio.sleep(0.05)
                # re-propose any uncommitted value from the prior reign
                unc = rnd.uncommitted or self.px.uncommitted()
                self._round = None
                self.active = True
                if unc is not None \
                        and unc[0] == self.px.last_committed + 1:
                    await self._begin(unc[2])
                self._start_lease()
                return
            self._round = None
            raise IOError("paxos: collect lost %d pn races" % 4)

    async def propose(self, blob: bytes) -> int:
        """Leader-only: replicate one value; returns its version."""
        async with self._lock:
            if not self.active:
                raise IOError("paxos: not active (no quorum)")
            return await self._begin(blob)

    async def _begin(self, blob: bytes) -> int:
        pn = self._reign_pn
        if self.px.accepted_pn != pn:
            # a rival leader's collect superseded our reign between our
            # collect and this begin: abdicate instead of proposing at
            # a pn we no longer own
            self.active = False
            raise IOError("paxos: deposed (accepted_pn %d > reign %d)"
                          % (self.px.accepted_pn, pn))
        version = self.px.last_committed + 1
        self.px.store_pending(version, pn, blob)
        rnd = PaxosRound(pn, version)
        rnd.acks.add(self.mon.rank)
        self._round = rnd
        for r in self._peers():
            self.mon.send_paxos(r, "begin", pn=pn, version=version,
                                blob=blob)
        if len(rnd.acks) < self._majority():
            try:
                await asyncio.wait_for(rnd.done, timeout=10.0)
            except asyncio.TimeoutError:
                self._round = None
                self.active = False
                raise IOError("paxos: lost quorum during begin")
        self._round = None
        self.px.store_commit(version, blob)
        for r in self._peers():
            self.mon.send_paxos(r, "commit", version=version,
                                blob=blob)
        return version

    def _start_lease(self) -> None:
        if self._lease_task is None or self._lease_task.done():
            self._lease_task = self.mon.msgr.spawn(self._lease_loop())

    async def _lease_loop(self) -> None:
        while self.active and self.mon.is_leader():
            until = asyncio.get_event_loop().time() + self.LEASE
            self.lease_until = until
            for r in self._peers():
                self.mon.send_paxos(r, "lease", lease_until=until,
                                    last_committed=self.px.last_committed)
            await asyncio.sleep(self.LEASE_RENEW)

    # -- peon --------------------------------------------------------------

    def _send_commits_since(self, rank: int, peer_lc: int) -> None:
        """Share committed values a lagging peer is missing (the
        reference's share_state), in version order."""
        for v in range(peer_lc + 1, self.px.last_committed + 1):
            blob = self.px.get_version(v)
            if blob is not None:
                self.mon.send_paxos(rank, "commit", version=v,
                                    blob=blob)

    def handle(self, src_rank: int, op: str, f: dict) -> None:
        # Reign fencing (Paxos.cc checks mon->get_epoch() on every
        # phase message): drop messages stamped with a stale election
        # epoch, and leader-authority ops from anyone who is not the
        # leader we acknowledged — a deposed leader that missed the new
        # VICTORY cannot push begins/leases at a majority.
        el = getattr(self.mon, "elector", None)
        if el is not None:
            epoch = f.get("epoch") or 0
            # commit carries an already-chosen value (always safe to
            # learn); catchup merely requests commits — both pass so a
            # restarted mon with a stale epoch can still converge
            if op not in ("commit", "catchup") and epoch < el.epoch:
                return
            if op == "lease" and epoch > el.epoch:
                # a steady-state leadership assertion from a reign we
                # never elected: we were partitioned through a regime
                # change — rejoin via a fresh election (heals the
                # stale-ex-leader split brain, whose subscribers
                # would otherwise never see the newer reign's maps).
                # Only leases trigger this: in-flight round messages
                # (collect/last/begin/accept) can legitimately carry
                # a newer stamp mid-election, and re-electing on them
                # would churn instead of converge.
                el.note_newer_reign(epoch)
                return
            if op in ("begin", "lease") and epoch == el.epoch \
                    and el.leader is not None \
                    and src_rank != el.leader:
                return
        if op == "collect":
            pn = f["pn"]
            promised = pn > self.px.accepted_pn
            if promised:
                self.px.store_accepted_pn(pn)
            unc = self.px.uncommitted() if promised else None
            # ALWAYS reply, echoing our accepted_pn: a silent refusal
            # of a low pn (a healed ex-leader whose pn generator never
            # saw the interim reign's promises) would livelock its
            # recovery — the reply lets it retry from a higher pn
            self.mon.send_paxos(
                src_rank, "last", pn=pn,
                last_committed=self.px.last_committed,
                accepted_pn=self.px.accepted_pn,
                uncommitted=(list(unc[:2]) + [unc[2]]
                             if unc else None))
        elif op == "last":
            rnd = self._round
            if rnd is None or f["pn"] != rnd.pn:
                return
            apn = f.get("accepted_pn") or 0
            if apn > rnd.pn:
                # the peer promised a higher reign than our collect:
                # no promise for us — retry past its pn
                rnd.superseded = max(rnd.superseded, apn)
                if not rnd.done.done():
                    rnd.done.set_result(None)
                return
            rnd.acks.add(src_rank)
            unc = f.get("uncommitted")
            if unc is not None:
                v, pn_u, blob = unc[0], unc[1], unc[2]
                cur = rnd.uncommitted
                if v == self.px.last_committed + 1 and (
                        cur is None or pn_u > cur[1]):
                    rnd.uncommitted = (v, pn_u, blob)
            peer_lc = f.get("last_committed", 0)
            if peer_lc > self.px.last_committed:
                # the peer's reign committed past us: pull its commits
                # before we act as leader (leader_collect waits)
                rnd.peer_max_lc = max(rnd.peer_max_lc, peer_lc)
                self.mon.request_catchup(src_rank)
            else:
                # catch a lagging peon up with committed values
                self._send_commits_since(src_rank, peer_lc)
            if len(rnd.acks) >= self._majority() \
                    and not rnd.done.done():
                rnd.done.set_result(None)
        elif op == "begin":
            if f["pn"] >= self.px.accepted_pn:
                # catch up any gap first (commits may have been lost
                # with a dead connection)
                if f["version"] > self.px.last_committed + 1:
                    self.mon.request_catchup(src_rank)
                    return
                if f["version"] == self.px.last_committed + 1:
                    self.px.store_pending(f["version"], f["pn"],
                                          f["blob"])
                    self.mon.send_paxos(src_rank, "accept",
                                        pn=f["pn"],
                                        version=f["version"])
        elif op == "accept":
            rnd = self._round
            if rnd is None or f["pn"] != rnd.pn \
                    or f.get("version") != rnd.version:
                # a delayed accept from an earlier begin (same reign,
                # same pn) must not count toward this round's majority
                return
            rnd.acks.add(src_rank)
            if len(rnd.acks) >= self._majority() \
                    and not rnd.done.done():
                rnd.done.set_result(None)
        elif op == "commit":
            if f["version"] > self.px.last_committed + 1:
                # gap (a commit broadcast overtook a lost one): pull
                # the missing range instead of skipping versions —
                # store_commit would advance last_committed past the
                # hole and the osdmap would freeze at the gap epoch
                self.mon.request_catchup(src_rank)
                return
            self.px.store_commit(f["version"], f["blob"])
        elif op == "lease":
            self.lease_until = max(self.lease_until, f["lease_until"])
            if self.mon.elector is not None:
                self.mon.elector.note_leader_alive()
            if f.get("last_committed", 0) > self.px.last_committed:
                self.mon.request_catchup(src_rank)
        elif op == "catchup":
            # a peer asks for commits it is missing
            self._send_commits_since(src_rank,
                                     f.get("last_committed", 0))

    def lease_valid(self) -> bool:
        return (asyncio.get_event_loop().time() < self.lease_until)
