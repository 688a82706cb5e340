"""Monitor leader election: classic, disallow, and connectivity
strategies.

Analog of src/mon/Elector.h + ElectionLogic.cc:

* CLASSIC — the lowest-ranked monitor that can reach a majority wins.
* DISALLOW — classic, but ranks named in mon_disallowed_leaders never
  lead (they defer, never propose; ElectionLogic handle "disallowed").
* CONNECTIVITY — candidates are ranked by how well the QUORUM can
  reach them (ElectionLogic.cc:332 propose_connectivity_handler):
  every monitor keeps a decaying per-peer connectivity score
  (ConnectionTracker role), reports are GOSSIPED inside election
  messages with per-reporter versions, and a voter defers to the
  proposer whose aggregate score (mean of all reporters' views) is
  higher — rank only breaks near-ties.  Scores persist in the mon
  store (Elector.h:278 persist_connectivity_scores) so a restarted
  monitor remembers who was flaky.

Epochs are odd while electing and even when stable
(ElectionLogic::bump_epoch semantics); every PROPOSE carries the
proposer's epoch so stale rounds are ignored, DEFER (ack) goes to the
best candidate seen this round, and a proposer declares VICTORY once
a majority (including itself) has deferred.  Losing contact with the
leader (or a victory timeout) restarts the election with a bumped
epoch.
"""

from __future__ import annotations

import asyncio

ELECTING = "electing"
LEADER = "leader"
PEON = "peon"

PROPOSE = "propose"
DEFER = "defer"
VICTORY = "victory"

CLASSIC = "classic"
DISALLOW = "disallow"
CONNECTIVITY = "connectivity"

_SCORES_KEY = b"elector:scores"


class ConnectionTracker:
    """Decaying per-peer connectivity scores with gossip merge
    (src/mon/ConnectionTracker.h).

    Each monitor owns ONE report: {peer rank: score in [0,1]} plus a
    version; election traffic carries every report a node has seen,
    and receivers keep the freshest per reporter.  A candidate's
    aggregate score is the mean of all reporters' views of it, so a
    monitor that half the cluster cannot reach scores low everywhere
    once gossip spreads."""

    DECAY = 0.5         # per-tick multiplier for unseen peers
    FLOOR = 0.001

    def __init__(self, rank: int, store=None, n_ranks: int = 0):
        self.rank = rank
        self.store = store
        self.reports: dict[int, dict] = {}
        self._seen: set[int] = set()     # peers heard from this tick
        self._ticks = 0                  # boot grace (see tick())
        self._load()
        mine = self.reports.setdefault(
            rank, {"v": 0, "scores": {}})
        mine["scores"][rank] = 1.0
        # seed EVERY monmap rank so tick() decays peers that go
        # silent without a transport reset (a blackholed peer must
        # not keep its perfect score just because lost() never fired)
        for r in range(n_ranks):
            mine["scores"].setdefault(r, 1.0)

    # -- observation --------------------------------------------------------

    def saw(self, rank: int) -> None:
        """A message arrived from this peer: it is reachable now."""
        if rank == self.rank:
            return
        self._seen.add(rank)
        mine = self.reports[self.rank]
        cur = mine["scores"].get(rank, 1.0)
        if cur != 1.0:
            # gradual recovery (halfway per receipt): a peer dropping
            # half its traffic oscillates well below 1.0 instead of
            # snapping healthy on every delivered message — that gap
            # is what lets the strategy demote FLAKY monitors, not
            # just fully-partitioned ones
            mine["scores"][rank] = min(1.0, cur * 0.5 + 0.5)
            mine["v"] += 1
            self._persist()

    def lost(self, rank: int) -> None:
        """Transport to the peer reset: degrade immediately."""
        mine = self.reports[self.rank]
        cur = mine["scores"].get(rank, 1.0)
        mine["scores"][rank] = max(self.FLOOR, cur * self.DECAY)
        mine["v"] += 1
        self._persist()

    def tick(self) -> None:
        """Decay every peer not heard from since the last tick, then
        persist (the reference decays on a halflife; one multiplier
        per tick is the same shape).  The first few ticks are a BOOT
        GRACE: monitors start staggered, and decaying peers that
        simply have not finished booting makes every monitor's view
        diverge at once — contradictory candidate preferences then
        churn the very first election for many rounds."""
        self._ticks += 1
        if self._ticks <= 5:
            self._seen.clear()
            return
        mine = self.reports[self.rank]
        changed = False
        for r, s in list(mine["scores"].items()):
            if r == self.rank or r in self._seen:
                continue
            ns = max(self.FLOOR, s * self.DECAY)
            if ns != s:
                mine["scores"][r] = ns
                changed = True
        self._seen.clear()
        if changed:
            mine["v"] += 1
            self._persist()

    # -- gossip -------------------------------------------------------------

    def wire(self) -> dict:
        return {str(r): {"v": rep["v"],
                         "scores": {str(p): s
                                    for p, s in rep["scores"].items()}}
                for r, rep in self.reports.items()}

    def merge(self, wire: dict | None) -> None:
        for r_s, rep in (wire or {}).items():
            r = int(r_s)
            if r == self.rank:
                continue            # nobody overwrites MY report
            cur = self.reports.get(r)
            if cur is None or rep["v"] > cur["v"]:
                self.reports[r] = {
                    "v": rep["v"],
                    "scores": {int(p): float(s)
                               for p, s in rep["scores"].items()}}

    def aggregate(self, rank: int) -> float:
        """Mean of every reporter's view of ``rank`` (the candidate's
        cluster-wide reachability)."""
        views = [rep["scores"][rank]
                 for rep in self.reports.values()
                 if rank in rep["scores"]]
        return sum(views) / len(views) if views else 1.0

    # -- persistence --------------------------------------------------------

    def _persist(self) -> None:
        if self.store is None:
            return
        from ..utils import denc

        tx = self.store.get_transaction()
        tx.set(_SCORES_KEY, denc.encode(self.wire()))
        self.store.submit_transaction(tx, sync=False)

    def _load(self) -> None:
        if self.store is None:
            return
        from ..utils import denc

        raw = self.store.get(_SCORES_KEY)
        if raw is None:
            return
        try:
            for r_s, rep in denc.decode(raw).items():
                self.reports[int(r_s)] = {
                    "v": rep["v"],
                    "scores": {int(p): float(s)
                               for p, s in rep["scores"].items()}}
        except Exception:
            self.reports = {}


class Elector:
    def __init__(self, mon, timeout: float = 2.0,
                 strategy: str = CLASSIC,
                 disallowed: set[int] | None = None):
        self.mon = mon                  # Monitor: rank, peers, send
        self.timeout = timeout
        self.strategy = strategy
        self.disallowed = set(disallowed or ())
        # the tracker persists (and is even consulted) only under the
        # connectivity strategy — classic clusters pay no per-message
        # KV writes or gossip bytes for scores they never read
        self.tracker = ConnectionTracker(
            mon.rank,
            getattr(mon, "store", None)
            if strategy == CONNECTIVITY else None,
            n_ranks=len(getattr(mon, "monmap", [])))
        self.stopped = False
        self.epoch = 1
        self.state = ELECTING
        self.leader: int | None = None
        self.quorum: set[int] = set()
        self.deferred_to: int | None = None
        self._defers: set[int] = set()
        self._timer: asyncio.TimerHandle | None = None

    # -- helpers -----------------------------------------------------------

    def _majority(self) -> int:
        return len(self.mon.monmap) // 2 + 1

    def _allowed(self, rank: int) -> bool:
        return rank not in self.disallowed

    def _prefer(self, a: int, b: int) -> bool:
        """True when candidate ``a`` should lead over ``b``.  Classic
        and disallow rank by id; connectivity ranks by aggregate
        reachability, id breaking near-ties.  The margin must damp
        boot-time score jitter (two monitors with diverging views
        each preferring themselves would livelock a round) yet SCALE
        with cluster size: the aggregate is a mean over n reporters,
        so one fully-partitioned link moves it by ~1/n — a fixed
        margin would mask real partitions in larger quorums.  0.5/n
        sits halfway between jitter and a single dead link."""
        if self.strategy == CONNECTIVITY:
            sa, sb = (self.tracker.aggregate(a),
                      self.tracker.aggregate(b))
            margin = 0.5 / max(2, len(self.mon.monmap))
            if abs(sa - sb) > margin:
                return sa > sb
        return a < b

    def _bump(self, to_epoch: int | None = None, electing=True) -> None:
        e = max(self.epoch + 1, to_epoch or 0)
        if electing and e % 2 == 0:
            e += 1
        if not electing and e % 2 == 1:
            e += 1
        self.epoch = e

    def _arm_timer(self) -> None:
        self._cancel_timer()
        loop = asyncio.get_event_loop()
        self._timer = loop.call_later(self.timeout, self._on_timeout)

    def _cancel_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    # -- rounds ------------------------------------------------------------

    def stop(self) -> None:
        """Shutdown: a dead monitor must not keep proposing (a zombie
        lowest-rank proposer would collect defers it can never see and
        livelock the survivors)."""
        self.stopped = True
        self._cancel_timer()

    def note_newer_reign(self, epoch: int) -> None:
        """A PAXOS message arrived stamped with an election epoch
        newer than any election we took part in: a regime change
        happened while we were partitioned away (our LEADER/PEON
        state is stale — a healed ex-leader would otherwise sit in a
        split brain forever, serving stale reads and never publishing
        newer maps to its subscribers).  Adopt the newer epoch and
        force a fresh election so leadership reconverges (the
        reference's Monitor epoch-mismatch -> bump_epoch path)."""
        if self.stopped or epoch <= self.epoch:
            return
        self.mon.ctx.log.info(
            "mon", "%s: saw reign epoch %d > ours %d (healed "
            "partition?): re-electing" % (self.mon.name, epoch,
                                          self.epoch))
        self._bump(to_epoch=epoch, electing=True)
        self.state = ELECTING
        self.leader = None
        self.quorum = set()
        self.deferred_to = None
        self._defers = set()
        self.mon.on_lose(-1, self.epoch)
        self.start_election()

    def note_leader_alive(self) -> None:
        """Peon liveness watchdog: each lease receipt re-arms a timer;
        if leases stop (a wedged-but-connected leader that never
        triggers peer_lost), the timeout forces a new election."""
        if self.state == PEON and not self.stopped:
            self._cancel_timer()
            loop = asyncio.get_event_loop()
            self._timer = loop.call_later(3 * self.timeout,
                                          self._on_timeout)

    def start_election(self) -> None:
        if self.stopped:
            return
        if not self._allowed(self.mon.rank):
            # a disallowed monitor never proposes itself — and it
            # must NOT bump its epoch while waiting (nobody would see
            # the bump, so a few timeouts would race it permanently
            # ahead of the cluster and its DEFERs/VICTORYs would all
            # be dropped as epoch mismatches).  It waits at its
            # current epoch for an allowed candidate's PROPOSE.
            self.state = ELECTING
            self.leader = None
            self.quorum = set()
            self.deferred_to = None
            self._defers = set()
            self._arm_timer()
            return
        self._bump(electing=True)
        self.state = ELECTING
        self.leader = None
        self.quorum = set()
        self.deferred_to = self.mon.rank
        self._defers = {self.mon.rank}
        self.mon.ctx.log.debug(
            "mon", "%s election epoch %d: proposing"
            % (self.mon.name, self.epoch))
        self.mon.send_election(PROPOSE, self.epoch)
        self._arm_timer()
        self._maybe_win()

    def _on_timeout(self) -> None:
        if self.stopped:
            return
        if self.state == ELECTING:
            self.start_election()
        elif self.state == PEON and self.leader is not None:
            # leader lease lapsed: force a new round
            self.start_election()

    def _maybe_win(self) -> None:
        if (self.state == ELECTING
                and self.deferred_to == self.mon.rank
                and len(self._defers) >= self._majority()):
            self._declare_victory()

    def _declare_victory(self) -> None:
        self._bump(electing=False)
        self.state = LEADER
        self.leader = self.mon.rank
        self.quorum = set(self._defers)
        self._cancel_timer()
        self.mon.ctx.log.info(
            "mon", "%s won election epoch %d quorum %s"
            % (self.mon.name, self.epoch, sorted(self.quorum)))
        self.mon.send_election(VICTORY, self.epoch,
                               quorum=sorted(self.quorum))
        self.mon.on_win(self.epoch, self.quorum)

    # -- message handlers ---------------------------------------------------

    def handle(self, src_rank: int, op: str, epoch: int,
               quorum=None, scores=None) -> None:
        self.tracker.saw(src_rank)
        self.tracker.merge(scores)
        if op == "ping":
            return      # liveness probe: tracker.saw above is enough
        if op == PROPOSE:
            if epoch < self.epoch and self.state != ELECTING:
                # stale proposer (e.g. rejoining): poke it to catch up
                # by starting a fresh round it will see
                self.start_election()
                return
            if epoch > self.epoch:
                # a fresh round supersedes any stale defer state —
                # keeping it would suppress re-proposing and block
                # defers to better proposers at the new epoch
                self.epoch = epoch if epoch % 2 else epoch + 1
                self.state = ELECTING
                self.deferred_to = None
                self._defers = set()
            if self.state != ELECTING:
                return
            me = self.mon.rank
            i_can_lead = self._allowed(me)
            src_better = (not i_can_lead and self._allowed(src_rank)
                          ) or (self._allowed(src_rank)
                                and self._prefer(src_rank, me))
            if src_better:
                # defer to the better candidate — unless we already
                # acked someone at least as good this round
                if self.deferred_to is None \
                        or src_rank == self.deferred_to \
                        or self._prefer(src_rank, self.deferred_to):
                    self.deferred_to = src_rank
                    self.mon.send_election(DEFER, self.epoch,
                                           to_rank=src_rank)
                    self._arm_timer()
            else:
                # we are the better candidate: (re)propose ourselves —
                # but only if we have not already deferred this round
                # (ElectionLogic ignores worse proposals after acking
                # a better one — revoking the defer could hand two
                # proposers disjoint majorities in the same epoch)
                if self.deferred_to is None and i_can_lead:
                    self.deferred_to = me
                    self._defers = {me}
                    self.mon.send_election(PROPOSE, self.epoch)
                    self._arm_timer()
        elif op == DEFER:
            if epoch != self.epoch or self.state != ELECTING:
                return
            if self.deferred_to == self.mon.rank:
                self._defers.add(src_rank)
                self._maybe_win()
        elif op == VICTORY:
            if epoch < self.epoch:
                return
            self.epoch = epoch
            self.state = PEON
            self.leader = src_rank
            self.quorum = set(quorum or [])
            self._cancel_timer()
            self.mon.ctx.log.info(
                "mon", "%s: mon.%d leads epoch %d"
                % (self.mon.name, src_rank, epoch))
            self.note_leader_alive()
            self.mon.on_lose(src_rank, self.epoch)

    def peer_lost(self, rank: int) -> None:
        """A quorum member became unreachable: re-elect if it matters
        (the leader died, or we are the leader and lost majority)."""
        self.tracker.lost(rank)
        if self.state == PEON and rank == self.leader:
            self.start_election()
        elif self.state == LEADER and rank in self.quorum:
            self.quorum.discard(rank)
            if len(self.quorum) < self._majority():
                self.start_election()
