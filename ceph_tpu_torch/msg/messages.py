"""Concrete wire messages for the mon/osd/client protocol.

Analog of src/messages/* (MOSDOp.h, MOSDRepOp.h, MOSDMap.h,
MOSDBoot.h, MOSDFailure.h, MOSDPing.h, MMonCommand.h ...): the subset
the framework's daemons speak, with payloads as plain denc values.

Object-op lists inside MOSDOp/MOSDOpReply use dicts
{"op": name, ...} instead of the reference's numeric opcode union
(src/osd/osd_types.h OSDOp) — the OSD's do_osd_ops interpreter switches
on the name.
"""

from __future__ import annotations

from .message import Message, register


@register
class MPing(Message):
    TYPE = "ping"
    FIELDS = ("stamp",)


@register
class MPong(Message):
    TYPE = "pong"
    FIELDS = ("stamp",)


# -- monitor <-> monitor ---------------------------------------------------


@register
class MMonElection(Message):
    """Elector rounds (MMonElection.h): op = propose|defer|victory;
    scores gossips the sender's ConnectionTracker reports
    (connectivity strategy)."""
    TYPE = "mon_election"
    FIELDS = ("op", "epoch", "rank", "quorum", "scores")


@register
class MMonPaxos(Message):
    """Paxos phases (MMonPaxos.h): op = collect|last|begin|accept|
    commit|lease|catchup."""
    TYPE = "mon_paxos"
    FIELDS = ("op", "rank", "pn", "version", "blob", "last_committed",
              "first_committed", "lease_until", "uncommitted", "epoch",
              "accepted_pn")


# -- monitor <-> anyone ----------------------------------------------------


@register
class MMonGetMap(Message):
    """Request the cluster map: full if have < 0 else incrementals
    after `have` (MMonGetOSDMap.h)."""

    TYPE = "mon_get_map"
    FIELDS = ("have",)


@register
class MMonSubscribe(Message):
    """Subscribe to map publications from epoch `start` (MMonSubscribe.h)."""

    TYPE = "mon_subscribe"
    FIELDS = ("start",)


@register
class MOSDMapMsg(Message):
    """Map publication (MOSDMap.h): optional full map bytes plus a list
    of incremental bytes, each OSDMap/Incremental.encode() output."""

    TYPE = "osd_map"
    FIELDS = ("fsid", "full", "incrementals")


@register
class MOSDBoot(Message):
    """OSD -> mon: I'm up at this addr (MOSDBoot.h)."""

    TYPE = "osd_boot"
    FIELDS = ("osd", "addr", "epoch")


@register
class MOSDFailure(Message):
    """OSD -> mon failure report (MOSDFailure.h): target osd,
    seconds it has been unresponsive, reporter's map epoch."""

    TYPE = "osd_failure"
    FIELDS = ("target", "failed_for", "epoch")


@register
class MOSDBeacon(Message):
    """OSD -> mon liveness/health beacon (MOSDBeacon.h): periodic even
    while healthy; slow_ops carries the count of in-flight ops older
    than osd_op_complaint_time so the monitor can raise (and clear)
    the SLOW_OPS health warning; device_lost reports whether the
    daemon's mesh chip is lost (its ops fail until the probe heals it)
    and device_chip names that chip (the mon raises DEVICE_LOST while
    any live daemon reports it, with the chip in the health detail —
    only the OSDs bound to a lost chip are affected).  slow_tenants is the
    per-tenant slice of slow_ops ({tenant: count}; tenant-less ops
    fold under "") so the SLOW_OPS health detail can name the worst
    tenant; legacy beacons without it read as no tenant attribution.
    net carries the daemon's heartbeat RTT slice ({"rtt_ms":
    {peer: ms}, "slow": [peers]}) feeding the mon's
    OSD_SLOW_PING_TIME edge; beacons without it encode
    byte-identically to the pre-net wire form.
    """

    TYPE = "osd_beacon"
    FIELDS = ("osd", "epoch", "slow_ops", "slow_tenants",
              "device_lost", "device_chip", "net")

    def to_wire(self) -> dict:
        d = {f: getattr(self, f) for f in self.FIELDS}
        if d.get("net") is None:
            del d["net"]        # legacy beacons stay byte-stable
        return d


@register
class MOSDAlive(Message):
    """OSD -> mon: cancel my pending failure reports, and/or request
    an up_thru bump so a fresh primary can prove its interval could go
    read-write before activating (MOSDAlive.h want/version)."""

    TYPE = "osd_alive"
    FIELDS = ("osd", "epoch", "want_up_thru")


@register
class MConfig(Message):
    """mon -> daemon: the daemon's resolved centralized-config view
    (MConfig.h / ConfigMonitor push); values feed the config system's
    'mon' source layer."""

    TYPE = "config"
    FIELDS = ("values",)


@register
class MMgrReport(Message):
    """Daemon -> mgr perf/state report (MMgrReport.h via
    DaemonServer::handle_report): perf = the daemon's PerfCounters
    dump; pg_states = {state_name: count} for the PGs it is primary
    of; num_pgs/num_objects round out the health summary; pg_stats
    carries the per-PG stat rows of every PG the daemon is primary for
    (the MPGStats slice — object/byte counts, degraded/misplaced/
    unfound tallies, cumulative client-IO and recovery counters);
    osd_stats carries daemon-wide extras (the op-size histogram).

    pg_stats_cols is the packed columnar form of the same rows
    (msg.statblock: parallel typed arrays + dictionary-encoded pgids
    and states) — the telemetry-fabric wire format the mgr ingests
    as one vectorized merge.  A report carries EITHER pg_stats_cols
    (columnar producers) or pg_stats (legacy dict rows); the mgr
    accepts both, so mixed fleets converge to one digest.  Reports
    without the columnar field encode byte-identically to the
    pre-columnar wire form (legacy frames stay pinned)."""

    TYPE = "mgr_report"
    FIELDS = ("daemon", "epoch", "perf", "pg_states", "num_pgs",
              "num_objects", "pg_stats", "osd_stats", "pg_stats_cols")

    def to_wire(self) -> dict:
        d = {f: getattr(self, f) for f in self.FIELDS}
        if d.get("pg_stats_cols") is None:
            del d["pg_stats_cols"]      # legacy frames stay byte-stable
        return d


@register
class MMonMgrDigest(Message):
    """mgr -> mon PGMap digest (the reverse MMonMgrReport/
    MgrStatMonitor flow): per-pool usage + IO/recovery rates, the
    cluster pg-state summary, and the degraded/misplaced/unfound
    totals the mon folds into `status`, `df`, `osd pool stats` and
    the PG_DEGRADED / PG_AVAILABILITY health checks.  Broadcast to
    every mon (like beacons) so whichever mon leads next already
    holds the picture."""

    TYPE = "mon_mgr_digest"
    FIELDS = ("digest", "epoch")


@register
class MLog(Message):
    """Daemon -> mon cluster-log batch (MLog.h / LogClient flow):
    entries = [{seq, stamp, who, channel, level, message}, ...].
    Broadcast to every mon (like beacons); the leader commits unseen
    entries through paxos (LogMonitor dedups by (who, seq)) and the
    mon that observes the commit acks with MLogAck so the client can
    retire them.  Unacked entries are re-flushed periodically — a
    leader election between emit and commit loses nothing."""

    TYPE = "log"
    FIELDS = ("entries",)


@register
class MLogAck(Message):
    """mon -> daemon: entries of `who` up to seq `last` (of boot
    incarnation `inc`; absent = the daemon's only life) are
    paxos-committed (MLogAck.h)."""

    TYPE = "log_ack"
    FIELDS = ("who", "last", "inc")


@register
class MCrashReport(Message):
    """Daemon -> mon pending crash reports (the ceph-crash agent's
    POST, as a message): reports = [crash report dicts].  Broadcast to
    every mon; the leader commits unseen crash_ids into the
    paxos-committed crash table, and any mon that sees them committed
    acks their ids so the daemon can clear its store copy."""

    TYPE = "crash_report"
    FIELDS = ("reports",)


@register
class MCrashReportAck(Message):
    """mon -> daemon: these crash_ids are in the committed table."""

    TYPE = "crash_report_ack"
    FIELDS = ("crash_ids",)


@register
class MOSDPGTemp(Message):
    """OSD -> mon pg_temp request (MOSDPGTemp.h / OSDMonitor
    prepare_pgtemp): pgs = [[pool, ps, [osds...]], ...]; an empty osd
    list clears the mapping (PeeringState queue_want_pg_temp)."""

    TYPE = "osd_pg_temp"
    FIELDS = ("pgs", "epoch")


@register
class MMonWatchEvents(Message):
    """Client -> mon: subscribe to the committed event stream from
    cursor `start` (exclusive — the MMonSubscribe shape applied to
    the event bus).  Sent again with the current cursor to renew
    after a reconnect; the mon replies with any committed backlog
    past the cursor and pushes MMonEvents batches as commits land."""

    TYPE = "mon_watch_events"
    FIELDS = ("start",)


@register
class MMonEvents(Message):
    """mon -> watching client: committed event rows past the
    subscriber's cursor, seq-ascending ({seq, type, stamp, message,
    data?}); last_seq is the mon's committed top.  Seqs are assigned
    at paxos apply, so every mon streams the identical contiguous
    sequence — a client that re-subscribes elsewhere after an
    election resumes with no gaps and no duplicates."""

    TYPE = "mon_events"
    FIELDS = ("events", "last_seq")


@register
class MMonCommand(Message):
    """Generic admin command (MMonCommand.h): {"prefix": ..., args}."""

    TYPE = "mon_command"
    FIELDS = ("tid", "cmd")


@register
class MMonCommandAck(Message):
    TYPE = "mon_command_ack"
    FIELDS = ("tid", "result", "out")


# -- client <-> osd --------------------------------------------------------


@register
class MOSDOp(Message):
    """Client object op (MOSDOp.h): tid for reply matching; pgid the
    client computed; ops = [{"op": "write", "offset": o, "data": b}...];
    epoch = client's map epoch for gating."""

    TYPE = "osd_op"
    FIELDS = ("tid", "pool", "ps", "oid", "snapc", "snapid", "ops",
              "epoch", "flags")


@register
class MOSDOpReply(Message):
    TYPE = "osd_op_reply"
    FIELDS = ("tid", "result", "outs", "epoch", "version")


@register
class MOSDBackoff(Message):
    """OSD -> client PG backoff (MOSDBackoff.h / the osd_backoff
    machinery): op = "block" tells the client to stop re-sending ops
    that target the PG (it is peering / below min_size and the op is
    parked server-side); op = "unblock" releases it.  id is the OSD's
    monotonically increasing backoff id — an unblock releases only
    blocks with id <= its own, so a stale unblock cannot cancel a
    newer block.  oid narrows the backoff to ONE degraded object (the
    reference's hobject-ranged backoffs): ops on other objects of the
    PG keep flowing; oid=None blocks the whole PG."""

    TYPE = "osd_backoff"
    FIELDS = ("pool", "ps", "op", "id", "epoch", "oid")


@register
class MWatchNotify(Message):
    """OSD -> watching client: a notify fired on a watched object
    (MWatchNotify.h); the client acks by replying with ack=True."""
    TYPE = "watch_notify"
    FIELDS = ("pool", "ps", "oid", "notify_id", "payload", "ack")


# -- osd <-> osd (replication / peering / recovery) ------------------------


@register
class MOSDRepOp(Message):
    """Primary -> replica transaction (MOSDRepOp.h): serialized
    Transaction + the pg log entry it carries."""

    TYPE = "osd_repop"
    FIELDS = ("pool", "ps", "tid", "txn", "log_entry", "epoch",
              "min_epoch", "pg_trim_to")


@register
class MOSDRepOpReply(Message):
    TYPE = "osd_repop_reply"
    FIELDS = ("pool", "ps", "tid", "result", "epoch")


@register
class MOSDPing(Message):
    """Heartbeat (MOSDPing.h): op is "ping" or "reply"."""

    TYPE = "osd_ping"
    FIELDS = ("osd", "op", "stamp", "epoch")


@register
class MOSDPGQuery(Message):
    """Primary -> replica: send me your info+log for pgid
    (MOSDPGQuery.h)."""

    TYPE = "pg_query"
    # query: "info" (peer state only) or "log" (entries since `since` —
    # the bounded GetLog fetch; full logs never ride info rounds)
    FIELDS = ("pool", "ps", "epoch", "query", "since")


@register
class MOSDPGLog(Message):
    """Replica -> primary: my pg info + full log (MOSDPGLog.h);
    info = {last_update, last_complete, log: [entries]}."""

    TYPE = "pg_log"
    FIELDS = ("pool", "ps", "epoch", "info")


@register
class MOSDScrub(Message):
    """mon -> primary OSD: operator-requested scrub of one PG
    (MOSDScrub.h / the `ceph pg scrub|deep-scrub|repair` flow)."""

    TYPE = "osd_scrub"
    FIELDS = ("pool", "ps", "deep", "repair")


@register
class MOSDRepScrub(Message):
    """Primary -> replica: build a scrub map for these objects
    (MOSDRepScrub.h); fetch=True also returns the bytes (the repair
    pull); inventory=True returns the replica's full hobject key list
    instead (the stray-clone sweep)."""
    TYPE = "rep_scrub"
    FIELDS = ("pool", "ps", "tid", "oids", "fetch", "inventory")


@register
class MOSDRepScrubMap(Message):
    """Replica -> primary: the chunk's ScrubMap (MOSDRepScrubMap.h)."""
    TYPE = "rep_scrub_map"
    FIELDS = ("pool", "ps", "tid", "objects")


@register
class MOSDPGPush(Message):
    """Recovery push (MOSDPGPush.h): full-object pushes
    [{oid fields, data, attrs, omap, version}...]."""

    TYPE = "pg_push"
    FIELDS = ("pool", "ps", "epoch", "pushes")


@register
class MOSDPGPushReply(Message):
    TYPE = "pg_push_reply"
    FIELDS = ("pool", "ps", "epoch", "oids")


# -- osd <-> osd (EC sub-ops) ----------------------------------------------


@register
class MOSDECSubOpWrite(Message):
    """Primary -> shard k write (MOSDECSubOpWrite.h): the shard's
    serialized transaction for one EC op."""

    TYPE = "ec_sub_write"
    FIELDS = ("pool", "ps", "shard", "tid", "txn", "log_entry",
              "epoch")


@register
class MOSDECSubOpWriteReply(Message):
    TYPE = "ec_sub_write_reply"
    FIELDS = ("pool", "ps", "shard", "tid", "result", "epoch")


@register
class MOSDECSubOpRead(Message):
    """Primary -> shard read (MOSDECSubOpRead.h): extents to read from
    the shard object: [[oid_key, off, len]...]."""

    TYPE = "ec_sub_read"
    FIELDS = ("pool", "ps", "shard", "tid", "reads", "epoch")


@register
class MOSDECSubOpReadReply(Message):
    TYPE = "ec_sub_read_reply"
    FIELDS = ("pool", "ps", "shard", "tid", "buffers", "errors",
              "epoch")
