"""EC backend: erasure-coded PG I/O over positional shards.

Condensed analog of src/osd/ECBackend.cc + ECUtil.{h,cc}: an EC pool's
PG stores each object as k+m shards, one per acting-set position —
acting[j] holds shard j (shard_id_t).  The primary:

* write  — encodes the object payload through the ErasureCodeInterface
  plugin (ECUtil::encode -> encode_chunks), persists its own shard, and
  sends each remote shard its transaction via MOSDECSubOpWrite
  (ECBackend::submit_transaction -> handle_sub_write,
  ECBackend.cc:1539,945); partial-extent writes are read-modify-write
  through the reconstruct path (start_rmw, ECBackend.cc:1898).
* read   — fetches the minimum shard set first (local + enough remotes
  for k distinct shards) and widens to every member on shortfall
  (objects_read_and_reconstruct + minimum_to_decode,
  ECBackend.cc:2405).  Sourcing is by *stored* shard, not acting
  position: any k distinct shards decode, so a member whose bytes
  belong to a previous layout still serves as a reconstruction source —
  availability the reference keeps via pg_temp + backfill.
* recover— rebuilds exactly the TARGET's shard from k survivors and
  pushes it (continue_recovery_op, ECBackend.cc:591): unlike the
  replicated backend, a pushed EC object is the recipient's shard, not
  a copy of the pusher's.

Shard metadata xattrs (the role ECUtil::HashInfo plays):
  ec_size  — true (unpadded) object length;
  ec_shard — which shard index these bytes encode (the shard_id_t the
             reference bakes into hobject_t);
  ec_ver   — the pg-log version that produced the bytes, so readers
             never mix shards from different writes (a member that
             missed a write is simply not a source until recovered).

Ordering: a per-(pg, oid) refcounted asyncio lock serializes client
RMW cycles AND recovery of the same object, the way ECBackend's
pipeline ordering (waiting_state -> waiting_reads -> waiting_commit)
plus the recovery read lock do.
"""

from __future__ import annotations

import asyncio

from ..ec import new_codec
from ..models.crushmap import ITEM_NONE
from ..msg.messages import (MOSDECSubOpRead, MOSDECSubOpReadReply,
                            MOSDECSubOpWrite, MOSDECSubOpWriteReply,
                            MOSDOpReply, MOSDPGPush)
from ..store.objectstore import NotFound, Transaction, hobject_t
from ..utils import denc
from .pg import PG, LogEntry

SIZE_XATTR = "ec_size"
SHARD_XATTR = "ec_shard"
VER_XATTR = "ec_ver"
HINFO_XATTR = "ec_hinfo"   # crc32 of every shard, comma-joined (the
                           # role ECUtil::HashInfo plays: deep scrub
                           # identifies a rotted shard by its crc)


def hinfo_bytes(shards: dict[int, bytes]) -> bytes:
    import zlib

    return b",".join(b"%d" % (zlib.crc32(shards[j]) & 0xFFFFFFFF)
                     for j in sorted(shards))


def _ver_bytes(version: tuple[int, int]) -> bytes:
    return b"%d.%d" % tuple(version)


def _parse_ver(raw: bytes) -> tuple[int, int]:
    a, b = raw.split(b".")
    return (int(a), int(b))


def derive_warmup_buckets(op_size_hist: list[int] | None, k: int,
                          w: int, top: int = 3) -> tuple | None:
    """Workload-aware device warmup for RAGGED streams: map the
    daemon's client write-size histogram (pow2 byte buckets —
    op_size_hist[i] counts writes of [2^i, 2^(i+1)) bytes) onto the
    bucket-ladder segment programs a k-chunk, w-bit codec's flushes
    will actually dispatch.  The batcher stages each flush TOTAL as a
    pow2 segment ladder (``DeviceRuntime.ragged_plan``), so the
    buckets worth warming are the ladder segments of each top item
    width (solo flushes) plus the segments of their combined total
    (the heterogeneous mixed flush a concurrent stream produces) —
    not each item's own pow2 ceiling.  Returns None when there is no
    history (caller falls back to the static default list)."""
    if not op_size_hist or not any(op_size_hist):
        return None
    from ..device.runtime import DeviceRuntime
    word_bytes = max(1, int(w) // 8)
    ranked = sorted(
        (i for i, n in enumerate(op_size_hist) if n > 0),
        key=lambda i: (-op_size_hist[i], i))[:top]
    words = []
    for i in ranked:
        payload = 1 << (i + 1)          # bucket upper bound, bytes
        words.append(-(-payload // (k * word_bytes)))   # ceil div
    buckets = set()
    for n in words + ([sum(words)] if len(words) > 1 else []):
        for _lo, seg in DeviceRuntime.ragged_plan(n):
            buckets.add(seg)
    return tuple(sorted(buckets))


class _OidLock:
    """Refcounted per-oid lock so the registry stays bounded."""

    __slots__ = ("lock", "refs")

    def __init__(self):
        self.lock = asyncio.Lock()
        self.refs = 0


class ECPGBackend:
    """Per-daemon EC I/O engine (shared across the daemon's EC PGs)."""

    def __init__(self, osd):
        self.osd = osd
        self._codecs: dict[str, object] = {}
        self._tid = 0
        # tid -> {"waiting": set, "event": Event, "buffers": dict,
        #         "errors": dict}
        self._reads: dict[int, dict] = {}
        self._writes: dict[int, dict] = {}
        self._locks: dict[tuple, _OidLock] = {}
        # telemetry: shard bytes fetched over the wire (RMW
        # amplification visibility; tests pin partial-write traffic)
        self.sub_read_bytes = 0
        # repair-traffic accounting (per codec plugin): survivor
        # bytes read through minimum_to_decode's minimal shard sets
        # vs rebuilt bytes pushed — shipped in MMgrReport osd_stats
        # and mirrored on the daemon's chip as chip-labeled series
        self.repair_traffic: dict[str, dict[str, int]] = {}
        # last degraded-read plan (tests assert fetched == minimal)
        self.last_read_plan: dict | None = None
        # last version-selection plan (tests assert the decode staged
        # exactly the minimum_to_decode-costed shard set)
        self.last_version_plan: dict | None = None

    # -- codec -------------------------------------------------------------

    def codec(self, pool):
        prof_name = pool.erasure_code_profile or "default"
        c = self._codecs.get(prof_name)
        if c is None:
            profile = dict(
                self.osd.osdmap.erasure_code_profiles.get(prof_name)
                or {"plugin": "jerasure", "k": "2", "m": "1",
                    "technique": "reed_sol_van"})
            c = new_codec(profile, device=self.osd.device)
            self._codecs[prof_name] = c
            self._maybe_warmup(c)
        return c

    def _codec_name(self, pool) -> str:
        """The pool codec's plugin name (the repair-traffic label)."""
        prof = dict(self.osd.osdmap.erasure_code_profiles.get(
            pool.erasure_code_profile or "default") or {})
        return prof.get("plugin", "jerasure")

    def note_repair(self, codec_name: str, bytes_read: int,
                    bytes_moved: int, targeted: bool = True) -> None:
        """Account one shard repair: `bytes_read` survivor bytes
        sourced (the minimal-set fetch when `targeted`, the full
        k-wide read otherwise) and `bytes_moved` rebuilt bytes
        written/pushed.  Flows to the perf counters, the MMgrReport
        osd_stats.repair row, and the daemon's chip gauges."""
        row = self.repair_traffic.setdefault(
            codec_name, {"read": 0, "moved": 0, "objects": 0,
                         "targeted": 0, "full": 0})
        row["read"] += max(0, int(bytes_read))
        row["moved"] += max(0, int(bytes_moved))
        row["objects"] += 1
        row["targeted" if targeted else "full"] += 1
        try:
            self.osd.perf.inc("repair_bytes_read",
                              max(0, int(bytes_read)))
            self.osd.perf.inc("repair_bytes_moved",
                              max(0, int(bytes_moved)))
            self.osd.perf.inc("repair_targeted" if targeted
                              else "repair_full")
        except KeyError:
            pass            # shells/tests without the counter set
        chip = getattr(self.osd, "device_chip", None)
        if chip is not None:
            chip.note_repair(bytes_read, bytes_moved)

    def _maybe_warmup(self, codec) -> None:
        """First sight of a profile: pre-compile its common device
        buckets in the background (the runtime's boot warmup) so the
        first client flushes hit the compile cache instead of paying
        XLA latency inside the write path."""
        from ..device.runtime import DeviceRuntime
        try:
            if not int(self.osd.ctx.conf["device_warmup"]):
                return
        except (KeyError, TypeError, ValueError):
            pass
        families = getattr(codec, "device_families",
                           lambda: [])()
        if not families:
            return
        rt = DeviceRuntime.get(self.osd.device)
        if rt.chip_available(self._chip()):
            # every program family the codec's flushes AND repairs
            # will dispatch (plain codecs: the coding matrix;
            # LRC: per-layer matrices + the local-group repair rows;
            # SHEC/CLAY: encode + single-failure decode shapes) —
            # so the first repair after boot doesn't eat a JIT
            # compile on the hot path.  Workload-aware buckets from
            # the daemon's op-size histogram when history exists;
            # the static default list otherwise — compiled on this
            # OSD's own chip (the one its flushes dispatch on).
            for matrix, w in families:
                if not isinstance(w, int):
                    continue    # a bitmatrix family: no GF(2^w) product
                derived = derive_warmup_buckets(
                    getattr(self.osd, "op_size_hist", None),
                    k=len(matrix[0]), w=w)
                if derived:
                    self.osd.msgr.spawn(
                        rt.warmup_ec(matrix, w, buckets=derived,
                                     chip=self._chip()))
                else:
                    self.osd.msgr.spawn(
                        rt.warmup_ec(matrix, w, chip=self._chip()))

    class _Locked:
        def __init__(self, backend, key):
            self.backend = backend
            self.key = key

        async def __aenter__(self):
            entry = self.backend._locks.get(self.key)
            if entry is None:
                entry = self.backend._locks[self.key] = _OidLock()
            entry.refs += 1
            self.entry = entry
            await entry.lock.acquire()

        async def __aexit__(self, *exc):
            self.entry.lock.release()
            self.entry.refs -= 1
            if self.entry.refs == 0 and \
                    self.backend._locks.get(self.key) is self.entry:
                del self.backend._locks[self.key]

    def oid_lock(self, pg: PG, oid: str) -> "_Locked":
        return self._Locked(self, (pg.pool_id, pg.ps, oid))

    # -- client op entry ---------------------------------------------------

    async def handle_op(self, pg: PG, conn, msg) -> None:
        """Primary-side execution of one client op list."""
        async with self.oid_lock(pg, msg.oid):
            # dup re-check under the oid lock: a resend that queued
            # behind the original acquires the lock after the first
            # execution journaled its reply
            dup = pg.lookup_reqid(msg.src, msg.tid)
            if dup is not None:
                conn.send(MOSDOpReply(
                    tid=msg.tid, result=dup["result"],
                    outs=dup["outs"], epoch=self.osd.osdmap.epoch,
                    version=dup["version"]))
                self.osd.perf.inc("dup_ops")
                self.osd._op_finish(msg, "dup_answered_from_journal")
                return
            try:
                await self._do_op(pg, conn, msg)
            except Exception as e:
                import traceback

                traceback.print_exc()
                conn.send(MOSDOpReply(
                    tid=msg.tid, result=-5, outs=[{"error": repr(e)}],
                    epoch=self.osd.osdmap.epoch, version=0))
            finally:
                # every exit retires the tracked op (idempotent): the
                # success paths already finished it with their stage
                self.osd._op_finish(msg, "ec_error_reply")

    async def _get_snapset(self, pg: PG, oid: str):
        """SnapSet from the local shard's attr, else any member's
        (identical on every shard)."""
        from . import snaps as snapmod
        ss = snapmod.load_snapset(self.osd.store, pg.cid,
                                  hobject_t(oid))
        if ss is not None:
            return ss
        raw = await self._fetch_xattr(pg, oid, snapmod.SNAPSET_ATTR)
        if raw is None:
            return None
        ss = denc.decode(raw)
        ss["clone_size"] = {int(k): v
                            for k, v in ss["clone_size"].items()}
        ss["clone_snaps"] = {int(k): list(v)
                             for k, v in ss["clone_snaps"].items()}
        return ss

    async def _head_state(self, pg: PG, oid: str):
        """(exists, whiteout) of the head object, judged from the
        local shard when present, else a peer's attrs."""
        from . import snaps as snapmod
        ho = hobject_t(oid)
        local = self._local_shard(pg, ho)
        if local is not None:
            return True, local[4].get(snapmod.WHITEOUT_ATTR) == b"1"
        raw = await self._fetch_xattr(pg, oid, SHARD_XATTR)
        if raw is None:
            return False, False
        wo = await self._fetch_xattr(pg, oid, snapmod.WHITEOUT_ATTR)
        return True, wo == b"1"

    async def _do_op(self, pg: PG, conn, msg) -> None:
        from ..store.objectstore import NOSNAP
        from . import snaps as snapmod
        writes = any(o["op"] in _EC_WRITE_OPS for o in msg.ops)
        epoch = self.osd.osdmap.epoch
        if not writes:
            outs, result = [], 0
            data = None
            fetched = False
            # snapshot read: resolve the serving clone up front
            read_snap = None
            snapid = getattr(msg, "snapid", None)
            if snapid not in (None, NOSNAP):
                ss = await self._get_snapset(pg, msg.oid)
                c = snapmod.choose_clone(ss, snapid)
                if c is None:
                    conn.send(MOSDOpReply(
                        tid=msg.tid, result=-2,
                        outs=[{"error": "not found"}],
                        epoch=epoch, version=0))
                    return
                if c != "head":
                    read_snap = c
            for op in msg.ops:
                name = op["op"]
                if name in ("read", "stat"):
                    if not fetched:
                        data, _v, rattrs = await self.read_object_attrs(
                            pg, msg.oid, snap=read_snap)
                        if (data is not None and read_snap is None
                                and (rattrs or {}).get(
                                    snapmod.WHITEOUT_ATTR) == b"1"):
                            data = None     # whiteout head: ENOENT
                        fetched = True
                    if data is None:
                        outs.append({"error": "not found"})
                        result = -2
                    elif name == "read":
                        off = op.get("offset", 0)
                        ln = op.get("length", 0)
                        outs.append({"data": data[off:off + ln]
                                     if ln else data[off:]})
                    else:
                        outs.append({"size": len(data)})
                elif name == "pgls":
                    from ..store.objectstore import NOSNAP as _NS
                    names = sorted(
                        h.name for h in
                        self.osd.store.collection_list(pg.cid)
                        if h.name != "__pgmeta__" and h.snap == _NS
                        and not snapmod.is_whiteout(self.osd.store,
                                                    pg.cid, h))
                    outs.append({"names": names})
                elif name == "getxattr":
                    val = await self._fetch_xattr(pg, msg.oid,
                                                  op["name"])
                    if val is None:
                        outs.append({"error": "not found"})
                        result = -2
                    else:
                        outs.append({"value": val})
                else:
                    outs.append({"error": "bad ec op %s" % name})
                    result = -22
            conn.send(MOSDOpReply(tid=msg.tid, result=result, outs=outs,
                                  epoch=epoch, version=0))
            self.osd.perf.inc("ops")
            pg.stats.note_read(sum(
                len(o.get("data") or b"") for o in outs
                if isinstance(o, dict)))
            self.osd._op_finish(msg, "ec_read_done")
            return

        # write path.  Pure in-place overwrites first try the
        # parity-delta RMW (bytes moved proportional to the touched
        # range, not the object — ECBackend start_rmw's role)
        self.osd._op_event(msg, "ec_write_started")
        wbytes = sum(len(o.get("data") or b"") for o in msg.ops
                     if isinstance(o, dict))
        self.osd.note_op_size(wbytes)
        if msg.ops and all(o["op"] == "write" for o in msg.ops):
            res = await self._try_delta_write(pg, msg)
            if res is not None:
                outs2, ok2 = res
                # the delta path journals the reqid inside the
                # replicated shard txns themselves (submit_write's
                # full-write path now does the same via `reqid`)
                conn.send(MOSDOpReply(
                    tid=msg.tid, result=0 if ok2 else -11,
                    outs=outs2, epoch=epoch,
                    version=pg.info.last_update[1]))
                self.osd.perf.inc("ops")
                if ok2:
                    pg.stats.note_write(wbytes)
                self.osd._op_finish(msg, "ec_delta_done")
                return
        # whole-object RMW fallback
        outs = []
        current: bytes | None = None
        loaded = False
        is_delete = False
        for op in msg.ops:
            name = op["op"]
            if name == "writefull":
                current = bytes(op["data"])
                loaded = True
                outs.append({})
            elif name == "write":
                off = op.get("offset", 0)
                if not loaded:
                    current, _ = await self.read_object(pg, msg.oid)
                    current = current or b""
                    loaded = True
                data = op["data"]
                if len(current) < off:
                    current = current + b"\0" * (off - len(current))
                current = current[:off] + data + \
                    current[off + len(data):]
                outs.append({})
            elif name == "truncate":
                if not loaded:
                    current, _ = await self.read_object(pg, msg.oid)
                    current = current or b""
                    loaded = True
                ln = op["length"]
                if len(current) < ln:
                    current = current + b"\0" * (ln - len(current))
                else:
                    current = current[:ln]
                outs.append({})
            elif name == "delete":
                # existence gate (mirrors the replicated path): a
                # delete of a never-written OR already-whiteouted
                # object must return -2, not append a spurious DELETE
                # log entry (a whiteout head reads back as b"", so the
                # probe alone cannot tell)
                h_exists, h_white = await self._head_state(pg, msg.oid)
                if not h_exists or h_white:
                    conn.send(MOSDOpReply(
                        tid=msg.tid, result=-2,
                        outs=[{"error": "not found"}],
                        epoch=epoch, version=0))
                    return
                is_delete = True
                current = None
                loaded = True
                outs.append({})
            elif name == "setxattr":
                outs.append({})  # applied with the shard transactions
            else:
                conn.send(MOSDOpReply(
                    tid=msg.tid, result=-22,
                    outs=[{"error": "bad ec op %s" % name}],
                    epoch=epoch, version=0))
                return
        if not is_delete and not loaded:
            # xattr-only mutation: rewrite the current payload
            current, _ = await self.read_object(pg, msg.oid)
            current = current or b""
        xattrs = {op["name"]: op["value"] for op in msg.ops
                  if op["op"] == "setxattr"}
        # snapshot bookkeeping (make_writeable on shards): first write
        # under a newer SnapContext clones every shard object inside
        # the same shard transactions
        clone_to, snapset_b, sna_snaps, whiteout = \
            await self._prepare_snapc(pg, msg, is_delete)
        ok = await self.submit_write(pg, msg.oid, current, is_delete,
                                     xattrs, clone_to=clone_to,
                                     snapset_b=snapset_b,
                                     sna_snaps=sna_snaps,
                                     whiteout=whiteout,
                                     top=getattr(msg, "_top", None),
                                     reqid=(msg.src, msg.tid, outs))
        ver = pg.info.last_update[1]
        conn.send(MOSDOpReply(tid=msg.tid, result=0 if ok else -11,
                              outs=outs, epoch=self.osd.osdmap.epoch,
                              version=ver))
        self.osd.perf.inc("ops")
        if ok:
            pg.stats.note_write(wbytes)
        self.osd._op_finish(msg, "ec_write_done")

    # -- write path --------------------------------------------------------

    def _chip(self) -> int | None:
        """This daemon's mesh-chip index (OSD->chip affinity): every
        EC dispatch from this backend lands on the OSD's own chip, so
        a chip loss fails exactly this daemon's EC ops until it heals."""
        chip = getattr(self.osd, "device_chip", None)
        return chip.index if chip is not None else None

    def _chip_lost(self) -> bool:
        """This daemon's chip is lost: a failed dispatch poisons it, so
        an IOError with the chip lost is a device failure, not an
        undecodable shard set."""
        chip = getattr(self.osd, "device_chip", None)
        return chip is not None and chip.lost

    def _on_dispatch_ticket(self, top):
        """Per-op device-dispatch attribution callback: the batcher
        delivers the DispatchTicket of the EXACT flush that carried
        this op's shards (closing the PR-2 gap where the stage
        histogram sampled the batcher's last flush time — wrong under
        heavy interleaving)."""
        def on_ticket(t):
            self.osd.perf.hist_sample("op_ec_device_dispatch",
                                      t.device_s)
            if top is not None:
                top.mark_event("device_dispatched")
                if getattr(t, "stream", False):
                    # the op's slot retired it independently of any
                    # co-resident slot (the continuous-dispatch path)
                    top.mark_event("device_stream_retired")
                top.note("device_ticket", t.dump())
                if top.tenant is not None:
                    self.osd.note_tenant_stage(
                        top.tenant, "device_dispatch", t.device_s)
        return on_ticket

    async def _encode_shards(self, pg: PG, data: bytes,
                             top=None,
                             klass: str | None = None
                             ) -> dict[int, bytes]:
        """Shard encode for the write path — the device-batched analog
        of ECTransaction::generate_transactions -> ECUtil::encode:
        concurrent writes across PGs aggregate into one TPU dispatch
        (ceph_tpu.ec.batcher routed through the device runtime).  The
        await spans the batch window PLUS the device flush, so its
        duration is the op's "EC batch wait" stage; the flush that
        actually carried the shards reports itself through the
        dispatch ticket as the "device dispatch" stage."""
        import time as _time
        codec = self.codec(self.osd.osdmap.pools[pg.pool_id])
        n = codec.get_chunk_count()
        tenant = top.tenant if top is not None else None
        if top is not None:
            top.mark_event("ec_encode_start")
        t0 = _time.monotonic()
        shards = await codec.encode_async(
            set(range(n)), data, klass=klass,
            on_ticket=self._on_dispatch_ticket(top),
            chip=self._chip(), tenant=tenant)
        dt = _time.monotonic() - t0
        self.osd.perf.hist_sample("op_ec_batch_wait", dt)
        if tenant is not None:
            self.osd.note_tenant_stage(tenant, "ec_batch_wait", dt)
        if top is not None:
            top.mark_event("ec_encoded")
        return shards

    def _shard_txn(self, pg: PG, ho: hobject_t, shard: bytes, j: int,
                   size: int, version, xattrs: dict | None,
                   hinfo: bytes | None = None) -> Transaction:
        t = Transaction()
        # touch+truncate(0)+write replaces any older (possibly longer)
        # shard without knowing remote existence
        t.touch(pg.cid, ho)
        t.truncate(pg.cid, ho, 0)
        t.write(pg.cid, ho, 0, len(shard), shard)
        t.setattr(pg.cid, ho, SIZE_XATTR, b"%d" % size)
        t.setattr(pg.cid, ho, SHARD_XATTR, b"%d" % j)
        t.setattr(pg.cid, ho, VER_XATTR, _ver_bytes(version))
        if hinfo is not None:
            t.setattr(pg.cid, ho, HINFO_XATTR, hinfo)
        for k, v in (xattrs or {}).items():
            t.setattr(pg.cid, ho, k, v)
        return t

    async def submit_write(self, pg: PG, oid: str,
                           data: bytes | None, is_delete: bool,
                           xattrs: dict | None = None,
                           clone_to: int | None = None,
                           snapset_b: bytes | None = None,
                           sna_snaps: list | None = None,
                           whiteout: bool = False,
                           top=None, reqid: tuple | None = None
                           ) -> bool:
        """Encode + distribute one object write; True when every live
        shard acked (ECBackend::try_reads_to_commit).

        Snapshot args: clone_to clones each member's shard object to
        hobject(oid, snap=clone_to) before the write applies;
        snapset_b is the updated SnapSet attr; sna_snaps index the new
        clone in the SnapMapper rows; whiteout turns a delete into a
        zero-length tombstone that keeps the SnapSet (clones alive).

        `reqid` = (src, tid, outs) journals the client's reply dup
        row inside EVERY shard transaction (the delta path's
        replicated-journal contract extended to full writes): after a
        primary loss, the promoted replica answers the client's
        resend from its own store instead of re-executing.  A < k
        commit forgets the pre-journaled row (the resend must
        re-execute)."""
        from . import snaps as snapmod
        from .pg import PGMETA_OID
        epoch = self.osd.osdmap.epoch
        version = (epoch, pg.info.last_update[1] + 1)
        entry = LogEntry(
            LogEntry.DELETE if is_delete else LogEntry.MODIFY,
            oid, version, pg.info.last_update)
        pg.info.last_update = version
        pg.log.append(entry)
        # this write supersedes any pending recovery of the object
        pg.missing.pop(oid, None)
        for pm in pg.peer_missing.values():
            pm.pop(oid, None)
        shards = (None if is_delete
                  else await self._encode_shards(pg, data, top=top))
        hinfo = None if shards is None else hinfo_bytes(shards)
        ho = hobject_t(oid)

        txns: dict[int, Transaction] = {}
        for j, osd_id in enumerate(pg.acting):
            if osd_id == ITEM_NONE or osd_id < 0:
                continue
            t = Transaction()
            if clone_to is not None:
                t.clone(pg.cid, ho, hobject_t(oid, snap=clone_to))
            if is_delete and whiteout:
                t.truncate(pg.cid, ho, 0)
                t.setattr(pg.cid, ho, snapmod.WHITEOUT_ATTR, b"1")
                t.setattr(pg.cid, ho, VER_XATTR, _ver_bytes(version))
            elif is_delete:
                t.remove(pg.cid, ho)
            else:
                t.append(self._shard_txn(pg, ho, shards[j], j,
                                         len(data), version, xattrs,
                                         hinfo))
                if snapset_b is not None:
                    t.setattr(pg.cid, ho, snapmod.WHITEOUT_ATTR, b"0")
            if snapset_b is not None and not (is_delete
                                              and not whiteout):
                t.setattr(pg.cid, ho, snapmod.SNAPSET_ATTR, snapset_b)
            for sn in (sna_snaps or ()):
                t.omap_setkeys(pg.cid, PGMETA_OID,
                               {snapmod.sna_key(sn, oid): b"1"})
            txns[j] = t
        if reqid is not None:
            src, tid, outs = reqid
            pg.record_reqid(list(txns.values()), src, tid, 0,
                            list(outs), version[1])
        ok = await self._commit_shard_txns(pg, oid, entry, txns,
                                           top=top)
        if reqid is not None and not ok:
            # < k shards acked: the resend must re-execute, not be
            # answered 0 from the pre-journaled row (mirrors the
            # delta path's forget-on-failed-commit contract)
            pg.forget_reqid(reqid[0], reqid[1])
        return ok

    async def _commit_shard_txns(self, pg: PG, oid: str, entry,
                                 txns: dict[int, "Transaction"],
                                 top=None) -> bool:
        """Distribute per-position shard transactions with the
        submit_write ack contract: local apply carries the log/meta
        rows, remotes ride MOSDECSubOpWrite, stragglers become
        peer_missing, success = >= k shards persisted."""
        epoch = self.osd.osdmap.epoch
        self._tid += 1
        tid = self._tid
        waiting: set[int] = set()
        down_skipped: set[int] = set()
        ev = asyncio.Event()
        st = {"waiting": waiting, "event": ev}
        self._writes[tid] = st
        for j, t in txns.items():
            osd_id = pg.acting[j]
            if osd_id == ITEM_NONE or osd_id < 0:
                continue
            if osd_id != self.osd.whoami \
                    and not self.osd.osdmap.is_up(osd_id):
                # a member the map already knows is down cannot ack:
                # mark it behind immediately instead of stalling the
                # client write on the sub-op timeout — but it still
                # counts as NOT applied for the >= k durability check
                pg.peer_missing.setdefault(osd_id, {})[oid] = entry.op
                down_skipped.add(osd_id)
                continue
            if osd_id == self.osd.whoami:
                entryt = Transaction()
                entryt.append(t)
                pg.persist_log_entry(entryt, entry)
                pg.maybe_trim_log(entryt)
                pg.persist_meta(entryt)
                self.osd.store.apply_transaction(entryt)
            else:
                waiting.add(osd_id)
                sub = MOSDECSubOpWrite(
                    pool=pg.pool_id, ps=pg.ps, shard=j, tid=tid,
                    txn=denc.encode(t.to_wire()),
                    log_entry=entry.to_wire(), epoch=epoch)
                # the sub-op joins the client op's cross-daemon span
                # (and its tenant rides along for shard-side books)
                sub.trace = top.trace if top is not None else None
                sub.tenant = top.tenant if top is not None else None
                self.osd._send_osd(osd_id, sub)
        if waiting:
            if top is not None:
                top.mark_event("ec_sub_write_sent")
            try:
                await asyncio.wait_for(
                    ev.wait(),
                    float(self.osd.ctx.conf["osd_ec_subop_timeout"]))
            except asyncio.TimeoutError:
                pass
            if top is not None:
                top.mark_event("ec_sub_write_acked"
                               if not st["waiting"]
                               else "ec_sub_write_timeout")
        self._writes.pop(tid, None)
        behind = set(st["waiting"]) | down_skipped
        if behind:
            for osd_id in st["waiting"]:
                pg.peer_missing.setdefault(osd_id, {})[oid] = entry.op
            codec = self.codec(self.osd.osdmap.pools[pg.pool_id])
            applied = sum(
                1 for j, osd_id in enumerate(pg.acting)
                if osd_id != ITEM_NONE and osd_id >= 0
                and osd_id not in behind)
            if applied >= codec.get_data_chunk_count():
                self.osd._kick_recovery(pg)
                return True
            return False
        return True

    async def _prepare_snapc(self, pg: PG, msg,
                             is_delete: bool = False):
        """Shared snapshot bookkeeping for both EC write paths:
        (clone_to, snapset_b, sna_snaps, whiteout)."""
        from . import snaps as snapmod
        clone_to = None
        snapset_b = None
        sna_snaps: list[int] = []
        whiteout = False
        snapc = getattr(msg, "snapc", None)
        if snapc:
            seq = int(snapc[0])
            snap_ids = [int(s) for s in snapc[1]]
            ss = await self._get_snapset(pg, msg.oid)
            head_exists, head_white = await self._head_state(pg,
                                                             msg.oid)
            if ss is None:
                ss = snapmod.new_snapset()
            newer = [s for s in snap_ids if s > ss["seq"]]
            if head_exists and not head_white and newer \
                    and seq > ss["seq"]:
                clone_to = seq
                try:
                    szb = await self._fetch_xattr(pg, msg.oid,
                                                  SIZE_XATTR)
                    size = int(szb or 0)
                except Exception:
                    size = 0
                ss["clones"].append(clone_to)
                ss["clones"].sort()
                ss["clone_size"][clone_to] = size
                ss["clone_snaps"][clone_to] = sorted(newer)
                sna_snaps = sorted(newer)
            if seq > ss["seq"]:
                ss["seq"] = seq
            if is_delete and ss["clones"]:
                whiteout = True
            snapset_b = snapmod.snapset_bytes(ss)
        return clone_to, snapset_b, sna_snaps, whiteout

    async def _try_delta_write(self, pg: PG, msg):
        """Chunk-aware partial overwrite: parity-delta RMW
        (ECBackend::start_rmw + ECUtil stripe math, ECBackend.cc:1898,
        ECUtil.h:25-66 — re-derived for the contiguous chunk layout
        using GF linearity).

        For an in-place overwrite of byte range [a,b) the only chunks
        whose bytes change are the touched data chunk columns and the
        SAME columns of every parity chunk:

            new_parity_i[x] = old_parity_i[x] XOR
                              sum_j gfmul(M[i][j], delta_j[x])

        so the network traffic is (1+m) ranged reads + (1+m) ranged
        writes proportional to the touched bytes — NOT the object
        size.  The GF products route through ``codec.delta_async`` —
        device-batched on this OSD's affinity chip, so concurrent
        partial writes across PGs/objects share one dispatch; a
        refused or failed dispatch fails the op) — and the
        reqid dup journal rides every shard txn so promoted replicas
        answer resends.  Untouched data shards get an attr-only
        version bump so readers never mix generations.  Shard crcs
        (hinfo) update incrementally via crc32 linearity:
        crc(new) = crc(old) ^ crc(delta0pad) ^ crc(zeros) — computed
        by the primary with no extra I/O.  Returns op outs, or None
        when ineligible (growth, degraded members, non-matrix codec,
        big spans), in which case the caller's whole-object RMW runs.
        The per-object oid_lock plays the ExtentCache role of
        serializing overlapping RMW cycles."""
        import zlib
        pool = self.osd.osdmap.pools[pg.pool_id]
        codec = self.codec(pool)
        matrix = getattr(codec, "matrix", None)
        if (not matrix or getattr(codec, "w", 0) not in (8, 16, 32)
                or codec.get_chunk_mapping()):
            return None
        # w=16/32: parity changes at word granularity (GF products
        # mix bits across the word), so column intervals align to the
        # word boundary below; the data-chunk writes themselves stay
        # byte-granular
        word = codec.w // 8
        k = codec.get_data_chunk_count()
        n = codec.get_chunk_count()
        m = n - k
        if msg.oid in pg.missing or any(
                msg.oid in pm for pm in pg.peer_missing.values()):
            # a stale shard exists somewhere: the delta path cannot
            # detect it (it never reads untouched shards) and must not
            # re-stamp versions over old bytes — whole-object RMW
            # rewrites every shard and heals instead
            return None
        local = self._local_shard(pg, hobject_t(msg.oid))
        if local is None:
            return None                      # primary degraded: RMW
        _j, _buf, size, ver, lattrs = local
        from . import snaps as snapmod
        if lattrs.get(snapmod.WHITEOUT_ATTR) == b"1":
            return None
        hinfo_raw = lattrs.get(HINFO_XATTR)
        if hinfo_raw is None:
            return None
        old_crcs = [int(x) for x in hinfo_raw.split(b",")]
        if len(old_crcs) != n:
            return None
        writes = []
        total = 0
        for op in msg.ops:
            off = int(op.get("offset", 0))
            data = bytes(op["data"])
            if off < 0 or off + len(data) > size or not data:
                return None                  # growth/degenerate: RMW
            writes.append((off, data))
            total += len(data)
        if total * 4 > size:
            return None                      # big span: full RMW wins
        cs = codec.get_chunk_size(size)
        if cs % word:
            return None          # word-ragged chunk layout: full RMW
        # per-chunk parts: {j: [(c0, new_bytes), ...]} in column space
        per_chunk: dict[int, list] = {}
        for off, data in writes:
            pos = off
            while pos < off + len(data):
                j = pos // cs
                c0 = pos % cs
                take = min(cs - c0, off + len(data) - pos)
                per_chunk.setdefault(j, []).append(
                    (c0, data[pos - off:pos - off + take]))
                pos += take
        # merged column intervals (parity changes exactly there),
        # floored/ceiled to the codec's word boundary — a sub-word
        # overwrite dirties its whole containing parity word; a
        # boundary-crossing write yields ranges at OPPOSITE chunk ends
        # — they must stay separate reads, never one covering span
        raw_ivs = sorted(((c0 // word) * word,
                          min(cs, -(-(c0 + len(d)) // word) * word))
                         for parts in per_chunk.values()
                         for c0, d in parts)
        ivs: list[list[int]] = []
        for a, b in raw_ivs:
            if ivs and a <= ivs[-1][1]:
                ivs[-1][1] = max(ivs[-1][1], b)
            else:
                ivs.append([a, b])

        async def ranged(j, a, b):
            """Old shard bytes [a,b) of position j, or None."""
            osd_id = pg.acting[j] if j < len(pg.acting) else -1
            if osd_id < 0 or osd_id == ITEM_NONE:
                return None
            if osd_id == self.osd.whoami:
                loc = self._local_shard(pg, hobject_t(msg.oid))
                if loc is None or loc[0] != j or loc[3] != ver:
                    return None
                return loc[1][a:b]
            rows = (await self._sub_read(
                pg, msg.oid, [osd_id], off=a,
                length=b - a)).get(osd_id) or []
            if not rows:
                return None
            rj, buf, _sz, rver, _attrs = rows[0]
            if rj != j or tuple(rver) != ver or len(buf) < b - a:
                return None              # stale/short: full RMW
            return bytes(buf)

        # old bytes: per-part for touched data chunks, per-interval
        # for every parity chunk — ALL reads issued concurrently (one
        # latency round, not one RTT per shard/part)
        keys: list[tuple] = []
        coros = []
        for j, parts in per_chunk.items():
            for c0, d in parts:
                keys.append(("d", j, c0))
                coros.append(ranged(j, c0, c0 + len(d)))
        for i in range(k, n):
            for a, b in ivs:
                keys.append(("p", i, a))
                coros.append(ranged(i, a, b))
        results = await asyncio.gather(*coros)
        old_part: dict[tuple, bytes] = {}
        old_par: dict[tuple, bytes] = {}
        for (kind, x, y), ob in zip(keys, results):
            if ob is None:
                return None
            if kind == "d":
                old_part[(x, y)] = ob
            else:
                old_par[(x, y)] = ob
        # deltas + incremental crcs (crc32 linearity over GF(2))
        import numpy as _np
        zeros_cs_crc = zlib.crc32(bytes(cs)) & 0xFFFFFFFF
        new_crcs = list(old_crcs)
        delta_part: dict[tuple, bytes] = {}
        for j, parts in per_chunk.items():
            dpad = bytearray(cs)
            for c0, d in parts:
                ob = old_part[(j, c0)]
                delta = bytes(x ^ y for x, y in zip(ob, d))
                delta_part[(j, c0)] = delta
                dpad[c0:c0 + len(delta)] = delta
            new_crcs[j] = (old_crcs[j] ^ zlib.crc32(bytes(dpad))
                           ^ zeros_cs_crc) & 0xFFFFFFFF
        # parity deltas: one device-batched GF product per interval
        # (codec.delta_async — concurrent partial writes across
        # PGs/objects batch their coefficient-column products into one
        # dispatch on this OSD's chip; DeviceBusy or a lost chip fails
        # the op), intervals issued concurrently so they
        # share a flush; the op's ticket feeds op_ec_device_dispatch
        top = getattr(msg, "_top", None)

        def _iv_deltas(a: int, b: int) -> dict[int, bytes]:
            out: dict[int, bytes] = {}
            for j, parts in per_chunk.items():
                row = bytearray(b - a)
                touched = False
                for c0, d in parts:
                    if c0 >= b or c0 + len(d) <= a:
                        continue
                    dp = delta_part[(j, c0)]
                    row[c0 - a:c0 - a + len(dp)] = dp
                    touched = True
                if touched:
                    out[j] = bytes(row)
            return out

        pdeltas = await asyncio.gather(*[
            codec.delta_async(_iv_deltas(a, b),
                              on_ticket=self._on_dispatch_ticket(top),
                              chip=self._chip(),
                              tenant=(top.tenant if top is not None
                                      else None))
            for a, b in ivs])
        new_par: dict[tuple, bytes] = {}
        for i in range(m):
            dpad = bytearray(cs)
            for (a, b), pd in zip(ivs, pdeltas):
                acc = _np.frombuffer(pd[i], _np.uint8)
                ob = _np.frombuffer(old_par[(k + i, a)], _np.uint8)
                new_par[(k + i, a)] = (ob[:b - a] ^ acc).tobytes()
                dpad[a:b] = pd[i]
            new_crcs[k + i] = (old_crcs[k + i]
                               ^ zlib.crc32(bytes(dpad))
                               ^ zeros_cs_crc) & 0xFFFFFFFF
        # snapshot bookkeeping shares the write path's semantics
        clone_to, snapset_b, sna_snaps, _wo = \
            await self._prepare_snapc(pg, msg)
        epoch = self.osd.osdmap.epoch
        version = (epoch, pg.info.last_update[1] + 1)
        entry = LogEntry(LogEntry.MODIFY, msg.oid, version,
                         pg.info.last_update)
        pg.info.last_update = version
        pg.log.append(entry)
        ho = hobject_t(msg.oid)
        hinfo_b = b",".join(b"%d" % c for c in new_crcs)
        from . import snaps as _snapmod
        from .pg import PGMETA_OID
        txns: dict[int, Transaction] = {}
        for j in range(min(n, len(pg.acting))):
            t = Transaction()
            if clone_to is not None:
                t.clone(pg.cid, ho,
                        hobject_t(msg.oid, snap=clone_to))
            if j in per_chunk:
                for c0, d in per_chunk[j]:
                    t.write(pg.cid, ho, c0, len(d), bytes(d))
            elif j >= k:
                for a, b in ivs:
                    t.write(pg.cid, ho, a, b - a,
                            new_par[(j, a)])
            t.setattr(pg.cid, ho, VER_XATTR, _ver_bytes(version))
            t.setattr(pg.cid, ho, HINFO_XATTR, hinfo_b)
            if snapset_b is not None:
                t.setattr(pg.cid, ho, _snapmod.SNAPSET_ATTR,
                          snapset_b)
                t.setattr(pg.cid, ho, _snapmod.WHITEOUT_ATTR, b"0")
            for s in (sna_snaps or ()):
                t.omap_setkeys(pg.cid, PGMETA_OID,
                               {_snapmod.sna_key(s, msg.oid): b"1"})
            txns[j] = t
        outs = [{} for _ in msg.ops]
        # the reqid dup journal rides EVERY shard txn (replicated, not
        # primary-local like the full-write path's own-txn journal):
        # after a primary loss the promoted replica answers a client
        # resend from its own store
        pg.record_reqid(list(txns.values()), msg.src, msg.tid, 0,
                        outs, version[1])
        self.osd._op_event(msg, "ec_delta_rmw")
        ok = await self._commit_shard_txns(pg, msg.oid, entry, txns,
                                           top=top)
        if not ok:
            # < k shards acked: the resend must re-execute (an
            # in-place overwrite re-executes idempotently), not be
            # answered 0 from the pre-journaled row
            pg.forget_reqid(msg.src, msg.tid)
        # the log entry is appended either way: do NOT fall back to the
        # whole-object path after a commit attempt (same durability
        # contract as submit_write: ok = >= k shards persisted)
        return (outs, ok)

    def handle_sub_write(self, conn, msg: MOSDECSubOpWrite) -> None:
        """Shard side (ECBackend::handle_sub_write)."""
        from .osdmap import pg_t

        pgid = pg_t(msg.pool, msg.ps)
        pg = self.osd.pgs.get(pgid)
        if pg is None:
            pg = PG(self.osd, msg.pool, msg.ps)
            pg.create_onstore()
            self.osd.pgs[pgid] = pg
        t = Transaction.from_wire(denc.decode(msg.txn))
        entry = LogEntry.from_wire(msg.log_entry)
        pg.log.append(entry)
        pg.info.last_update = entry.version
        pg.missing.pop(entry.oid, None)  # the write heals the object
        pg.persist_log_entry(t, entry)
        pg.maybe_trim_log(t)
        pg.persist_meta(t)
        self.osd.store.apply_transaction(t)
        conn.send(MOSDECSubOpWriteReply(
            pool=msg.pool, ps=msg.ps, shard=msg.shard, tid=msg.tid,
            result=0, epoch=msg.epoch))
        self.osd._op_finish(msg, "ec_shard_applied")

    def handle_sub_write_reply(self, msg: MOSDECSubOpWriteReply) -> None:
        st = self._writes.get(msg.tid)
        if st is None:
            return
        sender = int(msg.src.split(".")[1])
        st["waiting"].discard(sender)
        if not st["waiting"]:
            st["event"].set()

    # -- read path ---------------------------------------------------------

    def _local_shard(self, pg: PG, ho: hobject_t):
        """(shard_index, bytes, size, version, attrs) of the local
        object, or None."""
        if not self.osd.store.exists(pg.cid, ho):
            return None
        try:
            attrs = self.osd.store.getattrs(pg.cid, ho)
            j = int(attrs[SHARD_XATTR])
            size = int(attrs[SIZE_XATTR])
            ver = _parse_ver(attrs[VER_XATTR])
            return (j, self.osd.store.read(pg.cid, ho), size, ver,
                    attrs)
        except (NotFound, KeyError, ValueError):
            return None

    async def read_object(self, pg: PG, oid: str, snap: int = None):
        """Reconstructing whole-object read; returns (data, version)
        or (None, None)."""
        data, ver, _attrs = await self.read_object_attrs(pg, oid,
                                                        snap=snap)
        return data, ver

    async def read_object_attrs(self, pg: PG, oid: str,
                                snap: int = None):
        """Reconstructing whole-object read; returns
        (data, version, attrs) or (None, None, None).  Fetches the
        minimum member set first and widens on shortfall; only shards
        stamped with the newest observed version are mixed (ec_ver);
        attrs come from any shard of the winning version (user xattrs
        are written identically to every shard)."""
        pool = self.osd.osdmap.pools[pg.pool_id]
        codec = self.codec(pool)
        k = codec.get_data_chunk_count()
        ho = (hobject_t(oid) if snap is None
              else hobject_t(oid, snap=snap))
        members = []
        for osd_id in pg.acting:
            if osd_id != ITEM_NONE and osd_id >= 0 \
                    and osd_id not in members \
                    and (osd_id == self.osd.whoami
                         or self.osd.osdmap.is_up(osd_id)):
                # map-down members cannot answer: querying them only
                # burns the sub-read timeout per object — degraded
                # reads and recovery go straight to live shards
                members.append(osd_id)
        # per-version shard pools: {ver: {j: (bytes, size)}}
        by_ver: dict[tuple, dict[int, tuple]] = {}
        attrs_by_ver: dict[tuple, dict] = {}
        local = self._local_shard(pg, ho) \
            if self.osd.whoami in members else None
        if local is not None:
            j, buf, size, ver, lattrs = local
            by_ver.setdefault(ver, {})[j] = (buf, size)
            attrs_by_ver.setdefault(ver, dict(lattrs))
        remote = [o for o in members if o != self.osd.whoami]
        # ask the minimum first — planned through the codec's
        # minimum_to_decode so locality-aware codecs (LRC local
        # groups, SHEC shingle windows) fetch only their minimal
        # shard set, not the first k members; shortfall still widens
        # to everyone.  Falls back to the k-members heuristic when
        # the plan fails (too few live members: widening handles it).
        mapping = codec.get_chunk_mapping()
        want_pos = ({mapping[i] for i in range(k)} if mapping
                    else set(range(k)))
        pos_member = {pos: osd_id
                      for pos, osd_id in enumerate(pg.acting)
                      if osd_id in members}
        local_pos = next((p for p, o in pos_member.items()
                          if o == self.osd.whoami), None)
        minimal_pos = None
        try:
            minimal_pos = set(codec.minimum_to_decode(
                want_pos, set(pos_member)))
        except Exception:
            pass
        if minimal_pos is not None:
            minimal_members = {pos_member[p] for p in minimal_pos}
            first = [o for o in remote if o in minimal_members]
        else:
            have = 1 if local is not None else 0
            first = remote[:max(0, k - have)]
        rest = [o for o in remote if o not in first]
        self.last_read_plan = {
            "minimal": minimal_pos,
            "local": local_pos,
            "queried": {p for p, o in pos_member.items()
                        if o in first},
            "widened": False,
        }
        for batch in ([first, rest] if first else [rest]):
            if not batch:
                continue
            if batch is rest:
                self.last_read_plan["widened"] = True
                self.last_read_plan["queried"] |= {
                    p for p, o in pos_member.items() if o in rest}
            for sender, rows in \
                    (await self._sub_read(pg, oid, batch,
                                          snap=snap)).items():
                for (j, buf, sz, verw, rattrs) in rows:
                    ver = tuple(verw)
                    by_ver.setdefault(ver, {}).setdefault(
                        j, (buf, sz))
                    if rattrs:
                        attrs_by_ver.setdefault(ver, dict(rattrs))
            best = self._best_version(codec, k, by_ver)
            if best is not None:
                ver, use_pos = best
                chunks = {j: b for j, (b, _s) in
                          by_ver[ver].items() if j in use_pos}
                size = next(iter(by_ver[ver].values()))[1]
                try:
                    data = await codec.decode_concat_async(
                        chunks, chip=self._chip())
                except (IOError, OSError):
                    if self._chip_lost():
                        raise   # a device failure fails the op
                    continue  # widen to the remaining members
                return (data[:size], ver,
                        attrs_by_ver.get(ver, {}))
        return None, None, None

    def _best_version(self, codec, k, by_ver):
        """(version, decode shard set) for the newest version with a
        decodable shard set, else None.  Data positions come from the
        codec's chunk mapping — LRC-style layouts do NOT put data at
        0..k-1.

        Cost planning is `minimum_to_decode`-sized, not MDS-assumed:
        the old code fed EVERY gathered shard of the winning version
        to the decoder (the k-cost MDS assumption), which makes
        recovery-codec pools stage shards the plan never needed —
        SHEC decodes a shingle window, CLAY a sub-chunk plane subset,
        LRC a local group.  Now each candidate version's minimal plan
        is costed in sub-chunk units (a CLAY helper that ships
        d/q planes costs d/q of a shard, not 1), the newest decodable
        version still wins — serving an older version when a newer
        one is readable would be a stale read, so cost can never
        override recency — and the decode dispatch stages exactly the
        planned set.  Every candidate's cost lands in
        `last_version_plan` so tests and operators can audit what the
        cheaper plan saved."""
        mapping = codec.get_chunk_mapping()
        want = ({mapping[i] for i in range(k)} if mapping
                else set(range(k)))
        sub = max(1, codec.get_sub_chunk_count())
        candidates: dict = {}
        best = None
        for ver in sorted(by_ver, reverse=True):
            have = set(by_ver[ver])
            try:
                plan = dict(codec.minimum_to_decode(want, have))
            except Exception:
                continue
            use = set(plan) & have
            if not use:
                continue
            cost = sum(sum(cnt for _off, cnt in plan[p]) / sub
                       for p in use)
            candidates[ver] = {"shards": sorted(use),
                               "cost_chunks": round(cost, 4)}
            if best is None:
                best = (ver, use)
        self.last_version_plan = (
            None if best is None else
            {"version": best[0], "shards": sorted(best[1]),
             "cost_chunks": candidates[best[0]]["cost_chunks"],
             "candidates": candidates})
        return best

    async def _sub_read(self, pg: PG, oid: str,
                        members: list, snap: int = None,
                        off: int = 0, length: int = -1) -> dict:
        """One round of MOSDECSubOpRead to `members`; returns
        {sender: [(j, bytes, size, ver), ...]}.  snap targets a clone
        shard object; off/length select a shard byte range (-1 = the
        whole shard) — the ranged form is what makes partial-overwrite
        RMW traffic proportional to the touched extent."""
        self._tid += 1
        tid = self._tid
        ev = asyncio.Event()
        st = {"waiting": set(members), "event": ev, "buffers": {},
              "errors": {}}
        self._reads[tid] = st
        for osd_id in members:
            self.osd._send_osd(osd_id, MOSDECSubOpRead(
                pool=pg.pool_id, ps=pg.ps, shard=-1, tid=tid,
                reads=[[oid, length, snap, off]],
                epoch=self.osd.osdmap.epoch))
        try:
            await asyncio.wait_for(
                ev.wait(),
                float(self.osd.ctx.conf["osd_ec_subop_timeout"]))
        except asyncio.TimeoutError:
            pass
        self._reads.pop(tid, None)
        return st["buffers"]

    async def _fetch_xattr(self, pg: PG, oid: str,
                           name: str) -> bytes | None:
        """Client xattr read: local shard if present, else any member's
        shard attrs (xattrs are replicated to every shard)."""
        local = self._local_shard(pg, hobject_t(oid))
        if local is not None:
            return local[4].get(name)
        members = [o for o in pg.acting
                   if o != ITEM_NONE and 0 <= o != self.osd.whoami
                   and self.osd.osdmap.is_up(o)]
        for osd_id in members:
            rows = (await self._sub_read(pg, oid, [osd_id])) \
                .get(osd_id) or []
            if rows:
                attrs = rows[0][4] if len(rows[0]) > 4 else {}
                return attrs.get(name)
        return None

    def handle_sub_read(self, conn, msg: MOSDECSubOpRead) -> None:
        """Shard side (ECBackend::handle_sub_read): serves whatever
        shard index the stored bytes actually encode, with its version
        stamp and attrs."""
        from .osdmap import pg_t

        pg = self.osd.pgs.get(pg_t(msg.pool, msg.ps))
        buffers = []
        errors = []
        for row in msg.reads:
            oid = row[0]
            snap = row[2] if len(row) > 2 else None
            off = row[3] if len(row) > 3 else 0
            length = row[1] if len(row) > 1 else -1
            if pg is None:
                errors.append([oid, -2])
                continue
            ho = (hobject_t(oid) if snap is None
                  else hobject_t(oid, snap=snap))
            local = self._local_shard(pg, ho)
            if local is None:
                errors.append([oid, -2])
                continue
            j, buf, size, ver, attrs = local
            if length is not None and length >= 0:
                buf = buf[off:off + length]
            wire_attrs = {k: v for k, v in attrs.items()
                          if isinstance(k, str)}
            buffers.append([oid, j, buf, size, list(ver), wire_attrs])
        conn.send(MOSDECSubOpReadReply(
            pool=msg.pool, ps=msg.ps, shard=msg.shard, tid=msg.tid,
            buffers=buffers, errors=errors, epoch=msg.epoch))

    def handle_sub_read_reply(self, msg: MOSDECSubOpReadReply) -> None:
        st = self._reads.get(msg.tid)
        if st is None:
            return
        sender = int(msg.src.split(".")[1])
        rows = []
        for row in msg.buffers:
            oid, j, buf, sz, ver = row[0], row[1], row[2], row[3], \
                row[4]
            attrs = row[5] if len(row) > 5 else {}
            self.sub_read_bytes += len(buf)
            rows.append((j, buf, sz, ver, attrs))
        st["buffers"][sender] = rows
        for oid, err in msg.errors:
            st["errors"][sender] = err
        st["waiting"].discard(sender)
        if not st["waiting"]:
            st["event"].set()

    # -- recovery ----------------------------------------------------------

    def scan_stale_shards(self, pg: PG) -> dict[str, str]:
        """Objects whose stored bytes encode a different position than
        this osd now holds (after a remap reshuffled acting): they are
        effectively missing and must be reconstructed."""
        pos = None
        for j, o in enumerate(pg.acting):
            if o == self.osd.whoami:
                pos = j
                break
        if pos is None:
            return {}
        stale: dict[str, str] = {}
        from .pg import PGMETA_OID

        for ho in self.osd.store.collection_list(pg.cid):
            if ho.name == PGMETA_OID.name:
                continue
            local = self._local_shard(pg, ho)
            if local is None or local[0] != pos:
                stale[ho.name] = LogEntry.MODIFY
        return stale

    async def _reconstruct_shard(self, pg: PG, oid: str, j: int,
                                 klass: str, snap: int = None):
        """Rebuild ONLY position j's shard from the codec's minimal
        shard set (`minimum_to_decode({j}, survivors)`): LRC fetches
        the local group, SHEC the shingle window, CLAY only the
        repair planes (sub-chunk ranged reads), RS its k survivors —
        repair traffic proportional to the minimal set instead of a
        whole-object read + re-encode.  Returns
        (shard_bytes, size, ver, attrs, bytes_read), or None when the
        caller must fall back to the full read+re-encode path
        (version skew, stale layout, missing hinfo, unplannable
        loss).  The rebuilt shard is crc-checked against the
        survivors' hinfo vector before it is trusted."""
        import zlib
        pool = self.osd.osdmap.pools[pg.pool_id]
        codec = self.codec(pool)
        n = codec.get_chunk_count()
        avail = set()
        pos_member: dict[int, int] = {}
        for pos, osd_id in enumerate(pg.acting[:n]):
            if pos == j or osd_id == ITEM_NONE or osd_id < 0:
                continue
            if osd_id == self.osd.whoami \
                    or self.osd.osdmap.is_up(osd_id):
                avail.add(pos)
                pos_member[pos] = osd_id
        try:
            plan = dict(codec.minimum_to_decode({j}, avail))
        except Exception:
            return None
        if not plan or any(p not in pos_member for p in plan):
            return None
        sub = codec.get_sub_chunk_count()
        whole = [(0, sub)]
        partial = any(list(runs) != whole for runs in plan.values())
        ho = (hobject_t(oid) if snap is None
              else hobject_t(oid, snap=snap))

        async def fetch(pos: int, a: int = 0, ln: int = -1):
            """(bytes, size, ver, attrs) of shard `pos` [a, a+ln), or
            None."""
            member = pos_member[pos]
            if member == self.osd.whoami:
                loc = self._local_shard(pg, ho)
                if loc is None or loc[0] != pos:
                    return None
                buf = (loc[1] if ln < 0 else loc[1][a:a + ln])
                return bytes(buf), loc[2], loc[3], loc[4]
            rows = (await self._sub_read(
                pg, oid, [member], snap=snap, off=a,
                length=ln)).get(member) or []
            if not rows:
                return None
            rj, buf, sz, rver, rattrs = rows[0]
            if rj != pos:
                return None         # stale layout: full path heals
            return bytes(buf), sz, tuple(rver), (rattrs or {})

        if partial:
            # CLAY sub-chunk plan: learn the geometry from one
            # survivor's attrs (length-0 ranged read), then fetch
            # only each helper's repair planes
            pre = await fetch(sorted(plan)[0], 0, 0)
            if pre is None:
                return None
            _b, size, ver, attrs = pre
            cs = codec.get_chunk_size(size)
            if cs <= 0 or cs % sub:
                return None
            sc = cs // sub
            keys, coros = [], []
            for pos, runs in sorted(plan.items()):
                for off, cnt in runs:
                    keys.append(pos)
                    coros.append(fetch(pos, off * sc, cnt * sc))
            got = await asyncio.gather(*coros)
            helper: dict[int, list[bytes]] = {}
            nread = 0
            for pos, res in zip(keys, got):
                if res is None or res[2] != ver:
                    return None
                helper.setdefault(pos, []).append(res[0])
                nread += len(res[0])
            subchunks = {pos: b"".join(parts)
                         for pos, parts in helper.items()}
            expect = sum(cnt for runs in plan.values()
                         for _o, cnt in runs) * sc
            if sum(len(b) for b in subchunks.values()) != expect:
                return None
            repair = getattr(codec, "repair_async", None)
            if repair is None:
                return None
            shard = await repair(j, subchunks, klass=klass,
                                 chip=self._chip())
        else:
            got = await asyncio.gather(*[fetch(p)
                                         for p in sorted(plan)])
            chunks: dict[int, bytes] = {}
            size = ver = attrs = None
            nread = 0
            for pos, res in zip(sorted(plan), got):
                if res is None:
                    return None
                buf, sz, rver, rattrs = res
                if ver is None:
                    size, ver, attrs = sz, rver, dict(rattrs)
                elif rver != ver:
                    return None     # mixed generations: full path
                if rattrs.get(HINFO_XATTR) and \
                        not attrs.get(HINFO_XATTR):
                    attrs = dict(rattrs)
                chunks[pos] = buf
                nread += len(buf)
            lens = {len(c) for c in chunks.values()}
            if len(lens) != 1 or 0 in lens:
                return None
            decoded = await codec.decode_async(
                {j}, chunks, klass=klass, chip=self._chip())
            shard = decoded[j]
        hinfo_raw = (attrs or {}).get(HINFO_XATTR)
        if not hinfo_raw:
            return None
        try:
            crcs = [int(x) for x in hinfo_raw.split(b",")]
        except ValueError:
            return None
        if len(crcs) != n \
                or (zlib.crc32(shard) & 0xFFFFFFFF) != crcs[j]:
            return None             # untrusted rebuild: full path
        return shard, size, ver, attrs, nread

    def _push_attrs(self, attrs: dict, j: int, size: int,
                    ver) -> dict:
        """Survivor attrs re-stamped for the rebuilt shard (hinfo is
        already the full per-shard crc vector, identical on every
        member)."""
        out = dict(attrs)
        out[SIZE_XATTR] = b"%d" % size
        out[SHARD_XATTR] = b"%d" % j
        out[VER_XATTR] = _ver_bytes(ver)
        return out

    async def recover_peer_shards(self, pg: PG, osd_id: int,
                                  missing: dict) -> None:
        """Reconstruct each missing object's TARGET shard and push it
        (ECBackend::continue_recovery_op)."""
        j = None
        for pos, o in enumerate(pg.acting):
            if o == osd_id:
                j = pos
                break
        if j is None:
            return
        pool = self.osd.osdmap.pools[pg.pool_id]
        codec = self.codec(pool)
        pushes = []
        for oid, op in sorted(missing.items()):
            # per-object mClock admission: reconstruction yields to
            # client I/O (mClockScheduler background_recovery class)
            from .scheduler import K_RECOVERY
            await self.osd.sched.admit(K_RECOVERY,
                                       key=(pg.pool_id, pg.ps))
            async with self.oid_lock(pg, oid):
                if oid not in pg.peer_missing.get(osd_id, {}):
                    continue  # superseded by a newer write
                if op == LogEntry.DELETE:
                    pushes.append({"oid": oid, "delete": True})
                    continue
                n = codec.get_chunk_count()
                from ..device.runtime import K_RECOVERY_EC
                cname = self._codec_name(pool)
                # targeted repair first: rebuild ONLY the target's
                # shard from the codec's minimal shard set (LRC local
                # group / SHEC shingle window / CLAY repair planes /
                # RS k survivors), with the bytes it actually moved
                # accounted per codec
                rec = await self._reconstruct_shard(
                    pg, oid, j, K_RECOVERY_EC)
                if rec is not None:
                    shard, size, ver, rattrs, nread = rec
                    attrs = self._push_attrs(rattrs, j, size, ver)
                    pushes.append({"oid": oid, "delete": False,
                                   "data": shard, "attrs": attrs,
                                   "omap": {}})
                    self.note_repair(cname, nread, len(shard))
                else:
                    # full path: whole-object read + re-encode (also
                    # the version-skew / stale-layout healer)
                    read0 = self.sub_read_bytes
                    data, ver, rattrs = await self.read_object_attrs(
                        pg, oid)
                    if data is None:
                        pushes.append({"oid": oid, "delete": True})
                        continue
                    shards = await codec.encode_async(
                        set(range(n)), data, klass=K_RECOVERY_EC,
                        chip=self._chip())
                    # user xattrs: local shard first, else the attrs
                    # the surviving shards returned with the read
                    # replies (the primary's own shard may be missing
                    # too)
                    try:
                        attrs = dict(self.osd.store.getattrs(
                            pg.cid, hobject_t(oid)))
                    except NotFound:
                        attrs = dict(rattrs or {})
                    attrs[SIZE_XATTR] = b"%d" % len(data)
                    attrs[SHARD_XATTR] = b"%d" % j
                    attrs[VER_XATTR] = _ver_bytes(ver)
                    attrs[HINFO_XATTR] = hinfo_bytes(shards)
                    pushes.append({"oid": oid, "delete": False,
                                   "data": shards[j], "attrs": attrs,
                                   "omap": {}})
                    self.note_repair(
                        cname, self.sub_read_bytes - read0,
                        len(shards[j]), targeted=False)
                # clone shards travel too (snap reads after recovery)
                from . import snaps as snapmod
                ssraw = attrs.get(snapmod.SNAPSET_ATTR)
                if ssraw:
                    ss = denc.decode(ssraw)
                    for c in ss.get("clones", []):
                        crec = await self._reconstruct_shard(
                            pg, oid, j, K_RECOVERY_EC, snap=int(c))
                        if crec is not None:
                            cshard, csz, cver, cattrs, cread = crec
                            ca = self._push_attrs(cattrs, j, csz,
                                                  cver)
                            pushes.append({"oid": oid,
                                           "snap": int(c),
                                           "delete": False,
                                           "data": cshard,
                                           "attrs": ca, "omap": {}})
                            self.note_repair(cname, cread,
                                             len(cshard))
                            continue
                        cd, cver, cattrs = \
                            await self.read_object_attrs(
                                pg, oid, snap=int(c))
                        if cd is None:
                            continue
                        cshards = await codec.encode_async(
                            set(range(n)), cd, klass=K_RECOVERY_EC,
                            chip=self._chip())
                        ca = dict(cattrs or {})
                        ca[SIZE_XATTR] = b"%d" % len(cd)
                        ca[SHARD_XATTR] = b"%d" % j
                        ca[VER_XATTR] = _ver_bytes(cver)
                        ca[HINFO_XATTR] = hinfo_bytes(cshards)
                        pushes.append({"oid": oid, "snap": int(c),
                                       "delete": False,
                                       "data": cshards[j],
                                       "attrs": ca, "omap": {}})
        if pushes:
            pg.stats.note_recovery(0, sum(
                len(p.get("data") or b"") for p in pushes))
            self.osd._send_osd(osd_id, MOSDPGPush(
                pool=pg.pool_id, ps=pg.ps,
                epoch=self.osd.osdmap.epoch, pushes=pushes))

    async def recover_primary_shards(self, pg: PG) -> None:
        """Rebuild the primary's own missing shards from survivors."""
        j = None
        for pos, o in enumerate(pg.acting):
            if o == self.osd.whoami:
                j = pos
                break
        if j is None:
            return
        for oid, op in sorted(pg.missing.items()):
            from .scheduler import K_RECOVERY
            await self.osd.sched.admit(K_RECOVERY,
                                       key=(pg.pool_id, pg.ps))
            async with self.oid_lock(pg, oid):
                if oid not in pg.missing:
                    continue  # superseded by a newer write
                ho = hobject_t(oid)
                t = Transaction()
                if op == LogEntry.DELETE:
                    if self.osd.store.exists(pg.cid, ho):
                        t.remove(pg.cid, ho)
                else:
                    from ..device.runtime import K_RECOVERY_EC
                    pool = self.osd.osdmap.pools[pg.pool_id]
                    codec = self.codec(pool)
                    cname = self._codec_name(pool)
                    rec = await self._reconstruct_shard(
                        pg, oid, j, K_RECOVERY_EC)
                    if rec is not None:
                        shard, size, ver, rattrs, nread = rec
                        user = {ak: av for ak, av in rattrs.items()
                                if ak not in (SIZE_XATTR,
                                              SHARD_XATTR,
                                              VER_XATTR,
                                              HINFO_XATTR)}
                        t = self._shard_txn(
                            pg, ho, shard, j, size, ver, user,
                            rattrs.get(HINFO_XATTR))
                        self.note_repair(cname, nread, len(shard))
                    else:
                        read0 = self.sub_read_bytes
                        data, ver = await self.read_object(pg, oid)
                        if data is None:
                            pg.missing.pop(oid, None)
                            continue
                        n = codec.get_chunk_count()
                        shards = await codec.encode_async(
                            set(range(n)), data, klass=K_RECOVERY_EC,
                            chip=self._chip())
                        t = self._shard_txn(pg, ho, shards[j], j,
                                            len(data), ver, None,
                                            hinfo_bytes(shards))
                        self.note_repair(
                            cname, self.sub_read_bytes - read0,
                            len(shards[j]), targeted=False)
                pg.missing.pop(oid, None)
                pg.stats.note_recovery(1)
                pg.persist_meta(t)
                self.osd.store.apply_transaction(t)
                # rebuild local clone shards listed by the snapset
                from . import snaps as snapmod
                ss = snapmod.load_snapset(self.osd.store, pg.cid, ho)
                for c in (ss or {}).get("clones", []):
                    cho = hobject_t(oid, snap=int(c))
                    if self.osd.store.exists(pg.cid, cho):
                        continue
                    cd, cver = await self.read_object(pg, oid,
                                                      snap=int(c))
                    if cd is None:
                        continue
                    codec = self.codec(
                        self.osd.osdmap.pools[pg.pool_id])
                    n = codec.get_chunk_count()
                    from ..device.runtime import K_RECOVERY_EC
                    cshards = await codec.encode_async(
                        set(range(n)), cd, klass=K_RECOVERY_EC,
                    chip=self._chip())
                    ct = self._shard_txn(pg, cho, cshards[j], j,
                                         len(cd), cver, None,
                                         hinfo_bytes(cshards))
                    self.osd.store.apply_transaction(ct)


_EC_WRITE_OPS = {"write", "writefull", "delete", "truncate",
                 "setxattr"}
