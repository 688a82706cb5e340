"""PGMap: the mgr's fold of every OSD's per-PG stat rows.

Condensed analog of src/mon/PGMap.{h,cc} as maintained by the
MgrStatMonitor pipeline (OSD MPGStats -> DaemonServer -> PGMap
apply_incremental): primaries ship a stat row per PG they serve
(object/byte counts, degraded/misplaced/unfound tallies, cumulative
client-IO and recovery counters) inside their MMgrReports; this class
keeps the latest row per PG, derives **rates** from the delta between
two consecutive reports of the same primary (PGMap's pool_statfs
delta machinery), and renders:

* per-pool and cluster-wide totals (objects, bytes, degraded,
  misplaced, unfound) — the `df` / `osd pool stats` surface;
* client read/write ops/s + bytes/s and recovery objects/s + bytes/s
  — the `ceph -s` io: / recovery: lines;
* the digest the mgr periodically sends the monitors (MMonMgrDigest),
  from which the mon serves `status`/`df` and raises PG_DEGRADED /
  PG_AVAILABILITY.

Counter resets (primary restart or failover) surface as negative
deltas and clamp to zero — exactly one digest period of undercounted
rate, never a negative or wildly inflated one.

**Columnar storage + columnar ingest** (the telemetry fabric): at
100k-1M PG rows both the per-tick fold AND the per-report merge
dominate the mgr, so rows live in flat numpy columns — one
int64/float64 array per stat — keyed by the integer pgid key
``pool << 32 | seed`` rather than the pgid string.  Folds are
vectorized masked passes (staleness window, pool filter, per-pool
segment sums), and a packed columnar report block
(``msg.statblock``: the MMgrReport ``pg_stats_cols`` field) merges as
ONE searchsorted + masked scatter per report — rate derivation,
counter-reset clamping and primary-change resets included — instead
of a python loop per row.  Legacy dict-shaped ``pg_stats`` rows take
the original row-wise path into the same columns, so mixed fleets
converge to one digest.  `DictPGMap` below preserves the original
dict-of-rows implementation as the golden reference both paths are
pinned against (and the ingest/fold micro-benchmarks' baseline).

**Pruning**: stale rows (dead primaries past the prune window) and
deleted-pool rows compact OUT of the column store as a vectorized
keep-mask pass, with visible counters (``pruned_stale`` /
``pruned_pool`` / ``pruned_daemons`` — the exporter's
``ceph_tpu_mgr_rows_pruned_total``) instead of silent drops; the
staleness *fold* masks are unchanged, pruning only reclaims rows the
folds already ignore.
"""

from __future__ import annotations

import time as _time

import numpy as np

from ..msg import statblock

RATE_COUNTERS = ("read_ops", "read_bytes", "write_ops", "write_bytes",
                 "recovery_ops", "recovery_bytes")

# digest keys carrying the per-second forms of RATE_COUNTERS
RATE_KEYS = tuple(c + "_s" for c in RATE_COUNTERS)

# columnar int stats: (column name, wire/row key, output key)
_INT_COLS = (("pool", "pool", None),
             ("num_objects", "num_objects", "objects"),
             ("num_bytes", "num_bytes", "bytes"),
             ("degraded", "degraded", "degraded"),
             ("misplaced", "misplaced", "misplaced"),
             ("unfound", "unfound", "unfound"),
             ("log_size", "log_size", "log_size"),
             ("scrub_errors", "scrub_errors", "scrub_errors"))

# the packed wire block's column orders must mirror the store's (the
# scatter assigns positionally); a drift here is a bug, not a skew
assert statblock.STAT_CTR_COLS == RATE_COUNTERS
assert statblock.STAT_INT_COLS == tuple(w for _c, w, _o in _INT_COLS)


def _new_ingest() -> dict:
    """Ingest accounting shared by PGMap and DictPGMap: reports/rows/
    bytes per wire format, the apply-latency pow2-µs histogram
    (``ceph_tpu_mgr_ingest_seconds``), and the count of block rows
    that had to fall back to the row-wise loop (the fast-path
    coverage oracle — 0 in a healthy fleet)."""
    return {"reports": {"columnar": 0, "legacy": 0},
            "rows": {"columnar": 0, "legacy": 0},
            "bytes": {"columnar": 0, "legacy": 0},
            "fallback_rows": 0,
            "seconds_hist": [0] * 32}


def _note_ingest(ing: dict, fmt: str, cols_rows: int,
                 legacy_rows: int, nbytes: int,
                 seconds: float) -> None:
    """One report's accounting.  The report counts once under its
    dominant format (columnar if a block is present); row counts
    split by the wire shape each row actually arrived in, so a
    mixed-field report never skews the per-format rows series."""
    ing["reports"][fmt] += 1
    ing["rows"]["columnar"] += cols_rows
    ing["rows"]["legacy"] += legacy_rows
    ing["bytes"][fmt] += int(nbytes)
    us = int(seconds * 1e6)
    ing["seconds_hist"][max(0, min(31, us.bit_length() - 1))] += 1


class _RatesView:
    """Read-only dict-shaped view over the rate columns (the
    ``pm.rates[pgid]`` surface the stats tests and exporter keep)."""

    def __init__(self, pm: "PGMap"):
        self._pm = pm

    def _row(self, pgid) -> int | None:
        row = self._pm._row_of(pgid)
        if row is None or not self._pm._has_rate[row]:
            return None
        return row

    def __contains__(self, pgid) -> bool:
        return self._row(pgid) is not None

    def __getitem__(self, pgid) -> dict:
        row = self._row(pgid)
        if row is None:
            raise KeyError(pgid)
        return {k: float(self._pm._rate[i][row])
                for i, k in enumerate(RATE_KEYS)}

    def get(self, pgid, default=None):
        return self[pgid] if pgid in self else default


class PGMap:
    def __init__(self, stale_after: float = 15.0):
        self.stale_after = float(stale_after)
        self._n = 0
        self._cap = 0
        self._int: dict[str, np.ndarray] = {}       # int64 stats
        self._ctr: list[np.ndarray] = []            # RATE_COUNTERS
        self._rate: list[np.ndarray] = []           # RATE_KEYS
        self._keys = np.empty(0, np.int64)          # pool<<32|seed
        self._stamp = np.empty(0, np.float64)
        self._from = np.empty(0, np.int32)          # interned daemon
        self._state = np.empty(0, np.int16)         # interned state
        self._has_rate = np.empty(0, bool)
        # (sorted key array, row-of-sorted-position) — the searchsorted
        # index; None = dirty.  Rows allocated since the last rebuild
        # sit in _pending so scalar lookups never force a resort.
        self._sorted: tuple[np.ndarray, np.ndarray] | None = None
        self._pending: dict[int, int] = {}
        # daemon code -> (last block's key array, resolved rows):
        # the steady-state ingest shortcut (cleared on compaction)
        self._daemon_rows: dict[int, tuple] = {}
        # pgids outside the canonical "pool.seed" shape get synthetic
        # negative keys (never collide with parsed keys, which are >=0)
        self._str_keys: dict[str, int] = {}
        self._daemon_codes: dict[str, int] = {}
        self._state_codes: dict[str, int] = {}
        self._state_names: list[str] = []
        self.rates = _RatesView(self)
        # daemon -> {"op_size_hist_bytes_pow2": [...], "_stamp": t}
        # (bounded: one row per reporting daemon, never per-PG)
        self.osd_stats: dict[str, dict] = {}
        # daemon -> stamp of its last report of ANY shape (freshness
        # axis: shells report pg rows with osd_stats=None)
        self.report_stamps: dict[str, float] = {}
        self.ingest = _new_ingest()
        self.pruned_stale = 0
        self.pruned_pool = 0
        self.pruned_daemons = 0

    # -- column plumbing ---------------------------------------------------

    def _grow(self, need: int) -> None:
        new_cap = max(256, self._cap)
        while new_cap < need:
            new_cap *= 2
        pad = new_cap - self._cap

        def ext(arr, fill=0):
            return np.concatenate(
                [arr, np.full(pad, fill, arr.dtype)])

        if not self._cap:
            self._int = {c: np.zeros(new_cap, np.int64)
                         for c, _w, _o in _INT_COLS}
            self._ctr = [np.zeros(new_cap, np.float64)
                         for _ in RATE_COUNTERS]
            self._rate = [np.zeros(new_cap, np.float64)
                          for _ in RATE_KEYS]
            self._keys = np.zeros(new_cap, np.int64)
            self._stamp = np.zeros(new_cap, np.float64)
            self._from = np.full(new_cap, -1, np.int32)
            self._state = np.zeros(new_cap, np.int16)
            self._has_rate = np.zeros(new_cap, bool)
        else:
            for k in list(self._int):
                self._int[k] = ext(self._int[k])
            self._ctr = [ext(a) for a in self._ctr]
            self._rate = [ext(a) for a in self._rate]
            self._keys = ext(self._keys)
            self._stamp = ext(self._stamp)
            self._from = ext(self._from, -1)
            self._state = ext(self._state)
            self._has_rate = ext(self._has_rate, False)
        self._cap = new_cap

    def _pgid_key(self, pgid: str) -> int:
        try:
            pool_s, dot, seed_s = pgid.partition(".")
            if dot:
                pool = int(pool_s)
                seed = int(seed_s, 16)
                if (0 <= pool <= statblock._POOL_MAX
                        and 0 <= seed <= statblock._SEED_MAX):
                    return (pool << 32) | seed
            raise ValueError(pgid)
        except ValueError:
            k = self._str_keys.get(pgid)
            if k is None:
                k = -(len(self._str_keys) + 1)
                self._str_keys[pgid] = k
            return k

    def _ensure_index(self) -> None:
        if self._sorted is not None and not self._pending:
            return
        keys = self._keys[:self._n]
        order = np.argsort(keys, kind="stable").astype(np.int64)
        self._sorted = (keys[order], order)
        self._pending.clear()

    def _row_of_key(self, key: int) -> int | None:
        row = self._pending.get(key)
        if row is not None:
            return row
        if self._sorted is None:
            self._ensure_index()
        sk, sr = self._sorted
        i = int(np.searchsorted(sk, key))
        if i < sk.size and sk[i] == key:
            return int(sr[i])
        return None

    def _row_of(self, pgid: str) -> int | None:
        return self._row_of_key(self._pgid_key(pgid))

    def _alloc_row(self, key: int) -> int:
        if self._n >= self._cap:
            self._grow(self._n + 1)
        row = self._n
        self._n += 1
        self._keys[row] = key
        self._pending[key] = row
        return row

    def _alloc_rows(self, new_keys: np.ndarray) -> None:
        """Bulk allocation for a columnar block's unseen pgids: one
        capacity growth, one key scatter, and an O(n+m) merge of the
        (sorted) new keys into the sorted index — never a resort, so
        a fleet's worth of first-sight blocks stays linear."""
        m = new_keys.size
        need = self._n + m
        if need > self._cap:
            self._grow(need)
        new_rows = np.arange(self._n, need, dtype=np.int64)
        self._keys[self._n:need] = new_keys
        self._n = need
        sk, sr = self._sorted
        # one manual two-array merge (np.insert would re-derive the
        # destination mask per array): new keys land at their sorted
        # positions, the old index shifts around them
        dest = np.searchsorted(sk, new_keys) + np.arange(m)
        total = sk.size + m
        out_k = np.empty(total, np.int64)
        out_r = np.empty(total, np.int64)
        hole = np.ones(total, bool)
        hole[dest] = False
        out_k[dest] = new_keys
        out_r[dest] = new_rows
        out_k[hole] = sk
        out_r[hole] = sr
        self._sorted = (out_k, out_r)

    def _daemon_code(self, daemon: str) -> int:
        code = self._daemon_codes.get(daemon)
        if code is None:
            code = len(self._daemon_codes)
            self._daemon_codes[daemon] = code
        return code

    def _state_code(self, state: str) -> int:
        code = self._state_codes.get(state)
        if code is None:
            code = len(self._state_names)
            self._state_codes[state] = code
            self._state_names.append(state)
        return code

    @property
    def num_rows(self) -> int:
        return self._n

    # -- ingest ------------------------------------------------------------

    def apply_report(self, daemon: str, pg_stats: list | None,
                     osd_stats: dict | None, stamp: float,
                     pg_stats_cols: dict | None = None,
                     nbytes: int | None = None) -> None:
        """Fold one daemon's report in.  `stamp` is the receiver's
        clock at arrival (injectable for exact-delta tests).
        ``pg_stats_cols`` is the packed columnar block (statblock) the
        vectorized merge ingests; dict-shaped ``pg_stats`` rows keep
        the row-wise path.  A malformed block falls back to the row
        loop (counted in ``ingest["fallback_rows"]``) — never raises.
        """
        t0 = _time.perf_counter()
        self.report_stamps[daemon] = stamp
        if osd_stats:
            row = dict(osd_stats)
            row["_stamp"] = stamp
            self.osd_stats[daemon] = row
        fmt = "legacy"
        cols_rows = 0
        if pg_stats_cols is not None:
            fmt = "columnar"
            did = self._daemon_code(daemon)
            try:
                cols_rows = self._apply_cols(did, pg_stats_cols,
                                             stamp)
            except Exception:
                try:
                    rows = statblock.unpack_stat_rows(pg_stats_cols)
                except Exception:
                    rows = []
                self.ingest["fallback_rows"] += len(rows)
                cols_rows = len(rows)
                self._apply_rows(did, rows, stamp)
        if pg_stats:
            self._apply_rows(self._daemon_code(daemon), pg_stats,
                             stamp)
        if nbytes is None:
            nbytes = (statblock.block_nbytes(pg_stats_cols)
                      if pg_stats_cols is not None else 0)
        _note_ingest(self.ingest, fmt, cols_rows,
                     len(pg_stats or ()), nbytes,
                     _time.perf_counter() - t0)

    def _apply_rows(self, did: int, pg_stats: list,
                    stamp: float) -> None:
        """The original row-wise merge (legacy dict rows + the
        malformed-block fallback)."""
        for st in pg_stats:
            pgid = st.get("pgid")
            if not pgid:
                continue
            key = self._pgid_key(pgid)
            row = self._row_of_key(key)
            fresh = row is None
            if fresh:
                row = self._alloc_row(key)
            same_primary = (not fresh and self._from[row] == did)
            if same_primary:
                dt = stamp - self._stamp[row]
                if dt > 0:
                    for i, c in enumerate(RATE_COUNTERS):
                        cur = float(st.get(c, 0))
                        self._rate[i][row] = max(
                            0.0, (cur - self._ctr[i][row]) / dt)
                    self._has_rate[row] = True
            else:
                # new PG or a primary change: no comparable base —
                # rates restart from the next delta
                self._has_rate[row] = False
                for i in range(len(RATE_KEYS)):
                    self._rate[i][row] = 0.0
            for c, w, _o in _INT_COLS:
                self._int[c][row] = int(st.get(w, 0))
            for i, c in enumerate(RATE_COUNTERS):
                self._ctr[i][row] = float(st.get(c, 0))
            self._state[row] = self._state_code(
                st.get("state", "unknown"))
            self._from[row] = did
            self._stamp[row] = stamp

    def _apply_cols(self, did: int, block: dict, stamp: float) -> int:
        """The vectorized merge: one searchsorted over the int64 pgid
        keys, bulk allocation for unseen PGs, then masked column
        scatters reproducing the row loop's exact semantics — rate
        derivation over the per-row dt, counter-reset clamping at 0,
        rate reset on primary change, state dictionary translation."""
        cols = statblock.block_cols(block)
        n = cols["n"]
        if not n:
            return 0
        keys = (cols["pg_pool"] << 32) | cols["pg_seed"]
        # steady-state shortcut: a primary's PG set rarely changes
        # between reports, so its key->row resolution is cached and
        # revalidated with one vector compare (row indices are stable
        # until a prune compaction, which clears the cache)
        cached = self._daemon_rows.get(did)
        if cached is not None and cached[0].size == n \
                and np.array_equal(cached[0], keys):
            rows = cached[1]
        else:
            # duplicate pgids within one block would hit the masked
            # scatters with repeated indices (last-write-wins) and a
            # single rate derivation — not the row loop's
            # per-occurrence semantics.  Producers mint unique pgids;
            # a malformed block takes the row-wise fallback.  (A cache
            # hit implies the key set already passed this check.)
            ks = np.sort(keys)
            if n > 1 and (ks[1:] == ks[:-1]).any():
                raise ValueError("duplicate pgids in block")
            self._ensure_index()
            sk, sr = self._sorted
            rows = np.empty(n, np.int64)
            if sk.size:
                pos = np.minimum(np.searchsorted(sk, keys),
                                 sk.size - 1)
                found = sk[pos] == keys
                rows[found] = sr[pos[found]]
            else:
                found = np.zeros(n, bool)
            if not found.all():
                miss = ~found
                # allocation order == sorted key order, so unique's
                # inverse indexes the new rows directly (no re-search)
                uniq, inv = np.unique(keys[miss],
                                      return_inverse=True)
                base = self._n
                self._alloc_rows(uniq)
                rows[miss] = base + inv
            self._daemon_rows[did] = (keys, rows)
        # rate semantics, row-loop exact: same primary + dt>0 derives
        # clamped rates; a primary change (or fresh row: _from == -1)
        # zeroes them; same primary with dt<=0 leaves them untouched
        same = self._from[rows] == did
        dt = stamp - self._stamp[rows]
        rate_ok = same & (dt > 0)
        if rate_ok.any():
            rr = rows[rate_ok]
            dtv = dt[rate_ok]
            for i in range(len(RATE_COUNTERS)):
                cur = cols["ctrs"][i][rate_ok].astype(np.float64)
                self._rate[i][rr] = np.maximum(
                    0.0, (cur - self._ctr[i][rr]) / dtv)
            self._has_rate[rr] = True
        reset = ~same
        if reset.any():
            rr = rows[reset]
            self._has_rate[rr] = False
            for i in range(len(RATE_KEYS)):
                self._rate[i][rr] = 0.0
        for (c, _w, _o), arr in zip(_INT_COLS, cols["ints"]):
            self._int[c][rows] = arr
        for i in range(len(RATE_COUNTERS)):
            self._ctr[i][rows] = cols["ctrs"][i].astype(np.float64)
        names = cols["state_names"]
        if names:
            trans = np.asarray([self._state_code(s) for s in names],
                               np.int16)
            self._state[rows] = trans[cols["state"]]
        self._from[rows] = did
        self._stamp[rows] = stamp
        return n

    # -- pruning -----------------------------------------------------------

    def prune(self, now: float, pools: set | None = None,
              after: float | None = None) -> dict:
        """Compact stale rows (no report within `after`, default the
        staleness window) and deleted-pool rows out of the column
        store, and expire per-daemon extras the same way.  Every drop
        is counted (``pruned_stale`` / ``pruned_pool`` /
        ``pruned_daemons`` -> ``ceph_tpu_mgr_rows_pruned_total``) —
        rows leave the mgr visibly, never silently.  The fold masks
        are unchanged; pruning reclaims rows they already ignore."""
        after = self.stale_after if after is None else float(after)
        n = self._n
        dropped_stale = dropped_pool = 0
        if n:
            fresh = (now - self._stamp[:n]) <= after
            keep = fresh
            if pools is not None:
                in_pool = np.isin(
                    self._int["pool"][:n],
                    np.fromiter((int(p) for p in pools), np.int64,
                                count=len(pools)))
                dropped_pool = int(np.count_nonzero(fresh & ~in_pool))
                keep = fresh & in_pool
            dropped_stale = int(np.count_nonzero(~fresh))
            k = int(np.count_nonzero(keep))
            if k < n:
                idx = np.nonzero(keep)[0]
                for c in self._int:
                    self._int[c][:k] = self._int[c][idx]
                for arr in self._ctr:
                    arr[:k] = arr[idx]
                for arr in self._rate:
                    arr[:k] = arr[idx]
                self._keys[:k] = self._keys[idx]
                self._stamp[:k] = self._stamp[idx]
                self._from[:k] = self._from[idx]
                self._state[:k] = self._state[idx]
                self._has_rate[:k] = self._has_rate[idx]
                # reset the freed tail: _alloc_row/_alloc_rows only
                # write _keys, so a PG later allocated onto a recycled
                # slot must read _from == -1 (fresh), never a dead
                # row's primary — else the merge would derive a rate
                # from the dead row's counters/stamp
                self._from[k:n] = -1
                self._stamp[k:n] = 0.0
                self._has_rate[k:n] = False
                self._n = k
                self._sorted = None
                self._pending.clear()
                self._daemon_rows.clear()   # row indices moved
                self.pruned_stale += dropped_stale
                self.pruned_pool += dropped_pool
            else:
                dropped_stale = dropped_pool = 0
        dropped_daemons = 0
        for d in [d for d, t in self.report_stamps.items()
                  if now - t > after]:
            del self.report_stamps[d]
            self.osd_stats.pop(d, None)
            dropped_daemons += 1
        self.pruned_daemons += dropped_daemons
        return {"stale": dropped_stale, "pool": dropped_pool,
                "daemons": dropped_daemons}

    # -- vectorized fold ---------------------------------------------------

    def _live_mask(self, now: float, pools: set | None) -> np.ndarray:
        n = self._n
        live = (now - self._stamp[:n]) <= self.stale_after
        if pools is not None:
            live &= np.isin(self._int["pool"][:n],
                            np.fromiter((int(p) for p in pools),
                                        np.int64,
                                        count=len(pools)))
        return live

    def pool_totals(self, now: float,
                    pools: set | None = None) -> dict[int, dict]:
        """Per-pool sums of the live stat rows + their rates — one
        masked segment-sum pass over the columns."""
        if not self._n:
            return {}
        idx = np.nonzero(self._live_mask(now, pools))[0]
        if not idx.size:
            return {}
        uniq, inv = np.unique(self._int["pool"][idx],
                              return_inverse=True)
        k = uniq.size
        out = {int(p): {"num_pgs": 0, "objects": 0, "bytes": 0,
                        "degraded": 0, "misplaced": 0, "unfound": 0,
                        "log_size": 0, **{rk: 0.0 for rk in RATE_KEYS}}
               for p in uniq}
        counts = np.bincount(inv, minlength=k)
        for p, c in zip(uniq, counts):
            out[int(p)]["num_pgs"] = int(c)
        for c, _w, o in _INT_COLS:
            if o is None:
                continue
            acc = np.zeros(k, np.int64)
            np.add.at(acc, inv, self._int[c][idx])
            for p, v in zip(uniq, acc):
                out[int(p)][o] = int(v)
        for i, rk in enumerate(RATE_KEYS):
            acc = np.bincount(inv, weights=self._rate[i][idx],
                              minlength=k)
            for p, v in zip(uniq, acc):
                out[int(p)][rk] = float(v)
        return out

    def pg_state_counts(self, now: float,
                        pools: set | None = None) -> dict[str, int]:
        if not self._n:
            return {}
        idx = np.nonzero(self._live_mask(now, pools))[0]
        if not idx.size:
            return {}
        counts = np.bincount(self._state[idx],
                             minlength=len(self._state_names))
        return {self._state_names[i]: int(n)
                for i, n in enumerate(counts) if n}

    def inconsistent_pgs(self, now: float,
                         pools: set | None = None) -> int:
        """Live PGs whose last scrub left a nonzero residual error
        count — the PG_DAMAGED input (one vectorized mask pass)."""
        if not self._n:
            return 0
        mask = self._live_mask(now, pools)
        return int(np.count_nonzero(
            self._int["scrub_errors"][:self._n][mask]))

    # -- daemon-extra views (bounded dicts, unchanged shape) ---------------

    def live_osd_stats(self, now: float) -> dict[str, dict]:
        """Per-daemon extras (statfs, clog counters) from reports
        still within the staleness window."""
        return {d: row for d, row in self.osd_stats.items()
                if now - row["_stamp"] <= self.stale_after}

    def op_size_hist(self, now: float) -> list[int]:
        """Element-wise sum of every live daemon's op-size histogram
        (pow2 byte buckets)."""
        total: list[int] = []
        for row in self.osd_stats.values():
            if now - row["_stamp"] > self.stale_after:
                continue
            hist = row.get("op_size_hist_bytes_pow2") or []
            if len(hist) > len(total):
                total.extend([0] * (len(hist) - len(total)))
            for i, n in enumerate(hist):
                total[i] += n
        return total

    def report_freshness(self, now: float) -> dict:
        """Per-daemon report-age summary (bounded: one scalar pass
        over the stamps, never per-PG data): daemon count, the worst
        age + its daemon, how many daemons are past the staleness
        window, and the cumulative prune counters — the digest's
        `reports` section `status` renders as its max-age/stale line.
        """
        out = {"daemons": len(self.report_stamps),
               "max_age": 0.0, "max_age_daemon": None, "stale": 0,
               "pruned_stale_rows": self.pruned_stale,
               "pruned_pool_rows": self.pruned_pool,
               "pruned_daemons": self.pruned_daemons}
        for d, t in self.report_stamps.items():
            age = max(0.0, now - t)
            if age > out["max_age"] or out["max_age_daemon"] is None:
                out["max_age"] = round(age, 3)
                out["max_age_daemon"] = d
            if age > self.stale_after:
                out["stale"] += 1
        return out

    def digest(self, now: float, osdmap=None) -> dict:
        """The mon-bound digest (MMonMgrDigest payload): everything
        `status`/`df`/`osd pool stats` and the PG_* health checks
        need, with no raw per-PG rows (bounded size)."""
        pools = set(osdmap.pools) if osdmap is not None else None
        per_pool = self.pool_totals(now, pools)
        states = self.pg_state_counts(now, pools)
        totals = {
            "objects": 0, "bytes": 0, "degraded": 0,
            "misplaced": 0, "unfound": 0, "scrub_errors": 0,
            **{k: 0.0 for k in RATE_KEYS}}
        for row in per_pool.values():
            for k in totals:
                totals[k] += row[k]
        inactive = sum(n for s, n in states.items()
                       if s not in ("active", "replica"))
        # per-OSD raw capacity (the statfs axis `df` renders): bounded
        # — one small row per reporting daemon, never per-PG data
        osd_rows = {}
        # per-chip device utilization: each daemon reports ITS
        # affinity chip's integrals; fold one row per chip, freshest
        # report wins (co-located daemons share a chip and report
        # identical figures off the same ChipRuntime ring)
        device_util: dict[int, dict] = {}
        dev_stamp: dict[int, float] = {}
        # per-codec repair traffic: each daemon reports cumulative
        # counters, the digest sums across the live fleet (the
        # repair-bytes comparison oracle's committed surface)
        repair_traffic: dict[str, dict] = {}
        # per-pool dedup totals: each primary reports its cumulative
        # data-reduction counters, the digest sums across the fleet
        # (the `status` dedup panel + bench --dedup oracle surface)
        dedup_pools: dict[str, dict] = {}
        # long-flow progress rows (recovery drains, scrub sweeps):
        # keyed "daemon:flowid" so two OSDs' drains never collide —
        # `status` renders them and the mon leader diffs them into
        # progress_start/finish bus events
        progress: dict[str, dict] = {}
        # network plane: one bounded row per reporting daemon — wire
        # rates the producer computed over its own report interval,
        # the RTT rollup, and the per-peer 5s RTTs (the cluster RTT
        # matrix row); the full per-peer wire detail stays in
        # osd_stats for the exporter and never rides the digest
        net: dict[str, dict] = {}
        for d, row in self.live_osd_stats(now).items():
            nrow = row.get("net")
            if nrow:
                net[d] = {
                    "tx_Bps": float(nrow.get("tx_Bps", 0.0) or 0.0),
                    "rx_Bps": float(nrow.get("rx_Bps", 0.0) or 0.0),
                    "resends": int(nrow.get("resends", 0) or 0),
                    "replays": int(nrow.get("replays", 0) or 0),
                    "queue_depth": int(
                        nrow.get("queue_depth", 0) or 0),
                    "resend_rate": float(
                        nrow.get("resend_rate", 0.0) or 0.0),
                    "rtt_avg_ms": float(
                        (nrow.get("rtt") or {}).get(
                            "rtt_avg_ms", 0.0) or 0.0),
                    "rtt_max_ms": float(
                        (nrow.get("rtt") or {}).get(
                            "rtt_max_ms", 0.0) or 0.0),
                    "rtt_peers": dict(nrow.get("rtt_peers") or {}),
                }
            sf = row.get("statfs")
            if sf:
                osd_rows[d] = {"total": int(sf.get("total") or 0),
                               "used": int(sf.get("used") or 0)}
            du = row.get("device_util")
            if du and du.get("chip") is not None:
                chip = int(du["chip"])
                if row["_stamp"] >= dev_stamp.get(chip, -1.0):
                    dev_stamp[chip] = row["_stamp"]
                    device_util[chip] = {
                        k: v for k, v in du.items() if k != "chip"}
                    device_util[chip]["daemon"] = d
            for cname, rrow in (row.get("repair") or {}).items():
                agg = repair_traffic.setdefault(
                    str(cname), {"read": 0, "moved": 0,
                                 "objects": 0, "targeted": 0,
                                 "full": 0})
                for kk in agg:
                    agg[kk] += int(rrow.get(kk, 0) or 0)
            for pid, drow in (row.get("dedup") or {}).items():
                agg = dedup_pools.setdefault(
                    str(pid), {"chunks_stored": 0,
                               "chunks_deduped": 0,
                               "bytes_stored": 0, "bytes_saved": 0})
                for kk in agg:
                    agg[kk] += int(drow.get(kk, 0) or 0)
            for fid, prow in (row.get("progress") or {}).items():
                progress["%s:%s" % (d, fid)] = dict(prow)
        return {
            "num_pgs": sum(r["num_pgs"] for r in per_pool.values()),
            "pg_states": states,
            "pools": {int(pid): row
                      for pid, row in per_pool.items()},
            "totals": totals,
            "inactive_pgs": inactive,
            # scrub surface: PGs with unrepaired inconsistencies
            # (PG_DAMAGED) beside the summed error count the totals
            # carry (OSD_SCRUB_ERRORS)
            "inconsistent_pgs": self.inconsistent_pgs(now, pools),
            "op_size_hist_bytes_pow2": self.op_size_hist(now),
            "osd_stats": osd_rows,
            # chip -> windowed busy/queue-wait/idle fractions (the
            # `status` device-utilization line + QoS oracles)
            "device_util": device_util,
            # codec -> summed recovery traffic counters (what the
            # locality-aware codecs measurably save)
            "repair_traffic": repair_traffic,
            # pool -> summed dedup counters (what the data-reduction
            # plane measurably saves)
            "dedup_pools": dedup_pools,
            # daemon:flowid -> fraction-complete rows for long
            # background flows (the `status` progress section)
            "progress": progress,
            # daemon -> wire rates + RTT matrix row (`net status`,
            # the net.* history series, the slow-ping soft detail)
            "net": net,
            # per-daemon report freshness + prune visibility (the
            # `status` max-age/stale-count line)
            "reports": self.report_freshness(now),
        }


class DictPGMap:
    """The original dict-of-rows PGMap: the golden reference the
    columnar fold AND the columnar ingest path are pinned against
    (tests/test_scale.py, tests/test_ingest.py) and the baseline for
    the `bench.py --scale` ingest/fold micro-benchmarks.  Keep its
    semantics bit-for-bit when touching either class."""

    def __init__(self, stale_after: float = 15.0):
        self.stale_after = float(stale_after)
        # pgid -> latest stat row (+ "_from" daemon, "_stamp")
        self.pg_stats: dict[str, dict] = {}
        # pgid -> {counter_s: rate} derived from the last two reports
        self.rates: dict[str, dict] = {}
        # daemon -> {"op_size_hist_bytes_pow2": [...], "_stamp": t}
        self.osd_stats: dict[str, dict] = {}
        self.report_stamps: dict[str, float] = {}
        self.ingest = _new_ingest()
        self.pruned_stale = 0
        self.pruned_pool = 0
        self.pruned_daemons = 0

    # -- ingest ------------------------------------------------------------

    def apply_report(self, daemon: str, pg_stats: list | None,
                     osd_stats: dict | None, stamp: float,
                     pg_stats_cols: dict | None = None,
                     nbytes: int | None = None) -> None:
        t0 = _time.perf_counter()
        self.report_stamps[daemon] = stamp
        if osd_stats:
            row = dict(osd_stats)
            row["_stamp"] = stamp
            self.osd_stats[daemon] = row
        fmt = "legacy"
        legacy_rows = list(pg_stats or ())
        rows = legacy_rows
        cols_rows = 0
        if pg_stats_cols is not None:
            # the golden reference has no fast path: unpack and walk
            fmt = "columnar"
            unpacked = statblock.unpack_stat_rows(pg_stats_cols)
            cols_rows = len(unpacked)
            rows = unpacked + legacy_rows
        for st in rows:
            pgid = st.get("pgid")
            if not pgid:
                continue
            prev = self.pg_stats.get(pgid)
            cur = dict(st)
            cur["_from"] = daemon
            cur["_stamp"] = stamp
            if prev is not None and prev["_from"] == daemon:
                dt = stamp - prev["_stamp"]
                if dt > 0:
                    self.rates[pgid] = {
                        c + "_s": max(0.0, (cur.get(c, 0)
                                            - prev.get(c, 0)) / dt)
                        for c in RATE_COUNTERS}
            else:
                self.rates.pop(pgid, None)
            self.pg_stats[pgid] = cur
        if nbytes is None:
            nbytes = (statblock.block_nbytes(pg_stats_cols)
                      if pg_stats_cols is not None else 0)
        _note_ingest(self.ingest, fmt, cols_rows, len(legacy_rows),
                     nbytes, _time.perf_counter() - t0)

    # -- pruning -----------------------------------------------------------

    def prune(self, now: float, pools: set | None = None,
              after: float | None = None) -> dict:
        after = self.stale_after if after is None else float(after)
        dropped_stale = dropped_pool = 0
        for pgid, st in list(self.pg_stats.items()):
            if now - st["_stamp"] > after:
                dropped_stale += 1
            elif pools is not None and st.get("pool") not in pools:
                dropped_pool += 1
            else:
                continue
            del self.pg_stats[pgid]
            self.rates.pop(pgid, None)
        self.pruned_stale += dropped_stale
        self.pruned_pool += dropped_pool
        dropped_daemons = 0
        for d in [d for d, t in self.report_stamps.items()
                  if now - t > after]:
            del self.report_stamps[d]
            self.osd_stats.pop(d, None)
            dropped_daemons += 1
        self.pruned_daemons += dropped_daemons
        return {"stale": dropped_stale, "pool": dropped_pool,
                "daemons": dropped_daemons}

    # -- views -------------------------------------------------------------

    def _live_rows(self, now: float, pools: set | None):
        for pgid, st in self.pg_stats.items():
            if now - st["_stamp"] > self.stale_after:
                continue            # dead primary's last report
            if pools is not None and st.get("pool") not in pools:
                continue            # pool deleted since the report
            yield pgid, st

    def pool_totals(self, now: float,
                    pools: set | None = None) -> dict[int, dict]:
        out: dict[int, dict] = {}
        for pgid, st in self._live_rows(now, pools):
            row = out.setdefault(st["pool"], {
                "num_pgs": 0, "objects": 0, "bytes": 0,
                "degraded": 0, "misplaced": 0, "unfound": 0,
                "log_size": 0, "scrub_errors": 0,
                **{k: 0.0 for k in RATE_KEYS}})
            row["num_pgs"] += 1
            row["objects"] += st.get("num_objects", 0)
            row["bytes"] += st.get("num_bytes", 0)
            row["degraded"] += st.get("degraded", 0)
            row["misplaced"] += st.get("misplaced", 0)
            row["unfound"] += st.get("unfound", 0)
            row["log_size"] += st.get("log_size", 0)
            row["scrub_errors"] += st.get("scrub_errors", 0)
            rt = self.rates.get(pgid)
            if rt:
                for k in RATE_KEYS:
                    row[k] += rt.get(k, 0.0)
        return out

    def pg_state_counts(self, now: float,
                        pools: set | None = None) -> dict[str, int]:
        states: dict[str, int] = {}
        for _pgid, st in self._live_rows(now, pools):
            s = st.get("state", "unknown")
            states[s] = states.get(s, 0) + 1
        return states

    def inconsistent_pgs(self, now: float,
                         pools: set | None = None) -> int:
        return sum(1 for _p, st in self._live_rows(now, pools)
                   if st.get("scrub_errors", 0))

    live_osd_stats = PGMap.live_osd_stats
    op_size_hist = PGMap.op_size_hist
    report_freshness = PGMap.report_freshness
    digest = PGMap.digest
