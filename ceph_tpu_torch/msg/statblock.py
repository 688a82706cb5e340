"""Packed columnar stat-row blocks (the telemetry fabric's wire unit).

The MPGStats slice of an MMgrReport used to ride as a list of python
dicts — one dict per PG — which forces the mgr to walk the rows one
`for st in pg_stats` iteration at a time.  At 500k-1M PGs the report
*ingest* becomes the control plane's hot path (the fold went columnar
in the scale plane; ingest was the remaining row-at-a-time loop), so
the rows now ship as ONE packed block of parallel typed arrays:

* ``pg_pool`` / ``pg_seed`` — the pgid split into its integer parts
  (every producer mints pgids as ``"%d.%x" % (pool, ps)``), so the
  mgr's merge is a ``searchsorted`` over int64 keys instead of a dict
  probe per string;
* ``ints`` — the per-PG int64 stat columns in ``STAT_INT_COLS`` order
  (object/byte counts, degraded/misplaced/unfound, log size, scrub
  errors);
* ``ctrs`` — the cumulative rate-counter columns in ``STAT_CTR_COLS``
  order (client IO + recovery), int64;
* ``floats`` — float64 columns (``STAT_FLOAT_COLS``: the scrub
  stamps);
* ``state`` — uint16 codes into ``state_names``, the per-report
  dictionary encoding of the PG state strings.

Every array serializes as raw little-endian bytes (explicit ``<``
dtypes, so the packed encoding is byte-stable across hosts — pinned
by the golden test), and the whole block is a plain denc-encodable
dict riding MMgrReport's ``pg_stats_cols`` field.  ``block_cols``
reopens the arrays zero-copy on the mgr side; ``unpack_stat_rows``
restores dict rows for legacy consumers and the fallback path.

Versioning: ``v`` bumps only if the column layout itself changes;
receivers reject unknown versions (the sender then has no columnar
peer and the mgr's legacy dict-row path still applies the report).
"""

from __future__ import annotations

import numpy as np

STATBLOCK_V = 1

# int64 stat columns, in wire order (mirrors mgr.pgmap._INT_COLS)
STAT_INT_COLS = ("pool", "num_objects", "num_bytes", "degraded",
                 "misplaced", "unfound", "log_size", "scrub_errors")

# cumulative counters the mgr derives rates from (mirrors
# mgr.pgmap.RATE_COUNTERS — pgmap asserts the two stay identical)
STAT_CTR_COLS = ("read_ops", "read_bytes", "write_ops", "write_bytes",
                 "recovery_ops", "recovery_bytes")

# float64 columns (scrub stamps ride the row but are not folded)
STAT_FLOAT_COLS = ("last_scrub_stamp", "last_deep_scrub_stamp")

# pg_seed must fit the low 32 bits of the merge key (pool rides the
# high bits); pg_num tops out far below this
_SEED_MAX = (1 << 32) - 1

# pool must fit the high 31 bits so ``pool << 32 | seed`` stays inside
# a signed int64 (negative keys are the mgr's synthetic string-key
# space); out-of-range pgids keep the legacy dict-row path
_POOL_MAX = (1 << 31) - 1


def _i64(vals) -> bytes:
    return np.asarray(vals, dtype="<i8").tobytes()


def pack_stat_rows(rows: list[dict]) -> dict:
    """Dict-shaped stat rows -> one packed columnar block (the
    producer side: OSDs and shell fleets call this once per report).
    Raises ValueError on a row whose pgid is not the canonical
    ``pool.seed-hex`` shape — producers always mint that shape; a
    caller with odd pgids keeps the legacy dict-row field."""
    n = len(rows)
    pg_pool = np.empty(n, "<i8")
    pg_seed = np.empty(n, "<i8")
    states: list[int] = []
    state_names: list[str] = []
    state_codes: dict[str, int] = {}
    for i, st in enumerate(rows):
        pool_s, dot, seed_s = str(st["pgid"]).partition(".")
        if not dot:
            raise ValueError("non-canonical pgid %r" % st["pgid"])
        pool = int(pool_s)
        seed = int(seed_s, 16)
        if not (0 <= pool <= _POOL_MAX and 0 <= seed <= _SEED_MAX):
            raise ValueError("pgid %r out of key range" % st["pgid"])
        pg_pool[i] = pool
        pg_seed[i] = seed
        s = st.get("state", "unknown")
        code = state_codes.get(s)
        if code is None:
            code = len(state_names)
            state_codes[s] = code
            state_names.append(s)
        states.append(code)
    if len(state_names) > 0xFFFF:
        raise ValueError("too many distinct states")
    # field order is the wire order — deterministic, golden-pinned
    return {
        "v": STATBLOCK_V,
        "n": n,
        "pg_pool": pg_pool.tobytes(),
        "pg_seed": pg_seed.tobytes(),
        "ints": [_i64([int(st.get(c, 0)) for st in rows])
                 for c in STAT_INT_COLS],
        "ctrs": [_i64([int(st.get(c, 0)) for st in rows])
                 for c in STAT_CTR_COLS],
        "floats": [np.asarray([float(st.get(c, 0.0)) for st in rows],
                              "<f8").tobytes()
                   for c in STAT_FLOAT_COLS],
        "state_names": state_names,
        "state": np.asarray(states, "<u2").tobytes(),
    }


def _col(raw: bytes, n: int, dtype: str) -> np.ndarray:
    arr = np.frombuffer(raw, dtype=dtype)
    if arr.size != n:
        raise ValueError("column carries %d values for %d rows"
                         % (arr.size, n))
    return arr


def block_cols(block: dict) -> dict:
    """Validate a wire block and reopen its arrays zero-copy (the mgr
    fast path's input).  Raises ValueError on version skew or any
    length/layout mismatch — the caller then falls back to the
    row-wise path via ``unpack_stat_rows``."""
    if block.get("v") != STATBLOCK_V:
        raise ValueError("unknown statblock version %r"
                         % block.get("v"))
    n = int(block["n"])
    ints = block["ints"]
    ctrs = block["ctrs"]
    floats = block["floats"]
    if (len(ints) != len(STAT_INT_COLS)
            or len(ctrs) != len(STAT_CTR_COLS)
            or len(floats) != len(STAT_FLOAT_COLS)):
        raise ValueError("column-count mismatch")
    names = [str(s) for s in (block.get("state_names") or [])]
    state = _col(block["state"], n, "<u2")
    if n and (not names or int(state.max()) >= len(names)):
        raise ValueError("state code outside the dictionary")
    return {
        "n": n,
        "pg_pool": _col(block["pg_pool"], n, "<i8"),
        "pg_seed": _col(block["pg_seed"], n, "<i8"),
        "ints": [_col(raw, n, "<i8") for raw in ints],
        "ctrs": [_col(raw, n, "<i8") for raw in ctrs],
        "floats": [_col(raw, n, "<f8") for raw in floats],
        "state_names": names,
        "state": state,
    }


def unpack_stat_rows(block: dict) -> list[dict]:
    """Packed block -> dict-shaped rows (legacy consumers, the mgr's
    malformed-block fallback, and the golden tests' normal form)."""
    cols = block_cols(block)
    n = cols["n"]
    names = cols["state_names"]
    rows: list[dict] = []
    for i in range(n):
        row = {
            "pgid": "%d.%x" % (cols["pg_pool"][i], cols["pg_seed"][i]),
            "state": names[cols["state"][i]] if names else "unknown",
        }
        for c, arr in zip(STAT_INT_COLS, cols["ints"]):
            row[c] = int(arr[i])
        for c, arr in zip(STAT_CTR_COLS, cols["ctrs"]):
            row[c] = int(arr[i])
        for c, arr in zip(STAT_FLOAT_COLS, cols["floats"]):
            row[c] = float(arr[i])
        rows.append(row)
    return rows


def block_nbytes(block: dict) -> int:
    """Approximate wire size of a packed block (the ingest bytes
    accounting): the raw column payloads plus the small framing."""
    total = 16
    for key in ("pg_pool", "pg_seed", "state"):
        total += len(block.get(key) or b"")
    for key in ("ints", "ctrs", "floats"):
        total += sum(len(raw) for raw in (block.get(key) or ()))
    total += sum(len(s) + 5 for s in (block.get("state_names") or ()))
    return total
