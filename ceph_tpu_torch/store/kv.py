"""KeyValueDB: ordered KV abstraction + SQLite backend.

The reference wraps RocksDB behind KeyValueDB (src/kv/KeyValueDB.h,
src/kv/RocksDBStore.h:78) so stores and monitors are engine-agnostic.
Here the durable engine is SQLite in WAL mode (in the container there
is no RocksDB binding; SQLite gives the same contract: ordered byte
keys, atomic write batches, range scans).  The interface is kept so a
RocksDB/C++ engine can slot in without touching callers.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Iterator


class KVTransaction:
    """A write batch: set/rmkey/rm_range staged then submitted
    atomically (KeyValueDB::Transaction analog)."""

    def __init__(self):
        self.ops: list[tuple] = []

    def set(self, key: bytes, value: bytes) -> None:
        self.ops.append(("set", bytes(key), bytes(value)))

    def rmkey(self, key: bytes) -> None:
        self.ops.append(("rm", bytes(key)))

    def rm_range(self, first: bytes, last: bytes) -> None:
        """Removes keys in [first, last)."""
        self.ops.append(("rmrange", bytes(first), bytes(last)))


class KeyValueDB:
    """Ordered byte-key store contract."""

    def open(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def get_transaction(self) -> KVTransaction:
        return KVTransaction()

    def submit_transaction(self, tx: KVTransaction,
                           sync: bool = True) -> None:
        raise NotImplementedError

    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def iterate(self, first: bytes = b"",
                last: bytes | None = None) -> Iterator[tuple[bytes, bytes]]:
        """Ordered scan over [first, last)."""
        raise NotImplementedError


class MemKV(KeyValueDB):
    """Dict-backed engine for tests."""

    def __init__(self):
        self._d: dict[bytes, bytes] = {}
        self._lock = threading.RLock()

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass

    def submit_transaction(self, tx: KVTransaction,
                           sync: bool = True) -> None:
        with self._lock:
            for op in tx.ops:
                if op[0] == "set":
                    self._d[op[1]] = op[2]
                elif op[0] == "rm":
                    self._d.pop(op[1], None)
                else:
                    for k in [k for k in self._d if op[1] <= k < op[2]]:
                        del self._d[k]

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._d.get(key)

    def iterate(self, first: bytes = b"", last: bytes | None = None):
        with self._lock:
            keys = sorted(k for k in self._d
                          if k >= first and (last is None or k < last))
            items = [(k, self._d[k]) for k in keys]
        return iter(items)


class SQLiteKV(KeyValueDB):
    """Durable engine: one ordered BLOB table, WAL journaling."""

    def __init__(self, path: str):
        self.path = path
        self._conn: sqlite3.Connection | None = None
        self._lock = threading.RLock()

    def open(self) -> None:
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        # FULL fsyncs the WAL on every commit: sync=True submits must
        # be power-loss durable (the extent store's deferred in-place
        # writes depend on the committed WAL record surviving reboot;
        # NORMAL could roll the commit back and strand a torn block)
        self._conn.execute("PRAGMA synchronous=FULL")
        self._sync = True
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv "
            "(k BLOB PRIMARY KEY, v BLOB NOT NULL) WITHOUT ROWID")
        self._conn.commit()

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def submit_transaction(self, tx: KVTransaction,
                           sync: bool = True) -> None:
        assert self._conn is not None, "not open"
        with self._lock:
            if sync != self._sync:
                self._conn.execute("PRAGMA synchronous=%s"
                                   % ("FULL" if sync else "NORMAL"))
                self._sync = sync
            cur = self._conn.cursor()
            for op in tx.ops:
                if op[0] == "set":
                    cur.execute(
                        "INSERT INTO kv (k, v) VALUES (?, ?) "
                        "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                        (op[1], op[2]))
                elif op[0] == "rm":
                    cur.execute("DELETE FROM kv WHERE k = ?", (op[1],))
                else:
                    cur.execute("DELETE FROM kv WHERE k >= ? AND k < ?",
                                (op[1], op[2]))
            self._conn.commit()

    def get(self, key: bytes) -> bytes | None:
        assert self._conn is not None, "not open"
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return row[0] if row else None

    def iterate(self, first: bytes = b"", last: bytes | None = None):
        assert self._conn is not None, "not open"
        with self._lock:
            if last is None:
                rows = self._conn.execute(
                    "SELECT k, v FROM kv WHERE k >= ? ORDER BY k",
                    (first,)).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT k, v FROM kv WHERE k >= ? AND k < ? "
                    "ORDER BY k", (first, last)).fetchall()
        return iter(rows)
