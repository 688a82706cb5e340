"""Per-daemon admin socket: a unix-socket JSON command server.

Reference analog: AdminSocket (src/common/admin_socket.h) — every daemon
exposes `perf dump`, `config get/set/diff`, `dump_ops_in_flight`, plus
commands registered by subsystems.

Protocol: one JSON request per connection: {"prefix": "...", ...args},
one JSON reply, connection closes.  (The reference uses a similar
single-command-per-connect model.)
"""

from __future__ import annotations

import json
import os
import socket
import threading
from typing import Any, Callable

Handler = Callable[[dict], Any]


class AdminSocket:
    def __init__(self, path: str, context=None):
        self.path = path
        self._handlers: dict[str, tuple[Handler, str]] = {}
        self._thread: threading.Thread | None = None
        self._sock: socket.socket | None = None
        self._stop = threading.Event()
        if context is not None:
            self._register_builtin(context)

    # -- registration ----------------------------------------------------
    def register(self, prefix: str, handler: Handler, help: str = "") -> None:
        self._handlers[prefix] = (handler, help)

    def _register_builtin(self, ctx) -> None:
        self.register("help", lambda a: {
            p: h for p, (_, h) in sorted(self._handlers.items())
        }, "list commands")
        self.register("perf dump", lambda a: ctx.perf.dump(), "dump perf counters")
        self.register("config get", lambda a: {a["key"]: ctx.conf.get(a["key"])},
                      "get one config option")
        self.register("config set",
                      lambda a: (ctx.conf.set(a["key"], a["value"]), "ok")[1],
                      "set one config option at runtime")
        self.register("config diff", lambda a: ctx.conf.diff(),
                      "show non-default config values")
        self.register("config dump", lambda a: ctx.conf.dump(),
                      "show all resolved config values")
        self.register("log dump", lambda a: (ctx.log.dump_recent(), "ok")[1],
                      "dump recent log ring to the daemon log")

        # op-tracker dumps (TrackedOp/OpTracker admin commands): the
        # tracker registers itself on the context at construction, so
        # resolve lazily — daemons build their tracker after the
        # context (and some daemons have none)
        def tracker():
            tr = getattr(ctx, "optracker", None)
            if tr is None:
                raise RuntimeError("this daemon tracks no ops")
            return tr

        self.register(
            "dump_ops_in_flight",
            lambda a: tracker().dump_ops_in_flight(a.get("tenant")),
            "show in-flight tracked ops (optional tenant filter)")
        self.register(
            "dump_historic_ops",
            lambda a: tracker().dump_historic_ops(a.get("tenant")),
            "show recently completed ops (optional tenant filter)")
        self.register(
            "dump_historic_slow_ops",
            lambda a: tracker().dump_historic_slow_ops(
                a.get("tenant")),
            "show recently completed slow ops (optional tenant"
            " filter)")

        # flight-recorder ring (ceph_tpu.trace.recorder): the span
        # records the Perfetto export merges — same lazy-backref
        # pattern as the tracker dumps
        def recorder():
            fr = getattr(ctx, "flight_recorder", None)
            if fr is None:
                raise RuntimeError("this daemon records no spans")
            return fr

        self.register("dump_flight_recorder",
                      lambda a: recorder().dump(),
                      "dump the flight-recorder span ring")

        # heartbeat RTT matrix (osd.network.OsdNetwork): the
        # reference's `ceph daemon osd.N dump_osd_network` — same
        # lazy-backref pattern (only OSDs track peer pings)
        def network():
            net = getattr(ctx, "osd_network", None)
            if net is None:
                raise RuntimeError("this daemon tracks no peer pings")
            return net

        self.register("dump_osd_network",
                      lambda a: network().dump(),
                      "dump per-peer heartbeat RTT tracking")

    # -- server ----------------------------------------------------------
    def start(self) -> None:
        if not self.path:
            return
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.path)
        self._sock.listen(8)
        self._sock.settimeout(0.25)
        self._thread = threading.Thread(
            target=self._serve, name="admin-socket", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        if self._sock:
            self._sock.close()
            self._sock = None
        try:
            os.unlink(self.path)
        except (FileNotFoundError, OSError):
            pass

    def _serve(self) -> None:
        sock = self._sock  # local ref: stop() may null the attribute
        while not self._stop.is_set():
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self._handle(conn)
            except OSError:
                pass  # client stalled or vanished; keep serving
            finally:
                conn.close()

    def _handle(self, conn: socket.socket) -> None:
        conn.settimeout(5)
        chunks = []
        while True:
            b = conn.recv(65536)
            if not b:
                break
            chunks.append(b)
            if _is_complete(b"".join(chunks)):
                break
        try:
            req = json.loads(b"".join(chunks) or b"{}")
            prefix = req.get("prefix", "help")
            entry = self._handlers.get(prefix)
            if entry is None:
                reply = {"error": f"unknown command {prefix!r}"}
            else:
                reply = {"ok": entry[0](req)}
        except Exception as e:  # command errors go to the client, not the daemon
            reply = {"error": f"{type(e).__name__}: {e}"}
        conn.sendall(json.dumps(reply, default=str).encode())


def _is_complete(buf: bytes) -> bool:
    try:
        json.loads(buf)
        return True
    except ValueError:
        return False


def admin_command(path: str, prefix: str, **args) -> Any:
    """Client helper: send one command to a daemon's admin socket."""
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(5)
    try:
        s.connect(path)
        s.sendall(json.dumps({"prefix": prefix, **args}).encode())
        s.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            b = s.recv(65536)
            if not b:
                break
            chunks.append(b)
        reply = json.loads(b"".join(chunks))
    finally:
        s.close()
    if "error" in reply:
        raise RuntimeError(reply["error"])
    return reply["ok"]
