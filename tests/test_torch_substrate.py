"""The port's cluster substrate is ceph_tpu's, copied: each verbatim
module's source equals the reference's byte for byte, and each module
that binds to the port's device runtime differs only inside the
functions its allow-list names (the runtime bindings, the chip-loss
renames, the narrowed excepts).  Every other module of ceph_tpu has a
rewritten counterpart at the same path, but for the two that need none
(the JAX settings and the Pallas kernels, whose CUDA counterparts live
in ops/crush/kernels.py and csrc/).  One smoke case per copied package
runs against the copy: a messenger round trip, a MemStore transaction,
a one-mon paxos commit and a Config / AdminSocket round trip."""

import ast
import asyncio
import difflib
import os

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "ceph_tpu")
PORT = os.path.join(ROOT, "ceph_tpu_torch")

VERBATIM = [
    "utils/__init__.py", "utils/admin.py", "utils/backoff.py",
    "utils/config.py", "utils/context.py", "utils/crash.py",
    "utils/denc.py", "utils/log.py", "utils/perf.py",
    "store/__init__.py", "store/allocator.py", "store/blk.py",
    "store/extentstore.py", "store/kstore.py", "store/kv.py",
    "store/memstore.py", "store/objectstore.py",
    "msg/__init__.py", "msg/auth.py", "msg/faults.py", "msg/message.py",
    "msg/messenger.py", "msg/statblock.py",
    "trace/__init__.py", "trace/logclient.py", "trace/optracker.py",
    "mgr/__init__.py", "mgr/history.py", "mgr/pgmap.py", "mgr/slo.py",
    "mon/__init__.py", "mon/elector.py", "mon/paxos.py",
    "client/__init__.py", "client/striper.py",
    "osd/network.py", "osd/pg.py", "osd/progress.py",
    "osd/scheduler.py", "osd/snaps.py", "osd/watch.py",
    "osd/cls/__init__.py", "osd/cls/fsmeta.py", "osd/cls/lock.py",
    "osd/cls/rbd.py", "osd/cls/refcount.py", "osd/cls/rgw.py",
    "ec/interface.py", "ec/plugins/__init__.py", "ec/plugins/clay.py",
    "ec/plugins/isa.py", "ec/plugins/jerasure.py", "ec/plugins/lrc.py",
    "ec/plugins/shec.py",
    "models/crushcompiler.py", "models/crushtester.py",
    "native/gfec.c",
    "cli/crushtool.py", "cli/dencoder.py", "cli/monstore_tool.py",
    "cli/objectstore_tool.py", "cli/rados.py",
    "services/__init__.py", "services/fs.py", "services/rbd.py",
    "services/rgw.py",
    "testing/__init__.py", "testing/traffic.py",
]

# module -> the regions (function / class qualnames, module-level
# assignment names, "<imports>", "__doc__") whose lines may differ
ALLOWED = {
    # the runtime bindings: DeviceRuntime.get(device)
    "utils/exporter.py": {"device_runtime_lines", "cluster_exporter"},
    "trace/registry.py": {"DEVICE_SERIES", "lint_device_series"},
    "mgr/daemon.py": {"Manager.__init__", "Manager.balancer_tick"},
    "testing/cluster.py": {"LocalCluster.__init__", "LocalCluster.start",
                           "LocalCluster._start_osd",
                           "LocalCluster.revive_mgr",
                           "LocalCluster.export_trace",
                           "LocalCluster.healthy"},
    "cli/vstart.py": {"__doc__", "run", "main"},
    "scale/cluster.py": {"ScaleCluster", "ScaleCluster.__init__",
                         "ScaleCluster.start"},
    # the shells' mapping pass on the port's runtime: busy or lost
    # chips keep the grouping, other failures reach the caller, a map
    # outside the device's scope takes the host engine
    "scale/shell.py": {"__doc__", "MapCache", "MapCache.__init__",
                       "MapCache.primaries_async",
                       "MapCache.primaries_for", "MapCache._grouping",
                       "MapCache._host_grouping",
                       "ShellOSD._report_loop"},
    # the device rounds on the port's chip-loss oracle; verify()'s
    # picker seeded with a str (Random() takes no tuple since 3.11)
    "testing/thrasher.py": {"<imports>", "Workload.verify",
                            "ClusterThrasher",
                            "ClusterThrasher.__init__",
                            "ClusterThrasher._plan_one",
                            "ClusterThrasher._dispatch",
                            "ClusterThrasher._chip_loss_round",
                            "ClusterThrasher._primary_chip",
                            "ClusterThrasher._needs_device",
                            "ClusterThrasher._writes_through_loss",
                            "ClusterThrasher._poison_mid_compress_round",
                            "ClusterThrasher._poisoned_writes",
                            "ClusterThrasher._poison_mid_chunk_round",
                            "ClusterThrasher._verify_ec_host_parity"},
    # the host codec's native route: libgfec built under build/
    "ec/gf.py": {"__doc__", "mul_table_u8", "matmul_u8"},
    "native/__init__.py": {"<imports>", "BUILD_DIR", "_build", "_flags",
                           "lib"},
    "ops/crush/_gen_tables.py": {"__doc__", "main"},
    # an absolute import of the reference package
    "client/rados.py": {"RadosClient.list_objects"},
    # the chip-loss renames: device_lost / DEVICE_LOST
    "msg/messages.py": {"MOSDBeacon"},
    "mon/monitor.py": {"Monitor.__init__", "Monitor.ms_dispatch"},
    "mon/services.py": {"HealthMonitor", "HealthMonitor.maybe_commit",
                        "HealthMonitor.checks"},
    # the device-bound modules: codecs on the OSD's device, no host
    # route, the narrowed excepts
    "osd/ecbackend.py": {"<imports>", "ECPGBackend.codec",
                         "ECPGBackend._maybe_warmup", "ECPGBackend._chip",
                         "ECPGBackend._chip_lost",
                         "ECPGBackend._on_dispatch_ticket",
                         "ECPGBackend._try_delta_write",
                         "ECPGBackend.read_object_attrs"},
    "osd/scrubber.py": {"__doc__", "Scrubber.build_scrub_map",
                        "Scrubber.handle_rep_scrub"},
    "dedup/plane.py": {"DedupPlane.handle_op", "DedupPlane._plan_write"},
    "osd/daemon.py": {"_MAP_DEFERRED", "OSD.__init__", "OSD.start",
                      "OSD._on_device_state", "OSD._handle_osd_map",
                      "OSD._next_map", "OSD._bulk_mapping",
                      "OSD._defer_map", "OSD._reply_chip_lost",
                      "OSD._replay_deferred_maps", "OSD._handle_op",
                      "OSD._advance_pgs", "OSD._compression_paced",
                      "OSD._reply_compress_error", "OSD._maybe_compress",
                      "OSD._maybe_send_beacon"},
}

# modules whose port is a rewrite at the same path, held to the
# reference by their own tests (tests/test_torch_*.py)
REWRITTEN = [
    "__init__.py", "cli/__init__.py", "cli/osdmaptool.py",
    "compress/__init__.py", "compress/tlz.py",
    "dedup/__init__.py", "dedup/chunker.py",
    "device/__init__.py", "device/digest.py", "device/lzkernel.py",
    "device/mesh.py", "device/runtime.py", "device/stream.py",
    "ec/__init__.py", "ec/base.py", "ec/batcher.py", "ec/clay.py",
    "ec/isa.py", "ec/jerasure.py", "ec/kernels.py", "ec/lrc.py",
    "ec/matrices.py", "ec/plugin.py", "ec/shec.py",
    "models/__init__.py", "models/crushmap.py",
    "ops/__init__.py", "ops/crush/__init__.py", "ops/crush/_ln_tables.py",
    "ops/crush/device.py", "ops/crush/hashes.py", "ops/crush/host.py",
    "osd/__init__.py", "osd/balancer.py", "osd/osdmap.py",
    "parallel/__init__.py", "parallel/mapping.py",
    "scale/__init__.py", "scale/balancer.py", "trace/recorder.py",
]

# the only reference modules without a counterpart: JAX settings, and
# the Pallas kernels (their CUDA counterparts: ops/crush/kernels.py,
# csrc/crush_kernels.cu)
UNOWNED = ["ops/crush/pallas_draw.py", "utils/jaxenv.py"]


def _read(base: str, rel: str) -> str:
    with open(os.path.join(base, rel)) as fh:
        return fh.read()


def _owners(src: str) -> list[str]:
    """The region each line (1-based) belongs to: the innermost def or
    class, a module-level assignment's name, "<imports>", "__doc__" or
    "<module>".  Comment lines belong to the next code line's region;
    blank lines to none."""
    tree = ast.parse(src)
    lines = src.splitlines()
    own = ["<module>"] * (len(lines) + 2)

    def visit(node, prefix: str) -> None:
        for ch in ast.iter_child_nodes(node):
            name = None
            if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                name = prefix + ch.name
            elif not prefix and isinstance(ch, ast.Assign) \
                    and isinstance(ch.targets[0], ast.Name):
                name = ch.targets[0].id
            elif not prefix and isinstance(ch, (ast.Import,
                                                ast.ImportFrom)):
                name = "<imports>"
            elif not prefix and ch is tree.body[0] \
                    and isinstance(ch, ast.Expr):
                name = "__doc__"
            if name is None:
                continue
            start = min([d.lineno for d in
                         getattr(ch, "decorator_list", [])] + [ch.lineno])
            for ln in range(start, ch.end_lineno + 1):
                own[ln] = name
            if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                visit(ch, name + ".")

    visit(tree, "")
    nxt = "<module>"
    for ln in range(len(lines), 0, -1):
        text = lines[ln - 1].strip()
        if not text:
            own[ln] = None
        elif text.startswith("#"):
            # a comment above a def belongs to it, not to the enclosing
            # class or module
            if own[ln] == "<module>" or nxt.startswith(own[ln] + "."):
                own[ln] = nxt
        else:
            nxt = own[ln]
    return own


def _changed_regions(ref: str, port: str) -> set:
    a, b = ref.splitlines(), port.splitlines()
    oa, ob = _owners(ref), _owners(port)
    out = set()
    sm = difflib.SequenceMatcher(None, a, b, autojunk=False)
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            continue
        out.update(oa[i + 1] for i in range(i1, i2))
        out.update(ob[j + 1] for j in range(j1, j2))
    out.discard(None)
    return out


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy(rel):
    assert _read(PORT, rel) == _read(REF, rel), rel


@pytest.mark.parametrize("rel", sorted(ALLOWED))
def test_bound_module_differs_only_where_allowed(rel):
    changed = _changed_regions(_read(REF, rel), _read(PORT, rel))
    assert changed <= ALLOWED[rel], sorted(changed - ALLOWED[rel])
    # the allow-list stays exact: every named region did change
    assert ALLOWED[rel] <= changed, sorted(ALLOWED[rel] - changed)


def _reference_modules() -> set:
    out = set()
    for dirpath, _dirs, files in os.walk(REF):
        for f in files:
            if f.endswith((".py", ".c")):
                out.add(os.path.relpath(os.path.join(dirpath, f), REF))
    return out


def test_every_reference_module_has_a_counterpart():
    lists = (set(VERBATIM), set(ALLOWED), set(REWRITTEN))
    assert sum(map(len, lists)) == len(set().union(*lists))  # disjoint
    owned = set().union(*lists)
    for rel in sorted(owned):
        assert os.path.exists(os.path.join(PORT, rel)), rel
    assert sorted(_reference_modules() - owned) == UNOWNED
    for rel in UNOWNED:
        assert not os.path.exists(os.path.join(PORT, rel)), rel


def test_owner_map_catches_a_change_outside_the_allow_list():
    ref = "import os\n\n\ndef f():\n    return 1\n\n\ndef g():\n" \
          "    return 2\n"
    port = ref.replace("return 2", "return 3")
    assert _changed_regions(ref, port) == {"g"}
    port = ref.replace("import os", "import sys")
    assert _changed_regions(ref, port) == {"<imports>"}


# -- one smoke case per copied package, against the copy ------------------


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=20))


def test_messenger_round_trip():
    from ceph_tpu_torch.msg import (Messenger, decode_message,
                                    encode_message)
    from ceph_tpu_torch.msg.messages import MOSDOp, MPing, MPong

    m = MOSDOp(tid=7, pool=1, ps=0x1f, oid="foo", snapc=None,
               ops=[{"op": "write", "offset": 0, "data": b"abc"}],
               epoch=3, flags=0)
    out = decode_message(encode_message(m))
    assert (out.tid, out.oid, out.ops[0]["data"]) == (7, "foo", b"abc")

    class Echo:
        def ms_dispatch(self, conn, msg):
            if isinstance(msg, MPing):
                conn.send(MPong(stamp=msg.stamp))
            return True

    class Collect:
        def __init__(self):
            self.got = []
            self.event = asyncio.Event()

        def ms_dispatch(self, conn, msg):
            self.got.append(msg)
            self.event.set()
            return True

    async def main():
        server = Messenger("osd.0")
        await server.bind()
        server.add_dispatcher(Echo())
        client = Messenger("client.1")
        col = Collect()
        client.add_dispatcher(col)
        client.send_to(server.addr, MPing(stamp=1.5))
        await asyncio.wait_for(col.event.wait(), 5)
        assert isinstance(col.got[0], MPong)
        assert (col.got[0].stamp, col.got[0].src) == (1.5, "osd.0")
        await client.shutdown()
        await server.shutdown()

    run(main())


def test_memstore_transaction():
    from ceph_tpu_torch.store.memstore import MemStore
    from ceph_tpu_torch.store.objectstore import (Transaction, coll_t,
                                                  hobject_t)

    s = MemStore()
    s.mkfs()
    s.mount()
    cid, ho = coll_t.pg(1, 0), hobject_t("obj")
    t = Transaction()
    t.create_collection(cid)
    t.write(cid, ho, 0, 5, b"hello")
    t.setattr(cid, ho, "k", b"v")
    s.apply_transaction(t)
    t = Transaction()
    t.write(cid, ho, 3, 4, b"LOWS")
    s.apply_transaction(t)
    assert s.read(cid, ho) == b"helLOWS"
    assert s.getattr(cid, ho, "k") == b"v"
    assert [h.name for h in s.collection_list(cid)] == ["obj"]


def test_one_mon_paxos_commit():
    from ceph_tpu_torch.mon import Paxos
    from ceph_tpu_torch.store.kv import MemKV

    store = MemKV()
    store.open()
    p = Paxos(store)
    assert (p.propose(b"blob-1"), p.propose(b"blob-2")) == (1, 2)
    assert p.get_version(2) == b"blob-2"
    p2 = Paxos(store)
    assert p2.last_committed == 2 and p2.get_version(1) == b"blob-1"


def test_config_and_admin_socket_round_trip(tmp_path):
    from ceph_tpu_torch.utils.admin import admin_command
    from ceph_tpu_torch.utils.context import Context

    path = str(tmp_path / "osd.asok")
    ctx = Context("osd.7", conf_overrides={"admin_socket": path,
                                           "osd_op_complaint_time": 7.5})
    try:
        assert ctx.conf["osd_op_complaint_time"] == 7.5
        got = admin_command(path, "config get", key="osd_op_complaint_time")
        assert float(got["osd_op_complaint_time"]) == 7.5
        admin_command(path, "config set", key="osd_op_complaint_time",
                      value="9")
        assert ctx.conf["osd_op_complaint_time"] == 9.0
        assert "config get" in admin_command(path, "help")
    finally:
        ctx.shutdown()
