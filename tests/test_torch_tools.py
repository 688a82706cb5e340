"""The port's tools on the CPU, each held exactly to ceph_tpu's: the
CRUSH text compiler and tester, crushtool's stdout, dencoder's bytes,
the offline store tools' listings, the straw2 table generator and the
native GF(2^8) codec route (libgfec against the numpy loop and the
reference's matmul_u8)."""

import asyncio
import glob
import json
import os

import numpy as np
import pytest
import torch

from ceph_tpu.cli import crushtool as ref_crushtool
from ceph_tpu.cli import dencoder as ref_dencoder
from ceph_tpu.ec import gf as ref_gf
from ceph_tpu.models import crushcompiler as ref_cc
from ceph_tpu.models.crushtester import CrushTester as RefTester
from ceph_tpu_torch import native
from ceph_tpu_torch.cli import crushtool, dencoder, monstore_tool
from ceph_tpu_torch.cli import objectstore_tool
from ceph_tpu_torch.ec import gf
from ceph_tpu_torch.models import crushcompiler as cc
from ceph_tpu_torch.models.crushtester import CrushTester
from ceph_tpu_torch.ops.crush import _gen_tables, _ln_tables
from ceph_tpu_torch.utils import denc
from tests.test_crushtool import MAP_TEXT

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "dencoder")

# a second map: every bucket algorithm, an indep rule and tunables
ALGS_TEXT = """
tunable choose_total_tries 50
tunable chooseleaf_vary_r 1
device 0 osd.0
device 1 osd.1
device 2 osd.2
device 3 osd.3
device 4 osd.4
device 5 osd.5
device 6 osd.6
device 7 osd.7
type 0 osd
type 1 host
type 2 root
host h0 {
    id -2
    alg uniform
    hash 0
    item osd.0 weight 1.000
    item osd.1 weight 1.000
}
host h1 {
    id -3
    alg list
    hash 0
    item osd.2 weight 1.000
    item osd.3 weight 2.000
}
host h2 {
    id -4
    alg tree
    hash 0
    item osd.4 weight 1.000
    item osd.5 weight 0.500
}
host h3 {
    id -5
    alg straw
    hash 0
    item osd.6 weight 1.000
    item osd.7 weight 1.000
}
root default {
    id -1
    alg straw2
    hash 0
    item h0
    item h1
    item h2
    item h3
}
rule replicated_rule {
    id 0
    type replicated
    step take default
    step chooseleaf firstn 0 type host
    step emit
}
rule ec_rule {
    id 1
    type erasure
    step take default
    step chooseleaf indep 0 type host
    step emit
}
"""


@pytest.mark.parametrize("text", [MAP_TEXT, ALGS_TEXT],
                         ids=["two_level", "every_alg"])
def test_crushcompiler_matches_reference(text):
    ours, ref = cc.compile(text), ref_cc.compile(text)
    assert cc.decompile(ours) == ref_cc.decompile(ref)
    assert denc.encode(ours.to_dict()) == denc.encode(ref.to_dict())
    again = cc.compile(cc.decompile(ours))
    assert denc.encode(again.to_dict()) == denc.encode(ours.to_dict())


@pytest.mark.parametrize("text", [MAP_TEXT, ALGS_TEXT],
                         ids=["two_level", "every_alg"])
def test_crushtester_matches_reference(text):
    ours = CrushTester(cc.compile(text))
    ref = RefTester(ref_cc.compile(text))
    for rule, reps in ((0, 2), (0, 3)) + (((1, 4),) if "ec_rule" in text
                                          else ()):
        a = ours.test_rule(rule, reps, num_inputs=1024)
        b = ref.test_rule(rule, reps, num_inputs=1024)
        assert ([getattr(a, f) for f in a.__slots__]
                == [getattr(b, f) for f in b.__slots__])
        assert a.summary() == b.summary()
        assert (ours.compare(rule, reps, num_inputs=256)
                == ref.compare(rule, reps, num_inputs=256))


def test_crushtool_build_and_test_stdout_matches_reference(tmp_path,
                                                           capsys):
    outs = []
    for tool, name in ((crushtool, "ours"), (ref_crushtool, "ref")):
        binp = str(tmp_path / ("%s.bin" % name))
        assert tool.main(["--build", "--num-osds", "12", "host",
                          "straw2", "4", "root", "straw2", "0",
                          "-o", binp]) == 0
        assert tool.main(["-i", binp, "--test", "--rule", "0",
                          "--num-rep", "3", "--max-x", "511"]) == 0
        assert tool.main(["-d", binp]) == 0
        with open(binp, "rb") as fh:
            blob = fh.read()
        outs.append((capsys.readouterr().out, blob))
    assert outs[0] == outs[1]
    assert "bad_mappings" in outs[0][0] and "root" in outs[0][0]


def test_dencoder_corpus_and_round_trips_match_reference(capsys):
    assert dencoder._corpus(dencoder._registry(), GOLDEN) == 0
    capsys.readouterr()
    ours, ref = dencoder._registry(), ref_dencoder._registry()
    assert sorted(ours) == sorted(ref)
    seen = set()
    for hexpath in sorted(glob.glob(os.path.join(GOLDEN, "*.hex"))):
        name = os.path.basename(hexpath).split(".")[0]
        with open(hexpath) as fh:
            blob = bytes.fromhex(fh.read().strip())
        val = ours[name].dec(blob)
        assert val == ref[name].dec(blob), name
        assert ours[name].enc(val) == ref[name].enc(val), name
        assert ours[name].enc(val) == blob, name
        seen.add(name)
    assert {"osdmap", "osdmap_inc", "pg_info", "pg_log_entry",
            "message"} <= seen
    for tool in (dencoder, ref_dencoder):
        assert tool.main(["type", "pg_log_entry", "encode",
                          '["delete","x",[2,9],[2,8]]']) == 0
    a, b = capsys.readouterr().out.split()
    assert a == b


def _write_kstore(path: str, KStore, Transaction, coll_t, hobject_t):
    st = KStore(path)
    st.mount()
    cid = coll_t.pg(1, 0)
    t = Transaction()
    t.create_collection(cid)
    for i in range(5):
        ho = hobject_t("obj-%d" % i)
        data = bytes([i]) * (100 + i)
        t.touch(cid, ho)
        t.write(cid, ho, 0, len(data), data)
        t.setattr(cid, ho, "x", b"v%d" % i)
        t.omap_setkeys(cid, ho, {b"k%d" % i: b"ov%d" % i})
    st.apply_transaction(t)
    st.umount()


def _mon_store(path: str, pkg) -> None:
    async def build():
        store = pkg.store.kv.SQLiteKV(path)
        mon = pkg.mon.Monitor(pkg.utils.context.Context("mon"),
                              store=store)
        await mon.start()
        cl = pkg.client.RadosClient(mon.addr)
        await cl.connect()
        await cl.mon_command("osd pool create", pool="p", pg_num=8)
        await cl.mon_command("config set", who="global",
                             name="osd_max_pg_log_entries", value="777")
        await cl.mon_command("log", message="hello store")
        await cl.shutdown()
        await mon.shutdown()

    asyncio.run(build())


def test_store_tools_listings_match_reference(tmp_path, capsys):
    """Each package writes a KStore and a monitor store; both packages'
    tools list both stores identically."""
    import ceph_tpu
    import ceph_tpu.client
    import ceph_tpu.mon
    import ceph_tpu.store.kstore
    import ceph_tpu.store.kv
    import ceph_tpu.store.objectstore
    import ceph_tpu.utils.context
    import ceph_tpu_torch
    import ceph_tpu_torch.client
    import ceph_tpu_torch.mon
    import ceph_tpu_torch.store.kstore
    import ceph_tpu_torch.store.kv
    import ceph_tpu_torch.store.objectstore
    import ceph_tpu_torch.utils.context
    from ceph_tpu.cli import monstore_tool as ref_mst
    from ceph_tpu.cli import objectstore_tool as ref_ost

    stores = {}
    for name, pkg in (("ours", ceph_tpu_torch), ("ref", ceph_tpu)):
        os_ = pkg.store.objectstore
        kpath = str(tmp_path / ("%s.kstore" % name))
        _write_kstore(kpath, pkg.store.kstore.KStore, os_.Transaction,
                      os_.coll_t, os_.hobject_t)
        mpath = str(tmp_path / ("%s.mon" % name))
        _mon_store(mpath, pkg)
        stores[name] = (kpath, mpath)
    listings = {}
    for tool, mst in ((objectstore_tool, monstore_tool),
                      (ref_ost, ref_mst)):
        for name, (kpath, mpath) in sorted(stores.items()):
            got = []
            assert tool.main(["--data-path", kpath, "--op",
                              "list-pgs"]) == 0
            got.append(capsys.readouterr().out)
            assert tool.main(["--data-path", kpath, "--op", "list",
                              "--pgid", "1.0"]) == 0
            got.append(capsys.readouterr().out)
            for cmd in (["dump"], ["get-osdmap"], ["show-config"],
                        ["show-log", "5"]):
                assert mst.main([mpath] + cmd) == 0
                out = capsys.readouterr().out
                if cmd == ["dump"]:
                    out = {k: v for k, v in json.loads(out).items()
                           if "stamp" not in k}
                elif cmd == ["show-log", "5"]:
                    out = [ln.split(" ", 2)[-1]
                           for ln in out.splitlines()]
                got.append(out)
            listings[(tool.__name__.split(".")[0], name)] = got
    assert "1.0" in listings[("ceph_tpu_torch", "ours")][0]
    assert "obj-4" in listings[("ceph_tpu_torch", "ours")][1]
    # one tool on both packages' stores, both tools on one store
    assert (listings[("ceph_tpu_torch", "ours")]
            == listings[("ceph_tpu", "ours")])
    assert (listings[("ceph_tpu_torch", "ref")]
            == listings[("ceph_tpu", "ref")])
    # the two packages' object stores hold the same PG and objects
    assert (listings[("ceph_tpu_torch", "ours")][:2]
            == listings[("ceph_tpu_torch", "ref")][:2])


def test_gen_tables_regenerates_ln_tables(tmp_path, monkeypatch):
    """The generator's closed forms and the header it parses yield the
    port's _ln_tables.py values exactly (the header is written from
    the reference package's extracted tables)."""
    from ceph_tpu.ops.crush import _ln_tables as ref_tables
    assert _gen_tables.gen_rh_lh() == _ln_tables.RH_LH_TBL
    hdr = tmp_path / _gen_tables.HEADER
    hdr.parent.mkdir(parents=True)

    def table(name, vals):
        return "static const __u64 %s[%d] = {\n%s\n};\n" % (
            name, len(vals), ",\n".join("    0x%xull" % v for v in vals))

    hdr.write_text(table("__RH_LH_tbl", ref_tables.RH_LH_TBL)
                   + table("__LL_tbl", ref_tables.LL_TBL))
    out = tmp_path / "_ln_tables.py"
    monkeypatch.setattr(_gen_tables, "OUT", str(out))
    _gen_tables.main(str(tmp_path))
    got: dict = {}
    exec(out.read_text(), got)
    assert got["RH_LH_TBL"] == _ln_tables.RH_LH_TBL
    assert got["LL_TBL"] == _ln_tables.LL_TBL
    # below the docstring the generated file is the port's, byte for byte
    with open(_ln_tables.__file__) as fh:
        committed = fh.read()
    body = out.read_text()
    assert committed[committed.index("RH_LH_TBL"):] == \
        body[body.index("RH_LH_TBL"):]


@pytest.mark.parametrize("n", [1023, 1024, 4096, 65539])
def test_libgfec_matches_numpy_and_reference(n, monkeypatch):
    L = native.lib()
    assert L is not None, "gcc could not build libgfec"
    assert os.path.basename(os.path.dirname(L._name)) == "build"
    rng = np.random.default_rng(n)
    for m, k in ((1, 2), (3, 8), (4, 10), (6, 32)):
        matrix = rng.integers(0, 256, (m, k), dtype=np.uint8)
        data = rng.integers(0, 256, (k, n), dtype=np.uint8)
        routed = gf.matmul_u8(matrix, data)
        ref = ref_gf.matmul_u8(matrix, data)
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_TRIED", True)
        plain = gf.matmul_u8(matrix, data)
        monkeypatch.undo()
        np.testing.assert_array_equal(routed, plain)
        np.testing.assert_array_equal(routed, ref)
