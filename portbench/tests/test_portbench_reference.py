"""The plain references against fixed vectors: the isa Reed-Solomon
cases of the repository's EC corpus and the straw2 placements and
primitives recorded from the reference C implementation, read as data."""

import ast
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from portbench.reference import gf256_rs, straw2
ROOT = Path(__file__).resolve().parents[2]

GOLDEN = ROOT / "tests" / "golden"
# tests/golden/gen_ec_corpus.py's payload
PAYLOAD = bytes((7 * i + 3) % 256 for i in range(4096)) + b"tail-bytes!"


def _load(name):
    with open(GOLDEN / name) as f:
        return json.load(f)


def _isa_cases():
    return [e for e in _load("ec_corpus.json")["entries"]
            if e["plugin"] == "isa"
            and e["profile"].get("technique") == "reed_sol_van"]


@pytest.mark.parametrize("entry", _isa_cases(),
                         ids=lambda e: "k%s_m%s" % (e["profile"]["k"],
                                                   e["profile"]["m"]))
def test_rs_encode_matches_corpus(entry):
    k, m = int(entry["profile"]["k"]), int(entry["profile"]["m"])
    shards = gf256_rs.encode(PAYLOAD, k, m)
    assert len(shards[0]) == entry["chunk_size"]
    for i, s in enumerate(shards):
        assert hashlib.sha256(s).hexdigest() == entry["sha256"][str(i)]


def test_rs_delta_is_the_change_of_parity():
    k, m = 8, 3
    rng = np.random.default_rng(3)
    old = rng.bytes(8 * 4096)
    cs = gf256_rs.chunk_size(len(old), k)
    j, off = 5, 1024
    patch = rng.bytes(512)
    new = bytearray(old)
    new[j * cs + off:j * cs + off + 512] = patch
    before = gf256_rs.encode(old, k, m)
    after = gf256_rs.encode(bytes(new), k, m)
    deltas = gf256_rs.delta(old[j * cs + off:j * cs + off + 512], patch,
                            j, k, m)
    for i in range(m):
        got = np.frombuffer(before[k + i], np.uint8).copy()
        got[off:off + 512] ^= np.frombuffer(deltas[i], np.uint8)
        assert got.tobytes() == after[k + i]


def test_rs_rows_are_gf_gen_rs_matrix():
    assert gf256_rs.rs_van_coefficients(4, 3) == [
        [1, 1, 1, 1], [1, 2, 4, 8], [1, 4, 16, 64]]
    assert gf256_rs.gf_mul(0x80, 2) == 0x1D


def test_crush_primitives_match():
    p = _load("crush_primitives.json")
    h2 = np.array(p["hash2_in"])
    assert (straw2.hash32_2(h2[:, 0], h2[:, 1]).astype(np.int64)
            == np.array(p["hash2_out"])).all()
    h3 = np.array(p["hash3_in"])
    assert (straw2.hash32_3(h3[:, 0], h3[:, 1], h3[:, 2]).astype(np.int64)
            == np.array(p["hash3_out"])).all()
    assert (straw2.crush_ln(np.array(p["ln_in"]))
            == np.array(p["ln_out"])).all()


def _parse(v):
    return ast.literal_eval(v) if isinstance(v, str) else v


@pytest.mark.parametrize("name", ["flat_straw2_10", "flat_straw2_100_weird",
                                  "hier_straw2_4x4", "hier_straw2_8x3"])
def test_straw2_placements_match(name):
    case = _load("crush_mappings.json")[name]
    m = _parse(case["map"])
    reweight = np.array(_parse(case["reweights"]))
    tree = straw2.CrushTree({b["id"]: (b["type"], b["items"],
                                       b["item_weights"])
                             for b in m["buckets"]}, len(reweight))
    steps = {r["id"]: r["steps"] for r in m["rules"]}[0]
    checked = 0
    for (rule, x, rmax), want in zip(_parse(case["queries"]),
                                     _parse(case["results"])):
        if rule != 0:
            continue
        got = straw2.do_rule(tree, steps, np.array([x]), rmax, reweight)[0]
        assert [int(g) for g in got if g != straw2.ITEM_NONE] == want
        checked += 1
    assert checked >= 60


def test_straw2_batches_like_single_queries():
    case = _load("crush_mappings.json")["hier_straw2_8x3"]
    m = _parse(case["map"])
    reweight = np.array(_parse(case["reweights"]))
    tree = straw2.CrushTree({b["id"]: (b["type"], b["items"],
                                       b["item_weights"])
                             for b in m["buckets"]}, len(reweight))
    steps = {r["id"]: r["steps"] for r in m["rules"]}[0]
    xs = np.arange(300)
    batch = straw2.do_rule(tree, steps, xs, 3, reweight)
    for x in (0, 17, 299):
        assert (straw2.do_rule(tree, steps, xs[x:x + 1], 3, reweight)[0]
                == batch[x]).all()
