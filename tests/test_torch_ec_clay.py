"""The port's CLAY codec against the JAX package's, and the three
recovery codecs batched together.

new_codec({"plugin": "clay", ...}, device="cpu") -> encode_async /
decode_async / repair_async: each intersection-score round's MDS decode
(and repair's one decode over every repair plane) rides
`_device_matmul`, the dispatch stream or the flush batcher, the
per-chip runtime and K1's plain version; the 2x2 coupling solves stay
numpy.  Held bit for bit against the reference codec's sync encode /
decode / repair, its own async path (CEPH_TPU_EC_OFFLOAD=1), the golden
corpus, its sub-chunk read plans and its device families.
"""

import asyncio
import hashlib
import itertools
import json
import os

import numpy as np
import pytest
import torch

from ceph_tpu_torch.device.runtime import DeviceRuntime
from ceph_tpu_torch.ec import kernels as K
from ceph_tpu_torch.ec import new_codec
from ceph_tpu_torch.ec.clay import ErasureCodeClay
from test_torch_ec_lrc_shec import (HOST_ROUTE, PAYLOAD, _codecs, _names,
                                    _objects, _parity_round)

torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(__file__), "golden", "ec_corpus.json")
with open(CORPUS) as _f:
    _ENTRIES = [e for e in json.load(_f)["entries"]
                if e["plugin"] == "clay"]


def _helpers(codec, stored: dict, lost: int):
    """The sub-chunk runs minimum_to_decode plans for one lost chunk,
    cut from the stored chunks: {helper: bytes}."""
    n = codec.get_chunk_count()
    plan = codec.minimum_to_decode({lost}, set(range(n)) - {lost})
    sc = len(stored[lost]) // codec.get_sub_chunk_count()
    return {h: b"".join(stored[h][off * sc:(off + cnt) * sc]
                        for off, cnt in runs)
            for h, runs in plan.items()}


@pytest.mark.parametrize("entry", _ENTRIES, ids=[
    "-".join("%s%s" % kv for kv in sorted(e["profile"].items()))
    for e in _ENTRIES])
def test_corpus_entries(entry):
    """The port's sync encode and its encode_async give the corpus's
    chunk hashes."""
    codec = new_codec(dict(entry["profile"], plugin="clay"), device="cpu")
    n = entry["chunk_count"]
    assert codec.get_chunk_count() == n
    assert codec.get_data_chunk_count() == entry["data_chunk_count"]
    for encoded in (codec.encode(set(range(n)), PAYLOAD),
                    asyncio.run(codec.encode_async(set(range(n)),
                                                   PAYLOAD))):
        assert len(encoded[0]) == entry["chunk_size"]
        assert {str(i): hashlib.sha256(encoded[i]).hexdigest()
                for i in sorted(encoded)} == entry["sha256"]
    assert len(_ENTRIES) == 3


@pytest.mark.parametrize("mode", ["stream", "flush"])
@pytest.mark.parametrize("profile", [
    dict(k=4, m=3, d=5), dict(k=4, m=3, d=6), dict(k=4, m=2),
    dict(k=4, m=3, d=6, scalar_mds="isa"),
], ids=["k4m3d5", "k4m3d6", "k4m2d5", "k4m3d6-isa"])
def test_encode_decode_match_reference(profile, mode):
    port, ref = _codecs("clay", **profile)
    rt = _parity_round(port, ref, mode)
    assert all(t.ok for t in rt.chips[0].tickets)
    assert K.LAUNCHES["fused_xor"] == 0      # plain versions on the CPU


@pytest.mark.parametrize("profile", [
    dict(k=4, m=2), dict(k=4, m=3, d=6),
    dict(k=4, m=3, d=6, scalar_mds="isa"), dict(k=3, m=3, d=5),
], ids=["k4m2d5", "k4m3d6", "k4m3d6-isa", "k3m3d5"])
def test_repair_matches_reference(profile):
    """Every single loss, repaired concurrently from exactly the
    planned sub-chunk runs: the stored chunk, the reference's repair,
    and d/(d-k+1) sub-chunks a helper read."""
    port, ref = _codecs("clay", **profile)
    n = port.get_chunk_count()
    objs = _objects(21)
    stored = [ref.encode(set(range(n)), o) for o in objs]
    cases = [(lost, s, _helpers(port, s, lost))
             for s in stored for lost in range(n)]

    async def run():
        DeviceRuntime.reset(device="cpu")
        return await asyncio.gather(*[port.repair_async(lost, h)
                                      for lost, _s, h in cases])

    for (lost, s, helpers), got in zip(cases, asyncio.run(run())):
        assert got == s[lost] == ref.repair(lost, helpers), lost
        assert helpers == _helpers(ref, s, lost)
        q = port.d - port.k + 1
        assert (sum(map(len, helpers.values()))
                == port.d * len(s[lost]) // q)


def test_async_matches_reference_async(monkeypatch):
    """The port's encode_async / decode_async / repair_async == the
    reference's own device path (XLA programs on the CPU)."""
    monkeypatch.setenv("CEPH_TPU_EC_OFFLOAD", "1")
    port, ref = _codecs("clay", k=4, m=2)
    objs = _objects(12, (5000, 9000))

    async def run(codec):
        enc = await asyncio.gather(*[codec.encode_async(set(range(6)), o)
                                     for o in objs])
        dec = await asyncio.gather(*[
            codec.decode_async({0, 5}, {c: e[c] for c in range(1, 5)})
            for e in enc])
        rep = await asyncio.gather(*[
            codec.repair_async(2, _helpers(port, e, 2)) for e in enc])
        return enc, dec, rep

    assert asyncio.run(run(port)) == asyncio.run(run(ref))


def _plan(codec, want, avail):
    try:
        return codec.minimum_to_decode(set(want), set(avail))
    except (IOError, OSError) as e:
        return type(e)


@pytest.mark.parametrize("profile", [dict(k=4, m=2), dict(k=4, m=3, d=5)],
                         ids=["k4m2d5", "k4m3d5"])
def test_minimum_to_decode_matches_reference(profile):
    """Every single and double erasure, with the sub-chunk runs of the
    single-loss repair plan (d = k+m-1) and the whole-chunk plans."""
    port, ref = _codecs("clay", **profile)
    n = port.get_chunk_count()
    partial = 0
    for r in (1, 2):
        for lost in itertools.combinations(range(n), r):
            avail = set(range(n)) - set(lost)
            for want in (set(lost), set(range(port.k))):
                got = _plan(port, want, avail)
                assert got == _plan(ref, want, avail), (lost, want)
                partial += isinstance(got, dict) and any(
                    runs != [(0, port.get_sub_chunk_count())]
                    for runs in got.values())
    assert partial == (n if port.d == n - 1 else 0)


def test_device_families_match_reference():
    for profile in (dict(k=4, m=2), dict(k=4, m=3, d=6),
                    dict(k=4, m=3, d=6, scalar_mds="isa")):
        port, ref = _codecs("clay", **profile)
        fams = port.device_families()
        assert len(fams) == 2
        assert fams == ref.device_families()


def test_ragged_mix_concurrent():
    """A log-uniform size mix across LRC, SHEC and CLAY issued
    concurrently, in the stream and the flush mode: ragged widths and
    several matrices share the bucket staging, and every result equals
    the host codec's (tests/test_ec_recovery_codecs.py's mix)."""
    codecs = {name: _codecs(name, **prof) for name, prof in (
        ("lrc", dict(k=4, m=2, l=3)), ("shec", dict(k=4, m=3, c=2, w=8)),
        ("clay", dict(k=4, m=2)))}
    rng = np.random.default_rng(13)
    sizes = [int(s) for s in np.exp(rng.uniform(np.log(1 << 10),
                                                np.log(1 << 17), 6))]
    objs = [(name, rng.integers(0, 256, s, dtype=np.uint8).tobytes())
            for name in codecs for s in sizes]

    def want(name):
        return set(range(codecs[name][0].get_chunk_count()))

    hosts = [codecs[name][1].encode(want(name), d) for name, d in objs]
    for mode in ("stream", "flush"):
        async def run():
            rt = DeviceRuntime.reset(device="cpu")
            rt.dispatch_mode = mode
            enc = await asyncio.gather(*[
                codecs[name][0].encode_async(want(name), d)
                for name, d in objs])
            dec = await asyncio.gather(*[
                codecs[name][0].decode_async(
                    {0}, {c: e[c] for c in want(name) - {0}})
                for (name, _d), e in zip(objs, enc)])
            return enc, dec, rt

        enc, dec, rt = asyncio.run(run())
        assert enc == hosts, mode
        assert [d[0] for d in dec] == [h[0] for h in hosts], mode
        assert rt.chips[0].dispatches >= 3
        assert all(t.ok for t in rt.chips[0].tickets)


def test_async_paths_have_no_device_gate_or_host_route():
    sync = HOST_ROUTE | {"_decode_layered", "_decode_uncoupled", "repair"}
    for fn in (ErasureCodeClay._decode_layered_async,
               ErasureCodeClay.encode_async, ErasureCodeClay.decode_async,
               ErasureCodeClay.repair_async):
        assert not _names(fn.__code__) & sync, fn.__qualname__
    assert "_device_matmul" in _names(
        ErasureCodeClay._decode_layered_async.__code__)
    assert "_device_matmul" in _names(ErasureCodeClay.repair_async.__code__)


@pytest.mark.parametrize("mode", ["stream", "flush"])
def test_failed_dispatch_fails_the_op(mode, monkeypatch):
    """A refused launch fails encode_async, decode_async and
    repair_async with IOError; no host decode runs in their place."""
    def refused(*a, **kw):
        raise RuntimeError("CUDA launch failed")

    def no_host(*a, **kw):
        raise AssertionError("host codec reached from the async path")

    port, ref = _codecs("clay", k=4, m=2)
    objs = _objects(6)
    stored = [ref.encode(set(range(6)), o) for o in objs]
    monkeypatch.setattr(K, "fused_xor", refused)
    for name in ("encode_chunks", "decode_chunks", "repair",
                 "_decode_layered", "_decode_uncoupled"):
        monkeypatch.setattr(port, name, no_host)

    async def run():
        rt = DeviceRuntime.reset(device="cpu")
        rt.dispatch_mode = mode
        ops = [port.encode_async(set(range(6)), o) for o in objs]
        ops += [port.decode_async({1}, {c: s[c] for c in (0, 2, 3, 4, 5)})
                for s in stored]
        ops += [port.repair_async(3, _helpers(port, s, 3)) for s in stored]
        return await asyncio.gather(*ops, return_exceptions=True), rt

    res, rt = asyncio.run(run())
    assert all(isinstance(r, IOError) for r in res), res
    assert rt.chips[0].queue.inflight == 0
    assert rt.chips[0].pool.outstanding == 0
    assert not any(t.ok for t in rt.chips[0].tickets)

