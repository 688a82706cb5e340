"""The port's LRC and SHEC codecs against the JAX package's.

new_codec({"plugin": "lrc" | "shec", ...}, device="cpu") ->
encode_async / decode_async through `_device_matmul`, the dispatch
stream or the flush batcher, the per-chip runtime and the kernels'
plain versions (K1 at w=8, K2 at w=16/32), held bit for bit against the
reference codec's sync encode / decode, its own encode_async /
decode_async (CEPH_TPU_EC_OFFLOAD=1), the golden corpus, its read plans
and its device families.  A failed dispatch fails the op.
"""

import asyncio
import hashlib
import inspect
import itertools
import json
import os

import numpy as np
import pytest
import torch

from ceph_tpu.ec.plugin import ErasureCodePluginRegistry
from ceph_tpu_torch.device.runtime import DeviceRuntime
from ceph_tpu_torch.ec import kernels as K
from ceph_tpu_torch.ec import new_codec
from ceph_tpu_torch.ec.base import ErasureCode
from ceph_tpu_torch.ec.lrc import ErasureCodeLrc
from ceph_tpu_torch.ec.shec import ErasureCodeShec

torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(__file__), "golden", "ec_corpus.json")
with open(CORPUS) as _f:
    _corpus = json.load(_f)
# same formula as tests/golden/gen_ec_corpus.py
PAYLOAD = bytes((7 * i + 3) % 256 for i in range(4096)) + b"tail-bytes!"
SIZES = (5000, 64 << 10)


def _lrc_w_profile(w: int) -> dict:
    """The k=4,m=2,l=3 kml shape with an explicit per-layer word
    width (the kml shorthand pins w=8 through the layer defaults)."""
    layers = [["DDc_DDc_", "w=%d" % w],
              ["DDDc____", "w=%d" % w],
              ["____DDDc", "w=%d" % w]]
    return {"mapping": "DD__DD__", "layers": json.dumps(layers)}


def _codecs(plugin, **profile):
    prof = {k: str(v) for k, v in profile.items()}
    ref = ErasureCodePluginRegistry.instance().factory(plugin, dict(prof))
    port = new_codec(dict(prof, plugin=plugin), device="cpu")
    return port, ref


def _loss_patterns(codec):
    """Single data, single parity, and a data + parity double loss
    when m allows (tests/test_ec_recovery_codecs.py `_loss_patterns`)."""
    n = codec.get_chunk_count()
    k = codec.get_data_chunk_count()
    mapping = codec.get_chunk_mapping()
    data_pos = [mapping[i] for i in range(k)] if mapping else list(range(k))
    parity_pos = [i for i in range(n) if i not in data_pos]
    pats = [{data_pos[0]}, {parity_pos[0]}]
    if len(parity_pos) > 1:
        pats.append({data_pos[-1], parity_pos[-1]})
    return pats


def _objects(seed, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8).tobytes() for s in sizes]


def _parity_round(port, ref, mode, seed=3):
    """Every object encoded, then every loss pattern of every object
    decoded, all concurrently; each result against the reference's
    sync codec.  Returns the port's runtime."""
    n = port.get_chunk_count()
    want = set(range(n))
    objs = _objects(seed)
    hosts = [ref.encode(want, o) for o in objs]
    cases = []
    for h in hosts:
        for lost in _loss_patterns(ref):
            chunks = {i: h[i] for i in range(n) if i not in lost}
            try:
                cases.append((lost, chunks, ref.decode(set(lost), chunks)))
            except (IOError, OSError):
                continue        # pattern unrecoverable for this codec

    async def run():
        rt = DeviceRuntime.reset(device="cpu")
        rt.dispatch_mode = mode
        enc = await asyncio.gather(*[port.encode_async(want, o)
                                     for o in objs])
        dec = await asyncio.gather(*[port.decode_async(set(lost), ch)
                                     for lost, ch, _ in cases])
        return enc, dec, rt

    enc, dec, rt = asyncio.run(run())
    assert enc == hosts
    assert len(cases) >= 2 * len(objs)
    for (lost, _ch, want_dec), got in zip(cases, dec):
        assert got == want_dec, sorted(lost)
    return rt


# ---------------------------------------------------------------------------
# the golden corpus
# ---------------------------------------------------------------------------

_ENTRIES = [e for e in _corpus["entries"] if e["plugin"] in ("lrc", "shec")]


@pytest.mark.parametrize("entry", _ENTRIES, ids=[
    "%s-%s" % (e["plugin"], "-".join("%s%s" % kv for kv in
                                     sorted(e["profile"].items())))
    for e in _ENTRIES])
def test_corpus_entries(entry):
    """The port's sync encode and its encode_async give the corpus's
    chunk hashes."""
    codec = new_codec(dict(entry["profile"], plugin=entry["plugin"]),
                      device="cpu")
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


# ---------------------------------------------------------------------------
# encode / decode against the reference's sync codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", [8, 16, 32])
def test_shec_matches_reference(w):
    port, ref = _codecs("shec", k=4, m=3, c=2, w=w)
    kern = "fused_xor" if w == 8 else "bitplane_matmul"
    rt = _parity_round(port, ref, "stream", seed=w)
    assert rt.chips[0].dispatches >= 3
    assert all(t.ok for t in rt.chips[0].tickets)
    # the plain versions ran: no CUDA launch is counted on the CPU
    assert K.LAUNCHES[kern] == 0


@pytest.mark.parametrize("w", [8, 16, 32])
def test_lrc_matches_reference(w):
    port, ref = _codecs("lrc", **_lrc_w_profile(w))
    _parity_round(port, ref, "flush", seed=w)


@pytest.mark.parametrize("profile", [
    dict(plugin="lrc", k=4, m=2, l=3),
    dict(plugin="lrc", k=8, m=4, l=3),
    dict(plugin="shec", k=8, m=4, c=3, w=8),
    dict(plugin="shec", k=6, m=4, c=3, technique="single"),
], ids=["lrc-k4m2l3", "lrc-k8m4l3", "shec-k8m4c3", "shec-single-k6m4c3"])
def test_profiles_match_reference(profile):
    """The recovery phase's LRC and SHEC profiles, the kml default and
    the single-shingle technique."""
    profile = dict(profile)
    port, ref = _codecs(profile.pop("plugin"), **profile)
    _parity_round(port, ref, "stream")


def test_encode_async_matches_reference_encode_async(monkeypatch):
    """The port's encode_async / decode_async == the reference's own
    device path (XLA programs on the CPU) on the same concurrent ops."""
    monkeypatch.setenv("CEPH_TPU_EC_OFFLOAD", "1")
    cases = [_codecs("lrc", k=4, m=2, l=3),
             _codecs("shec", k=4, m=3, c=2, w=16)]
    objs = _objects(11, (5000, 12000))

    async def run(i):
        out = []
        for codecs in cases:
            codec = codecs[i]
            n = codec.get_chunk_count()
            enc = await asyncio.gather(*[codec.encode_async(set(range(n)),
                                                            o)
                                         for o in objs])
            lost = _loss_patterns(codec)[0]
            dec = await asyncio.gather(*[
                codec.decode_async(lost, {c: e[c] for c in range(n)
                                          if c not in lost})
                for e in enc])
            out.append((enc, dec))
        return out

    assert asyncio.run(run(0)) == asyncio.run(run(1))


# ---------------------------------------------------------------------------
# read planning and device families
# ---------------------------------------------------------------------------


def _plan(codec, want, avail):
    try:
        return codec.minimum_to_decode(set(want), set(avail))
    except (IOError, OSError) as e:
        return type(e)


@pytest.mark.parametrize("plugin,profile", [
    ("lrc", dict(k=4, m=2, l=3)),
    ("shec", dict(k=4, m=3, c=2)),
], ids=["lrc-k4m2l3", "shec-k4m3c2"])
def test_minimum_to_decode_matches_reference(plugin, profile):
    """Every single and double erasure: the plan to rebuild the lost
    chunks and the plan to read every data chunk."""
    port, ref = _codecs(plugin, **profile)
    n = port.get_chunk_count()
    data = {port.chunk_index(i) for i in range(port.get_data_chunk_count())}
    checked = 0
    for r in (1, 2):
        for lost in itertools.combinations(range(n), r):
            avail = set(range(n)) - set(lost)
            for want in (set(lost), data):
                assert (_plan(port, want, avail)
                        == _plan(ref, want, avail)), (lost, want)
                checked += 1
    assert checked == 2 * (n + n * (n - 1) // 2)


def test_device_families_match_reference():
    """RS has its coding matrix; LRC its global and local layer
    matrices and a local repair; SHEC its matrix and a repair."""
    for (plugin, profile), count in [
            (("jerasure", dict(technique="reed_sol_van", k=8, m=4)), 1),
            (("lrc", dict(k=4, m=2, l=3)), 3),
            (("lrc", _lrc_w_profile(16)), 3),
            (("shec", dict(k=4, m=3, c=2)), 2),
            (("shec", dict(k=4, m=3, c=2, w=32)), 2)]:
        port, ref = _codecs(plugin, **profile)
        fams = port.device_families()
        assert len(fams) == count, plugin
        assert ([([list(r) for r in mat], w) for mat, w in fams]
                == [([list(r) for r in mat], w)
                    for mat, w in ref.device_families()]), plugin


# ---------------------------------------------------------------------------
# the card path has no host route
# ---------------------------------------------------------------------------


def _names(code) -> set:
    """Every global and attribute name a function's code (nested
    functions included) refers to."""
    names = set(code.co_names)
    for const in code.co_consts:
        if inspect.iscode(const):
            names |= _names(const)
    return names


# the reference's device-state gates and host routes after a dispatch
HOST_ROUTE = {"device_offload_enabled", "chip_available", "host_encode",
              "matmul_u8", "matmul_words", "encode_chunks",
              "decode_chunks"}


def test_async_paths_have_no_device_gate_or_host_route():
    # an LRC layer's repair runs through its codec's decode_chunks_async
    for fn in (ErasureCodeLrc.encode_async, ErasureCodeLrc.decode_async,
               ErasureCode.encode_chunks_async,
               ErasureCode.decode_chunks_async,
               ErasureCode._reconstruct_async, ErasureCodeShec.decode_async):
        assert not _names(fn.__code__) & HOST_ROUTE, fn.__qualname__
    assert "matmul_words" in _names(ErasureCodeShec.decode_chunks.__code__)


@pytest.mark.parametrize("mode", ["stream", "flush"])
@pytest.mark.parametrize("plugin,profile", [
    ("lrc", dict(k=4, m=2, l=3)),
    ("lrc", _lrc_w_profile(32)),
    ("shec", dict(k=4, m=3, c=2)),
    ("shec", dict(k=4, m=3, c=2, w=16)),
], ids=["lrc-w8", "lrc-w32", "shec-w8", "shec-w16"])
def test_failed_dispatch_fails_the_op(plugin, profile, mode, monkeypatch):
    """A refused launch fails encode_async and decode_async with
    IOError; no host codec runs in their place."""
    def refused(*a, **kw):
        raise RuntimeError("CUDA launch failed")

    def no_host(*a, **kw):
        raise AssertionError("host codec reached from the async path")

    port, ref = _codecs(plugin, **profile)
    n = port.get_chunk_count()
    objs = _objects(5)
    hosts = [ref.encode(set(range(n)), o) for o in objs]
    monkeypatch.setattr(K, "fused_xor", refused)
    monkeypatch.setattr(K, "bitplane_matmul", refused)
    for codec in [port] + [ly.codec for ly in getattr(port, "layers", [])]:
        monkeypatch.setattr(codec, "encode_chunks", no_host)
        monkeypatch.setattr(codec, "decode_chunks", no_host)
    from ceph_tpu_torch.ec import gf
    monkeypatch.setattr(gf, "matmul_words", no_host)
    monkeypatch.setattr(gf, "matmul_u8", no_host)
    lost = _loss_patterns(port)[0]

    async def run():
        rt = DeviceRuntime.reset(device="cpu")
        rt.dispatch_mode = mode
        ops = [port.encode_async(set(range(n)), o) for o in objs]
        ops += [port.decode_async(lost, {c: h[c] for c in range(n)
                                         if c not in lost})
                for h in hosts]
        return await asyncio.gather(*ops, return_exceptions=True), rt

    res, rt = asyncio.run(run())
    assert all(isinstance(r, IOError) for r in res), res
    assert rt.chips[0].queue.inflight == 0
    assert rt.chips[0].pool.outstanding == 0
    assert not any(t.ok for t in rt.chips[0].tickets)


def test_lrc_layer_without_device_form_raises():
    """A layer whose codec has no GF(2^w) matrix form runs on its own
    codec's device route: a CLAY layer through CLAY's per-round MDS
    products, a cauchy_good layer through the bitmatrix family (K3's
    plain version here).  encode_async / decode_async equal the
    reference's sync codec, single and double losses, and the device
    families are the layer codec's."""
    clay = [["DDDDcc", "plugin=clay technique=reed_sol_van"]]
    cauchy = [["DDc_DDc_", "plugin=jerasure technique=cauchy_good "
               "packetsize=64"],
              ["DDDc____", ""], ["____DDDc", ""]]
    for mapping, layers in (("DDDD__", clay), ("DD__DD__", cauchy)):
        port, ref = _codecs("lrc", mapping=mapping,
                            layers=json.dumps(layers))
        n = port.get_chunk_count()
        objs = _objects(1, (4096, 9000))

        async def run():
            DeviceRuntime.reset(device="cpu")
            enc = await asyncio.gather(*[
                port.encode_async(set(range(n)), o) for o in objs])
            dec = await asyncio.gather(*[
                port.decode_async(lost, {c: e[c] for c in range(n)
                                         if c not in lost})
                for e in enc for lost in ({0}, {1, n - 1})])
            return enc, dec

        enc, dec = asyncio.run(run())
        assert enc == [ref.encode(set(range(n)), o) for o in objs]
        want = [ref.decode(lost, {c: e[c] for c in range(n)
                                  if c not in lost})
                for e in enc for lost in ({0}, {1, n - 1})]
        assert dec == want
        assert port.layers[0].codec.device_families()[0] in \
            port.device_families()


@pytest.mark.parametrize("plugin,profile", [
    ("lrc", dict(k=4, m=2, l=3)),
    ("shec", dict(k=4, m=3, c=2)),
    ("clay", dict(k=4, m=2)),
])
def test_default_device_without_a_card_raises(plugin, profile,
                                              monkeypatch):
    """No card and no device="cpu": the codec's async path raises, the
    inner codecs included; device="cpu" runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prof = dict({k: str(v) for k, v in profile.items()}, plugin=plugin)
    codec = new_codec(dict(prof))
    n = codec.get_chunk_count()
    obj = _objects(2, (5000,))[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(codec.encode_async(set(range(n)), obj))
    enc = codec.encode(set(range(n)), obj)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(codec.decode_async({0}, {i: enc[i]
                                             for i in range(1, n)}))
    cpu = new_codec(dict(prof), device="cpu")
    assert asyncio.run(cpu.encode_async(set(range(n)), obj)) == enc
