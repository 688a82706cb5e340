"""The jerasure bitmatrix techniques of the port against the JAX package.

cauchy_orig, cauchy_good, liberation, blaum_roth and liber8tion:
new_codec(profile, device="cpu") -> encode_async / decode_async ->
the batcher's bitmatrix family -> BitmatrixEncoder -> K3's row view
(its plain version here), held bit for bit against the golden corpus
and the reference codec's sync encode / decode, with the reference's
profile checks and error texts.  A failed dispatch fails the op, and
the async route never reaches the host codec.
"""

import asyncio
import hashlib
import itertools
import json
import os

import numpy as np
import pytest
import torch

from ceph_tpu.ec.plugin import ErasureCodePluginRegistry
from ceph_tpu_torch.device.runtime import DeviceRuntime
from ceph_tpu_torch.ec import batcher as B
from ceph_tpu_torch.ec import kernels as K
from ceph_tpu_torch.ec import new_codec

torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(__file__), "golden", "ec_corpus.json")
with open(CORPUS) as _f:
    _corpus = json.load(_f)
# same formula as tests/golden/gen_ec_corpus.py
PAYLOAD = bytes((7 * i + 3) % 256 for i in range(4096)) + b"tail-bytes!"
TECHNIQUES = ("cauchy_orig", "cauchy_good", "liberation", "blaum_roth")
_BITMATRIX_ENTRIES = [e for e in _corpus["entries"]
                      if e["profile"].get("technique") in TECHNIQUES]

PROFILES = [
    dict(technique="cauchy_orig", k=4, m=2, packetsize=32),
    dict(technique="cauchy_good", k=6, m=3, packetsize=16),
    dict(technique="liberation", k=4, m=2, w=7, packetsize=8),
    dict(technique="blaum_roth", k=4, m=2, w=6, packetsize=16),
    dict(technique="liber8tion", k=4, m=2, packetsize=8,
         **{"jerasure-allow-nonreference-layout": "true"}),
]
PROFILE_IDS = ["cauchy_orig", "cauchy_good", "liberation", "blaum_roth",
               "liber8tion"]


def _codecs(profile):
    prof = {k: str(v) for k, v in profile.items()}
    ref = ErasureCodePluginRegistry.instance().factory("jerasure",
                                                       dict(prof))
    port = new_codec(dict(prof, plugin="jerasure"), device="cpu")
    return port, ref


def _objects(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8).tobytes() for s in sizes]


def _decode_all(port, stored, losses, mode="stream"):
    n = port.get_chunk_count()

    async def run():
        rt = DeviceRuntime.reset(device="cpu")
        rt.dispatch_mode = mode
        return await asyncio.gather(*[
            port.decode_async(lost, {c: s[c] for c in range(n)
                                     if c not in lost})
            for s in stored for lost in losses])

    return asyncio.run(run())


@pytest.mark.parametrize(
    "entry", _BITMATRIX_ENTRIES,
    ids=["%s-k%sm%s" % (e["profile"]["technique"], e["profile"]["k"],
                        e["profile"]["m"]) for e in _BITMATRIX_ENTRIES])
def test_golden_corpus(entry):
    """encode_async reproduces the pinned chunk hashes, and decode_async
    restores a data chunk, and a data and a parity chunk, from them."""
    assert hashlib.sha256(PAYLOAD).hexdigest() == _corpus["payload_sha256"]
    port = new_codec(dict(entry["profile"], plugin=entry["plugin"]),
                     device="cpu")
    n, k = entry["chunk_count"], entry["data_chunk_count"]
    assert port.get_chunk_size(len(PAYLOAD)) == entry["chunk_size"]

    async def run():
        DeviceRuntime.reset(device="cpu")
        return await port.encode_async(set(range(n)), PAYLOAD)

    enc = asyncio.run(run())
    assert {str(i): hashlib.sha256(enc[i]).hexdigest()
            for i in sorted(enc)} == entry["sha256"]
    losses = [{0}, {k - 1, n - 1}]
    assert _decode_all(port, [enc], losses) == [
        {c: enc[c] for c in lost} for lost in losses]


@pytest.mark.parametrize("mode", ["stream", "flush"])
@pytest.mark.parametrize("profile", PROFILES, ids=PROFILE_IDS)
def test_matches_reference_sync(profile, mode):
    """Seeded objects (under, at and over one alignment unit):
    encode_async equals the reference's sync encode, and decode_async
    equals its sync decode over every single erasure and a sample of
    double erasures (two data, data and parity, two parity)."""
    port, ref = _codecs(profile)
    n, k = port.get_chunk_count(), port.get_data_chunk_count()
    align = ref.get_alignment()
    objs = _objects(n + len(mode), (1000, align, 2 * align + 5))

    async def run():
        rt = DeviceRuntime.reset(device="cpu")
        rt.dispatch_mode = mode
        return await asyncio.gather(*[port.encode_async(set(range(n)), o)
                                      for o in objs])

    stored = asyncio.run(run())
    assert stored == [ref.encode(set(range(n)), o) for o in objs]
    losses = [{c} for c in range(n)] + [{0, 1}, {1, k}, {k, k + 1},
                                        {k - 1, n - 1}]
    got = _decode_all(port, stored, losses, mode)
    assert got == [ref.decode(lost, {c: s[c] for c in range(n)
                                     if c not in lost})
                   for s in stored for lost in losses]


@pytest.mark.parametrize("profile", [
    dict(technique="cauchy_good", k=3, m=2, packetsize=4),
    dict(technique="cauchy_good", k=3, m=2, packetsize=3),
    dict(technique="cauchy_orig", k=4, m=3, packetsize=6),
    dict(technique="cauchy_good", k=5, m=3, w=16, packetsize=8),
    dict(technique="cauchy_orig", k=4, m=2, packetsize=64,
         **{"jerasure-per-chunk-alignment": "true"}),
    dict(technique="cauchy_good", k=6, m=3,
         **{"jerasure-per-chunk-alignment": "true"}),
    dict(technique="liberation", k=3, m=2, w=5, packetsize=12),
    dict(technique="blaum_roth", k=6, m=2, w=10, packetsize=4),
    dict(technique="blaum_roth", k=4, m=2, w=7, packetsize=8,
         **{"jerasure-allow-nonreference-layout": "true"}),
    dict(technique="cauchy_good", k=4, m=2, packetsize=8,
         mapping="D_DD_D"),
], ids=["cauchy-ps4", "cauchy-ps3", "cauchy-orig-ps6", "cauchy-w16",
        "cauchy-orig-per-chunk", "cauchy-per-chunk-default-ps",
        "liberation-w5-ps12",
        "blaum_roth-w10", "blaum_roth-w7-flag", "cauchy-mapping"])
def test_profile_variants(profile):
    """packetsize, w and jerasure-per-chunk-alignment variants (chunk
    sizes equal to the reference's; packets that the card permutes as
    8-, 4-, 2- and 1-byte words), blaum_roth w=7 under its flag and
    a mapping= profile: encode_async and a double-loss decode_async
    equal the reference's sync codec."""
    port, ref = _codecs(profile)
    n = port.get_chunk_count()
    for size in (1, 5000, 3 * ref.get_alignment() + 1):
        assert port.get_chunk_size(size) == ref.get_chunk_size(size)
    objs = _objects(7, (5000, ref.get_alignment() + 3))

    async def run():
        DeviceRuntime.reset(device="cpu")
        return await asyncio.gather(*[port.encode_async(set(range(n)), o)
                                      for o in objs])

    stored = asyncio.run(run())
    assert stored == [ref.encode(set(range(n)), o) for o in objs]
    losses = [{0, n - 1}, {1, 2}]
    assert _decode_all(port, stored, losses) == [
        ref.decode(lost, {c: s[c] for c in range(n) if c not in lost})
        for s in stored for lost in losses]


@pytest.mark.parametrize("profile", [
    dict(technique="liberation", k=4, m=2, w=6),
    dict(technique="liberation", k=4, m=3, w=7),
    dict(technique="liberation", k=8, m=2, w=7),
    dict(technique="liberation", k=4, m=2, w=7, packetsize=6),
    dict(technique="blaum_roth", k=4, m=2, w=5),
    dict(technique="blaum_roth", k=4, m=2, w=7),
    dict(technique="liber8tion", k=4, m=2),
    dict(technique="liber8tion", k=4, m=2, w=7,
         **{"jerasure-allow-nonreference-layout": "true"}),
    dict(technique="cauchy_good", k=4, m=2, w=8, packetsize=3,
         **{"jerasure-per-chunk-alignment": "true"}),
    dict(technique="no_such_technique", k=4, m=2),
], ids=["liberation-w6", "liberation-m3", "liberation-k-over-w",
        "liberation-ps6", "blaum_roth-w5", "blaum_roth-w7-no-flag",
        "liber8tion-no-flag", "liber8tion-w7", "per-chunk-partial-window",
        "unknown"])
def test_profile_errors_match_reference(profile):
    """The reference's parse-time rejections, with its texts: a w that
    is not prime (liberation) or w+1 not prime (blaum_roth), m != 2,
    k > w, a packetsize off a multiple of 4, the non-reference-layout
    gate, a per-chunk alignment that would cut a window, an unknown
    technique."""
    prof = {k: str(v) for k, v in profile.items()}
    with pytest.raises(ValueError) as ref_err:
        ErasureCodePluginRegistry.instance().factory("jerasure", dict(prof))
    with pytest.raises(ValueError) as port_err:
        new_codec(dict(prof, plugin="jerasure"), device="cpu")
    assert str(port_err.value) == str(ref_err.value)


def test_partial_window_and_delta_raise_like_the_reference():
    """A chunk that is not whole windows raises the reference's
    ValueError on the sync and the async route; parity_delta and
    delta_async raise its ValueError for a bitmatrix code."""
    prof = dict(technique="cauchy_good", k=4, m=2, packetsize=16)
    port, ref = _codecs(prof)
    chunks = {i: bytes(100) for i in range(4)}
    with pytest.raises(ValueError) as ref_err:
        ref.encode_chunks(dict(chunks))
    with pytest.raises(ValueError) as port_err:
        port.encode_chunks(dict(chunks))
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="whole number of"):
        asyncio.run(port.encode_chunks_async(dict(chunks)))
    with pytest.raises(ValueError) as ref_err:
        ref.parity_delta({0: bytes(64)})
    with pytest.raises(ValueError) as port_err:
        port.parity_delta({0: bytes(64)})
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match=str(ref_err.value)):
        asyncio.run(port.delta_async({0: bytes(64)}))


@pytest.mark.parametrize("profile", PROFILES[:3], ids=PROFILE_IDS[:3])
def test_async_route_is_the_device_route(profile, monkeypatch):
    """With the codec's sync encode_chunks / decode_chunks made to raise,
    encode_async and decode_async still return the reference's bytes,
    and every product took the bitmatrix family to BitmatrixEncoder."""
    port, ref = _codecs(profile)
    n = port.get_chunk_count()

    def no_host(*a, **kw):
        raise AssertionError("host codec reached from the async path")

    monkeypatch.setattr(port, "encode_chunks", no_host)
    monkeypatch.setattr(port, "decode_chunks", no_host)
    runs = []
    run_windows = K.BitmatrixEncoder.run_windows

    def counted(self, windows):
        runs.append(tuple(windows.shape))
        return run_windows(self, windows)

    monkeypatch.setattr(K.BitmatrixEncoder, "run_windows", counted)
    objs = _objects(3, (4000, 9000))

    async def run():
        DeviceRuntime.reset(device="cpu")
        enc = await asyncio.gather(*[port.encode_async(set(range(n)), o)
                                     for o in objs])
        dec = await asyncio.gather(*[
            port.decode_async({0, n - 1}, {c: e[c] for c in range(1, n - 1)})
            for e in enc])
        return enc, dec

    enc, dec = asyncio.run(run())
    assert enc == [ref.encode(set(range(n)), o) for o in objs]
    assert dec == [{0: e[0], n - 1: e[n - 1]} for e in enc]
    window = port.w * port.packetsize
    assert runs and all(s[2] == window for s in runs)


@pytest.mark.parametrize("mode", ["stream", "flush"])
def test_failed_dispatch_fails_the_op(mode, monkeypatch):
    """A refused K3 launch fails every op with IOError and leaves the
    runtime with nothing in flight; nothing re-encodes on the host."""
    def refused(*a, **kw):
        raise RuntimeError("xor_schedule: CUDA launch failed")

    port, ref = _codecs(PROFILES[1])
    n = port.get_chunk_count()
    stored = ref.encode(set(range(n)), b"y" * 7000)
    monkeypatch.setattr(K, "xor_rows", refused)

    async def run():
        rt = DeviceRuntime.reset(device="cpu")
        rt.dispatch_mode = mode
        res = await asyncio.gather(
            port.encode_async(set(range(n)), b"x" * 7000),
            port.decode_async({0}, {c: stored[c] for c in range(1, n)}),
            return_exceptions=True)
        return res, rt

    res, rt = asyncio.run(run())
    assert all(isinstance(r, IOError) for r in res), res
    assert rt.chips[0].queue.inflight == 0
    assert rt.chips[0].pool.outstanding == 0


def test_bitmatrix_and_matrix_jobs_never_share_a_batch(monkeypatch):
    """A cauchy_good and a reed_sol_van codec of the same k, m and w
    encoding concurrently in flush mode: every flush key carries one
    family, the bitmatrix one a BitmatrixFamily, and both results are
    right."""
    cauchy, ref_c = _codecs(dict(technique="cauchy_good", k=4, m=2,
                                 packetsize=8))
    rs, ref_r = _codecs(dict(technique="reed_sol_van", k=4, m=2))
    keys = []
    flush = B.DeviceBatcher._flush

    def spy(self, key):
        keys.append(key)
        return flush(self, key)

    monkeypatch.setattr(B.DeviceBatcher, "_flush", spy)
    objs = _objects(9, (3000, 1500))

    async def run():
        rt = DeviceRuntime.reset(device="cpu")
        rt.dispatch_mode = "flush"
        return await asyncio.gather(
            *[c.encode_async(set(range(6)), o)
              for c, o in itertools.product((cauchy, rs), objs)])

    got = asyncio.run(run())
    assert got == [r.encode(set(range(6)), o)
                   for r, o in itertools.product((ref_c, ref_r), objs)]
    families = {key[1] for key in keys}
    assert families == {8, B.BitmatrixFamily(8, 8)}
    assert cauchy.device_families() == [
        (cauchy._bitmatrix_key(), B.BitmatrixFamily(8, 8))]


def test_cauchy_orig_w32():
    """cauchy_orig k=9,m=3,w=32: a 96 x 288 bitmatrix (two K3 slices);
    encode_async and one double-loss decode_async equal the
    reference's sync codec."""
    port, ref = _codecs(dict(technique="cauchy_orig", k=9, m=3, w=32,
                             packetsize=8))
    n = port.get_chunk_count()
    objs = _objects(13, (9 * 32 * 8 * 4 + 1,))

    async def run():
        DeviceRuntime.reset(device="cpu")
        return await port.encode_async(set(range(n)), objs[0])

    stored = asyncio.run(run())
    assert stored == ref.encode(set(range(n)), objs[0])
    lost = {2, 10}
    assert _decode_all(port, [stored], [lost]) == [
        ref.decode(lost, {c: stored[c] for c in range(n)
                          if c not in lost})]


def test_bitmatrix_encoder_decode_rows():
    """BitmatrixEncoder: run_windows equals the row product, decode_rows
    is built once per signature and restores the erased chunks' rows."""
    port, _ref = _codecs(PROFILES[2])
    k, m, w = port.k, port.m, port.w
    enc = K.BitmatrixEncoder(port.bitmatrix, w, "cpu")
    rng = np.random.default_rng(17)
    ps, nw = 8, 3
    windows = torch.from_numpy(rng.integers(0, 256, (k, nw, w * ps),
                                            dtype=np.uint8))
    rows = windows.view(k, nw, w, ps).permute(0, 2, 1, 3).reshape(
        k * w, nw * ps)
    par_rows = enc(rows.contiguous())
    par = enc.run_windows(windows)
    assert torch.equal(par.view(m, nw, w, ps).permute(0, 2, 1, 3).reshape(
        m * w, nw * ps), par_rows)
    erased, surv = (1, k), (0, 2, 3, k + 1)
    dec = enc.decode_rows(erased, surv)
    assert enc.decode_rows(erased, surv) is dec
    allrows = torch.cat([rows, par_rows]).view(k + m, w, nw * ps)
    src = torch.cat([allrows[c] for c in surv])
    rec = dec(src.contiguous()).view(len(erased), w, nw * ps)
    assert torch.equal(rec[0], allrows[1]) and torch.equal(rec[1],
                                                           allrows[k])


def test_default_device_without_a_card_raises(monkeypatch):
    """No card and no device="cpu": the bitmatrix async path raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codec = new_codec({"plugin": "jerasure", "technique": "cauchy_good",
                       "k": "4", "m": "2", "packetsize": "8"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(codec.encode_async(set(range(6)), b"z" * 3000))
