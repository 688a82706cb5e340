"""Products wider than one kernel launch, against the JAX package.

A K1/K2 launch takes at most 256 input bits and 1024 output bitmatrix
rows, a K3 launch at most 256 input rows; the wrappers cut a wider
bitmatrix into slices of 256 columns (``pack_slices``) and row groups,
and XOR the slices' results.  Here, at device="cpu" (the kernels'
plain versions, through the same slicing loops), the jerasure
reed_sol_van profiles k=33,m=1,w=8; k=17,m=3,w=16; k=9,m=3,w=32 and
k=2,m=40,w=32, and SHEC k=9,m=3,c=2 at w=32 (a 288-bit product), run
encode_async / decode_async / delta_async against the reference's sync
codec; the raw wrappers at sliced shapes against the reference's XLA
DeviceEncoder; and decode_async under a ``mapping=`` profile on the
device route.  All values are integers: every comparison is exact.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import kernels as ref_kernels
from ceph_tpu.ec.plugin import ErasureCodePluginRegistry
from ceph_tpu_torch.device.runtime import DeviceRuntime
from ceph_tpu_torch.ec import kernels as K
from ceph_tpu_torch.ec import matrices, new_codec

torch.set_num_threads(1)

_WORD = {8: np.uint8, 16: np.uint16, 32: np.uint32}

WIDE = [
    ("jerasure", dict(technique="reed_sol_van", k=33, m=1, w=8)),
    ("jerasure", dict(technique="reed_sol_van", k=17, m=3, w=16)),
    ("jerasure", dict(technique="reed_sol_van", k=9, m=3, w=32)),
    ("jerasure", dict(technique="reed_sol_van", k=2, m=40, w=32)),
    ("shec", dict(k=9, m=3, c=2, w=32)),
]
WIDE_IDS = ["rs-k33-w8", "rs-k17-w16", "rs-k9-w32", "rs-m40-w32",
            "shec-k9-w32"]


def _codecs(plugin, profile):
    prof = {k: str(v) for k, v in profile.items()}
    ref = ErasureCodePluginRegistry.instance().factory(plugin, dict(prof))
    port = new_codec(dict(prof, plugin=plugin), device="cpu")
    return port, ref


def _objects(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8).tobytes() for s in sizes]


@pytest.mark.parametrize("mode", ["stream", "flush"])
@pytest.mark.parametrize("plugin,profile", WIDE, ids=WIDE_IDS)
def test_wide_profile_matches_reference(plugin, profile, mode):
    """encode_async, a single and (m > 1) a data + parity decode_async
    and delta_async on one and two data chunks equal the reference's
    sync encode / decode / parity_delta."""
    port, ref = _codecs(plugin, profile)
    n, k = port.get_chunk_count(), port.get_data_chunk_count()
    objs = _objects(n, (1000, 3 * k * 64 + 7))
    losses = [{0}] + ([{1, n - 1}] if n - k > 1 else [])
    rng = np.random.default_rng(k)
    deltas = [{0: rng.integers(0, 256, 96, np.uint8).tobytes()},
              {1: rng.integers(0, 256, 96, np.uint8).tobytes(),
               k - 1: rng.integers(0, 256, 96, np.uint8).tobytes()}]

    async def run():
        rt = DeviceRuntime.reset(device="cpu")
        rt.dispatch_mode = mode
        enc = await asyncio.gather(*[port.encode_async(set(range(n)), o)
                                     for o in objs])
        dec = await asyncio.gather(*[
            port.decode_async(lost, {c: e[c] for c in range(n)
                                     if c not in lost})
            for e in enc for lost in losses])
        dlt = await asyncio.gather(*[port.delta_async(d) for d in deltas])
        return enc, dec, dlt

    enc, dec, dlt = asyncio.run(run())
    assert enc == [ref.encode(set(range(n)), o) for o in objs]
    assert dec == [ref.decode(lost, {c: e[c] for c in range(n)
                                     if c not in lost})
                   for e in enc for lost in losses]
    assert dlt == [ref.parity_delta(d) for d in deltas]


@pytest.mark.parametrize("w,k,m,n", [
    (8, 33, 1, 203), (8, 40, 3, 64), (8, 8, 130, 9), (16, 17, 3, 77),
    (32, 9, 3, 50), (32, 2, 40, 13), (32, 10, 4, 5)])
def test_sliced_wrappers_match_reference_device_encoder(w, k, m, n):
    """fused_xor (w=8) and bitplane_matmul at more than 256 input bits
    and more than 1024 output rows: the wrapper's slicing loop, the
    plain version over the sliced masks and the reference's XLA
    DeviceEncoder agree."""
    rng = np.random.default_rng(k * m + w)
    mat = [[int(c) for c in rng.integers(1, 2 ** min(w, 16), k)]
           for _ in range(m)]
    bm = np.array(matrices.matrix_to_bitmatrix(k, m, w, mat))
    mk = torch.from_numpy(K.pack_slices(bm))
    assert tuple(K._sliced(mk).shape) == (-(-k * w // 256), m * w, 8)
    data = rng.integers(0, 2 ** w, (k, 4 * n), dtype=np.uint64).astype(
        _WORD[w])
    want = np.asarray(ref_kernels.DeviceEncoder(mat, w)(jnp.asarray(data)))
    if w == 8:
        d32 = torch.from_numpy(data.view(np.uint32))
        got = K.fused_xor(d32, mk)
        assert torch.equal(got, K.fused_xor_plain(d32, mk))
        got = got.numpy().view(np.uint8)
    else:
        d = torch.from_numpy(data)
        got = K.bitplane_matmul(d, mk, w)
        assert torch.equal(got, K.bitplane_matmul_plain(d, mk, w))
        got = got.numpy()
    np.testing.assert_array_equal(got, want)


def _xor_oracle(bm, rows):
    """numpy: output row r = XOR of the input rows bm[r] selects."""
    out = np.zeros((bm.shape[0], rows.shape[1]), np.uint8)
    for r in range(bm.shape[0]):
        sel = rows[bm[r] != 0]
        if len(sel):
            out[r] = np.bitwise_xor.reduce(sel, axis=0)
    return out


@pytest.mark.parametrize("in_rows,out_rows,B", [
    (320, 128, 9), (288, 96, 16), (600, 3, 1), (28, 14, 13), (24, 12, 4),
    (256, 7, 5)])
def test_xor_rows_wide_and_odd_rows(in_rows, out_rows, B):
    """K3's row view over more than 256 input rows (one schedule part a
    slice, indices counted from the slice's first row), any output row
    count and any row width: the wrapper, the plain version over the
    sliced masks, the sparse schedule run plainly and a numpy oracle
    agree, and the planes8 form is the same product on 8-row blocks."""
    rng = np.random.default_rng(in_rows * out_rows + B)
    bm = rng.integers(0, 2, (out_rows, in_rows)).astype(np.int8)
    bm[1] = 0
    rows = rng.integers(0, 256, (in_rows, 8 * B), dtype=np.uint8)
    mk = torch.from_numpy(K.pack_slices(bm))
    sched = K.XorSchedule(mk, in_rows)
    assert [p[:2] for p in sched.parts] == [
        (r0, min(256, in_rows - r0)) for r0 in range(0, in_rows, 256)]
    assert sched.pop == int(bm.sum()) and sched.out_rows == out_rows
    want = _xor_oracle(bm, rows)
    t = torch.from_numpy(rows)
    np.testing.assert_array_equal(K.xor_rows(t, mk).numpy(), want)
    np.testing.assert_array_equal(K.xor_rows(t, sched).numpy(), want)
    np.testing.assert_array_equal(K.xor_rows_plain(t, mk).numpy(), want)
    planes = t.view(in_rows * 8, B)
    np.testing.assert_array_equal(
        K.xor_schedule_sparse_plain(planes, sched).numpy(),
        want.reshape(out_rows * 8, B))
    np.testing.assert_array_equal(K.xor_schedule(planes, sched).numpy(),
                                  want.reshape(out_rows * 8, B))


def test_pack_slices_layout():
    """Up to 256 columns pack_slices is pack_rows; past it each slice is
    pack_rows of 256 columns, the last one zero-padded."""
    rng = np.random.default_rng(5)
    narrow = rng.integers(0, 2, (5, 256)).astype(np.int8)
    assert np.array_equal(K.pack_slices(narrow), K.pack_rows(narrow))
    wide = rng.integers(0, 2, (5, 300)).astype(np.int8)
    packed = K.pack_slices(wide)
    assert packed.shape == (2, 5, 8)
    assert np.array_equal(packed[0], K.pack_rows(wide[:, :256]))
    assert np.array_equal(packed[1], K.pack_rows(wide[:, 256:]))


def test_wrappers_reject_mismatched_slices():
    """Input rows that do not fill the masks' slices raise."""
    mk = torch.from_numpy(K.pack_slices(np.ones((8, 300), np.int8)))
    with pytest.raises(ValueError, match="slices"):
        K.fused_xor(torch.zeros((32, 4), dtype=torch.uint32), mk)
    with pytest.raises(ValueError, match="slices"):
        K.xor_rows(torch.zeros((256, 4), dtype=torch.uint8), mk)
    with pytest.raises(ValueError, match="slices"):
        K.bitplane_matmul(torch.zeros((16, 4), dtype=torch.uint8), mk, 8)


@pytest.mark.parametrize("mode", ["stream", "flush"])
def test_wide_failed_dispatch_fails_the_op(mode, monkeypatch):
    """A refused launch at a sliced shape fails the op with IOError; the
    runtime ends with nothing in flight."""
    def refused(*a, **kw):
        raise RuntimeError("bitplane_matmul: CUDA launch failed")

    port, _ref = _codecs(*WIDE[2])
    n = port.get_chunk_count()
    monkeypatch.setattr(K, "bitplane_matmul", refused)

    async def run():
        rt = DeviceRuntime.reset(device="cpu")
        rt.dispatch_mode = mode
        res = await asyncio.gather(
            port.encode_async(set(range(n)), b"x" * 5000),
            return_exceptions=True)
        return res, rt

    res, rt = asyncio.run(run())
    assert all(isinstance(r, IOError) for r in res), res
    assert rt.chips[0].queue.inflight == 0
    assert rt.chips[0].pool.outstanding == 0


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy_good"])
def test_mapping_decode_runs_on_the_device(technique, monkeypatch):
    """decode_async under mapping=D_DD_D maps the chunks to logical ids,
    rebuilds on the device and maps back: equal to the reference's sync
    decode, with the port's host decode made to raise."""
    prof = dict(technique=technique, k=4, m=2, mapping="D_DD_D",
                packetsize=16)
    port, ref = _codecs("jerasure", prof)
    n = port.get_chunk_count()
    objs = _objects(11, (3000, 777))
    stored = [ref.encode(set(range(n)), o) for o in objs]

    def no_host(*a, **kw):
        raise AssertionError("host codec reached from the async path")

    monkeypatch.setattr(port, "decode_chunks", no_host)
    monkeypatch.setattr(port, "encode_chunks", no_host)
    losses = [{0}, {1}, {1, 4}, {2, 5}]

    async def run():
        DeviceRuntime.reset(device="cpu")
        enc = await asyncio.gather(*[port.encode_async(set(range(n)), o)
                                     for o in objs])
        dec = await asyncio.gather(*[
            port.decode_async(lost, {c: s[c] for c in range(n)
                                     if c not in lost})
            for s in stored for lost in losses])
        return enc, dec

    enc, dec = asyncio.run(run())
    assert enc == stored
    assert dec == [ref.decode(lost, {c: s[c] for c in range(n)
                                     if c not in lost})
                   for s in stored for lost in losses]
