"""ceph_tpu_torch EC kernels' plain versions against the JAX package.

The same seeded numpy inputs go through the reference's Pallas kernels
(interpreted off the TPU) and through the port's kernel wrappers, which
take their plain PyTorch versions for CPU tensors.  All values are
integers, so every comparison is exact.
"""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import gf as ref_gf
from ceph_tpu.ec import kernels as ref_kernels
from ceph_tpu.ec import matrices as ref_matrices
from ceph_tpu.ec.plugin import ErasureCodePluginRegistry
from ceph_tpu_torch.ec import kernels as K
from ceph_tpu_torch.ec import matrices, new_codec

torch.set_num_threads(1)

CPU = torch.device("cpu")
_WORD = {8: np.uint8, 16: np.uint16, 32: np.uint32}


def _masks(bitmatrix) -> torch.Tensor:
    return torch.from_numpy(K.pack_rows(bitmatrix))


def _words(rng, shape, w):
    return rng.integers(0, 2 ** w, shape, dtype=np.uint64).astype(_WORD[w])


def test_pack_rows_layout():
    bm = np.zeros((3, 20), dtype=np.int8)
    bm[0, 0] = bm[1, 19] = bm[2, 5] = bm[2, 16] = 1
    packed = K.pack_rows(bm)
    assert packed.shape == (3, 8) and packed.dtype == np.uint32
    assert packed[0, 0] == 1
    assert packed[1, 0] == 1 << 19
    assert packed[2, 0] == (1 << 5) | (1 << 16)
    assert not packed[:, 1:].any()
    with pytest.raises(ValueError):
        K.pack_rows(np.zeros((1, 257)))


# ---------------------------------------------------------------------------
# K1 fused_xor
# ---------------------------------------------------------------------------


def test_fused_xor_matches_reference_pallas():
    """K1 plain version == reference FusedEncoder (Pallas, interpreted)
    on ragged widths with a zero-column stretch."""
    k, m = 8, 3
    mat = matrices.isa_rs_vandermonde_matrix(k, m)
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (k, 4100), dtype=np.uint8)
    data[:, 40:400] = 0
    ref = ref_kernels.FusedEncoder(mat, tile_bytes=4096)(data)
    port = K.FusedEncoder(mat, CPU)(data)
    np.testing.assert_array_equal(port, ref)
    assert not port[:, 40:400].any()
    # the wrapper on the uint32 view, at widths the lane groups of 8
    # do not divide
    for lanes in (1, 7, 1025):
        d32 = np.ascontiguousarray(data[:, :4 * lanes]).view(np.uint32)
        got = K.fused_xor(torch.from_numpy(d32), _masks(
            matrices.matrix_to_bitmatrix(k, m, 8, mat)))
        np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                      ref[:, :4 * lanes])


def test_fused_xor_decode_rows_match_reference():
    """K1 through decoder_for (reconstruction rows) == the reference's
    decoder, and it restores the erased chunks."""
    k, m = 4, 2
    mat = matrices.isa_cauchy_matrix(k, m)
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, (k, 2048), dtype=np.uint8)
    port = K.FusedEncoder(mat, CPU)
    parity = port(data)
    erased = (1, 4)
    surv = tuple(i for i in range(k + m) if i not in erased)
    src = np.stack([data[i] if i < k else parity[i - k]
                    for i in surv[:k]])
    got = port.decoder_for(erased, surv)(src)
    ref = ref_kernels.FusedEncoder(mat, tile_bytes=4096).decoder_for(
        erased, surv)(src)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], data[1])
    np.testing.assert_array_equal(got[1], parity[0])


def test_fused_xor_row_groups():
    """m > 4 output chunks (two kernel row groups on the card) still
    equal the host codec."""
    k, m = 6, 6
    mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, 8)
    rng = np.random.default_rng(13)
    data = rng.integers(0, 256, (k, 640), dtype=np.uint8)
    np.testing.assert_array_equal(
        K.FusedEncoder(mat, CPU)(data),
        ref_gf.matmul_u8(np.array(mat, dtype=np.uint8), data))


# ---------------------------------------------------------------------------
# K2 bitplane_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w,k,m,n", [(8, 8, 3, 1000), (16, 4, 2, 513),
                                     (32, 3, 2, 300)])
def test_bitplane_matmul_matches_reference_pallas(w, k, m, n):
    """K2 plain version == reference DeviceEncoder with the Pallas tile
    kernel (interpreted) and == its XLA program, for w = 8, 16, 32."""
    mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, w)
    rng = np.random.default_rng(20 + w)
    data = _words(rng, (k, n), w)
    data[:, 5:60] = 0
    ref_p = np.asarray(ref_kernels.DeviceEncoder(
        mat, w, use_pallas=True, tile=256)(jnp.asarray(data)))
    ref_x = np.asarray(ref_kernels.DeviceEncoder(mat, w)(jnp.asarray(data)))
    port = K.DeviceEncoder(mat, w, CPU)(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(port, ref_p)
    np.testing.assert_array_equal(port, ref_x)
    assert not port[:, 5:60].any()


@pytest.mark.parametrize("w", [8, 16, 32])
def test_bitplane_matmul_decode_matches_reference(w):
    k, m = 4, 3
    mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, w)
    rng = np.random.default_rng(30 + w)
    data = _words(rng, (k, 200), w)
    port = K.DeviceEncoder(mat, w, CPU)
    parity = port(torch.from_numpy(data)).numpy()
    erased = (0, 2, 5)
    surv = tuple(i for i in range(k + m) if i not in erased)
    src = np.stack([data[i] if i < k else parity[i - k]
                    for i in surv[:k]])
    got = port.decoder_for(erased, surv)(torch.from_numpy(src)).numpy()
    ref = np.asarray(ref_kernels.DeviceEncoder(mat, w).decoder_for(
        erased, surv)(jnp.asarray(src)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], data[0])
    np.testing.assert_array_equal(got[1], data[2])
    np.testing.assert_array_equal(got[2], parity[1])


def test_encode_batch_layout():
    enc = K.encoder_for_profile("isa", "reed_sol_van", 8, 3, device="cpu")
    rng = np.random.default_rng(0)
    stripes = rng.integers(0, 256, size=(6, 8, 128), dtype=np.uint8)
    out = enc.encode_batch(stripes).numpy()
    ref = np.asarray(ref_kernels.encoder_for_profile(
        "isa", "reed_sol_van", 8, 3).encode_batch(stripes))
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# K3 xor_schedule
# ---------------------------------------------------------------------------


def test_xor_schedule_matches_reference_pallas():
    """K3 plain version == reference PlanesEncoder (Pallas, interpreted),
    encode and decode_rows."""
    k, m = 6, 3
    mat = matrices.cauchy_good_general_coding_matrix(k, m, 8)
    rng = np.random.default_rng(40)
    chunks = rng.integers(0, 256, (k, 1024), dtype=np.uint8)
    planes = K.bytes_to_planes8(chunks)
    np.testing.assert_array_equal(planes,
                                  ref_kernels.bytes_to_planes8(chunks))
    ref = ref_kernels.PlanesEncoder(mat, tile=8)
    port = K.PlanesEncoder(mat, CPU)
    ref_out = np.asarray(ref(jnp.asarray(planes)))
    got = port(torch.from_numpy(planes)).numpy()
    np.testing.assert_array_equal(got, ref_out)
    np.testing.assert_array_equal(
        K.planes8_to_bytes(got, m),
        ref_gf.matmul_u8(np.array(mat, dtype=np.uint8), chunks))
    erased = (0, 4, 7)
    surv = tuple(i for i in range(k + m) if i not in erased)
    allp = np.concatenate([planes, got])
    src = np.concatenate([allp[c * 64:(c + 1) * 64] for c in surv[:k]])
    rec = port.decode_rows(erased, surv)(torch.from_numpy(src)).numpy()
    np.testing.assert_array_equal(
        rec, np.asarray(ref.decode_rows(erased, surv)(jnp.asarray(src))))
    np.testing.assert_array_equal(rec[0:64], planes[0:64])
    np.testing.assert_array_equal(rec[128:192], got[64:128])


def _k3_cases():
    """(name, bitmatrix, in_rows) for K3's schedule tests: an encode, a
    decode signature and a bitmatrix with a row of zeros."""
    k, m = 6, 3
    mat = matrices.cauchy_good_general_coding_matrix(k, m, 8)
    enc = np.array(matrices.matrix_to_bitmatrix(k, m, 8, mat), np.int8)
    erased = (1, 7)
    surv = tuple(i for i in range(k + m) if i not in erased)
    rows = K._reconstruction_rows(mat, k, 8, erased, surv)
    dec = np.array(matrices.matrix_to_bitmatrix(k, len(rows), 8, rows),
                   np.int8)
    zero = enc.copy()
    zero[[0, 5, 23]] = 0
    return [("encode", enc), ("decode", dec), ("zero_rows", zero)]


def test_xor_schedule_table_layout():
    """Each row's sources in order, its list 4-byte aligned, the padding
    and the tail zeros, a zero row counted 0."""
    bm = np.zeros((4, 300), np.int8)
    bm[0, [0, 3, 255]] = 1
    bm[2, :7] = 1
    bm[3, [1, 299]] = 1                   # 299 >= in_rows: not a source
    spans, idx = K.xor_schedule_table(K.pack_rows(bm[:, :256]), 256)
    assert spans.dtype == np.int32 and idx.dtype == np.uint8
    assert spans.tolist() == [[0, 3], [4, 0], [4, 7], [12, 1]]
    assert idx[0:3].tolist() == [0, 3, 255] and idx[3] == 0
    assert idx[4:11].tolist() == list(range(7)) and idx[11] == 0
    assert idx[12] == 1 and idx.size == 20 and not idx[13:].any()
    assert (spans[:, 0] % 4 == 0).all()
    s = K.XorSchedule(torch.from_numpy(K.pack_rows(bm[:, :256])), 256)
    assert s.pop == 11 and (s.in_rows, s.out_rows) == (256, 4)
    assert s.spans.device == CPU and s.idx.device == CPU


@pytest.mark.parametrize("case", range(3), ids=["encode", "decode",
                                                "zero_rows"])
def test_xor_schedule_sparse_matches_plain_and_reference(case):
    """K3's sparse schedule, run plainly, == xor_schedule_plain == the
    reference's Pallas XOR schedule (interpreted) on the same bitmatrix:
    encode rows, a decode signature's rows and rows of zeros."""
    name, bm = _k3_cases()[case]
    in_rows = bm.shape[1]
    rng = np.random.default_rng(50 + case)
    planes = rng.integers(0, 256, (in_rows * 8, 24), dtype=np.uint8)
    mk = _masks(bm)
    sched = K.XorSchedule(mk, in_rows)
    assert sched.pop == int(bm.sum())
    p = torch.from_numpy(planes)
    got = K.xor_schedule_sparse_plain(p, sched).numpy()
    np.testing.assert_array_equal(got, K.xor_schedule_plain(p, mk).numpy())
    np.testing.assert_array_equal(got, K.xor_schedule(p, sched).numpy())
    ref = np.asarray(ref_kernels._xor_schedule_pallas(bm, 8)(
        jnp.asarray(planes)))
    np.testing.assert_array_equal(got, ref)
    for r in np.flatnonzero(~bm.any(axis=1)):
        assert not got[8 * r:8 * r + 8].any()


def test_planes_encoder_caches_its_schedules():
    """PlanesEncoder builds its schedule once, and decode_rows one per
    erasure signature, each equal to a schedule built from the masks it
    holds (the encoder's own masks for the encode)."""
    k, m = 4, 2
    enc = K.PlanesEncoder(matrices.isa_cauchy_matrix(k, m), CPU)
    assert enc._schedule.masks is enc._masks
    want = K.xor_schedule_table(enc._masks.numpy(), k * 8)
    assert np.array_equal(enc._schedule.spans.numpy(), want[0])
    assert np.array_equal(enc._schedule.idx.numpy(), want[1])
    surv = (1, 2, 3, 4, 5)
    fn = enc.decode_rows((0,), surv)
    assert enc.decode_rows((0,), surv) is fn
    sched = fn.keywords["masks"]
    want = K.xor_schedule_table(sched.masks.numpy(), k * 8)
    assert np.array_equal(sched.spans.numpy(), want[0])
    assert (sched.in_rows, sched.out_rows) == (k * 8, 8)


def test_encode_stripes_matches_reference():
    k, m = 8, 3
    mat = matrices.isa_rs_vandermonde_matrix(k, m)
    rng = np.random.default_rng(41)
    stripes = rng.integers(0, 256, (3, k, 192), dtype=np.uint8)
    got = K.PlanesEncoder(mat, CPU).encode_stripes(stripes)
    ref = ref_kernels.PlanesEncoder(mat, tile=8).encode_stripes(stripes)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# wrappers: checks, and no fallback off the CPU
# ---------------------------------------------------------------------------


def test_wrappers_reject_bad_inputs():
    mk = _masks(np.ones((8, 16), dtype=np.int8))
    d = torch.zeros((2, 8), dtype=torch.uint32)
    with pytest.raises(TypeError):
        K.fused_xor(d.to(torch.int64), mk)
    with pytest.raises(ValueError):
        K.fused_xor(torch.zeros((2, 16), dtype=torch.uint32)[:, ::2], mk)
    with pytest.raises(ValueError):
        K.xor_schedule(torch.zeros((12, 4), dtype=torch.uint8), mk)
    with pytest.raises(ValueError):
        K.bitplane_matmul(torch.zeros((2, 4), dtype=torch.uint8), mk, 12)


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """Off the CPU a wrapper goes to the CUDA library or raises; the
    plain versions are never reached.  (Here the build has no nvcc, so
    it raises.)"""
    def boom(*a, **kw):
        raise AssertionError("plain version reached off the CPU")

    for name in ("fused_xor_plain", "bitplane_matmul_plain",
                 "xor_schedule_plain"):
        monkeypatch.setattr(K, name, boom)
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    K._build.library.cache_clear()
    monkeypatch.setattr(K._build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(K._build, "BUILD_DIR", K._build.BUILD_DIR / "none")
    meta = torch.device("meta")
    mk8 = _masks(np.ones((8, 32), dtype=np.int8)).to(meta)
    before = dict(K.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        K.fused_xor(torch.empty((4, 8), dtype=torch.uint32, device=meta),
                    mk8)
    with pytest.raises(RuntimeError, match="nvcc"):
        K.bitplane_matmul(torch.empty((4, 8), dtype=torch.uint8,
                                      device=meta), mk8, 8)
    with pytest.raises(RuntimeError, match="nvcc"):
        K.xor_schedule(torch.empty((32, 8), dtype=torch.uint8,
                                   device=meta), mk8)
    with pytest.raises(RuntimeError, match="nvcc"):
        K.xor_schedule(torch.empty((256, 8), dtype=torch.uint8,
                                   device=meta),
                       K.XorSchedule(np.ones((8, 8), np.uint32), 32, meta))
    assert K.LAUNCHES == before
    K._build.library.cache_clear()


# ---------------------------------------------------------------------------
# state carried across, matrices, golden corpus
# ---------------------------------------------------------------------------

_SLICE_MATRICES = [
    ("isa_rs_vandermonde_matrix", (8, 3)),
    ("isa_rs_vandermonde_matrix", (10, 4)),
    ("isa_cauchy_matrix", (6, 3)),
    ("reed_sol_vandermonde_coding_matrix", (2, 1, 8)),
    ("reed_sol_vandermonde_coding_matrix", (8, 3, 16)),
    ("reed_sol_vandermonde_coding_matrix", (8, 3, 32)),
    ("reed_sol_r6_coding_matrix", (4, 8)),
]


@pytest.mark.parametrize("fn,args", _SLICE_MATRICES)
def test_matrices_match_reference(fn, args):
    got = getattr(matrices, fn)(*args)
    assert got == getattr(ref_matrices, fn)(*args)
    w = args[2] if len(args) == 3 else (args[1] if "r6" in fn else 8)
    k, m = len(got[0]), len(got)
    assert (matrices.matrix_to_bitmatrix(k, m, w, got)
            == ref_matrices.matrix_to_bitmatrix(k, m, w, got))


def _state(enc, bitmatrix, kind):
    return {"matrix": np.array(enc.matrix), "bitmatrix": np.asarray(
        bitmatrix), "w": np.int64(enc.w), "kind": kind}


def test_load_reference_state():
    """The reference encoders' arrays load into the port's encoders of
    the same kind, which then compute the reference's outputs."""
    rng = np.random.default_rng(50)
    mat = ref_matrices.isa_rs_vandermonde_matrix(4, 2)
    ref_d = ref_kernels.DeviceEncoder(mat, 16)
    port_d = K.load_reference_state(
        _state(ref_d, ref_d._bm, "DeviceEncoder"), "cpu")
    assert isinstance(port_d, K.DeviceEncoder) and port_d.w == 16
    data = _words(rng, (4, 96), 16)
    np.testing.assert_array_equal(
        port_d(torch.from_numpy(data)).numpy(),
        np.asarray(ref_d(jnp.asarray(data))))
    ref_p = ref_kernels.PlanesEncoder(mat, tile=8)
    port_p = K.load_reference_state(
        _state(ref_p, ref_p._bitmatrix, "PlanesEncoder"), "cpu")
    planes = rng.integers(0, 256, (4 * 64, 16), dtype=np.uint8)
    np.testing.assert_array_equal(
        port_p(torch.from_numpy(planes)).numpy(),
        np.asarray(ref_p(jnp.asarray(planes))))
    ref_f = ref_kernels.FusedEncoder(mat)
    port_f = K.load_reference_state(
        _state(ref_f, ref_f._bitmatrix, "FusedEncoder"), "cpu")
    assert isinstance(port_f, K.FusedEncoder)
    bad = _state(ref_f, ref_f._bitmatrix, "FusedEncoder")
    bad["bitmatrix"] = bad["bitmatrix"].copy()
    bad["bitmatrix"][0, 0] ^= 1
    with pytest.raises(ValueError):
        K.load_reference_state(bad, "cpu")


PAYLOAD = bytes((7 * i + 3) % 256 for i in range(4096)) + b"tail-bytes!"
CORPUS = os.path.join(os.path.dirname(__file__), "golden", "ec_corpus.json")
with open(CORPUS) as f:
    _corpus = json.load(f)
_SLICE_ENTRIES = [
    e for e in _corpus["entries"]
    if e["plugin"] == "isa" or e["profile"].get("technique") in (
        "reed_sol_van", "reed_sol_r6_op")]


@pytest.mark.parametrize(
    "entry", _SLICE_ENTRIES,
    ids=["%s-%s-k%sm%s" % (e["plugin"], e["profile"].get("technique"),
                           e["profile"]["k"], e["profile"]["m"])
         for e in _SLICE_ENTRIES])
def test_golden_corpus(entry):
    """The port's codec — sync host path and the plain kernels behind
    encode_async — reproduces the pinned chunk hashes."""
    import asyncio
    assert hashlib.sha256(PAYLOAD).hexdigest() == _corpus["payload_sha256"]
    codec = new_codec(dict(entry["profile"], plugin=entry["plugin"]),
                      device="cpu")
    n = entry["chunk_count"]
    sync = codec.encode(set(range(n)), PAYLOAD)
    dev = asyncio.run(codec.encode_async(set(range(n)), PAYLOAD))
    for enc in (sync, dev):
        assert len(enc[0]) == entry["chunk_size"]
        got = {str(i): hashlib.sha256(enc[i]).hexdigest()
               for i in sorted(enc)}
        assert got == entry["sha256"]
    ref = ErasureCodePluginRegistry.instance().factory(
        entry["plugin"], dict(entry["profile"]))
    assert codec.get_chunk_size(len(PAYLOAD)) == ref.get_chunk_size(
        len(PAYLOAD))
