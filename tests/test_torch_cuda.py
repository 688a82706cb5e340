"""The CUDA kernels against their plain versions on the card.

Needs a CUDA card and nvcc; elsewhere every test here skips.  On the
card:  python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import kernels as K
from ceph_tpu_torch.ec import matrices

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _masks(bm, dev):
    return torch.from_numpy(K.pack_rows(bm)).to(dev)


@pytest.mark.parametrize("k,m,lanes", [(8, 3, 8195), (10, 6, 1027)])
def test_fused_xor_on_card(card, k, m, lanes):
    mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, 8)
    mk = _masks(matrices.matrix_to_bitmatrix(k, m, 8, mat), card)
    rng = np.random.default_rng(k)
    d = torch.from_numpy(rng.integers(0, 2**32, (k, lanes),
                                      dtype=np.uint32)).to(card)
    before = K.LAUNCHES["fused_xor"]
    got = K.fused_xor(d, mk)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_xor"] == before + -(-m // 4)
    assert torch.equal(got, K.fused_xor_plain(d, mk))


@pytest.mark.parametrize("w", [8, 16, 32])
def test_bitplane_matmul_on_card(card, w):
    k, m = 8, 3
    mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, w)
    mk = _masks(matrices.matrix_to_bitmatrix(k, m, w, mat), card)
    dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[w]
    rng = np.random.default_rng(w)
    d = torch.from_numpy(rng.integers(0, 2**w, (k, 3001), dtype=np.uint64)
                         .astype(dt)).to(card)
    got = K.bitplane_matmul(d, mk, w)
    torch.cuda.synchronize()
    assert torch.equal(got, K.bitplane_matmul_plain(d, mk, w))


@pytest.mark.parametrize("k,m,P", [(8, 3, 4096), (6, 5, 1001)])
def test_xor_schedule_on_card(card, k, m, P):
    enc = K.PlanesEncoder(matrices.isa_cauchy_matrix(k, m), card)
    rng = np.random.default_rng(P)
    p = torch.from_numpy(rng.integers(0, 256, (k * 64, P),
                                      dtype=np.uint8)).to(card)
    got = enc(p)
    torch.cuda.synchronize()
    assert torch.equal(got, K.xor_schedule_plain(p, enc._masks))


# ---------------------------------------------------------------------------
# CRUSH kernels (K4-K7)
# ---------------------------------------------------------------------------


def _crush_tables(card):
    from ceph_tpu_torch.models.crushmap import (CHOOSELEAF_FIRSTN, EMIT,
                                                STRAW2, TAKE, CrushMap)
    from ceph_tpu_torch.ops.crush.device import DeviceMapper
    m = CrushMap()
    hosts = [m.add_bucket(STRAW2, 1, list(range(5 * h, 5 * h + 5)),
                          [0x10000, 0x8000, 0, 0x20000, 0x10000],
                          id=-(h + 2)).id for h in range(8)]
    m.add_bucket(STRAW2, 2, hosts, [0x30000] * 8, id=-1)
    m.add_rule([(TAKE, -1, 0), (CHOOSELEAF_FIRSTN, 0, 1), (EMIT, 0, 0)],
               id=0)
    return DeviceMapper(m, device=card)


@pytest.mark.parametrize("lanes", [1, 4097, 70001])
def test_crush_descend_on_card(card, lanes):
    from ceph_tpu_torch.ops.crush import kernels as CK
    t = _crush_tables(card).fm.tables
    rng = np.random.default_rng(lanes)
    x = torch.from_numpy(rng.integers(0, 2**32, lanes,
                                      dtype=np.int64)).to(card)
    r = torch.from_numpy(rng.integers(0, 50, lanes).astype(np.int32)
                         ).to(card)
    pos = torch.zeros_like(r)
    for want, bid, depth in ((1, torch.zeros_like(r), (8,)),
                             (0, (r % 8 + 1).contiguous(), (5,))):
        before = CK.LAUNCHES["descend"]
        got = CK.descend(t, depth, want, x, r, bid, pos)
        torch.cuda.synchronize()
        assert CK.LAUNCHES["descend"] == before + 1
        plain = CK.descend_plain(t, depth, want, x, r, bid, pos)
        assert torch.equal(got[0], plain[0])
        assert torch.equal(got[1], plain[1])


def test_crush_post_hitscan_rowcompact_on_card(card):
    from ceph_tpu_torch.ops.crush import kernels as CK
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 40, (9999, 5)).astype(np.int32)
    raw[rng.random(raw.shape) < 0.2] = 0x7FFFFFFF
    raw = torch.from_numpy(raw).to(card)
    keep = torch.from_numpy(rng.random(40) < 0.8).to(card)
    for can_shift in (True, False):
        got = CK.post(raw, keep, can_shift)
        plain = CK.post_plain(raw, keep, can_shift)
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1],
                                                             plain[1])
    assert torch.equal(CK.hitscan(raw, keep), CK.hitscan_plain(raw, keep))
    hit = torch.from_numpy(rng.random(50001) < 0.05).to(card)
    for kt in (4, 128):
        got = CK.rowcompact(hit, 1000, kt, 49000)
        plain = CK.rowcompact_plain(hit, 1000, kt, 49000)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
