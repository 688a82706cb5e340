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
