"""The steps of the card's K1/K2 product on the CPU.

On the card K1 (``fused_xor``) and K2 (``bitplane_matmul``) are one
tensor-core kernel: column words gathered with byte permutes, one
AND-popcount product, the parity bits packed.  ``gf2_product_plain``
runs those steps with the kernel's own permute selectors, shifts and
masks;
here it is held against the plain versions and the reference's Pallas
kernels (interpreted off the TPU) on the same seeded inputs, at the
edges of the kernels' ranges.  All values are integers: every
comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import kernels as ref_kernels
from ceph_tpu_torch.ec import kernels as K
from ceph_tpu_torch.ec import matrices

torch.set_num_threads(1)

_WORD = {8: np.uint8, 16: np.uint16, 32: np.uint32}


def _masks(bitmatrix) -> torch.Tensor:
    return torch.from_numpy(K.pack_rows(bitmatrix))


def _words(rng, shape, w):
    return rng.integers(0, 2 ** w, shape, dtype=np.uint64).astype(_WORD[w])


def test_byte_permutes_transpose_4x4_blocks():
    rng = np.random.default_rng(50)
    x = rng.integers(0, 2**32, (4, 9), dtype=np.uint64).astype(np.int64)
    got = K._transpose4x4([torch.from_numpy(r) for r in x])
    b = x.astype(np.uint32).view(np.uint8).reshape(4, 9, 4)  # [r][i][c]
    want = np.ascontiguousarray(b.transpose(2, 1, 0)).view(np.uint32)
    for c in range(4):
        np.testing.assert_array_equal(got[c].numpy(), want[c, :, 0])


@pytest.mark.parametrize("w,k", [(8, 5), (16, 3), (32, 2), (8, 32)])
def test_column_words_hold_each_columns_input_bits(w, k):
    """Word s of column c holds bits 32s.. of the column's k*w input
    bits, bit j*w + x = bit x of element (j, c) (bitmatrix order)."""
    rng = np.random.default_rng(51 + w)
    data = _words(rng, (k, 21), w)
    got = K.column_words_plain(torch.from_numpy(data), w).numpy()
    bits = ((data.astype(np.uint64)[:, None, :] >>
             np.arange(w, dtype=np.uint64)[None, :, None]) & 1)
    bits = bits.reshape(k * w, -1)                      # (k*w, n)
    slots = -(-k * w // 32)
    full = np.zeros((slots * 32, bits.shape[1]), dtype=np.uint64)
    full[:k * w] = bits
    want = (full.reshape(slots, 32, -1)
            << np.arange(32, dtype=np.uint64)[None, :, None]).sum(axis=1)
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_parity_pack_takes_the_low_bit_of_each_count():
    rng = np.random.default_rng(52)
    for w in (8, 16, 32):
        counts = rng.integers(0, 257, (3 * w, 11))
        got = K.parity_pack_plain(torch.from_numpy(counts), w).numpy()
        par = (counts & 1).reshape(3, w, 11).astype(np.int64)
        want = (par << np.arange(w)[None, :, None]).sum(axis=1)
        np.testing.assert_array_equal(got, want)


# (w, k, m, n): k*w = 256 and m*w = 1024 at the edges, k = 1, m = 1..5,
# n = 1, 7 and 8195 (ragged against the 16-byte loads)
_SHAPES = [(8, 8, 3, 1000), (8, 1, 1, 7), (8, 32, 4, 8195), (8, 10, 5, 1),
           (16, 4, 2, 513), (16, 16, 1, 7), (32, 3, 2, 300), (32, 8, 32, 9),
           (32, 1, 1, 1)]


@pytest.mark.parametrize("w,k,m,n", _SHAPES)
def test_product_steps_match_plain_versions(w, k, m, n):
    """gf2_product_plain == bitplane_matmul_plain for encode rows, a
    bitmatrix row of zeros and decode rows; at w=8 also == fused_xor_plain
    on the same bytes as uint32 lanes."""
    mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, w)
    bm = np.array(matrices.matrix_to_bitmatrix(k, m, w, mat))
    rng = np.random.default_rng(53 + n)
    data = _words(rng, (k, n), w)
    zero = bm.copy()
    zero[-1] = 0
    erased = (0, k) if m > 1 else (0,)
    surv = tuple(i for i in range(k + m) if i not in erased)
    rows = K._reconstruction_rows(mat, k, w, erased, surv)
    dec = np.array(matrices.matrix_to_bitmatrix(k, len(rows), w, rows))
    d = torch.from_numpy(data)
    for b in (bm, zero, dec):
        got = K.gf2_product_plain(d, _masks(b), w)
        assert torch.equal(got, K.bitplane_matmul_plain(d, _masks(b), w))
        if w == 8 and n % 4 == 0:
            lanes = torch.from_numpy(data.view(np.uint32))
            np.testing.assert_array_equal(
                K.fused_xor_plain(lanes, _masks(b)).numpy().view(np.uint8),
                got.numpy())
    # the zeroed row is the top bit of the last output element
    top = K.gf2_product_plain(d, _masks(zero), w).to(torch.int64)[-1]
    assert not bool(((top >> (w - 1)) & 1).any())


@pytest.mark.parametrize("w,k,m,n", [(8, 8, 3, 1000), (16, 4, 2, 513),
                                     (32, 8, 4, 300), (8, 32, 2, 64)])
def test_product_steps_match_reference_pallas(w, k, m, n):
    """The product's steps == the reference's Pallas tile kernel
    (interpreted) for w = 8, 16, 32, k*w up to 256."""
    mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, w)
    rng = np.random.default_rng(60 + w + k)
    data = _words(rng, (k, n), w)
    data[:, 3:40] = 0
    ref = np.asarray(ref_kernels.DeviceEncoder(
        mat, w, use_pallas=True, tile=256)(jnp.asarray(data)))
    bm = matrices.matrix_to_bitmatrix(k, m, w, mat)
    got = K.gf2_product_plain(torch.from_numpy(data), _masks(bm), w)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("k,m,n", [(8, 3, 4100), (1, 1, 16), (12, 2, 64)])
def test_product_steps_match_reference_fused_encoder(k, m, n):
    """At w=8 on byte-layout chunks the steps == the reference's fused
    byte-layout Pallas kernel (interpreted), encode and decode rows."""
    mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, 8)
    rng = np.random.default_rng(70 + k)
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    ref_enc = ref_kernels.FusedEncoder(mat, tile_bytes=4096)
    bm = matrices.matrix_to_bitmatrix(k, m, 8, mat)
    got = K.gf2_product_plain(torch.from_numpy(data), _masks(bm), 8)
    np.testing.assert_array_equal(got.numpy(), ref_enc(data))
    erased = (0, k) if m > 1 else (0,)
    surv = tuple(i for i in range(k + m) if i not in erased)
    parity = got.numpy()
    src = np.stack([data[i] if i < k else parity[i - k] for i in surv[:k]])
    rows = K._reconstruction_rows(mat, k, 8, erased, surv)
    dec = matrices.matrix_to_bitmatrix(k, len(rows), 8, rows)
    rec = K.gf2_product_plain(torch.from_numpy(src), _masks(dec), 8)
    np.testing.assert_array_equal(
        rec.numpy(), ref_enc.decoder_for(erased, surv)(src))
    np.testing.assert_array_equal(rec.numpy()[0], data[0])
