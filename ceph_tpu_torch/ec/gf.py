"""Galois-field GF(2^w) arithmetic for erasure coding, w in {8, 16, 32}.

Semantics follow the jerasure/gf-complete conventions the reference links
against (src/erasure-code/jerasure/ErasureCodeJerasure.cc:22-28 pulls in
galois.h): the classic jerasure primitive polynomials

    w=8  : x^8 + x^4 + x^3 + x^2 + 1          (0x11d)
    w=16 : x^16 + x^12 + x^3 + x + 1          (0x1100b)
    w=32 : x^32 + x^22 + x^2 + x + 1          (0x400007)

ISA-L's GF(2^8) (src/erasure-code/isa/ErasureCodeIsa.cc) uses the same
0x11d field, so one table set serves both plugin families.

Host-side bulk region math is vectorized with numpy (the reference uses
SIMD in gf-complete/isa-l).  This is the codec's host semantics and the
oracle the CUDA kernels in ceph_tpu_torch/ec/kernels.py are held to.
"""

from __future__ import annotations

import functools

import numpy as np

PRIM_POLY = {
    2: 0x7, 3: 0xB, 4: 0x13, 5: 0x25, 6: 0x43, 7: 0x89,
    8: 0x11D, 9: 0x211, 10: 0x409, 11: 0x805, 12: 0x1053,
    13: 0x201B, 14: 0x4443, 15: 0x8003, 16: 0x1100B, 32: 0x400007,
}


# ---------------------------------------------------------------------------
# scalar arithmetic (python ints — exact for any w)
# ---------------------------------------------------------------------------

def mul_slow(a: int, b: int, w: int) -> int:
    """Carry-less multiply then reduce by the primitive polynomial."""
    if w not in PRIM_POLY:
        raise ValueError("unsupported GF word size w=%d" % w)
    prod = 0
    while b:
        if b & 1:
            prod ^= a
        b >>= 1
        a <<= 1
    poly = PRIM_POLY[w] | (1 << w)  # ensure the x^w term is present
    top = 1 << (2 * w - 1)
    for shift in range(w - 1, -1, -1):
        if prod & (top >> (w - 1 - shift)):
            prod ^= poly << shift
    return prod


@functools.lru_cache(maxsize=4)
def _tables(w: int) -> tuple[np.ndarray, np.ndarray]:
    """(log, exp) tables. exp has 2*(2^w-1) entries so log[a]+log[b] indexes
    directly without a modulo."""
    n = (1 << w) - 1
    exp = np.zeros(2 * n, dtype=np.uint32)
    log = np.zeros(n + 1, dtype=np.uint32)
    x = 1
    for i in range(n):
        exp[i] = x
        log[x] = i
        x = mul_slow(x, 2, w)
    exp[n:] = exp[:n]
    return log, exp


def gf_mul(a: int, b: int, w: int) -> int:
    if a == 0 or b == 0:
        return 0
    if w == 32:
        return mul_slow(a, b, w)
    log, exp = _tables(w)
    return int(exp[int(log[a]) + int(log[b])])


def gf_inv(a: int, w: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF inverse of 0")
    if w == 32:
        # a^(2^32-2) by square-and-multiply
        result, base, e = 1, a, (1 << 32) - 2
        while e:
            if e & 1:
                result = mul_slow(result, base, w)
            base = mul_slow(base, base, w)
            e >>= 1
        return result
    log, exp = _tables(w)
    n = (1 << w) - 1
    return int(exp[(n - int(log[a])) % n])


def gf_div(a: int, b: int, w: int) -> int:
    if a == 0:
        return 0
    return gf_mul(a, gf_inv(b, w), w)


def gf_pow(a: int, e: int, w: int) -> int:
    result = 1
    base = a
    while e:
        if e & 1:
            result = gf_mul(result, base, w)
        base = gf_mul(base, base, w)
        e >>= 1
    return result


# ---------------------------------------------------------------------------
# GF(2^8) dense tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def mul_table_u8() -> np.ndarray:
    """Full 256x256 GF(2^8) product table (64 KiB)."""
    log, exp = _tables(8)
    a = np.arange(256, dtype=np.uint32)
    la = log[a][:, None].astype(np.int64)
    lb = log[a][None, :].astype(np.int64)
    t = exp[la + lb].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


@functools.lru_cache(maxsize=1)
def nibble_tables_u8() -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi): lo[c, x] = c*x for x<16; hi[c, x] = c*(x<<4).

    ISA-L's own trick (gf_vect_mul_init): a byte product c*b splits into
    c*(b&0xf) ^ c*(b>>4 << 4) — two 16-entry lookups per coefficient.
    Shapes: (256, 16) each.
    """
    t = mul_table_u8()
    lo = t[:, :16].copy()
    hi = t[:, [x << 4 for x in range(16)]].copy()
    return lo, hi


# ---------------------------------------------------------------------------
# vectorized region ops (numpy host path)
# ---------------------------------------------------------------------------

def region_mul_u8(region: np.ndarray, c: int) -> np.ndarray:
    """Multiply every byte of `region` by constant c in GF(2^8)."""
    if c == 0:
        return np.zeros_like(region)
    if c == 1:
        return region.copy()
    return mul_table_u8()[c][region]


def region_mad_u8(dst: np.ndarray, region: np.ndarray, c: int) -> None:
    """dst ^= c * region (in place), GF(2^8)."""
    if c == 0:
        return
    if c == 1:
        np.bitwise_xor(dst, region, out=dst)
    else:
        np.bitwise_xor(dst, mul_table_u8()[c][region], out=dst)


def matmul_u8(matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix-vector product over byte regions.

    matrix: (m, k) uint8 coefficients; data: (k, n) uint8 regions.
    Returns (m, n) uint8: out[i] = xor_j matrix[i, j] * data[j].
    """
    m, k = matrix.shape
    n = data.shape[1]
    out = np.zeros((m, n), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            region_mad_u8(out[i], data[j], int(matrix[i, j]))
    return out


def _words_mul_w(words: np.ndarray, c: int, w: int) -> np.ndarray:
    """Multiply an array of w-bit words by constant c (w=16 via tables,
    w=32 via shift-and-add with vectorized reduction)."""
    if c == 0:
        return np.zeros_like(words)
    if c == 1:
        return words.copy()
    if w == 16:
        log, exp = _tables(16)
        out = np.zeros_like(words)
        nz = words != 0
        idx = log[words[nz].astype(np.uint32)].astype(np.int64) + int(log[c])
        out[nz] = exp[idx].astype(words.dtype)
        return out
    # w == 32: Russian-peasant over the constant's bits, vectorized on words
    acc = np.zeros(words.shape, dtype=np.uint64)
    cur = words.astype(np.uint64)
    poly = np.uint64(PRIM_POLY[32] & 0xFFFFFFFF)
    top = np.uint64(1 << 31)
    mask = np.uint64(0xFFFFFFFF)
    cc = c
    while cc:
        if cc & 1:
            acc ^= cur
        cc >>= 1
        carry = (cur & top) != 0
        cur = (cur << np.uint64(1)) & mask
        cur[carry] ^= poly
    return acc.astype(words.dtype)


def region_mad_words(dst: np.ndarray, region: np.ndarray, c: int, w: int) -> None:
    """dst ^= c * region for w-bit word arrays (w in {16, 32})."""
    if c == 0:
        return
    np.bitwise_xor(dst, _words_mul_w(region, c, w), out=dst)


def matmul_words(matrix: np.ndarray, data: np.ndarray, w: int) -> np.ndarray:
    """GF(2^w) region matmul for w=16/32 word-views of chunks."""
    if w == 8:
        return matmul_u8(matrix, data)
    m, k = matrix.shape
    out = np.zeros((m, data.shape[1]), dtype=data.dtype)
    for i in range(m):
        for j in range(k):
            region_mad_words(out[i], data[j], int(matrix[i, j]), w)
    return out


# ---------------------------------------------------------------------------
# GF matrix algebra (decode-side)
# ---------------------------------------------------------------------------

def matrix_invert(mat: list[list[int]], w: int) -> list[list[int]]:
    """Invert a square matrix over GF(2^w) by Gauss-Jordan elimination.

    Raises ValueError when singular (the caller treats that as -EIO, like
    the reference's gf_invert_matrix use at ErasureCodeIsa.cc:263).
    """
    n = len(mat)
    a = [row[:] for row in mat]
    inv = [[1 if i == j else 0 for j in range(n)] for i in range(n)]
    for col in range(n):
        pivot = next((r for r in range(col, n) if a[r][col] != 0), None)
        if pivot is None:
            raise ValueError("singular matrix over GF(2^%d)" % w)
        if pivot != col:
            a[col], a[pivot] = a[pivot], a[col]
            inv[col], inv[pivot] = inv[pivot], inv[col]
        p = a[col][col]
        if p != 1:
            pinv = gf_inv(p, w)
            a[col] = [gf_mul(x, pinv, w) for x in a[col]]
            inv[col] = [gf_mul(x, pinv, w) for x in inv[col]]
        for r in range(n):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [x ^ gf_mul(f, y, w) for x, y in zip(a[r], a[col])]
                inv[r] = [x ^ gf_mul(f, y, w) for x, y in zip(inv[r], inv[col])]
    return inv


def matrix_mul(a: list[list[int]], b: list[list[int]], w: int) -> list[list[int]]:
    rows, inner, cols = len(a), len(b), len(b[0])
    out = [[0] * cols for _ in range(rows)]
    for i in range(rows):
        for j in range(cols):
            acc = 0
            for t in range(inner):
                acc ^= gf_mul(a[i][t], b[t][j], w)
            out[i][j] = acc
    return out
