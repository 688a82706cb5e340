"""Coding-matrix generators matching the jerasure / ISA-L families.

The reference plugins delegate matrix construction to vendored C libraries
(src/erasure-code/jerasure/ErasureCodeJerasure.cc:203 reed_sol_vandermonde_
coding_matrix, :255 reed_sol_r6_coding_matrix, :323/:333 cauchy matrices;
src/erasure-code/isa/ErasureCodeIsa.cc gf_gen_rs_matrix / gf_gen_cauchy1_
matrix).  These generators re-derive the published algorithms (Plank's
jerasure 2.0 reed_sol.c / cauchy.c; intel isa-l gf_gen_* in ec_base.c) so
that coding matrices — and therefore encoded bytes — agree with the
reference plugins for the same profile.

All matrices are python int row-lists; the kernels consume numpy/torch views.
"""

from __future__ import annotations

import functools

from .gf import gf_inv, gf_mul, matrix_invert

Matrix = list[list[int]]


# ---------------------------------------------------------------------------
# jerasure: reed_sol_van (reed_sol.c)
# ---------------------------------------------------------------------------

def extended_vandermonde_matrix(rows: int, cols: int, w: int) -> Matrix:
    """rows x cols extended Vandermonde: first row e_0, last row e_{cols-1},
    middle rows are geometric in the row index."""
    if w < 30 and ((1 << w) < rows or (1 << w) < cols):
        raise ValueError("field too small for %dx%d" % (rows, cols))
    vdm = [[0] * cols for _ in range(rows)]
    vdm[0][0] = 1
    if rows == 1:
        return vdm
    vdm[rows - 1][cols - 1] = 1
    for i in range(1, rows - 1):
        acc = 1
        for j in range(cols):
            vdm[i][j] = acc
            acc = gf_mul(acc, i, w)
    return vdm


def big_vandermonde_distribution_matrix(rows: int, cols: int, w: int) -> Matrix:
    """Column-eliminate the extended Vandermonde so the top cols x cols block
    is the identity, then normalise so row `cols` (the first coding row) is
    all ones. Elementary row/column scalings preserve the MDS property."""
    if cols >= rows:
        raise ValueError("rows must exceed cols")
    dist = extended_vandermonde_matrix(rows, cols, w)

    for i in range(1, cols):
        # pivot search downward in column i
        j = next((r for r in range(i, rows) if dist[r][i] != 0), None)
        if j is None:
            raise ValueError("could not build distribution matrix")
        if j != i:
            dist[i], dist[j] = dist[j], dist[i]
        # scale column i so the pivot is 1
        if dist[i][i] != 1:
            inv = gf_inv(dist[i][i], w)
            for r in range(rows):
                dist[r][i] = gf_mul(inv, dist[r][i], w)
        # zero the rest of row i via column operations
        for j in range(cols):
            t = dist[i][j]
            if j != i and t != 0:
                for r in range(rows):
                    dist[r][j] ^= gf_mul(t, dist[r][i], w)

    # make row `cols` all ones: scale each column by the inverse of its
    # row-`cols` entry, then rescale the identity row it disturbed
    for j in range(cols):
        t = dist[cols][j]
        if t == 0:
            raise ValueError("zero in first coding row")
        if t != 1:
            inv = gf_inv(t, w)
            for r in range(rows):
                dist[r][j] = gf_mul(inv, dist[r][j], w)
            t2 = dist[j][j]
            if t2 != 1:
                inv2 = gf_inv(t2, w)
                for c in range(cols):
                    dist[j][c] = gf_mul(inv2, dist[j][c], w)
    return dist


def reed_sol_vandermonde_coding_matrix(k: int, m: int, w: int) -> Matrix:
    """The m x k coding block of the systematic distribution matrix
    (jerasure reed_sol.c; row 0 is all ones)."""
    dist = big_vandermonde_distribution_matrix(k + m, k, w)
    return [row[:] for row in dist[k:]]


def reed_sol_r6_coding_matrix(k: int, w: int) -> Matrix:
    """RAID6: P row all ones, Q row powers of 2 (reed_sol.c)."""
    matrix = [[1] * k, [0] * k]
    acc = 1
    for j in range(k):
        matrix[1][j] = acc
        acc = gf_mul(acc, 2, w)
    return matrix


# ---------------------------------------------------------------------------
# jerasure: cauchy (cauchy.c)
# ---------------------------------------------------------------------------

def cauchy_original_coding_matrix(k: int, m: int, w: int) -> Matrix:
    """matrix[i][j] = 1 / (i XOR (m+j)) in GF(2^w)."""
    if w < 31 and (k + m) > (1 << w):
        raise ValueError("k+m too large for w")
    return [[gf_inv(i ^ (m + j), w) for j in range(k)] for i in range(m)]


@functools.lru_cache(maxsize=None)
def n_ones(val: int, w: int) -> int:
    """Number of ones in the w x w bitmatrix of `val`: sum over columns c of
    popcount(val * 2^c) (cauchy.c cauchy_n_ones)."""
    total = 0
    cur = val
    for _ in range(w):
        total += bin(cur).count("1")
        cur = gf_mul(cur, 2, w)
    return total


def cauchy_improve_coding_matrix(k: int, m: int, w: int, matrix: Matrix) -> None:
    """Normalise the first row to ones, then greedily divide each later row
    by whichever of its elements minimises the total bitmatrix ones."""
    for j in range(k):
        if matrix[0][j] != 1:
            inv = gf_inv(matrix[0][j], w)
            for i in range(m):
                matrix[i][j] = gf_mul(matrix[i][j], inv, w)
    for i in range(1, m):
        row = matrix[i]
        best_cost = sum(n_ones(x, w) for x in row)
        best_row = row[:]
        for j in range(k):
            if row[j] in (0, 1):
                continue
            inv = gf_inv(row[j], w)
            cand = [gf_mul(x, inv, w) for x in row]
            cost = sum(n_ones(x, w) for x in cand)
            if cost < best_cost:
                best_cost = cost
                best_row = cand
        matrix[i] = best_row
    return


@functools.lru_cache(maxsize=None)
def _cbest_values(w: int, count: int) -> tuple[int, ...]:
    """Elements of GF(2^w)\\{0} ordered by bitmatrix ones count (the
    precomputed cbest tables in cauchy_best_r6.c), ties by value."""
    vals = sorted(range(1, 1 << w), key=lambda v: (n_ones(v, w), v))
    return tuple(vals[:count])


def cauchy_good_general_coding_matrix(k: int, m: int, w: int) -> Matrix:
    """cauchy_good: special-cased RAID6 best-element row for m==2, else the
    original Cauchy matrix improved for XOR count."""
    if m == 2 and w <= 10 and k <= (1 << w) - 1:
        # jerasure serves this from precomputed cbest tables; computing the
        # ordering is only tractable for small w — larger w falls through
        # to the improved general matrix
        best = _cbest_values(w, k)
        return [[1] * k, list(best)]
    matrix = cauchy_original_coding_matrix(k, m, w)
    cauchy_improve_coding_matrix(k, m, w, matrix)
    return matrix


# ---------------------------------------------------------------------------
# jerasure: bit-matrix conversion (jerasure.c)
# ---------------------------------------------------------------------------

def matrix_to_bitmatrix(k: int, m: int, w: int, matrix: Matrix) -> list[list[int]]:
    """Expand each GF element into a w x w binary block: block column x is
    the bit-vector of elt * 2^x, bit l landing in block row l."""
    bits = [[0] * (k * w) for _ in range(m * w)]
    for i in range(m):
        for j in range(k):
            elt = matrix[i][j]
            for x in range(w):
                for l in range(w):
                    bits[i * w + l][j * w + x] = (elt >> l) & 1
                elt = gf_mul(elt, 2, w)
    return bits


def gf2_invert(rows: list[list[int]]) -> list[list[int]]:
    """Invert a square 0/1 matrix over GF(2).  Each row of [A | I] is
    one Python integer (bit j = column j), so a row operation is one
    integer XOR: at n = 320 (cauchy k=10, w=32) an inversion takes tens
    of milliseconds."""
    n = len(rows)
    a = [sum(1 << j for j, v in enumerate(r) if v) | (1 << (n + i))
         for i, r in enumerate(rows)]
    for col in range(n):
        bit = 1 << col
        piv = next((r for r in range(col, n) if a[r] & bit), None)
        if piv is None:
            raise ValueError("singular GF(2) matrix")
        if piv != col:
            a[col], a[piv] = a[piv], a[col]
        p = a[col]
        for r in range(n):
            if r != col and a[r] & bit:
                a[r] ^= p
    return [[(v >> (n + j)) & 1 for j in range(n)] for v in a]


def survivor_bitrows(k: int, w: int, bitmatrix, survivors) -> list[list[int]]:
    """Bit-level rows of the generator [I; B] for the first k surviving
    chunks — the system a bitmatrix decode inverts."""
    rows = []
    for cid in survivors[:k]:
        for l in range(w):
            if cid < k:
                row = [0] * (k * w)
                row[cid * w + l] = 1
            else:
                row = [int(v) for v in bitmatrix[(cid - k) * w + l]]
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# ISA-L: ec_base.c generators
# ---------------------------------------------------------------------------

def isa_rs_vandermonde_matrix(k: int, m: int) -> Matrix:
    """gf_gen_rs_matrix coding block: row i (i>=0) is powers of 2^i —
    a[k+i][j] = (2^i)^j in GF(2^8). NOT always MDS for large m; the
    reference plugin restricts it (ErasureCodeIsa.cc applies it for the
    default profile and validates invertibility at decode time)."""
    rows = []
    gen = 1
    for _ in range(m):
        p = 1
        row = []
        for _ in range(k):
            row.append(p)
            p = gf_mul(p, gen, 8)
        gen = gf_mul(gen, 2, 8)
        rows.append(row)
    return rows


def isa_cauchy_matrix(k: int, m: int) -> Matrix:
    """gf_gen_cauchy1_matrix coding block: a[k+i][j] = 1/(i XOR j) for
    i in [k, k+m), j in [0, k)."""
    if k + m > 256:
        raise ValueError("k+m=%d exceeds GF(2^8) capacity" % (k + m))
    return [[gf_inv(i ^ j, 8) for j in range(k)] for i in range(k, k + m)]


# ---------------------------------------------------------------------------
# decode-side matrix assembly (shared by plugins)
# ---------------------------------------------------------------------------

def decoding_matrix(
    k: int, w: int, coding: Matrix, erased: list[int], surviving: list[int],
) -> tuple[Matrix, list[int]]:
    """Build the k x k matrix mapping k surviving chunks to the k data
    chunks: take rows of [I; C] for the first k surviving chunk ids,
    invert. Returns (inverse, chosen_ids). Mirrors the jerasure
    jerasure_make_decoding_matrix / isa-l invert flow
    (ErasureCodeIsa.cc:253-307)."""
    lost = set(erased)
    if lost & set(surviving):
        raise ValueError("erased chunks listed as surviving")
    chosen = surviving[:k]
    if len(chosen) < k:
        raise ValueError("not enough surviving chunks")
    rows = []
    for cid in chosen:
        if cid < k:
            rows.append([1 if j == cid else 0 for j in range(k)])
        else:
            rows.append(list(coding[cid - k]))
    return matrix_invert(rows, w), chosen
