"""SHEC: shingled erasure code (k, m, c).

Re-derivation of src/erasure-code/shec/ErasureCodeShec.{h,cc}: a
Reed-Solomon Vandermonde coding matrix whose parity rows are "shingled"
— each parity covers only a sliding window of the data chunks (the
rest of the row is zeroed, shec_reedsolomon_coding_matrix,
ErasureCodeShec.cc:465-532) — trading storage efficiency for recovery
bandwidth: a lost chunk is rebuilt from the small window of chunks its
parities cover.  c is the target durability (erasures any layout must
survive); the MULTIPLE technique splits the m parities into two
shingle trains (m1/c1, m2/c2) chosen by the recovery-efficiency search
(shec_calc_recovery_efficiency1, :424-463).

Decoding searches the 2^m parity subsets for the smallest invertible
recovery system (shec_make_decoding_matrix, :535-697) — that search
also powers minimum_to_decode, which is SHEC's selling point.

Counterpart of ceph_tpu/ec/shec.py.  encode_async and delta_async ride
the base class's device path on the shingled matrix; decode_async runs
its recovery inverse and its parity re-encode through `_device_matmul`
on the codec's device.  A failed dispatch fails the op.
"""

from __future__ import annotations

from itertools import combinations
from typing import Mapping

import numpy as np

from . import gf, matrices
from .base import ErasureCode
from .interface import ErasureCodeProfile

DEFAULT_K, DEFAULT_M, DEFAULT_C, DEFAULT_W = 4, 3, 2, 8


def calc_recovery_efficiency1(k: int, m1: int, m2: int, c1: int,
                              c2: int) -> float:
    """Port of shec_calc_recovery_efficiency1 (ErasureCodeShec.cc:424)."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [100000000] * k
    r_e1 = 0.0
    for rr in range(m1):
        start = ((rr * k) // m1) % k
        end = (((rr + c1) * k) // m1) % k
        cc = start
        first = True
        while first or cc != end:
            first = False
            r_eff_k[cc] = min(r_eff_k[cc],
                              ((rr + c1) * k) // m1 - (rr * k) // m1)
            cc = (cc + 1) % k
        r_e1 += ((rr + c1) * k) // m1 - (rr * k) // m1
    for rr in range(m2):
        start = ((rr * k) // m2) % k
        end = (((rr + c2) * k) // m2) % k
        cc = start
        first = True
        while first or cc != end:
            first = False
            r_eff_k[cc] = min(r_eff_k[cc],
                              ((rr + c2) * k) // m2 - (rr * k) // m2)
            cc = (cc + 1) % k
        r_e1 += ((rr + c2) * k) // m2 - (rr * k) // m2
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


def shec_coding_matrix(k: int, m: int, c: int, w: int,
                       single: bool) -> list[list[int]]:
    """shec_reedsolomon_coding_matrix (ErasureCodeShec.cc:465): RS
    Vandermonde rows with circular shingle windows zeroed."""
    if not single:
        c1_best, m1_best = -1, -1
        min_r_e1 = 100.0
        for c1 in range(c // 2 + 1):
            for m1 in range(m + 1):
                c2, m2 = c - c1, m - m1
                if m1 < c1 or m2 < c2:
                    continue
                if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
                    continue
                if (m1 != 0 and c1 == 0) or (m2 != 0 and c2 == 0):
                    continue
                r_e1 = calc_recovery_efficiency1(k, m1, m2, c1, c2)
                if min_r_e1 - r_e1 > 1e-12 and r_e1 < min_r_e1:
                    min_r_e1 = r_e1
                    c1_best, m1_best = c1, m1
        m1, c1 = m1_best, c1_best
        m2, c2 = m - m1, c - c1
    else:
        m1, c1 = 0, 0
        m2, c2 = m, c

    matrix = [row[:] for row in
              matrices.reed_sol_vandermonde_coding_matrix(k, m, w)]
    for rr in range(m1):
        end = ((rr * k) // m1) % k
        cc = (((rr + c1) * k) // m1) % k
        while cc != end:
            matrix[rr][cc] = 0
            cc = (cc + 1) % k
    for rr in range(m2):
        end = ((rr * k) // m2) % k
        cc = (((rr + c2) * k) // m2) % k
        while cc != end:
            matrix[rr + m1][cc] = 0
            cc = (cc + 1) % k
    return matrix


class ErasureCodeShec(ErasureCode):
    """Multiple-shingle SHEC (the reference's default technique)."""

    TECHNIQUE_SINGLE = False

    def __init__(self):
        super().__init__()
        self.c = 0
        self.w = DEFAULT_W
        self.matrix: list[list[int]] = []
        # (want, avail) -> decoding plan: the 2^m subset search with a
        # GF inversion per candidate is hot on degraded pools; the
        # reference caches it too (ErasureCodeShecTableCache)
        self._decoding_cache: dict[tuple, tuple] = {}

    def init(self, profile: ErasureCodeProfile) -> None:
        k = self._to_int(profile, "k", DEFAULT_K)
        m = self._to_int(profile, "m", DEFAULT_M)
        c = self._to_int(profile, "c", DEFAULT_C)
        w = self._to_int(profile, "w", DEFAULT_W)
        if w not in (8, 16, 32):
            raise ValueError("w=%d must be 8, 16 or 32" % w)
        if k <= 0 or m <= 0 or c <= 0:
            raise ValueError("k, m, c must be positive")
        if m < c:
            raise ValueError("m=%d must be >= c=%d" % (m, c))
        self.k, self.m, self.c, self.w = k, m, c, w
        self.matrix = shec_coding_matrix(k, m, c, w,
                                         self.TECHNIQUE_SINGLE)
        self._profile = dict(profile)

    # -- geometry ------------------------------------------------------------

    def get_chunk_size(self, object_size: int) -> int:
        alignment = self.k * self.w * 4
        padded = object_size + (-object_size) % alignment
        return padded // self.k

    # -- device dispatch (the card path) ----------------------------

    def _device_matrix(self):
        """SHEC's encode IS a plain GF(2^w) product -- the shingled
        matrix just carries zero coefficients outside each parity's
        window -- so encode and delta ride the base class's device path
        unchanged (zero coefficients contribute nothing under GF
        linearity, exactly like `delta_async`'s zero rows)."""
        return self.matrix, self.w

    def device_families(self) -> list[tuple]:
        """Encode family + the most common repair shape (first data
        chunk lost, everything else surviving): the decoding-matrix
        rows the first repair dispatches."""
        fams = [(self.matrix, self.w)]
        try:
            avail = set(range(1, self.k + self.m))
            rows, _cols, inv, _min = self._make_decoding({0}, avail)
        except IOError:
            return fams     # chunk 0 is not recoverable alone
        if rows:
            fams.append((inv, self.w))
        return fams

    # -- encode ----------------------------------------------------------

    def _word_view(self, buf: bytes) -> np.ndarray:
        # explicit little-endian so chunk bytes are identical across
        # host endianness (matches jerasure._MatrixTechnique._word_view)
        dt = {8: np.uint8, 16: np.dtype("<u2"),
              32: np.dtype("<u4")}[self.w]
        return np.frombuffer(buf, dtype=dt)

    def encode_chunks(self, chunks: dict[int, bytes]) -> dict[int, bytes]:
        k, m, w = self.k, self.m, self.w
        data = np.stack([self._word_view(chunks[i]) for i in range(k)])
        parity = gf.matmul_words(
            np.array(self.matrix, dtype=np.uint32), data, w)
        out = {i: bytes(chunks[i]) for i in range(k)}
        for i in range(m):
            out[k + i] = parity[i].tobytes()
        return out

    # -- recovery planning (shec_make_decoding_matrix) --------------------

    def _make_decoding(self, want: set[int], avail: set[int]):
        """Returns (dm_rows, dm_cols, inverse) for the smallest
        invertible recovery system, plus the minimum chunk set.
        Raises IOError when unrecoverable."""
        key = (frozenset(want), frozenset(avail))
        cached = self._decoding_cache.get(key)
        if cached is not None:
            return cached
        result = self._make_decoding_uncached(want, avail)
        if len(self._decoding_cache) > 256:
            self._decoding_cache.clear()
        self._decoding_cache[key] = result
        return result

    def _make_decoding_uncached(self, want: set[int], avail: set[int]):
        k, m = self.k, self.m
        want_vec = [1 if i in want else 0 for i in range(k + m)]
        # wanting an erased parity forces wanting its data window
        for i in range(m):
            if want_vec[k + i] and (k + i) not in avail:
                for j in range(k):
                    if self.matrix[i][j]:
                        want_vec[j] = 1
        mindup = k + 1
        minp = k + 1
        best = None
        for ek in range(m + 1):
            for p in combinations(range(m), ek):
                if ek > minp:
                    continue
                if any((k + pi) not in avail for pi in p):
                    continue
                tmprow = [0] * (k + m)
                tmpcol = [0] * k
                for i in range(k):
                    if want_vec[i] and i not in avail:
                        tmpcol[i] = 1
                for pi in p:
                    tmprow[k + pi] = 1
                    for j in range(k):
                        if self.matrix[pi][j]:
                            tmpcol[j] = 1
                            if j in avail:
                                tmprow[j] = 1
                dup_row = sum(tmprow)
                dup_col = sum(tmpcol)
                if dup_row != dup_col:
                    continue
                dup = dup_row
                if dup == 0:
                    return [], [], [], self._minimum_set(
                        [], want_vec, avail)
                if dup >= mindup:
                    continue
                rows = [i for i in range(k + m) if tmprow[i]]
                cols = [j for j in range(k) if tmpcol[j]]
                tmpmat = [[(1 if r == c else 0) if r < k
                           else self.matrix[r - k][c] for c in cols]
                          for r in rows]
                try:
                    inv = gf.matrix_invert(tmpmat, self.w)
                except (ValueError, ZeroDivisionError):
                    continue  # singular: try another parity subset
                mindup = dup
                minp = ek
                best = (rows, cols, inv)
        if best is None:
            raise IOError("shec: can't find recover matrix for want=%s "
                          "avail=%s" % (sorted(want), sorted(avail)))
        rows, cols, inv = best
        return rows, cols, inv, self._minimum_set(rows, want_vec, avail)

    def _minimum_set(self, rows, want_vec, avail) -> set[int]:
        k, m = self.k, self.m
        minimum = set(rows)
        for i in range(k):
            if want_vec[i] and i in avail:
                minimum.add(i)
        for i in range(m):
            if want_vec[k + i] and (k + i) in avail \
                    and (k + i) not in minimum:
                if any(self.matrix[i][j] and not want_vec[j]
                       for j in range(k)):
                    minimum.add(k + i)
        return minimum

    def _minimum_to_decode(self, want_to_read, available) -> set[int]:
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return want
        _, _, _, minimum = self._make_decoding(want, avail)
        return minimum

    # -- decode ------------------------------------------------------------

    def decode_chunks(self, want_to_read, chunks: Mapping[int, bytes]
                      ) -> dict[int, bytes]:
        k, m, w = self.k, self.m, self.w
        want = set(want_to_read)
        avail = set(chunks)
        rows, cols, inv, _ = self._make_decoding(want, avail)
        buffers = {i: self._word_view(chunks[i]) for i in chunks}
        out: dict[int, bytes] = {}
        recovered: dict[int, np.ndarray] = {}
        if rows:
            srcs = np.stack([buffers[r] for r in rows])
            rec = gf.matmul_words(
                np.array(inv, dtype=np.uint32), srcs, w)
            for i, c in enumerate(cols):
                if c not in avail:
                    recovered[c] = rec[i]
                    if c in want:
                        out[c] = rec[i].tobytes()
        # re-encode erased wanted parity from its shingle window only:
        # data chunks with a zero coefficient may themselves be erased
        # (and unneeded)
        for i in range(m):
            if (k + i) not in want or (k + i) in avail:
                continue
            cols = [j for j in range(k) if self.matrix[i][j]]
            data = np.stack([
                buffers[j] if j in buffers else recovered[j]
                for j in cols])
            mat = np.array([[self.matrix[i][j] for j in cols]],
                           dtype=np.uint32)
            out[k + i] = gf.matmul_words(mat, data, w)[0].tobytes()
        return out

    async def decode_async(self, want_to_read, chunks,
                           klass: str | None = None,
                           on_ticket=None,
                           chip: int | None = None) -> dict[int, bytes]:
        """`decode_chunks` with both products batched onto the codec's
        device (the recovery/degraded-read hot call): the
        smallest-invertible recovery system's inverse rides one
        dispatch, and erased wanted parities re-encode as selected rows
        of the full coding matrix -- zero-padded outside their shingle
        windows, exactly like `delta_async`'s zero rows -- in a second.
        The base class's decode_async demands k survivors (the MDS
        floor); SHEC repairs from a shingle window of fewer, so this
        override keeps the locality property on the card.  All-present
        reads and zero-length chunks take the sync path."""
        want = set(want_to_read)
        chunks = dict(chunks)
        if (want <= set(chunks)
                or any(len(c) == 0 for c in chunks.values())):
            return self.decode(want, chunks)
        lengths = {len(c) for c in chunks.values()}
        if len(lengths) != 1:
            raise ValueError(
                "surviving chunks have differing sizes %s" % lengths)
        k, m, w = self.k, self.m, self.w
        rows, cols, inv, _ = self._make_decoding(want, set(chunks))
        buffers = {i: self._word_view(chunks[i]) for i in chunks}
        out: dict[int, bytes] = {}
        recovered: dict[int, np.ndarray] = {}
        if rows:
            srcs = np.stack([buffers[r] for r in rows])
            rec = await self._device_matmul(
                inv, w, srcs, klass=klass, on_ticket=on_ticket,
                chip=chip)
            for i, c in enumerate(cols):
                if c not in chunks:
                    recovered[c] = np.ascontiguousarray(rec[i])
                    if c in want:
                        out[c] = recovered[c].tobytes()
        par_rows = [i for i in range(m)
                    if (k + i) in want and (k + i) not in chunks]
        if par_rows:
            n = next(iter(buffers.values())).shape[0]
            data = np.zeros((k, n), dtype=self._word_view(b"").dtype)
            for j in range(k):
                if any(self.matrix[i][j] for i in par_rows):
                    data[j] = (buffers[j] if j in buffers
                               else recovered[j])
            sel = [[self.matrix[i][j] for j in range(k)]
                   for i in par_rows]
            par = await self._device_matmul(
                sel, w, data, klass=klass, on_ticket=on_ticket,
                chip=chip)
            for x, i in enumerate(par_rows):
                out[k + i] = np.ascontiguousarray(par[x]).tobytes()
        for i in want:
            if i in chunks:
                out[i] = bytes(chunks[i])
        return out

    # a shingle window (possibly fewer than k chunks) can repair its
    # member — drop the base class's k-chunk floor
    REQUIRES_K_CHUNKS = False


class ErasureCodeShecSingle(ErasureCodeShec):
    TECHNIQUE_SINGLE = True
