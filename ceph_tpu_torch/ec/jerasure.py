"""jerasure-family codecs: the Reed-Solomon matrix techniques and the
bitmatrix techniques.

Behavioral re-derivation of src/erasure-code/jerasure/
ErasureCodeJerasure.{h,cc}: technique subclasses with the same
profiles, defaults, chunk-size/alignment math (:80-103,:174-184,
:278-292) and coding matrices (via ceph_tpu_torch.ec.matrices).  The
reed_sol techniques' encode is a GF(2^w) region matmul over w-bit
words (K1/K2 through the batcher); cauchy_orig, cauchy_good,
liberation, blaum_roth and liber8tion XOR packets under an
(m*w x k*w) bitmatrix (K3's row view through the batcher's bitmatrix
family).  The sync encode_chunks / decode_chunks stay numpy: they are
the codecs' host semantics.

Word order: chunks are interpreted as native little-endian w-bit words,
matching the x86 layout the reference produces.
"""

from __future__ import annotations

import numpy as np

from . import gf, matrices
from .base import ErasureCode
from .batcher import BitmatrixFamily

LARGEST_VECTOR_WORDSIZE = 16  # bytes; SIMD width the reference aligns for


def _align_up(n: int, a: int) -> int:
    return n + (a - n % a) % a


class ErasureCodeJerasure(ErasureCode):
    """Common profile parsing for every jerasure technique."""

    technique = ""
    DEFAULT_K = 2
    DEFAULT_M = 1
    DEFAULT_W = 8

    def __init__(self):
        super().__init__()
        self.w = 8
        self.per_chunk_alignment = False

    def init(self, profile: dict) -> None:
        profile["technique"] = self.technique
        profile.setdefault("plugin", "jerasure")
        self.parse(profile)
        self.prepare()
        self._profile = profile

    def parse(self, profile: dict) -> None:
        self.k = self._to_int(profile, "k", self.DEFAULT_K)
        self.m = self._to_int(profile, "m", self.DEFAULT_M)
        self.w = self._to_int(profile, "w", self.DEFAULT_W)
        # opt-in gate for techniques whose parity layout is NOT
        # bit-identical to the reference (liber8tion search tables and
        # the legacy blaum_roth w=7 construction are unavailable here)
        self.allow_nonreference_layout = self._to_bool(
            profile, "jerasure-allow-nonreference-layout", "false")
        self._parse_mapping(profile)
        if self.chunk_mapping and len(self.chunk_mapping) != self.k + self.m:
            raise ValueError("mapping %r maps %d chunks, expected %d" % (
                profile.get("mapping"), len(self.chunk_mapping), self.k + self.m))
        self.sanity_check_k_m()

    def prepare(self) -> None:
        raise NotImplementedError

    def get_alignment(self) -> int:
        raise NotImplementedError

    def get_chunk_size(self, object_size: int) -> int:
        alignment = self.get_alignment()
        if self.per_chunk_alignment:
            chunk_size = -(-object_size // self.k)
            if chunk_size % alignment:
                chunk_size = _align_up(chunk_size, alignment)
            return chunk_size
        padded = _align_up(object_size, alignment)
        assert padded % self.k == 0
        return padded // self.k


class _MatrixTechnique(ErasureCodeJerasure):
    """Plain GF(2^w) matrix encode over w-bit words (reed_sol family)."""

    def __init__(self):
        super().__init__()
        self.matrix: list[list[int]] = []

    def _device_matrix(self):
        return self.matrix, self.w

    def get_alignment(self) -> int:
        if self.per_chunk_alignment:
            return self.w * LARGEST_VECTOR_WORDSIZE
        alignment = self.k * self.w * 4
        if (self.w * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * LARGEST_VECTOR_WORDSIZE
        return alignment

    def _word_view(self, chunk: bytes) -> np.ndarray:
        if self.w == 8:
            return np.frombuffer(chunk, dtype=np.uint8)
        if self.w == 16:
            return np.frombuffer(chunk, dtype="<u2")
        return np.frombuffer(chunk, dtype="<u4")

    def encode_chunks(self, chunks: dict[int, bytes]) -> dict[int, bytes]:
        data = np.stack([self._word_view(chunks[self.chunk_index(i)])
                         for i in range(self.k)])
        mat = np.array(self.matrix, dtype=np.uint32)
        parity = gf.matmul_words(mat, data, self.w)
        out = dict(chunks)
        for i in range(self.m):
            out[self.chunk_index(self.k + i)] = parity[i].tobytes()
        return out

    def decode_chunks(self, want_to_read, chunks) -> dict[int, bytes]:
        k, m, w = self.k, self.m, self.w
        chunks = self._to_logical(chunks)
        have = sorted(chunks)
        erased = [i for i in range(k + m) if i not in chunks]
        inv, chosen = matrices.decoding_matrix(k, w, self.matrix, erased, have)
        rows = np.stack([self._word_view(chunks[c]) for c in chosen])
        # recover all data words, then re-encode any erased parity
        data_mat = gf.matmul_words(np.array(inv, dtype=np.uint32), rows, w)
        out: dict[int, bytes] = {}
        for i in erased:
            if i < k:
                out[i] = data_mat[i].tobytes()
            else:
                coef = np.array([self.matrix[i - k]], dtype=np.uint32)
                out[i] = gf.matmul_words(coef, data_mat, w)[0].tobytes()
        return self._from_logical(out)


class ReedSolomonVandermonde(_MatrixTechnique):
    technique = "reed_sol_van"
    DEFAULT_K, DEFAULT_M, DEFAULT_W = 7, 3, 8

    def parse(self, profile: dict) -> None:
        super().parse(profile)
        if self.w not in (8, 16, 32):
            raise ValueError("reed_sol_van: w=%d must be 8, 16 or 32" % self.w)
        self.per_chunk_alignment = self._to_bool(
            profile, "jerasure-per-chunk-alignment", "false")

    def prepare(self) -> None:
        self.matrix = matrices.reed_sol_vandermonde_coding_matrix(
            self.k, self.m, self.w)


class ReedSolomonRAID6(_MatrixTechnique):
    technique = "reed_sol_r6_op"
    DEFAULT_K, DEFAULT_M, DEFAULT_W = 7, 2, 8

    def parse(self, profile: dict) -> None:
        super().parse(profile)
        if self.m != 2:
            raise ValueError("reed_sol_r6_op: m=%d must be 2" % self.m)
        if self.w not in (8, 16, 32):
            raise ValueError("reed_sol_r6_op: w=%d must be 8, 16 or 32" % self.w)

    def prepare(self) -> None:
        self.matrix = matrices.reed_sol_r6_coding_matrix(self.k, self.w)


class _BitmatrixTechnique(ErasureCodeJerasure):
    """Bit-sliced XOR encode driven by a (m*w) x (k*w) bitmatrix.

    Chunk layout (jerasure schedule encode): a chunk is a sequence of
    windows of w packets x packetsize bytes; bit-row l of a chunk within
    a window is packet l. Coding packet (i,l) = XOR of data packets
    (j,x) where bitmatrix[i*w+l][j*w+x] is set.

    The async entry points (ErasureCode's, through the hooks
    encode_chunks_async and _reconstruct_async) run the same product
    on the codec's device:
    the chunks' windows stage as (k, nw, w*packetsize), the card
    permutes them to (k*w, nw*packetsize) bit-rows, K3 XORs them, and
    the parity permutes back (kernels.BitmatrixEncoder); a decode is the
    same product with the reconstruction bitmatrix of its erasure
    signature (kernels.bitmatrix_reconstruction), cached per signature.
    """

    DEFAULT_PACKETSIZE = 2048

    def __init__(self):
        super().__init__()
        self.packetsize = self.DEFAULT_PACKETSIZE
        self.bitmatrix: list[list[int]] = []
        self.matrix: list[list[int]] | None = None  # GF form when known
        self._recon: dict[tuple, tuple] = {}   # erasure signature -> rows
        self._bm_key: tuple | None = None      # the bitmatrix as a key

    supports_per_chunk_alignment = True  # cauchy only, like the reference

    def parse(self, profile: dict) -> None:
        super().parse(profile)
        self.packetsize = self._to_int(
            profile, "packetsize", self.DEFAULT_PACKETSIZE)
        if self.supports_per_chunk_alignment:
            self.per_chunk_alignment = self._to_bool(
                profile, "jerasure-per-chunk-alignment", "false")
        if (self.per_chunk_alignment
                and (self.w * self.packetsize) % LARGEST_VECTOR_WORDSIZE):
            # chunk sizes would not be whole w*packetsize windows; reject
            # at profile parse (the _packets guard stays as a backstop)
            raise ValueError(
                "%s: per-chunk alignment requires w*packetsize (%d) to be "
                "a multiple of %d; chunks would contain a partial window"
                % (self.technique, self.w * self.packetsize,
                   LARGEST_VECTOR_WORDSIZE))

    def get_alignment(self) -> int:
        if self.per_chunk_alignment:
            # ErasureCodeJerasureCauchy::get_alignment: w*packetsize
            # rounded UP to the SIMD width (not the lcm) — chunk sizes
            # must match the reference byte-for-byte.  When the result
            # is not a whole number of w*packetsize windows the encode
            # path rejects the profile loudly (the reference would feed
            # jerasure a partial window).
            return _align_up(self.w * self.packetsize,
                             LARGEST_VECTOR_WORDSIZE)
        alignment = self.k * self.w * self.packetsize * 4
        if (self.w * self.packetsize * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * self.packetsize * \
                LARGEST_VECTOR_WORDSIZE
        return alignment

    def _packets(self, chunk: bytes) -> np.ndarray:
        """(n_windows, w, packetsize) uint8 view."""
        window = self.w * self.packetsize
        if len(chunk) % window:
            raise ValueError(
                "%s: chunk of %d bytes is not a whole number of "
                "w*packetsize=%d windows (profile would feed the "
                "reference a partial window)"
                % (self.technique, len(chunk), window))
        a = np.frombuffer(chunk, dtype=np.uint8)
        return a.reshape(-1, self.w, self.packetsize)

    def _bm(self) -> np.ndarray:
        return np.array(self.bitmatrix, dtype=bool)

    def encode_chunks(self, chunks: dict[int, bytes]) -> dict[int, bytes]:
        k, m, w = self.k, self.m, self.w
        data = np.stack([self._packets(chunks[self.chunk_index(i)])
                         for i in range(k)])  # (k, nw, w, ps)
        nw, ps = data.shape[1], data.shape[3]
        flat = data.transpose(0, 2, 1, 3).reshape(k * w, nw * ps)
        bm = self._bm()
        out = dict(chunks)
        for i in range(m):
            cpk = np.zeros((w, nw * ps), dtype=np.uint8)
            for l in range(w):
                sel = flat[bm[i * w + l]]
                if len(sel):
                    cpk[l] = np.bitwise_xor.reduce(sel, axis=0)
            chunk = cpk.reshape(w, nw, ps).transpose(1, 0, 2)
            out[self.chunk_index(k + i)] = np.ascontiguousarray(chunk).tobytes()
        return out

    def decode_chunks(self, want_to_read, chunks) -> dict[int, bytes]:
        """Invert the bit-level generator restricted to surviving chunks."""
        k, m, w = self.k, self.m, self.w
        chunks = self._to_logical(chunks)
        erased = [i for i in range(k + m) if i not in chunks]
        have = sorted(chunks)[:k]
        rows = matrices.survivor_bitrows(k, w, self.bitmatrix, have)
        inv = matrices.gf2_invert(rows)
        data_flat = np.stack([self._packets(chunks[c]) for c in have])
        nw, ps = data_flat.shape[1], data_flat.shape[3]
        flat = data_flat.transpose(0, 2, 1, 3).reshape(k * w, nw * ps)
        inv_b = np.array(inv, dtype=bool)
        rec = np.zeros((k * w, nw * ps), dtype=np.uint8)
        for r in range(k * w):
            sel = flat[inv_b[r]]
            if len(sel):
                rec[r] = np.bitwise_xor.reduce(sel, axis=0)
        out: dict[int, bytes] = {}
        for i in erased:
            if i < k:
                chunk = rec[i * w:(i + 1) * w].reshape(w, nw, ps)
                out[i] = np.ascontiguousarray(
                    chunk.transpose(1, 0, 2)).tobytes()
        if any(i >= k for i in erased):
            bm = self._bm()
            for i in erased:
                if i >= k:
                    cpk = np.zeros((w, nw * ps), dtype=np.uint8)
                    for l in range(w):
                        sel = rec[bm[(i - k) * w + l]]
                        if len(sel):
                            cpk[l] = np.bitwise_xor.reduce(sel, axis=0)
                    out[i] = np.ascontiguousarray(
                        cpk.reshape(w, nw, ps).transpose(1, 0, 2)).tobytes()
        return self._from_logical(out)

    # -- device dispatch (the card path) ------------------------------

    def _family(self) -> BitmatrixFamily:
        return BitmatrixFamily(self.w, self.packetsize)

    def _bitmatrix_key(self) -> tuple:
        if self._bm_key is None:
            self._bm_key = tuple(tuple(int(v) for v in r)
                                 for r in self.bitmatrix)
        return self._bm_key

    def device_families(self) -> list[tuple]:
        """The bitmatrix family: (bitmatrix, BitmatrixFamily(w,
        packetsize))."""
        return [(self._bitmatrix_key(), self._family())]

    def parity_delta(self, deltas):
        raise ValueError("codec has no plain matrix form for parity deltas")

    async def delta_async(self, deltas, klass: str | None = None,
                          on_ticket=None, chip: int | None = None,
                          tenant: str | None = None):
        raise ValueError("codec has no plain matrix form for parity deltas")

    async def _product(self, bitmatrix: tuple, bufs: list, klass,
                       on_ticket, chip, tenant) -> np.ndarray:
        """One batched bitmatrix product on the codec's device: the
        chunks `bufs` as (k, nw, w*packetsize) windows -> (rows/w, nw,
        w*packetsize).  Raises IOError when the dispatch failed."""
        from ..device.runtime import K_CLIENT_EC
        from .batcher import DeviceBatcher
        window = self.w * self.packetsize
        arr = np.stack([self._packets(b).reshape(-1, window) for b in bufs])
        return await DeviceBatcher.get().encode(
            bitmatrix, self._family(), arr, klass=klass or K_CLIENT_EC,
            on_ticket=on_ticket, chip=chip, tenant=tenant,
            device=self.device)

    async def encode_chunks_async(self, chunks: dict[int, bytes],
                                  klass: str | None = None,
                                  on_ticket=None, chip: int | None = None,
                                  tenant: str | None = None
                                  ) -> dict[int, bytes]:
        """`encode_chunks` on the codec's device (the hook under
        ErasureCode.encode_async)."""
        k = self.k
        parity = await self._product(
            self._bitmatrix_key(),
            [chunks[self.chunk_index(i)] for i in range(k)], klass,
            on_ticket, chip, tenant)
        out = dict(chunks)
        for i in range(self.m):
            out[self.chunk_index(k + i)] = parity[i].tobytes()
        return out

    def _reconstruction(self, erased: tuple, have: tuple) -> tuple:
        """The reconstruction bitmatrix of one erasure signature (the
        survivors `have` in order), built once."""
        from .kernels import bitmatrix_reconstruction
        key = (erased, have)
        rows = self._recon.get(key)
        if rows is None:
            rows = tuple(tuple(int(v) for v in r) for r in
                         bitmatrix_reconstruction(self.bitmatrix, self.k,
                                                  self.w, erased, have))
            self._recon[key] = rows
        return rows

    async def _reconstruct_async(self, erased: tuple, lchunks, klass,
                                 on_ticket, chip) -> dict[int, bytes]:
        """The logical chunks `erased` rebuilt from the first k logical
        survivors, as one bitmatrix product on the codec's device (the
        hook under ErasureCode.decode_async / decode_chunks_async)."""
        have = tuple(sorted(lchunks)[:self.k])
        out = await self._product(
            self._reconstruction(tuple(erased), have),
            [lchunks[c] for c in have], klass, on_ticket, chip, None)
        return {e: out[j].tobytes() for j, e in enumerate(erased)}


class CauchyOrig(_BitmatrixTechnique):
    technique = "cauchy_orig"
    DEFAULT_K, DEFAULT_M, DEFAULT_W = 7, 3, 8

    def prepare(self) -> None:
        self.matrix = matrices.cauchy_original_coding_matrix(
            self.k, self.m, self.w)
        self.bitmatrix = matrices.matrix_to_bitmatrix(
            self.k, self.m, self.w, self.matrix)


class CauchyGood(_BitmatrixTechnique):
    technique = "cauchy_good"
    DEFAULT_K, DEFAULT_M, DEFAULT_W = 7, 3, 8

    def prepare(self) -> None:
        self.matrix = matrices.cauchy_good_general_coding_matrix(
            self.k, self.m, self.w)
        self.bitmatrix = matrices.matrix_to_bitmatrix(
            self.k, self.m, self.w, self.matrix)


class Liberation(_BitmatrixTechnique):
    """RAID-6 liberation codes (Plank): w prime, k <= w, minimal-density
    bitmatrix = rotation blocks plus one extra bit per column."""

    technique = "liberation"
    DEFAULT_K, DEFAULT_M, DEFAULT_W = 2, 2, 7
    supports_per_chunk_alignment = False

    def parse(self, profile: dict) -> None:
        super().parse(profile)
        if self.m != 2:
            raise ValueError("%s: m must be 2" % self.technique)
        self.check_kw()
        if self.packetsize == 0:
            raise ValueError("%s: packetsize must be set" % self.technique)
        if self.packetsize % 4:
            raise ValueError("%s: packetsize %d must be a multiple of 4"
                             % (self.technique, self.packetsize))

    def check_kw(self) -> None:
        if self.k > self.w:
            raise ValueError("liberation: k=%d must be <= w=%d"
                             % (self.k, self.w))
        if self.w <= 2 or not _is_prime(self.w):
            raise ValueError("liberation: w=%d must be prime > 2" % self.w)

    def prepare(self) -> None:
        k, w = self.k, self.w
        bits = [[0] * (k * w) for _ in range(2 * w)]
        for j in range(k):
            for r in range(w):
                bits[r][j * w + r] = 1                    # P: identity blocks
                bits[w + r][j * w + (r + j) % w] = 1      # Q: rotation by j
        for j in range(1, k):
            y = (j * ((w - 1) // 2)) % w                  # the extra "jay" bit
            bits[w + y][j * w + (y + j - 1) % w] ^= 1
        self.bitmatrix = bits


def _is_prime(v: int) -> bool:
    if v < 2:
        return False
    f = 2
    while f * f <= v:
        if v % f == 0:
            return False
        f += 1
    return True


class BlaumRoth(Liberation):
    """RAID-6 over the ring GF(2)[x]/M_p(x), p = w+1 prime: Q block for
    column j is the multiply-by-x^j matrix in the ring."""

    technique = "blaum_roth"

    def check_kw(self) -> None:
        if self.k > self.w:
            raise ValueError("blaum_roth: k=%d must be <= w=%d"
                             % (self.k, self.w))
        # w=7 tolerated for backward compatibility with old default
        if self.w != 7 and (self.w <= 2 or not _is_prime(self.w + 1)):
            raise ValueError("blaum_roth: w+1=%d must be prime" % (self.w + 1))
        if self.w == 7 and not self.allow_nonreference_layout:
            raise ValueError(
                "blaum_roth w=7: the legacy reference construction is not "
                "implemented bit-identically; chunks written by a "
                "reference cluster would decode WRONG.  Set "
                "jerasure-allow-nonreference-layout=true to accept a "
                "self-consistent (but non-interoperable) layout, or use "
                "a w with w+1 prime.")

    def prepare(self) -> None:
        k, w = self.k, self.w
        if w == 7:
            # w+1=8 is not prime, so the ring construction is not MDS; the
            # reference tolerates 7 for legacy pools. Serve it with a
            # GF(2^7) RAID6 generator bitmatrix (decodable; documented
            # divergence from the legacy layout).
            mat = matrices.reed_sol_r6_coding_matrix(k, 7)
            self.matrix = mat
            self.bitmatrix = matrices.matrix_to_bitmatrix(k, 2, 7, mat)
            return
        p = w + 1

        def mulx_pow(vec: list[int], times: int) -> list[int]:
            # multiply polynomial (deg < w) by x^times mod M_p(x) where
            # M_p(x) = 1 + x + ... + x^(p-1); representation deg < w
            v = list(vec)
            for _ in range(times):
                carry = v[w - 1]
                v = [0] + v[:-1]
                if carry:  # x^w = sum_{i<w} x^i  (since M_p(x) = 0)
                    v = [b ^ 1 for b in v]
            return v

        bits = [[0] * (k * w) for _ in range(2 * w)]
        for j in range(k):
            for r in range(w):
                bits[r][j * w + r] = 1
                basis = [1 if t == r else 0 for t in range(w)]
                col = mulx_pow(basis, j)
                for l in range(w):
                    if col[l]:
                        bits[w + l][j * w + r] = 1
        self.bitmatrix = bits


class Liber8tion(Liberation):
    """m=2, w=8 search-derived minimal-density code.  The reference uses
    matrices found by exhaustive search (liber8tion.c tables); this build
    uses the RAID6 generator expanded to a bitmatrix — same profile and
    layout, not bit-identical parity (documented divergence)."""

    technique = "liber8tion"
    DEFAULT_K, DEFAULT_M, DEFAULT_W = 2, 2, 8

    def check_kw(self) -> None:
        if self.w != 8:
            raise ValueError("liber8tion: w must be 8")
        if self.k > self.w:
            raise ValueError("liber8tion: k=%d must be <= 8" % self.k)
        if not self.allow_nonreference_layout:
            raise ValueError(
                "liber8tion: the reference's search-derived liber8tion.c "
                "bitmatrices are not available; parity would not be "
                "bit-identical and chunks written by a reference cluster "
                "would decode WRONG.  Set "
                "jerasure-allow-nonreference-layout=true to accept a "
                "self-consistent (but non-interoperable) layout.")

    def prepare(self) -> None:
        mat = matrices.reed_sol_r6_coding_matrix(self.k, 8)
        self.matrix = mat
        self.bitmatrix = matrices.matrix_to_bitmatrix(self.k, 2, 8, mat)


TECHNIQUES = {
    cls.technique: cls for cls in (
        ReedSolomonVandermonde, ReedSolomonRAID6, CauchyOrig, CauchyGood,
        Liberation, BlaumRoth, Liber8tion)
}


def make_codec(profile: dict):
    technique = profile.get("technique", "reed_sol_van")
    cls = TECHNIQUES.get(technique)
    if cls is None:
        raise ValueError("jerasure: unknown technique %r" % technique)
    codec = cls()
    codec.init(profile)
    return codec
