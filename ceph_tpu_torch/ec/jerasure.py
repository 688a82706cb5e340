"""jerasure-family codecs: the Reed-Solomon matrix techniques.

Behavioral re-derivation of src/erasure-code/jerasure/
ErasureCodeJerasure.{h,cc}: technique subclasses with the same
profiles, defaults, chunk-size/alignment math (:80-103,:174-184,
:278-292) and coding matrices (via ceph_tpu_torch.ec.matrices).  The
encode itself is a GF(2^w) region matmul (numpy host path; the CUDA
kernels in ceph_tpu_torch.ec.kernels consume the same matrices).
The bitmatrix techniques (cauchy_orig, cauchy_good, liberation,
blaum_roth, liber8tion) are not part of this package yet.

Word order: chunks are interpreted as native little-endian w-bit words,
matching the x86 layout the reference produces.
"""

from __future__ import annotations

import numpy as np

from . import gf, matrices
from .base import ErasureCode

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


TECHNIQUES = {
    cls.technique: cls for cls in (ReedSolomonVandermonde, ReedSolomonRAID6)
}


def make_codec(profile: dict):
    technique = profile.get("technique", "reed_sol_van")
    cls = TECHNIQUES.get(technique)
    if cls is None:
        raise ValueError("jerasure: technique %r is not available in "
                         "ceph_tpu_torch" % technique)
    codec = cls()
    codec.init(profile)
    return codec
