"""Shared erasure-code behavior: padding, chunk mapping, read planning.

Re-derivation of the reference base class (src/erasure-code/
ErasureCode.cc): encode_prepare zero-pads the object tail so every data
chunk is exactly get_chunk_size(len) bytes (:150-185), encode trims to
want_to_encode (:187-203), _decode passes surviving chunks through and
fills the rest via decode_chunks (:205-241), minimum_to_decode returns
want_to_read when fully available else the first k available (:102-119),
and the "mapping" profile string (D=data) permutes chunk positions
(:260-279).
"""

from __future__ import annotations

from typing import Mapping, Sequence

from .interface import ErasureCodeInterface, ErasureCodeProfile


class ErasureCode(ErasureCodeInterface):
    """Base class: subclasses set self.k / self.m in init() and implement
    encode_chunks / decode_chunks and get_chunk_size."""

    def __init__(self):
        self.k = 0
        self.m = 0
        self.chunk_mapping: list[int] = []
        self._profile: ErasureCodeProfile = {}
        # device of the async entry points (None: the card); set by
        # new_codec(profile, device=...)
        self.device = None

    # -- profile helpers ---------------------------------------------------

    @staticmethod
    def _to_int(profile: dict, name: str, default: int) -> int:
        v = profile.get(name)
        if v is None or v == "":
            profile[name] = str(default)
            return default
        try:
            return int(v)
        except (TypeError, ValueError):
            raise ValueError("profile %s=%r is not an integer" % (name, v))

    @staticmethod
    def _to_bool(profile: dict, name: str, default: str) -> bool:
        v = profile.get(name)
        if v is None or v == "":
            profile[name] = default
            v = default
        return str(v) in ("yes", "true", "True", "1")

    def _parse_mapping(self, profile: dict) -> None:
        mapping = profile.get("mapping")
        if not mapping:
            return
        data_pos = [i for i, c in enumerate(mapping) if c == "D"]
        coding_pos = [i for i, c in enumerate(mapping) if c != "D"]
        self.chunk_mapping = data_pos + coding_pos

    def sanity_check_k_m(self) -> None:
        if self.k < 2:
            raise ValueError("k=%d must be >= 2" % self.k)
        if self.m < 1:
            raise ValueError("m=%d must be >= 1" % self.m)

    # -- interface basics --------------------------------------------------

    def get_profile(self) -> ErasureCodeProfile:
        return self._profile

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_chunk_mapping(self) -> Sequence[int]:
        return self.chunk_mapping

    def chunk_index(self, i: int) -> int:
        return self.chunk_mapping[i] if i < len(self.chunk_mapping) else i

    def _to_logical(self, chunks: Mapping[int, bytes]) -> dict[int, bytes]:
        """Translate physical chunk ids back to generator-row (logical)
        ids so codec math is mapping-transparent."""
        if not self.chunk_mapping:
            return dict(chunks)
        inv = {p: l for l, p in enumerate(self.chunk_mapping)}
        return {inv.get(i, i): v for i, v in chunks.items()}

    def _from_logical(self, chunks: dict[int, bytes]) -> dict[int, bytes]:
        if not self.chunk_mapping:
            return chunks
        return {self.chunk_index(i): v for i, v in chunks.items()}

    def _logical_ids(self, ids) -> set[int]:
        if not self.chunk_mapping:
            return set(ids)
        inv = {p: l for l, p in enumerate(self.chunk_mapping)}
        return {inv.get(i, i) for i in ids}

    # -- object-level encode/decode ---------------------------------------

    def encode_prepare(self, data: bytes) -> dict[int, bytes]:
        """Split into k chunks of get_chunk_size(len), zero-padding the
        tail chunks."""
        k = self.get_data_chunk_count()
        blocksize = self.get_chunk_size(len(data))
        if blocksize == 0:  # zero-length object: k+m empty chunks
            return {self.chunk_index(i): b"" for i in range(k)}
        chunks: dict[int, bytes] = {}
        full = len(data) // blocksize
        for i in range(full):
            chunks[self.chunk_index(i)] = data[i * blocksize:(i + 1) * blocksize]
        if full < k:
            rest = data[full * blocksize:]
            chunks[self.chunk_index(full)] = rest.ljust(blocksize, b"\0")
            zero = bytes(blocksize)
            for i in range(full + 1, k):
                chunks[self.chunk_index(i)] = zero
        return chunks

    def encode(self, want_to_encode: set[int], data: bytes) -> dict[int, bytes]:
        if len(data) == 0:
            return {i: b"" for i in want_to_encode}
        prepared = self.encode_prepare(data)
        encoded = self.encode_chunks(prepared)
        return {i: encoded[i] for i in want_to_encode}

    # -- device dispatch (the card path) ------------------------------

    def _device_matrix(self):
        """(matrix, w) of this plain GF(2^w) matrix code: its encode is
        a region product, the shape the device batcher dispatches."""
        raise NotImplementedError

    def device_families(self) -> list[tuple]:
        """The (matrix, w) program families this codec's dispatches
        ride, what `DeviceRuntime.warmup_ec` runs at boot (a loop over
        this list).  A plain matrix codec has exactly its coding
        matrix; the layered codecs (LRC, SHEC, CLAY) override with
        their per-step matrices."""
        return [self._device_matrix()]

    async def _device_matmul(self, matrix, w: int, data,
                             klass: str | None = None,
                             on_ticket=None, chip: int | None = None,
                             tenant: str | None = None):
        """One batched GF(2^w) region product on the codec's device
        ([rows, k] x [k, n] words -> [rows, n]) through the batcher:
        the dispatch each step of the layered codecs rides.  Raises
        IOError when the dispatch failed."""
        from ..device.runtime import K_CLIENT_EC
        from .batcher import DeviceBatcher
        return await DeviceBatcher.get().encode(
            [[int(c) for c in r] for r in matrix], int(w), data,
            klass=klass or K_CLIENT_EC, on_ticket=on_ticket,
            chip=chip, tenant=tenant, device=self.device)

    @staticmethod
    def _word_dtype(w: int):
        import numpy as np
        return {8: np.uint8, 16: "<u2", 32: "<u4"}[w]

    async def encode_async(self, want_to_encode: set[int],
                           data: bytes, klass: str | None = None,
                           on_ticket=None, chip: int | None = None,
                           tenant: str | None = None
                           ) -> dict[int, bytes]:
        """encode() with the GF product batched onto the codec's device
        (``self.device``; the card unless ``new_codec`` was given
        another) across concurrent callers (ECBackend's hot call,
        src/osd/ECTransaction.cc:56 -> encode_chunks).  Only a
        zero-length object takes the sync path.

        klass selects the device dispatch class (client-EC vs
        recovery-EC admission weights); chip is the caller's mesh
        affinity; on_ticket receives the dispatch's DispatchTicket."""
        if len(data) == 0:
            return self.encode(want_to_encode, data)
        out = await self.encode_chunks_async(
            self.encode_prepare(data), klass=klass, on_ticket=on_ticket,
            chip=chip, tenant=tenant)
        return {i: out[i] for i in want_to_encode}

    async def encode_chunks_async(self, chunks: Mapping[int, bytes],
                                  klass: str | None = None,
                                  on_ticket=None, chip: int | None = None,
                                  tenant: str | None = None
                                  ) -> dict[int, bytes]:
        """`encode_chunks` with the GF product on the codec's device:
        the k data chunks (keyed as encode_prepare keys them) -> all
        k+m chunks.  The chunk-level entry a layered codec (LRC)
        drives each layer through."""
        import numpy as np
        matrix, w = self._device_matrix()
        k = self.get_data_chunk_count()
        arr = np.stack([
            np.frombuffer(chunks[self.chunk_index(i)],
                          dtype=self._word_dtype(w)) for i in range(k)])
        parity = await self._device_matmul(
            matrix, w, arr, klass=klass, on_ticket=on_ticket, chip=chip,
            tenant=tenant)
        out = dict(chunks)
        for i in range(len(matrix)):
            out[self.chunk_index(k + i)] = np.ascontiguousarray(
                parity[i]).tobytes()
        return out

    async def decode_chunks_async(self, want_to_read,
                                  chunks: Mapping[int, bytes],
                                  klass: str | None = None,
                                  on_ticket=None, chip: int | None = None
                                  ) -> dict[int, bytes]:
        """`decode_chunks` with the reconstruction on the codec's
        device: every erased chunk rebuilt directly from the surviving
        ones through the cached reconstruction rows (decode-as-encode),
        keyed as the chunks are."""
        lchunks = self._to_logical(chunks)
        erased = tuple(i for i in range(self.get_chunk_count())
                       if i not in lchunks)
        if not erased:
            return {}
        rec = await self._reconstruct_async(erased, lchunks, klass,
                                            on_ticket, chip)
        return self._from_logical(rec)

    async def _reconstruct_async(self, erased: tuple, lchunks: Mapping,
                                 klass, on_ticket, chip
                                 ) -> dict[int, bytes]:
        """The logical chunks `erased` rebuilt from the logical
        survivors `lchunks` as one device product."""
        import numpy as np

        from .batcher import reconstruct_matrix
        matrix, w = self._device_matrix()
        k = self.get_data_chunk_count()
        rows, chosen = reconstruct_matrix(k, w, matrix, erased,
                                          tuple(sorted(lchunks)))
        arr = np.stack([
            np.frombuffer(lchunks[c], dtype=self._word_dtype(w))
            for c in chosen])
        words = await self._device_matmul(
            rows, w, arr, klass=klass, on_ticket=on_ticket, chip=chip)
        return {e: np.ascontiguousarray(words[j]).tobytes()
                for j, e in enumerate(erased)}

    def parity_delta(self, deltas: Mapping[int, bytes]
                     ) -> dict[int, bytes]:
        """Host parity updates for a partial overwrite (the
        XOR-delta formulation of arXiv:2108.02692): given
        ``delta_j = new_j XOR old_j`` for each touched data chunk j
        (logical/generator-row index; all values the same length),
        returns {parity row i: XOR-delta to apply to parity chunk i}:

            new_parity_i = old_parity_i XOR sum_j gfmul(M[i][j],
                                                        delta_j)

        Exact under GF linearity for any matrix codec.  This is the
        codec's host semantics; `delta_async` computes the same on the
        device.

        Sub-word-aligned regions (w=16/32, length not a word
        multiple): the tail is zero-padded to the word boundary and
        the returned parity deltas carry the word-aligned length — a
        sub-word overwrite dirties its whole containing parity word,
        so callers apply the delta over the word-aligned envelope of
        the region."""
        import numpy as np

        from . import gf
        matrix, w = self._device_matrix()
        m = len(matrix)
        dtype = np.dtype(self._word_dtype(w))
        lengths = {len(d) for d in deltas.values()}
        if len(lengths) > 1:
            raise ValueError(
                "delta regions have differing lengths %s" % lengths)
        word = dtype.itemsize
        pad = (-(lengths.pop() if lengths else 0)) % word
        arrs = {int(j): np.frombuffer(
                    bytes(d) + b"\0" * pad if pad else d, dtype=dtype)
                for j, d in deltas.items()}
        n = next(iter(arrs.values())).shape[0] if arrs else 0
        out: dict[int, bytes] = {}
        for i in range(m):
            acc = np.zeros(n, dtype=dtype)
            for j, darr in arrs.items():
                c = int(matrix[i][j])
                if int(w) == 8:
                    gf.region_mad_u8(acc, darr, c)
                else:
                    gf.region_mad_words(acc, darr, c, int(w))
            out[i] = acc.tobytes()
        return out

    async def delta_async(self, deltas: Mapping[int, bytes],
                          klass: str | None = None,
                          on_ticket=None, chip: int | None = None,
                          tenant: str | None = None
                          ) -> dict[int, bytes]:
        """`parity_delta` with the GF products batched onto the
        codec's device (the OSD partial-write hot call): concurrent
        small overwrites aggregate into one dispatch.

        The delta rides the codec's FULL coding matrix with zero rows
        for untouched data chunks — zero rows contribute nothing under
        GF linearity, so delta dispatches share the encode streams and
        batch with ordinary full writes.  Sub-word-aligned regions on
        w=16/32 codecs are zero-padded to the word boundary; the
        returned parity deltas carry the word-aligned length, identical
        to `parity_delta`.  Zero-length regions take the sync path."""
        from ..device.runtime import K_CLIENT_EC
        from .batcher import DeviceBatcher
        if not deltas:
            return {}
        import numpy as np
        matrix, w = self._device_matrix()
        word = np.dtype(self._word_dtype(w)).itemsize
        lengths = {len(d) for d in deltas.values()}
        if len(lengths) != 1:
            raise ValueError(
                "delta regions have differing lengths %s" % lengths)
        nbytes = lengths.pop()
        if nbytes == 0:
            return self.parity_delta(deltas)
        pad = (-nbytes) % word
        k = self.get_data_chunk_count()
        arr = np.zeros((k, (nbytes + pad) // word),
                       dtype=self._word_dtype(w))
        for j, d in deltas.items():
            arr[int(j)] = np.frombuffer(
                bytes(d) + b"\0" * pad if pad else d,
                dtype=self._word_dtype(w))
        parity = await DeviceBatcher.get().encode(
            matrix, w, arr, klass=klass or K_CLIENT_EC,
            on_ticket=on_ticket, chip=chip, tenant=tenant,
            device=self.device)
        return {i: parity[i].tobytes() for i in range(len(matrix))}

    async def decode_async(self, want_to_read: set[int],
                           chunks: Mapping[int, bytes],
                           klass: str | None = None,
                           on_ticket=None,
                           chip: int | None = None) -> dict[int, bytes]:
        """decode() with the reconstruction product batched onto the
        codec's device (the ECBackend degraded-read/recovery call,
        src/osd/ECUtil.cc:12-121).  Reconstruction is an encode with
        the inverted-survivor matrix, so it shares the encode queue.
        Under a ``mapping=`` profile the chunks map to logical ids, the
        reconstruction runs on those, and the rebuilt chunks map back.
        All-present reads and zero-length chunks take the sync path, as
        in the reference."""
        if (want_to_read <= set(chunks)
                or any(len(c) == 0 for c in chunks.values())):
            return self.decode(want_to_read, chunks)
        if len(chunks) < self.get_data_chunk_count():
            raise IOError(
                "cannot decode: %d chunks available, %d needed"
                % (len(chunks), self.get_data_chunk_count()))
        lengths = {len(c) for c in chunks.values()}
        if len(lengths) != 1:
            raise ValueError(
                "surviving chunks have differing sizes %s" % lengths)
        erased = tuple(sorted(self._logical_ids(
            set(want_to_read) - set(chunks))))
        out = self._from_logical(await self._reconstruct_async(
            erased, self._to_logical(chunks), klass, on_ticket, chip))
        for i in want_to_read:
            if i in chunks:
                out[i] = bytes(chunks[i])
        return out

    async def decode_concat_async(self, chunks: Mapping[int, bytes],
                                  klass: str | None = None,
                                  on_ticket=None,
                                  chip: int | None = None) -> bytes:
        k = self.get_data_chunk_count()
        want = {self.chunk_index(i) for i in range(k)}
        decoded = await self.decode_async(want, chunks, klass=klass,
                                          on_ticket=on_ticket,
                                          chip=chip)
        return b"".join(decoded[self.chunk_index(i)]
                        for i in range(k))

    # Locality-aware codes (LRC, SHEC) can repair from FEWER than k
    # chunks (a local group / shingle window); they clear this flag so
    # _decode skips the k-chunk floor while keeping the size check.
    REQUIRES_K_CHUNKS = True

    def _decode(
        self, want_to_read: set[int], chunks: Mapping[int, bytes],
    ) -> dict[int, bytes]:
        if want_to_read <= set(chunks):
            return {i: bytes(chunks[i]) for i in want_to_read}
        if (self.REQUIRES_K_CHUNKS
                and len(chunks) < self.get_data_chunk_count()):
            raise IOError(
                "cannot decode: %d chunks available, %d needed"
                % (len(chunks), self.get_data_chunk_count()))
        lengths = {len(c) for c in chunks.values()}
        if len(lengths) != 1:
            raise ValueError("surviving chunks have differing sizes %s" % lengths)
        decoded = self.decode_chunks(want_to_read, chunks)
        out = {}
        for i in want_to_read:
            out[i] = bytes(chunks[i]) if i in chunks else decoded[i]
        return out

    def decode(
        self, want_to_read: set[int], chunks: Mapping[int, bytes],
        chunk_size: int = 0,
    ) -> dict[int, bytes]:
        return self._decode(want_to_read, chunks)

    def decode_concat(self, chunks: Mapping[int, bytes]) -> bytes:
        k = self.get_data_chunk_count()
        want = {self.chunk_index(i) for i in range(k)}
        decoded = self._decode(want, chunks)
        return b"".join(decoded[self.chunk_index(i)] for i in range(k))

    # -- read planning -----------------------------------------------------

    def _minimum_to_decode(
        self, want_to_read: set[int], available: set[int],
    ) -> set[int]:
        if want_to_read <= available:
            return set(want_to_read)
        k = self.get_data_chunk_count()
        if len(available) < k:
            raise IOError("cannot decode: only %d of %d chunks available"
                          % (len(available), k))
        return set(sorted(available)[:k])

    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int],
    ) -> dict[int, list[tuple[int, int]]]:
        ids = self._minimum_to_decode(want_to_read, available)
        whole = [(0, self.get_sub_chunk_count())]
        return {i: list(whole) for i in ids}

    def minimum_to_decode_with_cost(
        self, want_to_read: set[int], available: Mapping[int, int],
    ) -> set[int]:
        return self._minimum_to_decode(want_to_read, set(available))
