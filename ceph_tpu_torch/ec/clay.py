"""CLAY (Coupled LAYer) MSR regenerating codes.

Behavioral re-derivation of src/erasure-code/clay/ErasureCodeClay.{h,cc}
(the Clay-codes FAST'18 construction): an (k+m, k) scalar MDS code is
lifted onto a q x t node grid (q = d-k+1, t = (k+m+nu)/q) whose chunks
split into q^t sub-chunks ("planes"); pairwise coupling between a node
(x, y) in plane z and its partner (z_y, y) in the plane with digit y
swapped to x makes single-node repair read only q^(t-1) sub-chunks from
each of d helpers — repair bandwidth d/(d-k+1) sub-chunks per chunk
instead of k whole chunks.

Structure mirrored from the reference (cited by line where the
semantics are pinned):

* parameters/layout: q, t, nu padding, sub_chunk_no = q^t
  (ErasureCodeClay.cc:271-296); chunk alignment sub_chunk_no*k*pft
  (:93);
* encode = decode_layered with the parity nodes erased (:140-152);
* decode_layered: planes ordered by intersection score (erased
  hole-dot count, :762-773), per plane the surviving nodes' uncoupled
  symbols come from pairwise transforms of the coupled pairs
  (decode_erasures, :712-739), the erased nodes' uncoupled symbols from
  the scalar MDS decode (decode_uncoupled, :741-760), and the coupled
  symbols back out of the pair relations (recover_type1_erasure /
  get_coupled_from_uncoupled, :775-838);
* the pairwise transform IS a (4, 2) instance of the same scalar MDS
  code over [C_xy, C_sw, U_xy, U_sw] with the lower-x symbol first
  (the i0..i3 swap, :848-855) — byte-compat is *expected* to follow
  from the k=2,m=2 coding matrix of the chosen scalar_mds plugin, but
  note the golden corpus entries for clay are generated by this
  implementation (self-pinned regression vectors, not captured from
  the reference plugin), so on-the-wire shard compatibility with the
  reference is argued from the construction, not pinned by a vector;
* single-node repair reads only the repair planes {z : z_{y_lost} =
  x_lost} from every helper (minimum_to_decode sub-chunk ranges,
  :310-392); implemented here for the no-aloof case (d = #survivors,
  e.g. the default d = k+m-1 with one failure) — other layouts fall
  back to the full-chunk layered decode.

Counterpart of ceph_tpu/ec/clay.py.  The async entry points run each
intersection-score round's MDS decode (and repair's one decode over
every repair plane) through `_device_matmul` on the codec's device;
the 2x2 coupling solves stay numpy on the host, as in the reference.
A failed dispatch fails the op.
"""

from __future__ import annotations

import numpy as np

from . import gf
from .base import ErasureCode
from .plugin import ErasureCodePluginRegistry


class ErasureCodeClay(ErasureCode):
    DEFAULT_K = 4
    DEFAULT_M = 2

    def __init__(self):
        super().__init__()
        self.d = 0
        self.q = 0
        self.t = 0
        self.nu = 0
        self.sub_chunk_no = 1
        self.scalar_mds = "jerasure"
        self.technique = "reed_sol_van"

    # -- profile -----------------------------------------------------------

    def init(self, profile: dict) -> None:
        profile.setdefault("plugin", "clay")
        self.parse(profile)
        self.prepare()
        self._profile = profile

    def parse(self, profile: dict) -> None:
        self.k = self._to_int(profile, "k", self.DEFAULT_K)
        self.m = self._to_int(profile, "m", self.DEFAULT_M)
        self.d = self._to_int(profile, "d", self.k + self.m - 1)
        if not (self.k + 1 <= self.d <= self.k + self.m - 1):
            raise ValueError(
                "clay: d=%d must satisfy k+1 <= d <= k+m-1" % self.d)
        self.scalar_mds = profile.get("scalar_mds", "jerasure")
        if self.scalar_mds not in ("jerasure", "isa"):
            raise ValueError("clay: scalar_mds %r not supported"
                             % self.scalar_mds)
        self.technique = profile.get("technique", "reed_sol_van")
        if self.technique not in ("reed_sol_van", "cauchy"):
            raise ValueError("clay: technique %r not supported"
                             % self.technique)
        self._parse_mapping(profile)
        self.sanity_check_k_m()

    def prepare(self) -> None:
        self.q = self.d - self.k + 1
        self.nu = (self.q - (self.k + self.m) % self.q) % self.q
        self.t = (self.k + self.m + self.nu) // self.q
        self.sub_chunk_no = self.q ** self.t
        if self.k + self.m + self.nu > 254:
            raise ValueError("clay: k+m+nu too large for GF(256)")
        reg = ErasureCodePluginRegistry.instance()

        def mk(k, m):
            prof = {"plugin": self.scalar_mds, "k": str(k),
                    "m": str(m), "w": "8",
                    "technique": self.technique}
            return reg.factory(self.scalar_mds, prof)

        self.mds = mk(self.k + self.nu, self.m)
        self.pft = mk(2, 2)
        # (4,2) pairwise-transform generator: rows 0,1 = identity
        # (the coupled pair), rows 2,3 = the k=2,m=2 coding matrix
        # (the uncoupled pair).  Symbol order is the reference's
        # i0..i3 canonicalisation (ErasureCodeClay.cc:848-855):
        # sym0/sym2 = C/U of the LARGER-x pair member, sym1/sym3 of
        # the smaller.  Solves for any 2-of-4 are 2x2 GF inverts.
        P = [list(r) for r in self.pft.matrix]
        self._pft_gen = [[1, 0], [0, 1], list(P[0]), list(P[1])]
        self._pft_solves: dict[tuple, tuple] = {}

    # -- geometry ----------------------------------------------------------

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_alignment(self) -> int:
        return self.sub_chunk_no * self.k * self.pft.get_chunk_size(1)

    def get_chunk_size(self, object_size: int) -> int:
        a = self.get_alignment()
        padded = object_size + (a - object_size % a) % a
        return padded // self.k

    def _zvec(self, z: int) -> list[int]:
        v = [0] * self.t
        for i in range(self.t):
            v[self.t - 1 - i] = z % self.q
            z //= self.q
        return v

    def _zsw(self, z: int, zv: list[int], x: int, y: int) -> int:
        return z + (x - zv[y]) * (self.q ** (self.t - 1 - y))

    # -- pairwise transform -------------------------------------------------

    def _pft_solve(self, known: tuple[int, int]):
        """(A, B): unknowns = A @ [known0, known1] where unknowns are
        the complementary pair in index order."""
        key = known
        cached = self._pft_solves.get(key)
        if cached is not None:
            return cached
        G = self._pft_gen
        i, j = known
        unk = tuple(r for r in range(4) if r not in known)
        # [g_i; g_j] @ [d0,d1]^T = [known0, known1]^T
        inv = gf.matrix_invert([list(G[i]), list(G[j])], 8)
        rows = gf.matrix_mul([list(G[u]) for u in unk], inv, 8)
        self._pft_solves[key] = (unk, np.array(rows, dtype=np.uint8))
        return self._pft_solves[key]

    def _pair(self, a: np.ndarray, b: np.ndarray, known: tuple):
        """Apply the 2-of-4 solve: returns the two unknown symbols (in
        index order) from known symbols a, b (arrays)."""
        _unk, rows = self._pft_solve(known)
        data = np.stack([a, b])
        out = gf.matmul_u8(rows, data)
        return out[0], out[1]

    # -- layered decode (the engine behind encode AND decode) --------------

    def _rounds(self, erasures: set[int], sc: int):
        """(er, U, rounds): the erased nodes padded with parity nodes
        to m, the zeroed uncoupled symbols, and the planes of each
        intersection-score round (erased hole-dot count) in order."""
        q, t = self.q, self.t
        er = set(erasures)
        for i in range(self.k + self.nu, q * t):
            if len(er) >= self.m:
                break
            er.add(i)
        assert len(er) == self.m
        U = [np.zeros((self.sub_chunk_no, sc), np.uint8)
             for _ in range(q * t)]
        order = []
        for z in range(self.sub_chunk_no):
            zv = self._zvec(z)
            order.append(sum(1 for i in er if i % q == zv[i // q]))
        rounds = [[z for z in range(self.sub_chunk_no) if order[z] == score]
                  for score in range(max(order) + 1)]
        return er, U, rounds

    def _decode_layered(self, erasures: set[int], C: list, sc: int):
        """C: list of q*t numpy [sub_chunk_no, sc] uint8 arrays
        (erased entries are written in place)."""
        er, U, rounds = self._rounds(erasures, sc)
        dec_rows = self._mds_decode_rows(er)
        for planes in rounds:
            for z in planes:
                self._fill_uncoupled(er, z, C, U)
                self._decode_uncoupled(er, z, U, dec_rows)
            for z in planes:
                self._couple(er, z, C, U)
        return C

    def _couple(self, er: set[int], z: int, C, U) -> None:
        """The erased nodes' coupled symbols of plane z from the
        uncoupled ones and the partners' coupled symbols."""
        q = self.q
        zv = self._zvec(z)
        for node in sorted(er):
            x, y = node % q, node // q
            sw = y * q + zv[y]
            if zv[y] == x:       # hole-dot: C = U
                C[node][z] = U[node][z]
            elif sw not in er:
                # type-1 (recover_type1_erasure): solve the erased
                # node's C from (partner C, own U)
                z_sw = self._zsw(z, zv, x, y)
                if x < zv[y]:
                    # node is the smaller member (sym1): knowns
                    # sym0=C_sw, sym3=U_node
                    out = self._pair(C[sw][z_sw], U[node][z], (0, 3))
                else:
                    # node is the larger member (sym0): knowns
                    # sym1=C_sw, sym2=U_node
                    out = self._pair(C[sw][z_sw], U[node][z], (1, 2))
                C[node][z] = out[0]
            elif zv[y] < x:
                # both erased (get_coupled_from_uncoupled, larger side
                # drives): C pair from U pair
                z_sw = self._zsw(z, zv, x, y)
                c_hi, c_lo = self._pair(U[node][z], U[sw][z_sw], (2, 3))
                C[node][z] = c_hi           # sym0 (larger)
                C[sw][z_sw] = c_lo          # sym1

    def _fill_uncoupled(self, er: set[int], z: int, C, U) -> None:
        """decode_erasures' first pass: U for every surviving node of
        plane z from the coupled pairs."""
        q, t = self.q, self.t
        zv = self._zvec(z)
        for y in range(t):
            for x in range(q):
                node = q * y + x
                if node in er:
                    continue
                sw = q * y + zv[y]
                if zv[y] == x:
                    U[node][z] = C[node][z]
                elif zv[y] < x:
                    # node is the larger member: compute both U from
                    # the C pair (this also pre-fills the partner's U
                    # at the later plane z_sw — planes iterate
                    # ascending, and z_sw > z here; for an erased sw
                    # its C at z_sw was recovered in an earlier
                    # iscore round)
                    z_sw = self._zsw(z, zv, x, y)
                    u_hi, u_lo = self._pair(C[node][z], C[sw][z_sw],
                                            (0, 1))
                    U[node][z] = u_hi
                    U[sw][z_sw] = u_lo
                elif sw in er:
                    # node smaller, partner erased: partner's C at
                    # z_sw (< z, one fewer erased dot) is recovered
                    z_sw = self._zsw(z, zv, x, y)
                    u_hi, u_lo = self._pair(C[sw][z_sw], C[node][z],
                                            (0, 1))
                    U[sw][z_sw] = u_hi
                    U[node][z] = u_lo

    def _mds_decode_rows(self, er: set[int]):
        """Decoding rows for the scalar MDS over the q*t grid: rows
        that rebuild the erased nodes' uncoupled symbols from the
        surviving ones (cached per erasure signature upstream)."""
        from .batcher import reconstruct_matrix
        n = self.q * self.t
        have = tuple(i for i in range(n) if i not in er)
        erased = tuple(sorted(er))
        rows, chosen = reconstruct_matrix(
            self.k + self.nu, 8, [list(r) for r in self.mds.matrix],
            erased, have)
        return erased, chosen, np.array(rows, dtype=np.uint8)

    def _decode_uncoupled(self, er, z, U, dec_rows) -> None:
        erased, chosen, rows = dec_rows
        data = np.stack([U[c][z] for c in chosen])
        out = gf.matmul_u8(rows, data)
        for idx, node in enumerate(erased):
            U[node][z] = out[idx]

    # -- device dispatch (the card path) ----------------------------

    def device_families(self) -> list[tuple]:
        """The MDS decode-row matrices CLAY's dispatches ride: the
        encode shape (every parity node erased) and the single-node
        repair shape (node 0's whole row erased)."""
        fams: list[tuple] = []
        for er in (set(range(self.k + self.nu, self.q * self.t)),
                   set(range(self.q))):
            _er, _ch, rows = self._mds_decode_rows(er)
            fams.append(([list(r) for r in rows], 8))
        return fams

    async def _decode_layered_async(self, erasures: set[int], C: list,
                                    sc: int, klass=None,
                                    chip: int | None = None,
                                    tenant: str | None = None,
                                    on_ticket=None):
        """`_decode_layered` with each intersection-score round's
        uncoupled MDS decode batched across ALL the round's planes as
        ONE device product ([m, survivors] x [survivors, planes*sc]
        GF(256) words) on the codec's device.  The pairwise
        coupling transforms (2x2 solves per pair) stay host-side —
        they are O(pairs) tiny products, while the MDS decode is the
        k-wide inner loop.  Restructuring each round into
        fill-all-planes -> decode-all-planes is bit-exact: fills read
        only C (writing U), survivor pre-fills always target LATER
        planes, and the decode reads only survivor U entries of its
        own plane."""
        er, U, rounds = self._rounds(erasures, sc)
        erased, chosen, rows = self._mds_decode_rows(er)
        for planes in rounds:
            for z in planes:
                self._fill_uncoupled(er, z, C, U)
            if planes and sc:
                data = np.concatenate(
                    [np.stack([U[c][z] for c in chosen])
                     for z in planes], axis=1)
                out = await self._device_matmul(
                    rows, 8, data, klass=klass,
                    chip=chip, tenant=tenant, on_ticket=on_ticket)
                for pi, z in enumerate(planes):
                    for idx, node in enumerate(erased):
                        U[node][z] = out[idx, pi * sc:(pi + 1) * sc]
            for z in planes:
                self._couple(er, z, C, U)
        return C

    async def encode_async(self, want_to_encode: set[int],
                           data: bytes, klass: str | None = None,
                           on_ticket=None, chip: int | None = None,
                           tenant: str | None = None
                           ) -> dict[int, bytes]:
        """Coupled-layer encode (the layered decode with every parity
        node erased) with the per-round MDS products batched onto the
        codec's device.  A zero-length object, or a chunk size that
        is not a multiple of the sub-chunk count, takes the sync
        path."""
        if len(data) == 0:
            return self.encode(want_to_encode, data)
        prepared = self.encode_prepare(data)
        chunk_size = len(prepared[self.chunk_index(0)])
        if chunk_size % self.sub_chunk_no:
            return self.encode(want_to_encode, data)
        out = await self.encode_chunks_async(
            prepared, klass=klass, on_ticket=on_ticket, chip=chip,
            tenant=tenant)
        return {i: out[i] for i in want_to_encode}

    def _sub_chunk_size(self, chunk_size: int) -> int:
        if chunk_size % self.sub_chunk_no:
            raise ValueError("clay: chunk of %d bytes is not a multiple of "
                             "the %d sub-chunks" % (chunk_size,
                                                    self.sub_chunk_no))
        return chunk_size // self.sub_chunk_no

    async def encode_chunks_async(self, chunks: dict[int, bytes],
                                  klass: str | None = None,
                                  on_ticket=None, chip: int | None = None,
                                  tenant: str | None = None
                                  ) -> dict[int, bytes]:
        """`encode_chunks` with the per-round MDS products on the
        codec's device (the chunk-level entry an LRC layer rides)."""
        sc = self._sub_chunk_size(len(chunks[self.chunk_index(0)]))
        logical = {i: chunks[self.chunk_index(i)] for i in range(self.k)}
        C = self._grid(logical, sc)
        parities = set(range(self.k + self.nu, self.q * self.t))
        await self._decode_layered_async(
            parities, C, sc, klass=klass, chip=chip, tenant=tenant,
            on_ticket=on_ticket)
        out = dict(chunks)
        for i in range(self.m):
            out[self.chunk_index(self.k + i)] = \
                C[self.k + self.nu + i].tobytes()
        return out

    async def decode_chunks_async(self, want_to_read, chunks,
                                  klass: str | None = None,
                                  on_ticket=None, chip: int | None = None
                                  ) -> dict[int, bytes]:
        """`decode_chunks` with the per-round MDS products on the
        codec's device: every erased chunk rebuilt, keyed as the
        chunks are."""
        lchunks = self._to_logical(chunks)
        sc = self._sub_chunk_size(len(next(iter(lchunks.values()))))
        erased_ext = [i for i in range(self.k + self.m)
                      if i not in lchunks]
        C = self._grid(lchunks, sc)
        er = {i if i < self.k else i + self.nu for i in erased_ext}
        await self._decode_layered_async(
            er, C, sc, klass=klass, chip=chip, on_ticket=on_ticket)
        rec = {}
        for i in erased_ext:
            node = i if i < self.k else i + self.nu
            rec[i] = C[node].tobytes()
        return self._from_logical(rec)

    async def decode_async(self, want_to_read: set[int],
                           chunks, klass: str | None = None,
                           on_ticket=None,
                           chip: int | None = None) -> dict[int, bytes]:
        """Sub-chunk coupled decode through the device dispatch path:
        mirrors `_decode`'s wrapper semantics (passthrough, size
        check, k-chunk floor) around the device-batched layered
        decode.  All-present reads, zero-length chunks and a chunk
        size that is not a multiple of the sub-chunk count take the
        sync path."""
        want = set(want_to_read)
        chunks = dict(chunks)
        if (want <= set(chunks)
                or any(len(c) == 0 for c in chunks.values())):
            return self.decode(want, chunks)
        if len(chunks) < self.get_data_chunk_count():
            raise IOError(
                "cannot decode: %d chunks available, %d needed"
                % (len(chunks), self.get_data_chunk_count()))
        lengths = {len(c) for c in chunks.values()}
        if len(lengths) != 1:
            raise ValueError(
                "surviving chunks have differing sizes %s" % lengths)
        if lengths.pop() % self.sub_chunk_no:
            return self.decode(want, chunks)
        phys = await self.decode_chunks_async(
            want, chunks, klass=klass, on_ticket=on_ticket, chip=chip)
        out = {}
        for i in want:
            out[i] = bytes(chunks[i]) if i in chunks else phys[i]
        return out

    # -- chunk API ----------------------------------------------------------

    def _grid(self, chunks: dict[int, bytes], sc: int):
        """chunks (logical external ids) -> grid arrays with the nu
        zero nodes spliced in at k..k+nu-1."""
        n = self.q * self.t
        C = [np.zeros((self.sub_chunk_no, sc), np.uint8)
             for _ in range(n)]
        for i, buf in chunks.items():
            node = i if i < self.k else i + self.nu
            C[node] = np.frombuffer(buf, np.uint8).reshape(
                self.sub_chunk_no, sc).copy()
        return C

    def encode_chunks(self, chunks: dict[int, bytes]) -> dict[int, bytes]:
        chunk_size = len(chunks[self.chunk_index(0)])
        assert chunk_size % self.sub_chunk_no == 0
        sc = chunk_size // self.sub_chunk_no
        logical = {i: chunks[self.chunk_index(i)]
                   for i in range(self.k)}
        C = self._grid(logical, sc)
        parities = set(range(self.k + self.nu, self.q * self.t))
        self._decode_layered(parities, C, sc)
        out = dict(chunks)
        for i in range(self.m):
            out[self.chunk_index(self.k + i)] = \
                C[self.k + self.nu + i].tobytes()
        return out

    def decode_chunks(self, want_to_read, chunks) -> dict[int, bytes]:
        chunks = self._to_logical(chunks)
        chunk_size = len(next(iter(chunks.values())))
        assert chunk_size % self.sub_chunk_no == 0
        sc = chunk_size // self.sub_chunk_no
        n_ext = self.k + self.m
        erased_ext = [i for i in range(n_ext) if i not in chunks]
        C = self._grid(chunks, sc)
        er = {i if i < self.k else i + self.nu for i in erased_ext}
        self._decode_layered(er, C, sc)
        out = {}
        for i in erased_ext:
            node = i if i < self.k else i + self.nu
            out[i] = C[node].tobytes()
        return self._from_logical(out)

    # -- repair-bandwidth API ----------------------------------------------

    def _repair_planes(self, lost: int) -> list[int]:
        """Plane indices every helper must send to repair `lost`
        (z with z_{y_lost} == x_lost), ascending."""
        q, t = self.q, self.t
        x, y = lost % q, lost // q
        step = q ** (t - 1 - y)
        planes = []
        for z in range(self.sub_chunk_no):
            if (z // step) % q == x:
                planes.append(z)
        return planes

    def minimum_to_decode(self, want_to_read, available):
        want = set(want_to_read)
        avail = set(available)
        # the sub-chunk repair plan applies only to the no-aloof
        # layout repair() supports: a single loss with d = k+m-1, so
        # the d helpers ARE every surviving node
        if (len(want) == 1 and not (want & avail)
                and not self.chunk_mapping
                and self.d == self.k + self.m - 1):
            lost_ext = next(iter(want))
            helpers = avail - want
            if helpers == set(range(self.k + self.m)) - want:
                lost = (lost_ext if lost_ext < self.k
                        else lost_ext + self.nu)
                planes = self._repair_planes(lost)
                # contiguous (offset, count) runs in sub-chunk units
                runs = []
                for z in planes:
                    if runs and runs[-1][0] + runs[-1][1] == z:
                        runs[-1] = (runs[-1][0], runs[-1][1] + 1)
                    else:
                        runs.append((z, 1))
                chosen = sorted(helpers)[:self.d]
                return {c: list(runs) for c in chosen}
        return super().minimum_to_decode(want_to_read, available)

    def _repair_setup(self, lost_ext: int,
                      helper_subchunks: dict[int, bytes]):
        """(lost, planes, H, U, er, out): the lost node, its repair
        planes, the helpers' sub-chunks by node (the nu zero nodes
        help too), zeroed uncoupled symbols, the erased row for the
        uncoupled decode (lost's whole y-row) and the zeroed result."""
        q, t = self.q, self.t
        lost = lost_ext if lost_ext < self.k else lost_ext + self.nu
        planes = self._repair_planes(lost)
        sc = len(next(iter(helper_subchunks.values()))) // len(planes)
        n = q * t
        H: dict[int, np.ndarray] = {}
        for ext, buf in helper_subchunks.items():
            node = ext if ext < self.k else ext + self.nu
            H[node] = np.frombuffer(buf, np.uint8).reshape(
                len(planes), sc)
        for i in range(self.k, self.k + self.nu):   # zero nodes help
            H[i] = np.zeros((len(planes), sc), np.uint8)
        missing_helpers = set(range(n)) - set(H) - {lost}
        if missing_helpers:
            raise IOError("clay repair needs every surviving node "
                          "(aloof nodes unsupported; use decode)")
        U = {node: np.zeros((len(planes), sc), np.uint8)
             for node in range(n)}
        er = {(lost // q) * q + xx for xx in range(q)}
        out = np.zeros((self.sub_chunk_no, sc), np.uint8)
        return lost, planes, H, U, er, out

    def _repair_fill(self, z: int, plane_ind: dict, er: set[int],
                     H, U) -> None:
        """Repair plane z's uncoupled symbols of every helper outside
        the erased row, from the helpers' coupled pairs."""
        q, t = self.q, self.t
        zi = plane_ind[z]
        zv = self._zvec(z)
        for y in range(t):
            for x in range(q):
                node = y * q + x
                if node in er:
                    continue
                sw = y * q + zv[y]
                if zv[y] == x:
                    U[node][zi] = H[node][zi]
                elif zv[y] < x:
                    z_sw = self._zsw(z, zv, x, y)
                    u_hi, u_lo = self._pair(
                        H[node][zi], H[sw][plane_ind[z_sw]], (0, 1))
                    U[node][zi] = u_hi
                    U[sw][plane_ind[z_sw]] = u_lo

    def _repair_out(self, z: int, plane_ind: dict, lost: int, H, U,
                    out) -> None:
        """Back to coupled: the dot gives lost's own plane z, the other
        members of its row give lost's swapped planes."""
        q = self.q
        x_l, y_l = lost % q, lost // q
        zi = plane_ind[z]
        zv = self._zvec(z)
        out[z] = U[lost][zi]
        for xx in range(q):
            if xx == x_l:
                continue
            node = y_l * q + xx
            z_sw = self._zsw(z, zv, xx, y_l)
            if xx < x_l:
                # helper is the smaller member: knowns sym1=C, sym3=U;
                # lost (larger) C is sym0
                out[z_sw] = self._pair(H[node][zi], U[node][zi],
                                       (1, 3))[0]
            else:
                # helper larger: knowns sym0=C, sym2=U; lost (smaller)
                # C is sym1
                out[z_sw] = self._pair(H[node][zi], U[node][zi],
                                       (0, 2))[0]

    def repair(self, lost_ext: int,
               helper_subchunks: dict[int, bytes]) -> bytes:
        """Rebuild chunk `lost_ext` from d helpers' repair sub-chunks
        (each helper contributes only the q^(t-1) repair planes —
        bandwidth d/(d-k+1) sub-chunks vs k*sub_chunk_no for a full
        decode).  Helpers must be every other node (no aloof nodes);
        otherwise use decode()."""
        lost, planes, H, U, er, out = self._repair_setup(
            lost_ext, helper_subchunks)
        plane_ind = {z: i for i, z in enumerate(planes)}
        dec = self._mds_decode_rows(er)
        for z in planes:
            self._repair_fill(z, plane_ind, er, H, U)
            # MDS-decode the lost row's uncoupled symbols
            self._decode_uncoupled(er, plane_ind[z], U, dec)
            self._repair_out(z, plane_ind, lost, H, U, out)
        return out.tobytes()

    async def repair_async(self, lost_ext: int,
                           helper_subchunks: dict[int, bytes],
                           klass: str | None = None,
                           on_ticket=None,
                           chip: int | None = None) -> bytes:
        """`repair` with the lost row's MDS decode batched across ALL
        repair planes as one device product on the codec's device --
        the bandwidth-optimal d/(d-k+1) repair read.  Same three-phase
        restructure as `_decode_layered_async` (pairwise fills -> one
        batched decode -> couple back out), bit-exact vs the host
        `repair`."""
        lost, planes, H, U, er, out = self._repair_setup(
            lost_ext, helper_subchunks)
        plane_ind = {z: i for i, z in enumerate(planes)}
        sc = out.shape[1]
        erased, chosen, rows = self._mds_decode_rows(er)
        for z in planes:
            self._repair_fill(z, plane_ind, er, H, U)
        if sc:
            data = np.concatenate(
                [np.stack([U[c][plane_ind[z]] for c in chosen])
                 for z in planes], axis=1)
            dec = await self._device_matmul(
                rows, 8, data, klass=klass, chip=chip,
                on_ticket=on_ticket)
            for pi, z in enumerate(planes):
                for idx, node in enumerate(erased):
                    U[node][plane_ind[z]] = \
                        dec[idx, pi * sc:(pi + 1) * sc]
        for z in planes:
            self._repair_out(z, plane_ind, lost, H, U, out)
        return out.tobytes()
