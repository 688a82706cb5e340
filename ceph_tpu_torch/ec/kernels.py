"""Erasure-code kernels: GF(2^w) region products on the card.

Every GF(2^w) multiply-by-constant is linear over GF(2), so an (m x k)
GF coding matrix expands to an (m*w x k*w) 0/1 bitmatrix
(matrices.matrix_to_bitmatrix), and encoding is

    parity_bits = (B @ data_bits) mod 2

Three hand-written CUDA kernels (``csrc/ec_kernels.cu``) compute it,
one for each layout the reference's Pallas kernels served:

* ``fused_xor`` (K1) — byte-layout chunks as uint32 lanes.
  ``FusedEncoder`` (w=8), the batcher's write, decode and delta path.
* ``bitplane_matmul`` (K2) — w-bit words (w = 8, 16, 32).
  ``DeviceEncoder``.
* ``xor_rows`` (K3) — rows of bytes; each output row is the XOR of
  the input rows its bitmatrix row selects.  ``BitmatrixEncoder`` (the
  jerasure bitmatrix techniques, rows of nw*packetsize bytes) and, as
  ``xor_schedule`` on 8-row blocks, the bit-sliced planes8 layout of
  ``PlanesEncoder``.  The card runs a sparse schedule of those rows
  (``XorSchedule``, built once per mask set;
  ``xor_schedule_sparse_plain`` runs it plainly).

A launch takes at most 256 input bits (K1/K2) or input rows (K3).  A
wider bitmatrix is packed a slice of 256 columns at a time
(``pack_slices``: (slices, rows, 8) masks), and the wrapper launches
once a slice, the launches after the first XORing their result into
the output in the kernel's epilogue; K1/K2 also launch once for each
group of at most 1024 output bitmatrix rows.  The plain versions take
the same sliced masks.

K1 and K2 are one kernel on the card, a GF(2) product on the tensor
cores: each column's input bits are gathered into 32-bit words
(``column_words_plain``), each output bit is the parity of a bitmatrix
row AND those words, and the parity bits are packed into output
elements (``parity_pack_plain``); ``gf2_product_plain`` chains the
three steps as the kernel does.

Each wrapper takes the kernel's plain PyTorch version only for tensors
that lie on the CPU; on a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts kernel launches by name.

Decode reuses the same kernels with the inverted matrix (host-side
inversion, cached by erasure signature like ErasureCodeIsaTableCache).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from .. import _build, default_device
from . import matrices

# launches of each CUDA kernel; a wrapper adds one where it launches its
# kernel and nowhere else (plain versions on the CPU do not count)
LAUNCHES = {"fused_xor": 0, "bitplane_matmul": 0, "xor_schedule": 0}

_MASK_WORDS = 8             # 256 input bits per packed bitmatrix row
_MAX_IN_BITS = 32 * _MASK_WORDS
_PRODUCT_ROWS = 1024        # bitmatrix rows per K1/K2 launch

_WORD_DTYPE = {8: torch.uint8, 16: torch.uint16, 32: torch.uint32}
# the element a permute copy moves, by its bytes
_LANE_DTYPE = {8: torch.int64, 4: torch.int32, 2: torch.int16,
               1: torch.uint8}


def _lane(packet: int, t: torch.Tensor):
    """(dtype, bytes) of the widest word that divides a packet of
    `packet` bytes and the alignment of t's data: a permute of whole
    packets copies words, not bytes."""
    e = 8
    while packet % e or t.data_ptr() % e:
        e //= 2
    return _LANE_DTYPE[e], e


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pack_slices(bitmatrix) -> np.ndarray:
    """(rows, cols) 0/1 bitmatrix -> its packed rows: ``pack_rows`` when
    cols <= 256, else (slices, rows, 8), slice s the rows' columns
    256s .. 256s + 255 (whole chunks for w = 8, 16 and 32)."""
    bm = np.asarray(bitmatrix, dtype=np.uint8)
    if bm.shape[1] <= _MAX_IN_BITS:
        return pack_rows(bm)
    return np.stack([pack_rows(bm[:, c:c + _MAX_IN_BITS])
                     for c in range(0, bm.shape[1], _MAX_IN_BITS)])


def _sliced(masks: torch.Tensor) -> torch.Tensor:
    """Packed masks as (slices, rows, 8)."""
    return masks if masks.dim() == 3 else masks[None]


def _xor_into(dst: torch.Tensor, src: torch.Tensor, accumulate: bool
              ) -> None:
    """dst = src, or dst ^= src (through signed views: the CPU has no
    XOR on uint16/uint32)."""
    if not accumulate:
        dst.copy_(src)
        return
    signed = {torch.uint8: torch.uint8, torch.uint16: torch.int16,
              torch.uint32: torch.int32}[dst.dtype]
    dst.view(signed).bitwise_xor_(src.view(signed))


def _plain_sliced(fn, data: torch.Tensor, masks: torch.Tensor, per: int,
                  *args) -> torch.Tensor:
    """A plain version over (slices, rows, 8) masks: the XOR of its
    result on each slice of `per` input rows."""
    out = None
    for s, mk in enumerate(_sliced(masks)):
        part = fn(data[s * per:(s + 1) * per], mk, *args)
        if out is None:
            out = part.clone()
        else:
            _xor_into(out, part, True)
    return out


def _slice_count(name: str, rows: int, per: int, masks: torch.Tensor
                 ) -> int:
    """The slices of `per` input rows that `rows` inputs fill; raises
    unless the masks have exactly that many."""
    slices = _sliced(masks).shape[0]
    if not (slices - 1) * per < rows <= slices * per:
        raise ValueError("%s: %d input rows do not fill %d mask slices "
                         "of %d" % (name, rows, slices, per))
    return slices


def pack_rows(bitmatrix) -> np.ndarray:
    """(rows, cols<=256) 0/1 bitmatrix -> (rows, 8) uint32 row masks:
    bit c of row r (word c // 32, bit c % 32) = bitmatrix[r][c]."""
    bm = np.asarray(bitmatrix, dtype=np.uint8)
    rows, cols = bm.shape
    if cols > _MAX_IN_BITS:
        raise ValueError("bitmatrix has %d columns; the kernels take at "
                         "most %d input bits" % (cols, _MAX_IN_BITS))
    full = np.zeros((rows, _MAX_IN_BITS), dtype=np.uint8)
    full[:, :cols] = bm != 0
    return np.packbits(full, axis=1, bitorder="little").view(np.uint32)


def _selected(masks: torch.Tensor, cols: int) -> list[list[int]]:
    """Input columns each packed row selects (host lists)."""
    packed = np.ascontiguousarray(masks.cpu().numpy()).view(np.uint8)
    bits = np.unpackbits(packed, axis=1, bitorder="little")[:, :cols]
    return [list(np.flatnonzero(r)) for r in bits]


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned words -> int64 values (CPU torch has no shifts on uint32)."""
    return x.to(torch.int64)


def _check(name: str, t: torch.Tensor, dtype, ndim: int = 2) -> None:
    if t.dtype != dtype:
        raise TypeError("%s: expected %s, got %s" % (name, dtype, t.dtype))
    if t.dim() != ndim:
        raise ValueError("%s: expected %d dims, got shape %s"
                         % (name, ndim, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s: tensor must be contiguous" % name)


def _check_masks(name: str, data: torch.Tensor, masks: torch.Tensor,
                 rows_multiple: int) -> None:
    """(rows, 8) packed rows, or (slices, rows, 8) (``pack_slices``)."""
    _check(name + " masks", masks, torch.uint32, masks.dim())
    if (masks.dim() not in (2, 3) or masks.shape[-1] != _MASK_WORDS
            or masks.shape[-2] % rows_multiple or not masks.shape[-2]):
        raise ValueError("%s: masks must be ([slices,] rows, %d) with "
                         "rows a multiple of %d, got %s" % (
                             name, _MASK_WORDS, rows_multiple,
                             tuple(masks.shape)))
    if masks.device != data.device:
        raise ValueError("%s: masks on %s, data on %s"
                         % (name, masks.device, data.device))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# 8x8 bit transpose (plain version of the kernels' butterfly)
# ---------------------------------------------------------------------------

_M4LO, _M4HI = 0x0F0F0F0F, 0xF0F0F0F0
_M2LO, _M2HI = 0x33333333, 0xCCCCCCCC
_M1LO, _M1HI = 0x55555555, 0xAAAAAAAA


def _bit_transpose8(v: list) -> list:
    """8x8 bit transpose across eight uint32 words held in int64 tensors
    (per byte slot): returns t with t[x] byte-bit s == v[s] byte-bit x.
    Involution."""
    w = [None] * 8
    for i in range(4):
        a, b = v[i], v[i + 4]
        w[i] = (a & _M4LO) | ((b & _M4LO) << 4)
        w[i + 4] = ((a >> 4) & _M4LO) | (b & _M4HI)
    u = [None] * 8
    for g in (0, 4):
        for i in (0, 1):
            a, b = w[g + i], w[g + i + 2]
            u[g + i] = (a & _M2LO) | ((b & _M2LO) << 2)
            u[g + i + 2] = ((a >> 2) & _M2LO) | (b & _M2HI)
    t = [None] * 8
    for g in (0, 2, 4, 6):
        a, b = u[g], u[g + 1]
        t[g] = (a & _M1LO) | ((b & _M1LO) << 1)
        t[g + 1] = ((a >> 1) & _M1LO) | (b & _M1HI)
    return t


# ---------------------------------------------------------------------------
# K1: fused byte-layout encode
# ---------------------------------------------------------------------------


def fused_xor_plain(data32: torch.Tensor, masks: torch.Tensor
                    ) -> torch.Tensor:
    """Plain version of K1: (k, P) uint32 lanes -> (rows/8, P) uint32,
    lanes grouped eight at a time exactly as the kernel groups them.
    Takes (rows, 8) masks or their (slices, rows, 8) slices."""
    if masks.dim() == 3:
        return _plain_sliced(fused_xor_plain, data32, masks,
                             _MAX_IN_BITS // 8)
    k, P = data32.shape
    rows = masks.shape[0]
    G = -(-P // 8)
    x = _u32(data32)
    if G * 8 != P:
        x = torch.nn.functional.pad(x, (0, G * 8 - P))
    x = x.reshape(k, G, 8)
    planes = _bit_transpose8([x[:, :, s] for s in range(8)])  # [x] (k, G)
    acc = []
    for sel in _selected(masks, k * 8):
        a = torch.zeros(G, dtype=torch.int64, device=data32.device)
        for c in sel:
            j, b = divmod(int(c), 8)
            a = a ^ planes[b][j]
        acc.append(a)
    outs = []
    for i in range(rows // 8):
        segs = _bit_transpose8(acc[8 * i:8 * i + 8])
        outs.append(torch.stack(segs, dim=1).reshape(G * 8)[:P])
    return torch.stack(outs).to(torch.uint32)


def _product(name: str, data: torch.Tensor, masks: torch.Tensor, w: int,
             out: torch.Tensor, plain, launch) -> torch.Tensor:
    """K1/K2's launches for one product into `out`: one for each slice
    of 256/w input rows and each group of 1024/w output rows, the
    slices after the first XORing into `out`.  On the CPU each is the
    plain version on the same slice and group.  launch(part, out_row,
    masks, rows, accumulate) returns the C entry's error code."""
    per = _MAX_IN_BITS // w
    _slice_count(name, data.shape[0], per, masks)
    m, group = out.shape[0], _PRODUCT_ROWS // w
    cpu = data.device.type == "cpu"
    with contextlib.ExitStack() as stack:
        if not cpu:
            stack.enter_context(torch.cuda.device(data.device))
        for s, sl in enumerate(_sliced(masks)):
            part = data[s * per:(s + 1) * per]
            for i0 in range(0, m, group):
                g = min(group, m - i0)
                mk = sl[w * i0:w * (i0 + g)]
                if cpu:
                    _xor_into(out[i0:i0 + g], plain(part, mk), s > 0)
                    continue
                _build.check(launch(part, out[i0], mk, g, int(s > 0)),
                             name)
                LAUNCHES[name] += 1
    return out


def fused_xor(data32: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: (k, P) uint32 byte-layout lanes and (m*8, 8) packed
    bitmatrix rows, or their (slices, m*8, 8) slices for k > 32 ->
    (m, P) uint32 parity lanes.  One launch for each slice of 32 data
    rows and each group of 128 output chunks."""
    _check("fused_xor", data32, torch.uint32)
    _check_masks("fused_xor", data32, masks, 8)
    k, P = data32.shape
    if P == 0:
        raise ValueError("fused_xor: k=%d, P=%d out of range" % (k, P))
    out = torch.empty((masks.shape[-2] // 8, P), dtype=torch.uint32,
                      device=data32.device)
    lib = None if data32.device.type == "cpu" else _build.library()

    def launch(part, orow, mk, g, acc):
        return lib.ec_fused_xor(part.data_ptr(), orow.data_ptr(),
                                mk.data_ptr(), part.shape[0], g, P, acc,
                                _stream(part))

    return _product("fused_xor", data32, masks, 8, out, fused_xor_plain,
                    launch)


# ---------------------------------------------------------------------------
# K2: bit-plane matmul over w-bit words
# ---------------------------------------------------------------------------


def bitplane_matmul_plain(data: torch.Tensor, masks: torch.Tensor,
                          w: int) -> torch.Tensor:
    """Plain version of K2: unpack k*w bit-planes, a float32 product of
    0/1 values (exact: sums <= 256 < 2^24), mod 2, pack.  Takes (rows,
    8) masks or their (slices, rows, 8) slices."""
    if masks.dim() == 3:
        return _plain_sliced(bitplane_matmul_plain, data, masks,
                             _MAX_IN_BITS // w, w)
    k, n = data.shape
    rows = masks.shape[0]
    dev = data.device
    x = _u32(data)
    shifts = torch.arange(w, device=dev, dtype=torch.int64)
    bits = ((x[:, None, :] >> shifts[None, :, None]) & 1).reshape(k * w, n)
    sel = _selected(masks, k * w)
    bm = torch.zeros((rows, k * w), dtype=torch.float32)
    for r, cols in enumerate(sel):
        bm[r, cols] = 1.0
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        acc = torch.matmul(bm.to(dev), bits.to(torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    par = acc.to(torch.int64).reshape(rows // w, w, n) & 1
    packed = (par << shifts[None, :, None]).sum(dim=1)
    return packed.to(data.dtype)


def bitplane_matmul(data: torch.Tensor, masks: torch.Tensor,
                    w: int) -> torch.Tensor:
    """K2 wrapper: (k, n) w-bit words and (m*w, 8) packed bitmatrix rows,
    or their (slices, m*w, 8) slices for k*w > 256 -> (m, n) words.
    One launch for each slice of 256/w data rows and each group of
    1024/w output rows."""
    if w not in _WORD_DTYPE:
        raise ValueError("bitplane_matmul: w=%d must be 8, 16 or 32" % w)
    _check("bitplane_matmul", data, _WORD_DTYPE[w])
    _check_masks("bitplane_matmul", data, masks, w)
    k, n = data.shape
    if n == 0:
        raise ValueError("bitplane_matmul: k=%d, w=%d, n=%d out of range"
                         % (k, w, n))
    out = torch.empty((masks.shape[-2] // w, n), dtype=data.dtype,
                      device=data.device)
    lib = None if data.device.type == "cpu" else _build.library()

    def launch(part, orow, mk, g, acc):
        return lib.ec_bitplane_matmul(part.data_ptr(), orow.data_ptr(),
                                      mk.data_ptr(), part.shape[0], g, w,
                                      n, acc, _stream(part))

    return _product("bitplane_matmul", data, masks, w, out,
                    functools.partial(bitplane_matmul_plain, w=w), launch)


# ---------------------------------------------------------------------------
# K1/K2 on the card: the steps of the tensor-core GF(2) product
# ---------------------------------------------------------------------------


def _byte_perm(x, y, sel: int):
    """CUDA's __byte_perm(x, y, sel) on int64 tensors of uint32 values:
    result byte i is byte (sel >> 4i) & 7 of the eight bytes y:x."""
    out = torch.zeros_like(x)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        src = x if b < 4 else y
        out = out | (((src >> (8 * (b & 3))) & 0xFF) << (8 * i))
    return out


def _transpose4x4(x: list) -> list:
    """The kernel's 4x4 byte transpose: out[c] byte r == x[r] byte c."""
    t0 = _byte_perm(x[0], x[1], 0x5140)
    t1 = _byte_perm(x[0], x[1], 0x7362)
    t2 = _byte_perm(x[2], x[3], 0x5140)
    t3 = _byte_perm(x[2], x[3], 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def column_words_plain(data: torch.Tensor, w: int) -> torch.Tensor:
    """(k, n) w-bit elements -> (slots, n) int64 column words, slots =
    ceil(k*w / 32): word s of column c holds bits 32s..32s+31 of the
    column's k*w input bits, bit j*w + x = bit x of element (j, c).

    As the kernel builds them: each 32-bit slot covers 32/w input rows;
    16 bytes of each (four uint32 words) become one word per column by
    a 4x4 byte transpose (w=8), half-word permutes (w=16) or as loaded
    (w=32)."""
    k, n = data.shape
    per = 128 // w                       # columns in 16 bytes
    nb = -(-n // per)
    x = _u32(data)
    if nb * per != n:
        x = torch.nn.functional.pad(x, (0, nb * per - n))
    lanes = 32 // w                      # elements in a uint32 word
    sh = torch.arange(lanes, dtype=torch.int64) * w
    # (k, nb, 4) uint32 words of each 16-byte block, little-endian
    words = (x.reshape(k, nb, 4, lanes) << sh).sum(dim=3)
    rows = 32 // w                       # input rows in one slot
    slots = -(-k * w // 32)
    zero = torch.zeros_like(words[0])
    out = []
    for s in range(slots):
        v = [words[j] if j < k else zero
             for j in range(s * rows, (s + 1) * rows)]
        cols = [None] * per
        for q in range(4):
            if w == 8:
                for c, word in enumerate(_transpose4x4(
                        [v[r][:, q] for r in range(4)])):
                    cols[4 * q + c] = word
            elif w == 16:
                cols[2 * q] = _byte_perm(v[0][:, q], v[1][:, q], 0x5410)
                cols[2 * q + 1] = _byte_perm(v[0][:, q], v[1][:, q],
                                             0x7632)
            else:
                cols[q] = v[0][:, q]
        out.append(torch.stack(cols, dim=1).reshape(nb * per)[:n])
    return torch.stack(out)


def parity_pack_plain(counts: torch.Tensor, w: int) -> torch.Tensor:
    """(m*w, n) popcounts -> (m, n) int64 elements: bit y of element
    (i, c) is the parity of counts[i*w + y, c].

    As the kernel packs them: a thread holds the counts of rows 2t and
    2t+1 of each output byte; each is masked to its parity bit, the
    pair merged (row 2t+1 times 2 plus row 2t), shifted to bits 2t and
    2t+1 (times mul0) and the four threads' words are ORed."""
    rows, n = counts.shape
    out = torch.zeros((rows // 8, n), dtype=torch.int64)
    for t in range(4):
        mul0 = 1 << (2 * t)
        out = out | (((counts[2 * t + 1::8] & 1) * 2
                      + (counts[2 * t::8] & 1)) * mul0)
    nbytes = w // 8
    out = out.reshape(rows // w, nbytes, n)
    return sum(out[:, b] << (8 * b) for b in range(nbytes))


def gf2_product_plain(data: torch.Tensor, masks: torch.Tensor,
                      w: int) -> torch.Tensor:
    """The card's K1/K2 product in its three steps: column words,
    popc(row & column) over the slots, parity pack.  (k, n) w-bit
    elements and (m*w, 8) packed rows -> (m, n) elements of data's
    dtype."""
    cols = column_words_plain(data, w)              # (slots, n)
    mk = _u32(masks)[:, :cols.shape[0]]             # (rows, slots)
    both = mk[:, :, None] & cols[None]              # (rows, slots, n)
    counts = torch.zeros(both.shape[0], both.shape[2], dtype=torch.int64)
    for bit in range(32):
        counts += ((both >> bit) & 1).sum(dim=1)
    return parity_pack_plain(counts, w).to(data.dtype)


# ---------------------------------------------------------------------------
# K3: XOR schedule over rows of bytes (the planes8 layout is 8-row blocks)
# ---------------------------------------------------------------------------


def xor_rows_plain(rows: torch.Tensor, masks: torch.Tensor
                   ) -> torch.Tensor:
    """Plain version of K3's row view: (in_rows, B) uint8 and
    (out_rows, 8) packed rows, or their (slices, out_rows, 8) slices ->
    (out_rows, B) uint8."""
    if masks.dim() == 3:
        return _plain_sliced(xor_rows_plain, rows, masks, _MAX_IN_BITS)
    out = torch.zeros((masks.shape[0], rows.shape[1]), dtype=torch.uint8,
                      device=rows.device)
    for r, sel in enumerate(_selected(masks, rows.shape[0])):
        for b in sel:
            out[r] ^= rows[int(b)]
    return out


def xor_schedule_plain(planes: torch.Tensor, masks: torch.Tensor
                       ) -> torch.Tensor:
    """Plain version of K3: (in_rows*8, P) uint8 -> (rows*8, P) uint8."""
    R, P = planes.shape
    out = xor_rows_plain(planes.reshape(R // 8, 8 * P), masks)
    return out.reshape(out.shape[0] * 8, P)


def xor_schedule_table(packed: np.ndarray, in_rows: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(out_rows, 8) packed bitmatrix rows -> K3's sparse schedule:
    (spans, idx), spans (out_rows, 2) int32 and idx uint8.  Output row r
    XORs the input blocks idx[start:start + count], (start, count) =
    spans[r]; each row's list starts on a multiple of 4 (the kernel reads
    four indices a load) and the gaps and a 4-byte tail are zeros."""
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    bits = np.unpackbits(packed.view(np.uint8), axis=1,
                         bitorder="little")[:, :in_rows]
    spans = np.zeros((bits.shape[0], 2), dtype=np.int32)
    lists, pos = [], 0
    for r, row in enumerate(bits):
        src = np.flatnonzero(row).astype(np.uint8)
        spans[r] = (pos, src.size)
        lists += [src, np.zeros(-src.size % 4, dtype=np.uint8)]
        pos += src.size + (-src.size % 4)
    return spans, np.concatenate(lists + [np.zeros(4, dtype=np.uint8)])


class XorSchedule:
    """K3's packed bitmatrix rows (``masks``, one slice or
    ``pack_slices``' slices) and their sparse schedules
    (``xor_schedule_table``) on one device, built once on the host:
    ``parts`` holds (first input row, input rows, spans, idx) for each
    slice of at most 256 input rows, ``spans`` / ``idx`` the first
    slice's.  ``pop`` is the XORs of input rows it takes, the
    bitmatrix's popcount.  The schedule is only ever read beside the
    masks it was built from."""

    def __init__(self, masks, in_rows: int, device=None):
        if isinstance(masks, torch.Tensor):
            device = masks.device if device is None else device
            host = masks.cpu().numpy()
        else:
            host = np.ascontiguousarray(masks, dtype=np.uint32)
            masks = torch.from_numpy(host)
        device = torch.device("cpu") if device is None else device
        sliced = host if host.ndim == 3 else host[None]
        self.in_rows = in_rows
        self.out_rows = sliced.shape[1]
        self.masks = masks.to(device)
        self.parts = []
        self.pop = 0
        for s, packed in enumerate(sliced):
            row0 = s * _MAX_IN_BITS
            rows = min(_MAX_IN_BITS, in_rows - row0)
            spans, idx = xor_schedule_table(packed, rows)
            self.pop += int(spans[:, 1].sum())
            self.parts.append((row0, rows, torch.from_numpy(spans).to(device),
                               torch.from_numpy(idx).to(device)))
        self.spans, self.idx = self.parts[0][2], self.parts[0][3]


def xor_schedule_sparse_plain(planes: torch.Tensor, schedule: XorSchedule
                              ) -> torch.Tensor:
    """K3's sparse schedule run plainly: output block r is the XOR of
    the input blocks idx[start:start + count], (start, count) =
    spans[r], read from the schedule's tensors as the kernel reads them
    (each slice's indices counted from its first row).
    (in_rows*8, P) uint8 -> (out_rows*8, P) uint8."""
    R, P = planes.shape
    blocks = planes.reshape(R // 8, 8 * P)
    out = torch.zeros((schedule.out_rows, 8 * P), dtype=torch.uint8,
                      device=planes.device)
    for row0, _rows, spans, idx in schedule.parts:
        idx = idx.cpu().tolist()
        for r, (start, count) in enumerate(spans.cpu().tolist()):
            for b in idx[start:start + count]:
                out[r] ^= blocks[row0 + b]
    return out.reshape(schedule.out_rows * 8, P)


def xor_rows(rows: torch.Tensor, masks) -> torch.Tensor:
    """K3 wrapper, the row view: (in_rows, B) uint8 rows of any B >= 1
    bytes and (out_rows, 8) packed bitmatrix rows over in_rows columns,
    or their (slices, out_rows, 8) slices for in_rows > 256 ->
    (out_rows, B).  One launch a slice of 256 input rows, every output
    row in each.  `masks` is the rows' tensor, or the XorSchedule of
    them that an encoder builds once; given bare rows, the card path
    builds the schedule from a host copy of them."""
    schedule = masks if isinstance(masks, XorSchedule) else None
    if schedule is not None:
        masks = schedule.masks
    _check("xor_rows", rows, torch.uint8)
    _check_masks("xor_rows", rows, masks, 1)
    in_rows, B = rows.shape
    if B == 0:
        raise ValueError("xor_rows: rows shape %s out of range"
                         % (tuple(rows.shape),))
    slices = _slice_count("xor_rows", in_rows, _MAX_IN_BITS, masks)
    out_rows = masks.shape[-2]
    out = torch.empty((out_rows, B), dtype=torch.uint8, device=rows.device)
    if rows.device.type == "cpu":
        for s, mk in enumerate(_sliced(masks)):
            part = rows[s * _MAX_IN_BITS:(s + 1) * _MAX_IN_BITS]
            _xor_into(out, xor_rows_plain(part, mk), s > 0)
        return out
    lib = _build.library()
    if schedule is None:
        schedule = XorSchedule(masks, in_rows)
    if schedule.in_rows != in_rows or len(schedule.parts) != slices:
        raise ValueError("xor_rows: schedule for %d input rows, rows %s"
                         % (schedule.in_rows, tuple(rows.shape)))
    with torch.cuda.device(rows.device):
        for s, (row0, n, spans, idx) in enumerate(schedule.parts):
            err = lib.ec_xor_schedule(
                rows[row0].data_ptr(), out.data_ptr(), spans.data_ptr(),
                idx.data_ptr(), n, out_rows, B, int(s > 0), _stream(rows))
            _build.check(err, "xor_schedule")
            LAUNCHES["xor_schedule"] += 1
    return out


def xor_schedule(planes: torch.Tensor, masks) -> torch.Tensor:
    """K3 on the planes8 layout: (in_rows*8, P) uint8 planes and
    (out_rows, 8) packed bitmatrix rows over in_rows columns (or their
    slices, or their XorSchedule) -> (out_rows*8, P); ``xor_rows`` on
    8-row blocks of 8*P bytes."""
    _check("xor_schedule", planes, torch.uint8)
    R, P = planes.shape
    if R % 8 or P == 0:
        raise ValueError("xor_schedule: planes shape %s out of range"
                         % (tuple(planes.shape),))
    out = xor_rows(planes.view(R // 8, 8 * P), masks)
    return out.view(out.shape[0] * 8, P)


# ---------------------------------------------------------------------------
# planes8 layout converters (host)
# ---------------------------------------------------------------------------
#
# planes8 layout of one chunk of L bytes (w=8): bit-plane x (bit x of every
# data byte) is packed little-endian into L/8 bytes and laid out as 8 rows
# of L/64 columns; a chunk is a (64, L/64) uint8 array, a k-chunk stripe
# batch is (k*64, P) with P = total columns.


def bytes_to_planes8(chunks: np.ndarray) -> np.ndarray:
    """(k, L) uint8 byte-layout chunks -> (k*64, L//64) planes8."""
    k, L = chunks.shape
    bits = np.unpackbits(chunks.reshape(k, L, 1), axis=2, bitorder="little")
    planes = []
    for j in range(k):
        for x in range(8):
            pb = np.packbits(bits[j, :, x], bitorder="little")  # (L/8,)
            planes.append(pb.reshape(8, L // 64))
    return np.concatenate(planes, axis=0)


def planes8_to_bytes(planes: np.ndarray, nchunks: int) -> np.ndarray:
    """(nchunks*64, P) planes8 -> (nchunks, P*64) byte-layout chunks."""
    rows, P = planes.shape
    L = P * 64
    out = np.zeros((nchunks, L), dtype=np.uint8)
    for j in range(nchunks):
        byte_bits = np.zeros((L, 8), dtype=np.uint8)
        for x in range(8):
            pb = planes[j * 64 + x * 8:(j * 64) + (x + 1) * 8].reshape(L // 8)
            byte_bits[:, x] = np.unpackbits(pb, bitorder="little")
        out[j] = np.packbits(byte_bits, axis=1, bitorder="little").reshape(L)
    return out


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------


def reconstruction(matrix: list[list[int]], k: int, w: int,
                   erased: tuple[int, ...], survivors: tuple[int, ...]):
    """(rows, chosen): GF rows that rebuild `erased` chunks from the
    `chosen` first k usable survivors — invert the surviving rows,
    compose parity rows through the inverse (the decode-as-encode
    reformulation the encoders and the batcher share)."""
    inv, chosen = matrices.decoding_matrix(
        k, w, matrix, list(erased), list(survivors))
    rows = []
    for e in erased:
        if e < k:
            rows.append(list(inv[e]))
        else:
            coeff = matrix[e - k]
            rows.append([
                functools.reduce(
                    lambda a, t: a ^ t,
                    (matrices.gf_mul(coeff[j], inv[j][i], w)
                     for j in range(k)), 0)
                for i in range(k)])
    return rows, chosen


def _reconstruction_rows(matrix: list[list[int]], k: int, w: int,
                         erased: tuple[int, ...],
                         survivors: tuple[int, ...]) -> list[list[int]]:
    """The rows of `reconstruction`."""
    return reconstruction(matrix, k, w, erased, survivors)[0]


class _Encoder:
    """Coding matrix, its bitmatrix and the packed rows on one device."""

    def __init__(self, matrix: list[list[int]], w: int, device=None):
        self.device = default_device(device)
        self.m = len(matrix)
        self.k = len(matrix[0])
        self.w = w
        self.matrix = matrix
        self.bitmatrix = np.array(
            matrices.matrix_to_bitmatrix(self.k, self.m, w, matrix),
            dtype=np.int8)
        self._masks = torch.from_numpy(pack_slices(self.bitmatrix)).to(
            self.device)
        self._decoders: dict[tuple, "_Encoder"] = {}
        self._shapes: set[tuple] = set()    # input shapes run

    @property
    def program_count(self) -> int:
        """Distinct input shapes this encoder has run.  One compiled
        kernel serves them all on the card; the count stays the
        encoder-side figure the runtime's note_program bookkeeping is
        compared with."""
        return len(self._shapes)

    def decoder_for(self, erased: tuple[int, ...],
                    survivors: tuple[int, ...]):
        """Reconstruction rows through the same kernel: rows = erased
        chunk ids, inputs = the first k survivors.  Cached per erasure
        signature, like ErasureCodeIsaTableCache."""
        key = (erased, survivors[:self.k])
        dec = self._decoders.get(key)
        if dec is None:
            rows = _reconstruction_rows(self.matrix, self.k, self.w,
                                        erased, survivors)
            dec = self._with_rows(rows)
            self._decoders[key] = dec
        return dec

    def _with_rows(self, rows) -> "_Encoder":
        """An encoder of the same kind for other coding rows."""
        raise NotImplementedError


class FusedEncoder(_Encoder):
    """Byte-layout encode/reconstruct (w=8 only), kernel K1.

    `data` is (k, n) uint8 in ordinary byte layout; returns (m, n)
    parity bytes, bit-identical to the host codecs.  run32 is the
    device-resident entry point on (k, n//4) uint32 views (the same
    bytes, little-endian lanes).  The kernel masks the ragged edge, so
    any width runs without padding."""

    def __init__(self, matrix: list[list[int]], device=None):
        super().__init__(matrix, 8, device)

    def _with_rows(self, rows):
        return FusedEncoder(rows, self.device)

    def run32(self, data32: torch.Tensor) -> torch.Tensor:
        """(k, P) uint32 -> (m, P) uint32, device-resident."""
        self._shapes.add(tuple(data32.shape))
        return fused_xor(data32, self._masks)

    def __call__(self, data: np.ndarray) -> np.ndarray:
        k, n = data.shape
        pad = (-n) % 4
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if pad:
            data = np.pad(data, ((0, 0), (0, pad)))
        d32 = torch.from_numpy(data.view(np.uint32)).to(self.device)
        out8 = self.run32(d32).cpu().numpy().view(np.uint8)
        return out8[:, :n] if pad else out8


class DeviceEncoder(_Encoder):
    """Encode (and decode) for one (matrix, w), kernel K2.  `data` is a
    (k, n) tensor of w-bit words (uint8/uint16/uint32) on the encoder's
    device; n is the flattened batch of all in-flight stripes."""

    def __init__(self, matrix: list[list[int]], w: int = 8, device=None):
        super().__init__(matrix, w, device)

    def _with_rows(self, rows):
        return DeviceEncoder(rows, self.w, self.device)

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        self._shapes.add(tuple(data.shape))
        return bitplane_matmul(data, self._masks, self.w)

    def encode_batch(self, stripes: np.ndarray) -> torch.Tensor:
        """(batch, k, chunk_words) -> (batch, m, chunk_words)."""
        b, k, c = stripes.shape
        flat = torch.from_numpy(np.ascontiguousarray(
            stripes.transpose(1, 0, 2).reshape(k, b * c))).to(self.device)
        out = self(flat)
        return out.reshape(self.m, b, c).permute(1, 0, 2)


class PlanesEncoder(_Encoder):
    """Encode/decode on the planes8 layout (w=8), kernel K3.

    `planes` is (k*64, P) uint8; returns (m*64, P).  Batch many stripes
    by concatenating their chunk planes along the column axis."""

    def __init__(self, matrix: list[list[int]], device=None):
        super().__init__(matrix, 8, device)
        self._schedule = XorSchedule(self._masks, self.k * 8)
        self._row_fns: dict[tuple, object] = {}   # decode_rows cache

    def _with_rows(self, rows):
        return PlanesEncoder(rows, self.device)

    def __call__(self, planes: torch.Tensor) -> torch.Tensor:
        self._shapes.add(tuple(planes.shape))
        return xor_schedule(planes, self._schedule)

    def encode_stripes(self, stripes: np.ndarray) -> np.ndarray:
        """(batch, k, chunk_bytes) byte-layout -> (batch, m, chunk_bytes);
        convenience wrapper that converts layouts on the host."""
        b, k, c = stripes.shape
        if (b * c) % 64:
            raise ValueError(
                "batch*chunk_bytes=%d must be a multiple of 64 for the "
                "planes8 layout" % (b * c))
        planes = bytes_to_planes8(
            np.ascontiguousarray(stripes.transpose(1, 0, 2)).reshape(
                k, b * c))
        out = self(torch.from_numpy(planes).to(self.device)).cpu().numpy()
        parity = planes8_to_bytes(out, self.m)   # (m, b*c)
        return parity.reshape(self.m, b, c).transpose(1, 0, 2)

    def decode_rows(self, erased: tuple[int, ...],
                    survivors: tuple[int, ...]):
        """planes8 reconstruction of `erased` from the first k of
        `survivors` (bit-level inversion, cached per signature): returns
        a function (k*64, P) -> (len(erased)*64, P)."""
        key = (erased, survivors[:self.k])
        fn = self._row_fns.get(key)
        if fn is None:
            want = bitmatrix_reconstruction(self.bitmatrix, self.k, self.w,
                                            erased, survivors)
            fn = functools.partial(xor_schedule, masks=XorSchedule(
                pack_slices(want), self.k * self.w, self.device))
            self._row_fns[key] = fn
        return fn


def bitmatrix_reconstruction(bitmatrix, k: int, w: int,
                             erased: tuple[int, ...],
                             survivors: tuple[int, ...]) -> np.ndarray:
    """(len(erased)*w, k*w) int8 bitmatrix rows that rebuild the
    `erased` chunks from the bit-rows of the first k `survivors` (in
    that order): the survivors' generator rows inverted over GF(2) (data
    chunks), or a parity chunk's rows composed through that inverse —
    the reference's bitmatrix decode (decode_chunks), as one product."""
    bm = np.asarray(bitmatrix, dtype=np.int8)
    rows = matrices.survivor_bitrows(k, w, bm, survivors)
    inv = np.array(matrices.gf2_invert(rows), dtype=np.int8)
    want = []
    for e in erased:
        if e < k:
            want.append(inv[e * w:(e + 1) * w])
        else:
            # parity rows re-encoded through the inverse
            comp = (bm[(e - k) * w:(e - k + 1) * w].astype(np.int32)
                    @ inv.astype(np.int32)) & 1
            want.append(comp.astype(np.int8))
    return np.concatenate(want)


class BitmatrixEncoder:
    """One (m*w x k*w) 0/1 bitmatrix over rows of bytes, kernel K3's row
    view: the jerasure bitmatrix techniques (cauchy_orig, cauchy_good,
    liberation, blaum_roth, liber8tion).

    A chunk is nw windows of w packets of packetsize bytes; bit-row l of
    chunk j is packet l of every window, so the product's input is
    (k*w, nw*packetsize) rows and its output (m*w, nw*packetsize).
    XOR is position-wise, so objects batch by concatenating their
    windows.  ``run_windows`` takes the chunks as windows and permutes
    them to rows and back on the tensor's device."""

    def __init__(self, bitmatrix, w: int, device=None):
        self.device = default_device(device)
        self.bitmatrix = np.array(bitmatrix, dtype=np.int8)
        self.w = w
        rows, cols = self.bitmatrix.shape
        if rows % w or cols % w:
            raise ValueError("bitmatrix %s is not in w=%d blocks"
                             % ((rows, cols), w))
        self.k, self.m = cols // w, rows // w
        self._schedule = XorSchedule(pack_slices(self.bitmatrix), cols,
                                     self.device)
        self._decoders: dict[tuple, "BitmatrixEncoder"] = {}
        self._shapes: set[tuple] = set()

    @property
    def program_count(self) -> int:
        return len(self._shapes)

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        """(k*w, N) uint8 bit-rows -> (m*w, N), device-resident."""
        self._shapes.add(tuple(rows.shape))
        return xor_rows(rows, self._schedule)

    def run_windows(self, windows: torch.Tensor) -> torch.Tensor:
        """(k, nw, w*packetsize) uint8 chunk windows -> (m, nw,
        w*packetsize): permuted to bit-rows, K3, and permuted back."""
        return self.to_windows(self(self.to_rows(windows)),
                               windows.shape[1])

    def to_rows(self, windows: torch.Tensor) -> torch.Tensor:
        """(c, nw, w*packetsize) chunk windows -> (c*w, nw*packetsize)
        bit-rows, a copy on the tensor's device."""
        c, nw, width = windows.shape
        ps = width // self.w
        lane, e = _lane(ps, windows)
        rows = windows.view(lane).view(c, nw, self.w, ps // e).permute(
            0, 2, 1, 3).contiguous()
        return rows.view(torch.uint8).view(c * self.w, nw * ps)

    def to_windows(self, rows: torch.Tensor, nw: int) -> torch.Tensor:
        """``to_rows`` undone: (c*w, nw*packetsize) -> (c, nw,
        w*packetsize), a copy on the tensor's device."""
        c, ps = rows.shape[0] // self.w, rows.shape[1] // nw
        lane, e = _lane(ps, rows)
        back = rows.view(lane).view(c, self.w, nw, ps // e).permute(
            0, 2, 1, 3).contiguous()
        return back.view(torch.uint8).view(c, nw, self.w * ps)

    def decode_rows(self, erased: tuple[int, ...],
                    survivors: tuple[int, ...]) -> "BitmatrixEncoder":
        """The encoder that rebuilds `erased` from the first k of
        `survivors` (``bitmatrix_reconstruction``), cached per
        signature: its input is the survivors' (k*w, N) rows in that
        order, its output (len(erased)*w, N)."""
        key = (tuple(erased), tuple(survivors[:self.k]))
        dec = self._decoders.get(key)
        if dec is None:
            dec = BitmatrixEncoder(bitmatrix_reconstruction(
                self.bitmatrix, self.k, self.w, *key), self.w, self.device)
            self._decoders[key] = dec
        return dec


@functools.lru_cache(maxsize=64)
def encoder_for_profile(plugin: str, technique: str, k: int, m: int,
                        w: int = 8, device=None) -> DeviceEncoder:
    """Device encoder (K2) for the common matrix-backed profiles."""
    if plugin == "isa":
        mat = (matrices.isa_rs_vandermonde_matrix(k, m)
               if technique == "reed_sol_van"
               else matrices.isa_cauchy_matrix(k, m))
        return DeviceEncoder(mat, 8, device)
    if technique == "reed_sol_van":
        mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, w)
    elif technique == "reed_sol_r6_op":
        mat = matrices.reed_sol_r6_coding_matrix(k, w)
    elif technique == "cauchy_orig":
        mat = matrices.cauchy_original_coding_matrix(k, m, w)
    elif technique == "cauchy_good":
        mat = matrices.cauchy_good_general_coding_matrix(k, m, w)
    else:
        raise ValueError("no device path for technique %r" % technique)
    return DeviceEncoder(mat, w, device)


_KINDS = {"FusedEncoder": FusedEncoder, "DeviceEncoder": DeviceEncoder,
          "PlanesEncoder": PlanesEncoder}


def load_reference_state(state: dict, device=None) -> _Encoder:
    """The port's encoder for the state a reference encoder holds.

    `state` carries numpy arrays: ``matrix`` (m, k), ``bitmatrix``
    (m*w, k*w) int8 and ``w``; ``kind`` names the encoder class
    (FusedEncoder, DeviceEncoder or PlanesEncoder; default FusedEncoder
    for w=8, else DeviceEncoder).  The port builds its own bitmatrix
    from the matrix and raises ValueError if it differs from the one
    given."""
    w = int(np.asarray(state["w"]))
    matrix = [[int(c) for c in row] for row in np.asarray(state["matrix"])]
    kind = str(state.get("kind",
                         "FusedEncoder" if w == 8 else "DeviceEncoder"))
    if kind not in _KINDS:
        raise ValueError("unknown encoder kind %r" % kind)
    if kind != "DeviceEncoder" and w != 8:
        raise ValueError("%s is w=8 only, state has w=%d" % (kind, w))
    enc = (DeviceEncoder(matrix, w, device) if kind == "DeviceEncoder"
           else _KINDS[kind](matrix, device))
    given = np.asarray(state["bitmatrix"], dtype=np.int8)
    if not np.array_equal(given, enc.bitmatrix):
        raise ValueError("reference bitmatrix differs from the port's "
                         "for the same matrix and w=%d" % w)
    return enc
