"""CRUSH kernels: the straw2 descent, the post-CRUSH filter, the remap
hit scan and the row-group compaction, on the card.

Four hand-written CUDA kernels (``csrc/crush_kernels.cu``) carry the
bulk mapper (``ops.crush.device``):

* ``descend`` (K4) — the whole multi-level straw2 descent of one lane:
  rjenkins ``hash32_3``, the table ``crush_ln``, the exact draw
  ``trunc((crush_ln(u) - 2^48) / w)`` in 64-bit integers (the host
  engine's arithmetic, ``host.py:_exponential_draw``), winner select
  (first index of the strictly greatest draw; a zero weight draws
  S64_MIN) and the walk down child buckets until an item of the wanted
  type.
* ``post`` (K5) — the up-filter against exists&up, the stable
  compaction of replicated rows and the primary (first survivor).
* ``hitscan`` (K6) — which lanes' raw rows hold an OSD of a changed set.
* ``rowcompact`` (K7) — per group of ``row`` lanes, the indices of the
  hit lanes in ascending order in ``kt`` slots.

Every kernel has a plain PyTorch version beside it (``*_plain``).  A
wrapper takes the plain version only for tensors that lie on the CPU;
on a CUDA tensor it launches the kernel or raises, whatever the lane
count or map size.  ``LAUNCHES`` counts kernel launches by name.

CRUSH values are unsigned 32-bit in the reference; here they are held
in int64 (hash inputs and seeds, weights) or int32 (items, rows), and
the hash runs in int64 masked to 32 bits: CPU torch has no shifts or
arithmetic on uint32, its int32 ``>>`` is arithmetic, and CUDA torch has
no reductions on uint32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import _build
from ._ln_tables import LL_TBL, RH_LH_TBL

# launches of each CUDA kernel; a wrapper adds one where it launches its
# kernel and nowhere else (plain versions on the CPU do not count)
LAUNCHES = {"descend": 0, "post": 0, "hitscan": 0, "rowcompact": 0}

ITEM_NONE = 0x7FFFFFFF
S64_MIN = -(1 << 63)
LN_ONE = 1 << 48          # crush_ln(0xFFFF), the draw's offset
M32 = 0xFFFFFFFF
HASH_SEED = 1315423911

# status bits of descend (the reference kernel's ok=1 | perm=2; its
# uncertainty bit 4 has no counterpart: the draw here is exact)
ST_OK = 1
ST_PERM = 2


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# rjenkins and crush_ln on int64 tensors
# ---------------------------------------------------------------------------


def _mix(a, b, c):
    """rjenkins1 mix on int64 tensors that hold values congruent mod
    2^32 to the u32 words: +, -, ^ and << keep the low 32 bits right
    whatever lies above them, so only a right shift needs its operand
    masked to the true word first."""
    a = (a - b - c) ^ ((c & M32) >> 13)
    b = (b - c - a) ^ (a << 8)
    c = (c - a - b) ^ ((b & M32) >> 13)
    a = (a - b - c) ^ ((c & M32) >> 12)
    b = (b - c - a) ^ (a << 16)
    c = (c - a - b) ^ ((b & M32) >> 5)
    a = (a - b - c) ^ ((c & M32) >> 3)
    b = (b - c - a) ^ (a << 10)
    c = (c - a - b) ^ ((b & M32) >> 15)
    return a, b, c


def hash32_3(a, b, c):
    """crush_hash32_3 over int64 tensors holding u32 values."""
    h = (a ^ b ^ c) ^ HASH_SEED
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h & M32


def hash32_2(a, b):
    """crush_hash32_2 over int64 tensors holding u32 values."""
    a, b = torch.broadcast_tensors(a, b)
    h = (a ^ b) ^ HASH_SEED
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h & M32


# RH_LH_TBL (129 reciprocal/log pairs) then LL_TBL (256): the layout the
# kernel copies into shared memory
_LN_NP = np.array(list(RH_LH_TBL) + list(LL_TBL), dtype=np.int64)
_RH_NP = _LN_NP[0:258:2]
_LH_NP = _LN_NP[1:258:2]
_LL_NP = _LN_NP[258:]


@functools.lru_cache(maxsize=None)
def _ln_tensors(device: torch.device):
    dev = torch.device(device)
    return (torch.from_numpy(_LN_NP).to(dev),
            torch.from_numpy(_RH_NP).to(dev),
            torch.from_numpy(_LH_NP).to(dev),
            torch.from_numpy(_LL_NP).to(dev))


def crush_ln(u: torch.Tensor) -> torch.Tensor:
    """2^44 * log2(u + 1) in fixed point (mapper.c:226-268, host.py
    crush_ln) for int64 u in [0, 0xFFFF].  The product x * rh may pass
    2^63 and wrap in int64; bits 48..55, which are all it keeps (& 0xFF
    after >> 48), are those of the unsigned 64-bit product."""
    _all, rh_t, lh_t, ll_t = _ln_tensors(u.device)
    x = u + 1
    # bit length: x = m * 2^e with 0.5 <= m < 1 exactly (x < 2^53)
    bl = torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)
    need = (x & 0x18000) == 0
    bits = (16 - bl).clamp(min=0)
    x2 = torch.where(need, x << bits, x)
    iexpon = torch.where(need, 15 - bits, torch.full_like(bits, 15))
    p = (x2 >> 8) - 128                      # pair index in [0, 128]
    rh = rh_t[p]
    lh = lh_t[p]
    index2 = ((x2 * rh) >> 48) & 0xFF
    lh = (lh + ll_t[index2]) >> 4
    return (iexpon << 44) + lh


def div_s64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C's truncating signed division (host.py _div_s64); torch's `//`
    floors, which differs for the negative draws."""
    return torch.div(a, b, rounding_mode="trunc")


def bitmask(flags: torch.Tensor) -> torch.Tensor:
    """bool [D] -> int32 [ceil(D/32)] words, bit d % 32 of word d // 32."""
    D = flags.shape[0]
    W = max(1, -(-D // 32))
    f = torch.zeros(W * 32, dtype=torch.int64, device=flags.device)
    f[:D] = flags.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=flags.device)
    words = (f.view(W, 32) << shifts).sum(dim=1)
    return torch.where(words >= (1 << 31), words - (1 << 32),
                       words).to(torch.int32)


# ---------------------------------------------------------------------------
# flat bucket tables (what K4 reads)
# ---------------------------------------------------------------------------


class CrushTables:
    """A straw2 map flattened for the descent, on one device.  Bucket
    index bid = -1 - bucket id.

    items, ids [B, S] int32 (ids are the hash ids: the items, or the
    choose_args id overrides); weights [n_pos, B, S] int64 16.16 weights
    (masked to 32 bits), one row set per choose_args weight-set position
    (row min(position, n_pos - 1)); size, btype [B] int32."""

    def __init__(self, items, ids, weights, size, btype,
                 max_devices: int, device):
        dev = torch.device(device)

        def put(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                dtype=dt).to(dev).contiguous()

        self.device = dev
        self.items = put(items, torch.int32)
        self.ids = put(ids, torch.int32)
        self.weights = put(np.asarray(weights, np.int64) & M32,
                           torch.int64)
        self.size = put(size, torch.int32)
        self.btype = put(btype, torch.int32)
        self.n_pos, self.B, self.S = (int(v) for v in self.weights.shape)
        self.max_devices = int(max_devices)
        self._levels: dict[tuple, torch.Tensor] = {}

    def check_levels(self, depth_sizes: tuple) -> None:
        if any(s < 1 or s > self.S for s in depth_sizes):
            raise ValueError("level widths %s outside [1, %d]"
                             % (tuple(depth_sizes), self.S))

    def levels(self, depth_sizes: tuple) -> torch.Tensor:
        """int32 [n_levels] level widths on the device (cached)."""
        t = self._levels.get(depth_sizes)
        if t is None:
            self.check_levels(depth_sizes)
            t = torch.tensor(depth_sizes, dtype=torch.int32,
                             device=self.device)
            self._levels[depth_sizes] = t
        return t


# ---------------------------------------------------------------------------
# checks and the C library
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError("%s: expected %s, got %s" % (name, dtype, t.dtype))
    if t.dim() != ndim:
        raise ValueError("%s: expected %d dims, got shape %s"
                         % (name, ndim, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s: tensor must be contiguous" % name)


def _same_device(name: str, *ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError("%s: tensors on %s and %s"
                             % (name, dev, t.device))
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# K4: descend
# ---------------------------------------------------------------------------


def descend_plain(t: CrushTables, depth_sizes: tuple, want_type: int,
                  x, r, bid, pos):
    """Plain version of K4: (item int32 [L], status int32 [L])."""
    L = x.shape[0]
    dev = x.device
    B = t.B
    cur = bid.to(torch.int64)
    xs = x & M32
    rs = r.to(torch.int64) & M32
    p = pos.to(torch.int64).clamp(0, t.n_pos - 1)
    item = torch.full((L,), ITEM_NONE, dtype=torch.int32, device=dev)
    ok = torch.zeros(L, dtype=torch.bool, device=dev)
    perm = torch.zeros_like(ok)
    in_range = (cur >= 0) & (cur < B)
    size_all = t.size.to(torch.int64)
    done = ~in_range | (size_all[cur.clamp(0, B - 1)] == 0)
    w_flat = t.weights.view(t.n_pos * B, t.S)
    for S_d in depth_sizes:
        if bool(done.all()):
            break
        c = cur.clamp(0, B - 1)
        n = torch.minimum(size_all[c], torch.full_like(c, S_d))
        slot = torch.arange(S_d, device=dev)
        ids = t.ids[c, :S_d].to(torch.int64) & M32
        w = w_flat[p * B + c, :S_d]
        u = hash32_3(xs[:, None], ids, rs[:, None]) & 0xFFFF
        ln = crush_ln(u) - LN_ONE
        draw = div_s64(ln, w.clamp(min=1))
        draw = torch.where((w > 0) & (slot[None, :] < n[:, None]), draw,
                           torch.full_like(draw, S64_MIN))
        best = draw.max(dim=1, keepdim=True).values
        win = torch.where(draw == best, slot[None, :],
                          torch.full_like(draw, S_d)).min(dim=1).values
        chosen = t.items[c, win]
        is_bucket = chosen < 0
        cbid = -1 - chosen.to(torch.int64)
        bucket_ok = is_bucket & (cbid < B)
        cb = cbid.clamp(0, B - 1)
        zero = torch.zeros_like(cb)
        ctype = torch.where(bucket_ok, t.btype[cb].to(torch.int64), zero)
        csize = torch.where(bucket_ok, size_all[cb], zero)
        oob = ~is_bucket & (chosen >= t.max_devices)
        reach = ~done & ~oob & torch.where(
            is_bucket, bucket_ok & (ctype == want_type),
            torch.full_like(ok, want_type == 0))
        wrong = ~done & ~reach & ~bucket_ok
        empty_next = ~done & ~reach & bucket_ok & (csize == 0)
        item = torch.where(reach, chosen, item)
        ok = ok | reach
        perm = perm | wrong
        done = done | reach | wrong | empty_next
        cur = torch.where(~done, cbid, cur)
    status = ok.to(torch.int32) | (perm.to(torch.int32) << 1)
    return item, status


def descend(t: CrushTables, depth_sizes: tuple, want_type: int,
            x, r, bid, pos):
    """K4: x int64 [L] (u32 hash inputs), r, bid, pos int32 [L] ->
    (item int32 [L], status int32 [L]: ok=1 | perm=2)."""
    _check("descend x", x, torch.int64, 1)
    for name, v in (("r", r), ("bid", bid), ("pos", pos)):
        _check("descend " + name, v, torch.int32, 1)
        if v.shape != x.shape:
            raise ValueError("descend %s: shape %s, x %s"
                             % (name, tuple(v.shape), tuple(x.shape)))
    dev = _same_device("descend", x, r, bid, pos, t.items)
    depth_sizes = tuple(depth_sizes)
    t.check_levels(depth_sizes)
    if dev.type == "cpu":
        return descend_plain(t, depth_sizes, want_type, x, r, bid, pos)
    lib = _build.library()
    levels = t.levels(depth_sizes)
    L = x.shape[0]
    item = torch.empty(L, dtype=torch.int32, device=dev)
    status = torch.empty(L, dtype=torch.int32, device=dev)
    if L == 0:
        return item, status
    ln_all = _ln_tensors(dev)[0]
    err = lib.crush_descend(
        _p(x), _p(r), _p(bid), _p(pos), _p(t.items), _p(t.ids),
        _p(t.weights), _p(t.size), _p(t.btype), _p(levels),
        len(depth_sizes), t.B, t.S, t.n_pos, t.max_devices,
        int(want_type), _p(ln_all), L, _p(item), _p(status),
        ctypes.c_void_p(_stream(dev)))
    _build.check(err, "crush_descend")
    LAUNCHES["descend"] += 1
    return item, status


# ---------------------------------------------------------------------------
# K5: post (no-affinity form)
# ---------------------------------------------------------------------------


def _kept(raw: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """raw holds an OSD id in [0, D) whose flag is set."""
    D = flags.shape[0]
    valid = (raw >= 0) & (raw < D)
    return valid & flags[raw.clamp(0, D - 1).to(torch.int64)]


def first_slot(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row, S for a row with none."""
    S = mask.shape[1]
    slot = torch.arange(S, device=mask.device)
    return torch.where(mask, slot[None, :],
                       torch.full_like(slot, S)[None, :]).min(dim=1).values


def post_plain(raw: torch.Tensor, keep: torch.Tensor, can_shift: bool):
    """Plain version of K5: (up int32 [L, S], prim int32 [L])."""
    L, S = raw.shape
    k = _kept(raw, keep)
    up = torch.where(k, raw, torch.full_like(raw, ITEM_NONE))
    if can_shift:
        rank = k.to(torch.int64).cumsum(dim=1) - 1
        tgt = torch.where(k, rank, torch.full_like(rank, S))
        wide = torch.full((L, S + 1), ITEM_NONE, dtype=torch.int32,
                          device=raw.device)
        wide.scatter_(1, tgt, up)
        up = wide[:, :S].contiguous()
    has = up != ITEM_NONE
    first = first_slot(has)
    prim = torch.where(
        first < S, up.gather(1, first.clamp(max=S - 1)[:, None])[:, 0],
        torch.full_like(first, -1).to(torch.int32))
    return up, prim.to(torch.int32)


def _bits_arg(bits: torch.Tensor) -> int:
    """Shared-memory words for a bitmask (0: read it from device memory,
    when it passes the 48 KiB a block gets without opting in)."""
    words = bits.shape[0]
    return words if words * 4 <= 48 * 1024 else 0


def post(raw: torch.Tensor, keep: torch.Tensor, can_shift: bool):
    """K5: raw int32 [L, S] with ITEM_NONE holes, keep bool [D]
    (exists & up) -> (up int32 [L, S], prim int32 [L])."""
    _check("post raw", raw, torch.int32, 2)
    _check("post keep", keep, torch.bool, 1)
    dev = _same_device("post", raw, keep)
    if dev.type == "cpu":
        return post_plain(raw, keep, can_shift)
    lib = _build.library()
    L, S = raw.shape
    up = torch.empty_like(raw)
    prim = torch.empty(L, dtype=torch.int32, device=dev)
    if L == 0 or S == 0:
        return up, prim.fill_(-1)
    bits = bitmask(keep)
    err = lib.crush_post(
        _p(raw), _p(bits), keep.shape[0], S, int(bool(can_shift)),
        _bits_arg(bits), L, _p(up), _p(prim),
        ctypes.c_void_p(_stream(dev)))
    _build.check(err, "crush_post")
    LAUNCHES["post"] += 1
    return up, prim


# ---------------------------------------------------------------------------
# K6: hitscan
# ---------------------------------------------------------------------------


def hitscan_plain(raw: torch.Tensor, changed: torch.Tensor):
    """Plain version of K6: hit bool [L]."""
    return _kept(raw, changed).any(dim=1)


def hitscan(raw: torch.Tensor, changed: torch.Tensor):
    """K6: raw int32 [L, S], changed bool [D] -> hit bool [L]: some slot
    of the row holds an OSD of the changed set."""
    _check("hitscan raw", raw, torch.int32, 2)
    _check("hitscan changed", changed, torch.bool, 1)
    dev = _same_device("hitscan", raw, changed)
    if dev.type == "cpu":
        return hitscan_plain(raw, changed)
    lib = _build.library()
    L, S = raw.shape
    hit = torch.empty(L, dtype=torch.bool, device=dev)
    if L == 0 or S == 0:
        return hit.fill_(False)
    bits = bitmask(changed)
    err = lib.crush_hitscan(
        _p(raw), _p(bits), changed.shape[0], S, _bits_arg(bits), L,
        _p(hit), ctypes.c_void_p(_stream(dev)))
    _build.check(err, "crush_hitscan")
    LAUNCHES["hitscan"] += 1
    return hit


# ---------------------------------------------------------------------------
# K7: rowcompact
# ---------------------------------------------------------------------------


def rowcompact_plain(hit: torch.Tensor, row: int, kt: int, pg_num: int):
    """Plain version of K7: (idx int32 [NR*kt], valid bool [NR*kt],
    cnt int32 [NR])."""
    n = hit.shape[0]
    dev = hit.device
    nr = -(-n // row)
    lane = torch.arange(nr * row, device=dev)
    h = torch.zeros(nr * row, dtype=torch.bool, device=dev)
    h[:n] = hit
    h = (h & (lane < pg_num)).view(nr, row)
    cnt = h.sum(dim=1)
    rank = h.to(torch.int64).cumsum(dim=1) - 1
    base = torch.arange(nr, device=dev) * row
    idx = base[:, None].repeat(1, kt)
    put = h & (rank < kt)
    g = torch.arange(nr, device=dev)[:, None].expand(nr, row)
    idx.view(-1)[(g * kt + rank)[put]] = lane.view(nr, row)[put]
    slot = torch.arange(kt, device=dev)
    valid = (slot[None, :] < cnt[:, None]) & (idx < pg_num)
    return (idx.view(-1).to(torch.int32), valid.view(-1),
            cnt.to(torch.int32))


def rowcompact(hit: torch.Tensor, row: int, kt: int, pg_num: int):
    """K7: hit bool [n] -> (idx int32 [NR*kt], valid bool [NR*kt],
    cnt int32 [NR]) with NR = ceil(n / row).  Per group g of `row`
    lanes: slot j < min(cnt, kt) holds the j-th hit lane (ascending),
    pad slots hold the group's base lane g*row; valid = slot < cnt and
    lane < pg_num; hits at lanes >= pg_num are ignored; cnt[g] > kt
    shows an overflow (the slots then hold the first kt hits)."""
    _check("rowcompact hit", hit, torch.bool, 1)
    if row < 1 or kt < 1:
        raise ValueError("rowcompact: row %d, kt %d" % (row, kt))
    n = hit.shape[0]
    if n + row >= 1 << 31:
        raise ValueError("rowcompact: %d lanes do not fit int32" % n)
    dev = _same_device("rowcompact", hit)
    if dev.type == "cpu":
        return rowcompact_plain(hit, row, kt, pg_num)
    lib = _build.library()
    nr = -(-n // row)
    idx = torch.empty(nr * kt, dtype=torch.int32, device=dev)
    valid = torch.empty(nr * kt, dtype=torch.bool, device=dev)
    cnt = torch.empty(nr, dtype=torch.int32, device=dev)
    if nr == 0:
        return idx, valid, cnt
    err = lib.crush_rowcompact(
        _p(hit), n, max(0, int(pg_num)), row, kt, _p(idx), _p(valid),
        _p(cnt), ctypes.c_void_p(_stream(dev)))
    _build.check(err, "crush_rowcompact")
    LAUNCHES["rowcompact"] += 1
    return idx, valid, cnt
