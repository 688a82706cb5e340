"""CRUSH kernels: the whole choose step of a rule, the post-CRUSH
filter, the remap hit scan and the row-group compaction, on the card.

Four hand-written CUDA kernels (``csrc/crush_kernels.cu``) carry the
bulk mapper (``ops.crush.device``):

* ``choose`` (K4) — one thread runs one lane's whole
  ``crush_choose_firstn`` / ``crush_choose_indep`` (mapper.c:438-821):
  the straw2 descents (rjenkins ``hash32_3``, the table ``crush_ln``
  and the exact draw ``trunc((crush_ln(u) - 2^48) / w)``, taken without
  a division from a per-weight reciprocal, ``draw_recip_plain``), the
  collision checks, the reweight rejection, the chooseleaf recursion
  and the retry loops, and writes the lane's raw row.  A pool pass
  hands it the pool's ``raw_pg_to_pps`` arguments (``PpsSeeds``) in
  place of inputs, and each thread hashes its lane's seed
  (``pps_seed``) itself.
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
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ... import _build
from ._ln_tables import LL_TBL, RH_LH_TBL

# launches of each CUDA kernel; a wrapper adds one where it launches its
# kernel and nowhere else (plain versions on the CPU do not count).  A
# pass may run in an executor thread beside the loop's (the scale
# plane's MapCache), so the count is taken under a lock.  "choose_pps"
# counts the K4 launches (also counted under "choose") whose lanes
# hashed their own pps seeds
LAUNCHES = {"choose": 0, "choose_pps": 0, "post": 0, "hitscan": 0,
            "rowcompact": 0}
_LAUNCH_LOCK = threading.Lock()

ITEM_NONE = 0x7FFFFFFF
ITEM_UNDEF = 0x7FFFFFFE
S64_MIN = -(1 << 63)
LN_ONE = 1 << 48          # crush_ln(0xFFFF), the draw's offset
M32 = 0xFFFFFFFF
HASH_SEED = 1315423911

# status bits of a descent (the reference kernel's ok=1 | perm=2; its
# uncertainty bit 4 has no counterpart: the draw here is exact)
ST_OK = 1
ST_PERM = 2

# the choose kernel takes the plan's level widths in its launch
# parameters (csrc/crush_kernels.cu)
MAX_LEVELS = 16
# K4 stages the map in shared memory up to this many bytes (crush_ln
# tables included); a larger map is read from device memory
CHOOSE_SMEM_MAX = 100 * 1024


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _launched(name: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


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
LN_BYTES = _LN_NP.nbytes


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


def reciprocals(w: torch.Tensor) -> torch.Tensor:
    """float64 1/w (rounded to nearest) of int64 weights in [0, 2^32);
    0 where w == 0."""
    wf = w.to(torch.float64)
    return torch.where(w > 0, 1.0 / wf.clamp(min=1.0),
                       torch.zeros_like(wf))


def draw_recip_plain(u: torch.Tensor, w: torch.Tensor,
                     rcp: torch.Tensor) -> torch.Tensor:
    """The straw2 draw div_s64(crush_ln(u) - 2^48, w) without a division,
    as K4 takes it: a = 2^48 - crush_ln(u) lies in [0, 2^48], so
    a * rcp (both float64, rcp = 1/w rounded) is within 2^-4 of a / w
    and its truncation q is off floor(a / w) by at most one; one exact
    integer step (r = a - q*w; q -= 1 if r < 0; q += 1 if r >= w)
    corrects it, and the draw is -q.  u int64 in [0, 0xFFFF]; w int64
    in [0, 2^32) with rcp = reciprocals(w), broadcast against u.  A zero
    weight draws S64_MIN."""
    a = LN_ONE - crush_ln(u)
    q = torch.trunc(a.to(torch.float64) * rcp).to(torch.int64)
    r = a - q * w
    q = q - (r < 0).to(torch.int64) + (r >= w).to(torch.int64)
    return torch.where(w > 0, -q, torch.full_like(q, S64_MIN))


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
    (row min(position, n_pos - 1)); rcp [n_pos, B, S] float64, the
    weights' reciprocals (``draw_recip_plain``); size, btype [B] int32.

    ``packed`` is the same map as K4 reads it, one uint8 buffer of
    bucket rows laid end to end (no padding to S), in this order:
    reciprocals float64 [n_pos, N], weights uint32 [n_pos, N], items
    int32 [N], ids int32 [N], row offsets int32 [B + 1], types int32
    [B], zero-padded to a multiple of 16 bytes (N = total items)."""

    def __init__(self, items, ids, weights, size, btype,
                 max_devices: int, device):
        dev = torch.device(device)

        def put(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                dtype=dt).to(dev).contiguous()

        w_np = np.asarray(weights, np.int64) & M32
        rcp_np = np.where(w_np > 0, 1.0 / np.maximum(w_np, 1), 0.0)
        size_np = np.asarray(size, np.int32)
        self.device = dev
        self.items = put(items, torch.int32)
        self.ids = put(ids, torch.int32)
        self.weights = put(w_np, torch.int64)
        self.rcp = put(rcp_np, torch.float64)
        self.size = put(size_np, torch.int32)
        self.btype = put(btype, torch.int32)
        self.n_pos, self.B, self.S = (int(v) for v in self.weights.shape)
        self.max_devices = int(max_devices)
        # the packed rows
        keep = np.arange(self.S)[None, :] < size_np[:, None]
        self.N = int(keep.sum())
        off = np.zeros(self.B + 1, np.int32)
        off[1:] = np.cumsum(size_np)
        parts = [rcp_np[:, keep], w_np[:, keep].astype(np.uint32),
                 np.asarray(items, np.int32)[keep],
                 np.asarray(ids, np.int32)[keep], off,
                 np.asarray(btype, np.int32)]
        raw = b"".join(np.ascontiguousarray(a).tobytes() for a in parts)
        raw += bytes(-len(raw) % 16)
        self.packed = put(np.frombuffer(raw, np.uint8).copy(), torch.uint8)

    def check_levels(self, depth_sizes: tuple) -> None:
        if any(s < 1 or s > self.S for s in depth_sizes):
            raise ValueError("level widths %s outside [1, %d]"
                             % (tuple(depth_sizes), self.S))


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
# K4: choose
# ---------------------------------------------------------------------------


def _descend(t: CrushTables, depth_sizes: tuple, want_type: int, x, r,
             bid, pos, tally: list | None):
    """The straw2 descent of each lane (item int32 [L], status int32
    [L]); tally, when given, gets the count of draws taken (items of
    nonzero weight drawn by lanes still descending) as a tensor."""
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
    rcp_flat = t.rcp.view(t.n_pos * B, t.S)
    for S_d in depth_sizes:
        if L == 0 or bool(done.all()):
            break
        c = cur.clamp(0, B - 1)
        n = torch.minimum(size_all[c], torch.full_like(c, S_d))
        slot = torch.arange(S_d, device=dev)
        ids = t.ids[c, :S_d].to(torch.int64) & M32
        w = w_flat[p * B + c, :S_d]
        drawn = (w > 0) & (slot[None, :] < n[:, None])
        if tally is not None:
            tally.append((drawn & ~done[:, None]).sum())
        u = hash32_3(xs[:, None], ids, rs[:, None]) & 0xFFFF
        draw = draw_recip_plain(u, w, rcp_flat[p * B + c, :S_d])
        draw = torch.where(drawn, draw, torch.full_like(draw, S64_MIN))
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


def descend_plain(t: CrushTables, depth_sizes: tuple, want_type: int,
                  x, r, bid, pos):
    """The straw2 descent, a building block of choose_plain: x int64
    [L] (u32 hash inputs), r, bid, pos int32 [L] -> (item int32 [L],
    status int32 [L]).  From bucket index bid, draw every item of the
    bucket (at most depth_sizes[d] at level d; choose_args position
    pos), take the first item with the strictly greatest draw, and stop
    on an item of want_type (ok=1), stop for good on a device of the
    wrong type, an out-of-range device or a missing bucket (perm=2),
    stop on an empty child bucket (retryable: neither bit), or walk
    into the child bucket."""
    return _descend(t, tuple(depth_sizes), want_type, x, r, bid, pos, None)


def is_out(dev_weights, item, x):
    """Reweight rejection (mapper.c:402-416): dev_weights int32 [D] 16.16
    reweights, item int32 [L], x int64 [L]."""
    D = dev_weights.shape[0]
    w = dev_weights[item.clamp(0, D - 1).to(torch.int64)].to(torch.int64)
    oob = (item >= D) | (item < 0)
    hh = hash32_2(x, item.to(torch.int64) & M32) & 0xFFFF
    return oob | (w == 0) | ((w < 0x10000) & (hh >= w))


class ChoosePlan:
    """One rule's single choose step, resolved against the tunables:
    take_id (a bucket id), numrep, want_type, firstn, leaf (chooseleaf),
    tries, recurse (the leaf tries), vary_r, stable, outer_ds / inner_ds
    (the level widths of the outer and the leaf descents) and slots
    (the row width, min(numrep, result_max))."""

    __slots__ = ("take_id", "numrep", "want_type", "firstn", "leaf",
                 "tries", "recurse", "vary_r", "stable", "outer_ds",
                 "inner_ds", "slots")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)

    def ints(self) -> list[int]:
        """The plan as the kernel's launch parameters take it."""
        lv = [0] * (2 * MAX_LEVELS)
        lv[:len(self.outer_ds)] = self.outer_ds
        lv[MAX_LEVELS:MAX_LEVELS + len(self.inner_ds)] = self.inner_ds
        return [-1 - self.take_id, self.numrep, self.slots, self.want_type,
                int(self.firstn), int(self.leaf), self.tries, self.recurse,
                self.vary_r, self.stable, len(self.outer_ds),
                len(self.inner_ds)] + lv


def _in_row(rows, v):
    """v [L] occurs in rows [L, S]."""
    return (rows == v[:, None]).any(dim=1)


def _leaf_step(t, p: ChoosePlan, x, item, good, rows, r0, step: int, pos,
               dev_weights, tally):
    """The chooseleaf recursion of the lanes whose outer pick is a bucket
    and still good: up to p.recurse inner descents from it to a device,
    at r = r0 + step * ift, choose_args position pos.  A device that is
    out, or (rows given: firstn) already a leaf of the row, is retried;
    a permanent failure ends the lane's tries (the host's inner call
    skips its replica).  A device picked by the outer descent is its
    own leaf (mapper.c:541-543).  Returns (final, good) with good
    cleared where no leaf was found."""
    n = x.shape[0]
    leaf = item.clone()
    is_b = item < 0
    found = torch.zeros(n, dtype=torch.bool, device=x.device)
    cur = torch.nonzero(good & is_b).flatten()
    for ift in range(p.recurse):
        if cur.numel() == 0:
            break
        xc = x[cur]
        cand, st = _descend(t, p.inner_ds, 0, xc,
                            (r0[cur] + step * ift).to(torch.int32),
                            (-1 - item[cur]).to(torch.int32), pos[cur],
                            tally)
        cok = (st & ST_OK) != 0
        if rows is not None:
            cok = cok & ~_in_row(rows[cur], cand)
        cok = cok & ~is_out(dev_weights, cand, xc)
        take = cur[cok]
        leaf[take] = cand[cok]
        found[take] = True
        cur = cur[~cok & ((st & ST_PERM) == 0)]
    return leaf, good & (found | ~is_b)


def _choose_firstn_plain(t, p: ChoosePlan, xs, dev_weights, tally):
    """crush_choose_firstn (mapper.c:438-626) with local tries 0: per
    replica, whole descents retried (r = rep + ftotal) while the pick
    collides or is rejected, over the lanes still placing."""
    L = xs.shape[0]
    dev = xs.device
    out = torch.full((L, p.slots), ITEM_NONE, dtype=torch.int32,
                     device=dev)
    leaves = out.clone()
    outpos = torch.zeros(L, dtype=torch.int32, device=dev)
    for rep in range(p.numrep):
        lanes = torch.nonzero(outpos < p.slots).flatten()
        ftotal = 0
        while lanes.numel() and ftotal < p.tries:
            n = lanes.numel()
            x = xs[lanes]
            op = outpos[lanes]
            r = torch.full((n,), rep + ftotal, dtype=torch.int32,
                           device=dev)
            item, st = _descend(
                t, p.outer_ds, p.want_type, x, r,
                torch.full_like(r, -1 - p.take_id), op, tally)
            good = ((st & ST_OK) != 0) & ~_in_row(out[lanes], item)
            final = item
            if p.leaf:
                r0 = ((r >> (p.vary_r - 1)) if p.vary_r
                      else torch.zeros_like(r))
                if not p.stable:
                    r0 = r0 + op
                final, good = _leaf_step(t, p, x, item, good, leaves[lanes],
                                         r0, 1, op, dev_weights, tally)
            if p.want_type == 0:
                good = good & ~is_out(dev_weights, item, x)
            won = lanes[good]
            col = op[good].to(torch.int64)
            out[won, col] = item[good]
            leaves[won, col] = final[good]
            outpos[won] += 1
            lanes = lanes[~good & ((st & ST_PERM) == 0)]
            ftotal += 1
    return leaves if p.leaf else out


def _choose_indep_plain(t, p: ChoosePlan, xs, dev_weights, tally):
    """crush_choose_indep (mapper.c:633-821): rounds ftotal = 0, 1, ...
    in which every UNDEF slot draws with r = rep + numrep * ftotal;
    positionally stable, ITEM_NONE for slots that fail for good or
    stay undecided."""
    L = xs.shape[0]
    dev = xs.device
    out = torch.full((L, p.slots), ITEM_UNDEF, dtype=torch.int32,
                     device=dev)
    leaves = out.clone()
    for ftotal in range(p.tries):
        lanes = torch.nonzero((out == ITEM_UNDEF).any(dim=1)).flatten()
        if lanes.numel() == 0:
            break
        for rep in range(p.slots):
            cur = lanes[out[lanes, rep] == ITEM_UNDEF]
            if cur.numel() == 0:
                continue
            n = cur.numel()
            x = xs[cur]
            rr = rep + p.numrep * ftotal
            r = torch.full((n,), rr, dtype=torch.int32, device=dev)
            zero = torch.zeros_like(r)
            item, st = _descend(
                t, p.outer_ds, p.want_type, x, r,
                torch.full_like(r, -1 - p.take_id), zero, tally)
            good = ((st & ST_OK) != 0) & ~_in_row(out[cur], item)
            final = item
            if p.leaf:
                # the inner call starts at r + rep and steps by numrep,
                # at choose_args position rep (mapper.c:725-735)
                final, good = _leaf_step(t, p, x, item, good, None, r + rep,
                                         p.numrep, zero + rep, dev_weights,
                                         tally)
            if p.want_type == 0:
                good = good & ~is_out(dev_weights, item, x)
            perm = (st & ST_PERM) != 0
            out[cur[good], rep] = item[good]
            leaves[cur[good], rep] = final[good]
            out[cur[perm], rep] = ITEM_NONE
            leaves[cur[perm], rep] = ITEM_NONE
    res = leaves if p.leaf else out
    return torch.where(res == ITEM_UNDEF, torch.full_like(res, ITEM_NONE),
                       res)


def _check_plan(t: CrushTables, p: ChoosePlan) -> None:
    for ds in (p.outer_ds, p.inner_ds):
        if len(ds) > MAX_LEVELS:
            raise ValueError("choose: %d levels, at most %d"
                             % (len(ds), MAX_LEVELS))
        t.check_levels(ds)
    if not p.outer_ds or (p.leaf and not p.inner_ds):
        raise ValueError("choose: a descent without levels")


class PpsSeeds(NamedTuple):
    """A pool's raw_pg_to_pps arguments (osd_types.cc:1815-1831), which K4
    takes in place of inputs: lane l's ps is lanes[l] (int64 [L]) or,
    without lanes, base + l for `count` lanes."""

    pgp_num: int
    pgp_mask: int
    pool_id: int
    hashpspool: bool
    base: int = 0
    count: int = 0
    lanes: torch.Tensor | None = None


def pps_seed(ps, pgp_num: int, pgp_mask: int, pool_id: int,
             hashpspool: bool):
    """raw_pg_to_pps over an int64 tensor of ps values (osd_types.cc:
    1815-1831; hashes.pps_seed_v on the host): stable mod, then the
    pool mix.  Returns int64 u32 seeds.  The plain version of the seed
    each K4 thread hashes for its lane from PpsSeeds."""
    m = ps & pgp_mask
    masked = torch.where(m < pgp_num, m, ps & (pgp_mask >> 1))
    if hashpspool:
        return hash32_2(masked, torch.full_like(masked, pool_id & M32))
    return (masked + pool_id) & M32


def _pps_plain(pps: PpsSeeds, dev: torch.device) -> torch.Tensor:
    ps = (pps.lanes if pps.lanes is not None
          else torch.arange(pps.base, pps.base + pps.count, device=dev))
    return pps_seed(ps, pps.pgp_num, pps.pgp_mask, pps.pool_id,
                    pps.hashpspool)


def choose_plain(t: CrushTables, p: ChoosePlan, xs, dev_weights,
                 count_draws: bool = False, *,
                 pps: PpsSeeds | None = None,
                 xs_out: torch.Tensor | None = None):
    """Plain version of K4: raw rows int32 [L, p.slots] with ITEM_NONE
    holes (the leaves for chooseleaf).  With count_draws, (rows, draws):
    the straw2 draws the exact algorithm takes for these inputs, summed
    over the lanes.  With xs None, the inputs are pps's seeds
    (pps_seed), copied into xs_out where given, as choose takes them."""
    if xs is None:
        xs = _pps_plain(pps, dev_weights.device)
        if xs_out is not None:
            xs_out.copy_(xs)
    tally: list | None = [] if count_draws else None
    if p.slots < 1 or xs.shape[0] == 0:
        rows = torch.full((xs.shape[0], max(p.slots, 0)), ITEM_NONE,
                          dtype=torch.int32, device=xs.device)
    elif p.firstn:
        rows = _choose_firstn_plain(t, p, xs, dev_weights, tally)
    else:
        rows = _choose_indep_plain(t, p, xs, dev_weights, tally)
    if not count_draws:
        return rows
    return rows, int(sum(int(v) for v in tally))


def _stamp(dev: torch.device, stream=None):
    """A point on the device's timeline: a CUDA event recorded on
    `stream` (default: the current one), or the host clock's seconds on
    the CPU (where the plain version runs in the caller's thread)."""
    if dev.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream if stream is not None
              else torch.cuda.current_stream(dev))
    return ev


def choose(t: CrushTables, p: ChoosePlan, xs, dev_weights,
           staged: bool | None = None, *, pps: PpsSeeds | None = None,
           xs_out: torch.Tensor | None = None,
           marks: list | None = None):
    """K4: xs int64 [L] (u32 inputs, e.g. pps seeds), dev_weights int32
    [D] 16.16 reweights -> raw rows int32 [L, p.slots], each lane's
    whole crush_choose_firstn / crush_choose_indep.  With xs None, pps
    gives the lanes and each lane's input is its pps seed, which on the
    card the lane's thread hashes itself (counted in
    LAUNCHES["choose_pps"]); xs_out int64 [L], where given, receives
    those seeds.  On the card the kernel reads the map from shared
    memory (staged) or from device memory; staged None takes shared
    memory where the map and the crush_ln tables fit in CHOOSE_SMEM_MAX
    bytes.  `marks`, where given, takes a (start, end) pair of stamps
    (`_stamp`) around the launch, or around the plain version."""
    if (xs is None) == (pps is None):
        raise ValueError("choose: give either inputs or pps arguments")
    src = xs if xs is not None else pps.lanes
    if src is not None:
        _check("choose xs" if xs is not None else "choose pps lanes", src,
               torch.int64, 1)
        L = src.shape[0]
    else:
        L = int(pps.count)
        if L < 0 or pps.base < 0:
            raise ValueError("choose: %d pps lanes from %d"
                             % (L, pps.base))
    _check("choose dev_weights", dev_weights, torch.int32, 1)
    given = [v for v in (src, xs_out) if v is not None]
    dev = _same_device("choose", *given, dev_weights, t.items)
    if xs_out is not None:
        if xs is not None:
            raise ValueError("choose: xs_out takes the seeds of a pps pass")
        _check("choose xs_out", xs_out, torch.int64, 1)
        if xs_out.shape[0] != L:
            raise ValueError("choose: xs_out holds %d lanes, not %d"
                             % (xs_out.shape[0], L))
    _check_plan(t, p)
    smem = LN_BYTES + t.packed.shape[0]
    if staged is None:
        staged = smem <= CHOOSE_SMEM_MAX
    elif staged and smem > CHOOSE_SMEM_MAX:
        raise ValueError("choose: a %d-byte map does not fit in shared "
                         "memory" % t.packed.shape[0])
    if dev.type == "cpu" or L == 0 or p.slots < 1:
        # the plain version on the CPU; on the card, with no lanes or no
        # slots, nothing to launch
        t0 = _stamp(dev) if marks is not None else None
        rows = choose_plain(t, p, xs, dev_weights, pps=pps, xs_out=xs_out)
        if marks is not None:
            marks.append((t0, _stamp(dev)))
        return rows
    lib = _build.library()
    rows = torch.empty((L, p.slots), dtype=torch.int32, device=dev)
    plan = (ctypes.c_int * (12 + 2 * MAX_LEVELS))(*p.ints())
    ln_all = _ln_tensors(dev)[0]
    # the kernel hands lanes out from this counter (it zeroes it first)
    counter = torch.empty(1, dtype=torch.int64, device=dev)
    # under chooseleaf the rows take the leaves and this buffer the
    # outer picks the collision checks read; else the rows take both
    picks = torch.empty_like(rows) if p.leaf else rows
    if xs is not None:
        seed_args = (_p(xs), 0, None, 0, 0, 0, 0, None)
    else:
        seed_args = (None, int(pps.base),
                     None if pps.lanes is None else _p(pps.lanes),
                     int(pps.pgp_num) & M32, int(pps.pgp_mask) & M32,
                     int(pps.pool_id) & M32, int(bool(pps.hashpspool)),
                     None if xs_out is None else _p(xs_out))
    stream = torch.cuda.current_stream(dev)
    t0 = _stamp(dev, stream) if marks is not None else None
    err = lib.crush_choose(
        *seed_args, L, _p(t.packed), t.packed.shape[0], t.N, t.B, t.n_pos,
        t.max_devices, int(staged), ctypes.cast(plan, ctypes.c_void_p),
        _p(dev_weights), dev_weights.shape[0], _p(ln_all), _p(counter),
        _p(picks), _p(rows), ctypes.c_void_p(stream.cuda_stream))
    _build.check(err, "crush_choose")
    if marks is not None:
        marks.append((t0, _stamp(dev, stream)))
    _launched("choose")
    if xs is None:
        _launched("choose_pps")
    return rows


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
    _launched("post")
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
    _launched("hitscan")
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
    # 16-byte loads where every group starts on a 16-byte boundary
    vec = int(hit.data_ptr() % 16 == 0 and row % 16 == 0)
    err = lib.crush_rowcompact(
        _p(hit), n, max(0, int(pg_num)), row, kt, vec, _p(idx), _p(valid),
        _p(cnt), ctypes.c_void_p(_stream(dev)))
    _build.check(err, "crush_rowcompact")
    _launched("rowcompact")
    return idx, valid, cnt
