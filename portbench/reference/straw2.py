"""Plain CRUSH placement of replicated PGs over straw2 trees.

The yardstick of the placement cells: NumPy over a batch of PGs, written
from the published algorithm (src/crush/hash.c, src/crush/mapper.c,
src/osd/osd_types.cc, src/osd/OSDMap.cc) and importing nothing of the
program.

Derivation, for the case the cells run (straw2 buckets, a rule of TAKE,
CHOOSE_FIRSTN or CHOOSELEAF_FIRSTN, EMIT, the optimal tunables
choose_total_tries 50, chooseleaf_descend_once 1, chooseleaf_vary_r 1,
chooseleaf_stable 1, no local retries):

- A PG's placement seed is pps = hash32_2(stable_mod(ps, pgp_num,
  pgp_num_mask), pool) (HASHPSPOOL).
- A straw2 bucket gives each item the draw ln(u) / weight, u = the low
  16 bits of hash32_3(x, item, r) and ln(u) = crush_ln(u) - 2^48 (a
  fixed-point log2, <= 0), divided with truncation toward zero; a zero
  weight draws S64_MIN.  The first item with the largest draw wins.
- Replica rep (0, 1, ...) tries r = rep + ftotal, ftotal counting its
  failures, up to 51 tries.  At each r it descends from the rule's root,
  one straw2 choice a level with the same r, to an item of the step's
  type.  An item already chosen for this PG collides.  For CHOOSELEAF
  the leaf is then drawn once (descend_once) from that item's subtree
  with the same r (vary_r 1): a leaf already chosen, or one that is out,
  fails the try.  A device is out when its reweight w is 0, or below
  0x10000 and hash32_2(x, device) & 0xffff >= w.  A replica that fails
  51 tries is skipped (firstn leaves no hole).
- The up set is the raw set with devices that do not exist or are not
  up removed; its first entry is the up primary (-1 if none).  The
  cells set no primary affinity, upmap or temp entries: `up_sets`
  refuses a map with any.
"""

from __future__ import annotations

import numpy as np

from .crush_ln_tables import LL_TBL, RH_LH_TBL

ITEM_NONE = 0x7FFFFFFF
HASH_SEED = 1315423911
S64_MIN = np.iinfo(np.int64).min
TAKE, CHOOSE_FIRSTN, CHOOSELEAF_FIRSTN, EMIT = 1, 2, 6, 4
TRIES = 51

_RH_LH = np.array(RH_LH_TBL, dtype=np.uint64)
_LL = np.array(LL_TBL, dtype=np.uint64)
_U32 = np.uint32


def _mix(a, b, c):
    a = a - b; a = a - c; a = a ^ (c >> _U32(13))
    b = b - c; b = b - a; b = b ^ (a << _U32(8))
    c = c - a; c = c - b; c = c ^ (b >> _U32(13))
    a = a - b; a = a - c; a = a ^ (c >> _U32(12))
    b = b - c; b = b - a; b = b ^ (a << _U32(16))
    c = c - a; c = c - b; c = c ^ (b >> _U32(5))
    a = a - b; a = a - c; a = a ^ (c >> _U32(3))
    b = b - c; b = b - a; b = b ^ (a << _U32(10))
    c = c - a; c = c - b; c = c ^ (b >> _U32(15))
    return a, b, c


def _u32(v) -> np.ndarray:
    return np.asarray(np.asarray(v, dtype=np.int64) & 0xFFFFFFFF,
                      dtype=np.uint32)


def hash32_2(a, b) -> np.ndarray:
    """crush_hash32_rjenkins1_2, elementwise (uint32)."""
    a, b = np.broadcast_arrays(_u32(a), _u32(b))
    h = _U32(HASH_SEED) ^ a ^ b
    x = np.full_like(a, 231232)
    y = np.full_like(a, 1232)
    with np.errstate(over="ignore"):
        a, b, h = _mix(a, b, h)
        x, a, h = _mix(x, a, h)
        b, y, h = _mix(b, y, h)
    return h


def hash32_3(a, b, c) -> np.ndarray:
    """crush_hash32_rjenkins1_3, elementwise (uint32)."""
    a, b, c = np.broadcast_arrays(_u32(a), _u32(b), _u32(c))
    h = _U32(HASH_SEED) ^ a ^ b ^ c
    x = np.full_like(a, 231232)
    y = np.full_like(a, 1232)
    with np.errstate(over="ignore"):
        a, b, h = _mix(a, b, h)
        c, x, h = _mix(c, x, h)
        y, a, h = _mix(y, a, h)
        b, x, h = _mix(b, x, h)
        y, c, h = _mix(y, c, h)
    return h


def crush_ln(u: np.ndarray) -> np.ndarray:
    """2^44 * log2(u + 1) in fixed point, u in [0, 0xffff] (int64)."""
    x = np.asarray(u, dtype=np.int64) + 1
    small = (x & 0x18000) == 0
    bits = np.where(small, 16 - np.frexp(x.astype(np.float64))[1],
                    0).astype(np.int64)
    x = x << bits
    iexpon = 15 - bits
    index1 = (x >> 8) << 1
    rh = _RH_LH[index1 - 256]
    lh = _RH_LH[index1 + 1 - 256]
    with np.errstate(over="ignore"):
        xl64 = (x.astype(np.uint64) * rh) >> np.uint64(48)
    lh = (lh + _LL[(xl64 & np.uint64(0xFF)).astype(np.int64)]) \
        >> np.uint64(4)
    return (iexpon << 44) + lh.astype(np.int64)


def straw2_draws(x, ids, weights, r) -> np.ndarray:
    """[n, size] int64 draws of a bucket's items for PGs x at tries r."""
    u = hash32_3(np.asarray(x)[:, None], np.asarray(ids)[None, :],
                 np.asarray(r)[:, None]) & _U32(0xFFFF)
    ln = crush_ln(u) - (1 << 48)
    w = np.asarray(weights, dtype=np.int64)[None, :]
    safe = np.where(w > 0, w, 1)
    draw = -((-ln) // safe)          # C division: truncate toward zero
    return np.where(w > 0, draw, S64_MIN)


class CrushTree:
    """A straw2 hierarchy: {bucket id: (type, items, weights)}; devices
    are the non-negative ids, of type 0."""

    def __init__(self, buckets: dict[int, tuple[int, list, list]],
                 max_devices: int):
        self.buckets = {int(b): (int(t), np.asarray(i, np.int64),
                                 np.asarray(w, np.int64))
                        for b, (t, i, w) in buckets.items()}
        self.max_devices = int(max_devices)

    def type_of(self, item: np.ndarray) -> np.ndarray:
        out = np.zeros(item.shape, dtype=np.int64)
        for b, (t, _i, _w) in self.buckets.items():
            out[item == b] = t
        return out

    def choose(self, x, bucket, r) -> np.ndarray:
        """One straw2 choice for each PG, from per-PG buckets."""
        out = np.empty(len(x), dtype=np.int64)
        for b in np.unique(bucket):
            sel = bucket == b
            _t, ids, ws = self.buckets[int(b)]
            pick = np.argmax(straw2_draws(x[sel], ids, ws, r[sel]), axis=1)
            out[sel] = ids[pick]
        return out

    def descend(self, x, start, r, want_type):
        """(item, ok): straw2 choices with the same r from `start` down
        to an item of `want_type`; not ok where a device of another type
        (or an unknown id) is reached first."""
        cur = np.asarray(start, dtype=np.int64).copy()
        item = np.empty(len(x), dtype=np.int64)
        ok = np.ones(len(x), dtype=bool)
        todo = np.ones(len(x), dtype=bool)
        while todo.any():
            idx = np.nonzero(todo)[0]
            got = self.choose(x[idx], cur[idx], r[idx])
            item[idx] = got
            t = self.type_of(got)
            done = t == want_type
            bad = (~done & ((got >= 0)
                            | ~np.isin(got, list(self.buckets))))
            bad |= got >= self.max_devices
            ok[idx[bad]] = False
            todo[idx[done | bad]] = False
            cur[idx[~done & ~bad]] = got[~done & ~bad]
        return item, ok


def is_out(reweight: np.ndarray, item: np.ndarray, x: np.ndarray):
    inside = (item >= 0) & (item < len(reweight))
    w = np.where(inside, reweight[np.clip(item, 0, len(reweight) - 1)], 0)
    hashed = (hash32_2(x, item) & _U32(0xFFFF)).astype(np.int64) >= w
    return ~inside | (w == 0) | ((w < 0x10000) & hashed)


def choose_firstn(tree: CrushTree, x, root: int, numrep: int,
                  want_type: int, leaf: bool, reweight, ignore_out=False):
    """[n, numrep] chosen items (leaves for CHOOSELEAF), ITEM_NONE after
    the last filled slot.  `ignore_out` skips the reweight test (the
    benchmark's control, which breaks the no-out-device guarantee)."""
    n = len(x)
    out = np.full((n, numrep), ITEM_NONE, dtype=np.int64)
    leaves = np.full((n, numrep), ITEM_NONE, dtype=np.int64)
    filled = np.zeros(n, dtype=np.int64)
    for rep in range(numrep):
        ftotal = np.zeros(n, dtype=np.int64)
        active = np.ones(n, dtype=bool)
        while active.any():
            idx = np.nonzero(active)[0]
            xi = x[idx]
            r = rep + ftotal[idx]
            item, ok = tree.descend(xi, np.full(len(idx), root), r,
                                    want_type)
            pos = filled[idx]
            earlier = np.arange(numrep)[None, :] < pos[:, None]
            collide = ((out[idx] == item[:, None]) & earlier).any(axis=1)
            reject = ~ok
            lf = item.copy()
            if leaf:
                sub = ok & ~collide & (item < 0)
                if sub.any():
                    s = np.nonzero(sub)[0]
                    got, lok = tree.descend(xi[s], item[s], r[s], 0)
                    lcol = ((leaves[idx[s]] == got[:, None])
                            & earlier[s]).any(axis=1)
                    bad = ~lok | lcol
                    if not ignore_out:
                        bad |= is_out(reweight, got, xi[s])
                    lf[s] = got
                    reject[s[bad]] = True
            if not ignore_out:
                d = np.nonzero(ok & ~collide & (item >= 0))[0]
                reject[d[is_out(reweight, item[d], xi[d])]] = True
            fail = reject | collide
            win = idx[~fail]
            out[win, filled[win]] = item[~fail]
            leaves[win, filled[win]] = lf[~fail]
            filled[win] += 1
            ftotal[idx[fail]] += 1
            active[win] = False
            active[idx[fail & (ftotal[idx] >= TRIES)]] = False
    return leaves if leaf else out


def pps(ps: np.ndarray, pgp_num: int, pool_id: int) -> np.ndarray:
    """The HASHPSPOOL placement seed of each ps."""
    mask = (1 << int(pgp_num - 1).bit_length()) - 1
    ps = np.asarray(ps, dtype=np.int64)
    stable = np.where((ps & mask) < pgp_num, ps & mask, ps & (mask >> 1))
    return hash32_2(stable, pool_id).astype(np.int64)


def do_rule(tree: CrushTree, rule: list, x: np.ndarray, result_max: int,
            reweight, ignore_out=False) -> np.ndarray:
    """[n, result_max] raw CRUSH results of inputs x (ITEM_NONE after
    the last device), for a rule TAKE, CHOOSE(LEAF)_FIRSTN, EMIT."""
    x = np.asarray(x, dtype=np.int64)
    result = np.full((len(x), result_max), ITEM_NONE, dtype=np.int64)
    root = None
    chosen = False
    for op, a1, a2 in rule:
        if op == TAKE:
            root = int(a1)
        elif op in (CHOOSE_FIRSTN, CHOOSELEAF_FIRSTN) and not chosen:
            chosen = True
            numrep = a1 if a1 > 0 else a1 + result_max
            got = choose_firstn(tree, x, root, numrep, int(a2),
                                op == CHOOSELEAF_FIRSTN,
                                np.asarray(reweight, np.int64),
                                ignore_out=ignore_out)
            w = min(result_max, got.shape[1])
            result[:, :w] = got[:, :w]
        elif op == EMIT:
            break
        else:
            raise ValueError("rule step %r is outside the reference" % op)
    return result


def up_sets(tree: CrushTree, rule: list, size: int, ps: np.ndarray,
            pgp_num: int, pool_id: int, reweight: np.ndarray,
            exists: np.ndarray, up: np.ndarray, ignore_out=False):
    """(up [n, size] with ITEM_NONE padding, up_primary [n]) of a
    replicated pool's PGs `ps`, as OSDMap::pg_to_up_acting_osds gives
    them for a map with no upmap, temp or primary-affinity entries."""
    raw = do_rule(tree, rule, pps(ps, pgp_num, pool_id), size, reweight,
                  ignore_out=ignore_out)
    dev = np.clip(raw, 0, len(exists) - 1)
    keep = (raw != ITEM_NONE) & exists[dev] & up[dev]
    order = np.argsort(~keep, axis=1, kind="stable")
    out = np.take_along_axis(np.where(keep, raw, ITEM_NONE), order, axis=1)
    primary = np.where(out[:, 0] != ITEM_NONE, out[:, 0], -1)
    return out, primary
