"""Plain CRUSH placement of erasure-coded PGs over straw2 trees.

The yardstick of the erasure-coded placement cells: NumPy over a batch of
PGs, written from the published algorithm (src/crush/mapper.c
crush_choose_indep and crush_do_rule; src/osd/OSDMap.cc
_remove_nonexistent_osds, _raw_to_up_osds and _pick_primary) and
importing nothing of the program.  The straw2 draw, the hashes, the
reweight test and the placement seed are `straw2.py`'s.

Derivation, for the case the cells run (straw2 buckets, a rule of
SET_CHOOSELEAF_TRIES, SET_CHOOSE_TRIES, TAKE, CHOOSE_INDEP or
CHOOSELEAF_INDEP, EMIT, the optimal tunables, no local retries):

- The rule's tries: choose_tries is the step's argument (else
  choose_total_tries + 1 = 51), leaf tries the step's argument (else 1).
- Positions rep = 0 .. numrep - 1 are filled in rounds ftotal = 0, 1, ...
  while ftotal < choose_tries.  In a round every position still
  undecided draws once, in order, at r = rep + parent_r + numrep * ftotal
  (parent_r 0 for the rule's step): one straw2 choice a level with that
  r from the rule's root down to an item of the step's type.
- A descent that reaches a device of another type, or an id outside the
  map, fills its position with ITEM_NONE for good.
- A pick equal to the pick at any position collides, and the position
  draws again next round.
- CHOOSELEAF: the leaf is a nested crush_choose_indep from the picked
  bucket with left = 1, outpos = rep and parent_r = r, for leaf-tries
  rounds: its r is rep + r + numrep * ftotal', a device that is out
  retries it, and where it places nothing the outer position draws
  again next round.  CHOOSE of devices: a device that is out retries
  the position.  A device is out when its reweight w is 0, or below
  0x10000 and hash32_2(x, device) & 0xffff >= w.
- A position still undecided after the last round is ITEM_NONE.
- The up set is positional (an erasure pool cannot shift its shards): an
  entry whose OSD does not exist or is not up becomes ITEM_NONE in
  place.  The up primary is the first entry that is not ITEM_NONE, or
  -1.  The cells set no primary affinity, upmap or temp entries.

Departures from mapper.c: none for the maps the cells build.  An empty
bucket, which none of them holds, is outside this reference (as in
straw2.py), and so are uniform buckets, whose r steps by numrep + 1.
"""

from __future__ import annotations

import numpy as np

from .straw2 import ITEM_NONE, CrushTree, is_out, pps

ITEM_UNDEF = 0x7FFFFFFE
TAKE, CHOOSE_INDEP, EMIT, CHOOSELEAF_INDEP = 1, 3, 4, 7
SET_CHOOSE_TRIES, SET_CHOOSELEAF_TRIES = 8, 9
TRIES = 51          # choose_total_tries 50, plus the historical one


class Tree(CrushTree):
    """A straw2 hierarchy (`straw2.CrushTree`) whose items' types are
    read from one table, for trees of hundreds of buckets."""

    def __init__(self, buckets, max_devices: int):
        super().__init__(buckets, max_devices)
        lo = min(self.buckets, default=-1)
        self._types = np.zeros(-lo + 1, dtype=np.int64)
        for b, (t, _i, _w) in self.buckets.items():
            self._types[-1 - b] = t

    def type_of(self, item: np.ndarray) -> np.ndarray:
        item = np.asarray(item, dtype=np.int64)
        bid = np.clip(-1 - item, 0, len(self._types) - 1)
        return np.where(item < 0, self._types[bid], 0)


def _leaf(tree: CrushTree, x, bucket, rep: int, parent_r, numrep: int,
          tries: int, reweight, ignore_out: bool) -> np.ndarray:
    """The nested crush_choose_indep of a CHOOSELEAF position: per PG,
    the leaf under `bucket` (ITEM_NONE where none is placed)."""
    got = np.full(len(x), ITEM_NONE, dtype=np.int64)
    todo = np.arange(len(x))
    for ftotal in range(tries):
        if not len(todo):
            break
        r = rep + parent_r[todo] + numrep * ftotal
        item, ok = tree.descend(x[todo], bucket[todo], r, 0)
        placed = ok.copy()
        if not ignore_out:
            d = np.nonzero(ok)[0]
            placed[d[is_out(reweight, item[d], x[todo][d])]] = False
        got[todo[placed]] = item[placed]
        # a bad item ends the nested call (ITEM_NONE); an out device
        # draws again
        todo = todo[ok & ~placed]
    return got


def choose_indep(tree: CrushTree, x, root: int, numrep: int, left: int,
                 want_type: int, leaf: bool, reweight, tries: int,
                 leaf_tries: int, ignore_out: bool = False) -> np.ndarray:
    """[n, left] positional picks of a rule's indep step (the leaves for
    CHOOSELEAF), ITEM_NONE where a position fails.  `ignore_out` skips
    the reweight test (the benchmark's control, which breaks the
    no-out-device guarantee)."""
    x = np.asarray(x, dtype=np.int64)
    n = len(x)
    out = np.full((n, left), ITEM_UNDEF, dtype=np.int64)
    out2 = out.copy()
    reweight = np.asarray(reweight, dtype=np.int64)
    for ftotal in range(tries):
        if not (out == ITEM_UNDEF).any():
            break
        for rep in range(left):
            idx = np.nonzero(out[:, rep] == ITEM_UNDEF)[0]
            if not len(idx):
                continue
            xi = x[idx]
            r = np.full(len(idx), rep + numrep * ftotal, dtype=np.int64)
            item, ok = tree.descend(xi, np.full(len(idx), root), r,
                                    want_type)
            out[idx[~ok], rep] = ITEM_NONE
            out2[idx[~ok], rep] = ITEM_NONE
            collide = (out[idx] == item[:, None]).any(axis=1)
            placed = ok & ~collide
            lf = item.copy()
            if leaf:
                s = np.nonzero(placed & (item < 0))[0]
                got = _leaf(tree, xi[s], item[s], rep, r[s], numrep,
                            leaf_tries, reweight, ignore_out)
                lf[s] = got
                placed[s[got == ITEM_NONE]] = False
            if want_type == 0 and not ignore_out:
                d = np.nonzero(placed)[0]
                placed[d[is_out(reweight, item[d], xi[d])]] = False
            out[idx[placed], rep] = item[placed]
            out2[idx[placed], rep] = lf[placed]
    res = out2 if leaf else out
    return np.where(res == ITEM_UNDEF, ITEM_NONE, res)


def do_rule(tree: CrushTree, rule: list, x: np.ndarray, result_max: int,
            reweight, ignore_out: bool = False) -> np.ndarray:
    """[n, result_max] raw positional CRUSH results of inputs x, for a
    rule of tries steps, TAKE, one CHOOSE(LEAF)_INDEP step, EMIT."""
    x = np.asarray(x, dtype=np.int64)
    result = np.full((len(x), result_max), ITEM_NONE, dtype=np.int64)
    tries, leaf_tries = TRIES, 0
    root = None
    chosen = False
    for op, a1, a2 in rule:
        if op == SET_CHOOSE_TRIES:
            if a1 > 0:
                tries = int(a1)
        elif op == SET_CHOOSELEAF_TRIES:
            if a1 > 0:
                leaf_tries = int(a1)
        elif op == TAKE:
            root = int(a1)
        elif op in (CHOOSE_INDEP, CHOOSELEAF_INDEP) and not chosen:
            chosen = True
            numrep = a1 if a1 > 0 else a1 + result_max
            left = min(numrep, result_max)
            got = choose_indep(tree, x, root, numrep, left, int(a2),
                               op == CHOOSELEAF_INDEP, reweight, tries,
                               leaf_tries or 1, ignore_out=ignore_out)
            result[:, :left] = got
        elif op == EMIT:
            break
        else:
            raise ValueError("rule step %r is outside the reference" % op)
    return result


def up_sets(tree: CrushTree, rule: list, size: int, ps: np.ndarray,
            pgp_num: int, pool_id: int, reweight: np.ndarray,
            exists: np.ndarray, up: np.ndarray, ignore_out: bool = False):
    """(up [n, size] positional with ITEM_NONE holes, up_primary [n]) of
    an erasure pool's PGs `ps`, as OSDMap::pg_to_up_acting_osds gives
    them for a map with no upmap, temp or primary-affinity entries."""
    raw = do_rule(tree, rule, pps(ps, pgp_num, pool_id), size, reweight,
                  ignore_out=ignore_out)
    dev = np.clip(raw, 0, len(exists) - 1)
    keep = (raw >= 0) & (raw < len(exists)) & exists[dev] & up[dev]
    out = np.where(keep, raw, ITEM_NONE)
    has = keep.any(axis=1)
    primary = np.where(has, out[np.arange(len(out)), keep.argmax(axis=1)],
                       -1)
    return out, primary
