"""Host (scalar) CRUSH mapping engine — the bit-exact reference path.

Single-PG queries on the request-routing path use this engine; bulk
maps and remaps use the device mapper (ops.crush.device).  Both
produce identical mappings.

Reference semantics re-derived from src/crush/mapper.c: bucket choose
methods (:51-396), is_out (:402), crush_choose_firstn (:438),
crush_choose_indep (:633), and the crush_do_rule step VM (:878).
Structured here as a Mapper class over the declarative CrushMap model
rather than C workspaces; per-uniform-bucket permutation state lives in
a per-call dict.
"""

from __future__ import annotations

from ...models.crushmap import (
    CHOOSE_FIRSTN,
    CHOOSE_INDEP,
    CHOOSELEAF_FIRSTN,
    CHOOSELEAF_INDEP,
    EMIT,
    ITEM_NONE,
    ITEM_UNDEF,
    LIST,
    SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    SET_CHOOSE_LOCAL_TRIES,
    SET_CHOOSE_TRIES,
    SET_CHOOSELEAF_STABLE,
    SET_CHOOSELEAF_TRIES,
    SET_CHOOSELEAF_VARY_R,
    STRAW,
    STRAW2,
    TAKE,
    TREE,
    UNIFORM,
    Bucket,
    CrushMap,
    WeightSet,
)
from ._ln_tables import LL_TBL, RH_LH_TBL
from .hashes import hash32_2, hash32_3, hash32_4

S64_MIN = -(1 << 63)
_U64 = (1 << 64) - 1


def crush_ln(xin: int) -> int:
    """2^44 * log2(xin + 1) in fixed point (mapper.c:226-268)."""
    x = xin + 1
    iexpon = 15
    if not (x & 0x18000):
        bits = 16 - x.bit_length()
        x <<= bits
        iexpon = 15 - bits
    index1 = (x >> 8) << 1
    rh = RH_LH_TBL[index1 - 256]
    lh = RH_LH_TBL[index1 + 1 - 256]
    xl64 = (x * rh) & _U64
    xl64 >>= 48
    index2 = xl64 & 0xFF
    lh = (lh + LL_TBL[index2]) >> 4
    return (iexpon << 44) + lh


def _div_s64(a: int, b: int) -> int:
    """C-style truncating signed 64-bit division."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _exponential_draw(x: int, y: int, z: int, weight: int) -> int:
    """Scaled exponential variate: ln(U)/weight, U ~ hash16 (mapper.c:312)."""
    u = hash32_3(x, y, z) & 0xFFFF
    ln = crush_ln(u) - 0x1000000000000
    return _div_s64(ln, weight)


class _PermWork:
    """Permutation state for one uniform bucket (mapper.c:51-109)."""

    __slots__ = ("perm_x", "perm_n", "perm")

    def __init__(self, size: int):
        self.perm_x = 0
        self.perm_n = 0
        self.perm = [0] * size


class Mapper:
    """Evaluates rules against a CrushMap for one input x at a time."""

    def __init__(self, crushmap: CrushMap):
        self.map = crushmap

    # -- bucket choose methods -------------------------------------------

    def _perm_choose(self, b: Bucket, work: dict, x: int, r: int) -> int:
        w = work.get(b.id)
        if w is None:
            w = work[b.id] = _PermWork(b.size)
        pr = r % b.size
        if w.perm_x != (x & 0xFFFFFFFF) or w.perm_n == 0:
            w.perm_x = x & 0xFFFFFFFF
            if pr == 0:
                s = hash32_3(x, b.id, 0) % b.size
                w.perm[0] = s
                w.perm_n = 0xFFFF  # marks the r=0 shortcut
                return b.items[s]
            w.perm = list(range(b.size))
            w.perm_n = 0
        elif w.perm_n == 0xFFFF:
            # expand the r=0 shortcut into a real partial permutation
            for i in range(1, b.size):
                w.perm[i] = i
            w.perm[w.perm[0]] = 0
            w.perm_n = 1
        while w.perm_n <= pr:
            p = w.perm_n
            if p < b.size - 1:
                i = hash32_3(x, b.id, p) % (b.size - p)
                if i:
                    w.perm[p + i], w.perm[p] = w.perm[p], w.perm[p + i]
            w.perm_n += 1
        return b.items[w.perm[pr]]

    def _list_choose(self, b: Bucket, x: int, r: int) -> int:
        for i in range(b.size - 1, -1, -1):
            w = hash32_4(x, b.items[i], r, b.id) & 0xFFFF
            w = (w * b.sum_weights[i]) >> 16
            if w < b.item_weights[i]:
                return b.items[i]
        return b.items[0]

    def _tree_choose(self, b: Bucket, x: int, r: int) -> int:
        n = len(b.node_weights) >> 1  # root
        while not (n & 1):
            w = b.node_weights[n]
            t = (hash32_4(x, n, r, b.id) * w) >> 32
            # descend left if the pick lands inside the left subtree
            h = _height(n)
            left = n - (1 << (h - 1))
            if t < b.node_weights[left]:
                n = left
            else:
                n = left + (1 << h)
        return b.items[n >> 1]

    def _straw_choose(self, b: Bucket, x: int, r: int) -> int:
        high, high_draw = 0, 0
        for i in range(b.size):
            draw = (hash32_3(x, b.items[i], r) & 0xFFFF) * b.straws[i]
            if i == 0 or draw > high_draw:
                high, high_draw = i, draw
        return b.items[high]

    def _straw2_choose(
        self, b: Bucket, x: int, r: int,
        arg: WeightSet | None, position: int,
    ) -> int:
        weights = b.item_weights
        ids = b.items
        if arg is not None:
            if arg.weight_sets:
                pos = min(position, len(arg.weight_sets) - 1)
                weights = arg.weight_sets[pos]
            if arg.ids is not None:
                ids = arg.ids
        high, high_draw = 0, 0
        for i in range(b.size):
            if weights[i]:
                draw = _exponential_draw(x, ids[i], r, weights[i])
            else:
                draw = S64_MIN
            if i == 0 or draw > high_draw:
                high, high_draw = i, draw
        return b.items[high]

    def _bucket_choose(
        self, b: Bucket, work: dict, x: int, r: int,
        arg: WeightSet | None, position: int,
    ) -> int:
        if b.alg == UNIFORM:
            return self._perm_choose(b, work, x, r)
        if b.alg == LIST:
            return self._list_choose(b, x, r)
        if b.alg == TREE:
            return self._tree_choose(b, x, r)
        if b.alg == STRAW:
            return self._straw_choose(b, x, r)
        if b.alg == STRAW2:
            return self._straw2_choose(b, x, r, arg, position)
        return b.items[0]

    # -- device reweight rejection (mapper.c:402-416) --------------------

    def _is_out(self, weights: list[int], item: int, x: int) -> bool:
        if item >= len(weights):
            return True
        w = weights[item]
        if w >= 0x10000:
            return False
        if w == 0:
            return True
        return (hash32_2(x, item) & 0xFFFF) >= w

    # -- depth-first choose with retries (mapper.c:438-626) --------------

    def _choose_firstn(
        self, bucket: Bucket, work: dict, weights: list[int],
        x: int, numrep: int, type: int,
        out: list[int], outpos: int, out_size: int,
        tries: int, recurse_tries: int,
        local_retries: int, local_fallback_retries: int,
        recurse_to_leaf: bool, vary_r: int, stable: int,
        out2: list[int] | None, parent_r: int,
        choose_args: dict[int, WeightSet] | None,
    ) -> int:
        m = self.map
        count = out_size
        rep = 0 if stable else outpos
        while rep < numrep and count > 0:
            ftotal = 0
            skip_rep = False
            retry_descent = True
            while retry_descent:
                retry_descent = False
                in_b = bucket
                flocal = 0
                retry_bucket = True
                while retry_bucket:
                    retry_bucket = False
                    collide = False
                    r = rep + parent_r + ftotal
                    if in_b.size == 0:
                        reject = True
                    else:
                        if (local_fallback_retries > 0
                                and flocal >= (in_b.size >> 1)
                                and flocal > local_fallback_retries):
                            item = self._perm_choose(in_b, work, x, r)
                        else:
                            item = self._bucket_choose(
                                in_b, work, x, r,
                                choose_args.get(in_b.id) if choose_args else None,
                                outpos)
                        if item >= m.max_devices:
                            skip_rep = True
                            break
                        itemtype = m.buckets[item].type if item < 0 else 0
                        if itemtype != type:
                            if item >= 0 or item not in m.buckets:
                                skip_rep = True
                                break
                            in_b = m.buckets[item]
                            retry_bucket = True
                            continue
                        for i in range(outpos):
                            if out[i] == item:
                                collide = True
                                break
                        reject = False
                        if not collide and recurse_to_leaf:
                            if item < 0:
                                sub_r = r >> (vary_r - 1) if vary_r else 0
                                got = self._choose_firstn(
                                    m.buckets[item], work, weights, x,
                                    1 if stable else outpos + 1, 0,
                                    out2, outpos, count,
                                    recurse_tries, 0,
                                    local_retries, local_fallback_retries,
                                    False, vary_r, stable, None, sub_r,
                                    choose_args)
                                if got <= outpos:
                                    reject = True  # didn't reach a leaf
                            else:
                                out2[outpos] = item
                        if not reject and not collide and itemtype == 0:
                            reject = self._is_out(weights, item, x)
                    if reject or collide:
                        ftotal += 1
                        flocal += 1
                        if collide and flocal <= local_retries:
                            retry_bucket = True
                        elif (local_fallback_retries > 0
                              and flocal <= in_b.size + local_fallback_retries):
                            retry_bucket = True
                        elif ftotal < tries:
                            retry_descent = True
                        else:
                            skip_rep = True
                        if not retry_bucket:
                            break
            if skip_rep:
                rep += 1
                continue
            out[outpos] = item
            outpos += 1
            count -= 1
            rep += 1
        return outpos

    # -- breadth-first positionally-stable choose (mapper.c:633-821) -----

    def _choose_indep(
        self, bucket: Bucket, work: dict, weights: list[int],
        x: int, left: int, numrep: int, type: int,
        out: list[int], outpos: int,
        tries: int, recurse_tries: int, recurse_to_leaf: bool,
        out2: list[int] | None, parent_r: int,
        choose_args: dict[int, WeightSet] | None,
    ) -> None:
        m = self.map
        endpos = outpos + left
        for rep in range(outpos, endpos):
            out[rep] = ITEM_UNDEF
            if out2 is not None:
                out2[rep] = ITEM_UNDEF
        ftotal = 0
        while left > 0 and ftotal < tries:
            for rep in range(outpos, endpos):
                if out[rep] != ITEM_UNDEF:
                    continue
                in_b = bucket
                while True:
                    r = rep + parent_r
                    if in_b.alg == UNIFORM and in_b.size % numrep == 0:
                        r += (numrep + 1) * ftotal
                    else:
                        r += numrep * ftotal
                    if in_b.size == 0:
                        break
                    item = self._bucket_choose(
                        in_b, work, x, r,
                        choose_args.get(in_b.id) if choose_args else None,
                        outpos)
                    if item >= m.max_devices:
                        out[rep] = ITEM_NONE
                        if out2 is not None:
                            out2[rep] = ITEM_NONE
                        left -= 1
                        break
                    itemtype = m.buckets[item].type if item < 0 else 0
                    if itemtype != type:
                        if item >= 0 or item not in m.buckets:
                            out[rep] = ITEM_NONE
                            if out2 is not None:
                                out2[rep] = ITEM_NONE
                            left -= 1
                            break
                        in_b = m.buckets[item]
                        continue
                    collide = False
                    for i in range(outpos, endpos):
                        if out[i] == item:
                            collide = True
                            break
                    if collide:
                        break
                    if recurse_to_leaf:
                        if item < 0:
                            self._choose_indep(
                                m.buckets[item], work, weights, x,
                                1, numrep, 0, out2, rep,
                                recurse_tries, 0, False, None, r,
                                choose_args)
                            if out2[rep] == ITEM_NONE:
                                break
                        elif out2 is not None:
                            out2[rep] = item
                    if itemtype == 0 and self._is_out(weights, item, x):
                        break
                    out[rep] = item
                    left -= 1
                    break
            ftotal += 1
        for rep in range(outpos, endpos):
            if out[rep] == ITEM_UNDEF:
                out[rep] = ITEM_NONE
            if out2 is not None and out2[rep] == ITEM_UNDEF:
                out2[rep] = ITEM_NONE

    # -- rule VM (mapper.c:878-1083) -------------------------------------

    def do_rule(
        self, ruleno: int, x: int, result_max: int,
        weights: list[int],
        choose_args: dict[int, WeightSet] | None = None,
    ) -> list[int]:
        """Map input x to a list of devices (may contain ITEM_NONE holes
        for indep/EC rules)."""
        m = self.map
        rule = m.rules.get(ruleno)
        if rule is None:
            return []
        t = m.tunables
        choose_tries = t.choose_total_tries + 1  # historical off-by-one
        choose_leaf_tries = 0
        choose_local_retries = t.choose_local_tries
        choose_local_fallback_retries = t.choose_local_fallback_tries
        vary_r = t.chooseleaf_vary_r
        stable = t.chooseleaf_stable

        work: dict = {}  # uniform-bucket permutation state, per call
        result: list[int] = []
        w: list[int] = [0] * result_max
        o: list[int] = [0] * result_max
        c: list[int] = [0] * result_max
        wsize = 0

        for op, arg1, arg2 in rule.steps:
            if op == TAKE:
                if (0 <= arg1 < m.max_devices) or arg1 in m.buckets:
                    w[0] = arg1
                    wsize = 1
            elif op == SET_CHOOSE_TRIES:
                if arg1 > 0:
                    choose_tries = arg1
            elif op == SET_CHOOSELEAF_TRIES:
                if arg1 > 0:
                    choose_leaf_tries = arg1
            elif op == SET_CHOOSE_LOCAL_TRIES:
                if arg1 >= 0:
                    choose_local_retries = arg1
            elif op == SET_CHOOSE_LOCAL_FALLBACK_TRIES:
                if arg1 >= 0:
                    choose_local_fallback_retries = arg1
            elif op == SET_CHOOSELEAF_VARY_R:
                if arg1 >= 0:
                    vary_r = arg1
            elif op == SET_CHOOSELEAF_STABLE:
                if arg1 >= 0:
                    stable = arg1
            elif op in (CHOOSE_FIRSTN, CHOOSE_INDEP,
                        CHOOSELEAF_FIRSTN, CHOOSELEAF_INDEP):
                if wsize == 0:
                    continue
                firstn = op in (CHOOSE_FIRSTN, CHOOSELEAF_FIRSTN)
                recurse_to_leaf = op in (CHOOSELEAF_FIRSTN, CHOOSELEAF_INDEP)
                osize = 0
                for i in range(wsize):
                    numrep = arg1
                    if numrep <= 0:
                        numrep += result_max
                        if numrep <= 0:
                            continue
                    bucket = m.buckets.get(w[i])
                    if bucket is None:
                        continue
                    # each take-item writes into a fresh window at o+osize
                    # (the C code passes pointer offsets; collision checks
                    # are local to the window)
                    avail = result_max - osize
                    o_win = [0] * avail
                    c_win = [0] * avail
                    if firstn:
                        if choose_leaf_tries:
                            recurse_tries = choose_leaf_tries
                        elif t.chooseleaf_descend_once:
                            recurse_tries = 1
                        else:
                            recurse_tries = choose_tries
                        n = self._choose_firstn(
                            bucket, work, weights, x, numrep, arg2,
                            o_win, 0, avail,
                            choose_tries, recurse_tries,
                            choose_local_retries,
                            choose_local_fallback_retries,
                            recurse_to_leaf, vary_r, stable,
                            c_win, 0, choose_args)
                    else:
                        n = min(numrep, avail)
                        self._choose_indep(
                            bucket, work, weights, x, n, numrep,
                            arg2, o_win, 0,
                            choose_tries,
                            choose_leaf_tries if choose_leaf_tries else 1,
                            recurse_to_leaf, c_win, 0, choose_args)
                    o[osize:osize + n] = o_win[:n]
                    c[osize:osize + n] = c_win[:n]
                    osize += n
                if recurse_to_leaf:
                    o[:osize] = c[:osize]
                w, o = o, w
                wsize = osize
            elif op == EMIT:
                for i in range(wsize):
                    if len(result) >= result_max:
                        break
                    result.append(w[i])
                wsize = 0
        return result


def _height(n: int) -> int:
    h = 0
    while (n & 1) == 0:
        h += 1
        n >>= 1
    return h
