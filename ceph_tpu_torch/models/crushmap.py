"""CRUSH map model: buckets, rules, tunables, choose_args.

A declarative description of the placement hierarchy, consumed by both
the host interpreter (ops.crush.host) and the bulk device mapper
(ops.crush.device).

Reference semantics: struct crush_map / crush_bucket / crush_rule
(src/crush/crush.h) and the construction rules in src/crush/builder.c —
list buckets carry cumulative sums, tree buckets a 1-indexed implicit
binary tree of node weights, straw buckets the v0/v1 straw-length
computation, straw2 plain 16.16 item weights.  All weights are 16.16
fixed point.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

# bucket algorithms
UNIFORM, LIST, TREE, STRAW, STRAW2 = 1, 2, 3, 4, 5
ALG_NAMES = {UNIFORM: "uniform", LIST: "list", TREE: "tree",
             STRAW: "straw", STRAW2: "straw2"}

# rule step opcodes
NOOP = 0
TAKE = 1
CHOOSE_FIRSTN = 2
CHOOSE_INDEP = 3
EMIT = 4
CHOOSELEAF_FIRSTN = 6
CHOOSELEAF_INDEP = 7
SET_CHOOSE_TRIES = 8
SET_CHOOSELEAF_TRIES = 9
SET_CHOOSE_LOCAL_TRIES = 10
SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
SET_CHOOSELEAF_VARY_R = 12
SET_CHOOSELEAF_STABLE = 13

ITEM_UNDEF = 0x7FFFFFFE  # internal: slot not yet decided (indep)
ITEM_NONE = 0x7FFFFFFF   # exported: no mapping for this slot

RJENKINS1 = 0


@dataclass
class Bucket:
    """One interior node of the hierarchy (negative id)."""

    id: int                      # < 0
    alg: int
    type: int                    # hierarchy level (e.g. 1=host, 2=rack...)
    items: list[int]             # child ids (devices >= 0, buckets < 0)
    weight: int = 0              # 16.16 total
    hash: int = RJENKINS1
    name: str = ""               # bucket name (compiler/tooling)
    # per-algorithm derived state
    item_weight: int = 0               # uniform: shared weight
    item_weights: list[int] = field(default_factory=list)  # list/straw/straw2
    sum_weights: list[int] = field(default_factory=list)   # list: cumulative
    node_weights: list[int] = field(default_factory=list)  # tree: 1-indexed
    straws: list[int] = field(default_factory=list)        # straw: lengths

    @property
    def size(self) -> int:
        return len(self.items)

    def to_dict(self) -> dict:
        return {
            "id": self.id, "alg": self.alg, "type": self.type,
            "items": self.items, "weight": self.weight, "hash": self.hash,
            "name": self.name,
            "item_weight": self.item_weight,
            "item_weights": self.item_weights,
            "sum_weights": self.sum_weights,
            "node_weights": self.node_weights,
            "straws": self.straws,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Bucket":
        d = dict(d)
        d.setdefault("name", "")
        return cls(**d)


@dataclass
class Rule:
    """A placement rule: a short program over (op, arg1, arg2) steps."""

    id: int
    steps: list[tuple[int, int, int]]
    name: str = ""

    def to_dict(self) -> dict:
        return {"id": self.id, "name": self.name,
                "steps": [list(s) for s in self.steps]}

    @classmethod
    def from_dict(cls, d: dict) -> "Rule":
        return cls(id=d["id"], name=d.get("name", ""),
                   steps=[tuple(s) for s in d["steps"]])


@dataclass
class Tunables:
    """Retry-behaviour knobs.  Defaults = the reference's optimal profile."""

    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    choose_total_tries: int = 50
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1
    straw_calc_version: int = 1

    @classmethod
    def legacy(cls) -> "Tunables":
        return cls(choose_local_tries=2, choose_local_fallback_tries=5,
                   choose_total_tries=19, chooseleaf_descend_once=0,
                   chooseleaf_vary_r=0, chooseleaf_stable=0,
                   straw_calc_version=0)

    def to_dict(self) -> dict:
        return self.__dict__.copy()

    @classmethod
    def from_dict(cls, d: dict) -> "Tunables":
        return cls(**d)


@dataclass
class WeightSet:
    """choose_args entry for one bucket: per-position weight vectors and
    optional id remapping (the balancer's retry-free lever)."""

    bucket_id: int
    weight_sets: list[list[int]] = field(default_factory=list)  # [pos][i]
    ids: list[int] | None = None

    def to_dict(self) -> dict:
        return {"bucket_id": self.bucket_id, "weight_sets": self.weight_sets,
                "ids": self.ids}

    @classmethod
    def from_dict(cls, d: dict) -> "WeightSet":
        return cls(**d)


class CrushMap:
    """The full placement map."""

    def __init__(self, tunables: Tunables | None = None):
        self.buckets: dict[int, Bucket] = {}       # id (<0) -> bucket
        self.rules: dict[int, Rule] = {}
        self.types: dict[int, str] = {0: "osd"}    # hierarchy level names
        self.tunables = tunables or Tunables()
        self.choose_args: dict[str, dict[int, WeightSet]] = {}
        self.device_classes: dict[int, str] = {}   # device id -> class name

    # -- derived ---------------------------------------------------------
    @property
    def max_devices(self) -> int:
        mx = 0
        for b in self.buckets.values():
            for item in b.items:
                if item >= mx:
                    mx = item + 1
        return mx

    @property
    def max_buckets(self) -> int:
        return max((-b for b in self.buckets), default=0)

    def bucket(self, item: int) -> Bucket | None:
        return self.buckets.get(item)

    # -- construction ----------------------------------------------------
    def add_bucket(
        self, alg: int, type: int, items: list[int], weights: list[int],
        id: int | None = None, hash: int = RJENKINS1, name: str = "",
    ) -> Bucket:
        """Create a bucket, deriving its per-algorithm state the same way
        the reference builder does (builder.c:190-639)."""
        if id is None:
            id = -(self.max_buckets + 1)
        assert id < 0 and id not in self.buckets
        assert len(items) == len(weights)
        b = Bucket(id=id, alg=alg, type=type, items=list(items), hash=hash,
                   name=name)
        if alg == UNIFORM:
            # uniform buckets share one item weight (first entry wins)
            b.item_weight = weights[0] if weights else 0
            b.weight = b.item_weight * len(items)
        elif alg == LIST:
            b.item_weights = list(weights)
            w = 0
            for wi in weights:
                w += wi
                b.sum_weights.append(w)
            b.weight = w
        elif alg == TREE:
            depth = _tree_depth(len(items))
            b.node_weights = [0] * (1 << depth)
            for i, wi in enumerate(weights):
                node = _tree_leaf_node(i)
                b.node_weights[node] = wi
                b.weight += wi
                for _ in range(1, depth):
                    node = _tree_parent(node)
                    b.node_weights[node] += wi
        elif alg == STRAW:
            b.item_weights = list(weights)
            b.weight = sum(weights)
            b.straws = _calc_straws(weights, self.tunables.straw_calc_version)
        elif alg == STRAW2:
            b.item_weights = list(weights)
            b.weight = sum(weights)
        else:
            raise ValueError(f"unknown bucket alg {alg}")
        self.buckets[id] = b
        return b

    def add_rule(self, steps: list[tuple[int, int, int]],
                 id: int | None = None, name: str = "") -> Rule:
        if id is None:
            id = max(self.rules, default=-1) + 1
        r = Rule(id=id, steps=[tuple(s) for s in steps], name=name)
        self.rules[id] = r
        return r

    # -- convenience hierarchy builder -----------------------------------
    def build_flat(self, n_osds: int, alg: int = STRAW2,
                   weights: list[int] | None = None) -> Bucket:
        """One root bucket over n_osds devices (weights 16.16, default 1.0)."""
        w = weights or [0x10000] * n_osds
        return self.add_bucket(alg, 1, list(range(n_osds)), w)

    # -- serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "buckets": [b.to_dict() for b in self.buckets.values()],
            "rules": [r.to_dict() for r in self.rules.values()],
            "types": self.types,
            "tunables": self.tunables.to_dict(),
            "choose_args": {
                name: [ws.to_dict() for ws in per.values()]
                for name, per in self.choose_args.items()
            },
            "device_classes": self.device_classes,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CrushMap":
        m = cls(Tunables.from_dict(d["tunables"]))
        for bd in d["buckets"]:
            b = Bucket.from_dict(bd)
            m.buckets[b.id] = b
        for rd in d["rules"]:
            r = Rule.from_dict(rd)
            m.rules[r.id] = r
        m.types = {int(k): v for k, v in d.get("types", {0: "osd"}).items()}
        for name, lst in d.get("choose_args", {}).items():
            m.choose_args[name] = {
                ws["bucket_id"]: WeightSet.from_dict(ws) for ws in lst
            }
        m.device_classes = {
            int(k): v for k, v in d.get("device_classes", {}).items()
        }
        return m


# -- tree bucket geometry (builder.c:294-327, crush.h:494) ----------------

def _tree_leaf_node(i: int) -> int:
    return ((i + 1) << 1) - 1


def _tree_height(n: int) -> int:
    h = 0
    while (n & 1) == 0:
        h += 1
        n >>= 1
    return h


def _tree_parent(n: int) -> int:
    h = _tree_height(n)
    if n & (1 << (h + 1)):
        return n - (1 << h)
    return n + (1 << h)


def _tree_depth(size: int) -> int:
    if size == 0:
        return 0
    depth = 1
    t = size - 1
    while t:
        t >>= 1
        depth += 1
    return depth


# -- legacy straw lengths (builder.c:430-546) -----------------------------

def _calc_straws(weights: list[int], version: int) -> list[int]:
    """Straw lengths for the legacy straw algorithm.

    Kept for map compatibility; the reference itself documents the
    approach as flawed and superseded by straw2.  Version 0 skips the
    numleft decrement for zero-weight items; version 1 decrements.
    """
    size = len(weights)
    straws = [0] * size
    # reverse = indices sorted ascending by weight (stable insertion order)
    reverse = sorted(range(size), key=lambda i: (weights[i], i))

    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        if weights[reverse[i]] == 0:
            straws[reverse[i]] = 0
            i += 1
            if version >= 1:
                numleft -= 1
            continue
        straws[reverse[i]] = int(straw * 0x10000)
        i += 1
        if i == size:
            break
        if version == 0:
            if weights[reverse[i]] == weights[reverse[i - 1]]:
                continue
            wbelow += (float(weights[reverse[i - 1]]) - lastw) * numleft
            j = i
            while j < size:
                if weights[reverse[j]] == weights[reverse[i]]:
                    numleft -= 1
                else:
                    break
                j += 1
            wnext = numleft * (weights[reverse[i]] - weights[reverse[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= math.pow(1.0 / pbelow, 1.0 / numleft)
            lastw = weights[reverse[i - 1]]
        else:
            wbelow += (float(weights[reverse[i - 1]]) - lastw) * numleft
            numleft -= 1
            wnext = numleft * (weights[reverse[i]] - weights[reverse[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= math.pow(1.0 / pbelow, 1.0 / numleft)
            lastw = weights[reverse[i - 1]]
    return straws
