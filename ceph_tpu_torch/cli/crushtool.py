"""crushtool: compile, decompile and test crush maps.

Analog of src/tools/crushtool.cc over the same text format:

    python -m ceph_tpu.cli.crushtool -c map.txt -o map.bin
    python -m ceph_tpu.cli.crushtool -d map.bin [-o map.txt]
    python -m ceph_tpu.cli.crushtool -i map.bin --test --rule 0 \\
        --num-rep 3 [--min-x 0 --max-x 1023] [--show-utilization]
    python -m ceph_tpu.cli.crushtool --build --num-osds 12 \\
        host straw2 4 root straw2 0 -o map.bin

The binary form is the framework's denc encoding of the map (the
to_dict schema), not the reference's wire format.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..models.crushcompiler import ALG_BY_NAME, compile, decompile
from ..models.crushmap import (CHOOSELEAF_FIRSTN, EMIT, TAKE, CrushMap)
from ..models.crushtester import CrushTester
from ..utils import denc


def load_map(path: str) -> CrushMap:
    with open(path, "rb") as f:
        raw = f.read()
    try:
        return CrushMap.from_dict(denc.decode(raw))
    except Exception:
        return compile(raw.decode())


def save_map(m: CrushMap, path: str | None, text: bool = False) -> None:
    if text:
        data = decompile(m).encode()
    else:
        data = denc.encode(m.to_dict())
    if path is None or path == "-":
        sys.stdout.write(data.decode() if text else repr(data))
    else:
        with open(path, "wb") as f:
            f.write(data)


def build_map(num_osds: int, layers: list[tuple[str, str, int]]
              ) -> CrushMap:
    """--build: stack layers bottom-up (crushtool.cc --build).
    Each layer (name, alg, size): size children per bucket, 0 = one
    bucket holding everything."""
    m = CrushMap()
    m.types = {0: "osd"}
    lower = list(range(num_osds))
    lower_weights = [0x10000] * num_osds
    next_id = -1
    for depth, (tname, algname, size) in enumerate(layers, 1):
        m.types[depth] = tname
        alg = ALG_BY_NAME[algname]
        groups = []
        if size <= 0:
            groups = [list(range(len(lower)))]
        else:
            groups = [list(range(i, min(i + size, len(lower))))
                      for i in range(0, len(lower), size)]
        new_lower, new_weights = [], []
        for gi, g in enumerate(groups):
            items = [lower[i] for i in g]
            ws = [lower_weights[i] for i in g]
            b = m.add_bucket(alg, depth, items, ws, id=next_id,
                             name="%s%d" % (tname, gi))
            next_id -= 1
            new_lower.append(b.id)
            new_weights.append(b.weight)
        lower, lower_weights = new_lower, new_weights
    if len(lower) == 1:
        root = lower[0]
    else:
        m.types[len(layers) + 1] = "root"
        b = m.add_bucket(ALG_BY_NAME["straw2"], len(layers) + 1, lower,
                         lower_weights, id=next_id, name="root")
        root = b.id
    leaf_type = 1 if layers else 0
    m.add_rule([(TAKE, root, 0), (CHOOSELEAF_FIRSTN, 0, leaf_type),
                (EMIT, 0, 0)], id=0, name="replicated_rule")
    return m


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="crushtool")
    p.add_argument("-c", "--compile", metavar="SRC")
    p.add_argument("-d", "--decompile", metavar="SRC")
    p.add_argument("-i", "--input", metavar="SRC")
    p.add_argument("-o", "--output", metavar="DST")
    p.add_argument("--build", action="store_true")
    p.add_argument("--num-osds", type=int, default=0)
    p.add_argument("layers", nargs="*",
                   help="--build: name alg size triples")
    p.add_argument("--test", action="store_true")
    p.add_argument("--rule", type=int, default=0)
    p.add_argument("--num-rep", type=int, default=3)
    p.add_argument("--min-x", type=int, default=0)
    p.add_argument("--max-x", type=int, default=1023)
    p.add_argument("--show-utilization", action="store_true")
    p.add_argument("--show-bad-mappings", action="store_true")
    args = p.parse_args(argv)

    if args.compile:
        with open(args.compile) as f:
            m = compile(f.read())
        save_map(m, args.output or (args.compile + ".bin"))
        return 0
    if args.decompile:
        m = load_map(args.decompile)
        save_map(m, args.output or "-", text=True)
        return 0
    if args.build:
        if args.num_osds <= 0 or len(args.layers) % 3:
            p.error("--build needs --num-osds and name alg size triples")
        layers = [(args.layers[i], args.layers[i + 1],
                   int(args.layers[i + 2]))
                  for i in range(0, len(args.layers), 3)]
        m = build_map(args.num_osds, layers)
        save_map(m, args.output or "-",
                 text=(args.output in (None, "-")))
        return 0
    if args.test:
        if not args.input:
            p.error("--test needs -i MAP")
        m = load_map(args.input)
        tester = CrushTester(m)
        n = args.max_x - args.min_x + 1
        report = tester.test_rule(args.rule, args.num_rep, n,
                                  args.min_x)
        out = report.summary()
        if args.show_utilization:
            out["utilization"] = {
                "osd.%d" % d: round(r, 4)
                for d, r in sorted(report.utilization().items())}
            out["device_counts"] = {
                "osd.%d" % d: c
                for d, c in sorted(report.device_counts.items())}
        print(json.dumps(out, indent=1))
        return 0 if report.bad_mappings == 0 else 1
    p.error("one of -c, -d, --build, --test is required")
    return 2


if __name__ == "__main__":
    sys.exit(main())
