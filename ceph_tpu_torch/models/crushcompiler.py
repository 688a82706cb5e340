"""CrushCompiler: the crush map text format, compile + decompile.

Re-derivation of src/crush/CrushCompiler.cc: the same section grammar
crushtool speaks —

    tunable <name> <value>
    device <num> osd.<num> [class <name>]
    type <num> <name>
    <typename> <bucketname> {
        id <num>
        alg uniform|list|tree|straw|straw2
        hash 0
        item <name> weight <float> [pos <n>]
    }
    rule <name> {
        id <num>
        type replicated|erasure
        step take <bucketname> [class <name>]
        step set_<tunable> <value>
        step choose|chooseleaf firstn|indep <n> type <typename>
        step emit
    }

compile() parses text into a CrushMap; decompile() emits text that
round-trips (compile(decompile(m)) maps identically to m).  Weights
are printed with 5 decimals of the 16.16 fixed point, exactly like the
reference's decompile output.
"""

from __future__ import annotations

from .crushmap import (CHOOSE_FIRSTN, CHOOSE_INDEP, CHOOSELEAF_FIRSTN,
                       CHOOSELEAF_INDEP, EMIT, LIST, STRAW, STRAW2,
                       TAKE, TREE, UNIFORM, CrushMap, Tunables)
from .crushmap import (SET_CHOOSE_LOCAL_FALLBACK_TRIES,
                       SET_CHOOSE_LOCAL_TRIES, SET_CHOOSE_TRIES,
                       SET_CHOOSELEAF_STABLE, SET_CHOOSELEAF_TRIES,
                       SET_CHOOSELEAF_VARY_R)

ALG_BY_NAME = {"uniform": UNIFORM, "list": LIST, "tree": TREE,
               "straw": STRAW, "straw2": STRAW2}
ALG_NAME = {v: k for k, v in ALG_BY_NAME.items()}

SET_STEPS = {
    "set_choose_tries": SET_CHOOSE_TRIES,
    "set_chooseleaf_tries": SET_CHOOSELEAF_TRIES,
    "set_choose_local_tries": SET_CHOOSE_LOCAL_TRIES,
    "set_choose_local_fallback_tries": SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    "set_chooseleaf_vary_r": SET_CHOOSELEAF_VARY_R,
    "set_chooseleaf_stable": SET_CHOOSELEAF_STABLE,
}
SET_STEP_NAME = {v: k for k, v in SET_STEPS.items()}

TUNABLES = ("choose_local_tries", "choose_local_fallback_tries",
            "choose_total_tries", "chooseleaf_descend_once",
            "chooseleaf_vary_r", "chooseleaf_stable",
            "straw_calc_version")


class CompileError(ValueError):
    pass


def _tokenize(text: str):
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        yield lineno, line.replace("{", " { ").replace("}", " } ").split()


def compile(text: str) -> CrushMap:  # noqa: A001 (reference name)
    m = CrushMap(Tunables())
    m.types = {}
    devices: dict[str, int] = {}
    bucket_sections: list[tuple[int, list[list[str]]]] = []
    rule_sections: list[tuple[int, list[list[str]]]] = []
    toks = list(_tokenize(text))
    i = 0

    def collect_section(start: int):
        body = []
        j = start
        while j < len(toks) and "}" not in toks[j][1]:
            body.append(toks[j][1])
            j += 1
        if j >= len(toks):
            raise CompileError("unterminated section at line %d"
                               % toks[start - 1][0])
        return body, j + 1

    while i < len(toks):
        lineno, words = toks[i]
        head = words[0]
        if head == "tunable":
            if words[1] not in TUNABLES:
                raise CompileError("line %d: unknown tunable %r"
                                   % (lineno, words[1]))
            setattr(m.tunables, words[1], int(words[2]))
            i += 1
        elif head == "device":
            num = int(words[1])
            devices[words[2]] = num
            if len(words) >= 5 and words[3] == "class":
                m.device_classes[num] = words[4]
            i += 1
        elif head == "type":
            m.types[int(words[1])] = words[2]
            i += 1
        elif head == "rule" and words[-1] == "{":
            body, i = collect_section(i + 1)
            rule_sections.append((lineno, [words] + body))
        elif words[-1] == "{":
            body, i = collect_section(i + 1)
            bucket_sections.append((lineno, [words] + body))
        else:
            raise CompileError("line %d: cannot parse %r"
                               % (lineno, " ".join(words)))

    if 0 not in m.types:
        m.types[0] = "osd"
    type_by_name = {v: k for k, v in m.types.items()}
    names: dict[str, int] = dict(devices)

    # two passes so buckets can reference later-defined child buckets
    parsed = []
    for lineno, section in bucket_sections:
        head = section[0]
        tname, bname = head[0], head[1]
        if tname not in type_by_name:
            raise CompileError("line %d: unknown type %r"
                               % (lineno, tname))
        props = {"alg": "straw2", "hash": "0"}
        items: list[tuple[str, float]] = []
        bid = None
        for words in section[1:]:
            if words[0] == "id":
                bid = int(words[1])
            elif words[0] == "item":
                # None = unspecified: devices default to 1.0, bucket
                # children to their computed subtree weight — an
                # EXPLICIT "weight 1.00" on a bucket child must stick
                weight = None
                if "weight" in words:
                    weight = float(words[words.index("weight") + 1])
                items.append((words[1], weight))
            elif words[0] in ("alg", "hash"):
                props[words[0]] = words[1]
        if bid is None:
            bid = -(len(parsed) + 2)
        names[bname] = bid
        parsed.append((lineno, bname, bid, type_by_name[tname],
                       props, items))

    for lineno, bname, bid, btype, props, items in parsed:
        child_ids, weights = [], []
        for iname, w in items:
            if iname not in names:
                raise CompileError("line %d: unknown item %r"
                                   % (lineno, iname))
            cid = names[iname]
            if w is None:
                if cid < 0 and any(p[2] == cid for p in parsed):
                    pass     # bucket child: subtree weight, filled
                             # after children resolve
                else:
                    w = 1.0  # device default
            child_ids.append(cid)
            weights.append(w)
        parsed_w = []
        for cid, w in zip(child_ids, weights):
            if w is None:
                parsed_w.append(None)
            else:
                parsed_w.append(int(round(w * 0x10000)))
        names[bname] = bid
        alg = ALG_BY_NAME.get(props["alg"])
        if alg is None:
            raise CompileError("line %d: unknown alg %r"
                               % (lineno, props["alg"]))
        # resolve deferred bucket weights (children defined later):
        # process in dependency order by retrying
        deferred = [(bid, alg, btype, bname, child_ids, parsed_w,
                     int(props["hash"]))]
        while deferred:
            progress = False
            still = []
            for ent in deferred:
                bid2, alg2, btype2, bname2, cids, ws, h = ent
                resolved = []
                ok = True
                for cid, w in zip(cids, ws):
                    if w is not None:
                        resolved.append(w)
                    elif cid in m.buckets:
                        resolved.append(m.buckets[cid].weight)
                    else:
                        ok = False
                        break
                if ok:
                    m.add_bucket(alg2, btype2, cids, resolved, id=bid2,
                                 hash=h, name=bname2)
                    progress = True
                else:
                    still.append(ent)
            if still and not progress:
                raise CompileError(
                    "bucket %r references unresolved children"
                    % still[0][3])
            deferred = still

    for lineno, section in rule_sections:
        rname = section[0][1]
        rid = None
        steps: list[tuple[int, int, int]] = []
        for words in section[1:]:
            if words[0] == "id":
                rid = int(words[1])
            elif words[0] == "type":
                pass  # replicated/erasure: advisory in the text format
            elif words[0] in ("min_size", "max_size"):
                pass  # legacy, ignored like current reference versions
            elif words[0] == "step":
                steps.append(_parse_step(lineno, words[1:], names,
                                         type_by_name))
        m.add_rule(steps, id=rid, name=rname)
    return m


def _parse_step(lineno, words, names, type_by_name):
    op = words[0]
    if op == "take":
        if words[1] not in names:
            raise CompileError("line %d: unknown take target %r"
                               % (lineno, words[1]))
        return (TAKE, names[words[1]], 0)
    if op == "emit":
        return (EMIT, 0, 0)
    if op in SET_STEPS:
        return (SET_STEPS[op], int(words[1]), 0)
    if op in ("choose", "chooseleaf"):
        mode = words[1]
        n = int(words[2])
        tname = words[4] if len(words) > 4 and words[3] == "type" else "osd"
        if tname not in type_by_name:
            raise CompileError("line %d: unknown type %r"
                               % (lineno, tname))
        t = type_by_name[tname]
        opcode = {
            ("choose", "firstn"): CHOOSE_FIRSTN,
            ("choose", "indep"): CHOOSE_INDEP,
            ("chooseleaf", "firstn"): CHOOSELEAF_FIRSTN,
            ("chooseleaf", "indep"): CHOOSELEAF_INDEP,
        }.get((op, mode))
        if opcode is None:
            raise CompileError("line %d: bad step %s %s"
                               % (lineno, op, mode))
        return (opcode, n, t)
    raise CompileError("line %d: unknown step %r" % (lineno, op))


def decompile(m: CrushMap) -> str:
    out = ["# begin crush map"]
    t = m.tunables
    for name in TUNABLES:
        out.append("tunable %s %d" % (name, getattr(t, name)))
    out.append("")
    out.append("# devices")
    for d in range(m.max_devices):
        line = "device %d osd.%d" % (d, d)
        if d in m.device_classes:
            line += " class %s" % m.device_classes[d]
        out.append(line)
    out.append("")
    out.append("# types")
    types = dict(m.types) or {0: "osd"}
    if 0 not in types:
        types[0] = "osd"
    for num in sorted(types):
        out.append("type %d %s" % (num, types[num]))
    out.append("")
    out.append("# buckets")
    names = _bucket_names(m)
    # children before parents (the reference emits leaves first)
    emitted = set()

    def emit_bucket(bid: int):
        if bid in emitted:
            return
        b = m.buckets[bid]
        for item in b.items:
            if item < 0:
                emit_bucket(item)
        emitted.add(bid)
        tname = types.get(b.type, "type%d" % b.type)
        out.append("%s %s {" % (tname, names[bid]))
        out.append("\tid %d" % bid)
        out.append("\talg %s" % ALG_NAME[b.alg])
        out.append("\thash %d\t# rjenkins1" % b.hash)
        ws = _item_weights(b)
        for item, w in zip(b.items, ws):
            iname = "osd.%d" % item if item >= 0 else names[item]
            out.append("\titem %s weight %.5f" % (iname, w / 0x10000))
        out.append("}")

    for bid in sorted(m.buckets, reverse=True):
        emit_bucket(bid)
    out.append("")
    out.append("# rules")
    for rid in sorted(m.rules):
        r = m.rules[rid]
        out.append("rule %s {" % (r.name or "rule_%d" % rid))
        out.append("\tid %d" % rid)
        out.append("\ttype replicated")
        for op, a1, a2 in r.steps:
            if op == TAKE:
                out.append("\tstep take %s" % names[a1])
            elif op == EMIT:
                out.append("\tstep emit")
            elif op in SET_STEP_NAME:
                out.append("\tstep %s %d" % (SET_STEP_NAME[op], a1))
            else:
                verb, mode = {
                    CHOOSE_FIRSTN: ("choose", "firstn"),
                    CHOOSE_INDEP: ("choose", "indep"),
                    CHOOSELEAF_FIRSTN: ("chooseleaf", "firstn"),
                    CHOOSELEAF_INDEP: ("chooseleaf", "indep"),
                }[op]
                tname = types.get(a2, "type%d" % a2)
                out.append("\tstep %s %s %d type %s"
                           % (verb, mode, a1, tname))
        out.append("}")
    out.append("")
    out.append("# end crush map")
    return "\n".join(out) + "\n"


def _bucket_names(m: CrushMap) -> dict[int, str]:
    names = {}
    for bid, b in m.buckets.items():
        names[bid] = b.name or "bucket%d" % -bid
    return names


def _item_weights(b) -> list[int]:
    from .crushmap import LIST, STRAW, STRAW2, TREE, UNIFORM
    from .crushmap import _tree_leaf_node

    if b.alg == UNIFORM:
        return [b.item_weight] * len(b.items)
    if b.alg in (LIST, STRAW, STRAW2):
        return list(b.item_weights)
    if b.alg == TREE:
        return [b.node_weights[_tree_leaf_node(i)]
                for i in range(len(b.items))]
    return [0] * len(b.items)
