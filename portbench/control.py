"""The controls and planted faults that the benchmark's checks must catch.

    python3 portbench/control.py --workload NAME --seeds 1,2,3 \\
        [--seconds S] [--fault NAME]

prints one JSON line a seed with the numbers the cell's check compares,
read with the control (or the fault) in place of the program, and exits
0.  A cell's workload file names its control (`"control"`).  The
benchmark's own runs never run these.

Controls (no precision is stated by either configuration, so each
breaks one of its guarantees):

- client cells, `parity_uncommitted`: the primary acknowledges a write
  whose parity shards' transactions it never sends or applies (data
  shards commit; every read still answers from them).  Breaks
  "acknowledged once every shard has committed"; `shards_wrong` must
  read above 0.
- placement cells: the plain reference put in the program's place at
  the cell's own map size, on the PGs and epochs a run checks, with one
  guarantee broken: `ignore_out` (reweights ignored: out OSDs stay in
  up sets; for mixes that mark OSDs out) or `stale_crush` (the previous
  epoch's CRUSH weights; for mixes that change them).
  `pgs_placed_wrong` must read above 0.

Faults, planted in the program (CPU tests at toy sizes drive the rest of
a run over them): `unchanged` (a write acknowledged and not applied; a
mapping left at the first epoch's), `half` (parity over half the data
chunks; half the PGs' rows left from the previous epoch), `altered`
(one parity byte flipped where the encode produces it; one PG in 1000
given another OSD).  The exchange between chips does not exist in these
one-chip cells.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import types
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from portbench import run as harness  # noqa: E402
from portbench.reference import straw2  # noqa: E402
from portbench.traffic import EpochStream, rng_for  # noqa: E402


@contextlib.contextmanager
def patched(owner, name: str, make):
    """owner.name replaced by make(original) for the body."""
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


# -- client cells -------------------------------------------------------

def _commit(keep):
    """ECPGBackend._commit_shard_txns that sends only the positions `keep`
    admits and acknowledges all the same."""
    from ceph_tpu_torch.osd.ecbackend import ECPGBackend

    def make(orig):
        async def commit(self, pg, oid, entry, txns, top=None):
            k = self.codec(self.osd.osdmap.pools[pg.pool_id]) \
                .get_data_chunk_count()
            kept = {j: t for j, t in txns.items() if keep(j, k)}
            if kept:
                await orig(self, pg, oid, entry, kept, top=top)
            return True
        return commit
    return patched(ECPGBackend, "_commit_shard_txns", make)


def _encode(before=None, after=None):
    """ErasureCode.encode_async with the object passed through
    before(codec, data) and the chunks through after(codec, chunks)."""
    from ceph_tpu_torch.ec.base import ErasureCode

    def make(orig):
        async def encode_async(self, want, data, *a, **kw):
            if before is not None:
                data = before(self, data)
            out = await orig(self, want, data, *a, **kw)
            return out if after is None else after(self, out)
        return encode_async
    return patched(ErasureCode, "encode_async", make)


def _half(codec, data: bytes) -> bytes:
    """The object with its second half of data chunks zeroed, as if half
    the batch were left out of the product."""
    k = codec.get_data_chunk_count()
    keep = codec.get_chunk_size(len(data)) * (k // 2)
    return data[:keep] + bytes(max(0, len(data) - keep))


def _flip_parity(codec, out: dict) -> dict:
    j = codec.get_data_chunk_count()
    if out.get(j):
        b = bytearray(out[j])
        b[0] ^= 0x5A
        out[j] = bytes(b)
    return out


def client_patch(name: str):
    if name == "parity_uncommitted":
        return _commit(lambda j, k: j < k)
    if name == "unchanged":
        return _commit(lambda j, k: False)
    if name == "half":
        return _encode(before=_half)
    if name == "altered":
        return _encode(after=_flip_parity)
    raise ValueError("no control or fault %r for a client cell" % name)


# -- placement cells -------------------------------------------------------

def placement_patch(name: str):
    """A fault planted in OSDMapMapping: its pools' rows as `name` says."""
    from ceph_tpu_torch.parallel import mapping
    state: dict = {}

    def make(orig):
        def build(self, osdmap, *a, **kw):
            orig(self, osdmap, *a, **kw)
            first = state.setdefault("first", self.pools)
            prev = state.get("prev", first)
            state["prev"] = dict(self.pools)
            for pid, pm in self.pools.items():
                if name == "unchanged":
                    self.pools[pid] = first[pid]
                elif name == "half":
                    h = pm.up.shape[0] // 2
                    pm.up[h:] = prev[pid].up[h:]
                    pm.up_primary[h:] = prev[pid].up_primary[h:]
                elif name == "altered":
                    pm.up[::1000, -1] = (pm.up[::1000, -1] + 1) % 1000
                else:
                    raise ValueError("no fault %r for a placement cell"
                                     % name)
        return build
    return patched(mapping.OSDMapMapping, "_build", make)


def placement_control(workload: str, seed: int, epochs: int, kind: str,
                      overrides: dict | None = None) -> dict:
    """The control's reading at the cell's own map size: `epochs` epochs
    of the mix from `seed`, the check's sample of PGs and epochs, the
    control's rows against the reference's.  `overrides` replace keys of
    the workload ("cell") and configuration ("config") files."""
    from portbench.drivers import osdmap_epochs as drv
    overrides = overrides or {}
    cell = harness.load_json(HERE / "workloads" / (workload + ".json"))
    cell.update(overrides.get("cell", {}))
    cfg = harness.load_json(HERE / "configs" / (cell["config"] + ".json"))
    cfg.update(overrides.get("config", {}))
    n = int(cfg["hosts"]) * int(cfg["per_host"])
    stream = EpochStream(cell["epochs"], seed, n, int(cfg["per_host"]),
                         int(cfg["crush_weight"]))
    for _ in range(int(cell.get("warmup_epochs", 3))):
        stream.next()
    sample = np.sort(rng_for(seed, 5).choice(
        int(cfg["pg_num"]), size=int(cell["check_pgs"]), replace=False))
    alive = np.ones(n, dtype=bool)
    picks = drv.EpochSample(seed, int(cell["check_epochs"]))
    states: dict[int, tuple] = {}
    for i in range(epochs):
        prev = stream.crush.copy()
        stream.next()
        states[i] = (stream.reweight.copy(), stream.crush.copy(), prev)
        wanted = picks.offer(i)
        for j in [j for j in states if j not in wanted]:
            del states[j]
    kept = {}
    # only the checked epochs' rows are computed, by the control
    for i, (rw, crush, prev) in states.items():
        weights = prev if kind == "stale_crush" else crush
        up, prim = straw2.up_sets(
            drv.reference_tree(cfg, weights), cfg["rule"],
            int(cfg["size"]), sample, int(cfg["pg_num"]),
            int(cfg["pool_id"]), rw, alive, alive,
            ignore_out=kind == "ignore_out")
        kept[i] = {"up": up, "primary": prim, "reweight": rw,
                   "crush": crush}
    run = types.SimpleNamespace(config=cfg, kept=kept)
    return {"pgs_placed_wrong": drv.count_wrong(run, sample)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--epochs", type=int, default=200,
                    help="placement cells: epochs a run makes")
    args = ap.parse_args(argv)
    import torch
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.load_json(HERE / "workloads" / (args.workload + ".json"))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cell["driver"] == "osdmap_epochs" and args.fault is None:
            kind = cell["control"]
            out = {"control": kind,
                   "checks": placement_control(args.workload, seed,
                                               args.epochs, kind)}
        else:
            name = args.fault or cell["control"]
            patch = (client_patch(name) if cell["driver"] == "cluster_client"
                     else placement_patch(name))
            with patch:
                _run, line = harness.run_cell(
                    bench, args.workload, seed, args.seconds, False, device,
                    start=time.perf_counter())
            out = {"control" if args.fault is None else "fault": name,
                   "correct": line["correct"],
                   "attempted": line["attempted"],
                   "checks": {k: v["value"]
                              for k, v in line["checks"].items()}}
        out.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
