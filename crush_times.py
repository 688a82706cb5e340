"""Time the CRUSH slice of one or more checkouts of this repository on
the card, each in a process of its own, in the order given:

    python3 crush_times.py TREE [TREE ...]

TREE is the root of a checkout (for example an unpacked ``git
archive``) holding ``ceph_tpu_torch/`` and ``chip_smoke.py``; give
trees in turns (A B B A) to compare two on one card.  Each process
builds its tree's kernels, builds ``chip_smoke.py``'s cluster (the
1000-OSD map with a 10,000,000-PG replicated pool and a 1,000,000-PG
chooseleaf indep pool), and per pool: a warm-up pass and remap on a
131072-PG pool of the same rule, then the first full map and remap of
the pool, then three more of each.  Times are host-clock seconds
around a call that ends in a synchronise.  Where the tree's kernels
have a whole-step ``choose`` (K4), it also gives K4's device span
(``chip_smoke.device_ms``, ten warm calls) on one chunk of the 10M pool
and on the whole 1M pool.  Prints the card's name and power limit,
then one JSON line per tree.  Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

WARM_PGS = 1 << 17


def one(tree: str) -> dict:
    """The timings of one tree, in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import chip_smoke as C
    from ceph_tpu_torch import _build
    t0 = time.perf_counter()
    _build.library()
    out = {"tree": tree, "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0), "pools": {}}
    m = C.cluster()
    dm = m.device_mapper()
    w, ex, iu = C.cluster_state(m)
    w2, ex2, iu2 = w.copy(), ex.copy(), iu.copy()
    churned = list(range(0, C.N_OSDS, C.N_OSDS // 10))[:10]
    w2[churned] = 0
    iu2[churned] = False
    for pid, pool in sorted(m.pools.items()):
        args = C.pool_args(pool)
        cs = pool.can_shift_osds()
        warm = args[:2] + (WARM_PGS, WARM_PGS, WARM_PGS - 1) + args[5:]
        dm.map_pool_state(*warm, w, ex, iu, None, cs).remap(w2, ex2, iu2)

        def full():
            return dm.map_pool_state(*args, w, ex, iu, None, cs)

        st, first = C.synced(full)
        st2, first_remap = C.synced(lambda: st.remap(w2, ex2, iu2))
        maps = [C.synced(full)[1] for _ in range(3)]
        remaps = [C.synced(lambda: st.remap(w2, ex2, iu2))[1]
                  for _ in range(3)]
        out["pools"][pid] = {
            "pg_num": pool.pg_num, "size": pool.size,
            "first_map_ms": first * 1e3, "first_remap_ms": first_remap * 1e3,
            "map_ms": [t * 1e3 for t in maps],
            "remap_ms": [t * 1e3 for t in remaps],
            "moved_pgs": int((st.up != st2.up).any(dim=1).sum())}
    from ceph_tpu_torch.ops.crush import device as D, kernels as K
    if hasattr(K, "choose"):
        tb = dm.fm.tables
        wt = torch.from_numpy(w).cuda()
        for pid, L in ((1, D.DeviceMapper.CHUNK), (2, m.pools[2].pg_num)):
            args = C.pool_args(m.pools[pid])
            plan = dm._plan(args[0], args[1])
            xs = D.pps_seed(torch.arange(L, device="cuda"), *args[3:])
            out["pools"][pid]["choose_ms"] = C.device_ms(
                lambda: K.choose(tb, plan, xs, wt), 10, "choose_kernel")[0]
            out["pools"][pid]["choose_lanes"] = L
    return out


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("crush_times: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for tree in argv:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree], capture_output=True,
                             text=True, timeout=1200)
        if res.returncode:
            sys.stderr.write(res.stdout + res.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
