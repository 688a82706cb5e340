"""Time K3 (``xor_schedule``) built at other column tiles and ring depths.

    python3 tools/k3_tiles.py

K3's kernel (``ceph_tpu_torch/csrc/ec_kernels.cu``) takes two settings
at build time: ``K3_LOG_TILE``, a column tile of 2**n bytes of every
input block, and ``K3_STAGES``, the tiles its shared-memory ring holds
(the package builds 7 and 2: 128 bytes, two stages).  This script
builds the source once for each pair in ``SETTINGS`` with nvcc (all
builds started together) into ``build/k3_tiles/``, loads each build
with ctypes and, in one process, times its ``ec_xor_schedule`` at the
three shapes of ``ec_times.py``: the k=8, m=3 encode at 64 MiB of
payload (P = 131072), bench.py's reconstruct leg (one lost data shard
of k=8, m=3 from 256 MiB of survivor planes, P = 524288, the rows from
``decode_rows((3,), survivors)``) and isa Cauchy k=32 with 8 output
chunks (P = 32768).  A setting whose ring does not fit a block's 227
KiB of shared memory at a shape is skipped there.  ``ms`` is the
kernel's device time per call in a ``torch.profiler`` window over 20
warm calls (``chip_smoke.device_ms``; ``timed_by`` names the clocks
used), keyed "tile bytes/stages"; the builds are timed in turns,
in order and then in reverse, and each result must equal
``xor_schedule_plain``.  Prints the card's name and power limit, then
one JSON line per shape.  Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = [(7, 1), (7, 2), (7, 3), (7, 4), (8, 1), (8, 2), (8, 3),
            (9, 1), (9, 2), (9, 3), (10, 1), (10, 2)]
SMEM_OPTIN = 227 * 1024     # a block's shared memory on sm_90


def build(settings) -> dict:
    """{(log_tile, stages): the loaded build's ec_xor_schedule}."""
    from ceph_tpu_torch import _build
    out = os.path.join(ROOT, "build", "k3_tiles")
    os.makedirs(out, exist_ok=True)
    nvcc, src = _build.nvcc_path(), str(_build.SOURCES[0])
    paths = {s: os.path.join(out, "k3_%d_%d.so" % s) for s in settings}
    _build._run([[nvcc, *_build.NVCC_FLAGS, "-shared",
                  "-DK3_LOG_TILE=%d" % lt, "-DK3_STAGES=%d" % st,
                  "-o", paths[(lt, st)], src] for lt, st in settings])
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {}
    for s, path in paths.items():
        fn = ctypes.CDLL(path).ec_xor_schedule
        fn.argtypes = [p, p, p, p, i, i, ll, i, p]
        fn.restype = ctypes.c_int
        fns[s] = fn
    return fns


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k3_tiles: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from ceph_tpu_torch import _build
    from ceph_tpu_torch.ec import kernels as K, matrices
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    fns = build(SETTINGS)
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    enc = K.PlanesEncoder(matrices.isa_rs_vandermonde_matrix(8, 3), dev)
    wide = K.PlanesEncoder(matrices.isa_cauchy_matrix(32, 8), dev)
    survivors = tuple(i for i in range(11) if i != 3)
    for name, sched, k, P in (
            ("encode", enc._schedule, 8, 131072),
            ("reconstruct",
             enc.decode_rows((3,), survivors).keywords["masks"], 8, 524288),
            ("wide", wide._schedule, 32, 32768)):
        planes = torch.from_numpy(rng.integers(0, 256, (k * 64, P),
                                               dtype=np.uint8)).to(dev)
        want = K.xor_schedule_plain(planes, sched.masks)
        out = torch.empty_like(want)
        fit = [s for s in SETTINGS
               if (s[1] * k * 8) << s[0] <= SMEM_OPTIN]

        def call(fn):
            _build.check(fn(planes.data_ptr(), out.data_ptr(),
                            sched.spans.data_ptr(), sched.idx.data_ptr(),
                            k * 8, sched.out_rows, 8 * P, 0,
                            torch.cuda.current_stream().cuda_stream),
                         "ec_xor_schedule")

        ms, clocks = {s: [] for s in fit}, set()
        for order in (fit, fit[::-1]):
            for s in order:
                out.zero_()
                call(fns[s])
                C.require(torch.equal(out, want), "K3 at tile 2^%d, %d "
                          "stages differs from its plain version (%s)"
                          % (s[0], s[1], name))
                t, timed_by = C.device_ms(lambda: call(fns[s]), 20,
                                          "xor_schedule_kernel")
                ms[s].append(t)
                clocks.add(timed_by)
        nbytes = planes.numel() + want.numel()
        print(json.dumps({
            "shape": name, "k": k, "out_rows": sched.out_rows, "P": P,
            "bytes": nbytes,
            "bound_ms": nbytes / C.HBM_BYTES_S * 1e3,
            "ms": {"%d/%d" % (1 << s[0], s[1]): v for s, v in ms.items()},
            "timed_by": sorted(clocks),
            "skipped": ["%d/%d" % (1 << s[0], s[1])
                        for s in SETTINGS if s not in fit]}), flush=True)
        del planes, want, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
