"""Time the EC slice of one or more checkouts of this repository on the
card, each in a process of its own, in the order given:

    python3 ec_times.py TREE [TREE ...]

TREE is the root of a checkout (for example an unpacked ``git
archive``) holding ``ceph_tpu_torch/`` and ``chip_smoke.py``; give
trees in turns (A B B A) to compare two on one card.  Each process
builds its tree's kernels and, for each of ``chip_smoke.py``'s six
profiles, runs a warm-up round and then a timed round of 2048
concurrent ``encode_async`` calls of k x 4 KiB (payload MiB/s over the
host clock, and the device busy share: the dispatches' CUDA-event
device time over the round's wall time), then 128 degraded reads and
128 partial overwrites, which stage the decode and delta segments.
Then it times K1 (``fused_xor``) at k=8, m=3 with 32 MiB per chunk
row and at three segment shapes of the main path (k, m, lanes), and K2
(``bitplane_matmul``) at k=8, m=3, n=2^19 words for w = 32, 16, 8:
and K3 (``PlanesEncoder.__call__`` and its ``decode_rows``) at three
shapes: the k=8, m=3 encode at 64 MiB of payload (P = 131072), the
reconstruct leg of bench.py (one lost data shard of k=8, m=3 rebuilt
from 256 MiB of survivor planes, P = 524288, the rows from
``decode_rows((3,), survivors)``) and a wide one (isa Cauchy k=32 with
8 output chunks, P = 32768), each with its bytes and its byte bound
(``bound_ms``: the bytes over the card's published peak memory rate,
3.35 TB/s), and beside them the ``copy_`` bandwidth the tree's process
measures.
``ms`` is the kernels' device time per call in a ``torch.profiler``
window over 20 warm calls (``chip_smoke.device_ms``), ``call_ms`` the
CUDA-event time per call of back-to-back wrapper calls, which a
wrapper's host work bounds below for short kernels; each result must
equal the plain version.  The segment shapes are the
smallest, the median and the largest K1 shape the first tree's main
path staged; the later trees are given the same shapes.  Prints the
card's name and power limit, then one JSON line per tree.  Needs one
CUDA card.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time

ROUNDS = 2          # a warm-up round, then the timed round
HBM_BYTES_S = 3.35e12   # H100 SXM HBM3 peak (data sheet, 700 W)


def _k1_shapes(rt) -> list[list[int]]:
    """(k, m, lanes) of every K1 launch shape the runtime staged."""
    out = set()
    for kind, mkey, w, seg in rt.chips[0].programs:
        if kind == "ec" and w == 8:
            out.add((len(mkey[0]), len(mkey), seg // 4))
    return sorted(out, key=lambda s: (s[2] * (s[0] + s[1]), s))


def one(tree: str, shapes: list | None) -> dict:
    """The timings of one tree, in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    import chip_smoke as C
    from ceph_tpu_torch import _build
    from ceph_tpu_torch.device.runtime import DeviceRuntime
    from ceph_tpu_torch.ec import kernels as K, matrices, new_codec
    t0 = time.perf_counter()
    _build.library()
    dev = torch.device("cuda")
    out = {"tree": tree, "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0), "profiles": []}
    rng = np.random.default_rng(7)

    async def profiles():
        rt = DeviceRuntime.get(dev)
        for prof in C.PROFILES:
            codec = new_codec(dict(prof), device=dev)
            k = codec.get_data_chunk_count()
            n = codec.get_chunk_count()
            want = set(range(n))
            for r in range(ROUNDS):
                objs = [rng.integers(0, 256, k * C.CHUNK,
                                     dtype=np.uint8).tobytes()
                        for _ in range(C.OBJECTS)]
                seq0 = rt._seq
                t = time.perf_counter()
                enc = await asyncio.gather(*[codec.encode_async(want, o)
                                             for o in objs])
                wall = time.perf_counter() - t
            busy = sum(tk.device_s for tk in rt.chips[0].tickets
                       if tk.seq > seq0)
            for o, got in zip(objs[:8], enc):
                C.require(got == codec.encode(want, o),
                          "encode_async != encode")
            surv = [{i: e[i] for i in range(1, n)} for e in enc[:C.CHECKED]]
            await asyncio.gather(*[codec.decode_async({0}, s)
                                   for s in surv])
            deltas = [{0: rng.integers(0, 256, 1024,
                                       dtype=np.uint8).tobytes()}
                      for _ in range(C.CHECKED)]
            await asyncio.gather(*[codec.delta_async(d) for d in deltas])
            out["profiles"].append({
                "profile": prof, "encode_s": wall,
                "encode_payload_mib_s": C.OBJECTS * k * C.CHUNK / wall
                / 2**20,
                "encode_device_busy_share": busy / wall})
        return _k1_shapes(rt)

    staged = asyncio.run(profiles())
    if shapes is None:
        shapes = [staged[0], staged[len(staged) // 2], staged[-1]]
    out["k1_shapes_staged"] = len(staged)

    def masks(k, m, w):
        mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, w)
        return torch.from_numpy(K.pack_rows(
            matrices.matrix_to_bitmatrix(k, m, w, mat))).to(dev)

    def k1(k, m, lanes, iters=20):
        mk = masks(k, m, 8)
        d = torch.from_numpy(rng.integers(0, 2**32, (k, lanes),
                                          dtype=np.uint32)).to(dev)
        C.require(torch.equal(K.fused_xor(d, mk), K.fused_xor_plain(d, mk)),
                  "fused_xor differs from its plain version")
        return {"k": k, "m": m, "lanes": lanes,
                "ms": C.device_ms(lambda: K.fused_xor(d, mk), iters)[0],
                "call_ms": C.cuda_ms(lambda: K.fused_xor(d, mk), iters)}

    out["k1"] = k1(8, 3, (32 << 20) // 4)
    out["k1_segments"] = [k1(*s) for s in shapes]
    out["k2"] = {}
    for w in (32, 16, 8):
        mk = masks(8, 3, w)
        dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[w]
        d = torch.from_numpy(rng.integers(0, 2**w, (8, 1 << 19),
                                          dtype=np.uint64).astype(dt)).to(dev)
        C.require(torch.equal(K.bitplane_matmul(d, mk, w),
                              K.bitplane_matmul_plain(d, mk, w)),
                  "bitplane_matmul differs from its plain version")
        out["k2"][str(w)] = {
            "ms": C.device_ms(lambda: K.bitplane_matmul(d, mk, w), 20)[0],
            "call_ms": C.cuda_ms(lambda: K.bitplane_matmul(d, mk, w), 20)}
    big = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(big)
    out["copy_gb_s"] = 2 * big.numel() / C.cuda_ms(
        lambda: dst.copy_(big), 10) / 1e6
    del big, dst
    enc = K.PlanesEncoder(matrices.isa_rs_vandermonde_matrix(8, 3), dev)
    wide = K.PlanesEncoder(matrices.isa_cauchy_matrix(32, 8), dev)
    survivors = tuple(i for i in range(11) if i != 3)
    out["k3"] = {}
    for name, fn, k, P in (
            ("encode", enc, 8, 131072),
            ("reconstruct", enc.decode_rows((3,), survivors), 8, 524288),
            ("wide", wide, 32, 32768)):
        masks = (fn.keywords["masks"] if hasattr(fn, "keywords")
                 else fn._masks)
        masks = getattr(masks, "masks", masks)   # an XorSchedule's rows
        planes = torch.from_numpy(rng.integers(0, 256, (k * 64, P),
                                               dtype=np.uint8)).to(dev)
        got = fn(planes)
        C.require(torch.equal(got, K.xor_schedule_plain(planes, masks)),
                  "xor_schedule differs from its plain version (%s)" % name)
        out["k3"][name] = {
            "k": k, "out_rows": masks.shape[0], "P": P,
            "bytes": planes.numel() + got.numel(),
            "bound_ms": (planes.numel() + got.numel()) / HBM_BYTES_S * 1e3,
            "ms": C.device_ms(lambda: fn(planes), 20)[0],
            "call_ms": C.cuda_ms(lambda: fn(planes), 20)}
        del planes, got
    out["shapes"] = [list(s) for s in shapes]
    return out


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        shapes = json.loads(argv[2]) if len(argv) > 2 else None
        print(json.dumps(one(argv[1], shapes)), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("ec_times: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    shapes = None
    for tree in argv:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", tree]
        if shapes is not None:
            cmd.append(json.dumps(shapes))
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=1200)
        if res.returncode:
            sys.stderr.write(res.stdout + res.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        shapes = json.loads(line)["shapes"]
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
