"""Card smoke test of ceph_tpu_torch: build, kernel parity, the EC,
CRUSH, recovery, background, codec-completeness and balancer slices
and the runtime's chip-loss surface end to end, and kernel times
beside their bounds.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  Any failure raises
and exits non-zero; without a card it exits 2 and prints no result.
Phases, each printing its results as JSON lines:

1. the card's name and power limit;
2. build the kernels (csrc/ec_kernels.cu, csrc/crush_kernels.cu) with
   nvcc for sm_90a, one nvcc per source, started together;
3. hold each kernel bit for bit against its plain PyTorch version on
   the card (ragged widths, zero columns, decode rows, a bitmatrix row
   of zeros and views whose pointers are off the 16-byte grid; K1 and
   K2 also at k = 1 and 32, m = 1 to 6, m*w = 1024, widths 1, 7 and
   8195; K3 at k = 32, up to 8 output chunks in one launch, odd P and
   P under one 128-byte column tile) and spot-check them against the
   numpy GF codec;
4. the slice end to end: new_codec(profile) -> encode_async (2048
   concurrent 4 KiB-chunk objects per profile) / decode_async /
   delta_async through the dispatch stream, batcher and runtime,
   compared with the sync host codec; then PlanesEncoder
   encode_stripes / decode_rows.  Launch counts are read around this
   phase and every kernel must have run in it;
5. kernel times (device time in a torch.profiler window; CUDA events
   around back-to-back calls beside it) at the main path's shapes, beside
   the bound (the bytes the kernel must move over the card's published
   peak memory rate, 3.35 TB/s, or its operations over the card's peak
   rate, whichever is longer) and the plain version's time, with a
   copy_'s rate in the same run beside the peak; K1 also at
   the smallest, the median and the largest segment shape the main
   path staged, each with its launches there; K3 at the encode shape
   and at bench.py's reconstruct leg (one lost data shard of k=8,m=3
   from 256 MiB of survivor planes), with its schedule's XORs and
   shared-memory reads; each kernel's result there must again equal
   its plain version;
6. the CRUSH kernels (K4-K7) bit for bit against their plain versions
   on seeded inputs (K4: firstn and indep rules, a choose_args map,
   the map staged in shared memory and read from device memory; lane
   counts off the TPU's 4096-lane tile; K7: overflowing and ragged row
   groups, rows 2048 and 1000);
7. the CRUSH slice end to end at the size of bench.py's bulk map: a
   1000-OSD straw2 map (50 hosts x 20), OSDMap -> OSDMapMapping and
   device_mapper().map_pool_state for a 10,000,000-PG replicated pool
   (size 3) and a 1,000,000-PG erasure pool (chooseleaf indep, size
   11), then 10 OSDs down and out through MapState.remap.  Launch
   counts are read around this phase and every CRUSH kernel must have
   run in it, K4 once per chunk of each full pass.  Each pass equals
   the same pass through the kernels' plain versions on the card (so
   K4 equals choose_plain over every PG of both pools, and the plain
   version counts the draws they need), the remap equals a fresh full
   pass and moves 296962 PGs of the 10M pool, and sampled PGs equal
   the host pipeline (pg_to_up_acting_osds);
8. the map and remap times (CUDA events and the host clock, warm), a
   torch.profiler window over each (device time by kernel, busy
   share), and each CRUSH kernel's time at the main path's shapes
   beside its bound, its plain version's time and, for K7,
   torch.nonzero's (device span and call).  K4's bound is its
   operations: the draws the inputs need times the hash's 137 integer
   instructions over the integer ALU pipe's 64 lanes per SM per clock
   at the card's maximum SM clock.  Beside it: the bound over all 128
   issue slots per SM per clock, the byte bound, K4's time on the same
   inputs given a warp at a time (32 lanes, one input), which takes
   away the divergence between a warp's lanes, and its time with the
   map read from device memory instead of shared memory;
9. the recovery codecs end to end, each profile on a fresh runtime:
   bench.py's repair profiles (jerasure RS k=8,m=4, LRC k=8,m=4,l=3,
   SHEC k=8,m=4,c=3, CLAY k=4,m=2), then LRC k=4,m=2,l=3, an LRC with
   w=16 layers and SHEC k=4,m=3,c=2 at w=32.  256 concurrent 256 KiB
   objects through encode_async, equal to the host encode; a single
   data-shard loss repaired from exactly the shards minimum_to_decode
   plans (CLAY: repair_async over its sub-chunk runs), equal to the
   stored shard, reading BASELINE.json's 262144, 98304, 131072 and
   163840 bytes an object; a data and a parity shard lost on 64
   objects, decode_async equal to the host decode.  K1 must launch in
   every leg of a w=8 profile and K2 in every leg of a w=16/32 one,
   and no other EC kernel; CLAY's host coupling solves are timed;
10. the background planes end to end, each leg warmed once (its result
   held against its oracle) and then timed on a fresh runtime
   (`"phase": "background"` lines): crc32_batch on bench.py's 256 x 4
   KiB digest buffers and on a deep-scrub chunk (25 objects of 4 MiB
   and their attribute blobs, four dispatches), equal to zlib.crc32;
   compress_async on bench.py's 24-object compression corpus and on
   4 MiB text, zero and random objects, equal to compress_host and
   round-tripping, and the seed-0 parity corpus of tests/test_tlz.py
   hashing to its pinned digest; boundary_batch / fingerprint_batch on
   bench.py's dedup corpus and four random 4 MiB objects, equal to
   chunk_host and zlib.crc32, interior chunks within [2048, 16384].
   Each leg prints MiB/s, dispatches, their CUDA-event device seconds
   and busy share, the host seconds in crc32_combine, token emission
   (_assemble) or cut resolution, and the runtime's gauges; then each
   plane's program alone at its dispatch shape beside its byte bound.
   The planes are torch programs with no hand kernel, so they add no
   row to the kernels' record;
11. codec completeness: K1/K2 over more than 256 input bits and 1024
   output rows (a launch a slice and a row group) and K3's row view at
   odd output rows, rows of 1, 13, 4097 and 65537 bytes and more than
   256 input rows, each bit for bit against its plain version with its
   launches a call; then, each on a fresh runtime, jerasure's bitmatrix
   techniques at the default packetsize (cauchy_good 6+3 as
   BASELINE.json's Cauchy-good config, 512 objects of 384 KiB;
   cauchy_orig 4+2, liberation 4+2 w=7, blaum_roth 4+2 w=6 and
   liber8tion 4+2, 512 objects of one alignment unit), the wide
   reed_sol_van profiles k=33,m=1,w=8; k=17,m=3,w=16; k=9,m=3,w=32;
   k=2,m=40,w=32 and cauchy_orig k=9,m=3,w=32 (64 objects), an LRC
   with a cauchy_good layer and one with a CLAY layer: encode_async, a
   data loss and a data + parity loss through decode_async and
   (reed_sol_van) delta_async, equal to the host codec (16 objects a
   leg one by one, every decode against the stored chunks), each leg's
   MiB/s, busy share and launches.  Launch counts are read around the
   legs: K1, K2 and K3 must each have run there.  Then K3's row view
   at the cauchy_good encode and one-loss decode shapes, the two
   permute copies of that encode, and sliced K1 (k=33,m=1) and K2
   (k=9,m=3,w=32) at 4 MiB a row, beside their byte bounds.  K1-K3's
   rows in the kernels' record carry phase 11's launches, each EC
   path's count and these times;
12. the upmap balancer and the runtime's chip-loss surface
   (`"phase": "balancer"` and `"phase": "faults"` lines).  At 1000 OSDs
   (bench.py's map, every 5th OSD at half reweight as in
   tests/test_scale.py) and one size-3 pool of pg_num 32768:
   BalancerState on the card equals its CPU run (K4/K5's plain
   versions) and launches K4 and K5; one batched_calc_pg_upmaps tick
   at the defaults equals its CPU run (items, changes, rounds,
   candidates, stddev), scores at least 1000 candidates in a ticket,
   no round on the host, the stddev falls, and its items replayed on a
   decoded copy keep tests/test_scale.py's rules; calc_pg_upmaps(1.0,
   100) equals its CPU run; osdmaptool --test-map-pgs --bulk on a
   --createsimple 1000-OSD map prints the host engine's histogram
   (1024 PGs: the host engine takes ~33 ms a PG of that flat map).  Then the
   scorer alone at the tick's largest table beside its byte bound.
   The faults leg, on four logical chips of the card: warmup_ec for
   every device_families() entry of isa 8+3, LRC 4+2+3 and jerasure
   8+3 at w=16 (K1 and K2 launch; the first encode after it is a
   bucket hit); an injected fault on chip 2 fails a sharded encode
   with IOError and loses chip 2 alone; while it is lost its encodes,
   OSDMapMapping and the balancer fail and launch nothing, chip 0's
   encodes are exact and the next sharded flush leaves it out; the
   probe heals it within 2 s once the faults clear; a whole-mesh loss
   fails chip-less ops and heals; prom_lines and the flight
   recorder's Chrome trace pass their lints.  K4/K5's and K1/K2's rows
   in the kernels' record add these launches.

The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import asyncio
import functools
import json
import os
import subprocess
import sys
import time
import zlib
from collections import Counter

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

OBJECTS = 2048          # concurrent encode_async calls per profile
CHUNK = 4096            # bytes per data chunk of each object
CHECKED = 128           # objects per decode / delta round
PROFILES = [
    {"plugin": "isa", "technique": "reed_sol_van", "k": "8", "m": "3"},
    {"plugin": "isa", "technique": "reed_sol_van", "k": "10", "m": "4"},
    {"plugin": "jerasure", "technique": "reed_sol_van", "k": "2",
     "m": "1"},
    {"plugin": "isa", "technique": "cauchy", "k": "6", "m": "3"},
    {"plugin": "jerasure", "technique": "reed_sol_van", "k": "8",
     "m": "3", "w": "16"},
    {"plugin": "jerasure", "technique": "reed_sol_van", "k": "8",
     "m": "3", "w": "32"},
]
SOURCE = "ceph_tpu_torch/csrc/ec_kernels.cu"
REPLACES = {
    "fused_xor": "ceph_tpu/ec/kernels.py:413",
    "bitplane_matmul": "ceph_tpu/ec/kernels.py:124",
    "xor_schedule": "ceph_tpu/ec/kernels.py:210",
}
CRUSH_SOURCE = "ceph_tpu_torch/csrc/crush_kernels.cu"
CRUSH_REPLACES = {
    "choose": "ceph_tpu/ops/crush/pallas_draw.py:418",
    "post": "ceph_tpu/ops/crush/pallas_draw.py:503",
    "hitscan": "ceph_tpu/ops/crush/pallas_draw.py:562",
    "rowcompact": "ceph_tpu/ops/crush/pallas_draw.py:707",
}
N_OSDS = 1000           # bench.py:49-84: 50 straw2 hosts x 20 OSDs
PER_HOST = 20
REP_PGS = 10_000_000    # the replicated pool (size 3)
EC_PGS = 1_000_000      # the erasure pool (chooseleaf indep, k=8 m=3)
EC_SIZE = 11
HOST_SAMPLE = 20_000    # PGs checked against the host pipeline
MOVED_PGS = 296_962     # 10M pool PGs the churn moves (deterministic)
HASH_OPS = 137          # integer instructions of one hash32_3 (K4's bound)
INT_LANES = 64          # integer ALU lanes per SM per clock (cc 9.0)
ISSUE_LANES = 128       # issue slots per SM per clock (4 schedulers x 32)
B1_CLOCKS = 6.699       # clocks per 1-bit m16n8k256 product per SM
HBM_BYTES_S = 3.35e12   # H100 SXM HBM3 peak (data sheet, 700 W): byte bounds
                        # sub-partition (tools/b1_mma_rate.cu, H100)


def emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def all_zero(t: torch.Tensor) -> bool:
    # CUDA torch has no reductions on uint16/uint32
    return not bool(t.to(torch.int64).any())


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# ---------------------------------------------------------------------------
# phase 3: kernel parity
# ---------------------------------------------------------------------------


def parity_phase(dev, K, matrices, gf) -> None:
    rng = np.random.default_rng(1)

    def masks_of(bm):
        return torch.from_numpy(K.pack_rows(bm)).to(dev)

    def same(name, got, plain, **info):
        require(torch.equal(got, plain), "%s differs from its plain "
                "version: %s" % (name, info))
        emit(phase="parity", kernel=name, max_abs_err=0, **info)

    def shifted(t, by=1):
        """t's values in a buffer that starts `by` elements later: a
        pointer off the 16-byte grid (the kernels' narrower paths)."""
        buf = torch.empty(t.numel() + by, dtype=t.dtype, device=dev)
        v = buf[by:].view(t.shape)
        v.copy_(t)
        return v

    def zero_row(bm):
        z = np.array(bm)
        z[1] = 0
        return z

    # K1: k = 1 .. 32, m = 1 .. 6, lanes 1, 7, 8195 and others (ragged,
    # off a multiple of 4), zero columns, a bitmatrix row of zeros, an
    # unaligned view, decode rows
    for k, m, lanes in ((8, 3, 8195), (10, 6, 4099), (4, 2, 1024),
                        (1, 1, 1), (32, 4, 7), (8, 5, 8195), (32, 1, 8)):
        mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, 8)
        bm = matrices.matrix_to_bitmatrix(k, m, 8, mat)
        data = rng.integers(0, 2**32, (k, lanes), dtype=np.uint32)
        data[:, 100:300] = 0
        d = torch.from_numpy(data).to(dev)
        plain = K.fused_xor_plain(d, masks_of(bm))
        got = K.fused_xor(d, masks_of(bm))
        same("fused_xor", got, plain, k=k, m=m, lanes=lanes)
        same("fused_xor", K.fused_xor(shifted(d), masks_of(bm)), plain,
             k=k, m=m, lanes=lanes, view="unaligned")
        same("fused_xor", K.fused_xor(d, masks_of(zero_row(bm))),
             K.fused_xor_plain(d, masks_of(zero_row(bm))), k=k, m=m,
             lanes=lanes, rows="one row of zeros")
        require(all_zero(got[:, 100:300]), "zero columns, nonzero parity")
        cols = np.sort(rng.choice(lanes, min(64, lanes), replace=False))
        host = gf.matmul_u8(np.array(mat, np.uint8),
                            np.ascontiguousarray(data[:, cols]).view(np.uint8))
        require(np.array_equal(np.ascontiguousarray(
            got.cpu().numpy()[:, cols]).view(np.uint8),
                               host), "fused_xor vs gf.matmul_u8")
        erased = (0, k) if m > 1 else (0,)
        surv = tuple(i for i in range(k + m) if i not in erased)
        rows = K._reconstruction_rows(mat, k, 8, erased, surv)
        rbm = matrices.matrix_to_bitmatrix(k, len(rows), 8, rows)
        same("fused_xor", K.fused_xor(d, masks_of(rbm)),
             K.fused_xor_plain(d, masks_of(rbm)), k=k, rows="decode",
             lanes=lanes)

    # K2 at w = 8, 16, 32: encode and decode rows, ragged n (1, 7,
    # 8195), zeros, m*w = 1024 and k*w = 256, a bitmatrix row of zeros,
    # an unaligned view
    for w, k, m, n in ((8, 8, 3, 5001), (16, 8, 3, 3001), (32, 8, 3, 2049),
                       (16, 4, 6, 777), (32, 8, 32, 8195), (32, 1, 1, 1),
                       (8, 32, 2, 7), (16, 16, 4, 8195)):
        mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, w)
        bm = matrices.matrix_to_bitmatrix(k, m, w, mat)
        dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[w]
        data = rng.integers(0, 2**w, (k, n), dtype=np.uint64).astype(dt)
        data[:, 7:90] = 0
        d = torch.from_numpy(data).to(dev)
        plain = K.bitplane_matmul_plain(d, masks_of(bm), w)
        got = K.bitplane_matmul(d, masks_of(bm), w)
        same("bitplane_matmul", got, plain, w=w, k=k, m=m, n=n)
        same("bitplane_matmul", K.bitplane_matmul(shifted(d), masks_of(bm),
                                                  w), plain, w=w, k=k, m=m,
             n=n, view="unaligned")
        same("bitplane_matmul",
             K.bitplane_matmul(d, masks_of(zero_row(bm)), w),
             K.bitplane_matmul_plain(d, masks_of(zero_row(bm)), w), w=w,
             k=k, m=m, n=n, rows="one row of zeros")
        require(all_zero(got[:, 7:90]), "zero columns, nonzero parity")
        cols = np.sort(rng.choice(n, min(32, n), replace=False))
        host = gf.matmul_words(np.array(mat, np.uint64),
                               np.ascontiguousarray(data[:, cols]), w)
        require(np.array_equal(got.cpu().numpy()[:, cols], host.astype(dt)),
                "bitplane_matmul vs gf.matmul_words")
        erased = (1, k + 1) if k > 1 else (0,)
        surv = tuple(i for i in range(k + m) if i not in erased)
        rows = K._reconstruction_rows(mat, k, w, erased, surv)
        rbm = matrices.matrix_to_bitmatrix(k, len(rows), w, rows)
        same("bitplane_matmul", K.bitplane_matmul(d, masks_of(rbm), w),
             K.bitplane_matmul_plain(d, masks_of(rbm), w), w=w,
             rows="decode", n=n)

    # K3: encode and decode on planes8; blocks off the 16-byte grid (odd
    # P), P under one 128-byte column tile, k = 32 (256 input blocks),
    # more than four output chunks in one launch, a bitmatrix row of
    # zeros, views 1, 4 and 8 bytes off the 16-byte grid
    for k, m, P in ((8, 3, 4096), (6, 3, 1001), (10, 6, 64),
                    (32, 8, 1001), (32, 2, 3), (4, 5, 1), (8, 3, 7)):
        mat = matrices.isa_cauchy_matrix(k, m)
        enc = K.PlanesEncoder(mat, dev)
        planes = rng.integers(0, 256, (k * 64, P), dtype=np.uint8)
        planes[:, 10:20] = 0
        p = torch.from_numpy(planes).to(dev)
        n0 = K.LAUNCHES["xor_schedule"]
        got = enc(p)
        require(K.LAUNCHES["xor_schedule"] == n0 + 1,
                "xor_schedule: %d launches for %d output chunks"
                % (K.LAUNCHES["xor_schedule"] - n0, m))
        plain = K.xor_schedule_plain(p, enc._masks)
        same("xor_schedule", got, plain, k=k, m=m, P=P)
        for by in (1, 4, 8):
            same("xor_schedule", enc(shifted(p, by)), plain, k=k, m=m, P=P,
                 view="%d bytes off" % by)
        if P > 20:
            require(all_zero(got[:, 10:20]), "zero columns, nonzero parity")
        zk = masks_of(zero_row(matrices.matrix_to_bitmatrix(k, m, 8, mat)))
        zgot = K.xor_schedule(p, zk)
        same("xor_schedule", zgot, K.xor_schedule_plain(p, zk), k=k, m=m,
             P=P, rows="one row of zeros")
        require(all_zero(zgot[8:16]), "a zero bitmatrix row, nonzero rows")
        if P % 8 == 0:
            host = gf.matmul_u8(np.array(mat, np.uint8),
                                K.planes8_to_bytes(planes, k))
            require(np.array_equal(
                K.planes8_to_bytes(got.cpu().numpy(), m), host),
                "xor_schedule vs gf.matmul_u8")
        erased = (0, k + 1)
        surv = tuple(i for i in range(k + m) if i not in erased)
        dec = enc.decode_rows(erased, surv)
        allp = torch.cat([p, got])
        src = torch.cat([allp[64 * c:64 * c + 64] for c in surv[:k]])
        rec = dec(src)
        same("xor_schedule", rec, K.xor_schedule_plain(src,
             dec.keywords["masks"].masks), k=k, rows="decode", P=P)
        require(torch.equal(rec[:64], p[:64]) and
                torch.equal(rec[64:], got[64:128]),
                "xor_schedule decode does not restore the chunks")


# ---------------------------------------------------------------------------
# phase 4: the slice end to end
# ---------------------------------------------------------------------------


async def slice_round(codec, K, rt, rng) -> dict:
    k = codec.get_data_chunk_count()
    n = codec.get_chunk_count()
    objs = [rng.integers(0, 256, k * CHUNK, dtype=np.uint8).tobytes()
            for _ in range(OBJECTS)]
    want = set(range(n))
    before = dict(K.LAUNCHES)
    noted = rt.chips[0].bucket_hits + rt.chips[0].bucket_misses
    seq0 = rt._seq
    t0 = time.perf_counter()
    encoded = await asyncio.gather(*[codec.encode_async(want, o)
                                     for o in objs])
    t_enc = time.perf_counter() - t0
    # device time of the encode dispatches (CUDA events: copy in,
    # kernel, copy out) over the wall time of the gather
    busy = sum(t.device_s for t in rt.chips[0].tickets if t.seq > seq0)
    for o, got in zip(objs, encoded):
        require(got == codec.encode(want, o), "encode_async != encode")
    out = {"encode_s": t_enc,
           "encode_payload_mib_s": OBJECTS * k * CHUNK / t_enc / 2**20,
           "encode_device_busy_share": busy / t_enc}
    # single-shard and two-shard degraded reads
    for erased in ((0,), (1, k)) if n - k >= 2 else ((0,),):
        survivors = [{i: e[i] for i in range(n) if i not in erased}
                     for e in encoded[:CHECKED]]
        t0 = time.perf_counter()
        got = await asyncio.gather(*[codec.decode_async(set(erased), s)
                                     for s in survivors])
        out["decode_%d_s" % len(erased)] = time.perf_counter() - t0
        for s, g in zip(survivors, got):
            require(g == codec.decode(set(erased), s),
                    "decode_async != decode")
    # partial overwrites: 1 KiB deltas on one or two data chunks
    deltas = [{int(j): rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
               for j in rng.choice(k, 1 + i % 2, replace=False)}
              for i in range(CHECKED)]
    t0 = time.perf_counter()
    got = await asyncio.gather(*[codec.delta_async(d) for d in deltas])
    out["delta_s"] = time.perf_counter() - t0
    for d, g in zip(deltas, got):
        require(g == codec.parity_delta(d), "delta_async != parity_delta")
    out["launches"] = {name: K.LAUNCHES[name] - before[name]
                       for name in K.LAUNCHES}
    out["segments"] = (rt.chips[0].bucket_hits + rt.chips[0].bucket_misses
                       - noted)
    return out


def slice_phase(dev, K, new_codec, DeviceRuntime, gf) -> dict:
    """Drives the main path; returns the launches it made."""
    K.reset_launches()
    rng = np.random.default_rng(2)
    # launches of each kernel shape (k, m, segment words, w): every
    # staged segment is one launch (the require below holds it)
    shapes: dict[str, Counter] = {"fused_xor": Counter(),
                                  "bitplane_matmul": Counter()}

    async def run_all():
        rt = DeviceRuntime.get(dev)
        require(rt.dispatch_mode == "stream", "stream mode is the default")
        chip = rt.chips[0]
        noted = chip.note_program

        def note_program(kind, key):
            mkey, w, seg = key
            shapes["fused_xor" if w == 8 else "bitplane_matmul"][
                (len(mkey[0]), len(mkey), seg, w)] += 1
            return noted(kind, key)

        chip.note_program = note_program
        for prof in PROFILES:
            codec = new_codec(dict(prof), device=dev)
            res = await slice_round(codec, K, rt, rng)
            w = int(prof.get("w", 8))
            kern = "fused_xor" if w == 8 else "bitplane_matmul"
            other = "bitplane_matmul" if w == 8 else "fused_xor"
            # every staged segment is one launch (decode rows and m <= 4
            # fit one row group), and only this profile's kernel ran
            require(res["launches"][kern] == res["segments"] > 0,
                    "%s launches %s != segments %d" % (
                        kern, res["launches"], res["segments"]))
            require(res["launches"][other] == 0, "wrong kernel launched")
            emit(phase="slice", profile=prof, objects=OBJECTS,
                 object_bytes=codec.get_data_chunk_count() * CHUNK, **res)
        del chip.note_program
        emit(phase="slice", metrics=rt.metrics(),
             dispatch_ms=rt.dispatch_pctls())

    asyncio.run(run_all())

    # K3 on the main path: PlanesEncoder at 64 MiB of k=8 payload
    from ceph_tpu_torch.ec import matrices
    k, m = 8, 3
    mat = matrices.isa_rs_vandermonde_matrix(k, m)
    enc = K.PlanesEncoder(mat, dev)
    stripes = rng.integers(0, 256, (OBJECTS, k, CHUNK), dtype=np.uint8)
    t0 = time.perf_counter()
    parity = enc.encode_stripes(stripes)
    t_stripes = time.perf_counter() - t0
    flat = np.ascontiguousarray(stripes.transpose(1, 0, 2)).reshape(k, -1)
    host = gf.matmul_u8(np.array(mat, np.uint8), flat)
    require(np.array_equal(
        np.ascontiguousarray(parity.transpose(1, 0, 2)).reshape(m, -1),
        host), "encode_stripes != gf.matmul_u8")
    planes = torch.from_numpy(K.bytes_to_planes8(flat)).to(dev)
    pplanes = enc(planes)
    erased = (0, 9)
    surv = tuple(i for i in range(k + m) if i not in erased)
    allp = torch.cat([planes, pplanes])
    src = torch.cat([allp[64 * c:64 * c + 64] for c in surv[:k]])
    rec = enc.decode_rows(erased, surv)(src)
    require(torch.equal(rec[:64], planes[:64])
            and torch.equal(rec[64:], pplanes[64:128]),
            "decode_rows does not restore the chunks")
    emit(phase="slice", encoder="PlanesEncoder", k=k, m=m,
         payload_bytes=int(flat.size), encode_stripes_s=t_stripes)
    launches = dict(K.LAUNCHES)
    for name, count in launches.items():
        require(count > 0, "%s was not launched on the main path" % name)
    emit(phase="slice", launches=launches)
    return launches, shapes


# ---------------------------------------------------------------------------
# phase 9: the recovery codecs end to end
# ---------------------------------------------------------------------------


def _lrc_w16_layers() -> str:
    """The k=4,m=2,l=3 layer shape at w=16 (the kml shorthand pins
    w=8 through its layer defaults)."""
    return json.dumps([["DDc_DDc_", "w=16"], ["DDDc____", "w=16"],
                       ["____DDDc", "w=16"]])


# bench.py:1336-1341's four profiles, each with BASELINE.json's repair
# bytes read per 256 KiB object (published.repair_traffic), then the
# baseline's LRC, an LRC at w=16 and a SHEC at w=32 (K2's legs)
RECOVERY_PROFILES = [
    ("rs", {"plugin": "jerasure", "technique": "reed_sol_van", "k": "8",
            "m": "4", "w": "8"}, 262144),
    ("lrc", {"plugin": "lrc", "k": "8", "m": "4", "l": "3"}, 98304),
    ("shec", {"plugin": "shec", "k": "8", "m": "4", "c": "3", "w": "8"},
     131072),
    ("clay", {"plugin": "clay", "k": "4", "m": "2"}, 163840),
    ("lrc-k4m2l3", {"plugin": "lrc", "k": "4", "m": "2", "l": "3"}, None),
    ("lrc-w16", {"plugin": "lrc", "mapping": "DD__DD__",
                 "layers": _lrc_w16_layers()}, None),
    ("shec-w32", {"plugin": "shec", "k": "4", "m": "3", "c": "2",
                  "w": "32"}, None),
]
RECOVERY_OBJECTS = 256          # concurrent objects a leg
RECOVERY_BYTES = 256 << 10      # bytes an object (bench.py:1303)
DOUBLE_OBJECTS = 64             # objects of the double-loss leg


class leg_meter:
    """Launches, dispatch tickets and wall time of one leg."""

    def __init__(self, K, kern: str, other: str):
        self.K, self.kern, self.other = K, kern, other
        self.tickets: dict[int, object] = {}

    def on_ticket(self, ticket) -> None:
        self.tickets[ticket.seq] = ticket

    def __enter__(self):
        self.before = dict(self.K.LAUNCHES)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.wall = time.perf_counter() - self.t0
        self.launches = {name: self.K.LAUNCHES[name] - self.before[name]
                         for name in (self.kern, self.other)}
        return False

    def record(self, what: str) -> dict:
        # the codec's own K1 (w=8) or K2 (w=16/32) launches, and no other
        require(self.launches[self.kern] > 0
                and self.launches[self.other] == 0,
                "%s: launches %s" % (what, self.launches))
        busy = sum(t.device_s for t in self.tickets.values())
        return {"s": self.wall, "dispatches": len(self.tickets),
                "device_busy_share": busy / self.wall,
                "launches": self.launches}


async def recovery_leg(name, prof, expect_read, K, new_codec,
                       DeviceRuntime, dev, rng) -> dict:
    from ceph_tpu_torch.device.runtime import K_RECOVERY_EC
    codec = new_codec(dict(prof), device=dev)
    n = codec.get_chunk_count()
    everything = set(range(n))
    w = {int(mat_w[1]) for mat_w in codec.device_families()}
    require(len(w) == 1, "%s: one word width" % name)
    w = w.pop()
    kern = "fused_xor" if w == 8 else "bitplane_matmul"
    other = "bitplane_matmul" if w == 8 else "fused_xor"
    DeviceRuntime.reset(device=dev)
    objs = [rng.integers(0, 256, RECOVERY_BYTES, dtype=np.uint8).tobytes()
            for _ in range(RECOVERY_OBJECTS)]
    out = {"w": w, "objects": RECOVERY_OBJECTS,
           "object_bytes": RECOVERY_BYTES}

    # CLAY's 2x2 coupling solves are host numpy: time them in the legs
    coupling = [0.0]
    if hasattr(codec, "_pair"):
        pair = codec._pair

        def timed_pair(*a):
            t = time.perf_counter()
            try:
                return pair(*a)
            finally:
                coupling[0] += time.perf_counter() - t

        codec._pair = timed_pair

    # 1. encode
    with leg_meter(K, kern, other) as m:
        stored = await asyncio.gather(*[
            codec.encode_async(everything, o, on_ticket=m.on_ticket)
            for o in objs])
    out["encode"] = m.record(name + " encode")
    out["encode"]["payload_mib_s"] = (RECOVERY_OBJECTS * RECOVERY_BYTES
                                      / m.wall / 2**20)
    out["encode"]["coupling_s"] = coupling[0]
    for o, got in zip(objs, stored):
        require(got == codec.encode(everything, o),
                "%s: encode_async != encode" % name)

    # 2. a single data-shard loss, repaired from exactly the plan
    mapping = codec.get_chunk_mapping()
    lost = mapping[0] if mapping else 0
    plan = codec.minimum_to_decode({lost}, everything - {lost})
    sub = codec.get_sub_chunk_count()
    partial = any(runs != [(0, sub)] for runs in plan.values())
    reads = []
    for s in stored:
        if partial:
            sc = len(s[lost]) // sub
            reads.append({h: b"".join(s[h][off * sc:(off + cnt) * sc]
                                      for off, cnt in runs)
                          for h, runs in plan.items()})
        else:
            reads.append({h: s[h] for h in plan})
    coupling[0] = 0.0
    with leg_meter(K, kern, other) as m:
        if partial:
            rebuilt = await asyncio.gather(*[
                codec.repair_async(lost, r, klass=K_RECOVERY_EC,
                                   on_ticket=m.on_ticket)
                for r in reads])
        else:
            rebuilt = [d[lost] for d in await asyncio.gather(*[
                codec.decode_async({lost}, r, klass=K_RECOVERY_EC,
                                   on_ticket=m.on_ticket)
                for r in reads])]
    out["repair"] = m.record(name + " repair")
    out["repair"]["coupling_s"] = coupling[0]
    for s, got in zip(stored, rebuilt):
        require(got == s[lost], "%s: repaired shard != stored" % name)
    per_obj = {sum(map(len, r.values())) for r in reads}
    require(len(per_obj) == 1, "%s: uneven repair reads" % name)
    per_obj = per_obj.pop()
    require(expect_read is None or per_obj == expect_read,
            "%s: repair read %d bytes an object, not %s"
            % (name, per_obj, expect_read))
    out["repair"].update(lost=lost, helpers=sorted(plan),
                         sub_chunk_runs=partial,
                         bytes_read_per_object=per_obj,
                         ms_per_object=m.wall * 1e3 / RECOVERY_OBJECTS)

    # 3. one data and one parity shard lost, decoded on the card
    data_pos = [codec.chunk_index(i)
                for i in range(codec.get_data_chunk_count())]
    parity = [i for i in range(n) if i not in data_pos][-1]
    erased = {lost, parity}
    survivors = [{c: s[c] for c in everything - erased}
                 for s in stored[:DOUBLE_OBJECTS]]
    with leg_meter(K, kern, other) as m:
        got = await asyncio.gather(*[
            codec.decode_async(erased, r, klass=K_RECOVERY_EC,
                               on_ticket=m.on_ticket)
            for r in survivors])
    out["double"] = m.record(name + " double loss")
    out["double"].update(erased=sorted(erased), objects=DOUBLE_OBJECTS)
    for r, g in zip(survivors, got):
        require(g == codec.decode(erased, r),
                "%s: decode_async != decode" % name)
    return out


def recovery_phase(dev, K, new_codec, DeviceRuntime) -> dict:
    """Drives LRC, SHEC and CLAY (and RS beside them) through
    encode_async / decode_async / repair_async; returns each leg's K1
    and K2 launches."""
    K.reset_launches()
    t0 = time.perf_counter()
    rng = np.random.default_rng(43)
    reads = {}
    launches = {}

    async def run_all():
        for name, prof, expect in RECOVERY_PROFILES:
            res = await recovery_leg(name, prof, expect, K, new_codec,
                                     DeviceRuntime, dev, rng)
            reads[name] = res["repair"]["bytes_read_per_object"]
            launches[name] = {leg: res[leg]["launches"]
                              for leg in ("encode", "repair", "double")}
            emit(phase="recovery", profile=name, **res)

    asyncio.run(run_all())
    ratios = {name: reads[name] / reads["rs"]
              for name in ("lrc", "shec", "clay")}
    require(ratios == {"lrc": 0.375, "shec": 0.5, "clay": 0.625},
            "repair read ratios %s" % ratios)
    emit(phase="recovery", repair_read_vs_rs=ratios, launches=launches,
         totals=dict(K.LAUNCHES), seconds=time.perf_counter() - t0)
    return launches


# ---------------------------------------------------------------------------
# phase 10: the background planes end to end
# ---------------------------------------------------------------------------

OBJECT_BYTES = 4 << 20      # RBD's default object size
DEEP_OBJECTS = 25           # a deep-scrub chunk: 100 MiB of objects
# tests/test_tlz.py:138: the seed-0 parity corpus's pinned digest
TLZ_CORPUS_SHA = ("6b5a8a918a2b73648cdf56451168ba36e0e6ce3cd285582b0b595d"
                  "576f27ab79")


class host_timer:
    """Sums the seconds spent in one module function while active."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.s = 0.0

    def __enter__(self):
        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return self.fn(*a, **kw)
            finally:
                self.s += time.perf_counter() - t

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


async def background_leg(name, payload, call, check, timer, repeats, dev,
                         **info) -> dict:
    """Warms `call` once (its result held against the oracle by
    `check`), then times it `repeats` times on a fresh runtime: wall,
    dispatches, their CUDA-event device seconds and the busy share,
    and the host seconds in `timer`'s function."""
    from ceph_tpu_torch.device.runtime import K_BACKGROUND, DeviceRuntime
    rt = DeviceRuntime.reset(device=dev)
    chip = rt.chips[0]
    passes = []
    with timer:
        for i in range(1 + repeats):
            seq0, d0 = rt._seq, chip.dispatches
            timer.s = 0.0
            t0 = time.perf_counter()
            out = await call()
            wall = time.perf_counter() - t0
            tickets = [t for t in chip.tickets if t.seq > seq0]
            require(len(tickets) == chip.dispatches - d0 > 0
                    and all(t.ok and t.klass == K_BACKGROUND
                            for t in tickets),
                    "%s: dispatch tickets" % name)
            dev_s = sum(t.device_s for t in tickets)
            passes.append({"s": wall, "dispatches": len(tickets),
                           "device_s": dev_s, "busy_share": dev_s / wall,
                           "dispatch_ms": dev_s * 1e3 / len(tickets),
                           timer.name + "_s": timer.s})
            if i == 0:
                check(out)
    timed = passes[1:]
    rec = {"leg": name, "payload_bytes": payload, **info,
           "warm": passes[0], "timed": timed,
           "mib_s": [payload / p["s"] / 2**20 for p in timed],
           "metrics": chip.metrics()}
    emit(phase="background", **rec)
    return rec


def compress_corpus(rng, n_objs: int = 24) -> list[bytes]:
    """bench.py:1523-1537: 8-256 KiB log-uniform, text / zero / random."""
    blobs = []
    for i in range(n_objs):
        size = int(np.exp(rng.uniform(np.log(8 << 10), np.log(256 << 10))))
        kind = i % 3
        if kind == 0:
            unit = rng.integers(0x20, 0x7F, 24, dtype=np.uint8).tobytes()
            blobs.append((unit * (size // len(unit) + 1))[:size])
        elif kind == 1:
            blobs.append(bytes(size))
        else:
            blobs.append(rng.integers(0, 256, size,
                                      dtype=np.uint8).tobytes())
    return blobs


def tlz_parity_corpus(seed: int) -> list[bytes]:
    """tests/test_tlz.py:141-157's seeded corpus."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(10):
        size = int(rng.integers(1, 5 * 4096))
        kind = i % 3
        if kind == 0:
            unit = rng.integers(0x20, 0x7F, 16, dtype=np.uint8).tobytes()
            out.append((unit * (size // 16 + 1))[:size])
        elif kind == 1:
            out.append(bytes(size))
        else:
            out.append(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    return out


def dedup_corpus(rng, n_objs: int, avg: int) -> list[bytes]:
    """bench.py:1697-1709: four multi-chunk payloads, each written
    verbatim by several objects."""
    vocab = []
    for _ in range(4):
        n = int(rng.integers(3, 6))
        vocab.append(rng.integers(0, 256, n * avg, dtype=np.uint8).tobytes())
    return [vocab[i % len(vocab)] for i in range(n_objs)]


def background_programs(dev, digest, lz, ch) -> list[dict]:
    """Each plane's program alone at the main path's dispatch shape, on
    resident inputs, beside its byte bound: the stage, lens and table
    read once, the outputs written once, over 3.35 TB/s.  `ms` is the
    device span of its kernels (torch.profiler over warm calls), with
    CUDA events around back-to-back calls and the costliest kernels
    beside it.  Each result is held against its oracle.  A dispatch
    also copies its stage over PCIe: a pinned 32 MiB copy's rate is
    printed first."""
    rng = np.random.default_rng(53)
    rows = []
    host = torch.empty(digest.DEVICE_MAX_STAGE_BYTES, dtype=torch.uint8,
                       pin_memory=True)
    h2d_ms = cuda_ms(lambda: host.to(dev, non_blocking=True), 10)
    emit(phase="background", yardstick="pinned host-to-device copy",
         bytes=host.numel(), ms=h2d_ms, gb_s=host.numel() / h2d_ms / 1e6)

    def row(name, shape, fn, nbytes):
        ms, how = device_ms(fn, 20)
        rec = dict(program=name, shape=shape, ms=ms, ms_from=how,
                   events_ms=cuda_ms(fn, 20), bytes=nbytes,
                   bound_ms=nbytes / HBM_BYTES_S * 1e3,
                   top=device_profile(fn, top=4).get("top"))
        rec["share"] = rec["bound_ms"] / ms
        emit(phase="background", **rec)
        rows.append(rec)

    lanes, width = 2048, digest.DEVICE_MAX_BYTES
    stage = rng.integers(0, 256, (lanes, width), dtype=np.uint8)
    lens = rng.integers(0, width + 1, lanes).astype(np.int32)
    lens[:1024] = width
    table = digest._device_table(width, dev)
    s_d, l_d = torch.from_numpy(stage).to(dev), torch.from_numpy(lens).to(dev)
    lin = digest.digest_lanes(s_d, l_d, table).cpu().numpy().view(np.uint32)
    z = digest._tables(width)[1]
    require([int(v) ^ int(z[n]) for v, n in zip(lin, lens)]
            == [zlib.crc32(stage[i, :n].tobytes())
                for i, n in enumerate(lens)], "digest_lanes != zlib")
    row("digest_lanes", [lanes, width],
        lambda: digest.digest_lanes(s_d, l_d, table),
        stage.nbytes + lens.nbytes + table.numel() * 4 + lanes * 4)

    lanes = lz._MAX_LANES
    text = rng.integers(0x20, 0x7F, 24, dtype=np.uint8).tobytes()
    segs = [(text * 200)[:lz.TLZ_BLOCK] if i % 2 else
            rng.integers(0, 256, lz.TLZ_BLOCK, dtype=np.uint8).tobytes()
            for i in range(lanes)]
    stage, lens = lz._stage_blocks(segs, lanes)
    s_d, l_d = torch.from_numpy(stage).to(dev), torch.from_numpy(lens).to(dev)
    c, m = lz.match_plan(s_d, l_d)
    want_c, want_m = lz.match_plan_host(stage, lens)
    require(np.array_equal(c.cpu().numpy(), want_c)
            and np.array_equal(m.cpu().numpy(), want_m),
            "match_plan != match_plan_host")
    row("match_plan", [lanes, lz.TLZ_BLOCK], lambda: lz.match_plan(s_d, l_d),
        stage.nbytes + lens.nbytes + 2 * 4 * stage.size)

    lanes = ch._MAX_LANES
    blob = rng.integers(0, 256, lanes * ch.SEG, dtype=np.uint8).tobytes()
    segs, _ns = ch._segments([blob])
    stage = np.zeros((lanes, ch.MARGIN + ch.SEG), np.uint8)
    lens = ch._stage_segments(segs, lanes, stage)
    s_d, l_d = torch.from_numpy(stage).to(dev), torch.from_numpy(lens).to(dev)
    require(np.array_equal(ch.candidate_mask(s_d, l_d).cpu().numpy(),
                           ch._mask_lanes_host(stage, lens)),
            "candidate_mask != _mask_lanes_host")
    row("candidate_mask", [lanes, ch.MARGIN + ch.SEG],
        lambda: ch.candidate_mask(s_d, l_d),
        stage.nbytes + lens.nbytes + lanes * ch.SEG)
    return rows


def background_phase(dev) -> None:
    """Drives crc32_batch, compress_async and boundary_batch /
    fingerprint_batch at deployment sizes, each pass's result held
    against its oracle, then times each program alone."""
    import hashlib

    from ceph_tpu_torch.compress import tlz
    from ceph_tpu_torch.dedup import chunker as ch
    from ceph_tpu_torch.device import digest, lzkernel as lz

    t0 = time.perf_counter()

    async def scrub(bufs):
        out, path = await digest.crc32_batch(bufs, device=dev)
        require(path == "device", "crc32_batch path %s" % path)
        return out

    def scrub_check(bufs):
        def check(out):
            require(out == [zlib.crc32(b) for b in bufs],
                    "crc32_batch != zlib.crc32")
        return check

    async def compress_all(objs):
        out = []
        for o in objs:
            blob, path = await tlz.compress_async(o, device=dev)
            require(path == "device", "compress_async path %s" % path)
            out.append(blob)
        return out

    def compress_check(objs):
        def check(blobs):
            for o, b in zip(objs, blobs):
                require(b == tlz.compress_host(o),
                        "compress_async != compress_host")
                require(tlz.decompress(b) == o, "tlz round trip")
        return check

    async def dedup_all(blobs):
        cuts, path = await ch.boundary_batch(blobs, device=dev)
        chunks = [c for b, cc in zip(blobs, cuts) for c in ch.split(b, cc)]
        fps, fpath = await ch.fingerprint_batch(chunks, device=dev)
        require((path, fpath) == ("device", "device"),
                "dedup paths %s %s" % (path, fpath))
        return cuts, chunks, fps

    def dedup_check(blobs):
        def check(out):
            cuts, chunks, fps = out
            require(cuts == [ch.chunk_host(b) for b in blobs],
                    "boundary_batch != chunk_host")
            for b, cc in zip(blobs, cuts):
                sizes = [len(c) for c in ch.split(b, cc)]
                require(all(ch.CHUNK_MIN <= s <= ch.CHUNK_MAX
                            for s in sizes[:-1])
                        and sizes[-1] <= ch.CHUNK_MAX,
                        "chunk sizes %s" % sizes)
            require(fps == [ch.fingerprint(zlib.crc32(c), len(c))
                            for c in chunks], "fingerprints != zlib")
        return check

    async def run_all():
        rng = np.random.default_rng(41)
        bufs = [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
                for _ in range(256)]
        await background_leg(
            "scrub-bench", 256 * 4096, lambda: scrub(bufs),
            scrub_check(bufs), host_timer(digest, "crc32_combine"), 5,
            dev, buffers=256, buffer_bytes=4096)

        rng = np.random.default_rng(42)
        deep = []
        for _ in range(DEEP_OBJECTS):
            deep.append(rng.integers(0, 256, OBJECT_BYTES,
                                     dtype=np.uint8).tobytes())
            deep.append(rng.integers(0, 256, int(rng.integers(200, 600)),
                                     dtype=np.uint8).tobytes())
        rec = await background_leg(
            "deep-scrub", sum(map(len, deep)), lambda: scrub(deep),
            scrub_check(deep), host_timer(digest, "crc32_combine"), 1,
            dev, objects=DEEP_OBJECTS, object_bytes=OBJECT_BYTES)
        # 16 KiB lanes, DEVICE_MAX_STAGE_BYTES a dispatch: 4 at 100 MiB
        lanes = sum(-(-len(b) // digest.DEVICE_MAX_BYTES) for b in deep)
        per = digest.DEVICE_MAX_STAGE_BYTES // digest.DEVICE_MAX_BYTES
        require(rec["warm"]["dispatches"] == -(-lanes // per),
                "deep scrub dispatches")

        parity = tlz_parity_corpus(0)
        sha = hashlib.sha256()
        for blob in await compress_all(parity):
            sha.update(blob)
        require(sha.hexdigest() == TLZ_CORPUS_SHA,
                "tlz corpus digest %s" % sha.hexdigest())
        emit(phase="background", leg="tlz-parity-corpus", seed=0,
             sha256=sha.hexdigest())

        corpus = compress_corpus(np.random.default_rng(41))
        await background_leg(
            "compress-bench", sum(map(len, corpus)),
            lambda: compress_all(corpus), compress_check(corpus),
            host_timer(tlz, "_assemble"), 3, dev, objects=len(corpus))
        rng = np.random.default_rng(43)
        unit = rng.integers(0x20, 0x7F, 24, dtype=np.uint8).tobytes()
        big = [(unit * (OBJECT_BYTES // 24 + 1))[:OBJECT_BYTES],
               bytes(OBJECT_BYTES),
               rng.integers(0, 256, OBJECT_BYTES, dtype=np.uint8).tobytes()]
        rec = await background_leg(
            "compress-4mib", 3 * OBJECT_BYTES, lambda: compress_all(big),
            compress_check(big), host_timer(tlz, "_assemble"), 1, dev,
            objects=["text", "zero", "random"])
        m = rec["metrics"]
        emit(phase="background", leg="compress-4mib",
             ratio=m["device_compress_bytes_out"]
             / m["device_compress_bytes_in"])

        corpus = dedup_corpus(np.random.default_rng(47), 12, ch.CHUNK_AVG)
        await background_leg(
            "dedup-bench", sum(map(len, corpus)), lambda: dedup_all(corpus),
            dedup_check(corpus), host_timer(ch, "resolve_cuts"), 3, dev,
            objects=len(corpus))
        rng = np.random.default_rng(48)
        big = [rng.integers(0, 256, OBJECT_BYTES, dtype=np.uint8).tobytes()
               for _ in range(4)]
        await background_leg(
            "dedup-4mib", 4 * OBJECT_BYTES, lambda: dedup_all(big),
            dedup_check(big), host_timer(ch, "resolve_cuts"), 1, dev,
            objects=4)

    asyncio.run(run_all())
    background_programs(dev, digest, lz, ch)
    emit(phase="background", seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------


def timing_phase(dev, K, matrices, launches, shapes) -> list[dict]:
    rng = np.random.default_rng(3)
    big = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(big)
    copy_bps = 2 * big.numel() / (cuda_ms(lambda: dst.copy_(big), 10) / 1e3)
    del big, dst
    emit(phase="times", yardstick="copy_", bytes=2 << 30,
         gb_s=copy_bps / 1e9, share_of_peak=copy_bps / HBM_BYTES_S)
    rows = []

    # The bound is the larger of two times: the bytes a kernel must
    # move (inputs read once, outputs written once) over the card's
    # peak memory rate, and its operations over the card's rate for their
    # type.  K1 and K2 run a 1-bit AND-popcount product on the tensor
    # cores, 2 * (k*w) * (m*w) operations per column.  The data sheet
    # gives no 1-bit rate for the H100; tools/b1_mma_rate.cu measures
    # one m16n8k256 product (65536 operations) per B1_CLOCKS clocks on
    # each of an SM's four sub-partitions, at the maximum SM clock.  K3's
    # XORs (below) are far under its bytes.  (K4's bound, phase 8, is its
    # integer operations.)
    b1_ops = (2 * 16 * 8 * 256 * 4 / B1_CLOCKS * sm_clock_hz() *
              torch.cuda.get_device_properties(dev).multi_processor_count)

    def bound(nbytes, ops=0, op_ms=None):
        """(ms, by): op_ms, else ops at the 1-bit product rate."""
        byte_ms = nbytes / HBM_BYTES_S * 1e3
        if op_ms is None:
            op_ms = ops / b1_ops * 1e3
        return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms,
                                                            "operations")

    def record(name, ms, plain_ms, nbytes, err, ops=0, op_ms=None, **info):
        require(err == 0, "%s differs from its plain version at %s: "
                "max_abs_err %d" % (name, info, err))
        bound_ms, bound_by = bound(nbytes, ops, op_ms)
        rec = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "gb_s": nbytes / (ms / 1e3) / 1e9,
               "op_bound_ms": (ops / b1_ops * 1e3 if op_ms is None
                               else op_ms),
               "share_of_bound": bound_ms / ms, **info}
        emit(phase="times", **rec)
        return rec

    def masks_of(bm):
        return torch.from_numpy(K.pack_rows(bm)).to(dev)

    def k1_row(k, m, lanes, iters):
        """K1 on (k, lanes) uint32 with m output chunks: the kernel's
        and the plain version's times, bytes, operations, error."""
        mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, 8)
        mk = masks_of(np.array(matrices.matrix_to_bitmatrix(k, m, 8, mat)))
        d = torch.from_numpy(rng.integers(0, 2**32, (k, lanes),
                                          dtype=np.uint32)).to(dev)
        got = K.fused_xor(d, mk)
        plain = K.fused_xor_plain(d, mk)
        ms, timed_by = device_ms(lambda: K.fused_xor(d, mk), iters)
        return {"ms": ms, "timed_by": timed_by,
                "call_ms": cuda_ms(lambda: K.fused_xor(d, mk), iters),
                "plain_ms": cuda_ms(lambda: K.fused_xor_plain(d, mk), 2),
                "nbytes": (k + m) * lanes * 4,
                "ops": 2 * (8 * k) * (8 * m) * 4 * lanes,
                "max_abs_err": max_abs_err(got, plain)}

    # K1 at the smallest, the median and the largest shape the main path
    # staged (k, m, lanes), each with its launches there
    seen = sorted(shapes["fused_xor"].items(),
                  key=lambda kv: ((kv[0][0] + kv[0][1]) * kv[0][2], kv[0]))
    segments = []
    for (k, m, seg, _w), count in (seen[0], seen[len(seen) // 2],
                                   seen[-1]):
        r = k1_row(k, m, seg // 4, 50)
        require(r["max_abs_err"] == 0, "fused_xor differs from its plain "
                "version at k=%d, m=%d, %d lanes" % (k, m, seg // 4))
        bound_ms, bound_by = bound(r["nbytes"], r["ops"])
        segments.append({"k": k, "m": m, "lanes": seg // 4,
                         "launches": count, "ms": r["ms"],
                         "timed_by": r["timed_by"], "call_ms": r["call_ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
                         "bound_by": bound_by, "max_abs_err": 0})
        emit(phase="times", kernel="fused_xor", segment=segments[-1])
    # K1: k=8,m=3 at 32 MiB per chunk row
    k, m = 8, 3
    r = k1_row(k, m, (32 << 20) // 4, 20)
    rows.append(record("fused_xor", r["ms"], r["plain_ms"], r["nbytes"],
                       r["max_abs_err"], r["ops"], timed_by=r["timed_by"],
                       call_ms=r["call_ms"],
                       shape="k=8,m=3, 32 MiB per chunk row",
                       segments=segments,
                       segment_shapes_staged=len(seen)))

    # K2 at the largest slot the main path staged, for each w
    by_w = {}
    for w in (32, 16, 8):
        seg = max((s[2] for s in shapes["bitplane_matmul"] if s[3] == w),
                  default=1 << 19)
        mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, w)
        bm = np.array(matrices.matrix_to_bitmatrix(k, m, w, mat))
        mk = masks_of(bm)
        dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[w]
        d = torch.from_numpy(rng.integers(0, 2**w, (k, seg),
                                          dtype=np.uint64).astype(dt)
                             ).to(dev)
        ms, timed_by = device_ms(lambda: K.bitplane_matmul(d, mk, w), 20)
        call_ms = cuda_ms(lambda: K.bitplane_matmul(d, mk, w), 20)
        plain_ms = cuda_ms(lambda: K.bitplane_matmul_plain(d, mk, w), 2)
        err = max_abs_err(K.bitplane_matmul(d, mk, w),
                          K.bitplane_matmul_plain(d, mk, w))
        require(err == 0, "bitplane_matmul differs from its plain "
                "version at w=%d, n=%d: max_abs_err %d" % (w, seg, err))
        nbytes = (k + m) * seg * w // 8
        ops = 2 * (k * w) * (m * w) * seg
        bound_ms, bound_by = bound(nbytes, ops)
        by_w[w] = {"ms": ms, "timed_by": timed_by, "call_ms": call_ms,
                   "plain_ms": plain_ms, "n": seg,
                   "bytes": nbytes, "ops": ops, "bound_ms": bound_ms,
                   "bound_by": bound_by, "max_abs_err": err}
    top = by_w[32]
    rows.append(record("bitplane_matmul", top["ms"], top["plain_ms"],
                       top["bytes"], max(
                           v["max_abs_err"] for v in by_w.values()),
                       top["ops"], timed_by=top["timed_by"],
                       call_ms=top["call_ms"],
                       shape="k=8,m=3, w=32, n=%d words" % top["n"],
                       by_w={str(w): v for w, v in by_w.items()}))

    # K3 at the main path's encode (k=8,m=3 planes8, 64 MiB of payload)
    # and at bench.py's reconstruct leg (one lost data shard of k=8,m=3
    # from 256 MiB of survivor planes).  Operations: the schedule's
    # 32-bit XORs (a row of c sources takes c - 1 a word), two to a
    # 3-input XOR on the integer pipe (INT_LANES a SM a clock); beside
    # them the shared-memory reads the design makes, popcount x block,
    # and their time at 128 bytes a clock an SM.
    props = torch.cuda.get_device_properties(dev)
    int_per_s = props.multi_processor_count * INT_LANES * sm_clock_hz()
    smem_per_s = props.multi_processor_count * 128 * sm_clock_hz()
    enc = K.PlanesEncoder(matrices.isa_rs_vandermonde_matrix(k, m), dev)
    survivors = tuple(i for i in range(k + m) if i != 3)
    by_shape = {}
    for shape, fn, P in (
            ("encode", enc, OBJECTS * CHUNK // 64),
            ("reconstruct", enc.decode_rows((3,), survivors), 524288)):
        sched = fn.keywords["masks"] if fn is not enc else enc._schedule
        masks = sched.masks
        planes = torch.from_numpy(rng.integers(0, 256, (k * 64, P),
                                               dtype=np.uint8)).to(dev)
        ms, timed_by = device_ms(lambda: fn(planes), 20)
        got = fn(planes)
        err = max_abs_err(got, K.xor_schedule_plain(planes, masks))
        require(err == 0, "xor_schedule differs from its plain version at "
                "the %s shape: max_abs_err %d" % (shape, err))
        counts = sched.spans[:, 1].cpu()
        xors = int((counts - 1).clamp(min=0).sum()) * 8 * P // 4
        nbytes = planes.numel() + got.numel()
        op_ms = xors / 2 / int_per_s * 1e3
        bound_ms, bound_by = bound(nbytes, op_ms=op_ms)
        by_shape[shape] = {
            "ms": ms, "timed_by": timed_by,
            "call_ms": cuda_ms(lambda: fn(planes), 20),
            "plain_ms": cuda_ms(
                lambda: K.xor_schedule_plain(planes, masks), 2),
            "k": k, "out_rows": masks.shape[0], "P": P, "bytes": nbytes,
            "popcount": sched.pop, "xor_ops": xors, "op_bound_ms": op_ms,
            "smem_read_bytes": sched.pop * 8 * P,
            "smem_read_ms": sched.pop * 8 * P / smem_per_s * 1e3,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms, "max_abs_err": err}
        del planes, got
    top = by_shape["encode"]
    rows.append(record("xor_schedule", top["ms"], top["plain_ms"],
                       top["bytes"], 0, op_ms=top["op_bound_ms"],
                       timed_by=top["timed_by"], call_ms=top["call_ms"],
                       shape="k=8,m=3, 64 MiB payload",
                       popcount=top["popcount"], xor_ops=top["xor_ops"],
                       smem_read_bytes=top["smem_read_bytes"],
                       smem_read_ms=top["smem_read_ms"],
                       by_shape=by_shape))
    return rows


# ---------------------------------------------------------------------------
# phase 6: CRUSH kernel parity
# ---------------------------------------------------------------------------


def crush_map(choose_args: bool = False):
    """bench.py's bulk map: 50 straw2 hosts x 20 OSDs under a straw2
    root; rule 0 chooseleaf firstn, rule 1 chooseleaf indep (hosts)."""
    from ceph_tpu_torch.models.crushmap import (
        CHOOSELEAF_FIRSTN, CHOOSELEAF_INDEP, EMIT, STRAW2, TAKE, CrushMap,
        WeightSet)
    crush = CrushMap()
    hosts = []
    for h in range(N_OSDS // PER_HOST):
        items = list(range(h * PER_HOST, (h + 1) * PER_HOST))
        hosts.append(crush.add_bucket(STRAW2, 1, items,
                                      [0x10000] * PER_HOST,
                                      id=-(h + 2)).id)
    crush.add_bucket(STRAW2, 2, hosts,
                     [crush.buckets[h].weight for h in hosts], id=-1)
    crush.add_rule([(TAKE, -1, 0), (CHOOSELEAF_FIRSTN, 0, 1),
                    (EMIT, 0, 0)], id=0)
    crush.add_rule([(TAKE, -1, 0), (CHOOSELEAF_INDEP, 0, 1),
                    (EMIT, 0, 0)], id=1)
    if choose_args:
        rng = np.random.default_rng(4)
        sets = {}
        for bid, b in crush.buckets.items():
            ws = [rng.choice([0, 0x8000, 0x10000, 0x20000],
                             b.size).tolist() for _ in range(3)]
            ids = (rng.integers(0, 1 << 30, b.size).tolist() if bid == -1
                   else None)
            sets[bid] = WeightSet(bucket_id=bid, weight_sets=ws, ids=ids)
        crush.choose_args["opt"] = sets
    return crush


def crush_parity_phase(dev, K, D) -> None:
    rng = np.random.default_rng(5)

    def same(name, got, plain, **info):
        for g, p in zip(got, plain):
            require(torch.equal(g, p), "%s differs from its plain "
                    "version: %s" % (name, info))
        emit(phase="crush_parity", kernel=name, max_abs_err=0, **info)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # K4: the 1000-OSD map and a choose_args map (three weight-set
    # positions, remapped hash ids), firstn and indep, some OSDs out or
    # reweighted, the map staged in shared memory and read from device
    # memory
    w = np.full(N_OSDS, 0x10000, np.int32)
    w[rng.choice(N_OSDS, 30, replace=False)] = 0
    w[rng.choice(N_OSDS, 30, replace=False)] = 0x8000
    dw = t(w)
    for cargs in (False, True):
        dm = D.DeviceMapper(crush_map(cargs), "opt" if cargs else None,
                            device=dev)
        tb = dm.fm.tables
        for L, ruleno, rmax in ((100003, 0, 3), (4097, 1, EC_SIZE)):
            xs = t(rng.integers(0, 1 << 32, L, dtype=np.int64))
            p = dm._plan(ruleno, rmax)
            plain = K.choose_plain(tb, p, xs, dw)
            for staged in (True, False):
                got = K.choose(tb, p, xs, dw, staged)
                same("choose", (got,), (plain,), lanes=L, rule=ruleno,
                     choose_args=cargs, staged=staged,
                     packed_bytes=int(tb.packed.shape[0]))
    # K5 with and without can_shift
    L, S = 100003, 11
    raw = rng.integers(0, N_OSDS, (L, S)).astype(np.int32)
    raw[rng.random((L, S)) < 0.1] = 0x7FFFFFFF
    raw = t(raw)
    keep = t(rng.random(N_OSDS) < 0.97)
    for can_shift in (True, False):
        same("post", K.post(raw, keep, can_shift),
             K.post_plain(raw, keep, can_shift), lanes=L, slots=S,
             can_shift=can_shift)
    # K6 with an empty and a dense changed set
    for frac in (0.0, 0.01, 1.0):
        changed = t(rng.random(N_OSDS) < frac)
        same("hitscan", (K.hitscan(raw, changed),),
             (K.hitscan_plain(raw, changed),), lanes=L, changed=frac)
    # K7: sparse, a group over KT, a ragged last group, pg_num masking,
    # the mapper's row (16-byte loads) and a row off it (byte loads)
    n = 1_000_003
    hit = rng.random(n) < 0.01
    hit[4096:6144] = True
    hit = t(hit)
    for row, kt, pg in ((2048, 128, n), (2048, 128, n - 1000),
                        (2048, 2048, n), (1000, 128, n - 1000)):
        got = K.rowcompact(hit, row, kt, pg)
        require(int(got[2].max()) > 128, "rowcompact: no group overflowed")
        same("rowcompact", got, K.rowcompact_plain(hit, row, kt, pg),
             lanes=n, row=row, kt=kt, pg_num=pg)


# ---------------------------------------------------------------------------
# phase 7: the CRUSH slice end to end
# ---------------------------------------------------------------------------


class plain_kernels:
    """Route the CRUSH wrappers to their plain versions (on the card)
    for the comparison runs; nothing is launched or counted inside.
    ``draws`` sums the straw2 draws the plain K4 counts."""

    NAMES = ("choose", "post", "hitscan", "rowcompact")

    def __init__(self, K):
        self.K = K
        self.draws = 0

    def _choose(self, *args):
        rows, draws = self.K.choose_plain(*args, count_draws=True)
        self.draws += draws
        return rows

    def __enter__(self):
        self.saved = {n: getattr(self.K, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(self.K, n, getattr(self.K, n + "_plain"))
        self.K.choose = self._choose
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.K, n, fn)


def synced(fn):
    """(result, seconds) of fn on the host clock, ending in a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn) -> float:
    """Milliseconds between CUDA events recorded around one call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def cluster():
    """The port's OSDMap: bench.py's map, a 10M-PG replicated pool and
    a 1M-PG erasure pool, every OSD up and in."""
    from ceph_tpu_torch.osd.osdmap import (
        OSD_EXISTS, OSD_UP, POOL_TYPE_ERASURE, Incremental, OSDMap, PGPool)
    m = OSDMap()
    inc = Incremental(epoch=1)
    inc.new_max_osd = N_OSDS
    inc.new_crush = crush_map()
    inc.new_pools[1] = PGPool(id=1, name="rbd", pg_num=REP_PGS, size=3,
                              crush_rule=0)
    inc.new_pools[2] = PGPool(id=2, name="ec", pg_num=EC_PGS,
                              size=EC_SIZE, min_size=9, crush_rule=1,
                              type=POOL_TYPE_ERASURE)
    m.apply_incremental(inc)
    inc = m.new_incremental()
    for o in range(N_OSDS):
        inc.new_state[o] = OSD_EXISTS | OSD_UP
        inc.new_weight[o] = 0x10000
    m.apply_incremental(inc)
    return m


def cluster_state(m):
    from ceph_tpu_torch.osd.osdmap import OSD_EXISTS, OSD_UP
    state = np.asarray(m.osd_state, dtype=np.int32)
    return (np.asarray(m.osd_weight, np.int32), (state & OSD_EXISTS) != 0,
            (state & OSD_UP) != 0)


def pool_args(pool):
    from ceph_tpu_torch.osd.osdmap import FLAG_HASHPSPOOL
    return (pool.crush_rule, pool.size, pool.pg_num, pool.pgp_num,
            pool.pgp_num_mask, pool.id, bool(pool.flags & FLAG_HASHPSPOOL))


def same_state(a, b, what):
    require(torch.equal(a.raw, b.raw) and torch.equal(a.up, b.up)
            and torch.equal(a.prim, b.prim), what)


def crush_slice_phase(dev, K, D) -> dict:
    """Drives the CRUSH main path; returns its launches and timings."""
    from ceph_tpu_torch.osd.osdmap import OSD_UP, pg_t
    from ceph_tpu_torch.parallel.mapping import OSDMapMapping
    m = cluster()
    churned = list(range(0, N_OSDS, N_OSDS // 10))[:10]
    inc = m.new_incremental()
    for o in churned:
        inc.new_state[o] = OSD_UP          # down
        inc.new_weight[o] = 0              # and out
    m2 = cluster()
    m2.apply_incremental(inc)
    out: dict = {"pools": {}}

    # ---- the main path, with the launch counts read around it
    K.reset_launches()
    mapping, t_mapping = synced(lambda: OSDMapMapping(m))
    dm = m.device_mapper()
    states = {}
    chunks = {pid: -(-pool.pg_num // D.DeviceMapper.CHUNK)
              for pid, pool in m.pools.items()}
    require(K.LAUNCHES["choose"] == sum(chunks.values()),
            "OSDMapMapping: %d choose launches for %d chunks"
            % (K.LAUNCHES["choose"], sum(chunks.values())))
    for pid, pool in m.pools.items():
        args = pool_args(pool)
        n0 = K.LAUNCHES["choose"]
        st, t_map = synced(lambda: dm.map_pool_state(
            *args, *cluster_state(m), None, pool.can_shift_osds()))
        n1 = K.LAUNCHES["choose"]
        st2, t_remap = synced(lambda: st.remap(*cluster_state(m2)))
        fresh = dm.map_pool_state(*args, *cluster_state(m2), None,
                                  pool.can_shift_osds())
        require(n1 - n0 == chunks[pid] and st.recomputed == 0,
                "pool %d: %d choose launches for %d chunks, %d lanes "
                "recomputed" % (pid, n1 - n0, chunks[pid], st.recomputed))
        states[pid] = (st, st2, fresh)
        out["pools"][pid] = {"pg_num": pool.pg_num, "size": pool.size,
                             "map_s": t_map, "remap_s": t_remap,
                             "chunks": chunks[pid],
                             "map_choose_launches": n1 - n0,
                             "recomputed": st.recomputed,
                             "remap_lanes": st2.recomputed}
    launches = dict(K.LAUNCHES)
    for name, count in launches.items():
        require(count > 0, "%s was not launched on the CRUSH main path"
                % name)
    require(mapping.scalar_pools == 0 and mapping.device_pools == 2,
            "OSDMapMapping: %d device / %d scalar pools"
            % (mapping.device_pools, mapping.scalar_pools))
    emit(phase="crush_slice", launches=launches,
         osdmapmapping_s=t_mapping)

    # ---- checks: plain versions on the card (K4 over every PG of both
    # pools), remap, host sample
    rng = np.random.default_rng(6)
    for pid, pool in m.pools.items():
        st, st2, fresh = states[pid]
        rec = out["pools"][pid]
        pm = mapping.pools[pid]
        require(np.array_equal(pm.up, st.up.cpu().numpy())
                and np.array_equal(pm.up_primary, st.prim.cpu().numpy()),
                "OSDMapMapping != map_pool_state (pool %d)" % pid)
        same_state(st2, fresh, "remap != a fresh full pass (pool %d)"
                   % pid)
        args = pool_args(pool)
        with plain_kernels(K) as plain:
            pst = dm.map_pool_state(*args, *cluster_state(m), None,
                                    pool.can_shift_osds())
            same_state(st, pst, "map != its plain versions (pool %d)" % pid)
            rec["draws_needed"] = plain.draws
            pst2 = pst.remap(*cluster_state(m2))
            same_state(st2, pst2, "remap != its plain versions (pool %d)"
                       % pid)
        del pst, pst2
        n = HOST_SAMPLE if pid == 1 else HOST_SAMPLE // 4
        for ps in rng.choice(pool.pg_num, n, replace=False).tolist():
            pg = pg_t(pid, ps)
            require(mapping.get(pg) == m.pg_to_up_acting_osds(pg),
                    "host pipeline differs at %s" % (pg,))
        for ps in rng.choice(pool.pg_num, n // 4, replace=False).tolist():
            want = m2.pg_to_up_acting_osds(pg_t(pid, ps))
            row = st2.up[ps].tolist()
            if pool.can_shift_osds():
                row = [v for v in row if v != 0x7FFFFFFF]
            require((row, int(st2.prim[ps])) == want[:2],
                    "remap differs from the host at %d.%x" % (pid, ps))
        rec["moved_pgs"] = int((st.up != st2.up).any(dim=1).sum())
        rec["draws_per_pg"] = rec["draws_needed"] / pool.pg_num
        rec["host_sample"] = n + n // 4
        emit(phase="crush_slice", pool=pid, **rec)
    require(out["pools"][1]["moved_pgs"] == MOVED_PGS,
            "the churn moved %d PGs of the 10M pool, not %d"
            % (out["pools"][1]["moved_pgs"], MOVED_PGS))
    return launches, out, states


# ---------------------------------------------------------------------------
# phase 8: CRUSH times
# ---------------------------------------------------------------------------


def device_profile(fn, top: int = 8) -> dict:
    """torch.profiler over one call: device time by kernel (the top
    few), their sum over the call's wall time (the busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = synced(fn)
    except RuntimeError as e:       # the tracer, not the port, failed
        return {"profiler": "failed: %s" % e}
    kernels = {}
    for ev in prof.key_averages():
        # device-side events only: a CPU op also carries its kernels'
        # device time, which would count them twice
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0:
            kernels[ev.key[:60]] = (us / 1e3, ev.count)
    busy = sum(ms for ms, _n in kernels.values())
    order = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall * 1e3, "device_ms": busy,
            "busy_share": busy / (wall * 1e3) if wall else None,
            "top": [{"kernel": k, "ms": ms, "count": n}
                    for k, (ms, n) in order]}


def device_ms(fn, iters: int, match: str | None = None):
    """Device milliseconds per call of fn, from a torch.profiler window
    over `iters` warm calls: the kernels whose name holds `match`, or
    all device work when match is None.  A short kernel's wrapper
    (checks, bitmask, ctypes) can take longer on the host than the
    kernel on the card, so CUDA events around back-to-back calls would
    time the host; the profiler reads the kernel's own span.

    The tracer can drop a window's device events, all or some of them.
    A window counts only when it saw device time and every matched
    kernel's launch count is a whole multiple of `iters` (each call's
    launches all seen); up to three windows are tried.  Returns
    (ms, "profiler"), or CUDA-event time per call and "events" where
    no window counted or the tracer failed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        except RuntimeError:        # the tracer, not the port, failed
            break
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and (match is None or match in ev.key)]
        us = sum(getattr(ev, "self_device_time_total", 0) or 0
                 for ev in evs)
        if us > 0 and all(ev.count % iters == 0 for ev in evs):
            return us / 1e3 / iters, "profiler"
        emit(phase="profiler_window_dropped", match=match, device_us=us,
             counts=[ev.count for ev in evs], iters=iters)
    return cuda_ms(fn, iters), "events"


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def crush_timing_phase(dev, K, D, launches, out, states) -> list[dict]:
    m = cluster()
    dm = m.device_mapper()
    pool = m.pools[1]
    args = pool_args(pool)
    w, ex, iu = cluster_state(m)
    st, st2, _fresh = states[1]
    # end to end: the full 10M-PG map and the 10-OSD remap, warm (the
    # main path's calls were the warm-up), CUDA events around the call
    # and the host clock around the call and a sync; the same for the
    # 1M-PG indep pool
    w2, ex2, iu2 = w.copy(), ex.copy(), iu.copy()
    churned = list(range(0, N_OSDS, N_OSDS // 10))[:10]
    w2[churned] = 0
    iu2[churned] = False
    map_ms = event_ms(lambda: dm.map_pool_state(*args, w, ex, iu))
    remap_ms = event_ms(lambda: st.remap(w2, ex2, iu2))
    _, t_map = synced(lambda: dm.map_pool_state(*args, w, ex, iu))
    _, t_remap = synced(lambda: st.remap(w2, ex2, iu2))
    emit(phase="crush_times", pool=1, pg_num=pool.pg_num,
         map_ms=map_ms, remap_ms=remap_ms, map_wall_ms=t_map * 1e3,
         remap_wall_ms=t_remap * 1e3,
         first_map_ms=out["pools"][1]["map_s"] * 1e3,
         first_remap_ms=out["pools"][1]["remap_s"] * 1e3,
         moved_pgs=out["pools"][1]["moved_pgs"])
    ec = m.pools[2]
    ec_args = pool_args(ec)
    est = states[2][0]
    ec_map_ms = event_ms(lambda: dm.map_pool_state(*ec_args, w, ex, iu,
                                                   None, False))
    ec_remap_ms = event_ms(lambda: est.remap(w2, ex2, iu2))
    emit(phase="crush_times", pool=2, pg_num=ec.pg_num, map_ms=ec_map_ms,
         remap_ms=ec_remap_ms,
         first_map_ms=out["pools"][2]["map_s"] * 1e3,
         first_remap_ms=out["pools"][2]["remap_s"] * 1e3,
         moved_pgs=out["pools"][2]["moved_pgs"])
    for what, fn, ms in (
            ("map", lambda: dm.map_pool_state(*args, w, ex, iu), map_ms),
            ("remap", lambda: st.remap(w2, ex2, iu2), remap_ms)):
        prof = device_profile(fn)
        if "device_ms" in prof:
            # the tracer slows the host; the share against the call's
            # untraced time is the one that describes the run
            prof["busy_share_untraced"] = prof["device_ms"] / ms
        emit(phase="crush_profile", pool=1, call=what, **prof)
    rows = []

    def record(name, fn, plain, nbytes, err, library=None, iters=20,
               bound=None, **info):
        """ms: the kernel's device time (device_ms); call_ms: CUDA
        events around whole wrapper calls; plain_ms: CUDA events around
        the plain version; library_ms: the library call's device time,
        library_call_ms: CUDA events around it; timed_by and
        library_timed_by say which clock (device_ms).  bound: (ms, by) where
        the bound is not the bytes."""
        require(err == 0, "%s differs from its plain version at %s"
                % (name, info))
        ms, timed_by = device_ms(fn, iters, name + "_kernel")
        byte_ms = nbytes / HBM_BYTES_S * 1e3
        bound_ms, bound_by = bound or (byte_ms, "bytes")
        rec = {"name": name, "route": "cuda", "source": CRUSH_SOURCE,
               "replaces": CRUSH_REPLACES[name],
               "launches": launches[name], "max_abs_err": err, "ms": ms,
               "plain_ms": cuda_ms(plain, 1 if bound else 3),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "byte_bound_ms": byte_ms,
               "library_ms": None,
               "gb_s": nbytes / (ms / 1e3) / 1e9, "timed_by": timed_by,
               "call_ms": cuda_ms(fn, iters), **info}
        if library:
            rec["library_ms"], rec["library_timed_by"] = device_ms(
                library, iters)
            rec["library_call_ms"] = cuda_ms(library, iters)
        rec["share_of_bound"] = bound_ms / ms
        emit(phase="crush_times", **rec)
        return rec

    def diff(a, b):
        return max(max_abs_err(x, y) for x, y in zip(a, b))

    # K4 at the main path's shapes: one chunk (1M lanes) of the 10M
    # firstn pool (the whole pool in one launch is timed too) and the
    # whole 1M indep pool.  Bound: the draws these inputs need
    # (the plain version counts them; 214 a lane for the whole pool, see
    # the crush_slice lines) x the hash's 137 integer instructions over
    # the integer ALU pipe's 64 lanes per SM per clock at the max SM
    # clock; over all 4 x 32 issue slots per SM per clock beside it.
    props = torch.cuda.get_device_properties(dev)
    clock = sm_clock_hz()
    int_per_s = props.multi_processor_count * INT_LANES * clock
    issue_per_s = props.multi_processor_count * ISSUE_LANES * clock
    tb = dm.fm.tables
    wt = torch.from_numpy(w).to(dev)
    k4 = {}
    for tag, p_args, L in (("firstn", args, D.DeviceMapper.CHUNK),
                           ("indep", ec_args, ec.pg_num)):
        plan = dm._plan(p_args[0], p_args[1])
        xs = D.pps_seed(torch.arange(L, device=dev), *p_args[3:])
        plain, draws = K.choose_plain(tb, plan, xs, wt, count_draws=True)
        got = K.choose(tb, plan, xs, wt)
        # divergence: the same lanes' inputs, each given to a whole warp
        # (32 lanes in a row), so a warp's lanes do the same work
        xu = xs[:L // 32].repeat_interleave(32).contiguous()
        du = K.choose_plain(tb, plan, xu, wt, count_draws=True)[1]
        tu, _ = device_ms(lambda: K.choose(tb, plan, xu, wt), 10,
                          "choose_kernel")
        # the same inputs with the map read from device memory, not
        # staged in shared memory (the route of maps over 100 KiB)
        tdm, _ = device_ms(lambda: K.choose(tb, plan, xs, wt, False), 10,
                           "choose_kernel")
        k4[tag] = {"plan": plan, "xs": xs, "L": L, "draws": draws,
                   "err": max_abs_err(got, plain),
                   "uniform_ms": tu, "uniform_draws": du,
                   "device_memory_ms": tdm,
                   "op_ms": draws * HASH_OPS / int_per_s * 1e3,
                   "issue_ms": draws * HASH_OPS / issue_per_s * 1e3,
                   # x in, the raw row out, the map and reweights read
                   "bytes": L * (8 + 4 * plan.slots)
                   + int(tb.packed.shape[0]) + 4 * N_OSDS}
        del plain, got, xu
    ind = k4["indep"]
    ind_ms, _ = device_ms(lambda: K.choose(tb, ind["plan"], ind["xs"], wt),
                          10, "choose_kernel")
    xs_all = D.pps_seed(torch.arange(pool.pg_num, device=dev), *args[3:])
    pool_ms, _ = device_ms(
        lambda: K.choose(tb, k4["firstn"]["plan"], xs_all, wt), 3,
        "choose_kernel")
    pool_draws = out["pools"][1]["draws_needed"]
    del xs_all
    fn4 = k4["firstn"]
    rec = record(
        "choose", lambda: K.choose(tb, fn4["plan"], fn4["xs"], wt),
        lambda: K.choose_plain(tb, fn4["plan"], fn4["xs"], wt),
        fn4["bytes"], max(fn4["err"], ind["err"]),
        bound=(fn4["op_ms"], "operations"),
        bound_of="hash32_3 integer instructions",
        shape="1M lanes of the 10M pool, chooseleaf firstn size 3",
        draws_needed=fn4["draws"], draws_per_lane=fn4["draws"] / fn4["L"],
        warp_uniform_ms=fn4["uniform_ms"],
        warp_uniform_draws=fn4["uniform_draws"],
        device_memory_ms=fn4["device_memory_ms"],
        indep_device_memory_ms=ind["device_memory_ms"],
        indep_warp_uniform_ms=ind["uniform_ms"],
        indep_warp_uniform_draws=ind["uniform_draws"],
        sms=props.multi_processor_count, sm_clock_hz=clock,
        hash_ops=HASH_OPS, int_lanes_per_sm=INT_LANES,
        issue_bound_ms=fn4["issue_ms"],
        indep_shape="the 1M-PG pool, chooseleaf indep size 11",
        indep_ms=ind_ms, indep_draws_needed=ind["draws"],
        indep_draws_per_lane=ind["draws"] / ind["L"],
        indep_op_bound_ms=ind["op_ms"],
        indep_issue_bound_ms=ind["issue_ms"],
        indep_byte_bound_ms=ind["bytes"] / HBM_BYTES_S * 1e3,
        indep_draws_per_s=ind["draws"] / (ind_ms / 1e3),
        pool_ms=pool_ms, pool_draws_needed=pool_draws,
        pool_op_bound_ms=pool_draws * HASH_OPS / int_per_s * 1e3,
        pool_draws_per_s=pool_draws / (pool_ms / 1e3))
    rec["draws_per_s"] = fn4["draws"] / (rec["ms"] / 1e3)
    emit(phase="crush_times", kernel="choose",
         draws_per_s=rec["draws_per_s"])
    rows.append(rec)
    del k4, fn4, ind
    # K5 at the chunk: raw [1M, 3] from the main path's state
    L = D.DeviceMapper.CHUNK
    raw = st.raw[:L].contiguous()
    keep = torch.from_numpy(ex & iu).to(dev)
    rows.append(record("post", lambda: K.post(raw, keep, True),
                       lambda: K.post_plain(raw, keep, True),
                       L * (12 + 12 + 4) + 128,
                       diff(K.post(raw, keep, True),
                            K.post_plain(raw, keep, True)),
                       shape="1M lanes x 3 slots, can_shift"))
    # K6 over the whole pool's raw rows (the remap's scan)
    raw_all = st.raw
    changed = torch.zeros(N_OSDS, dtype=torch.bool, device=dev)
    changed[churned] = True
    n = raw_all.shape[0]
    hit = K.hitscan(raw_all, changed)
    rows.append(record("hitscan", lambda: K.hitscan(raw_all, changed),
                       lambda: K.hitscan_plain(raw_all, changed),
                       n * (12 + 1) + 128,
                       max_abs_err(hit, K.hitscan_plain(raw_all, changed)),
                       shape="10M lanes x 3 slots, 10 OSDs changed"))
    # K7 over the remap's hit mask, KT as the remap sizes it
    kt = 128
    nr = -(-n // D.DeviceMapper.RC_ROW)
    a = (hit, D.DeviceMapper.RC_ROW, kt, n)
    got = K.rowcompact(*a)
    rows.append(record("rowcompact", lambda: K.rowcompact(*a),
                       lambda: K.rowcompact_plain(*a),
                       n + nr * kt * 5 + nr * 4,
                       diff(got, K.rowcompact_plain(*a)),
                       library=lambda: torch.nonzero(hit),
                       shape="10M lanes, row 2048, kt 128, %d hits"
                       % int(hit.sum()),
                       row_overflows=int((got[2] > kt).sum())))
    return rows


# ---------------------------------------------------------------------------
# phase 11: codec completeness
# ---------------------------------------------------------------------------

_NONREF = {"jerasure-allow-nonreference-layout": "true"}


def _jer(technique: str, k: int, m: int, **kw) -> dict:
    return dict({"plugin": "jerasure", "technique": technique,
                 "k": str(k), "m": str(m)},
                **{key: str(v) for key, v in kw.items()})


# (name, profile, objects, object bytes, the EC kernels it launches: each
# of them in some leg, at least one of them in every leg, no other).
# The bitmatrix techniques at the default packetsize (2048), one
# alignment unit an object (BASELINE.json:9's Cauchy-good k=6,m=3,w=8:
# 384 KiB objects of 64 KiB chunks, 192 MiB); the products wider than
# one launch (ROADMAP.md queue 3's four reed_sol_van profiles and
# cauchy_orig k=9,m=3,w=32); an LRC with a cauchy_good layer and one
# with a CLAY layer.
COMPLETENESS_PROFILES = [
    ("cauchy_good 6+3", _jer("cauchy_good", 6, 3), 512, 393216,
     ("xor_schedule",)),
    ("cauchy_orig 4+2", _jer("cauchy_orig", 4, 2), 512, 262144,
     ("xor_schedule",)),
    ("liberation 4+2 w=7", _jer("liberation", 4, 2, w=7), 512, 229376,
     ("xor_schedule",)),
    ("blaum_roth 4+2 w=6", _jer("blaum_roth", 4, 2, w=6), 512, 196608,
     ("xor_schedule",)),
    ("liber8tion 4+2", _jer("liber8tion", 4, 2, **_NONREF), 512, 262144,
     ("xor_schedule",)),
    ("rs k=33,m=1,w=8", _jer("reed_sol_van", 33, 1, w=8), 64, 33 << 13,
     ("fused_xor",)),
    ("rs k=17,m=3,w=16", _jer("reed_sol_van", 17, 3, w=16), 64, 17 << 14,
     ("bitplane_matmul",)),
    ("rs k=9,m=3,w=32", _jer("reed_sol_van", 9, 3, w=32), 64, 9 << 15,
     ("bitplane_matmul",)),
    ("rs k=2,m=40,w=32", _jer("reed_sol_van", 2, 40, w=32), 64, 2 << 16,
     ("bitplane_matmul",)),
    ("cauchy_orig k=9,m=3,w=32", _jer("cauchy_orig", 9, 3, w=32), 64,
     2359296, ("xor_schedule",)),
    ("lrc cauchy_good layer",
     {"plugin": "lrc", "mapping": "DD__DD__", "layers": json.dumps(
         [["DDc_DDc_", "plugin=jerasure technique=cauchy_good"],
          ["DDDc____", ""], ["____DDDc", ""]])}, 512, 262144,
     ("xor_schedule", "fused_xor")),
    ("lrc clay layer",
     {"plugin": "lrc", "mapping": "DDDD__", "layers": json.dumps(
         [["DDDDcc", "plugin=clay"]])}, 256, 262144, ("fused_xor",)),
]
SYNC_CHECKED = 16       # objects a leg whose async results are held
                        # against the host sync codec one by one


async def completeness_leg(name, prof, objects, nbytes, kernels, K,
                           new_codec, DeviceRuntime, dev, rng) -> dict:
    """One profile on a fresh runtime: encode_async of every object,
    then a data loss and a data + parity loss through decode_async, and
    (matrix codecs) delta_async; each against the host sync codec."""
    codec = new_codec(dict(prof), device=dev)
    n, k = codec.get_chunk_count(), codec.get_data_chunk_count()
    every = set(range(n))
    DeviceRuntime.reset(device=dev)
    objs = [rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
            for _ in range(objects)]
    sample = range(0, objects, max(1, objects // SYNC_CHECKED))
    out = {"objects": objects, "object_bytes": nbytes}
    launched = Counter()

    def check_launches(m, what):
        rec = {"s": m.wall, "dispatches": len(m.tickets),
               "device_busy_share": sum(
                   t.device_s for t in m.tickets.values()) / m.wall,
               "launches": {kn: K.LAUNCHES[kn] - m.before[kn]
                            for kn in K.LAUNCHES}}
        launched.update(rec["launches"])
        require(any(rec["launches"][kn] for kn in kernels)
                and not any(c for kn, c in rec["launches"].items()
                            if kn not in kernels),
                "%s %s: launches %s" % (name, what, rec["launches"]))
        return rec

    with leg_meter(K, kernels[0], kernels[0]) as m:
        stored = await asyncio.gather(*[
            codec.encode_async(every, o, on_ticket=m.on_ticket)
            for o in objs])
    out["encode"] = check_launches(m, "encode")
    out["encode"]["payload_mib_s"] = objects * nbytes / m.wall / 2**20
    for i in sample:
        require(stored[i] == codec.encode(every, objs[i]),
                "%s: encode_async != encode" % name)
    mapping = codec.get_chunk_mapping()
    data0 = mapping[0] if mapping else 0
    parity = [c for c in range(n)
              if c not in {codec.chunk_index(j) for j in range(k)}][-1]
    for leg, erased in (("single", {data0}), ("double", {data0, parity})):
        if n - k < len(erased):
            continue
        reads = [{c: s[c] for c in every - erased} for s in stored]
        with leg_meter(K, kernels[0], kernels[0]) as m:
            got = await asyncio.gather(*[
                codec.decode_async(erased, r, on_ticket=m.on_ticket)
                for r in reads])
        out[leg] = check_launches(m, leg)
        out[leg]["payload_mib_s"] = objects * nbytes / m.wall / 2**20
        for s, g in zip(stored, got):
            require(g == {c: s[c] for c in erased},
                    "%s: %s decode_async != the stored chunks"
                    % (name, leg))
        for i in sample:
            require(got[i] == codec.decode(erased, reads[i]),
                    "%s: %s decode_async != decode" % (name, leg))
    if prof["plugin"] == "jerasure" and \
            prof["technique"] == "reed_sol_van":
        deltas = [{int(j): rng.integers(0, 256, 4096,
                                        dtype=np.uint8).tobytes()
                   for j in rng.choice(k, 1 + i % 2, replace=False)}
                  for i in range(SYNC_CHECKED)]
        with leg_meter(K, kernels[0], kernels[0]) as m:
            got = await asyncio.gather(*[
                codec.delta_async(d, on_ticket=m.on_ticket)
                for d in deltas])
        out["delta"] = check_launches(m, "delta")
        for d, g in zip(deltas, got):
            require(g == codec.parity_delta(d),
                    "%s: delta_async != parity_delta" % name)
    for kn in kernels:
        require(launched[kn] > 0, "%s: %s not launched" % (name, kn))
    return out


def completeness_kernels(dev, K, matrices, gf, rng) -> dict:
    """K1/K2 over more than 256 input bits and more than 1024 output
    rows, K3's row view at odd output rows, rows of any width (A = 1, 8
    and 16 byte units) and more than 256 input rows: each bit for bit
    against its plain version on the card, with its launches a call."""
    def same(name, got, plain, launched, want, **info):
        require(torch.equal(got, plain), "%s differs from its plain "
                "version: %s" % (name, info))
        require(launched == want, "%s: %d launches, expected %d (%s)"
                % (name, launched, want, info))
        emit(phase="completeness", check=name, max_abs_err=0,
             launches=launched, **info)

    for w, k, m, n in ((8, 33, 1, 8195), (8, 40, 3, 1027),
                       (8, 8, 130, 515), (16, 17, 3, 3001),
                       (32, 9, 3, 2049), (32, 2, 40, 777),
                       (32, 10, 4, 7)):
        mat = [[int(c) for c in rng.integers(1, 2 ** min(w, 16), k)]
               for _ in range(m)]
        bm = np.array(matrices.matrix_to_bitmatrix(k, m, w, mat))
        mk = torch.from_numpy(K.pack_slices(bm)).to(dev)
        calls = -(-k * w // 256) * -(-m * w // 1024)
        dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[w]
        data = rng.integers(0, 2 ** w, (k, 4 * n),
                            dtype=np.uint64).astype(dt)
        host = gf.matmul_words(np.array(mat, np.uint64), data[:, :64], w)
        if w == 8:
            d = torch.from_numpy(data.view(np.uint32)).to(dev)
            name, plain = "fused_xor", K.fused_xor_plain(d, mk)
            before = K.LAUNCHES[name]
            got = K.fused_xor(d, mk)
            view = got.cpu().numpy().view(np.uint8)
        else:
            d = torch.from_numpy(data).to(dev)
            name = "bitplane_matmul"
            plain = K.bitplane_matmul_plain(d, mk, w)
            before = K.LAUNCHES[name]
            got = K.bitplane_matmul(d, mk, w)
            view = got.cpu().numpy()
        same(name, got, plain, K.LAUNCHES[name] - before, calls, w=w, k=k,
             m=m, n=4 * n, input_bits=k * w, output_rows=m * w)
        require(np.array_equal(view[:, :64], host.astype(dt)),
                "%s at k*w=%d vs gf.matmul_words" % (name, k * w))
    for in_rows, out_rows, B in ((48, 24, 1 << 20), (48, 8, 65537),
                                 (28, 14, 4097), (24, 12, 13),
                                 (320, 128, 4096), (288, 96, 1001),
                                 (600, 3, 24), (7, 1, 1)):
        bm = rng.integers(0, 2, (out_rows, in_rows)).astype(np.int8)
        bm[0] = 0
        rows = torch.from_numpy(rng.integers(0, 256, (in_rows, B),
                                             dtype=np.uint8)).to(dev)
        sched = K.XorSchedule(K.pack_slices(bm), in_rows, dev)
        before = K.LAUNCHES["xor_schedule"]
        got = K.xor_rows(rows, sched)
        unit = 16 if B % 16 == 0 else 8 if B % 8 == 0 else 1
        same("xor_schedule", got, K.xor_rows_plain(rows, sched.masks),
             K.LAUNCHES["xor_schedule"] - before, -(-in_rows // 256),
             view="rows", in_rows=in_rows, out_rows=out_rows,
             row_bytes=B, unit_bytes=unit)
        require(all_zero(got[0]), "a zero bitmatrix row, nonzero row")


def completeness_times(dev, K, matrices, rng, bound) -> dict:
    """K3 on the row view at the cauchy_good 6+3 encode and one-data-
    loss decode shapes of phase 11 (512 objects, 4 windows of 8 x 2048
    bytes a chunk), the two permute copies of that encode (and the same
    copies a byte an element), and K1 / K2
    at sliced shapes (k=33,m=1,w=8 and k=9,m=3,w=32, 4 MiB a chunk
    row), each beside its byte bound and its plain version's time."""
    from ceph_tpu_torch.ec import jerasure
    out = {}
    codec = jerasure.make_codec(_jer("cauchy_good", 6, 3))
    k, m, w, ps = codec.k, codec.m, codec.w, codec.packetsize
    nw = 512 * 4
    enc = K.BitmatrixEncoder(codec.bitmatrix, w, dev)
    dec = enc.decode_rows((0,), tuple(range(1, k + 1)))
    windows = torch.from_numpy(rng.integers(0, 256, (k, nw, w * ps),
                                            dtype=np.uint8)).to(dev)
    rows = enc.to_rows(windows)
    require(torch.equal(rows, windows.view(k, nw, w, ps).permute(
        0, 2, 1, 3).reshape(k * w, nw * ps)), "to_rows != the permute")
    for shape, fn in (("encode", enc), ("decode", dec)):
        got = fn(rows)
        plain_fn = functools.partial(K.xor_rows_plain,
                                     masks=fn._schedule.masks)
        err = max_abs_err(got, plain_fn(rows))
        ms, timed_by = device_ms(lambda: fn(rows), 20, "xor_schedule")
        nbytes = rows.numel() + got.numel()
        bound_ms, bound_by = bound(nbytes)
        out["xor_schedule " + shape] = {
            "ms": ms, "timed_by": timed_by,
            "plain_ms": cuda_ms(lambda: plain_fn(rows), 2),
            "in_rows": k * w, "out_rows": got.shape[0],
            "row_bytes": nw * ps, "bytes": nbytes,
            "popcount": fn._schedule.pop, "bound_ms": bound_ms,
            "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            "max_abs_err": err}
        require(err == 0, "xor_schedule differs from its plain version at "
                "the cauchy_good %s shape" % shape)
        del got
    par = enc(rows)
    # the port's permutes (words as wide as the packets allow) and,
    # beside them in the same call, the same permutes a byte an element
    for shape, fn, src in (
            ("windows to rows", lambda: enc.to_rows(windows), windows),
            ("rows to windows", lambda: enc.to_windows(par, nw), par),
            ("windows to rows, bytes", lambda: windows.view(
                k, nw, w, ps).permute(0, 2, 1, 3).contiguous(), windows),
            ("rows to windows, bytes", lambda: par.view(
                m, w, nw, ps).permute(0, 2, 1, 3).contiguous(), par)):
        ms, timed_by = device_ms(fn, 20)
        nbytes = 2 * src.numel()
        bound_ms, bound_by = bound(nbytes)
        out["permute " + shape] = {
            "ms": ms, "timed_by": timed_by, "bytes": nbytes,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms}
    require(torch.equal(enc.run_windows(windows).view(m, nw, w, ps).permute(
        0, 2, 1, 3).reshape(m * w, nw * ps), par),
        "run_windows != the row product")
    del windows, rows, par
    for name, w, k, m in (("fused_xor", 8, 33, 1),
                          ("bitplane_matmul", 32, 9, 3)):
        mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, w)
        bm = np.array(matrices.matrix_to_bitmatrix(k, m, w, mat))
        mk = torch.from_numpy(K.pack_slices(bm)).to(dev)
        n = (4 << 20) // (w // 8)
        dt = {8: np.uint8, 32: np.uint32}[w]
        data = torch.from_numpy(rng.integers(0, 2 ** w, (k, n),
                                             dtype=np.uint64).astype(dt)
                                ).to(dev)
        if w == 8:
            data = data.view(torch.uint32)
            fn = functools.partial(K.fused_xor, data, mk)
            plain = functools.partial(K.fused_xor_plain, data, mk)
        else:
            fn = functools.partial(K.bitplane_matmul, data, mk, w)
            plain = functools.partial(K.bitplane_matmul_plain, data, mk, w)
        before = K.LAUNCHES[name]
        got = fn()
        launches = K.LAUNCHES[name] - before
        err = max_abs_err(got, plain())
        require(err == 0, "%s differs from its plain version at k=%d, "
                "m=%d, w=%d" % (name, k, m, w))
        ms, timed_by = device_ms(fn, 20, "gf2_product")
        nbytes = (k + m) * (4 << 20)
        bound_ms, bound_by = bound(nbytes)
        out["%s k=%d,m=%d,w=%d" % (name, k, m, w)] = {
            "ms": ms, "timed_by": timed_by,
            "plain_ms": cuda_ms(plain, 2), "launches_a_call": launches,
            "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms, "max_abs_err": err}
    return out


def completeness_phase(dev, K, new_codec, DeviceRuntime, matrices,
                       gf) -> dict:
    """Drives the bitmatrix techniques, the wide products and the LRC
    layers on their own codecs' routes; returns the phase's launches
    and its kernel times at the new shapes."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(44)
    completeness_kernels(dev, K, matrices, gf, rng)
    K.reset_launches()

    async def run_all():
        for name, prof, objects, nbytes, kernels in COMPLETENESS_PROFILES:
            res = await completeness_leg(name, prof, objects, nbytes,
                                         kernels, K, new_codec,
                                         DeviceRuntime, dev, rng)
            emit(phase="completeness", profile=name, **res)

    asyncio.run(run_all())
    launches = dict(K.LAUNCHES)
    for name, count in launches.items():
        require(count > 0, "%s was not launched by phase 11's codec calls"
                % name)
    emit(phase="completeness", launches=launches)

    def bound(nbytes):
        return nbytes / HBM_BYTES_S * 1e3, "bytes"

    times = completeness_times(dev, K, matrices, rng, bound)
    for what, rec in times.items():
        emit(phase="completeness", times=what, **rec)
    emit(phase="completeness", seconds=time.perf_counter() - t0)
    return {"launches": launches, "times": times}


# ---------------------------------------------------------------------------
# phase 12: the upmap balancer and the runtime's chip-loss surface
# ---------------------------------------------------------------------------

BAL_PGS = 32768         # one size-3 pool: ~98 PG replicas an OSD
TOOL_OSDS = 1000        # osdmaptool --createsimple
TOOL_PGS = 1024         # the host engine takes ~33 ms a PG of this map


def skewed_map(hosts: int = N_OSDS // PER_HOST, per_host: int = PER_HOST,
               pg_num: int = BAL_PGS):
    """bench.py's map shape (straw2 hosts under a straw2 root, rule 0
    chooseleaf firstn type host) with every 5th OSD at half reweight,
    the skew of tests/test_scale.py, and one size-3 replicated pool."""
    from ceph_tpu_torch.models.crushmap import (
        CHOOSELEAF_FIRSTN, EMIT, STRAW2, TAKE, CrushMap)
    from ceph_tpu_torch.osd.osdmap import (
        OSD_EXISTS, OSD_UP, Incremental, OSDMap, PGPool)
    crush = CrushMap()
    ids = [crush.add_bucket(STRAW2, 1,
                            list(range(h * per_host, (h + 1) * per_host)),
                            [0x10000] * per_host, id=-(h + 2)).id
           for h in range(hosts)]
    crush.add_bucket(STRAW2, 2, ids,
                     [crush.buckets[h].weight for h in ids], id=-1)
    crush.add_rule([(TAKE, -1, 0), (CHOOSELEAF_FIRSTN, 0, 1),
                    (EMIT, 0, 0)], id=0)
    m = OSDMap()
    inc = Incremental(epoch=1)
    inc.new_max_osd = hosts * per_host
    inc.new_crush = crush
    inc.new_pools[1] = PGPool(id=1, name="rbd", pg_num=pg_num, size=3,
                              crush_rule=0)
    m.apply_incremental(inc)
    inc = m.new_incremental()
    for o in range(hosts * per_host):
        inc.new_state[o] = OSD_EXISTS | OSD_UP
        inc.new_weight[o] = 0x8000 if o % 5 == 0 else 0x10000
    m.apply_incremental(inc)
    return m


def upmap_items(inc) -> tuple:
    return ({(pg.pool, pg.ps): [tuple(t) for t in v]
             for pg, v in inc.new_pg_upmap_items.items()},
            sorted((pg.pool, pg.ps) for pg in inc.old_pg_upmap_items))


def quiet(fn, *args):
    """(fn's return, its standard output) with the output captured."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args)
    return ret, buf.getvalue()


def balancer_leg(dev, CK) -> dict:
    """BalancerState, one batched tick, the sequential optimizer and
    osdmaptool at 1000 OSDs, each on the card against its CPU run.
    Returns the K4/K5 launches of the card's prologue and tick and the
    scorer's largest dispatch."""
    from ceph_tpu_torch.cli import osdmaptool
    from ceph_tpu_torch.osd import balancer as bal
    from ceph_tpu_torch.osd.osdmap import OSDMap
    from ceph_tpu_torch.scale import balancer as scale
    out = {}
    m = skewed_map()
    CK.reset_launches()
    st, out["prologue_s"] = synced(
        lambda: bal.BalancerState(m, None, device=dev))
    prologue = dict(CK.LAUNCHES)
    require(prologue["choose"] > 0 and prologue["post"] > 0,
            "the prologue launched no K4/K5: %s" % prologue)
    cpu, out["prologue_cpu_s"] = synced(
        lambda: bal.BalancerState(skewed_map(), None, device="cpu"))
    for attr in ("pg_raw", "pg_up", "counts", "target"):
        require(getattr(st, attr) == getattr(cpu, attr),
                "BalancerState.%s differs from its CPU run" % attr)

    # one tick at the entry point's defaults; the largest scoring
    # table is kept to time the scorer alone
    tables = []
    dispatch = scale._dispatch_score

    def keep(chip, *arrays):
        if not tables or arrays[2].shape[0] > tables[0][2].shape[0]:
            tables[:] = [arrays]
        return dispatch(chip, *arrays)

    scale._dispatch_score = keep
    try:
        CK.reset_launches()
        inc = m.new_incremental()
        res, out["tick_s"] = synced(
            lambda: scale.batched_calc_pg_upmaps(m, inc, device=dev))
        tick = dict(CK.LAUNCHES)
    finally:
        scale._dispatch_score = dispatch
    cm = skewed_map()
    cinc = cm.new_incremental()
    want, out["tick_cpu_s"] = synced(
        lambda: scale.batched_calc_pg_upmaps(cm, cinc, device="cpu"))
    require(upmap_items(inc) == upmap_items(cinc),
            "the card's pg_upmap_items differ from the CPU run's")
    for attr in ("changes", "rounds", "candidates_scored",
                 "stddev_after"):
        require(getattr(res, attr) == getattr(want, attr),
                "tick %s: card %s, cpu %s" % (attr, getattr(res, attr),
                                              getattr(want, attr)))
    require(res.device_rounds >= 1 and res.host_rounds == 0,
            "rounds: device %d, host %d" % (res.device_rounds,
                                            res.host_rounds))
    size = m.pools[1].size
    cands = [t.nbytes // (4 * size) for t in res.tickets]
    require(max(cands) >= 1000, "largest ticket %d candidates"
            % max(cands))
    require(res.stddev_after < res.stddev_before, "stddev did not fall")
    out.update(changes=res.changes, rounds=res.rounds,
               candidates_scored=res.candidates_scored,
               stddev_before=res.stddev_before,
               stddev_after=res.stddev_after,
               round_device_s=[t.device_s for t in res.tickets],
               round_candidates=cands, build_s=res.build_s,
               commit_s=res.commit_s)

    # replay the items on a decoded copy (tests/test_scale.py:222-258)
    m2 = OSDMap.decode(m.encode())
    m2.apply_incremental(inc)
    domains = bal._failure_domains(m2, 0)
    for pg, items in m2.pg_upmap_items.items():
        raw, _ = m2._pg_to_raw_osds(m2.pools[pg.pool], pg)
        require(all(f in raw for f, _t in items),
                "%s: an item's source is not in the raw row" % (pg,))
        up = m2.pg_to_up_acting_osds(pg)[0]
        doms = [domains.get(o) for o in up]
        require(len(set(up)) == len(up) and None not in doms
                and len(set(doms)) == len(doms),
                "%s: up %s repeats an OSD or a domain" % (pg, up))
        require(bal._effective_up(m2, raw, items) == up,
                "%s: the items' effect is not the up set" % (pg,))
    st2 = bal.BalancerState(m2, None, device=dev)
    require(abs(scale._stddev(st2.counts, st2.target)
                - res.stddev_after) < 1e-9,
            "the applied map's stddev differs from stddev_after")

    # the sequential optimizer, card against CPU
    inc = m.new_incremental()
    n, out["sequential_s"] = synced(
        lambda: bal.calc_pg_upmaps(m, inc, 1.0, 100, device=dev))
    cinc = cm.new_incremental()
    require(bal.calc_pg_upmaps(cm, cinc, 1.0, 100, device="cpu") == n
            and upmap_items(inc) == upmap_items(cinc),
            "calc_pg_upmaps differs from its CPU run")
    out["sequential_changes"] = n

    # osdmaptool: --bulk on the card against the host engine
    path = os.path.join(HERE, "build", "osdmaptool-%d.bin" % TOOL_OSDS)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    quiet(osdmaptool.main, ["--createsimple", str(TOOL_OSDS),
                            "--pg-num", str(TOOL_PGS), path])
    (rc, host), host_s = synced(
        lambda: quiet(osdmaptool.main, [path, "--test-map-pgs"]))
    (rc2, bulk), bulk_s = synced(
        lambda: quiet(osdmaptool.main, [path, "--test-map-pgs", "--bulk",
                                        "--device", str(dev)]))
    require(rc == rc2 == 0 and json.loads(bulk) == json.loads(host)
            and json.loads(host)["pg_total"] == TOOL_PGS,
            "osdmaptool --bulk histogram differs from the host engine's")
    out["osdmaptool"] = {"osds": TOOL_OSDS, "pg_num": TOOL_PGS,
                         "host_s": host_s, "bulk_s": bulk_s}
    out["launches"] = {"prologue": {k: prologue[k]
                                    for k in ("choose", "post")},
                       "tick": {k: tick[k] for k in ("choose", "post")}}
    out["tables"] = tables[0]
    return out


def scorer_times(dev, tables) -> dict:
    """The scorer alone at the tick's largest table, beside its byte
    bound: the eight inputs read once, valid (bool) and score
    (float32) written once."""
    from ceph_tpu_torch.scale import balancer as scale
    placed = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in tables]
    c, s = tables[0].shape
    nbytes = sum(a.nbytes for a in tables) + c + 4 * c
    return {"candidates": c, "slots": s, "bytes": nbytes,
            "ms": cuda_ms(lambda: scale._score_pass(*placed), 20),
            "bound_ms": nbytes / HBM_BYTES_S * 1e3, "bound_by": "bytes"}


async def wait_until(pred, timeout: float) -> float:
    t0 = time.perf_counter()
    while not pred():
        require(time.perf_counter() - t0 < timeout,
                "condition not reached in %.1f s" % timeout)
        await asyncio.sleep(0.005)
    return time.perf_counter() - t0


def faults_leg(dev, K, new_codec, DeviceRuntime) -> dict:
    """warmup_ec, one chip's loss and heal, and the whole mesh's, on
    four logical chips of the card."""
    from ceph_tpu_torch.device.runtime import DeviceLost
    from ceph_tpu_torch.parallel.mapping import OSDMapMapping
    from ceph_tpu_torch.scale import batched_calc_pg_upmaps
    from ceph_tpu_torch.trace import recorder
    from ceph_tpu_torch.utils import exporter
    rng = np.random.default_rng(48)
    out = {}

    async def run():
        recorder.clear_device_ring()
        rt = DeviceRuntime.reset(chips=4, device=dev)
        rt.configure({"device_max_inflight": 2, "device_queue_len": 64,
                      "device_probe_interval": 0.04,
                      "device_shard_min_words": 1024})
        isa = new_codec({"plugin": "isa", "technique": "reed_sol_van",
                         "k": "8", "m": "3"}, device=dev)
        every = set(range(11))
        codecs = (isa, new_codec({"plugin": "lrc", "k": "4", "m": "2",
                                  "l": "3"}, device=dev),
                  new_codec({"plugin": "jerasure",
                             "technique": "reed_sol_van", "k": "8",
                             "m": "3", "w": "16"}, device=dev))
        families = {(tuple(map(tuple, mat)), w)
                    for codec in codecs
                    for mat, w in codec.device_families()}
        K.reset_launches()
        t0 = time.perf_counter()
        for mat, w in sorted(families):
            await rt.warmup_ec(mat, w)
        out["warmup_s"] = time.perf_counter() - t0
        out["warmup_launches"] = dict(K.LAUNCHES)
        require(rt.compile_count == 3 * len(families) and not rt.lost,
                "warmup counted %d buckets for %d families"
                % (rt.compile_count, len(families)))
        require(K.LAUNCHES["fused_xor"] > 0
                and K.LAUNCHES["bitplane_matmul"] > 0,
                "warmup launched %s" % K.LAUNCHES)
        # 896-word chunks: under the shard threshold, bucket 1024
        small = rng.integers(0, 256, 8 * 896, dtype=np.uint8).tobytes()
        hits = rt.chips[0].bucket_hits
        require(await isa.encode_async(every, small)
                == isa.encode(every, small)
                and rt.compile_count == 3 * len(families)
                and rt.chips[0].bucket_hits > hits,
                "the first encode after warmup missed its bucket")

        # one chip lost mid-flush: the op fails, only that chip is lost
        big = rng.integers(0, 256, 8 << 16, dtype=np.uint8).tobytes()
        want = isa.encode(every, big)
        rt.chips[2].inject_fault(1)
        try:
            await isa.encode_async(every, big)
            require(False, "the faulted sharded encode succeeded")
        except IOError as e:
            out["fault_error"] = repr(e)
        require([c.lost for c in rt.chips] == [False, False, True, False],
                "lost chips %s" % [c.lost for c in rt.chips])
        require('ceph_tpu_device_lost{chip="2"} 1' in rt.prom_lines(),
                "prom_lines does not show chip 2 lost")
        rt.chips[2].inject_fault(1 << 30)    # probes fail meanwhile
        before = K.LAUNCHES["fused_xor"]
        try:
            await isa.encode_async(every, small, chip=2)
            require(False, "an encode on the lost chip succeeded")
        except IOError:
            pass
        require(K.LAUNCHES["fused_xor"] == before,
                "the lost chip launched K1")
        m = skewed_map(hosts=12, per_host=4, pg_num=1024)
        for call in (lambda: OSDMapMapping(m, chip=2, device=dev),
                     lambda: batched_calc_pg_upmaps(
                         m, m.new_incremental(), chip=2, device=dev)):
            try:
                call()
                require(False, "a pass on the lost chip succeeded")
            except (DeviceLost, IOError):
                pass
        require(await isa.encode_async(every, small, chip=0)
                == isa.encode(every, small), "chip 0's encode differs")
        served = [c.dispatches for c in rt.chips]
        require(await isa.encode_async(every, big) == want,
                "the sharded encode without chip 2 differs")
        grew = [c.dispatches - d for c, d in zip(rt.chips, served)]
        require(grew[2] == 0 and all(grew[i] for i in (0, 1, 3)),
                "sharded flush dispatches by chip %s" % grew)
        rt.chips[2].clear_faults()
        out["heal_s"] = await wait_until(lambda: not rt.chips[2].lost,
                                         2.0)
        require(rt.chips[2].heal_count == 1, "heal_count")
        before = K.LAUNCHES["fused_xor"]
        require(await isa.encode_async(every, small, chip=2)
                == isa.encode(every, small)
                and K.LAUNCHES["fused_xor"] > before,
                "the healed chip's encode")

        # the whole mesh lost, then healed
        rt.inject_fault(1 << 30)
        rt.poison("whole-mesh loss")
        for call in (lambda: rt.route(None),):
            try:
                call()
                require(False, "route(None) on a lost mesh")
            except DeviceLost:
                pass
        try:
            await isa.encode_async(every, small)
            require(False, "a chip-less encode on a lost mesh succeeded")
        except (DeviceLost, IOError):
            pass
        rt.clear_faults()
        out["mesh_heal_s"] = await wait_until(
            lambda: len(rt.available_chips()) == 4, 2.0)
        text = "\n".join(rt.prom_lines())
        require(exporter.validate_exposition(text) == [],
                "prom_lines: %s" % exporter.validate_exposition(text)[:3])
        records = recorder.device_records()
        doc = recorder.chrome_trace({}, device=records)
        require(recorder.validate_chrome_trace(doc) == [],
                "chrome trace: %s" % recorder.validate_chrome_trace(doc)[:3])
        require(any(not r["ok"] and r["chip"] == 2 for r in records),
                "the ring lacks the failed ticket")
        out.update(metrics=rt.metrics(), ring=len(records),
                   failed_tickets=sum(not r["ok"] for r in records))

    t0 = time.perf_counter()
    asyncio.run(run())
    out["seconds"] = time.perf_counter() - t0
    return out


def balancer_phase(dev, K, CK, new_codec, DeviceRuntime) -> dict:
    """Phase 12; returns the kernels' launches on its two legs and the
    scorer's time."""
    t0 = time.perf_counter()
    bal = balancer_leg(dev, CK)
    score = scorer_times(dev, bal.pop("tables"))
    emit(phase="balancer", osds=N_OSDS, pg_num=BAL_PGS, scorer=score,
         **bal)
    faults = faults_leg(dev, K, new_codec, DeviceRuntime)
    emit(phase="faults", **faults)
    seconds = time.perf_counter() - t0
    emit(phase="balancer", seconds=seconds)
    return {"balancer": bal["launches"], "faults": faults["warmup_launches"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ceph_tpu_torch import _build, default_device
    from ceph_tpu_torch.device.runtime import DeviceRuntime
    from ceph_tpu_torch.ec import gf, kernels as K, matrices, new_codec
    from ceph_tpu_torch.ops.crush import device as CD, kernels as CK

    card = card_line()
    print(card, flush=True)
    dev = default_device()
    emit(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(dev), card=card)

    t0 = time.perf_counter()
    path, report = _build.build()
    _build.library()
    emit(phase="build", seconds=time.perf_counter() - t0, library=path.name,
         ptxas=[ln.strip() for ln in report.splitlines()
                if "Used" in ln or "spill" in ln])

    parity_phase(dev, K, matrices, gf)
    launches, shapes = slice_phase(dev, K, new_codec, DeviceRuntime, gf)
    rows = timing_phase(dev, K, matrices, launches, shapes)
    crush_parity_phase(dev, CK, CD)
    claunches, cout, states = crush_slice_phase(dev, CK, CD)
    rows += crush_timing_phase(dev, CK, CD, claunches, cout, states)
    recovery_phase(dev, K, new_codec, DeviceRuntime)
    recovered = dict(K.LAUNCHES)
    background_phase(dev)
    comp = completeness_phase(dev, K, new_codec, DeviceRuntime, matrices,
                              gf)
    bal = balancer_phase(dev, K, CK, new_codec, DeviceRuntime)
    # K1-K3's rows: launches on this slice's path (phase 11's codec
    # calls), each EC path's count beside them, and the times at the
    # shapes phase 11 gives them
    for row in rows:
        name = row["name"]
        if name not in comp["launches"]:
            continue
        row["launches"] = comp["launches"][name]
        row["launches_by_path"] = {
            "ec_slice": launches[name], "recovery": recovered[name],
            "codec_completeness": comp["launches"][name]}
        row["completeness_times"] = {
            what: rec for what, rec in comp["times"].items()
            if what.startswith(name) or (name == "xor_schedule"
                                         and what.startswith("permute"))}
    # phase 12's paths: K4/K5 in the balancer's prologue and tick, K1/K2
    # in warmup_ec
    for row in rows:
        name = row["name"]
        if name in ("choose", "post"):
            row.setdefault("launches_by_path", {})["balancer"] = (
                bal["balancer"]["prologue"][name]
                + bal["balancer"]["tick"][name])
        elif name in ("fused_xor", "bitplane_matmul"):
            row["launches_by_path"]["faults_warmup"] = bal["faults"][name]
    torch.cuda.synchronize()
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
