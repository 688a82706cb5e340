"""Card smoke test of ceph_tpu_torch: build, kernel parity, the EC slice
end to end, and kernel times beside their bounds.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  Any failure raises
and exits non-zero; without a card it exits 2 and prints no result.
Phases, each printing its results as JSON lines:

1. the card's name and power limit;
2. build the kernels (csrc/ec_kernels.cu) with nvcc for sm_90a;
3. hold each kernel bit for bit against its plain PyTorch version on
   the card (ragged widths, zero columns, decode rows, several output
   row groups) and spot-check both against the numpy GF codec;
4. the slice end to end: new_codec(profile) -> encode_async (2048
   concurrent 4 KiB-chunk objects per profile) / decode_async /
   delta_async through the dispatch stream, batcher and runtime,
   compared with the sync host codec; then PlanesEncoder
   encode_stripes / decode_rows.  Launch counts are read around this
   phase and every kernel must have run in it;
5. kernel times with CUDA events at the main path's shapes, beside
   the bound (the bytes the kernel must move over the copy bandwidth
   measured in the same run) and the plain version's time; each
   kernel's result there must again equal its plain version.

The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time

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

    # K1: encode rows (m <= 4 and m = 6: two row groups), decode rows,
    # lanes not a multiple of 8 or of 4 (scalar edge), zero columns
    for k, m, lanes in ((8, 3, 8195), (10, 6, 4099), (4, 2, 1024)):
        mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, 8)
        bm = matrices.matrix_to_bitmatrix(k, m, 8, mat)
        data = rng.integers(0, 2**32, (k, lanes), dtype=np.uint32)
        data[:, 100:300] = 0
        d = torch.from_numpy(data).to(dev)
        got = K.fused_xor(d, masks_of(bm))
        same("fused_xor", got, K.fused_xor_plain(d, masks_of(bm)),
             k=k, m=m, lanes=lanes)
        require(all_zero(got[:, 100:300]), "zero columns, nonzero parity")
        cols = np.sort(rng.choice(lanes, 64, replace=False))
        host = gf.matmul_u8(np.array(mat, np.uint8),
                            np.ascontiguousarray(data[:, cols]).view(np.uint8))
        require(np.array_equal(np.ascontiguousarray(
            got.cpu().numpy()[:, cols]).view(np.uint8),
                               host), "fused_xor vs gf.matmul_u8")
        erased = (0, k)
        surv = tuple(i for i in range(k + m) if i not in erased)
        rows = K._reconstruction_rows(mat, k, 8, erased, surv)
        rbm = matrices.matrix_to_bitmatrix(k, len(rows), 8, rows)
        same("fused_xor", K.fused_xor(d, masks_of(rbm)),
             K.fused_xor_plain(d, masks_of(rbm)), k=k, rows="decode",
             lanes=lanes)

    # K2 at w = 8, 16, 32: encode and decode rows, ragged n, zeros
    for w, k, m, n in ((8, 8, 3, 5001), (16, 8, 3, 3001), (32, 8, 3, 2049),
                       (16, 4, 6, 777)):
        mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, w)
        bm = matrices.matrix_to_bitmatrix(k, m, w, mat)
        dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[w]
        data = rng.integers(0, 2**w, (k, n), dtype=np.uint64).astype(dt)
        data[:, 7:90] = 0
        d = torch.from_numpy(data).to(dev)
        got = K.bitplane_matmul(d, masks_of(bm), w)
        same("bitplane_matmul", got,
             K.bitplane_matmul_plain(d, masks_of(bm), w), w=w, k=k, m=m,
             n=n)
        require(all_zero(got[:, 7:90]), "zero columns, nonzero parity")
        cols = np.sort(rng.choice(n, 32, replace=False))
        host = gf.matmul_words(np.array(mat, np.uint64),
                               np.ascontiguousarray(data[:, cols]), w)
        require(np.array_equal(got.cpu().numpy()[:, cols], host.astype(dt)),
                "bitplane_matmul vs gf.matmul_words")
        erased = (1, k + 1)
        surv = tuple(i for i in range(k + m) if i not in erased)
        rows = K._reconstruction_rows(mat, k, w, erased, surv)
        rbm = matrices.matrix_to_bitmatrix(k, len(rows), w, rows)
        same("bitplane_matmul", K.bitplane_matmul(d, masks_of(rbm), w),
             K.bitplane_matmul_plain(d, masks_of(rbm), w), w=w,
             rows="decode", n=n)

    # K3: encode and decode on planes8, block sizes off the 16-byte grid
    for k, m, P in ((8, 3, 4096), (6, 3, 1001), (10, 6, 64)):
        mat = matrices.isa_cauchy_matrix(k, m)
        enc = K.PlanesEncoder(mat, dev)
        planes = rng.integers(0, 256, (k * 64, P), dtype=np.uint8)
        planes[:, 10:20] = 0
        p = torch.from_numpy(planes).to(dev)
        got = enc(p)
        same("xor_schedule", got, K.xor_schedule_plain(p, enc._masks),
             k=k, m=m, P=P)
        require(all_zero(got[:, 10:20]), "zero columns, nonzero parity")
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
             dec.keywords["masks"]), k=k, rows="decode", P=P)
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
    shapes: dict[str, set] = {"fused_xor": set(), "bitplane_matmul": set()}

    async def run_all():
        rt = DeviceRuntime.get(dev)
        require(rt.dispatch_mode == "stream", "stream mode is the default")
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
        for key in rt.chips[0].programs:
            _kind, _mkey, w, seg = key
            shapes["fused_xor" if w == 8 else "bitplane_matmul"].add(
                (len(_mkey[0]), seg, w))
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
# phase 5: times
# ---------------------------------------------------------------------------


def timing_phase(dev, K, matrices, launches, shapes) -> list[dict]:
    rng = np.random.default_rng(3)
    big = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(big)
    copy_ms = cuda_ms(lambda: dst.copy_(big), 10)
    copy_bps = 2 * big.numel() / (copy_ms / 1e3)
    del big, dst
    emit(phase="times", yardstick="copy_", bytes=2 << 30, ms=copy_ms,
         gb_s=copy_bps / 1e9)
    rows = []

    # The bound is the bytes a kernel must move (inputs read once,
    # outputs written once) over the measured copy bandwidth. The
    # kernels do only 32-bit integer logic, for which the card's
    # published peaks give no rate, so no operation bound is counted.
    def record(name, ms, plain_ms, nbytes, err, **info):
        require(err == 0, "%s differs from its plain version at %s: "
                "max_abs_err %d" % (name, info, err))
        rec = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": nbytes / copy_bps * 1e3, "bound_by": "bytes",
               "library_ms": None, "gb_s": nbytes / (ms / 1e3) / 1e9,
               **info}
        emit(phase="times", **rec)
        return rec

    def masks_of(bm):
        return torch.from_numpy(K.pack_rows(bm)).to(dev)

    # K1: k=8,m=3 at 32 MiB per chunk row
    k, m = 8, 3
    mat = matrices.isa_rs_vandermonde_matrix(k, m)
    bm = np.array(matrices.matrix_to_bitmatrix(k, m, 8, mat))
    mk = masks_of(bm)
    P = (32 << 20) // 4
    d = torch.from_numpy(rng.integers(0, 2**32, (k, P),
                                      dtype=np.uint32)).to(dev)
    ms = cuda_ms(lambda: K.fused_xor(d, mk), 20)
    plain_ms = cuda_ms(lambda: K.fused_xor_plain(d, mk), 2)
    err = max_abs_err(K.fused_xor(d, mk), K.fused_xor_plain(d, mk))
    rows.append(record("fused_xor", ms, plain_ms, (k + m) * P * 4, err,
                       shape="k=8,m=3, 32 MiB per chunk row"))
    del d

    # K2 at the largest slot the main path staged, for each w
    by_w = {}
    for w in (32, 16, 8):
        seen = [s for s in shapes["bitplane_matmul"] if s[2] == w]
        seg = max((s[1] for s in seen), default=1 << 19)
        mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, w)
        bm = np.array(matrices.matrix_to_bitmatrix(k, m, w, mat))
        mk = masks_of(bm)
        dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[w]
        d = torch.from_numpy(rng.integers(0, 2**w, (k, seg),
                                          dtype=np.uint64).astype(dt)
                             ).to(dev)
        ms = cuda_ms(lambda: K.bitplane_matmul(d, mk, w), 20)
        plain_ms = cuda_ms(lambda: K.bitplane_matmul_plain(d, mk, w), 2)
        err = max_abs_err(K.bitplane_matmul(d, mk, w),
                          K.bitplane_matmul_plain(d, mk, w))
        require(err == 0, "bitplane_matmul differs from its plain "
                "version at w=%d, n=%d: max_abs_err %d" % (w, seg, err))
        nbytes = (k + m) * seg * w // 8
        by_w[w] = {"ms": ms, "plain_ms": plain_ms, "n": seg,
                   "bytes": nbytes, "bound_ms": nbytes / copy_bps * 1e3,
                   "max_abs_err": err}
    top = by_w[32]
    rows.append(record("bitplane_matmul", top["ms"], top["plain_ms"],
                       top["bytes"], max(
                           v["max_abs_err"] for v in by_w.values()),
                       shape="k=8,m=3, w=32, n=%d words" % top["n"],
                       by_w={str(w): v for w, v in by_w.items()}))

    # K3: k=8,m=3 planes8 at 64 MiB of payload (the main path's size)
    enc = K.PlanesEncoder(matrices.isa_rs_vandermonde_matrix(k, m), dev)
    P = OBJECTS * CHUNK // 64
    planes = torch.from_numpy(rng.integers(0, 256, (k * 64, P),
                                           dtype=np.uint8)).to(dev)
    ms = cuda_ms(lambda: enc(planes), 20)
    plain_ms = cuda_ms(lambda: K.xor_schedule_plain(planes, enc._masks), 2)
    err = max_abs_err(enc(planes), K.xor_schedule_plain(planes, enc._masks))
    rows.append(record("xor_schedule", ms, plain_ms, (k + m) * 64 * P,
                       err, shape="k=8,m=3, 64 MiB payload"))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ceph_tpu_torch import _build, default_device
    from ceph_tpu_torch.device.runtime import DeviceRuntime
    from ceph_tpu_torch.ec import gf, kernels as K, matrices, new_codec

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
    torch.cuda.synchronize()
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
