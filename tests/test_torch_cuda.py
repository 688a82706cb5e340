"""The CUDA kernels against their plain versions on the card, the
background planes' torch programs against their numpy oracles there,
a balancer tick against its CPU run, a chip's loss and heal, a short
EC round through the port's cluster, the scale plane's shells mapping
on the card and a thrasher chip_loss round.

Needs a CUDA card and nvcc; elsewhere every test here skips.  On the
card:  python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu_torch.device.runtime import DeviceRuntime
from ceph_tpu_torch.ec import kernels as K
from ceph_tpu_torch.ec import matrices

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _masks(bm, dev):
    return torch.from_numpy(K.pack_rows(bm)).to(dev)


def _view(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of t whose storage starts `offset` elements
    into its buffer (a pointer off the 16-byte grid when offset > 0)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    v = buf[offset:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.parametrize("k,m,lanes", [
    (8, 3, 8195), (10, 6, 1027), (1, 1, 1), (32, 4, 7), (32, 5, 8195),
    (4, 1, 8), (6, 4, 1)])
def test_fused_xor_on_card(card, k, m, lanes):
    """K1: k = 1 and 32, m = 1, 4, 5 and 6, ragged lanes, an unaligned
    view, a bitmatrix row of all zeros, decode rows; one launch for up
    to 128 output chunks."""
    mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, 8)
    bm = np.array(matrices.matrix_to_bitmatrix(k, m, 8, mat))
    bm[1] = 0
    mk = _masks(bm, card)
    rng = np.random.default_rng(k)
    d = torch.from_numpy(rng.integers(0, 2**32, (k, lanes),
                                      dtype=np.uint32)).to(card)
    for data in (d, _view(d, 1)):
        before = K.LAUNCHES["fused_xor"]
        got = K.fused_xor(data, mk)
        torch.cuda.synchronize()
        assert K.LAUNCHES["fused_xor"] == before + 1
        assert torch.equal(got, K.fused_xor_plain(d, mk))
    if k + m > 1:
        erased = (0, k) if m > 1 else (0,)
        surv = tuple(i for i in range(k + m) if i not in erased)
        rows = K._reconstruction_rows(mat, k, 8, erased, surv)
        rk = _masks(matrices.matrix_to_bitmatrix(k, len(rows), 8, rows),
                    card)
        assert torch.equal(K.fused_xor(d, rk), K.fused_xor_plain(d, rk))


@pytest.mark.parametrize("w,k,m,n", [
    (8, 8, 3, 3001), (16, 8, 3, 3001), (32, 8, 3, 3001), (32, 8, 32, 7),
    (32, 1, 1, 1), (8, 32, 2, 8195), (16, 16, 4, 8), (8, 5, 2, 1)])
def test_bitplane_matmul_on_card(card, w, k, m, n):
    """K2 at w = 8, 16, 32: m*w = 1024, k*w = 256, ragged n, an
    unaligned view, a bitmatrix row of all zeros, decode rows."""
    mat = matrices.reed_sol_vandermonde_coding_matrix(k, m, w)
    bm = np.array(matrices.matrix_to_bitmatrix(k, m, w, mat))
    bm[-1] = 0
    mk = _masks(bm, card)
    dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[w]
    rng = np.random.default_rng(w + n)
    d = torch.from_numpy(rng.integers(0, 2**w, (k, n), dtype=np.uint64)
                         .astype(dt)).to(card)
    plain = K.bitplane_matmul_plain(d, mk, w)
    for data in (d, _view(d, 1)):
        before = K.LAUNCHES["bitplane_matmul"]
        got = K.bitplane_matmul(data, mk, w)
        torch.cuda.synchronize()
        assert K.LAUNCHES["bitplane_matmul"] == before + 1
        assert torch.equal(got, plain)
    if k + m > 1:
        erased = (0, k) if m > 1 else (0,)
        surv = tuple(i for i in range(k + m) if i not in erased)
        rows = K._reconstruction_rows(mat, k, w, erased, surv)
        rk = _masks(matrices.matrix_to_bitmatrix(k, len(rows), w, rows),
                    card)
        assert torch.equal(K.bitplane_matmul(d, rk, w),
                           K.bitplane_matmul_plain(d, rk, w))


@pytest.mark.parametrize("k,m,P", [
    (8, 3, 4096), (6, 5, 1001), (10, 6, 64), (32, 8, 1001), (32, 2, 3),
    (4, 5, 1), (8, 3, 7)])
def test_xor_schedule_on_card(card, k, m, P):
    """K3: odd P (blocks off the 16-byte grid), P under one 128-byte
    column tile, k = 32 (256 input blocks), more than four output chunks
    in one launch, views 1, 4 and 8 bytes off the 16-byte grid, a
    bitmatrix row of zeros, decode rows."""
    mat = matrices.isa_cauchy_matrix(k, m)
    enc = K.PlanesEncoder(mat, card)
    rng = np.random.default_rng(P)
    p = torch.from_numpy(rng.integers(0, 256, (k * 64, P),
                                      dtype=np.uint8)).to(card)
    plain = K.xor_schedule_plain(p, enc._masks)
    for by in (0, 1, 4, 8):
        before = K.LAUNCHES["xor_schedule"]
        got = enc(_view(p, by))
        torch.cuda.synchronize()
        assert K.LAUNCHES["xor_schedule"] == before + 1
        assert torch.equal(got, plain)
    bm = np.array(matrices.matrix_to_bitmatrix(k, m, 8, mat))
    bm[1] = 0
    mk = _masks(bm, card)
    got = K.xor_schedule(p, mk)
    assert torch.equal(got, K.xor_schedule_plain(p, mk))
    assert not got[8:16].to(torch.int64).any()
    erased = (0, k + 1)
    surv = tuple(i for i in range(k + m) if i not in erased)
    dec = enc.decode_rows(erased, surv)
    assert torch.equal(dec(p),
                       K.xor_schedule_plain(p, dec.keywords["masks"].masks))


@pytest.mark.parametrize("w,k,m,n", [
    (8, 33, 1, 8195), (8, 40, 3, 1027), (8, 8, 130, 37),
    (16, 17, 3, 3001), (32, 9, 3, 2049), (32, 2, 40, 777),
    (32, 10, 4, 1)])
def test_sliced_products_on_card(card, w, k, m, n):
    """K1 (w=8) and K2 over more than 256 input bits (a launch a slice
    of 256, the later ones XORing into the output) and more than 1024
    output bitmatrix rows (a launch a row group): equal to the sliced
    plain version and to the host GF product, aligned and unaligned."""
    from ceph_tpu_torch.ec import gf
    rng = np.random.default_rng(k * m)
    mat = [[int(c) for c in rng.integers(1, 2 ** min(w, 16), k)]
           for _ in range(m)]
    bm = np.array(matrices.matrix_to_bitmatrix(k, m, w, mat))
    mk = torch.from_numpy(K.pack_slices(bm)).to(card)
    slices = -(-k * w // 256)
    groups = -(-m * w // 1024)
    dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[w]
    data = rng.integers(0, 2 ** w, (k, n), dtype=np.uint64).astype(dt)
    host = gf.matmul_words(np.array(mat, np.uint64), data, w).astype(dt)
    if w == 8:
        lanes = -(-n // 4)
        data = np.pad(data, ((0, 0), (0, 4 * lanes - n)))
        d = torch.from_numpy(data.view(np.uint32)).to(card)
        kern, plain = K.fused_xor, K.fused_xor_plain(d, mk)
        args = ()
    else:
        d = torch.from_numpy(data).to(card)
        kern, args = K.bitplane_matmul, (w,)
        plain = K.bitplane_matmul_plain(d, mk, w)
    name = "fused_xor" if w == 8 else "bitplane_matmul"
    for data_in in (d, _view(d, 1)):
        before = K.LAUNCHES[name]
        got = kern(data_in, mk, *args)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == before + slices * groups
        assert torch.equal(got, plain)
    out = got.cpu().numpy()
    if w == 8:
        out = out.view(np.uint8)[:, :n]
    assert np.array_equal(out, host)


@pytest.mark.parametrize("in_rows,out_rows,B", [
    (48, 24, 1 << 20), (28, 14, 4097), (24, 12, 13), (320, 128, 4096),
    (288, 96, 1001), (600, 3, 24), (7, 1, 1), (256, 5, 8)])
def test_xor_rows_on_card(card, in_rows, out_rows, B):
    """K3's row view: odd output rows, rows of any width (A = 16, 8 and
    1 byte units; one byte), more than 256 input rows (a launch a slice,
    the later ones XORing into the output), views off the 16-byte
    grid, a row of zeros."""
    rng = np.random.default_rng(in_rows + B)
    bm = rng.integers(0, 2, (out_rows, in_rows)).astype(np.int8)
    bm[0] = 0
    rows = torch.from_numpy(rng.integers(0, 256, (in_rows, B),
                                         dtype=np.uint8)).to(card)
    sched = K.XorSchedule(K.pack_slices(bm), in_rows, card)
    plain = K.xor_rows_plain(rows.cpu(), sched.masks.cpu())
    slices = -(-in_rows // 256)
    for by in (0, 1, 8):
        before = K.LAUNCHES["xor_schedule"]
        got = K.xor_rows(_view(rows, by), sched)
        torch.cuda.synchronize()
        assert K.LAUNCHES["xor_schedule"] == before + slices
        assert torch.equal(got.cpu(), plain)
    assert not got[0].to(torch.int64).any()


@pytest.mark.parametrize("profile", [
    dict(technique="cauchy_good", k="6", m="3"),
    dict(technique="cauchy_orig", k="9", m="3", w="32", packetsize="64"),
    dict(technique="liberation", k="4", m="2", w="7", packetsize="12"),
    dict(technique="blaum_roth", k="4", m="2", w="6"),
    dict(technique="cauchy_good", k="4", m="2", packetsize="3"),
], ids=["cauchy_good", "cauchy_orig-w32", "liberation", "blaum_roth",
        "cauchy_good-ps3"])
def test_bitmatrix_codec_on_card(card, profile):
    """The jerasure bitmatrix techniques on the card: encode_async and a
    single and a double decode_async equal to the host codec, each
    launching K3 and neither K1 nor K2."""
    from ceph_tpu_torch.device.runtime import DeviceRuntime
    from ceph_tpu_torch.ec import new_codec
    codec = new_codec(dict(profile, plugin="jerasure"), device=card)
    n, k = codec.get_chunk_count(), codec.get_data_chunk_count()
    every = set(range(n))
    rng = np.random.default_rng(n)
    align = codec.get_alignment()
    objs = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
            for s in (1000, align, 3 * align - 5)]
    stored = [codec.encode(every, o) for o in objs]

    async def counted(ops):
        before = dict(K.LAUNCHES)
        out = await asyncio.gather(*ops)
        assert K.LAUNCHES["xor_schedule"] > before["xor_schedule"]
        assert K.LAUNCHES["fused_xor"] == before["fused_xor"]
        assert K.LAUNCHES["bitplane_matmul"] == before["bitplane_matmul"]
        return out

    async def run():
        DeviceRuntime.reset(device=card)
        assert await counted([codec.encode_async(every, o)
                              for o in objs]) == stored
        for erased in ({0}, {1, k}):
            reads = [{c: s[c] for c in every - erased} for s in stored]
            assert (await counted([codec.decode_async(erased, r)
                                   for r in reads])
                    == [{c: s[c] for c in erased} for s in stored])

    asyncio.run(run())


# ---------------------------------------------------------------------------
# CRUSH kernels (K4-K7)
# ---------------------------------------------------------------------------


def _crush_mapper(card, hosts=8, per_host=5):
    from ceph_tpu_torch.models.crushmap import (
        CHOOSE_INDEP, CHOOSELEAF_FIRSTN, CHOOSELEAF_INDEP, EMIT, STRAW2,
        TAKE, CrushMap)
    from ceph_tpu_torch.ops.crush.device import DeviceMapper
    m = CrushMap()
    w = [0x10000, 0x8000, 0, 0x20000, 0x10000] * per_host
    ids = [m.add_bucket(STRAW2, 1,
                        list(range(per_host * h, per_host * (h + 1))),
                        w[:per_host], id=-(h + 2)).id for h in range(hosts)]
    m.add_bucket(STRAW2, 2, ids, [0x30000] * hosts, id=-1)
    m.add_rule([(TAKE, -1, 0), (CHOOSELEAF_FIRSTN, 0, 1), (EMIT, 0, 0)],
               id=0)
    m.add_rule([(TAKE, -1, 0), (CHOOSELEAF_INDEP, 0, 1), (EMIT, 0, 0)],
               id=1)
    m.add_rule([(TAKE, -1, 0), (CHOOSE_INDEP, 0, 0), (EMIT, 0, 0)], id=2)
    return DeviceMapper(m, device=card)


@pytest.mark.parametrize("ruleno,rmax,lanes,hosts", [
    (0, 3, 1, 8), (0, 3, 70001, 8), (1, 6, 4097, 8), (2, 4, 9999, 8),
    (1, 11, 5000, 8), (1, 20, 3001, 24), (0, 20, 3001, 24)])
def test_crush_choose_on_card(card, ruleno, rmax, lanes, hosts):
    """K4 (firstn and indep, chooseleaf and plain choose, more slots
    than hosts can fill, rows of 20 slots) against its plain version,
    one launch."""
    from ceph_tpu_torch.ops.crush import kernels as CK
    dm = _crush_mapper(card, hosts)
    p = dm._plan(ruleno, rmax)
    rng = np.random.default_rng(lanes + ruleno)
    xs = torch.from_numpy(rng.integers(0, 2**32, lanes,
                                       dtype=np.int64)).to(card)
    w = np.full(hosts * 5, 0x10000, np.int32)
    w[[3, 17]] = 0
    w[[5, 22]] = 0x6000
    dw = torch.from_numpy(w).to(card)
    for staged in (True, False):    # the map in shared or device memory
        before = CK.LAUNCHES["choose"]
        got = CK.choose(dm.fm.tables, p, xs, dw, staged)
        torch.cuda.synchronize()
        assert CK.LAUNCHES["choose"] == before + 1
        assert torch.equal(got, CK.choose_plain(dm.fm.tables, p, xs, dw))


def test_crush_post_hitscan_rowcompact_on_card(card):
    from ceph_tpu_torch.ops.crush import kernels as CK
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 40, (9999, 5)).astype(np.int32)
    raw[rng.random(raw.shape) < 0.2] = 0x7FFFFFFF
    raw = torch.from_numpy(raw).to(card)
    keep = torch.from_numpy(rng.random(40) < 0.8).to(card)
    for can_shift in (True, False):
        got = CK.post(raw, keep, can_shift)
        plain = CK.post_plain(raw, keep, can_shift)
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1],
                                                             plain[1])
    assert torch.equal(CK.hitscan(raw, keep), CK.hitscan_plain(raw, keep))
    hit = torch.from_numpy(rng.random(50001) < 0.05).to(card)
    for kt in (4, 128):
        got = CK.rowcompact(hit, 1000, kt, 49000)
        plain = CK.rowcompact_plain(hit, 1000, kt, 49000)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


@pytest.mark.parametrize("row", [2048, 1000])
def test_crush_rowcompact_on_card(card, row):
    """K7 at the mapper's row (16-byte loads) and off it (byte loads),
    ragged groups, a pg_num mask, overflowing and dense groups, and a
    hit mask that starts off a 16-byte boundary."""
    from ceph_tpu_torch.ops.crush import kernels as CK
    rng = np.random.default_rng(row)
    mask = rng.random(50001 + 3) < 0.05
    mask[4096:7000] = True
    full = torch.from_numpy(mask).to(card)
    for hit in (full[:50001], full[3:]):
        for kt in (4, 128, row):
            before = CK.LAUNCHES["rowcompact"]
            got = CK.rowcompact(hit, row, kt, 49000)
            torch.cuda.synchronize()
            assert CK.LAUNCHES["rowcompact"] == before + 1
            plain = CK.rowcompact_plain(hit, row, kt, 49000)
            assert all(torch.equal(a, b) for a, b in zip(got, plain))


_LRC_W16 = {"mapping": "DD__DD__", "layers": (
    '[["DDc_DDc_", "w=16"], ["DDDc____", "w=16"], ["____DDDc", "w=16"]]')}


@pytest.mark.parametrize("profile,kern", [
    (dict(plugin="lrc", k="4", m="2", l="3"), "fused_xor"),
    (dict(plugin="lrc", **_LRC_W16), "bitplane_matmul"),
    (dict(plugin="shec", k="4", m="3", c="2"), "fused_xor"),
    (dict(plugin="shec", k="4", m="3", c="2", w="32"), "bitplane_matmul"),
    (dict(plugin="clay", k="4", m="2"), "fused_xor"),
], ids=["lrc", "lrc-w16", "shec", "shec-w32", "clay"])
def test_recovery_codec_on_card(card, profile, kern):
    """LRC, SHEC and CLAY on the card: encode_async, a single-loss
    repair from the planned shards (CLAY: repair_async over its
    sub-chunk runs) and a double-loss decode_async equal to the host
    codec, each launching the codec's kernel (K1 at w=8, K2 at
    w=16/32) and no other."""
    import asyncio

    from ceph_tpu_torch.device.runtime import DeviceRuntime
    from ceph_tpu_torch.ec import new_codec
    codec = new_codec(dict(profile), device=card)
    n = codec.get_chunk_count()
    every = set(range(n))
    rng = np.random.default_rng(n)
    objs = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
            for s in (5000, 64 << 10, 256 << 10)]
    stored = [codec.encode(every, o) for o in objs]
    lost = codec.chunk_index(0)
    plan = codec.minimum_to_decode({lost}, every - {lost})
    sub = codec.get_sub_chunk_count()
    parity = [i for i in range(n) if i not in
              {codec.chunk_index(j)
               for j in range(codec.get_data_chunk_count())}][-1]

    def helpers(s):
        sc = len(s[lost]) // sub
        return {h: b"".join(s[h][o * sc:(o + c) * sc] for o, c in runs)
                for h, runs in plan.items()}

    async def counted(ops):
        other = {"fused_xor": "bitplane_matmul",
                 "bitplane_matmul": "fused_xor"}[kern]
        before = dict(K.LAUNCHES)
        out = await asyncio.gather(*ops)
        assert K.LAUNCHES[kern] > before[kern]
        assert K.LAUNCHES[other] == before[other]
        return out

    async def run():
        DeviceRuntime.reset(device=card)
        assert await counted([codec.encode_async(every, o)
                              for o in objs]) == stored
        if any(r != [(0, sub)] for r in plan.values()):
            rep = await counted([codec.repair_async(lost, helpers(s))
                                 for s in stored])
        else:
            rep = [d[lost] for d in await counted([
                codec.decode_async({lost}, {h: s[h] for h in plan})
                for s in stored])]
        assert rep == [s[lost] for s in stored]
        erased = {lost, parity}
        reads = [{c: s[c] for c in every - erased} for s in stored]
        assert (await counted([codec.decode_async(erased, r)
                               for r in reads])
                == [codec.decode(erased, r) for r in reads])

    asyncio.run(run())


def test_digest_plane_on_card(card):
    """crc32_batch on the card: length classes, folded buffers and a
    batch over one dispatch's staging bound, equal to zlib."""
    import zlib

    from ceph_tpu_torch.device import digest

    rng = np.random.default_rng(41)
    bufs = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
            for s in (0, 1, 255, 4096, 12345, 16384, 16385, 1 << 22)]
    bufs.append(b"y" * (digest.DEVICE_MAX_STAGE_BYTES + 1))

    async def run():
        rt = DeviceRuntime.reset(device=card)
        out, path = await digest.crc32_batch(bufs)
        return rt.chips[0], out, path

    chip, out, path = asyncio.run(run())
    assert path == "device" and chip.dispatches == 2      # 2313 lanes
    assert out == [zlib.crc32(b) for b in bufs]
    assert all(t.ok and t.device_s > 0 for t in chip.tickets)


def test_compression_plane_on_card(card):
    """match_plan on the card equals the numpy oracle; compress_async
    equals compress_host and round-trips."""
    from ceph_tpu_torch.compress import tlz
    from ceph_tpu_torch.device import lzkernel as lz

    rng = np.random.default_rng(7)
    text = rng.integers(0x20, 0x7F, 24, dtype=np.uint8).tobytes()
    objs = [(text * 12000)[:260000], bytes(70000),
            rng.integers(0, 256, 100000, dtype=np.uint8).tobytes(),
            b"\xff" * 5000]
    segs = tlz._blocks_of(objs[0])[:64]
    stage, lens = lz._stage_blocks(segs, 64)
    c, m = lz.match_plan(torch.from_numpy(stage).to(card),
                         torch.from_numpy(lens).to(card))
    want_c, want_m = lz.match_plan_host(stage, lens)
    assert np.array_equal(c.cpu().numpy(), want_c)
    assert np.array_equal(m.cpu().numpy(), want_m)

    async def run():
        DeviceRuntime.reset(device=card)
        return [await tlz.compress_async(o) for o in objs]

    for o, (blob, path) in zip(objs, asyncio.run(run())):
        assert path == "device"
        assert blob == tlz.compress_host(o)
        assert tlz.decompress(blob) == o


def test_dedup_plane_on_card(card):
    """boundary_batch and fingerprint_batch on the card equal
    chunk_host and zlib."""
    import zlib

    from ceph_tpu_torch.dedup import chunker as ch

    rng = np.random.default_rng(47)
    blobs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(1, 40 * ch.SEG, 6)] + [b"", bytes(50000)]

    async def run():
        DeviceRuntime.reset(device=card)
        cuts, path = await ch.boundary_batch(blobs)
        chunks = [c for b, cc in zip(blobs, cuts) for c in ch.split(b, cc)]
        fps, fpath = await ch.fingerprint_batch(chunks)
        return cuts, path, chunks, fps, fpath

    cuts, path, chunks, fps, fpath = asyncio.run(run())
    assert (path, fpath) == ("device", "device")
    assert cuts == [ch.chunk_host(b) for b in blobs]
    assert fps == [ch.fingerprint(zlib.crc32(c), len(c)) for c in chunks]


def _skewed_map(hosts=12, per_host=4, pg_num=1024):
    from ceph_tpu_torch.models.crushmap import (CHOOSELEAF_FIRSTN, EMIT,
                                                STRAW2, TAKE, CrushMap)
    from ceph_tpu_torch.osd.osdmap import (OSD_EXISTS, OSD_UP, Incremental,
                                           OSDMap, PGPool)
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
    inc.new_pools[1] = PGPool(id=1, name="p", pg_num=pg_num, size=3,
                              crush_rule=0)
    m.apply_incremental(inc)
    inc = m.new_incremental()
    for o in range(hosts * per_host):
        inc.new_state[o] = OSD_EXISTS | OSD_UP
        inc.new_weight[o] = 0x8000 if o % 5 == 0 else 0x10000
    m.apply_incremental(inc)
    return m


def test_balancer_tick_on_card(card):
    """A batched_calc_pg_upmaps tick on the card (K4/K5 in the
    prologue, the scorer on the card) equals its CPU run."""
    from ceph_tpu_torch.ops.crush import kernels as CK
    from ceph_tpu_torch.scale import batched_calc_pg_upmaps

    def tick(device):
        m = _skewed_map()
        inc = m.new_incremental()
        res = batched_calc_pg_upmaps(m, inc, max_deviation=0.5,
                                     device=device)
        items = {(pg.pool, pg.ps): list(v)
                 for pg, v in inc.new_pg_upmap_items.items()}
        return res, items

    before = dict(CK.LAUNCHES)
    res, items = tick(card)
    assert CK.LAUNCHES["choose"] > before["choose"]
    assert CK.LAUNCHES["post"] > before["post"]
    want, want_items = tick("cpu")
    assert items == want_items and res.changes > 0
    for attr in ("changes", "rounds", "candidates_scored",
                 "stddev_before", "stddev_after"):
        assert getattr(res, attr) == getattr(want, attr), attr
    assert res.host_rounds == 0 and res.device_rounds == res.rounds
    assert all(t.ok and t.device_s > 0 for t in res.tickets)


def test_chip_loss_and_heal_on_card(card):
    """inject -> lose -> heal on the card: the faulted encode fails
    with IOError, the lost chip launches nothing, the probe (a real op
    on the card) heals it and its next encode is exact."""
    import time

    from ceph_tpu_torch.ec import new_codec
    codec = new_codec({"plugin": "isa", "k": "4", "m": "2"}, device=card)
    data = bytes(range(256)) * 64
    every = set(range(6))

    async def run():
        rt = DeviceRuntime.reset(chips=2, device=card)
        rt.configure({"device_max_inflight": 2, "device_queue_len": 64,
                      "device_probe_interval": 0.04})
        chip = rt.chips[1]
        chip.inject_fault(1 << 30)
        with pytest.raises(IOError):
            await codec.encode_async(every, data, chip=1)
        assert chip.lost and not rt.chips[0].lost
        before = K.LAUNCHES["fused_xor"]
        with pytest.raises(IOError):
            await codec.encode_async(every, data, chip=1)
        assert K.LAUNCHES["fused_xor"] == before
        assert await codec.encode_async(every, data, chip=0) == \
            codec.encode(every, data)
        chip.clear_faults()
        t0 = time.monotonic()
        while chip.lost and time.monotonic() - t0 < 2.0:
            await asyncio.sleep(0.01)
        assert not chip.lost and chip.heal_count == 1
        before = K.LAUNCHES["fused_xor"]
        assert await codec.encode_async(every, data, chip=1) == \
            codec.encode(every, data)
        assert K.LAUNCHES["fused_xor"] > before

    asyncio.run(run())


def test_cluster_round_on_card(card):
    """Four OSDs on the card, a jerasure 2+1 pool: the OSDs' encodes
    launch K1, and every read equals its write."""
    from ceph_tpu_torch.testing import LocalCluster

    async def main():
        c = await LocalCluster(n_osds=4, device=card).start()
        try:
            await c.client.mon_command(
                "osd erasure-code-profile set", name="rs21",
                profile={"plugin": "jerasure", "technique": "reed_sol_van",
                         "k": "2", "m": "1"})
            pid = await c.create_pool("rs21", pg_num=8, pool_type="erasure",
                                      erasure_code_profile="rs21")
            await c.wait_health(pid)
            io = c.client.io_ctx("rs21")
            rng = np.random.default_rng(4)
            data = {"c%d" % i: rng.bytes(65536 + i) for i in range(4)}
            before = K.LAUNCHES["fused_xor"]
            for oid, blob in data.items():
                await io.write_full(oid, blob)
            for oid, blob in data.items():
                assert await io.read(oid) == blob
            assert K.LAUNCHES["fused_xor"] > before
        finally:
            await c.stop()

    asyncio.run(asyncio.wait_for(main(), 120))


def test_scale_cluster_on_card(card):
    """Forty shells on the card: the shells' MapCache maps each epoch
    through K4/K5, a mark-out drains, and the last epoch's grouping
    equals the host engine's."""
    from ceph_tpu_torch.ops.crush import kernels as CK
    from ceph_tpu_torch.osd.osdmap import pg_t
    from ceph_tpu_torch.scale import ScaleCluster
    from ceph_tpu_torch.utils.backoff import wait_for

    from ceph_tpu_torch import _build
    _build.library()        # built before the loop starts, not in it

    async def main():
        c = await ScaleCluster(40, conf={"log_level": 0},
                               device=card).start()
        try:
            before = CK.LAUNCHES["choose"], CK.LAUNCHES["post"]
            await c.create_pool("scale", pg_num=256)
            await c.wait_epoch_converged(c.leader().osdmap.epoch, 30.0)
            await wait_for(
                lambda: (c.digest() or {}).get("num_pgs") == 256, 30.0,
                what="digest carrying all 256 shell PGs")
            await c.mark_out_fraction(0.05)
            obs = await c.wait_misplaced_drained(timeout=60.0)
            assert obs["max_misplaced"] > 0
            assert CK.LAUNCHES["choose"] > before[0]
            assert CK.LAUNCHES["post"] > before[1]
            m = c.leader().osdmap
            grouping = c.mapcache.primaries_for(m)
            rows = {(pool, ps): (osd, up) for osd, pgs in grouping.items()
                    for pool, ps, up in pgs}
            pid = next(p for p, pl in m.pools.items()
                       if pl.name == "scale")
            for ps in range(256):
                up, prim, _a, _ap = m.pg_to_up_acting_osds(pg_t(pid, ps))
                want = tuple(o for o in up if o != 0x7FFFFFFF)
                assert rows[(pid, ps)] == (prim, want), ps
            assert c.mapcache.host_builds == 0
        finally:
            await c.stop()

    asyncio.run(asyncio.wait_for(main(), 180))


def test_thrash_chip_loss_round_on_card(card):
    """Three OSDs on three logical chips of the card, an isa 2+1 pool
    under a workload: one chip_loss round held to the port's oracle,
    then every acked write reads back; K1 launches."""
    from ceph_tpu_torch.testing import (ClusterThrasher, LocalCluster,
                                        Workload)

    from ceph_tpu_torch import _build
    _build.library()        # built before the loop starts, not in it

    async def main():
        c = await LocalCluster(
            n_osds=3, device=card, device_chips=3,
            conf={"device_probe_interval": 0.04,
                  "heartbeat_interval": 0.5, "heartbeat_grace": 10.0,
                  "mon_osd_down_out_interval": 600.0}).start()
        try:
            await c.client.mon_command(
                "osd erasure-code-profile set", name="isa21",
                profile={"plugin": "isa", "k": "2", "m": "1"})
            pid = await c.create_pool("isa21", pg_num=8,
                                      pool_type="erasure",
                                      erasure_code_profile="isa21")
            await c.wait_health(pid)
            before = K.LAUNCHES["fused_xor"]
            wl = Workload(c.client.io_ctx("isa21"), seed=3).start()
            th = ClusterThrasher(c, seed=3, actions=[("chip_loss", 1)])
            await th.run(pid, wl)
            await wl.stop()
            await wl.verify()
            rec, = th.device_rounds
            assert rec["refused"] >= 1 and rec["acked"] >= 1, rec
            assert rec["device_lost_raised"] and rec["device_lost_cleared"]
            assert K.LAUNCHES["fused_xor"] > before
        finally:
            await c.stop()

    asyncio.run(asyncio.wait_for(main(), 180))
