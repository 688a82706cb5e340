"""The CRUSH kernels' plain versions (K4-K7) against the JAX package.

Every value is an integer, so every comparison is exact (tolerance 0).
K4's building block, the straw2 descent (``descend_plain``, on the
division-free draw), is held against the reference's XLA descent
(``_descend(..., resolve=False)``, the Pallas kernel's semantics at
logic level, pallas_draw.py:20-25) on the lanes that descent does not
flag, and against the host engine's straw2 choose on every lane (K4
itself, ``choose_plain``: test_torch_crush_choose.py); K5
against ``_post_process``; K6 against the reference's XLA hit formula;
K7 against ``np.nonzero`` per row group and once against its Pallas
kernel in interpret mode (one 16384-lane mask).  In interpret mode on
the CPU the Pallas descent costs tens of seconds a case and the post
and hit-scan kernels seconds each, so K4-K6 meet the reference through
its XLA forms only.
"""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.models.crushmap import (CHOOSELEAF_FIRSTN, EMIT, STRAW2,
                                      TAKE, CrushMap, WeightSet)
from ceph_tpu.ops.crush import device as RD
from ceph_tpu.ops.crush import host as RH
from ceph_tpu.ops.crush import pallas_draw as RP
from ceph_tpu.ops.crush.hashes import hash32_2, hash32_3

from ceph_tpu_torch.models.crushmap import CrushMap as PCrushMap
from ceph_tpu_torch.ops.crush import device as PD
from ceph_tpu_torch.ops.crush import kernels as K

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
NONE = 0x7FFFFFFF


def _port(m: CrushMap) -> PCrushMap:
    return PCrushMap.from_dict(m.to_dict())


def _tree(hosts=6, per_host=5, seed=1, racks=0, cargs=False,
          device_under_root=False):
    """root (type 3 with racks, else 2) -> [racks ->] hosts -> osds.
    With racks, one more rack under the root is empty."""
    rng = random.Random(seed)
    m = CrushMap()
    host_ids = []
    for h in range(hosts):
        items = list(range(h * per_host, (h + 1) * per_host))
        w = [rng.choice([0, 0x8000, 0x10000, 0x18000, 0x20000])
             if per_host > 2 else 0x10000 for _ in items]
        b = m.add_bucket(STRAW2, 1, items, w, id=-(h + 2))
        host_ids.append(b.id)
    top = host_ids
    if racks:
        top = []
        per = -(-hosts // racks)
        for k in range(racks + 1):
            kids = host_ids[k * per:(k + 1) * per] if k < racks else []
            b = m.add_bucket(STRAW2, 2, kids,
                             [max(m.buckets[h].weight, 0x10000)
                              for h in kids], id=-(hosts + 2 + k))
            top.append(b.id)
    root_items = list(top)
    root_w = [max(m.buckets[b].weight, 0x10000) for b in top]
    if device_under_root:
        root_items.append(hosts * per_host)      # a bare OSD under root
        root_w.append(0x10000)
    m.add_bucket(STRAW2, 3 if racks else 2, root_items, root_w, id=-1)
    m.add_rule([(TAKE, -1, 0), (CHOOSELEAF_FIRSTN, 0, 1), (EMIT, 0, 0)],
               id=0)
    if cargs:
        sets = {}
        for bid, b in m.buckets.items():
            ws = [[rng.choice([0, 0x8000, 0x10000, 0x20000])
                   for _ in b.items] for _ in range(3)]
            sets[bid] = WeightSet(bucket_id=bid, weight_sets=ws)
        m.choose_args["opt"] = sets
    return m


def _lanes(L, n_buckets, seed, n_pos=1):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, L, dtype=np.int64)
    x[:4] = [0, 1, (1 << 32) - 1, 1 << 31]
    r = rng.integers(0, 60, L).astype(np.int32)
    bid = rng.integers(0, n_buckets, L).astype(np.int32)
    pos = rng.integers(0, n_pos + 1, L).astype(np.int32)
    return x, r, bid, pos


def _host_descend(m, cargs, x, r, bid, pos, depth_sizes, want_type):
    """The descent on the host engine's straw2 choose (host.py:147):
    (item, ok, perm) of one lane."""
    mp = RH.Mapper(m)
    b = m.buckets.get(-1 - bid)
    if b is None or b.size == 0:
        return NONE, False, False
    for S_d in depth_sizes:
        if b.size > S_d:
            b = type(b)(**{**b.__dict__, "items": b.items[:S_d],
                           "item_weights": b.item_weights[:S_d]})
        arg = cargs.get(b.id) if cargs else None
        if arg is not None and arg.weight_sets:
            arg = WeightSet(bucket_id=arg.bucket_id, ids=arg.ids,
                            weight_sets=[ws[:b.size]
                                         for ws in arg.weight_sets])
        c = mp._straw2_choose(b, int(x), int(r), arg, int(pos))
        if c < 0 and c in m.buckets:
            child = m.buckets[c]
            if child.type == want_type:
                return c, True, False
            if child.size == 0:
                return NONE, False, False
            b = child
            continue
        if c >= 0 and c < m.max_devices and want_type == 0:
            return c, True, False
        return NONE, False, True
    return NONE, False, False


# ---------------------------------------------------------------------------
# primitives: hash, crush_ln, truncating division
# ---------------------------------------------------------------------------


def test_crush_ln_exhaustive():
    u = torch.arange(65536, dtype=torch.int64)
    got = K.crush_ln(u).numpy()
    want = np.array([RH.crush_ln(int(v)) for v in range(65536)],
                    dtype=np.int64)
    assert np.array_equal(got, want)
    with open(os.path.join(GOLDEN, "crush_primitives.json")) as f:
        prim = json.load(f)
    ln = K.crush_ln(torch.tensor(prim["ln_in"], dtype=torch.int64))
    assert ln.tolist() == prim["ln_out"]


def test_div_s64_truncates_negative_draws():
    a = torch.tensor([-(1 << 48), -(1 << 48) + 1, -7, -1, 0, 7, -12345678901,
                      -65536, -65535], dtype=torch.int64)
    b = torch.tensor([1, 3, 2, 0x10000, 5, 2, 0xFFFFFFFF, 0x10000, 0x10000],
                     dtype=torch.int64)
    got = K.div_s64(a, b).tolist()
    want = [RH._div_s64(int(x), int(y)) for x, y in zip(a, b)]
    assert got == want
    # floor division is the trap: it rounds the negative draws down
    assert (a // b).tolist() != want


def test_hashes_match_reference_and_golden():
    with open(os.path.join(GOLDEN, "crush_primitives.json")) as f:
        prim = json.load(f)
    a2 = torch.tensor(prim["hash2_in"], dtype=torch.int64)
    assert K.hash32_2(a2[:, 0], a2[:, 1]).tolist() == prim["hash2_out"]
    a3 = torch.tensor(prim["hash3_in"], dtype=torch.int64)
    assert (K.hash32_3(a3[:, 0], a3[:, 1], a3[:, 2]).tolist()
            == prim["hash3_out"])
    rng = np.random.default_rng(5)
    v = rng.integers(0, 1 << 32, (2000, 3), dtype=np.int64)
    top = (1 << 32) - 1
    v[:3] = [[0, 0, 0], [top, top, top], [1 << 31, 1, top]]
    t = torch.from_numpy(v)
    assert (K.hash32_3(t[:, 0], t[:, 1], t[:, 2]).tolist()
            == [hash32_3(*map(int, row)) for row in v])
    assert (K.hash32_2(t[:, 0], t[:, 1]).tolist()
            == [hash32_2(int(p), int(q)) for p, q, _ in v])
    # the trap the int64 form avoids: torch's int32 >> is arithmetic, so
    # a word at or above 2^31 would shift in ones
    assert (torch.tensor([-(1 << 31)], dtype=torch.int32) >> 13).item() < 0


def test_bitmask_words():
    rng = np.random.default_rng(2)
    for D in (1, 31, 32, 33, 1000):
        f = rng.random(D) < 0.5
        f[-1] = True
        words = K.bitmask(torch.from_numpy(f)).numpy().view(np.uint32)
        back = np.unpackbits(words.view(np.uint8), bitorder="little")[:D]
        assert np.array_equal(back.astype(bool), f)


# ---------------------------------------------------------------------------
# K4's descent (descend_plain, a building block of choose_plain)
# ---------------------------------------------------------------------------


_K4_CASES = [
    # (map kwargs, start buckets, choose_args, depth from, want_type)
    ("outer", dict(hosts=6, per_host=5), "root", False, 1),
    ("racks", dict(hosts=7, per_host=3, racks=3, device_under_root=True),
     "root", False, 1),
    ("choose_args", dict(hosts=5, per_host=4, seed=3, cargs=True), "root",
     True, 1),
    ("choose_args_inner", dict(hosts=5, per_host=4, seed=4, cargs=True),
     "hosts", True, 0),
]


@pytest.mark.parametrize("name,kw,start,cargs,want",
                         _K4_CASES, ids=[c[0] for c in _K4_CASES])
def test_descend_plain_matches_reference(name, kw, start, cargs, want):
    m = _tree(**kw)
    cname = "opt" if cargs else None
    rdm = RD.DeviceMapper(m, cname)
    pdm = PD.DeviceMapper(_port(m), cname, device="cpu")
    if start == "root":
        starts, L = [-1], 2048
    else:
        starts, L = [b for b in m.buckets if m.buckets[b].type == 1], 2048
    depth = rdm._depth_sizes(starts, want)
    x, r, bid, pos = _lanes(L, len(starts), hash(name) % 1000,
                            pdm.fm.n_pos)
    bid = np.array([-1 - starts[i] for i in bid], np.int32)
    item, status = K.descend_plain(pdm.fm.tables, depth, want,
                                   torch.from_numpy(x), torch.from_numpy(r),
                                   torch.from_numpy(bid),
                                   torch.from_numpy(pos))
    item, status = item.numpy(), status.numpy()
    ok, perm = (status & 1) != 0, (status & 2) != 0
    assert not (status & ~3).any()
    # the reference's XLA descent (resolve=False) on its unflagged lanes
    ref = jax.jit(lambda b, xx, rr, pp: RD._descend(
        rdm.fm, b, xx, rr, want, pp, depth, False))
    ri, rok, rperm, rflag = (np.asarray(v) for v in ref(
        jnp.asarray(bid), jnp.asarray(x.astype(np.uint32)),
        jnp.asarray(r), jnp.asarray(pos)))
    keep = ~rflag
    assert keep.mean() > 0.9
    assert np.array_equal(item[keep], ri[keep])
    assert np.array_equal(ok[keep], rok[keep])
    assert np.array_equal(perm[keep], rperm[keep])
    # the host engine's straw2 draw on every lane
    cmap = m.choose_args.get("opt") if cargs else None
    for i in range(L):
        want_row = _host_descend(m, cmap, x[i], r[i], int(bid[i]),
                                 pos[i], depth, want)
        assert (int(item[i]), bool(ok[i]), bool(perm[i])) == want_row, i
    if name == "racks":
        assert perm.any() and (~ok & ~perm).any() and ok.any()


def test_tables_carry_the_reference_flatmap():
    """The port's flat tables hold the reference FlatMap's ids, weights,
    sizes and types for every map of these tests."""
    maps = [(_tree(**kw), "opt" if c else None) for _n, kw, _s, c, _w
            in _K4_CASES]
    for m, cname in maps:
        ref = RD.FlatMap(m, cname)
        state = {"map": m.to_dict(), "choose_args_name": cname,
                 "osd_weight": np.full(m.max_devices, 0x10000),
                 "exists": np.ones(m.max_devices, bool),
                 "isup": np.ones(m.max_devices, bool)}
        dm, st = PD.load_reference_state(state, "cpu")
        t = dm.fm.tables
        assert np.array_equal(t.items.numpy(), ref._items_np)
        assert np.array_equal(t.ids.numpy(), ref._ids_np)
        assert np.array_equal(t.weights.numpy(), ref._w_np & K.M32)
        assert np.array_equal(dm.fm._w_np, ref._w_np)
        assert np.array_equal(t.size.numpy(), ref._size_np)
        assert np.array_equal(t.btype.numpy(), ref._btype_np)
        assert (dm.fm.B, dm.fm.S, dm.fm.n_pos, dm.fm.max_depth) == (
            ref.B, ref.S, ref.n_pos, ref.max_depth)
        assert st["keep"].all() and st["primary_affinity"] is None
        # CUDA torch has no reductions on uint16/uint32: none is used
        assert st["osd_weight"].dtype == torch.int32
        assert [v.dtype for v in (t.items, t.ids, t.weights, t.size,
                                  t.btype)] == [torch.int32] * 2 + [
            torch.int64] + [torch.int32] * 2


# ---------------------------------------------------------------------------
# K5, K6, K7
# ---------------------------------------------------------------------------


def _raw_rows(L, S, D, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, D, (L, S)).astype(np.int32)
    raw[rng.random((L, S)) < 0.15] = NONE
    raw[::97] = NONE
    return raw


@pytest.mark.parametrize("can_shift", [True, False])
def test_post_plain_matches_reference(can_shift):
    D, L, S = 40, 3000, 4
    rng = np.random.default_rng(7)
    raw = _raw_rows(L, S, D, 1)
    exists = rng.random(D) < 0.9
    isup = rng.random(D) < 0.85
    seeds = rng.integers(0, 1 << 32, L, dtype=np.int64)
    up, prim = K.post(torch.from_numpy(raw), torch.from_numpy(exists & isup),
                      can_shift)
    ref = jax.jit(lambda *a: RD._post_process(*a, can_shift, False))
    rup, rprim = ref(jnp.asarray(raw), jnp.asarray(seeds.astype(np.uint32)),
                     jnp.asarray(exists), jnp.asarray(isup),
                     jnp.zeros(D, jnp.int32))
    assert np.array_equal(up.numpy(), np.asarray(rup))
    assert np.array_equal(prim.numpy(), np.asarray(rprim))


@pytest.mark.parametrize("density", [0.0, 0.05, 1.0])
def test_hitscan_plain_matches_reference(density):
    D, L, S = 50, 3000, 3
    raw = _raw_rows(L, S, D, 4)
    changed = np.random.default_rng(5).random(D) < density
    hit = K.hitscan(torch.from_numpy(raw), torch.from_numpy(changed))
    # the reference's XLA hit formula (device.py:1765-1768)
    idxc = np.clip(raw, 0, D - 1)
    want = np.any((raw != NONE) & (raw < D) & changed[idxc], axis=1)
    assert np.array_equal(hit.numpy(), want)


def _rowcompact_reference(hit, row, kt, pg_num):
    """np.nonzero per row group, in the K7 slot layout."""
    n = hit.shape[0]
    nr = -(-n // row)
    idx = np.zeros((nr, kt), np.int64)
    valid = np.zeros((nr, kt), bool)
    cnt = np.zeros(nr, np.int64)
    for g in range(nr):
        lo, hi = g * row, min(n, (g + 1) * row)
        lanes = lo + np.nonzero(hit[lo:hi])[0]
        lanes = lanes[lanes < pg_num]
        cnt[g] = lanes.size
        idx[g] = lo
        k = min(kt, lanes.size)
        idx[g, :k] = lanes[:k]
        valid[g] = (np.arange(kt) < lanes.size) & (idx[g] < pg_num)
    return idx.reshape(-1), valid.reshape(-1), cnt


@pytest.mark.parametrize("n,row,kt,pg_num,p", [
    (16000, 2048, 128, 16000, 0.02),     # sparse, ragged last group
    (16000, 2048, 128, 15000, 0.2),      # groups that overflow kt
    (5000, 256, 16, 4999, 0.05),         # small groups, pg_num mask
    (100, 2048, 128, 100, 1.0),          # one ragged dense group
    (4096, 1000, 64, 4096, 0.0),         # no hits, row off the warp grid
])
def test_rowcompact_plain_matches_nonzero(n, row, kt, pg_num, p):
    rng = np.random.default_rng(n + kt)
    hit = rng.random(n) < p
    idx, valid, cnt = K.rowcompact(torch.from_numpy(hit), row, kt, pg_num)
    ridx, rvalid, rcnt = _rowcompact_reference(hit, row, kt, pg_num)
    assert np.array_equal(idx.numpy(), ridx)
    assert np.array_equal(valid.numpy(), rvalid)
    assert np.array_equal(cnt.numpy(), rcnt)
    if p == 0.2:
        assert (rcnt > kt).any()


def test_rowcompact_plain_matches_pallas_interpret(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_PALLAS_INTERPRET", "1")
    n, row, kt, pg_num = 8 * 2048, 2048, 128, 16000
    hit = np.random.default_rng(9).random(n) < 0.03
    idx, valid, cnt = K.rowcompact(torch.from_numpy(hit), row, kt, pg_num)
    ridx, rvalid, rcnt = RP.make_rowcompact_kernel(n, row, kt, pg_num)(
        jnp.asarray(hit))
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert np.array_equal(valid.numpy(), np.asarray(rvalid))
    assert np.array_equal(cnt.numpy(), np.asarray(rcnt))


# ---------------------------------------------------------------------------
# wrappers: checks, and no plain version off the CPU
# ---------------------------------------------------------------------------


def test_wrappers_check_their_inputs():
    raw = torch.zeros((4, 3), dtype=torch.int64)
    keep = torch.ones(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        K.post(raw, keep, True)
    with pytest.raises(TypeError):
        K.hitscan(raw.to(torch.int32), keep.to(torch.int32))
    with pytest.raises(ValueError):
        K.rowcompact(keep, 0, 128, 8)
    with pytest.raises(ValueError):
        K.post(raw.to(torch.int32).t(), keep, True)
    m = _tree()
    dm = PD.DeviceMapper(_port(m), device="cpu")
    t, p = dm.fm.tables, dm._plan(0, 3)
    x = torch.zeros(4, dtype=torch.int64)
    w = torch.full((m.max_devices,), 0x10000, dtype=torch.int32)
    with pytest.raises(TypeError):
        K.choose(t, p, x.to(torch.int32), w)
    with pytest.raises(TypeError):
        K.choose(t, p, x, w.to(torch.int64))
    with pytest.raises(ValueError):
        K.choose(t, p, x[None, :], w)
    wide = K.ChoosePlan(**{k: getattr(p, k) for k in K.ChoosePlan.__slots__})
    wide.outer_ds = (99,)
    with pytest.raises(ValueError, match="level widths"):
        K.choose(t, wide, x, w)
    with pytest.raises(ValueError, match="tensors on"):
        K.choose(t, p, x.to("meta"), w)


def test_off_the_cpu_wrappers_reach_only_their_kernels(monkeypatch):
    """Off the CPU a wrapper launches its kernel or raises; the plain
    versions are never reached.  (Here the build has no nvcc, so it
    raises, and nothing counts as launched.)"""
    def boom(*a, **kw):
        raise AssertionError("plain version reached off the CPU")

    for name in ("choose_plain", "descend_plain", "post_plain",
                 "hitscan_plain", "rowcompact_plain"):
        monkeypatch.setattr(K, name, boom)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    K._build.library.cache_clear()
    monkeypatch.setattr(K._build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(K._build, "BUILD_DIR", K._build.BUILD_DIR / "none")
    meta = torch.device("meta")
    dm = PD.DeviceMapper(_port(_tree()), device="cpu")
    fm = dm.fm
    t = K.CrushTables(fm._items_np, fm._ids_np, fm._w_np, fm._size_np,
                      fm._btype_np, fm.max_devices, meta)
    L = 5000        # not a multiple of the TPU kernel's 4096-lane tile
    x = torch.empty(L, dtype=torch.int64, device=meta)
    w = torch.empty(fm.max_devices, dtype=torch.int32, device=meta)
    raw = torch.empty((L, 3), dtype=torch.int32, device=meta)
    keep = torch.empty(7, dtype=torch.bool, device=meta)
    before = dict(K.LAUNCHES)
    firstn = dm._plan(0, 3)
    indep = K.ChoosePlan(**{k: getattr(firstn, k)
                            for k in K.ChoosePlan.__slots__})
    indep.firstn = False
    for p in (firstn, indep):
        with pytest.raises(RuntimeError, match="nvcc"):
            K.choose(t, p, x, w)
    with pytest.raises(RuntimeError, match="nvcc"):
        K.post(raw, keep, True)
    with pytest.raises(RuntimeError, match="nvcc"):
        K.hitscan(raw, keep)
    with pytest.raises(RuntimeError, match="nvcc"):
        K.rowcompact(torch.empty(L, dtype=torch.bool, device=meta), 2048,
                     128, L)
    assert K.LAUNCHES == before
    K._build.library.cache_clear()
