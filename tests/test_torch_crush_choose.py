"""K4's plain version (``choose_plain``) and its division-free draw
against the JAX package and the host engine.

Every value is an integer, so every comparison is exact (tolerance 0).
``draw_recip_plain`` is held against ``div_s64`` (the host engine's
truncating division) for every 16-bit hash and every distinct weight
of the test maps.  ``choose_plain``, reached through
``DeviceMapper(device="cpu").do_rule_batch``, is held against the host
engine's ``do_rule`` on every case and against the reference's
``DeviceMapper.do_rule_batch`` (its XLA retry loops and host dust) on
the cases marked so: each reference case compiles its programs, a few
seconds on the CPU.
"""

import random

import numpy as np
import pytest
import torch

from ceph_tpu.models.crushmap import (CHOOSE_FIRSTN, CHOOSE_INDEP,
                                      CHOOSELEAF_FIRSTN, CHOOSELEAF_INDEP,
                                      EMIT, SET_CHOOSELEAF_TRIES, STRAW2,
                                      TAKE, CrushMap, WeightSet)
from ceph_tpu.ops.crush import host as RH
from ceph_tpu.ops.crush.device import DeviceMapper as RefMapper

from ceph_tpu_torch.models.crushmap import CrushMap as PCrushMap
from ceph_tpu_torch.ops.crush import device as PD
from ceph_tpu_torch.ops.crush import kernels as K

torch.set_num_threads(1)

NONE = 0x7FFFFFFF


def _port(m: CrushMap) -> PCrushMap:
    return PCrushMap.from_dict(m.to_dict())


def _map(hosts=6, per_host=5, seed=1, cargs=False):
    """root -> hosts -> osds, straw2, uneven weights; rules 0-3 as in
    test_torch_crush_slice, 4 chooseleaf firstn down to the OSDs
    themselves (type 0), 5 chooseleaf firstn with three leaf tries."""
    rng = random.Random(seed)
    m = CrushMap()
    ids = []
    for h in range(hosts):
        items = list(range(h * per_host, (h + 1) * per_host))
        w = [rng.choice([0x8000, 0x10000, 0x18000, 0x20000])
             for _ in items]
        ids.append(m.add_bucket(STRAW2, 1, items, w, id=-(h + 2)).id)
    m.add_bucket(STRAW2, 2, ids, [m.buckets[h].weight for h in ids], id=-1)
    m.add_rule([(TAKE, -1, 0), (CHOOSELEAF_FIRSTN, 0, 1), (EMIT, 0, 0)],
               id=0)
    m.add_rule([(TAKE, -1, 0), (CHOOSELEAF_INDEP, 0, 1), (EMIT, 0, 0)],
               id=1)
    m.add_rule([(TAKE, -1, 0), (CHOOSE_FIRSTN, 0, 0), (EMIT, 0, 0)], id=2)
    m.add_rule([(TAKE, -1, 0), (CHOOSE_INDEP, 0, 1), (EMIT, 0, 0)], id=3)
    m.add_rule([(TAKE, -1, 0), (CHOOSELEAF_FIRSTN, 0, 0), (EMIT, 0, 0)],
               id=4)
    m.add_rule([(TAKE, -1, 0), (SET_CHOOSELEAF_TRIES, 3, 0),
                (CHOOSELEAF_FIRSTN, 0, 1), (EMIT, 0, 0)], id=5)
    if cargs:
        sets = {}
        for bid, b in m.buckets.items():
            ws = [[rng.choice([0, 0x8000, 0x10000, 0x20000])
                   for _ in b.items] for _ in range(3)]
            hid = ([rng.randrange(1 << 20) for _ in b.items] if bid == -1
                   else None)
            sets[bid] = WeightSet(bucket_id=bid, weight_sets=ws, ids=hid)
        m.choose_args["opt"] = sets
    return m


def _host_rows(m, ruleno, xs, rmax, w, cargs=None):
    host = RH.Mapper(m)
    out = np.full((len(xs), rmax), NONE, np.int32)
    for i, x in enumerate(xs):
        row = host.do_rule(ruleno, int(x), rmax, list(w),
                           choose_args=cargs)
        out[i, :len(row)] = row
    return out


def _weights(n, seed, frac=0.15):
    """16.16 reweights: most in, some out, some partially rejected."""
    rng = np.random.default_rng(seed)
    w = np.full(n, 0x10000, np.int32)
    pick = rng.random(n)
    w[pick < frac / 2] = 0
    w[(pick >= frac / 2) & (pick < frac)] = 0x6000
    return w


# ---------------------------------------------------------------------------
# the draw
# ---------------------------------------------------------------------------


def _test_weights():
    """Every distinct weight (choose_args sets included) of the maps
    these tests and test_torch_crush_slice build, plus the extremes."""
    ws = {1, 0x10000, 0xFFFFFFFF}
    for m in (_map(), _map(4, 3, 5), _map(5, 4, 3, cargs=True)):
        for b in m.buckets.values():
            ws.update(b.item_weights)
        for sets in m.choose_args.values():
            for arg in sets.values():
                for row in arg.weight_sets:
                    ws.update(row)
    ws.discard(0)
    return sorted(ws)


def _divisor_weights():
    """Weights that divide some a = 2^48 - crush_ln(u) exactly: a(u)
    itself and a(u) / k for u near 0xFFFF, where a < 2^32.  Only there
    can the float64 estimate a * (1/w) truncate below a / w (elsewhere
    a / w is at least 1/w from an integer, more than the product's
    error), so only there does the correction step act."""
    u = torch.arange(0xFF00, 0xFFFF, dtype=torch.int64)
    a = K.LN_ONE - K.crush_ln(u)
    a = a[(a > 0) & (a < 1 << 32)]
    ws = set(a.tolist())
    for k in (2, 3, 7):
        ws.update((a[a % k == 0] // k).tolist())
    return sorted(ws)


@pytest.mark.parametrize("weights", ["maps", "divisors"])
def test_draw_recip_plain_equals_div_s64(weights):
    """Every 16-bit hash against every distinct weight of the test maps
    (plus 1, 0x10000, 0xFFFFFFFF), and against weights that divide a
    draw's numerator, where the correction step is exercised."""
    ws = _test_weights() if weights == "maps" else _divisor_weights()
    u = torch.arange(65536, dtype=torch.int64)[:, None]
    a = K.LN_ONE - K.crush_ln(u)
    off = 0
    for lo in range(0, len(ws), 32):
        w = torch.tensor(ws[lo:lo + 32], dtype=torch.int64)[None, :]
        rcp = K.reciprocals(w)
        got = K.draw_recip_plain(u, w, rcp)
        want = K.div_s64(K.crush_ln(u) - K.LN_ONE, w)
        assert got.shape == (65536, w.shape[1])
        assert torch.equal(got, want)
        est = torch.trunc(a.to(torch.float64) * rcp).to(torch.int64)
        assert (est + want).abs().max() <= 1
        off += int((est != -want).sum())
    assert (off > 0) == (weights == "divisors")
    # a zero weight draws S64_MIN, as the host engine's straw2
    zero = torch.zeros((1, 1), dtype=torch.int64)
    assert (K.draw_recip_plain(u, zero, K.reciprocals(zero))
            == K.S64_MIN).all()
    # host engine's own draw on a sample
    for uu, ww in ((0, 1), (0xFFFF, 0xFFFFFFFF), (1234, 0x10000),
                   (40000, 0x18000)):
        x = K.draw_recip_plain(torch.tensor([uu]), torch.tensor([ww]),
                               K.reciprocals(torch.tensor([ww])))
        assert int(x) == RH._div_s64(RH.crush_ln(uu) - (1 << 48), ww)


def test_tables_hold_the_reciprocals_and_packed_rows():
    m = _map(5, 4, 3, cargs=True)
    t = PD.DeviceMapper(_port(m), "opt", device="cpu").fm.tables
    assert torch.equal(t.rcp, K.reciprocals(t.weights))
    assert t.rcp.dtype == torch.float64
    raw = t.packed.numpy().tobytes()
    assert len(raw) % 16 == 0
    N, B, P = t.N, t.B, t.n_pos
    assert N == int(t.size.sum())
    at = 0

    def take(dt, count):
        nonlocal at
        a = np.frombuffer(raw, dt, count, at)
        at += a.nbytes
        return a

    rcp = take(np.float64, P * N).reshape(P, N)
    w = take(np.uint32, P * N).reshape(P, N)
    items, ids = take(np.int32, N), take(np.int32, N)
    off, btype = take(np.int32, B + 1), take(np.int32, B)
    keep = (np.arange(t.S)[None, :] < t.size.numpy()[:, None])
    assert np.array_equal(w, t.weights.numpy()[:, keep])
    assert np.array_equal(rcp, t.rcp.numpy()[:, keep])
    assert np.array_equal(items, t.items.numpy()[keep])
    assert np.array_equal(ids, t.ids.numpy()[keep])
    assert np.array_equal(np.diff(off), t.size.numpy())
    assert np.array_equal(btype, t.btype.numpy())


# ---------------------------------------------------------------------------
# choose_plain
# ---------------------------------------------------------------------------


# (name, map kwargs, tunables, ruleno, rmax, choose_args, reweight seed,
# also against the JAX reference)
_CASES = [
    ("leaf_firstn", {}, {}, 0, 3, False, 1, True),
    ("leaf_indep", {}, {}, 1, 4, False, 2, True),
    ("choose_firstn_osds", {}, {}, 2, 3, False, 3, False),
    ("choose_indep_hosts", {}, {}, 3, 5, False, 4, False),
    ("leaf_firstn_more_than_hosts", {}, {}, 0, 7, False, 5, False),
    ("leaf_indep_more_than_hosts", {}, {}, 1, 7, False, 6, False),
    ("leaf_to_osd_type0", {}, {}, 4, 3, False, 7, False),
    ("leaf_tries_3", {}, {}, 5, 3, False, 8, True),
    ("vary_r_0_stable_0", {}, {"chooseleaf_vary_r": 0,
                               "chooseleaf_stable": 0}, 0, 4, False, 9,
     False),
    ("vary_r_2", {}, {"chooseleaf_vary_r": 2}, 0, 4, False, 10, False),
    ("descend_once_0", {}, {"chooseleaf_descend_once": 0,
                            "choose_total_tries": 7}, 0, 3, False, 11,
     False),
    ("choose_args_firstn", {"seed": 3, "cargs": True}, {}, 0, 3, True, 12,
     True),
    ("choose_args_indep", {"seed": 3, "cargs": True}, {}, 1, 4, True, 13,
     False),
    ("crowded_firstn", {"hosts": 4, "per_host": 3, "seed": 5}, {}, 0, 4,
     False, 14, True),
    ("crowded_indep", {"hosts": 4, "per_host": 3, "seed": 5}, {}, 1, 4,
     False, 15, True),
    # wider than the 16 slots the choose kernel once held in registers
    ("wide_indep_20", {"hosts": 24, "per_host": 2, "seed": 7}, {}, 1, 20,
     False, 16, False),
    ("wide_firstn_20", {"hosts": 24, "per_host": 2, "seed": 7}, {}, 0, 20,
     False, 17, False),
]


@pytest.mark.parametrize("name,kw,tun,ruleno,rmax,cargs,wseed,ref",
                         _CASES, ids=[c[0] for c in _CASES])
def test_choose_plain_matches_reference_and_host(name, kw, tun, ruleno,
                                                 rmax, cargs, wseed, ref):
    m = _map(**kw)
    for k, v in tun.items():
        setattr(m.tunables, k, v)
    cname = "opt" if cargs else None
    n_osd = m.max_devices
    w = _weights(n_osd, wseed)
    xs = (np.arange(300, dtype=np.int64) * 2654435761 + wseed) % (1 << 32)
    dm = PD.DeviceMapper(_port(m), cname, device="cpu")
    got = dm.do_rule_batch(ruleno, xs, rmax, w)
    cmap = m.choose_args.get("opt") if cargs else None
    assert np.array_equal(got, _host_rows(m, ruleno, xs, rmax, w, cmap))
    if ref:
        assert np.array_equal(
            got, RefMapper(m, cname).do_rule_batch(ruleno, xs, rmax, w))
    assert (got != NONE).any()


def test_crowded_map_needs_many_retries():
    """On 4 hosts x 3 OSDs a size-4 firstn pool places its last replica
    on the one host left: many lanes need more than three attempts for
    it (more than three retries in all), which the per-lane retry loop
    takes to their end."""
    m = _map(4, 3, 5)
    calls = {}
    orig = RH.Mapper._straw2_choose

    def counting(self, b, x, r, arg, position):
        if b.id == -1:
            calls[x] = calls.get(x, 0) + 1
        return orig(self, b, x, r, arg, position)

    xs = (np.arange(300, dtype=np.int64) * 2654435761) % (1 << 32)
    w = np.full(12, 0x10000, np.int32)
    RH.Mapper._straw2_choose = counting
    try:
        want = _host_rows(m, 0, xs, 4, w)
    finally:
        RH.Mapper._straw2_choose = orig
    # 4 replicas; more than 3 extra root draws means retries past the
    # reference's three optimistic attempts
    assert sum(calls[int(x)] > 4 + 3 for x in xs) > 30
    dm = PD.DeviceMapper(_port(m), device="cpu")
    assert np.array_equal(dm.do_rule_batch(0, xs, 4, w), want)


@pytest.mark.parametrize("ruleno,rmax", [(0, 3), (1, 4)])
def test_choose_plain_counts_the_draws_it_needs(ruleno, rmax):
    """The draw count behind K4's operation bound equals the straw2
    items of nonzero weight the host engine draws for the same
    inputs."""
    m = _map()
    drawn = [0]
    orig = RH.Mapper._straw2_choose

    def counting(self, b, x, r, arg, position):
        drawn[0] += sum(1 for v in b.item_weights if v)
        return orig(self, b, x, r, arg, position)

    xs = (np.arange(200, dtype=np.int64) * 40503) % (1 << 32)
    w = _weights(m.max_devices, 21)
    RH.Mapper._straw2_choose = counting
    try:
        want = _host_rows(m, ruleno, xs, rmax, w)
    finally:
        RH.Mapper._straw2_choose = orig
    dm = PD.DeviceMapper(_port(m), device="cpu")
    rows, draws = K.choose_plain(dm.fm.tables, dm._plan(ruleno, rmax),
                                 torch.from_numpy(xs),
                                 torch.from_numpy(w), count_draws=True)
    assert np.array_equal(rows.numpy(), want)
    assert draws == drawn[0]


def test_choose_rejects_plans_the_kernel_cannot_hold(monkeypatch):
    """Deeper descents than the launch parameters hold raise, and so
    does a map asked into shared memory that does not fit there; any
    row width maps."""
    m = _map()
    dm = PD.DeviceMapper(_port(m), device="cpu")
    xs = torch.zeros(4, dtype=torch.int64)
    w = torch.full((30,), 0x10000, dtype=torch.int32)
    p = dm._plan(0, 3)
    deep = K.ChoosePlan(**{k: getattr(p, k) for k in K.ChoosePlan.__slots__})
    deep.outer_ds = (1,) * (K.MAX_LEVELS + 1)
    with pytest.raises(ValueError, match="levels"):
        K.choose(dm.fm.tables, deep, xs, w)
    assert K.choose(dm.fm.tables, dm._plan(1, 40), xs, w).shape == (4, 40)
    monkeypatch.setattr(K, "CHOOSE_SMEM_MAX", K.LN_BYTES)
    with pytest.raises(ValueError, match="shared memory"):
        K.choose(dm.fm.tables, p, xs, w, staged=True)
    assert K.choose(dm.fm.tables, p, xs, w).shape == (4, 3)
