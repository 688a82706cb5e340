"""K4's pool form: the choose kernel hashing each lane's pps seed
(raw_pg_to_pps, osd_types.cc:1815-1831) itself from the pool's
arguments (``kernels.PpsSeeds``) in place of a seed pass before it.

Every case holds a pool pass (``DeviceMapper.map_pool_state``, in
chunks where the case sets a small ``CHUNK``), ``MapState.remap``'s
index-array form (``_settle``) and the primary-affinity form's seeds
(``xs_out``) to K4's explicit-input route fed with the reference's
seeds, and those seeds to the JAX package's ``pps_seed_v``.  Every
value is an integer, so every comparison is exact.  The cases run on
the CPU route (the plain versions) always and on the card where there
is one.  The card's machine has no JAX: there the seeds come from the
port's copy of ``pps_seed_v``, which ``test_the_port_copies_the_
reference_seed`` holds to the JAX package's.
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.models.crushmap import (CHOOSELEAF_FIRSTN,
                                            CHOOSELEAF_INDEP, EMIT, STRAW2,
                                            TAKE, CrushMap)
from ceph_tpu_torch.ops.crush import device as D
from ceph_tpu_torch.ops.crush import kernels as K
from ceph_tpu_torch.ops.crush.hashes import pps_seed_v as port_pps_seed_v

torch.set_num_threads(1)

N_OSDS = 30


def _mask(pgp_num: int) -> int:
    """pg_pool_t's pgp_num_mask: the next power of two less one."""
    return (1 << (pgp_num - 1).bit_length()) - 1


# name -> pool (pg_num, pgp_num, pool_id, hashpspool), rule, form; the
# form "chunks" maps with CHUNK 16, "settle" remaps after a reweight
# decrease, "affinity" maps with primary affinities
CASES = {
    "fold": ((48, 40, 3, True), 0, "pass"),
    "pgp-is-pg": ((64, 64, 1, True), 0, "pass"),
    "no-hashpspool": ((48, 40, 7, False), 0, "pass"),
    "pool-2^31": ((40, 40, 2**31 + 9, True), 0, "pass"),
    "pool-wraps": ((40, 36, 2**32 - 20, False), 1, "pass"),
    "chunks": ((48, 40, 5, True), 0, "chunks"),
    "chunks-indep": ((40, 33, 2**31, True), 1, "chunks"),
    "settle": ((64, 48, 2, True), 0, "settle"),
    "affinity": ((48, 40, 4, True), 0, "affinity"),
}


def _crushmap() -> CrushMap:
    """6 straw2 hosts of 5 OSDs under a straw2 root; rule 0 chooseleaf
    firstn host, rule 1 chooseleaf indep host."""
    m = CrushMap()
    hosts = [m.add_bucket(STRAW2, 1, list(range(5 * h, 5 * h + 5)),
                          [0x10000, 0x8000, 0x10000, 0x18000, 0x10000],
                          id=-(h + 2)).id for h in range(6)]
    m.add_bucket(STRAW2, 2, hosts, [0x50000] * 6, id=-1)
    m.add_rule([(TAKE, -1, 0), (CHOOSELEAF_FIRSTN, 0, 1), (EMIT, 0, 0)],
               id=0)
    m.add_rule([(TAKE, -1, 0), (CHOOSELEAF_INDEP, 0, 1), (EMIT, 0, 0)],
               id=1)
    return m


def _state():
    w = np.full(N_OSDS, 0x10000, np.int32)
    w[[4, 21]] = 0x9000
    w[13] = 0
    exists = np.ones(N_OSDS, bool)
    isup = np.ones(N_OSDS, bool)
    isup[[7, 26]] = False
    aff = np.full(N_OSDS, 0x10000, np.int32)
    aff[[0, 5, 11, 16]] = [0, 0x4000, 0x8000, 0xC000]
    return w, exists, isup, aff


def _pps_reference(route: str):
    if route == "cpu":
        # the JAX package's host reference (numpy; its import loads JAX)
        from ceph_tpu.ops.crush.hashes import pps_seed_v
        return pps_seed_v
    return port_pps_seed_v


@pytest.fixture
def dev(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device(request.param)


ROUTES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _expected(dm, rule, seeds, w, keep, aff):
    """K4's explicit-input route and the post filter, fed the seeds."""
    xs = torch.from_numpy(seeds).to(dm.device)
    raw = K.choose(dm.fm.tables, dm._plan(rule, 3), xs,
                   torch.from_numpy(w).to(dm.device))
    up, prim = D._post_process(
        raw, xs, torch.from_numpy(keep).to(dm.device),
        None if aff is None else torch.from_numpy(aff).to(dm.device), True)
    return raw, up, prim


def _same(state, want):
    for got, exp in zip((state.raw, state.up, state.prim), want):
        assert torch.equal(got, exp)


@pytest.mark.parametrize("dev", ROUTES, indirect=True)
@pytest.mark.parametrize("case", list(CASES))
def test_k4_hashes_the_pps_seeds(case, dev):
    (pg_num, pgp_num, pool_id, hashps), rule, form = CASES[case]
    mask = _mask(pgp_num)
    seeds = _pps_reference(dev.type)(np.arange(pg_num), pgp_num, mask,
                                     pool_id, hashps) & K.M32
    dm = D.DeviceMapper(_crushmap(), device=dev)
    if form == "chunks":
        dm.CHUNK = 16
    w, exists, isup, aff = _state()
    aff = aff if form == "affinity" else None
    keep = exists & isup
    args = (rule, 3, pg_num, pgp_num, mask, pool_id, hashps)
    if form == "settle":
        # a reweight decrease: remap recomputes the touched lanes alone
        w0 = w.copy()
        w[[2, 9, 23]] = 0x4000
        state = dm.map_pool_state(*args, w0, exists, isup).remap(
            w, exists, isup)
        assert 0 < state.recomputed < pg_num
    else:
        state = dm.map_pool_state(*args, w, exists, isup, aff)
    _same(state, _expected(dm, rule, seeds, w, keep, aff))

    # the index-array form on lanes out of order, its seeds kept
    lanes = torch.from_numpy(
        np.random.default_rng(pg_num).permutation(pg_num)[:pg_num - 5]
    ).to(dev)
    out = torch.full((lanes.shape[0],), -1, dtype=torch.int64, device=dev)
    got = K.choose(dm.fm.tables, dm._plan(rule, 3), None,
                   torch.from_numpy(w).to(dev),
                   pps=K.PpsSeeds(pgp_num, mask, pool_id, hashps,
                                  lanes=lanes), xs_out=out)
    want = torch.from_numpy(seeds).to(dev)[lanes]
    assert torch.equal(out, want)
    assert torch.equal(got, K.choose(dm.fm.tables, dm._plan(rule, 3),
                                     want, torch.from_numpy(w).to(dev)))


@pytest.mark.parametrize("case", list(CASES))
def test_the_port_copies_the_reference_seed(case):
    from ceph_tpu.ops.crush.hashes import pps_seed_v
    (pg_num, pgp_num, pool_id, hashps), _rule, _form = CASES[case]
    ps = np.arange(2 * pg_num)
    args = (pgp_num, _mask(pgp_num), pool_id, hashps)
    want = pps_seed_v(ps, *args) & K.M32
    assert np.array_equal(port_pps_seed_v(ps, *args) & K.M32, want)
    assert np.array_equal(K.pps_seed(torch.from_numpy(ps), *args).numpy(),
                          want)


def test_the_pool_form_checks_its_arguments():
    dm = D.DeviceMapper(_crushmap(), device="cpu")
    t, p = dm.fm.tables, dm._plan(0, 3)
    w = torch.full((N_OSDS,), 0x10000, dtype=torch.int32)
    x = torch.zeros(4, dtype=torch.int64)
    pps = K.PpsSeeds(40, 63, 1, True, base=0, count=4)
    with pytest.raises(ValueError, match="either"):
        K.choose(t, p, None, w)
    with pytest.raises(ValueError, match="either"):
        K.choose(t, p, x, w, pps=pps)
    with pytest.raises(ValueError, match="xs_out"):
        K.choose(t, p, x, w, xs_out=x.clone())
    with pytest.raises(ValueError, match="xs_out"):
        K.choose(t, p, None, w, pps=pps, xs_out=x[:3].clone())
    with pytest.raises(TypeError):
        K.choose(t, p, None, w, pps=pps._replace(lanes=x.to(torch.int32)))
    with pytest.raises(ValueError, match="pps lanes"):
        K.choose(t, p, None, w, pps=pps._replace(count=-1))
    empty = K.choose(t, p, None, w, pps=pps._replace(count=0))
    assert empty.shape == (0, 3)


@pytest.mark.parametrize("rule", [0, 1])
def test_the_plain_version_takes_the_pool_form(rule):
    """choose_plain takes pps arguments and a seed buffer as K4 does:
    the same rows and draws as for the seeds given as inputs."""
    dm = D.DeviceMapper(_crushmap(), device="cpu")
    t, p = dm.fm.tables, dm._plan(rule, 3)
    w = torch.from_numpy(_state()[0])
    lanes = torch.tensor([37, 2, 50, 9, 41], dtype=torch.int64)
    seeds = K.pps_seed(lanes, 40, 63, 8, True)
    want = K.choose_plain(t, p, seeds, w, count_draws=True)
    for pps in (K.PpsSeeds(40, 63, 8, True, lanes=lanes),
                K.PpsSeeds(40, 63, 8, True, base=37, count=1)):
        out = torch.full((pps.count or lanes.shape[0],), -1,
                         dtype=torch.int64)
        rows, draws = K.choose_plain(t, p, None, w, True, pps=pps,
                                     xs_out=out)
        n = out.shape[0]
        assert torch.equal(out, seeds[:n])
        assert torch.equal(rows, want[0][:n])
        assert draws == (want[1] if n == lanes.shape[0]
                         else K.choose_plain(t, p, seeds[:1], w, True)[1])


def test_the_smoke_plain_route_runs_pool_passes():
    """chip_smoke's plain_kernels, which swaps K4 for choose_plain around
    whole passes on the card, runs a pool pass (the affinity form, its
    seeds kept) and its remap with the same rows as the wrappers."""
    import chip_smoke
    dm = D.DeviceMapper(_crushmap(), device="cpu")
    dm.CHUNK = 16
    w, exists, isup, aff = _state()
    w2 = w.copy()
    w2[[2, 9, 23]] = 0x4000
    args = (0, 3, 48, 40, 63, 3, True)
    want = dm.map_pool_state(*args, w, exists, isup, aff)
    want2 = want.remap(w2, exists, isup, aff)
    assert want2.recomputed > 0
    with chip_smoke.plain_kernels(K) as plain:
        got = dm.map_pool_state(*args, w, exists, isup, aff)
        got2 = got.remap(w2, exists, isup, aff)
    assert K.choose is not plain._choose and plain.draws > 0
    _same(got, (want.raw, want.up, want.prim))
    _same(got2, (want2.raw, want2.up, want2.prim))


def test_off_the_cpu_the_pool_form_reaches_only_k4(monkeypatch):
    """Off the CPU the pool form launches K4 or raises: neither the plain
    seeds nor the plain choose are reached.  (Here the build has no
    nvcc, so it raises, and nothing counts as launched.)"""
    def boom(*a, **kw):
        raise AssertionError("plain version reached off the CPU")

    for name in ("choose_plain", "pps_seed", "hash32_2"):
        monkeypatch.setattr(K, name, boom)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    K._build.library.cache_clear()
    monkeypatch.setattr(K._build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(K._build, "BUILD_DIR", K._build.BUILD_DIR / "none")
    meta = torch.device("meta")
    dm = D.DeviceMapper(_crushmap(), device="cpu")
    fm = dm.fm
    t = K.CrushTables(fm._items_np, fm._ids_np, fm._w_np, fm._size_np,
                      fm._btype_np, fm.max_devices, meta)
    p = dm._plan(0, 3)
    w = torch.empty(N_OSDS, dtype=torch.int32, device=meta)
    lanes = torch.empty(70, dtype=torch.int64, device=meta)
    before = dict(K.LAUNCHES)
    for pps, out in ((K.PpsSeeds(40, 63, 1, True, base=16, count=70), None),
                     (K.PpsSeeds(40, 63, 1, False, lanes=lanes),
                      torch.empty_like(lanes))):
        with pytest.raises(RuntimeError, match="nvcc"):
            K.choose(t, p, None, w, pps=pps, xs_out=out)
    assert K.LAUNCHES == before
    K._build.library.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("dev", ["cuda"], indirect=True)
def test_pool_passes_count_their_seeding_launches(dev):
    """On the card every K4 launch of a pool pass hashes its seeds
    (LAUNCHES["choose_pps"] rises with "choose"); do_rule_batch's
    explicit inputs do not count there."""
    dm = D.DeviceMapper(_crushmap(), device=dev)
    dm.CHUNK = 16
    w, exists, isup, _aff = _state()
    before = dict(K.LAUNCHES)
    dm.map_pool_state(0, 3, 48, 40, 63, 3, True, w, exists, isup)
    assert K.LAUNCHES["choose"] - before["choose"] == 3
    assert K.LAUNCHES["choose_pps"] - before["choose_pps"] == 3
    before = dict(K.LAUNCHES)
    rows = dm.do_rule_batch(0, np.arange(40), 3, w)
    assert rows.shape == (40, 3)
    assert K.LAUNCHES["choose"] - before["choose"] == 3
    assert K.LAUNCHES["choose_pps"] == before["choose_pps"]


@pytest.mark.cuda
@pytest.mark.parametrize("dev", ["cuda"], indirect=True)
def test_seeds_of_lanes_past_the_first_wave_on_card(dev):
    """A pass of more lanes than one wave of K4's resident threads holds,
    so lanes are handed out from its counter and hash their seeds where
    the kernel takes a new lane; firstn and indep, the seeds kept."""
    pg_num, pgp_num = (1 << 20) + 12345, (1 << 20) - 77
    mask = _mask(pgp_num)
    dm = D.DeviceMapper(_crushmap(), device=dev)
    w, exists, isup, aff = _state()
    seeds = port_pps_seed_v(np.arange(pg_num), pgp_num, mask, 6, True)
    want = torch.from_numpy(seeds & K.M32).to(dev)
    wt = torch.from_numpy(w).to(dev)
    for rule in (0, 1):
        p = dm._plan(rule, 3)
        out = torch.empty(pg_num, dtype=torch.int64, device=dev)
        got = K.choose(dm.fm.tables, p, None, wt, xs_out=out,
                       pps=K.PpsSeeds(pgp_num, mask, 6, True, count=pg_num))
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert torch.equal(got, K.choose(dm.fm.tables, p, want, wt))
    state = dm.map_pool_state(0, 3, pg_num, pgp_num, mask, 6, True, w,
                              exists, isup, aff)
    _same(state, _expected(dm, 0, seeds & K.M32, w, exists & isup, aff))
