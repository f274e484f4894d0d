"""The port's numpy-only copies of selection, the materialized fleet and
the aggregation helpers, against the JAX reference's on the same inputs.

Selection and the fleet must be byte-identical: the same cohorts, the
same policy state and the same RNG state after every call (the cases of
the reference's ``tests/test_selection.py`` and ``tests/test_fleet.py``,
run on both sides).  ``add``, ``delta``, ``staleness_discount`` and
``buffered_flush_average`` agree at rtol 1e-6.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.federated.aggregation as r_agg
import repro.federated.devices as r_dev
import repro.federated.selection as r_sel
import repro_torch.federated.aggregation as t_agg
import repro_torch.federated.devices as t_dev
import repro_torch.federated.selection as t_sel

FULL = 10_000_000


def _devices(mod, n=20, seed=0):
    return mod.sample_devices(seed, n, FULL)


def _rngs(seed=0):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _same_rng(a, b):
    assert a.bit_generator.state == b.bit_generator.state


def _ids(xs):
    return [int(x) for x in xs]


# --------------------------------------------------------------------------- #
# memory_feasible / random_select
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("req", [0, 200, 201, 1000, FULL // 3])
def test_memory_feasible_identical(req):
    small = [(0, 100, 1.0), (1, 200, 1.0), (2, 300, 1.0)]
    for profs in ([r_dev.DeviceProfile(*p) for p in small],
                  _devices(r_dev, 50)):
        t_profs = [t_dev.DeviceProfile(d.device_id, d.mem_bytes, d.speed)
                   for d in profs]
        assert (r_sel.memory_feasible(profs, req)
                == t_sel.memory_feasible(t_profs, req))


@pytest.mark.parametrize("cands,k", [(list(range(10)), 4), ([], 4),
                                     ([1, 2], 5), (list(range(50)), 50),
                                     ([7], 1)])
def test_random_select_identical(cands, k):
    ra, ta = _rngs(3)
    for _ in range(3):
        assert (_ids(r_sel.random_select(ra, cands, k))
                == _ids(t_sel.random_select(ta, cands, k)))
    _same_rng(ra, ta)


# --------------------------------------------------------------------------- #
# tifl_select and its credit contract
# --------------------------------------------------------------------------- #
def _tifl_both(n, cands_of, k, credits, calls=1, seed=0, n_tiers=5):
    r_devs, t_devs = _devices(r_dev, n), _devices(t_dev, n)
    rc = None if credits is None else dict(credits)
    tc = None if credits is None else dict(credits)
    ra, ta = _rngs(seed)
    outs = []
    for _ in range(calls):
        a = r_sel.tifl_select(ra, r_devs, cands_of(r_devs), k,
                              n_tiers=n_tiers, credits=rc)
        b = t_sel.tifl_select(ta, t_devs, cands_of(t_devs), k,
                              n_tiers=n_tiers, credits=tc)
        assert _ids(a) == _ids(b)
        assert rc == tc
        if tc is not None:
            assert all(v >= 0 for v in tc.values())
        outs.append(_ids(b))
    _same_rng(ra, ta)
    return outs, tc


def _all(devs):
    return [d.device_id for d in devs]


@pytest.mark.parametrize("case", ["empty_pool", "k0", "exhausted",
                                  "never_negative", "one_tier",
                                  "no_credits", "half_pool"])
def test_tifl_select_identical(case):
    if case == "empty_pool":
        outs, credits = _tifl_both(20, lambda d: [], 4, {t: 3 for t in
                                                        range(5)})
        assert outs == [[]] and credits == {t: 3 for t in range(5)}
    elif case == "k0":
        outs, credits = _tifl_both(20, _all, 0, {t: 3 for t in range(5)})
        assert outs == [[]] and credits == {t: 3 for t in range(5)}
    elif case == "exhausted":
        outs, _ = _tifl_both(20, _all, 4, {t: 0 for t in range(5)})
        assert outs[0]
    elif case == "never_negative":
        outs, credits = _tifl_both(20, _all, 3, {t: 1 for t in range(5)},
                                   calls=50)
        assert all(outs) and max(credits.values()) <= 1
    elif case == "one_tier":
        _tifl_both(20, _all, 3, {0: 2}, calls=5, n_tiers=1)
    elif case == "no_credits":
        _tifl_both(50, _all, 5, None, calls=5, seed=1)
    else:
        _tifl_both(40, lambda d: _all(d)[::2], 4, {t: 2 for t in range(5)},
                   calls=12, seed=2)


# --------------------------------------------------------------------------- #
# oort
# --------------------------------------------------------------------------- #
def _oort_states(**kw):
    return r_sel.OortState(**kw), t_sel.OortState(**kw)


@pytest.mark.parametrize("case", ["greedy", "staleness", "explore",
                                  "empty", "mixed"])
def test_oort_select_identical(case):
    n = 10 if case == "staleness" else 20
    r_devs, t_devs = _devices(r_dev, n), _devices(t_dev, n)
    cand = _all(r_devs)
    kw = {"greedy": dict(epsilon=0.0, t_desired=10.0),
          "staleness": dict(epsilon=0.0, t_desired=10.0),
          "explore": dict(epsilon=1.0), "empty": {},
          "mixed": dict(epsilon=0.3)}[case]
    rs, ts = _oort_states(**kw)
    seen = cand if case in ("greedy", "staleness") else cand[:5]
    loss0 = 1.0 if case == "staleness" else 0.1
    for c in seen:
        r_sel.oort_update(rs, c, loss0, 0)
        t_sel.oort_update(ts, c, loss0, 0)
    r_sel.oort_update(rs, 7, 50.0, 0)
    t_sel.oort_update(ts, 7, 50.0, 0)
    ra, ta = _rngs(0)
    picks = []
    for r in range(1, 6):
        cands = [] if case == "empty" else cand
        k = 9 if case == "staleness" else 4
        a = r_sel.oort_select(ra, r_devs, cands, k, rs, r)
        b = t_sel.oort_select(ta, t_devs, cands, k, ts, r)
        assert _ids(a) == _ids(b)
        picks.append(_ids(b))
        for c, loss in zip(b, np.linspace(0.5, 3.0, len(b))):
            r_sel.oort_update(rs, int(c), float(loss), r)
            t_sel.oort_update(ts, int(c), float(loss), r)
    assert vars(rs) == vars(ts)
    _same_rng(ra, ta)
    if case == "greedy":
        assert 7 in picks[0]
    if case == "empty":
        assert picks == [[]] * 5


# --------------------------------------------------------------------------- #
# policy classes over the streaming and the materialized fleet
# --------------------------------------------------------------------------- #
def _fleets(kind):
    if kind == "streaming":
        return r_dev.Fleet(0, 500, FULL), t_dev.Fleet(0, 500, FULL)
    return (r_dev.MaterializedFleet(_devices(r_dev, 60), FULL),
            t_dev.MaterializedFleet(_devices(t_dev, 60), FULL))


@pytest.mark.parametrize("kind", ["streaming", "materialized"])
@pytest.mark.parametrize("name", ["random", "tifl", "oort"])
def test_policies_identical(name, kind):
    rf, tf = _fleets(kind)
    rp, tp = r_sel.make_policy(name), t_sel.make_policy(name)
    ra, ta = _rngs(0)
    for r, req in enumerate([FULL // 2, FULL // 4, 0, FULL // 2, FULL,
                             FULL // 3]):
        a, na = rp.select(ra, rf, 8, req, r)
        b, nb = tp.select(ta, tf, 8, req, r)
        assert _ids(a) == _ids(b) and na == nb
        losses = np.linspace(1.0, 2.0, len(b))
        if len(b) > 1:
            losses[1] = np.nan
        rp.observe(a, losses, r)
        tp.observe(b, losses, r)
        assert rp.state_dict() == tp.state_dict()
    _same_rng(ra, ta)


@pytest.mark.parametrize("name", ["random", "tifl", "oort"])
def test_policy_state_dict_round_trip(name):
    """A policy's state crosses JSON and loads into a fresh port policy
    and into the reference's, both selecting on identically after."""
    rf, tf = _fleets("streaming")
    tp = t_sel.make_policy(name)
    ta = np.random.default_rng(5)
    for r in range(4):
        sel, _ = tp.select(ta, tf, 6, FULL // 3, r)
        tp.observe(sel, np.arange(len(sel), dtype=float) + r, r)
    state = json.loads(json.dumps(tp.state_dict()))
    t2, r2 = t_sel.make_policy(name), r_sel.make_policy(name)
    t2.load_state_dict(state)
    r2.load_state_dict(state)
    assert t2.state_dict() == tp.state_dict() == r2.state_dict()
    ra, tb = np.random.default_rng(9), np.random.default_rng(9)
    for r in range(4, 7):
        a, _ = r2.select(ra, rf, 6, FULL // 3, r)
        b, _ = t2.select(tb, tf, 6, FULL // 3, r)
        assert _ids(a) == _ids(b)


def test_make_policy_resolution():
    assert isinstance(t_sel.make_policy("random"), t_sel.RandomPolicy)
    assert isinstance(t_sel.make_policy("tifl"), t_sel.TiFLPolicy)
    assert isinstance(t_sel.make_policy("oort"), t_sel.OortPolicy)
    p = t_sel.OortPolicy(epsilon=0.5)
    assert t_sel.make_policy(p) is p
    with pytest.raises(ValueError, match="fedavg"):
        t_sel.make_policy("fedavg")
    with pytest.raises(ValueError):
        t_sel.make_policy(p, epsilon=0.1)
    with pytest.raises(ValueError, match="stateless"):
        t_sel.RandomPolicy().load_state_dict({"credits": {}})


def test_tifl_policy_infeasible_returns_empty():
    fleet = t_dev.Fleet(0, 1000, 1000)
    sel, n_feas = t_sel.TiFLPolicy().select(np.random.default_rng(0), fleet,
                                            8, 10 ** 9, 0)
    assert sel == [] and n_feas == 0


# --------------------------------------------------------------------------- #
# MaterializedFleet and sample_devices
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,n", [(0, 20), (3, 250), (7, 1)])
def test_sample_devices_identical(seed, n):
    a = r_dev.sample_devices(seed, n, FULL)
    b = t_dev.sample_devices(seed, n, FULL)
    assert [vars(d) for d in a] == [vars(d) for d in b]
    # a different model only rescales the budgets
    c = t_dev.sample_devices(seed, n, FULL // 2)
    assert [d.speed for d in c] == [d.speed for d in b]


@pytest.mark.parametrize("n,tiers", [(300, 5), (250, 5), (7, 5), (40, 3)])
def test_materialized_fleet_identical(n, tiers):
    rm = r_dev.MaterializedFleet(r_dev.Fleet(0, n, FULL).profiles(range(n)),
                                 full_model_bytes=FULL, n_tiers=tiers)
    tm = t_dev.MaterializedFleet(t_dev.Fleet(0, n, FULL).profiles(range(n)),
                                 full_model_bytes=FULL, n_tiers=tiers)
    ids = np.arange(n)
    for attr in ("tier_of", "speeds", "mem_bytes"):
        x, y = getattr(rm, attr)(ids), getattr(tm, attr)(ids)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    for attr in ("tier_fracs", "tier_mem_frac", "tier_speed"):
        assert getattr(rm, attr).tobytes() == getattr(tm, attr).tobytes()
    assert rm.full_model_bytes == tm.full_model_bytes
    for req in (0, FULL // 4, FULL // 2, FULL):
        assert (rm.tier_feasible_prob(req).tobytes()
                == tm.tier_feasible_prob(req).tobytes())
        assert rm.feasible_count(req) == tm.feasible_count(req)
        for tier in (None, 0, tiers - 1):
            ra, ta = _rngs(3)
            assert (rm.sample_cohort(ra, 12, req, tier=tier)
                    == tm.sample_cohort(ta, 12, req, tier=tier))
            _same_rng(ra, ta)
    # the streaming fleet's cohorts, as in the reference
    f = t_dev.Fleet(0, n, FULL)
    assert (f.sample_cohort(np.random.default_rng(3), 12, FULL // 2)
            == tm.sample_cohort(np.random.default_rng(3), 12, FULL // 2))


def test_materialized_fleet_rejects_gappy_ids():
    profs = [t_dev.DeviceProfile(device_id=i, mem_bytes=100, speed=1.0)
             for i in (0, 2, 3)]
    with pytest.raises(ValueError, match="contiguous"):
        t_dev.MaterializedFleet(profs)


# --------------------------------------------------------------------------- #
# aggregation helpers
# --------------------------------------------------------------------------- #
def _trees(seed, c=None):
    rng = np.random.default_rng(seed)
    lead = () if c is None else (c,)
    return {"a": rng.standard_normal((*lead, 3, 4)).astype(np.float32),
            "b": [rng.standard_normal((*lead, 5)).astype(np.float32)]}


def _close(port_tree, ref_tree):
    from repro_torch.common.tree import tree_leaves
    import jax
    for x, y in zip(tree_leaves(port_tree), jax.tree.leaves(ref_tree),
                    strict=True):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-7)


def _t(tree):
    from repro_torch.common.tree import tree_map
    return tree_map(torch.from_numpy, tree)


def _j(tree):
    import jax
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("scale", [1.0, -0.5, 3.0])
def test_add_and_delta(scale):
    a, b = _trees(0), _trees(1)
    _close(t_agg.delta(_t(a), _t(b)), r_agg.delta(_j(a), _j(b)))
    _close(t_agg.add(_t(a), _t(b), scale), r_agg.add(_j(a), _j(b), scale))


@pytest.mark.parametrize("schedule,alpha", [("constant", 0.5),
                                            ("polynomial", 0.5),
                                            ("polynomial", 1.3)])
def test_staleness_discount(schedule, alpha):
    s = [0, 1, 2, 5, 40]
    np.testing.assert_allclose(t_agg.staleness_discount(s, schedule, alpha),
                               r_agg.staleness_discount(s, schedule, alpha),
                               rtol=1e-6)
    with pytest.raises(ValueError):
        t_agg.staleness_discount([-1], schedule, alpha)
    with pytest.raises(ValueError, match="unknown"):
        t_agg.staleness_discount(s, "exponential")


@pytest.mark.parametrize("staleness", [[0, 0, 0, 0], [0, 1, 3, 7]])
def test_buffered_flush_average(staleness):
    deltas = _trees(2, c=4)
    w = [10.0, 3.0, 0.0, 7.0]
    t_up, t_d = t_agg.buffered_flush_average(_t(deltas), w, staleness,
                                             alpha=0.7)
    r_up, r_d = r_agg.buffered_flush_average(_j(deltas), w, staleness,
                                             alpha=0.7)
    np.testing.assert_allclose(t_d, r_d, rtol=1e-6)
    _close(t_up, r_up)
    with pytest.raises(ValueError):
        t_agg.buffered_flush_average(_t(deltas), w[:3], staleness)
    # discounts multiply the normalized weights, no renormalization
    _close(t_agg.stacked_weighted_average(_t(deltas), w, discounts=t_d),
           r_agg.stacked_weighted_average(_j(deltas), w, discounts=r_d))
