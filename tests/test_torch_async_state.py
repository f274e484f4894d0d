"""The buffered-async server's host logic in the port (``plan_flushes``,
``AsyncServerState``) against the JAX reference's, on the same arrival
sequences drawn from numpy seeds as ``tests/test_async_state_properties.py``
draws them: the same flush groups, staleness, versions, clocks, evictions
and buffer order, exactly.  Then the reference's invariants on the port
(exactly-once delivery, conservation of total weight, ``evict_stale``'s
exact boundary, other stages' entries held verbatim), the checkpoint seam
(``state_dict`` in the reference's format and layout, refusing an
unmaterialised delta; ``from_state_dict`` back, each delta in storage of
its own) and the bridge's stacked trees (``lead=1``)."""
import json

import numpy as np
import pytest
import torch

from repro.federated import runtime as rrt
from repro_torch import bridge
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.federated import runtime as trt

SEEDS = range(12)


def _draw(seed):
    """Rounds of arrival offsets (0-6 a round, some tied), a buffer size,
    a stage per round, and per round a ``max_staleness`` cap or None."""
    g = np.random.default_rng(seed)
    n_rounds = int(g.integers(1, 7))
    rounds = []
    for _ in range(n_rounds):
        times = np.round(g.uniform(0.1, 50.0, int(g.integers(0, 7))), 1)
        if times.size > 1 and g.random() < 0.3:
            times[-1] = times[0]                   # a tie
        rounds.append(times.tolist())
    caps = [None if g.random() < 0.6 else int(g.integers(0, 3))
            for _ in range(n_rounds)]
    return (rounds, int(g.integers(0, 5)),
            g.integers(0, 2, n_rounds).tolist(), caps)


def _entries(mod, state, uid0, times, stage, delta):
    return [mod.BufferEntry(delta=delta(uid0 + k), weight=1.0 + uid0 + k,
                            loss=0.0, pulled_version=state.version,
                            arrival_time=state.clock + dt, stage=stage,
                            cohort=uid0 + k)
            for k, dt in enumerate(times)]


def _flush_key(fl):
    return ([e.cohort for e in fl.entries], fl.staleness.tolist(),
            fl.version, fl.time)


def _buffer_key(state):
    return ([(e.cohort, e.stage, e.pulled_version, e.arrival_time)
             for e in state.entries], state.version, state.clock)


@pytest.mark.parametrize("seed", SEEDS)
def test_schedules_equal_the_reference(seed):
    rounds, K, stages, caps = _draw(seed)
    ref, port = rrt.AsyncServerState(), trt.AsyncServerState()
    uid = 0
    for times, stage, cap in zip(rounds, stages, caps):
        ev_r, ev_t = ref.evict_stale(cap), port.evict_stale(cap)
        assert [e.cohort for e in ev_r] == [e.cohort for e in ev_t]
        new_r = _entries(rrt, ref, uid, times, stage, lambda u: None)
        new_t = _entries(trt, port, uid, times, stage, lambda u: None)
        uid += len(times)
        fr, ft = ref.schedule(new_r, K, stage), port.schedule(new_t, K,
                                                                  stage)
        assert [_flush_key(f) for f in fr] == [_flush_key(f) for f in ft]
        assert _buffer_key(ref) == _buffer_key(port)
    dr, dt = ref.drop_retired_stages(1), port.drop_retired_stages(1)
    assert [e.cohort for e in dr] == [e.cohort for e in dt]
    assert _buffer_key(ref) == _buffer_key(port)


@pytest.mark.parametrize("seed", SEEDS)
def test_exactly_once_version_staleness_and_weight(seed):
    """Every delivery flushed once or still pending, each flush one
    version, staleness the versions since the entry's pull, arrival order
    within a flush, the clock monotone and the total weight conserved."""
    rounds, K, stages, _ = _draw(seed)
    state = trt.AsyncServerState()
    delivered, flushed, uid = [], [], 0
    for times, stage in zip(rounds, stages):
        clock = state.clock
        new = _entries(trt, state, uid, times, stage, lambda u: None)
        uid += len(times)
        delivered.extend(new)
        v0 = state.version
        flushes = state.schedule(new, K, stage)
        assert state.version == v0 + len(flushes)
        for j, fl in enumerate(flushes):
            assert fl.version == v0 + j
            ts = [e.arrival_time for e in fl.entries]
            assert ts == sorted(ts) and fl.time == ts[-1]
            for e, s in zip(fl.entries, fl.staleness):
                assert e.stage == stage and s == fl.version - e.pulled_version
            if K > 0:
                assert len(fl.entries) == K
            flushed.extend(fl.entries)
        assert state.clock >= clock
        assert not {id(e) for e in state.entries} & {id(e) for e in flushed}
        total = sum(e.weight for e in delivered)
        np.testing.assert_allclose(
            sum(e.weight for e in flushed)
            + sum(e.weight for e in state.entries), total, rtol=1e-12)
    assert len({id(e) for e in flushed}) == len(flushed)
    assert sorted(map(id, flushed + state.entries)) == sorted(
        map(id, delivered))


@pytest.mark.parametrize("version,cap", [(v, c) for v in (0, 3, 6)
                                         for c in (0, 1, 3)])
def test_evict_stale_is_the_references_exact_boundary(version, cap):
    def fill(mod):
        state = mod.AsyncServerState()
        state.version = version
        state.entries = [mod.BufferEntry(
            delta=None, weight=1.0, loss=0.0, pulled_version=v,
            arrival_time=0.0, stage=0, cohort=v) for v in range(version + 1)]
        return state

    ref, port = fill(rrt), fill(trt)
    assert port.evict_stale(None) == [] and len(port) == version + 1
    got = [e.cohort for e in port.evict_stale(cap)]
    assert got == [e.cohort for e in ref.evict_stale(cap)]
    assert all(version - v > cap for v in got)
    assert all(version - e.pulled_version <= cap for e in port.entries)


def test_schedule_holds_other_stage_entries_verbatim():
    state = trt.AsyncServerState()
    held = _entries(trt, state, 0, [5.0], 0, lambda u: None)[0]
    state.entries = [held]
    flushes = state.schedule(
        _entries(trt, state, 1, [1.0], 1, lambda u: None), 1, stage=1)
    assert [[e.cohort for e in f.entries] for f in flushes] == [[1]]
    assert state.entries == [held] and state.entries[0] is held
    fresh = trt.AsyncServerState()
    assert fresh.schedule([], 2, stage=0) == []
    assert (fresh.version, fresh.clock, len(fresh)) == (0, 0.0, 0)


@pytest.mark.parametrize("times,K", [
    ([4.0, 1.0, 2.5, 9.0, 3.0], 2), ([3.0, 1.0], 5), ([3.0, 1.0, 2.0], 0),
    ([1.0, 1.0, 1.0], 2), ([0.0], 1), ([2.0, 2.0, 1.0, 7.0, 7.0, 0.5], 4)])
def test_plan_flushes_equals_the_reference(times, K):
    ref, port = rrt.plan_flushes(times, K), trt.plan_flushes(times, K)
    assert [f.tolist() for f in port.flushes] == [f.tolist()
                                                  for f in ref.flushes]
    assert port.pending.tolist() == ref.pending.tolist()
    assert port.round_time == ref.round_time


@pytest.mark.parametrize("bad", [[], [1.0, -0.5], [[1.0, 2.0]]])
def test_plan_flushes_validates_as_the_reference(bad):
    with pytest.raises(ValueError):
        rrt.plan_flushes(bad, 2)
    with pytest.raises(ValueError):
        trt.plan_flushes(bad, 2)


def test_state_dict_refuses_an_unmaterialised_delta():
    state = trt.AsyncServerState()
    state.entries = [trt.BufferEntry(delta=None, weight=1.0, loss=0.0,
                                     pulled_version=0, arrival_time=0.0,
                                     stage=0, cohort=0)]
    with pytest.raises(ValueError, match="mid-round"):
        state.state_dict()


def _ref_delta(g):
    """A trainable-like delta tree in the reference's layout: a conv
    weight (HWIO) beside a head and a GroupNorm scale."""
    return {"conv": {"w": g.standard_normal((3, 3, 2, 5)).astype(np.float32),
                     "b": g.standard_normal(5).astype(np.float32)},
            "head": {"w": g.standard_normal((5, 4)).astype(np.float32)}}


def test_state_dict_is_the_references_and_restores_exactly():
    """The same buffer (two stages, interleaved) gives the reference's
    arrays and meta, to the bit and in its layout; ``from_state_dict`` of
    the reference's arrays gives back the port's entries, each delta in
    storage of its own."""
    g = np.random.default_rng(0)
    ref, port = rrt.AsyncServerState(), trt.AsyncServerState()
    for s in (ref, port):
        s.version, s.clock = 5, 12.5
    for k, stage in enumerate([1, 0, 1, 1, 0]):
        d = _ref_delta(g)
        common = dict(weight=1.5 + k, pulled_version=k, arrival_time=3.25 * k,
                      stage=stage, cohort=k)
        ref.entries.append(rrt.BufferEntry(
            delta=d, loss=np.float32(0.5 + k), **common))
        port.entries.append(trt.BufferEntry(
            delta=bridge.from_reference(d, "cpu"),
            loss=torch.tensor(0.5 + k), **common))
    ra, rm = ref.state_dict()
    ta, tm = port.state_dict()
    assert json.loads(json.dumps(tm)) == json.loads(json.dumps(rm))
    flat_r = _flat(ra)
    flat_t = _flat(ta)
    assert flat_r.keys() == flat_t.keys()
    for p, a in flat_r.items():
        b = flat_t[p].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b, err_msg=p)
    like = trt.AsyncServerState.arrays_like(
        _StageAdapter(port.entries), None, tm)
    assert {p: tuple(x.shape) for p, x in _flat(like).items()} == {
        p: a.shape for p, a in flat_r.items()}
    back = trt.AsyncServerState.from_state_dict(
        rm, tree_map(lambda a: torch.from_numpy(np.array(a)), ra), "cpu")
    assert (back.version, back.clock) == (5, 12.5)
    for e, f in zip(port.entries, back.entries, strict=True):
        assert (e.stage, e.weight, e.pulled_version, e.arrival_time,
                e.cohort) == (f.stage, f.weight, f.pulled_version,
                              f.arrival_time, f.cohort)
        assert torch.equal(e.loss, f.loss) and f.loss.dim() == 0
        for x, y in zip(tree_leaves(e.delta), tree_leaves(f.delta),
                        strict=True):
            assert torch.equal(x, y)
            assert y.untyped_storage().nbytes() == y.numel() * 4


class _StageAdapter:
    """``split_stage`` of a made-up model: every stage trains a tree
    shaped as the entries' deltas."""

    def __init__(self, entries):
        self.like = entries[0].delta

    def split_stage(self, params, t):
        return None, self.like


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree) if not torch.is_tensor(tree) else tree}


@pytest.mark.parametrize("lead", [0, 1, 2])
def test_bridge_permutes_a_stacked_conv_on_its_last_four_axes(lead):
    g = np.random.default_rng(lead)
    shape = (2, 3)[:lead] + (3, 3, 4, 6)
    tree = {"conv1": {"w": g.standard_normal(shape).astype(np.float32)},
            "wq": g.standard_normal(shape).astype(np.float32)}
    port = bridge.from_reference(tree, "cpu", lead=lead)
    entry = port["conv1"]["w"].reshape(-1, 6, 4, 3, 3)
    ref = tree["conv1"]["w"].reshape(-1, 3, 3, 4, 6)
    for i in range(entry.shape[0]):
        np.testing.assert_array_equal(
            entry[i].numpy(),
            bridge.from_reference({"conv1": {"w": ref[i]}},
                                  "cpu")["conv1"]["w"].numpy())
    # a 4-D leaf that is not a conv weight crosses unchanged
    np.testing.assert_array_equal(port["wq"].numpy(), tree["wq"])
    back = bridge.to_reference(port, lead=lead)
    for k in ("wq",):
        np.testing.assert_array_equal(back[k], tree[k])
    np.testing.assert_array_equal(back["conv1"]["w"], tree["conv1"]["w"])
