"""The port's buffered-async runtime (``AsyncBufferedRuntime``) against the
JAX reference's, and the reference's async invariants
(``tests/test_async_runtime.py``) on the port, at ``cnn_setup``'s sizes.

Rounds: the two runtimes from the same params through the bridge (the
reference's, each round), on the same stack and ``sim_times``, over three
rounds with a stage change and a straggler carried into a later flush;
each round's update at 1e-3 of its largest entry (the port's round bar,
``test_torch_vectorized.py``), the buffered deltas at 1e-3 of their
largest, staleness, versions and ``sim_round_time`` exactly.  K = C
against the port's vectorized round at the reference's own bar between
its runtimes (rtol 1e-4, atol 1e-5).  Servers: ``FLConfig(runtime=
"async")`` through both packages' servers with dropout; async checkpoints
(pending entries of two stages) across the packages both ways to the bit,
the next round at the round bar; a kill and resume within the port to the
bit.  One reference runtime serves every reference side, so that its
stage programs compile once (the servers' stacks have its shapes).
"""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.core import CurriculumHP as RHP
from repro.data import Batcher as RBatcher
from repro.data.loader import stack_round
from repro.federated import runtime as rrt
from repro.federated.devices import Fleet as RFleet
from repro.federated.server import FLConfig as RFLConfig
from repro.federated.server import NeuLiteServer as RServer
from repro.optim import sgd as r_sgd
from repro_torch import bridge
from repro_torch.common.tree import tree_leaves
from repro_torch.core.curriculum import CurriculumHP as THP
from repro_torch.core.progressive import make_adapter as t_make_adapter
from repro_torch.data.loader import truncate_step_mask
from repro_torch.federated import runtime as trt
from repro_torch.federated.devices import Fleet
from repro_torch.federated.server import FLConfig, NeuLiteServer
from repro_torch.models import cnn as t_cnn
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim.optimizers import sgd as t_sgd

CPU = torch.device("cpu")
TOL = 1e-3
SEQ_TOL = dict(rtol=1e-4, atol=1e-5)
ASYNC = dict(buffer_size=3, staleness_schedule="polynomial",
             staleness_alpha=0.5)
# the servers' fleet: every device fits both stages, so every round
# trains all 4 clients (the stacks keep the reference runtime's shapes)
FL = dict(n_devices=4, clients_per_round=4, local_epochs=1, batch_size=16,
          num_stages=2, seed=0, runtime="async", dropout_schedule="constant",
          dropout_rate=0.1, **ASYNC)
FLEET = (0, 4, 16_000_000)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh(batchers, seed=0):
    return [RBatcher(b.ds, b.bs, seed=seed + i, kind=b.kind)
            for i, b in enumerate(batchers)]


@pytest.fixture(scope="module")
def setup(cnn_setup):
    """(reference adapter, its params on the host, port adapter, the
    port's params through the bridge, client datasets, a 4-cohort
    stack)."""
    r_ad, r_params, batchers = cnn_setup
    t_ad = t_make_adapter(t_cnn.CNNConfig(
        name="r18", arch="resnet18", num_classes=4, image_size=8,
        width_mult=0.125), 2)
    r_params = jax.device_get(r_params)
    return (r_ad, r_params, t_ad, bridge.from_reference(r_params, "cpu"),
            [b.ds for b in batchers],
            stack_round(_fresh(batchers), range(4), local_epochs=1))


@pytest.fixture(scope="module")
def ref_runtime(setup):
    """The reference's async runtime (the server's optimizer and
    curriculum settings), shared so that it compiles each stage once."""
    return rrt.AsyncBufferedRuntime(
        setup[0], r_sgd(0.05, momentum=0.9, weight_decay=5e-4),
        RHP(mu=0.01), **ASYNC)


def _cohort_deltas(runtime, params, t, stack):
    """Each cohort's f32 delta from ``params`` through the reference
    runtime's compiled stage program."""
    frozen, trainable = runtime.adapter.split_stage(params, t)
    locals_, _ = runtime._program(t)(
        trainable, frozen, jax.tree.map(np.asarray, stack.batches),
        np.asarray(stack.step_mask))
    return jax.tree.map(lambda loc, b: np.asarray(loc, np.float32)
                        - np.asarray(b, np.float32)[None], locals_,
                        jax.device_get(trainable))


def _port(t_ad, **kw):
    return trt.AsyncBufferedRuntime(t_ad, t_sgd(0.05), THP(mu=0.01),
                                    CPU, **kw)


def _np(tree):
    return [np.asarray(a, np.float64) for a in jax.tree.leaves(tree)]


def _rel(got, want, start):
    """max |got - want| over the largest entry of want - start."""
    upd = [w - s for w, s in zip(want, start)]
    scale = max(float(np.abs(u).max()) for u in upd if u.size)
    assert scale > 0
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want)
               if g.size) / scale


def _assert_close(a, b, **tol):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **tol)


def _same_tree(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(tree_leaves(a), tree_leaves(b), strict=True))


# --------------------------------------------------------------------------- #
# rounds, port against reference
# --------------------------------------------------------------------------- #
# (stage, sim_times): the stage-0 straggler (cohort 3, arriving at 8)
# misses round 0's flush at 3 and flushes in round 2, two versions later,
# beside two fresh deliveries; round 1's stage-1 straggler stays pending
ROUNDS = [(0, [1.0, 2.0, 3.0, 8.0]), (1, [2.0, 1.0, 50.0, 3.0]),
          (0, [5.0, 4.0, 6.0, 7.0])]
WANT = [dict(staleness=[0, 0, 0, -1], n_uploads=3, n_carried=0,
             n_pending=1, server_version=1, sim_round_time=3.0),
        dict(staleness=[0, 0, -1, 0], n_uploads=3, n_carried=0,
             n_pending=2, server_version=2, sim_round_time=3.0),
        dict(staleness=[0, 0, -1, -1], n_uploads=3, n_carried=1,
             n_pending=3, server_version=3, sim_round_time=5.0)]


def test_rounds_match_the_reference(setup, ref_runtime):
    r_ad, r_params, t_ad, _, _, stack = setup
    ref_runtime.reset_state()
    port = _port(t_ad, **ASYNC)
    params = r_params
    for (t, sim), want in zip(ROUNDS, WANT):
        before = {id(e) for e in ref_runtime.state.entries}
        r_tr, rm = ref_runtime.run_stacked(params, t, stack, sim_times=sim)
        t_tr, tm = port.run_stacked(bridge.from_reference(params, "cpu"), t,
                                    stack, sim_times=sim)
        for m in (rm, tm):
            got = {k: m[k] for k in want}
            got["staleness"] = list(got["staleness"])
            assert got == want
        start = _np(r_ad.split_stage(params, t)[1])
        assert _rel(_np(bridge.to_reference(t_tr)), _np(r_tr), start) <= TOL
        r_loss, t_loss = float(rm["mean_local_loss"]), float(
            tm["mean_local_loss"])
        assert abs(t_loss - r_loss) <= TOL * abs(r_loss)
        np.testing.assert_allclose(np.asarray(tm["cohort_losses"]),
                                   np.asarray(rm["cohort_losses"]),
                                   rtol=TOL)
        # the pending buffers: the same entries; this round's new ones'
        # deltas (one cohort's training, not averaged) at 1e-3 of their
        # largest entry, or 10x the reference's own movement under a 1e-7
        # change of the round's params where that exceeds 1e-4
        assert ([(e.stage, e.cohort, e.pulled_version, e.arrival_time,
                  e.weight) for e in ref_runtime.state.entries]
                == [(e.stage, e.cohort, e.pulled_version, e.arrival_time,
                     e.weight) for e in port.state.entries])
        moved = _cohort_deltas(ref_runtime, jax.tree.map(
            lambda p: p * (1 + 1e-7), params), t, stack)
        for re, te in zip(ref_runtime.state.entries, port.state.entries):
            if id(re) in before:           # held in its own round
                continue
            want_d = _np(re.delta)
            scale = max(float(np.abs(d).max()) for d in want_d)
            sens = max(float(np.abs(m[re.cohort] - w).max()) for m, w in
                       zip(_np(moved), want_d)) / scale
            bar = max(TOL, 10 * sens) if sens > TOL / 10 else TOL
            got = max(float(np.abs(g - w).max()) for g, w in
                      zip(_np(bridge.to_reference(te.delta)), want_d))
            assert got <= bar * scale, (got / scale, sens)
        params = r_ad.merge_stage(params, r_tr, t)


# --------------------------------------------------------------------------- #
# the reference's invariants, on the port
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tx(tx_setup):
    """``tx_setup`` in the port: adapter, params through the bridge and a
    3-cohort stack."""
    adapter, params, batchers = tx_setup
    fields = {f.name: getattr(adapter.cfg, f.name)
              for f in dataclasses.fields(TModelConfig)
              if hasattr(adapter.cfg, f.name)}
    return (t_make_adapter(TModelConfig(**fields), 2),
            bridge.from_reference(jax.device_get(params), "cpu"),
            stack_round(_fresh(batchers), range(3), local_epochs=1))


@pytest.mark.parametrize("kind,t", [("cnn", 0), ("cnn", 1), ("tx", 0),
                                    ("tx", 1)])
def test_full_buffer_matches_vectorized(kind, t, setup, tx):
    """K = C on a fresh server: one flush at staleness 0, the vectorized
    round."""
    if kind == "cnn":
        t_ad, params, stack = setup[2], setup[3], setup[5]
        hp = THP(mu=0.01)
    else:
        (t_ad, params, stack), hp = tx, THP(mu=0.01, enabled=False)
    opt = t_sgd(0.05 if kind == "cnn" else 1e-3)
    vec = trt.VectorizedRuntime(t_ad, opt, hp, CPU)
    asy = trt.AsyncBufferedRuntime(t_ad, opt, hp, CPU, buffer_size=0)
    tr_v, m_v = vec.run_stacked(params, t, stack)
    tr_a, m_a = asy.run_stacked(params, t, stack)
    _assert_close(tr_a, tr_v, **SEQ_TOL)
    np.testing.assert_allclose(float(m_a["mean_local_loss"]),
                               float(m_v["mean_local_loss"]), rtol=1e-4)
    assert torch.equal(m_a["cohort_losses"], m_v["cohort_losses"])
    assert m_a["n_pending"] == 0 and m_a["server_version"] == 1
    assert (m_a["staleness"] == 0).all()


def test_straggler_never_moves_or_delays_its_round(setup):
    t_ad, params, stack = setup[2], setup[3], setup[5]
    a, b = _port(t_ad, buffer_size=3), _port(t_ad, buffer_size=3)
    tr_a, m_a = a.run_stacked(params, 0, stack, sim_times=[2, 1, 3, 50.0])
    tr_b, m_b = b.run_stacked(params, 0, stack, sim_times=[2, 1, 3, 500.0])
    assert _same_tree(tr_a, tr_b)
    assert m_a["sim_round_time"] == m_b["sim_round_time"] == 3.0
    assert m_a["staleness"].tolist() == [0, 0, 0, -1]
    assert len(a.state) == 1 and a.state.version == 1
    # the pending delta and loss hold their own bytes, not the (C, ...)
    # stack of the round's deltas
    e = a.state.entries[0]
    for x in tree_leaves(e.delta) + [e.loss]:
        assert x.untyped_storage().nbytes() == x.numel() * x.element_size()


def test_dead_cohorts_never_deliver(setup):
    """A cohort that crashed at step 0 takes no slot and no staleness
    level: K = 1 flushes the survivor alone, fresh, as the vectorized
    round weights it; with K = 2 a lone survivor waits and lands next
    round."""
    t_ad, params, stack = setup[2], setup[3], setup[5]
    faulted = truncate_step_mask(stack, [0, None, 0, 0])
    asy = _port(t_ad, buffer_size=1, staleness_alpha=1.0)
    tr_a, m_a = asy.run_stacked(params, 0, faulted,
                                sim_times=[0.0, 4.0, 0.0, 0.0])
    assert m_a["staleness"].tolist() == [-1, 0, -1, -1]
    assert m_a["n_uploads"] == 1 and m_a["n_pending"] == 0
    vec = trt.VectorizedRuntime(t_ad, t_sgd(0.05), THP(mu=0.01), CPU)
    _assert_close(tr_a, vec.run_stacked(params, 0, faulted)[0], **SEQ_TOL)

    asy = _port(t_ad, buffer_size=2)
    batchers = _batchers(setup)
    out = asy.run_round(params, 0, batchers, [0, 1, 2], 1,
                        faults=[0, 0, None])
    assert out.n_uploads == 0 and len(asy.state) == 1
    assert np.isnan(float(out.mean_loss)) and out.round_sim_time == 0.0
    assert _same_tree(out.params, params)
    out2 = asy.run_round(out.params, 0, batchers, [0, 1, 2], 1)
    assert out2.n_uploads == 4 and len(asy.state) == 0
    assert np.isfinite(float(out2.mean_loss))
    assert not _same_tree(out2.params, params)


def _batchers(setup):
    from repro_torch.data.loader import Batcher
    return [Batcher(ds, 16, seed=i, kind="image")
            for i, ds in enumerate(setup[4])]


def test_uploads_exclude_pending_and_other_stages_wait(setup):
    t_ad, params = setup[2], setup[3]
    batchers = _batchers(setup)
    asy = _port(t_ad, buffer_size=3)
    out = asy.run_round(params, 0, batchers, [0, 1, 2, 3], 1)
    assert out.n_uploads == 3 and len(asy.state) == 1
    assert out.sim_times == [float(n) for n in out.num_batches]
    held = asy.state.entries[0]
    out1 = asy.run_round(out.params, 1, batchers[:2], [0, 1], 1)
    assert out1.n_uploads == 0 and len(asy.state) == 3
    assert np.isnan(float(out1.mean_loss))
    assert _same_tree(out1.params, out.params)
    out2 = asy.run_round(out1.params, 0, batchers[:2], [0, 1], 1)
    assert out2.n_uploads == 3 and len(asy.state) == 2
    assert all(e.stage == 1 for e in asy.state.entries)
    assert held not in asy.state.entries


def test_max_staleness_evicts(setup):
    t_ad, params, stack = setup[2], setup[3], setup[5]
    asy = _port(t_ad, buffer_size=3, max_staleness=0)
    _, m1 = asy.run_stacked(params, 0, stack, sim_times=[1, 2, 3, 100.0])
    assert m1["n_pending"] == 1
    _, m2 = asy.run_stacked(params, 0, stack, sim_times=[200, 300, 400,
                                                         500.0])
    assert m2["n_evicted"] == 1 and m2["n_carried"] == 0
    assert m2["n_uploads"] == 3 and m2["n_pending"] == 1


def test_monotone_schedule_retires_stranded_stages(setup):
    flc = FLConfig(**dict(FL, clients_per_round=3, buffer_size=4,
                          dropout_rate=0.0), co_adaptation=False,
                   rounds_per_stage=1)
    srv = NeuLiteServer(setup[2], setup[4], flc, fleet=Fleet(*FLEET),
                        params=setup[3], device="cpu")
    assert not srv.schedule.revisits_stages
    srv.run(1)
    assert [e.stage for e in srv.runtime.state.entries] == [0] * 3
    srv.run(2)
    assert all(e.stage >= 1 for e in srv.runtime.state.entries)


def test_refusals(setup):
    t_ad, params, stack = setup[2], setup[3], setup[5]
    zero = dataclasses.replace(stack, weights=np.zeros_like(stack.weights))
    with pytest.raises(ValueError, match="zero total"):
        _port(t_ad).run_stacked(params, 0, zero)
    with pytest.raises(ValueError, match="staleness schedule"):
        _port(t_ad, staleness_schedule="warp")
    # the mesh is ported: model_parallel=2 runs on the sharded runtime's
    # mesh (in one process clamped to 1, with the reference's warning); an
    # explicit mesh that contradicts model_parallel raises as there
    with pytest.warns(UserWarning, match="clamping to 1"):
        on_mesh = _port(t_ad, model_parallel=2)
    assert on_mesh.mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="contradicts the explicit mesh"):
        _port(t_ad, model_parallel=2, mesh=SimpleNamespace(
            axis_names=("data", "model"), shape={"data": 1, "model": 4}))
    with pytest.warns(UserWarning, match="clamping to 1"):
        srv = NeuLiteServer(t_ad, setup[4], FLConfig(**FL, model_parallel=2),
                            params=params, device="cpu")
    assert srv.runtime.model_shards == 1
    assert isinstance(trt.make_runtime("sharded", t_ad, None, None, CPU),
                      trt.ShardedRuntime)
    built = _port(t_ad)
    assert trt.make_runtime(built, t_ad, None, None, CPU) is built
    with pytest.raises(ValueError, match="AND constructor kwargs"):
        trt.make_runtime(built, t_ad, None, None, CPU, buffer_size=2)


def test_all_dropped_round_is_lost_but_safe(setup):
    t_ad, params = setup[2], setup[3]
    asy = _port(t_ad, buffer_size=2)
    out = asy.run_round(params, 0, _batchers(setup), [0, 1, 2], 1,
                        faults=[0, 0, 0])
    assert _same_tree(out.params, params)
    assert np.isnan(float(out.mean_loss)) and out.num_batches == [0, 0, 0]
    assert out.round_sim_time == 0.0 and out.sim_times == [0.0] * 3
    assert len(asy.state) == 0 and asy.state.version == 0


# --------------------------------------------------------------------------- #
# the servers and their checkpoints
# --------------------------------------------------------------------------- #
ROUNDS_RUN = 3


@pytest.fixture(scope="module")
def servers(setup, ref_runtime, tmp_path_factory):
    """Both packages' async servers from the same params over the same
    fleet, ``ROUNDS_RUN`` rounds each with dropout; the reference's state
    saved after them (its path), and both servers' params after the
    rounds but the last."""
    r_ad, r_params, t_ad, t_params, clients, _ = setup
    ref_runtime.reset_state()
    ref_runtime.client_speeds = None
    ref = RServer(r_ad, clients, RFLConfig(**FL), runtime=ref_runtime,
                  fleet=RFleet(*FLEET))
    port = NeuLiteServer(t_ad, clients, FLConfig(**FL), fleet=Fleet(*FLEET),
                         params=t_params, device="cpu")
    assert isinstance(port.runtime, trt.AsyncBufferedRuntime)
    assert port.runtime.client_speeds is port.fleet
    ref.run(ROUNDS_RUN - 1)
    port.run(ROUNDS_RUN - 1)
    before_last = (jax.device_get(ref.params),
                   bridge.to_reference(port.params))
    ref.run(1)
    port.run(1)
    path = ref.save_state(str(tmp_path_factory.mktemp("ref_async")))
    return ref, port, path, jax.device_get(ref.params), before_last


def _history_agrees(ref_hist, port_hist):
    for rh, th in zip(ref_hist, port_hist, strict=True):
        assert (rh.stage, rh.n_selected, rh.n_feasible, rh.upload_bytes,
                rh.server_version, rh.sim_time) == (
            th.stage, th.n_selected, th.n_feasible, th.upload_bytes,
            th.server_version, th.sim_time)
        if np.isnan(rh.mean_loss):
            assert np.isnan(th.mean_loss)
        else:
            assert abs(th.mean_loss - rh.mean_loss) <= TOL * abs(
                rh.mean_loss)


def test_server_rounds_match_the_reference(setup, servers):
    """The rounds' cohorts, uploads, versions and simulated times exactly,
    losses at 1e-3, the params' update after two rounds at 1e-3 of its
    largest entry.  After the third the trajectories have parted past
    the bar by the tiny model's kinks, on the vectorized runtime too
    (its servers, the same fleet and faults: 1.5e-4 of the update after
    three rounds, 1.2e-2 after four), so the third round is held by its
    loss and its bookkeeping."""
    ref, port, _, _, (ref_params, port_params) = servers
    _history_agrees(ref.history, port.history)
    assert port.history[-1].server_version == port.runtime.state.version
    assert [(e.stage, e.cohort, e.pulled_version, e.arrival_time)
            for e in port.runtime.state.entries] == [
        (e.stage, e.cohort, e.pulled_version, e.arrival_time)
        for e in ref.runtime.state.entries]
    assert _rel(_np(port_params), _np(ref_params), _np(setup[1])) <= TOL
    assert ref.rng.bit_generator.state == port.rng.bit_generator.state


def _buffers_equal(ref_state, port_state):
    assert (ref_state.version, ref_state.clock) == (port_state.version,
                                                    port_state.clock)
    assert len(ref_state) == len(port_state)
    for r, t in zip(ref_state.entries, port_state.entries):
        assert (r.stage, r.weight, r.pulled_version, r.arrival_time,
                r.cohort) == (t.stage, t.weight, t.pulled_version,
                              t.arrival_time, t.cohort)
        assert np.asarray(r.loss, np.float32) == t.loss.numpy()
        assert t.loss.dim() == 0 and t.loss.device == CPU
        for a, b in zip(jax.tree.leaves(r.delta),
                        jax.tree.leaves(bridge.to_reference(t.delta)),
                        strict=True):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_reference_async_checkpoint_restores_in_port(setup, servers):
    ref, _, path, ref_params, _ = servers
    ref.load_state(path)
    stages = {e.stage for e in ref.runtime.state.entries}
    assert stages == {0, 1}, "the checkpoint should hold two stages"
    port = NeuLiteServer.restore(setup[2], setup[4], FLConfig(**FL), path,
                                 fleet=Fleet(*FLEET), device="cpu")
    assert _same_tree(port.params, bridge.from_reference(ref_params, "cpu"))
    _buffers_equal(ref.runtime.state, port.runtime.state)
    assert ref.rng.bit_generator.state == port.rng.bit_generator.state
    _history_agrees(ref.history, port.history)
    ref.run(1)
    port.run(1)
    _history_agrees(ref.history, port.history)
    assert _rel(_np(bridge.to_reference(port.params)),
                _np(jax.device_get(ref.params)), _np(ref_params)) <= TOL


def test_port_async_checkpoint_restores_in_reference(servers, tmp_path):
    ref, port, _, _, _ = servers
    path = port.save_state(str(tmp_path))
    ref.load_state(path)
    for a, b in zip(jax.tree.leaves(jax.device_get(ref.params)),
                    jax.tree.leaves(bridge.to_reference(port.params)),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    _buffers_equal(ref.runtime.state, port.runtime.state)
    assert ref.next_round == port.next_round == ROUNDS_RUN


def test_port_kill_and_resume_is_exact(setup, tmp_path):
    def server(**kw):
        return NeuLiteServer(setup[2], setup[4], FLConfig(**FL, **kw),
                             fleet=Fleet(*FLEET), params=setup[3],
                             device="cpu")

    straight = server()
    straight.run(4)
    killed = server(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    killed.run(3)                    # round 2's work past the checkpoint
    assert len(killed.runtime.state) > 0
    resumed = NeuLiteServer.restore(setup[2], setup[4], killed.flc,
                                    str(tmp_path), fleet=Fleet(*FLEET),
                                    device="cpu")
    assert resumed.next_round == 2
    resumed.run(2)
    assert _same_tree(straight.params, resumed.params)
    sa, sb = straight.runtime.state, resumed.runtime.state
    assert (sa.version, sa.clock, len(sa)) == (sb.version, sb.clock, len(sb))
    for a, b in zip(sa.entries, sb.entries):
        assert (a.stage, a.weight, a.pulled_version, a.arrival_time,
                a.cohort) == (b.stage, b.weight, b.pulled_version,
                              b.arrival_time, b.cohort)
        assert torch.equal(a.loss, b.loss) and _same_tree(a.delta, b.delta)
    # repr: a NaN loss (a round that only buffered) equals itself there
    assert [repr(h) for h in straight.history] == [
        repr(h) for h in resumed.history]
    assert straight.rng.bit_generator.state == resumed.rng.bit_generator.state


def test_devices_setter_moves_the_clock_to_the_new_fleet(setup):
    srv = NeuLiteServer(setup[2], setup[4], FLConfig(**FL),
                        fleet=Fleet(*FLEET), params=setup[3], device="cpu")
    old = srv.fleet
    assert srv.runtime.client_speeds is old
    srv.devices = old.profiles(range(old.n_devices))
    assert srv.fleet is not old and srv.runtime.client_speeds is srv.fleet
    # a runtime given its own speeds keeps them
    own = {0: 2.0}
    rt = _port(setup[2], client_speeds=own)
    srv = NeuLiteServer(setup[2], setup[4], FLConfig(**FL), runtime=rt,
                        fleet=Fleet(*FLEET), params=setup[3], device="cpu")
    srv.devices = srv.fleet.profiles(range(4))
    assert rt.client_speeds is own
