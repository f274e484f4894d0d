"""The port's rounds on a mesh at stage 1 and its buffered-async runtime on
a mesh, on gloo worlds of 2 (data 2) and 4 (data 2 x model 2) on the CPU;
crash-safe resume on a mesh and checkpoints across worlds and packages.

Rounds: ``cnn_setup``'s and ``tx_setup``'s models and data (the CNN's
params from the port's seeded init, ``tx_setup``'s own; see
``test_torch_sharded_runtime.py``, which holds stage 0 against the
reference's ``VectorizedRuntime``), the sharded round at stage 1 against
the JAX reference's ``ShardedRuntime`` (1-D, one JAX device) at the
reference's bar between its runtimes (rtol 1e-4, atol 1e-5), the 2-D
round's ``merge_stage`` too.

Async: three rounds of ``test_torch_async_runtime.py`` (K = 3 of 4 cohorts,
a stage change, a straggler carried into a later flush) on the mesh
against the one-process async runtime: the host numbers (staleness,
uploads, carried, pending, versions, simulated time) exactly, the new
trainable and the pending deltas at rtol 1e-4, atol 1e-5; K = C against
the vectorized round at that bar.

Resume (``tests/test_runtime.py``'s ``sharded``, ``sharded-2d`` and
``async-2d`` cases at its sizes): 4 rounds checkpointing every 2, then a
server restored from the round-2 checkpoint on every rank runs rounds 2-3:
params, history and buffer to the bit.  A world-2 checkpoint restores in a
world of 1 and a world-1 checkpoint in a world of 2; a world-4 async
checkpoint (model shards gathered) in one process; a reference checkpoint
of a JAX ``ShardedRuntime`` server restores in a world of 2, whose next 2
rounds are then the port's straight run's to the bit; a world-2
checkpoint restores in the reference's sharded server.  The reference's
servers are built with the port's init params through the bridge (its
own eager init of the CNN takes ~18 s) and never train.
"""
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import CurriculumHP as RHP
from repro.core import make_adapter as r_make_adapter
from repro.data import Batcher as RBatcher
from repro.data import dirichlet_partition as r_partition
from repro.data import make_image_dataset as r_images
from repro.federated import runtime as rrt
from repro.federated.devices import Fleet as RFleet
from repro.federated.server import FLConfig as RFLConfig
from repro.federated.server import NeuLiteServer as RServer
from repro.models.cnn import CNNConfig as RCNNConfig
from repro.optim import sgd as r_sgd
from repro_torch import bridge
from repro_torch.checkpoint import checkpoint_path
from repro_torch.core.curriculum import CurriculumHP
from repro_torch.federated import runtime as trt
from repro_torch.launch import rounds as lr
from repro_torch.launch.mesh import start_world
from repro_torch.optim.optimizers import sgd
from test_torch_sharded_runtime import CNN, LR, TOL, _hp, _setup

CPU = torch.device("cpu")
ASYNC = dict(buffer_size=3, staleness_schedule="polynomial",
             staleness_alpha=0.5)
# test_torch_async_runtime.py's rounds: (stage, sim_times)
ROUNDS = [(0, [1.0, 2.0, 3.0, 8.0]), (1, [2.0, 1.0, 50.0, 3.0]),
          (0, [5.0, 4.0, 6.0, 7.0])]
WANT = [dict(staleness=[0, 0, 0, -1], n_uploads=3, n_carried=0,
             n_pending=1, server_version=1, sim_round_time=3.0),
        dict(staleness=[0, 0, -1, 0], n_uploads=3, n_carried=0,
             n_pending=2, server_version=2, sim_round_time=3.0),
        dict(staleness=[0, 0, -1, -1], n_uploads=3, n_carried=1,
             n_pending=3, server_version=3, sim_round_time=5.0)]
# tests/test_runtime.py's resume servers (a fleet whose every device fits
# both stages, so that every round trains)
DATA = dict(seed=0, n=160, classes=4, image_size=8, clients=4, test_seed=3,
            test_n=64)
FL = dict(n_devices=4, clients_per_round=3, local_epochs=1, batch_size=16,
          num_stages=2, seed=0, use_hsic_kernel=True)
FLEET = (0, 4, 16_000_000)
MODEL = ("cnn", CNN, 2)
RESUME = {2: {"sharded": dict(runtime="sharded")},
          4: {"sharded-2d": dict(runtime="sharded", model_parallel=2),
              "async-2d": dict(runtime="async", buffer_size=4,
                               model_parallel=2)}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stacked(setups, name, kind, rounds, runtime="sharded", **kw):
    _, r_params, model, _, stack = setups[kind]
    return dict(name=name, model=model, params=r_params, lr=LR[kind],
                hp=_hp(kind), runtime=runtime,
                rounds=[dict(t=t, stack=stack, **({"sim_times": s}
                                                   if s else {}))
                        for t, s in rounds], **kw)


def _server_case(name, flc, directory, rounds=4, **kw):
    return dict(name=name, model=MODEL, data=DATA, fleet=FLEET,
                flc=dict(FL, checkpoint_dir=os.path.join(directory, name),
                         checkpoint_every=2, **flc),
                rounds=rounds, **kw)


def _port_params():
    return lr.build_adapter(MODEL).init_params(0, CPU)


def _reference_server(flc):
    """The reference's server at round 0 on the port's init params."""
    adapter = r_make_adapter(RCNNConfig(**CNN), 2)
    adapter.init_params = lambda rng: bridge.to_reference(_port_params())
    ds = r_images(0, DATA["n"], num_classes=4, image_size=8)
    parts = r_partition(0, ds.labels, 4, alpha=1.0)
    test = r_images(3, DATA["test_n"], num_classes=4, image_size=8)
    return RServer(adapter, [ds.subset(p) for p in parts], RFLConfig(**flc),
                   test_batcher=RBatcher(test, 32, seed=7, kind="image"),
                   fleet=RFleet(*FLEET))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh"))
    setups = {kind: _setup(kind) for kind in ("cnn", "tx")}
    # a world of 1 (this process) and the reference write checkpoints first
    one = lr.server_runs(CPU, [_server_case("world1", dict(
        runtime="sharded"), d, rounds=2)])[0]
    ref = _reference_server(dict(FL, runtime="sharded"))
    ref_ckpt = ref.save_state(os.path.join(d, "reference"))
    rounds = [(t, s) for t, s in ROUNDS]
    w2 = [_stacked(setups, "cnn", "cnn", [(1, None)]),
          _stacked(setups, "tx", "tx", [(1, None)]),
          _stacked(setups, "async", "cnn", rounds, "async",
                   runtime_kw=ASYNC),
          _stacked(setups, "async-kc", "cnn", [(1, None)], "async",
                   runtime_kw=dict(ASYNC, buffer_size=0))]
    two_d = {"model_parallel": 2}
    w4 = [_stacked(setups, "cnn-2d", "cnn", [(1, None)], runtime_kw=two_d),
          _stacked(setups, "tx-2d", "tx", [(1, None)], runtime_kw=two_d),
          _stacked(setups, "async-2d", "cnn", rounds, "async",
                   runtime_kw=dict(ASYNC, **two_d))]
    s2 = [_server_case("resume-sharded", RESUME[2]["sharded"], d,
                       resume_at=2),
          _server_case("from-world1", dict(runtime="sharded"), d, rounds=2,
                       restore_from=checkpoint_path(
                           os.path.join(d, "world1"), 2)),
          _server_case("from-reference", dict(runtime="sharded"), d,
                       rounds=2, restore_from=ref_ckpt)]
    s4 = [_server_case(f"resume-{n}", kw, d, resume_at=2)
          for n, kw in RESUME[4].items()]
    started = {2: start_world(lr.rounds_and_servers, 2, "cpu", w2, s2,
                              threads=1),
               4: start_world(lr.rounds_and_servers, 4, "cpu", w4, s4,
                              threads=1)}

    # the reference's rounds and the one-process port's, meanwhile
    refs = {}
    for kind, (r_ad, r_params, model, stack, t_stack) in setups.items():
        rhp = RHP(mu=0.01, enabled=kind == "cnn")
        opt = r_sgd(LR[kind], momentum=0.9, weight_decay=5e-4)
        tr, m = rrt.ShardedRuntime(r_ad, opt, rhp).run_stacked(r_params, 1,
                                                               stack)
        refs["sharded", kind] = (jax.device_get(tr),
                                 float(m["mean_local_loss"]))
    _, r_params, model, _, stack = setups["cnn"]
    args = (lr.build_adapter(model), sgd(LR["cnn"], 0.9, 5e-4),
            CurriculumHP(**_hp("cnn")), CPU)
    params = bridge.from_reference(r_params, CPU)
    asy = trt.AsyncBufferedRuntime(*args, **ASYNC)
    assert asy.mesh is None
    refs["async"] = []
    for t, sim in ROUNDS:
        tr, m = asy.run_stacked(params, t, stack, sim_times=sim)
        refs["async"].append((bridge.to_reference(tr), m,
                              lr._buffer(asy)))
    tr, m = trt.VectorizedRuntime(*args).run_stacked(params, 1, stack)
    refs["vectorized-port", "cnn"] = (bridge.to_reference(tr), m)

    out = {}
    for size, world in started.items():
        ranks = world.join()
        out[size] = {c["name"]: [r[i] for r in ranks]
                     for i, c in enumerate(ranks[0])}
    return dict(worlds=out, refs=refs, setups=setups, one=one,
                directory=d, reference=ref, reference_ckpt=ref_ckpt)


def _leaves(tree):
    return [np.asarray(a, np.float64) for a in jax.tree.leaves(tree)]


def _close(got, want, **tol):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **tol)


def _bits(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _same_history(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], float) and math.isnan(x[k]):
                assert math.isnan(y[k]), (k, x, y)
            else:
                assert x[k] == y[k], (k, x, y)


def _same_buffer(a, b, **tol):
    assert [(e["stage"], e["cohort"], e["weight"], e["pulled_version"],
             e["arrival_time"]) for e in a] == [
        (e["stage"], e["cohort"], e["weight"], e["pulled_version"],
         e["arrival_time"]) for e in b]
    for x, y in zip(a, b):
        for p, q in zip(x["delta"], y["delta"], strict=True):
            if tol:
                np.testing.assert_allclose(p, q, **tol)
            else:
                np.testing.assert_array_equal(p, q)


# --------------------------------------------------------------------------- #
# stage-1 rounds against the reference
# --------------------------------------------------------------------------- #
CASES = [(2, "cnn", "cnn"), (2, "tx", "tx"), (4, "cnn-2d", "cnn"),
         (4, "tx-2d", "tx")]


@pytest.mark.parametrize("size,case,kind", CASES,
                         ids=[f"world{s}-{c}" for s, c, _ in CASES])
def test_stage1_round_matches_reference_sharded(worlds, size, case, kind):
    row = worlds["worlds"][size][case][0]["rounds"][0]
    assert row["t"] == 1
    tr, loss = worlds["refs"]["sharded", kind]
    _close(row["trainable"], tr, **TOL)
    np.testing.assert_allclose(row["mean_loss"], loss, rtol=1e-4)
    if size == 4:
        r_ad, r_params = worlds["setups"][kind][:2]
        want = r_ad.merge_stage(r_params, tr, 1)
        _close(row["merged"], want, **TOL)
        assert worlds["worlds"][4][case][0]["mesh"] == {"data": 2,
                                                        "model": 2}


# --------------------------------------------------------------------------- #
# the async runtime on the mesh
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("size,case", [(2, "async"), (4, "async-2d")])
def test_async_on_mesh_matches_one_process(worlds, size, case):
    ranks = worlds["worlds"][size][case]
    for rank in ranks:
        for row, want, (tr, m, buffer) in zip(rank["rounds"], WANT,
                                              worlds["refs"]["async"]):
            got = {k: row[k] for k in want}
            assert got == want
            assert got == {k: (np.asarray(m[k]).tolist() if k ==
                               "staleness" else m[k]) for k in want}
            _close(row["trainable"], tr, **TOL)
            np.testing.assert_allclose(row["cohort_losses"],
                                       m["cohort_losses"].numpy(),
                                       rtol=1e-4)
            _same_buffer(row["buffer"], buffer, **TOL)
    for other in ranks[1:]:           # every rank the same bits
        for a, b in zip(ranks[0]["rounds"], other["rounds"]):
            _bits(a["trainable"], b["trainable"])
            _same_buffer(a["buffer"], b["buffer"])


def test_async_full_buffer_on_mesh_is_the_vectorized_round(worlds):
    row = worlds["worlds"][2]["async-kc"][0]["rounds"][0]
    tr, m = worlds["refs"]["vectorized-port", "cnn"]
    _close(row["trainable"], tr, **TOL)
    np.testing.assert_allclose(row["mean_loss"],
                               float(m["mean_local_loss"]), rtol=1e-4)
    assert row["server_version"] == 1 and row["n_pending"] == 0
    assert row["staleness"] == [0, 0, 0, 0]


def test_async_2d_holds_below_065(worlds):
    held = worlds["worlds"][4]["async-2d"][0]["rounds"][0][
        "held_trainable_bytes"]
    whole = sum(a.nbytes for a in jax.tree.leaves(
        worlds["refs"]["async"][0][0]))
    assert held < 0.65 * whole


# --------------------------------------------------------------------------- #
# resume on the mesh, across worlds and across packages
# --------------------------------------------------------------------------- #
RESUME_IDS = [(2, "sharded"), (4, "sharded-2d"), (4, "async-2d")]


@pytest.mark.parametrize("size,case", RESUME_IDS,
                         ids=[c for _, c in RESUME_IDS])
def test_resume_matches_straight_run_exactly(worlds, size, case):
    for rank in worlds["worlds"][size][f"resume-{case}"]:
        straight, resumed = rank["final"], rank["resumed"]
        _bits(straight["params"], resumed["params"])
        _same_history(straight["history"], resumed["history"])
        assert straight["rng"] == resumed["rng"]
        if case.startswith("async"):
            # the save point strands deliveries in the pending buffer
            assert len(rank["saved"][2]["buffer"]) > 0
            assert (straight["version"], straight["clock"]) == (
                resumed["version"], resumed["clock"])
            _same_buffer(straight["buffer"], resumed["buffer"])
    a, b = (r["final"] for r in worlds["worlds"][size][f"resume-{case}"][:2])
    _bits(a["params"], b["params"])


def test_world2_checkpoint_restores_in_a_world_of_one(worlds):
    saved = worlds["worlds"][2]["resume-sharded"][0]["saved"][2]
    path = checkpoint_path(os.path.join(worlds["directory"], "resume-sharded"),
                           2)
    res = lr.server_runs(CPU, [_server_case(
        "w1", dict(runtime="sharded"), worlds["directory"], rounds=0,
        restore_from=path)])[0]["restored"]
    assert res["mesh"] == {"data": 1, "model": 1}
    _bits(saved["params"], res["params"])
    _same_history(saved["history"], res["history"])
    assert saved["rng"] == res["rng"] and res["next_round"] == 2


def test_world1_checkpoint_restores_in_a_world_of_two(worlds):
    one = worlds["one"]["saved"][2]
    for rank in worlds["worlds"][2]["from-world1"]:
        assert rank["restored"]["mesh"] == {"data": 2, "model": 1}
        _bits(one["params"], rank["restored"]["params"])
        _same_history(one["history"], rank["restored"]["history"])
        assert len(rank["final"]["history"]) == 4


def test_world4_async_checkpoint_restores_in_one_process(worlds):
    saved = worlds["worlds"][4]["resume-async-2d"][0]["saved"][2]
    path = checkpoint_path(os.path.join(worlds["directory"],
                                        "resume-async-2d"), 2)
    res = lr.server_runs(CPU, [_server_case(
        "w1-async", dict(runtime="async", buffer_size=4),
        worlds["directory"], rounds=0, restore_from=path)])[0]["restored"]
    assert res["mesh"] is None
    _bits(saved["params"], res["params"])
    _same_buffer(saved["buffer"], res["buffer"])
    assert (saved["version"], saved["clock"]) == (res["version"],
                                                  res["clock"])


def test_reference_checkpoint_restores_in_a_world_of_two(worlds):
    """The reference's sharded server at round 0, on the port's init
    params: restored in a world of 2, its next 2 rounds are the port's
    straight run's to the bit."""
    straight = worlds["worlds"][2]["resume-sharded"]
    for rank, own in zip(worlds["worlds"][2]["from-reference"], straight):
        assert rank["restored"]["next_round"] == 0
        _bits(bridge.to_reference(_port_params()),
              rank["restored"]["params"])
        _bits(own["saved"][2]["params"], rank["final"]["params"])
        _same_history(own["saved"][2]["history"],
                      rank["final"]["history"])


def test_world2_checkpoint_restores_in_the_reference(worlds):
    ref = worlds["reference"]
    final = worlds["worlds"][2]["resume-sharded"][0]["final"]
    ref.load_state(checkpoint_path(os.path.join(worlds["directory"],
                                                "resume-sharded"), 4))
    _bits(final["params"], jax.device_get(ref.params))
    assert ref.next_round == 4 and ref.runtime.name == "sharded"
    assert ref.rng.bit_generator.state == final["rng"]


def test_server_prints_on_rank0_only(worlds, capsys):
    """``run(log_every=)`` prints on rank 0: a world-1 server prints."""
    from repro_torch.launch.rounds import _server
    case = _server_case("log", dict(runtime="sharded"),
                        worlds["directory"], rounds=1)
    case["flc"] = dict(case["flc"], checkpoint_dir=None, checkpoint_every=0)
    srv = _server(case, CPU)
    assert srv.is_rank0 and srv.mesh.rank == 0
    srv.run(1, log_every=1)
    assert "round    0 stage 0" in capsys.readouterr().out
