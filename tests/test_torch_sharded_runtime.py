"""The port's ``ShardedRuntime`` on gloo worlds of 1, 2 and 4 ranks on the
CPU, against the JAX reference's ``VectorizedRuntime``, on ``cnn_setup``'s
and ``tx_setup``'s models and data, from the same bridged params, at
stage 0.  Stage 1, against the reference's ``ShardedRuntime`` too, is in
``test_torch_sharded_async.py``, whose worlds run it beside the async
cases: the reference compiles a program per stage (~7 s for the CNN), so
the stages split over the two files to keep each within its time.

Bars: the reference's own between its runtimes (``tests/test_runtime.py``:
rtol 1e-4, atol 1e-5 on the new trainable; the mean loss at rtol 1e-4).
The transformer trains at lr 1e-3 with the curriculum off, as
``test_torch_vectorized.py`` holds it: at 0.05 its stage-0 round is
chaotic in the reference itself.  nHSIC runs through the kernel wrappers
(their plain versions here).

A world of 1 (this process's one-rank mesh) gives the vectorized runtime's
bits.  A world of 2 (data 2) splits the cohorts, padding tx_setup's 3 to 4
and a 3-cohort cnn stack; a world of 4 runs the 2-D (data 2 x model 2)
round with ``merge_stage``, and data 4.  Every rank's
result has the same bits; with ``model_parallel=2`` a rank holds below
0.65 of the replicated trainable bytes; a rank whose round drifted from
rank 0's makes every rank refuse it.

Each world is spawned once per module (``launch.mesh.start_world``, one
torch thread a rank) and runs every case of its size
(``launch.rounds.stacked_rounds``); the reference's rounds compute here
while the worlds run.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import CurriculumHP as RHP
from repro.core import make_adapter, make_transformer_adapter
from repro.data import Batcher as RBatcher
from repro.data import (dirichlet_partition, make_image_dataset,
                        make_lm_dataset)
from repro.data.loader import stack_round
from repro.federated import runtime as rrt
from repro.models.cnn import CNNConfig
from repro.models.config import ModelConfig as RModelConfig
from repro.optim import sgd as r_sgd
from repro_torch import bridge
from repro_torch.common.tree import tree_leaves
from repro_torch.data.loader import RoundStack
from repro_torch.federated import runtime as trt
from repro_torch.launch import rounds as lr
from repro_torch.launch.mesh import start_world

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
LR = {"cnn": 0.05, "tx": 1e-3}
CNN = dict(name="r18", arch="resnet18", num_classes=4, image_size=8,
           width_mult=0.125)
TX = dict(name="t", family="dense", num_layers=4, d_model=32, num_heads=2,
          num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_stack(stack, cohorts=None):
    """A reference ``RoundStack`` as the port's (numpy leaves), its first
    ``cohorts`` cohorts where given."""
    c = slice(None) if cohorts is None else slice(0, cohorts)
    return RoundStack(batches=jax.tree.map(lambda x: np.asarray(x)[c],
                                           stack.batches),
                      step_mask=np.asarray(stack.step_mask)[c],
                      weights=np.asarray(stack.weights)[c],
                      num_batches=list(stack.num_batches)[c])


def _setup(kind):
    """``cnn_setup``'s or ``tx_setup``'s model, data and batchers
    (``tests/conftest.py``) and ``tx_setup``'s params; ``cnn_setup``'s
    params from the port's seeded init in the reference's layout (the
    fixture's JAX init takes ~20 s, most of this file's budget):
    (reference adapter, params, the port's model description, the stack:
    the reference's and the port's)."""
    if kind == "cnn":
        r_ad = make_adapter(CNNConfig(**CNN), 2)
        model = ("cnn", CNN, 2)
        ds = make_image_dataset(0, 200, num_classes=4, image_size=8)
        parts = dirichlet_partition(0, ds.labels, 4, alpha=1.0)
        batchers = [RBatcher(ds.subset(p), 16, seed=i, kind="image")
                    for i, p in enumerate(parts)]
    else:
        r_ad = make_transformer_adapter(RModelConfig(**TX), 2)
        model = ("transformer", TX, 2)
        ds = make_lm_dataset(0, 96, 8, TX["vocab_size"])
        idx = np.arange(len(ds))
        batchers = [RBatcher(ds.subset(idx[i::3]), 8, seed=i, kind="lm")
                    for i in range(3)]
    if kind == "cnn":
        params = bridge.to_reference(lr.build_adapter(model).init_params(
            0, CPU))
    else:                       # tx_setup's own params (a 4 s init)
        params = jax.device_get(r_ad.init_params(jax.random.PRNGKey(0)))
    stack = stack_round(batchers, range(len(batchers)), local_epochs=1)
    return r_ad, params, model, stack, _port_stack(stack)


@pytest.fixture(scope="module")
def setups():
    return {kind: _setup(kind) for kind in ("cnn", "tx")}


def _hp(kind):
    return dict(mu=0.01, enabled=kind == "cnn", use_hsic_kernel=True)


def _case(setups, name, kind, stages, cohorts=None, **kw):
    _, r_params, model, _, stack = setups[kind]
    if cohorts is not None:
        stack = _port_stack(setups[kind][3], cohorts)
    return dict(name=name, model=model, params=r_params, lr=LR[kind],
                hp=_hp(kind), runtime="sharded",
                rounds=[{"t": t, "stack": stack} for t in stages], **kw)


@pytest.fixture(scope="module")
def worlds(setups):
    """Each world's ranks' results by case name, and the reference's
    rounds: ``("vectorized", kind, t)`` -> (new trainable, mean loss)."""
    w2 = [_case(setups, "cnn", "cnn", (0,)),
          _case(setups, "cnn-3", "cnn", (1,), cohorts=3),
          _case(setups, "tx", "tx", (0,)),
          _case(setups, "drift", "cnn", (0, 0), drift_rank=1)]
    two_d = {"runtime_kw": {"model_parallel": 2}}
    w4 = [_case(setups, "cnn-2d", "cnn", (0,), **two_d),
          _case(setups, "tx-2d", "tx", (0,), **two_d),
          _case(setups, "cnn-4x1", "cnn", (0,))]
    started = {2: start_world(lr.stacked_rounds, 2, "cpu", w2, threads=1),
               4: start_world(lr.stacked_rounds, 4, "cpu", w4, threads=1)}
    ref = {}
    for kind, (r_ad, r_params, _, stack, _) in setups.items():
        rhp = RHP(mu=0.01, enabled=kind == "cnn")
        opt = r_sgd(LR[kind], momentum=0.9, weight_decay=5e-4)
        tr, m = rrt.VectorizedRuntime(r_ad, opt, rhp).run_stacked(r_params,
                                                                  0, stack)
        ref["vectorized", kind, 0] = (jax.device_get(tr),
                                      float(m["mean_local_loss"]))
    out = {}
    for size, world in started.items():
        ranks = world.join()
        out[size] = {case["name"]: [r[i] for r in ranks]
                     for i, case in enumerate(ranks[0])}
    return out, ref


def _leaves(tree):
    return [np.asarray(a, np.float64) for a in jax.tree.leaves(tree)]


def _close(got, want, **tol):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("kind", ["cnn", "tx"])
def test_world_of_one_gives_vectorized_bits(setups, kind):
    """This process's one-rank mesh: the same einsum over the same cohorts,
    then an all-reduce over one rank, so the vectorized round's bits."""
    from repro_torch.core.curriculum import CurriculumHP
    from repro_torch.optim.optimizers import sgd
    _, r_params, model, _, stack = setups[kind]
    adapter = lr.build_adapter(model)
    params = bridge.from_reference(r_params, CPU)
    args = (adapter, sgd(LR[kind], 0.9, 5e-4), CurriculumHP(**_hp(kind)),
            CPU)
    sharded = trt.ShardedRuntime(*args)
    assert sharded.mesh.shape == {"data": 1, "model": 1}
    tr_s, m_s = sharded.run_stacked(params, 0, stack)
    tr_v, m_v = trt.VectorizedRuntime(*args).run_stacked(params, 0, stack)
    for a, b in zip(tree_leaves(tr_s), tree_leaves(tr_v), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(m_s["cohort_losses"], m_v["cohort_losses"])
    assert torch.equal(m_s["mean_local_loss"], m_v["mean_local_loss"])


ROUNDS = [(2, "cnn", "cnn"), (2, "tx", "tx"), (4, "cnn-2d", "cnn"),
          (4, "tx-2d", "tx"), (4, "cnn-4x1", "cnn")]


@pytest.mark.parametrize("size,case,kind", ROUNDS,
                         ids=[f"world{s}-{c}" for s, c, _ in ROUNDS])
def test_round_matches_reference(worlds, size, case, kind):
    results, ref = worlds
    for row in results[size][case][0]["rounds"]:
        t = row["t"]
        tr, loss = ref["vectorized", kind, t]
        _close(row["trainable"], tr, **TOL)
        np.testing.assert_allclose(row["mean_loss"], loss, rtol=1e-4)


@pytest.mark.parametrize("kind", ["cnn", "tx"])
def test_2d_round_merges(worlds, setups, kind):
    """Data 2 x model 2: the merged params (the aggregate gathered whole
    over "model") against the reference's merge of its vectorized round
    (stage 1: ``test_torch_sharded_async.py``)."""
    results, ref = worlds
    r_ad, r_params = setups[kind][:2]
    rows = results[4][f"{kind}-2d"][0]["rounds"]
    assert results[4][f"{kind}-2d"][0]["mesh"] == {"data": 2, "model": 2}
    assert [row["t"] for row in rows] == [0]
    for row in rows:
        t = row["t"]
        want = r_ad.merge_stage(r_params, ref["vectorized", kind, t][0], t)
        _close(row["merged"], want, **TOL)


@pytest.mark.parametrize("size", [2, 4])
def test_every_rank_has_the_same_bits(worlds, size):
    results, _ = worlds
    for name, ranks in results[size].items():
        for other in ranks[1:]:
            for a, b in zip(ranks[0]["rounds"], other["rounds"]):
                assert a.keys() == b.keys(), name
                if "error" in a:
                    continue
                for x, y in zip(jax.tree.leaves(a["merged"]),
                                jax.tree.leaves(b["merged"]), strict=True):
                    np.testing.assert_array_equal(x, y)
                np.testing.assert_array_equal(a["cohort_losses"],
                                              b["cohort_losses"])
                assert a["mean_loss"] == b["mean_loss"]


def test_model_parallel_holds_below_065_of_replicated(worlds):
    results, _ = worlds
    for kind in ("cnn", "tx"):
        replicated = results[2][kind][0]["rounds"]
        sharded = results[4][f"{kind}-2d"]
        for t, row in enumerate(replicated):
            whole = sum(a.nbytes for a in jax.tree.leaves(row["trainable"]))
            assert row["held_trainable_bytes"] == whole
            held = {r["rounds"][t]["held_trainable_bytes"] for r in sharded}
            assert len(held) == 1
            assert held.pop() < 0.65 * whole, (kind, t)


def test_padded_cohort_is_a_noop(worlds, setups):
    """3 cohorts on 2 data ranks: one zero-weight, fully masked cohort
    pads the axis; the round is the vectorized round on the 3."""
    from repro_torch.core.curriculum import CurriculumHP
    from repro_torch.optim.optimizers import sgd
    results, _ = worlds
    _, r_params, model, r_stack, _ = setups["cnn"]
    stack = _port_stack(r_stack, 3)
    new, m = trt.VectorizedRuntime(
        lr.build_adapter(model), sgd(LR["cnn"], 0.9, 5e-4),
        CurriculumHP(**_hp("cnn")), CPU).run_stacked(
            bridge.from_reference(r_params, CPU), 1, stack)
    row = results[2]["cnn-3"][0]["rounds"][0]
    _close(row["trainable"], bridge.to_reference(new), **TOL)
    assert row["cohort_losses"].shape == (3,)
    np.testing.assert_allclose(row["cohort_losses"],
                               m["cohort_losses"].numpy(), rtol=1e-4)
    np.testing.assert_allclose(row["mean_loss"],
                               float(m["mean_local_loss"]), rtol=1e-4)
    # the tx stack's 3 cohorts pad too
    assert results[2]["tx"][0]["rounds"][0]["cohort_losses"].shape == (3,)


def test_a_drifted_rank_makes_every_rank_refuse(worlds):
    results, _ = worlds
    for rank in results[2]["drift"]:
        first, second = rank["rounds"]
        assert "disagree with rank 0" in first["error"]
        assert "error" not in second
    a, b = (r["rounds"][1] for r in results[2]["drift"])
    np.testing.assert_array_equal(a["cohort_losses"], b["cohort_losses"])
