"""The port's vectorized runtime (all cohorts at once: ``torch.func.vmap``
of the stage step, then the Eq. 1 sum over the cohort axis) against the JAX
reference's ``VectorizedRuntime`` and against the port's own
``SequentialRuntime``, on ``cnn_setup`` and ``tx_setup``, every stage, with
nHSIC through the kernel wrappers (their plain versions on the CPU) and
without.

Bars: against the reference, the round's update (new minus start params)
at 1e-3 of its largest entry, the bar of ``test_torch_round.py`` (a few SGD
steps with momentum carry each side's f32 rounding; the tiny models have
kinks).  Against the port's sequential runtime, on the same params and
data, the reference's own bar between its two runtimes
(``tests/test_runtime.py``: rtol 1e-4, atol 1e-5).  As there, the
transformer runs with the curriculum off: its stage-0 nHSIC term amplifies
f32 reassociation across steps.  It trains at lr 1e-3, as
``test_torch_full_step.py``'s epochs do: at the CNN's 0.05 its stage-0
round is chaotic in the reference itself (the reference's round moves by
3.4% of its largest update for a 1e-7 relative change of its start
params), and no port can be held closer than the reference holds itself.
Every stack is drawn from fresh seeded copies of the fixtures' batchers,
so a test's data does not depend on which tests ran before it: the
shared batchers advance with every draw, and ``cnn_setup`` has kinks (on
one such draw of the masked stack below, the reference's own round moves
by 3.4e-3 of its largest update for a 1e-7 change of its params).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import CurriculumHP as RHP
from repro.data import Batcher as RBatcher
from repro.data.loader import stack_round
from repro.federated import runtime as rrt
from repro.models import cnn as r_cnn
from repro.models.config import ModelConfig as RModelConfig
from repro.optim import sgd as r_sgd
from repro_torch import bridge
from repro_torch.core.curriculum import CurriculumHP as THP
from repro_torch.core.progressive import make_adapter as t_make_adapter
from repro_torch.data.loader import Batcher as TBatcher
from repro_torch.federated import runtime as trt
from repro_torch.federated.server import FLConfig, NeuLiteServer
from repro_torch.models import cnn as t_cnn
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim.optimizers import sgd as t_sgd

CPU = torch.device("cpu")
LR = {"cnn": 0.05, "tx": 1e-3}
SEQ_TOL = dict(rtol=1e-4, atol=1e-5)
REF_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one thread here: the port's side is many small ops, which
    several test processes sharing the cores slow down many times over
    when each runs a pool of threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh(batchers, seed=0):
    """Seeded copies of ``batchers``: the same data and draw order on every
    run, whatever the tests before drew."""
    return [RBatcher(b.ds, b.bs, seed=seed + i, kind=b.kind)
            for i, b in enumerate(batchers)]


def _hp(kind, kernel):
    enabled = kind == "cnn"
    return (RHP(mu=0.01, enabled=enabled),
            THP(mu=0.01, enabled=enabled, use_hsic_kernel=kernel))


@pytest.fixture(scope="module")
def setups(cnn_setup, tx_setup):
    out = {}
    adapter, params, batchers = cnn_setup
    out["cnn"] = (adapter, jax.device_get(params), t_make_adapter(
        t_cnn.CNNConfig(name="r18", arch="resnet18", num_classes=4,
                        image_size=8, width_mult=0.125), 2), batchers)
    adapter, params, batchers = tx_setup
    fields = {f.name: getattr(adapter.cfg, f.name)
              for f in dataclasses.fields(RModelConfig)
              if f.name in {g.name for g in dataclasses.fields(TModelConfig)}}
    out["tx"] = (adapter, jax.device_get(params),
                 t_make_adapter(TModelConfig(**fields), 2), batchers)
    for kind, (r_ad, r_params, t_ad, batchers) in out.items():
        out[kind] = (r_ad, r_params, t_ad,
                     bridge.from_reference(r_params, "cpu"),
                     stack_round(_fresh(batchers), range(len(batchers)),
                                 local_epochs=1))
    return out


@pytest.fixture(scope="module")
def reference_rounds(setups):
    """The reference's vectorized round of each setup and stage (its nHSIC
    is the plain one: the kernel flag does not change the reference), and
    each setup's runtime (its compiled programs serve stacks of the same
    shapes)."""
    out = {}
    for kind, (r_ad, r_params, _, _, stack) in setups.items():
        hp, _ = _hp(kind, False)
        runtime = out["runtime", kind] = rrt.VectorizedRuntime(
            r_ad, r_sgd(LR[kind]), hp)
        for t in range(r_ad.plan.num_stages):
            tr, m = runtime.run_stacked(r_params, t, stack)
            out[kind, t] = (jax.device_get(tr),
                            float(m["mean_local_loss"]))
    return out


def _ref_leaves(tree):
    return [np.asarray(a, np.float64) for a in jax.tree.leaves(tree)]


def _port_leaves(tree):
    return _ref_leaves(bridge.to_reference(tree))


def _update_rel_err(r_new, t_new, r_start, t_start):
    r_upd = [a - s for a, s in zip(_ref_leaves(r_new), _ref_leaves(r_start))]
    t_upd = [a - s for a, s in zip(_port_leaves(t_new),
                                   _port_leaves(t_start))]
    assert len(r_upd) == len(t_upd)
    scale = max(float(np.abs(u).max()) for u in r_upd if u.size)
    assert scale > 0
    return max(float(np.abs(a - b).max()) for a, b in zip(r_upd, t_upd)
               if a.size) / scale


def _assert_trees_close(a, b, **tol):
    la, lb = _port_leaves(a), _port_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, **tol)


CASES = [(kind, kernel, t) for kind in ("cnn", "tx")
         for kernel in (True, False) for t in range(2)]
IDS = [f"{k}-{'kernel' if kern else 'plain'}-stage{t}"
       for k, kern, t in CASES]


@pytest.mark.parametrize("kind,kernel,t", CASES, ids=IDS)
def test_vectorized_matches_reference_vectorized(setups, reference_rounds,
                                                 kind, kernel, t):
    r_ad, r_params, t_ad, t_params, stack = setups[kind]
    _, hp = _hp(kind, kernel)
    new, m = trt.VectorizedRuntime(t_ad, t_sgd(LR[kind]), hp,
                                   CPU).run_stacked(t_params, t, stack)
    r_new, r_loss = reference_rounds[kind, t]
    _, r_start = r_ad.split_stage(r_params, t)
    _, t_start = t_ad.split_stage(t_params, t)
    assert _update_rel_err(r_new, new, r_start, t_start) <= REF_TOL
    assert abs(float(m["mean_local_loss"]) - r_loss) <= REF_TOL * abs(r_loss)


@pytest.mark.parametrize("kind,kernel,t", CASES, ids=IDS)
def test_vectorized_matches_sequential(setups, kind, kernel, t):
    _, _, t_ad, t_params, stack = setups[kind]
    _, hp = _hp(kind, kernel)
    opt = t_sgd(LR[kind])
    seq, m_s = trt.SequentialRuntime(t_ad, opt, hp, CPU).run_stacked(
        t_params, t, stack)
    vec, m_v = trt.VectorizedRuntime(t_ad, opt, hp, CPU).run_stacked(
        t_params, t, stack)
    _assert_trees_close(seq, vec, **SEQ_TOL)
    np.testing.assert_allclose(float(m_s["mean_local_loss"]),
                               float(m_v["mean_local_loss"]), rtol=1e-4)
    np.testing.assert_allclose(m_s["cohort_losses"].numpy(),
                               m_v["cohort_losses"].numpy(), rtol=1e-4)


@pytest.fixture(scope="module")
def masked_round(setups, cnn_setup, reference_rounds):
    """A stack whose mask has False inside the step sequence (mid-round
    dropout), and the reference's vectorized round on it (through the
    runtime whose stage-0 program the stack's shapes already compiled)."""
    _, r_params, _, _, _ = setups["cnn"]
    stack = stack_round(_fresh(cnn_setup[2]), range(4), local_steps=4)
    stack.step_mask = np.asarray([[True, False, True, True],
                                  [True, True, False, False],
                                  [False, True, True, False],
                                  [True, True, True, True]])
    r_new, _ = reference_rounds["runtime", "cnn"].run_stacked(r_params, 0,
                                                              stack)
    return stack, jax.device_get(r_new)


@pytest.mark.parametrize("kernel", [True, False])
def test_non_prefix_mask(setups, masked_round, kernel):
    """A non-prefix mask means the same to both runtimes and to the
    reference's."""
    r_ad, r_params, t_ad, t_params, _ = setups["cnn"]
    stack, r_new = masked_round
    _, hp = _hp("cnn", kernel)
    opt = t_sgd(LR["cnn"])
    seq, _ = trt.SequentialRuntime(t_ad, opt, hp, CPU).run_stacked(
        t_params, 0, stack)
    vec, _ = trt.VectorizedRuntime(t_ad, opt, hp, CPU).run_stacked(
        t_params, 0, stack)
    _, r_start = r_ad.split_stage(r_params, 0)
    _, t_start = t_ad.split_stage(t_params, 0)
    _assert_trees_close(seq, vec, **SEQ_TOL)
    assert _update_rel_err(r_new, vec, r_start, t_start) <= REF_TOL


def test_masked_cohort_keeps_its_start_exactly(setups, cnn_setup):
    """A cohort whose every step is masked uploads the round's start to
    the bit, and its loss is 0."""
    _, _, t_ad, t_params, _ = setups["cnn"]
    stack = stack_round(_fresh(cnn_setup[2][:2]), [0, 1], local_steps=2)
    stack.step_mask = np.asarray([[True, True], [False, False]])
    frozen, trainable = t_ad.split_stage(t_params, 0)
    locals_, losses = trt.make_local_program(
        t_ad, t_sgd(LR["cnn"]), _hp("cnn", True)[1], 0)(
            trainable, frozen, bridge_batches(stack), stack.step_mask)
    cohort1 = jax.tree.map(lambda a: a[1], locals_)
    for got, start in zip(_port_leaves(cohort1), _port_leaves(trainable)):
        np.testing.assert_array_equal(got, start)
    assert float(losses[1]) == 0.0 and float(losses[0]) > 0.0


def bridge_batches(stack):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)),
                        stack.batches)


def test_zero_weight_round_raises(setups):
    _, _, t_ad, t_params, stack = setups["cnn"]
    stack = dataclasses.replace(stack, weights=np.zeros_like(stack.weights))
    with pytest.raises(ValueError, match="zero total aggregation weight"):
        trt.VectorizedRuntime(t_ad, t_sgd(LR["cnn"]), _hp("cnn", True)[1],
                              CPU).run_stacked(t_params, 0, stack)


def test_lost_round_returns_params_unchanged(setups, cnn_setup):
    """Every cohort faults before its first step: the round is lost."""
    _, _, t_ad, t_params, _ = setups["cnn"]
    batchers = [TBatcher(b.ds, 16, seed=i, kind="image")
                for i, b in enumerate(cnn_setup[2])]
    out = trt.VectorizedRuntime(t_ad, t_sgd(LR["cnn"]), _hp("cnn", True)[1],
                                CPU).run_round(
        t_params, 0, batchers, [0, 1, 2], 1, faults=[0, 0, 0])
    assert out.params is t_params and out.n_uploads == 0
    assert np.isnan(float(out.mean_loss))


def test_flconfig_reaches_the_vectorized_runtime(cnn_setup):
    """``FLConfig(runtime="vectorized")`` builds the vectorized runtime in
    the server, which runs a round with a finite loss."""
    adapter, params, batchers = cnn_setup
    t_ad = t_make_adapter(t_cnn.CNNConfig(
        name="r18", arch="resnet18", num_classes=4, image_size=8,
        width_mult=0.125), 2)
    server = NeuLiteServer(
        t_ad, [b.ds for b in batchers],
        FLConfig(n_devices=4, clients_per_round=2, local_epochs=1,
                 batch_size=16, num_stages=2, use_hsic_kernel=True,
                 runtime="vectorized"),
        params=bridge.from_reference(jax.device_get(params), "cpu"),
        device="cpu")
    assert isinstance(server.runtime, trt.VectorizedRuntime)
    rr = server.run_round(0)
    assert rr.n_selected > 0 and np.isfinite(rr.mean_loss)


def test_eq1_aggregate_matches_reference():
    rng = np.random.default_rng(0)
    locals_ = {"a": rng.standard_normal((3, 4, 5)).astype(np.float32),
               "b": [rng.standard_normal((3, 7)).astype(np.float32)]}
    weights = np.asarray([5.0, 40.0, 12.0], np.float32)
    losses = rng.standard_normal(3).astype(np.float32)
    r_new, r_loss = rrt.eq1_aggregate(jax.tree.map(jax.numpy.asarray,
                                                   locals_),
                                      jax.numpy.asarray(weights),
                                      jax.numpy.asarray(losses))
    t_new, t_loss = trt.eq1_aggregate(
        jax.tree.map(torch.from_numpy, locals_), weights,
        torch.from_numpy(losses))
    for a, b in zip(jax.tree.leaves(jax.device_get(r_new)),
                    jax.tree.leaves(jax.tree.map(np.asarray, t_new))):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=1e-6)
    with pytest.raises(ValueError, match="positive finite weight sum"):
        trt.eq1_aggregate(jax.tree.map(torch.from_numpy, locals_),
                          np.zeros(3), torch.from_numpy(losses))


def test_full_round_program_matches_reference(setups):
    """FedAvg's round over the whole model, reference against port (the
    CNN: the transformer's full round moves by 0.23 of its largest update
    in the reference itself for a 1e-7 change of its params)."""
    r_ad, r_params, t_ad, t_params, stack = setups["cnn"]
    r_model = {"model": r_params["model"]}
    t_model = {"model": t_params["model"]}
    r_new, r_m = rrt.make_full_round_program(r_ad, r_sgd(LR["cnn"]))(
        r_model, jax.tree.map(jax.numpy.asarray, stack.batches),
        jax.numpy.asarray(stack.weights), jax.numpy.asarray(stack.step_mask))
    t_new, t_m = trt.make_full_round_program(t_ad, t_sgd(LR["cnn"]))(
        t_model, bridge_batches(stack), stack.weights, stack.step_mask)
    assert _update_rel_err(jax.device_get(r_new), t_new, r_model,
                           t_model) <= REF_TOL
    np.testing.assert_allclose(t_m["cohort_losses"].numpy(),
                               np.asarray(r_m["cohort_losses"]),
                               rtol=REF_TOL)


def test_fl_round_step_matches_reference(setups, tx_setup):
    """The all-steps round entry point, on a stack without padding (the
    transformer: its reference program compiles in half the CNN's time)."""
    r_ad, r_params, t_ad, t_params, _ = setups["tx"]
    stack = stack_round(_fresh(tx_setup[2]), range(3), local_steps=2)
    r_hp, hp = _hp("tx", True)
    r_frozen, r_tr = r_ad.split_stage(r_params, 1)
    t_frozen, t_tr = t_ad.split_stage(t_params, 1)
    r_new, r_m = rrt.make_fl_round_step(r_ad, r_sgd(LR["tx"]), r_hp, 1)(
        r_tr, r_frozen, jax.tree.map(jax.numpy.asarray, stack.batches),
        jax.numpy.asarray(stack.weights))
    t_new, t_m = trt.make_fl_round_step(t_ad, t_sgd(LR["tx"]), hp, 1)(
        t_tr, t_frozen, bridge_batches(stack), stack.weights)
    assert _update_rel_err(jax.device_get(r_new), t_new, r_tr,
                           t_tr) <= REF_TOL
    np.testing.assert_allclose(float(t_m["mean_local_loss"]),
                               float(r_m["mean_local_loss"]), rtol=REF_TOL)


@pytest.mark.parametrize("impl", ["auto", "im2col", "lax"])
def test_resolve_conv_impl_matches_reference_mapping(impl):
    """On the CPU both map "auto" to im2col; the reference's "lax" is the
    port's "native" (cuDNN on the card, where "auto" maps to it)."""
    names = {"lax": "native"}
    want = r_cnn.resolve_conv_impl(impl)
    assert t_cnn.resolve_conv_impl(names.get(impl, impl), "cpu") == \
        names.get(want, want)
    assert t_cnn.resolve_conv_impl("auto", "cuda") == "native"
    assert t_cnn.CNNConfig(name="r", arch="resnet18").conv_impl == "auto"
