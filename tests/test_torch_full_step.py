"""The full-model (FedAvg) step of the port against the JAX reference's
``make_full_step``, and full-model local training against its
``run_local_training_full``: shrunk ResNet18 (``cnn_setup``'s), VGG11 and
SqueezeNet, and ``tx_setup``'s transformer.  Then the measurement of the
stage-vs-full memory claim: it raises off the card, and its gate.

Params are the same on both sides (bridged); batches are numpy draws from
fixed seeds.  Tolerance: a step at f32 rtol 1e-4, with an absolute floor
of 1e-4 of the largest update, judged by its update (new minus start
params); an epoch at 1e-3 of the largest update (the bar of
``test_torch_round.py``: a few steps of SGD with momentum carry the
rounding of each).  As in ``chip_smoke.py``'s step check, each bar takes
the reference's own sensitivity into account: the reference runs again
from its start params times 1 + 1e-7 N(0, 1) (a seeded draw per entry),
and where that moves its update by more than a tenth of the bar (relative
to the largest entry), the bar is 10 times the movement; it must stay
below a cap just above the largest bar reached (a step's 1.3e-3 under
2e-3, an epoch's 7.7e-3 under 8e-3), so that a noisier reference cannot
widen the bar unseen.  These narrow GroupNorm models can be that
sensitive: the shrunk SqueezeNet's fire modules normalise groups of one
channel (at 16x16, over 2x2 maps, its epoch moves by 1.2% of its largest
update for that change, so it runs at 32x32 here, where it moves by
4.7e-4).  The epoch runs at lr 1e-3, where the step runs at FLConfig's
0.05: at 0.05 the shrunk models are chaotic over a few steps (the
transformer's epoch moves by 3.3% of its largest update for that
change), and no port can be held closer than the reference holds
itself."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as r_optim
from repro.core import make_adapter as r_make_adapter
from repro.core.progressive import make_full_step as r_make_full_step
from repro.data import Batcher as RBatcher
from repro.data import dirichlet_partition, make_image_dataset
from repro.federated.client import \
    run_local_training_full as r_run_local_training_full
from repro.models.cnn import CNNConfig as RConfig
from repro.models.config import ModelConfig as RModelConfig
from repro_torch import bridge
from repro_torch.analysis.memory import audit_memory, measure_local_training
from repro_torch.core.progressive import make_adapter as t_make_adapter
from repro_torch.core.progressive import make_full_step as t_make_full_step
from repro_torch.data.loader import Batcher as TBatcher
from repro_torch.federated.client import run_local_training_full
from repro_torch.models.cnn import CNNConfig as TConfig
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim.optimizers import sgd as t_sgd

RTOL = 1e-4
EPOCH_TOL = 1e-3
LR = 0.05
EPOCH_LR = 1e-3
STEP_BAR_CAP, EPOCH_BAR_CAP = 2e-3, 8e-3
# (name, arch, image size); width 0.125, 4 classes, 2 stages
CNNS = [("resnet18", "resnet18", 8), ("vgg11", "vgg11", 8),
        ("squeezenet", "squeezenet", 32)]
MODELS = [c[0] for c in CNNS] + ["transformer"]


def _close(ref, port, rtol=RTOL, scale=None):
    ref = np.asarray(ref, np.float64)
    port = np.asarray(port.detach().cpu() if torch.is_tensor(port) else port,
                      np.float64)
    assert ref.shape == port.shape
    if scale is None:
        scale = np.abs(ref).max()
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(scale, 1e-6))


def _cnn(arch, size):
    kw = dict(name=arch, arch=arch, num_classes=4, image_size=size,
              width_mult=0.125)
    t_adapter = t_make_adapter(TConfig(**kw), 2)
    t_params = t_adapter.init_params(0, "cpu")
    ds = make_image_dataset(0, 200, num_classes=4, image_size=size)
    parts = dirichlet_partition(0, ds.labels, 4, alpha=1.0)
    return (r_make_adapter(RConfig(**kw), 2), bridge.to_reference(t_params),
            t_adapter, t_params, ds.subset(parts[0]), "image")


@pytest.fixture(scope="module")
def models(tx_setup):
    out = {name: _cnn(arch, size) for name, arch, size in CNNS}
    adapter, params, batchers = tx_setup
    fields = {f.name: getattr(adapter.cfg, f.name)
              for f in dataclasses.fields(RModelConfig)
              if f.name in {g.name for g in dataclasses.fields(TModelConfig)}}
    out["transformer"] = (
        adapter, jax.device_get(params),
        t_make_adapter(TModelConfig(**fields), 2),
        bridge.from_reference(jax.device_get(params), "cpu"),
        batchers[0].ds, "lm")
    return out


def _batch(data, kind, seed=0):
    b = RBatcher(data, 16 if kind == "image" else 8, seed=seed,
                 kind=kind).sample()
    r = jax.tree.map(jnp.asarray, b)
    t = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), b)
    return r, t


def _updates(new, start):
    return [np.asarray(a, np.float64) - np.asarray(s, np.float64)
            for a, s in zip(jax.tree.leaves(new), jax.tree.leaves(start))]


def _bar(tol, cap, run, start):
    """``tol``, or 10 times the relative movement of the reference's update
    ``run(start) - start`` when ``start`` moves by a random 1e-7 relative
    change, where that movement exceeds ``tol / 10``; below ``cap``."""
    rng = np.random.default_rng(0)
    moved = jax.tree.map(lambda a: (np.asarray(a) * (
        1 + 1e-7 * rng.standard_normal(np.shape(a)))).astype(np.float32),
        start)
    upd = _updates(run(start), start)
    sens = max(float(np.abs(a - b).max()) for a, b in zip(
        upd, _updates(run(moved), start))) / max(
            np.abs(u).max() for u in upd)
    bar = tol if sens <= tol / 10 else max(tol, 10 * sens)
    assert bar < cap, f"the reference differs from itself by {sens:.1e}"
    return bar


def _check_updates(r_new, t_new, start, tol):
    """Every leaf's update within ``tol`` of the largest reference
    update (and ``tol`` relative)."""
    r_def = jax.tree.structure(r_new)
    assert jax.tree.structure(bridge.to_reference(t_new)) == r_def
    r_upd = _updates(r_new, start)
    t_upd = _updates(bridge.to_reference(t_new), start)
    scale = max(np.abs(u).max() for u in r_upd if u.size)
    assert scale > 0
    for a, b in zip(r_upd, t_upd, strict=True):
        _close(a, b, rtol=tol, scale=scale)


@pytest.mark.parametrize("name", MODELS)
def test_full_step_matches(models, name):
    """One full-model step from ``{"model": ...}``: the loss and the
    update of every leaf of the whole model."""
    adapter, params, t_adapter, t_params, data, kind = models[name]
    r_batch, t_batch = _batch(data, kind)
    r_opt, t_opt = r_optim.sgd(LR), t_sgd(LR)
    start = {"model": params["model"]}
    r_step = jax.jit(r_make_full_step(adapter, r_opt))
    _, r_new, r_m = r_step(r_opt.init(start), start, r_batch)
    bar = _bar(RTOL, STEP_BAR_CAP,
               lambda p: r_step(r_opt.init(p), p, r_batch)[1], start)
    t_start = {"model": t_params["model"]}
    t_step = t_make_full_step(t_adapter, t_opt)
    _, t_new, t_m = t_step(t_opt.init(t_start), t_start, t_batch)
    assert set(t_m) == {"loss"} and not t_m["loss"].requires_grad
    _close(r_m["loss"], t_m["loss"])
    _check_updates(r_new, t_new, start, bar)
    # the inputs are not modified
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(t_start), jax.tree.leaves(t_params["model"])))


@pytest.mark.parametrize("name", MODELS)
def test_full_local_training_matches(models, name):
    """One client's local epoch of full-model steps, both sides from the
    same data and batcher seed: step count, sample count, mean loss and
    the final params."""
    adapter, params, t_adapter, t_params, data, kind = models[name]
    bs = 16 if kind == "image" else 8
    r_opt, t_opt = r_optim.sgd(EPOCH_LR), t_sgd(EPOCH_LR)
    r_step = jax.jit(r_make_full_step(adapter, r_opt))
    start = {"model": params["model"]}

    def ref_epoch(start):
        return r_run_local_training_full(
            r_step, r_opt, start, RBatcher(data, bs, seed=3, kind=kind), 1)

    ref = ref_epoch(start)
    bar = _bar(EPOCH_TOL, EPOCH_BAR_CAP, lambda p: ref_epoch(p).trainable,
               start)
    port = run_local_training_full(
        t_make_full_step(t_adapter, t_opt), t_opt,
        {"model": t_params["model"]}, TBatcher(data, bs, seed=3, kind=kind),
        1, device="cpu")
    assert port.num_batches == ref.num_batches >= 2
    assert port.num_samples == ref.num_samples == len(data)
    _close(ref.mean_loss, port.mean_loss, rtol=EPOCH_TOL)
    _check_updates(ref.trainable, port.trainable, start, bar)


def test_full_local_training_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_local_training_full(None, None, {}, None, 1)


def test_memory_measurement_raises_off_the_card(models):
    """On a CPU device the measurement raises; it never returns the
    analytic estimate in its place."""
    _, _, t_adapter, t_params, data, kind = models["vgg11"]
    batch = TBatcher(data, 16, kind=kind).sample()
    for stage in (None, 0):
        with pytest.raises(RuntimeError, match="no estimate"):
            measure_local_training(t_adapter, t_params, [batch], t_sgd(LR),
                                   stage=stage, device="cpu")


def test_audit_flags_a_stage_at_or_above_the_full_peak():
    table, failures = audit_memory({0: 100, 1: 250, 2: 200}, 200)
    assert sorted(failures) == [1, 2]
    assert failures[2].startswith(
        "stage 2 peak 200 B >= full-model reference peak 200 B")
    assert "block-wise training no longer saves memory" in failures[1]
    assert [table["stages"][t]["below_full"] for t in "012"] == [
        True, False, False]
    assert table["reference"] == {"program": "full-model-step",
                                  "peak_bytes": 200}


def test_fig6_off_the_card_is_the_reference_analytic_table():
    """``fig6_memory.run(device="cpu")``: the seven analytic rows (the six
    measured models' and the reference's ``granite-smoke``), each equal to
    the reference's ``stage_memory_table`` and ``estimate_full_memory`` to
    the byte, and no measured column."""
    from repro.configs import get_smoke_config as r_smoke
    from repro.configs import xlstm_1_3b as r_xlstm
    from repro.configs.paper_models import vit as r_vit
    from repro.core.memory import estimate_full_memory, stage_memory_table
    from repro_torch.benchmarks import fig6_memory as fig6

    rows = fig6.run(device="cpu")
    r_cases = {arch: (r_make_adapter(RConfig(name=arch, arch=arch), stages),
                      {"analytic": (fig6.PAPER_BATCH, 0)})
               for arch, stages in fig6.CNNS}
    r_cases["vit12"] = (
        r_make_adapter(r_vit(**fig6.VIT), fig6.VIT_STAGES),
        {"seq=0 (the server's)": (fig6.VIT_BATCH, 0),
         f"seq={fig6.VIT_PATCHES} (patches)": (fig6.VIT_BATCH,
                                               fig6.VIT_PATCHES)})
    r_cases["xlstm-1.3b"] = (
        r_make_adapter(dataclasses.replace(r_xlstm.config(), dtype="float32"),
                       fig6.XLSTM_STAGES),
        {f"seq={fig6.XLSTM_SEQ}": (fig6.XLSTM_BATCH, fig6.XLSTM_SEQ)})
    r_cases["granite-smoke"] = (
        r_make_adapter(r_smoke(fig6.GRANITE), fig6.GRANITE_STAGES),
        {f"seq={fig6.GRANITE_SEQ}": (fig6.GRANITE_BATCH, fig6.GRANITE_SEQ)})
    assert set(rows) == set(r_cases) and len(rows) == 7
    for name, (adapter, cases) in r_cases.items():
        row = rows[name]
        assert row["measured"] == "not measured"
        assert set(row["estimate"]) == set(cases)
        for label, (batch, seq) in cases.items():
            stages = [e.total for e in stage_memory_table(adapter, batch,
                                                          seq)]
            full = estimate_full_memory(adapter, batch, seq).total
            assert row["batch"] == batch
            assert row["estimate"][label] == {
                "stage_bytes": stages, "full_bytes": full,
                "reduction": 1.0 - max(stages) / full}, (name, label)


def test_peak_split_replays_the_trace_to_its_peak():
    """``fig6_peak_split.peak_split`` on a made-up allocator trace: the
    peak is where the live bytes are largest, and the blocks live there
    are summed by what allocated them."""
    from repro_torch.benchmarks.fig6_peak_split import peak_split

    def ev(action, addr, size, *names):
        return {"action": action, "addr": addr, "size": size,
                "frames": [{"name": n, "filename": "x.py", "line": 1}
                           for n in names]}

    trace = [
        ev("alloc", 1, 100, "<lambda>", "measure_local_training"),
        ev("alloc", 2, 40, "at::_ops::relu::call", "train_step",
           "run_local_training", "measure_local_training"),
        ev("alloc", 3, 70, "at::native::run_conv_plan", "train_step"),
        ev("free_requested", 3, 70),
        ev("free_completed", 3, 70),
        ev("alloc", 4, 50, "at::native::cudnn_convolution", "train_step"),
        ev("free_requested", 2, 40),
    ]
    out = peak_split(trace, 5)
    assert out["replay_peak_bytes"] == 5 + 100 + 40 + 70
    assert out["by_category"] == {"held tree": 100, "cuDNN workspace": 70,
                                  "outside the port [at::_ops::relu::call]":
                                  40}
    assert out["peak_set_by"]["category"] == "cuDNN workspace"
    assert out["peak_set_by"]["size"] == 70
