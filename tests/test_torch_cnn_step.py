"""CNN forward and one NeuLite stage step of the port against the JAX
reference on ``cnn_setup`` (ResNet18, width 0.125, 8x8 images), from the
same converted params and the same numpy batch, under the 2-stage plan of
``cnn_setup`` and under the 4-stage plan of the smoke run, whose middle
stages train a boundary unit and several surrogates together.

Tolerance: f32 at rtol 1e-4, the reference's own backend-equivalence bar;
the two sides differ only in the order of conv and matmul sums.  A step is
judged by its update (new minus start params), not by the new params, so
that a wrong gradient shows: the absolute floor is 1e-4 of the largest
update in the trainable tree, for entries whose update is near 0 on both
sides.

The 4-stage cases use client 2's first batch.  On client 0's first batch
stage 1 sits on a kink of this tiny model: a 1e-7 relative change of the
start params moves the reference's own gradient by 1e-2 of its largest
entry, so no port can agree with it closer than that there.  On clients 1-3
no stage does, and every stage agrees to below 6e-5 of the largest
update."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as r_optim
from repro.core import make_adapter as r_make_adapter
from repro.core.curriculum import CurriculumHP as RHP
from repro.core.progressive import make_stage_step as r_make_step
from repro.models.cnn import CNNConfig as RConfig
from repro_torch import bridge
from repro_torch.common.tree import tree_leaves
from repro_torch.core.curriculum import CurriculumHP as THP
from repro_torch.core.progressive import make_adapter as t_make_adapter
from repro_torch.core.progressive import make_stage_step as t_make_step
from repro_torch.models import cnn as t_cnn
from repro_torch.optim.optimizers import sgd as t_sgd

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the test processes share the cores, and each
    running a pool of threads slows every one of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-4


def _close(ref, port, rtol=RTOL, scale=None):
    ref = np.asarray(ref, np.float64)
    port = np.asarray(port.detach().cpu() if torch.is_tensor(port) else port,
                      np.float64)
    assert ref.shape == port.shape
    if scale is None:
        scale = np.abs(ref).max()
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(scale, 1e-6))


CFG = dict(name="r18", arch="resnet18", num_classes=4, image_size=8,
           width_mult=0.125)


@pytest.fixture(scope="module")
def both(cnn_setup):
    adapter, params, batchers = cnn_setup
    t_adapter = t_make_adapter(t_cnn.CNNConfig(**CFG), 2)
    t_params = bridge.from_reference(jax.device_get(params), "cpu")
    batch = next(batchers[0].epoch())
    return adapter, params, t_adapter, t_params, batch


def _batches(batch):
    r = {"inputs": {"images": jnp.asarray(batch["inputs"]["images"])},
         "labels": jnp.asarray(batch["labels"])}
    t = {"inputs": {"images": torch.from_numpy(batch["inputs"]["images"])},
         "labels": torch.from_numpy(batch["labels"])}
    return r, t


def test_full_forward_matches(both):
    adapter, params, t_adapter, t_params, batch = both
    r_batch, t_batch = _batches(batch)
    _close(adapter.forward_eval(params, r_batch["inputs"]),
           t_adapter.forward_eval(t_params, t_batch["inputs"]))


@pytest.mark.parametrize("t", [0, 1])
def test_stage_apply_matches(both, t):
    adapter, params, t_adapter, t_params, batch = both
    r_batch, t_batch = _batches(batch)
    rf, rt = adapter.split_stage(params, t)
    tf, tt = t_adapter.split_stage(t_params, t)
    r_logits, r_feats = adapter.stage_apply(rf, rt, r_batch["inputs"])
    t_logits, t_feats = t_adapter.stage_apply(tf, tt, t_batch["inputs"])
    _close(r_logits, t_logits)
    for k in ("x_embed", "z_active", "z_proj"):
        _close(r_feats[k], t_feats[k])


def _ref_step(adapter, params, r_batch, t):
    """The reference's step for stage t.  The start tree is 1.01x the
    global ref, so the proximal term is nonzero."""
    opt = r_optim.sgd(0.05)
    step = jax.jit(r_make_step(adapter, opt, RHP(mu=0.01), t))
    rf, rt = adapter.split_stage(params, t)
    rt1 = jax.tree.map(lambda a: a * 1.01, rt)
    _, r_new, r_m = step(opt.init(rt1), rt1, rf, r_batch, rt)
    return rt1, jax.device_get(r_new), jax.device_get(r_m)


def _check_step(t_adapter, t_params, t_batch, ref_step, t, use_kernel):
    """One port step from the reference's start tree: loss, metrics and the
    update of every trainable leaf against the reference's."""
    rt1, r_new, r_m = ref_step
    t_opt = t_sgd(0.05)
    t_step = t_make_step(t_adapter, t_opt,
                         THP(mu=0.01, use_hsic_kernel=use_kernel), t)
    tf, tt = t_adapter.split_stage(t_params, t)
    tt1 = bridge.from_reference(jax.device_get(rt1), "cpu")
    _, t_new, t_m = t_step(t_opt.init(tt1), tt1, tf, t_batch, tt)
    assert set(r_m) == set(t_m)
    for k in r_m:
        _close(r_m[k], torch.as_tensor(t_m[k]))
    assert float(t_m["prox"]) > 0
    start = jax.tree.leaves(jax.device_get(rt1))
    r_leaves, r_def = jax.tree.flatten(r_new)
    t_leaves, t_def = jax.tree.flatten(bridge.to_reference(t_new))
    assert r_def == t_def
    r_upd = [np.asarray(a, np.float64) - s for a, s in zip(r_leaves, start)]
    t_upd = [np.asarray(b, np.float64) - s for b, s in zip(t_leaves, start)]
    scale = max(np.abs(u).max() for u in r_upd)
    assert scale > 0
    for a, b in zip(r_upd, t_upd, strict=True):
        _close(a, b, scale=scale)


@pytest.fixture(scope="module")
def ref_steps(both):
    adapter, params, _, _, batch = both
    r_batch, _ = _batches(batch)
    return {t: _ref_step(adapter, params, r_batch, t) for t in (0, 1)}


@pytest.mark.parametrize("t", [0, 1])
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain-nhsic", "kernel-wrapper-nhsic"])
def test_stage_step_matches(both, ref_steps, t, use_kernel):
    """One step: loss, metrics and the update of the trainable tree.  The
    port runs nHSIC either plain or through its kernel wrapper (which takes
    ``ref.py`` on CPU tensors); the reference runs its plain nHSIC."""
    _, _, t_adapter, t_params, batch = both
    _, t_batch = _batches(batch)
    _check_step(t_adapter, t_params, t_batch, ref_steps[t], t, use_kernel)


@pytest.fixture(scope="module")
def four_stage(cnn_setup):
    """The 4-stage plan on the same model: units (0,3), (3,5), (5,7),
    (7,9), as the smoke run splits full-width ResNet18."""
    _, _, batchers = cnn_setup
    adapter = r_make_adapter(RConfig(**CFG), 4)
    params = adapter.init_params(jax.random.PRNGKey(0))
    t_adapter = t_make_adapter(t_cnn.CNNConfig(**CFG), 4)
    assert [tuple(b) for b in t_adapter.plan.bounds] == [
        (0, 3), (3, 5), (5, 7), (7, 9)]
    t_params = bridge.from_reference(jax.device_get(params), "cpu")
    r_batch, t_batch = _batches(next(batchers[2].epoch()))
    steps = {t: _ref_step(adapter, params, r_batch, t) for t in range(4)}
    return t_adapter, t_params, t_batch, steps


@pytest.mark.parametrize("t", [0, 1, 2, 3])
def test_four_stage_step_matches(four_stage, t):
    """Each stage of the 4-stage plan, nHSIC through the kernel wrapper."""
    t_adapter, t_params, t_batch, steps = four_stage
    _check_step(t_adapter, t_params, t_batch, steps[t], t, use_kernel=True)


@pytest.mark.parametrize("t", [1])
def test_frozen_prefix_gets_no_grad(both, t):
    _, _, t_adapter, t_params, batch = both
    _, t_batch = _batches(batch)
    tf, tt = t_adapter.split_stage(t_params, t)
    assert tf["units"], "stage 1 of cnn_setup has a frozen prefix"
    step = t_make_step(t_adapter, t_sgd(0.05), THP(mu=0.01), t)
    before = [p.clone() for p in tree_leaves(tf)]
    opt = t_sgd(0.05).init(tt)
    _, new, _ = step(opt, tt, tf, t_batch, tt)
    for p, b in zip(tree_leaves(tf), before, strict=True):
        assert p.grad is None and not p.requires_grad and p.equal(b)
    # optimizer state covers the trainable subtree only
    assert len(tree_leaves(opt["mu"])) == len(tree_leaves(tt))
    logits, feats = t_adapter.stage_apply(tf, tt, t_batch["inputs"])
    assert not feats["x_embed"].requires_grad
    assert all(not p.requires_grad for p in tree_leaves(new))
