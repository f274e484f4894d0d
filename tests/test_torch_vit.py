"""The transformer path of the port against the JAX reference, on the CPU.

* The shrunk ViT ``vit(num_classes=10, image_size=32, num_layers=6,
  d_model=48)`` (6 heads of 8, 16 patches, 3 stages), attention through the
  flash op on both sides (the reference's Pallas kernel in interpret mode,
  the port's kernel wrapper taking its plain version on CPU tensors):
  ``stage_apply`` and one stage step per stage at rtol 1e-4, and two rounds
  of the sequential server from bridged params (update at 1e-3, see
  ``test_two_rounds_match``).
* ``tx_setup`` (dense text, causal, swiglu), the plain attention path: one
  step of stage 0 and of stage 1.
* The paper's ViT-12 at full width (d_model 384, 12 periods, batch 4),
  plain path: each of the 12 periods alone (output and VJP, fed the
  reference's input to it), and one stage-0 step at 3 periods.  Whole-model
  parity at 12 periods is not defined at the reference's init (see
  ``test_full_width_vit12_is_chaotic_at_init``).

A step is judged by its update (new minus start params), as in
``test_torch_cnn_step.py``: rtol 1e-4 with an absolute floor of 1e-4 of the
largest update in the trainable tree.  The start tree is 1.01x the global
ref, so the proximal term is nonzero.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as r_optim
from repro.configs.paper_models import vit as r_vit
from repro.core import make_adapter as r_make_adapter
from repro.core.curriculum import CurriculumHP as RHP
from repro.core.progressive import make_stage_step as r_make_step
from repro.data import dirichlet_partition, make_image_dataset
from repro.federated.server import FLConfig as RFLConfig
from repro.federated.server import NeuLiteServer as RServer
from repro.models.config import ModelConfig as RModelConfig
from repro_torch import bridge
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs.paper_models import vit as t_vit
from repro_torch.core.curriculum import CurriculumHP as THP
from repro_torch.core.progressive import make_adapter as t_make_adapter
from repro_torch.core.progressive import make_stage_step as t_make_step
from repro_torch.federated.server import FLConfig as TFLConfig
from repro_torch.federated.server import NeuLiteServer as TServer
from repro_torch.kernels.flash_attention import kernel as t_flash_kernel
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim.optimizers import sgd as t_sgd

RTOL = 1e-4
SMALL = dict(num_classes=10, image_size=32, num_layers=6, d_model=48)


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                      np.float64)


def _close(ref, port, rtol=RTOL, scale=None):
    ref, port = _np(ref), _np(port)
    assert ref.shape == port.shape
    if scale is None:
        scale = np.abs(ref).max()
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(scale, 1e-6))


def _batches(batch):
    r = {"inputs": {k: jnp.asarray(v) for k, v in batch["inputs"].items()},
         "labels": jnp.asarray(batch["labels"])}
    t = {"inputs": {k: torch.from_numpy(np.asarray(v))
                    for k, v in batch["inputs"].items()},
         "labels": torch.from_numpy(np.asarray(batch["labels"]))}
    return r, t


def _ref_step(adapter, params, r_batch, t):
    opt = r_optim.sgd(0.05)
    step = jax.jit(r_make_step(adapter, opt, RHP(mu=0.01), t))
    rf, rt = adapter.split_stage(params, t)
    rt1 = jax.tree.map(lambda a: a * 1.01, rt)
    _, r_new, r_m = step(opt.init(rt1), rt1, rf, r_batch, rt)
    return rt1, jax.device_get(r_new), jax.device_get(r_m)


def _check_step(t_adapter, t_params, t_batch, ref_step, t, use_kernel=True):
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
    scale = max(np.abs(u).max() for u in r_upd if u.size)
    assert scale > 0
    for a, b in zip(r_upd, t_upd, strict=True):
        _close(a, b, scale=scale)


# --------------------------------------------------------------------------- #
# the shrunk ViT, attention through the flash op on both sides
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def small_vit():
    r_cfg = dataclasses.replace(r_vit(**SMALL), use_flash_kernel=True)
    t_cfg = dataclasses.replace(t_vit(**SMALL), use_flash_kernel=True)
    adapter = r_make_adapter(r_cfg, 3)
    t_adapter = t_make_adapter(t_cfg, 3)
    assert [tuple(b) for b in t_adapter.plan.bounds] == [(0, 2), (2, 4),
                                                         (4, 6)]
    params = adapter.init_params(jax.random.PRNGKey(0))
    t_params = bridge.from_reference(jax.device_get(params), "cpu")
    ds = make_image_dataset(0, 8, num_classes=10, image_size=32)
    batch = {"inputs": {"images": ds.images}, "labels": ds.labels}
    return adapter, params, t_adapter, t_params, batch


def test_patch_count_forward_and_loss_match(small_vit):
    adapter, params, t_adapter, t_params, batch = small_vit
    r_batch, t_batch = _batches(batch)
    from repro_torch.models.model import patchify
    assert tuple(patchify(t_adapter.cfg, t_batch["inputs"]["images"])
                 .shape) == (8, 16, 192)
    _close(adapter.forward_eval(params, r_batch["inputs"]),
           t_adapter.forward_eval(t_params, t_batch["inputs"]))
    from repro.models.model import loss_fn as r_loss_fn
    from repro_torch.models.model import loss_fn as t_loss_fn
    _close(r_loss_fn(params["model"], adapter.cfg, r_batch),
           t_loss_fn(t_params["model"], t_adapter.cfg, t_batch))


@pytest.mark.parametrize("t", [0, 1, 2])
def test_stage_apply_matches(small_vit, t):
    adapter, params, t_adapter, t_params, batch = small_vit
    r_batch, t_batch = _batches(batch)
    rf, rt = adapter.split_stage(params, t)
    tf, tt = t_adapter.split_stage(t_params, t)
    tt = tree_map(lambda p: p.detach().requires_grad_(True), tt)
    r_logits, r_feats = adapter.stage_apply(rf, rt, r_batch["inputs"])
    t_logits, t_feats = t_adapter.stage_apply(tf, tt, t_batch["inputs"])
    _close(r_logits, t_logits)
    for k in ("x_embed", "z_active", "z_proj"):
        _close(r_feats[k], t_feats[k])
    # stage 0 trains the patch embedding: x_embed carries gradient there
    assert t_feats["x_embed"].requires_grad == (t == 0)


@pytest.mark.parametrize("t", [0, 1, 2])
def test_stage_step_matches(small_vit, t):
    adapter, params, t_adapter, t_params, batch = small_vit
    r_batch, t_batch = _batches(batch)
    _check_step(t_adapter, t_params, t_batch,
                _ref_step(adapter, params, r_batch, t), t)


def test_split_merge_round_trip_and_empty_slices(small_vit):
    _, _, t_adapter, t_params, _ = small_vit
    f0, tr0 = t_adapter.split_stage(t_params, 0)
    assert tr0["boundary"]["sub0"]["mixer"]["wq"].shape[0] == 0
    assert "embed" in tr0 and "embed" not in f0
    f2, tr2 = t_adapter.split_stage(t_params, 2)
    assert tr2["surrogates"] is None and "embed" in f2
    bumped = {**tr2, "active": tree_map(lambda a: a + 1.0, tr2["active"])}
    wq = t_params["model"]["layers"]["sub0"]["mixer"]["wq"].clone()
    merged = t_adapter.merge_stage(t_params, bumped, 2)
    # the views split_stage handed out are not written
    assert t_params["model"]["layers"]["sub0"]["mixer"]["wq"].equal(wq)
    new_wq = merged["model"]["layers"]["sub0"]["mixer"]["wq"]
    assert new_wq[:4].equal(wq[:4]) and new_wq[4:].equal(wq[4:] + 1.0)


ROUND_TOL = 1e-3


@pytest.fixture(scope="module")
def vit_servers(small_vit):
    """Two rounds (stages 0 and 1) of the reference's server, of the port's
    from the bridged params, and of the reference's again from params
    scaled by 1 + 1e-7 (its own sensitivity)."""
    adapter, params, _, _, _ = small_vit
    fl = dict(n_devices=12, clients_per_round=2, local_epochs=1,
              batch_size=8, lr=0.05, num_stages=3, mu=0.01, seed=0)
    ds = make_image_dataset(0, 96, num_classes=10, image_size=32)
    parts = dirichlet_partition(0, ds.labels, fl["n_devices"], alpha=1.0)
    clients = [ds.subset(p) for p in parts]
    refs = []
    for eps in (0.0, 1e-7):
        ref = RServer(adapter, clients, RFLConfig(**fl))
        ref.params = jax.tree.map(lambda a, eps=eps: a * (1 + eps), params)
        ref.run(2)
        refs.append(ref)
    t_cfg = dataclasses.replace(t_vit(**SMALL), use_flash_kernel=True)
    port = TServer(t_make_adapter(t_cfg, 3), clients,
                   TFLConfig(**fl, use_hsic_kernel=True),
                   params=bridge.from_reference(jax.device_get(params),
                                                "cpu"), device="cpu")
    t_flash_kernel.reset_launches()
    port.run(2)
    return refs, port, jax.device_get(params)


def _update_err(new, other, start):
    """Largest difference of two runs' params over the largest entry of
    the first run's update (new minus start)."""
    new, other, start = ([np.asarray(a, np.float64) for a in
                          jax.tree.leaves(jax.device_get(t))]
                         for t in (new, other, start))
    scale = max(np.abs(a - s).max() for a, s in zip(new, start))
    assert scale > 0
    return max(float(np.abs(a - b).max())
               for a, b in zip(new, other, strict=True)) / scale


def test_two_rounds_match(vit_servers):
    """Cohorts, feasibility, step counts and upload bytes identical; loss
    at rtol 1e-4; the params' update at 1e-3 of the largest update.

    Not 1e-4 for the update: the reference, started from params 1e-7
    apart, itself differs by more than 1e-4 of the largest update after
    these two rounds (1.2e-4 with flash attention on this fixture), as the
    near one-hot attention of the reference's init amplifies f32 rounding
    (see ``test_full_width_vit12_is_chaotic_at_init``)."""
    (ref, ref_eps), port, start = vit_servers
    assert [h.stage for h in ref.history] == [0, 1]
    for rh, th in zip(ref.history, port.history, strict=True):
        assert (rh.round_idx, rh.stage, rh.n_selected, rh.n_feasible,
                rh.upload_bytes) == (th.round_idx, th.stage, th.n_selected,
                                     th.n_feasible, th.upload_bytes)
        assert rh.n_selected > 0
        assert rh.sim_time == pytest.approx(th.sim_time, rel=1e-12)
        assert abs(th.mean_loss - rh.mean_loss) <= RTOL * abs(rh.mean_loss)
    assert _update_err(ref.params, ref_eps.params, start) > RTOL
    assert _update_err(ref.params, bridge.to_reference(port.params),
                       start) <= ROUND_TOL
    # on the CPU the flash wrapper takes its plain version: no launch
    assert t_flash_kernel.LAUNCHES == {"flash_attention_fwd": 0}


# --------------------------------------------------------------------------- #
# tx_setup: dense text, causal, swiglu, plain attention
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def text(tx_setup):
    adapter, params, batchers = tx_setup
    fields = {f.name: getattr(adapter.cfg, f.name)
              for f in dataclasses.fields(RModelConfig)
              if f.name in {g.name for g in dataclasses.fields(TModelConfig)}}
    t_adapter = t_make_adapter(TModelConfig(**fields), 2)
    t_params = bridge.from_reference(jax.device_get(params), "cpu")
    return adapter, params, t_adapter, t_params, next(batchers[0].epoch())


@pytest.mark.parametrize("t", [0, 1])
def test_text_stage_step_matches(text, t):
    adapter, params, t_adapter, t_params, batch = text
    assert adapter.cfg.causal and adapter.cfg.act == "swiglu"
    r_batch, t_batch = _batches(batch)
    _check_step(t_adapter, t_params, t_batch,
                _ref_step(adapter, params, r_batch, t), t)


# --------------------------------------------------------------------------- #
# the paper's ViT-12 at full width
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def vit12():
    """Full-width ViT-12 on both sides, the reference's period inputs and
    outputs at batch 4, and a numpy cotangent per period."""
    from repro.models import model as r_model
    adapter = r_make_adapter(r_vit(), 3)
    t_adapter = t_make_adapter(t_vit(), 3)
    params = adapter.init_params(jax.random.PRNGKey(1))
    t_params = bridge.from_reference(jax.device_get(params), "cpu")
    ds = make_image_dataset(0, 4, num_classes=100, image_size=64)
    r_batch, t_batch = _batches({"inputs": {"images": ds.images},
                                 "labels": ds.labels})
    x, pos, _ = r_model.embed_inputs(params["model"], adapter.cfg,
                                     r_batch["inputs"])

    @jax.jit
    def period(lp, x):
        return r_model._run_periods(lp, adapter.cfg, x, pos, remat=False)[0]

    rng = np.random.default_rng(0)
    chain = []
    for i in range(12):
        lp = jax.tree.map(lambda a, i=i: a[i:i + 1], params["model"]["layers"])
        g = rng.standard_normal(x.shape).astype(np.float32)
        y, vjp = jax.vjp(period, lp, x)
        chain.append((np.asarray(x), np.asarray(y), g,
                      jax.device_get(vjp(jnp.asarray(g)))))
        x = y
    return adapter, params, t_adapter, t_params, r_batch, t_batch, chain


def test_full_width_vit12_shape(vit12):
    adapter, params, t_adapter, t_params, _, t_batch, _ = vit12
    cfg = t_adapter.cfg
    assert (cfg.d_model, cfg.num_periods, cfg.num_heads,
            cfg.resolved_head_dim, cfg.d_ff) == (384, 12, 6, 64, 1536)
    assert [tuple(b) for b in t_adapter.plan.bounds] == [(0, 4), (4, 8),
                                                         (8, 12)]
    from repro.common import paramdef as r_pd
    from repro_torch.common import paramdef as t_pd
    # model, surrogates and projector: 88.2 MB in f32
    assert t_pd.nparams(t_adapter.defs) == r_pd.nparams(adapter.defs) \
        == 22_044_672
    assert t_pd.nbytes(t_adapter.defs) == r_pd.nbytes(adapter.defs)
    from repro_torch.models.model import embed_inputs
    x, _, _ = embed_inputs(t_params["model"], cfg, t_batch["inputs"])
    assert tuple(x.shape) == (4, 64, 384)


@pytest.mark.parametrize("i", range(12))
def test_full_width_vit12_period_matches(vit12, i):
    """Period i of the full-width model, fed the reference's input to it:
    output, and the VJP to its params and input, at rtol 1e-4."""
    from repro_torch.models.model import _run_periods
    _, _, t_adapter, t_params, _, _, chain = vit12
    x, y, g, (r_dp, r_dx) = chain[i]
    lp = tree_map(lambda a: a[i:i + 1].detach().requires_grad_(True),
                  t_params["model"]["layers"])
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    B, S = x.shape[:2]
    pos = torch.arange(S)[None].expand(B, S)
    ty = _run_periods(lp, t_adapter.cfg, tx, pos)
    _close(y, ty)
    leaves = tree_leaves(lp)
    grads = torch.autograd.grad(ty, [tx] + leaves, torch.from_numpy(g))
    _close(r_dx, grads[0])
    for r_leaf, t_leaf in zip(jax.tree.leaves(r_dp), grads[1:], strict=True):
        _close(r_leaf, t_leaf)


def test_full_width_vit12_is_chaotic_at_init(vit12):
    """Why no whole-model parity at full depth: at the reference's init the
    attention logits have a std of ~64 (``wq``/``wk`` take their fan-in
    from the head axis), the softmax is nearly one-hot, and a change of
    1e-7 in the embedded input grows ~10x per period.  The reference then
    disagrees with itself by > 1e-1 of the largest activation after 12
    periods, so any f32 reordering of sums (the port's included) does too.
    Whole-step parity is checked at the depth where it is defined
    (``test_full_width_vit12_stage0_step_matches``); every period is
    checked alone at full depth above."""
    from repro.models import model as r_model
    adapter, params, _, _, r_batch, _, chain = vit12
    x, _, _ = r_model.embed_inputs(params["model"], adapter.cfg,
                                   r_batch["inputs"])
    B, S = x.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    y, _, _ = r_model._run_periods(params["model"]["layers"], adapter.cfg,
                                   x * (1 + 1e-7), pos, remat=False)
    ref_out = chain[-1][1]
    rel = float(np.abs(np.asarray(y) - ref_out).max()
                / np.abs(ref_out).max())
    assert rel > 1e-1, rel


def test_full_width_vit12_stage0_step_matches():
    """One stage step at full width (d_model 384, 6 heads of 64, 64x64
    images, 100 classes, batch 4) at the depth where parity is defined:
    3 periods, stage 0 (patch embedding, one active period, two
    surrogates, projector, head), plain path on both sides."""
    adapter = r_make_adapter(r_vit(num_layers=3), 3)
    t_adapter = t_make_adapter(t_vit(num_layers=3), 3)
    params = adapter.init_params(jax.random.PRNGKey(1))
    t_params = bridge.from_reference(jax.device_get(params), "cpu")
    ds = make_image_dataset(0, 4, num_classes=100, image_size=64)
    r_batch, t_batch = _batches({"inputs": {"images": ds.images},
                                 "labels": ds.labels})
    _check_step(t_adapter, t_params, t_batch,
                _ref_step(adapter, params, r_batch, 0), 0, use_kernel=False)
