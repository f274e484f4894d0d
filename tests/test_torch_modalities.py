"""The audio (musicgen-large) and VLM (llava-next-34b) modalities of the
port against the JAX reference, on the CPU, and the LLM pre-training
example.

* ``model_defs``: musicgen has no token embedding and a (4, d, V) head;
  every leaf's shape and spec is the reference's.
* Each arch's smoke config (B = 4: nHSIC is degenerate below 3 rows)
  from the same params (drawn by the reference's init rules with numpy,
  through the bridge): the forward's logits, ``loss_fn``, one SGD stage
  step per stage (loss, metrics, new trainable params) and a prefill
  followed by two decode steps (musicgen from frame embeddings), against
  the reference's jitted functions at rtol 1e-4 of the largest entry.
* ``task_ce`` on the lm, classify, multi-head (mask over the heads) and
  VLM (text-suffix) layouts, and ``label_features`` of (B, S, heads)
  labels, against the reference's.
* ``examples/progressive_llm_pretrain.main`` at ``--steps 8 --d-model 64
  --layers 4 --vocab 256`` on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.common import paramdef as r_pd
from repro.core import CurriculumHP as RHP
from repro.core import curriculum as r_cur
from repro.core import hsic as r_hsic
from repro.core import make_stage_step as r_make_step
from repro.core import make_transformer_adapter as r_make_adapter
from repro.models import model as r_model
from repro.optim import sgd as r_sgd
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch.common.tree import flatten_paths, tree_leaves
from repro_torch.core import curriculum as t_cur
from repro_torch.core import hsic as t_hsic
from repro_torch.core.curriculum import CurriculumHP as THP
from repro_torch.core.progressive import (make_stage_step,
                                          make_transformer_adapter)
from repro_torch.models import model as t_model
from repro_torch.optim import sgd as t_sgd

RTOL = 1e-4
ARCHS = ["musicgen-large", "llava-next-34b"]
B, S, DECODE = 4, 32, 2
LR = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a.detach().float() if torch.is_tensor(a) else a,
                      np.float64)


def _close(ref, port, tol=RTOL):
    ref, port = _np(ref), _np(port)
    assert ref.shape == port.shape, (ref.shape, port.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= tol, err


def _init(defs, seed):
    """A reference ParamDef tree drawn by the reference's init rules, from
    numpy (no compile per leaf)."""
    rng = np.random.default_rng(seed)

    def draw(d):
        if d.init in ("zeros", "ones"):
            return (np.zeros if d.init == "zeros" else np.ones)(
                d.shape, np.float32)
        scale = d.scale if d.scale is not None else (
            0.02 if d.init == "embed" else
            1 / np.sqrt(max(d.shape[-2] if len(d.shape) >= 2
                            else d.shape[-1], 1)))
        return (scale * rng.standard_normal(d.shape)).astype(np.float32)
    return jax.tree.map(draw, defs, is_leaf=r_pd.is_def)


def _batch(cfg, seq, seed):
    """Inputs and labels of ``cfg``'s modality (``token_inputs`` /
    ``label_specs``' shapes), f32 embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "audio":
        inputs = {"embeds": rng.standard_normal(
            (B, seq, cfg.d_model)).astype(np.float32)}
        labels = rng.integers(0, cfg.vocab_size,
                              (B, seq, cfg.num_output_heads))
    else:
        pv = min(cfg.num_vision_patches, seq - 16)
        inputs = {"patches": rng.standard_normal(
            (B, pv, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, seq - pv))
            .astype(np.int32)}
        labels = rng.integers(0, cfg.vocab_size, (B, seq - pv))
    return {"inputs": inputs, "labels": labels.astype(np.int32)}


def _t(tree):
    return bridge.from_reference(tree, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(arch, reference cfg, port cfg, numpy params of the adapter,
    batch, the reference's results)."""
    arch = request.param
    r_cfg = r_configs.get_smoke_config(arch)
    t_cfg = t_configs.get_smoke_config(arch)
    adapter = r_make_adapter(r_cfg, num_stages=4)
    params = _init(adapter.defs, 0)
    batch = _batch(r_cfg, S, 1)
    model = params["model"]
    ref = {}
    # one compile for both
    ref["logits"], ref["loss"] = jax.jit(lambda p, b: (r_model.forward(
        p, r_cfg, b["inputs"], remat=False)[0], r_model.loss_fn(
        p, r_cfg, b)))(model, batch)
    opt = r_sgd(LR)
    ref["steps"] = []
    for t in range(adapter.plan.num_stages):
        frozen, trainable = adapter.split_stage(params, t)
        step = jax.jit(r_make_step(adapter, opt, RHP(), t))
        _, new, m = step(opt.init(trainable), trainable, frozen, batch,
                         trainable)
        ref["steps"].append((new, m))
    # a prefill of the first S - DECODE positions, then DECODE steps
    P = S - DECODE
    prompt = dict(batch["inputs"])
    if r_cfg.modality == "audio":
        prompt["embeds"] = prompt["embeds"][:, :P]
    else:
        prompt["tokens"] = prompt["tokens"][:, :P - prompt["patches"]
                                            .shape[1]]
    logits, caches = jax.jit(lambda p, x: r_model.prefill(p, r_cfg, x))(
        model, prompt)
    pv = prompt.get("patches", np.zeros((B, 0))).shape[1]
    target = r_pd.shape_tree(r_model.cache_defs(r_cfg, B, S))
    caches = jax.tree.map(lambda c, t: jnp.pad(
        c, [(0, ts - cs) for cs, ts in zip(c.shape, t.shape)]),
        caches, target)
    decode = jax.jit(lambda p, x, c, pos: r_model.decode_step(
        p, r_cfg, x, c, pos))
    ref["prefill"] = logits
    ref["decode"] = []
    for i in range(DECODE):
        pos = P + i
        x = ({"embeds": batch["inputs"]["embeds"][:, pos:pos + 1]}
             if r_cfg.modality == "audio" else
             {"tokens": batch["inputs"]["tokens"][:, pos - pv:pos - pv + 1]})
        lg, caches = decode(model, x, caches, jnp.asarray(pos))
        ref["decode"].append((x, lg))
    return arch, r_cfg, t_cfg, params, batch, ref


def test_model_defs_match_reference(case):
    arch, r_cfg, t_cfg, _, _, _ = case
    for smoke in (True, False):
        rc = r_cfg if smoke else r_configs.get_config(arch)
        tc = t_cfg if smoke else t_configs.get_config(arch)
        r_defs = {}
        from repro.common.tree import map_with_path
        map_with_path(r_defs.__setitem__, r_model.model_defs(rc))
        t_defs = flatten_paths(t_model.model_defs(tc))
        assert sorted(r_defs) == sorted(t_defs)
        for path, d in t_defs.items():
            r = r_defs[path]
            spec = list(r.spec)
            while spec and spec[-1] is None:
                spec.pop()
            assert (d.shape, d.spec) == (tuple(r.shape), tuple(spec)), path
    defs = t_model.model_defs(t_cfg)
    if arch == "musicgen-large":
        assert "embed" not in defs
        assert defs["head"]["w_out"].shape == (4, t_cfg.d_model,
                                               t_cfg.vocab_size)
    else:
        assert defs["embed"]["table"].shape == (t_cfg.vocab_size,
                                                t_cfg.d_model)


def test_forward_and_loss_match_reference(case):
    _, _, t_cfg, params, batch, ref = case
    model = _t(params["model"])
    with torch.no_grad():
        logits = t_model.forward(model, t_cfg, _t(batch["inputs"]))
        loss = t_model.loss_fn(model, t_cfg, _t(batch))
    _close(ref["logits"], logits)
    _close(ref["loss"], loss)
    x, _, mask = t_model.embed_inputs(model, t_cfg, _t(batch["inputs"]))
    assert x.shape == (B, S, t_cfg.d_model)
    if t_cfg.modality == "vlm":
        pv = batch["inputs"]["patches"].shape[1]
        assert mask.shape == (B, S) and not mask[:, :pv].any() \
            and mask[:, pv:].all()
    else:
        assert mask is None


def test_stage_steps_match_reference(case):
    _, _, t_cfg, params, batch, ref = case
    adapter = make_transformer_adapter(t_cfg, num_stages=4)
    assert adapter.plan.num_stages == len(ref["steps"])
    opt = t_sgd(LR)
    for t, (r_new, r_m) in enumerate(ref["steps"]):
        frozen, trainable = adapter.split_stage(_t(params), t)
        assert ("embed" in frozen or "embed" in trainable) == \
            (t_cfg.modality != "audio")
        _, new, m = make_stage_step(adapter, opt, THP(), t)(
            opt.init(trainable), trainable, frozen, _t(batch), trainable)
        for k in ("loss", "ce", "nhsic_xz", "nhsic_yz"):
            _close(r_m[k], m[k])
        r_leaves = jax.tree.leaves(r_new)
        assert len(r_leaves) == len(tree_leaves(new))
        for a, b in zip(r_leaves, tree_leaves(new)):
            if a.size:                    # an empty boundary slice
                _close(a, b)


def test_prefill_and_decode_match_reference(case):
    _, r_cfg, t_cfg, params, batch, ref = case
    model = _t(params["model"])
    P = S - DECODE
    prompt = dict(_t(batch["inputs"]))
    if t_cfg.modality == "audio":
        prompt["embeds"] = prompt["embeds"][:, :P]
    else:
        prompt["tokens"] = prompt["tokens"][:, :P - prompt["patches"]
                                            .shape[1]]
    with torch.no_grad():
        logits, caches = t_model.prefill(model, t_cfg, prompt)
        _close(ref["prefill"], logits)
        caches = t_model.grow_caches(t_cfg, caches, B, S)
        for i, (x, r_lg) in enumerate(ref["decode"]):
            lg, caches = t_model.decode_step(model, t_cfg, _t(x), caches,
                                             P + i)
            _close(r_lg, lg)
    shape = (B, 1, t_cfg.num_output_heads, t_cfg.vocab_size) \
        if t_cfg.num_output_heads > 1 else (B, 1, t_cfg.vocab_size)
    assert tuple(lg.shape) == shape


@pytest.mark.parametrize("layout", ["lm", "classify", "heads", "heads_mask",
                                    "vlm"])
def test_task_ce_layouts_match_reference(layout):
    rng = np.random.default_rng(3)
    V, H, St = 11, 3, 5
    cfg = dataclasses.make_dataclass("C", [("task", str, "lm"),
                                           ("num_output_heads", int, 1)])
    mask = None
    if layout == "classify":
        cfg, logits = cfg(task="classify"), rng.standard_normal((B, V))
        labels = rng.integers(0, V, (B,))
    elif layout.startswith("heads"):
        cfg, logits = cfg(num_output_heads=H), rng.standard_normal(
            (B, 7, H, V))
        labels = rng.integers(0, V, (B, 7, H))
        if layout == "heads_mask":
            mask = rng.random((B, 7)) < 0.6
    else:
        cfg, logits = cfg(), rng.standard_normal((B, 7, V))
        labels = rng.integers(0, V, (B, St if layout == "vlm" else 7))
        mask = rng.random((B, 7)) < 0.6
    logits = logits.astype(np.float32)
    want = r_cur.task_ce(jnp.asarray(logits), jnp.asarray(labels), cfg,
                         None if mask is None else jnp.asarray(mask))
    got = t_cur.task_ce(torch.from_numpy(logits), torch.from_numpy(labels),
                        cfg, None if mask is None else torch.from_numpy(mask))
    _close(want, got, 1e-6)


def test_label_features_of_head_labels_match_reference():
    labels = np.random.default_rng(4).integers(0, 2048, (B, 9, 4))
    _close(r_hsic.label_features(jnp.asarray(labels), 2048),
           t_hsic.label_features(torch.from_numpy(labels), 2048), 1e-6)


def test_progressive_llm_pretrain_runs_on_the_cpu(capsys):
    from repro_torch.examples import progressive_llm_pretrain as ex
    out = ex.main(["--steps", "8", "--d-model", "64", "--layers", "4",
                   "--vocab", "256"], device="cpu")
    assert len(out["neulite_losses"]) == len(out["e2e_losses"]) == 8
    assert np.all(np.isfinite(out["neulite_losses"] + out["e2e_losses"]))
    assert out["neulite_ms"] > 0 and out["e2e_ms"] > 0
    assert out["speedup"] == out["e2e_ms"] / out["neulite_ms"]
    # the reference's model at these flags: 4 layers of d 64, 256 tokens
    from repro.models.config import ModelConfig as RConfig
    r_cfg = RConfig(name="pretrain-lm", family="dense", num_layers=4,
                    d_model=64, num_heads=2, num_kv_heads=1, d_ff=256,
                    vocab_size=256, dtype="float32")
    assert out["n_params"] == r_pd.nparams(r_model.model_defs(r_cfg))
    printed = capsys.readouterr().out
    assert "per-step speedup" in printed and "1.84-2.31x" in printed
