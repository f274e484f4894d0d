"""deepseek-v2-lite-16b (MLA + MoE) and jamba-1.5-large-398b (Mamba +
attention + MoE) as whole models in the port against the JAX reference, on
the CPU, from the same params (the reference's init rules through the
bridge).

* Each smoke config (jamba's cut to one period, 8 layers, so that the
  reference compiles each shape once in a few seconds), B = 4 (nHSIC is
  degenerate below 3 rows), S = 16: the forward's logits and ``loss_fn``
  (CE + the MoE aux term), one SGD NeuLite stage step (the last stage:
  loss, CE, nHSIC, new trainable params), and a prefill followed by two decode
  steps, against the reference's jitted functions at rtol 1e-4 of the
  largest entry.
* The stage forward's ``feats["aux"]`` comes from the boundary and active
  periods, never the frozen prefix: deepseek-lite at 4 layers, stage 2,
  against the reference's ``stage_apply``.
* Quirk Q5: an MoE forward drops tokens past capacity over its whole token
  pool, while a decode step sees B tokens and drops none; at capacity
  factor 0.5 the port's decode leaves its forward (as the reference's
  does), at 8.0 (the reference's decode test) it equals it.
* One vectorized round of deepseek-lite (stage 0, 3 cohorts) against the
  reference's ``VectorizedRuntime`` at 1e-3 of the largest update, and
  against the port's sequential runtime (rtol 1e-4, atol 1e-5).
* ``core/memory.py``'s estimates (stage and full-model) of the full
  configs equal the reference's: shape arithmetic only.
* The bridge carries a whole bf16 model (stacked MoE, MLA and Mamba
  leaves, the float32 ones among them) to the bit.
* ``launch/serve.main`` and ``launch/train.main`` run the three archs'
  smoke configs on the CPU.
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
from repro.core import make_stage_step as r_make_step
from repro.core import make_transformer_adapter as r_make_adapter
from repro.core import memory as r_memory
from repro.data import Batcher as RBatcher
from repro.data import make_lm_dataset
from repro.data.loader import stack_round
from repro.federated import runtime as r_rt
from repro.models import model as r_model
from repro.optim import sgd as r_sgd
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch.common.tree import tree_leaves
from repro_torch.core import memory as t_memory
from repro_torch.core.curriculum import CurriculumHP as THP
from repro_torch.core.progressive import (make_stage_step,
                                          make_transformer_adapter)
from repro_torch.federated import runtime as t_rt
from repro_torch.models import model as t_model
from repro_torch.models import moe as t_moe
from repro_torch.optim import sgd as t_sgd
from test_torch_moe import init_defs

RTOL = 1e-4
B, S, DECODE = 4, 16, 2
LR = 0.05
CPU = torch.device("cpu")
ARCHS = ["deepseek-v2-lite-16b", "jamba-1.5-large-398b"]
ALL = ARCHS + ["deepseek-v2-236b"]


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


def _t(tree):
    return bridge.from_reference(tree, "cpu")


def _smoke(pkg, arch, **kw):
    cfg = pkg.get_smoke_config(arch)
    if arch.startswith("jamba"):
        kw.setdefault("num_layers", 8)
    return dataclasses.replace(cfg, **kw)


def _tokens(cfg, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"inputs": {"tokens": toks[:, :-1]}, "labels": toks[:, 1:]}


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(arch, reference cfg, port cfg, numpy params of the adapter, batch,
    the reference's results)."""
    arch = request.param
    r_cfg, t_cfg = _smoke(r_configs, arch), _smoke(t_configs, arch)
    adapter = r_make_adapter(r_cfg, num_stages=4)
    params = init_defs(adapter.defs, 0)
    batch = _tokens(r_cfg, 1)
    model = params["model"]
    ref = {}

    def fwd(p, b):
        logits, _, aux = r_model.forward(p, r_cfg, b["inputs"], remat=False)
        return logits, r_model.loss_fn(p, r_cfg, b), aux
    ref["logits"], ref["loss"], ref["aux"] = jax.jit(fwd)(model, batch)
    # the last stage: deepseek-lite's stage 1 (boundary and active
    # periods), jamba's one stage at one period
    opt = r_sgd(LR)
    t = adapter.plan.num_stages - 1
    frozen, trainable = adapter.split_stage(params, t)
    step = jax.jit(r_make_step(adapter, opt, RHP(), t))
    _, new, m = step(opt.init(trainable), trainable, frozen, batch,
                     trainable)
    ref["step"] = (t, new, m)
    P = S - DECODE
    toks = batch["inputs"]["tokens"]
    logits, caches = jax.jit(lambda p, x: r_model.prefill(p, r_cfg, x))(
        model, {"tokens": toks[:, :P]})
    target = r_pd.shape_tree(r_model.cache_defs(r_cfg, B, S))
    caches = jax.tree.map(lambda c, t: jnp.pad(
        c, [(0, ts - cs) for cs, ts in zip(c.shape, t.shape)]),
        caches, target)
    decode = jax.jit(lambda p, x, c, pos: r_model.decode_step(
        p, r_cfg, x, c, pos))
    ref["prefill"], ref["decode"] = logits, []
    for i in range(DECODE):
        lg, caches = decode(model, {"tokens": toks[:, P + i:P + i + 1]},
                            caches, jnp.asarray(P + i))
        ref["decode"].append(lg)
    return arch, r_cfg, t_cfg, params, batch, ref


def test_loss_fn_with_aux_matches_reference(case):
    _, _, t_cfg, params, batch, ref = case
    model = _t(params["model"])
    aux = t_model.new_aux(CPU)
    with torch.no_grad():
        logits = t_model.forward(model, t_cfg, _t(batch["inputs"]), aux)
        loss = t_model.loss_fn(model, t_cfg, _t(batch))
    _close(ref["logits"], logits)
    _close(ref["loss"], loss)
    for k in ("load_balance", "router_z"):
        _close(ref["aux"][k], aux[k])
        assert float(aux[k]) > 0
    # the loss is the CE plus the aux term
    from repro_torch.models.layers import cross_entropy
    ce = cross_entropy(logits, _t(batch["labels"]))
    _close(float(loss) - float(ce), float(t_moe.moe_aux_loss(aux,
                                                             t_cfg.moe)),
           1e-3)


def test_stage_steps_match_reference(case):
    _, _, t_cfg, params, batch, ref = case
    adapter = make_transformer_adapter(t_cfg, num_stages=4)
    t, r_new, r_m = ref["step"]
    assert adapter.plan.num_stages == t + 1
    opt = t_sgd(LR)
    frozen, trainable = adapter.split_stage(_t(params), t)
    _, new, m = make_stage_step(adapter, opt, THP(), t)(
        opt.init(trainable), trainable, frozen, _t(batch), trainable)
    for k in ("loss", "ce", "nhsic_xz", "nhsic_yz"):
        _close(r_m[k], m[k])
    r_leaves = jax.tree.leaves(r_new)
    assert len(r_leaves) == len(tree_leaves(new))
    for a, b in zip(r_leaves, tree_leaves(new)):
        if a.size:
            _close(a, b)


def test_prefill_and_decode_match_reference(case):
    _, _, t_cfg, params, batch, ref = case
    model = _t(params["model"])
    P = S - DECODE
    toks = torch.from_numpy(batch["inputs"]["tokens"])
    with torch.no_grad():
        logits, caches = t_model.prefill(model, t_cfg,
                                         {"tokens": toks[:, :P]})
        _close(ref["prefill"], logits)
        caches = t_model.grow_caches(t_cfg, caches, B, S)
        for i, r_lg in enumerate(ref["decode"]):
            lg, caches = t_model.decode_step(
                model, t_cfg, {"tokens": toks[:, P + i:P + i + 1]}, caches,
                P + i)
            _close(r_lg, lg)


def test_stage_aux_skips_the_frozen_prefix():
    """deepseek-lite at 4 layers (4 periods), stage 2: a frozen prefix of
    one period, the boundary and the active period; ``feats["aux"]`` is
    the reference's (boundary + active)."""
    arch = "deepseek-v2-lite-16b"
    r_cfg = _smoke(r_configs, arch, num_layers=4)
    t_cfg = _smoke(t_configs, arch, num_layers=4)
    r_ad = r_make_adapter(r_cfg, num_stages=4)
    params = init_defs(r_ad.defs, 2)
    batch = _tokens(r_cfg, 3)
    t_ad = make_transformer_adapter(t_cfg, num_stages=4)
    t = 2
    frozen, trainable = r_ad.split_stage(params, t)
    assert jax.tree.leaves(frozen["prefix"])[0].shape[0] == 1
    _, feats = jax.jit(lambda f, tr, x: r_model.stage_apply(
        f, tr, r_cfg, x, remat=False))(frozen, trainable, batch["inputs"])
    t_frozen, t_train = t_ad.split_stage(_t(params), t)
    with torch.no_grad():
        _, t_feats = t_model.stage_apply(t_frozen, t_train, t_cfg,
                                         _t(batch["inputs"]))
        whole = t_model.new_aux(CPU)
        t_model.forward(_t(params["model"]), t_cfg, _t(batch["inputs"]),
                        whole)
    for k in ("load_balance", "router_z"):
        _close(feats["aux"][k], t_feats["aux"][k])
        # three of the four periods: less than the whole model's
        assert float(t_feats["aux"][k]) < float(whole[k])
    dense = dataclasses.replace(t_cfg, moe=None, pattern=(("attn", "mlp"),))
    assert t_model.stage_apply(
        *make_transformer_adapter(dense, 4).split_stage(
            make_transformer_adapter(dense, 4).init_params(0, "cpu"), 1),
        dense, _t(batch["inputs"]))[1]["aux"] is None


@pytest.mark.parametrize("cf,same", [(0.5, False), (8.0, True)])
def test_quirk_moe_decode_drops_none(cf, same, capsys):
    """Q5: the forward over B x S tokens at capacity factor 0.5 drops
    tokens; a decode step (B tokens, C >= 8) drops none, so its logits
    leave the forward's.  At 8.0 nothing drops and they agree."""
    arch = "deepseek-v2-lite-16b"
    r_cfg = _smoke(r_configs, arch)
    cfg = _smoke(t_configs, arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    model = _t(init_defs(r_model.model_defs(r_cfg), 4))
    toks = torch.from_numpy(_tokens(cfg, 5)["inputs"]["tokens"])
    P = S - 4
    with torch.no_grad():
        full = t_model.forward(model, cfg, {"tokens": toks})
        lg, caches = t_model.prefill(model, cfg, {"tokens": toks[:, :P]})
        caches = t_model.grow_caches(cfg, caches, B, S)
        steps = []
        for i in range(S - P):
            step, caches = t_model.decode_step(
                model, cfg, {"tokens": toks[:, P + i:P + i + 1]}, caches,
                P + i)
            steps.append(step)
    got = torch.cat(steps, 1)
    err = float((got - full[:, P:]).abs().max() / full[:, P:].abs().max())
    with capsys.disabled():
        print(f"\n  Q5, capacity factor {cf}: decode against the forward "
              f"{err:.2e}")
    assert (err <= RTOL) == same, err


def test_vectorized_round_matches_reference():
    arch = "deepseek-v2-lite-16b"
    r_cfg, t_cfg = _smoke(r_configs, arch), _smoke(t_configs, arch)
    r_ad = r_make_adapter(r_cfg, num_stages=2)
    t_ad = make_transformer_adapter(t_cfg, num_stages=2)
    params = init_defs(r_ad.defs, 6)
    ds = make_lm_dataset(0, 48, 8, r_cfg.vocab_size)
    idx = np.arange(len(ds))
    batchers = [RBatcher(ds.subset(idx[i::3]), 4, seed=i, kind="lm")
                for i in range(3)]
    stack = stack_round(batchers, range(3), local_steps=2)
    hp = RHP(mu=0.01)
    r_new, r_m = r_rt.VectorizedRuntime(r_ad, r_sgd(LR), hp).run_stacked(
        params, 0, stack)
    t_params = _t(params)
    thp = THP(mu=0.01)
    vec, m = t_rt.VectorizedRuntime(t_ad, t_sgd(LR), thp, CPU).run_stacked(
        t_params, 0, stack)
    seq, m_s = t_rt.SequentialRuntime(t_ad, t_sgd(LR), thp,
                                      CPU).run_stacked(t_params, 0, stack)
    _, r_start = r_ad.split_stage(params, 0)
    _, t_start = t_ad.split_stage(t_params, 0)
    r_upd = [np.asarray(a, np.float64) - np.asarray(s, np.float64)
             for a, s in zip(jax.tree.leaves(r_new),
                             jax.tree.leaves(r_start))]
    t_upd = [_np(a) - _np(s) for a, s in zip(tree_leaves(vec),
                                             tree_leaves(t_start))]
    scale = max(float(np.abs(u).max()) for u in r_upd if u.size)
    err = max(float(np.abs(a - b).max()) for a, b in zip(r_upd, t_upd)
              if a.size) / scale
    assert err <= 1e-3, err
    _close(float(r_m["mean_local_loss"]), m["mean_local_loss"], 1e-3)
    for a, b in zip(tree_leaves(seq), tree_leaves(vec), strict=True):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_a_bf16_model_to_the_bit(arch):
    """The whole bf16 model across the bridge and back: the stacked MoE
    experts (P, E, d, ff), MLA's (P, r, H, e) and Mamba's ``conv_w`` keep
    their shapes (none is taken for a conv weight), the float32 leaves
    (router, ``A_log``, ``D``, ``dt_bias``) stay float32, every leaf
    keeps its bits."""
    r_cfg = _smoke(r_configs, arch, dtype="bfloat16")
    defs = r_model.model_defs(r_cfg)
    params = jax.tree.map(lambda d, a: np.asarray(jnp.asarray(a, d.dtype)),
                          defs, init_defs(defs, 7), is_leaf=r_pd.is_def)
    got = _t(params)
    back = bridge.reference_layout(got)
    r_leaves = jax.tree.leaves(params)
    assert len(r_leaves) == len(tree_leaves(got)) == len(tree_leaves(back))
    f32 = 0
    for a, t, b in zip(r_leaves, tree_leaves(got), tree_leaves(back)):
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name
        f32 += a.dtype.name == "float32"
        if a.dtype.name == "bfloat16":
            bits = t.view(torch.int16).numpy().view(np.uint16)
            assert np.array_equal(bits, a.view(np.uint16))
        else:
            assert np.array_equal(t.numpy(), a)
        assert torch.equal(b, t)
    assert f32 >= 1
    stacked = t_model.model_defs(_smoke(t_configs, arch))["layers"]
    moe = stacked["sub1" if arch.startswith("jamba") else "sub0"]["ffn"]
    assert len(moe["w_up"].shape) == 4            # (P, E, d, ff)


@pytest.mark.parametrize("arch", ALL)
def test_full_config_memory_estimates_match_reference(arch):
    """``core/memory.py``'s stage and full-model estimates of the full
    configs (its ``mamba`` and ``moe`` branches), at two batch shapes and
    both optimizer slot counts, to the byte.  (Param counts and FLOPs:
    ``tests/test_torch_serve.py``.)"""
    r_ad = r_make_adapter(r_configs.get_config(arch), num_stages=4)
    t_ad = make_transformer_adapter(t_configs.get_config(arch), num_stages=4)
    for batch, seq in ((8, 64), (2, 4096)):
        for slots in (1, 2):
            for t in range(r_ad.plan.num_stages):
                assert dataclasses.asdict(t_memory.estimate_stage_memory(
                    t_ad, t, batch, seq, slots)) == dataclasses.asdict(
                    r_memory.estimate_stage_memory(r_ad, t, batch, seq,
                                                   slots))
            assert dataclasses.asdict(t_memory.estimate_full_memory(
                t_ad, batch, seq, slots)) == dataclasses.asdict(
                r_memory.estimate_full_memory(r_ad, batch, seq, slots))


@pytest.mark.parametrize("arch", ALL)
def test_serve_and_train_main_run_on_the_cpu(arch, tmp_path):
    from repro_torch.launch import serve, train
    out = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "5",
                      "--gen", "3"], device="cpu")
    assert out["tokens"].shape == (2, 3)
    assert int(out["tokens"].max()) < t_configs.get_smoke_config(
        arch).vocab_size
    # 64 sequences a client, one local step each
    res = train.main(["--arch", arch, "--rounds", "1", "--clients", "64",
                      "--cohort", "2", "--batch", "64", "--seq", "8",
                      "--out", str(tmp_path)], device="cpu")
    losses = [m["mean_loss"] for m in res["metrics"]]
    assert len(losses) == 1 and np.all(np.isfinite(losses))
