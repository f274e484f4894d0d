"""The port's serving path against the JAX reference, on the CPU.

* ``sdpa`` with ``q_offset`` and ``kv_mask``; one attention layer's
  ``gqa_forward(with_cache=True)`` and ``gqa_decode`` (plain, qk-norm, QKV
  bias, a window that the decode wraps, GQA with H = 4 over KV = 2);
  ``causal_conv_step``, ``mlstm_decode`` and ``slstm_decode`` from random
  caches.
* Each of the five ported archs' smoke configs (and qwen3-1.7b's with 2 kv
  heads and the flash kernel on both sides: the reference's Pallas in
  interpret mode, the port's plain version on the CPU): prefill logits and
  caches, then each decode step's logits and caches, at 1e-4 of the
  largest entry, from the same params (drawn by the reference's init
  rules, with numpy) through the bridge; the port's decode against its
  own forward at the reference's 2e-3.
* The two reference quirks the port does not copy: a windowed prefill
  longer than the window (Q1) and an xLSTM prompt shorter than three
  tokens (Q2).  There the port's decode reproduces its forward and the
  reference's does not; on either side of them the two agree.
* The bridge moves every cache leaf as it is.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.common import paramdef as r_pd
from repro.models import attention as r_attn
from repro.models import model as r_model
from repro.models import ssm as r_ssm
from repro.models.config import ModelConfig as RConfig
from repro.models.config import XLSTMConfig as RXLSTM
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch.common.tree import tree_leaves
from repro_torch.models import attention as t_attn
from repro_torch.models import model as t_model
from repro_torch.models import ssm as t_ssm
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.config import XLSTMConfig as TXLSTM

RTOL = 1e-4            # f32 parity with the reference
DECODE_TOL = 2e-3      # decode against forward (tests/test_decode_consistency)
B, P, T = 2, 8, 3      # batch, prompt, decode steps
ARCHS = ["granite-3-8b", "h2o-danube-3-4b", "qwen1.5-4b", "qwen3-1.7b",
         "xlstm-1.3b", "qwen3-1.7b-kv2"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)


def _err(ref, port):
    ref, port = _np(ref), _np(port)
    assert ref.shape == port.shape, (ref.shape, port.shape)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-6)


def _close(ref, port, tol=RTOL):
    err = _err(ref, port)
    assert err <= tol, err


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _init(defs, seed):
    """A reference ParamDef tree drawn as the reference's ``init_params``
    draws it (zeros, ones, 0.02 embeddings, 1/sqrt(fan-in) otherwise), from
    numpy: the same distribution without a compile per leaf."""
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


def _random_params(defs, seed):
    """Every leaf of a reference ParamDef tree drawn at random (norm scales
    around 1), so that zero-initialized biases are exercised too."""
    rng = np.random.default_rng(seed)

    def draw(path, d):
        if path[-1].key == "scale":
            return (1 + 0.1 * rng.standard_normal(d.shape)).astype(np.float32)
        return (0.3 * rng.standard_normal(d.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, defs, is_leaf=r_pd.is_def)


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("causal,window", [(True, 3), (False, 0)])
def test_sdpa_with_offset_and_kv_mask(causal, window):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
    kv_mask = rng.random((2, 7)) < 0.6
    kv_mask[:, 4:7] = True           # every row keeps a key
    want = r_attn.sdpa(q, k, v, causal=causal, window=window, q_offset=4,
                       kv_mask=jnp.asarray(kv_mask))
    got = t_attn.sdpa(_t(q), _t(k), _t(v), causal=causal, window=window,
                      q_offset=4, kv_mask=torch.from_numpy(kv_mask))
    _close(want, got)


ATTN_VARIANTS = {"plain": {}, "qk_norm": {"qk_norm": True},
                 "qkv_bias": {"qkv_bias": True}, "window": {"window": 8},
                 "gqa": {"num_kv_heads": 2, "qk_norm": True,
                         "qkv_bias": True}}


@pytest.mark.parametrize("variant", list(ATTN_VARIANTS))
def test_gqa_prefill_and_decode_match(variant):
    """One layer: the prefill's output and cache (S = 6), then 4 decode
    steps (to position 9: a window of 8 wraps), output and cache each."""
    kw = {**dict(name="t", family="dense", num_layers=1, d_model=32,
                 num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=16,
                 dtype="float32"), **ATTN_VARIANTS[variant]}
    r_cfg, t_cfg = RConfig(**kw), TConfig(**kw)
    params = _random_params(r_attn.gqa_defs(r_cfg), 1)
    t_params = bridge.from_reference(params, "cpu")
    rng = np.random.default_rng(2)
    S, steps = 6, 4
    x = rng.standard_normal((B, S + steps, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    y, cache = r_attn.gqa_forward(params, r_cfg, x[:, :S], pos,
                                  with_cache=True)
    ty, tcache = t_attn.gqa_forward(t_params, t_cfg, _t(x[:, :S]), _t(pos),
                                    with_cache=True)
    _close(y, ty)
    for k in ("k", "v"):
        _close(cache[k], tcache[k])
    target = r_attn.gqa_cache_defs(r_cfg, B, S + steps)
    assert {k: d.shape for k, d in target.items()} == {
        k: d.shape for k, d in t_attn.gqa_cache_defs(t_cfg, B,
                                                     S + steps).items()}
    grow = [(0, 0), (0, target["k"].shape[1] - S), (0, 0), (0, 0)]
    cache = {k: jnp.pad(c, grow) for k, c in cache.items()}
    tcache = {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, grow[1][1]))
              for k, c in tcache.items()}
    for t in range(S, S + steps):
        y, cache = r_attn.gqa_decode(params, r_cfg, x[:, t:t + 1], cache, t)
        ty, tcache = t_attn.gqa_decode(t_params, t_cfg, _t(x[:, t:t + 1]),
                                       tcache, t)
        _close(y, ty)
        for k in ("k", "v"):
            _close(cache[k], tcache[k])


# --------------------------------------------------------------------------- #
# recurrent cells
# --------------------------------------------------------------------------- #
XLSTM_KW = dict(name="x", family="ssm", num_layers=8, d_model=64,
                num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=64,
                dtype="float32")


def _xlstm_cfgs():
    from repro.models.config import xlstm_pattern as r_pattern
    from repro_torch.models.config import xlstm_pattern as t_pattern
    return (RConfig(**XLSTM_KW, pattern=r_pattern(), xlstm=RXLSTM()),
            TConfig(**XLSTM_KW, pattern=t_pattern(), xlstm=TXLSTM()))


def test_causal_conv_step_matches():
    rng = np.random.default_rng(3)
    x_t, buf, w, b = (rng.standard_normal(s).astype(np.float32)
                      for s in [(2, 5), (2, 3, 5), (5, 4), (5,)])
    y, nbuf = r_ssm.causal_conv_step(x_t, buf, w, b)
    ty, tbuf = t_ssm.causal_conv_step(_t(x_t), _t(buf), _t(w), _t(b))
    _close(y, ty)
    _close(nbuf, tbuf)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cell_decode_matches_from_random_cache(kind):
    """One decode step from a random cache (an sLSTM ``m`` of either sign,
    an mLSTM ``n`` away from 0): output and every cache leaf."""
    r_cfg, t_cfg = _xlstm_cfgs()
    params = _init(getattr(r_ssm, f"{kind}_defs")(r_cfg), 4)
    defs = getattr(r_ssm, f"{kind}_cache_defs")(r_cfg, B)
    rng = np.random.default_rng(5)
    cache = {k: rng.standard_normal(d.shape).astype(np.float32)
             for k, d in defs.items()}
    if kind == "slstm":
        cache["n"] = np.abs(cache["n"]) + 0.5
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    y, new = jax.jit(lambda p, x_, c: getattr(r_ssm, f"{kind}_decode")(
        p, r_cfg, x_, c, 5))(params, x, cache)
    ty, tnew = getattr(t_ssm, f"{kind}_decode")(
        bridge.from_reference(params, "cpu"), t_cfg, _t(x),
        bridge.from_reference(cache, "cpu"), 5)
    _close(y, ty)
    assert set(new) == set(tnew)
    for k in new:
        _close(new[k], tnew[k])


# --------------------------------------------------------------------------- #
# whole models at their smoke configs
# --------------------------------------------------------------------------- #
def _arch_cfgs(arch):
    if arch == "qwen3-1.7b-kv2":
        kw = dict(num_kv_heads=2, use_flash_kernel=True)
        return (dataclasses.replace(r_configs.get_smoke_config("qwen3-1.7b"),
                                    **kw),
                dataclasses.replace(t_configs.get_smoke_config("qwen3-1.7b"),
                                    **kw))
    return r_configs.get_smoke_config(arch), t_configs.get_smoke_config(arch)


def _grow(r_cfg, caches, total):
    target = r_pd.shape_tree(r_model.cache_defs(r_cfg, B, total))
    return jax.tree.map(
        lambda c, t: c if c.shape == t.shape else jnp.pad(
            c, [(0, ts - cs) for cs, ts in zip(c.shape, t.shape)]),
        caches, target)


def _reference_serve(r_cfg, params, toks, prompt):
    """The reference's prefill (its caches grown as its serving grows them)
    and its decode steps over ``toks[:, prompt:]``: (prefill logits, grown
    caches, [(step logits, caches after the step)])."""
    total = toks.shape[1]
    logits, caches = jax.jit(lambda p, x: r_model.prefill(
        p, r_cfg, {"tokens": x}))(params, toks[:, :prompt])
    caches = _grow(r_cfg, caches, total)
    out = (jax.device_get(logits), jax.device_get(caches), [])
    decode = jax.jit(lambda p, tok, c, pos: r_model.decode_step(
        p, r_cfg, {"tokens": tok}, c, pos))
    for t in range(prompt, total):
        logits, caches = decode(params, toks[:, t:t + 1], caches,
                                jnp.asarray(t))
        out[2].append((jax.device_get(logits), jax.device_get(caches)))
    return out


def _port_serve(t_cfg, t_params, toks, prompt):
    """The port's prefill and decode steps, as ``_reference_serve``; every
    cache is copied, since decode updates them in place."""
    total = toks.shape[1]
    tt = _t(toks)
    with torch.no_grad():
        logits, caches = t_model.prefill(t_params, t_cfg,
                                         {"tokens": tt[:, :prompt]})
        caches = t_model.grow_caches(t_cfg, caches, toks.shape[0], total)
        out = (logits, bridge.to_reference(caches), [])
        for t in range(prompt, total):
            logits, caches = t_model.decode_step(
                t_params, t_cfg, {"tokens": tt[:, t:t + 1]}, caches, t)
            out[2].append((logits, bridge.to_reference(caches)))
    return out


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One arch served on both sides from the reference's params: (arch,
    port config, port params, tokens, reference side, port side)."""
    r_cfg, t_cfg = _arch_cfgs(request.param)
    params = _init(r_model.model_defs(r_cfg), 0)
    toks = np.random.default_rng(0).integers(
        0, r_cfg.vocab_size, (B, P + T)).astype(np.int32)
    t_params = bridge.from_reference(params, "cpu")
    return (request.param, t_cfg, t_params, toks,
            _reference_serve(r_cfg, params, toks, P),
            _port_serve(t_cfg, t_params, toks, P))


def _close_tree(ref, port, tol=RTOL):
    r_leaves, t_leaves = jax.tree.leaves(ref), tree_leaves(port)
    assert len(r_leaves) == len(t_leaves)
    for r, t in zip(r_leaves, t_leaves):
        _close(r, t, tol)


def test_prefill_matches_reference(served):
    _, _, _, _, (r_logits, r_caches, _), (t_logits, t_caches, _) = served
    assert t_logits.shape == r_logits.shape
    _close(r_logits, t_logits)
    _close_tree(r_caches, t_caches)


def test_decode_steps_match_reference(served):
    _, _, _, _, (_, _, r_steps), (_, _, t_steps) = served
    assert len(r_steps) == len(t_steps) == T
    for (r_logits, r_caches), (t_logits, t_caches) in zip(r_steps, t_steps):
        _close(r_logits, t_logits)
        _close_tree(r_caches, t_caches)


def test_decode_reproduces_own_forward(served):
    """The port's decode logits against its full forward over the prompt
    and the decoded tokens, at the reference's own 2e-3."""
    _, t_cfg, t_params, toks, _, (t_prefill, _, t_steps) = served
    cfg = dataclasses.replace(t_cfg, use_flash_kernel=False)
    with torch.no_grad():
        full = t_model.forward(t_params, cfg, {"tokens": _t(toks)})
    assert float((t_prefill[:, 0] - full[:, P - 1]).abs().max()) \
        < DECODE_TOL
    dec = torch.cat([lg for lg, _ in t_steps], dim=1)
    assert float((dec - full[:, P:]).abs().max()) < DECODE_TOL


# --------------------------------------------------------------------------- #
# the reference quirks Q1 and Q2
# --------------------------------------------------------------------------- #
QUIRKS = {"Q1": ("h2o-danube-3-4b", {"window": 4}, 6),
          "Q2": ("xlstm-1.3b", {}, 2)}
QUIRK_TOTAL = 10


def _quirk(name):
    arch, kw, _ = QUIRKS[name]
    r_cfg = dataclasses.replace(r_configs.get_smoke_config(arch), **kw)
    t_cfg = dataclasses.replace(t_configs.get_smoke_config(arch), **kw)
    params = _init(r_model.model_defs(r_cfg), 0)
    toks = np.random.default_rng(1).integers(
        0, r_cfg.vocab_size, (B, QUIRK_TOTAL)).astype(np.int32)
    return r_cfg, t_cfg, params, toks


@pytest.mark.parametrize("name", list(QUIRKS))
def test_quirk_port_decode_keeps_the_forward(name):
    """Q1 (a window of 4, a prompt of 6) and Q2 (an xLSTM prompt of 2): the
    port's decode reproduces its forward at 2e-3; the reference's differs
    from its own forward by more than 0.1."""
    r_cfg, t_cfg, params, toks = _quirk(name)
    prompt = QUIRKS[name][2]
    t_params = bridge.from_reference(params, "cpu")
    with torch.no_grad():
        full = t_model.forward(t_params, t_cfg, {"tokens": _t(toks)})
    _, _, t_steps = _port_serve(t_cfg, t_params, toks, prompt)
    dec = torch.cat([lg for lg, _ in t_steps], dim=1)
    port_err = float((dec - full[:, prompt:]).abs().max())
    r_full, _, _ = r_model.forward(params, r_cfg, {"tokens": toks},
                                   remat=False)
    _, _, r_steps = _reference_serve(r_cfg, params, toks, prompt)
    r_dec = np.concatenate([lg for lg, _ in r_steps], axis=1)
    ref_err = np.abs(r_dec - np.asarray(r_full)[:, prompt:]).max(axis=(0, 2))
    print(f"{name}: decode logits off the forward, per step: port "
          f"{port_err:.2e} at most, reference {ref_err.tolist()}")
    assert port_err < DECODE_TOL
    assert ref_err.max() > 0.1


@pytest.mark.parametrize("name,prompt", [("Q1", 3), ("Q1", 8), ("Q2", 3),
                                         ("Q2", 8)])
def test_quirk_neighbours_match_reference(name, prompt):
    """A prompt within the window or a multiple of it (Q1), three tokens
    or more (Q2): the port equals the reference at 1e-4."""
    r_cfg, t_cfg, params, toks = _quirk(name)
    r_logits, r_caches, r_steps = _reference_serve(r_cfg, params, toks,
                                                   prompt)
    t_logits, t_caches, t_steps = _port_serve(
        t_cfg, bridge.from_reference(params, "cpu"), toks, prompt)
    _close(r_logits, t_logits)
    _close_tree(r_caches, t_caches)
    for (r_lg, r_c), (t_lg, t_c) in zip(r_steps, t_steps, strict=True):
        _close(r_lg, t_lg)
        _close_tree(r_c, t_c)


# --------------------------------------------------------------------------- #
# the bridge
# --------------------------------------------------------------------------- #
def test_bridge_leaves_cache_leaves_unpermuted():
    """Attention's k/v, the mLSTM's C/n/m and its ``conv`` buffer (a cache
    leaf, not a conv weight) and the sLSTM's c/n/m/h cross both ways as
    they are."""
    rng = np.random.default_rng(6)
    for arch in ("xlstm-1.3b", "qwen3-1.7b"):
        r_cfg = r_configs.get_smoke_config(arch)
        defs = r_model.cache_defs(r_cfg, B, 5)
        caches = jax.tree.map(
            lambda d: rng.standard_normal(d.shape).astype(np.float32),
            defs, is_leaf=r_pd.is_def)
        t_caches = bridge.from_reference(caches, "cpu")
        for r, t in zip(jax.tree.leaves(caches), tree_leaves(t_caches),
                        strict=True):
            assert np.array_equal(r, t.numpy())
        for r, t in zip(jax.tree.leaves(caches),
                        jax.tree.leaves(bridge.to_reference(t_caches)),
                        strict=True):
            assert np.array_equal(r, t)
