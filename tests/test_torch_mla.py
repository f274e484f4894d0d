"""The port's multi-head latent attention (``repro_torch.models.attention``,
``attn_impl="mla"``) against the JAX reference, on the CPU, from the same
params (the reference's init rules through the bridge).

* deepseek-v2-lite-16b's smoke config (``q_lora_rank`` 0: ``wq``) and the
  same with ``q_lora_rank`` 32 (``w_dq`` -> RMSNorm -> ``w_uq``, the branch
  only deepseek-v2-236b takes; ``reduced()`` sets it to 0): the forward,
  its cache (``ckv``, ``krope``) and the gradients of a random cotangent
  into x and every param, at f32 rtol 1e-4 of the largest entry; a prefill
  of P, its cache grown to the horizon, then absorbed decode steps against
  the reference's (slot ``min(pos, S - 1)``), and against the forward over
  the whole sequence.
* The full configs' MLA param and cache shapes equal the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import attention as r_attn
from repro.models.config import MLAConfig as RMLA
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch.common.tree import flatten_paths, tree_map
from repro_torch.models import attention as t_attn
from repro_torch.models.config import MLAConfig as TMLA
from test_torch_moe import _rel, init_defs

RTOL = 1e-4
B, S, P = 2, 24, 20


@pytest.fixture(scope="module", params=[0, 32], ids=["wq", "q_lora32"])
def setup(request):
    r_cfg = r_configs.get_smoke_config("deepseek-v2-lite-16b")
    t_cfg = t_configs.get_smoke_config("deepseek-v2-lite-16b")
    q = request.param
    r_cfg = dataclasses.replace(r_cfg, mla=dataclasses.replace(
        r_cfg.mla, q_lora_rank=q))
    t_cfg = dataclasses.replace(t_cfg, mla=dataclasses.replace(
        t_cfg.mla, q_lora_rank=q))
    params = init_defs(r_attn.mla_defs(r_cfg), 0)
    assert ("w_uq" in params) == bool(q) and ("wq" in params) != bool(q)
    x = np.random.default_rng(1).standard_normal(
        (B, S, r_cfg.d_model)).astype(np.float32)
    return r_cfg, t_cfg, params, x


def test_mla_forward_matches_reference(setup):
    r_cfg, t_cfg, params, x = setup
    ct = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))

    @jax.jit
    def run(p, x):
        (y, cache), vjp = jax.vjp(lambda p, x: r_attn.attn_forward(
            p, r_cfg, x, pos, with_cache=True), p, x)
        zero = jax.tree.map(jnp.zeros_like, cache)
        return y, cache, vjp((jnp.asarray(ct), zero))
    r_y, r_cache, (r_gp, r_gx) = run(params, x)
    live = tree_map(lambda t: t.clone().requires_grad_(True),
                    bridge.from_reference(params, "cpu"))
    tx = torch.from_numpy(x).requires_grad_(True)
    tpos = torch.arange(S)[None].expand(B, S)
    y, cache = t_attn.attn_forward(live, t_cfg, tx, tpos, with_cache=True)
    torch.sum(y * torch.from_numpy(ct)).backward()
    assert _rel(r_y, y) <= RTOL
    assert sorted(cache) == ["ckv", "krope"]
    for k in cache:
        assert _rel(r_cache[k], cache[k]) <= RTOL, k
    assert _rel(r_gx, tx.grad) <= RTOL
    want = flatten_paths(bridge.from_reference(r_gp, "cpu"))
    got = flatten_paths(tree_map(lambda t: t.grad, live))
    assert sorted(want) == sorted(got)
    for k, g in got.items():
        assert _rel(want[k], g) <= RTOL, k


def test_mla_absorbed_decode_matches_reference(setup):
    r_cfg, t_cfg, params, x = setup
    pos = jnp.broadcast_to(jnp.arange(P)[None], (B, P))
    _, cache = jax.jit(lambda p, x: r_attn.attn_forward(
        p, r_cfg, x, pos, with_cache=True))(params, x[:, :P])
    cache = jax.tree.map(lambda c: jnp.pad(
        c, ((0, 0), (0, S - P), (0, 0))), cache)
    dec = jax.jit(lambda p, x, c, t: r_attn.attn_decode(p, r_cfg, x, c, t))
    tp = bridge.from_reference(params, "cpu")
    tx = torch.from_numpy(x)
    with torch.no_grad():
        full = t_attn.attn_forward(tp, t_cfg, tx, torch.arange(S)[None]
                                   .expand(B, S))
        _, tc = t_attn.attn_forward(tp, t_cfg, tx[:, :P],
                                    torch.arange(P)[None].expand(B, P),
                                    with_cache=True)
        tc = {k: torch.nn.functional.pad(c, (0, 0, 0, S - P))
              for k, c in tc.items()}
        for t in range(P, S):
            r_y, cache = dec(params, x[:, t:t + 1], cache, t)
            y, tc = t_attn.attn_decode(tp, t_cfg, tx[:, t:t + 1], tc, t)
            assert _rel(r_y, y) <= RTOL, t
            assert _rel(full[:, t:t + 1], y) <= RTOL, t
        for k in tc:
            assert _rel(cache[k], tc[k]) <= RTOL, k
        # past the horizon the last slot is overwritten, as the reference's
        r_y, _ = dec(params, x[:, :1], cache, S + 3)
        y, _ = t_attn.attn_decode(tp, t_cfg, tx[:, :1], tc, S + 3)
        assert _rel(r_y, y) <= RTOL


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v2-236b"])
def test_full_mla_shapes_match_reference(arch):
    r_cfg, t_cfg = r_configs.get_config(arch), t_configs.get_config(arch)
    assert dataclasses.asdict(t_cfg.mla) == dataclasses.asdict(r_cfg.mla)
    assert TMLA() == TMLA(**dataclasses.asdict(RMLA()))
    r_defs = flatten_paths(jax.tree.map(
        lambda d: tuple(d.shape), r_attn.attn_defs(r_cfg),
        is_leaf=lambda d: hasattr(d, "shape")))
    t_defs = flatten_paths(tree_map(lambda d: d.shape,
                                    t_attn.attn_defs(t_cfg)))
    assert r_defs == t_defs
    for k, d in t_attn.attn_cache_defs(t_cfg, 2, 64).items():
        assert d.shape == tuple(r_attn.attn_cache_defs(r_cfg, 2, 64)[k]
                                .shape)
