"""The port's MoE layer (``repro_torch.models.moe``) and
``launch/steps.py:align_moe_dispatch`` against the JAX reference, on the
CPU.

* ``expert_capacity`` over a grid of token counts, experts, top-k and
  capacity factors.
* ``moe_apply`` from the same params (the reference's init rules through
  the bridge): the output, both aux losses and the gradients of a random
  cotangent into x and every param (the router included), at f32 rtol
  1e-4 of the largest entry; with and without shared experts, at
  ``dispatch_groups`` 1 and 2, and at a capacity factor low enough that
  tokens drop.  The routing is identical: each token's experts and, per
  group, the token of every slot (the reference's ``_dispatch_group``).
* The forward and its gradients repeat to the bit; under
  ``torch.func.vmap`` (the vectorized runtime's cohort axis) each cohort
  gets the bits of its own call.
* ``align_moe_dispatch`` on a 1x1 and a 2x1 ``HostMesh`` and with
  ``REPRO_MOE_GROUPS``, equal to the reference's on a mesh of the same
  shape.
"""
import dataclasses
import itertools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import paramdef as r_pd
from repro.launch import steps as r_steps
from repro.models import moe as r_moe
from repro.models.config import ModelConfig as RConfig
from repro.models.config import MoEConfig as RMoE
from repro_torch import bridge
from repro_torch.common.tree import flatten_paths, tree_leaves, tree_map
from repro_torch.launch import steps as t_steps
from repro_torch.models import moe as t_moe
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.config import MoEConfig as TMoE

RTOL = 1e-4
B, S, D = 2, 12, 32


def _np(a):
    return np.asarray(a.detach().float() if torch.is_tensor(a) else a,
                      np.float64)


def _rel(ref, port):
    ref, port = _np(ref), _np(port)
    assert ref.shape == port.shape, (ref.shape, port.shape)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-6)


def init_defs(defs, seed):
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


def _cfgs(**moe):
    kw = dict(num_experts=4, top_k=2, num_shared=1, d_ff_expert=16)
    kw.update(moe)
    base = dict(name="m", family="moe", num_layers=1, d_model=D,
                num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=16,
                pattern=(("attn", "moe"),), dtype="float32")
    return (RConfig(**base, moe=RMoE(**kw)), TConfig(**base, moe=TMoE(**kw)))


@pytest.mark.parametrize("experts,top_k", list(itertools.product(
    (4, 16, 64, 160), (1, 2, 6))))
def test_expert_capacity_matches_reference(experts, top_k):
    for tokens, cf in itertools.product((1, 7, 64, 1000, 4096),
                                        (1.25, 0.5, 8.0)):
        kw = dict(num_experts=experts, top_k=top_k, capacity_factor=cf)
        c = t_moe.expert_capacity(tokens, TMoE(**kw))
        assert c == r_moe.expert_capacity(tokens, RMoE(**kw))
        assert c >= 8 and c % 8 == 0


CASES = {"shared-g1": {},
         "routed-g2": dict(num_shared=0, dispatch_groups=2),
         # C = 8 slots an expert (the least) for 24 tokens x 2 of 4
         # experts, and for 12 tokens a group x 2 of 2: both drop
         "drop-g1": dict(capacity_factor=0.25),
         "drop-g2": dict(capacity_factor=0.25, dispatch_groups=2,
                         num_experts=2)}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(name, reference cfg, port cfg, params, x, cotangent, the
    reference's (y, aux), its gradients (params, x), its routing)."""
    r_cfg, t_cfg = _cfgs(**CASES[request.param])
    params = init_defs(r_moe.moe_defs(r_cfg), 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    ct = rng.standard_normal((B, S, D)).astype(np.float32)

    @jax.jit
    def run(p, x, ct):
        (y, aux), vjp = jax.vjp(lambda p, x: r_moe.moe_apply(p, r_cfg, x),
                                p, x)
        # d(y . ct + load_balance + 3 router_z)
        g = vjp((ct, {"load_balance": jnp.float32(1.0),
                      "router_z": jnp.float32(3.0)}))
        return y, aux, g
    y, aux, g = run(params, x, ct)
    moe = r_cfg.moe
    N = B * S
    G = moe.dispatch_groups
    C = r_moe.expert_capacity(N // G, moe)
    logits = x.reshape(N, D) @ params["router"]
    _, top_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), moe.top_k)
    slot_tok = jax.vmap(lambda xt, lg: r_moe._dispatch_group(
        xt, lg, moe, C)[1])(jnp.asarray(x.reshape(G, N // G, D)),
                            jnp.asarray(logits.reshape(G, N // G, -1)))
    return (request.param, r_cfg, t_cfg, params, x, ct, (y, aux), g,
            (np.asarray(top_e), np.asarray(slot_tok).reshape(G, -1), C))


def _port(t_cfg, params, x, ct):
    live = tree_map(lambda t: t.clone().requires_grad_(True),
                    bridge.from_reference(params, "cpu"))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = t_moe.moe_apply(live, t_cfg, tx)
    (torch.sum(y * torch.from_numpy(ct)) + aux["load_balance"]
     + 3 * aux["router_z"]).backward()
    return y, aux, tree_map(lambda t: t.grad, live), tx.grad


def test_moe_apply_matches_reference(case):
    name, _, t_cfg, params, x, ct, (r_y, r_aux), (r_gp, r_gx), _ = case
    y, aux, gp, gx = _port(t_cfg, params, x, ct)
    assert y.dtype == torch.float32 and aux["router_z"].dtype == torch.float32
    assert _rel(r_y, y) <= RTOL
    for k in ("load_balance", "router_z"):
        assert _rel(r_aux[k], aux[k]) <= RTOL, k
    assert _rel(r_gx, gx) <= RTOL
    r_flat = flatten_paths(bridge.from_reference(r_gp, "cpu"))
    got = flatten_paths(gp)
    assert sorted(r_flat) == sorted(got)
    assert ("shared/w_up" in got) == (not name.startswith("routed"))
    for k, g in got.items():
        assert float(g.abs().max()) > 0, k
        assert _rel(r_flat[k], g) <= RTOL, k


def test_routing_is_the_reference_s(case):
    name, _, t_cfg, params, x, _, _, _, (r_top_e, r_slot_tok, C) = case
    moe = t_cfg.moe
    N, G = B * S, moe.dispatch_groups
    logits = torch.from_numpy(x.reshape(N, D)) @ torch.from_numpy(
        params["router"])
    top_e = torch.topk(torch.softmax(logits, -1), moe.top_k, dim=-1)[1]
    assert np.array_equal(top_e.numpy(), r_top_e)
    slot_tok, tok_slot, _, _ = t_moe._route(
        top_e.reshape(G, N // G, moe.top_k), moe.num_experts, C)
    assert np.array_equal(slot_tok.numpy(), r_slot_tok)
    # tok_slot is slot_tok's transpose: each token's kept slots, in expert
    # order, then the drop index E*C
    EC = moe.num_experts * C
    for g in range(G):
        for tok in range(N // G):
            kept = sorted(np.flatnonzero(r_slot_tok[g] == tok).tolist())
            row = tok_slot[g, tok].tolist()
            assert row == kept + [EC] * (moe.top_k - len(kept))
    dropped = int((tok_slot == EC).sum())
    assert dropped == N * moe.top_k - int((r_slot_tok < N // G).sum())
    if name.startswith("drop"):
        assert dropped > 0


def test_moe_repeats_to_the_bit(case):
    _, _, t_cfg, params, x, ct, _, _, _ = case
    runs = [_port(t_cfg, params, x, ct) for _ in range(3)]
    first = tree_leaves(runs[0])
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in
                   zip(first, tree_leaves(other), strict=True))


def test_moe_under_vmap_is_each_cohort_s_call(case):
    """Three cohorts' params and inputs under ``torch.func.vmap`` (and
    ``vmap(grad)``) give each cohort the bits of its own call."""
    _, _, t_cfg, params, x, _, _, _, _ = case
    base = bridge.from_reference(params, "cpu")
    stack = tree_map(lambda t: torch.stack([t, 1.1 * t, 0.9 * t]), base)
    xs = torch.from_numpy(np.stack([x, -x, 0.5 * x]))

    def loss(p, xi):
        y, aux = t_moe.moe_apply(p, t_cfg, xi)
        return y.square().sum() + aux["load_balance"] + aux["router_z"]

    ys = torch.func.vmap(lambda p, xi: t_moe.moe_apply(p, t_cfg, xi)[0])(
        stack, xs)
    gs = torch.func.vmap(torch.func.grad(loss))(stack, xs)
    for c in range(3):
        p = tree_map(lambda t, c=c: t[c], stack)
        assert torch.equal(ys[c], t_moe.moe_apply(p, t_cfg, xs[c])[0])
        want = torch.func.grad(loss)(p, xs[c])
        for a, b in zip(tree_leaves(gs), tree_leaves(want), strict=True):
            assert torch.allclose(a[c], b, rtol=1e-6, atol=1e-7)


def _host_mesh(shape):
    """A ``HostMesh`` of ``shape``: the process's one-rank mesh for 1x1;
    for a larger shape the same over a stand-in device mesh of that shape
    (``align_moe_dispatch`` reads the mesh's ``shape`` only)."""
    from repro_torch.launch.mesh import HostMesh, make_host_mesh
    one = make_host_mesh(1, "cpu")
    if shape == (1, 1):
        return one
    dm = SimpleNamespace(size=lambda i: shape[i],
                         get_local_rank=lambda a: 0,
                         get_group=lambda a: None)
    return HostMesh(dm, one.device, one.backend)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1)])
def test_align_moe_dispatch_matches_reference(shape, monkeypatch):
    mesh = _host_mesh(shape)
    assert mesh.shape == {"data": shape[0], "model": shape[1]}
    r_mesh = SimpleNamespace(shape={"data": shape[0], "model": shape[1]})
    r_cfg, t_cfg = _cfgs()
    monkeypatch.delenv("REPRO_MOE_GROUPS", raising=False)
    got = t_steps.align_moe_dispatch(t_cfg, mesh)
    want = r_steps.align_moe_dispatch(r_cfg, r_mesh)
    assert got.moe.dispatch_groups == want.moe.dispatch_groups == shape[0]
    assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
    monkeypatch.setenv("REPRO_MOE_GROUPS", "3")
    assert t_steps.align_moe_dispatch(t_cfg, mesh).moe.dispatch_groups == \
        r_steps.align_moe_dispatch(r_cfg, r_mesh).moe.dispatch_groups == 3
    dense = dataclasses.replace(t_cfg, moe=None, pattern=(("attn", "mlp"),))
    assert t_steps.align_moe_dispatch(dense, mesh) is dense
