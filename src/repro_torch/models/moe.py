"""Mixture-of-Experts layer (port of ``repro.models.moe``), DeepSeek-V2 /
Jamba style.

Sort-based grouped dispatch with a static per-expert capacity C: each
token's top-k experts (of the softmax, renormalised) are sorted by expert
id (stably), ranked within their expert, dropped past C, gathered into an
``(E, C, d)`` buffer, run through the experts' SwiGLU as batched products
and combined back with the router weights.  Routing runs within
``moe.dispatch_groups`` token groups (the mesh's batch shards); the aux
losses (load balance, router z-loss) are taken over all tokens.  DeepSeek's
shared experts are one dense SwiGLU of width ``num_shared * d_ff_expert``
on every token.

Every shape is static and nothing reads a value back to the host, so the
layer runs in a captured CUDA graph and under ``torch.func.vmap``.  The
dispatch and the combine are the two directions of one pair of gathers
(``_GatherSum``): a slot -> token map and a (token, k) -> slot map, each
the other's transpose.  So each direction and its backward is a gather,
summed over k in expert order where a token has several slots: no
scatter-add, whose CUDA atomics would add in a varying order, so the
layer's forward and gradients repeat to the bit.  The combine adds each
slot's float32 product, cast to the model dtype, one k at a time in the
model dtype, as the reference's scatter-add does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common.paramdef import ParamDef
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import MODEL_AXIS, mlp, mlp_defs


def expert_capacity(num_tokens: int, moe: MoEConfig) -> int:
    c = math.ceil(num_tokens * moe.top_k / moe.num_experts
                  * moe.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def moe_defs(cfg: ModelConfig) -> dict:
    moe = cfg.moe
    d, ff = cfg.d_model, moe.d_ff_expert
    dt = cfg.param_dtype
    E = moe.num_experts
    defs = {
        "router": ParamDef((d, E), torch.float32, scale=0.02),
        "w_gate": ParamDef((E, d, ff), dt, (MODEL_AXIS,)),
        "w_up": ParamDef((E, d, ff), dt, (MODEL_AXIS,)),
        "w_down": ParamDef((E, ff, d), dt, (MODEL_AXIS,)),
    }
    if moe.num_shared:
        defs["shared"] = mlp_defs(d, moe.num_shared * ff, dt, act="swiglu")
    return defs


def _gather_sum(src, idx):
    """src (G, N, D), idx (G, M, J) of values in [0, N] -> (G, M, D): row m
    is the sum over j, in order and in src's dtype, of src's row
    idx[:, m, j]; index N is a zero row."""
    G, _, D = src.shape
    pad = torch.cat([src, src.new_zeros((G, 1, D))], dim=1)
    out = None
    for j in range(idx.shape[-1]):
        row = pad.gather(1, idx[..., j, None].expand(-1, -1, D))
        out = row if out is None else out + row
    return out


class _GatherSum(torch.autograd.Function):
    """``_gather_sum(src, idx)`` whose backward is ``_gather_sum(g,
    idx_t)``, idx_t the transpose map of idx (a row of src meets the out
    rows that list it).  Both directions gather, so both repeat to the
    bit."""

    generate_vmap_rule = True

    @staticmethod
    def forward(src, idx, idx_t):
        return _gather_sum(src, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[2])

    @staticmethod
    def backward(ctx, g):
        (idx_t,) = ctx.saved_tensors
        return _gather_sum(g, idx_t), None, None


def _route(top_e, E: int, C: int):
    """Group-local sort-based routing.  top_e: (G, n, K), each token's
    top-k experts.  Returns

    * ``slot_tok`` (G, E*C): the token of each slot (n: empty);
    * ``tok_slot`` (G, n, K): each token's slots in expert order (E*C:
      dropped past capacity);
    * ``slot_flat`` (G, E*C, 1) and ``flat_slot`` (G, n*K, 1): the same
      maps between slots and the flat (token, k) assignments (n*K: empty;
      E*C: dropped), which carry the weights."""
    G, n, K = top_e.shape
    dev = top_e.device
    flat_e = top_e.reshape(G, n * K)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    se = flat_e.gather(1, order)
    counts = torch.zeros((G, E), dtype=se.dtype, device=dev).scatter_add(
        1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(n * K, device=dev) - starts.gather(1, se)
    dest = torch.where(rank < C, se * C + rank,
                       torch.full_like(rank, E * C))
    # slots: each kept assignment has its own; the dropped ones all land on
    # slot E*C, cut off
    slot_flat = torch.full((G, E * C + 1), n * K, dtype=order.dtype,
                           device=dev).scatter(1, dest, order)[:, :E * C]
    flat_slot = torch.empty_like(dest).scatter(1, order, dest)
    slot_tok = slot_flat // K
    tok_slot = torch.sort(flat_slot.reshape(G, n, K), dim=-1).values
    return slot_tok, tok_slot, slot_flat[..., None], flat_slot[..., None]


def moe_apply(params, cfg: ModelConfig, x):
    """x: (B, S, d) -> (y, aux) with aux = {"load_balance", "router_z"},
    float32 scalars over all B*S tokens."""
    moe = cfg.moe
    B, S, d = x.shape
    N = B * S
    E, K = moe.num_experts, moe.top_k
    G = max(1, min(moe.dispatch_groups, N))
    while N % G:
        G -= 1
    n = N // G
    C = expert_capacity(n, moe)

    xt = x.reshape(N, d)
    logits = xt.float() @ params["router"]                       # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)                  # (N, K)

    # ---- aux losses (global statistics) -----------------------------------
    me = probs.mean(dim=0)                                       # (E,)
    experts = torch.arange(E, device=x.device)
    routed = (top_e[..., None] == experts).float().sum(dim=1)    # (N, E)
    ce = routed.mean(dim=0) / K
    aux = {"load_balance": E * torch.sum(me * ce),
           "router_z": torch.logsumexp(logits, dim=-1).square().mean()}

    # ---- group-local dispatch ---------------------------------------------
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    slot_tok, tok_slot, slot_flat, flat_slot = _route(
        top_e.reshape(G, n, K), E, C)
    slot_w = _GatherSum.apply(top_p.reshape(G, n * K, 1), slot_flat,
                              flat_slot)                         # (G, EC, 1)
    buf = _GatherSum.apply(xt.reshape(G, n, d), slot_tok[..., None],
                           tok_slot)                             # (G, EC, d)

    # ---- the experts' SwiGLU, batched over E --------------------------------
    h = buf.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    h = (torch.nn.functional.silu(torch.bmm(h, params["w_gate"]))
         * torch.bmm(h, params["w_up"]))
    out = torch.bmm(h, params["w_down"])                         # (E, GC, d)
    out = out.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # ---- combine: each token's slots, in expert order -----------------------
    upd = (out.float() * slot_w).to(x.dtype)
    y = _GatherSum.apply(upd, tok_slot, slot_tok[..., None]).reshape(N, d)
    if moe.num_shared:
        y = y + mlp(params["shared"], xt, act="swiglu")
    return y.reshape(B, S, d), aux


def moe_aux_loss(aux: dict, moe: MoEConfig):
    return (moe.aux_loss_weight * aux["load_balance"]
            + moe.router_z_weight * aux["router_z"])
