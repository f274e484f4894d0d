"""Transformer assembly (port of ``repro.models.model``): embeddings ->
stacked period layers -> norm -> head, and the NeuLite stage forward.

Params of the layer stack are stacked over ``num_periods`` (the leading
axis of every leaf), as in the reference; ``_run_periods`` runs them with a
Python loop over that axis where the reference scans.  The port keeps every
activation for the backward (no ``jax.remat``-style recomputation): the
numbers are the same, the memory is not.

Entry points:
  ``forward``      full-model logits (evaluation)
  ``loss_fn``      full-model training loss
  ``prefill``      a prompt's last-position logits and the per-layer caches
  ``decode_step``  one token against those caches (serving)
  ``stage_apply``  NeuLite stage t: frozen embedding and prefix (no grad),
                   trainable boundary and active periods, surrogate output
                   module, head, nHSIC projector.

Caches are the mixers' (``attention``, ``ssm``), per pattern position
``sub{j}`` and stacked over the periods, as in the reference.
``decode_step`` updates them in place and returns them.

MoE sub-layers (``ffn == "moe"``, ``models.moe``) add their aux losses
(``load_balance``, ``router_z``, float32) into the ``aux`` dict that
``_run_periods`` is given; ``loss_fn`` adds ``moe_aux_loss`` of them to the
CE, and ``stage_apply`` returns those of the boundary and active periods
(never the frozen prefix's) as ``feats["aux"]``.  Dense MLP layers of a MoE
config are ``moe.d_ff_dense`` wide where it is set, as in the reference.

Modalities, as in the reference: ``text`` (tokens), ``image`` (patches of
the ViT), ``audio`` (MusicGen: precomputed frame embeddings in, no token
embedding, one output head per codebook, labels (B, S, heads)) and
``vlm`` (LLaVA-NeXT: precomputed patch embeddings before the text's
token embeddings; the loss covers the text positions only).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.paramdef import ParamDef, nparams, stack_defs
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MODEL_AXIS, cross_entropy, embed,
                                       embedding_defs, gelu, head_defs,
                                       lm_head, mlp, mlp_defs, rmsnorm,
                                       rmsnorm_defs)


# --------------------------------------------------------------------------- #
# sub-layers
# --------------------------------------------------------------------------- #
def _mixer_defs(cfg: ModelConfig, kind: str) -> dict:
    fn = {"attn": attn.attn_defs, "mamba": ssm.mamba_defs,
          "mlstm": ssm.mlstm_defs, "slstm": ssm.slstm_defs}[kind]
    return fn(cfg)


def _mixer_forward(params, cfg: ModelConfig, kind: str, x, positions,
                   with_cache=False):
    fn = {"attn": attn.attn_forward, "mamba": ssm.mamba_forward,
          "mlstm": ssm.mlstm_forward, "slstm": ssm.slstm_forward}[kind]
    return fn(params, cfg, x, positions, with_cache=with_cache)


def _mixer_decode(params, cfg: ModelConfig, kind: str, x, cache, pos: int):
    fn = {"attn": attn.attn_decode, "mamba": ssm.mamba_decode,
          "mlstm": ssm.mlstm_decode, "slstm": ssm.slstm_decode}[kind]
    return fn(params, cfg, x, cache, pos)


def _ffn_defs(cfg: ModelConfig, ffn: str):
    if ffn == "none":
        return None
    if ffn == "moe":
        return moe_mod.moe_defs(cfg)
    # dense MLP; a MoE config's dense layers are d_ff_dense wide
    d_ff = cfg.d_ff
    if cfg.moe is not None and cfg.moe.d_ff_dense:
        d_ff = cfg.moe.d_ff_dense
    return mlp_defs(cfg.d_model, d_ff, cfg.param_dtype, cfg.act)


def sublayer_defs(cfg: ModelConfig, kind: str, ffn: str) -> dict:
    d = {"norm1": rmsnorm_defs(cfg.d_model, cfg.param_dtype),
         "mixer": _mixer_defs(cfg, kind)}
    f = _ffn_defs(cfg, ffn)
    if f is not None:
        d["norm2"] = rmsnorm_defs(cfg.d_model, cfg.param_dtype)
        d["ffn"] = f
    return d


def _ffn_apply(params, cfg: ModelConfig, ffn: str, x, aux=None):
    """x plus the sub-layer's FFN (MLP or MoE) of its normed x; a MoE's
    aux losses are added into ``aux`` where it is given."""
    if ffn == "none":
        return x
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    if ffn != "moe":
        return x + mlp(params["ffn"], h, cfg.act)
    y, a = moe_mod.moe_apply(params["ffn"], cfg, h)
    if aux is not None:
        for k, v in a.items():
            aux[k] = aux[k] + v
    return x + y


def sublayer_apply(params, cfg: ModelConfig, kind: str, ffn: str, x,
                   positions, *, with_cache=False, aux=None):
    """Pre-norm residual sub-layer: the mixer (attention, Mamba, mLSTM or
    sLSTM), then the MLP or MoE where the pattern has one (a MoE's aux
    losses added into ``aux`` where given).  Returns x, and with
    ``with_cache`` (x, the mixer's cache)."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    mix = _mixer_forward(params["mixer"], cfg, kind, h, positions,
                         with_cache)
    if not with_cache:
        return _ffn_apply(params, cfg, ffn, x + mix, aux)
    mix, cache = mix
    return _ffn_apply(params, cfg, ffn, x + mix, aux), cache


def sublayer_decode(params, cfg: ModelConfig, kind: str, ffn: str, x,
                    cache, pos: int):
    """``sublayer_apply`` for one token against the mixer's cache."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    mix, cache = _mixer_decode(params["mixer"], cfg, kind, h, cache, pos)
    return _ffn_apply(params, cfg, ffn, x + mix), cache


def period_defs(cfg: ModelConfig) -> dict:
    return {f"sub{i}": sublayer_defs(cfg, kind, ffn)
            for i, (kind, ffn) in enumerate(cfg.pattern)}


def patch_embed_defs(cfg: ModelConfig) -> dict:
    pdim = cfg.patch_size * cfg.patch_size * cfg.in_channels
    n = (cfg.image_size // cfg.patch_size) ** 2
    return {"w": ParamDef((pdim, cfg.d_model), cfg.param_dtype),
            "b": ParamDef((cfg.d_model,), cfg.param_dtype, init="zeros"),
            "pos": ParamDef((n, cfg.d_model), cfg.param_dtype, init="embed")}


def patchify(cfg: ModelConfig, images):
    """(B, H, W, C) -> (B, n_patches, P*P*C), the reference's order."""
    B, H, W, C = images.shape
    p = cfg.patch_size
    x = images.reshape(B, H // p, p, W // p, p, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def model_defs(cfg: ModelConfig) -> dict:
    defs: dict = {}
    if cfg.modality in ("text", "vlm"):
        defs["embed"] = embedding_defs(cfg.vocab_size, cfg.d_model,
                                       cfg.param_dtype)
    elif cfg.modality == "image":
        defs["embed"] = patch_embed_defs(cfg)
    # audio: the frontend stub feeds embeddings in (no token embedding)
    defs["layers"] = stack_defs(period_defs(cfg), cfg.num_periods)
    defs["final_norm"] = rmsnorm_defs(cfg.d_model, cfg.param_dtype)
    defs["head"] = head_defs(cfg.d_model, cfg.vocab_size, cfg.param_dtype,
                             cfg.num_output_heads)
    return defs


def cache_defs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Per-pattern-position caches stacked over periods."""
    out = {}
    for j, (kind, _) in enumerate(cfg.pattern):
        if kind == "attn":
            c = attn.attn_cache_defs(cfg, batch, seq)
        else:
            c = {"mamba": ssm.mamba_cache_defs, "mlstm": ssm.mlstm_cache_defs,
                 "slstm": ssm.slstm_cache_defs}[kind](cfg, batch)
        out[f"sub{j}"] = stack_defs(c, cfg.num_periods)
    return out


def grow_caches(cfg: ModelConfig, caches, batch: int, seq: int):
    """Prefill's caches zero-padded at the end to ``cache_defs(cfg, batch,
    seq)``'s shapes (the decode horizon), as the reference's serving pads
    them; leaves already at their size are kept as they are."""
    def grow(c, d):
        pad = [n - m for m, n in zip(c.shape, d.shape)]
        if not any(pad):
            return c
        return F.pad(c, [a for p in reversed(pad) for a in (0, p)])
    return tree_map(grow, caches, cache_defs(cfg, batch, seq))


# --------------------------------------------------------------------------- #
# input embedding per modality
# --------------------------------------------------------------------------- #
def embed_inputs(params, cfg: ModelConfig, inputs: dict):
    """Returns (x, positions, loss_mask); ``loss_mask`` (B, S) bool is
    false over a VLM's patches, ``None`` otherwise."""
    mask = None
    if cfg.modality == "text":
        x = embed(params["embed"], inputs["tokens"])
    elif cfg.modality == "audio":
        x = inputs["embeds"].to(cfg.param_dtype)
    elif cfg.modality == "image":
        x = patchify(cfg, inputs["images"].to(cfg.param_dtype))
        x = x @ params["embed"]["w"] + params["embed"]["b"]
        x = x + params["embed"]["pos"]
    else:                                             # vlm
        patches = inputs["patches"].to(cfg.param_dtype)   # (B, Pv, d)
        tokens = inputs["tokens"]                          # (B, St)
        x = torch.cat([patches, embed(params["embed"], tokens)], dim=1)
        B, Pv = patches.shape[:2]
        mask = torch.cat([
            torch.zeros(B, Pv, dtype=torch.bool, device=x.device),
            torch.ones(B, tokens.shape[1], dtype=torch.bool,
                       device=x.device)], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    return x, positions, mask


# --------------------------------------------------------------------------- #
# layer stack
# --------------------------------------------------------------------------- #
def num_stacked(tree) -> int:
    """Length of the leading (period) axis of a stacked tree; 0 if empty."""
    leaves = tree_leaves(tree)
    return leaves[0].shape[0] if leaves else 0


def new_aux(device) -> dict:
    """The MoE aux sums at zero (float32 scalars)."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("load_balance", "router_z")}


def _run_periods(layer_params, cfg: ModelConfig, x, positions, *,
                 with_cache=False, aux=None):
    """The pattern over each period of the stacked params, in order; the
    MoE sub-layers' aux losses are added into ``aux`` where it is given
    (``new_aux``).  Returns x, and with ``with_cache`` (x, the caches
    stacked over the periods)."""
    caches = []
    for i in range(num_stacked(layer_params)):
        period = tree_map(lambda a, i=i: a[i], layer_params)
        held = {}
        for j, (kind, ffn) in enumerate(cfg.pattern):
            x = sublayer_apply(period[f"sub{j}"], cfg, kind, ffn, x,
                               positions, with_cache=with_cache, aux=aux)
            if with_cache:
                x, held[f"sub{j}"] = x
        caches.append(held)
    if not with_cache:
        return x
    return x, tree_map(lambda *c: torch.stack(c), *caches)


def _decode_periods(layer_params, cfg: ModelConfig, x, caches, pos: int):
    """One token through every period; each layer's new cache is written
    into its slice of the stacked ``caches`` (in place)."""
    for i in range(num_stacked(layer_params)):
        period = tree_map(lambda a, i=i: a[i], layer_params)
        for j, (kind, ffn) in enumerate(cfg.pattern):
            held = {k: c[i] for k, c in caches[f"sub{j}"].items()}
            x, new = sublayer_decode(period[f"sub{j}"], cfg, kind, ffn, x,
                                     held, pos)
            for k, t in new.items():
                if t is not held[k]:
                    held[k].copy_(t)
    return x, caches


def forward(params, cfg: ModelConfig, inputs: dict, aux=None):
    """Full model -> logits (the MoE aux sums added into ``aux`` where
    given)."""
    x, positions, _ = embed_inputs(params, cfg, inputs)
    x = _run_periods(params["layers"], cfg, x, positions, aux=aux)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.task == "classify":
        x = x.mean(dim=1)                            # global pool
    return lm_head(params["head"], x, cfg.num_output_heads)


def prefill(params, cfg: ModelConfig, inputs: dict):
    """A prompt through the model with caches.  Returns (the last
    position's logits (B, 1, V), caches).  The head runs on the last
    position alone: the same numbers as the reference's full logits
    sliced, without a (B, S, V) tensor."""
    x, positions, _ = embed_inputs(params, cfg, inputs)
    x, caches = _run_periods(params["layers"], cfg, x, positions,
                             with_cache=True)
    x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return lm_head(params["head"], x, cfg.num_output_heads), caches


def decode_step(params, cfg: ModelConfig, inputs: dict, caches, pos: int):
    """One position, ``inputs = {"tokens": (B, 1)}`` (audio: ``{"embeds":
    (B, 1, d)}``) at absolute position ``pos``, against ``caches`` (grown
    to the horizon, ``grow_caches``).  Updates them in place; returns
    (logits (B, 1, V) or (B, 1, heads, V), caches)."""
    if cfg.modality == "audio":
        x = inputs["embeds"].to(cfg.param_dtype)
    else:
        x = embed(params["embed"], inputs["tokens"])
    x, caches = _decode_periods(params["layers"], cfg, x, caches, pos)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_head(params["head"], x, cfg.num_output_heads), caches


def loss_fn(params, cfg: ModelConfig, batch: dict):
    """Full-model (non-progressive) training loss: the mean CE; over
    every head of a multi-head output (labels (B, S, heads)), over the
    text suffix of a VLM's logits; plus ``moe_aux_loss`` for a MoE
    config."""
    aux = None if cfg.moe is None else new_aux(tree_leaves(params)[0].device)
    logits = forward(params, cfg, batch["inputs"], aux)
    _, _, mask = embed_inputs(params, cfg, batch["inputs"])
    labels = batch["labels"]
    if cfg.task == "classify":
        loss = cross_entropy(logits, labels)
    elif cfg.num_output_heads > 1:
        loss = cross_entropy(logits, labels,
                             None if mask is None else mask[..., None])
    else:
        if cfg.modality == "vlm":
            # logits cover [patches + text]; labels the text only
            logits, mask = logits[:, -labels.shape[1]:], None
        loss = cross_entropy(logits, labels, mask)
    if aux is not None:
        loss = loss + moe_mod.moe_aux_loss(aux, cfg.moe)
    return loss


# --------------------------------------------------------------------------- #
# NeuLite progressive stage forward
# --------------------------------------------------------------------------- #
def surrogate_defs(cfg: ModelConfig, num_blocks: int) -> dict:
    """Output-module basic layers: one residual projection per replaced
    block, stacked over the T-1 replaceable blocks; stage t uses [t:]."""
    d, dt = cfg.d_model, cfg.param_dtype
    base = {"norm": rmsnorm_defs(d, dt),
            "w": ParamDef((d, d), dt, (None, MODEL_AXIS)),
            "wo": ParamDef((d, d), dt, (MODEL_AXIS,))}
    return stack_defs(base, max(num_blocks - 1, 1))


def apply_surrogates(sur_params, cfg: ModelConfig, x):
    """The surrogate layers in order (suffix already sliced)."""
    for i in range(num_stacked(sur_params)):
        p = tree_map(lambda a, i=i: a[i], sur_params)
        h = rmsnorm(p["norm"], x, cfg.norm_eps)
        x = x + gelu(h @ p["w"]) @ p["wo"]
    return x


def projector_defs(cfg: ModelConfig, out_dim: int = 64) -> dict:
    """3-layer MLP projecting block activations to a low-dim space for the
    nHSIC(Y;Z) estimate."""
    d, dt = cfg.d_model, cfg.param_dtype
    hid = max(out_dim * 2, 128)
    return {"w1": ParamDef((d, hid), dt, (None, MODEL_AXIS)),
            "w2": ParamDef((hid, hid), dt, (MODEL_AXIS,)),
            "w3": ParamDef((hid, out_dim), dt)}


def apply_projector(p, x):
    h = gelu(x @ p["w1"])
    h = gelu(h @ p["w2"])
    return h @ p["w3"]


def stage_apply(frozen, trainable, cfg: ModelConfig, inputs: dict):
    """Progressive stage forward.

    ``frozen``:    {"embed"?: ..., "prefix": stacked periods (may be empty)}
    ``trainable``: {"embed"?: ..., "boundary": stacked periods (may be
                    empty), "active": stacked periods, "surrogates": suffix
                    or None, "projector", "final_norm", "head"}

    The frozen embedding (stage > 0) and prefix run under
    ``torch.no_grad``: they keep no activations and get no gradient.  At
    stage 0 the embedding is trainable and ``x_embed`` carries gradient, so
    nHSIC(X;Z) trains the patch embedding too.  Returns (logits, feats) with
    ``x_embed``, ``z_active``, ``z_proj``, ``aux`` (the MoE aux sums of the
    boundary and active periods; ``None`` without MoE) and
    ``loss_mask``."""
    if "embed" in frozen:
        with torch.no_grad():
            x, positions, loss_mask = embed_inputs(frozen, cfg, inputs)
    else:
        x, positions, loss_mask = embed_inputs(trainable, cfg, inputs)
    x_embed = x
    aux = None if cfg.moe is None else new_aux(x.device)
    if num_stacked(frozen.get("prefix")):
        with torch.no_grad():
            x = _run_periods(frozen["prefix"], cfg, x, positions)
    x = _run_periods(trainable.get("boundary"), cfg, x, positions, aux=aux)
    x = _run_periods(trainable["active"], cfg, x, positions, aux=aux)
    z_active = x
    if trainable.get("surrogates") is not None:
        x = apply_surrogates(trainable["surrogates"], cfg, x)
    x = rmsnorm(trainable["final_norm"], x, cfg.norm_eps)
    if cfg.task == "classify":
        x = x.mean(dim=1)
    logits = lm_head(trainable["head"], x, cfg.num_output_heads)
    z_proj = None
    if trainable.get("projector") is not None:
        z_proj = apply_projector(trainable["projector"], z_active)
    feats = {"x_embed": x_embed, "z_active": z_active, "z_proj": z_proj,
             "aux": aux, "loss_mask": loss_mask}
    return logits, feats


# --------------------------------------------------------------------------- #
# accounting
# --------------------------------------------------------------------------- #
def model_flops(cfg: ModelConfig, num_tokens: int) -> float:
    """MODEL_FLOPS = 6 * N_active * D (MoE counts active experts only)."""
    return 6.0 * active_param_count(cfg) * num_tokens


def total_param_count(cfg: ModelConfig) -> int:
    return nparams(model_defs(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top_k + shared experts only)."""
    total = nparams(model_defs(cfg))
    if cfg.moe is None:
        return total
    moe_layers = sum(1 for _, f in cfg.pattern if f == "moe") \
        * cfg.num_periods
    per_expert = 3 * cfg.d_model * cfg.moe.d_ff_expert
    return total - moe_layers * (cfg.moe.num_experts - cfg.moe.top_k) \
        * per_expert
