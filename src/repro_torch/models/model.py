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
  ``stage_apply``  NeuLite stage t: frozen embedding and prefix (no grad),
                   trainable boundary and active periods, surrogate output
                   module, head, nHSIC projector.
"""
from __future__ import annotations

import torch

from repro_torch.common.paramdef import ParamDef, stack_defs
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (cross_entropy, embed, embedding_defs,
                                       gelu, head_defs, lm_head, mlp,
                                       mlp_defs, rmsnorm, rmsnorm_defs)


# --------------------------------------------------------------------------- #
# sub-layers
# --------------------------------------------------------------------------- #
def _mixer_defs(cfg: ModelConfig, kind: str) -> dict:
    fn = {"attn": attn.gqa_defs, "mlstm": ssm.mlstm_defs,
          "slstm": ssm.slstm_defs}[kind]
    return fn(cfg)


def _mixer_forward(params, cfg: ModelConfig, kind: str, x, positions):
    fn = {"attn": attn.gqa_forward, "mlstm": ssm.mlstm_forward,
          "slstm": ssm.slstm_forward}[kind]
    return fn(params, cfg, x, positions)


def sublayer_defs(cfg: ModelConfig, kind: str, ffn: str) -> dict:
    d = {"norm1": rmsnorm_defs(cfg.d_model, cfg.param_dtype),
         "mixer": _mixer_defs(cfg, kind)}
    if ffn != "none":
        d["norm2"] = rmsnorm_defs(cfg.d_model, cfg.param_dtype)
        d["ffn"] = mlp_defs(cfg.d_model, cfg.d_ff, cfg.param_dtype, cfg.act)
    return d


def sublayer_apply(params, cfg: ModelConfig, kind: str, ffn: str, x,
                   positions):
    """Pre-norm residual sub-layer: the mixer (attention, mLSTM or sLSTM),
    then the MLP where the pattern has one."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    x = x + _mixer_forward(params["mixer"], cfg, kind, h, positions)
    if ffn != "none":
        h = rmsnorm(params["norm2"], x, cfg.norm_eps)
        x = x + mlp(params["ffn"], h, cfg.act)
    return x


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
    if cfg.modality == "text":
        defs["embed"] = embedding_defs(cfg.vocab_size, cfg.d_model,
                                       cfg.param_dtype)
    else:
        defs["embed"] = patch_embed_defs(cfg)
    defs["layers"] = stack_defs(period_defs(cfg), cfg.num_periods)
    defs["final_norm"] = rmsnorm_defs(cfg.d_model, cfg.param_dtype)
    defs["head"] = head_defs(cfg.d_model, cfg.vocab_size, cfg.param_dtype)
    return defs


# --------------------------------------------------------------------------- #
# input embedding per modality
# --------------------------------------------------------------------------- #
def embed_inputs(params, cfg: ModelConfig, inputs: dict):
    """Returns (x, positions, loss_mask)."""
    if cfg.modality == "text":
        tokens = inputs["tokens"]
        x = embed(params["embed"], tokens)
    else:
        x = patchify(cfg, inputs["images"].to(cfg.param_dtype))
        x = x @ params["embed"]["w"] + params["embed"]["b"]
        x = x + params["embed"]["pos"]
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    return x, positions, None


# --------------------------------------------------------------------------- #
# layer stack
# --------------------------------------------------------------------------- #
def num_stacked(tree) -> int:
    """Length of the leading (period) axis of a stacked tree; 0 if empty."""
    leaves = tree_leaves(tree)
    return leaves[0].shape[0] if leaves else 0


def _run_periods(layer_params, cfg: ModelConfig, x, positions):
    """The pattern over each period of the stacked params, in order."""
    for i in range(num_stacked(layer_params)):
        period = tree_map(lambda a, i=i: a[i], layer_params)
        for j, (kind, ffn) in enumerate(cfg.pattern):
            x = sublayer_apply(period[f"sub{j}"], cfg, kind, ffn, x,
                               positions)
    return x


def forward(params, cfg: ModelConfig, inputs: dict):
    """Full model -> logits."""
    x, positions, _ = embed_inputs(params, cfg, inputs)
    x = _run_periods(params["layers"], cfg, x, positions)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.task == "classify":
        x = x.mean(dim=1)                            # global pool
    return lm_head(params["head"], x)


def loss_fn(params, cfg: ModelConfig, batch: dict):
    """Full-model (non-progressive) training loss."""
    logits = forward(params, cfg, batch["inputs"])
    _, _, mask = embed_inputs(params, cfg, batch["inputs"])
    return cross_entropy(logits, batch["labels"],
                         None if cfg.task == "classify" else mask)


# --------------------------------------------------------------------------- #
# NeuLite progressive stage forward
# --------------------------------------------------------------------------- #
def surrogate_defs(cfg: ModelConfig, num_blocks: int) -> dict:
    """Output-module basic layers: one residual projection per replaced
    block, stacked over the T-1 replaceable blocks; stage t uses [t:]."""
    d, dt = cfg.d_model, cfg.param_dtype
    base = {"norm": rmsnorm_defs(d, dt), "w": ParamDef((d, d), dt),
            "wo": ParamDef((d, d), dt)}
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
    return {"w1": ParamDef((d, hid), dt), "w2": ParamDef((hid, hid), dt),
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
    ``x_embed``, ``z_active``, ``z_proj`` and ``loss_mask``."""
    if "embed" in frozen:
        with torch.no_grad():
            x, positions, loss_mask = embed_inputs(frozen, cfg, inputs)
    else:
        x, positions, loss_mask = embed_inputs(trainable, cfg, inputs)
    x_embed = x
    if num_stacked(frozen.get("prefix")):
        with torch.no_grad():
            x = _run_periods(frozen["prefix"], cfg, x, positions)
    x = _run_periods(trainable.get("boundary"), cfg, x, positions)
    x = _run_periods(trainable["active"], cfg, x, positions)
    z_active = x
    if trainable.get("surrogates") is not None:
        x = apply_surrogates(trainable["surrogates"], cfg, x)
    x = rmsnorm(trainable["final_norm"], x, cfg.norm_eps)
    if cfg.task == "classify":
        x = x.mean(dim=1)
    logits = lm_head(trainable["head"], x)
    z_proj = None
    if trainable.get("projector") is not None:
        z_proj = apply_projector(trainable["projector"], z_active)
    feats = {"x_embed": x_embed, "z_active": z_active, "z_proj": z_proj,
             "loss_mask": loss_mask}
    return logits, feats
