"""Assigned input shapes and the abstract inputs of each arch's steps
(port of ``repro.configs.shapes``).

  train_4k       seq_len=  4,096  global_batch=256   (training)
  prefill_32k    seq_len= 32,768  global_batch= 32   (inference-prefill)
  decode_32k     seq_len= 32,768  global_batch=128   (inference-decode)
  long_500k      seq_len=524,288  global_batch=  1   (long-context-decode)

Decode shapes take one token against a seq_len-deep cache; ``long_500k``
needs sub-quadratic state: recurrent archs run natively, full-attention
archs run their sliding-window variant
(``ModelConfig.with_window(long_context_window)``).

The reference's ``jax.ShapeDtypeStruct`` is a tensor on the ``meta``
device here: a shape and a dtype, nothing allocated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.common import paramdef as PD
from repro_torch.models import model as tx
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def pad_heads_for_tp(cfg: ModelConfig, tp: int = 16) -> ModelConfig:
    """Zero-padded attention heads for tensor parallelism.

    Where num_heads does not divide the model axis (llava: 56 heads,
    qwen1.5: 20) the *query* head count grows to the next multiple that
    keeps the GQA group mapping intact (per-group padding; MHA pads q and
    kv together).  Padded heads start from the init like any other head
    (zero ``wv``/``wo`` rows would make their contribution exactly 0); they
    cost (H'/H - 1) extra attention FLOPs."""
    if cfg.attn_impl == "mla":
        return cfg
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if H % tp == 0:
        return cfg
    Dh = cfg.resolved_head_dim
    if KV == H:                        # MHA: pad q and kv together
        H2 = -(-H // tp) * tp
        KV2 = H2
    else:                              # GQA: grow the per-kv group size
        G = H // KV
        G2 = G
        while (KV * G2) % tp:
            G2 += 1
        H2, KV2 = KV * G2, KV
    return dataclasses.replace(cfg, num_heads=H2, num_kv_heads=KV2,
                               head_dim=Dh)


def resolve_config(cfg: ModelConfig, shape: InputShape,
                   tp: int = 16) -> ModelConfig:
    """Deployment config for a shape: long_500k swaps full attention for the
    sliding-window variant; head counts are TP-padded (``tp=0`` disables,
    for the *logical* model FLOPs)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        cfg = cfg.with_window(cfg.long_context_window)
    if tp:
        cfg = pad_heads_for_tp(cfg, tp)
    return cfg


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def token_inputs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Model inputs for a full-sequence pass (train / prefill)."""
    if cfg.modality == "audio":
        return {"embeds": _sds((batch, seq, cfg.d_model), torch.bfloat16)}
    if cfg.modality == "vlm":
        pv = min(cfg.num_vision_patches, seq - 16)
        return {"patches": _sds((batch, pv, cfg.d_model), torch.bfloat16),
                "tokens": _sds((batch, seq - pv), torch.int32)}
    return {"tokens": _sds((batch, seq), torch.int32)}


def label_specs(cfg: ModelConfig, batch: int, seq: int):
    if cfg.modality == "audio":
        return _sds((batch, seq, cfg.num_output_heads), torch.int32)
    if cfg.modality == "vlm":
        pv = min(cfg.num_vision_patches, seq - 16)
        return _sds((batch, seq - pv), torch.int32)
    return _sds((batch, seq), torch.int32)


def decode_inputs(cfg: ModelConfig, batch: int) -> dict:
    if cfg.modality == "audio":
        return {"embeds": _sds((batch, 1, cfg.d_model), torch.bfloat16)}
    return {"tokens": _sds((batch, 1), torch.int32)}


def cache_specs(cfg: ModelConfig, batch: int, seq: int):
    """Meta-tensor tree of the per-layer caches (stacked over periods)."""
    return PD.shape_tree(tx.cache_defs(cfg, batch, seq))


def cache_part_specs(cfg: ModelConfig, batch: int, seq: int):
    """The logical spec tree matching ``cache_specs`` (per leaf a tuple,
    one entry per leading dim, trailing ``None`` dims dropped)."""
    return PD.spec_tree(tx.cache_defs(cfg, batch, seq))


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """All abstract inputs for the step a shape runs.

    train   -> {"batch": {"inputs", "labels"}}
    prefill -> {"inputs"}
    decode  -> {"inputs", "caches", "pos"}
    """
    shape = SHAPES[shape_name]
    cfg = resolve_config(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": {"inputs": token_inputs(cfg, B, S),
                          "labels": label_specs(cfg, B, S)}}
    if shape.kind == "prefill":
        return {"inputs": token_inputs(cfg, B, S)}
    return {"inputs": decode_inputs(cfg, B),
            "caches": cache_specs(cfg, B, S),
            "pos": _sds((), torch.int32)}
