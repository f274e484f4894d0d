"""Model configuration (port of ``repro.models.config``), for the models
the port runs: the paper's ViT, dense GQA text models and the xLSTM
(mLSTM and sLSTM blocks).

The layer stack is ``num_periods = num_layers // len(pattern)`` repetitions
of a pattern of (layer kind, FFN kind) sub-layers, with params stacked over
the period axis.  The fields keep the reference's names and defaults.  What
the port does not run yet raises a ``ValueError`` naming it: MLA, MoE, the
``mamba`` layer kind, ``mlstm``/``slstm`` without an ``XLSTMConfig``, the
``audio``/``vlm`` modalities, qk-norm and QKV bias.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block mix."""
    mlstm_expand: int = 2           # up-projection factor inside mLSTM block
    slstm_proj_factor: float = 4.0 / 3.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # repeating tuple of (layer_kind, ffn_kind); its length divides
    # num_layers.  The port runs layer kinds "attn", "mlstm" and "slstm",
    # with ffn "mlp" or "none".
    pattern: Tuple[Tuple[str, str], ...] = (("attn", "mlp"),)

    # --- attention ---------------------------------------------------------
    attn_impl: str = "gqa"          # gqa (mla: not ported)
    qk_norm: bool = False           # not ported
    qkv_bias: bool = False          # not ported
    window: int = 0                 # 0 = full; >0 = sliding window
    rope_theta: float = 10_000.0
    mla: Optional[Any] = None       # not ported
    moe: Optional[Any] = None       # not ported
    xlstm: Optional[XLSTMConfig] = None

    # --- modality ----------------------------------------------------------
    modality: str = "text"          # text | image (audio, vlm: not ported)
    task: str = "lm"                # lm | classify
    causal: bool = True
    image_size: int = 32
    patch_size: int = 4
    in_channels: int = 3

    # --- misc ----------------------------------------------------------------
    norm_eps: float = 1e-5
    act: str = "swiglu"             # swiglu | gelu
    dtype: str = "bfloat16"
    # route attention through the hand-written CUDA flash-attention forward
    # (``kernels/flash_attention``); False takes the plain ``sdpa``
    use_flash_kernel: bool = False
    # route the sLSTM time scan through the hand-written CUDA scan
    # (``kernels/slstm_scan``); False takes the plain per-step loop
    use_slstm_kernel: bool = False

    def __post_init__(self):
        unported = []
        if self.attn_impl != "gqa" or self.mla is not None:
            unported.append("MLA attention")
        if self.moe is not None or any(f == "moe" for _, f in self.pattern):
            unported.append("MoE")
        ported = {"attn"} | ({"mlstm", "slstm"} if self.xlstm else set())
        kinds = sorted({k for k, _ in self.pattern} - ported)
        if kinds:
            unported.append(f"layer kinds {kinds}")
        if self.modality not in ("text", "image"):
            unported.append(f"modality {self.modality!r}")
        if self.qk_norm or self.qkv_bias:
            unported.append("qk-norm and QKV bias")
        if unported:
            raise ValueError(f"{self.name}: not yet ported: "
                             + ", ".join(unported))
        if self.num_layers % len(self.pattern):
            raise ValueError(f"{self.name}: num_layers={self.num_layers} not "
                             f"divisible by pattern period "
                             f"{len(self.pattern)}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    @property
    def param_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def xlstm_pattern() -> Tuple[Tuple[str, str], ...]:
    """xLSTM[7:1]: 7 mLSTM blocks then 1 sLSTM block per period of 8.
    xLSTM blocks carry their own up/down projection; no separate FFN.
    [arXiv:2405.04517]"""
    return tuple([("mlstm", "none")] * 7 + [("slstm", "none")])
