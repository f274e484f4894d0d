"""Model configuration (port of ``repro.models.config``), for the models
the port runs: the paper's ViT, dense GQA decoders (with qk-norm, QKV bias
and sliding-window attention), the xLSTM (mLSTM and sLSTM blocks), and
the audio (MusicGen: frame embeddings in, one head per codebook) and VLM
(LLaVA-NeXT: patch embeddings before the text) modalities.

The layer stack is ``num_periods = num_layers // len(pattern)`` repetitions
of a pattern of (layer kind, FFN kind) sub-layers, with params stacked over
the period axis.  The fields keep the reference's names and defaults.  What
the port does not run yet raises a ``ValueError`` naming it: MLA, MoE, the
``mamba`` layer kind and ``mlstm``/``slstm`` without an ``XLSTMConfig``.
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
    family: str                     # dense | ssm | audio | vlm
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
    qk_norm: bool = False           # RMSNorm of q and k over the head dim
    qkv_bias: bool = False
    window: int = 0                 # 0 = full; >0 = sliding window
    rope_theta: float = 10_000.0
    mla: Optional[Any] = None       # not ported
    moe: Optional[Any] = None       # not ported
    xlstm: Optional[XLSTMConfig] = None

    # --- modality ----------------------------------------------------------
    modality: str = "text"          # text | audio | vlm | image
    num_output_heads: int = 1       # musicgen: 4 codebook heads
    num_vision_patches: int = 0     # llava: prefix of precomputed patch embeds
    task: str = "lm"                # lm | classify
    causal: bool = True
    image_size: int = 32
    patch_size: int = 4
    in_channels: int = 3

    # --- misc ----------------------------------------------------------------
    norm_eps: float = 1e-5
    # kept for the reference's configs; neither package reads it (the head
    # is always its own param), so param counts match the reference's
    tie_embeddings: bool = False
    act: str = "swiglu"             # swiglu | gelu
    dtype: str = "bfloat16"
    # long-context fallback: full-attention archs get a sliding-window
    # variant for the long_500k decode shape (``configs/shapes.py``)
    long_context_window: int = 4096
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
        if unported:
            raise ValueError(f"{self.name}: not yet ported: "
                             + ", ".join(unported))
        if self.modality not in ("text", "image", "audio", "vlm"):
            raise ValueError(f"{self.name}: unknown modality "
                             f"{self.modality!r}")
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

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state does not grow quadratically with context
        (recurrent layers and/or windowed attention only)."""
        kinds = {k for k, _ in self.pattern}
        if kinds <= {"mamba", "mlstm", "slstm"}:
            return True
        return self.window > 0

    def with_window(self, window: int) -> "ModelConfig":
        """Sliding-window variant (the long_500k fallback of dense
        archs)."""
        return dataclasses.replace(self, window=window)

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ModelConfig":
        """Reduced same-family variant for smoke tests: whole periods, at
        most ``d_model`` wide, 2-4 heads, a vocabulary of at most
        ``vocab``, float32.  (The reference's also shrinks MoE and MLA,
        which the port does not run.)"""
        period = self.period
        layers = max(num_layers, period)
        layers = (layers // period) * period or period
        heads = max(2, min(4, self.num_heads))
        kv = min(self.num_kv_heads, heads)
        if heads % kv:
            kv = heads
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=layers,
            d_model=min(d_model, self.d_model),
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=0,
            d_ff=min(512, self.d_ff) if self.d_ff else 0,
            vocab_size=min(vocab, self.vocab_size),
            window=min(self.window, 64) if self.window else 0,
            num_vision_patches=min(self.num_vision_patches, 16),
            dtype="float32",
        )


def xlstm_pattern() -> Tuple[Tuple[str, str], ...]:
    """xLSTM[7:1]: 7 mLSTM blocks then 1 sLSTM block per period of 8.
    xLSTM blocks carry their own up/down projection; no separate FFN.
    [arXiv:2405.04517]"""
    return tuple([("mlstm", "none")] * 7 + [("slstm", "none")])
