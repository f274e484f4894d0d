"""Model configuration (port of ``repro.models.config``).  One
``ModelConfig`` describes every architecture of the pool: the paper's ViT,
dense GQA decoders (with qk-norm, QKV bias and sliding-window attention),
MLA + MoE (DeepSeek-V2), the xLSTM (mLSTM and sLSTM blocks), hybrid Mamba
+ attention + MoE (Jamba), and the audio (MusicGen: frame embeddings in,
one head per codebook) and VLM (LLaVA-NeXT: patch embeddings before the
text) modalities.

The layer stack is ``num_periods = num_layers // len(pattern)`` repetitions
of a pattern of (layer kind, FFN kind) sub-layers, with params stacked over
the period axis.  The fields keep the reference's names and defaults.  A
pattern whose layer kind needs a config the model lacks (``mamba``
without an ``SSMConfig``, ``mlstm``/``slstm`` without an ``XLSTMConfig``,
``moe`` without a ``MoEConfig``, ``attn_impl="mla"`` without an
``MLAConfig``) raises a ``ValueError`` naming it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 = no query compression
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8            # routed experts
    top_k: int = 2
    num_shared: int = 0             # always-on shared experts
    d_ff_expert: int = 0            # per-expert hidden dim
    capacity_factor: float = 1.25
    router_z_weight: float = 1e-3
    aux_loss_weight: float = 1e-2
    first_dense_layers: int = 0     # kept for accounting, as the reference
    d_ff_dense: int = 0             # hidden dim of the dense MLP layers
    # routing runs within ``dispatch_groups`` token groups (the mesh's
    # batch shards, ``launch.steps.align_moe_dispatch``); 1 = global
    dispatch_groups: int = 1


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block mix."""
    mlstm_expand: int = 2           # up-projection factor inside mLSTM block
    slstm_proj_factor: float = 4.0 / 3.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # repeating tuple of (layer_kind, ffn_kind); its length divides
    # num_layers.  layer_kind: attn | mamba | mlstm | slstm; ffn_kind:
    # mlp | moe | none
    pattern: Tuple[Tuple[str, str], ...] = (("attn", "mlp"),)

    # --- attention ---------------------------------------------------------
    attn_impl: str = "gqa"          # gqa | mla
    qk_norm: bool = False           # RMSNorm of q and k over the head dim
    qkv_bias: bool = False
    window: int = 0                 # 0 = full; >0 = sliding window
    rope_theta: float = 10_000.0
    mla: Optional[MLAConfig] = None

    # --- mixtures / ssm ----------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
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
        missing = []
        if self.attn_impl not in ("gqa", "mla"):
            missing.append(f"attn_impl {self.attn_impl!r} (gqa or mla)")
        if self.attn_impl == "mla" and self.mla is None:
            missing.append("MLAConfig for attn_impl='mla'")
        if any(f == "moe" for _, f in self.pattern) and self.moe is None:
            missing.append("MoEConfig for the 'moe' FFN")
        needs = {"attn": True, "mamba": self.ssm is not None,
                 "mlstm": self.xlstm is not None,
                 "slstm": self.xlstm is not None}
        kinds = sorted({k for k, _ in self.pattern}
                       - {k for k, ok in needs.items() if ok})
        if kinds:
            missing.append(f"layer kinds {kinds} (mamba needs an SSMConfig,"
                           f" mlstm/slstm an XLSTMConfig)")
        if missing:
            raise ValueError(f"{self.name}: " + ", ".join(missing))
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

    @property
    def attn_layer_fraction(self) -> float:
        return sum(1 for k, _ in self.pattern if k == "attn") / self.period

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                num_experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """Reduced same-family variant for smoke tests: whole periods, at
        most ``d_model`` wide, 2-4 heads, a vocabulary of at most
        ``vocab``, float32; MoE at most ``num_experts`` experts top-2, one
        shared, 128 wide, and MLA at rank 64 without q compression, as the
        reference's.  Its quirk is kept: ``d_ff_dense`` becomes
        ``min(256, d_ff_dense) or 256``, so a MoE config's dense MLP layers
        (Jamba's) are 256 wide, not ``d_ff``."""
        period = self.period
        layers = max(num_layers, period)
        layers = (layers // period) * period or period
        heads = max(2, min(4, self.num_heads))
        kv = min(self.num_kv_heads, heads)
        if heads % kv:
            kv = heads
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe,
                num_experts=min(num_experts, moe.num_experts),
                top_k=min(2, moe.top_k),
                num_shared=min(1, moe.num_shared),
                d_ff_expert=min(128, moe.d_ff_expert) or 128,
                d_ff_dense=min(256, moe.d_ff_dense) or 256,
                first_dense_layers=min(moe.first_dense_layers, 1),
            )
        mla = self.mla
        if mla is not None:
            mla = MLAConfig(kv_lora_rank=64, q_lora_rank=0,
                            qk_nope_head_dim=32, qk_rope_head_dim=16,
                            v_head_dim=32)
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
            moe=moe,
            mla=mla,
            window=min(self.window, 64) if self.window else 0,
            num_vision_patches=min(self.num_vision_patches, 16),
            dtype="float32",
        )


def jamba_pattern() -> Tuple[Tuple[str, str], ...]:
    """Jamba period-8 super-block: attention at position 4, Mamba elsewhere,
    MoE on every other layer (odd positions). [arXiv:2403.19887]"""
    return tuple(("attn" if i == 4 else "mamba", "moe" if i % 2 else "mlp")
                 for i in range(8))


def xlstm_pattern() -> Tuple[Tuple[str, str], ...]:
    """xLSTM[7:1]: 7 mLSTM blocks then 1 sLSTM block per period of 8.
    xLSTM blocks carry their own up/down projection; no separate FFN.
    [arXiv:2405.04517]"""
    return tuple([("mlstm", "none")] * 7 + [("slstm", "none")])
