"""qwen3-1.7b (port of ``repro.configs.qwen3_1_7b``): dense GQA decoder
with per-head QK RMSNorm.

28 layers, d_model 2048, 16 heads (GQA, 8 kv heads) of 128, d_ff 6144,
vocab 151936, RoPE theta 1e6: 2,031,739,904 params (the head is its own
param; ``tie_embeddings`` is recorded, not applied, as in the reference).
[hf:Qwen/Qwen3-8B]
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen3-1.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=6144,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
