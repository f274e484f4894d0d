"""qwen1.5-4b (port of ``repro.configs.qwen1_5_4b``): dense MHA decoder
with QKV bias.

40 layers, d_model 2560, 20 heads (kv 20, MHA) of 128, d_ff 6912, vocab
151936, RoPE theta 1e6.  [hf:Qwen/Qwen1.5-0.5B]
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen1.5-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=40,
        d_model=2560,
        num_heads=20,
        num_kv_heads=20,
        d_ff=6912,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
