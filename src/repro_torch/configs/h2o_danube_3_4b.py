"""h2o-danube-3-4b (port of ``repro.configs.h2o_danube_3_4b``): a
llama/mistral-mix dense decoder with sliding-window attention.

24 layers, d_model 3840, 32 heads (GQA, 8 kv heads) of 120, d_ff 10240,
vocab 32000, window 4096 (mistral-style).  [arXiv:2401.16818]
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "h2o-danube-3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=24,
        d_model=3840,
        num_heads=32,
        num_kv_heads=8,
        d_ff=10240,
        vocab_size=32000,
        window=4096,
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
