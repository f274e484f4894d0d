"""granite-3-8b (port of ``repro.configs.granite_3_8b``): dense GQA
decoder.

40 layers, d_model 4096, 32 heads (GQA, 8 kv heads) of 128, d_ff 12800,
vocab 49155.  [hf:ibm-granite/granite-3.0-2b-base]
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "granite-3-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
        rope_theta=10_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
