"""musicgen-large (port of ``repro.configs.musicgen_large``): a
decoder-only transformer over EnCodec tokens.

48 layers, d_model 2048, 32 heads (MHA: 32 kv heads) of 64, GELU MLP of
8192, 4 codebook heads of vocab 2048 each (delay-pattern decoding):
2,432,894,976 params.  The EnCodec conv frontend is a stub, as in the
reference: the model takes precomputed frame embeddings (``embeds``) and
has no token embedding.  [arXiv:2306.05284]
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "musicgen-large"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        modality="audio",
        num_output_heads=4,          # 4 EnCodec codebooks
        act="gelu",
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
