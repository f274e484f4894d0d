"""llava-next-34b (port of ``repro.configs.llava_next_34b``): the VLM's
language backbone, a Yi-34B-class dense GQA decoder.

60 layers, d_model 7168, 56 heads over 8 kv heads of 128, d_ff 20480,
vocab 64000: 34,388,917,248 params.  The vision tower (SigLIP/ViT, anyres
tiling, projector) is a stub, as in the reference: the model takes
precomputed patch embeddings (``patches``; anyres: a base of 576 and 4
tiles of 576, 2880 patches) before the text's tokens.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "llava-next-34b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        modality="vlm",
        num_vision_patches=2880,     # anyres: (1 base + 4 tiles) x 576
        rope_theta=5_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
