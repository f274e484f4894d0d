"""jamba-1.5-large-398b (port of ``repro.configs.jamba_1_5_large_398b``):
hybrid Mamba + attention (1:7) + MoE.

72 layers, d_model 8192, 64 heads (GQA, 8 kv heads), d_ff 24576, vocab
65536; a period-8 super-block: attention at position 4, Mamba elsewhere;
MoE (16 experts top-2 of 24576) on every other layer.  Mamba: d_state 16,
d_conv 4, expand 2 (dt_rank ceil(8192 / 16) = 512): 398.6 B params.
[arXiv:2403.19887]
"""
from repro_torch.models.config import (ModelConfig, MoEConfig, SSMConfig,
                                       jamba_pattern)

ARCH_ID = "jamba-1.5-large-398b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        pattern=jamba_pattern(),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        moe=MoEConfig(num_experts=16, top_k=2, num_shared=0,
                      d_ff_expert=24576, capacity_factor=1.25),
    )


def smoke_config() -> ModelConfig:
    return config().reduced(num_layers=16)
