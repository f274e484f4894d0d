"""deepseek-v2-236b (port of ``repro.configs.deepseek_v2_236b``): MLA +
fine-grained MoE, 236 B total / 21 B active.

60 layers, d_model 5120, 128 heads, MLA kv_lora 512 + q_lora 1536, 160
routed experts top-6 + 2 shared, each 1536 wide, vocab 102400: 239.4 B
params.  [arXiv:2405.04434]

The leading dense layer is folded into the MoE pattern, as in
deepseek-v2-lite-16b and the reference.
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

ARCH_ID = "deepseek-v2-236b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        d_ff=1536,
        vocab_size=102400,
        attn_impl="mla",
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        pattern=(("attn", "moe"),),
        moe=MoEConfig(num_experts=160, top_k=6, num_shared=2,
                      d_ff_expert=1536, capacity_factor=1.25,
                      first_dense_layers=1, d_ff_dense=12288),
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
