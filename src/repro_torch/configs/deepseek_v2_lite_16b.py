"""deepseek-v2-lite-16b (port of ``repro.configs.deepseek_v2_lite_16b``):
MLA + fine-grained MoE.

27 layers, d_model 2048, 16 heads, MLA kv_lora 512 (no q-lora), 64 routed
experts top-6 + 2 shared, each 1408 wide, vocab 102400: 16.21 B params,
2.66 B active.  [arXiv:2405.04434]

As in the reference, DeepSeek's one leading dense layer (d_ff 10944) is
folded into the uniform MoE pattern; ``first_dense_layers`` and
``d_ff_dense`` are kept for accounting.
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

ARCH_ID = "deepseek-v2-lite-16b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        attn_impl="mla",
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        pattern=(("attn", "moe"),),
        moe=MoEConfig(num_experts=64, top_k=6, num_shared=2,
                      d_ff_expert=1408, capacity_factor=1.25,
                      first_dense_layers=1, d_ff_dense=10944),
    )


def smoke_config() -> ModelConfig:
    return config().reduced()
