"""xlstm-1.3b (port of ``repro.configs.xlstm_1_3b``): xLSTM[7:1], 7 mLSTM
and 1 sLSTM blocks per period of 8.

48 layers (6 periods), d_model 2048, 4 heads, d_ff 0 (xLSTM blocks carry
their own up/down projections), vocab 50304, ``mlstm_expand=1``: 1,491,568,976
params.  ``smoke_config`` is its 16-layer reduction (2 periods, d_model
256, 4 heads of 64, vocab 512, float32).  [arXiv:2405.04517]
"""
from repro_torch.models.config import ModelConfig, XLSTMConfig, xlstm_pattern

ARCH_ID = "xlstm-1.3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        pattern=xlstm_pattern(),
        # expand=1 lands the stack at ~1.5B params, the model's name and
        # budget at 48 layers x d_model 2048
        xlstm=XLSTMConfig(mlstm_expand=1),
    )


def smoke_config() -> ModelConfig:
    return config().reduced(num_layers=16)
