"""Architecture registry (port of ``repro.configs``): the reference's ten
assigned ids, in its order, and the input shapes (``configs/shapes.py``).

``get_config("<id>")`` gives the full-scale config and
``get_smoke_config`` its reduced same-family CPU variant, for every arch
of the reference: the four dense decoders, xlstm-1.3b, musicgen-large
(audio), llava-next-34b (VLM), deepseek-v2-lite-16b and deepseek-v2-236b
(MLA + MoE) and jamba-1.5-large-398b (Mamba + attention + MoE).
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_v2_236b, deepseek_v2_lite_16b,
                                 granite_3_8b, h2o_danube_3_4b,
                                 jamba_1_5_large_398b, llava_next_34b,
                                 musicgen_large, qwen1_5_4b, qwen3_1_7b,
                                 xlstm_1_3b)
from repro_torch.configs.shapes import (SHAPES, InputShape, cache_part_specs,
                                        cache_specs, decode_inputs,
                                        input_specs, label_specs,
                                        resolve_config, token_inputs)
from repro_torch.models.config import ModelConfig

ARCH_IDS = ["musicgen-large", "xlstm-1.3b", "llava-next-34b",
            "granite-3-8b", "deepseek-v2-lite-16b", "deepseek-v2-236b",
            "h2o-danube-3-4b", "qwen1.5-4b", "qwen3-1.7b",
            "jamba-1.5-large-398b"]
_REGISTRY = {m.ARCH_ID: m for m in (musicgen_large, xlstm_1_3b,
                                    llava_next_34b, granite_3_8b,
                                    deepseek_v2_lite_16b, deepseek_v2_236b,
                                    h2o_danube_3_4b, qwen1_5_4b, qwen3_1_7b,
                                    jamba_1_5_large_398b)}


def _module(arch_id: str):
    if arch_id not in _REGISTRY:
        raise ValueError(f"unknown arch {arch_id!r}; one of {ARCH_IDS}")
    return _REGISTRY[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "SHAPES",
           "InputShape", "input_specs", "token_inputs", "label_specs",
           "decode_inputs", "cache_specs", "cache_part_specs",
           "resolve_config"]
