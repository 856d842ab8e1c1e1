"""Architecture registry: ``get(arch_id)`` / ``get_reduced(arch_id)``.

Every architecture of the reference is registered: the dense GQA / MHA
decoders (token or embedding input, rmsnorm or layernorm, GLU or plain
GELU MLP), xLSTM, the hybrid attention + Mamba2 / SSD hymba-1.5b, and the
DeepSeek MoE decoders, with MHA or MLA attention.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from repro_torch.configs import (base, command_r_35b, deepseek_moe_16b,
                                 deepseek_v2_lite_16b, hymba_1_5b,
                                 mistral_nemo_12b, musicgen_medium,
                                 pixtral_12b, qwen3_1_7b, xlstm_1_3b, yi_9b)
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeSpec, cache_specs,
                                      input_specs)

_MODULES = (yi_9b, qwen3_1_7b, mistral_nemo_12b, command_r_35b,
            deepseek_v2_lite_16b, deepseek_moe_16b, musicgen_medium,
            xlstm_1_3b, hymba_1_5b, pixtral_12b)

REGISTRY: Dict[str, Tuple[Callable[[], ModelConfig], Callable[[], ModelConfig]]] = {
    m.ARCH_ID: (m.full, m.reduced) for m in _MODULES
}

ARCH_IDS = tuple(REGISTRY)


def _entry(arch_id: str):
    try:
        return REGISTRY[arch_id]
    except KeyError as e:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}") from e


def get(arch_id: str) -> ModelConfig:
    return _entry(arch_id)[0]()


def get_reduced(arch_id: str) -> ModelConfig:
    return _entry(arch_id)[1]()


__all__ = ["REGISTRY", "ARCH_IDS", "get", "get_reduced", "ModelConfig", "base",
           "SHAPES", "ShapeSpec", "input_specs", "cache_specs"]
