"""yi-9b — dense llama-arch GQA LM [arXiv:2403.04652; hf]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "yi-9b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5e6,
        notes="llama-arch GQA; 01.AI Yi-9B per arXiv:2403.04652",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        full(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=0, q_chunk=64,
    )
