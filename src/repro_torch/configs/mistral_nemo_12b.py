"""mistral-nemo-12b — dense GQA, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "mistral-nemo-12b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        rope_theta=1e6,
        notes="head_dim 128 (q-proj 4096 < d_model); 128k context via rope 1e6",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        full(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, q_chunk=64,
    )
