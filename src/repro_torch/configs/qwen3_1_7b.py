"""qwen3-1.7b — dense GQA LM with qk-norm [hf:Qwen/Qwen3-1.7B; hf]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen3-1.7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        vocab_size=151936,
        qk_norm=True,
        tie_embeddings=True,
        rope_theta=1e6,
        notes="qk_norm per-head RMSNorm; tied embeddings (sub-8B Qwen3)",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        full(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, q_chunk=64,
    )
