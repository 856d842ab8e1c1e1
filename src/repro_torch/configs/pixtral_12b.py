"""pixtral-12b — pixtral-ViT + mistral-nemo backbone [hf:mistralai/Pixtral-12B-2409].

Backbone only, as in the reference: the 400M ViT frontend is a stub —
training batches carry precomputed patch+text embeddings (B, S, d_model)
(``SyntheticLM(embed_dim=...)``); serving consumes text token ids against
the 131072 vocab.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "pixtral-12b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        input_mode="embeddings",
        rope_theta=1e6,
        notes="mistral-nemo decoder; ViT frontend stubbed per assignment",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        full(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, q_chunk=64,
    )
