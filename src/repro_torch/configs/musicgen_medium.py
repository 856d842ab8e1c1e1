"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only, as in the reference: the EnCodec frontend (and the
4-codebook delay-pattern embedding sum) is a stub — training batches carry
precomputed frame embeddings (B, S, d_model) (``SyntheticLM(embed_dim=...)``);
the LM head targets the 2048-entry codec vocabulary.  Decode consumes codec
token ids directly.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "musicgen-medium"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        norm="layernorm",
        act="gelu",
        mlp="plain",
        input_mode="embeddings",
        rope_theta=1e4,
        notes="MHA, layernorm, plain GELU FFN (4x); frontend stubbed",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        full(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=0, q_chunk=64,
    )
