"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066; hf]."""

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "deepseek-moe-16b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,  # MHA (GQA kv=16 == n_heads)
        head_dim=128,
        d_ff=1408,
        vocab_size=102400,
        moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=1408,
                      dense_ff=10944, first_dense=1),
        rope_theta=1e4,
        notes="fine-grained expert segmentation; first layer dense FFN",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        full(), n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=32, vocab_size=512, q_chunk=64,
        moe=MoEConfig(n_routed=8, n_shared=2, top_k=2, d_expert=32,
                      dense_ff=128, first_dense=1),
    )
