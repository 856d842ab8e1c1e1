"""hymba-1.5b — parallel attention + Mamba (SSD) heads [arXiv:2411.13676; hf].

Hybrid-head block: attention and SSM branches read the same normed input;
their normalized outputs are averaged.  Most layers use sliding-window
attention, three use full attention (first / middle / last).  The paper's
meta-tokens are omitted, as in the reference config.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "hymba-1.5b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        sliding_window=1024,
        full_attn_layers=(0, 15, 31),
        ssm=SSMConfig(state_dim=16, chunk=64, mamba_expand=1),
        rope_theta=1e4,
        notes="25 attn heads + 25 SSD heads in parallel; ssm_state=16",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        full(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, q_chunk=64,
        sliding_window=32, full_attn_layers=(0,),
        ssm=SSMConfig(state_dim=8, chunk=16, mamba_expand=1),
    )
