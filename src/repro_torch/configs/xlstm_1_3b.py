"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517].

xLSTM[7:1]: one sLSTM block per 8 (the rest mLSTM), 48 blocks total.
d_ff=0 per the assignment — blocks carry their own projections (mLSTM
pf=2 up/down, sLSTM ffn pf=4/3).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "xlstm-1.3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        ssm=SSMConfig(chunk=64, mlstm_proj_factor=2, slstm_period=8),
        notes="matrix-memory mLSTM chunkwise (GEMM form); sLSTM sequential "
              "scan (RedMulE-inapplicable recurrence, see DESIGN.md)",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        full(), n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        vocab_size=512, q_chunk=64,
        ssm=SSMConfig(chunk=16, mlstm_proj_factor=2, slstm_period=2),
    )
