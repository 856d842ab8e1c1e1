"""command-r-35b — large dense GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

Note: the HF model uses a parallel attn+FFN block and layernorm; the
reference keeps its sequential pre-norm block (backbone-equivalent GEMM
volume), and so does the port.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "command-r-35b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22528,
        vocab_size=256000,
        use_bias=False,
        norm="layernorm",
        rope_theta=8e6,
        notes="largest dense cell; TP stress case (256k vocab head)",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        full(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=0, q_chunk=64,
    )
