"""The architecture config schema (counterpart of ``repro.configs.base``).

The ``ModelConfig`` dataclass with the reference's fields and defaults,
and its sub-configs: ``MLAConfig`` (DeepSeek-V2's compressed-KV
attention), ``MoEConfig`` (fine-grained routed + shared experts) and the
``SSMConfig`` of the xLSTM / SSM families, and the reference's shape suite
(``ShapeSpec`` / ``SHAPES``, what ``roofline.analysis.model_flops`` reads),
with ``input_specs`` / ``cache_specs``: a step's data arguments and decode
cache as meta tensors (shape and dtype, no storage).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import precision as prec

__all__ = ["MLAConfig", "MoEConfig", "ModelConfig", "SSMConfig", "ShapeSpec",
           "SHAPES", "input_specs", "cache_specs"]


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_expert: int
    dense_ff: int            # FFN width of the leading dense layer(s)
    first_dense: int = 1
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True
    aux_weight: float = 0.01
    z_weight: float = 1e-4


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    chunk: int = 64
    mlstm_proj_factor: int = 2
    mamba_expand: int = 1
    slstm_period: int = 8     # one sLSTM per this many blocks (xLSTM [7:1])

    def slstm_ffn_dim(self, d: int) -> int:
        return -(-(4 * d) // (3 * 64)) * 64  # ceil(4d/3) to a 64 multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    qk_norm: bool = False
    use_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    full_attn_layers: Tuple[int, ...] = ()
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    act: str = "silu"
    mlp: str = "glu"          # glu | plain
    input_mode: str = "tokens"
    tie_embeddings: bool = False
    policy_name: str = "tpu_bf16"
    param_dtype: str = "float32"
    q_chunk: int = 1024
    ce_chunk: int = 0
    # MoE expert parallelism on a mesh: gspmd (every rank routes all its
    # tokens) | shard_map (rows sliced across model peers, all-to-alls);
    # one device: the plain dispatch either way
    moe_impl: str = "gspmd"
    remat: str = "full"
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def policy(self) -> prec.Policy:
        return prec.resolve(self.policy_name)

    @property
    def compute_dtype(self):
        return self.policy.compute_dtype

    @property
    def block_kind(self) -> str:
        if self.family == "moe":
            return "moe"
        if self.family == "ssm":
            return "xlstm"
        if self.family == "hybrid":
            return "hymba"
        return "attn"

    @property
    def supports_long_context_decode(self) -> bool:
        """True for sub-quadratic (SSM / hybrid) families: the dry run's
        long_500k cells."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Total parameters (embedding included), for MODEL_FLOPS."""
        from repro_torch.models import transformer  # the models import configs

        return transformer.count_params(self)

    def active_param_count(self) -> int:
        """A token's active parameters (MoE: top-k of the routed experts)."""
        from repro_torch.models import transformer

        return transformer.count_params(self, active_only=True)


# --------------------------------------------------------------------- #
# The shape suite
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for the step function's data arguments."""
    B, S = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    if shape.kind in ("train", "prefill"):
        if cfg.input_mode == "embeddings":
            return {"embeddings": meta((B, S, cfg.d_model), cfg.compute_dtype),
                    "labels": meta((B, S), torch.int32)}
        return {"inputs": meta((B, S), torch.int32),
                "labels": meta((B, S), torch.int32)}
    # decode: one new token against a cache of length S
    return {"inputs": meta((B, 1), torch.int32), "pos": meta((), torch.int32)}


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    """The decode cache of a shape, as meta tensors."""
    from repro_torch.models import transformer

    return transformer.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  device="meta")
