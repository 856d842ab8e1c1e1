"""Precision policies with per-operand storage dtypes (torch dtypes).

Counterpart of ``repro.core.precision``.  A :class:`Policy` names the dtype
roles of one GEMM: ``x_dtype`` / ``w_dtype`` / ``grad_dtype`` (storage in
device memory; ``None`` means the compute dtype), ``compute_dtype`` (what
tiles are widened to before the matrix unit), ``accum_dtype`` (the
accumulator) and ``output_dtype`` (what results are stored in; ``None``
means the compute dtype).  FP8 storage travels with a per-tensor unit-max
scale (:func:`quantize_fp8`).  The six shipped policies are the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = [
    "Policy", "PAPER_FP16", "TPU_FP16", "TPU_BF16", "FP32",
    "MIXED_FP8_E4M3", "MIXED_FP8_E5M2", "FP8_FORMATS",
    "resolve", "known_policies", "is_fp8", "fp8_max",
    "quantize_fp8", "dequantize_fp8", "as_dtype", "dtype_name",
]

FP8_FORMATS = ("float8_e4m3fn", "float8_e5m2")


def as_dtype(d) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ("bfloat16")."""
    if isinstance(d, torch.dtype):
        return d
    dt = getattr(torch, str(d), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"{d!r} does not name a torch dtype")
    return dt


def dtype_name(d) -> str:
    """The dtype's short name, as the reference spells it ("bfloat16")."""
    return str(as_dtype(d)).removeprefix("torch.")


def is_fp8(dtype) -> bool:
    try:
        return dtype_name(dtype) in FP8_FORMATS
    except TypeError:
        return False


def fp8_max(dtype) -> float:
    """Largest finite value of an FP8 format (448 for E4M3, 57344 for E5M2)."""
    return float(torch.finfo(as_dtype(dtype)).max)


def _validate_dtype(owner: str, field: str, value, *,
                    optional: bool = False) -> None:
    if value is None and optional:
        return
    try:
        ok = as_dtype(value).is_floating_point
    except TypeError:
        ok = False
    if not ok:
        raise ValueError(
            f"{owner}.{field} = {value!r} is not a floating dtype; "
            f"known precision policies: {known_policies()}")


@dataclasses.dataclass(frozen=True)
class Policy:
    """A matmul precision policy (see the module docstring)."""

    name: str
    compute_dtype: torch.dtype
    accum_dtype: torch.dtype
    output_dtype: Optional[torch.dtype] = None
    # mirrors the reference's field; the port never branches on it (an fp16
    # accumulator is re-rounded per block whatever it says: blockwise_accum)
    faithful_accum: bool = False
    x_dtype: Optional[torch.dtype] = None
    w_dtype: Optional[torch.dtype] = None
    grad_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        _validate_dtype("Policy", "compute_dtype", self.compute_dtype)
        _validate_dtype("Policy", "accum_dtype", self.accum_dtype)
        _validate_dtype("Policy", "output_dtype", self.output_dtype,
                        optional=True)
        for f in ("x_dtype", "w_dtype", "grad_dtype"):
            _validate_dtype("Policy", f, getattr(self, f), optional=True)

    @property
    def out_dtype(self) -> torch.dtype:
        return self.output_dtype if self.output_dtype is not None else self.compute_dtype

    @property
    def x_storage_dtype(self) -> torch.dtype:
        return self.x_dtype if self.x_dtype is not None else self.compute_dtype

    @property
    def w_storage_dtype(self) -> torch.dtype:
        return self.w_dtype if self.w_dtype is not None else self.compute_dtype

    @property
    def grad_storage_dtype(self) -> torch.dtype:
        return self.grad_dtype if self.grad_dtype is not None else self.compute_dtype

    @property
    def mixed_storage(self) -> bool:
        return any(getattr(self, f) is not None
                   for f in ("x_dtype", "w_dtype", "grad_dtype"))

    @property
    def scaled(self) -> bool:
        """True when any operand storage is FP8 (per-tensor scales)."""
        return any(is_fp8(d) for d in (self.x_dtype, self.w_dtype,
                                       self.grad_dtype) if d is not None)

    @property
    def blockwise_accum(self) -> bool:
        """True when the accumulator is re-rounded to ``accum_dtype`` after
        every reduction block: the reference kernel keeps its scratch
        accumulator in ``accum_dtype``, so an fp16 accumulator is."""
        return self.accum_dtype == torch.float16


PAPER_FP16 = Policy("paper_fp16", torch.float16, torch.float16, torch.float16,
                    faithful_accum=True)
TPU_FP16 = Policy("tpu_fp16", torch.float16, torch.float32, torch.float16)
TPU_BF16 = Policy("tpu_bf16", torch.bfloat16, torch.float32, torch.bfloat16)
FP32 = Policy("fp32", torch.float32, torch.float32, torch.float32)
MIXED_FP8_E4M3 = Policy(
    "mixed_fp8_e4m3", torch.float16, torch.float16, torch.float16,
    faithful_accum=True, x_dtype=torch.float8_e4m3fn,
    w_dtype=torch.float8_e4m3fn, grad_dtype=torch.float8_e5m2)
MIXED_FP8_E5M2 = Policy(
    "mixed_fp8_e5m2", torch.float16, torch.float32, torch.float16,
    x_dtype=torch.float8_e5m2, w_dtype=torch.float8_e5m2,
    grad_dtype=torch.float8_e5m2)

_BY_NAME = {p.name: p for p in (PAPER_FP16, TPU_FP16, TPU_BF16, FP32,
                                MIXED_FP8_E4M3, MIXED_FP8_E5M2)}


def known_policies() -> Tuple[str, ...]:
    return tuple(sorted(_BY_NAME))


def resolve(policy) -> Policy:
    """Accept a Policy or its name; None is the LM default (tpu_bf16)."""
    if isinstance(policy, Policy):
        return policy
    if policy is None:
        return TPU_BF16
    try:
        return _BY_NAME[str(policy)]
    except KeyError as e:
        raise ValueError(
            f"unknown precision policy {policy!r}; known: {sorted(_BY_NAME)}"
        ) from e


def quantize_fp8(v: torch.Tensor, dtype,
                 scale: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor unit-max quantization ``q = v / s`` stored in ``dtype``.

    ``s = amax(|v|)`` in fp32 unless ``scale`` is given; an all-zero or
    non-finite tensor gets ``s = 1``.  Values land in [-1, 1] so products
    on a binary16 datapath cannot overflow.  Returns ``(q, s)``."""
    dt = as_dtype(dtype)
    if not is_fp8(dt):
        raise ValueError(
            f"quantize_fp8 target must be one of {FP8_FORMATS}, got "
            f"{dtype_name(dt)!r}")
    vf = v.to(torch.float32)
    if scale is None:
        amax = vf.abs().max() if vf.numel() else vf.new_zeros(())
        scale = torch.where((amax > 0) & torch.isfinite(amax), amax,
                            torch.ones_like(amax))
    scale = torch.as_tensor(scale, dtype=torch.float32, device=vf.device)
    return _to_fp8(vf / scale, dt), scale


def _to_fp8(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """fp32 -> FP8, round to nearest even, bit for bit as XLA converts.

    PyTorch saturates where XLA does not: E4M3 (no infinity) takes ±NaN
    above 464 (what rounds past 448) and for ±inf, where PyTorch gives
    ±448; an E5M2 NaN is 0x7e (with its sign bit), where PyTorch gives
    0x7f.  Finite values inside the range convert alike."""
    if dt == torch.float8_e4m3fn:
        nan = torch.full_like(x, float("nan")).copysign(x)
        return torch.where(x.abs() > 464.0, nan, x).to(dt)
    q = x.to(dt).view(torch.uint8)
    return torch.where(torch.isnan(x), (q & 0x80) | 0x7E, q).view(dt)


def dequantize_fp8(q: torch.Tensor, scale, dtype=torch.float32) -> torch.Tensor:
    """Invert :func:`quantize_fp8`: widen and multiply the scale back."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    return (q.to(torch.float32) * s).to(as_dtype(dtype))
