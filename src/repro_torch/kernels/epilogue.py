"""Declarative fused-GEMM epilogue spec and its plain PyTorch semantics.

The port of ``repro.kernels.epilogue``: the same fields, the same
``ValueError`` checks and the same stage order on the fp32 (or int32)
accumulator:

    acc -> (* row_scale) -> (* col_scale) -> (+ bias) -> activation
        -> (* gate(operand2)) -> (+ residual)
        -> quantize -> (q, scale)
         | cast -> rmsnorm of the CAST value (sum / n, not mean)

The normed output is computed from the cast value, so a fused
``(value, normed)`` is bitwise what storing ``value`` and re-reading it
through ``models.layers.rmsnorm`` gives.  ``apply_epilogue`` implements
the stages the serving path uses (the int8 row and column scales,
``activation='gelu'`` in its tanh form, ``gate='silu'``, the residual, the
rowwise quantize, the cast, the rmsnorm); the others (bias, the other
activations and gates, the colwise quantize) keep their fields and raise
``NotImplementedError`` until a later slice has a caller for them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch

_ACTIVATIONS = ("none", "gelu", "silu", "relu")
_GATES = ("none", "mul", "gelu", "silu", "relu")
_NORMS = ("none", "rmsnorm")
_QUANT_AXES = ("row", "col")


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Static description of a fused GEMM store phase (see module doc).

    ``out_dtype`` is a ``torch.dtype`` (None -> accumulator dtype)."""

    bias: bool = False
    activation: str = "none"
    gate: str = "none"
    residual: bool = False
    norm: str = "none"
    norm_eps: float = 1e-6
    out_dtype: Optional[Any] = None
    quantize: bool = False
    quantize_axis: str = "row"

    def __post_init__(self):
        if self.activation not in _ACTIVATIONS:
            raise ValueError(
                f"Epilogue.activation must be one of {_ACTIVATIONS}, "
                f"got {self.activation!r}")
        if self.gate not in _GATES:
            raise ValueError(
                f"Epilogue.gate must be one of {_GATES}, "
                f"got {self.gate!r}")
        if self.norm not in _NORMS:
            raise ValueError(
                f"Epilogue.norm must be one of {_NORMS}, "
                f"got {self.norm!r}")
        if self.quantize_axis not in _QUANT_AXES:
            raise ValueError(
                f"Epilogue.quantize_axis must be one of {_QUANT_AXES}, "
                f"got {self.quantize_axis!r}")
        if self.quantize and self.norm != "none":
            raise ValueError(
                "Epilogue.quantize and Epilogue.norm are mutually "
                "exclusive: the normed output feeds a full-width GEMM "
                "input, quantize emits (q, scale)")
        if not self.norm_eps > 0:
            raise ValueError(
                f"Epilogue.norm_eps must be > 0, got {self.norm_eps!r}")

    @property
    def is_identity(self) -> bool:
        """True when the epilogue is nothing but the accumulator cast."""
        return not (self.bias or self.residual or self.quantize
                    or self.activation != "none"
                    or self.gate != "none" or self.norm != "none")


def rms_normalize(value: torch.Tensor, scale: torch.Tensor, eps: float,
                  wide: torch.dtype = torch.float32) -> torch.Tensor:
    """``value * rsqrt(sum(value^2)/n + eps) * (1 + scale)`` at ``wide``,
    cast back to ``value.dtype``: the one rmsnorm expression shared by the
    epilogue's norm stage and the standalone ``models.layers.rmsnorm``."""
    nf = value.to(wide)
    ms = torch.sum(nf * nf, dim=-1, keepdim=True) / nf.shape[-1]
    out = nf * torch.rsqrt(ms + eps) * (1.0 + scale.to(wide))
    return out.to(value.dtype)


def quantize_symmetric(x: torch.Tensor, dim: int, compiled: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``dim`` (the reduced axis):
    ``scale = max(absmax, 1e-12) / 127`` in f32, ``q = clip(round(x /
    scale), +-127)`` with an IEEE division and round-half-even; ``dim=-1``
    gives per-row scales, ``dim=-2`` per-column scales.

    The reference divides by the constant 127 in two ways: inside a
    compiled program (every activation quantize, the kernels) XLA turns it
    into a multiply by the rounded reciprocal ``fl(1/127)``, while its
    one-shot weight pass runs op by op and divides.  ``compiled`` picks
    the first, the K3 kernel's; ``False`` the second."""
    absmax = torch.clamp(torch.amax(torch.abs(x), dim=dim, keepdim=True),
                         min=1e-12)
    if compiled:
        scale = absmax * (1.0 / 127.0)
    else:  # a tensor divisor: CUDA takes a scalar one as a reciprocal
        scale = absmax / torch.full_like(absmax, 127.0)
    scale = scale.to(torch.float32)
    q = torch.clamp(torch.round(x / scale.to(x.dtype)), -127, 127)
    return q.to(torch.int8), scale


def apply_epilogue(
    acc: torch.Tensor,
    ep: Epilogue,
    residual: Optional[torch.Tensor] = None,
    operand2: Optional[torch.Tensor] = None,
    norm_scale: Optional[torch.Tensor] = None,
    row_scale: Optional[torch.Tensor] = None,
    col_scale: Optional[torch.Tensor] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Apply ``ep`` to a GEMM accumulator ``[M, N]`` (fp32 or int32, or f64
    for the oracles, which keeps the whole chain at f64).  ``row_scale
    [M, 1]`` and ``col_scale [1, N]`` dequantize an int8 GEMM's int32
    accumulator first, in that order.  Returns the cast value, ``(q,
    scale)`` under ``quantize``, or ``(value, normed)`` under
    ``norm='rmsnorm'``.  A scaled accumulator defaults to fp32 output."""
    if ep.quantize and ep.quantize_axis != "row":
        raise NotImplementedError(
            "the colwise quantize epilogue belongs to the training slice")
    if ep.bias or ep.activation not in ("none", "gelu") \
            or ep.gate not in ("none", "silu"):
        raise NotImplementedError(
            f"the serving slice runs the int8 scales, activation='gelu', "
            f"gate='silu', the residual, the row quantize and the rmsnorm; "
            f"{ep} needs a later slice")
    scaled = row_scale is not None or col_scale is not None
    if ep.is_identity and not scaled:
        return acc.to(ep.out_dtype) if ep.out_dtype else acc
    wide = torch.float64 if acc.dtype == torch.float64 else torch.float32
    x = acc.to(wide)
    if row_scale is not None:
        x = x * row_scale.to(wide)
    if col_scale is not None:
        x = x * col_scale.to(wide)
    if ep.activation == "gelu":
        # jax.nn.gelu's default, the tanh form (the reference's
        # kernels/epilogue.py:166), on the fp32 accumulator
        x = torch.nn.functional.gelu(x, approximate="tanh")
    if ep.gate == "silu":
        if operand2 is None:
            raise ValueError("Epilogue.gate set but no operand2")
        x = torch.nn.functional.silu(operand2.to(wide)) * x
    if ep.residual:
        if residual is None:
            raise ValueError("Epilogue.residual set but no residual operand")
        x = x + residual.to(wide)
    if ep.quantize:
        return quantize_symmetric(x, dim=-1)
    value = x.to(ep.out_dtype or (torch.float32 if scaled else acc.dtype))
    if ep.norm == "rmsnorm":
        if norm_scale is None:
            raise ValueError("Epilogue.norm set but no norm_scale operand")
        return value, rms_normalize(value, norm_scale.reshape(1, -1),
                                    ep.norm_eps, wide)
    return value
