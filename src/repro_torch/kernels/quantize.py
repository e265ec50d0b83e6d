"""K3, the rowwise int8 quantize, launched on the card, and the
``QuantizedWeight`` the int8 serving path stores its weights in.

``quantize_rowwise_cuda`` wraps ``k3_quantize_rows`` of
``csrc/matmul.cu``; its plain version is ``ref.quantize_rowwise_ref``,
which ``kernels.ops`` takes for tensors on the CPU.  Both compute
``scale = max(absmax, 1e-12) * fl(1/127)`` (the reference's ``/ 127.0``
as XLA compiles it: a multiply by the rounded reciprocal) and ``q =
clip(round(x / scale), +-127)`` with an IEEE division and
round-half-even, so they agree bit for bit with each other and with the
reference.  The weight pass, the fixed-scale quantize and the saturation counter
are plain tensor code, as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.kernels import _cuda


class QuantizedWeight(nn.Module):
    """An int8 GEMM weight with per-column scales: the int8 values stored
    K-major, as the ``qt`` buffer ``[N, K]`` (the layout the s8 wgmma of
    K2 reads), and the ``scale`` buffer f32 ``[1, N]``.  ``q`` is the
    ``[K, N]`` view of ``qt``, the reference's layout.  Serving only: made
    by ``Model.quantize_params_for_serving``, never trained."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        """``q`` int8 ``[K, N]`` (any strides; stored transposed once)."""
        super().__init__()
        if q.dtype != torch.int8 or scale.dtype != torch.float32:
            raise TypeError(f"QuantizedWeight holds int8 values and f32 "
                            f"scales, got {q.dtype} and {scale.dtype}")
        if q.dim() != 2:
            raise ValueError(f"QuantizedWeight holds a [K, N] matrix, got "
                             f"{tuple(q.shape)}")
        self.register_buffer("qt", q.t().contiguous())
        self.register_buffer("scale", scale)

    @property
    def q(self) -> torch.Tensor:
        """The int8 values as ``[K, N]``: a view of the ``[N, K]``
        storage."""
        return self.qt.t()

    def as_matrix(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The 2-D GEMM operand pair ``(q [K, N], scale [1, N])``; ``q`` is
        the transposed view of the K-major storage."""
        return self.q, self.scale.reshape(1, self.qt.shape[0])

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.q.to(torch.float32) * self.scale).to(dtype)


def quantize_weight_colwise(w: torch.Tensor) -> QuantizedWeight:
    """One-shot column-wise weight quantization (the serving pass): one
    scale per output column, the layout the int8 GEMM's store phase folds
    back in."""
    from repro_torch.kernels.ref import quantize_colwise_ref
    return QuantizedWeight(*quantize_colwise_ref(w))


def quantize_fixed_scale(x: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    """Quantize with a fixed (calibrated) scale.  Unlike the absmax scale
    it can saturate, and the clip at +-127 is where that lands, which
    ``saturation_fraction`` counts."""
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8)


def saturation_fraction(q: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Fraction of int8 values at the clip boundary (|q| == 127) along
    ``dim``: one health number per lane for a ``[L, N]`` tensor."""
    sat = (torch.abs(q.to(torch.int32)) >= 127).to(torch.float32)
    return torch.mean(sat, dim=dim)


def quantize_rowwise_cuda(x: torch.Tensor, *, count: str = "quantize"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: ``(q int8 [M, N], scale f32 [M, 1])`` of a bf16 or fp32
    ``[M, N]`` CUDA tensor whose rows are whole 16-byte vectors (N a
    multiple of 8 for bf16, of 4 for fp32), whole warps a row (as many as
    the shape needs to fill the card; no count changes a bit).  ``count``
    names the launch counter: the int8 GEMM's own row pass counts as
    ``int8_quantize``.  M == 0 returns empty outputs without a launch."""
    if x.dim() != 2:
        raise ValueError(f"quantize_rowwise takes [M, N], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the K3 kernel takes bf16 or fp32, got {x.dtype}")
    _cuda.check(x, "quantize input", x.dtype)
    m, n = x.shape
    per = 16 // x.element_size()
    if n % per:
        raise ValueError(f"the K3 kernel needs N divisible by {per} for "
                         f"{x.dtype}, got N={n}")
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m and n:
        _cuda.LAUNCHES[count] += 1
        _cuda.launch("matmul", "k3_quantize_rows", x.data_ptr(), q.data_ptr(),
                     scale.data_ptr(), m, n, int(x.dtype == torch.float32))
    return q, scale
