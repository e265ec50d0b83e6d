"""Shared layers: rmsnorm, RoPE, the embedding gather and the MaxEVA MLP
(single device; bf16 or int8 weights)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.maxeva_matmul import (XYZConfig, xyz_matmul,
                                            xyz_matmul_replicated_out)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.quantize import QuantizedWeight


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """fp32 ``x * rsqrt(sum(x^2)/n + eps) * (1 + scale)`` cast back to
    ``x.dtype`` — ``sum / n``, not a mean op, the exact expression of the
    fused epilogue's norm stage.  On the card: the K1 row-norm kernel."""
    return kops.rmsnorm(x, scale, eps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x [..., S, n, hd] (n = heads or groups), positions [S] or [B, S].
    Angles in fp32; the result is cast back to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freq   # [..., S, half]
    ang = ang[..., None, :]                               # [..., S, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def vocab_parallel_embed(table: torch.Tensor, ids: torch.Tensor,
                         compute_dtype: torch.dtype) -> torch.Tensor:
    """ids [B, S] -> [B, S, D] in the compute dtype (one device: a plain
    row gather)."""
    return table[ids].to(compute_dtype)


def _mlp_apply_int8(params: Dict[str, QuantizedWeight], x: torch.Tensor,
                    compute_dtype: torch.dtype, residual: torch.Tensor,
                    norm_scale: torch.Tensor, norm_eps: float = 1e-6):
    """The int8 gated MLP (weights quantized column-wise by
    ``Model.quantize_params_for_serving``).  ONE rowwise quantize of the
    normed stream feeds both the gate and the up GEMM; the gate GEMM emits
    raw g in bf16, the up GEMM's epilogue computes ``silu(g) * u`` and
    quantizes it, handing the down GEMM the ``(q, scale)`` pair straight
    from its store phase; the down GEMM folds the residual add and the NEXT
    norm.  Returns ``(h_new, rmsnorm(h_new, norm_scale))``."""
    lead = x.shape[:-1]
    qx, sx = kops.quantize_rowwise(x.reshape(-1, x.shape[-1]))
    g = kops.int8_matmul(qx, sx, *params["gate"].as_matrix(),
                         out_dtype=compute_dtype)
    qh, sh = kops.int8_matmul(qx, sx, *params["up"].as_matrix(),
                              epilogue=Epilogue(gate="silu", quantize=True),
                              operand2=g)
    fold = Epilogue(residual=True, norm="rmsnorm", norm_eps=norm_eps,
                    out_dtype=compute_dtype)
    val, xn = kops.int8_matmul(
        qh, sh, *params["down"].as_matrix(), epilogue=fold,
        residual=residual.reshape(-1, residual.shape[-1]),
        norm_scale=norm_scale)
    return val.reshape(*lead, -1), xn.reshape(*lead, -1)


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              compute_dtype: torch.dtype, residual: torch.Tensor,
              norm_scale: torch.Tensor, norm_eps: float = 1e-6):
    """The gated MLP on the normed stream x [B, S, D], folded into the
    block's residual: returns ``(h_new, rmsnorm(h_new, norm_scale))`` with
    ``h_new = residual + down(silu(g) * u)``.  ``silu(g) * u`` is the up
    GEMM's two-operand gate epilogue (the gate GEMM emits raw g); the down
    GEMM folds the residual add and the NEXT norm (``norm_scale``) into its
    epilogue.  Quantized weights take ``_mlp_apply_int8``."""
    if isinstance(params["up"], QuantizedWeight):
        return _mlp_apply_int8(params, x, compute_dtype, residual,
                               norm_scale, norm_eps)
    cd = compute_dtype
    up_cfg = XYZConfig(out_dtype=cd)
    g = xyz_matmul(x, params["gate"], cfg=up_cfg)
    h = xyz_matmul(x, params["up"], cfg=dataclasses.replace(
        up_cfg, epilogue=Epilogue(gate="silu", out_dtype=cd)), operand2=g)
    fold = Epilogue(residual=True, norm="rmsnorm", norm_eps=norm_eps,
                    out_dtype=cd)
    return xyz_matmul_replicated_out(
        h, params["down"], cfg=XYZConfig(out_dtype=cd, epilogue=fold),
        residual=residual, norm_scale=norm_scale)
