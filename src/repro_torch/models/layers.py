"""Shared layers: rmsnorm, RoPE, whisper's sinusoidal positions, the
embedding gather and the MaxEVA MLP, gated (SwiGLU) or plain GELU (single
device; bf16 or int8 weights), and the MLP's training forward
(``mlp_train``: the same GEMMs and epilogues through ``kernels.autograd``,
on the fp32 master weights, with the fold or, in whisper's encoder,
without it)."""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional

import torch

from repro_torch.core.maxeva_matmul import (XYZConfig, xyz_matmul,
                                            xyz_matmul_replicated_out)
from repro_torch.kernels import autograd as ag
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


def sinusoid(start: int, length: int, d_model: int, dtype: torch.dtype,
             device=None) -> torch.Tensor:
    """Whisper's sinusoidal positions [1, length, d_model] for positions
    start .. start + length - 1 (the reference's ``lm.py:717``): angles
    ``pos * exp(-i * log(10000) / (d/2 - 1))`` at fp32, ``[sin | cos]``,
    cast to ``dtype``."""
    pos = start + torch.arange(length, device=device)[:, None].to(
        torch.float32)
    half = d_model // 2
    freq = torch.exp(-torch.arange(half, dtype=torch.float32, device=device)
                     * (math.log(10000.0) / max(half - 1, 1)))
    ang = pos * freq[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[None].to(dtype)


@contextlib.contextmanager
def full_fp32():
    """fp32 products in full fp32 on every device inside the block: TF32
    off, as XLA's fp32 einsum on the CPU is full fp32."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of fp32 operands in full fp32 (``full_fp32``): the MoE's
    router, the RG-LRU's gates, the xLSTM mixers' gate and input maps."""
    with full_fp32():
        return torch.matmul(a, b)


def vocab_parallel_embed(table: torch.Tensor, ids: torch.Tensor,
                         compute_dtype: torch.dtype) -> torch.Tensor:
    """ids [B, S] -> [B, S, D] in the compute dtype (one device: a plain
    row gather)."""
    return table[ids].to(compute_dtype)


def up_epilogue(gated: bool, **kw) -> Epilogue:
    """The up GEMM's epilogue: ``silu(g) * u`` from the gate GEMM's raw g
    (``operand2``; gated) or ``gelu(u)`` (plain), with ``kw``'s store."""
    return (Epilogue(gate="silu", **kw) if gated
            else Epilogue(activation="gelu", **kw))


def next_norm_fold(norm_eps: float, compute_dtype: torch.dtype) -> Epilogue:
    """The down GEMM's epilogue in a decoder block: the residual add and the
    NEXT norm, returning ``(value, normed)``."""
    return Epilogue(residual=True, norm="rmsnorm", norm_eps=norm_eps,
                    out_dtype=compute_dtype)


def _mlp_apply_int8(params: Dict[str, QuantizedWeight], x: torch.Tensor,
                    compute_dtype: torch.dtype, residual: torch.Tensor,
                    norm_scale: torch.Tensor, norm_eps: float = 1e-6,
                    gated: bool = True):
    """The int8 MLP (weights quantized column-wise by
    ``Model.quantize_params_for_serving``), the reference's
    ``_mlp_apply_int8``.  ONE rowwise quantize of the normed stream feeds
    the up GEMM (and the gate GEMM, gated); the up GEMM's epilogue computes
    ``silu(g) * u`` from the gate GEMM's raw g (gated) or ``gelu(u)``
    (plain, ``layers.py:369-371``) and quantizes it, handing the down GEMM
    the ``(q, scale)`` pair straight from its store phase; the down GEMM
    folds the residual add and the NEXT norm.  Returns ``(h_new,
    rmsnorm(h_new, norm_scale))``."""
    lead = x.shape[:-1]
    qx, sx = kops.quantize_rowwise(x.reshape(-1, x.shape[-1]))
    g = (kops.int8_matmul(qx, sx, *params["gate"].as_matrix(),
                          out_dtype=compute_dtype) if gated else None)
    qh, sh = kops.int8_matmul(qx, sx, *params["up"].as_matrix(),
                              epilogue=up_epilogue(gated, quantize=True),
                              operand2=g)
    val, xn = kops.int8_matmul(
        qh, sh, *params["down"].as_matrix(),
        epilogue=next_norm_fold(norm_eps, compute_dtype),
        residual=residual.reshape(-1, residual.shape[-1]),
        norm_scale=norm_scale)
    return val.reshape(*lead, -1), xn.reshape(*lead, -1)


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              compute_dtype: torch.dtype,
              residual: Optional[torch.Tensor] = None,
              norm_scale: Optional[torch.Tensor] = None,
              norm_eps: float = 1e-6, gated: bool = True):
    """The MLP on the normed stream x [B, S, D].  Gated: ``silu(g) * u``
    is the up GEMM's two-operand gate epilogue (the gate GEMM emits raw
    g); plain (whisper): ``gelu(u)`` is the up GEMM's activation epilogue.
    With ``residual`` and ``norm_scale`` (a decoder block) the down GEMM
    folds the residual add and the NEXT norm into its epilogue and the
    call returns ``(h_new, rmsnorm(h_new, norm_scale))`` with ``h_new =
    residual + down(...)``; without them (whisper's encoder, whose
    residual the reference adds outside the GEMM in bf16, ``lm.py:379``)
    it returns ``down(...)`` cast to the compute dtype.  Quantized weights
    take ``_mlp_apply_int8``."""
    if isinstance(params["up"], QuantizedWeight):
        return _mlp_apply_int8(params, x, compute_dtype, residual,
                               norm_scale, norm_eps, gated)
    cd = compute_dtype
    up_cfg = XYZConfig(out_dtype=cd)
    g = xyz_matmul(x, params["gate"], cfg=up_cfg) if gated else None
    h = xyz_matmul(x, params["up"], cfg=dataclasses.replace(
        up_cfg, epilogue=up_epilogue(gated, out_dtype=cd)), operand2=g)
    if norm_scale is None:
        return xyz_matmul_replicated_out(h, params["down"],
                                         cfg=XYZConfig(out_dtype=cd))
    return xyz_matmul_replicated_out(
        h, params["down"], cfg=XYZConfig(
            out_dtype=cd, epilogue=next_norm_fold(norm_eps, cd)),
        residual=residual, norm_scale=norm_scale)


def mlp_train(params: Dict[str, torch.Tensor], x: torch.Tensor,
              compute_dtype: torch.dtype,
              residual: Optional[torch.Tensor] = None,
              norm_scale: Optional[torch.Tensor] = None,
              norm_eps: float = 1e-6, gated: bool = True):
    """``mlp_apply`` with gradients: the gate GEMM, the up GEMM with its
    ``silu(g) * u`` epilogue (or ``gelu(u)``), and the down GEMM, each
    through ``kernels.autograd.matmul`` on the master weights (cast to the
    compute dtype inside).  With ``residual`` and ``norm_scale`` (a
    decoder block) the down GEMM folds the residual and the NEXT norm and
    the call returns ``(h_new, rmsnorm(h_new, norm_scale))``; without them
    (whisper's encoder) it returns ``down(...)`` in the compute dtype."""
    cd = compute_dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    g = ag.matmul(x2, params["gate"], out_dtype=cd) if gated else None
    h = ag.matmul(x2, params["up"], out_dtype=cd,
                  epilogue=up_epilogue(gated, out_dtype=cd), operand2=g)
    if norm_scale is None:
        return ag.matmul(h, params["down"], out_dtype=cd).reshape(*lead, -1)
    val, xn = ag.matmul(h, params["down"], out_dtype=cd,
                        epilogue=next_norm_fold(norm_eps, cd),
                        residual=residual.reshape(-1, residual.shape[-1]),
                        norm_scale=norm_scale)
    return val.reshape(*lead, -1), xn.reshape(*lead, -1)
