"""K1 and K2: the blocked GEMM with a fused epilogue, float and int8,
launched on the card.

``matmul_cuda`` and ``rmsnorm_cuda`` are the wrappers of the two kernels
in ``csrc/matmul.cu``; their plain PyTorch versions are
``ref.matmul_fused_ref`` and ``epilogue.rms_normalize``, which
``kernels.ops`` takes for tensors on the CPU.  The kernel takes bf16 x bf16
with an fp32 accumulator, and of the epilogue stages the serving path
uses: the cast to bf16, ``gate='silu'`` with ``operand2``, the residual
add, and ``norm='rmsnorm'`` (the GEMM stores the value, then the
row-norm kernel normalizes the stored rows).  Any other stage or dtype
raises: the kernel never silently falls back.

``int8_matmul_cuda`` wraps K2, ``k2_int8_matmul``: int8 x int8 into an
int32 accumulator with the row and column scales applied first in the
store phase; its plain version is ``ref.int8_matmul_ref``.  It stores bf16
or fp32; under ``quantize`` it stores the fp32 value in a workspace and
the K3 row pass (counted as ``int8_quantize``) makes ``(q, scale)``;
under ``norm='rmsnorm'`` the row-norm kernel completes ``(value,
normed)``, as for K1.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.quantize import quantize_rowwise_cuda


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """Row rmsnorm of a bf16 ``[M, N]`` tensor with an fp32 ``[N]`` scale:
    ``x * rsqrt(sum(x^2)/N + eps) * (1 + scale)``, fixed-order reduction."""
    m, n = x.shape
    _cuda.check(x, "rmsnorm input", torch.bfloat16)
    _cuda.check(scale, "rmsnorm scale", torch.float32, (n,))
    out = torch.empty_like(x)
    if m == 0:
        return out
    _cuda.LAUNCHES["rmsnorm"] += 1
    _cuda.launch("matmul", "k1_rmsnorm_rows", x.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), m, n, float(eps))
    return out


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, ep: Epilogue, *,
                residual: Optional[torch.Tensor] = None,
                operand2: Optional[torch.Tensor] = None,
                norm_scale: Optional[torch.Tensor] = None):
    """``epilogue(a @ b)`` through the K1 kernel.  a [M, K], b [K, N], both
    bf16 and contiguous, K and N multiples of 8.  Returns ``[M, N]`` bf16
    (``ep.out_dtype`` must be bf16), or ``(value, normed)`` under
    ``norm='rmsnorm'``."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"the K1 kernel takes bf16 x bf16, got "
                        f"{a.dtype} x {b.dtype}")
    _cuda.check(a, "matmul A", torch.bfloat16)
    _cuda.check(b, "matmul B", torch.bfloat16)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not chain")
    m, k = a.shape
    n = b.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"the K1 kernel needs K and N divisible by 8, got "
                         f"K={k}, N={n}")
    if ep.bias or ep.quantize or ep.activation != "none" \
            or ep.gate not in ("none", "silu"):
        raise NotImplementedError(
            f"the K1 kernel implements the cast, gate='silu', residual and "
            f"rmsnorm stages; {ep} needs a later slice")
    if ep.out_dtype != torch.bfloat16:
        raise TypeError(f"the K1 kernel stores bf16, got out_dtype "
                        f"{ep.out_dtype}")
    gate = ep.gate == "silu"
    if gate:
        if operand2 is None:
            raise ValueError("Epilogue.gate set but no operand2")
        _cuda.check(operand2, "operand2", torch.bfloat16, (m, n))
    if ep.residual:
        if residual is None:
            raise ValueError("Epilogue.residual set but no residual operand")
        _cuda.check(residual, "residual", torch.bfloat16, (m, n))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    if m and n:
        _cuda.LAUNCHES["matmul"] += 1
        _cuda.launch("matmul", "k1_matmul", a.data_ptr(), b.data_ptr(),
                     out.data_ptr(),
                     residual.data_ptr() if ep.residual else None,
                     operand2.data_ptr() if gate else None,
                     m, n, k, int(gate))
    if ep.norm == "rmsnorm":
        if norm_scale is None:
            raise ValueError("Epilogue.norm set but no norm_scale operand")
        return out, rmsnorm_cuda(out, norm_scale, ep.norm_eps)
    return out


def int8_matmul_cuda(qa: torch.Tensor, sa: torch.Tensor, qb: torch.Tensor,
                     sb: torch.Tensor, ep: Epilogue, *,
                     residual: Optional[torch.Tensor] = None,
                     operand2: Optional[torch.Tensor] = None,
                     norm_scale: Optional[torch.Tensor] = None):
    """``epilogue(sa * sb * (qa @ qb))`` through the K2 kernel.  qa [M, K]
    and qb [K, N] int8 contiguous, K and N multiples of 16; sa [M, 1] and
    sb [1, N] f32.  Returns ``[M, N]`` in ``ep.out_dtype`` (bf16 or fp32,
    default fp32), ``(q, scale)`` under ``quantize`` or ``(value,
    normed)`` under ``norm='rmsnorm'``."""
    if qa.dim() != 2 or qb.dim() != 2 or qa.shape[1] != qb.shape[0]:
        raise ValueError(f"int8 matmul shapes {tuple(qa.shape)} x "
                         f"{tuple(qb.shape)} do not chain")
    m, k = qa.shape
    n = qb.shape[1]
    _cuda.check(qa, "int8 matmul A", torch.int8)
    _cuda.check(qb, "int8 matmul B", torch.int8)
    _cuda.check(sa, "a_scale", torch.float32, (m, 1))
    _cuda.check(sb, "b_scale", torch.float32, (1, n))
    if k % 16 or n % 16:
        raise ValueError(f"the K2 kernel needs K and N divisible by 16, got "
                         f"K={k}, N={n}")
    if ep.bias or ep.activation != "none" \
            or ep.gate not in ("none", "silu") \
            or (ep.quantize and ep.quantize_axis != "row"):
        raise NotImplementedError(
            f"the K2 kernel implements the scales, gate='silu', the "
            f"residual, the row quantize and the rmsnorm; {ep} needs a "
            f"later slice")
    out_dtype = torch.float32 if ep.quantize \
        else (ep.out_dtype or torch.float32)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the K2 kernel stores bf16 or fp32, got {out_dtype}")
    if ep.norm == "rmsnorm" and out_dtype != torch.bfloat16:
        raise TypeError("the K2 rmsnorm output is bf16")
    gate = ep.gate == "silu"
    if gate:
        if operand2 is None:
            raise ValueError("Epilogue.gate set but no operand2")
        _cuda.check(operand2, "operand2", torch.bfloat16, (m, n))
    if ep.residual:
        if residual is None:
            raise ValueError("Epilogue.residual set but no residual operand")
        _cuda.check(residual, "residual", torch.bfloat16, (m, n))
    out = torch.empty((m, n), dtype=out_dtype, device=qa.device)
    f32 = out_dtype == torch.float32
    if m and n:
        _cuda.LAUNCHES["int8_matmul"] += 1
        _cuda.launch("matmul", "k2_int8_matmul", qa.data_ptr(), qb.data_ptr(),
                     sa.data_ptr(), sb.data_ptr(),
                     out.data_ptr() if f32 else None,
                     None if f32 else out.data_ptr(),
                     residual.data_ptr() if ep.residual else None,
                     operand2.data_ptr() if gate else None,
                     m, n, k, int(gate))
    if ep.quantize:
        return quantize_rowwise_cuda(out, count="int8_quantize")
    if ep.norm == "rmsnorm":
        if norm_scale is None:
            raise ValueError("Epilogue.norm set but no norm_scale operand")
        return out, rmsnorm_cuda(out, norm_scale, ep.norm_eps)
    return out
