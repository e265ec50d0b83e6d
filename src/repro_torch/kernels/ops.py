"""Dispatch over the kernels, by the device of the tensors.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version.  There is no mode
switch, no environment variable and no fallback: the device of the data
is the whole policy.  Launch counts live in ``kernels._cuda.LAUNCHES``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.addertree import addertree_cuda
from repro_torch.kernels.epilogue import Epilogue, rms_normalize
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda,
                                                 flash_attention_lse_cuda,
                                                 flash_decode_cuda,
                                                 flash_decode_tiled,
                                                 paged_flash_decode_cuda,
                                                 paged_flash_decode_tiled)
from repro_torch.kernels.matmul import (int8_matmul_cuda, matmul_cuda,
                                        rmsnorm_cuda)
from repro_torch.kernels.quantize import (QuantizedWeight,
                                          quantize_rowwise_cuda)


def matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
           epilogue: Optional[Epilogue] = None,
           residual: Optional[torch.Tensor] = None,
           operand2: Optional[torch.Tensor] = None,
           norm_scale: Optional[torch.Tensor] = None):
    """``epilogue(a @ b)`` for 2-D ``a [M, K]`` and ``b [K, N]``; callers
    flatten leading dims.  ``out_dtype`` fills ``epilogue.out_dtype`` when
    that is unset (default: the fp32 accumulator).  Returns
    ``(value, normed)`` under ``norm='rmsnorm'``.

    ``b`` may be a ``QuantizedWeight`` (the int8 serving path): ``a`` is
    then rowwise-quantized and the GEMM runs int8 x int8 -> int32 with both
    scales applied in the epilogue."""
    if epilogue is None and any(x is not None for x in
                                (residual, operand2, norm_scale)):
        raise ValueError("residual/operand2/norm_scale operands require an "
                         "Epilogue spec")
    if isinstance(b, QuantizedWeight):
        qa, sa = quantize_rowwise(a)
        return int8_matmul(qa, sa, *b.as_matrix(), out_dtype=out_dtype,
                           epilogue=epilogue, residual=residual,
                           operand2=operand2, norm_scale=norm_scale)
    ep = epilogue or Epilogue()
    if out_dtype is not None and ep.out_dtype is None:
        ep = dataclasses.replace(ep, out_dtype=out_dtype)
    if a.is_cuda:
        return matmul_cuda(a, b, ep, residual=residual, operand2=operand2,
                           norm_scale=norm_scale)
    return ref.matmul_fused_ref(a, b, ep, residual=residual,
                                operand2=operand2, norm_scale=norm_scale)


def int8_matmul(qa: torch.Tensor, sa: torch.Tensor, qb: torch.Tensor,
                sb: torch.Tensor, *, out_dtype=None,
                epilogue: Optional[Epilogue] = None,
                residual: Optional[torch.Tensor] = None,
                operand2: Optional[torch.Tensor] = None,
                norm_scale: Optional[torch.Tensor] = None):
    """``epilogue(sa * sb * (qa @ qb))``: int8 ``qa [M, K]`` with row
    scales ``sa [M, 1]`` (what ``quantize_rowwise`` or the previous GEMM's
    quantize epilogue emits) against int8 ``qb [K, N]`` with column scales
    ``sb [1, N]``, int32 accumulation, scales applied first in the
    epilogue.  Default output fp32; ``(q, scale)`` under ``quantize``,
    ``(value, normed)`` under ``norm='rmsnorm'``."""
    if qa.dtype != torch.int8 or qb.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 x int8, got {qa.dtype} x "
                        f"{qb.dtype}")
    ep = epilogue or Epilogue()
    if not ep.residual and residual is not None:
        raise ValueError("a residual operand requires Epilogue(residual=True)")
    if ep.gate == "none" and operand2 is not None:
        raise ValueError("an operand2 requires Epilogue(gate=...)")
    if out_dtype is not None and ep.out_dtype is None:
        ep = dataclasses.replace(ep, out_dtype=out_dtype)
    if qa.is_cuda:
        return int8_matmul_cuda(qa, sa, qb, sb, ep, residual=residual,
                                operand2=operand2, norm_scale=norm_scale)
    return ref.int8_matmul_ref(qa, sa, qb, sb, ep, residual=residual,
                               operand2=operand2, norm_scale=norm_scale)


def quantize_rowwise(x: torch.Tensor):
    """``(q int8 [M, N], scale f32 [M, 1])`` of ``x [M, N]``: K3 on the
    card."""
    if x.is_cuda:
        return quantize_rowwise_cuda(x)
    return ref.quantize_rowwise_ref(x)


def quantize_colwise(x: torch.Tensor):
    """``(q int8 [K, N], scale f32 [1, N])``: K3 on the transpose, as the
    reference reuses its rowwise kernel."""
    q_t, s_t = quantize_rowwise(x.t().contiguous())
    return q_t.t(), s_t.reshape(1, -1)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Row rmsnorm over the last axis (fp32 math, f64 for f64 rows, ``sum
    / n``, ``(1 + scale)``), cast back to ``x.dtype``.  On the card this is the
    K1 row-norm kernel, the same routine that completes the fused down
    GEMM's normed output."""
    if x.is_cuda:
        return rmsnorm_cuda(x.reshape(-1, x.shape[-1]), scale,
                            eps).reshape(x.shape)
    if x.dtype == torch.float64:    # an f64 run: the tests' exact anchor
        return rms_normalize(x, scale, eps, torch.float64)
    return rms_normalize(x, scale, eps)


def flash_attention(q, k, v, *, kind: str = "global", window: int = 0,
                    prefix_len: int = 0, softcap: Optional[float] = None):
    """Prefill attention: q [B, Sq, H, hd], k/v [B, Skv, KV, hd] ->
    [B, Sq, H, hd].  'global' is causal, 'local' attends the last
    ``window`` keys, 'chunked' the keys of the query's own chunk of
    ``window``, 'prefix' the causal keys and every key before
    ``prefix_len``, 'full' every key (Skv may differ from Sq);
    ``softcap`` caps the scores.  Other kinds raise."""
    ref.check_kind(kind)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, kind=kind, window=window,
                                    prefix_len=prefix_len, softcap=softcap)
    return ref.flash_attention_ref(q, k, v, kind=kind, window=window,
                                   prefix_len=prefix_len, softcap=softcap)


def flash_attention_lse(q, k, v, *, kind: str = "global", window: int = 0,
                        prefix_len: int = 0, softcap: Optional[float] = None):
    """``flash_attention``'s output and each query row's log-sum-exp
    [B, H, Sq] fp32 (the training forward, which keeps it for the
    backward): K4's second output on the card."""
    ref.check_kind(kind)
    if q.is_cuda:
        return flash_attention_lse_cuda(q, k, v, kind=kind, window=window,
                                        prefix_len=prefix_len,
                                        softcap=softcap)
    return ref.flash_attention_lse_ref(q, k, v, kind=kind, window=window,
                                       prefix_len=prefix_len,
                                       softcap=softcap)


def flash_attention_bwd(q, k, v, out, lse, dout, *, kind: str = "global",
                        window: int = 0, prefix_len: int = 0,
                        softcap: Optional[float] = None):
    """``(dq, dk, dv)`` of the prefill attention from its inputs, output,
    log-sum-exp and output gradient: K4's backward on the card, the plain
    recomputing backward (``ref.flash_attention_bwd_ref``) on the CPU."""
    ref.check_kind(kind)
    if q.is_cuda:
        return flash_attention_bwd_cuda(q, k, v, out, lse, dout, kind=kind,
                                        window=window, prefix_len=prefix_len,
                                        softcap=softcap)
    return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, kind=kind,
                                       window=window, prefix_len=prefix_len,
                                       softcap=softcap)


def flash_decode(q, k_cache, v_cache, pos: int, *, kind: str = "global",
                 softcap: Optional[float] = None,
                 n_splits: Optional[int] = None):
    """Decode attention over slots <= ``pos``: q [B, 1, KV, G, hd]
    against dense caches [B, K, KV, hd] -> [B, 1, KV, G, hd].  'global',
    or 'full' (every slot, ``pos`` unread: cross-attention); a local
    layer's ring buffer is decoded by
    ``models.attention.decode_attention_ring``.  ``n_splits`` (on the
    card; default: enough tile groups to fill the SMs) changes no bit of
    the result."""
    ref.check_kind(kind, ("global", "full"))
    if q.is_cuda:
        return flash_decode_cuda(q, k_cache, v_cache, pos, n_splits,
                                 softcap, kind)
    return flash_decode_tiled(q, k_cache, v_cache, pos, softcap, kind)


def paged_flash_decode(q, k_pool, v_pool, page_table, positions, *,
                       kind: str = "global", window: int = 0,
                       softcap: Optional[float] = None):
    """Paged decode and prefill-chunk attention: q [L, S, KV, G, hd]
    through ``page_table`` [L, P] against the pools [NP + 1, PS, KV, hd]
    at per-token ``positions`` [L, S] (-1 = idle) -> [L, S, KV, G, hd].
    'global', 'local' or 'chunked' (``window``); ``softcap`` caps the
    scores."""
    ref.check_kind(kind, ref.PAGED_KINDS)
    if q.is_cuda:
        return paged_flash_decode_cuda(q, k_pool, v_pool, page_table,
                                       positions, kind=kind, window=window,
                                       softcap=softcap)
    return paged_flash_decode_tiled(q, k_pool, v_pool, page_table, positions,
                                    kind=kind, window=window, softcap=softcap)


def addertree(partials: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """``out[M, N] = sum_s partials[s, M, N]`` folded in ascending s at 32
    bits, cast to ``out_dtype`` (default: the partials' dtype): K7 on the
    card."""
    if partials.dim() != 3:
        raise ValueError(f"partials must be [S, M, N], got "
                         f"{tuple(partials.shape)}")
    if partials.is_cuda:
        return addertree_cuda(partials, out_dtype)
    return ref.addertree_ref(partials, out_dtype)
