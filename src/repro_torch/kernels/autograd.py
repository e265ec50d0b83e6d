"""The training path's autograd Functions over the kernels.

The reference differentiates its kernels' plain XLA versions (no
``custom_vjp`` in ``src/repro/kernels/``); the port differentiates its
kernels by hand, so that the card's backward runs on kernels too:

* ``matmul``: K1 with its epilogues (the gate ``silu(g) * u`` with
  ``operand2``, the residual, the ``(value, normed)`` rmsnorm of the cast
  value).  The weight is passed at its own dtype (the fp32 master) and
  cast to the activation's dtype inside, so its gradient comes back at the
  master's dtype and width.  The backward adds the gradients of both
  outputs, differentiates the epilogue in plain torch at fp32 (it
  recomputes the gate's input ``u = a @ w`` with a K1 launch of the fp32
  store rather than keeping it), then launches ``dA = dC @ W^T`` (K1, the
  activation's dtype) and ``dW = A^T @ dC`` (K1's fp32 store), ``dC``
  rounded to the activation's dtype; the transposed operands are
  contiguous copies.
* ``rmsnorm``: the standalone row norm (``k1_rmsnorm_rows``); its backward
  is plain torch, as the reference has no kernel for it.
* ``flash_attention``: K4, which keeps q, k, v, its output and its row
  log-sum-exp; the backward is K4's backward kernel, in the forward's
  kind (its window and prefix length) and softcap, at Sq == Skv.
* ``embed``: the embedding gather, whose backward sums each row's
  gradients in token order (a stable sort, then one segment sum per
  row, no atomics), so a recomputed or repeated step is bitwise the same
  on the card.

On the CPU the same Functions run the kernels' plain versions
(``kernels.ops`` dispatches by device), so the formulas are the ones the
CPU tests hold against ``torch.autograd`` and ``jax.grad``; only the
launches differ on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.epilogue import Epilogue, rms_normalize


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The width a backward computes at: fp32, or f64 for f64 inputs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _norm_grads(value, scale, eps, dnormed):
    """Gradients of ``rms_normalize(value, scale)`` at the value's width
    (fp32 for bf16) with respect to the value and the scale."""
    wide = _wide(value.dtype)
    with torch.enable_grad():
        vv = value.detach().to(wide).requires_grad_()
        sc = scale.detach().to(wide).requires_grad_()
        y = rms_normalize(vv, sc.reshape(1, -1), eps, wide)
        dv, ds = torch.autograd.grad(y, (vv, sc), dnormed.to(wide))
    return dv, ds


class _Matmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, w, ep: Epilogue, residual, operand2, norm_scale):
        wc = w.to(a.dtype)
        out = kops.matmul(a, wc, epilogue=ep,
                          residual=residual if ep.residual else None,
                          operand2=operand2 if ep.gate != "none" else None,
                          norm_scale=norm_scale if ep.norm != "none" else None)
        value = out[0] if ep.norm != "none" else out
        ctx.ep = ep
        ctx.res_dtype = residual.dtype if residual is not None else None
        ctx.save_for_backward(a, w, operand2, norm_scale,
                              value if ep.norm != "none" else None)
        return out

    @staticmethod
    def backward(ctx, *grads):
        ep = ctx.ep
        a, w, operand2, norm_scale, value = ctx.saved_tensors
        wide = _wide(a.dtype)
        dx = grads[0].to(wide)
        dscale = None
        if ep.norm != "none":
            dv, dscale = _norm_grads(value, norm_scale, ep.norm_eps,
                                     grads[1])
            dx = dx + dv
        dres = dx.to(ctx.res_dtype) if ep.residual else None
        dacc, dop2 = dx, None
        if ep.gate != "none" or ep.activation != "none":
            # the epilogue before the residual, on the recomputed fp32
            # accumulator
            acc = kops.matmul(a, w.to(a.dtype), out_dtype=wide)
            with torch.enable_grad():
                acc = acc.requires_grad_()
                y = acc
                if ep.activation == "gelu":
                    y = F.gelu(y, approximate="tanh")
                elif ep.activation != "none":
                    raise NotImplementedError(ep.activation)
                ins = [acc]
                if ep.gate == "silu":
                    g = operand2.detach().to(wide).requires_grad_()
                    y = F.silu(g) * y
                    ins.append(g)
                elif ep.gate != "none":
                    raise NotImplementedError(ep.gate)
                got = torch.autograd.grad(y, ins, dx)
            dacc = got[0]
            if ep.gate != "none":
                dop2 = got[1].to(operand2.dtype)
        dc = dacc.to(a.dtype).contiguous()
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = kops.matmul(dc, w.to(a.dtype).t().contiguous(),
                             out_dtype=a.dtype)
        if ctx.needs_input_grad[1]:
            dw = kops.matmul(a.t().contiguous(), dc,
                             out_dtype=wide).to(w.dtype)
        if dscale is not None:
            dscale = dscale.to(norm_scale.dtype)
        return da, dw, None, dres, dop2, dscale


def matmul(a: torch.Tensor, w: torch.Tensor, *, out_dtype,
           epilogue: Optional[Epilogue] = None,
           residual: Optional[torch.Tensor] = None,
           operand2: Optional[torch.Tensor] = None,
           norm_scale: Optional[torch.Tensor] = None):
    """``kops.matmul(a, w.to(a.dtype), ...)`` with its gradients: a [M, K]
    in the compute dtype, w [K, N] at any float dtype (the master).
    Returns the value, or ``(value, normed)`` under ``norm='rmsnorm'``."""
    ep = epilogue or Epilogue()
    if ep.out_dtype is None:
        ep = dataclasses.replace(ep, out_dtype=out_dtype)
    return _Matmul.apply(a, w, ep, residual, operand2, norm_scale)


class _RowNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return kops.rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        shape = x.shape
        dx, ds = _norm_grads(x.reshape(-1, shape[-1]), scale, ctx.eps,
                             dy.reshape(-1, shape[-1]))
        return dx.reshape(shape).to(x.dtype), ds.to(scale.dtype), None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``kops.rmsnorm`` (the row-norm kernel) with its gradients."""
    return _RowNorm.apply(x, scale, eps)


class _Flash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, kind: str, window: int, prefix_len: int,
                softcap):
        out, lse = kops.flash_attention_lse(q, k, v, kind=kind,
                                            window=window,
                                            prefix_len=prefix_len,
                                            softcap=softcap)
        ctx.mask = dict(kind=kind, window=window, prefix_len=prefix_len,
                        softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = kops.flash_attention_bwd(q, k, v, out, lse,
                                              dout.contiguous(), **ctx.mask)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, kind: str = "global", window: int = 0,
                    prefix_len: int = 0, softcap: Optional[float] = None):
    """``kops.flash_attention`` with its gradients (K4 and its backward)."""
    return _Flash.apply(q, k, v, kind, window, prefix_len, softcap)


class _Embed(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, ids, dtype):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids].to(dtype)

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1).long()
        g = dy.reshape(flat.shape[0], -1).to(_wide(dy.dtype))
        # each row's gradients summed in token order, with no atomics: a
        # stable sort groups a row's tokens, one segment sum per row
        rows, order = torch.sort(flat, stable=True)
        rows, counts = torch.unique_consecutive(rows, return_counts=True)
        out = torch.zeros((ctx.rows, g.shape[1]), dtype=g.dtype,
                          device=g.device)
        out[rows] = torch.segment_reduce(g[order], "sum", lengths=counts,
                                         axis=0)
        return out, None, None


def embed(table: torch.Tensor, ids: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """``table[ids]`` cast to ``dtype`` (``layers.vocab_parallel_embed``),
    its gradient summed into the table's rows at fp32 in a fixed order."""
    return _Embed.apply(table, ids, dtype)
