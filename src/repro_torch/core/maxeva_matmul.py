"""The MaxEVA X x Y x Z matmul, single-device slice.

On one device the xyz weight layout ``[model, K/Y, N/Z]`` is ``[1, K, N]``
and the whole product is one local GEMM with the epilogue fused into its
store phase.  The port keeps weights in the unsharded ``[K, N]`` form
(``unshard_weight_xyz`` converts the reference's layout) and runs the
local GEMM through ``kernels.ops.matmul``.  The multi-device schedules
(allreduce, reduce-scatter, the rings, the overlapped gather) are a later
slice.

``rank_order_sum`` is the determinism rule every reduction of the port
shares: stacked contributions fold at fp32 in ascending order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.epilogue import Epilogue


@dataclasses.dataclass(frozen=True)
class XYZConfig:
    """Per-GEMM plan consumed by ``xyz_matmul`` (single device: Y == 1)."""

    y: int = 1
    out_dtype: Optional[torch.dtype] = None
    epilogue: Optional[Epilogue] = None

    def __post_init__(self):
        if self.y != 1:
            raise NotImplementedError(
                "K-sharded (Y > 1) xyz plans need the multi-device slice")


def unshard_weight_xyz(w_xyz: torch.Tensor, y: int) -> torch.Tensor:
    """Inverse of the reference's ``shard_weight_xyz``: xyz layout
    ``[model, K/Y, N/Z]`` -> ``[K, N]`` (a reshape of ``[1, K, N]`` on one
    device)."""
    model, ky_rows, ncol = w_xyz.shape
    z = model // y
    k = ky_rows * y
    w_dev = w_xyz.reshape(z, y, z, k // model, ncol)  # (nz, ky, kz, krow, n)
    return w_dev.permute(2, 1, 3, 0, 4).reshape(k, z * ncol)


def rank_order_sum(buf: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Fold ``buf`` over axis 0 in ascending order at fp32 (f64 stays
    f64; integers fold exactly at int32), then cast to ``dtype``: the
    association that makes split counts and schedules bitwise-equal."""
    if not buf.dtype.is_floating_point:
        wide = torch.int32
    else:
        wide = torch.float64 if buf.dtype == torch.float64 else torch.float32
    acc = buf[0].to(wide)
    for i in range(1, buf.shape[0]):
        acc = acc + buf[i].to(wide)
    return acc.to(dtype)


def xyz_matmul(x: torch.Tensor, w: torch.Tensor, *, cfg: XYZConfig,
               residual: Optional[torch.Tensor] = None,
               operand2: Optional[torch.Tensor] = None,
               norm_scale: Optional[torch.Tensor] = None):
    """``out[..., N] = epilogue(x[..., K] @ w)`` on one device.  ``w`` is
    the unsharded ``[K, N]`` weight.  Without an epilogue the output is
    cast to ``cfg.out_dtype or x.dtype`` in the GEMM's store phase (the
    same single rounding of the fp32 accumulator as casting after).
    Returns ``(value, normed)`` under ``norm='rmsnorm'``."""
    ep = cfg.epilogue
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out_dtype = cfg.out_dtype or x.dtype
    if ep is None:
        return kops.matmul(x2, w, out_dtype=out_dtype).reshape(*lead, -1)
    ep1 = dataclasses.replace(ep, out_dtype=ep.out_dtype or out_dtype)
    res2 = residual.reshape(-1, residual.shape[-1]) \
        if residual is not None else None
    o2 = operand2.reshape(-1, operand2.shape[-1]) \
        if operand2 is not None else None
    out = kops.matmul(x2, w, epilogue=ep1, residual=res2, operand2=o2,
                      norm_scale=norm_scale)
    if ep1.norm != "none":
        value, normed = out
        return value.reshape(*lead, -1), normed.reshape(*lead, -1)
    return out.reshape(*lead, -1)


def xyz_matmul_replicated_out(x: torch.Tensor, w: torch.Tensor, *,
                              cfg: XYZConfig,
                              residual: Optional[torch.Tensor] = None,
                              operand2: Optional[torch.Tensor] = None,
                              norm_scale: Optional[torch.Tensor] = None):
    """The row-parallel (Y == model) down projection with a full-row
    output — on one device the same local GEMM as ``xyz_matmul``, and the
    home of the ``norm='rmsnorm'`` epilogue."""
    return xyz_matmul(x, w, cfg=cfg, residual=residual, operand2=operand2,
                      norm_scale=norm_scale)
