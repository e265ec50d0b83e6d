"""Packed-parameter views.

A packed weight holds several logical weights in one array along its last
axis.  With ``packing == g`` the columns are laid out in g groups, each
``[view_0 chunk | view_1 chunk | ...]`` — granite's ``wqkv`` has
``packing = gcd(q_dim, kv_dim) = 1024`` groups of ``[4 q | 1 k | 1 v]``
columns, not ``[Q | K | V]``.  ``split_packed_columns`` works on the
packed weight and on the output of a GEMM against it (activations inherit
the packed column layout); ``pack_views`` is its inverse.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def split_packed_columns(arr: torch.Tensor, sizes: Sequence[int],
                         packing: int = 1) -> Tuple[torch.Tensor, ...]:
    """Split the last axis of ``arr`` into per-view tensors (views of
    ``arr`` where the layout allows)."""
    lead = arr.shape[:-1]
    if packing == 1:
        return tuple(torch.split(arr, list(sizes), dim=-1))
    a = arr.reshape(*lead, packing, sum(sizes) // packing)
    parts = torch.split(a, [s // packing for s in sizes], dim=-1)
    return tuple(p.reshape(*lead, s) for p, s in zip(parts, sizes))


def pack_views(views: Sequence[torch.Tensor],
               packing: int = 1) -> torch.Tensor:
    """Per-view tensors -> the packed tensor (inverse of
    ``split_packed_columns``)."""
    lead = views[0].shape[:-1]
    parts = [v.reshape(*lead, packing, v.shape[-1] // packing)
             for v in views]
    packed = torch.cat(parts, dim=-1)
    return packed.reshape(*lead, packed.shape[-2] * packed.shape[-1])
