"""Attention for the dense GQA decoder: one packed QKV GEMM (bf16, or
int8 against a ``QuantizedWeight``), RoPE, flash prefill (K4) over the
grouped K/V, cached decode through split-K flash decode (K5), and paged
serving: K/V scattered through a page table into shared pools, then paged
flash decode (K6) for decode steps and prefill chunks alike."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.quantize import QuantizedWeight
from repro_torch.models.layers import rope
from repro_torch.models.param import split_packed_columns


def qkv_packing(cfg: ArchConfig) -> int:
    """Shard-interleave factor of the packed ``wqkv`` columns:
    gcd(q_dim, kv_dim) groups of ``[q | k | v]`` chunks (1024 groups of
    ``[4 q | 1 k | 1 v]`` columns for granite-3-8b)."""
    return math.gcd(cfg.q_dim, cfg.kv_dim)


def qkv_sizes(cfg: ArchConfig) -> Tuple[int, int, int]:
    return (cfg.q_dim, cfg.kv_dim, cfg.kv_dim)


class Attention(nn.Module):
    """The packed ``wqkv [D, q_dim + 2 kv_dim]`` (interleaved, see
    ``qkv_packing``) and the out projection ``wo [q_dim, D]``; either may
    be a ``QuantizedWeight`` (``weights`` given: the int8 serving copy)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, weights: Optional[dict] = None):
        super().__init__()
        if weights is not None:
            self.wqkv, self.wo = weights["wqkv"], weights["wo"]
            return
        d = cfg.d_model
        kw = dict(dtype=dtype, device=device)
        self.wqkv = nn.Parameter(
            torch.empty(d, cfg.q_dim + 2 * cfg.kv_dim, **kw),
            requires_grad=False)
        self.wo = nn.Parameter(torch.empty(cfg.q_dim, d, **kw),
                               requires_grad=False)


def _weight(w, compute_dtype: torch.dtype):
    """A float weight cast to the compute dtype; a ``QuantizedWeight``
    as it is (``kops.matmul`` runs the int8 GEMM for it)."""
    return w if isinstance(w, QuantizedWeight) else w.to(compute_dtype)


def project_qkv(attn: Attention, x: torch.Tensor, cfg: ArchConfig,
                compute_dtype: torch.dtype):
    """One GEMM against the packed ``wqkv`` (weight cast to the compute
    dtype, cast of the output fused in the store phase; an int8 weight
    takes one rowwise quantize of x and one int8 GEMM); the split is paid
    on the activation output.  Returns un-roped q [B,S,H,hd],
    k/v [B,S,KV,hd]."""
    b, s, _ = x.shape
    y = kops.matmul(x.reshape(b * s, -1), _weight(attn.wqkv, compute_dtype),
                    out_dtype=compute_dtype).reshape(b, s, -1)
    q, k, v = split_packed_columns(y, qkv_sizes(cfg), qkv_packing(cfg))
    return (q.reshape(b, s, cfg.n_heads, cfg.hd),
            k.reshape(b, s, cfg.n_kv_heads, cfg.hd),
            v.reshape(b, s, cfg.n_kv_heads, cfg.hd))


def decode_attention(q, k_cache, v_cache, pos: int) -> torch.Tensor:
    """q [B, 1, KV, G, hd] against dense caches [B, K, KV, hd], slots <=
    ``pos`` live: the tiled flash-decode path (K5 on the card)."""
    return kops.flash_decode(q, k_cache, v_cache, pos)


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: int) -> None:
    """Write [B, S, KV, hd] at slots ``pos .. pos+S-1``.  The caches are
    updated IN PLACE (the reference returns new arrays; here the cache
    buffers are owned by the serving loop and never aliased)."""
    s = k_new.shape[1]
    k_cache[:, pos:pos + s] = k_new.to(k_cache.dtype)
    v_cache[:, pos:pos + s] = v_new.to(v_cache.dtype)


def paged_update(k_pool: torch.Tensor, v_pool: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 positions: torch.Tensor, page_table: torch.Tensor) -> None:
    """Scatter [L, S, KV, hd] post-rope K/V through the page table, IN
    PLACE (the reference returns new pools; here the scheduler owns them).
    Position p of lane l lives at ``pool[page_table[l, p // PS], p % PS]``;
    an inactive slot (position -1) or an unmapped page writes to the
    trash page (the last pool row), so the scatter's shape never depends
    on how many lanes are live.  Duplicate trash writes may race; the
    trash page is never read unmasked."""
    n_pool, ps = k_pool.shape[0], k_pool.shape[1]
    b, s = positions.shape
    valid = positions >= 0
    lpage = torch.clamp(torch.div(positions, ps, rounding_mode="floor"), 0,
                        page_table.shape[1] - 1)
    slot = torch.where(valid, positions % ps, 0)
    phys = torch.gather(page_table, 1, lpage.to(torch.long))
    phys = torch.where(valid & (phys >= 0), phys, n_pool - 1)
    pf, sf = phys.reshape(-1).long(), slot.reshape(-1).long()
    k_pool[pf, sf] = k_new.reshape(b * s, *k_new.shape[2:]).to(k_pool.dtype)
    v_pool[pf, sf] = v_new.reshape(b * s, *v_new.shape[2:]).to(v_pool.dtype)


def paged_attention(q, k_pool, v_pool, page_table,
                    positions) -> torch.Tensor:
    """q [L, S, KV, G, hd] against the paged pools -> [L, S, KV, G, hd]:
    the paged flash-decode path (K6 on the card) for decode steps (S == 1)
    and prefill chunks (S > 1) alike."""
    return kops.paged_flash_decode(q, k_pool, v_pool, page_table, positions)


def attention_apply(attn: Attention, x: torch.Tensor, cfg: ArchConfig,
                    compute_dtype: torch.dtype, *, theta: float,
                    positions: torch.Tensor, cache: dict,
                    pos: Optional[int] = None,
                    page_table: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Global causal attention sub-block.  With ``page_table`` [L, P] the
    cache is the layer's page pools (``{"kp", "vp"}``) and ``positions``
    [L, S] holds per-token positions (-1 = inactive): the K/V are written
    first, then attended (paged serving, decode step or prefill chunk).
    Otherwise the cache is dense (``{"k", "v"}``): ``pos`` None is prefill
    over the whole sequence, the post-rope K/V written from slot 0; else
    single-token decode at position ``pos``."""
    b, s, _ = x.shape
    n_kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    q, k, v = project_qkv(attn, x, cfg, compute_dtype)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    if page_table is not None:
        paged_update(cache["kp"], cache["vp"], k, v, positions, page_table)
        out = paged_attention(q.reshape(b, s, n_kv, g, hd), cache["kp"],
                              cache["vp"], page_table, positions)
    elif pos is None:
        # prefill: GQA K/V consumed grouped (head h reads kv head h // g)
        out = kops.flash_attention(q, k, v.contiguous())
        update_cache(cache["k"], cache["v"], k, v, 0)
    else:
        update_cache(cache["k"], cache["v"], k, v, pos)
        out = decode_attention(q.reshape(b, s, n_kv, g, hd), cache["k"],
                               cache["v"], pos)
    out = out.reshape(b, s, cfg.q_dim).to(compute_dtype)
    return kops.matmul(out.reshape(b * s, -1), attn.wo,
                       out_dtype=compute_dtype).reshape(b, s, -1)
