"""Attention for the dense GQA decoder: one packed QKV GEMM, RoPE, flash
prefill (K4) over the grouped K/V, and cached decode through split-K
flash decode (K5)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
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
    ``qkv_packing``) and the out projection ``wo [q_dim, D]``."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d = cfg.d_model
        kw = dict(dtype=dtype, device=device)
        self.wqkv = nn.Parameter(
            torch.empty(d, cfg.q_dim + 2 * cfg.kv_dim, **kw),
            requires_grad=False)
        self.wo = nn.Parameter(torch.empty(cfg.q_dim, d, **kw),
                               requires_grad=False)


def project_qkv(attn: Attention, x: torch.Tensor, cfg: ArchConfig,
                compute_dtype: torch.dtype):
    """One GEMM against the packed ``wqkv`` (weight cast to the compute
    dtype, cast of the output fused in the store phase); the split is paid
    on the activation output.  Returns un-roped q [B,S,H,hd],
    k/v [B,S,KV,hd]."""
    b, s, _ = x.shape
    y = kops.matmul(x.reshape(b * s, -1), attn.wqkv.to(compute_dtype),
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


def attention_apply(attn: Attention, x: torch.Tensor, cfg: ArchConfig,
                    compute_dtype: torch.dtype, *, theta: float,
                    positions: torch.Tensor, cache: dict,
                    pos: Optional[int] = None) -> torch.Tensor:
    """Global causal attention sub-block over the layer's dense ``cache``
    (``{"k", "v"}``).  ``pos`` None: prefill over the whole sequence, the
    post-rope K/V written from slot 0; else single-token decode at
    position ``pos``."""
    b, s, _ = x.shape
    n_kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    q, k, v = project_qkv(attn, x, cfg, compute_dtype)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    if pos is None:
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
