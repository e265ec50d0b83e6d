"""Attention for the dense GQA decoder: one packed QKV GEMM (bf16, or
int8 against a ``QuantizedWeight``), RoPE, flash prefill (K4) over the
grouped K/V, cached decode through split-K flash decode (K5), and paged
serving: K/V scattered through a page table into shared pools, then paged
flash decode (K6) for decode steps and prefill chunks alike.

Three decoder kinds, as in the reference: 'global' (causal), 'local'
(sliding window of ``cfg.window`` positions) and llama4's 'chunked' (the
causal keys of the query's own chunk of ``cfg.window`` positions);
``cfg.attn_softcap`` caps the scores.  Whisper adds 'full'
(bidirectional): its encoder's self-attention, and the decoder's
cross-attention over the encoder output (``cross_attention_apply``,
unpacked ``wq/wk/wv/wo``); whisper takes no RoPE (``use_rope=False``).
A local or chunked layer's dense cache is a ring buffer of ``min(window,
max_len)`` slots (position p at slot p % W), decoded by
``decode_attention_ring``, plain torch as the reference's einsum path is
plain XLA (``attention.py:405-441``); its paged lanes keep their full
history and K6 masks by position.  ``attention_train`` and
``cross_attention_train`` are the training forwards: the same products
through ``kernels.autograd`` (K1 and K4 with their backwards; the
cross-attention's q and K/V products ``torch.matmul``) on the master
weights, with no cache."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import autograd as ag
from repro_torch.kernels import ops as kops
from repro_torch.kernels.quantize import QuantizedWeight
from repro_torch.kernels.ref import accum_dtype, softcap_scores
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


class CrossAttention(nn.Module):
    """Whisper's cross-attention, unpacked as in the reference
    (``lm.py:103-106``): ``wq [D, q_dim]`` reads the decoder stream,
    ``wk``/``wv [D, kv_dim]`` the encoder output, ``wo [q_dim, D]``.
    Never quantized (the reference's int8 pass skips ``xattn``); served
    from its copy at the compute dtype (``lm._cast_xattn``)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d = cfg.d_model
        kw = dict(dtype=dtype, device=device)
        for name, shape in (("wq", (d, cfg.q_dim)), ("wk", (d, cfg.kv_dim)),
                            ("wv", (d, cfg.kv_dim)), ("wo", (cfg.q_dim, d))):
            setattr(self, name, nn.Parameter(torch.empty(shape, **kw),
                                             requires_grad=False))


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
    return split_qkv(kops.matmul(
        x.reshape(b * s, -1), _weight(attn.wqkv, compute_dtype),
        out_dtype=compute_dtype).reshape(b, s, -1), cfg)


def split_qkv(y: torch.Tensor, cfg: ArchConfig):
    """The packed QKV GEMM's output [B, S, q_dim + 2 kv_dim] split into
    un-roped q [B,S,H,hd] and k/v [B,S,KV,hd] (strided views)."""
    b, s, _ = y.shape
    q, k, v = split_packed_columns(y, qkv_sizes(cfg), qkv_packing(cfg))
    return (q.reshape(b, s, cfg.n_heads, cfg.hd),
            k.reshape(b, s, cfg.n_kv_heads, cfg.hd),
            v.reshape(b, s, cfg.n_kv_heads, cfg.hd))


_NEG = -1e30


def decode_attention(q, k_cache, v_cache, pos: int, *, kind: str = "global",
                     window: int = 0,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q [B, 1, KV, G, hd] against dense caches [B, K, KV, hd] (global,
    slots <= ``pos`` live: the tiled flash-decode path, K5 on the card) or
    ring buffers [B, W, KV, hd] (local and chunked:
    ``decode_attention_ring``, the reference's ``attention.py:405-409``)."""
    if kind in ("local", "chunked"):
        return decode_attention_ring(q, k_cache, v_cache, pos, kind=kind,
                                     window=window, softcap=softcap)
    return kops.flash_decode(q, k_cache, v_cache, pos, kind=kind,
                             softcap=softcap)


def decode_attention_ring(q, k_cache, v_cache, pos: int, *, window: int,
                          kind: str = "local",
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Local or chunked decode over a ring buffer [B, W, KV, hd], the
    reference's ``decode_attention_einsum`` (``attention.py:430-441``):
    slot j holds position pos - ((pos - j) mod W), live where that position
    is >= 0 and within ``window`` of ``pos`` ('local'), or in the chunk of
    ``window`` positions that holds ``pos`` ('chunked').  q is rounded to
    the cache dtype and the scores summed at
    fp32; the probabilities are rounded to the cache dtype for the value
    product and normalized by their fp32 sum."""
    hd = q.shape[-1]
    acc = accum_dtype(k_cache.dtype)
    s = torch.einsum("bqkgd,bKkd->bkgqK", q.to(k_cache.dtype).to(acc),
                     k_cache.to(acc)) * hd ** -0.5
    s = softcap_scores(s, softcap)
    w = k_cache.shape[1]
    slots = torch.arange(w, device=q.device)
    kpos = pos - torch.remainder(pos - slots, w)
    valid = (kpos >= 0) & (kpos <= pos)
    if kind == "chunked":
        valid &= torch.div(kpos, window, rounding_mode="floor") \
            == pos // window
    else:
        valid &= pos - kpos < window
    s = s.masked_fill(~valid, _NEG)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~valid, 0.0)
    out = torch.einsum("bkgqK,bKkd->bkgqd", p.to(v_cache.dtype).to(acc),
                       v_cache.to(acc))
    out = out / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pos: int, *,
                 ring: bool = False) -> None:
    """Write one token's [B, 1, KV, hd] at slot ``pos`` (``pos % W`` for a
    ring buffer).  The caches are updated IN PLACE (the reference returns
    new arrays; here the cache buffers are owned by the serving loop and
    never aliased)."""
    slot = pos % k_cache.shape[1] if ring else pos
    k_cache[:, slot:slot + 1] = k_new.to(k_cache.dtype)
    v_cache[:, slot:slot + 1] = v_new.to(v_cache.dtype)


def fill_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
               k: torch.Tensor, v: torch.Tensor, *, ring: bool) -> None:
    """After a prefill of S positions: the post-rope K/V [B, S, KV, hd] at
    slots 0..S-1, or, in a ring buffer of W slots, the last min(S, W)
    positions p at slots p % W (the reference's ``_prefill_attention``).
    In place."""
    s, w = k.shape[1], k_cache.shape[1]
    if not ring:
        k_cache[:, :s] = k.to(k_cache.dtype)
        v_cache[:, :s] = v.to(v_cache.dtype)
        return
    n = min(s, w)
    slots = torch.remainder(torch.arange(s - n, s, device=k.device), w)
    k_cache[:, slots] = k[:, s - n:].to(k_cache.dtype)
    v_cache[:, slots] = v[:, s - n:].to(v_cache.dtype)


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


def paged_attention(q, k_pool, v_pool, page_table, positions, *,
                    kind: str = "global", window: int = 0,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q [L, S, KV, G, hd] against the paged pools -> [L, S, KV, G, hd]:
    the paged flash-decode path (K6 on the card) for decode steps (S == 1)
    and prefill chunks (S > 1) alike; local lanes keep their full history
    and are masked by position."""
    return kops.paged_flash_decode(q, k_pool, v_pool, page_table, positions,
                                   kind=kind, window=window, softcap=softcap)


def attention_apply(attn: Attention, x: torch.Tensor, cfg: ArchConfig,
                    compute_dtype: torch.dtype, *, kind: str, theta: float,
                    positions: torch.Tensor, cache: Optional[dict],
                    pos: Optional[int] = None,
                    page_table: Optional[torch.Tensor] = None,
                    use_rope: bool = True) -> torch.Tensor:
    """The attention sub-block of kind ``kind`` ('global', 'local',
    'chunked', or 'full' for whisper's encoder).  With ``page_table``
    [L, P] the cache is the layer's page pools (``{"kp", "vp"}``) and
    ``positions`` [L, S] holds per-token positions (-1 = inactive): the
    K/V are written first, then attended (paged serving, decode step or
    prefill chunk).  Otherwise the cache is dense (``{"k", "v"}``, a ring
    buffer for 'local' and 'chunked'): ``pos`` None is prefill over the
    whole sequence, the post-rope K/V written to the cache after (the
    encoder keeps none: ``cache`` None); else single-token decode at
    position ``pos``.
    ``use_rope=False`` (whisper) leaves q and k unrotated."""
    b, s, _ = x.shape
    n_kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    mask = dict(kind=kind, window=cfg.window, softcap=cfg.attn_softcap)
    # the reference's dense ring kinds (attention.py:673)
    ring = kind in ("local", "chunked")
    q, k, v = project_qkv(attn, x, cfg, compute_dtype)
    if use_rope:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    else:
        # the packed split leaves strided views; the kernels take rows
        q, k = q.contiguous(), k.contiguous()
    if page_table is not None:
        paged_update(cache["kp"], cache["vp"], k, v, positions, page_table)
        out = paged_attention(q.reshape(b, s, n_kv, g, hd), cache["kp"],
                              cache["vp"], page_table, positions, **mask)
    elif pos is None:
        # prefill: GQA K/V consumed grouped (head h reads kv head h // g)
        out = kops.flash_attention(q, k, v.contiguous(), **mask)
        if cache is not None:
            fill_cache(cache["k"], cache["v"], k, v, ring=ring)
    else:
        update_cache(cache["k"], cache["v"], k, v, pos, ring=ring)
        out = decode_attention(q.reshape(b, s, n_kv, g, hd), cache["k"],
                               cache["v"], pos, **mask)
    out = out.reshape(b, s, cfg.q_dim).to(compute_dtype)
    return kops.matmul(out.reshape(b * s, -1), attn.wo,
                       out_dtype=compute_dtype).reshape(b, s, -1)


def cross_attention_apply(xattn: CrossAttention, x: torch.Tensor,
                          enc_out: torch.Tensor, cfg: ArchConfig,
                          compute_dtype: torch.dtype,
                          decode: bool) -> torch.Tensor:
    """Whisper's cross-attention sub-block (the reference's ``lm.py:
    272-287``): q from the decoder's normed stream x [B, S, D], K/V from
    the encoder output ``enc_out`` [B, F, D], recomputed at every call as
    the reference does.  The three input products are plain GEMMs outside
    any kernel, as the reference's einsums are (``lm.py:276-281``,
    ``attention.py:619``); the attention is the 'full' kind: K4 over every
    frame at prefill, K5 with no position mask at decode (``decode``, S ==
    1); ``wo`` goes through K1 (``attention.py:705``).  The weights are
    taken at the compute dtype (the served copy's), never cast here."""
    b, s, _ = x.shape
    f = enc_out.shape[1]
    n_kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    cd = compute_dtype
    q = torch.matmul(x, xattn.wq).reshape(b, s, cfg.n_heads, hd)
    ek = torch.matmul(enc_out, xattn.wk).reshape(b, f, n_kv, hd)
    ev = torch.matmul(enc_out, xattn.wv).reshape(b, f, n_kv, hd)
    if decode:
        out = kops.flash_decode(q.reshape(b, s, n_kv, g, hd), ek, ev, f - 1,
                                kind="full", softcap=cfg.attn_softcap)
    else:
        out = kops.flash_attention(q, ek, ev, kind="full",
                                   softcap=cfg.attn_softcap)
    out = out.reshape(b * s, cfg.q_dim).to(cd)
    return kops.matmul(out, xattn.wo, out_dtype=cd).reshape(b, s, -1)


def attention_train(wqkv: torch.Tensor, wo: torch.Tensor, x: torch.Tensor,
                    cfg: ArchConfig, compute_dtype: torch.dtype, *,
                    kind: str, theta: float,
                    positions: Optional[torch.Tensor],
                    use_rope: bool = True) -> torch.Tensor:
    """``attention_apply``'s prefill with gradients and no cache: the packed
    QKV GEMM, RoPE (``use_rope=False``: whisper, q and k unrotated), K4
    over the grouped K/V and the out projection, the GEMMs on the master
    weights ``wqkv``/``wo`` (cast to the compute dtype inside
    ``kernels.autograd.matmul``)."""
    b, s, _ = x.shape
    cd = compute_dtype
    q, k, v = split_qkv(ag.matmul(x.reshape(b * s, -1), wqkv, out_dtype=cd
                                  ).reshape(b, s, -1), cfg)
    if use_rope:
        q, k = rope(q, positions, theta), rope(k, positions, theta)
    else:
        # the packed split leaves strided views; the kernels take rows
        q, k = q.contiguous(), k.contiguous()
    v = v.contiguous()
    out = ag.flash_attention(q, k, v, kind=kind, window=cfg.window,
                             softcap=cfg.attn_softcap)
    out = out.reshape(b * s, cfg.q_dim).to(cd)
    return ag.matmul(out, wo, out_dtype=cd).reshape(b, s, -1)


def cross_attention_train(wq: torch.Tensor, wk: torch.Tensor,
                          wv: torch.Tensor, wo: torch.Tensor, x: torch.Tensor,
                          enc_out: torch.Tensor, cfg: ArchConfig,
                          compute_dtype: torch.dtype) -> torch.Tensor:
    """``cross_attention_apply``'s prefill with gradients: q from the
    decoder's normed stream x [B, S, D], K/V from the encoder output
    ``enc_out`` [B, F, D], each a ``torch.matmul`` of the master weight
    cast to the compute dtype under autograd (the reference's einsums,
    ``lm.py:276-281``, outside any kernel); K4 'full' over the F frames
    with its backward at F != S; ``wo`` through K1."""
    b, s, _ = x.shape
    f = enc_out.shape[1]
    n_kv, hd, cd = cfg.n_kv_heads, cfg.hd, compute_dtype
    q = torch.matmul(x, wq.to(cd)).reshape(b, s, cfg.n_heads, hd)
    ek = torch.matmul(enc_out, wk.to(cd)).reshape(b, f, n_kv, hd)
    ev = torch.matmul(enc_out, wv.to(cd)).reshape(b, f, n_kv, hd)
    out = ag.flash_attention(q, ek, ev, kind="full",
                             softcap=cfg.attn_softcap)
    out = out.reshape(b * s, cfg.q_dim).to(cd)
    return ag.matmul(out, wo, out_dtype=cd).reshape(b, s, -1)
