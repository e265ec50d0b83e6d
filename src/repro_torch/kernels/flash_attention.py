"""K4 (flash prefill), K5 (split-K flash decode) and K6 (paged flash
decode), launched on the card, beside the plain tiled decodes and their
deterministic combine.

Determinism contract (the reference's rank-order rule applied to the
softmax): decode reduces the KV axis in fixed ``DEFAULT_KV_TILE``-slot
tiles anchored at slot 0.  Each tile yields an independent partial
``(m_t, l_t, acc_t)``; the combine takes a global max, rescales by
``exp(m_t - m)`` and folds the tiles in ASCENDING order at fp32.  A partial
never depends on which program computed it, so the CUDA kernel's output
is bitwise identical for every ``n_splits``.  A fully masked tile is
``(_NEG, 0, 0)`` and folds in as +0.0.

K5 is two kernels with a wrapper each: ``decode_partials_cuda`` (plain
version ``decode_tile_partials``) and ``decode_combine_cuda`` (plain
version ``combine_tile_partials``); ``flash_decode_cuda`` runs the pair,
and its plain version is ``flash_decode_tiled``, a tile-for-tile copy of
the reference's XLA mirror.  The plain version of K4 is
``ref.flash_attention_ref`` (causal masked softmax, GQA grouped in the
einsum).  ``kernels.ops`` takes the plain versions for tensors on the CPU.

K6 is one kernel, ``paged_partials_cuda`` (plain version
``paged_tile_partials``, the twin of the reference's
``_paged_tile_partials_xla``), followed by K5's combine:
``paged_flash_decode_cuda`` / ``paged_flash_decode_tiled``.  It tiles a
lane's logical view in the same 32-slot tiles from position 0 as the
dense path (not one page per tile, see ROADMAP F2), so a paged lane is
bitwise the same history in a dense cache.  Its rows are (lane, s, kv
head), each with its own position, so prefill chunks (S > 1) and decode
(S == 1) take the same kernel; an idle row (position -1) gives exactly
0.0.

Variants (gemma2): K4 and K6 take the ``'local'`` kind, a sliding window
in which query position p attends keys p - window < k <= p, and all three
take ``softcap``: the scaled scores become ``softcap * tanh(s /
softcap)`` (an IEEE division, ``ref.softcap_scores``) before the mask.
K5 serves ``'global'`` only: a local layer's dense cache is a ring buffer,
decoded outside the kernels (``models.attention.decode_attention_ring``).
Any other kind raises (``ref.check_kind``) on every device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.ref import (accum_dtype, attention_mask, check_kind,
                                     softcap_scores)

_NEG = -1e30

# KV tile of the decode path; the CUDA kernel's TILE is the same constant
DEFAULT_KV_TILE = 32
_HEAD_DIMS = (16, 32, 64, 128)


def combine_tile_partials(m_t: torch.Tensor, l_t: torch.Tensor,
                          acc_t: torch.Tensor) -> torch.Tensor:
    """Combine per-tile softmax partials stacked on axis 0: ``m_t``/``l_t``
    [T, ...], ``acc_t`` [T, ..., hd].  Returns the normalized output
    [..., hd] at the partials' width (fp32, or f64 for the oracles)."""
    from repro_torch.core.maxeva_matmul import rank_order_sum
    m = torch.amax(m_t, dim=0)
    alpha = torch.exp(m_t - m[None])
    l = rank_order_sum(l_t * alpha, m_t.dtype)
    acc = rank_order_sum(acc_t * alpha[..., None], m_t.dtype)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def decode_tile_partials(q, k_cache, v_cache, pos: int,
                         softcap: Optional[float] = None):
    """Per-tile partials over a dense cache, slots <= ``pos`` live: q
    [B, S, KV, G, hd], caches [B, K, KV, hd].  Returns (m_t, l_t, acc_t)
    stacked on axis 0 with inner layout [B, KV, G, S(, hd)].  One product
    per tile, as in the reference's mirror; the short last tile's missing
    slots would be masked, so slicing them off changes no bit."""
    hd = q.shape[-1]
    kv_len = k_cache.shape[1]
    acc = accum_dtype(q.dtype, k_cache.dtype)
    qa = q.to(acc)
    ms, ls, accs = [], [], []
    for t0 in range(0, kv_len, DEFAULT_KV_TILE):
        kt = k_cache[:, t0:t0 + DEFAULT_KV_TILE].to(acc)
        vt = v_cache[:, t0:t0 + DEFAULT_KV_TILE].to(acc)
        s = torch.einsum("bqkgd,bKkd->bkgqK", qa, kt) * hd ** -0.5
        s = softcap_scores(s, softcap)
        valid = t0 + torch.arange(kt.shape[1], device=q.device) <= pos
        s = s.masked_fill(~valid, _NEG)
        m_t = torch.amax(s, dim=-1)
        p = torch.exp(s - m_t[..., None]).masked_fill(~valid, 0.0)
        ms.append(m_t)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgqK,bKkd->bkgqd", p, vt))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def flash_decode_tiled(q, k_cache, v_cache, pos: int,
                       softcap: Optional[float] = None) -> torch.Tensor:
    """Plain tiled flash decode: q [B, S, KV, G, hd] against dense caches
    [B, K, KV, hd], slots <= ``pos`` live -> [B, S, KV, G, hd] in q's
    dtype."""
    out = combine_tile_partials(*decode_tile_partials(q, k_cache, v_cache,
                                                      pos, softcap))
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def _check_head_dim(hd: int) -> None:
    if hd not in _HEAD_DIMS:
        raise ValueError(f"the flash kernels take head_dim in {_HEAD_DIMS}, "
                         f"got {hd}")


def _window_arg(kind: str, window: int) -> int:
    """The kernels' window argument: the window for 'local', 0 (none) for
    'global'."""
    check_kind(kind)
    if kind != "local":
        return 0
    if window < 1:
        raise ValueError(f"a local window must be >= 1, got {window}")
    return int(window)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, kind: str = "global", window: int = 0,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """K4: causal online-softmax prefill ('local': the last ``window``
    keys of each query only), scores softcapped when ``softcap`` is set.
    q [B, Sq, H, hd], k/v [B, Skv, KV, hd] bf16 contiguous, KV | H ->
    [B, Sq, H, hd] bf16."""
    b, sq, n_h, hd = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    win = _window_arg(kind, window)
    _check_head_dim(hd)
    if n_h % n_kv:
        raise ValueError(f"{n_h} q heads do not group over {n_kv} kv heads")
    _cuda.check(q, "q", torch.bfloat16)
    _cuda.check(k, "k", torch.bfloat16, (b, skv, n_kv, hd))
    _cuda.check(v, "v", torch.bfloat16, (b, skv, n_kv, hd))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    _cuda.count("flash_attention", local=win > 0, softcap=bool(softcap))
    _cuda.launch("flash_attention", "k4_flash_prefill", q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv, n_h,
                 n_kv, hd, hd ** -0.5, win, float(softcap or 0.0))
    return out


def default_splits(rows: int, n_tiles: int, device: torch.device) -> int:
    """Tile groups per (batch, kv head) row that fill the card's SMs: the
    SM count over the rows, at most one group per tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n_tiles, math.ceil(sms / max(rows, 1))))


def decode_partials_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: int,
                         n_splits: Optional[int] = None,
                         softcap: Optional[float] = None):
    """K5 partials kernel: q [B, 1, KV, G, hd], caches [B, K, KV, hd] bf16
    contiguous, slots <= ``pos`` live, scores softcapped when ``softcap``
    is set.  Returns fp32 ``m_t``/``l_t`` [B*KV, T, G] and ``acc_t``
    [B*KV, T, G, hd] for the T 32-slot tiles.  ``n_splits`` tile groups
    run as separate blocks (default: enough to fill the SMs); no bit of
    the partials depends on it."""
    b, s_q, n_kv, g, hd = q.shape
    if s_q != 1:
        raise ValueError("flash decode is single-token (S == 1)")
    kv_len = k_cache.shape[1]
    _check_head_dim(hd)
    _cuda.check(q, "q", torch.bfloat16)
    _cuda.check(k_cache, "k_cache", torch.bfloat16, (b, kv_len, n_kv, hd))
    _cuda.check(v_cache, "v_cache", torch.bfloat16, (b, kv_len, n_kv, hd))
    rows = b * n_kv
    n_tiles = math.ceil(kv_len / DEFAULT_KV_TILE)
    if n_splits is None:
        n_splits = default_splits(rows, n_tiles, q.device)
    if n_splits < 1:
        raise ValueError(f"n_splits must be >= 1, got {n_splits}")
    f32 = dict(dtype=torch.float32, device=q.device)
    m_t = torch.empty((rows, n_tiles, g), **f32)
    l_t = torch.empty((rows, n_tiles, g), **f32)
    acc_t = torch.empty((rows, n_tiles, g, hd), **f32)
    if m_t.numel():
        _cuda.count("decode_partials", softcap=bool(softcap))
        _cuda.launch("flash_attention", "k5_decode_partials", q.data_ptr(),
                     k_cache.data_ptr(), v_cache.data_ptr(), m_t.data_ptr(),
                     l_t.data_ptr(), acc_t.data_ptr(), b, n_kv, g, hd,
                     kv_len, int(pos), n_tiles,
                     math.ceil(n_tiles / n_splits), n_splits, hd ** -0.5,
                     float(softcap or 0.0))
    return m_t, l_t, acc_t


def decode_combine_cuda(m_t: torch.Tensor, l_t: torch.Tensor,
                        acc_t: torch.Tensor) -> torch.Tensor:
    """K5 combine kernel: fp32 partials ``m_t``/``l_t`` [R, T, G] and
    ``acc_t`` [R, T, G, hd] -> [R, G, hd] bf16, the global max and the
    ascending fold over T."""
    rows, n_tiles, g, hd = acc_t.shape
    _cuda.check(m_t, "m_t", torch.float32, (rows, n_tiles, g))
    _cuda.check(l_t, "l_t", torch.float32, (rows, n_tiles, g))
    _cuda.check(acc_t, "acc_t", torch.float32)
    out = torch.empty((rows, g, hd), dtype=torch.bfloat16,
                      device=acc_t.device)
    if out.numel() and n_tiles:
        _cuda.count("decode_combine")
        _cuda.launch("flash_attention", "k5_decode_combine", m_t.data_ptr(),
                     l_t.data_ptr(), acc_t.data_ptr(), out.data_ptr(), rows,
                     n_tiles, g, hd)
    return out


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: int,
                      n_splits: Optional[int] = None,
                      softcap: Optional[float] = None) -> torch.Tensor:
    """K5: split-K flash decode, the partials kernel then the combine.
    q [B, 1, KV, G, hd], caches [B, K, KV, hd] bf16 contiguous ->
    [B, 1, KV, G, hd] bf16, bitwise the same for any ``n_splits``."""
    m_t, l_t, acc_t = decode_partials_cuda(q, k_cache, v_cache, pos,
                                           n_splits, softcap)
    return decode_combine_cuda(m_t, l_t, acc_t).reshape(q.shape)


# ---------------------------------------------------------------------------
# K6: paged decode (and prefill chunks)
# ---------------------------------------------------------------------------

def paged_tile_partials(q, k_pool, v_pool, page_table, positions, *,
                        kind: str = "global", window: int = 0,
                        softcap: Optional[float] = None):
    """Per-tile partials over a lane's gathered logical view: q
    [L, S, KV, G, hd], pools [NP + 1, PS, KV, hd] (the last row is the
    trash page), ``page_table`` [L, P] (-1 = unmapped: read from the trash
    page and masked), ``positions`` [L, S] (-1 = idle row).  Returns
    (m_t, l_t, acc_t) stacked on axis 0 with inner layout
    [L, KV, G, S(, hd)], tile for tile the reference's mirror."""
    check_kind(kind)
    n_pool, ps = k_pool.shape[0], k_pool.shape[1]
    n_lanes, p_max = page_table.shape
    hd = q.shape[-1]
    mapped = page_table >= 0
    ptc = torch.where(mapped, page_table, n_pool - 1).long()
    kl = k_pool[ptc].reshape(n_lanes, p_max * ps, *k_pool.shape[2:])
    vl = v_pool[ptc].reshape(n_lanes, p_max * ps, *v_pool.shape[2:])
    kvalid = mapped.repeat_interleave(ps, dim=1)            # [L, P*PS]
    qpos = positions.to(torch.long)                         # [L, S]
    acc = accum_dtype(q.dtype, k_pool.dtype)
    qa = q.to(acc)
    ms, ls, accs = [], [], []
    for t0 in range(0, p_max * ps, DEFAULT_KV_TILE):
        kt = kl[:, t0:t0 + DEFAULT_KV_TILE].to(acc)
        vt = vl[:, t0:t0 + DEFAULT_KV_TILE].to(acc)
        s = torch.einsum("bqkgd,bKkd->bkgqK", qa, kt) * hd ** -0.5
        s = softcap_scores(s, softcap)
        kvpos = t0 + torch.arange(kt.shape[1], device=q.device)
        mask = (kvalid[:, None, t0:t0 + DEFAULT_KV_TILE]
                & attention_mask(qpos, kvpos, kind, window)
                & (qpos[:, :, None] >= 0))[:, None, None]   # [L,1,1,S,T]
        s = s.masked_fill(~mask, _NEG)
        m_t = torch.amax(s, dim=-1)
        p = torch.exp(s - m_t[..., None]).masked_fill(~mask, 0.0)
        ms.append(m_t)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgqK,bKkd->bkgqd", p, vt))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def paged_flash_decode_tiled(q, k_pool, v_pool, page_table, positions, *,
                             kind: str = "global", window: int = 0,
                             softcap: Optional[float] = None
                             ) -> torch.Tensor:
    """Plain paged flash decode: q [L, S, KV, G, hd] through the page table
    -> [L, S, KV, G, hd] in q's dtype."""
    out = combine_tile_partials(*paged_tile_partials(
        q, k_pool, v_pool, page_table, positions, kind=kind, window=window,
        softcap=softcap))
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def paged_partials_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor,
                        positions: torch.Tensor, *, kind: str = "global",
                        window: int = 0, softcap: Optional[float] = None):
    """K6 partials kernel: q [L, S, KV, G, hd] bf16, pools [NP + 1, PS, KV,
    hd] bf16, ``page_table`` [L, P] and ``positions`` [L, S] int32, all
    contiguous; table entries must be -1 or a page below NP.  'local'
    masks keys at or before position - window; a tile wholly outside a
    row's keys is written as (_NEG, 0, 0) without reading K or V.  Returns
    fp32 ``m_t``/``l_t`` [L*S*KV, T, G] and ``acc_t`` [L*S*KV, T, G, hd]
    for the T 32-slot tiles of the logical view, in ``default_splits``
    tile groups per row."""
    n_lanes, s_q, n_kv, g, hd = q.shape
    n_pool, ps = k_pool.shape[0], k_pool.shape[1]
    p_max = page_table.shape[1]
    win = _window_arg(kind, window)
    _check_head_dim(hd)
    _cuda.check(q, "q", torch.bfloat16)
    _cuda.check(k_pool, "k_pool", torch.bfloat16, (n_pool, ps, n_kv, hd))
    _cuda.check(v_pool, "v_pool", torch.bfloat16, (n_pool, ps, n_kv, hd))
    _cuda.check(page_table, "page_table", torch.int32, (n_lanes, p_max))
    _cuda.check(positions, "positions", torch.int32, (n_lanes, s_q))
    rows = n_lanes * s_q * n_kv
    n_tiles = math.ceil(p_max * ps / DEFAULT_KV_TILE)
    n_splits = default_splits(rows, n_tiles, q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    m_t = torch.empty((rows, n_tiles, g), **f32)
    l_t = torch.empty((rows, n_tiles, g), **f32)
    acc_t = torch.empty((rows, n_tiles, g, hd), **f32)
    if m_t.numel():
        _cuda.count("paged_partials", local=win > 0,
                    softcap=bool(softcap))
        _cuda.launch("flash_attention", "k6_paged_partials", q.data_ptr(),
                     k_pool.data_ptr(), v_pool.data_ptr(),
                     page_table.data_ptr(), positions.data_ptr(),
                     m_t.data_ptr(), l_t.data_ptr(), acc_t.data_ptr(),
                     n_lanes, s_q, n_kv, g, hd, p_max, ps, n_tiles,
                     math.ceil(n_tiles / n_splits), n_splits, hd ** -0.5,
                     win, float(softcap or 0.0))
    return m_t, l_t, acc_t


def paged_flash_decode_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, page_table: torch.Tensor,
                            positions: torch.Tensor, *, kind: str = "global",
                            window: int = 0,
                            softcap: Optional[float] = None) -> torch.Tensor:
    """K6: the paged partials kernel, then K5's combine.
    -> [L, S, KV, G, hd] bf16."""
    parts = paged_partials_cuda(q, k_pool, v_pool, page_table, positions,
                                kind=kind, window=window, softcap=softcap)
    return decode_combine_cuda(*parts).reshape(q.shape)
