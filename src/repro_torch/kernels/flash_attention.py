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

K5 is one kernel, one launch per decode: ``flash_decode_cuda`` computes
the partials of each row's live tiles and the last split of the row to
arrive folds them (an arrival counter per row in ``split_scratch``'s
counters, shared with K1); its plain version is ``flash_decode_tiled``, a
tile-for-tile copy of the reference's XLA mirror (``decode_tile_partials``
then ``combine_tile_partials``).  A tile that holds no key of its row is
neither computed nor folded; it would have been (_NEG, 0, 0), which folds
in as +0.0, so skipping it changes no bit.  The live tiles' partials stay
in the launch's workspace (``dense_decode_launch`` returns it,
``record_views`` reads it), which is how they are checked.  A block holds
at most ``_G_MAX`` query heads; a kv head with more is served as
``head_groups(G)`` rows that read the same K/V.  The plain
version of K4 is ``ref.flash_attention_ref`` (causal masked softmax, GQA
grouped in the einsum).  ``kernels.ops`` takes the plain versions for
tensors on the CPU.

K6 is ``paged_flash_decode_cuda`` (plain version
``paged_flash_decode_tiled``; its partials ``paged_tile_partials``, the
twin of the reference's ``_paged_tile_partials_xla``), two bodies chosen
by the shape alone (``paged_body``).  Decode (S == 1) is K5's kernel on
the page table: it tiles a lane's logical view in the same 32-slot tiles
from position 0 as the dense path (not one page per tile, see ROADMAP
F2), so a paged lane is bitwise the same history in a dense cache, and
its workspace holds the live tiles' partials.  A prefill chunk (S > 1)
takes a flash-prefill body (``k6_paged_chunk``): one block per (q tile,
kv head, lane) holds S x G query rows of the lane (``chunk_tiles``) and
streams each K/V tile of the lane once, page by page through the table,
into K4's tensor-core arithmetic; each row is masked by its
own position, so it agrees with the plain version within the rounding
of P to bf16.  In both an idle row (position -1) gives exactly 0.0, and
a lane reads only its own pages.

Variants (gemma2): K4 and K6 take the ``'local'`` kind, a sliding window
in which query position p attends keys p - window < k <= p, and all three
take ``softcap``: the scaled scores become ``softcap * tanh(s /
softcap)`` (an IEEE division, ``ref.softcap_scores``) before the mask.
K5 serves ``'global'``: a local layer's dense cache is a ring buffer,
decoded outside the kernels (``models.attention.decode_attention_ring``).
Whisper's ``'full'`` kind (no position mask): K4 over every key, with Skv
free of Sq and ragged (its encoder self-attention and cross-attention
prefill), and K5 at position ``kv_len - 1`` (its cross-attention decode);
each launch also counts under its ``full`` variant.  llama4's
``'chunked'`` kind (query position p attends the causal keys of its own
chunk of ``window`` positions, p // W == k // W): K4 at prefill, and K6's
decode and chunk bodies in the scheduler; a chunked layer's dense cache
is a ring decoded outside the kernels, as a local one's.  K4 also takes
the reference's ``'prefix'`` kind (every key before ``prefix_len`` as
well as the causal ones), reached through ``ops.flash_attention`` only: no
model of the reference runs it.  A launch of either counts under its
``chunked`` or ``prefix`` variant.  One mask code (``MASK_CODES``) with
``window`` and ``prefix_len`` selects the kind in every kernel
(``mask_args``).  K6 serves paged decoder-only models, 'global', 'local'
and 'chunked'.  Any other kind raises (``ref.check_kind``) on every
device.

Head dims (``_HEAD_DIMS``): 16 to 128, and gemma3's 256, where K4 and
K6's chunk body stream 64-slot K/V tiles (two stages beside the 64 KB Q
tile) and the decode body's 96 KB ring fits two blocks an SM, so its
split count comes from ``decode_splits``.  A launch at hd 256 also counts
under its ``hd256`` variant.  Any other head dim raises on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.matmul import sm_count, split_scratch
from repro_torch.kernels.ref import (_ATTN_KINDS, PAGED_KINDS, accum_dtype,
                                     attention_mask, check_kind,
                                     softcap_scores)

_NEG = -1e30

# KV tile of the decode path; the CUDA kernel's TILE is the same constant
DEFAULT_KV_TILE = 32
_HEAD_DIMS = (16, 32, 64, 128, 256)
# query heads a block of the decode kernel holds (G_MAX)
_G_MAX = 8
# blocks per SM the decode grid aims at: one wave, as many as fit an SM
# at hd 128 (the 3-stage ring's 48 KB of shared memory, and 122 registers
# a thread, each allow 4)
DECODE_BLOCKS_PER_SM = 4
# the kernels' mask codes (``MaskKind`` in csrc/flash_attention.cu)
MASK_CODES = {"global": 0, "local": 1, "full": 2, "chunked": 3, "prefix": 4}


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
                         softcap: Optional[float] = None,
                         kind: str = "global"):
    """Per-tile partials over a dense cache, slots <= ``pos`` live (every
    slot for ``kind='full'``, the reference's mirror with no position
    mask): q [B, S, KV, G, hd], caches [B, K, KV, hd].  Returns (m_t, l_t,
    acc_t) stacked on axis 0 with inner layout [B, KV, G, S(, hd)].  One
    product per tile, as in the reference's mirror; the short last tile's
    missing slots would be masked, so slicing them off changes no bit."""
    hd = q.shape[-1]
    kv_len = k_cache.shape[1]
    pos = _decode_pos(kind, pos, kv_len)
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
                       softcap: Optional[float] = None,
                       kind: str = "global") -> torch.Tensor:
    """Plain tiled flash decode: q [B, S, KV, G, hd] against dense caches
    [B, K, KV, hd], slots <= ``pos`` live (every slot for 'full') ->
    [B, S, KV, G, hd] in q's dtype."""
    out = combine_tile_partials(*decode_tile_partials(q, k_cache, v_cache,
                                                      pos, softcap, kind))
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def _check_head_dim(hd: int) -> None:
    if hd not in _HEAD_DIMS:
        raise ValueError(f"the flash kernels take head_dim in {_HEAD_DIMS}, "
                         f"got {hd}")


def _decode_pos(kind: str, pos: int, kv_len: int) -> int:
    """The last live slot of a dense decode: ``pos`` for 'global'; for
    'full' (cross-attention) the last stored slot, as the reference passes
    ``kv_len - 1`` (``models/attention.py:682``), so every slot is live."""
    check_kind(kind, ("global", "full"))
    return kv_len - 1 if kind == "full" else int(pos)


def mask_args(kind: str, window: int = 0, prefix_len: int = 0,
              kinds=_ATTN_KINDS):
    """The kernels' mask arguments ``(code, window, prefix_len)``: the
    kind's ``MASK_CODES`` entry, the window for 'local' and 'chunked' (0
    for the others), the prefix length for 'prefix' (0 for the others).
    Raises for a kind outside ``kinds`` (default: K4's), a window below 1
    where the kind has one, or a negative prefix length."""
    check_kind(kind, kinds)
    if kind in ("local", "chunked") and window < 1:
        raise ValueError(f"a {kind} window must be >= 1, got {window}")
    if kind == "prefix" and prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    return (MASK_CODES[kind],
            int(window) if kind in ("local", "chunked") else 0,
            int(prefix_len) if kind == "prefix" else 0)


def k4_variants(kind: str, softcap: Optional[float], hd: int) -> dict:
    """The launch-count variants (``_cuda.count``'s keywords, in their
    order) of K4 and of its backward under ``kind``, ``softcap`` and head
    dim ``hd``; K4's training forward adds ``lse``."""
    return dict(local=kind == "local", full=kind == "full",
                chunked=kind == "chunked", prefix=kind == "prefix",
                softcap=bool(softcap), hd256=hd == 256)


def _k4(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kind: str,
        window: int, prefix_len: int, softcap: Optional[float],
        with_lse: bool):
    """K4's checks and launch; ``(out, lse or None)``."""
    b, sq, n_h, hd = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    code, win, plen = mask_args(kind, window, prefix_len)
    _check_head_dim(hd)
    if n_h % n_kv:
        raise ValueError(f"{n_h} q heads do not group over {n_kv} kv heads")
    _cuda.check(q, "q", torch.bfloat16)
    _cuda.check(k, "k", torch.bfloat16, (b, skv, n_kv, hd))
    _cuda.check(v, "v", torch.bfloat16, (b, skv, n_kv, hd))
    out = torch.empty_like(q)
    lse = (torch.empty((b, n_h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.numel() == 0:
        return out, lse
    _cuda.count("flash_attention", **k4_variants(kind, softcap, hd),
                lse=with_lse)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    args = (b, sq, skv, n_h, n_kv, hd, hd ** -0.5, code, win, plen,
            float(softcap or 0.0))
    if with_lse:
        _cuda.launch("flash_attention", "k4_flash_prefill_lse", *ptrs,
                     lse.data_ptr(), *args)
    else:
        _cuda.launch("flash_attention", "k4_flash_prefill", *ptrs, *args)
    return out, lse


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, kind: str = "global", window: int = 0,
                         prefix_len: int = 0,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """K4: causal online-softmax prefill ('local': the last ``window``
    keys of each query only; 'chunked': the keys of its own chunk of
    ``window``; 'prefix': also every key before ``prefix_len``; 'full':
    every key, Skv free of Sq), scores softcapped when ``softcap`` is set.
    q [B, Sq, H, hd], k/v [B, Skv, KV, hd] bf16 contiguous, KV | H ->
    [B, Sq, H, hd] bf16."""
    return _k4(q, k, v, kind, window, prefix_len, softcap, False)[0]


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, kind: str = "global",
                             window: int = 0, prefix_len: int = 0,
                             softcap: Optional[float] = None):
    """K4 with its second output: ``(out, lse)``, ``out`` bitwise
    ``flash_attention_cuda``'s and ``lse`` [B, H, Sq] fp32 each query row's
    log-sum-exp of its scaled (softcapped) scores, which the backward
    reads (``k4_flash_prefill_lse``, counted under the ``lse`` variant)."""
    return _k4(q, k, v, kind, window, prefix_len, softcap, True)


# K4's backward takes every kind and head dim of the forward, with or
# without the softcap, at Sq == Skv; its workspace's rows (D and lse
# log2(e) a query) are padded with 0 to a multiple of this, the dQ pass's
# widest q tile (csrc/flash_backward.cu's ROW_PAD)
BWD_ROW_PAD = 128


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, kind: str = "global",
                             window: int = 0, prefix_len: int = 0,
                             softcap: Optional[float] = None):
    """K4's backward (``csrc/flash_backward.cu``): ``(dq, dk, dv)`` of the
    prefill from q, k, v, its output ``out``, its ``lse`` (``flash_
    attention_lse_cuda``) and the output's gradient ``dout``, all bf16 but
    ``lse``; one call (three launches: the row dots D beside lse log2(e),
    then dK/dV, then dQ, both passes wgmma fed by a TMA ring), counted once
    as ``flash_attention_bwd`` and under its variants as the forward is
    (``local``, ``full``, ``chunked``, ``prefix``, ``softcap``, ``hd256``).
    Takes every kind (``mask_args``: the window of 'local' and 'chunked',
    the prefix length of 'prefix') at head dims 16 to 256 with or without
    the softcap, at Sq == Skv; 'full' at Skv != Sq (cross-attention)
    raises."""
    b, s, n_h, hd = q.shape
    n_kv, skv = k.shape[2], k.shape[1]
    code, win, plen = mask_args(kind, window, prefix_len)
    if skv != s:
        raise NotImplementedError(
            f"K4's backward takes Skv == Sq (got {skv} keys for {s} "
            f"queries): cross-attention's backward is whisper's training "
            f"slice")
    _check_head_dim(hd)
    if softcap is not None and softcap < 0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    if n_h % n_kv:
        raise ValueError(f"{n_h} q heads do not group over {n_kv} kv heads")
    for t, what in ((q, "q"), (out, "out"), (dout, "dout")):
        _cuda.check(t, what, torch.bfloat16, (b, s, n_h, hd))
    _cuda.check(k, "k", torch.bfloat16, (b, s, n_kv, hd))
    _cuda.check(v, "v", torch.bfloat16, (b, s, n_kv, hd))
    _cuda.check(lse, "lse", torch.float32, (b, n_h, s))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    s_pad = -(-s // BWD_ROW_PAD) * BWD_ROW_PAD
    ws = torch.empty((2, b, n_h, s_pad), dtype=torch.float32,
                     device=q.device)
    _cuda.count("flash_attention_bwd", **k4_variants(kind, softcap, hd))
    _cuda.launch("flash_backward", "k4_flash_backward", q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 ws.data_ptr(), b, s, n_h, n_kv, hd, hd ** -0.5, code, win,
                 plen, float(softcap or 0.0))
    return dq, dk, dv


def default_splits(rows: int, n_tiles: int, sms: int) -> int:
    """Splits per row of the K5/K6 kernel, from the shape alone: enough
    blocks for ``DECODE_BLOCKS_PER_SM`` on each of ``sms`` SMs, at most
    one per tile.  No bit of the output depends on it."""
    want = -(-DECODE_BLOCKS_PER_SM * sms // max(rows, 1))
    return max(1, min(n_tiles, want))


def decode_blocks_per_sm(hd: int) -> int:
    """Blocks of the decode kernel that fit one SM at head dim ``hd``: its
    ring of 3 K and V tiles of 32 slots is 48 KB at hd 128 (4 blocks of
    the SM's 228 KB) and 96 KB at hd 256 (2)."""
    return DECODE_BLOCKS_PER_SM if hd <= 128 else 2


def decode_splits(rows: int, n_tiles: int, sms: int, hd: int) -> int:
    """``default_splits`` for rows at head dim ``hd``: one wave of the
    blocks that fit an SM there (``decode_blocks_per_sm``), so a row at hd
    256, whose block takes the room of two at hd 128, counts twice.  No
    bit of the output depends on it."""
    weight = DECODE_BLOCKS_PER_SM // decode_blocks_per_sm(hd)
    return default_splits(rows * weight, n_tiles, sms)


def head_groups(g: int):
    """(rep, G / rep): the kernel serves a kv head's ``g`` query heads as
    ``rep`` rows of ``g / rep`` heads, the fewest rows that hold at most
    ``_G_MAX`` heads each.  The rows read the same K/V; no bit of a head's
    output depends on the grouping."""
    if g < 1:
        raise ValueError(f"the decode kernel takes >= 1 query heads per kv "
                         f"head, got {g}")
    rep = next(r for r in range(1, g + 1) if g % r == 0 and g // r <= _G_MAX)
    return rep, g // rep


def _check_decode(q: torch.Tensor, g: int, hd: int):
    """Checks q and the head dim; returns ``head_groups(g)``."""
    _check_head_dim(hd)
    groups = head_groups(g)
    _cuda.check(q, "q", torch.bfloat16)
    return groups


def _workspace(rows: int, n_tiles: int, g: int, hd: int,
               device: torch.device) -> torch.Tensor:
    """The kernel's workspace [rows, T, record]: one fp32 record per (row,
    tile) of ``acc_t`` [G, hd], ``m_t`` [G] and ``l_t`` [G], padded to 16
    bytes (``record_floats`` in the source).  The kernel writes the
    records of live tiles only; the others are never written."""
    rec = -(-g * (hd + 2) // 4) * 4
    return torch.empty((rows, n_tiles, rec), dtype=torch.float32,
                       device=device)


def record_views(ws: torch.Tensor, g: int, hd: int):
    """``m_t``/``l_t`` [rows, T, G] and ``acc_t`` [rows, T, G, hd] from the
    workspace of a launch whose rows hold ``g`` query heads each (in
    ``head_groups(g)`` kernel rows).  Only the live tiles' records were
    written."""
    rep, gk = head_groups(g)
    w = ws.unflatten(0, (-1, rep))            # [rows, rep, T, record]

    def heads(x):                             # [rows, rep, T, gk, ...]
        x = x.transpose(1, 2)
        return x.reshape(*x.shape[:2], g, *x.shape[4:])
    return (heads(w[..., gk * hd:gk * hd + gk]),
            heads(w[..., gk * hd + gk:gk * hd + 2 * gk]),
            heads(w[..., :gk * hd].unflatten(-1, (gk, hd))))


def dense_decode_launch(q, k_cache, v_cache, pos: int,
                        n_splits: Optional[int] = None,
                        softcap: Optional[float] = None,
                        kind: str = "global"):
    """One launch of ``k5_flash_decode``; returns (out, workspace).  The
    workspace holds each live tile's partial (``record_views``).  'full'
    is the launch at position ``kv_len - 1``."""
    b, s_q, n_kv, g, hd = q.shape
    if s_q != 1:
        raise ValueError("flash decode is single-token (S == 1)")
    kv_len = k_cache.shape[1]
    pos = _decode_pos(kind, pos, kv_len)
    rep, gk = _check_decode(q, g, hd)
    _cuda.check(k_cache, "k_cache", torch.bfloat16, (b, kv_len, n_kv, hd))
    _cuda.check(v_cache, "v_cache", torch.bfloat16, (b, kv_len, n_kv, hd))
    rows = b * n_kv * rep
    n_tiles = math.ceil(kv_len / DEFAULT_KV_TILE)
    if n_splits is None:
        n_splits = decode_splits(rows, n_tiles, sm_count(q.device.index), hd)
    if n_splits < 1:
        raise ValueError(f"n_splits must be >= 1, got {n_splits}")
    out = torch.empty_like(q)
    ws = _workspace(rows, n_tiles, gk, hd, q.device)
    if rows == 0 or n_tiles == 0:
        return out.zero_(), ws
    counters = (split_scratch(q.device, 0, rows)[1].data_ptr()
                if n_splits > 1 else None)
    _cuda.count("flash_decode", full=kind == "full", softcap=bool(softcap),
                hd256=hd == 256)
    _cuda.launch("flash_attention", "k5_flash_decode", q.data_ptr(),
                 k_cache.data_ptr(), v_cache.data_ptr(), ws.data_ptr(),
                 out.data_ptr(), counters, b, n_kv, rep, gk, hd, kv_len,
                 int(pos), n_tiles, n_splits, hd ** -0.5,
                 float(softcap or 0.0))
    return out, ws


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: int,
                      n_splits: Optional[int] = None,
                      softcap: Optional[float] = None,
                      kind: str = "global") -> torch.Tensor:
    """K5: split-K flash decode, partials and fold in one launch.
    q [B, 1, KV, G, hd], caches [B, K, KV, hd] bf16 contiguous ->
    [B, 1, KV, G, hd] bf16, bitwise the same for any ``n_splits`` (tile
    groups per kernel row; default ``decode_splits``)."""
    return dense_decode_launch(q, k_cache, v_cache, pos, n_splits,
                               softcap, kind)[0]


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
    check_kind(kind, PAGED_KINDS)
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


# the chunk body's q tile holds at most this many (position, head) rows;
# it takes page sizes from 4 slots to 128, a K/V tile (128 slots, 64 at hd
# 256) being whole pages (at most 32) or part of one
CHUNK_ROWS = 128
CHUNK_PAGE_SIZES = (4, 8, 16, 32, 64, 128)


def paged_body(s_q: int) -> str:
    """K6's kernel for a call of ``s_q`` positions a lane, by the shape
    alone: decode (S == 1) keeps the split-K decode body, whose tiles and
    fold carry the paged == dense bitwise contract; a prefill chunk (S >
    1) takes the flash-prefill body."""
    return "k6_paged_decode" if s_q == 1 else "k6_paged_chunk"


def chunk_tiles(s_q: int, g: int):
    """(positions per q tile, q tiles) of the chunk body: a q tile holds
    the G query heads of ``CHUNK_ROWS // G`` consecutive chunk positions
    (at most S), rows in (position, head) order; the grid is one block per
    (q tile, kv head, lane)."""
    if not 1 <= g <= CHUNK_ROWS:
        raise ValueError(f"the chunk body takes 1 to {CHUNK_ROWS} query "
                         f"heads per kv head, got {g}")
    per = min(CHUNK_ROWS // g, s_q)
    return per, -(-s_q // per)


def _chunk_launch(q, k_pool, v_pool, page_table, positions, kind: str,
                  code: int, win: int,
                  softcap: Optional[float]) -> torch.Tensor:
    """One launch of ``k6_paged_chunk`` on operands and mask arguments
    (``mask_args``) the caller checked."""
    n_lanes, s_q, n_kv, g, hd = q.shape
    n_pool, ps = k_pool.shape[0], k_pool.shape[1]
    out = torch.empty_like(q)
    if q.numel():
        _cuda.count("paged_decode", local=kind == "local",
                    chunked=kind == "chunked", softcap=bool(softcap),
                    chunk=True, hd256=hd == 256)
        _cuda.launch("flash_attention", "k6_paged_chunk", q.data_ptr(),
                     k_pool.data_ptr(), v_pool.data_ptr(),
                     page_table.data_ptr(), positions.data_ptr(),
                     out.data_ptr(), n_lanes, s_q, n_kv, g, hd,
                     page_table.shape[1], ps.bit_length() - 1, n_pool,
                     hd ** -0.5, code, win, float(softcap or 0.0))
    return out


def paged_decode_launch(q, k_pool, v_pool, page_table, positions, *,
                        kind: str = "global", window: int = 0,
                        softcap: Optional[float] = None,
                        n_splits: Optional[int] = None):
    """One launch of K6, the body chosen by ``paged_body``.  Decode
    returns (out, workspace): the workspace holds each live tile's partial
    (``record_views``); ``n_splits`` (default ``decode_splits``) changes
    no bit of it.  A prefill chunk returns (out, None): its body keeps no
    per-tile records."""
    n_lanes, s_q, n_kv, g, hd = q.shape
    n_pool, ps = k_pool.shape[0], k_pool.shape[1]
    p_max = page_table.shape[1]
    code, win, _ = mask_args(kind, window, kinds=PAGED_KINDS)
    chunk = paged_body(s_q) == "k6_paged_chunk"
    if chunk:
        _check_head_dim(hd)
        chunk_tiles(s_q, g)
        if ps not in CHUNK_PAGE_SIZES:
            raise ValueError(f"the chunk body takes page sizes "
                             f"{CHUNK_PAGE_SIZES}, got {ps}")
        _cuda.check(q, "q", torch.bfloat16)
    else:
        rep, gk = _check_decode(q, g, hd)
    _cuda.check(k_pool, "k_pool", torch.bfloat16, (n_pool, ps, n_kv, hd))
    _cuda.check(v_pool, "v_pool", torch.bfloat16, (n_pool, ps, n_kv, hd))
    _cuda.check(page_table, "page_table", torch.int32, (n_lanes, p_max))
    _cuda.check(positions, "positions", torch.int32, (n_lanes, s_q))
    if chunk:
        return _chunk_launch(q, k_pool, v_pool, page_table, positions, kind,
                             code, win, softcap), None
    rows = n_lanes * n_kv * rep
    n_tiles = math.ceil(p_max * ps / DEFAULT_KV_TILE)
    if n_splits is None:
        n_splits = decode_splits(rows, n_tiles, sm_count(q.device.index), hd)
    if n_splits < 1:
        raise ValueError(f"n_splits must be >= 1, got {n_splits}")
    out = torch.empty_like(q)
    ws = _workspace(rows, n_tiles, gk, hd, q.device)
    if rows == 0 or n_tiles == 0:
        return out.zero_(), ws
    counters = (split_scratch(q.device, 0, rows)[1].data_ptr()
                if n_splits > 1 else None)
    _cuda.count("paged_decode", local=kind == "local",
                chunked=kind == "chunked", softcap=bool(softcap),
                hd256=hd == 256)
    _cuda.launch("flash_attention", "k6_paged_decode", q.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
                 positions.data_ptr(), ws.data_ptr(), out.data_ptr(),
                 counters, n_lanes, n_kv, rep, gk, hd, p_max, ps, n_tiles,
                 n_splits, hd ** -0.5, code, win, float(softcap or 0.0))
    return out, ws


def paged_flash_decode_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, page_table: torch.Tensor,
                            positions: torch.Tensor, *, kind: str = "global",
                            window: int = 0,
                            softcap: Optional[float] = None) -> torch.Tensor:
    """K6, one launch: q [L, S, KV, G, hd] bf16, pools [NP + 1, PS, KV, hd]
    bf16, ``page_table`` [L, P] and ``positions`` [L, S] int32, all
    contiguous; table entries must be -1 or a page below NP.  'local'
    masks keys at or before position - window, 'chunked' keys before the
    chunk of ``window`` positions that holds the position; a tile wholly
    outside a row's keys is never read.  -> [L, S, KV, G, hd] bf16, an idle row
    exactly 0.0."""
    return paged_decode_launch(q, k_pool, v_pool, page_table, positions,
                               kind=kind, window=window, softcap=softcap)[0]
