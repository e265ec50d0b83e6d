"""Plain PyTorch versions of the serving kernels, and the f64 oracles.

These are what a kernel wrapper runs for a tensor on the CPU, and what
``chip_smoke.py`` holds each CUDA kernel against on the card.  With f64
inputs every function keeps its whole chain at f64 (the oracle runs).
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_REF = -1e30


def accum_dtype(*dtypes: torch.dtype) -> torch.dtype:
    """The GEMM accumulator of the promoted input dtype: fp32 for every
    float input up to 32 bits, f64 for f64 (an oracle run must not
    silently accumulate at fp32)."""
    return (torch.float64 if torch.float64 in dtypes else torch.float32)


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B with fp32 (f64) accumulation; mixed inputs promote the
    way ``jnp.dot`` does (a bf16 activation against fp32 weights runs an
    fp32 product).  With ``out_dtype`` None (or float32) the accumulator
    is stored uncast: the plain version of K1's fp32 store, which the
    weight gradients take."""
    acc = accum_dtype(a.dtype, b.dtype)
    out = torch.matmul(a.to(acc), b.to(acc))
    return out.to(out_dtype or acc)


def matmul_fused_ref(a: torch.Tensor, b: torch.Tensor, epilogue,
                     residual: Optional[torch.Tensor] = None,
                     operand2: Optional[torch.Tensor] = None,
                     norm_scale: Optional[torch.Tensor] = None):
    """epilogue(A @ B): the plain version of the fused-epilogue GEMM.
    Returns ``(value, normed)`` under ``epilogue.norm``, else one tensor.
    The quantize stage belongs to the int8 GEMM (``int8_matmul_ref``); the
    float GEMM refuses it, as its kernel does."""
    from repro_torch.kernels.epilogue import apply_epilogue
    if epilogue.quantize:
        raise NotImplementedError(
            "the float GEMM has no quantize stage; the int8 GEMM does")
    return apply_epilogue(matmul_ref(a, b), epilogue, residual=residual,
                          operand2=operand2, norm_scale=norm_scale)


ROW_LANES, ROW_VEC = 32, 8   # a warp's lanes; bf16 values a 16-byte vector


def rmsnorm_rows_ref(value: torch.Tensor, scale: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """``epilogue.rms_normalize`` in the row-norm kernels' order
    (``csrc/matmul.cu`` ``rmsnorm_row``, the standalone rmsnorm and the
    GEMMs' fused tail alike): bitwise what they compute on the card.

    ``value`` [..., N] bf16, N a multiple of 8; ``scale`` [N] fp32.  Lane l
    of a warp adds the squares of the row's 8-value vectors l, l + 32, l +
    64, ... in ascending order, each vector's values in index order, at
    fp32; then the 32 lane sums fold pairwise, each lane with the one 16,
    8, 4, 2 and 1 away.  The order depends on N alone, never on the rows
    beside.  Then ``r = 1 / sqrt(sum / N + eps)`` and ``(x * r) * (1 +
    scale)``, each step an IEEE operation (tensor divisors: torch on CUDA
    divides by a Python scalar as a reciprocal multiply)."""
    n = value.shape[-1]
    lead = value.shape[:-1]
    x = value.to(torch.float32)
    rounds = -(-n // (ROW_LANES * ROW_VEC))
    # lane l's squares in its order, the missing tail as +0.0 added last
    # (the sum is >= +0, so adding +0.0 changes no bit)
    sq = torch.nn.functional.pad(x * x, (0, rounds * ROW_LANES * ROW_VEC - n))
    sq = sq.reshape(*lead, rounds, ROW_LANES, ROW_VEC).transpose(-3, -2)
    sq = sq.reshape(*lead, ROW_LANES, rounds * ROW_VEC)
    ss = torch.zeros((*lead, ROW_LANES), dtype=torch.float32,
                     device=value.device)
    for t in range(rounds * ROW_VEC):
        ss = ss + sq[..., t]
    half = ROW_LANES // 2
    while half:
        ss = ss[..., :half] + ss[..., half:2 * half]
        half //= 2
    ms = ss / torch.full_like(ss, float(n))
    eps32 = torch.tensor(eps, dtype=torch.float32, device=value.device)
    r = torch.ones_like(ms) / torch.sqrt(ms + eps32)
    return ((x * r) * (1.0 + scale.to(torch.float32))).to(value.dtype)


def quantize_rowwise_ref(x: torch.Tensor):
    """Row-wise symmetric int8 quantization of ``x [M, N]`` at fp32:
    ``(q int8 [M, N], scale f32 [M, 1])``, the plain version of K3."""
    from repro_torch.kernels.epilogue import quantize_symmetric
    return quantize_symmetric(x.to(torch.float32), dim=-1)


def quantize_colwise_ref(x: torch.Tensor):
    """Column-wise symmetric int8 quantization (the weight layout):
    ``(q int8 [..., K, N], scale f32 [..., 1, N])``, dividing by 127 as
    the reference's op-by-op weight pass does."""
    from repro_torch.kernels.epilogue import quantize_symmetric
    return quantize_symmetric(x.to(torch.float32), dim=-2, compiled=False)


def int8_matmul_ref(qa: torch.Tensor, sa: torch.Tensor, qb: torch.Tensor,
                    sb: torch.Tensor, epilogue=None,
                    residual: Optional[torch.Tensor] = None,
                    operand2: Optional[torch.Tensor] = None,
                    norm_scale: Optional[torch.Tensor] = None):
    """epilogue(sa * sb * (QA @ QB)): the plain version of K2.  ``qa
    [M, K]`` int8 with row scales ``sa [M, 1]``, ``qb [K, N]`` int8 with
    column scales ``sb [1, N]``.  The int8 operands are upcast before the
    product (an int8 ``torch.mm`` returns int8 and wraps): to f64, whose
    53-bit mantissa holds every partial sum exactly (|sum| <= K * 127^2),
    so the int32 accumulator is exact on any device and in any order."""
    from repro_torch.kernels.epilogue import Epilogue, apply_epilogue
    acc = torch.matmul(qa.to(torch.float64), qb.to(torch.float64)
                       ).to(torch.int32)
    return apply_epilogue(acc, epilogue or Epilogue(), residual=residual,
                          operand2=operand2, norm_scale=norm_scale,
                          row_scale=sa, col_scale=sb)


# the kinds of the prefill kernel (K4: every mask of the reference's
# ``attention_mask_ref``, ``repro/kernels/ref.py:140-157``) and of the
# dense decode (K5 takes 'global' and 'full'); the paged kernel (K6) serves
# decoder-only models, whose layers are 'global', 'local' or 'chunked'
_ATTN_KINDS = ("global", "local", "full", "chunked", "prefix")
PAGED_KINDS = ("global", "local", "chunked")


def check_kind(kind: str, kinds=_ATTN_KINDS) -> None:
    """Refuse an attention kind a kernel does not implement (one outside
    ``kinds``, e.g. 'full' or 'prefix' for the paged kernel): it raises on
    every device, never falls through."""
    if kind not in kinds:
        raise NotImplementedError(
            f"attention kind {kind!r} is not ported; the kernels take "
            f"{kinds}")


def softcap_scores(s: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    """``softcap * tanh(s / softcap)`` (gemma2's logit softcap), identity
    for None or 0.  The division is an IEEE division, as in the CUDA
    kernels: the divisor is a 0-d tensor, because torch on CUDA divides by
    a Python scalar as a multiply by its rounded reciprocal."""
    if not softcap:
        return s
    c = torch.tensor(softcap, dtype=s.dtype, device=s.device)
    return c * torch.tanh(s / c)


def attention_mask(qpos: torch.Tensor, kpos: torch.Tensor, kind: str,
                   window: int, prefix_len: int = 0) -> torch.Tensor:
    """[..., Sq, Skv] bool from query positions [..., Sq] and key
    positions [Skv], term for term the reference's ``attention_mask_ref``
    (``repro/kernels/ref.py:140-157``): causal (key <= query) for
    'global', 'local', 'chunked' and 'prefix'; 'local' also keeps only the
    last ``window`` positions (query - key < window), 'chunked' only the
    query's own chunk of ``window`` positions (query // window == key //
    window), and 'prefix' adds every key before ``prefix_len`` (a
    bidirectional prefix); 'full' keeps every key (whisper's encoder and
    cross-attention).  A negative key position never attends."""
    check_kind(kind)
    if kind == "full":
        return torch.ones((*qpos.shape, kpos.shape[0]), dtype=torch.bool,
                          device=kpos.device)
    mask = kpos <= qpos[..., None]
    if kind == "local":
        mask &= (qpos[..., None] - kpos) < window
    elif kind == "chunked":
        mask &= torch.div(qpos[..., None], window, rounding_mode="floor") \
            == torch.div(kpos, window, rounding_mode="floor")
    elif kind == "prefix":
        mask |= kpos < prefix_len
    return mask & (kpos >= 0)


def _grouped_scores(q, k, kind, window, prefix_len, softcap):
    """The scaled, softcapped scores of q [B, Sq, H, hd] against k [B, Skv,
    KV, hd] at the accumulator width, grouped [B, KV, G, Sq, Skv] (q head
    h reads kv head h // G, never repeated), and the mask."""
    b, sq, n_h, hd = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    acc = accum_dtype(q.dtype)
    qg = q.reshape(b, sq, n_kv, n_h // n_kv, hd).to(acc)
    s = torch.einsum("bqkgd,bKkd->bkgqK", qg, k.to(acc))
    s = softcap_scores(s * hd ** -0.5, softcap)
    mask = attention_mask(torch.arange(sq, device=q.device),
                          torch.arange(skv, device=q.device), kind, window,
                          prefix_len)
    return s, mask


def flash_attention_lse_ref(q, k, v, *, kind: str = "global",
                            window: int = 0, prefix_len: int = 0,
                            softcap: Optional[float] = None):
    """``(flash_attention_ref(...), lse)``: the output and each query
    row's log-sum-exp of its attended scores, [B, H, Sq] at the
    accumulator width (natural log; what K4 writes as its second output
    and its backward reads)."""
    b, sq, n_h, hd = q.shape
    s, mask = _grouped_scores(q, k, kind, window, prefix_len, softcap)
    s = s.masked_fill(~mask, _NEG_REF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgqK,bKkd->bkgqd", p, v.to(p.dtype)) / l
    lse = (m + torch.log(l))[..., 0].reshape(b, n_h, sq)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, n_h, hd).to(
        q.dtype), lse


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *,
                            kind: str = "global", window: int = 0,
                            prefix_len: int = 0,
                            softcap: Optional[float] = None):
    """The attention backward in the recomputing form, the plain version
    of K4's backward: from q, k, v, the output, its row log-sum-exp ``lse``
    [B, H, Sq] and the output's gradient ``dout`` [B, Sq, H, hd],

        P = exp(S - lse) (masked keys 0), D = rowsum(dout * out),
        dV = P^T dout, dS = P * (dout V^T - D)  (times 1 - (S / c)^2
        under a softcap c), dQ = dS K / sqrt(hd), dK = dS^T Q / sqrt(hd),

    GQA's dK and dV summed over each kv head's G query heads, at the
    accumulator width (f64 stays f64), cast to the inputs' dtypes."""
    b, sq, n_h, hd = q.shape
    n_kv = k.shape[2]
    g = n_h // n_kv
    acc = accum_dtype(q.dtype)
    s, mask = _grouped_scores(q, k, kind, window, prefix_len, softcap)
    lse_g = lse.to(acc).reshape(b, n_kv, g, sq, 1)
    p = torch.exp(s.masked_fill(~mask, _NEG_REF) - lse_g).masked_fill(
        ~mask, 0.0)
    dog = dout.reshape(b, sq, n_kv, g, hd).to(acc)
    og = out.reshape(b, sq, n_kv, g, hd).to(acc)
    dv = torch.einsum("bkgqK,bqkgd->bKkd", p, dog)
    dp = torch.einsum("bqkgd,bKkd->bkgqK", dog, v.to(acc))
    d = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - d)
    if softcap:
        c = torch.tensor(softcap, dtype=acc, device=q.device)
        ds = ds * (1.0 - torch.square(s / c))
    qg = q.reshape(b, sq, n_kv, g, hd).to(acc)
    dq = torch.einsum("bkgqK,bKkd->bqkgd", ds, k.to(acc)) * hd ** -0.5
    dk = torch.einsum("bkgqK,bqkgd->bKkd", ds, qg) * hd ** -0.5
    return (dq.reshape(b, sq, n_h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, kind: str = "global", window: int = 0,
                        prefix_len: int = 0,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Prefill attention (query row i attends slots <= i; 'local' only the
    last ``window`` of them; 'chunked' only those of its own chunk of
    ``window``; 'prefix' also every slot before ``prefix_len``; 'full'
    every slot, with Skv free of Sq: ``attention_mask``),
    plain masked softmax at the accumulator width, the scaled scores
    softcapped before the mask.  q [B, Sq, H, hd]; k/v [B, Skv, KV, hd]
    with KV | H: q head h reads kv head h // (H // KV) — grouped in the
    einsum, never repeated."""
    return flash_attention_lse_ref(q, k, v, kind=kind, window=window,
                                   prefix_len=prefix_len,
                                   softcap=softcap)[0]


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     kind: str = "global",
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Decode oracle: q [B, 1, KV, G, hd] against dense caches
    [B, K, KV, hd], slots <= pos live ('global'; every slot for 'full',
    ``pos`` unread).  Plain (untiled) masked softmax at the accumulator
    width, the scaled scores softcapped."""
    check_kind(kind, ("global", "full"))
    if kind == "full":
        pos = k_cache.shape[1] - 1
    hd = q.shape[-1]
    acc = accum_dtype(q.dtype)
    s = torch.einsum("bqkgd,bKkd->bkgqK", q.to(acc), k_cache.to(acc))
    s = softcap_scores(s * hd ** -0.5, softcap)
    slots = torch.arange(k_cache.shape[1], device=q.device)
    valid = slots <= pos
    s = s.masked_fill(~valid, _NEG_REF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~valid, 0.0)
    out = torch.einsum("bkgqK,bKkd->bkgqd", p, v_cache.to(acc))
    out = out / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def addertree_ref(partials: torch.Tensor,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``out[M, N] = sum_s partials[s, M, N]``, the paper's adder tree:
    folded in ascending s at 32 bits (fp32 for float partials, int32 for
    int8, which is exact), then cast to ``out_dtype`` (default: the
    partials' dtype), the plain version of K7."""
    from repro_torch.core.maxeva_matmul import rank_order_sum
    return rank_order_sum(partials, out_dtype or partials.dtype)


def splitk_partials_ref(a: torch.Tensor, b: torch.Tensor,
                        k_ranges) -> torch.Tensor:
    """``[S, M, N]`` partial products of A @ B over the K ranges
    ``k_ranges`` ([begin, end) each, at the accumulator width): what the
    bytes regime of the K1 kernel writes to its workspace."""
    acc = accum_dtype(a.dtype, b.dtype)
    return torch.stack([torch.matmul(a[:, k0:k1].to(acc), b[k0:k1].to(acc))
                        for k0, k1 in k_ranges])


def matmul_splitk_ref(a: torch.Tensor, b: torch.Tensor, epilogue, k_ranges,
                      residual: Optional[torch.Tensor] = None,
                      operand2: Optional[torch.Tensor] = None,
                      norm_scale: Optional[torch.Tensor] = None):
    """epilogue(A @ B) as the K1 kernel computes it at M < 64: the partial
    product of each K range, folded in ascending range order at the
    accumulator width, then the epilogue.  The plain version of the split-K
    arithmetic (``kernels.matmul.k1_plan`` gives the ranges)."""
    return splitk_fold_ref(splitk_partials_ref(a, b, k_ranges), epilogue,
                           residual=residual, operand2=operand2,
                           norm_scale=norm_scale)


def splitk_fold_ref(partials: torch.Tensor, epilogue,
                    residual: Optional[torch.Tensor] = None,
                    operand2: Optional[torch.Tensor] = None,
                    norm_scale: Optional[torch.Tensor] = None):
    """epilogue(sum_s partials[s]) with the partials ``[S, M, N]`` folded
    in ascending s at their own width: the plain version of the fold that
    the last split of each column block does in the K1 kernel."""
    from repro_torch.kernels.epilogue import apply_epilogue
    acc = partials[0]
    for p in partials[1:]:
        acc = acc + p
    return apply_epilogue(acc, epilogue, residual=residual,
                          operand2=operand2, norm_scale=norm_scale)
