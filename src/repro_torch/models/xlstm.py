"""xLSTM's two mixers (arXiv:2405.04517), the reference's
``models/xlstm.py`` in plain torch: the mLSTM (a matrix memory, its
prefill in the chunkwise form) and the sLSTM (a scalar memory, strictly
sequential).

mLSTM, per head (state C [hd, hd], n [hd], stabilizer m):

  m_t = max(logf_t + m_{t-1}, logi_t)
  C_t = exp(logf_t + m_{t-1} - m_t) C_{t-1} + exp(logi_t - m_t) k_t v_t^T
  n_t = exp(logf_t + m_{t-1} - m_t) n_{t-1} + exp(logi_t - m_t) k_t
  h_t = (C_t^T q_t) / max(|n_t . q_t|, exp(-m_t))

The reference computes both mixers outside Pallas (``jnp.einsum``,
``lax.scan``), so the port's products are library products, as the
RG-LRU's are, and its one kernel on this path is the row norm of each
mixer's inner norm (``kernels.autograd.rmsnorm``: the row-norm kernel,
with its backward in training).  What each step asks for:

- the projections (``up_x``, ``up_g``, ``wq``, ``wk``, ``wv``, ``down``,
  the sLSTM's ``out``) and the causal conv (``rglru.causal_conv``, shared
  with the RG-LRU as in the reference) at the compute dtype;
- everything of the recurrences at fp32 in full fp32 (``layers.
  full_fp32``: TF32 off): the gate maps ``w_i``/``w_f`` (N = n_heads),
  the sLSTM's input map ``w_in`` and its block-diagonal recurrent map
  ``r``, and every product of the chunk and the step (``rec_dtype``: f64
  in an f64 run, which the tests take as their exact anchor; the
  reference keeps fp32 there);
- the mLSTM's head dim ``2 d / n_heads`` (its width is ``2 d``), not
  ``cfg.hd``;
- ``log_sigmoid(x) = -logaddexp(-x, 0)`` (``jax.nn.log_sigmoid``; torch's
  ``softplus`` returns ``x`` above 20);
- the prefill in chunks of ``min(64, S)`` positions (``mlstm_chunk``, the
  reference's ``_mlstm_chunk``): the intra-chunk log decays masked to
  ``-1e30`` above the diagonal before the row max, the carry from ``m =
  0``; S must be below 64 or a multiple of it, as the reference asserts
  (ROADMAP F10; ``prefill_chunk`` refuses other lengths);
- the sLSTM's scan one token at a time (a Python loop over S, its gate
  pre-activations laid out [S, heads, B, 4, W / heads] once, so that a
  step is one batched product with ``r`` and one add before the gates;
  in training one autograd node, ``_SLSTMScan``).

The cache of a layer is the state after its last token: the mLSTM's
``{"C" [B, H, hd, hd], "n" [B, H, hd], "m" [B, H]}`` at fp32 and its
conv's left context ``conv`` [B, cw - 1, 2d] in the compute dtype, the
sLSTM's ``{"c", "n", "m", "h"}`` [B, d] at fp32 (the reference's
``mlstm_cache_defs``/``slstm_cache_defs``).  The prefill writes it (new
tensors, not views of the prefill's activations); a decode step replaces
each entry with a new tensor, so a shallow copy of the dict keeps the
state it had (``lm.Cache.fork``).

Training (no cache, the reference's ``mode="train"``) runs the prefill's
arithmetic under autograd and writes no state.  Its ties split their
gradients as the reference's do: the row max is ``amax`` (even shares
among equal entries, as ``jnp.max``), and ``torch.maximum`` halves a
tie's gradient as ``jnp.maximum`` does.  The sLSTM's first token from the
zero state ties ``max(n, 1)`` wherever ``logi >= logf`` (``n = exp(logi -
m) = 1`` exactly); that tie's share reaches no input, since ``m = logi``
there gives ``n`` a zero derivative.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.autograd import rmsnorm
from repro_torch.models.layers import fp32_matmul, full_fp32
from repro_torch.models.rglru import causal_conv

_NEG = -1e30
# the reference's chunk of the mLSTM prefill (``mlstm_apply(chunk=64)``)
CHUNK = 64
# the mixers' inner norms' epsilon (the reference's ``rmsnorm(..., 1e-6)``)
_EPS = 1e-6


def _params(module: nn.Module, shapes: Dict[str, tuple],
            dtype: torch.dtype, device) -> None:
    """``shapes``' parameters: the module's ``COMPUTE_WEIGHTS`` and
    ``WIDENED`` at ``dtype``, the others (the weights the reference holds
    and multiplies at fp32) at fp32."""
    for name, shape in shapes.items():
        dt = (dtype if name in module.COMPUTE_WEIGHTS + module.WIDENED
              else torch.float32)
        setattr(module, name, nn.Parameter(
            torch.empty(shape, dtype=dt, device=device),
            requires_grad=False))


class MLSTM(nn.Module):
    """The reference's ``mlstm_defs``: ``up_x``/``up_g [D, 2D]``, ``conv
    [cw, 2D]``, ``wq``/``wk``/``wv [2D, 2D]`` and ``down [2D, D]`` at
    ``dtype``; the gate maps ``w_i``/``w_f [2D, H]``, their biases ``b_i``/
    ``b_f [H]`` and the inner norm's scale ``norm [2D]`` at fp32."""

    # the weights held at the block's dtype and used at the compute dtype
    COMPUTE_WEIGHTS = ("up_x", "up_g", "conv", "wq", "wk", "wv", "down")
    # the weights held at the block's dtype and used at fp32
    WIDENED = ()

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        w = 2 * d
        _params(self, {"up_x": (d, w), "up_g": (d, w),
                       "conv": (cfg.conv_width, w), "wq": (w, w),
                       "wk": (w, w), "wv": (w, w), "w_i": (w, nh),
                       "w_f": (w, nh), "b_i": (nh,), "b_f": (nh,),
                       "norm": (w,), "down": (w, d)}, dtype, device)


class SLSTM(nn.Module):
    """The reference's ``slstm_defs``: the input map ``w_in [D, 4D]`` (z,
    i, f, o) and ``out [D, D]`` at ``dtype`` (``w_in`` is a
    ``param_dtype`` weight in the reference, widened at use); the
    block-diagonal recurrent map ``r [4, H, D/H, D/H]``, ``bias [4D]`` and
    ``norm [D]`` at fp32."""

    COMPUTE_WEIGHTS = ("out",)
    WIDENED = ("w_in",)

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        _params(self, {"w_in": (d, 4 * d), "r": (4, nh, d // nh, d // nh),
                       "bias": (4 * d,), "norm": (d,), "out": (d, d)},
                dtype, device)


def rec_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """The recurrences' dtype: fp32, or f64 in an f64 run."""
    return torch.promote_types(compute_dtype, torch.float32)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``, its softplus
    ``logaddexp(x, 0)``."""
    return -torch.logaddexp(-x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def prefill_chunk(s: int) -> int:
    """The mLSTM prefill's chunk for a prompt of ``s`` positions: ``min(64,
    s)``, which must divide ``s`` (the reference asserts it, ROADMAP
    F10)."""
    chunk = min(CHUNK, s)
    if s < 1 or s % chunk:
        raise ValueError(
            f"an mLSTM prefill takes fewer than {CHUNK} positions or a "
            f"multiple of {CHUNK} (the reference's chunkwise form), got {s}")
    return chunk


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def mlstm_chunk(carry: Carry, qc, kc, vc, logf, logi
                ) -> Tuple[Carry, torch.Tensor]:
    """One chunk of the chunkwise form (the reference's ``_mlstm_chunk``).
    qc/kc/vc [B, L, H, hd]; logf/logi [B, L, H] fp32; carry = (C [B, H,
    hd, hd], n [B, H, hd], m [B, H]) at fp32 (``rec_dtype``).  Returns
    the carry at the chunk's end and h [B, L, H, hd] at fp32.  Call under
    ``full_fp32``."""
    C, n, m = carry
    L, hd = qc.shape[1], qc.shape[3]
    f32 = logf.dtype
    qc, kc, vc = qc.to(f32), kc.to(f32), vc.to(f32)
    kc = kc * hd ** -0.5
    Fc = torch.cumsum(logf, dim=1)                          # [B, L, H]
    # the intra-chunk log decays D[t, s] = F_t - F_s + logi_s, s <= t
    logD = Fc[:, :, None] - Fc[:, None, :] + logi[:, None, :, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=qc.device).tril()
    logD = torch.where(tri[None, :, :, None], logD,
                       torch.full((), _NEG, dtype=f32, device=qc.device))
    # the carried state decays by g_t = F_t + m
    g = Fc + m[:, None]
    m_t = torch.maximum(logD.amax(dim=2), g)                # [B, L, H]
    intra_w = torch.exp(logD - m_t[:, :, None])             # [B, t, s, H]
    scores = torch.einsum("bthd,bshd->btsh", qc, kc) * intra_w
    num = torch.einsum("btsh,bshd->bthd", scores, vc)
    nvec = torch.einsum("btsh,bshd->bthd", intra_w, kc)
    inter_w = torch.exp(g - m_t)                            # [B, L, H]
    num = num + torch.einsum("bthd,bhde->bthe", qc, C) * inter_w[..., None]
    nvec = nvec + n[:, None] * inter_w[..., None]
    qn = torch.abs(torch.einsum("bthd,bthd->bth", qc, nvec))
    hout = num / torch.maximum(qn, torch.exp(-m_t))[..., None]
    # the carry at the chunk's end
    last = Fc[:, -1]                                        # [B, H]
    tail = Fc[:, -1:] - Fc + logi                           # [B, L, H]
    m_new = torch.maximum(last + m, tail.amax(dim=1))
    wk = torch.exp(tail - m_new[:, None])                   # [B, L, H]
    decay = torch.exp(last + m - m_new)
    kw = kc * wk[..., None]
    C_new = (decay[..., None, None] * C
             + torch.einsum("blhd,blhe->bhde", kw, vc))
    n_new = decay[..., None] * n + kw.sum(1)
    return (C_new, n_new, m_new), hout


def mlstm_step(carry: Carry, q, k, v, logf, logi
               ) -> Tuple[Carry, torch.Tensor]:
    """One token (the reference's ``mlstm_step``): q/k/v [B, H, hd];
    logf/logi [B, H] fp32.  Returns the new carry and h [B, H, hd] fp32.
    Call under ``full_fp32``."""
    C, n, m = carry
    f32 = logf.dtype
    q, k, v = q.to(f32), k.to(f32), v.to(f32)
    k = k * k.shape[-1] ** -0.5
    m_new = torch.maximum(logf + m, logi)
    fw = torch.exp(logf + m - m_new)
    iw = torch.exp(logi - m_new)
    C = fw[..., None, None] * C + iw[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = fw[..., None] * n + iw[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    qn = torch.abs(torch.einsum("bhd,bhd->bh", q, n))
    h = num / torch.maximum(qn, torch.exp(-m_new))[..., None]
    return (C, n, m_new), h


def mlstm_apply(mix: MLSTM, x: torch.Tensor, cfg: ArchConfig,
                compute_dtype: torch.dtype,
                cache: Optional[Dict[str, torch.Tensor]],
                decode: bool) -> torch.Tensor:
    """The mLSTM on the normed stream x [B, S, D] -> [B, S, D] in the
    compute dtype (the reference's ``mlstm_apply``).  Prefill (``decode``
    False) runs the chunkwise form from a zero state (``m = 0``) and
    writes the state after the last position into ``cache``; a decode
    step (S = 1) reads the state and replaces it.  With ``cache`` None
    (training) the prefill's arithmetic writes nothing.  ``mix`` is the
    module or any object with its weights as attributes."""
    cd, f32 = compute_dtype, rec_dtype(compute_dtype)
    b, s, _ = x.shape
    nh = cfg.n_heads
    chunk = None if decode else prefill_chunk(s)
    xb = torch.matmul(x, mix.up_x.to(cd))
    gb = torch.matmul(x, mix.up_g.to(cd))
    xc, conv_state = causal_conv(xb, mix.conv.to(cd),
                                 cache["conv"] if decode else None)
    del xb
    xc = F.silu(xc.to(f32)).to(cd)
    w = xc.shape[-1]
    hd = w // nh
    q = torch.matmul(xc, mix.wq.to(cd)).reshape(b, s, nh, hd)
    k = torch.matmul(xc, mix.wk.to(cd)).reshape(b, s, nh, hd)
    v = torch.matmul(xc, mix.wv.to(cd)).reshape(b, s, nh, hd)
    # the recurrence runs at fp32 whatever the compute dtype
    x32 = xc.to(f32)
    del xc
    logi = fp32_matmul(x32, mix.w_i) + mix.b_i
    logf = log_sigmoid(fp32_matmul(x32, mix.w_f) + mix.b_f)
    del x32
    with full_fp32():
        if decode:
            carry = (cache["C"], cache["n"], cache["m"])
            carry, h = mlstm_step(carry, q[:, 0], k[:, 0], v[:, 0],
                                  logf[:, 0], logi[:, 0])
            h = h[:, None]
        else:
            carry = (torch.zeros((b, nh, hd, hd), dtype=f32, device=x.device),
                     torch.zeros((b, nh, hd), dtype=f32, device=x.device),
                     torch.zeros((b, nh), dtype=f32, device=x.device))
            hs = []
            for t in range(0, s, chunk):
                sl = slice(t, t + chunk)
                carry, hc = mlstm_chunk(carry, q[:, sl], k[:, sl], v[:, sl],
                                        logf[:, sl], logi[:, sl])
                hs.append(hc.to(cd))
            h = torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]
    del q, k, v
    if cache is not None:
        cache["C"], cache["n"], cache["m"] = carry
        cache["conv"] = conv_state
    del carry, conv_state
    hflat = rmsnorm(h.reshape(b, s, w).to(cd), mix.norm, _EPS)
    out = hflat * F.silu(gb.to(f32)).to(cd)
    return torch.matmul(out, mix.down.to(cd))


def mlstm_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                device) -> Dict[str, torch.Tensor]:
    """A zeroed mLSTM state (the reference's ``mlstm_cache_defs``): ``C``,
    ``n``, ``m`` at fp32, the conv's left context in ``dtype``."""
    nh, w = cfg.n_heads, 2 * cfg.d_model
    hd = w // nh
    kw = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, nh, hd, hd), **kw),
            "n": torch.zeros((batch, nh, hd), **kw),
            "m": torch.zeros((batch, nh), **kw),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _step_parts(r_cat: torch.Tensor, carry, xz_t: torch.Tensor,
                zero: torch.Tensor, one: torch.Tensor):
    """``slstm_step``'s new carry and the values its backward reads: the
    gates z, o, iw, fw, log f, its pre-activation, logf + m and log i."""
    c, n, m, h = carry
    nh, b, y = h.shape
    pre = xz_t + torch.bmm(h, r_cat).view(nh, b, 4, y)
    # one view each (one node for the backward, not four)
    z, logi, f_pre, o = pre.unbind(2)
    z = torch.tanh(z)
    logf = -torch.logaddexp(-f_pre, zero)       # log_sigmoid
    o = torch.sigmoid(o)
    logf_m = logf + m
    m_new = torch.maximum(logf_m, logi)
    iw = torch.exp(logi - m_new)
    fw = torch.exp(logf_m - m_new)
    c = fw * c + iw * z
    n = fw * n + iw
    h = o * c / torch.maximum(n, one)
    return (c, n, m_new, h), (z, o, iw, fw, logf, f_pre, logf_m, logi)


def slstm_step(r_cat: torch.Tensor, carry, xz_t: torch.Tensor,
               zero: torch.Tensor, one: torch.Tensor):
    """One token (the reference's ``_slstm_step``), its tensors by head:
    carry = (c, n, m, h) each [H, B, W/H] fp32; ``xz_t`` [H, B, 4, W/H]
    the token's input map and bias (z, i, f, o); ``r_cat`` [H, W/H,
    4 W/H], the recurrent map's four blocks side by side; ``zero`` and
    ``one`` 0-d constants of the carry's dtype and device (made once a
    call, not once a token).  Returns the new carry.  Call under
    ``full_fp32``."""
    return _step_parts(r_cat, carry, xz_t, zero, one)[0]


def slstm_scan(r_cat: torch.Tensor, carry, xz: torch.Tensor):
    """The token loop from ``carry`` over xz [S, H, B, 4, W/H]: (the
    stack of each token's h [S, H, B, W/H], the carry after the last)."""
    one = torch.ones((), dtype=xz.dtype, device=xz.device)
    zero = torch.zeros((), dtype=xz.dtype, device=xz.device)
    hs = []
    with full_fp32():
        # the tokens' slices as one op (one backward node, where indexing
        # xz token by token would give each token's gradient a zeroed
        # [S, ...])
        for xz_t in xz.unbind(0):
            carry = slstm_step(r_cat, carry, xz_t, zero, one)
            hs.append(carry[3])
    return torch.stack(hs), carry


def _tie_share(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``maximum(a, b)``'s share of its gradient for ``a``: 1 where a > b,
    half at a tie (``jnp.maximum`` and ``torch.maximum`` split it), else
    0."""
    return (a > b).to(a.dtype) + 0.5 * (a == b).to(a.dtype)


class _SLSTMScan(torch.autograd.Function):
    """Training's scan from the zero state as one autograd node.  Its
    forward runs the loop recording nothing (under per-block remat twice,
    the block's forward and its recomputation) and keeps each token's
    carry and gates; its backward walks the tokens back by hand, the
    derivative of each op of ``_step_parts`` as autograd forms it
    (``tanh``'s ``1 - z^2``, ``sigmoid``'s ``(1 - o) o``, log_sigmoid's
    ``exp(log f - f)``, the ties of both maxima split in half), then ``r``'s
    gradient in one product over every token.  Recorded op by op, the loop
    ran its ops three times over (twice inside the remat block's
    checkpoint, once more to be differentiated) and as many backward
    nodes, each paying the host's dispatch: a training step of xlstm was
    host-bound."""

    @staticmethod
    def forward(ctx, r_cat, xz):
        carry = _zero_carry(xz)
        one = torch.ones((), dtype=xz.dtype, device=xz.device)
        zero = torch.zeros((), dtype=xz.dtype, device=xz.device)
        carries, parts = [carry], []
        with full_fp32():
            for xz_t in xz.unbind(0):
                carry, saved = _step_parts(r_cat, carry, xz_t, zero, one)
                carries.append(carry)
                parts.append(saved)
        # [S + 1, H, B, W/H] each: the carry before the first token and
        # after each; [S, H, B, W/H] each: the gates
        seq = [torch.stack(t) for t in zip(*carries)]
        gates = [torch.stack(t) for t in zip(*parts)]
        ctx.save_for_backward(r_cat, *seq, *gates)
        return seq[3][1:]

    @staticmethod
    def backward(ctx, dh):
        r_cat, c, n, m, h, *gates = ctx.saved_tensors
        z, o, iw, fw, logf, f_pre, logf_m, logi = gates
        s, nh, b, y = dh.shape
        one = torch.ones((), dtype=dh.dtype, device=dh.device)
        r_t = r_cat.transpose(1, 2)
        gh_next = gc_next = gn_next = gm_next = torch.zeros_like(dh[0])
        dpre = [None] * s
        with full_fp32():
            for t in range(s - 1, -1, -1):
                gh = dh[t] + gh_next
                den = torch.maximum(n[t + 1], one)
                # h = (o c) / den
                g_oc = gh / den
                go = g_oc * c[t + 1]
                gc = gc_next + g_oc * o[t]
                gn = gn_next + (-g_oc * h[t + 1]) * _tie_share(n[t + 1], one)
                # c = fw c' + iw z, n = fw n' + iw
                gfw = gc * c[t] + gn * n[t]
                giw = gc * z[t] + gn
                gz = gc * iw[t]
                gc_next, gn_next = gc * fw[t], gn * fw[t]
                # fw = exp(logf_m - m), iw = exp(logi - m), m = max(logf_m,
                # logi)
                ef, ei = gfw * fw[t], giw * iw[t]
                gm = gm_next - ef - ei
                share = _tie_share(logf_m[t], logi[t])
                g_logf_m = ef + gm * share
                g_logi = ei + gm * (1.0 - share)
                gm_next = g_logf_m           # logf_m = log f + m'
                g_f = g_logf_m * torch.exp(logf[t] - f_pre[t])
                g_z = gz * (1.0 - z[t] * z[t])
                g_o = go * (1.0 - o[t]) * o[t]
                g = torch.stack([g_z, g_logi, g_f, g_o], dim=2)
                dpre[t] = g
                gh_next = torch.bmm(g.view(nh, b, 4 * y), r_t)
            dxz = torch.stack(dpre)                     # [S, H, B, 4, y]
            # r's gradient over every token at once: h' [H, S B, y] against
            # dpre [H, S B, 4 y]
            h_prev = h[:-1].transpose(0, 1).reshape(nh, s * b, y)
            dr = torch.bmm(h_prev.transpose(1, 2),
                           dxz.transpose(0, 1).reshape(nh, s * b, 4 * y))
        return dr, dxz


def _zero_carry(xz: torch.Tensor):
    """The zero state (c, n, m, h), each [H, B, W/H], of a scan over
    xz [S, H, B, 4, W/H]."""
    _, nh, b, _, y = xz.shape
    return tuple(torch.zeros((nh, b, y), dtype=xz.dtype, device=xz.device)
                 for _ in range(4))


def slstm_apply(mix: SLSTM, x: torch.Tensor, cfg: ArchConfig,
                compute_dtype: torch.dtype,
                cache: Optional[Dict[str, torch.Tensor]],
                decode: bool) -> torch.Tensor:
    """The sLSTM on the normed stream x [B, S, D] -> [B, S, D] in the
    compute dtype (the reference's ``slstm_apply``).  Prefill scans the S
    positions one at a time from a zero state and writes the state after
    the last into ``cache``; a decode step reads and replaces it.  With
    ``cache`` None (training) the prefill's arithmetic writes nothing, and
    the scan is one autograd node (``_SLSTMScan``)."""
    cd, f32 = compute_dtype, rec_dtype(compute_dtype)
    b, s, w = x.shape
    nh = mix.r.shape[1]
    y = w // nh
    xz = fp32_matmul(x.to(f32), mix.w_in.to(f32)) + mix.bias  # [B, S, 4W]
    # [S, H, B, 4, W/H]: one token's slice is one add's operand
    xz = xz.view(b, s, 4, nh, y).permute(1, 3, 0, 2, 4).contiguous()
    r_cat = mix.r.permute(1, 2, 0, 3).reshape(nh, y, 4 * y)

    def by_head(t):                                          # [B, W] ->
        return t.view(b, nh, y).transpose(0, 1).contiguous()

    if cache is None:
        hs = _SLSTMScan.apply(r_cat, xz)
    else:
        carry = (tuple(by_head(cache[k]) for k in ("c", "n", "m", "h"))
                 if decode else _zero_carry(xz))
        hs, carry = slstm_scan(r_cat, carry, xz)
        for key, t in zip(("c", "n", "m", "h"), carry):
            cache[key] = t.transpose(0, 1).reshape(b, w)
        del carry
    del xz
    h = hs.permute(2, 0, 1, 3).reshape(b, s, w)
    h = rmsnorm(h.to(cd), mix.norm, _EPS)
    return torch.matmul(h, mix.out.to(cd))


def slstm_cache(cfg: ArchConfig, batch: int, device
                ) -> Dict[str, torch.Tensor]:
    """A zeroed sLSTM state (the reference's ``slstm_cache_defs``): ``c``,
    ``n``, ``m``, ``h`` [B, D] at fp32."""
    return {k: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                           device=device) for k in ("c", "n", "m", "h")}
