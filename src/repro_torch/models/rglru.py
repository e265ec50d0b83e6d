"""The RG-LRU recurrent mixer (recurrentgemma / Griffin, arXiv:2402.19427),
the reference's ``models/rglru.py`` in plain torch:

  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
  a_t = exp(-c * softplus(Lambda) * sigma(r_t)),  c = 8

The reference computes all of it outside Pallas (``jnp.einsum``, a Python
sum of products, ``lax.associative_scan``), so the port's products are
library products, as the MoE's are.  Each step asks for the reference's
results:

- the two branches' projections ``in_x``/``in_g`` and ``out`` at the
  compute dtype;
- the causal conv (width ``conv_width``, depthwise) as the reference's
  XLA fusion on the CPU computes it (``causal_conv``): at bf16 each
  product and each add rounded but the last add, which stays at fp32 for
  the gates that widen it; at fp32 the sum contracted into FMAs in XLA's
  order.  On the smoke config the mixer's bf16 output is then bitwise the
  reference's, its fp32 output within 2e-7 of its scale;
- the gates ``w_a``/``w_i`` multiplied at fp32, full fp32 on every device
  (``layers.fp32_matmul``).  The mixer holds them at the block's dtype,
  the reference's ``param_dtype`` (``WIDENED``), and widens them at use
  as the reference does, so that training rounds their gradients and
  updates as the reference's bf16 leaves take them; the serving copy
  (``lm._cast_mixer``) holds them widened once, which changes no bit and
  spares each call the cast (1.75 GB written and read again a decode
  step at full width);
- ``softplus`` as ``logaddexp(x, 0)`` (``jax.nn.softplus``; torch's own
  returns ``x`` above 20);
- the prefill scan over the affine maps ``h -> a h + b`` in
  ``lax.associative_scan``'s own odd/even recursion (``linear_scan``:
  log depth, the same pairs combined in the same order, each ``b_l a_r +
  b_r`` one FMA as XLA contracts it);
- the decode update ``a h + b`` as one FMA;
- the output gate ``h * gelu(g)`` with the tanh gelu at fp32, both
  factors rounded to the compute dtype.

The cache of a layer is ``{"h": fp32 [B, W], "conv": [B, cw - 1, W]}``
in the compute dtype (the reference's ``rglru_cache_defs``): the prefill
writes the state after its last token, a decode step replaces both
entries (new tensors, so a caller's shallow copy of the dict keeps the
state it had: ``lm.Cache.fork``).  Training (no cache, the reference's
``mode="train"``) runs the prefill's arithmetic under autograd and writes
no state.  Its one tie rule is the floor of the gated input's scale:
``torch.maximum`` splits a tie's gradient evenly, as ``jnp.maximum``
does (``torch.clamp`` would pass it whole).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import fp32_matmul

_C = 8.0


class RGLRU(nn.Module):
    """The reference's ``rglru_defs``: ``in_x``/``in_g [D, W]``, ``conv
    [cw, W]``, ``out [W, D]`` and the gates ``w_a``/``w_i [W, W]`` at
    ``dtype``, ``lam [W]`` at fp32."""

    # the weights held at the block's dtype and used at the compute dtype
    COMPUTE_WEIGHTS = ("in_x", "in_g", "conv", "out")
    # the weights held at the block's dtype and used at fp32
    WIDENED = ("w_a", "w_i")

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width or cfg.d_model
        shapes = {"in_x": (d, w), "in_g": (d, w), "conv": (cfg.conv_width, w),
                  "w_a": (w, w), "w_i": (w, w), "lam": (w,), "out": (w, d)}
        for name, shape in shapes.items():
            dt = (dtype if name in self.COMPUTE_WEIGHTS + self.WIDENED
                  else torch.float32)
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=dt, device=device),
                requires_grad=False))


def lru_log_init(shape, generator: torch.Generator,
                 device) -> torch.Tensor:
    """``lam``'s init (the reference's ``param.py:131-136``): ``u`` uniform
    in [0.9^2, 0.999^2], ``log(expm1(-0.5 log(u) / 8))``, so that ``a =
    exp(-8 softplus(lam))`` has moduli in [0.9, 0.999].  Drawn from the
    port's generator, not the reference's bits."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32) * (0.999 ** 2 - 0.9 ** 2) + 0.9 ** 2
    return torch.log(torch.expm1(-0.5 * torch.log(u) / _C))


def causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time (the reference's ``_causal_conv``).
    x [B, S, W], kernel [cw, W], both in the compute dtype; ``state`` [B,
    cw - 1, W] the left context (None: zeros).  Returns (out [B, S, W],
    the state after the last position)."""
    cw, s = kernel.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    taps = [xp[:, i:i + s] for i in range(cw)]
    if x.dtype == torch.float32 and cw > 1:
        # XLA's fusion contracts ((p0 + p1) + p2) + p3 into FMAs: the
        # first product into the second, then each later tap into the sum
        out = taps[1] * kernel[1]
        for i in (0, *range(2, cw)):
            out = torch.addcmul(out, taps[i], kernel[i])
    else:
        # each product and each add rounded to the dtype, but the last add:
        # every consumer of the sum widens it to fp32 (``_gates``), and
        # XLA's CPU fusion keeps that add at fp32 for them
        out = taps[0] * kernel[0]
        for i in range(1, cw - 1):
            out = out + taps[i] * kernel[i]
        out = out.to(torch.float32) + (taps[-1] * kernel[-1]).to(
            torch.float32)
    # a copy: a view would hold the whole [B, S + cw - 1, W] input alive
    new_state = xp[:, s:].clone() if cw > 1 else state
    return out, new_state


def gates(mix: RGLRU, xc: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decay ``a`` and the gated input ``b`` [B, S, W] at fp32 from the
    conv'd branch (the reference's ``_gates``)."""
    x32 = xc.to(torch.float32)
    r = torch.sigmoid(fp32_matmul(x32, mix.w_a.to(torch.float32)))
    i = torch.sigmoid(fp32_matmul(x32, mix.w_i.to(torch.float32)))
    sp = torch.logaddexp(mix.lam, torch.zeros((), dtype=torch.float32,
                                              device=mix.lam.device))
    log_a = (-_C * sp) * r
    a = torch.exp(log_a)
    floor = torch.full((), 1e-12, dtype=torch.float32, device=xc.device)
    b = torch.sqrt(torch.maximum(1.0 - torch.exp(2.0 * log_a), floor)) \
        * (i * x32)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 over dim 1 of [B, S, W]:
    ``lax.associative_scan`` of the affine maps, ``(a_l, b_l) o (a_r,
    b_r) = (a_l a_r, b_l a_r + b_r)``, in its own recursion: pairs (0, 1),
    (2, 3), ... combined, the half-length scan of the pairs gives the odd
    positions, each even position 2k its odd predecessor combined with
    element 2k.  About 2 log2(S) levels of elementwise launches (13 at S =
    4160), no loop over time.  Only the ``b`` half (h) is returned; the
    down-sweep's products of ``a`` feed no ``b`` and are not formed."""
    n = a.shape[1]
    if n < 2:
        return b
    ar = a[:, 1::2]
    # the pairs' maps: (a_{2k} a_{2k+1}, b_{2k} a_{2k+1} + b_{2k+1})
    odd = linear_scan(a[:, 0:-1:2] * ar,
                      torch.addcmul(b[:, 1::2], b[:, 0:-1:2], ar))
    h = torch.empty_like(b)
    h[:, 0] = b[:, 0]
    h[:, 1::2] = odd
    # even position 2k (k >= 1): h_{2k-1} a_{2k} + b_{2k}
    prev = odd[:, :-1] if n % 2 == 0 else odd
    h[:, 2::2] = torch.addcmul(b[:, 2::2], prev, a[:, 2::2])
    return h


def rglru_apply(mix: RGLRU, x: torch.Tensor, cfg: ArchConfig,
                compute_dtype: torch.dtype,
                cache: Optional[Dict[str, torch.Tensor]],
                decode: bool) -> torch.Tensor:
    """The mixer on the normed stream x [B, S, D] -> [B, S, D] in the
    compute dtype (the reference's ``rglru_apply``).  Prefill (``decode``
    False) scans from a zero state and writes the state after the last
    position into ``cache``; a decode step (S = 1) reads the state and
    replaces it with the updated one.  With ``cache`` None (training) the
    prefill's arithmetic writes nothing.  ``mix`` is the module or any
    object with its weights as attributes (training: the parameters'
    leaves)."""
    cd = compute_dtype
    xb = torch.matmul(x, mix.in_x.to(cd))
    gb = torch.matmul(x, mix.in_g.to(cd))
    xc, conv_state = causal_conv(xb, mix.conv.to(cd),
                                 cache["conv"] if decode else None)
    a, b = gates(mix, xc)
    if decode:
        h = torch.addcmul(b[:, 0], a[:, 0], cache["h"].to(torch.float32))
        cache["h"] = h.to(cache["h"].dtype)
        h = h[:, None]
    else:
        h = linear_scan(a, b)
        if cache is not None:
            cache["h"] = h[:, -1].clone()
    if cache is not None:
        cache["conv"] = conv_state
    g = F.gelu(gb.to(torch.float32), approximate="tanh").to(cd)
    return torch.matmul(h.to(cd) * g, mix.out.to(cd))


def rglru_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                device) -> Dict[str, torch.Tensor]:
    """A zeroed state (the reference's ``rglru_cache_defs``): ``h`` fp32
    [B, W] and the conv's left context [B, cw - 1, W] in ``dtype``."""
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}
