"""The routed Mixture-of-Experts FFN (llama4), plain torch, the
reference's ``models/moe.py:63-177`` at one data shard (``ds = 1``: one
device, every token of a call in one dispatch).

The reference computes the MoE with einsums, a sort and scatters outside
any Pallas kernel, so the port's products are batched library products
(``torch.bmm``), as the reference's are XLA's.  Each step asks for the
reference's results, not a routing of the port's own:

- the router is an fp32 product (TF32 off, also on the card) and a
  softmax;
- top-1 is ``argmax``, the lowest expert index among ties, and its gate
  ``g / g`` is 1.0;
- capacity is the reference's Python expression (``_capacity``);
- dispatch is a stable sort by expert id and ``searchsorted``: a token
  past its expert's capacity is dropped (its FFN output is 0, so it
  passes through the residual), the later tokens of a call first;
- the expert products are bf16 batched products, then ``silu(g) * h``
  with the silu at fp32 rounded to the compute dtype;
- the combine is an fp32 ``index_add_`` and the shared expert's down
  product is added at fp32, then the sum is cast to the compute dtype.

Capacity is shared by every token of one call, so a token's output
depends on the tokens routed before it in the call (ROADMAP F6).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import fp32_matmul


class MoEOut(NamedTuple):
    """``out`` [B, S, D] in the compute dtype; ``aux`` the load-balancing
    loss (fp32 scalar); ``kept`` [B, S] bool, whether each token kept its
    expert (False: dropped at capacity)."""
    out: torch.Tensor
    aux: torch.Tensor
    kept: torch.Tensor


class MoE(nn.Module):
    """The reference's ``moe_defs`` at one device: ``router [D, E]`` fp32,
    the expert stacks ``w_up``/``w_gate [E, D, F]`` and ``w_down [E, F,
    D]``, and the shared expert's ``shared_up``/``shared_gate [D, F]`` and
    ``shared_down [F, D]``."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        if not cfg.gated_mlp:
            raise NotImplementedError(
                f"{cfg.name}: the port's MoE serves gated experts")
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        shapes = {"router": ((d, e), torch.float32),
                  "w_up": ((e, d, f), dtype), "w_gate": ((e, d, f), dtype),
                  "w_down": ((e, f, d), dtype)}
        if cfg.moe_shared_expert:
            shapes.update(shared_up=((d, f), dtype),
                          shared_gate=((d, f), dtype),
                          shared_down=((f, d), dtype))
        for name, (shape, dt) in shapes.items():
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=dt, device=device),
                requires_grad=False))

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Slots an expert takes from a call of ``n_tokens`` tokens: the
    reference's ``_capacity`` (``moe.py:63-66``) at one device, ``int(n *
    k / e * cf)`` rounded up to a multiple of 8, at least 8."""
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, (c + 7) // 8 * 8)


def router_probs(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """softmax(x @ router) of tokens x [N, D] at fp32: an fp32 product in
    full fp32 on every device (TF32 off for the call, as the reference's
    fp32 einsum on the CPU is)."""
    logits = fp32_matmul(x.to(torch.float32), router.to(torch.float32))
    return torch.softmax(logits, dim=-1)


def dispatch(expert: torch.Tensor, n_experts: int, cap: int):
    """Top-1 dispatch of tokens routed to ``expert`` [N] (the reference's
    ``_dispatch_one_shard``, ``moe.py:69-87``, at k = 1): the tokens in a
    stable sort by expert id (``st``), each token's slot ``dest`` in the
    [E * cap] dispatch buffer (``E * cap``, the overflow slot, for a token
    past its expert's capacity) and ``keep``, all in sorted order."""
    n = expert.shape[0]
    se, st = torch.sort(expert, stable=True)
    starts = torch.searchsorted(se, torch.arange(n_experts,
                                                 device=expert.device))
    pos_in_e = torch.arange(n, device=expert.device) - starts[se]
    keep = pos_in_e < cap
    dest = torch.where(keep, se * cap + pos_in_e,
                       torch.full_like(se, n_experts * cap))
    return st, dest, keep


def moe_apply(moe: MoE, x: torch.Tensor, cfg: ArchConfig,
              compute_dtype: torch.dtype) -> MoEOut:
    """x [B, S, D] (the normed stream) -> ``MoEOut``: the routed experts'
    outputs plus the shared expert's, the reference's ``moe_apply`` at one
    data shard."""
    if cfg.top_k != 1:
        # k > 1 (grok) needs top_k's order and gates, and then the order of
        # the fp32 index_add_ over a token's k contributions matters
        raise NotImplementedError(
            f"{cfg.name}: the port's MoE routes top-1, got top_k="
            f"{cfg.top_k}")
    b, s, d = x.shape
    n, e, cd = b * s, cfg.n_experts, compute_dtype
    xt = x.reshape(n, d)
    probs = router_probs(xt, moe.router)
    expert = torch.argmax(probs, dim=-1)            # the first maximum
    # the Switch/GShard load-balancing loss (moe.py:121-124)
    me = probs.mean(dim=0)
    ce = F.one_hot(expert, e).to(torch.float32).mean(dim=0)
    aux = e * torch.sum(me * ce)

    cap = capacity(n, cfg)
    st, dest, keep = dispatch(expert, e, cap)
    kd, kt = dest[keep], st[keep]
    xe = torch.zeros((e * cap, d), dtype=cd, device=x.device)
    xe[kd] = xt[kt].to(cd)
    xe = xe.reshape(e, cap, d)
    h = torch.bmm(xe, moe.w_up.to(cd))
    g = torch.bmm(xe, moe.w_gate.to(cd))
    h = F.silu(g.to(torch.float32)).to(cd) * h
    del g
    ye = torch.bmm(h, moe.w_down.to(cd)).reshape(e * cap, d)
    del h
    # the combine at fp32 (moe.py:90-97): at k = 1 each token gets at most
    # one contribution (times its gate, 1.0), so the sum is exact
    out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, kt, ye[kd].to(torch.float32))
    if cfg.moe_shared_expert:
        hs = torch.matmul(xt, moe.shared_up.to(cd))
        gs = torch.matmul(xt, moe.shared_gate.to(cd))
        hs = F.silu(gs.to(torch.float32)).to(cd) * hs
        out += torch.matmul(hs, moe.shared_down.to(cd)).to(torch.float32)
    kept = torch.zeros(n, dtype=torch.bool, device=x.device)
    kept[st] = keep
    return MoEOut(out.to(cd).reshape(b, s, d), aux, kept.reshape(b, s))
