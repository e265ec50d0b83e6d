"""The routed Mixture-of-Experts FFN (llama4 at top-1 with a shared
expert, grok-1 at top-2), plain torch, the reference's
``models/moe.py:63-177`` at one data shard (``ds = 1``: one device, every
token of a call in one dispatch).

The reference computes the MoE with einsums, a sort and scatters outside
any Pallas kernel, so the port's products are batched library products
(``torch.bmm``), as the reference's are XLA's.  Each step asks for the
reference's results, not a routing of the port's own:

- the router is an fp32 product (TF32 off, also on the card) and a
  softmax;
- the top k experts of a token are ``lax.top_k``'s (``top_k``): values
  descending, the lower expert index first among ties (``torch.topk``
  breaks ties otherwise), and their gates ``g / g.sum()`` at fp32 (at k =
  1 the gate is 1.0);
- capacity is the reference's Python expression (``_capacity``);
- dispatch flattens the [N, k] choices in (token, rank) order and
  stable-sorts them by expert, then ``searchsorted``: an entry past its
  expert's capacity is dropped on its own (a token may keep one of its
  two experts and lose the other; a token that loses all of them passes
  through the residual), the later tokens of a call first;
- the expert products are bf16 batched products, then ``silu(g) * h``
  with the silu at fp32 rounded to the compute dtype;
- the combine (``combine``) takes each entry's expert output times its
  gate as the jitted reference computes it, ``f32(ye) * f32(bf16(gate))``
  (XLA keeps the product unrounded inside its jit), and ``index_add_``s
  the contributions at fp32 into zeros; the shared expert's down product
  is added at fp32, then the sum is cast to the compute dtype.

At k <= 2 the combine does not depend on the order of the additions: a
token's row starts at 0.0 and takes at most two contributions, and ``0 +
a`` is exactly ``a`` and ``a + b`` is ``b + a``.  So CUDA's atomic
``index_add_`` is bitwise deterministic.  From k = 3 on the sum would need
an ordered fold; no reference model routes to three experts, and the port
refuses it (``check_top_k``).

Capacity is shared by every token of one call, so a token's output
depends on the tokens routed before it in the call (ROADMAP F6).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import fp32_matmul

# the most experts a token is routed to: beyond it the fp32 combine of a
# token's contributions would depend on their order
MAX_TOP_K = 2


class MoEOut(NamedTuple):
    """``out`` [B, S, D] in the compute dtype; ``aux`` the load-balancing
    loss (fp32 scalar); ``kept`` [B, S] bool, True where all k of a
    token's entries kept their expert's slot (False: at least one was
    dropped at capacity)."""
    out: torch.Tensor
    aux: torch.Tensor
    kept: torch.Tensor


def check_top_k(cfg: ArchConfig) -> None:
    """Refuse a routing the port does not serve: k outside 1..MAX_TOP_K."""
    if not 1 <= cfg.top_k <= MAX_TOP_K:
        raise ValueError(
            f"{cfg.name}: top_k={cfg.top_k}; the port's MoE routes 1 to "
            f"{MAX_TOP_K} experts a token: from 3 on the fp32 combine of a "
            f"token's contributions would need an ordered fold, and no "
            f"reference model routes to three experts")


class MoE(nn.Module):
    """The reference's ``moe_defs`` at one device: ``router [D, E]`` fp32,
    the expert stacks ``w_up``/``w_gate [E, D, F]`` and ``w_down [E, F,
    D]``, and the shared expert's ``shared_up``/``shared_gate [D, F]`` and
    ``shared_down [F, D]`` (llama4)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        if not cfg.gated_mlp:
            raise NotImplementedError(
                f"{cfg.name}: the port's MoE serves gated experts")
        check_top_k(cfg)
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


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k(probs, k)``: the k largest values of each row in
    descending order and their indices, the lower index first among equal
    values (a stable sort; ``torch.topk`` may pick another of a tie)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch(expert: torch.Tensor, n_experts: int, cap: int,
             gates: Optional[torch.Tensor] = None):
    """Dispatch of the experts chosen for each token, ``expert`` [N] (top-1)
    or [N, k] (the reference's ``_dispatch_one_shard``, ``moe.py:69-89``):
    the N * k entries flattened in (token, rank) order and stable-sorted by
    expert id; for each entry in sorted order its token ``st``, its slot
    ``dest`` in the [E * cap] dispatch buffer (``E * cap``, the overflow
    slot, for an entry past its expert's capacity) and ``keep``.  With
    ``gates`` (the shape of ``expert``) their values in sorted order are
    returned too, ``(st, dest, keep, sg)``."""
    k = expert.shape[1] if expert.dim() == 2 else 1
    flat = expert.reshape(-1)
    m = flat.shape[0]
    se, order = torch.sort(flat, stable=True)
    st = order // k
    starts = torch.searchsorted(se, torch.arange(n_experts,
                                                 device=expert.device))
    pos_in_e = torch.arange(m, device=expert.device) - starts[se]
    keep = pos_in_e < cap
    dest = torch.where(keep, se * cap + pos_in_e,
                       torch.full_like(se, n_experts * cap))
    if gates is None:
        return st, dest, keep
    return st, dest, keep, gates.reshape(-1)[order]


def combine(ye: torch.Tensor, st: torch.Tensor, dest: torch.Tensor,
            sg: torch.Tensor, keep: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's ``_combine_one_shard`` (``moe.py:92-99``) as its jit
    computes it: expert outputs ``ye`` [E * cap, D] in the compute dtype,
    the sorted entries' tokens, slots, gates and kept flags -> [n, D] fp32.
    Each entry's contribution is ``f32(ye[dest]) * f32(cd(gate * keep))``
    (a dropped entry reads the zero overflow row: +0.0), the gate rounded
    to the compute dtype but not the product (XLA elides the round trip
    ``f32 -> bf16 -> f32`` of the product inside its jit), then an fp32
    ``index_add_`` into zeros: at k <= 2 bitwise whatever the order."""
    d = ye.shape[-1]
    ye_flat = torch.cat([ye.reshape(-1, d), ye.new_zeros((1, d))])
    gate = (sg * keep).to(ye.dtype).to(torch.float32)
    contrib = ye_flat[dest].to(torch.float32) * gate[:, None]
    out = torch.zeros((n, d), dtype=torch.float32, device=ye.device)
    return out.index_add_(0, st, contrib)


def moe_apply(moe: MoE, x: torch.Tensor, cfg: ArchConfig,
              compute_dtype: torch.dtype) -> MoEOut:
    """x [B, S, D] (the normed stream) -> ``MoEOut``: the routed experts'
    outputs plus the shared expert's, the reference's ``moe_apply`` at one
    data shard."""
    check_top_k(cfg)
    b, s, d = x.shape
    n, e, k, cd = b * s, cfg.n_experts, cfg.top_k, compute_dtype
    xt = x.reshape(n, d)
    probs = router_probs(xt, moe.router)
    # the Switch/GShard load-balancing loss, top-1 at any k (moe.py:121-124)
    top1 = torch.argmax(probs, dim=-1)               # the first maximum
    me = probs.mean(dim=0)
    ce = F.one_hot(top1, e).to(torch.float32).mean(dim=0)
    aux = e * torch.sum(me * ce)

    gate_vals, expert = top_k(probs, k)              # [n, k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    cap = capacity(n, cfg)
    st, dest, keep, sg = dispatch(expert, e, cap, gate_vals)
    # the dropped entries all land on the overflow row, cut off after
    xe = torch.zeros((e * cap + 1, d), dtype=cd, device=x.device)
    xe[dest] = xt[st].to(cd)
    xe = xe[:-1].reshape(e, cap, d)
    h = torch.bmm(xe, moe.w_up.to(cd))
    g = torch.bmm(xe, moe.w_gate.to(cd))
    del xe
    # silu(g) * h, the silu at fp32 rounded to the compute dtype; in place
    # where the values allow, which at grok's width saves 4 GB of a
    # prefill's transients
    g = F.silu(g.to(torch.float32), inplace=True).to(cd)
    h.mul_(g)
    del g
    ye = torch.bmm(h, moe.w_down.to(cd))
    del h
    out = combine(ye, st, dest, sg, keep, n)
    if cfg.moe_shared_expert:
        hs = torch.matmul(xt, moe.shared_up.to(cd))
        gs = torch.matmul(xt, moe.shared_gate.to(cd))
        hs = F.silu(gs.to(torch.float32)).to(cd) * hs
        out += torch.matmul(hs, moe.shared_down.to(cd)).to(torch.float32)
    # a token is kept where all k of its entries are (integer counts: the
    # same under CUDA's atomics)
    kept = torch.zeros(n, dtype=torch.int32, device=x.device).index_add_(
        0, st, keep.to(torch.int32)) == k
    return MoEOut(out.to(cd).reshape(b, s, d), aux, kept.reshape(b, s))
