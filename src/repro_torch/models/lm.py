"""The dense GQA decoder (global attention + gated MLP, tied embeddings):
parameters, forward in ``prefill`` and ``decode`` modes, and the dense KV
cache.

The reference scans one stacked parameter group; here the 40 blocks are an
``nn.ModuleList``.  The rmsnorm chain is the reference's: the entry norm
is the only standalone ``ln1``; every block's down GEMM folds the residual
add and the NEXT block's ``ln1`` (the last block's folds ``final_norm``)
into its epilogue, while ``ln2`` stays a standalone rmsnorm.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import Attention, attention_apply
from repro_torch.models.layers import mlp_apply, rmsnorm, vocab_parallel_embed
from repro_torch.models.loss import vocab_parallel_logits

Cache = List[Dict[str, torch.Tensor]]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        kw = dict(dtype=dtype, device=device)
        self.gate = nn.Parameter(torch.empty(d, ff, **kw), requires_grad=False)
        self.up = nn.Parameter(torch.empty(d, ff, **kw), requires_grad=False)
        self.down = nn.Parameter(torch.empty(ff, d, **kw), requires_grad=False)


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.ln1 = nn.Parameter(torch.empty(cfg.d_model, **kw),
                                requires_grad=False)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = nn.Parameter(torch.empty(cfg.d_model, **kw),
                                requires_grad=False)
        self.ffn = MLP(cfg, dtype, device)


class Model(nn.Module):
    """``Model(cfg)`` lives on the card; ``Model(cfg, device="cpu")`` runs
    the plain PyTorch versions of every kernel."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        if cfg.block_pattern != ("global",) or not cfg.gated_mlp \
                or not cfg.tie_embeddings:
            raise NotImplementedError(
                f"{cfg.name}: this slice serves dense global-attention "
                f"decoders with a gated MLP and tied embeddings")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = _dtype(cfg.compute_dtype)
        dt = _dtype(cfg.param_dtype)
        self.embed = nn.Parameter(
            torch.empty(cfg.padded_vocab(), cfg.d_model, dtype=dt,
                        device=self.device), requires_grad=False)
        self.final_norm = nn.Parameter(
            torch.empty(cfg.d_model, dtype=torch.float32, device=self.device),
            requires_grad=False)
        self.blocks = nn.ModuleList(
            Block(cfg, dt, self.device) for _ in range(cfg.n_layers))

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Model":
        """Seeded init with the reference's schema and scales: norm scales
        zero, the embedding N(0, 1/d), every other weight N(0, 1/fan_in).
        Drawn by ``torch.Generator`` on the model's device, so it does not
        reproduce the JAX package's bits (``convert.from_jax_params``
        carries those across)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if p.dim() == 1:
                p.zero_()
                continue
            fan_in = self.cfg.d_model if name == "embed" else p.shape[0]
            w = torch.randn(p.shape, generator=gen, device=self.device,
                            dtype=torch.float32)
            p.copy_(w.mul_(1.0 / math.sqrt(fan_in)))
        return self

    # -- cache -----------------------------------------------------------------

    def new_cache(self, batch: int, max_len: int) -> Cache:
        """Zeroed dense K/V caches [B, max_len, KV, hd] in bf16, one dict per
        layer (the reference's ``cache_defs`` for the global kind)."""
        cfg = self.cfg
        shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
        kw = dict(dtype=torch.bfloat16, device=self.device)
        return [{"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}
                for _ in range(cfg.n_layers)]

    # -- forward ----------------------------------------------------------------

    def _block(self, blk: Block, h, xn, next_scale, *, positions, cache, pos):
        cfg, cd = self.cfg, self.compute_dtype
        out = attention_apply(blk.attn, xn, cfg, cd, theta=cfg.rope_theta,
                              positions=positions, cache=cache, pos=pos)
        h = h + out
        xn2 = rmsnorm(h, blk.ln2, cfg.norm_eps)
        ffn = {"gate": blk.ffn.gate, "up": blk.ffn.up, "down": blk.ffn.down}
        return mlp_apply(ffn, xn2, cd, residual=h, norm_scale=next_scale,
                         norm_eps=cfg.norm_eps)

    def forward(self, tokens: torch.Tensor, *, cache: Cache,
                pos: Optional[int] = None) -> torch.Tensor:
        """tokens [B, S].  ``pos`` None: prefill (the cache is filled from
        slot 0); else one decode token at position ``pos``.  Returns the
        final-normed stream [B, S, D]."""
        cfg, cd = self.cfg, self.compute_dtype
        h = vocab_parallel_embed(self.embed, tokens, cd)
        # the sqrt(d) multiplier is rounded to the compute dtype first
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=cd,
                             device=h.device)
        if pos is None:
            positions = torch.arange(tokens.shape[1], device=h.device)
        else:
            positions = torch.tensor([pos], device=h.device)
        xn = rmsnorm(h, self.blocks[0].ln1, cfg.norm_eps)
        for i, blk in enumerate(self.blocks):
            nxt = (self.blocks[i + 1].ln1 if i + 1 < len(self.blocks)
                   else self.final_norm)
            h, xn = self._block(blk, h, xn, nxt, positions=positions,
                                cache=cache[i], pos=pos)
        return xn  # the last block's fold produced rmsnorm(h, final_norm)

    # -- entry points -------------------------------------------------------------

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor,
                max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
        """tokens [B, S] -> (last-token logits [B, Vp] fp32, cache with
        ``max_len`` slots)."""
        b, s = tokens.shape
        cache = self.new_cache(b, max(max_len or s, s, 1))
        h = self.forward(tokens.to(self.device), cache=cache)
        return vocab_parallel_logits(h[:, -1:], self.embed)[:, 0], cache

    @torch.inference_mode()
    def decode_step(self, cache: Cache, token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Cache]:
        """token [B, 1] at position ``pos`` -> (logits [B, Vp] fp32, cache
        updated in place)."""
        h = self.forward(token.to(self.device), cache=cache, pos=int(pos))
        return vocab_parallel_logits(h, self.embed)[:, 0], cache
