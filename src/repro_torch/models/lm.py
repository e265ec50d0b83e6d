"""The dense GQA decoder (global or sliding-window attention + gated MLP,
tied embeddings): parameters, forward in ``prefill``, ``decode`` and
``paged`` modes, the dense KV cache and the paged KV pools, and the int8
serving copy.

Layer i's attention kind is ``cfg.block_pattern[i % period]`` (gemma2
alternates 'local' and 'global'); its RoPE theta is ``rope_theta``, or
``rope_theta_global`` for a global layer where that is set.  The
reference scans a stacked parameter group of one pattern period (plus an
unrolled tail); here the blocks are one ``nn.ModuleList``.  The rmsnorm
chain is the reference's: the entry norm is the only standalone ``ln1``;
every block's down GEMM folds the residual add and the NEXT block's
``ln1`` (the last block's folds ``final_norm``) into its epilogue, while
``ln2`` stays a standalone rmsnorm.  ``final_softcap`` caps the logits.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.quantize import quantize_weight_colwise
from repro_torch.kernels.ref import check_kind
from repro_torch.models.attention import Attention, attention_apply
from repro_torch.models.layers import mlp_apply, rmsnorm, vocab_parallel_embed
from repro_torch.models.loss import vocab_parallel_logits

Cache = List[Dict[str, torch.Tensor]]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, weights: Optional[dict] = None):
        super().__init__()
        if weights is not None:
            self.gate, self.up, self.down = (weights["gate"], weights["up"],
                                             weights["down"])
            return
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

    @classmethod
    def quantized(cls, blk: "Block", cfg: ArchConfig) -> "Block":
        """The int8 serving copy of ``blk``: the five projection weights
        quantized column-wise, the norm scales shared."""
        q = cls.__new__(cls)
        nn.Module.__init__(q)
        q.ln1, q.ln2 = blk.ln1, blk.ln2
        qw = quantize_weight_colwise
        q.attn = Attention(cfg, None, None, weights={
            "wqkv": qw(blk.attn.wqkv), "wo": qw(blk.attn.wo)})
        q.ffn = MLP(cfg, None, None, weights={
            name: qw(getattr(blk.ffn, name))
            for name in ("gate", "up", "down")})
        return q


class Model(nn.Module):
    """``Model(cfg)`` lives on the card; ``Model(cfg, device="cpu")`` runs
    the plain PyTorch versions of every kernel."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        for kind in cfg.block_pattern:
            check_kind(kind)
        if not cfg.gated_mlp or not cfg.tie_embeddings:
            raise NotImplementedError(
                f"{cfg.name}: the port serves dense attention decoders "
                f"with a gated MLP and tied embeddings")
        self.cfg = cfg
        self.int8 = False
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

    @torch.no_grad()
    def quantize_params_for_serving(self) -> "Model":
        """One-shot int8 weight quantization for serving: a new ``Model``
        whose packed ``wqkv``, ``wo`` and MLP ``gate``/``up``/``down`` are
        ``QuantizedWeight``s (int8 values stored once transposed, [N, K],
        the K-major operand of K2's s8 wgmma; one f32 scale per output
        column) and which shares this model's embedding and norm scales
        (the tied head keeps full precision for the logits).  Idempotent:
        an int8 model returns itself."""
        if self.int8:
            return self
        q = Model.__new__(Model)
        nn.Module.__init__(q)
        q.cfg, q.int8, q.device = self.cfg, True, self.device
        q.compute_dtype = self.compute_dtype
        q.embed, q.final_norm = self.embed, self.final_norm
        q.blocks = nn.ModuleList(Block.quantized(b, self.cfg)
                                 for b in self.blocks)
        return q

    @property
    def supports_paged_serving(self) -> bool:
        """The paged scheduler serves single-device stacks of the attention
        kinds K6 takes ('global', 'local'): every model the port builds."""
        return all(kind in ("global", "local")
                   for kind in self.cfg.block_pattern)

    def _theta(self, kind: str) -> float:
        cfg = self.cfg
        if kind == "global" and cfg.rope_theta_global:
            return cfg.rope_theta_global
        return cfg.rope_theta

    # -- cache -----------------------------------------------------------------

    def new_cache(self, batch: int, max_len: int) -> Cache:
        """Zeroed dense K/V caches in bf16, one dict per layer (the
        reference's ``cache_defs``): [B, max_len, KV, hd] for a global
        layer, a ring buffer of min(window, max_len) slots for a local
        one."""
        cfg = self.cfg
        kw = dict(dtype=torch.bfloat16, device=self.device)
        out = []
        for i in range(cfg.n_layers):
            slots = (min(cfg.window, max_len) if cfg.kind(i) == "local"
                     else max_len)
            shape = (batch, slots, cfg.n_kv_heads, cfg.hd)
            out.append({"k": torch.zeros(shape, **kw),
                        "v": torch.zeros(shape, **kw)})
        return out

    def new_paged_cache(self, n_pages: int, page_size: int) -> Cache:
        """Zeroed K/V page pools ``[n_pages + 1, page_size, KV, hd]`` bf16,
        one pair per layer, shared by every lane through the page table;
        row ``n_pages`` is the trash page (written by idle lanes and padded
        chunk tails, never read unmasked)."""
        cfg = self.cfg
        shape = (n_pages + 1, page_size, cfg.n_kv_heads, cfg.hd)
        kw = dict(dtype=torch.bfloat16, device=self.device)
        return [{"kp": torch.zeros(shape, **kw),
                 "vp": torch.zeros(shape, **kw)}
                for _ in range(cfg.n_layers)]

    # -- forward ----------------------------------------------------------------

    def _block(self, blk: Block, kind: str, h, xn, next_scale, *, positions,
               cache, pos, page_table):
        cfg, cd = self.cfg, self.compute_dtype
        out = attention_apply(blk.attn, xn, cfg, cd, kind=kind,
                              theta=self._theta(kind), positions=positions,
                              cache=cache, pos=pos, page_table=page_table)
        h = h + out
        xn2 = rmsnorm(h, blk.ln2, cfg.norm_eps)
        ffn = {"gate": blk.ffn.gate, "up": blk.ffn.up, "down": blk.ffn.down}
        return mlp_apply(ffn, xn2, cd, residual=h, norm_scale=next_scale,
                         norm_eps=cfg.norm_eps)

    def forward(self, tokens: torch.Tensor, *, cache: Cache,
                pos: Optional[int] = None,
                positions: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S].  With ``page_table`` [B, P]: paged serving, the
        cache is the page pools and ``positions`` [B, S] holds per-token
        positions (-1 = inactive).  Otherwise ``pos`` None is prefill (the
        dense cache is filled from slot 0), else one decode token at
        position ``pos``.  Returns the final-normed stream [B, S, D]."""
        cfg, cd = self.cfg, self.compute_dtype
        h = vocab_parallel_embed(self.embed, tokens, cd)
        # the sqrt(d) multiplier is rounded to the compute dtype first
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=cd,
                             device=h.device)
        if page_table is None:
            positions = (torch.arange(tokens.shape[1], device=h.device)
                         if pos is None
                         else torch.tensor([pos], device=h.device))
        xn = rmsnorm(h, self.blocks[0].ln1, cfg.norm_eps)
        for i, blk in enumerate(self.blocks):
            nxt = (self.blocks[i + 1].ln1 if i + 1 < len(self.blocks)
                   else self.final_norm)
            h, xn = self._block(blk, cfg.kind(i), h, xn, nxt,
                                positions=positions,
                                cache=cache[i], pos=pos,
                                page_table=page_table)
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
        logits = vocab_parallel_logits(h[:, -1:], self.embed,
                                       self.cfg.final_softcap)
        return logits[:, 0], cache

    @torch.inference_mode()
    def decode_step(self, cache: Cache, token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Cache]:
        """token [B, 1] at position ``pos`` -> (logits [B, Vp] fp32, cache
        updated in place)."""
        h = self.forward(token.to(self.device), cache=cache, pos=int(pos))
        logits = vocab_parallel_logits(h, self.embed, self.cfg.final_softcap)
        return logits[:, 0], cache

    @torch.inference_mode()
    def decode_step_paged(self, cache: Cache, token: torch.Tensor,
                          positions: torch.Tensor, page_table: torch.Tensor
                          ) -> Tuple[torch.Tensor, Cache]:
        """One decode step for every serving lane through the page pools.
        token [L, 1] each lane's previous pick; positions [L] the position
        being written (-1 = idle lane: its write lands on the trash page,
        its logits row is garbage the host ignores); page_table [L, P].
        Returns (logits [L, Vp] fp32, pools updated in place).  The shapes
        depend only on (L, pools, P), never on which requests hold the
        lanes."""
        dev = self.device
        h = self.forward(token.to(dev), cache=cache,
                         positions=positions.to(dev, torch.int32)[:, None],
                         page_table=page_table.to(dev, torch.int32))
        logits = vocab_parallel_logits(h, self.embed, self.cfg.final_softcap)
        return logits[:, 0], cache

    @torch.inference_mode()
    def prefill_chunk(self, cache: Cache, tokens: torch.Tensor,
                      positions: torch.Tensor, page_table: torch.Tensor,
                      last_idx: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """One fixed-size prompt chunk for every serving lane at once, with
        the decode step's write-then-attend math.  tokens [L, C];
        positions [L, C] (-1 marks idle lanes and the padded tail of a
        final chunk: those writes go to the trash page); page_table [L, P];
        last_idx [L] the index of each lane's last real token in this chunk
        (-1 = idle, clamped to 0: a garbage row the host ignores).  Returns
        (logits [L, Vp] at each lane's last real token, pools updated in
        place)."""
        dev = self.device
        h = self.forward(tokens.to(dev), cache=cache,
                         positions=positions.to(dev, torch.int32),
                         page_table=page_table.to(dev, torch.int32))
        idx = torch.clamp(last_idx.to(dev, torch.long), min=0)
        hl = h[torch.arange(h.shape[0], device=dev), idx][:, None]
        logits = vocab_parallel_logits(hl, self.embed, self.cfg.final_softcap)
        return logits[:, 0], cache
