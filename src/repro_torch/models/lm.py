"""The GQA decoder (global, sliding-window or chunked attention + gated
MLP or routed MoE, tied embeddings), whisper's encoder-decoder,
paligemma's patch prefix, recurrentgemma's RG-LRU blocks and xLSTM's
blocks: parameters, forward in ``prefill``, ``decode`` and ``paged``
modes, the dense KV cache and the paged KV pools, and the int8 serving
copy.

Layer i's attention kind is ``cfg.block_pattern[i % period]`` (gemma2
alternates 'local' and 'global'); its RoPE theta is ``rope_theta``, or
``rope_theta_global`` for a global layer where that is set.  The
reference scans a stacked parameter group of one pattern period (plus an
unrolled tail); here the blocks are one ``nn.ModuleList``.  The rmsnorm
chain is the reference's: the entry norm is the only standalone ``ln1``;
every block's down GEMM folds the residual add and the NEXT block's
``ln1`` (the last block's folds ``final_norm``) into its epilogue, while
``ln2`` stays a standalone rmsnorm.  ``final_softcap`` caps the logits.

llama4 and grok-1 (``cfg.moe``, the reference's ``lm.py:291-297``): each
block's FFN is the routed MoE (``models.moe``, top-1 with a shared expert
or top-2), which has no GEMM epilogue to fold into, so after ``ln2`` and
the MoE the residual add runs in the compute dtype and the NEXT norm as a
standalone rmsnorm.  llama4's 'chunked' layers keep a dense ring cache of
``min(window, max_len)`` slots, as local ones do.  Each forward keeps the
MoE layers' ``kept`` masks (which tokens kept all their experts) in
``Model.moe_kept``.

Whisper (``cfg.encdec``, the reference's ``lm.py:272-287, 356-385``): an
encoder of ``n_enc_layers`` blocks over the (stubbed) frame embeddings
[B, F, D] plus sinusoidal positions, each a standalone rmsnorm, the
'full' self-attention (K4), a standalone rmsnorm and the plain GELU MLP,
its residual adds in the compute dtype outside the GEMMs, then the final
rmsnorm.  The decoder takes sinusoidal positions, no RoPE; each block
adds a cross-attention over the encoder output between the self-attention
and the MLP (its own standalone rmsnorm ``lnx``).  The encoder output is
held beside the dense cache (``Cache.enc_out``) and decode recomputes the
cross-attention K/V from it at every step.

paligemma (``cfg.prefix_tokens``, the reference's ``_embed_inputs``,
``lm.py:346-361``): the prefill takes ``prefix_tokens`` (stubbed) patch
embeddings [B, P, D]; the text tokens' rows are gathered and scaled by
``sqrt(d_model)`` first, then the patches, cast to the compute dtype and
not scaled, are put in front.  Positions and RoPE run over P + S, and the
layers keep their own kind: paligemma's 'global' attends to the patches
causally, as the reference's does (ROADMAP F5).  Decode takes no patches.

recurrentgemma (an 'rglru' kind in ``block_pattern``, the reference's
``lm.py:252-261``): such a block holds the RG-LRU mixer (``mix``,
``models.rglru``) where an attention block holds ``attn``, and keeps its
norms and its MLP, whose down GEMM folds the residual and the next
``ln1`` as every block's does.  The prefill scans each mixer from a zero
state and keeps the state after the last token in the layer's cache
entry (``{"h", "conv"}``, the reference's ``return_state``); a decode
step advances it.  A recurrent state has no pages: the paged mode
refuses such a model (``supports_paged_serving`` false), and its int8
copy leaves the mixer at its float weights (the reference's pass touches
``/attn/`` and ``/ffn/`` only).

xlstm (the 'mlstm' and 'slstm' kinds, ``d_ff`` 0, the reference's
``lm.py:252-261, 308-312``): such a block is ``ln1`` and the mixer
(``models.xlstm``) alone, with no ``ln2`` and no FFN, so there is no down
GEMM to fold into: the residual add runs in the compute dtype and the
NEXT norm (the next ``ln1``, or ``final_norm``) as a standalone rmsnorm.
Its cache entry is the mixer's state (the mLSTM's ``{"C", "n", "m",
"conv"}``, the sLSTM's ``{"c", "n", "m", "h"}``), written by the prefill
and replaced by each decode step as an RG-LRU's is.  Every weight is the
mixer's, so the int8 copy quantizes nothing and shares every leaf.

Every weight is held at the config's ``param_dtype``.  A float32 config
(internlm2-1.8b, whisper-small, paligemma-3b, xlstm-350m, the smoke
configs) keeps float32 projections as the master copy, the reference's,
so that its int8 copy is quantized from the reference's values bit for
bit and training updates them; the serving entry points run
``served_blocks`` (and whisper's ``served_encoder``), a copy of the
blocks whose ``wqkv``, ``wo``, MLP projections, cross-attention
``wq``/``wk``/``wv``/``wo`` and recurrent mixers' compute-dtype weights
(``COMPUTE_WEIGHTS``: their projections and conv) are cast once to the
compute dtype (every product multiplies bf16 x bf16), made at the first
serving call and made again only after such a weight changes.  A mixer
holds the weights it multiplies at fp32 (``WIDENED``: the RG-LRU's gates,
the sLSTM's input map) at ``param_dtype``, as the reference does, and the
same copy widens them once where that is narrower (recurrentgemma-9b's
bf16).  The int8 copy holds each mixer as
the served copy does.

Training (``loss``, the reference's ``lm.py:508-521``) is a functional
forward over a dict of the parameters (``train_params``: the fp32 masters,
which autograd differentiates), with no cache and no K/V writes: each
weight is cast to the compute dtype at its use inside the autograd
Functions of ``kernels.autograd`` (K1 with its epilogues, the row norm,
K4), and each block is rematerialized in the backward when ``cfg.remat
== 'full'`` (``torch.utils.checkpoint``).  The loss is
``models.loss.vocab_parallel_xent`` against the tied embedding, with
paligemma's prefix targets ignored and an MoE's ``0.01 * aux /
n_layers`` added.  A recurrent mixer's block is ``h + mixer(xn)`` with
no cache (the reference's ``lm.py:259-265``), its library products and
plain torch under autograd, then the MLP with its fold
(recurrentgemma), or with ``d_ff`` 0 the next norm standalone (xlstm,
``lm.py:305-309``).  A mixer's weights that it multiplies at fp32 but
holds at a narrower ``param_dtype`` (``WIDENED``: recurrentgemma's bf16
gates) are widened at use, as the reference's are, so their gradients
and updates round to that dtype as the reference's do.  Whisper's loss
takes the batch's frames [B, F, D]: the encoder runs first, each of its
blocks rematerialized in the backward whatever ``cfg.remat`` (the
reference's ``jax.checkpoint`` of its encoder scan, ``lm.py:383``), and
its output, computed once, feeds every decoder block's cross-attention
(q and the K/V products of the encoder output ``torch.matmul`` under
autograd, as the reference's einsums lie outside any kernel; K4 'full'
over the F frames, whose backward takes Skv != Sq; ``wo`` through K1).
"""
from __future__ import annotations

import functools
import math
import types
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import autograd as ag
from repro_torch.kernels.quantize import quantize_weight_colwise
from repro_torch.kernels.ref import PAGED_KINDS
from repro_torch.models.attention import (Attention, CrossAttention,
                                          attention_apply, attention_train,
                                          cross_attention_apply,
                                          cross_attention_train)
from repro_torch.models.layers import (mlp_apply, mlp_train, rmsnorm,
                                       sinusoid, vocab_parallel_embed)
from repro_torch.models.loss import (vocab_parallel_logits,
                                     vocab_parallel_xent)
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.rglru import (RGLRU, lru_log_init, rglru_apply,
                                      rglru_cache)
from repro_torch.models import xlstm

# the recurrent mixers: a block of such a kind holds ``mix`` in place of
# ``attn``, and its cache entry is the mixer's state; each kind's module,
# its apply and its zeroed state (cfg, batch, compute dtype, device)
MIXERS = {"rglru": (RGLRU, rglru_apply, rglru_cache),
          "mlstm": (xlstm.MLSTM, xlstm.mlstm_apply, xlstm.mlstm_cache),
          "slstm": (xlstm.SLSTM, xlstm.slstm_apply,
                    lambda cfg, batch, cd, dev: xlstm.slstm_cache(cfg, batch,
                                                                  dev))}


# the paged serving cache: one {"kp", "vp"} pair of page pools a layer
Pools = List[Dict[str, torch.Tensor]]


class Cache(list):
    """The dense cache: one dict per decoder layer, ``{"k", "v"}`` for an
    attention layer or a recurrent layer's state (an RG-LRU's ``{"h",
    "conv"}``, an mLSTM's ``{"C", "n", "m", "conv"}``, an sLSTM's ``{"c",
    "n", "m", "h"}``), and for
    whisper the encoder output [B, F, D] in the compute dtype
    (``enc_out``; the reference's cache entry, ``lm.py:669-672``)."""
    enc_out: Optional[torch.Tensor] = None

    def fork(self) -> "Cache":
        """A cache over the same buffers whose layer dicts are copies: a
        decode step on it writes its K/V slot into the shared buffers (which
        the next step on this cache overwrites) but leaves this cache's
        recurrent states as they were.  The fixed loop's float step for
        degraded lanes runs on a fork, as the reference's discards the
        cache it returns."""
        out = Cache(dict(layer) for layer in self)
        out.enc_out = self.enc_out
        return out


def check_prefill_len(cfg: ArchConfig, s: int) -> None:
    """Raise ValueError where ``cfg``'s prefill cannot take ``s`` tokens:
    a model with mLSTM blocks takes fewer than 64 or a multiple of 64
    (``xlstm.prefill_chunk``, ROADMAP F10)."""
    if "mlstm" in cfg.block_pattern:
        xlstm.prefill_chunk(s)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _mlp_names(cfg: ArchConfig) -> Tuple[str, ...]:
    return ("gate", "up", "down") if cfg.gated_mlp else ("up", "down")


class MLP(nn.Module):
    """``up``/``down`` and, gated, ``gate`` (``weights`` given: the int8
    serving copy's ``QuantizedWeight``s)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, weights: Optional[dict] = None):
        super().__init__()
        self.names = _mlp_names(cfg)
        if weights is not None:
            for name in self.names:
                setattr(self, name, weights[name])
            return
        d, ff = cfg.d_model, cfg.d_ff
        kw = dict(dtype=dtype, device=device)
        for name in self.names:
            shape = (ff, d) if name == "down" else (d, ff)
            setattr(self, name, nn.Parameter(torch.empty(shape, **kw),
                                             requires_grad=False))

    def params(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in self.names}


def _mixer_casts(mix: nn.Module, dtype: torch.dtype
                 ) -> Dict[str, torch.dtype]:
    """The weights of a recurrent mixer that its serving copy at ``dtype``
    casts, each with its serving dtype: the compute-dtype weights
    (``COMPUTE_WEIGHTS``) wider than ``dtype``, and the weights it
    multiplies at fp32 (``WIDENED``) held narrower."""
    f32 = torch.float32
    out = {n: dtype for n in mix.COMPUTE_WEIGHTS
           if getattr(mix, n).dtype.itemsize > dtype.itemsize}
    out.update({n: f32 for n in mix.WIDENED
                if getattr(mix, n).dtype.itemsize < f32.itemsize})
    return out


def _cast_module(mod: nn.Module, casts: Dict[str, torch.dtype]
                 ) -> nn.Module:
    """A copy of ``mod`` whose parameters named in ``casts`` are cast once
    to their dtypes, the others shared; ``mod`` itself where none is."""
    if not casts:
        return mod
    c = type(mod).__new__(type(mod))
    nn.Module.__init__(c)
    for name, p in mod.named_parameters(recurse=False):
        setattr(c, name, nn.Parameter(p.detach().to(casts[name]),
                                      requires_grad=False)
                if name in casts else p)
    return c


def _cast_mixer(mix: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A recurrent mixer's serving copy at ``dtype``: the weights of
    ``_mixer_casts`` cast once, the others shared; the mixer itself where
    none is cast."""
    return _cast_module(mix, _mixer_casts(mix, dtype))


def _narrow(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float weight wider than ``dtype`` cast to it; else the weight."""
    w = w.detach()
    return w.to(dtype) if w.dtype.itemsize > dtype.itemsize else w


def _cast_attn(attn: nn.Module, cfg: ArchConfig,
               dtype: torch.dtype) -> nn.Module:
    """The packed ``wqkv`` and ``wo`` cast once to ``dtype`` where wider."""
    return Attention(cfg, None, None, weights={
        name: _narrow(getattr(attn, name), dtype) for name in ("wqkv", "wo")})


def _cast_mlp(ffn: nn.Module, cfg: ArchConfig,
              dtype: torch.dtype) -> nn.Module:
    """A dense MLP's projections cast once to ``dtype`` where wider."""
    return MLP(cfg, None, None, weights={
        name: _narrow(getattr(ffn, name), dtype) for name in ffn.names})


def _cast_xattn(xattn: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Whisper's cross-attention at ``dtype``: ``wq``/``wk``/``wv``/``wo``
    cast once where wider, so no serving call casts them."""
    return _cast_module(xattn, {
        name: dtype for name, p in xattn.named_parameters(recurse=False)
        if p.dtype.itemsize > dtype.itemsize})


def _norm(cfg: ArchConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(cfg.d_model, dtype=torch.float32,
                                    device=device), requires_grad=False)


class Block(nn.Module):
    """A decoder block of kind ``kind``: an attention block holds ``attn``,
    a recurrent block (``MIXERS``) the mixer ``mix``; whisper's
    (``cfg.encdec``) also holds the cross-attention and its norm ``lnx``,
    an MoE model's (``cfg.moe``) an MoE as its FFN.  With ``d_ff`` 0 (xlstm) a
    block has no ``ln2`` and no FFN."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, kind: str):
        super().__init__()
        self.ln1 = _norm(cfg, device)
        if kind in MIXERS:
            self.mix = MIXERS[kind][0](cfg, dtype, device)
        else:
            self.attn = Attention(cfg, dtype, device)
        if cfg.encdec:
            self.lnx = _norm(cfg, device)
            self.xattn = CrossAttention(cfg, dtype, device)
        if cfg.d_ff > 0:
            self.ln2 = _norm(cfg, device)
            self.ffn = (MoE if cfg.moe else MLP)(cfg, dtype, device)

    @classmethod
    def cast(cls, blk: "Block", cfg: ArchConfig,
             dtype: torch.dtype) -> "Block":
        """The serving copy of ``blk`` at ``dtype``: the packed ``wqkv``,
        ``wo``, the MLP's projections and whisper's cross-attention cast
        once, and a recurrent mixer's ``_cast_mixer`` copy; everything else
        (norm scales, an MoE, the mixers' fp32 maps) shared."""
        c = cls.__new__(cls)
        nn.Module.__init__(c)
        for name, child in blk.named_children():
            setattr(c, name, child)
        c.ln1 = blk.ln1
        if hasattr(blk, "ln2"):
            c.ln2 = blk.ln2
        if cfg.encdec:
            c.lnx = blk.lnx
            c.xattn = _cast_xattn(blk.xattn, dtype)
        if hasattr(blk, "attn"):
            c.attn = _cast_attn(blk.attn, cfg, dtype)
        else:
            c.mix = _cast_mixer(blk.mix, dtype)
        if cfg.d_ff > 0 and not cfg.moe:
            c.ffn = _cast_mlp(blk.ffn, cfg, dtype)
        return c

    @classmethod
    def quantized(cls, blk: "Block", cfg: ArchConfig,
                  dtype: torch.dtype) -> "Block":
        """The int8 serving copy of ``blk``: the packed ``wqkv``, ``wo``
        and the MLP's projections quantized column-wise (from the float
        masters); the norm scales and an MoE (router, experts and any
        shared expert) shared; whisper's cross-attention and every
        recurrent mixer left float (the reference's pass skips ``xattn``,
        an MoE's ``ffn`` and every mixer, ``lm.py:194-208``) and held as
        the served copy at ``dtype``, the compute dtype, holds them
        (``_cast_xattn``, ``_cast_mixer``).  An xLSTM block (a mixer and
        no FFN) has no leaf to quantize."""
        q = cls.__new__(cls)
        nn.Module.__init__(q)
        q.ln1 = blk.ln1
        if cfg.encdec:
            q.lnx, q.xattn = blk.lnx, _cast_xattn(blk.xattn, dtype)
        qw = quantize_weight_colwise
        if hasattr(blk, "mix"):
            q.mix = _cast_mixer(blk.mix, dtype)
        else:
            q.attn = Attention(cfg, None, None, weights={
                "wqkv": qw(blk.attn.wqkv), "wo": qw(blk.attn.wo)})
        if cfg.d_ff > 0:
            q.ln2 = blk.ln2
            q.ffn = blk.ffn if cfg.moe else MLP(cfg, None, None, weights={
                name: qw(getattr(blk.ffn, name)) for name in blk.ffn.names})
        return q


class EncoderBlock(nn.Module):
    """Whisper's encoder block (the reference's ``enc_block``): ``ln1``,
    the packed self-attention, ``ln2`` and the MLP."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.ln1 = _norm(cfg, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = _norm(cfg, device)
        self.ffn = MLP(cfg, dtype, device)

    @classmethod
    def cast(cls, blk: "EncoderBlock", cfg: ArchConfig,
             dtype: torch.dtype) -> "EncoderBlock":
        """``blk`` with its ``wqkv``, ``wo`` and MLP projections cast once
        to ``dtype`` where wider, its norm scales shared."""
        c = cls.__new__(cls)
        nn.Module.__init__(c)
        c.ln1, c.ln2 = blk.ln1, blk.ln2
        c.attn = _cast_attn(blk.attn, cfg, dtype)
        c.ffn = _cast_mlp(blk.ffn, cfg, dtype)
        return c


class Encoder(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.blocks = nn.ModuleList(EncoderBlock(cfg, dtype, device)
                                    for _ in range(cfg.n_enc_layers))
        self.final_norm = _norm(cfg, device)

    @classmethod
    def cast(cls, enc: "Encoder", cfg: ArchConfig,
             dtype: torch.dtype) -> "Encoder":
        """The encoder's serving copy at ``dtype`` (``EncoderBlock.cast``
        of each block), its final norm shared; never quantized (the
        reference's int8 pass skips ``/encoder/``, ``lm.py:202``)."""
        c = cls.__new__(cls)
        nn.Module.__init__(c)
        c.blocks = nn.ModuleList(EncoderBlock.cast(b, cfg, dtype)
                                 for b in enc.blocks)
        c.final_norm = enc.final_norm
        return c


class Model(nn.Module):
    """``Model(cfg)`` lives on the card; ``Model(cfg, device="cpu")`` runs
    the plain PyTorch versions of every kernel."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        for kind in cfg.block_pattern:
            if kind not in PAGED_KINDS and kind not in MIXERS:
                raise NotImplementedError(
                    f"{cfg.name}: block kind {kind!r} is not ported; the "
                    f"port serves the attention kinds {PAGED_KINDS} and the "
                    f"recurrent mixers {tuple(MIXERS)}")
        if not cfg.tie_embeddings:
            raise NotImplementedError(
                f"{cfg.name}: the port serves models with tied embeddings")
        self.cfg = cfg
        self.int8 = False
        self.moe_kept: List[torch.Tensor] = []
        self.device = resolve_device(device)
        self.compute_dtype = _dtype(cfg.compute_dtype)
        dt = _dtype(cfg.param_dtype)
        self.embed = nn.Parameter(
            torch.empty(cfg.padded_vocab(), cfg.d_model, dtype=dt,
                        device=self.device), requires_grad=False)
        self.final_norm = _norm(cfg, self.device)
        self.blocks = nn.ModuleList(
            Block(cfg, dt, self.device, cfg.kind(i))
            for i in range(cfg.n_layers))
        if cfg.encdec:
            self.encoder = Encoder(cfg, dt, self.device)
        # float projections wider than the compute dtype, and a mixer's
        # weights multiplied at fp32 but held narrower, are served from a
        # cast copy (``served_blocks``)
        cd = self.compute_dtype
        self._cast_to = (cd if cd.itemsize < dt.itemsize or any(
            _mixer_casts(b.mix, cd) for b in self.blocks if hasattr(b, "mix"))
            else None)
        self._served: Optional[Tuple[tuple, List[Block],
                                     Optional[Encoder]]] = None

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Model":
        """Seeded init with the reference's schema and scales: norm scales
        and biases zero, the embedding N(0, 1/d), every other weight N(0,
        1/fan_in), the fan-in the second-to-last dim (``param.py:142-145``:
        an expert stack [E, D, F] takes D, a causal conv [cw, W] its width
        cw); an RG-LRU mixer's ``lam`` its ``lru_log`` init, an mLSTM's
        forget bias ``b_f`` ``linspace(3, 6, n_heads)`` and an sLSTM's
        recurrent map ``r`` N(0, 0.05^2) (its ``scale`` overrides the
        fan-in, ``param.py:143-145``); each drawn at fp32 and rounded to
        its parameter's dtype.  Drawn by
        ``torch.Generator`` on the model's device, so it does not reproduce
        the JAX package's bits (``convert.from_jax_params`` carries those
        across)."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, p in self.named_parameters():
            parts = name.split(".")
            leaf = parts[-1]
            # blocks.<i>.mix.<leaf>: a recurrent mixer's weight
            mix = parts[0] == "blocks" and parts[2] == "mix"
            kind = cfg.kind(int(parts[1])) if mix else None
            if mix and kind == "rglru" and leaf == "lam":
                p.copy_(lru_log_init(p.shape, gen, self.device))
                continue
            if mix and kind == "mlstm" and leaf == "b_f":
                p.copy_(torch.linspace(3.0, 6.0, p.shape[0],
                                       dtype=torch.float32))
                continue
            if p.dim() == 1:
                p.zero_()
                continue
            fan_in = cfg.d_model if name == "embed" else p.shape[-2]
            scale = (0.05 if mix and kind == "slstm" and leaf == "r"
                     else 1.0 / math.sqrt(fan_in))
            w = torch.randn(p.shape, generator=gen, device=self.device,
                            dtype=torch.float32).mul_(scale)
            p.copy_(w)
        return self

    @torch.no_grad()
    def quantize_params_for_serving(self, release: bool = False) -> "Model":
        """One-shot int8 weight quantization for serving: a new ``Model``
        whose decoder blocks' packed ``wqkv``, ``wo`` and MLP ``gate``/
        ``up``/``down`` are ``QuantizedWeight``s (int8 values stored once
        transposed, [N, K], the K-major operand of K2's s8 wgmma; one f32
        scale per output column) and which shares this model's embedding
        and norm scales (the tied head keeps full precision for the
        logits) and an MoE model's FFN (only ``wqkv`` and ``wo`` are
        quantized, ``lm.py:194-208``); whisper's encoder and
        cross-attention stay float (the reference's pass skips
        ``/encoder/`` and ``/xattn/``, ``lm.py:202``), held as the served
        copy holds them (cast once to the compute dtype), as are the
        recurrent mixers.  Idempotent: an int8 model returns itself.

        ``release``: quantize this model in place, block by block, each
        block's float projections dropped as soon as its int8 copy exists
        (the reference's engine replaces the float weights,
        ``serve/engine.py:240-248``).  The peak is then the float model
        plus one block's int8 copy, and this model, returned, is the int8
        one: nothing serves the float weights afterwards."""
        if self.int8:
            return self
        cd = self.compute_dtype
        encoder = (Encoder.cast(self.encoder, self.cfg, cd)
                   if self.cfg.encdec else None)
        if release:
            self._served = None
            for i in range(len(self.blocks)):
                self.blocks[i] = Block.quantized(self.blocks[i], self.cfg,
                                                 cd)
            if encoder is not None:
                self.encoder = encoder
            self.int8 = True
            return self
        q = Model.__new__(Model)
        nn.Module.__init__(q)
        q.cfg, q.int8, q.device = self.cfg, True, self.device
        q.compute_dtype = self.compute_dtype
        q.embed, q.final_norm = self.embed, self.final_norm
        q.blocks = nn.ModuleList(Block.quantized(b, self.cfg, cd)
                                 for b in self.blocks)
        if encoder is not None:
            q.encoder = encoder
        return q

    def _projections(self):
        for blk in self.blocks:
            if hasattr(blk, "attn"):
                yield blk.attn.wqkv
                yield blk.attn.wo
            else:
                for name in blk.mix.COMPUTE_WEIGHTS + blk.mix.WIDENED:
                    yield getattr(blk.mix, name)
            if isinstance(getattr(blk, "ffn", None), MLP):
                yield from blk.ffn.params().values()
            if hasattr(blk, "xattn"):
                yield from blk.xattn.parameters()
        for blk in (self.encoder.blocks if self.cfg.encdec else ()):
            yield blk.attn.wqkv
            yield blk.attn.wo
            yield from blk.ffn.params().values()

    def _served_copy(self):
        """``(key, blocks, encoder)`` at the compute dtype, made once and
        kept while no projection weight changes (each weight's identity
        and version counter)."""
        key = tuple((id(w), w._version) for w in self._projections())
        if self._served is None or self._served[0] != key:
            self._served = None     # the old copy goes before the new one
            cfg, cd = self.cfg, self._cast_to
            self._served = (key, [Block.cast(b, cfg, cd)
                                  for b in self.blocks],
                            Encoder.cast(self.encoder, cfg, cd)
                            if cfg.encdec else None)
        return self._served

    def served_blocks(self) -> List[Block]:
        """The blocks the serving entry points run: ``self.blocks``, or,
        where the float projections are wider than the compute dtype
        (internlm2-1.8b, whisper-small, paligemma-3b, xlstm-350m and the
        smoke configs: float32 masters, bf16 compute) or a mixer holds
        weights it multiplies at fp32 narrower (recurrentgemma-9b's bf16
        gates), ``Block.cast`` copies at the compute dtype.  The copy is
        made once and kept while no projection weight changes, so a step
        reads the weights at the dtypes it multiplies them at and casts
        nothing."""
        if self.int8 or getattr(self, "_cast_to", None) is None:
            return list(self.blocks)
        return self._served_copy()[1]

    def served_encoder(self) -> "Encoder":
        """Whisper's encoder as ``encode`` runs it: ``self.encoder``, or
        its ``Encoder.cast`` copy at the compute dtype where its
        projections are wider, made and kept with ``served_blocks``'."""
        if self.int8 or getattr(self, "_cast_to", None) is None:
            return self.encoder
        return self._served_copy()[2]

    @property
    def supports_paged_serving(self) -> bool:
        """The paged scheduler serves single-device decoder stacks of the
        attention kinds K6 takes ('global', 'local', 'chunked'); a
        recurrent mixer carries a dense state with no page indirection,
        and an encoder-decoder or a prefix-LM prefills through extra inputs
        (the frames, the patches) the chunk loop does not model, so
        engines take the fixed loop for them (the reference's
        ``lm.py:556-565``)."""
        cfg = self.cfg
        return not cfg.encdec and not cfg.prefix_tokens and all(
            kind in PAGED_KINDS for kind in cfg.block_pattern)

    def _theta(self, kind: str) -> float:
        cfg = self.cfg
        if kind == "global" and cfg.rope_theta_global:
            return cfg.rope_theta_global
        return cfg.rope_theta

    # -- cache -----------------------------------------------------------------

    def new_cache(self, batch: int, max_len: int) -> Cache:
        """Zeroed dense K/V caches in bf16, one dict per layer (the
        reference's ``cache_defs``): [B, max_len, KV, hd] for a global
        layer, a ring buffer of min(window, max_len) slots for a local or
        chunked one; a recurrent layer's zeroed state (``rglru_cache``,
        ``xlstm.mlstm_cache``, ``xlstm.slstm_cache``; a conv context in
        the compute dtype), which the prefill writes."""
        cfg, cd, dev = self.cfg, self.compute_dtype, self.device
        kw = dict(dtype=torch.bfloat16, device=dev)
        out = Cache()
        for i in range(cfg.n_layers):
            if cfg.kind(i) in MIXERS:
                out.append(MIXERS[cfg.kind(i)][2](cfg, batch, cd, dev))
                continue
            slots = (min(cfg.window, max_len)
                     if cfg.kind(i) in ("local", "chunked") else max_len)
            shape = (batch, slots, cfg.n_kv_heads, cfg.hd)
            out.append({"k": torch.zeros(shape, **kw),
                        "v": torch.zeros(shape, **kw)})
        return out

    def new_paged_cache(self, n_pages: int, page_size: int) -> Pools:
        """Zeroed K/V page pools ``[n_pages + 1, page_size, KV, hd]`` bf16,
        one pair per layer, shared by every lane through the page table;
        row ``n_pages`` is the trash page (written by idle lanes and padded
        chunk tails, never read unmasked).  A model the scheduler cannot
        serve (``supports_paged_serving``) raises, as the reference's
        ``paged_cache_defs`` does."""
        if not self.supports_paged_serving:
            raise ValueError(
                f"paged serving needs a decoder of attention blocks only "
                f"(no recurrent mixers, encoder-decoder or prefix-LM); "
                f"{self.cfg.name} has the pattern "
                f"{self.cfg.block_pattern}")
        cfg = self.cfg
        shape = (n_pages + 1, page_size, cfg.n_kv_heads, cfg.hd)
        kw = dict(dtype=torch.bfloat16, device=self.device)
        return [{"kp": torch.zeros(shape, **kw),
                 "vp": torch.zeros(shape, **kw)}
                for _ in range(cfg.n_layers)]

    # -- forward ----------------------------------------------------------------

    def _block(self, blk: Block, kind: str, h, xn, next_scale, *, positions,
               cache, pos, page_table, enc_out=None):
        cfg, cd = self.cfg, self.compute_dtype
        if kind in MIXERS:
            if page_table is not None:
                raise NotImplementedError(
                    f"{cfg.name}: a recurrent ({kind}) state has no pages; "
                    f"serve it through the fixed loop")
            out = MIXERS[kind][1](blk.mix, xn, cfg, cd, cache,
                                  decode=pos is not None)
        else:
            out = attention_apply(blk.attn, xn, cfg, cd, kind=kind,
                                  theta=self._theta(kind),
                                  positions=positions, cache=cache, pos=pos,
                                  page_table=page_table,
                                  use_rope=not cfg.encdec)
        h = h + out
        if enc_out is not None:
            # cross-attention, added outside any GEMM (lm.py:272-287)
            xx = rmsnorm(h, blk.lnx, cfg.norm_eps)
            h = h + cross_attention_apply(blk.xattn, xx, enc_out, cfg, cd,
                                          decode=pos is not None)
        if cfg.d_ff == 0:
            # an xLSTM block has no FFN: the next norm runs standalone
            # (lm.py:308-312)
            return h, rmsnorm(h, next_scale, cfg.norm_eps)
        xn2 = rmsnorm(h, blk.ln2, cfg.norm_eps)
        if cfg.moe:
            # the routed path: no GEMM epilogue to fold into, so the
            # residual add and the next norm run standalone (lm.py:291-297)
            y = moe_apply(blk.ffn, xn2, cfg, cd)
            self.moe_kept.append(y.kept)
            h = h + y.out
            return h, rmsnorm(h, next_scale, cfg.norm_eps)
        return mlp_apply(blk.ffn.params(), xn2, cd, residual=h,
                         norm_scale=next_scale, norm_eps=cfg.norm_eps,
                         gated=cfg.gated_mlp)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder over frame embeddings [B, F, D] (the
        reference's ``_encode``, ``lm.py:363-385``) -> [B, F, D] in the
        compute dtype: the frames plus sinusoidal positions, per block a
        standalone rmsnorm, the 'full' self-attention (K4, no RoPE), the
        residual add, a standalone rmsnorm, the plain GELU MLP (K1's gelu
        up GEMM, a down GEMM with no epilogue), the residual add in the
        compute dtype; then the final rmsnorm."""
        cfg, cd = self.cfg, self.compute_dtype
        f = frames.shape[1]
        h = frames.to(self.device).to(cd) + sinusoid(0, f, cfg.d_model, cd,
                                                      self.device)
        positions = torch.arange(f, device=self.device)
        encoder = self.served_encoder()
        for blk in encoder.blocks:
            x = rmsnorm(h, blk.ln1, cfg.norm_eps)
            h = h + attention_apply(blk.attn, x, cfg, cd, kind="full",
                                    theta=cfg.rope_theta,
                                    positions=positions, cache=None,
                                    use_rope=False)
            x2 = rmsnorm(h, blk.ln2, cfg.norm_eps)
            h = h + mlp_apply(blk.ffn.params(), x2, cd, gated=cfg.gated_mlp)
        return rmsnorm(h, encoder.final_norm, cfg.norm_eps)

    def forward(self, tokens: torch.Tensor, *, cache: Cache,
                pos: Optional[int] = None,
                positions: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S].  With ``page_table`` [B, P]: paged serving, the
        cache is the page pools and ``positions`` [B, S] holds per-token
        positions (-1 = inactive).  Otherwise ``pos`` None is prefill (the
        dense cache is filled from slot 0), else one decode token at
        position ``pos``.  Whisper's decoder attends ``enc_out`` [B, F, D]
        in every block; paligemma's prefill puts ``patches`` [B, P, D] in
        front of the tokens.  Returns the final-normed stream [B, P + S,
        D]."""
        cfg, cd = self.cfg, self.compute_dtype
        h = vocab_parallel_embed(self.embed, tokens, cd)
        # the sqrt(d) multiplier is rounded to the compute dtype first
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=cd,
                             device=h.device)
        if patches is not None:
            # the patches in front, cast and not scaled (lm.py:352-355)
            h = torch.cat([patches.to(h.device).to(cd), h], dim=1)
        if cfg.encdec:
            # sinusoidal positions from the first token's (lm.py:356-360)
            h = h + sinusoid(0 if pos is None else pos, tokens.shape[1],
                             cfg.d_model, cd, h.device)
        if page_table is None:
            positions = (torch.arange(h.shape[1], device=h.device)
                         if pos is None
                         else torch.tensor([pos], device=h.device))
        blocks = self.served_blocks()
        xn = rmsnorm(h, blocks[0].ln1, cfg.norm_eps)
        self.moe_kept = []
        for i, blk in enumerate(blocks):
            nxt = (blocks[i + 1].ln1 if i + 1 < len(blocks)
                   else self.final_norm)
            h, xn = self._block(blk, cfg.kind(i), h, xn, nxt,
                                positions=positions,
                                cache=cache[i], pos=pos,
                                page_table=page_table, enc_out=enc_out)
        return xn  # the last block's fold produced rmsnorm(h, final_norm)

    # -- training -------------------------------------------------------------------

    def train_params(self) -> Dict[str, torch.Tensor]:
        """The parameters as the training step takes them (the reference's
        ``init_params`` tree, by the port's names): each tensor of the
        model, sharing its storage and version counter, as a leaf that
        requires grad, at its own dtype (the fp32 masters of a float32
        config).  An optimizer step that updates them in place updates the
        model, and ``served_blocks`` casts them again."""
        if self.int8:
            raise ValueError("the int8 serving copy is not trained")
        return {name: p.detach().requires_grad_(True)
                for name, p in self.named_parameters()}

    def _mixer_train(self, params: Dict[str, torch.Tensor], i: int,
                     xn: torch.Tensor) -> torch.Tensor:
        """Block ``i``'s recurrent mixer on the normed stream with
        gradients: its apply with no cache (the reference's
        ``mode="train"``) on its parameters' leaves."""
        p = f"blocks.{i}.mix."
        mix = types.SimpleNamespace(**{
            k[len(p):]: v for k, v in params.items() if k.startswith(p)})
        return MIXERS[self.cfg.kind(i)][1](mix, xn, self.cfg,
                                           self.compute_dtype, None, False)

    def _train_block(self, params: Dict[str, torch.Tensor], i: int,
                     positions: torch.Tensor, h: torch.Tensor,
                     xn: torch.Tensor, next_scale: torch.Tensor,
                     enc_out: Optional[torch.Tensor] = None):
        """Block ``i`` of the training forward: ``(h, rmsnorm(h,
        next_scale), aux)``, the serving block's arithmetic with gradients
        (``attention_train`` or a recurrent mixer, whisper's
        ``cross_attention_train`` over ``enc_out`` after its standalone
        ``lnx``, ``mlp_train``; an MoE's ``moe_apply`` and the standalone
        norm after it; with ``d_ff`` 0 the standalone norm alone)."""
        cfg, cd = self.cfg, self.compute_dtype
        kind, p = cfg.kind(i), f"blocks.{i}."
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        if kind in MIXERS:
            h = h + self._mixer_train(params, i, xn)
        else:
            h = h + attention_train(params[p + "attn.wqkv"],
                                    params[p + "attn.wo"], xn, cfg, cd,
                                    kind=kind, theta=self._theta(kind),
                                    positions=positions,
                                    use_rope=not cfg.encdec)
        if enc_out is not None:
            # cross-attention, added outside any GEMM (lm.py:272-287)
            xx = ag.rmsnorm(h, params[p + "lnx"], cfg.norm_eps)
            h = h + cross_attention_train(
                *(params[p + "xattn." + n] for n in ("wq", "wk", "wv", "wo")),
                xx, enc_out, cfg, cd)
        if cfg.d_ff == 0:
            # an xLSTM block has no FFN: the next norm runs standalone
            return h, ag.rmsnorm(h, next_scale, cfg.norm_eps), zero
        xn2 = ag.rmsnorm(h, params[p + "ln2"], cfg.norm_eps)
        if cfg.moe:
            ffn = types.SimpleNamespace(**{
                k[len(p) + 4:]: v for k, v in params.items()
                if k.startswith(p + "ffn.")})
            y = moe_apply(ffn, xn2, cfg, cd)
            h = h + y.out
            return h, ag.rmsnorm(h, next_scale, cfg.norm_eps), y.aux
        h, xn = mlp_train({n: params[p + "ffn." + n] for n in
                           _mlp_names(cfg)}, xn2, cd, residual=h,
                          norm_scale=next_scale, norm_eps=cfg.norm_eps,
                          gated=cfg.gated_mlp)
        return h, xn, zero

    def _train_encoder_block(self, params: Dict[str, torch.Tensor], i: int,
                             h: torch.Tensor) -> torch.Tensor:
        """Encoder block ``i`` with gradients: ``encode``'s block (the
        standalone ``ln1``, the 'full' self-attention with no RoPE, the
        residual, the standalone ``ln2``, the plain GELU MLP with no fold,
        the residual) through ``kernels.autograd``."""
        cfg, cd = self.cfg, self.compute_dtype
        p = f"encoder.blocks.{i}."
        x = ag.rmsnorm(h, params[p + "ln1"], cfg.norm_eps)
        h = h + attention_train(params[p + "attn.wqkv"], params[p + "attn.wo"],
                                x, cfg, cd, kind="full", theta=cfg.rope_theta,
                                positions=None, use_rope=False)
        x2 = ag.rmsnorm(h, params[p + "ln2"], cfg.norm_eps)
        return h + mlp_train({n: params[p + "ffn." + n]
                              for n in _mlp_names(cfg)}, x2, cd,
                             gated=cfg.gated_mlp)

    def train_encode(self, params: Dict[str, torch.Tensor],
                     frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder with gradients (the reference's ``_encode``,
        ``lm.py:363-385``): frames [B, F, D] -> [B, F, D] in the compute
        dtype, ``encode``'s arithmetic, each block recomputed in the
        backward whatever ``cfg.remat`` (the reference's
        ``jax.checkpoint(body)``)."""
        cfg, cd, dev = self.cfg, self.compute_dtype, self.device
        if frames is None or frames.dim() != 3 or \
                frames.shape[2] != cfg.d_model:
            raise ValueError(f"{cfg.name} trains from frames [B, F, "
                             f"{cfg.d_model}]")
        f = frames.shape[1]
        h = frames.to(dev).to(cd) + sinusoid(0, f, cfg.d_model, cd, dev)
        for i in range(cfg.n_enc_layers):
            h = checkpoint(functools.partial(self._train_encoder_block,
                                             params, i), h,
                           use_reentrant=False)
        return ag.rmsnorm(h, params["encoder.final_norm"], cfg.norm_eps)

    def train_forward(self, params: Dict[str, torch.Tensor],
                      tokens: torch.Tensor,
                      patches: Optional[torch.Tensor] = None,
                      frames: Optional[torch.Tensor] = None):
        """The training forward (the reference's ``forward(mode='train')``):
        tokens [B, S] (and paligemma's patches [B, P, D] in front; whisper's
        frames [B, F, D] through ``train_encode`` first) ->
        ``(rmsnorm(h, final_norm) [B, P + S, D], aux)``, ``aux`` the sum of
        the MoE layers' load-balancing losses.  No cache, no K/V writes;
        under ``cfg.remat == 'full'`` each block is recomputed in the
        backward (``torch.utils.checkpoint``), so a block's activations
        live only while its gradient is taken.  Whisper's encoder output is
        computed once and held while every decoder block (and its
        recomputation) reads it."""
        cfg, cd = self.cfg, self.compute_dtype
        dev = self.device
        enc_out = self.train_encode(params, frames) if cfg.encdec else None
        h = ag.embed(params["embed"], tokens.to(dev), cd)
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=cd, device=dev)
        if cfg.prefix_tokens:
            h = torch.cat([patches.to(dev).to(cd), h], dim=1)
        if cfg.encdec:
            # sinusoidal positions from 0 (lm.py:356-360)
            h = h + sinusoid(0, h.shape[1], cfg.d_model, cd, dev)
        positions = torch.arange(h.shape[1], device=dev)
        xn = ag.rmsnorm(h, params["blocks.0.ln1"], cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(cfg.n_layers):
            nxt = (params[f"blocks.{i + 1}.ln1"] if i + 1 < cfg.n_layers
                   else params["final_norm"])
            block = functools.partial(self._train_block, params, i,
                                      positions, enc_out=enc_out)
            if cfg.remat == "full":
                h, xn, a = checkpoint(block, h, xn, nxt, use_reentrant=False)
            else:
                h, xn, a = block(h, xn, nxt)
            aux = aux + a
        return xn, aux

    def loss(self, params: Dict[str, torch.Tensor],
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The training loss of a batch (``tokens``, ``targets`` [B, S], and
        paligemma's ``patches`` or whisper's ``frames``), the reference's
        ``Model.loss``: the mean
        NLL of the targets against the tied embedding
        (``vocab_parallel_xent``, the final softcap), paligemma's patch
        positions ignored (targets -1), plus ``0.01 * aux / n_layers`` for
        an MoE."""
        cfg = self.cfg
        h, aux = self.train_forward(params, batch["tokens"],
                                    batch.get("patches"), batch.get("frames"))
        targets = batch["targets"].to(self.device)
        if cfg.prefix_tokens:
            ignore = torch.full((targets.shape[0], cfg.prefix_tokens), -1,
                                dtype=targets.dtype, device=self.device)
            targets = torch.cat([ignore, targets], dim=1)
        nll = vocab_parallel_xent(h, params["embed"], targets,
                                  final_softcap=cfg.final_softcap)
        if cfg.moe:
            nll = nll + 0.01 * aux / cfg.n_layers
        return nll

    # -- entry points -------------------------------------------------------------

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None,
                frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """tokens [B, S] -> (last-token logits [B, Vp] fp32, cache with
        ``max_len`` slots).  Whisper takes its clips' frame embeddings
        ``frames`` [B, F, D]: the encoder runs here and its output is held
        in the cache (``Cache.enc_out``) for the decode steps.  paligemma
        takes its images' patch embeddings ``patches`` [B, P, D], P =
        ``prefix_tokens``: the prompt is P + S positions long, and the
        first decode step is at position P + S.  A model with mLSTM
        blocks takes S below 64 or a multiple of 64 (ROADMAP F10) and
        raises ValueError on other lengths before it computes anything."""
        cfg = self.cfg
        b, s = tokens.shape
        check_prefill_len(cfg, s)
        p = cfg.prefix_tokens
        if p:
            if patches is None or tuple(patches.shape) != (b, p, cfg.d_model):
                raise ValueError(f"{cfg.name} prefills from patches "
                                 f"[{b}, {p}, {cfg.d_model}]")
        elif patches is not None:
            raise ValueError(f"{cfg.name} has no prefix for patches")
        cache = self.new_cache(b, max(max_len or p + s, p + s, 1))
        if cfg.encdec:
            if frames is None or frames.shape[0] != b:
                raise ValueError(f"{self.cfg.name} prefills from frames "
                                 f"[{b}, F, {self.cfg.d_model}]")
            cache.enc_out = self.encode(frames)
        elif frames is not None:
            raise ValueError(f"{self.cfg.name} has no encoder for frames")
        h = self.forward(tokens.to(self.device), cache=cache,
                         enc_out=cache.enc_out, patches=patches)
        logits = vocab_parallel_logits(h[:, -1:], self.embed,
                                       self.cfg.final_softcap)
        return logits[:, 0], cache

    @torch.inference_mode()
    def decode_step(self, cache: Cache, token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Cache]:
        """token [B, 1] at position ``pos`` -> (logits [B, Vp] fp32, cache
        updated in place).  Whisper's cross-attention reads the encoder
        output held in the cache."""
        h = self.forward(token.to(self.device), cache=cache, pos=int(pos),
                         enc_out=cache.enc_out)
        logits = vocab_parallel_logits(h, self.embed, self.cfg.final_softcap)
        return logits[:, 0], cache

    @torch.inference_mode()
    def decode_step_paged(self, cache: Pools, token: torch.Tensor,
                          positions: torch.Tensor, page_table: torch.Tensor
                          ) -> Tuple[torch.Tensor, Pools]:
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
    def prefill_chunk(self, cache: Pools, tokens: torch.Tensor,
                      positions: torch.Tensor, page_table: torch.Tensor,
                      last_idx: torch.Tensor) -> Tuple[torch.Tensor, Pools]:
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
