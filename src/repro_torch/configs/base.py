"""Architecture configuration schema (the dense decoders, the MoE decoder,
the encoder-decoder, the prefix-LM, the RG-LRU hybrid and xLSTM the port
serves).  A copy of the JAX package's ``ArchConfig`` fields that the
serving and training paths read; the port never imports that package."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # cycled over layers: 'global', 'local' (sliding window) or 'chunked'
    # (llama4: causal within chunks of ``window`` positions) attention, or
    # a recurrent mixer: 'rglru' (recurrentgemma), 'mlstm' or 'slstm'
    # (xlstm)
    block_pattern: Tuple[str, ...] = ("global",)
    window: int = 1024           # local/chunked attention window
    attn_softcap: Optional[float] = None   # gemma2 attention logit softcap
    final_softcap: Optional[float] = None  # gemma2 final logit softcap
    rope_theta: float = 10_000.0
    rope_theta_global: Optional[float] = None  # gemma3 dual-theta
    # MoE (llama4): every block's FFN is a routed MoE of n_experts, top_k
    # of them a token, with a shared expert beside them
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_shared_expert: bool = False
    capacity_factor: float = 1.25
    gated_mlp: bool = True
    # encoder-decoder (whisper): an encoder of n_enc_layers bidirectional
    # blocks over enc_frames (stubbed) frame embeddings a clip, and
    # cross-attention in every decoder block
    encdec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500
    # VLM prefix (paligemma): prefix_tokens (stubbed) patch embeddings
    # [B, prefix_tokens, d_model] in front of the text tokens
    prefix_tokens: int = 0
    # RG-LRU (recurrentgemma): the recurrence's width (None: d_model) and
    # its causal conv's width
    lru_width: Optional[int] = None
    conv_width: int = 4
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # float32 is the reference's training master copy: the port holds every
    # weight at it and serves the projections from a copy at the compute
    # dtype (``models.lm.Model.served_blocks``)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # training (the reference's base.py:64-72): AdamW's moments at fp32 or
    # int8, per-block rematerialization ('none' | 'full'), the gradient-
    # accumulation microbatches of a step and their accumulator's dtype
    opt_state_mode: str = "fp32"
    remat: str = "full"
    microbatches: int = 1
    grad_accum_dtype: str = "float32"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    def padded_vocab(self, multiple: int = 128) -> int:
        return multiple * math.ceil(self.vocab / multiple)

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.pattern_period

    @property
    def tail_blocks(self) -> Tuple[str, ...]:
        """Remainder layers when n_layers % pattern_period != 0."""
        return self.block_pattern[:self.n_layers % self.pattern_period]

    def kind(self, layer: int) -> str:
        """Attention kind of layer ``layer``: the pattern, cycled."""
        return self.block_pattern[layer % self.pattern_period]

    def param_count(self) -> int:
        """Parameters of the decoder with tied embeddings, and of the
        encoder for ``encdec``, by the reference's count (whose decoder
        blocks leave out the cross-attention and its norm; an MoE block's
        FFN is its experts, router and shared expert; an RG-LRU mixer's
        two [w, w] gates and its decay count ``3 * w``, ROADMAP F8; an
        mLSTM's three [2d, 2d] q/k/v count ``3 (2d)^2 / 4`` and its block
        one norm, an sLSTM leaves out its ``out`` [d, d], ROADMAP F9)."""
        d, cw = self.d_model, self.conv_width
        attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
        if self.moe:
            mlp = (self.n_experts + self.moe_shared_expert) * mlp \
                + d * self.n_experts
        w = self.lru_width or d
        block = {
            "rglru": 3 * d * w + cw * w + 3 * w + mlp + 2 * d,
            # the mLSTM's w is 2d
            "mlstm": (2 * d * 2 * d + 3 * (2 * d) ** 2 // 4 + 2 * d * d
                      + cw * 2 * d + 4 * 2 * d + d),
            "slstm": (4 * d * d + 4 * d + 4 * d * d // max(1, self.n_heads)
                      + mlp + 2 * d),
        }
        total = self.padded_vocab() * d + d + sum(
            block.get(self.kind(i), attn + mlp + 2 * d)
            for i in range(self.n_layers))
        if self.encdec:
            total += self.n_enc_layers * (attn + d + 2 * d * self.d_ff
                                          + 2 * d)
        return total
