"""Architecture configuration schema (the dense-decoder subset the port
serves).  A copy of the JAX package's ``ArchConfig`` fields that the
fixed-batch serving path reads; the port never imports that package."""
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
    block_pattern: Tuple[str, ...] = ("global",)
    rope_theta: float = 10_000.0
    gated_mlp: bool = True
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

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

    def param_count(self) -> int:
        """Parameters of the dense gated decoder with tied embeddings."""
        d = self.d_model
        attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
        return (self.padded_vocab() * d + d
                + self.n_layers * (attn + mlp + 2 * d))
