"""Serving logits against the tied embedding (single device)."""
from __future__ import annotations

import torch


def vocab_parallel_logits(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """[B, S, D] -> [B, S, Vp].  ``h`` is promoted to fp32 (f64 stays f64)
    against the embedding, as the reference does; this plain product is
    left to ``torch.matmul`` (fp32, TF32 off)."""
    lt = torch.promote_types(h.dtype, torch.float32)
    return torch.matmul(h.to(lt), head.to(lt).t())
