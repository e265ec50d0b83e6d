"""Serving logits against the tied embedding (single device)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ref import softcap_scores

# embedding rows upcast at a time: the fp32 temporary is VOCAB_SLICE x D
# (604 MB at gemma2's D = 4608) where the whole upcast would be Vp x D
# (4.7 GB at its vocab of 256000)
VOCAB_SLICE = 32768


def vocab_parallel_logits(h: torch.Tensor, head: torch.Tensor,
                          final_softcap: Optional[float] = None
                          ) -> torch.Tensor:
    """[B, S, D] -> [B, S, Vp].  ``h`` is promoted to fp32 (f64 stays f64)
    against the embedding, as the reference does, one slice of
    ``VOCAB_SLICE`` embedding rows at a time (each logit is its own dot
    product, so slicing the vocabulary changes no product, only the size
    of the upcast temporary); the plain product is left to
    ``torch.matmul`` (fp32, TF32 off).  ``final_softcap`` caps the logits
    (``softcap * tanh(logits / softcap)``)."""
    lt = torch.promote_types(h.dtype, torch.float32)
    hl = h.to(lt)
    logits = torch.cat([torch.matmul(hl, head[v0:v0 + VOCAB_SLICE].to(lt).t())
                        for v0 in range(0, head.shape[0], VOCAB_SLICE)],
                       dim=-1)
    return softcap_scores(logits, final_softcap)
