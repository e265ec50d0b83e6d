"""Serving logits and the training loss against the tied embedding
(single device)."""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ref import softcap_scores
from repro_torch.models.layers import full_fp32

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


def _chunk_nll(hc: torch.Tensor, head: torch.Tensor, tgt: torch.Tensor,
               final_softcap: Optional[float]):
    """(sum of the kept tokens' NLL, their count) of one chunk: fp32 logits
    [B, C, Vp] (TF32 off; f64 for an f64 ``hc``), the final softcap, the
    log-sum-exp with the max held out of the gradient, targets < 0
    ignored."""
    vocab = head.shape[0]
    lt = torch.promote_types(hc.dtype, torch.float32)
    with full_fp32():
        logits = torch.matmul(hc.to(lt), head.to(lt).t())
    logits = softcap_scores(logits, final_softcap)
    mx = torch.amax(logits.detach(), dim=-1)
    se = torch.sum(torch.exp(logits - mx[..., None]), dim=-1)
    lse = mx + torch.log(se)
    ok = (tgt >= 0) & (tgt < vocab)
    tl = torch.gather(logits, -1, torch.clamp(tgt, 0, vocab - 1).long()
                      [..., None])[..., 0] * ok.to(lt)
    w = (tgt >= 0).to(lt)
    return torch.sum((lse - tl) * w), torch.sum(w)


def vocab_parallel_xent(h: torch.Tensor, head: torch.Tensor,
                        targets: torch.Tensor, *, chunk: int = 512,
                        final_softcap: Optional[float] = None
                        ) -> torch.Tensor:
    """Mean NLL over the tokens whose target is >= 0 (0-d fp32), the
    reference's ``vocab_parallel_xent`` on one device: ``h`` [B, S, D]
    against every row of the (padded) ``head`` [Vp, D], in chunks of
    ``min(chunk, S)`` positions (S a multiple of it), each chunk's logits
    recomputed in the backward (``torch.utils.checkpoint``), so the [B, S,
    Vp] logits never exist; the chunks' sums are added in order (f64 for
    an f64 ``h``)."""
    s = h.shape[1]
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    lt = torch.promote_types(h.dtype, torch.float32)
    nll = torch.zeros((), dtype=lt, device=h.device)
    w = torch.zeros((), dtype=lt, device=h.device)
    for c0 in range(0, s, chunk):
        cn, cw = checkpoint(_chunk_nll, h[:, c0:c0 + chunk], head,
                            targets[:, c0:c0 + chunk], final_softcap,
                            use_reentrant=False)
        nll = nll + cn
        w = w + cw
    return nll / torch.clamp(w, min=1.0)
