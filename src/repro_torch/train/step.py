"""The training step, the port of the reference's ``train/step.py`` on one
device: the loss and its gradients (``Model.loss`` through the autograd
Functions of ``kernels.autograd``), accumulated over ``microbatches``
slices of the batch in ``cfg.grad_accum_dtype`` and divided by their
count, then AdamW (``optim.adamw_update``, in place).  The step runs with
TF32 off (``layers.full_fp32``): its fp32 products (the logits against the
tied embedding, an MoE's router) are full fp32, as the reference's are on
the CPU.  No shardings: the multi-device step is a later slice."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models.layers import full_fp32
from repro_torch.models.lm import Model
from repro_torch.optim import AdamWConfig, adamw_update, global_norm


def loss_and_grads(model: Model, params: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor]):
    """``(loss, grads)`` of one (micro)batch."""
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatches: Optional[int] = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``; with ``microbatches`` > 1 (default
    ``model.cfg.microbatches``) the batch's rows are split into that many
    microbatches, one backward at a time (peak activation memory divided
    by their count)."""
    n_micro = microbatches if microbatches is not None \
        else model.cfg.microbatches

    def train_step(params: Dict[str, torch.Tensor], opt_state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]):
        with full_fp32():
            if n_micro <= 1:
                loss, grads = loss_and_grads(model, params, batch)
            else:
                rows = next(iter(batch.values())).shape[0]
                if rows % n_micro:
                    raise ValueError(f"a batch of {rows} rows does not split "
                                     f"into {n_micro} microbatches")
                per = rows // n_micro
                acc_dt = getattr(torch, model.cfg.grad_accum_dtype)
                grads = {k: torch.zeros(p.shape, dtype=acc_dt,
                                        device=p.device)
                         for k, p in params.items()}
                loss = 0.0
                for i in range(n_micro):
                    mb = {k: v[i * per:(i + 1) * per]
                          for k, v in batch.items()}
                    lm, gm = loss_and_grads(model, params, mb)
                    for k, g in gm.items():
                        grads[k].add_(g.to(acc_dt))
                    loss = loss + lm
                    del gm
                loss = loss / n_micro
                grads = {k: g / n_micro for k, g in grads.items()}
            gnorm = global_norm(grads[k] for k in params)
            params, opt_state = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
