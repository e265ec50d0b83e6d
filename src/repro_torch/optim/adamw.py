"""AdamW with fp32 or int8 (row-quantized) moment states, the port of the
reference's ``optim/adamw.py``.

The update is the reference's step for step: the global grad norm at
fp32, clipping by ``grad_clip``, the bias corrections, ``m / bc1 /
(sqrt(v / bc2) + eps)`` and the decoupled weight decay on the fp32 value
of the parameter, written back at the parameter's dtype.  The int8 mode
stores each moment as int8 with one fp32 scale per trailing row
(``{"q", "s"}``), dequantizes, updates at fp32 and requantizes each step;
``v`` is stored as sqrt(v) (the sqrt codec: linear int8 would round small
second moments to zero and ``m / (sqrt(0) + eps)`` would explode).  The
reference always runs the update inside ``jax.jit``, where XLA turns the
codec's ``/ 127.0`` into a multiply by the rounded reciprocal (ROADMAP
F4); ``_q8`` follows that compiled form, so the codec is bitwise the
reference's.

Unlike the reference, which returns new arrays, ``adamw_update`` updates
the parameter and moment tensors in place (one leaf's fp32 temporaries at
a time, the memory the reference's optimization barriers buy) and returns
the same trees.  Parameters and states are dicts keyed by the port's
parameter names (``Model.train_params``); ``convert`` carries the state
to and from the reference's tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_mode: str = "fp32"     # 'fp32' | 'int8'
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __post_init__(self):
        if self.state_mode not in ("fp32", "int8"):
            raise ValueError(f"state_mode must be 'fp32' or 'int8', got "
                             f"{self.state_mode!r}")


# -- int8 moment codecs -------------------------------------------------------

def _q8(x: torch.Tensor, sqrt_scale: bool = False) -> Dict[str, torch.Tensor]:
    """Row-wise int8 of an fp32 ``x`` (``sqrt_scale``: of sqrt(x), x >= 0):
    ``s = max(absmax, 1e-20) * fl(1/127)`` (the jitted reference's
    division by 127), ``q = clip(round(x / s), +-127)`` with the IEEE
    division and round-half-even."""
    xe = torch.sqrt(torch.clamp(x, min=0.0)) if sqrt_scale else x
    absmax = torch.amax(torch.abs(xe), dim=-1, keepdim=True)
    scale = (torch.clamp(absmax, min=1e-20) * (1.0 / 127.0)).to(torch.float32)
    q = torch.clamp(torch.round(xe / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def _dq8(p: Dict[str, torch.Tensor], sqrt_scale: bool = False) -> torch.Tensor:
    x = p["q"].to(torch.float32) * p["s"]
    return x * x if sqrt_scale else x


def is_q8(x: Any) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def _encode(x: torch.Tensor, mode: str, sqrt_scale: bool = False):
    if mode == "int8" and x.dim() >= 1 and x.numel() > 1:
        return _q8(x, sqrt_scale)
    return x.to(torch.float32)


def _decode(x, sqrt_scale: bool = False) -> torch.Tensor:
    return _dq8(x, sqrt_scale) if is_q8(x) else x


# -- API ----------------------------------------------------------------------

def init_opt_state(params: Dict[str, torch.Tensor],
                   cfg: AdamWConfig) -> Dict[str, Any]:
    """``{"step": int32 0, "m": ..., "v": ...}``, one zeroed moment per
    parameter (fp32, or ``{"q", "s"}`` in int8 mode), on its device."""
    def zeros(p, sqrt_scale=False):
        return _encode(torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device), cfg.state_mode,
                       sqrt_scale)
    dev = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p, True) for k, p in params.items()}}


def global_norm(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares, the leaves'
    sums added in the order given (the reference's: one sum a leaf, then
    the sum of their stack)."""
    sums = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: Dict[str, Any],
                 cfg: AdamWConfig) -> Tuple[Dict[str, torch.Tensor],
                                            Dict[str, Any]]:
    """One AdamW step, in place (see the module doc); returns ``(params,
    state)``."""
    step = state["step"] + 1
    lr = cfg.schedule(step) if cfg.schedule is not None else cfg.lr
    gnorm = global_norm(grads[k] for k in params)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.grad_clip else 1.0)
    sf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=sf.device), sf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=sf.device), sf)
    for k, p in params.items():
        g = grads[k].to(torch.float32) * clip
        m = cfg.b1 * _decode(state["m"][k]) + (1 - cfg.b1) * g
        v = cfg.b2 * _decode(state["v"][k], True) + (1 - cfg.b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        pf = pf - lr * (delta + cfg.weight_decay * pf)
        p.copy_(pf)
        state["m"][k] = _encode(m, cfg.state_mode)
        state["v"][k] = _encode(v, cfg.state_mode, True)
        del g, m, v, delta, pf
    state["step"] = step
    return params, state
