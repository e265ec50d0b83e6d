"""Fixed-batch greedy serving: prefill every lane, then decode in lockstep.

The port of the reference's ``generate_with_status_fixed`` loop with its
health guards: a non-finite logit quarantines THAT lane (structured
status, pad tokens from then on) while its peers keep decoding, or raises
under ``on_nonfinite='raise'``; batch rows past ``max_lanes`` are shed at
the door.  The reference routes paged-capable models to its
continuous-batching scheduler, whose greedy outputs it holds bitwise equal
to this loop; until the paged slice is ported, ``generate`` here runs this
fixed loop for every model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.lm import Model
from repro_torch.robust.guards import (STATUS_NONFINITE, STATUS_OK,
                                       STATUS_SHED, GenerateResult,
                                       NumericalHealthError)

_ON_NONFINITE = ("quarantine", "raise", "off")


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    # per-lane finite-logit guard, computed in the token pick
    guards: bool = True
    # 'quarantine' the lane, 'raise' NumericalHealthError, or 'off'
    on_nonfinite: str = "quarantine"
    # token emitted for a lane past its quarantine/shed point
    pad_id: int = 0
    # dtype logits are picked in
    logits_dtype: str = "float32"
    # admission control: lanes beyond this are shed (None = admit all)
    max_lanes: Optional[int] = None

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.pad_id < 0:
            raise ValueError(f"pad_id must be >= 0, got {self.pad_id}")
        if self.on_nonfinite not in _ON_NONFINITE:
            raise ValueError(
                f"unknown on_nonfinite {self.on_nonfinite!r}; valid "
                f"modes are {_ON_NONFINITE}")
        dt = getattr(torch, self.logits_dtype, None)
        if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
            raise ValueError(f"logits_dtype must name a float dtype, got "
                             f"{self.logits_dtype!r}")
        if self.max_lanes is not None and self.max_lanes < 1:
            raise ValueError(
                f"max_lanes must be >= 1 (or None), got {self.max_lanes}")


class ServeEngine:
    def __init__(self, model: Model, scfg: ServeConfig = ServeConfig()):
        self.model = model
        self.scfg = scfg
        self._ldtype = getattr(torch, scfg.logits_dtype)

    def _pick_and_probe(self, logits: torch.Tensor):
        """Greedy pick over the real vocab plus the per-lane finite probe:
        (tok [B] int32, finite [B] bool)."""
        real = logits[:, :self.model.cfg.vocab]
        tok = torch.argmax(real.to(self._ldtype), dim=-1).to(torch.int32)
        return tok, torch.isfinite(real).all(dim=-1)

    def generate(self, batch: Dict[str, torch.Tensor]) -> np.ndarray:
        """batch['tokens'] [B, S] -> generated tokens [B, <= max_new]."""
        return self.generate_with_status(batch).tokens

    def generate_with_status(self, batch: Dict[str, torch.Tensor]
                             ) -> GenerateResult:
        """Guarded generation with structured per-lane outcomes (the fixed
        loop until the paged slice lands)."""
        return self.generate_with_status_fixed(batch)

    def generate_with_status_fixed(self, batch: Dict[str, torch.Tensor]
                                   ) -> GenerateResult:
        scfg = self.scfg
        toks = torch.as_tensor(batch["tokens"])
        b_full = toks.shape[0]
        if toks.dim() != 2 or toks.shape[1] == 0:
            # a zero-length prompt can never seed a pick: shed the batch
            return GenerateResult(
                tokens=np.zeros((b_full, 0), np.int32),
                status=[STATUS_SHED] * b_full,
                fault_step=np.full((b_full,), -1, np.int64),
                n_steps=0, timed_out=False, admitted=0)
        admit = b_full if scfg.max_lanes is None \
            else min(b_full, scfg.max_lanes)
        toks = toks[:admit]
        prompt_len = toks.shape[1]
        logits, cache = self.model.prefill(
            toks, max_len=prompt_len + scfg.max_new_tokens)

        status = np.array([STATUS_OK] * admit, dtype=object)
        fault_step = np.full((admit,), -1, np.int64)
        done = np.zeros((admit,), bool)
        guards_on = scfg.guards and scfg.on_nonfinite != "off"
        out: List[np.ndarray] = []
        for i in range(scfg.max_new_tokens):
            tok, finite = self._pick_and_probe(logits)
            tok_np = tok.cpu().numpy()
            if guards_on:
                newly_bad = ~finite.cpu().numpy() & ~done
                if newly_bad.any():
                    lanes = np.flatnonzero(newly_bad)
                    if scfg.on_nonfinite == "raise":
                        raise NumericalHealthError(
                            f"non-finite logits at decode step {i} in "
                            f"lanes {lanes.tolist()}")
                    status[newly_bad] = STATUS_NONFINITE
                    fault_step[newly_bad & (fault_step < 0)] = i
            quarantined = status == STATUS_NONFINITE
            if quarantined.any():
                tok_np = np.where(quarantined, scfg.pad_id,
                                  tok_np).astype(tok_np.dtype)
            out.append(tok_np)
            done = done | quarantined
            if done.all() or i == scfg.max_new_tokens - 1:
                break
            tok_dev = torch.from_numpy(tok_np)[:, None]
            logits, cache = self.model.decode_step(cache, tok_dev,
                                                   prompt_len + i)

        tokens = (np.stack(out, axis=1) if out
                  else np.zeros((admit, 0), np.int32))
        if admit < b_full:
            shed = b_full - admit
            full = np.full((b_full, tokens.shape[1]), scfg.pad_id,
                           tokens.dtype)
            full[:admit] = tokens
            tokens = full
            status = np.concatenate(
                [status, np.array([STATUS_SHED] * shed, dtype=object)])
            fault_step = np.concatenate(
                [fault_step, np.full((shed,), -1, np.int64)])
        return GenerateResult(tokens=tokens, status=list(status),
                              fault_step=fault_step, n_steps=len(out),
                              timed_out=False, admitted=admit)
