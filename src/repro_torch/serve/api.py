"""Typed request-level serving API: ``SamplingParams``, ``Request`` and
``RequestOutput``, with the reference's validation messages.

``ServeEngine.submit()/step()/collect()`` consumes and produces these;
``generate()``/``generate_with_status()`` are fixed-batch shims over the
same scheduler.  A request picks greedily or samples at its temperature
from its own key stream, rooted at ``Request.seed``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from repro_torch.robust.guards import STATUS_OK


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling: greedy or temperature sampling, the token
    budget and the stop token."""

    greedy: bool = True
    temperature: float = 1.0
    max_new_tokens: int = 32
    eos_id: Optional[int] = None

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if not (self.temperature >= 0.0):  # also rejects NaN
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.eos_id is not None and self.eos_id < 0:
            raise ValueError(f"eos_id must be >= 0, got {self.eos_id}")


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: an id the caller correlates outputs by, the
    prompt token ids, optional per-request sampling (``None`` = the
    engine's ``ServeConfig`` defaults) and the seed of its sampling
    stream."""

    id: Union[int, str]
    tokens: np.ndarray
    sampling: Optional[SamplingParams] = None
    seed: int = 0

    def __post_init__(self):
        toks = np.asarray(self.tokens)
        if toks.ndim != 1 or toks.size == 0:
            raise ValueError(
                f"Request.tokens must be a non-empty 1-D id array, got "
                f"shape {toks.shape}")
        if not np.issubdtype(toks.dtype, np.integer):
            raise ValueError(
                f"Request.tokens must be integer ids, got {toks.dtype}")
        object.__setattr__(self, "tokens", toks.astype(np.int32))


@dataclasses.dataclass
class RequestOutput:
    """Structured per-request outcome.

    ``tokens``     [n] generated ids (real tokens only, no pad filler).
    ``status``     one of ``repro_torch.robust.guards.STATUSES``.
    ``fault_step`` step at which the request left ``ok``; -1 if it never
                   did (including ``shed``: rejected before any step).
    ``n_steps``    decode steps executed for this request.
    ``prompt_len`` prompt tokens consumed (0 for shed requests).
    """

    id: Union[int, str]
    tokens: np.ndarray
    status: str = STATUS_OK
    fault_step: int = -1
    n_steps: int = 0
    prompt_len: int = 0

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK
