"""Per-request serving statuses and the structured generation result.

A copy of the reference's vocabulary (``ok``, ``quarantined_nonfinite``,
``degraded_fp32``, ``timeout``, ``shed``): one poisoned lane never takes
down the batch, it gets a status while its peers keep decoding.
"""
from __future__ import annotations

import dataclasses

import numpy as np

STATUS_OK = "ok"
STATUS_NONFINITE = "quarantined_nonfinite"
STATUS_DEGRADED = "degraded_fp32"
STATUS_TIMEOUT = "timeout"
STATUS_SHED = "shed"

STATUSES = (STATUS_OK, STATUS_NONFINITE, STATUS_DEGRADED, STATUS_TIMEOUT,
            STATUS_SHED)


class NumericalHealthError(RuntimeError):
    """Raised (only under ``ServeConfig(on_nonfinite='raise')``) when a
    non-finite logit appears."""


@dataclasses.dataclass
class GenerateResult:
    """Outcome of one ``ServeEngine.generate_with_status``.

    ``tokens``     [B, n] generated ids (pad_id past a lane's fault point;
                   shed lanes are all pad).
    ``status``     length-B list of the statuses above.
    ``fault_step`` [B] step at which the lane left ``ok`` (-1 if never).
    ``n_steps``    decode steps executed.
    ``timed_out``  True when a wall-clock budget ended the loop.
    ``admitted``   lanes actually decoded (B - admitted were shed).
    """

    tokens: np.ndarray
    status: list
    fault_step: np.ndarray
    n_steps: int
    timed_out: bool = False
    admitted: int = 0

    @property
    def ok(self) -> bool:
        return all(s == STATUS_OK for s in self.status)

    def lanes_with(self, status: str) -> np.ndarray:
        return np.flatnonzero(np.asarray(self.status, object) == status)
