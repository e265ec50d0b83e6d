"""The serving stack's robustness layer: deterministic fault injection
(``faults``), the per-request statuses and result (``guards``), and retry
with backoff (``retry``); the reference's ``repro.robust`` names."""
from repro_torch.robust.faults import (FaultPlan, LogitFault, StallFault,
                                       TransientServeError, bitflip_leaf,
                                       truncate_leaf, truncate_manifest)
from repro_torch.robust.guards import (STATUS_DEGRADED, STATUS_NONFINITE,
                                       STATUS_OK, STATUS_SHED,
                                       STATUS_TIMEOUT, GenerateResult,
                                       NumericalHealthError)
from repro_torch.robust.retry import generate_with_retry

__all__ = [
    "FaultPlan", "LogitFault", "StallFault", "TransientServeError",
    "bitflip_leaf", "truncate_leaf", "truncate_manifest",
    "GenerateResult", "NumericalHealthError", "generate_with_retry",
    "STATUS_OK", "STATUS_NONFINITE", "STATUS_DEGRADED", "STATUS_TIMEOUT",
    "STATUS_SHED",
]
