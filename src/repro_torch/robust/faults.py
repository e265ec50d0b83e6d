"""Deterministic fault injection for the serving stack (the counterpart of
the reference's ``robust/faults.py``).

A ``FaultPlan`` is a seeded, declarative description of the faults one
``ServeEngine`` call should meet: non-finite or overscaled logits at a
chosen step and lane, a host stall before a chosen step, and transient
whole-call failures for the retry wrapper.  Checkpoint corruption
(truncated leaf, flipped bit, truncated manifest) works on a committed
checkpoint directory on disk and names the parameter it corrupted.

  * No plan, no work: the engines hold one ``plan is not None`` check per
    hook and run exactly as without the harness.
  * Deterministic: the bit-flip position comes from a numpy Generator
    seeded by the caller.
  * Explicit hooks at boundaries the serving code already has (the logits
    before a pick, the host loop, files on disk), never monkeypatched
    internals.  ``_poison_rows`` works on the logits' own device: no host
    round trip, and no copy when no fault hits.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Tuple

import numpy as np
import torch

_LOGIT_KINDS = ("nan", "inf", "ninf", "scale")


class TransientServeError(RuntimeError):
    """A retryable whole-request failure (what ``robust.retry`` absorbs)."""


@dataclasses.dataclass(frozen=True)
class LogitFault:
    """Corrupt the logits a step's token is picked from.

    ``step`` indexes the generated token (0: the token picked from the
    prefill logits); ``lanes`` are batch rows (scheduler lanes).
    ``kind``: ``'nan'`` / ``'inf'`` / ``'ninf'`` poison the whole row, the
    fault the finite guard quarantines; ``'scale'`` multiplies the row by
    ``scale``, which drives the int8 saturation probe past its threshold
    without leaving the finite domain."""

    step: int
    lanes: Tuple[int, ...]
    kind: str = "nan"
    scale: float = 64.0

    def __post_init__(self):
        if self.kind not in _LOGIT_KINDS:
            raise ValueError(f"unknown logit-fault kind {self.kind!r}; "
                             f"valid kinds are {_LOGIT_KINDS}")


@dataclasses.dataclass(frozen=True)
class StallFault:
    """Stall the host for ``seconds`` before step ``step``: the hung host
    the per-request wall-clock budget turns into ``timeout`` statuses."""

    step: int
    seconds: float


@dataclasses.dataclass
class FaultPlan:
    seed: int = 0
    logit_faults: Tuple[LogitFault, ...] = ()
    stalls: Tuple[StallFault, ...] = ()
    # raise TransientServeError for the first N generate calls (the count
    # survives retries: the retry loop is what gets through)
    fail_first_generates: int = 0
    enabled: bool = True
    _attempts: int = dataclasses.field(default=0, repr=False)

    # -- fixed-loop hooks -----------------------------------------------------

    def on_generate_start(self) -> None:
        if self.enabled and self._attempts < self.fail_first_generates:
            self._attempts += 1
            raise TransientServeError(
                f"injected transient failure (attempt {self._attempts} of "
                f"{self.fail_first_generates} planned)")
        self._attempts += 1

    def maybe_stall(self, step: int, sleep=time.sleep) -> None:
        if not self.enabled:
            return
        for f in self.stalls:
            if f.step == step:
                sleep(f.seconds)

    def perturb_logits(self, step: int, logits: torch.Tensor
                       ) -> torch.Tensor:
        """Every logit fault registered for ``step`` (copy-on-write: a step
        no fault hits returns ``logits`` itself)."""
        if not self.enabled:
            return logits
        hits = [(f, lane) for f in self.logit_faults if f.step == step
                for lane in f.lanes]
        return _poison_rows(logits, hits)

    # -- scheduler hooks ------------------------------------------------------
    #
    # The scheduler has no global step: each lane holds its own request at
    # its own step.  These take the per-lane step vector (-1: the lane is
    # idle or not picking this iteration) and read ``LogitFault.lanes`` /
    # ``StallFault.step`` against the step of the request in that lane; on
    # the lockstep shim they reduce to the hooks above.

    def maybe_stall_lanes(self, lane_steps, fired: set,
                          sleep=time.sleep) -> None:
        """Each StallFault fires once per drain (tracked in the caller's
        ``fired`` set), when any live lane reaches its step: under churn
        several iterations can match, and a stall that fired on each
        would model several faults, not one."""
        if not self.enabled:
            return
        for i, f in enumerate(self.stalls):
            if i in fired:
                continue
            if any(int(t) == f.step for t in lane_steps if t >= 0):
                fired.add(i)
                sleep(f.seconds)

    def perturb_logits_lanes(self, lane_steps, logits: torch.Tensor
                             ) -> torch.Tensor:
        """Fault (step, lane) hits when the request in ``lane`` is at
        ``step`` this iteration (copy-on-write as ``perturb_logits``)."""
        if not self.enabled:
            return logits
        hits = [(f, lane) for f in self.logit_faults for lane in f.lanes
                if 0 <= lane < len(lane_steps)
                and int(lane_steps[lane]) == f.step]
        return _poison_rows(logits, hits)


def _poison_rows(logits: torch.Tensor, hits) -> torch.Tensor:
    """Apply (fault, lane) pairs to rows of a copy of ``logits``, on its
    device; no hit returns the same object."""
    if not hits:
        return logits
    out = logits.clone()
    for f, lane in hits:
        if f.kind == "nan":
            out[lane] = float("nan")
        elif f.kind == "inf":
            out[lane] = float("inf")
        elif f.kind == "ninf":
            out[lane] = float("-inf")
        else:  # 'scale'
            out[lane] *= f.scale
    return out


# -- on-disk checkpoint corruption -------------------------------------------
#
# These work on a committed step directory (the layout CheckpointManager
# wrote) and return the name of the parameter they corrupted, so a test can
# hold the restore error to it.


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _leaf_meta(ckpt_dir: str, step: int, leaf: int):
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        meta = json.load(f)["leaves"][leaf]
    return d, meta, meta.get("param", meta["file"])


def truncate_leaf(ckpt_dir: str, step: int, leaf: int = 0,
                  keep_bytes: int = 16) -> str:
    """Truncate a leaf file to ``keep_bytes`` (a torn leaf after a crash
    that beat the fsync).  Returns the parameter's name."""
    d, meta, name = _leaf_meta(ckpt_dir, step, leaf)
    path = os.path.join(d, meta["file"])
    with open(path, "rb") as f:
        data = f.read(keep_bytes)
    with open(path, "wb") as f:
        f.write(data)
    return name


def bitflip_leaf(ckpt_dir: str, step: int, leaf: int = 0,
                 seed: int = 0) -> str:
    """Flip one seeded-random bit in the second half of a leaf file, clear
    of the .npy header, so that only the crc32 can see it.  Returns the
    parameter's name."""
    d, meta, name = _leaf_meta(ckpt_dir, step, leaf)
    path = os.path.join(d, meta["file"])
    with open(path, "rb") as f:
        data = bytearray(f.read())
    rng = np.random.default_rng(seed)
    off = int(rng.integers(len(data) // 2, len(data)))
    data[off] ^= 1 << int(rng.integers(0, 8))
    with open(path, "wb") as f:
        f.write(data)
    return name


def truncate_manifest(ckpt_dir: str, step: int, keep_bytes: int = 32) -> str:
    """Truncate a step's manifest.json (a torn metadata write): the step
    still lists as present but must restore as structured corruption."""
    path = os.path.join(_step_dir(ckpt_dir, step), "manifest.json")
    with open(path, "rb") as f:
        data = f.read(keep_bytes)
    with open(path, "wb") as f:
        f.write(data)
    return "manifest.json"
