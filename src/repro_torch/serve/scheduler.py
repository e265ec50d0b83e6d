"""Continuous-batching request scheduler over the paged KV cache.

One scheduler owns a fixed set of decode LANES and a page pool; requests
flow queue -> lane -> retired while every model call keeps its shape:

  * admission: a queued request takes the lowest free lane and allocates
    ``ceil((prompt + max_new) / page_size)`` pages; transient page
    exhaustion keeps it queued, an impossible fit (longer than a lane can
    ever hold, or zero-length) sheds it with a structured status.
  * chunked prefill: at most one fixed-size prompt chunk per lane per
    iteration, every prefilling lane in one ``[L, chunk]`` call
    (``Model.prefill_chunk``); idle lanes ride along at position -1.  The
    last chunk's logits seed the request's first pick.
  * decode: every lane holding a picked token steps in one ``[L, 1]`` call
    (``Model.decode_step_paged``).  In a dense model a lane's math is
    independent of its neighbours (rows of every GEMM and norm are
    independent, and the paged attention masks other lanes' pages), so a
    request's tokens are the same alone or amid churn.  An MoE model
    (llama4 at top-1, grok-1 at top-2) shares each expert's capacity among
    every token of a call, idle lanes' padding included, and drops the
    entries that sort past it, as the reference does (ROADMAP F6): a
    lane's tokens then depend on the lanes before it, and only lane 0's,
    whose entries sort first within every expert at any k, never do.
  * pick: one pick with the health probes (finite, absmax, int8
    saturation) over all lanes, each lane with its request's sampling
    (greedy, or temperature sampling from the request's own key stream
    ``fold_in(PRNGKey(seed), step)``), then ONE device-to-host transfer:
    the only host sync of an iteration.  Everything before it is queued on
    the device without waiting.  The lane-constant pick arguments (keys,
    modes, temperatures, calibration) stay on the device and are rebuilt
    only when the lane mix changes; an iteration in which no lane samples
    draws nothing.

``FaultPlan`` hooks ride at the reference's boundaries: a stall fires once
per drain when a live lane reaches its step (before the deadlines are
checked), and logit faults poison the pick buffer's rows of the lanes
whose request is at the fault's step.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.robust.guards import (STATUS_DEGRADED, STATUS_NONFINITE,
                                       STATUS_OK, STATUS_SHED,
                                       STATUS_TIMEOUT, NumericalHealthError)
from repro_torch.serve.api import Request, RequestOutput, SamplingParams
from repro_torch.serve.kv_cache import PagedKVCache


@dataclasses.dataclass
class _Lane:
    """One admitted request's host-side state."""

    req: Request
    sp: SamplingParams
    key_base: np.ndarray              # uint32[2] PRNGKey(req.seed)
    n_prefilled: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    status: str = STATUS_OK
    fault_step: int = -1
    degraded: bool = False
    calib: float = 1.0
    calibrated: bool = False
    deadline: Optional[float] = None

    @property
    def prefilled(self) -> bool:
        return self.n_prefilled >= len(self.req.tokens)


class PagedScheduler:
    """Fixed-lane continuous-batching loop; see the module docstring.
    Built by ``ServeEngine``; its knobs are the shape constants: lane
    count, page geometry and the prefill chunk size."""

    def __init__(self, engine, *, n_lanes: int, pages_per_lane: int,
                 n_pages: int, page_size: int, chunk: int):
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.engine = engine
        self.n_lanes = n_lanes
        self.chunk = chunk
        self.kv = PagedKVCache(engine.model, n_lanes, n_pages, page_size,
                               pages_per_lane)
        self.lanes: List[Optional[_Lane]] = [None] * n_lanes
        self.queue: deque = deque()
        self.timed_out = False
        self._logits: Optional[torch.Tensor] = None   # [L, Vp] pick buffer
        self._last_tok = np.zeros((n_lanes,), np.int32)
        self._stall_fired: set = set()
        # the lane-constant pick arguments live on the device and are
        # rebuilt only when the lane mix, a calibration or a degradation
        # changes (``_lane_gen``)
        self._lane_gen = 0
        self._pick_gen = -1
        self._pick_const = None
        self._sampled = False
        self._degr_dev: Optional[torch.Tensor] = None

    # -- surface ---------------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(1 for a in self.lanes if a is not None)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    def reset_fault_state(self) -> None:
        """Per-drain fault bookkeeping (which stalls fired, the timeout
        flag), cleared by the shim between calls so that a reused
        scheduler replays a FaultPlan from the start."""
        self._stall_fired.clear()
        self.timed_out = False

    def submit(self, req: Request) -> None:
        sp = req.sampling if req.sampling is not None \
            else self.engine.scfg.sampling_defaults()
        self.queue.append((req, sp))

    def run_to_completion(self, fault_plan=None) -> List[RequestOutput]:
        outs: List[RequestOutput] = []
        idle = 0
        while self.has_work:
            before = self.n_active
            outs.extend(self.step(fault_plan))
            if self.queue and before == 0 and self.n_active == 0:
                idle += 1
                if idle > 2:
                    raise RuntimeError(
                        "scheduler stalled: queue non-empty but nothing "
                        "admits (page pool smaller than one request?)")
            else:
                idle = 0
        return outs

    # -- one iteration ---------------------------------------------------------

    def step(self, fault_plan=None) -> List[RequestOutput]:
        """Advance every phase one tick; returns the requests finished now."""
        eng = self.engine
        scfg = eng.scfg
        model = eng.model
        dev = model.device
        plan = fault_plan if (fault_plan is not None
                              and fault_plan.enabled) else None
        finished: List[RequestOutput] = []
        L = self.n_lanes
        fresh = np.zeros((L,), bool)

        # 1. admissions first, so a lane freed last iteration refills
        # before this iteration's calls
        self._admit(finished)

        # 2. chunked prefill: one chunk per prefilling lane, all in one
        # [L, C] call
        pre = [l for l, a in enumerate(self.lanes)
               if a is not None and not a.prefilled]
        completed = np.zeros((L,), bool)
        chunk_rows = None
        if pre:
            tc = np.zeros((L, self.chunk), np.int32)
            pc = np.full((L, self.chunk), -1, np.int32)
            last = np.full((L,), -1, np.int32)
            for l in pre:
                a = self.lanes[l]
                start = a.n_prefilled
                n = min(self.chunk, len(a.req.tokens) - start)
                tc[l, :n] = a.req.tokens[start:start + n]
                pc[l, :n] = np.arange(start, start + n, dtype=np.int32)
                last[l] = n - 1
                a.n_prefilled += n
                completed[l] = a.prefilled  # its row seeds the first pick
            chunk_rows, _ = model.prefill_chunk(
                self.kv.pools, torch.from_numpy(tc), torch.from_numpy(pc),
                self.kv.table_device(), torch.from_numpy(last))

        # 3. decode: one [L, 1] step for every lane holding tokens
        dec = [l for l, a in enumerate(self.lanes)
               if a is not None and a.prefilled and a.tokens]
        fp_logits = None
        if dec:
            pos_np = np.full((L,), -1, np.int32)
            for l in dec:
                a = self.lanes[l]
                pos_np[l] = len(a.req.tokens) + len(a.tokens) - 1
            tok = torch.from_numpy(self._last_tok[:, None].copy())
            pos = torch.from_numpy(pos_np)
            table = self.kv.table_device()
            if eng.fp_model is not None \
                    and any(self.lanes[l].degraded for l in dec):
                # before the int8 step: the int8 step then overwrites the
                # K/V this step wrote at the same positions
                fp_logits, _ = eng.fp_model.decode_step_paged(
                    self.kv.pools, tok, pos, table)
            self._logits, _ = model.decode_step_paged(self.kv.pools, tok, pos,
                                                      table)
            fresh[dec] = True

        # 4. lanes that finished their prompt this iteration: their
        # last-chunk logits rows enter the pick buffer
        if completed.any():
            if self._logits is None:
                self._logits = chunk_rows
            else:
                mask = torch.from_numpy(completed).to(dev)
                self._logits = torch.where(mask[:, None], chunk_rows,
                                           self._logits)
            fresh |= completed

        # 5. faults and per-request deadlines: each fresh lane's step (the
        # index of the token it picks now; -1 elsewhere), the stall first,
        # as in the fixed loop: a stalled host is what the budget converts
        steps = np.full((L,), -1, np.int64)
        for l, a in enumerate(self.lanes):
            if a is not None and fresh[l]:
                steps[l] = len(a.tokens)
        if plan is not None:
            plan.maybe_stall_lanes(steps, self._stall_fired)
        now = time.monotonic()
        for l, a in enumerate(self.lanes):
            if a is not None and a.deadline is not None and now > a.deadline:
                a.status = STATUS_TIMEOUT
                a.fault_step = len(a.tokens)
                self.timed_out = True
                fresh[l] = False
                steps[l] = -1
                self._retire(l, finished)
        if not fresh.any():
            return finished
        if plan is not None:
            self._logits = plan.perturb_logits_lanes(steps, self._logits)

        # 6. one pick + health probes over all lanes, one transfer.  A
        # lane that is not fresh carries step -1: its key differs from a
        # live lane's, and its pick is never read.
        kb, greedy, temp, calib = self._pick_args(dev)
        steps_d = (torch.from_numpy(steps).to(dev) if self._sampled
                   else None)
        pick_args = (kb, steps_d, greedy, temp, calib)
        tok_d, fin_d, absmax_d, sat_d = eng._pick_and_probe_lanes(
            self._logits, *pick_args)
        if fp_logits is not None:
            # degraded lanes pick from the float logits; the same keys
            # keep the healthy lanes' picks as they are
            tok_fp = eng._pick_and_probe_lanes(fp_logits, *pick_args)[0]
            tok_d = torch.where(self._degr_dev, tok_fp, tok_d)
        host = torch.stack([tok_d.double(), fin_d.double(),
                            absmax_d.double(), sat_d.double()]).cpu().numpy()
        tok_np = host[0].astype(np.int64)
        fin_np, absmax_np, sat_np = host[1] > 0, host[2], host[3]

        # 7. guards + commit + retire
        guards_on = scfg.guards and scfg.on_nonfinite != "off"
        sat_on = scfg.guards and scfg.int8
        if guards_on and scfg.on_nonfinite == "raise":
            bad = [l for l in range(L) if fresh[l] and not fin_np[l]]
            if bad:
                t = len(self.lanes[bad[0]].tokens)
                raise NumericalHealthError(
                    f"non-finite logits at decode step {t} in lanes {bad}")
        for l in range(L):
            a = self.lanes[l]
            if a is None or not fresh[l]:
                continue
            t = len(a.tokens)
            if guards_on and not fin_np[l]:
                a.status = STATUS_NONFINITE
                a.fault_step = t
                self._retire(l, finished)
                continue
            if sat_on:
                if not a.calibrated:
                    # the request's first logits calibrate its probe
                    a.calib = float(max(absmax_np[l], 1e-6))
                    a.calibrated = True
                    self._lane_gen += 1
                elif (fin_np[l] and not a.degraded
                        and sat_np[l] > scfg.saturation_threshold):
                    a.degraded = True
                    self._lane_gen += 1
                    if a.status == STATUS_OK:
                        a.status = STATUS_DEGRADED
                        a.fault_step = t
            tk = int(tok_np[l])
            a.tokens.append(tk)
            self._last_tok[l] = tk
            if (a.sp.eos_id is not None and tk == a.sp.eos_id) \
                    or len(a.tokens) >= a.sp.max_new_tokens:
                self._retire(l, finished)
        return finished

    # -- internals -------------------------------------------------------------

    def _pick_args(self, dev: torch.device):
        """The lane-constant pick arguments on the device, rebuilt when the
        lane mix changed: keys ``[L, 2]``, the greedy mask, temperatures
        and calibrations (an empty lane: greedy, 1.0).  Keys, mask and
        temperatures are None while no lane samples."""
        if self._pick_gen != self._lane_gen:
            L = self.n_lanes
            kb = np.zeros((L, 2), np.uint32)
            greedy = np.ones((L,), bool)
            temp = np.ones((L,), np.float32)
            calib = np.ones((L,), np.float32)
            degr = np.zeros((L,), bool)
            for l, a in enumerate(self.lanes):
                if a is None:
                    continue
                kb[l] = a.key_base
                greedy[l] = a.sp.greedy
                temp[l] = a.sp.temperature
                calib[l] = a.calib
                degr[l] = a.degraded
            self._sampled = not greedy.all()
            sampled = ((torch.from_numpy(kb.astype(np.int64)).to(dev),
                        torch.from_numpy(greedy).to(dev),
                        torch.from_numpy(temp).to(dev))
                       if self._sampled else (None, None, None))
            self._pick_const = sampled + (torch.from_numpy(calib).to(dev),)
            self._degr_dev = torch.from_numpy(degr).to(dev)
            self._pick_gen = self._lane_gen
        return self._pick_const

    def _admit(self, finished: List[RequestOutput]) -> None:
        while self.queue:
            free = [l for l, a in enumerate(self.lanes) if a is None]
            if not free:
                return
            req, sp = self.queue[0]
            total = len(req.tokens) + sp.max_new_tokens
            if not self.kv.fits_ever(total):
                # can never fit a lane (over-wide or zero-length): a
                # structured shed, not a crash
                self.queue.popleft()
                finished.append(RequestOutput(
                    id=req.id, tokens=np.zeros((0,), np.int32),
                    status=STATUS_SHED, fault_step=-1, n_steps=0,
                    prompt_len=0))
                continue
            lane = free[0]
            if not self.kv.admit(lane, total):
                return  # transient page exhaustion: stay queued
            self.queue.popleft()
            a = _Lane(req=req, sp=sp,
                      key_base=self.engine._request_key(req.seed))
            timeout = self.engine.scfg.request_timeout_s
            if timeout is not None:
                a.deadline = time.monotonic() + timeout
            self.lanes[lane] = a
            self._lane_gen += 1

    def _retire(self, lane: int, finished: List[RequestOutput]) -> None:
        a = self.lanes[lane]
        self.kv.release(lane)
        self.lanes[lane] = None
        self._lane_gen += 1
        finished.append(RequestOutput(
            id=a.req.id, tokens=np.asarray(a.tokens, np.int32),
            status=a.status, fault_step=a.fault_step,
            n_steps=len(a.tokens), prompt_len=len(a.req.tokens)))
