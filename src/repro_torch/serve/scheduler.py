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
    (llama4) shares each expert's capacity among every token of a call,
    idle lanes' padding included, and drops the tokens that sort past it,
    as the reference does (ROADMAP F6): a lane's tokens then depend on the
    lanes before it, and only lane 0's tokens, which sort first within
    every expert, never do.
  * pick: one greedy pick with the health probes (finite, absmax, int8
    saturation) over all lanes, then ONE device-to-host transfer: the only
    host sync of an iteration.  Everything before it is queued on the
    device without waiting.
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

    # -- surface ---------------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(1 for a in self.lanes if a is not None)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    def submit(self, req: Request) -> None:
        sp = req.sampling if req.sampling is not None \
            else self.engine.scfg.sampling_defaults()
        if not sp.greedy:
            raise NotImplementedError(
                "sampled picks (threefry fold_in/categorical parity with "
                "the reference) are not ported yet; submit greedy requests")
        self.queue.append((req, sp))

    def run_to_completion(self) -> List[RequestOutput]:
        outs: List[RequestOutput] = []
        idle = 0
        while self.has_work:
            before = self.n_active
            outs.extend(self.step())
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

    def step(self) -> List[RequestOutput]:
        """Advance every phase one tick; returns the requests finished now."""
        eng = self.engine
        scfg = eng.scfg
        model = eng.model
        dev = model.device
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

        # 5. per-request deadlines
        now = time.monotonic()
        for l, a in enumerate(self.lanes):
            if a is not None and a.deadline is not None and now > a.deadline:
                a.status = STATUS_TIMEOUT
                a.fault_step = len(a.tokens)
                self.timed_out = True
                fresh[l] = False
                self._retire(l, finished)
        if not fresh.any():
            return finished

        # 6. one greedy pick + health probes over all lanes, one transfer
        calib = torch.tensor([a.calib if a is not None else 1.0
                              for a in self.lanes], dtype=torch.float32)
        tok_d, fin_d, absmax_d, sat_d = eng._pick_and_probe_lanes(
            self._logits, calib.to(dev))
        if fp_logits is not None:
            tok_fp = eng._pick_and_probe_lanes(fp_logits, calib.to(dev))[0]
            degr = torch.tensor([a is not None and a.degraded
                                 for a in self.lanes], device=dev)
            tok_d = torch.where(degr, tok_fp, tok_d)
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
                elif (fin_np[l] and not a.degraded
                        and sat_np[l] > scfg.saturation_threshold):
                    a.degraded = True
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
            a = _Lane(req=req, sp=sp)
            timeout = self.engine.scfg.request_timeout_s
            if timeout is not None:
                a.deadline = time.monotonic() + timeout
            self.lanes[lane] = a

    def _retire(self, lane: int, finished: List[RequestOutput]) -> None:
        a = self.lanes[lane]
        self.kv.release(lane)
        self.lanes[lane] = None
        finished.append(RequestOutput(
            id=a.req.id, tokens=np.asarray(a.tokens, np.int32),
            status=a.status, fault_step=a.fault_step,
            n_steps=len(a.tokens), prompt_len=len(a.req.tokens)))
