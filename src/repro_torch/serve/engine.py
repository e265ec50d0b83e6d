"""Request-level serving engine: continuous batching over a paged KV
cache behind ``submit()/step()/collect()``, and the fixed-batch loop.

  * the PAGED path (``serve.scheduler.PagedScheduler``): requests admit
    into recycled decode lanes backed by page pools, prompts prefill in
    fixed-size chunks interleaved with decode steps, and every model call
    has one of two shapes, ``[n_lanes, 1]`` or ``[n_lanes, chunk]``;
  * the FIXED path (``generate_with_status_fixed``): prefill every lane,
    then decode in lockstep over a dense cache.

``generate()`` / ``generate_with_status()`` are shims over a cached
fixed-geometry scheduler, as in the reference, whose greedy tokens equal
the fixed loop's; a model the scheduler cannot serve (whisper's
encoder-decoder, paligemma's prefix-LM, recurrentgemma's and xlstm's
recurrent states, ``Model.supports_paged_serving``) falls through to the
fixed loop, which hands the batch's ``frames`` or
``patches`` to its prefill, and its ``submit()`` raises.  With
``ServeConfig(int8=True)`` the engine serves the model's int8 copy
(``Model.quantize_params_for_serving``); a saturation
probe, calibrated on each request's first logits, marks requests whose
logits drift past the int8 envelope as ``degraded_fp32`` and, with
``fp32_fallback``, finishes them on the retained bf16 model over the same
pools.  A non-finite logit quarantines that request (or raises under
``on_nonfinite='raise'``); a wall-clock budget gives ``timeout``; a
request that can never fit is ``shed``.

Picks are greedy or sampled, as the reference's: a sampled pick is
``jax.random.categorical`` computed bit for bit in torch
(``serve.sampling``).  The scheduler samples each lane from its request's
own stream, ``fold_in(PRNGKey(request.seed), step)``, so a sampled
request's tokens do not depend on its lane or its neighbours; the fixed
loop samples every lane from one key, ``PRNGKey(seed)``, split after each
decode step.  A pick in which no lane samples draws nothing.  A
``robust.FaultPlan`` injects faults at the reference's boundaries (a
transient failure at the start of a call, a host stall before a step,
poisoned logits before a pick); ``from_checkpoint`` serves weights
restored by ``checkpoint.CheckpointManager``.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.quantize import (quantize_fixed_scale,
                                          saturation_fraction)
from repro_torch.models.lm import Model
from repro_torch.robust.guards import (STATUS_DEGRADED, STATUS_NONFINITE,
                                       STATUS_OK, STATUS_SHED,
                                       STATUS_TIMEOUT, GenerateResult,
                                       NumericalHealthError)
from repro_torch.serve import sampling
from repro_torch.serve.api import Request, RequestOutput, SamplingParams
from repro_torch.serve.scheduler import PagedScheduler

_ON_NONFINITE = ("quarantine", "raise", "off")

# ServeConfig fields that moved to SamplingParams; kept as the engine-wide
# defaults of requests that carry none (the reference's
# ``_SAMPLING_DEFAULTS``)
_SAMPLING_DEFAULTS = dict(max_new_tokens=32, eos_id=None, greedy=True,
                          temperature=1.0)


@dataclasses.dataclass
class ServeConfig:
    # -- sampling defaults (deprecated here: pass SamplingParams on each
    # Request; a non-default value warns) -------------------------------------
    max_new_tokens: int = 32
    # stop token (None = run to max_new_tokens)
    eos_id: Optional[int] = None
    greedy: bool = True
    temperature: float = 1.0
    # per-lane health guards (finite logits; int8 saturation probe),
    # computed in the token pick
    guards: bool = True
    # 'quarantine' the lane, 'raise' NumericalHealthError, or 'off'
    on_nonfinite: str = "quarantine"
    # token emitted for a lane past its quarantine/shed point
    pad_id: int = 0
    # dtype logits are picked in
    logits_dtype: str = "float32"
    # admission control: lanes beyond this are shed (None = admit all)
    max_lanes: Optional[int] = None
    # serve the int8 copy of the model (projection weights quantized once,
    # column-wise scales)
    int8: bool = False
    # int8 only: keep the bf16 model and finish saturated lanes on it
    fp32_fallback: bool = False
    # int8 only: fraction of a lane's logits past its calibrated int8
    # envelope above which the lane degrades
    saturation_threshold: float = 0.25
    # wall-clock budget per request (None = no budget)
    request_timeout_s: Optional[float] = None
    # -- paged scheduler geometry (shape constants) ---------------------------
    n_lanes: int = 4
    page_size: int = 16
    prefill_chunk: int = 32
    # per-request position ceiling (prompt + max_new); sets the table width
    max_seq_len: int = 256
    # pages in the pool (None = n_lanes full lanes' worth)
    n_pages: Optional[int] = None

    def __post_init__(self):
        moved = [k for k, d in _SAMPLING_DEFAULTS.items()
                 if getattr(self, k) != d]
        if moved:
            warnings.warn(
                f"ServeConfig sampling fields {moved} are deprecated: pass "
                f"repro_torch.serve.api.SamplingParams on each Request (the "
                f"ServeConfig values remain the engine-wide defaults)",
                DeprecationWarning, stacklevel=3)
        SamplingParams(greedy=self.greedy, temperature=self.temperature,
                       max_new_tokens=self.max_new_tokens,
                       eos_id=self.eos_id)
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
        if self.request_timeout_s is not None \
                and not (self.request_timeout_s > 0):
            raise ValueError(
                f"request_timeout_s must be > 0 (or None), got "
                f"{self.request_timeout_s}")
        if not (0.0 < self.saturation_threshold <= 1.0):
            raise ValueError(
                f"saturation_threshold must be in (0, 1], got "
                f"{self.saturation_threshold}")
        if self.fp32_fallback and not self.int8:
            raise ValueError(
                "fp32_fallback without int8 is meaningless: the engine "
                "already serves full precision")
        if self.n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {self.n_lanes}")
        if self.page_size < 1:
            raise ValueError(
                f"page_size must be >= 1, got {self.page_size}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.max_seq_len < 2:
            raise ValueError(
                f"max_seq_len must be >= 2, got {self.max_seq_len}")
        if self.n_pages is not None and self.n_pages < 1:
            raise ValueError(
                f"n_pages must be >= 1 (or None), got {self.n_pages}")

    def sampling_defaults(self) -> SamplingParams:
        """The SamplingParams of requests that carry none, from the
        deprecated fields."""
        return SamplingParams(greedy=self.greedy,
                              temperature=self.temperature,
                              max_new_tokens=self.max_new_tokens,
                              eos_id=self.eos_id)


def pick_lanes(real: torch.Tensor, ldtype: torch.dtype,
               key_base: Optional[torch.Tensor] = None,
               steps: Optional[torch.Tensor] = None,
               greedy: Optional[torch.Tensor] = None,
               temp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scheduler's pick over the real-vocab logits ``real [L, v]``
    (the reference's ``_pick_and_probe_lanes`` without its probes): each
    lane's argmax in ``ldtype``, or where ``greedy [L]`` is False
    ``categorical(fold_in(key_base[l], steps[l]), real[l] / temp[l])``,
    every lane drawing its own ``[v]``.  The division runs in fp32 at
    least (the reference promotes the logits to its fp32 ``temp``).
    ``key_base`` None: no lane samples and nothing is drawn."""
    lf = real.to(ldtype)
    tok = torch.argmax(lf, dim=-1).to(torch.int32)
    if key_base is None:
        return tok
    keys = sampling.fold_in(key_base, steps)
    wide = torch.promote_types(ldtype, torch.float32)
    scaled = lf.to(wide) / torch.clamp(temp, min=1e-6)[:, None]
    tok_s = sampling.categorical(keys, scaled).to(torch.int32)
    return torch.where(greedy, tok, tok_s)


class ServeEngine:
    def __init__(self, model: Model, scfg: ServeConfig = ServeConfig()):
        if scfg.fp32_fallback and model.int8:
            raise ValueError(
                "fp32_fallback finishes lanes on the float model, and this "
                "model is already int8 (its float weights were released)")
        self.scfg = scfg
        # int8: the one-shot quantized copy serves; the bf16 model stays
        # only under fp32_fallback
        self.model = model.quantize_params_for_serving() if scfg.int8 \
            else model
        self.fp_model = model if scfg.fp32_fallback else None
        self._ldtype = getattr(torch, scfg.logits_dtype)
        self._sched: Optional[PagedScheduler] = None
        self._finished: List[RequestOutput] = []
        self._shim_cache: Dict[tuple, PagedScheduler] = {}

    @classmethod
    def from_checkpoint(cls, model: Model, ckpt_dir: str,
                        step: Optional[int] = None,
                        scfg: ServeConfig = ServeConfig(),
                        fallback: bool = True) -> "ServeEngine":
        """Serve the weights of a checkpoint written by
        ``checkpoint.CheckpointManager`` (by either package: the reference's
        tree, ``convert.to_jax_params``), loaded into ``model`` in place.
        A checkpoint of separate ``wq``/``wk``/``wv`` leaves is packed into
        ``wqkv``.  With ``fallback`` (the serving default) a step that
        fails its integrity check is reported and the newest earlier
        intact step is served: stale weights over none.  With
        ``scfg.int8`` the restored weights go through the one-shot
        quantization, as in ``__init__``."""
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.convert import from_jax_params
        _, tree = CheckpointManager(ckpt_dir).restore(
            step, cfg=model.cfg, fallback=fallback)
        model.load_state_dict(from_jax_params(model.cfg, tree))
        return cls(model, scfg)

    # -- token pick + health probes ---------------------------------------------

    def _pick_math(self, logits: torch.Tensor, key: Optional[torch.Tensor],
                   compiled: bool) -> torch.Tensor:
        """The fixed loop's pick over the real vocab in ``logits_dtype``:
        greedy, or ``categorical(key, logits / temperature)`` with one key
        for the whole ``[B, v]`` draw.  ``compiled`` follows the
        reference's two call sites: inside its jitted guarded pick XLA
        turns the division by the constant temperature into a multiply by
        its fp32 reciprocal; its eager pick (guards off, the fp32
        fallback's tokens) divides by the temperature cast to the
        dtype."""
        lf = logits[:, :self.model.cfg.vocab].to(self._ldtype)
        if self.scfg.greedy:
            return torch.argmax(lf, dim=-1).to(torch.int32)
        t = torch.tensor(max(self.scfg.temperature, 1e-6),
                         dtype=self._ldtype)
        if compiled:
            recip = np.float32(1.0) / np.float32(t.float().item())
            scaled = (lf.float() * float(recip)).to(self._ldtype)
        else:
            scaled = lf / t.to(lf.device)
        return sampling.categorical(key, scaled).to(torch.int32)

    def _pick(self, logits: torch.Tensor, key: Optional[torch.Tensor]
              ) -> torch.Tensor:
        """The unguarded pick (the reference's eager ``_pick``)."""
        return self._pick_math(logits, key, compiled=False)

    def _pick_and_probe(self, logits: torch.Tensor,
                        key: Optional[torch.Tensor],
                        calib: Optional[torch.Tensor]):
        """The fixed loop's guarded pick plus the per-lane probes over the
        real vocab: ``finite``, and with ``calib [B]`` (int8) ``absmax``
        (the calibration source of the first pick) and ``sat`` (the
        fraction of the lane's logits that saturate a fixed int8 scale
        calibrated to ``calib``)."""
        real = logits[:, :self.model.cfg.vocab]
        tok = self._pick_math(logits, key, compiled=True)
        finite = torch.isfinite(real).all(dim=-1)
        if calib is None:
            return tok, finite, None, None
        return (tok, finite) + self._saturation_probe(real, calib)

    @staticmethod
    def _saturation_probe(real: torch.Tensor, calib: torch.Tensor):
        absmax = torch.amax(torch.abs(real), dim=-1)
        scale = torch.clamp(calib, min=1e-6)[:, None] * (1.0 / 127.0)
        sat = saturation_fraction(quantize_fixed_scale(real, scale))
        return absmax, sat

    def _pick_and_probe_lanes(self, logits: torch.Tensor,
                              key_base: Optional[torch.Tensor],
                              steps: Optional[torch.Tensor],
                              greedy: Optional[torch.Tensor],
                              temp: Optional[torch.Tensor],
                              calib: torch.Tensor):
        """The scheduler's pick (``pick_lanes``) plus the probes over
        ``logits [L, Vp]``: each lane samples from its own request's key
        stream, so a sampled request's tokens do not depend on its lane or
        its neighbours."""
        real = logits[:, :self.model.cfg.vocab]
        tok = pick_lanes(real, self._ldtype, key_base, steps, greedy, temp)
        finite = torch.isfinite(real).all(dim=-1)
        return (tok, finite) + self._saturation_probe(real, calib)

    @staticmethod
    def _request_key(seed: int) -> np.ndarray:
        """``uint32[2]`` ``PRNGKey(seed)``, the root of a request's
        ``fold_in`` stream: two integer operations on the host (the
        reference caches its device dispatch; nothing to cache here)."""
        return sampling.prng_key(seed)

    # -- request-level API -----------------------------------------------------

    def _new_scheduler(self, n_lanes: int, max_len: int,
                       n_pages: Optional[int] = None) -> PagedScheduler:
        scfg = self.scfg
        if not self.model.supports_paged_serving:
            raise NotImplementedError(
                "paged serving needs a decoder-only model of global and "
                "local attention blocks; use generate_with_status() or "
                "generate_with_status_fixed() for this model")
        ppl = -(-max_len // scfg.page_size)
        return PagedScheduler(
            self, n_lanes=n_lanes, pages_per_lane=ppl,
            n_pages=n_pages if n_pages is not None else n_lanes * ppl,
            page_size=scfg.page_size, chunk=scfg.prefill_chunk)

    @property
    def scheduler(self) -> PagedScheduler:
        """The engine's continuous-batching scheduler, built at first use
        from the ServeConfig geometry."""
        if self._sched is None:
            scfg = self.scfg
            self._sched = self._new_scheduler(scfg.n_lanes, scfg.max_seq_len,
                                              scfg.n_pages)
        return self._sched

    def submit(self, request: Request) -> None:
        """Queue one request (admitted into a lane as capacity frees)."""
        self.scheduler.submit(request)

    def step(self, fault_plan=None) -> List[RequestOutput]:
        """One scheduler iteration: admissions, at most one prefill chunk
        per prefilling lane, one decode call, one pick.  Returns the
        requests finished now (also buffered for ``collect()``)."""
        outs = self.scheduler.step(fault_plan)
        self._finished.extend(outs)
        return outs

    def collect(self) -> List[RequestOutput]:
        """Every finished request not collected yet."""
        out, self._finished = self._finished, []
        return out

    @property
    def pending(self) -> bool:
        """True while the scheduler holds queued or active work."""
        return self._sched is not None and self._sched.has_work

    def drain(self, fault_plan=None) -> List[RequestOutput]:
        """Step until idle; returns every output finished along the way
        (buffered ones included)."""
        self._finished.extend(self.scheduler.run_to_completion(fault_plan))
        return self.collect()

    def _shim_scheduler(self, n_lanes: int, prompt_len: int,
                        max_new: int) -> PagedScheduler:
        """Fixed-geometry scheduler for the ``generate(batch)`` shim: one
        lane per batch row and a pool every row admits into at once,
        cached per (lanes, prompt, budget)."""
        key = (n_lanes, prompt_len, max_new)
        sched = self._shim_cache.get(key)
        if sched is None:
            sched = self._new_scheduler(n_lanes, prompt_len + max_new)
            while len(self._shim_cache) >= 4:
                self._shim_cache.pop(next(iter(self._shim_cache)))
            self._shim_cache[key] = sched
        return sched

    # -- batch-shaped generation -------------------------------------------------

    def generate(self, batch: Dict[str, torch.Tensor], seed: int = 0
                 ) -> np.ndarray:
        """batch['tokens'] [B, S] -> generated tokens [B, <= max_new]."""
        return self.generate_with_status(batch, seed).tokens

    def generate_with_status(self, batch: Dict[str, torch.Tensor],
                             seed: int = 0, fault_plan=None
                             ) -> GenerateResult:
        """Guarded generation with structured per-lane outcomes: each batch
        row becomes a Request (the ServeConfig's sampling, ``seed`` for
        every row) on a cached fixed-geometry scheduler and the
        RequestOutputs are reassembled into a GenerateResult.  A model the
        scheduler cannot serve falls through to
        ``generate_with_status_fixed`` (the reference's ``engine.py:544``).
        ``fault_plan`` (a ``robust.FaultPlan``) injects faults; None leaves
        the loop as it is."""
        if not self.model.supports_paged_serving:
            return self.generate_with_status_fixed(batch, seed, fault_plan)
        scfg = self.scfg
        plan = fault_plan if (fault_plan is not None
                              and fault_plan.enabled) else None
        if plan is not None:
            plan.on_generate_start()
        toks = np.asarray(batch["tokens"])
        b_full = toks.shape[0]
        if toks.ndim != 2 or toks.shape[1] == 0:
            # a zero-length prompt can never seed a pick: shed the batch
            return GenerateResult(
                tokens=np.zeros((b_full, 0), np.int32),
                status=[STATUS_SHED] * b_full,
                fault_step=np.full((b_full,), -1, np.int64),
                n_steps=0, timed_out=False, admitted=0)
        admit = b_full if scfg.max_lanes is None \
            else min(b_full, scfg.max_lanes)
        sp = scfg.sampling_defaults()
        sched = self._shim_scheduler(admit, toks.shape[1],
                                     sp.max_new_tokens)
        sched.reset_fault_state()
        for r in range(admit):
            sched.submit(Request(id=r, tokens=toks[r], sampling=sp,
                                 seed=seed))
        try:
            outs = sched.run_to_completion(plan)
        except Exception:
            # a raise mid-drain leaves lanes mapped: drop the scheduler
            self._shim_cache = {k: v for k, v in self._shim_cache.items()
                                if v is not sched}
            raise
        n_steps = max((len(o.tokens) for o in outs), default=0)
        tokens = np.full((b_full, n_steps), scfg.pad_id, np.int32)
        status = np.array([STATUS_SHED] * b_full, dtype=object)
        fault_step = np.full((b_full,), -1, np.int64)
        for o in outs:
            tokens[o.id, :len(o.tokens)] = o.tokens
            status[o.id] = o.status
            fault_step[o.id] = o.fault_step
        return GenerateResult(tokens=tokens, status=list(status),
                              fault_step=fault_step, n_steps=n_steps,
                              timed_out=sched.timed_out, admitted=admit)

    def generate_with_status_fixed(self, batch: Dict[str, torch.Tensor],
                                   seed: int = 0, fault_plan=None
                                   ) -> GenerateResult:
        """The lockstep fixed-batch loop over a dense cache: every lane
        prefills (K4) and decodes (K5; a local layer's ring buffer
        outside the kernels) in step.  Kept as the reference the scheduler
        shim's greedy tokens are held equal to (bitwise for global-only
        models; with local layers the ring and the paged lane sum in other
        orders, so only the tokens are held equal).  The guards are the
        scheduler's: ``request_timeout_s``, counted from the end of the
        prefill, times out every running lane at the top of a step; with
        int8 each lane's first logits calibrate its saturation probe, and
        a degraded lane picks from the float model's logits under
        ``fp32_fallback``.  Whisper's batch carries ``frames`` [B, F, D],
        which the prefill encodes, and paligemma's ``patches`` [B, P, D],
        which it puts in front of the tokens: the prompt is then P + S
        positions long.  A sampled config (``greedy=False``)
        draws every lane's pick from one key: ``PRNGKey(seed)`` for token
        0, then ``key, pick_key = split(key)`` after each decode step (a
        degraded lane picks from the float logits with the same key).
        ``fault_plan`` stalls the host before a step and poisons the
        logits before its pick."""
        scfg = self.scfg
        plan = fault_plan if (fault_plan is not None
                              and fault_plan.enabled) else None
        if plan is not None:
            plan.on_generate_start()
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
        frames, patches = (None if batch.get(k) is None
                           else torch.as_tensor(batch[k])[:admit]
                           for k in ("frames", "patches"))
        # the patches are positions of the prompt (engine.py:625)
        prompt_len = toks.shape[1] + self.model.cfg.prefix_tokens
        logits, cache = self.model.prefill(
            toks, max_len=prompt_len + scfg.max_new_tokens, frames=frames,
            patches=patches)
        # the clock starts once prefill has returned: the budget bounds the
        # decode loop, not the first call's kernel build
        deadline = (time.monotonic() + scfg.request_timeout_s
                    if scfg.request_timeout_s is not None else None)

        status = np.array([STATUS_OK] * admit, dtype=object)
        fault_step = np.full((admit,), -1, np.int64)
        done = np.zeros((admit,), bool)
        degraded = np.zeros((admit,), bool)
        timed_out = False
        calib = None          # each lane's first-logits absmax (int8 probe)
        fp_logits = None      # the float model's logits for degraded lanes
        guards_on = scfg.guards and scfg.on_nonfinite != "off"
        sat_on = scfg.guards and scfg.int8
        dev = self.model.device
        # the sampled loop's key: token 0 picks with the unsplit key; a
        # greedy loop draws nothing and carries no key
        key = (None if scfg.greedy
               else sampling.key_tensor(sampling.prng_key(seed), dev))
        pick_key = key
        out: List[np.ndarray] = []
        for i in range(scfg.max_new_tokens):
            if plan is not None:
                plan.maybe_stall(i)
            if deadline is not None and time.monotonic() > deadline:
                running = ~done
                status[running] = STATUS_TIMEOUT
                fault_step[running & (fault_step < 0)] = i
                timed_out = True
                break
            if plan is not None:
                logits = plan.perturb_logits(i, logits)
            if guards_on or sat_on:
                cal = None
                if sat_on:
                    cal = (torch.ones((admit,), dtype=torch.float32,
                                      device=dev) if calib is None else calib)
                tok, finite, absmax, sat = self._pick_and_probe(
                    logits, pick_key, cal)
                fin_np = finite.cpu().numpy()
            else:
                tok = self._pick(logits, pick_key)
            if fp_logits is not None:
                # degraded lanes pick from the float model's logits with
                # the same key
                tok_fp = self._pick(fp_logits, pick_key)
                tok = torch.where(torch.from_numpy(degraded).to(dev), tok_fp,
                                  tok)
            tok_np = tok.cpu().numpy()
            if guards_on:
                newly_bad = ~fin_np & ~done
                if newly_bad.any():
                    lanes = np.flatnonzero(newly_bad)
                    if scfg.on_nonfinite == "raise":
                        raise NumericalHealthError(
                            f"non-finite logits at decode step {i} in "
                            f"lanes {lanes.tolist()}")
                    status[newly_bad] = STATUS_NONFINITE
                    fault_step[newly_bad & (fault_step < 0)] = i
            if sat_on:
                if calib is None:
                    # each lane's first logits calibrate its probe
                    calib = torch.clamp(absmax, min=1e-6)
                else:
                    newly_sat = ((sat.cpu().numpy()
                                  > scfg.saturation_threshold)
                                 & ~degraded & ~done & fin_np)
                    if newly_sat.any():
                        degraded |= newly_sat
                        mark = newly_sat & (status == STATUS_OK)
                        status[mark] = STATUS_DEGRADED
                        fault_step[mark & (fault_step < 0)] = i
            quarantined = status == STATUS_NONFINITE
            if quarantined.any():
                tok_np = np.where(quarantined, scfg.pad_id,
                                  tok_np).astype(tok_np.dtype)
            out.append(tok_np)
            if scfg.eos_id is not None:
                done = done | (tok_np == scfg.eos_id)
            done = done | quarantined
            if done.all() or i == scfg.max_new_tokens - 1:
                break
            tok_dev = torch.from_numpy(tok_np)[:, None]
            fp_logits = None
            if degraded.any() and self.fp_model is not None:
                # before the int8 step, on a fork of the same cache: the
                # float step writes its K/V at this position, which the
                # int8 step then overwrites before any later step reads
                # it, and advances only the fork's recurrent states
                fp_logits, _ = self.fp_model.decode_step(cache.fork(),
                                                         tok_dev,
                                                         prompt_len + i)
            logits, cache = self.model.decode_step(cache, tok_dev,
                                                   prompt_len + i)
            if key is not None:
                key, pick_key = sampling.split(key)

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
                              timed_out=timed_out, admitted=admit)
