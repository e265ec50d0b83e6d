"""The fault-tolerant training loop, the port of the reference's
``train/trainer.py`` on one device.

* Periodic asynchronous checkpoints of ``(params, opt)`` through the
  port's ``checkpoint.CheckpointManager``, in the reference's tree and
  on-disk format (``convert.to_jax_params`` / ``opt_to_jax``; int8 moments
  as their ``{"q", "s"}`` leaves), so either package restores the other's
  fp32 training state.
* Restart from the latest checkpoint on a failed step (a ``RuntimeError``,
  which a CUDA fault raises too), at most ``max_retries`` times; the data
  pipeline is rebuilt at the restored step and replays the same stream.
* The straggler watchdog: an EMA of the step time, and the steps slower
  than ``straggler_factor`` times it.
* Failure injection for tests: ``fail_at_step``, or the reference's
  environment variable ``REPRO_FAIL_AT_STEP`` (read as the reference reads
  it), raises inside that step once.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import (from_jax_params, opt_from_jax, opt_to_jax,
                                 to_jax_params)
from repro_torch.models.lm import Model
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    max_retries: int = 2
    straggler_factor: float = 3.0
    ema_alpha: float = 0.2
    log_every: int = 10
    fail_at_step: Optional[int] = None  # failure injection (tests)


class StragglerWatchdog:
    """EMA-based step-time anomaly detector."""

    def __init__(self, factor: float, alpha: float):
        self.factor = factor
        self.alpha = alpha
        self.ema: Optional[float] = None
        self.events: List[Dict[str, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        if slow:
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
            log.warning("straggler: step %d took %.3fs (ema %.3fs)",
                        step, dt, self.ema)
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        return slow


class Trainer:
    def __init__(self, model: Model, opt_cfg: AdamWConfig,
                 tcfg: TrainerConfig, pipeline_factory: Callable[[int], Any]):
        """``pipeline_factory(start_step)`` -> iterator of ``(step,
        batch)``; called again after every restart so the data resumes
        deterministically."""
        self.model = model
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.pipeline_factory = pipeline_factory
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.watchdog = StragglerWatchdog(tcfg.straggler_factor,
                                          tcfg.ema_alpha)
        self.step_fn = make_train_step(model, opt_cfg)
        self.metrics: List[Dict[str, float]] = []

    # -- state ------------------------------------------------------------------

    def init_state(self, seed: int = 0):
        params = self.model.init_weights(seed).train_params()
        return params, init_opt_state(params, self.opt_cfg)

    def save(self, step: int, params, opt) -> None:
        cfg = self.model.cfg
        self.ckpt.save(step, (to_jax_params(cfg, params),
                              opt_to_jax(cfg, opt)))

    def restore(self):
        """``(step, params, opt)`` of the latest checkpoint: the parameters
        loaded into the model (in place) and taken as ``train_params``, the
        optimizer state placed on the model's device."""
        cfg, dev = self.model.cfg, self.model.device
        step, (ptree, otree) = self.ckpt.restore(None)
        with torch.no_grad():
            self.model.load_state_dict(from_jax_params(cfg, ptree))
        opt = opt_from_jax(cfg, otree)

        def place(t):
            return ({k: place(v) for k, v in t.items()}
                    if isinstance(t, dict) else t.to(dev))
        return step, self.model.train_params(), place(opt)

    # -- loop -------------------------------------------------------------------

    def run(self, seed: int = 0):
        tcfg = self.tcfg
        if self.ckpt.latest_step() is not None:
            start, params, opt = self.restore()
            log.info("resumed from checkpoint step %d", start)
        else:
            params, opt = self.init_state(seed)
            start = 0

        retries = 0
        step = start
        pipe = self.pipeline_factory(step)
        it = iter(pipe)
        fail_at = tcfg.fail_at_step
        if fail_at is None and os.environ.get("REPRO_FAIL_AT_STEP"):
            fail_at = int(os.environ["REPRO_FAIL_AT_STEP"])

        while step < tcfg.steps:
            try:
                data_step, batch = next(it)
                assert data_step == step, (data_step, step)
                t0 = time.time()
                if fail_at is not None and step == fail_at:
                    fail_at = None  # fail once
                    raise RuntimeError("injected node failure")
                params, opt, m = self.step_fn(params, opt, batch)
                loss = float(m["loss"])
                dt = time.time() - t0
                self.watchdog.observe(step, dt)
                self.metrics.append({"step": step, "loss": loss, "dt": dt,
                                     "grad_norm": float(m["grad_norm"])})
                if step % tcfg.log_every == 0:
                    log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
                step += 1
                if step % tcfg.ckpt_every == 0 or step == tcfg.steps:
                    self.save(step, params, opt)
            except RuntimeError as e:
                retries += 1
                log.error("step %d failed (%s); retry %d/%d", step, e,
                          retries, tcfg.max_retries)
                if retries > tcfg.max_retries:
                    raise
                self.ckpt.wait()
                if self.ckpt.latest_step() is not None:
                    step, params, opt = self.restore()
                else:
                    params, opt = self.init_state(seed)
                    step = 0
                if hasattr(pipe, "close"):
                    pipe.close()
                pipe = self.pipeline_factory(step)
                it = iter(pipe)

        self.ckpt.wait()
        if hasattr(pipe, "close"):
            pipe.close()
        return params, opt
