"""Deterministic, resumable token data on one process, the port of the
reference's ``data/pipeline.py``.

``SyntheticTokenSource`` is the reference's counter-based stream: token
(step, row, position) is a 64-bit splitmix-style mix of the seed, the
step and ``row * 1_000_003 + position``, modulo ``max(2, vocab - 2)``, in
the same uint64 numpy arithmetic, so its batches are the reference's bit
for bit and step N is reproducible from scratch (which is what makes a
resumed run exact).  ``MemmapTokenSource`` reads a flat int32 token file,
strided by (step, row) as the reference's.  ``TokenPipeline`` builds each
step's batch on a background thread, ``prefetch`` steps ahead: tokens and
targets (the window shifted by one), paligemma's patches and whisper's
frames drawn from the reference's numpy seeds, placed on the model's
device as torch tensors (int32 tokens, fp32 patches and frames).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    prefetch: int = 2


def _mix(a: np.ndarray, b: int) -> np.ndarray:
    # 64-bit splitmix-style mixing, vectorized (the reference's)
    x = (a ^ np.uint64(b)) * np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    return x


class SyntheticTokenSource:
    """tokens[step, row, pos] = f(seed, step, row, pos) mod vocab."""

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        self.seed = seed

    def batch(self, step: int, rows: slice, cfg: DataConfig) -> np.ndarray:
        r0, r1 = rows.start, rows.stop
        rr = np.arange(r0, r1, dtype=np.uint64)[:, None]
        pp = np.arange(cfg.seq_len + 1, dtype=np.uint64)[None, :]
        base = _mix(rr * np.uint64(1_000_003) + pp,
                    (self.seed << 20) ^ step)
        return (base % np.uint64(max(2, self.vocab - 2))).astype(np.int32)


class MemmapTokenSource:
    """Flat int32 token file; document order strided deterministically."""

    def __init__(self, path: str, vocab: int):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.vocab = vocab

    def batch(self, step: int, rows: slice, cfg: DataConfig) -> np.ndarray:
        n = len(self.tokens)
        width = cfg.seq_len + 1
        out = np.empty((rows.stop - rows.start, width), np.int32)
        for i, r in enumerate(range(rows.start, rows.stop)):
            start = ((step * cfg.global_batch + r) * width) % max(
                1, n - width)
            out[i] = self.tokens[start:start + width]
        return out


class TokenPipeline:
    """Iterator of ``(step, batch)`` from ``start_step`` on, the batches
    built ``cfg.prefetch`` steps ahead on a daemon thread and placed on
    ``device``; ``close`` stops it."""

    def __init__(self, source, cfg: DataConfig, device=None,
                 arch: Optional[ArchConfig] = None, start_step: int = 0):
        self.source = source
        self.cfg = cfg
        self.device = torch.device("cpu" if device is None else device)
        self.arch = arch
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _build(self, step: int) -> Dict[str, np.ndarray]:
        # one process: the whole global batch
        toks = self.source.batch(step, slice(0, self.cfg.global_batch),
                                 self.cfg)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        arch = self.arch
        if arch is not None and arch.prefix_tokens:
            rng = np.random.default_rng(self.cfg.seed * 7919 + step)
            batch["patches"] = rng.standard_normal(
                (toks.shape[0], arch.prefix_tokens, arch.d_model),
                np.float32)
            text = self.cfg.seq_len - arch.prefix_tokens
            batch["tokens"] = batch["tokens"][:, :text]
            batch["targets"] = batch["targets"][:, :text]
        if arch is not None and arch.encdec:
            rng = np.random.default_rng(self.cfg.seed * 104729 + step)
            batch["frames"] = rng.standard_normal(
                (toks.shape[0], arch.enc_frames, arch.d_model), np.float32)
        return batch

    def _place(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                item = (step, self._place(self._build(step)))
            except Exception as e:  # surfaced in the consumer
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        self.step = item[0] + 1
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
