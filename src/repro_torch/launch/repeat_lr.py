"""The loss on one repeated batch after a few training steps, under K4's
backward and under the plain backward, on the card.

    PYTHONPATH=src python -m repro_torch.launch.repeat_lr \\
        [--arch gemma2-27b] [--layers 2] [--steps 2] [--repeat 4] \\
        [--lr 1e-3] [--out repeat_lr.json]

Replays ``chip_smoke.py``'s training phase (``train_model``) at full width,
the config cut to ``--layers`` layers: ``Trainer.run`` takes ``--steps``
steps of the synthetic stream (seed 0, 8 x 4096 tokens a step in the
config's microbatches, AdamW at lr 1e-3), then ``--repeat`` steps on the
stream's next batch, repeated, at ``--lr``.  It does so twice from the
same seed: with K4's backward, then with the attention's backward swapped
for the plain one (``ref.flash_attention_bwd_ref_by_kv_head`` at fp32,
cast to bf16).  Where both runs' losses rise at the same step, the rise
comes from the optimizer and the data, not from the kernel.  Prints each
run's losses as JSON.  Needs the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticTokenSource, TokenPipeline
from repro_torch.kernels import ops, ref
from repro_torch.models.lm import Model
from repro_torch.optim import AdamWConfig
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

SEED, BATCH, SEQ, LR = 0, 8, 4096, 1e-3


def plain_bwd(q, k, v, out, lse, dout, **mask):
    """The attention's backward in the plain version, at fp32, in the
    inputs' dtypes."""
    grads = ref.flash_attention_bwd_ref_by_kv_head(q, k, v, out, lse, dout,
                                                   **mask)
    return tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v)))


def run(arch: str, layers: int, steps: int, repeat: int, lr: float) -> dict:
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = Model(cfg)
    dcfg = DataConfig(BATCH, SEQ, SEED)
    src = SyntheticTokenSource(cfg.vocab, SEED)

    def pipes(start):
        return TokenPipeline(src, dcfg, "cuda", cfg, start_step=start)

    ckdir = tempfile.mkdtemp(prefix="repeat_lr_")
    trainer = Trainer(model, AdamWConfig(lr=LR, state_mode=cfg.opt_state_mode),
                      TrainerConfig(steps=steps, ckpt_every=0,
                                    ckpt_dir=ckdir, keep=1, log_every=1),
                      pipes)
    try:
        params, opt = trainer.run(SEED)
        it = pipes(steps)
        _, batch = next(it)
        it.close()
        step_fn = make_train_step(model, AdamWConfig(
            lr=lr, state_mode=cfg.opt_state_mode))
        rep = []
        for _ in range(repeat):
            params, opt, m = step_fn(params, opt, batch)
            rep.append((float(m["loss"]), float(m["grad_norm"])))
        return dict(stream=[(m["loss"], m["grad_norm"])
                            for m in trainer.metrics], repeated=rep)
    finally:
        trainer.ckpt.wait()
        shutil.rmtree(ckdir, ignore_errors=True)
        del trainer, model
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-27b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--repeat", type=int, default=4)
    ap.add_argument("--lr", type=float, default=LR)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("repeat_lr: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    result = dict(card=card, **vars(args))
    kernel_bwd = ops.flash_attention_bwd
    for name, bwd in (("k4_backward", kernel_bwd), ("plain_backward",
                                                     plain_bwd)):
        ops.flash_attention_bwd = bwd
        try:
            result[name] = run(args.arch, args.layers, args.steps,
                               args.repeat, args.lr)
        finally:
            ops.flash_attention_bwd = kernel_bwd
        print(f"{name}: {json.dumps(result[name])}", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
