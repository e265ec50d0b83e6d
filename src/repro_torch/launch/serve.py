"""Serving launcher: fixed-batch greedy generation with a dense KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --smoke --device cpu

Runs on the CUDA card unless ``--device cpu``; weights are random, drawn
from ``--seed`` on the device.  Prints the prefill time, the decode time
per step, tokens/s and every request's status.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.lm import Model
from repro_torch.serve.engine import ServeConfig, ServeEngine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg, device=device).init_weights(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen)
    eng = ServeEngine(model, ServeConfig(max_new_tokens=args.max_new))

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, max_len=args.prompt_len
                                  + args.max_new)
    _sync(device)
    t1 = time.perf_counter()
    tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
    for i in range(args.max_new - 1):
        logits, cache = model.decode_step(cache, tok, args.prompt_len + i)
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
    _sync(device)
    t2 = time.perf_counter()
    res = eng.generate_with_status({"tokens": tokens})
    _sync(device)
    t3 = time.perf_counter()
    steps = max(args.max_new - 1, 1)
    print(f"{cfg.name} on {device}: prefill {1e3 * (t1 - t0):.3f} ms, "
          f"decode {1e3 * (t2 - t1) / steps:.3f} ms/step, "
          f"generate {res.tokens.size / (t3 - t2):.1f} tok/s")
    for lane, (st, fs) in enumerate(zip(res.status, res.fault_step)):
        extra = f" (at step {fs})" if fs >= 0 else ""
        print(f"  lane {lane}: {st}{extra}")
    print(res.tokens[:, :12])


if __name__ == "__main__":
    main()
