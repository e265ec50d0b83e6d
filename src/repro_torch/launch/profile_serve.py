"""Where the serving time goes on the card: a ``torch.profiler`` trace of
one prefill and a few decode steps of the fixed-batch path.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch granite-3-8b --out profile_serve.json

Prints, for prefill and for the mean decode step: the host wall time
(synchronized, profiler off), the device busy time (sum of kernel times
from a profiled run of the same calls; one stream, so kernels do not
overlap), the idle share, and the kernels by device time.
Needs the card: the timings are device metrics.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.lm import Model


def _kernel_times(prof) -> dict:
    """Device microseconds by kernel name."""
    out = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.name] += ev.device_time_total if hasattr(
                ev, "device_time_total") else ev.cuda_time_total
    return dict(out)


def _window(fn, reps: int):
    """Host wall time per call without the profiler (synchronized), then
    device kernel times per call from a profiled run of the same calls."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = {k: v / reps for k, v in _kernel_times(prof).items()}
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us,
            "kernels_ms": {k: v / 1e3 for k, v in top}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the card; none is present")

    cfg = get_config(args.arch)
    model = Model(cfg).init_weights(args.seed)
    toks = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                         generator=torch.Generator().manual_seed(args.seed))
    max_len = args.prompt_len + 3 * args.steps + 2
    model.prefill(toks, max_len)                                # warm-up
    prefill = _window(lambda: model.prefill(toks, max_len), 2)
    logits, cache = model.prefill(toks, max_len)
    tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
    state = {"pos": args.prompt_len}

    def step():
        model.decode_step(cache, tok, state["pos"])
        state["pos"] += 1

    step()                                                      # warm-up
    decode = _window(step, args.steps)
    card = torch.cuda.get_device_name(0)
    report = {"card": card, "arch": cfg.name, "batch": args.batch,
              "prompt_len": args.prompt_len, "prefill": prefill,
              "decode_step": decode}
    for phase in ("prefill", "decode_step"):
        r = report[phase]
        print(f"{phase}: wall {r['wall_ms']:.3f} ms, device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share "
              f"{r['idle_share']:.3f}")
        for name, ms in list(r["kernels_ms"].items())[:12]:
            print(f"    {ms:9.4f} ms  {name[:110]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
