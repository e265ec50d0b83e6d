"""Where the serving time goes on the card: ``torch.profiler`` traces of
the fixed-batch path (one prefill, a few decode steps) and of the
continuous-batching scheduler's iterations, bf16 and int8 (where the int8
copy does not fit beside the model, gemma2-27b, the int8 windows run
after the bf16 ones on the model quantized in place,
``quantize_params_for_serving(release=True)``).

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch granite-3-8b --out profile_serve.json
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch gemma2-27b --out profile_serve_gemma2.json
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch gemma3-12b --batch 2 --prompt-len 4160 \
        --out profile_serve_gemma3.json
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch whisper-small --batch 8 --prompt-len 64 \
        --out profile_serve_whisper.json
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch llama4-scout-17b-a16e --layers 8 --batch 2 \
        --prompt-len 8448 --out profile_serve_llama4.json
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch paligemma-3b --batch 8 --prompt-len 512 \
        --out profile_serve_paligemma.json
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch recurrentgemma-9b --batch 2 --prompt-len 4160 \
        --out profile_serve_recurrentgemma.json
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch xlstm-350m --batch 8 --prompt-len 2048 \
        --out profile_serve_xlstm.json
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch grok-1-314b --layers 6 --batch 2 --prompt-len 4160 \
        --out profile_serve_grok.json

Prints, for each window (fixed prefill, fixed decode step, and per engine
a scheduler iteration that prefills one chunk on every lane and one that
only decodes): the host wall time (synchronized, profiler off), the device
busy time (sum of kernel times from a profiled run of the same calls from
the same starting state; one stream, so kernels do not overlap), the idle
share, and the kernels by device time.  The fixed windows run on the int8
copy too wherever it fits beside the model.  whisper-small (an
encoder-decoder), paligemma-3b (a prefix-LM), recurrentgemma-9b (RG-LRU
states) and xlstm-350m (mLSTM and sLSTM states; ``--prompt-len`` below 64
or a multiple of 64), served by the fixed loop only, have the fixed
windows, bf16 and int8 (xlstm's int8 copy quantizes nothing: its windows
are the bf16 ones, and are not run twice): whisper's prefill window
holds the encoder over the batch's clips (``launch.serve.make_frames``),
and its decode step recomputes the cross-attention K/V from the held
encoder output; paligemma's prompt is its images' patches
(``launch.serve.make_patches``) and ``--prompt-len`` minus them text
tokens.  llama4-scout and grok-1 (``--layers`` cuts their depth) have
the fixed and the scheduler windows, their int8 copies the attention's
only.  Needs the card: the timings are device metrics.
"""
from __future__ import annotations

import argparse
import itertools
import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.quantize import QuantizedWeight
from repro_torch.launch.serve import (geometry, int8_fits, make_frames,
                                      make_patches, with_layers)
from repro_torch.models.lm import Model
from repro_torch.serve.api import Request, SamplingParams
from repro_torch.serve.engine import ServeConfig, ServeEngine


# the scheduler windows' prompts: 7 chunks of 64 on every lane
SCHED_PROMPT = 448


def _kernel_times(prof) -> dict:
    """Device microseconds by kernel name."""
    out = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.name] += ev.device_time_total if hasattr(
                ev, "device_time_total") else ev.cuda_time_total
    return dict(out)


def _window(fn, reps: int, setup):
    """Host wall time per call without the profiler (synchronized), then
    device kernel times per call from a profiled run of the same calls:
    ``setup`` brings the state to the window's start before each half, so
    both halves do the same work."""
    setup()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6 / reps
    setup()
    torch.cuda.synchronize()
    # the card's activity alone: the kernel times need no host events, and
    # a long prompt's window (xlstm's 2 x 8192: about a million launches)
    # would not finish its host-side trace in ten minutes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = {k: v / reps for k, v in _kernel_times(prof).items()}
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us,
            "kernels_ms": {k: v / 1e3 for k, v in top}}


def _fixed(model, cfg, args) -> dict:
    """``--prompt-len`` positions: a prefix-LM's patches, then text."""
    toks = torch.randint(0, cfg.vocab,
                         (args.batch, args.prompt_len - cfg.prefix_tokens),
                         generator=torch.Generator().manual_seed(args.seed))
    inputs = {}
    if cfg.encdec:
        inputs["frames"] = make_frames(cfg, args.batch, args.seed)
    if cfg.prefix_tokens:
        inputs["patches"] = make_patches(cfg, args.batch, args.seed)
    max_len = args.prompt_len + args.steps + 2
    model.prefill(toks, max_len, **inputs)                      # warm-up
    prefill = _window(lambda: model.prefill(toks, max_len, **inputs),
                      2, lambda: None)
    state = {}

    def start():
        """A fresh cache after the prompt, and one decode step."""
        logits, state["cache"] = model.prefill(toks, max_len, **inputs)
        state["tok"] = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
        state["pos"] = args.prompt_len
        step()

    def step():
        model.decode_step(state["cache"], state["tok"], state["pos"])
        state["pos"] += 1

    return {"prefill": prefill,
            "decode_step": _window(step, args.steps, start)}


def _scheduler(model, cfg, args, int8: bool) -> dict:
    """One lane per request, every prompt SCHED_PROMPT long: the first
    iterations prefill a 64-token chunk on every lane, the later ones only
    decode.  Each window starts from a fresh wave of the same requests."""
    geom = geometry(cfg.name)
    eng = ServeEngine(model, ServeConfig(int8=int8, **geom))
    sched = eng.scheduler
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, SCHED_PROMPT)
               for _ in range(geom["n_lanes"])]
    waves = itertools.count()

    def fill():
        """Retire what runs, submit a new wave and run the iteration that
        admits it and prefills its first chunk."""
        eng.drain()
        base = next(waves) * len(prompts)
        for i, p in enumerate(prompts):
            eng.submit(Request(id=base + i, tokens=p, sampling=SamplingParams(
                max_new_tokens=args.steps + 4)))
        eng.step()

    def to_decode():
        fill()
        while any(a is None or not a.prefilled for a in sched.lanes):
            eng.step()
        eng.step()                                 # the first decode

    fill()                                         # warm-up
    to_decode()
    out = {"chunk_iteration": _window(eng.step, 2, fill),
           "decode_iteration": _window(eng.step, args.steps, to_decode)}
    if not all(a is not None and a.prefilled for a in sched.lanes):
        raise RuntimeError("a lane retired inside the decode window")
    eng.drain()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="profile the config's first N layers")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the card; none is present")
    geom = geometry(args.arch)
    if SCHED_PROMPT + args.steps + 4 > geom["max_seq_len"]:
        raise SystemExit("--steps too large for the scheduler's lanes")

    cfg = with_layers(get_config(args.arch), args.layers)
    model = Model(cfg).init_weights(args.seed)
    report = {"card": torch.cuda.get_device_name(0), "arch": cfg.name,
              "layers": cfg.n_layers, "batch": args.batch,
              "prompt_len": args.prompt_len,
              "lanes": geom["n_lanes"], "sched_prompt": SCHED_PROMPT,
              "fixed": _fixed(model, cfg, args)}
    if int8_fits(cfg, model.device, fp32_fallback=True):
        # the fixed windows on the int8 copy beside the model too, where
        # the copy quantizes anything
        q8 = model.quantize_params_for_serving()
        if any(isinstance(m, QuantizedWeight) for m in q8.modules()):
            report["fixed_int8"] = _fixed(q8, cfg, args)
        del q8
        torch.cuda.empty_cache()
    if model.supports_paged_serving:
        report["scheduler_bf16"] = _scheduler(model, cfg, args, False)
        torch.cuda.empty_cache()
        if not int8_fits(cfg, model.device, fp32_fallback=True):
            # the copy does not fit beside the model: quantize it in place
            model = model.quantize_params_for_serving(release=True)
        report["scheduler_int8"] = _scheduler(model, cfg, args, True)
    windows = [(group, phase) for group in
               ("fixed", "fixed_int8", "scheduler_bf16", "scheduler_int8")
               if group in report for phase in report[group]]
    for group, phase in windows:
        r = report[group][phase]
        print(f"{group} {phase}: wall {r['wall_ms']:.3f} ms, device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share "
              f"{r['idle_share']:.3f}")
        for name, ms in list(r["kernels_ms"].items())[:12]:
            print(f"    {ms:9.4f} ms  {name[:110]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
