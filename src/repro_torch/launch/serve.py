"""Serving launcher: fixed-batch greedy generation over a dense KV cache,
or continuous batching over the paged KV cache (``--requests N``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --requests 16 [--int8]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --smoke --device cpu [--requests 6]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
        [--requests 8] [--int8] [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
        [--requests 8] [--int8] [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
        [--batch 8 --prompt-len 64 --max-new 64] [--int8] \
        [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama4-scout-17b-a16e --layers 8 \
        [--batch 2 --prompt-len 8448] [--requests 8] [--int8] \
        [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \
        [--batch 8 --prompt-len 512 --max-new 32] [--int8] \
        [--smoke --device cpu --prompt-len 16]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b [--batch 2 --prompt-len 4160] [--int8] \
        [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \
        [--batch 8 --prompt-len 2048 --max-new 32] [--int8] \
        [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b \
        --layers 6 [--batch 2 --prompt-len 4160] [--requests 8] [--int8] \
        [--smoke --device cpu]

Drills (the reference's flags): lane 1 gets NaN logits at step 2 and is
quarantined while its peers finish, the first call fails once and is
retried, and step 4 stalls past the budget:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --inject-nan 2:1 --inject-transient 1 --inject-stall 4:3 \
        --timeout-s 2

Runs on the CUDA card unless ``--device cpu``; weights are random, drawn
from ``--seed`` on the device.  The fixed mode times one prefill and the
decode steps of the dense loop, then runs ``generate_with_status`` (the
scheduler's shim; an encoder-decoder or a prefix-LM falls through to the
fixed loop) under ``generate_with_retry`` with the drill flags'
``FaultPlan``, and prints tokens/s and every lane's status and fault
step.  The continuous mode submits ``--requests`` requests at once,
prompt lengths and token budgets drawn from ``--seed``, to a scheduler of
8 lanes (``geometry(arch)``; a smoke config's lanes are ``GEOMETRY``'s
512 positions), steps it until every request has finished,
and prints the time to first token, the time per decode-only iteration,
tokens/s and every request's status.

``--int8`` serves every model of the port.  Without ``--fp32-fallback``
the model is quantized in place, each block's bf16 projections released
as soon as its int8 copy exists (``Model.quantize_params_for_serving(
release=True)``): gemma2-27b's 54.5 GB of bf16 weights become 28.4 GB,
the peak about the bf16 model plus one block.  ``--fp32-fallback`` keeps
the bf16 model beside the int8 copy; ``int8_fits`` refuses what the card
cannot hold (gemma2-27b then).  An MoE model's int8 copy quantizes the
attention's ``wqkv`` and ``wo`` only, as the reference's does.

whisper-small (an encoder-decoder) takes frame embeddings as its input, one
clip of ``enc_frames`` frames a batch row drawn N(0, 1) from ``--seed``
(the stubbed conv frontend); paligemma-3b (a prefix-LM) takes
``prefix_tokens`` patch embeddings a batch row drawn the same way (the
stubbed SigLIP tower) in front of ``--prompt-len`` minus
``prefix_tokens`` text tokens.  Both are served by the fixed loop only:
``generate_with_status`` falls through to it, and ``--requests`` is
refused; so is recurrentgemma-9b (26 RG-LRU blocks, whose recurrent state
has no pages, and 12 local-attention blocks; 18.8 GB of weights at bf16,
20.6 GB as the port holds them, the mixers' gates at fp32), and so is
xlstm-350m (21 mLSTM and 3 sLSTM blocks, 1.07 GB as the port holds them;
its ``--prompt-len`` must be below 64 or a multiple of 64, the
reference's chunkwise prefill, ROADMAP F10; its int8 copy quantizes
nothing, every weight being a recurrent mixer's).
llama4-scout-17b-a16e (MoE, 3 chunked layers to 1 global,
window 8192) is 211 GB in bf16 at its 48 layers: ``--layers N`` serves
its first N at full width (``dataclasses.replace(cfg, n_layers=N)``; 8
layers are 37.3 GB).  grok-1-314b (MoE, 8 experts top-2, 64 global
layers) is 631 GB: ``--layers 6`` serves 60.65 GB of it at full width,
and 7 layers leave no room for a prefill's expert transients; its int8
copy quantizes ``wqkv`` and ``wo`` (0.53 GB), its experts stay bf16.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import _cuda
from repro_torch.kernels.quantize import QuantizedWeight
from repro_torch.models.lm import Block, Model, check_prefill_len
from repro_torch.robust import (FaultPlan, LogitFault, StallFault,
                                generate_with_retry)
from repro_torch.serve.api import Request, SamplingParams
from repro_torch.serve.engine import ServeConfig, ServeEngine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_requests(vocab: int, n: int, seed: int, prompt_range=(32, 448),
                  new_range=(16, 32)) -> List[Request]:
    """``n`` greedy requests with prompt lengths and token budgets drawn
    uniformly (inclusive) from the ranges, tokens from ``seed``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
        new = int(rng.integers(new_range[0], new_range[1] + 1))
        reqs.append(Request(id=i, tokens=rng.integers(0, vocab, plen),
                            sampling=SamplingParams(max_new_tokens=new)))
    return reqs


def serve_requests(engine: ServeEngine, requests: List[Request],
                   fault_plan=None) -> Dict:
    """Submit every request at once and step the engine's scheduler until
    all have finished.  Host clock around synchronized iterations: each
    request's time to first token (from the submit), the wall time of
    every iteration and whether it ran a prefill chunk.  Returns those
    with the outputs by request id, and the kernel launches of the last
    iteration that ran no chunk (``decode_launches``, from
    ``kernels._cuda.LAUNCHES``).  ``fault_plan`` rides every step."""
    dev = engine.model.device
    sched = engine.scheduler
    _sync(dev)
    t0 = time.perf_counter()
    for r in requests:
        engine.submit(r)
    ttft: Dict = {}
    iters = []
    outs = {}
    decode_launches = None
    while engine.pending:
        chunk = any(a is not None and not a.prefilled
                    for a in sched.lanes) or (
            bool(sched.queue) and any(a is None for a in sched.lanes))
        before = dict(_cuda.LAUNCHES)
        t = time.perf_counter()
        for o in engine.step(fault_plan):
            outs[o.id] = o
        _sync(dev)
        now = time.perf_counter()
        iters.append((now - t, chunk))
        if not chunk:
            decode_launches = {k: n - before.get(k, 0)
                               for k, n in _cuda.LAUNCHES.items()
                               if n != before.get(k, 0)}
        for a in sched.lanes:
            if a is not None and a.tokens and a.req.id not in ttft:
                ttft[a.req.id] = now - t0
        for rid, o in outs.items():
            if o.tokens.size and rid not in ttft:
                ttft[rid] = now - t0
    wall = time.perf_counter() - t0
    engine.collect()
    decode = [s for s, c in iters if not c]
    n_tok = sum(o.tokens.size for o in outs.values())
    return dict(outputs=outs, ttft_s=ttft, wall_s=wall, iterations=len(iters),
                decode_ms_per_iter=(1e3 * sum(decode) / len(decode)
                                    if decode else None),
                chunk_iterations=len(iters) - len(decode),
                generated=n_tok, tokens_per_s=n_tok / wall,
                decode_launches=decode_launches)


# continuous batching: 8 lanes of up to 512 positions, 16-slot pages,
# 64-token prefill chunks; prompts of 32-448 tokens, budgets of 16-32
GEOMETRY = dict(n_lanes=8, page_size=16, prefill_chunk=64, max_seq_len=512)
# gemma2-27b: the same lanes, pages and chunks; lanes of up to 4192
# positions (a 4160-token prompt past its 4096 window, and 32 new tokens),
# and a pool of 512 pages shared by them (3.1 GB over 46 layers) instead
# of eight full lanes' 2096
GEMMA2_GEOMETRY = dict(GEOMETRY, max_seq_len=4192, n_pages=512)
# gemma3-12b: gemma2's lanes and shared pool (1.6 GB over 48 layers at its
# 8 kv heads of 256), so a 4160-token prompt runs past its 1024 window
GEMMA3_GEOMETRY = dict(GEMMA2_GEOMETRY)
# llama4-scout: lanes of up to 8224 positions (a prompt of 8180 tokens
# decoding past its 8192-position chunk), a pool of 1024 pages shared by
# them (0.54 GB over 8 layers at its 8 kv heads of 128)
LLAMA4_GEOMETRY = dict(GEOMETRY, max_seq_len=8224, n_pages=1024)
# grok-1: gemma2's lanes and shared pool (0.2 GB over 6 layers at its 8 kv
# heads of 128), so request 0 takes the fixed loop's 4160-token prompt
GROK_GEOMETRY = dict(GEMMA2_GEOMETRY)
PROMPT_RANGE, NEW_RANGE = (32, 448), (16, 32)


def geometry(arch: str, smoke: bool = False) -> dict:
    """The scheduler geometry ``--arch`` is served with.  A smoke config
    (window 16) runs past its window in ``GEOMETRY``'s 512-position lanes;
    the long lanes are for the full configs' windows."""
    if smoke:
        return GEOMETRY
    if arch.startswith("gemma2"):
        return GEMMA2_GEOMETRY
    if arch.startswith("gemma3"):
        return GEMMA3_GEOMETRY
    if arch.startswith("llama4"):
        return LLAMA4_GEOMETRY
    if arch.startswith("grok"):
        return GROK_GEOMETRY
    return GEOMETRY


def make_frames(cfg, batch: int, seed: int) -> torch.Tensor:
    """An encoder-decoder's input: ``batch`` clips of ``cfg.enc_frames``
    frame embeddings of ``cfg.d_model``, drawn N(0, 1) in fp32 from
    ``seed`` (the reference's ``launch/serve.py:98-100`` draws the same
    shape; the stubbed conv frontend's output)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((batch, cfg.enc_frames, cfg.d_model), generator=gen)


def make_patches(cfg, batch: int, seed: int) -> torch.Tensor:
    """A prefix-LM's input: ``batch`` images of ``cfg.prefix_tokens``
    patch embeddings of ``cfg.d_model``, drawn N(0, 1) in fp32 from
    ``seed`` (the reference's ``launch/serve.py:95-97`` draws the same
    shape; the stubbed SigLIP tower's output)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((batch, cfg.prefix_tokens, cfg.d_model),
                       generator=gen)


def with_layers(cfg, layers):
    """``cfg`` cut to its first ``layers`` layers (None: all of them), the
    only cut the launchers make; wider than the config is refused."""
    if layers is None or layers == cfg.n_layers:
        return cfg
    if not 1 <= layers <= cfg.n_layers:
        raise ValueError(f"{cfg.name} has {cfg.n_layers} layers, asked for "
                         f"{layers}")
    return dataclasses.replace(cfg, n_layers=layers)


def _nbytes(tensors) -> int:
    return sum(t.nbytes for t in tensors)


def int8_peak_bytes(cfg, fp32_fallback: bool = False) -> int:
    """The weight bytes the int8 build of ``cfg`` holds at its peak,
    reckoned on the meta device (no memory is touched): the float model
    (every weight at its own dtype: bf16 projections, or a float32
    config's fp32 masters)
    and, with ``fp32_fallback``, every block's int8 copy beside it; without
    it the release path's float model plus the largest block's int8 copy
    (blocks differ: an RG-LRU block's copy is its MLP alone, its mixer
    shared; an xLSTM block's is empty).  A block's int8 copy is its ``QuantizedWeight``s (int8 values
    and f32 column scales); what it shares is not counted twice."""
    model = Model(cfg, device="meta")
    copies = [_nbytes(b for m in Block.quantized(
                          blk, cfg, model.compute_dtype).modules()
                      if isinstance(m, QuantizedWeight) for b in m.buffers())
              for blk in model.blocks]
    return (_nbytes(model.state_dict().values())
            + (sum(copies) if fp32_fallback else max(copies)))


def int8_fits(cfg, device: torch.device, fp32_fallback: bool = False,
              total: Optional[float] = None) -> bool:
    """Whether the int8 build's peak (``int8_peak_bytes``) leaves a fifth
    of the card (``total`` bytes; default: the card's memory) for caches
    and activations.  The CPU has no such limit here."""
    if total is None:
        if device.type != "cuda":
            return True
        total = torch.cuda.get_device_properties(device).total_memory
    return int8_peak_bytes(cfg, fp32_fallback) < 0.8 * total


def _parse_faults(args) -> Optional[FaultPlan]:
    """The drill flags as a FaultPlan ("step:lane", "step:seconds"), or
    None."""
    logit_faults, stalls = [], []
    for spec in args.inject_nan or ():
        step, lane = spec.split(":")
        logit_faults.append(LogitFault(step=int(step), lanes=(int(lane),),
                                       kind="nan"))
    for spec in args.inject_saturation or ():
        step, lane = spec.split(":")
        logit_faults.append(LogitFault(step=int(step), lanes=(int(lane),),
                                       kind="scale", scale=100.0))
    for spec in args.inject_stall or ():
        step, seconds = spec.split(":")
        stalls.append(StallFault(step=int(step), seconds=float(seconds)))
    if not (logit_faults or stalls or args.inject_transient):
        return None
    return FaultPlan(seed=args.seed, logit_faults=tuple(logit_faults),
                     stalls=tuple(stalls),
                     fail_first_generates=args.inject_transient)


def _guards(args) -> dict:
    """The ServeConfig fields of the guard flags."""
    return dict(int8=args.int8, fp32_fallback=args.fp32_fallback,
                guards=not args.no_guards, request_timeout_s=args.timeout_s,
                max_lanes=args.max_lanes)


def _continuous(args, model, cfg, plan) -> None:
    geom = geometry(cfg.name, args.smoke)
    eng = ServeEngine(model, ServeConfig(**_guards(args), **geom))
    reqs = make_requests(cfg.vocab, args.requests, args.seed, PROMPT_RANGE,
                         NEW_RANGE)
    r = serve_requests(eng, reqs, plan)
    ttft = np.array([r["ttft_s"][q.id] for q in reqs if q.id in r["ttft_s"]])
    dec = r["decode_ms_per_iter"]
    print(f"{cfg.name}{' int8' if args.int8 else ''} on {model.device}: "
          f"{len(reqs)} requests on {geom['n_lanes']} lanes, "
          f"{r['iterations']} "
          f"iterations ({r['chunk_iterations']} with a prefill chunk), "
          f"{r['generated']} tokens in {r['wall_s']:.3f} s = "
          f"{r['tokens_per_s']:.1f} tok/s")
    if ttft.size:
        print(f"  time to first token: median {1e3 * np.median(ttft):.1f} "
              f"ms, max {1e3 * ttft.max():.1f} ms")
    if dec is not None:
        print(f"  decode-only iteration: {dec:.3f} ms")
    for q in reqs:
        o = r["outputs"][q.id]
        extra = f" (at step {o.fault_step})" if o.fault_step >= 0 else ""
        print(f"  request {q.id}: prompt {len(q.tokens)}, {o.tokens.size} "
              f"tokens, {o.status}{extra}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--int8", action="store_true",
                    help="serve int8 weights (column-wise scales)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the config's first N layers (default: all)")
    # fixed-batch mode
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    # continuous batching
    ap.add_argument("--requests", type=int, default=0,
                    help="continuous batching: serve this many requests")
    # guards (the reference's flags)
    ap.add_argument("--fp32-fallback", action="store_true",
                    help="with --int8: keep the bf16 model and finish "
                         "saturation-degraded lanes on it")
    ap.add_argument("--no-guards", action="store_true",
                    help="no per-lane numerical-health guards")
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="wall-clock budget per request; expired lanes "
                         "get a structured 'timeout' status")
    ap.add_argument("--max-lanes", type=int, default=None,
                    help="admission limit; surplus batch rows are shed")
    ap.add_argument("--retries", type=int, default=2,
                    help="transient-failure retries (doubling backoff)")
    # fault-injection drills ("step:lane" / "step:seconds")
    ap.add_argument("--inject-nan", action="append", metavar="STEP:LANE")
    ap.add_argument("--inject-saturation", action="append",
                    metavar="STEP:LANE")
    ap.add_argument("--inject-stall", action="append",
                    metavar="STEP:SECONDS")
    ap.add_argument("--inject-transient", type=int, default=0,
                    help="fail the first N generate calls with a retryable "
                         "error")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = with_layers(get_config(args.arch, smoke=args.smoke), args.layers)
    if args.int8 and not int8_fits(cfg, device, args.fp32_fallback):
        raise SystemExit(
            f"{cfg.name}: its int8 build holds "
            f"{int8_peak_bytes(cfg, args.fp32_fallback) / 1e9:.1f} GB of "
            f"weights at its peak, more than 0.8 of the card"
            + (" (--fp32-fallback keeps the bf16 model beside the int8 "
               "copy)" if args.fp32_fallback else ""))
    text_len = args.prompt_len - cfg.prefix_tokens
    if text_len < 1:
        raise SystemExit(f"{cfg.name}: --prompt-len counts its "
                         f"{cfg.prefix_tokens} patches and at least one "
                         f"text token, got {args.prompt_len}")
    try:
        check_prefill_len(cfg, text_len)
    except ValueError as e:
        raise SystemExit(f"{cfg.name}: --prompt-len: {e}") from None
    model = Model(cfg, device=device).init_weights(args.seed)
    if args.int8 and not args.fp32_fallback:
        # the bf16 projections go block by block as the int8 copy is built
        model = model.quantize_params_for_serving(release=True)
    plan = _parse_faults(args)
    if args.requests:
        if not model.supports_paged_serving:
            why = ("also takes frames" if cfg.encdec
                   else "also takes patches" if cfg.prefix_tokens
                   else "keeps a recurrent state with no pages")
            raise SystemExit(
                f"{cfg.name}: continuous batching prefills tokens into "
                f"pages only, and this model {why}; run the fixed loop")
        return _continuous(args, model, cfg, plan)

    gen = torch.Generator().manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab, (args.batch, text_len),
                           generator=gen)
    batch = {"tokens": tokens}
    if cfg.encdec:
        batch["frames"] = make_frames(cfg, args.batch, args.seed)
    if cfg.prefix_tokens:
        batch["patches"] = make_patches(cfg, args.batch, args.seed)
    eng = ServeEngine(model, ServeConfig(max_new_tokens=args.max_new,
                                         **_guards(args)))
    served = eng.model
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = served.prefill(tokens, max_len=args.prompt_len
                                   + args.max_new,
                                   frames=batch.get("frames"),
                                   patches=batch.get("patches"))
    _sync(device)
    t1 = time.perf_counter()
    tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
    for i in range(args.max_new - 1):
        logits, cache = served.decode_step(cache, tok, args.prompt_len + i)
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
    _sync(device)
    t2 = time.perf_counter()
    # generate_with_status (an encoder-decoder or a prefix-LM takes its
    # fall-through to the fixed loop) under the retry wrapper, the drills'
    # plan riding it
    res = generate_with_retry(eng, batch, args.seed, retries=args.retries,
                              fault_plan=plan)
    _sync(device)
    t3 = time.perf_counter()
    steps = max(args.max_new - 1, 1)
    print(f"{cfg.name}{' int8' if args.int8 else ''} on {device}: prefill "
          f"{1e3 * (t1 - t0):.3f} ms, decode {1e3 * (t2 - t1) / steps:.3f} "
          f"ms/step, generate {res.tokens.size / (t3 - t2):.1f} tok/s, "
          f"{res.admitted}/{args.batch} lanes admitted"
          f"{', TIMED OUT' if res.timed_out else ''}")
    for lane, (st, fs) in enumerate(zip(res.status, res.fault_step)):
        extra = f" (at step {fs})" if fs >= 0 else ""
        print(f"  lane {lane}: {st}{extra}")
    print(res.tokens[:, :12])


if __name__ == "__main__":
    main()
