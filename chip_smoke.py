#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero before the last
line):

1. card: name and power limit (``nvidia-smi``), then ``nvcc`` builds every
   kernel of the serving path from ``src/repro_torch/csrc/`` for sm_90a,
   one compiler per source, all started together.
2. kernels: each CUDA kernel against its plain PyTorch version on the card
   at granite-3-8b's full-width shapes, each row of the output within a
   stated tolerance of that row's own scale; the fused rmsnorm output must
   be bitwise the standalone rmsnorm of the stored value, and split-K
   decode bitwise the same for n_splits 1/2/4.  Each kernel's time, its
   plain version's time, one PyTorch library call's time where one
   computes the same function (a yardstick only; the port never calls it)
   and the least time the card could take (the bound) are recorded.
3. smoke: the whole path on granite-3-8b-smoke (bf16 parameters, as the
   full model has) on the CPU (plain versions) and on the card (kernels):
   greedy tokens must match over 8 steps, and the card's teacher-forced
   logits must sit within twice the CPU pipeline's own bf16 rounding
   noise (its distance from an fp32-compute run on the same tokens).
4. serve: granite-3-8b at full width and all 40 layers, random weights
   from a seed (varied as in phase 3): ``ServeEngine.generate_with_status``
   answers 4 requests of 256 prompt tokens with 16 greedy tokens each.
   Launch counts are set to 0 just before and read just after; every
   kernel must have launched, and no lane may repeat one token.  Before
   the weights are varied, a witness: three decode steps' logits against
   the last-position logits of a prefill over the same tokens
   (``WITNESS_TOL``).

Then one JSON line listing every ported kernel, the card line again, and
last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet (dense): HBM rate and peak operation rates
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12     # outside the tensor cores
L2_FLUSH_BYTES = 64 << 20   # more than the 50 MB L2
BATCH, PROMPT, NEW = 4, 256, 16
SEED = 0


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, flops_per_s: float = None):
    """The least time in ms: bytes over the memory rate or operations over
    the peak rate of their type (bf16 tensor cores unless stated)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (flops_per_s or BF16_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Device time of one call, averaged over ``reps`` calls, each after
    an L2 flush (the serving path meets its weights and caches cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn, reps: int = 10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def row_err(got, want, floor: float = 1e-3) -> float:
    """Worst row's error against that row's own scale: max over rows (all
    axes but the last) of max|got - want| / max(floor, max|want|).  A
    row's tolerance follows its own size, so large rows elsewhere in the
    output cannot hide an error in small ones."""
    g, w = got.float(), want.float()
    diff = (g - w).abs().amax(dim=-1)
    scale = w.abs().amax(dim=-1).clamp(min=floor)
    return float((diff / scale).max())


def check_kernels(torch, timer):
    """Phase 2: every kernel against its plain version at full width.
    Tolerances are per row (``row_err``): a bf16 output may differ from
    the plain version by one rounding flip, one ulp of the element, which
    is at most eps * the row's largest magnitude."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.epilogue import Epilogue, rms_normalize
    from repro_torch.kernels.flash_attention import (combine_tile_partials,
                                                     decode_combine_cuda,
                                                     decode_partials_cuda,
                                                     decode_tile_partials,
                                                     flash_decode_tiled)

    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16

    def rand(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    d, ff, qkv_n = 4096, 12800, 6144
    results = {}
    shapes = []
    # K1 GEMM: each output row within 2 bf16 ulps of its scale (fp32 sums
    # in another order may flip a rounding, and the normed output inherits
    # one flip of the value); the rmsnorm output is bitwise the standalone
    # norm of the stored value.
    k1_tol = 2 * eps_bf16
    for m in (4, 1024):
        x = rand(m, d)
        h = rand(m, ff)
        res = rand(m, d)
        nscale = rand(d, dtype=torch.float32, scale=0.1)
        w = {"qkv": rand(d, qkv_n, scale=d ** -0.5),
             "o": rand(d, d, scale=d ** -0.5),
             "gate": rand(d, ff, scale=d ** -0.5),
             "up": rand(d, ff, scale=d ** -0.5),
             "down": rand(ff, d, scale=ff ** -0.5)}
        g = ops.matmul(x, w["gate"], out_dtype=bf)
        cases = {
            "qkv": (x, w["qkv"], Epilogue(out_dtype=bf), {}),
            "o": (x, w["o"], Epilogue(out_dtype=bf), {}),
            "gate": (x, w["gate"], Epilogue(out_dtype=bf), {}),
            "up": (x, w["up"], Epilogue(gate="silu", out_dtype=bf),
                   {"operand2": g}),
            "down": (h, w["down"], Epilogue(residual=True, norm="rmsnorm",
                                           out_dtype=bf),
                     {"residual": res, "norm_scale": nscale}),
        }
        for name, (a, b, ep, kw) in cases.items():
            got = ops.matmul(a, b, epilogue=ep, **kw)
            want = ref.matmul_fused_ref(a, b, ep, **kw)
            if ep.norm != "none":
                require(torch.equal(got[1], ops.rmsnorm(got[0], nscale,
                                                        ep.norm_eps)),
                        "fused rmsnorm is not bitwise store-then-rmsnorm")
                err = max(row_err(got[0], want[0]), row_err(got[1], want[1]))
                abs_err = max(max_err(got[0], want[0]),
                              max_err(got[1], want[1]))
            else:
                err = row_err(got, want)
                abs_err = max_err(got, want)
            require(err <= k1_tol,
                    f"K1 {name} M={m}: a row is off by {err:.3e} of its "
                    f"scale")
            mm, kk = a.shape
            nn = b.shape[1]
            nbytes = 2 * (mm * kk + kk * nn + mm * nn)
            nbytes += 2 * mm * nn * (("operand2" in kw) + ("residual" in kw))
            if ep.norm != "none":   # the normed output and its scale
                nbytes += 2 * mm * nn + 4 * nn
            row = {
                "shape": f"{name} M={mm} K={kk} N={nn}",
                "max_abs_err": abs_err, "max_row_err": err,
                "ms": timer(lambda: ops.matmul(a, b, epilogue=ep, **kw)),
                "plain_ms": timer(
                    lambda: ref.matmul_fused_ref(a, b, ep, **kw)),
                "library_ms": timer(lambda: torch.matmul(a, b)),
            }
            row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * mm * kk * nn)
            shapes.append(row)
            print("  k1", json.dumps(row))
    dec = [r for r in shapes if " M=4 " in r["shape"]]
    results["k1_matmul"] = dict(
        work="one decoder block's five projections at decode (M=4): "
             "qkv, o, gate, up+silu gate, down+residual (+rmsnorm pass)",
        max_abs_err=max(r["max_abs_err"] for r in shapes),
        max_row_err=max(r["max_row_err"] for r in shapes), tol=k1_tol,
        ms=sum(r["ms"] for r in dec), plain_ms=sum(r["plain_ms"] for r in dec),
        bound_ms=sum(r["bound_ms"] for r in dec),
        bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in dec)
                  else "operations"),
        library_ms=sum(r["library_ms"] for r in dec),
        shapes=shapes)

    # K1 row-norm pass (decode shape): each row within 1 bf16 ulp of its
    # scale
    x = rand(BATCH, d)
    nscale = rand(d, dtype=torch.float32, scale=0.1)
    got, want = ops.rmsnorm(x, nscale), rms_normalize(x, nscale, 1e-6)
    err = row_err(got, want)
    require(err <= eps_bf16, f"rmsnorm: a row is off by {err:.3e}")
    w1 = (1.0 + nscale).to(bf)
    t_b, by = bound(2 * 2 * x.numel() + 4 * d, 0)
    results["k1_rmsnorm"] = dict(
        work=f"rmsnorm rows [{BATCH}, {d}] bf16",
        max_abs_err=max_err(got, want), max_row_err=err, tol=eps_bf16,
        ms=timer(lambda: ops.rmsnorm(x, nscale)),
        plain_ms=timer(lambda: rms_normalize(x, nscale, 1e-6)),
        bound_ms=t_b, bound_by=by,
        library_ms=(timer(lambda: F.rms_norm(x, (d,), w1, 1e-6))
                    if hasattr(F, "rms_norm") else None))

    # K4 flash prefill: each (b, s, h) row within 4 bf16 ulps of its own
    # scale (P is rounded to bf16 for the P.V product, then the output is
    # cast)
    b, s, nh, nkv, hd = BATCH, PROMPT, 32, 8, 128
    q, k, v = rand(b, s, nh, hd), rand(b, s, nkv, hd), rand(b, s, nkv, hd)
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    err = row_err(got, want)
    require(err <= 4 * eps_bf16, f"K4: a row is off by {err:.3e} of its "
                                 f"scale")
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(nh // nkv, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(nh // nkv, dim=2).transpose(1, 2)
    t_b, by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                    4 * b * nh * hd * s * (s + 1) / 2)
    results["k4_flash_prefill"] = dict(
        work=f"causal prefill B={b} S={s} H={nh} KV={nkv} hd={hd}",
        max_abs_err=max_err(got, want), max_row_err=err, tol=4 * eps_bf16,
        ms=timer(lambda: ops.flash_attention(q, k, v)),
        plain_ms=timer(lambda: ref.flash_attention_ref(q, k, v)),
        bound_ms=t_b, bound_by=by,
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)))

    # K5 split-K flash decode, two kernels.  The pair: each (b, kv, g) row
    # within 2 bf16 ulps of its scale, bitwise the same for n_splits 1, 2,
    # 4 and the default.  Partials (fp32, same math, other summation
    # order): each row within 1e-5 of its scale.  Combine (the same
    # ascending fold at fp32 as the plain version, then one cast): each row
    # within 1 bf16 ulp.
    length, pos, g = PROMPT + NEW, PROMPT + NEW - 1, nh // nkv
    q = rand(b, 1, nkv, g, hd)
    kc, vc = rand(b, length, nkv, hd), rand(b, length, nkv, hd)
    outs = [ops.flash_decode(q, kc, vc, pos, n_splits=n)
            for n in (None, 1, 2, 4)]
    require(all(torch.equal(outs[0], o) for o in outs[1:]),
            "K5 output changes with n_splits")
    pair_err = row_err(outs[0], flash_decode_tiled(q, kc, vc, pos))
    require(pair_err <= 2 * eps_bf16,
            f"K5: a row is off by {pair_err:.3e} of its scale")

    rows, n_tiles = b * nkv, -(-length // 32)
    parts = decode_partials_cuda(q, kc, vc, pos)
    plain = decode_tile_partials(q, kc, vc, pos)   # [T, B, KV, G, 1(, hd)]
    plain = (plain[0][..., 0].permute(1, 2, 0, 3).reshape(rows, n_tiles, g),
             plain[1][..., 0].permute(1, 2, 0, 3).reshape(rows, n_tiles, g),
             plain[2][..., 0, :].permute(1, 2, 0, 3, 4).reshape(
                 rows, n_tiles, g, hd))
    p_err = max(row_err(x, y) for x, y in zip(parts, plain))
    require(p_err <= 1e-5, f"K5 partials: a row is off by {p_err:.3e}")
    live = pos + 1
    t_b, by = bound(2 * q.numel() + 2 * 2 * b * live * nkv * hd
                    + 4 * (2 * rows * n_tiles * g + rows * n_tiles * g * hd),
                    4 * b * nh * hd * live)
    results["k5_decode_partials"] = dict(
        work=f"decode partials B={b} cache={length} pos={pos} KV={nkv} "
             f"G={g} hd={hd}, {n_tiles} tiles",
        max_abs_err=max(max_err(x, y) for x, y in zip(parts, plain)),
        max_row_err=p_err, tol=1e-5,
        ms=timer(lambda: decode_partials_cuda(q, kc, vc, pos)),
        plain_ms=timer(lambda: decode_tile_partials(q, kc, vc, pos)),
        bound_ms=t_b, bound_by=by, library_ms=None)

    stacked = (parts[0].transpose(0, 1), parts[1].transpose(0, 1),
               parts[2].transpose(0, 1))
    got = decode_combine_cuda(*parts)
    want = combine_tile_partials(*stacked).to(bf)
    c_err = row_err(got, want)
    require(c_err <= eps_bf16, f"K5 combine: a row is off by {c_err:.3e}")
    t_b, by = bound(4 * (2 * rows * n_tiles * g + rows * n_tiles * g * hd)
                    + 2 * rows * g * hd, 3 * rows * n_tiles * g * hd,
                    FP32_FLOPS_PER_S)
    results["k5_decode_combine"] = dict(
        work=f"decode combine of {n_tiles} tiles, {rows} rows x G={g} x "
             f"hd={hd}",
        max_abs_err=max_err(got, want), max_row_err=c_err, tol=eps_bf16,
        ms=timer(lambda: decode_combine_cuda(*parts)),
        plain_ms=timer(lambda: combine_tile_partials(*stacked)),
        bound_ms=t_b, bound_by=by, library_ms=None)

    qd = q.reshape(b, nh, 1, hd)
    kd = kc[:, :live].repeat_interleave(g, dim=2).transpose(1, 2)
    vd = vc[:, :live].repeat_interleave(g, dim=2).transpose(1, 2)
    results["k5_pair"] = dict(
        work="partials + combine against one SDPA call on the live slots",
        max_row_err=pair_err, tol=2 * eps_bf16,
        ms=timer(lambda: ops.flash_decode(q, kc, vc, pos)),
        plain_ms=timer(lambda: flash_decode_tiled(q, kc, vc, pos)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(qd, kd,
                                                                vd)))
    return results


def vary(torch, model, seed):
    """Random norm scales and tripled block weights, so greedy decoding of
    the small model changes token from step to step."""
    gen = torch.Generator(device=model.device).manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.copy_(0.5 * torch.randn(p.shape, generator=gen,
                                          device=model.device))
            elif name != "embed":
                p.mul_(3)


def check_smoke_path(torch):
    """Phase 3: the whole path, card against CPU, on the smoke config."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True),
                              param_dtype="bfloat16")
    cpu = Model(cfg, device="cpu").init_weights(SEED)
    vary(torch, cpu, SEED)
    card = Model(cfg)
    card.load_state_dict(cpu.state_dict())
    ref32 = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                  device="cpu")
    ref32.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (BATCH, 16),
                         generator=torch.Generator().manual_seed(SEED))
    steps = 8
    want = ServeEngine(cpu, ServeConfig(max_new_tokens=steps)).generate(
        {"tokens": toks})
    got = ServeEngine(card, ServeConfig(max_new_tokens=steps)).generate(
        {"tokens": toks})
    require(got.shape == (BATCH, steps) and (got == want).all(),
            f"greedy tokens differ: card {got.tolist()} cpu {want.tolist()}")

    def rel(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max()
                     / max(1.0, float(b.abs().max())))

    lc, cc = cpu.prefill(toks, 16 + steps)
    lg, cg = card.prefill(toks, 16 + steps)
    l3, c3 = ref32.prefill(toks, 16 + steps)
    err, noise = [rel(lg, lc)], [rel(lc, l3)]
    for i in range(steps - 1):
        tok = torch.from_numpy(want[:, i:i + 1])
        lc, cc = cpu.decode_step(cc, tok, 16 + i)
        lg, cg = card.decode_step(cg, tok, 16 + i)
        l3, c3 = ref32.decode_step(c3, tok, 16 + i)
        err.append(rel(lg, lc))
        noise.append(rel(lc, l3))
    require(max(err) <= 2 * max(noise),
            f"card logits off by {max(err):.3e} of scale, budget "
            f"{2 * max(noise):.3e}")
    return dict(tokens=got.tolist(), logit_err=max(err),
                budget=2 * max(noise),
                distinct_tokens=len(set(got.reshape(-1).tolist())))


def rel_rows(got, want) -> float:
    """Worst lane's max|got - want| over that lane's logit scale."""
    g, w = got.double().cpu(), want.double().cpu()
    return float(((g - w).abs().amax(-1)
                  / w.abs().amax(-1).clamp(min=1.0)).max())


# Phase 4 witness: a decode step's logits against the last-position logits
# of a prefill over the same tokens (K5 against K4 on the new rows; every
# other op is row-local and the same code).  It runs at the reference's
# init scales (zero norm scales, 1/sqrt(fan_in) weights): the served run's
# varied weights triple wq and wk, so attention scores are about 9x
# sharper, and the rounding-level difference between K4 (P rounded to
# bf16) and K5 (P in fp32) flips near-tied softmax winners, which grows
# over 40 layers.  The tolerance is 5% of each lane's logit scale (the CPU
# test test_decode_matches_prefill_at_init_scales holds the plain versions
# to the same bound at 40 layers), and the same step against a prefill
# whose last token was changed must differ by more than 4x that, so the
# check tells a fault apart.
WITNESS_TOL = 0.05
WITNESS_STEPS = (0, 7, NEW - 2)


def decode_witness(torch, model, toks):
    cfg = model.cfg
    logits, cache = model.prefill(toks, PROMPT + NEW)
    seq = toks.to(logits.device)
    witness = []
    for i in range(NEW - 1):
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
        seq = torch.cat([seq, tok], dim=1)
        logits, cache = model.decode_step(cache, tok, PROMPT + i)
        if i in WITNESS_STEPS:
            want, _ = model.prefill(seq)
            other = seq.clone()
            other[:, -1] = (other[:, -1] + 1) % cfg.vocab
            off, _ = model.prefill(other)
            witness.append(dict(step=i, err=rel_rows(logits, want),
                                other_token=rel_rows(logits, off)))
    for w in witness:
        require(w["err"] <= WITNESS_TOL,
                f"decode step {w['step']} is off its prefill by "
                f"{w['err']:.3e} of the logit scale")
        require(w["other_token"] > 4 * WITNESS_TOL,
                f"the witness cannot tell a changed token apart: {w}")
    return witness


def serve_full(torch):
    """Phase 4: full-width, 40-layer granite-3-8b through the engine."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = get_config("granite-3-8b")
    t0 = time.perf_counter()
    model = Model(cfg).init_weights(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                         generator=torch.Generator().manual_seed(SEED))
    witness = decode_witness(torch, model, toks)
    vary(torch, model, SEED)
    engine = ServeEngine(model, ServeConfig(max_new_tokens=NEW))
    engine.generate_with_status({"tokens": toks})      # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = engine.generate_with_status({"tokens": toks})
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(res.tokens.shape == (BATCH, NEW), f"tokens {res.tokens.shape}")
    require(all(st == "ok" for st in res.status), f"statuses {res.status}")
    require(all(n > 0 for n in launches.values()),
            f"a kernel never launched on the main path: {launches}")
    require(all(len(set(lane.tolist())) > 1 for lane in res.tokens),
            f"a lane repeats one token: {res.tokens.tolist()}")

    # prefill and per-step decode times, host clock around synchronized work
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = model.prefill(toks, PROMPT + NEW)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t)
    require(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    require(logits.shape == (BATCH, cfg.padded_vocab()), "logit shape")
    tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(NEW - 1):
        logits, cache = model.decode_step(cache, tok, PROMPT + i)
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t) / (NEW - 1) * 1e3
    require(bool(torch.isfinite(logits).all()), "non-finite decode logits")

    return dict(
        params=cfg.param_count(), init_s=init_s,
        prefill_ms=sorted(pre)[1] * 1e3, decode_ms_per_step=dec_ms,
        generate_s=gen_s, tokens_per_s=BATCH * NEW / gen_s,
        decode_tokens_per_s=BATCH / dec_ms * 1e3,
        statuses=list(res.status), launches=launches, peak_bytes=peak,
        tokens=res.tokens.tolist(), witness=witness,
        witness_tol=WITNESS_TOL)


SOURCES = {
    "k1_matmul": ("matmul", "src/repro_torch/csrc/matmul.cu",
                  "src/repro/kernels/matmul.py:293"),
    "k1_rmsnorm": ("rmsnorm", "src/repro_torch/csrc/matmul.cu",
                   "src/repro/kernels/matmul.py:180"),
    "k4_flash_prefill": ("flash_attention",
                         "src/repro_torch/csrc/flash_attention.cu",
                         "src/repro/kernels/flash_attention.py:331"),
    "k5_decode_partials": ("decode_partials",
                           "src/repro_torch/csrc/flash_attention.cu",
                           "src/repro/kernels/flash_attention.py:447"),
    "k5_decode_combine": ("decode_combine",
                          "src/repro_torch/csrc/flash_attention.cu",
                          "src/repro/kernels/flash_attention.py:77"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _cuda
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    libs = _cuda.build_all()
    print(f"card: {card}; built {sorted(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    kernels = check_kernels(torch, Timer(torch))
    print("kernels: " + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk != "shapes"}
         for k, v in kernels.items()}), flush=True)
    smoke = check_smoke_path(torch)
    print("smoke: " + json.dumps(smoke), flush=True)
    serve = serve_full(torch)
    print("serve: " + json.dumps(serve), flush=True)

    line = []
    for name, (counter, source, replaces) in SOURCES.items():
        k = kernels[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": serve["launches"][counter],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"],
                     "max_row_err": k["max_row_err"], "tol": k["tol"],
                     "work": k["work"]})
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # report the failing phase, exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
