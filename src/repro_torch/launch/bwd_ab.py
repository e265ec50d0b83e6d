"""K4's backward (``csrc/flash_backward.cu``) against other builds of it,
on the card.

    PYTHONPATH=src python -m repro_torch.launch.bwd_ab \\
        [--against NAME=CSRC_DIR ...] [--plant FAULT ...] \\
        [--shapes B,S,H,KV,HD[,kind=K][,window=W][,prefix_len=P]
                  [,softcap=C][,qscale=A] ...] [--out bwd_ab.json]

Builds this checkout's kernel (through ``kernels._cuda``) and, for each
``--against``, the ``flash_backward.cu`` of another ``csrc`` directory
(a ``git archive`` of the parent, or an edited copy of this one, under
``build/``) with nvcc into ``build/exp/<NAME>/``, and for each
``--plant``, this checkout's sources with one of ``FAULTS`` planted (a
copy under ``$TMPDIR``, removed once built): a check that cannot tell
such a build from this one is too loose.  Every build must take this
checkout's launch arguments (``_cuda.SIGNATURES``).  A shape may name an
attention kind, its window or prefix length, a softcap and a factor on q
(default 'global', none, 1: q, k and v are standard normal, so the
scaled scores are about N(0, 1) and a softcap of 50 barely bends them;
q times 10 puts them at the cap).  At each shape, each build's (dq, dk,
dv) must be within ``TOL`` of each row's scale of the plain backward at
fp32 (``ref.flash_attention_bwd_ref_by_kv_head``) and bitwise the same
over two calls; then each build's device time is taken in turns (first
to last, then last to first), beside SDPA's backward (an ``attn_mask``
for a window, a chunk or a prefix; none with a softcap) and the bound
(the backward's five products over the live pairs at 989 TFLOP/s).  The
time is CUDA events around each of 10 calls, each after an L2 flush,
behind a spin kernel (``launch/k1_widths.py``'s timer).  Prints ptxas's
registers and spills of each build.  Needs the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import _cuda, ref
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_lse_cuda)
from repro_torch.launch.k1_widths import _device_ms, _spin_cycles_per_ms

# internlm2-1.8b's training microbatch, then the small rows chip_smoke.py
# holds beside it (hd 16, 32, 64; S not a multiple of a tile; G = 1, 4)
SHAPES = ((4, 4096, 16, 8, 128), (4, 64, 4, 2, 16), (2, 1024, 8, 4, 32),
          (2, 1024, 8, 4, 64), (2, 1000, 16, 8, 128), (2, 1024, 4, 4, 128),
          (2, 1024, 8, 2, 128))
TOL = 2e-2
BF16_FLOPS_PER_S = 989e12
EXP = _cuda.BUILD_DIR.parent / "exp"
# faults a check of the softcap's backward must catch: (the line of
# flash_backward.cu as it is, the line planted in its place)
FAULTS = {
    # dS without the cap's derivative 1 - t^2
    "no_cap_derivative": ("    d = 1.0f - t * t;", "    d = 1.0f;"),
    # P from the uncapped score, against the forward's capped lse
    "uncapped_p": ("    p = exp2f(fmaf(cap.softcap * t, LOG2E, -lse2));",
                   "    p = exp2f(fmaf(s, cap.scale2, -lse2));"),
}


def _build(name: str, csrc: Path):
    out = EXP / name
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libflash_backward.so"
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so),
           str(csrc / "flash_backward.cu")]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def _planted(fault: str) -> Path:
    """A copy of this checkout's ``csrc`` with ``FAULTS[fault]`` planted,
    in a new directory under ``$TMPDIR``."""
    line, planted = FAULTS[fault]
    out = Path(tempfile.mkdtemp(prefix=f"bwd_ab_{fault}_")) / "csrc"
    shutil.copytree(_cuda.CSRC, out)
    src = out / "flash_backward.cu"
    text = src.read_text()
    if text.count(line + "\n") != 1:
        raise SystemExit(f"--plant {fault}: the line {line.strip()!r} is "
                         f"not in flash_backward.cu once")
    src.write_text(text.replace(line + "\n", planted + "\n"))
    return out


def _use(lib) -> None:
    """Make ``lib`` the library the wrapper launches."""
    _cuda._LIBS["flash_backward"] = lib
    _cuda._FNS.pop(("flash_backward", "k4_flash_backward"), None)


def _row_err(got, want) -> float:
    g, w = got.float(), want.float()
    return float(((g - w).abs().amax(-1)
                  / w.abs().amax(-1).clamp(min=1e-3)).max())


def sdpa_mask_kw(s: int, device, kind: str = "global", window: int = 0,
                 prefix_len: int = 0, softcap=None):
    """SDPA's arguments for K4's function at Sq == Skv = ``s`` under a mask
    kind: ``is_causal`` for 'global', none for 'full', the kind's boolean
    ``attn_mask`` otherwise; None under a softcap (no SDPA call caps its
    scores, so there is no library yardstick)."""
    if softcap:
        return None
    if kind == "global":
        return {"is_causal": True}
    if kind == "full":
        return {}
    pos = torch.arange(s, device=device)
    return {"attn_mask": ref.attention_mask(pos, pos, kind, window,
                                            prefix_len)}


def sdpa_bwd_ms(q, k, v, dout, ms, kw):
    """The library yardstick of K4's backward: the device ms (``ms`` times
    one call) of SDPA's backward on the same values with ``sdpa_mask_kw``'s
    arguments (``torch.autograd.grad`` of one forward, kept), the faster
    of the kv heads grouped (``enable_gqa``) and repeated to H."""
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    do = dout.transpose(1, 2).contiguous()
    best = None
    for rep in (False, True):
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
        if rep:
            kt, vt = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
        kt, vt = kt.requires_grad_(), vt.requires_grad_()
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=not rep,
                                               **kw)
        t = ms(lambda: torch.autograd.grad(o, (qt, kt, vt), do,
                                           retain_graph=True))
        best = t if best is None else min(best, t)
        del o
    return best


def _spec(text: str):
    """"B,S,H,KV,HD[,key=value ...]" -> ((B, S, H, KV, HD), kwargs: the
    mask's and ``qscale``)."""
    parts = text.split(",")
    mask = {}
    for kv in parts[5:]:
        key, val = kv.split("=")
        mask[key] = val if key == "kind" else (
            float(val) if key in ("softcap", "qscale") else int(val))
    return tuple(int(x) for x in parts[:5]), mask


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", action="append", default=[],
                    help="NAME=CSRC_DIR: another checkout's csrc")
    ap.add_argument("--plant", action="append", default=[],
                    choices=sorted(FAULTS),
                    help="a build of this checkout with this fault planted")
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="B,S,H,KV,HD (default: SHAPES)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bwd_ab: no CUDA device")
    shapes = ([_spec(s) for s in args.shapes] if args.shapes
              else [(s, {}) for s in SHAPES])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    pending = {}
    for spec in args.against:
        name, path = spec.split("=", 1)
        pending[name] = _build(name, Path(path))
    planted = {fault: _planted(fault) for fault in args.plant}
    for fault, csrc in planted.items():
        pending[fault] = _build(fault, csrc)
    libs = {"this": _cuda.lib("flash_backward")}
    print("ptxas this: " + "; ".join(_cuda.ptxas_report(
        _cuda._target("flash_backward"))), flush=True)
    for name, (so, proc) in pending.items():
        log, _ = proc.communicate()
        if name in planted:
            shutil.rmtree(planted[name].parent)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        print(f"ptxas {name}: " + "; ".join(
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line
            or "warning" in line), flush=True)
        lib = ctypes.CDLL(str(so))
        fn = lib.k4_flash_backward
        fn.argtypes = _cuda.SIGNATURES["flash_backward"]["k4_flash_backward"]
        fn.restype = ctypes.c_int
        libs[name] = lib

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    cpm = _spin_cycles_per_ms()

    def ms(fn):
        return _device_ms(fn, flush, cpm)

    gen = torch.Generator(device="cuda").manual_seed(27)
    rows = []
    for (b, s, h, kv, hd), spec in shapes:
        mask = {key: val for key, val in spec.items() if key != "qscale"}

        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * scale).to(torch.bfloat16)
        q, k, v, dout = (rand(b, s, h, hd, scale=spec.get("qscale", 1.0)),
                         rand(b, s, kv, hd), rand(b, s, kv, hd),
                         rand(b, s, h, hd))
        out, lse = flash_attention_lse_cuda(q, k, v, **mask)
        want = ref.flash_attention_bwd_ref_by_kv_head(q, k, v, out, lse, dout,
                                                      **mask)
        row = {"shape": [b, s, h, kv, hd], "mask": spec}
        for name, lib in libs.items():
            _use(lib)
            got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **mask)
            again = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **mask)
            torch.cuda.synchronize()
            row[name] = {
                "row_err": max((_row_err(g, w) for g, w in zip(got, want)),
                               key=lambda e: math.inf if math.isnan(e)
                               else e),    # a NaN is the worst
                "bitwise_twice": all(torch.equal(x, y)
                                     for x, y in zip(got, again))}
        del want
        order = list(libs) + list(libs)[::-1]
        for name in order:
            _use(libs[name])
            t = ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                                    **mask))
            row[name].setdefault("ms", []).append(t)
        _use(libs["this"])
        pairs = b * h * s * ref.live_keys(mask.get("kind", "global"), s,
                                          mask.get("window", 0),
                                          mask.get("prefix_len", 0))
        row["bound_ms"] = 10 * hd * pairs / BF16_FLOPS_PER_S * 1e3
        kw = sdpa_mask_kw(s, q.device, **mask)
        row["sdpa_bwd_ms"] = None if kw is None else sdpa_bwd_ms(
            q, k, v, dout, ms, kw)
        print(json.dumps(row), flush=True)
        rows.append(row)
    ok = all(r[n]["row_err"] <= TOL and r[n]["bitwise_twice"]
             for r in rows for n in libs)
    result = {"card": card, "tol": TOL, "rows": rows, "ok": ok}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
