"""K4's backward (``csrc/flash_backward.cu``) against other builds of it,
on the card.

    PYTHONPATH=src python -m repro_torch.launch.bwd_ab \\
        [--against NAME=CSRC_DIR ...] [--shapes B,S,H,KV,HD ...] \\
        [--out bwd_ab.json]

Builds this checkout's kernel (through ``kernels._cuda``) and, for each
``--against``, the ``flash_backward.cu`` of another ``csrc`` directory
(a ``git archive`` of the parent, or an edited copy of this one, under
``build/``) with nvcc into ``build/exp/<NAME>/``.  Every build takes the
same launch arguments.  At each
shape, each build's (dq, dk, dv) must be within ``TOL`` of each row's
scale of the plain backward at fp32 (``kernels/ref.py``, one kv head at a
time) and bitwise the same over two calls; then each build's device time
is taken in turns (first to last, then last to first), beside SDPA's
causal backward and the bound (the backward's five products at 989
TFLOP/s).  The time is CUDA events around each of 10 calls, each after an
L2 flush, behind a spin kernel (``launch/k1_widths.py``'s timer).  Prints
ptxas's registers and spills of each build.  Needs the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
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


def _build(name: str, csrc: Path):
    out = EXP / name
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libflash_backward.so"
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so),
           str(csrc / "flash_backward.cu")]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def _use(lib) -> None:
    """Make ``lib`` the library the wrapper launches."""
    _cuda._LIBS["flash_backward"] = lib
    _cuda._FNS.pop(("flash_backward", "k4_flash_backward"), None)


def _row_err(got, want) -> float:
    g, w = got.float(), want.float()
    return float(((g - w).abs().amax(-1)
                  / w.abs().amax(-1).clamp(min=1e-3)).max())


def _plain(q, k, v, out, lse, dout):
    g = q.shape[2] // k.shape[2]
    f = torch.float32
    parts = [ref.flash_attention_bwd_ref(
        q[:, :, j * g:(j + 1) * g].to(f), k[:, :, j:j + 1].to(f),
        v[:, :, j:j + 1].to(f), out[:, :, j * g:(j + 1) * g].to(f),
        lse[:, j * g:(j + 1) * g], dout[:, :, j * g:(j + 1) * g].to(f))
        for j in range(k.shape[2])]
    return tuple(torch.cat([p[i] for p in parts], dim=2) for i in range(3))


def _sdpa_bwd(q, k, v, dout, ms):
    import torch.nn.functional as F
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (k, v))
    with torch.enable_grad():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
    do = dout.transpose(1, 2).contiguous()
    return ms(lambda: torch.autograd.grad(o, (qt, kt, vt), do,
                                          retain_graph=True))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", action="append", default=[],
                    help="NAME=CSRC_DIR: another checkout's csrc")
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="B,S,H,KV,HD (default: SHAPES)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bwd_ab: no CUDA device")
    shapes = ([tuple(int(x) for x in s.split(",")) for s in args.shapes]
              if args.shapes else SHAPES)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    pending = {}
    for spec in args.against:
        name, path = spec.split("=", 1)
        pending[name] = _build(name, Path(path))
    libs = {"this": _cuda.lib("flash_backward")}
    print("ptxas this: " + "; ".join(_cuda.ptxas_report(
        _cuda._target("flash_backward"))), flush=True)
    for name, (so, proc) in pending.items():
        log, _ = proc.communicate()
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
    for b, s, h, kv, hd in shapes:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
        q, k, v, dout = (rand(b, s, h, hd), rand(b, s, kv, hd),
                         rand(b, s, kv, hd), rand(b, s, h, hd))
        out, lse = flash_attention_lse_cuda(q, k, v)
        want = _plain(q, k, v, out, lse, dout)
        row = {"shape": [b, s, h, kv, hd]}
        for name, lib in libs.items():
            _use(lib)
            got = flash_attention_bwd_cuda(q, k, v, out, lse, dout)
            again = flash_attention_bwd_cuda(q, k, v, out, lse, dout)
            torch.cuda.synchronize()
            row[name] = {
                "row_err": max(_row_err(g, w) for g, w in zip(got, want)),
                "bitwise_twice": all(torch.equal(x, y)
                                     for x, y in zip(got, again))}
        del want
        order = list(libs) + list(libs)[::-1]
        for name in order:
            _use(libs[name])
            t = ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, dout))
            row[name].setdefault("ms", []).append(t)
        _use(libs["this"])
        causal = 4 * b * h * hd * s * (s + 1) / 2
        row["bound_ms"] = 2.5 * causal / BF16_FLOPS_PER_S * 1e3
        row["sdpa_bwd_ms"] = _sdpa_bwd(q, k, v, dout, ms)
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
