"""K4's backward of this checkout against a build of an older checkout
whose ``k4_flash_backward`` takes one sequence length (before Skv was a
launch argument), on the card, at Skv == Sq shapes.

    PYTHONPATH=src python -m repro_torch.launch.bwd_ab_sq \\
        [--csrc build/parent/src/repro_torch/csrc]

Builds the older ``flash_backward.cu`` with nvcc into
``build/exp/parent_bwd/`` and calls it with its own launch arguments;
this checkout's build goes through ``flash_attention_bwd_cuda``.  At each
shape (internlm2's training microbatch, G = 1 at hd 128, gemma3's global
layer at hd 256, whisper's encoder 'full') both builds run on the same
inputs, whether the older one's dQ, dK and dV equal this one's bit for
bit is printed, and each is timed 6 times in alternating order (CUDA
events around each of 10 calls after an L2 flush, behind a spin:
``launch/k1_widths.py``'s timer).  Prints one JSON line a shape with both
builds' sorted times.  Needs the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import (BWD_ROW_PAD,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_lse_cuda)
from repro_torch.launch.k1_widths import _device_ms, _spin_cycles_per_ms

# (B, S, H, KV, hd): internlm2's microbatch, G = 1, gemma3's global layer,
# whisper's encoder ('full')
SHAPES = ((4, 4096, 16, 8, 128), (2, 1024, 4, 4, 128), (2, 4096, 16, 8, 256),
          (8, 1500, 12, 12, 64))
# the older launcher's arguments: q, k, v, out, dout, lse, dq, dk, dv, ws,
# B, S, H, KV, hd, scale, mask kind, window, prefix_len, softcap, stream
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SQ_ONLY = [_P] * 10 + [_I] * 5 + [_F, _I, _I, _I, _F, _P]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", default="build/parent/src/repro_torch/csrc",
                    help="the older checkout's csrc directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bwd_ab_sq: no CUDA device")
    out = _cuda.BUILD_DIR.parent / "exp" / "parent_bwd"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libflash_backward.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so),
                    str(Path(args.csrc) / "flash_backward.cu")], check=True)
    old = ctypes.CDLL(str(so)).k4_flash_backward
    old.argtypes, old.restype = SQ_ONLY, ctypes.c_int
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    cpm = _spin_cycles_per_ms()
    gen = torch.Generator(device="cuda").manual_seed(30)
    for b, s, h, kv, hd in SHAPES:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
        q, k, v, do = (rand(b, s, h, hd), rand(b, s, kv, hd),
                       rand(b, s, kv, hd), rand(b, s, h, hd))
        kind = "full" if hd == 64 else "global"
        o, lse = flash_attention_lse_cuda(q, k, v, kind=kind)
        want = flash_attention_bwd_cuda(q, k, v, o, lse, do, kind=kind)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        s_pad = -(-s // BWD_ROW_PAD) * BWD_ROW_PAD
        ws = torch.empty((2, b, h, s_pad), dtype=torch.float32,
                         device="cuda")

        def run_old():
            err = old(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), b, s, h,
                      kv, hd, hd ** -0.5, 2 if kind == "full" else 0, 0, 0,
                      0.0, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"the older build's launch: {err}")

        def run_new():
            flash_attention_bwd_cuda(q, k, v, o, lse, do, kind=kind)
        run_old()
        torch.cuda.synchronize()
        times = {"old": [], "new": []}
        for i in range(6):
            for name in (("old", "new") if i % 2 == 0 else ("new", "old")):
                times[name].append(_device_ms(
                    run_old if name == "old" else run_new, flush, cpm))
        print(json.dumps({"shape": [b, s, h, kv, hd], "kind": kind,
                          "bitwise_old_new": all(
                              torch.equal(x, y)
                              for x, y in zip((dq, dk, dv), want)),
                          **{n: sorted(t) for n, t in times.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
