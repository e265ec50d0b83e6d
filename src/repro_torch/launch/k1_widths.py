"""K1's operations regime at each of its tile widths, on the card.

    PYTHONPATH=src python -m repro_torch.launch.k1_widths \\
        [--out k1_widths.json]

For gemma2-27b's and granite-3-8b's five projections at the operations
regime's driven rows (512, 1024 and 8320), runs the K1 kernel once per tile
width of ``kernels.matmul.K1_OPS_COLS``, checks that every width gives
bitwise the same output (no width changes the order in which an element's
products are summed), and prints each width's device time and TFLOP/s
beside the width the plan picks.  The time is CUDA events around each of
10 calls, each after an L2 flush, recorded behind a spin kernel that keeps
the card busy while the host enqueues the call, so the host's launch is
not in it (as ``chip_smoke.py`` times kernels).  At 8320 rows every
width fills its waves, so the ratios of those rows' rates are the
relative rates per column that ``k1_plan`` weighs.  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _cuda
from repro_torch.kernels.matmul import K1_OPS_COLS, k1_plan, sm_count

ROWS = {"granite-3-8b": (512, 1024), "gemma2-27b": (512, 8320)}
REPS = 10


def _projections(arch: str):
    cfg = get_config(arch)
    d, ff = cfg.d_model, cfg.d_ff
    return {"qkv": (d, cfg.q_dim + 2 * cfg.kv_dim), "o": (cfg.q_dim, d),
            "gate": (d, ff), "up": (d, ff), "down": (ff, d)}


def _k1(a, b, out, cols):
    m, k = a.shape
    n = b.shape[1]
    _cuda.launch("matmul", "k1_matmul", a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), None, None, None, None, None, None, m, n, k,
                 1, cols, 0, 1e-6)


def _spin_cycles_per_ms() -> float:
    cycles = 10_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def _device_ms(fn, flush, cycles_per_ms: float) -> float:
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    spin = int(cycles_per_ms * max(2.0, 4 * host_ms))
    total = 0.0
    for _ in range(REPS):
        torch.cuda._sleep(spin)
        torch.bitwise_not(flush, out=flush)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / REPS


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_widths needs the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    _cuda.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    cycles_per_ms = _spin_cycles_per_ms()
    rows = []
    for arch, ms in ROWS.items():
        for name, (k, n) in _projections(arch).items():
            b = (torch.randn((k, n), generator=gen, device="cuda")
                 * k ** -0.5).to(torch.bfloat16)
            for m in ms:
                a = torch.randn((m, k), generator=gen,
                                device="cuda").to(torch.bfloat16)
                outs = {c: torch.empty((m, n), dtype=torch.bfloat16,
                                       device="cuda") for c in K1_OPS_COLS}
                row = {"arch": arch, "proj": name, "m": m, "n": n, "k": k,
                       "plan": k1_plan(m, n, k,
                                       sm_count(a.device.index)).cols}
                for cols, out in outs.items():
                    t = _device_ms(lambda: _k1(a, b, out, cols), flush,
                                   cycles_per_ms)
                    row[f"ms_{cols}"] = t
                    row[f"tflops_{cols}"] = 2 * m * n * k / t / 1e9
                first = outs[next(iter(outs))]
                row["bitwise_equal"] = all(torch.equal(first, o)
                                           for o in outs.values())
                if not row["bitwise_equal"]:
                    raise SystemExit(f"K1 widths disagree: {row}")
                rows.append(row)
                print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
