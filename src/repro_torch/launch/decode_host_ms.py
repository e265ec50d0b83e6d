"""Host cost of one K5 decode call, on the card.

    PYTHONPATH=src python -m repro_torch.launch.decode_host_ms \\
        [--calls 200] [--rounds 5]

At granite-3-8b's fixed-loop decode (B 4, a 272-slot cache at position
271, KV 8, G 4, hd 128: the shape each of its 40 layers gives K5 at the
last step), times ``ops.flash_decode`` three ways and prints one JSON
line:

- ``host_ms``: the host's time per call, the wall time of ``--calls``
  back-to-back calls enqueued while a spin kernel (``torch.cuda._sleep``)
  keeps the card busy, so the host never waits for the card;
- ``wall_ms``: CUDA events around one call with an idle card (host work
  inside the call included), the mean of ``--calls`` calls;
- ``device_ms``: CUDA events around one call recorded behind the spin, so
  only the call's kernels are in it.

Each is the median of ``--rounds`` rounds.  It uses ``ops.flash_decode``
only, so the same file can time another checkout's package (put that
checkout's ``src`` first on ``PYTHONPATH``).  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from repro_torch.kernels import _cuda, ops

B, LENGTH, POS, KV, G, HD = 4, 272, 271, 8, 4, 128
SPIN_CYCLES = 200_000_000   # about 0.1 s at the H100's clock


def _round(q, kc, vc, calls: int):
    call = lambda: ops.flash_decode(q, kc, vc, POS)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    host = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    for start, end in events:
        start.record()
        call()
        end.record()
        end.synchronize()
    wall = statistics.mean(s.elapsed_time(e) for s, e in events)
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        start.record()
        call()
        end.record()
    torch.cuda.synchronize()
    device = statistics.mean(s.elapsed_time(e) for s, e in events)
    return host, wall, device


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q = rand(B, 1, KV, G, HD)
    kc, vc = rand(B, LENGTH, KV, HD), rand(B, LENGTH, KV, HD)
    ops.flash_decode(q, kc, vc, POS)          # builds and loads the kernel
    _cuda.reset_launches()
    ops.flash_decode(q, kc, vc, POS)
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    rounds = [_round(q, kc, vc, args.calls) for _ in range(args.rounds)]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": card, "package": ops.__file__,
        "shape": dict(B=B, cache=LENGTH, pos=POS, KV=KV, G=G, hd=HD),
        "launches_per_call": launches,
        "host_ms": statistics.median(r[0] for r in rounds),
        "wall_ms": statistics.median(r[1] for r in rounds),
        "device_ms": statistics.median(r[2] for r in rounds),
        "rounds": rounds}))


if __name__ == "__main__":
    main()
