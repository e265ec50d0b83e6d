"""How far xlstm's decode step lies from its prefill, in the reference and
in the port, on the CPU: both on the reference's init of one parameter
tree, a prefill of S tokens, then STEPS decode steps fed the next tokens,
against a prefill of the S + STEPS tokens; each distance the worst lane's
max |difference| over its logit scale.  Also the two frameworks' prefill
and decode logits against each other.  Not a test: a probe of how the
rounding of one compute dtype grows with depth at a chosen width.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_xlstm_depth_probe.py \\
        --layers 24 --prompt 2048 --steps 64 --batch 1 \\
        --d-model 1024 --heads 4 --head-dim 256

(xlstm-350m's width over the smoke config's vocab of 256; about 3 min and
5 GB at 24 layers.  ``--batch 8 --vocab 50304 --layers 8``: the card's
witness conditions on one period of the pattern, about 5 min and 4 GB.)

``--card`` takes the port alone, no JAX, at ``chip_smoke.py`` phase 11's
fp32 witness (xlstm-350m's config cut to ``--layers``, 8 lanes, a prompt
of 2048, 64 steps, its ``xlstm_witness`` and ``plain_norms_at_fp32``) on
the card and on the same machine's CPU, from one set of weights drawn on
the CPU; it prints one JSON line, each device's distance and the two
devices' decode and prefill logits against each other:

    PYTHONPATH=src python tests/_xlstm_depth_probe.py --card --layers 24
"""
import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.lm import Model

ARCH = "xlstm-350m"


def rel(got, want, vocab: int) -> float:
    g = np.asarray(got, np.float64)[:, :vocab]
    w = np.asarray(want, np.float64)[:, :vocab]
    return float((np.abs(g - w).max(-1)
                  / np.maximum(1.0, np.abs(w).max(-1))).max())


def card(layers: int) -> None:
    """Phase 11's fp32 witness of the port on the card and on the CPU."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    cfg = dataclasses.replace(get_config(ARCH), n_layers=layers,
                              compute_dtype="float32")
    cpu = Model(cfg, device="cpu").init_weights(cs.SEED)
    toks = torch.randint(0, cfg.vocab,
                         (cs.XL_BATCH, cs.XL_PROMPT + cs.XL_WIT_STEPS),
                         generator=torch.Generator().manual_seed(cs.SEED + 2))
    out, logits = dict(layers=layers, vocab=cfg.vocab), {}
    for dev in ("cuda", "cpu"):
        m = cpu if dev == "cpu" else Model(cfg, device=dev)
        if m is not cpu:
            m.load_state_dict(cpu.state_dict())
        with cs.plain_norms_at_fp32(torch):
            w, dec, pre = cs.xlstm_witness(torch, m, toks.to(dev))
        out[dev], logits[dev] = w, (dec.cpu(), pre.cpu())
        del m
    (d0, p0), (d1, p1) = logits.values()
    out.update(decode_across=cs.rel_rows(d0, d1),
               prefill_across=cs.rel_rows(p0, p1))
    print(json.dumps(out), flush=True)


def reference(args) -> None:
    """The reference and the port on the CPU, one parameter tree."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.launch.mesh import make_mesh
    from repro.models.lm import Model as JaxModel
    from repro_torch.convert import from_jax_params

    over = dict(compute_dtype=args.compute, n_layers=args.layers)
    if args.d_model:
        over["d_model"] = args.d_model
    if args.heads:
        over.update(n_heads=args.heads, n_kv_heads=args.heads)
    if args.head_dim:
        over["head_dim"] = args.head_dim
    if args.vocab:
        over["vocab"] = args.vocab
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **over)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **over)
    jm = JaxModel(jcfg, make_mesh(1, 1))
    tree = jax.tree.map(np.asarray, jm.init_params(args.seed))
    jp = jax.tree.map(jnp.asarray, tree)
    tm = Model(cfg, device="cpu")
    tm.load_state_dict(from_jax_params(cfg, tree))
    s, steps = args.prompt, args.steps
    toks = np.random.default_rng(args.seed + 3).integers(
        0, cfg.vocab, (args.batch, s + steps)).astype(np.int32)
    prefill = jax.jit(lambda p, t, n: jm.prefill(p, {"tokens": t}, n),
                      static_argnums=2)
    decode = jax.jit(jm.decode_step)
    jl, jc = prefill(jp, jnp.asarray(toks[:, :s]), s + steps)
    tl, tc = tm.prefill(torch.from_numpy(toks[:, :s]).long(), s + steps)
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        jl, jc = decode(jp, jc, jnp.asarray(tok), jnp.asarray(s + i,
                                                              jnp.int32))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok).long(), s + i)
    jw, _ = prefill(jp, jnp.asarray(toks), s + steps)
    tw, _ = tm.prefill(torch.from_numpy(toks).long())
    v = cfg.vocab
    print(f"{cfg.name} {args.compute}, {args.layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, batch {args.batch}, prompt "
          f"{s}, {steps} steps: decode against prefill, reference "
          f"{rel(jl, jw, v):.3e}, port {rel(tl.numpy(), tw.numpy(), v):.3e}; "
          f"port against reference, prefill {rel(tw.numpy(), jw, v):.3e}, "
          f"decode {rel(tl.numpy(), jl, v):.3e}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--card", action="store_true",
                    help="the port alone on the card and the CPU (only "
                         "--layers applies)")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=1024,
                    help="below 64 or a multiple of 64 (ROADMAP F10)")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--heads", type=int, default=None)
    ap.add_argument("--head-dim", type=int, default=None)
    ap.add_argument("--compute", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=None,
                    help="in place of the smoke config's 256 (xlstm-350m's "
                         "is 50304)")
    args = ap.parse_args()
    if args.card:
        card(args.layers)
    else:
        reference(args)


if __name__ == "__main__":
    main()
