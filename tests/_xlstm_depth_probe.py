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
5 GB at 24 layers.)
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.launch.mesh import make_mesh
from repro.models.lm import Model as JaxModel

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models.lm import Model

ARCH = "xlstm-350m"


def rel(got, want, vocab: int) -> float:
    g = np.asarray(got, np.float64)[:, :vocab]
    w = np.asarray(want, np.float64)[:, :vocab]
    return float((np.abs(g - w).max(-1)
                  / np.maximum(1.0, np.abs(w).max(-1))).max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    args = ap.parse_args()
    over = dict(compute_dtype=args.compute, n_layers=args.layers)
    if args.d_model:
        over["d_model"] = args.d_model
    if args.heads:
        over.update(n_heads=args.heads, n_kv_heads=args.heads)
    if args.head_dim:
        over["head_dim"] = args.head_dim
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


if __name__ == "__main__":
    main()
