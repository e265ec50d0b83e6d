"""The whole serving slice of the port against the JAX reference, on the
CPU: the same parameters (``convert.from_jax_params`` of the reference's
``Model.init_params``) through ``prefill``/``decode_step`` and the
fixed-batch greedy loop, on the granite-3-8b and internlm2-1.8b smoke
configs.  The reference runs in its default CPU kernel mode (``xla``).

At the reference's init (zero norm scales, 1/sqrt(fan_in) weights) the
tied embedding dominates and greedy decoding repeats one token.  The
tests draw the norm scales from a numpy seed and triple the block
weights (the same values on both sides), so the greedy tokens vary from
step to step and a wrong block cannot hide.

Budgets: with ``compute_dtype='float32'`` every product runs in fp32 on
both sides, and logits agree within 1e-4 of their scale, greedy tokens
exactly.  With bf16 compute the two frameworks round to bf16 at the same
places but sum in other orders (and the reference's CPU prefill scales q
in bf16 before the scores), so the port is teacher-forced on the
reference's tokens and its distance from the reference may be at most
twice the reference's own bf16 rounding noise: the distance between the
reference's bf16 and fp32 runs on the same tokens (the repo's
consistency-budget rule, derived from the pipeline, not hand-tuned).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.launch.mesh import make_mesh
from repro.models.lm import Model as JaxModel
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models.lm import Model
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

ARCHS = ["granite-3-8b", "internlm2-1.8b"]
PROMPT, STEPS = 12, 8


@pytest.fixture(autouse=True)
def _xla_mode():
    assert jops.kernel_mode() == "xla", "the reference must run its CPU path"


def _models(arch, compute_dtype, param_dtype=None):
    over = dict(compute_dtype=compute_dtype)
    if param_dtype:
        over["param_dtype"] = param_dtype
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jm = JaxModel(jcfg, make_mesh(1, 1))
    params = jax.tree.map(np.asarray, jm.init_params(0))
    rng = np.random.default_rng(7)
    grp = params["groups"]["b0"]
    for name in ("ln1", "ln2"):
        grp[name] = (0.5 * rng.standard_normal(grp[name].shape)
                     ).astype(np.float32)
    params["final_norm"] = (0.5 * rng.standard_normal(
        params["final_norm"].shape)).astype(np.float32)
    for sub, names in (("attn", ("wqkv", "wo")),
                       ("ffn", ("gate", "up", "down"))):
        for name in names:
            grp[sub][name] = grp[sub][name] * grp[sub][name].dtype.type(3)
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(from_jax_params(tcfg, params))
    return jm, jax.tree.map(jnp.asarray, params), tm


def _tokens(vocab):
    return np.random.default_rng(1).integers(
        0, vocab, (2, PROMPT)).astype(np.int32)


def _rel_err(got, want) -> float:
    g = np.asarray(got.double() if torch.is_tensor(got) else got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w)) / max(1.0, np.max(np.abs(w))))


def _teacher_forced(arch, compute_dtype, param_dtype=None):
    """Relative logit errors over prefill and STEPS decode steps, the port
    fed the reference's greedy tokens: (port vs reference, reference vs
    the reference's own fp32-compute run on the same tokens)."""
    jm, params, tm = _models(arch, compute_dtype, param_dtype)
    anchor = JaxModel(dataclasses.replace(jm.cfg, compute_dtype="float32"),
                      jm.mesh)
    toks = jnp.asarray(_tokens(jm.cfg.vocab))
    jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, PROMPT + STEPS))(
        params, {"tokens": toks})
    al, acache = jax.jit(lambda p, b: anchor.prefill(p, b, PROMPT + STEPS))(
        params, {"tokens": toks})
    tl, tcache = tm.prefill(torch.from_numpy(np.array(toks)),
                            PROMPT + STEPS)
    errs, noise = [_rel_err(tl, jl)], [_rel_err(jl, al)]
    decode, adecode = jax.jit(jm.decode_step), jax.jit(anchor.decode_step)
    for i in range(STEPS):
        tok = jnp.argmax(jl[:, :jm.cfg.vocab], -1).astype(jnp.int32)[:, None]
        pos = jnp.asarray(PROMPT + i, jnp.int32)
        jl, jcache = decode(params, jcache, tok, pos)
        al, acache = adecode(params, acache, tok, pos)
        tl, tcache = tm.decode_step(tcache, torch.from_numpy(np.array(tok)),
                                    PROMPT + i)
        errs.append(_rel_err(tl, jl))
        noise.append(_rel_err(jl, al))
    return max(errs), max(noise)


@pytest.mark.parametrize("arch", ARCHS)
def test_slice_fp32_logits_match_reference(arch):
    assert _teacher_forced(arch, "float32")[0] <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_slice_fp32_greedy_tokens_match_reference(arch):
    jm, params, tm = _models(arch, "float32")
    toks = _tokens(jm.cfg.vocab)
    want = JaxServeEngine(jm, params, JaxServeConfig(
        max_new_tokens=STEPS)).generate_with_status_fixed(
        {"tokens": jnp.asarray(toks)})
    got = ServeEngine(tm, ServeConfig(max_new_tokens=STEPS)).generate(
        {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, STEPS)
    np.testing.assert_array_equal(got, want.tokens)
    assert len(set(got[0].tolist())) > 1, "degenerate greedy stream"


@pytest.mark.parametrize("arch,param_dtype", [("granite-3-8b", "bfloat16"),
                                              ("internlm2-1.8b", None)])
def test_slice_bf16_teacher_forced_within_budget(arch, param_dtype):
    err, noise = _teacher_forced(arch, "bfloat16", param_dtype)
    assert err <= 2.0 * noise, (err, noise)


def test_bf16_params_convert_exactly():
    """A bf16 leaf reaches the port bit for bit (through float32)."""
    jm, params, tm = _models("granite-3-8b", "bfloat16", "bfloat16")
    want = np.asarray(params["groups"]["b0"]["attn"]["wqkv"][1], np.float32)
    got = tm.blocks[1].attn.wqkv
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    up = np.asarray(params["groups"]["b0"]["ffn"]["up"][0, 0], np.float32)
    np.testing.assert_array_equal(tm.blocks[0].ffn.up.float().numpy(), up)


@pytest.mark.parametrize("n_layers", [2, 40])
def test_decode_matches_prefill_at_init_scales(n_layers):
    """At the reference's init scales a decode step's logits stay within 5%
    of the logit scale of a prefill over the same tokens (the witness
    chip_smoke.py runs on the card, K5 against K4), while a changed last
    token moves them by more than 4x that."""
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True),
                              param_dtype="bfloat16", n_layers=n_layers)
    tm = Model(cfg, device="cpu").init_weights(0)
    seq = torch.from_numpy(_tokens(cfg.vocab))
    logits, cache = tm.prefill(seq, PROMPT + STEPS)
    for i in range(STEPS):
        tok = torch.argmax(logits[:, :cfg.vocab], -1).to(seq.dtype)[:, None]
        seq = torch.cat([seq, tok], dim=1)
        logits, cache = tm.decode_step(cache, tok, PROMPT + i)
        other = seq.clone()
        other[:, -1] = (other[:, -1] + 1) % cfg.vocab
        assert _rel_err(logits, tm.prefill(seq)[0]) <= 0.05
        assert _rel_err(logits, tm.prefill(other)[0]) > 0.2
