"""Training the recurrent mixers at bf16 compute, the port against the
reference's jitted step on the CPU (``test_torch_train_mixers.py`` holds
them at fp32, the tie rules, the masters and the round trips).

recurrentgemma at bf16 ``param_dtype`` (its full config's), xlstm's fp32
masters; both on bf16-valued weights.  Each token's NLL, the whole
gradient, each leaf's mean gradient distance and the mean update after 1
and 3 steps lie within twice the reference's own bf16 distance from its
fp32-compute run.  recurrentgemma's gates ``w_a``/``w_i``, bf16 leaves on
both sides that the mixer widens at use, stay bf16 after every step; at
fp32 compute their gradients are bf16 and one step makes them the
reference's bf16 leaves bit for bit.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.loss import vocab_parallel_xent as jxent
from repro.models.lm import Model as JaxModel

from repro_torch.convert import from_jax_params
from repro_torch.models.lm import Model
from repro_torch.train.step import loss_and_grads
# the train step's helpers and its step count (4 x S tokens)
from test_torch_train import (STEPS, _batches, _pair, _port_steps,
                              _reference_steps, _token_nll, _torch_batch)

torch.set_num_threads(1)

RG, XL = "recurrentgemma-9b", "xlstm-350m"
# xlstm at 128 positions: two mLSTM chunks of 64, the carry between them
SEQ = {RG: 32, XL: 128}
# the weights: recurrentgemma's bf16 leaves (its full config's
# param_dtype), xlstm's fp32 masters
OVER = {RG: dict(param_dtype="bfloat16"), XL: {}}


@pytest.fixture(autouse=True)
def _xla_mode():
    assert jops.kernel_mode() == "xla", "the reference must run its CPU path"


def _loss_and_h(m):
    """The reference's ``Model.loss`` (no prefix, no MoE) with its
    final-normed stream as aux, jitted with its gradients: one compile
    for the stream and the gradients."""
    def f(p, b):
        h = m.forward(p, b, mode="train")[0]
        return jxent(h, p["embed"], b["targets"], m.ctx,
                     final_softcap=m.cfg.final_softcap), h
    return jax.jit(jax.value_and_grad(f, has_aux=True))


@pytest.fixture(scope="module", params=[RG, XL])
def runs(request):
    """Both sides on the same bf16-valued weights: the reference at bf16
    compute and its fp32-compute anchor (the first batch's stream and
    gradients, and STEPS train steps each), and the port's configs."""
    arch = request.param
    jm, params, tm = _pair(arch, "bfloat16", bf16_values=True, **OVER[arch])
    j32 = JaxModel(dataclasses.replace(jm.cfg, compute_dtype="float32"),
                   jm.mesh)
    batches = _batches(jm.cfg, s=SEQ[arch])
    jp = jax.tree.map(jnp.asarray, params)
    jb = jax.tree.map(jnp.asarray, batches[0])
    ref = {}
    for name, m in (("ref", jm), ("anchor", j32)):
        (loss, h), g = _loss_and_h(m)(jp, jb)
        ref[name] = types.SimpleNamespace(
            loss=float(loss), h=np.asarray(h.astype(jnp.float32)),
            grads=from_jax_params(tm.cfg, jax.tree.map(np.asarray, g)),
            trees=_reference_steps(m, params, batches)[1])
    return types.SimpleNamespace(arch=arch, params=params, cfg=tm.cfg,
                                 batches=batches, ref=ref)


def _port(r, compute="bfloat16"):
    cfg = dataclasses.replace(r.cfg, compute_dtype=compute)
    tm = Model(cfg, device="cpu")
    tm.load_state_dict(from_jax_params(cfg, r.params))
    return tm


def test_loss_and_grads_at_bf16_within_the_reference_noise(runs):
    """Each token's NLL (the max over tokens) lies as close to the
    reference's fp32 run as twice the reference's own bf16 run does; so
    does the whole gradient (its L2 distance over every leaf) and each
    leaf's mean distance, for every leaf of at least 64 entries.  A max
    over a leaf is not held: recurrentgemma's bf16 gradients are quantized
    (one entry a bf16 ulp apart moves a max by a whole ulp of its size),
    and xlstm's gate biases hold one entry a head (2 in the smoke config),
    single draws of the noise whose ratios to the reference's scatter
    widely either way while the whole gradient's distance matches the
    reference's."""
    batch, ref = runs.batches[0], runs.ref
    embed = np.asarray(runs.params["embed"], np.float32)
    nll = {name: _token_nll(ref[name].h, embed, batch["targets"])
           for name in ref}
    tm = _port(runs)
    with torch.no_grad():
        h, _ = tm.train_forward(tm.train_params(),
                                torch.from_numpy(batch["tokens"]))
    nll["port"] = _token_nll(h.float().numpy(), embed, batch["targets"])
    err = np.abs(nll["port"] - nll["anchor"]).max()
    noise = np.abs(nll["ref"] - nll["anchor"]).max()
    assert err <= 2 * noise, (err, noise)
    _, tg = loss_and_grads(tm, tm.train_params(), _torch_batch(batch))
    sq_err = sq_noise = 0.0
    for key, g in tg.items():
        a = ref["anchor"].grads[key].double()
        err = (g.double() - a).abs()
        noise = (ref["ref"].grads[key].double() - a).abs()
        sq_err += float((err ** 2).sum())
        sq_noise += float((noise ** 2).sum())
        if g.numel() >= 64:
            assert float(err.mean()) <= 2 * float(noise.mean()), (
                key, float(err.mean()), float(noise.mean()))
    assert sq_err <= 4 * sq_noise, (sq_err, sq_noise)


def test_train_step_at_bf16_within_the_reference_noise(runs):
    """One and three bf16 steps: the mean parameter update lies as close
    to the reference's fp32 run's as twice the reference's own bf16 run's
    does (relative to lr).  recurrentgemma's gates, bf16 leaves that the
    mixer widens at use (``RGLRU.WIDENED``), stay bf16 after every step
    and differ from the reference's bf16 run's on
    no larger a share of their entries than twice the share by which the
    port's bf16 leaves differ from the reference's (the bf16 gradients'
    noise).  At fp32 compute (the anchor's configuration) their gradients
    come back bf16 (the VJP of the cast at use, as the reference's),
    the loss is the reference's within 1e-5, and one AdamW step writes
    them back as the reference's bf16 leaves bit for bit.  (The grad norm
    is not held to 1e-5 there: every bf16 leaf's gradient is rounded to
    bf16 on both sides, and the entries whose fp32 gradients straddle a
    rounding boundary move it past that.)"""
    tm = _port(runs)
    p0 = {k: v.clone().double() for k, v in tm.state_dict().items()}
    _, tsnaps = _port_steps(tm, runs.batches)
    narrowed = [k for k in p0 if runs.arch == RG
                and k.rsplit(".", 1)[-1] in ("w_a", "w_i")]
    assert bool(narrowed) == (runs.arch == RG)
    for i in range(STEPS):
        refb = from_jax_params(tm.cfg, runs.ref["ref"].trees[i])
        if narrowed:
            gates = [tsnaps[i][k] for k in narrowed]
            assert all(g.dtype == torch.bfloat16 for g in gates), i
            off = sum(int((tsnaps[i][k] != refb[k]).sum())
                      for k in narrowed) / sum(g.numel() for g in gates)
            bf = [k for k, v in tsnaps[i].items()
                  if v.dtype == torch.bfloat16]
            noise = sum(int((tsnaps[i][k] != refb[k]).sum()) for k in bf
                        ) / sum(tsnaps[i][k].numel() for k in bf)
            assert 0 < noise and off <= 2 * noise, (i, off, noise)
        if i not in (0, STEPS - 1):
            continue
        anchor = from_jax_params(tm.cfg, runs.ref["anchor"].trees[i])

        def mean_dist(snap):
            return sum(float(((snap[k].double() - p0[k])
                              - (anchor[k].double() - p0[k])).abs().sum())
                       for k in p0) / sum(v.numel() for v in p0.values())
        assert mean_dist(tsnaps[i]) <= 2 * mean_dist(refb), i
    if not narrowed:
        return
    assert set(narrowed) == {f"blocks.{i}.mix.{n}" for i in (0, 1, 3, 4)
                             for n in ("w_a", "w_i")}
    t32 = _port(runs, "float32")
    loss, grads = loss_and_grads(t32, t32.train_params(),
                                 _torch_batch(runs.batches[0]))
    for k in narrowed:
        assert grads[k].dtype == torch.bfloat16, k
    want = runs.ref["anchor"].loss
    assert abs(float(loss) - want) <= 1e-5 * want
    _, t32snaps = _port_steps(t32, runs.batches[:1])
    want = from_jax_params(tm.cfg, runs.ref["anchor"].trees[0])
    for k in narrowed:
        assert want[k].dtype == t32snaps[0][k].dtype == torch.bfloat16
        assert torch.equal(t32snaps[0][k], want[k]), k
