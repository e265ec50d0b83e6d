"""whisper-small's training slice on the CPU against the reference, and
the fp32 masters of whisper and paligemma (C6).

* The train step at fp32 after 1 and 3 steps, at fewer decoder tokens
  than frames (4 x 8 over 24: the cross-attention's Sq < Skv;
  ``test_torch_train.py`` holds the loss and its gradients at 32 over 24,
  Sq > Skv), by ``test_torch_train.py``'s fp32 rule (losses and grad norms
  within 1e-5 relative; updates within 1e-3 lr but for 0.1% of the
  entries, none past a flipped sign), the encoder's leaves among them.
* Remat bitwise: the encoder's per-block checkpoints and the decoder's,
  against the same forward with no checkpoint at all.
* bf16 compute within the reference's own noise, as
  ``test_torch_train_mixers_bf16.py`` holds it: each token's NLL (the max
  over tokens) and each leaf's mean gradient distance within 2x, the whole
  gradient's L2 distance within 2x, the mean update after 1 and 3 steps
  within 2x, on bf16-valued weights.
* The plain backward at Skv != Sq ('full': Sq > Skv, Sq < Skv, ragged;
  G = 1 and 2) against ``torch.autograd`` of the plain attention at f64,
  and the lse against ``logsumexp``; the CUDA wrapper's launch arguments
  at whisper's training and serving shapes (intercepted), and every causal
  kind refused at Skv != Sq.
* A checkpoint of whisper's training state (the encoder's leaves among
  them) restored by the reference's manager, and the reverse; the
  launcher on the smoke config.
* C6: paligemma's and whisper's int8 copies bitwise the reference's from
  unrounded fp32 weights; the masters fp32 after a step; the served copy
  (the decoder's blocks, the cross-attention and the encoder) multiplies
  bf16 by bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCkpt
from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels.quantize import QuantizedWeight as JQuantizedWeight
from repro.launch.mesh import make_mesh
from repro.models.lm import Model as JaxModel
from repro.models.loss import vocab_parallel_xent as jxent
from repro.optim import AdamWConfig as JAdamW
from repro.optim import abstract_opt_state
from repro.optim import init_opt_state as jinit_opt

from repro_torch.configs import get_config
from repro_torch.convert import (from_jax_params, opt_from_jax, opt_to_jax,
                                 to_jax_params)
from repro_torch.data import DataConfig, SyntheticTokenSource, TokenPipeline
from repro_torch.kernels import _cuda, ref
from repro_torch.kernels import autograd as ag
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as kops
from repro_torch.kernels.quantize import QuantizedWeight
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.models.lm import Model
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train.step import loss_and_grads, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
# the train step's helpers, its lr and step count (4 x 32 tokens); the
# CUDA wrappers' launch intercepted
from test_torch_train import (LR, STEPS, _batches, _pair, _port_steps,
                              _reference_steps, _rel, _token_nll,
                              _torch_batch)
from test_torch_train_kernels import _bf, intercepted  # noqa: F401

torch.set_num_threads(1)

WH, PG = "whisper-small", "paligemma-3b"
F64 = torch.float64


@pytest.fixture(autouse=True)
def _xla_mode():
    assert jops.kernel_mode() == "xla", "the reference must run its CPU path"


# ---------------------------------------------------------------------------
# the loss, the train step, remat
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fp32_runs():
    jm, params, tm = _pair(WH, "float32")
    p0 = {k: v.clone() for k, v in tm.state_dict().items()}
    batches = _batches(jm.cfg, s=8)
    assert batches[0]["frames"].shape[1] == jm.cfg.enc_frames > 8
    return (tm.cfg, p0, _reference_steps(jm, params, batches),
            _port_steps(tm, batches))


@pytest.mark.parametrize("step", [0, STEPS - 1], ids=["1step", "3steps"])
def test_train_step_matches_the_reference_at_fp32(fp32_runs, step):
    cfg, p0, (jh, jtrees), (th, tsnaps) = fp32_runs
    for i in range(step + 1):
        assert abs(th[i][0] - jh[i][0]) <= 1e-5 * abs(jh[i][0])
        assert abs(th[i][1] - jh[i][1]) <= 1e-5 * abs(jh[i][1])
    want = from_jax_params(cfg, jtrees[step])
    assert any(k.startswith("encoder.") for k in want)
    off = total = 0
    for k, p in tsnaps[step].items():
        d = ((p.double() - p0[k].double())
             - (want[k].double() - p0[k].double())).abs() / LR
        off += int((d > 1e-3).sum())
        total += d.numel()
        assert float(d.max()) <= 2.2, k     # at most a flipped sign
    assert off <= 1e-3 * total, (off, total)


def test_remat_is_bitwise_no_remat(monkeypatch):
    """The encoder's blocks (always rematerialized) and the decoder's
    (``cfg.remat == 'full'``) recomputed in the backward give the loss and
    every gradient of the same forward with no checkpoint, bit for bit."""
    _, _, tm = _pair(WH, "bfloat16")
    assert tm.cfg.remat == "full"
    (batch,) = _batches(tm.cfg, n=1)
    l1, g1 = loss_and_grads(tm, tm.train_params(), _torch_batch(batch))
    monkeypatch.setattr(lm, "checkpoint",
                        lambda fn, *args, **kw: fn(*args))
    l2, g2 = loss_and_grads(tm, tm.train_params(), _torch_batch(batch))
    assert torch.equal(l1, l2)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)


def _loss_and_h(m):
    """The reference's ``Model.loss`` (no prefix, no MoE) with its
    final-normed stream as aux, jitted with its gradients."""
    def f(p, b):
        h = m.forward(p, b, mode="train")[0]
        return jxent(h, p["embed"], b["targets"], m.ctx,
                     final_softcap=m.cfg.final_softcap), h
    return jax.jit(jax.value_and_grad(f, has_aux=True))


@pytest.fixture(scope="module")
def bf16_runs():
    """Both sides on the same bf16-valued weights: the reference at bf16
    compute and its fp32-compute anchor (the first batch's stream and
    gradients, and STEPS train steps each)."""
    jm, params, tm = _pair(WH, "bfloat16", bf16_values=True)
    j32 = JaxModel(dataclasses.replace(jm.cfg, compute_dtype="float32"),
                   jm.mesh)
    batches = _batches(jm.cfg)
    jp = jax.tree.map(jnp.asarray, params)
    jb = jax.tree.map(jnp.asarray, batches[0])
    out = {}
    for name, m in (("ref", jm), ("anchor", j32)):
        (_, h), g = _loss_and_h(m)(jp, jb)
        out[name] = (np.asarray(h.astype(jnp.float32)),
                     from_jax_params(tm.cfg, jax.tree.map(np.asarray, g)),
                     _reference_steps(m, params, batches)[1])
    return params, tm, batches, out


def test_loss_and_grads_at_bf16_within_the_reference_noise(bf16_runs):
    params, tm, batches, out = bf16_runs
    batch = batches[0]
    embed = np.asarray(params["embed"], np.float32)
    nll = {name: _token_nll(h, embed, batch["targets"])
           for name, (h, _, _) in out.items()}
    with torch.no_grad():
        h, _ = tm.train_forward(tm.train_params(),
                                torch.from_numpy(batch["tokens"]),
                                frames=torch.from_numpy(batch["frames"]))
    nll["port"] = _token_nll(h.float().numpy(), embed, batch["targets"])
    err = np.abs(nll["port"] - nll["anchor"]).max()
    noise = np.abs(nll["ref"] - nll["anchor"]).max()
    assert err <= 2 * noise, (err, noise)
    _, tg = loss_and_grads(tm, tm.train_params(), _torch_batch(batch))
    sq_err = sq_noise = 0.0
    for key, g in tg.items():
        a = out["anchor"][1][key].double()
        e = (g.double() - a).abs()
        n = (out["ref"][1][key].double() - a).abs()
        sq_err += float((e ** 2).sum())
        sq_noise += float((n ** 2).sum())
        if g.numel() >= 64:
            assert float(e.mean()) <= 2 * float(n.mean()), (
                key, float(e.mean()), float(n.mean()))
    assert sq_err <= 4 * sq_noise, (sq_err, sq_noise)


def test_train_step_at_bf16_within_the_reference_noise(bf16_runs):
    params, tm, batches, out = bf16_runs
    tm = Model(tm.cfg, device="cpu")
    tm.load_state_dict(from_jax_params(tm.cfg, params))
    p0 = {k: v.clone().double() for k, v in tm.state_dict().items()}
    _, tsnaps = _port_steps(tm, batches)
    for i in (0, STEPS - 1):
        anchor = from_jax_params(tm.cfg, out["anchor"][2][i])
        refb = from_jax_params(tm.cfg, out["ref"][2][i])

        def mean_dist(snap):
            return sum(float(((snap[k].double() - p0[k])
                              - (anchor[k].double() - p0[k])).abs().sum())
                       for k in p0) / sum(v.numel() for v in p0.values())
        assert mean_dist(tsnaps[i]) <= 2 * mean_dist(refb), i


# ---------------------------------------------------------------------------
# K4's backward at Skv != Sq
# ---------------------------------------------------------------------------

def _plain_attention(q, k, v):
    """Softmax attention over every key (no mask), GQA by repeating the kv
    heads, at the inputs' dtype: torch.autograd differentiates it."""
    g = q.shape[2] // k.shape[2]
    ke, ve = (x.repeat_interleave(g, dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, ke) * q.shape[-1] ** -0.5
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), ve), s


@pytest.mark.parametrize("b,sq,skv,h,kv,hd", [
    (2, 40, 12, 4, 4, 16), (1, 8, 40, 4, 2, 16), (2, 33, 5, 2, 1, 8)],
    ids=["sq>skv", "sq<skv", "ragged-g2"])
def test_plain_backward_at_other_keys_is_autograds(b, sq, skv, h, kv, hd):
    """'full' over Skv != Sq: the plain lse is ``logsumexp`` of the scaled
    scores and the plain recomputing backward (``ref.flash_attention_bwd_
    ref``) is autograd's gradient of the plain attention, both at f64."""
    gen = torch.Generator().manual_seed(sq * 7 + skv)
    q = torch.randn((b, sq, h, hd), generator=gen, dtype=F64)
    k = torch.randn((b, skv, kv, hd), generator=gen, dtype=F64)
    v = torch.randn((b, skv, kv, hd), generator=gen, dtype=F64)
    dout = torch.randn((b, sq, h, hd), generator=gen, dtype=F64)
    out, lse = ref.flash_attention_lse_ref(q, k, v, kind="full")
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    want, s = _plain_attention(qg, kg, vg)
    assert _rel(out, want.detach()) < 1e-12
    assert _rel(lse, torch.logsumexp(s.detach(), -1)) < 1e-12
    wq, wk, wv = torch.autograd.grad(want, (qg, kg, vg), dout)
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                             kind="full")
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    for got, w in ((dq, wq), (dk, wk), (dv, wv)):
        assert _rel(got, w) < 1e-12


def test_weight_gradient_pads_its_rows_for_k1(monkeypatch):
    """A batch of rows that is no multiple of 8 (one clip's 1500 frames;
    13 rows here): the weight gradient's product (K1's fp32 store on the
    card, which takes K in 16-byte rows) gets the rows padded with zeros
    to a multiple of 8, and the gradient is the unpadded one."""
    seen = []
    real = kops.matmul

    def spy(a, b, **kw):
        seen.append(tuple(a.shape))
        return real(a, b, **kw)
    monkeypatch.setattr(kops, "matmul", spy)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((13, 16), generator=gen, dtype=F64)
    w = torch.randn((16, 24), generator=gen, dtype=F64, requires_grad=True)
    dy = torch.randn((13, 24), generator=gen, dtype=F64)
    (dw,) = torch.autograd.grad(ag.matmul(x, w, out_dtype=F64), (w,), dy)
    assert seen[-1] == (16, 16)       # A^T: the 13 rows padded to 16
    assert _rel(dw, x.t() @ dy) < 1e-14


@pytest.mark.parametrize("b,sq,skv", [(4, 4096, 1500), (8, 64, 1500),
                                      (2, 1000, 37)],
                         ids=["train", "cross-prefill", "ragged"])
def test_k4_backward_launch_at_other_keys(intercepted, monkeypatch, b, sq,
                                          skv):
    """whisper's cross-attention (12 heads over 12, hd 64): the launch
    takes Sq and Skv apart, dQ and the workspace rows (D and lse log2(e),
    padded with 0 to ``BWD_ROW_PAD``) over the Sq queries, dK and dV over
    the Skv keys, counted under the 'full' variant."""
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **kw: made.append(a[0]) or empty(*a, **kw))
    q, k = _bf(b, sq, 12, 64), _bf(b, skv, 12, 64)
    dq, dk, dv = tfa.flash_attention_bwd_cuda(q, k, k, q,
                                              torch.zeros(b, 12, sq), q,
                                              kind="full")
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    ((lib, fn, args),) = intercepted
    assert (lib, fn) == ("flash_backward", "k4_flash_backward")
    assert len(args) + 1 == len(_cuda.SIGNATURES[lib][fn])
    assert args[10:] == (b, sq, skv, 12, 12, 64, 64 ** -0.5, 2, 0, 0, 0.0)
    assert made == [(2, b, 12, -(-sq // tfa.BWD_ROW_PAD) * tfa.BWD_ROW_PAD)]
    assert _cuda.LAUNCHES["flash_attention_bwd:full"] == 1


@pytest.mark.parametrize("kw", [dict(kind="local", window=16),
                                dict(kind="chunked", window=16),
                                dict(kind="prefix", prefix_len=8)],
                         ids=["local", "chunked", "prefix"])
def test_k4_backward_refuses_causal_kinds_at_other_keys(intercepted, kw):
    q, k = _bf(1, 64, 2, 64), _bf(1, 48, 1, 64)
    with pytest.raises(NotImplementedError, match="Skv == Sq"):
        tfa.flash_attention_bwd_cuda(q, k, k, q, torch.zeros(1, 2, 64), q,
                                     **kw)
    assert not intercepted


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------

def _trainer(path, steps, ckpt_every=2):
    cfg = get_config(WH, smoke=True)
    src = SyntheticTokenSource(cfg.vocab)

    def factory(start):
        return TokenPipeline(src, DataConfig(global_batch=2, seq_len=16),
                             "cpu", cfg, start_step=start)
    return Trainer(Model(cfg, device="cpu"), AdamWConfig(lr=LR),
                   TrainerConfig(steps=steps, ckpt_every=ckpt_every,
                                 ckpt_dir=str(path), keep=1,
                                 log_every=100), factory)


def test_checkpoints_cross_the_packages(tmp_path):
    """The port trainer's checkpoint of whisper's fp32 training state
    (params and AdamW state after 2 steps, the encoder's leaves among
    them) restores through the reference's ``CheckpointManager`` leaf for
    leaf; a reference checkpoint of its (params, opt: random moments in
    the reference's tree) restores through the port trainer."""
    tr = _trainer(tmp_path / "port", steps=2)
    params, opt = tr.run(0)
    cfg = tr.model.cfg
    jm = JaxModel(jax_config(WH, smoke=True), make_mesh(1, 1))
    jopt_cfg = JAdamW(lr=LR)
    like = (jm.abstract_params(),
            abstract_opt_state(jm.abstract_params(), jopt_cfg))
    step, (jp, jo) = JaxCkpt(str(tmp_path / "port")).restore(None, like)
    assert step == 2
    want_p, want_o = to_jax_params(cfg, params), opt_to_jax(cfg, opt)
    assert "encoder" in jp and "encoder" in want_p
    for got, want in ((jp, want_p), (jo, want_o)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(g), w)

    p1 = jax.tree.map(jnp.asarray, jm.init_params(1))
    rng = np.random.default_rng(4)
    o1 = jax.tree.map(lambda z: jnp.asarray(np.abs(rng.standard_normal(
        z.shape)).astype(np.float32)), jinit_opt(p1, jopt_cfg))
    o1["step"] = jnp.asarray(1, jnp.int32)
    JaxCkpt(str(tmp_path / "ref")).save(3, (p1, o1), blocking=True)
    step, tparams, topt = _trainer(tmp_path / "ref", steps=4).restore()
    assert step == 3
    want = from_jax_params(cfg, jax.tree.map(np.asarray, p1))
    assert any(k.startswith("encoder.") for k in want)
    assert all(torch.equal(tparams[k].detach(), want[k]) for k in want)
    wopt = opt_from_jax(cfg, jax.tree.map(np.asarray, o1))
    assert int(topt["step"]) == 1
    for mom in ("m", "v"):
        assert all(torch.equal(topt[mom][k], wopt[mom][k])
                   for k in wopt[mom])


def test_launcher_trains_the_smoke_config_on_the_cpu(tmp_path, capsys):
    tr = launch_train.main(["--arch", WH, "--smoke", "--device", "cpu",
                            "--steps", "3", "--batch", "2", "--seq", "16",
                            "--warmup", "1", "--ckpt-dir", str(tmp_path)])
    assert [m["step"] for m in tr.metrics] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in tr.metrics)
    assert tr.ckpt.latest_step() == 3
    assert "first loss" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# C6: whisper's and paligemma's fp32 masters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[WH, PG])
def unrounded(request):
    """The reference's smoke init (bf16 compute, fp32 masters) with no
    rounding, and the port on the same leaves."""
    arch = request.param
    jm = JaxModel(jax_config(arch, smoke=True), make_mesh(1, 1))
    params = jax.tree.map(np.asarray, jm.init_params(0))
    cfg = get_config(arch, smoke=True)
    assert (cfg.param_dtype, cfg.compute_dtype) == ("float32", "bfloat16")
    tm = Model(cfg, device="cpu")
    tm.load_state_dict(from_jax_params(cfg, params))
    return jm, params, tm


def test_masters_are_the_references_bit_for_bit(unrounded):
    jm, params, tm = unrounded
    for key, t in tm.state_dict().items():
        assert t.dtype == torch.float32, key
    want = from_jax_params(tm.cfg, params)
    assert all(torch.equal(t, want[k]) for k, t in tm.state_dict().items())


def test_int8_copy_is_the_references_from_unrounded_masters(unrounded):
    """Every quantized leaf (the decoder's ``wqkv``, ``wo`` and MLP) of the
    port's int8 copy is the reference's ``quantize_params_for_serving``
    leaf bit for bit, values and column scales, from fp32 weights that no
    bf16 rounding touched."""
    jm, params, tm = unrounded
    jq = jm.quantize_params_for_serving(jax.tree.map(jnp.asarray, params))
    q = tm.quantize_params_for_serving()
    period = jm.cfg.pattern_period
    n = 0
    for layer, blk in enumerate(q.blocks):
        g, i = divmod(layer, period)
        jblk = jq["groups"][f"b{i}"]
        for sub, name in (("attn", "wqkv"), ("attn", "wo"),
                          *(("ffn", m) for m in blk.ffn.names)):
            got, want = getattr(getattr(blk, sub), name), jblk[sub][name]
            assert isinstance(got, QuantizedWeight)
            assert isinstance(want, JQuantizedWeight)
            np.testing.assert_array_equal(
                got.q.numpy(), np.asarray(want.q[g]).reshape(got.q.shape))
            np.testing.assert_array_equal(
                got.scale.numpy().reshape(-1),
                np.asarray(want.scale[g]).reshape(-1))
            n += 1
    assert n == len(q.blocks) * (2 + len(q.blocks[0].ffn.names))


def _batch_of(cfg, b=2, s=8):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (b, s + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])}
    if cfg.encdec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    if cfg.prefix_tokens:
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.prefix_tokens, cfg.d_model)).astype(np.float32))
    return batch


def test_a_step_updates_the_fp32_masters(unrounded):
    """One AdamW step at bf16 compute updates every weight of the model in
    place at fp32 (the reference's masters, never a bf16 copy)."""
    _, _, tm = unrounded
    tm = Model(tm.cfg, device="cpu").init_weights(0)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    params = tm.train_params()
    opt = AdamWConfig(lr=LR)
    make_train_step(tm, opt)(params, init_opt_state(params, opt),
                             _batch_of(tm.cfg))
    for key, t in tm.state_dict().items():
        assert t.dtype == torch.float32, key
        if t.dim() > 1:
            assert not torch.equal(t, before[key]), key


def test_served_copy_multiplies_bf16_by_bf16(unrounded, monkeypatch):
    """At bf16 compute every GEMM of the served fixed loop takes a bf16
    activation and a bf16 weight (the served copy's), the cross-attention
    and the encoder included, float and int8; the masters stay fp32."""
    _, _, tm = unrounded
    cfg, bf = tm.cfg, torch.bfloat16
    seen = []
    real = kops.matmul

    def spy(a, b, **kw):     # the float GEMMs (an int8 weight takes K2)
        if not isinstance(b, QuantizedWeight):
            seen.append((a.dtype, b.dtype))
        return real(a, b, **kw)
    monkeypatch.setattr(kops, "matmul", spy)
    batch = _batch_of(cfg)
    inputs = {k: v for k, v in batch.items() if k != "targets"}
    for int8 in (False, True):
        ServeEngine(tm, ServeConfig(max_new_tokens=3, int8=int8)
                    ).generate_with_status_fixed(inputs)
    assert len(seen) > 4 * cfg.n_layers
    assert set(seen) == {(bf, bf)}, set(seen)
    served = tm.served_blocks()
    assert served[0].attn.wqkv.dtype == bf
    if cfg.encdec:
        assert {getattr(b.xattn, n).dtype for b in served
                for n in ("wq", "wk", "wv", "wo")} == {bf}
        assert tm.served_encoder().blocks[0].attn.wqkv.dtype == bf
        assert tm.served_encoder().blocks[0].ffn.up.dtype == bf
    assert tm.blocks[0].attn.wqkv.dtype == torch.float32
