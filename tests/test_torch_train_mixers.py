"""Training the recurrent mixers (recurrentgemma's RG-LRU, xlstm's mLSTM
and sLSTM) through the port, against the reference's train step on the
CPU (the reference in its ``xla`` kernel mode, its step under
``jax.jit`` as its trainer runs it).

* ``Model.loss`` and its gradients on both smoke configs at fp32 compute
  (xlstm at S = 128: two mLSTM chunks carry state, and the sLSTM): the
  loss within 1e-5 relative, every gradient leaf within 1e-4 of its scale.
* The train step after 1 and 3 steps at fp32, by
  ``test_torch_train.py``'s rule (losses and grad norms within 1e-5, the
  updates relative to lr: at most 0.1% of the entries off by 1e-3 lr);
  xlstm's grad norms and updates after 3 steps within 4x the reference's
  own distance from the port's f64 run (ROADMAP's consistency rule: its
  eight recurrent layers amplify fp32 noise past the 1e-5), and that
  distance within a stated fp32 level, so the anchor stays the
  reference's.
* bf16 compute: ``test_torch_train_mixers_bf16.py``.
* The tie rules: the sLSTM's first token from the zero state ties
  ``max(n, 1)`` (n = 1 exactly wherever logi >= logf), and the port's
  gradients there are the reference's (the tie's share reaches no input,
  so ``clamp(n, min=1)`` gives the same); saturated RG-LRU gates
  (tripled weights: ``sqrt(max(1 - exp(2 log_a), 1e-12))`` cancels) give
  gradients within 4x the reference's own distance from the f64
  formula's (ROADMAP's consistency rule).
* xlstm's fp32 masters: every training leaf at the reference's float32,
  the served copy multiplying bf16 by bf16, its logits bitwise those of a
  model whose masters hold the bf16 values (the rounding loading made
  before the masters were kept).
* Remat recomputes each mixer bitwise; a checkpoint and the AdamW state
  (fp32 and int8 moments) cross the packages for recurrentgemma at bf16
  ``param_dtype``; the launcher trains both smoke configs on the CPU.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCkpt
from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.launch.mesh import make_mesh
from repro.models.lm import Model as JaxModel
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm
from repro.models.layers import TPCtx
from repro.optim import AdamWConfig as JAdamW
from repro.optim import abstract_opt_state
from repro.optim import init_opt_state as jinit_opt
from repro.train.step import make_train_step as jmake_train_step

from repro_torch.configs import get_config
from repro_torch.convert import (from_jax_params, opt_from_jax, opt_to_jax,
                                 to_jax_params)
from repro_torch.data import DataConfig, SyntheticTokenSource, TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import rglru, xlstm
from repro_torch.models.lm import Model
from repro_torch.optim import AdamWConfig
from repro_torch.train.step import loss_and_grads
from repro_torch.train.trainer import Trainer, TrainerConfig
# the train step's helpers and its lr and step count (4 x S tokens)
from test_torch_train import (LR, STEPS, _batches, _pair, _port_steps, _rel,
                              _reference_steps, _torch_batch)

torch.set_num_threads(1)

RG, XL = "recurrentgemma-9b", "xlstm-350m"
# xlstm at 128 positions: two mLSTM chunks of 64, the carry between them
SEQ = {RG: 32, XL: 128}


@pytest.fixture(autouse=True)
def _xla_mode():
    assert jops.kernel_mode() == "xla", "the reference must run its CPU path"


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# the loss and its gradients at fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [RG, XL])
def test_loss_and_grads_match_the_reference(arch):
    jm, params, tm = _pair(arch, "float32")
    (batch,) = _batches(jm.cfg, s=SEQ[arch], n=1)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(_jax(params), _jax(batch))
    loss, grads = loss_and_grads(tm, tm.train_params(), _torch_batch(batch))
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    want = from_jax_params(tm.cfg, jax.tree.map(np.asarray, jg))
    assert set(want) == set(grads)
    assert any(".mix." in k for k in grads)
    for key, g in grads.items():
        assert _rel(g, want[key].numpy()) <= 1e-4, key


@pytest.mark.parametrize("arch", [RG, XL])
def test_remat_recompute_is_bitwise_the_forward(arch):
    """Per-block remat recomputes each mixer (the RG-LRU's scan, the
    mLSTM's chunks, the sLSTM's token loop) bit for bit: the loss and every
    gradient equal the run without it."""
    _, _, tm = _pair(arch, "bfloat16")
    (batch,) = _batches(tm.cfg, s=SEQ[arch], n=1, b=2)
    assert tm.cfg.remat == "full"
    l1, g1 = loss_and_grads(tm, tm.train_params(), _torch_batch(batch))
    tm.cfg = dataclasses.replace(tm.cfg, remat="none")
    l2, g2 = loss_and_grads(tm, tm.train_params(), _torch_batch(batch))
    assert torch.equal(l1, l2)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)


# ---------------------------------------------------------------------------
# the train step at fp32
# ---------------------------------------------------------------------------

# xlstm's f64 anchor is the port's own run, so the reference's distance
# from it is held too, under 4x the level it measured over the 3 steps
# (grad norms 2.35e-5 relative, the updates' mean 1.73e-4 lr and max 0.481
# lr): a port fault both precisions share moves the anchor away from the
# reference and fails here
XL_ANCHOR_GNORM, XL_ANCHOR_UPDATE_MEAN, XL_ANCHOR_UPDATE_MAX = 1e-4, 7e-4, 2.0


@pytest.fixture(scope="module", params=[RG, XL])
def fp32_runs(request):
    """Both sides' STEPS steps at fp32; for xlstm also the port's f64 run
    on the same weights, the exact anchor of the consistency rule (its
    recurrences, norms and loss at f64; AdamW's arithmetic stays fp32)."""
    arch = request.param
    jm, params, tm = _pair(arch, "float32")
    p0 = {k: v.clone() for k, v in tm.state_dict().items()}
    batches = _batches(jm.cfg, s=SEQ[arch])
    anchor = None
    if arch == XL:
        m64 = Model(dataclasses.replace(tm.cfg, compute_dtype="float64"),
                    device="cpu")
        m64.load_state_dict(tm.state_dict())
        anchor = _port_steps(m64.double(), batches)
    return (tm.cfg, p0, _reference_steps(jm, params, batches),
            _port_steps(tm, batches), anchor)


@pytest.mark.parametrize("step", [0, STEPS - 1], ids=["1step", "3steps"])
def test_train_step_matches_the_reference_at_fp32(fp32_runs, step):
    """``test_torch_train.py``'s fp32 rule: the losses and grad norms
    within 1e-5 relative, the update (p - p0) relative to lr at most 2.2
    anywhere and off by 1e-3 lr on at most 0.1% of the entries.  xlstm
    after 3 steps: its gradients meet 1e-4 of each leaf's scale, but
    eight recurrent layers amplify fp32 noise (one mixer alone lies far
    closer to the reference's), and AdamW's later updates, which divide
    by each entry's own gradient history, carry it past the 1e-5 and the
    0.1% rules; so there the grad norms and the update vectors (each
    entry's distance, their mean and max) are held within 4x the
    reference's own distance from the f64 anchor (ROADMAP's consistency
    rule), and that distance under the stated fp32 level
    (``XL_ANCHOR_*``); the losses keep 1e-5."""
    cfg, p0, (jh, jtrees), (th, tsnaps), anchor = fp32_runs
    for i in range(step + 1):
        assert abs(th[i][0] - jh[i][0]) <= 1e-5 * abs(jh[i][0])
    want = from_jax_params(cfg, jtrees[step])
    if anchor is not None and step > 0:
        (ah, asnaps) = anchor
        for i in range(step + 1):
            assert abs(th[i][1] - ah[i][1]) <= 4 * abs(jh[i][1] - ah[i][1])
            assert (abs(jh[i][1] - ah[i][1])
                    <= XL_ANCHOR_GNORM * abs(ah[i][1])), i

        def dist(snap):
            d = [((snap[k].double() - asnaps[step][k].double()) / LR).abs()
                 for k in p0]
            return (float(sum(x.sum() for x in d))
                    / sum(x.numel() for x in d), max(float(x.max())
                                                     for x in d))
        (port_mean, port_max), (ref_mean, ref_max) = (
            dist(tsnaps[step]), dist(want))
        assert port_mean <= 4 * ref_mean and port_max <= 4 * ref_max
        assert (ref_mean <= XL_ANCHOR_UPDATE_MEAN
                and ref_max <= XL_ANCHOR_UPDATE_MAX), (ref_mean, ref_max)
        return
    for i in range(step + 1):
        assert abs(th[i][1] - jh[i][1]) <= 1e-5 * abs(jh[i][1])
    off = total = 0
    for k, p in tsnaps[step].items():
        d = ((p.double() - p0[k].double())
             - (want[k].double() - p0[k].double())).abs() / LR
        off += int((d > 1e-3).sum())
        total += d.numel()
        assert float(d.max()) <= 2.2, k     # at most a flipped sign
    assert off <= 1e-3 * total, (off, total)


# ---------------------------------------------------------------------------
# the tie rules and saturated gates
# ---------------------------------------------------------------------------

def _mixer_leaves(arch, kind, scale=1.0):
    """One mixer's reference leaves (block ``kind`` of the smoke config's
    first group, weights times ``scale``, ``lam`` and the biases as they
    are), as numpy."""
    jm = JaxModel(jax_config(arch, smoke=True), make_mesh(1, 1))
    tree = jax.tree.map(np.asarray, jm.init_params(0))
    i = jm.cfg.block_pattern.index(kind)
    leaves = {k: np.asarray(v[0], np.float32)
              for k, v in tree["groups"][f"b{i}"]["mix"].items()}
    return {k: (v * scale if v.ndim > 1 else v) for k, v in leaves.items()}


def _ctx():
    return TPCtx(mesh=make_mesh(1, 1), sp=False, compute_dtype=jnp.float32)


def _mixer_grads(arch, fn_ref, fn_port, leaves, x, dy):
    """The VJP of ``dy`` through one mixer at fp32 on both sides: the
    reference's ``fn_ref(params, x)`` and the port's ``fn_port(mix, x)``,
    as dicts of numpy gradients (``x`` and every leaf)."""
    def ref(p, xx):
        return jnp.sum(fn_ref(p, xx) * dy)
    jg = jax.jit(jax.grad(ref, argnums=(0, 1)))(_jax(leaves), jnp.asarray(x))
    want = {k: np.asarray(v) for k, v in jg[0].items()}
    want["x"] = np.asarray(jg[1])
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in
          leaves.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    mix = types.SimpleNamespace(**tp)
    y = fn_port(mix, tx)
    names = list(tp)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(),
                              [tp[k] for k in names] + [tx])
    out = {k: g.numpy() for k, g in zip(names, got)}
    out["x"] = got[-1].numpy()
    return out, want


def _slstm_case():
    cfg = dataclasses.replace(get_config(XL, smoke=True),
                              compute_dtype="float32")
    jcfg = dataclasses.replace(jax_config(XL, smoke=True),
                               compute_dtype="float32")
    leaves = _mixer_leaves(XL, "slstm")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    ctx = _ctx()

    def fn_ref(p, xx):
        return jxlstm.slstm_apply(p, xx, jcfg, ctx)[0]

    def fn_port(mix, xx):
        return xlstm.slstm_apply(mix, xx, cfg, torch.float32, None, False)
    return _mixer_grads(XL, fn_ref, fn_port, leaves, x, dy), leaves, x, cfg


def test_slstm_tie_gradients_are_the_references(monkeypatch):
    """The sLSTM's first token from the zero state: ``n = exp(logi - m) =
    1`` exactly wherever ``logi >= logf``, a tie in ``max(n, 1)`` whose
    gradient the scan's backward halves (``xlstm._tie_share``) as
    ``jnp.maximum`` does.  The port's gradients (the input and every leaf)
    lie within 1e-4 of each one's scale of the reference's.  The tie's
    share reaches no input: there ``m = logi``, so ``n = exp(logi - m)``
    has a zero derivative, and the whole share at a tie (``clamp(n,
    min=1)``'s rule) gives the same gradients within 1e-6."""
    (got, want), leaves, x, cfg = _slstm_case()
    # the tie is there: the first token's pre-activations, logi >= logf
    xz = x[:, 0] @ leaves["w_in"] + leaves["bias"]
    w = cfg.d_model
    logi, logf = xz[:, w:2 * w], -np.logaddexp(0.0, -xz[:, 2 * w:3 * w])
    assert (logi >= logf).mean() > 0.2
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-4, k
    monkeypatch.setattr(xlstm, "_tie_share",
                        lambda a, b: (a >= b).to(a.dtype))
    (clamped, _), *_ = _slstm_case()
    assert max(_rel(clamped[k], got[k]) for k in got) <= 1e-6


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_slstm_scan_backward_is_autograds(dtype, tol):
    """Training's sLSTM scan (``xlstm._SLSTMScan``: the loop's backward
    written out by hand) against autograd through the same loop
    (``xlstm.slstm_scan``) from the zero state: the outputs bitwise, the
    gradients of the recurrent map and of every pre-activation within
    ``tol`` of their scale (at f64 the derivatives are the same, at fp32
    they sum in other orders), the first token's ties in ``max(n, 1)``
    included."""
    gen = torch.Generator().manual_seed(9)
    s, nh, b, y = 40, 2, 3, 8
    xz = (2 * torch.randn(s, nh, b, 4, y, generator=gen, dtype=dtype)
          ).requires_grad_()
    r = (0.5 * torch.randn(nh, y, 4 * y, generator=gen, dtype=dtype)
         ).requires_grad_()
    dh = torch.randn(s, nh, b, y, generator=gen, dtype=dtype)
    out = xlstm._SLSTMScan.apply(r, xz)
    ref = xlstm.slstm_scan(r, xlstm._zero_carry(xz), xz)[0]
    assert torch.equal(out, ref)
    for g, w in zip(torch.autograd.grad(out, (r, xz), dh),
                    torch.autograd.grad(ref, (r, xz), dh)):
        assert float((g - w).abs().max() / w.abs().max()) <= tol


def _rglru_f64(leaves, x, dy):
    """The RG-LRU's formula in f64 under autograd (the conv, the gates,
    the sequential recurrence, the tanh gelu gate): the VJP of ``dy`` as
    numpy gradients of ``x`` and every leaf."""
    f = {k: torch.from_numpy(np.asarray(v, np.float64)).requires_grad_()
         for k, v in leaves.items()}
    xx = torch.from_numpy(np.asarray(x, np.float64)).requires_grad_()
    xb, gb = xx @ f["in_x"], xx @ f["in_g"]
    cw, s = f["conv"].shape[0], x.shape[1]
    xp = torch.cat([xb.new_zeros((x.shape[0], cw - 1, xb.shape[2])), xb], 1)
    xc = sum(xp[:, i:i + s] * f["conv"][i] for i in range(cw))
    r = torch.sigmoid(xc @ f["w_a"])
    gi = torch.sigmoid(xc @ f["w_i"])
    log_a = -8.0 * torch.logaddexp(f["lam"], torch.zeros(())) * r
    b = torch.sqrt(torch.maximum(1 - torch.exp(2 * log_a),
                                 torch.full((), 1e-12, dtype=torch.float64))
                   ) * gi * xc
    a = torch.exp(log_a)
    hs, h = [], torch.zeros_like(b[:, 0])
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    g = torch.nn.functional.gelu(gb, approximate="tanh")
    y = (torch.stack(hs, 1) * g) @ f["out"]
    names = list(f)
    got = torch.autograd.grad((y * torch.from_numpy(
        np.asarray(dy, np.float64))).sum(), [f[k] for k in names] + [xx])
    out = {k: v.numpy() for k, v in zip(names, got)}
    out["x"] = got[-1].numpy()
    return out


def test_saturated_gate_gradients_within_the_references_error():
    """The RG-LRU's weights tripled (``lam`` as drawn): the recurrence
    gate saturates (r -> 0, a -> 1) and ``sqrt(max(1 - exp(2 log_a),
    1e-12))`` cancels, where ``sqrt``'s derivative reaches 5e5 near the
    floor.  At fp32 each gradient (the input and every leaf) lies within 4x
    the reference's own distance from the f64 formula's."""
    cfg = dataclasses.replace(get_config(RG, smoke=True),
                              compute_dtype="float32")
    jcfg = dataclasses.replace(jax_config(RG, smoke=True),
                               compute_dtype="float32")
    leaves = _mixer_leaves(RG, "rglru", scale=3.0)
    rng = np.random.default_rng(5)
    x = (3 * rng.standard_normal((2, 24, cfg.d_model))).astype(np.float32)
    dy = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    ctx = _ctx()
    got, want = _mixer_grads(
        RG, lambda p, xx: jrglru.rglru_apply(p, xx, jcfg, ctx)[0],
        lambda mix, xx: rglru.rglru_apply(mix, xx, cfg, torch.float32, None,
                                          False),
        leaves, x, dy)
    exact = _rglru_f64(leaves, x, dy)
    # saturated: 1 - exp(2 log_a) cancels below fp32's resolution somewhere
    xc = np.asarray(x, np.float64) @ leaves["in_x"]
    assert np.any(np.abs(xc @ leaves["w_a"]) > 30)
    for k in want:
        assert _rel(got[k], exact[k]) <= 4 * _rel(want[k], exact[k]), k


# ---------------------------------------------------------------------------
# xlstm's fp32 masters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_xlstm_trains_fp32_masters(smoke):
    """xlstm's config keeps the reference's float32 ``param_dtype`` (its
    training master): every training leaf the port holds is float32, as
    every leaf of the reference's tree is, the mixers' projections
    included (the smoke config's tree compared leaf by leaf)."""
    cfg = get_config(XL, smoke=smoke)
    assert cfg.param_dtype == "float32"
    jm = JaxModel(jax_config(XL, smoke=smoke), make_mesh(1, 1))
    abstract = jm.abstract_params()
    assert {leaf.dtype for leaf in jax.tree.leaves(abstract)} == {
        np.dtype(np.float32)}
    tm = Model(cfg, device="meta")
    params = tm.train_params()
    assert all(p.dtype == torch.float32 for p in params.values())
    assert params["blocks.0.mix.wq"].requires_grad
    if smoke:
        tree = from_jax_params(cfg, jax.tree.map(
            lambda a: np.zeros(a.shape, a.dtype), abstract))
        assert set(params) == set(tree)


def test_served_xlstm_multiplies_bf16_by_bf16(monkeypatch):
    """xlstm's fp32 masters at bf16 compute: every projection the fixed
    loop runs takes a bf16 activation and a bf16 weight from the served
    copy (cast once, kept while the masters do not change; the fp32 maps
    stay fp32 products), and its logits and tokens are bitwise those of a
    model whose masters hold their bf16 values."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    cfg = get_config(XL, smoke=True)
    assert (cfg.param_dtype, cfg.compute_dtype) == ("float32", "bfloat16")
    model = Model(cfg, device="cpu").init_weights(0)
    compute = {f"blocks.{i}.mix.{n}" for i, b in enumerate(model.blocks)
               for n in b.mix.COMPUTE_WEIGHTS}
    rounded = Model(cfg, device="cpu")
    rounded.load_state_dict({
        k: v.to(torch.bfloat16).float() if k in compute else v
        for k, v in model.state_dict().items()})
    assert model.blocks[0].mix.wq.dtype == torch.float32
    served = model.served_blocks()
    assert served[0].mix.wq.dtype == torch.bfloat16
    assert served[0].mix.w_i is model.blocks[0].mix.w_i
    assert model.served_blocks()[0] is served[0]
    seen = []
    real = torch.matmul

    def spy(a, b, **kw):
        seen.append((a.dtype, b.dtype))
        return real(a, b, **kw)
    monkeypatch.setattr(torch, "matmul", spy)
    toks = torch.randint(0, cfg.vocab, (2, 64),
                         generator=torch.Generator().manual_seed(0))
    out = ServeEngine(model, ServeConfig(max_new_tokens=4)
                      ).generate_with_status_fixed({"tokens": toks})
    want = ServeEngine(rounded, ServeConfig(max_new_tokens=4)
                       ).generate_with_status_fixed({"tokens": toks})
    assert set(seen) == {(torch.bfloat16, torch.bfloat16),
                         (torch.float32, torch.float32)}, set(seen)
    np.testing.assert_array_equal(out.tokens, want.tokens)
    assert torch.equal(model.prefill(toks)[0], rounded.prefill(toks)[0])
    q = model.quantize_params_for_serving()
    assert q.blocks[0].mix.wq.dtype == torch.bfloat16
    assert torch.equal(q.prefill(toks)[0], rounded.prefill(toks)[0])


# ---------------------------------------------------------------------------
# checkpoints, the optimizer state and the launcher
# ---------------------------------------------------------------------------

def _trainer(arch, tmp_path, steps, seq, **over):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    model = Model(cfg, device="cpu").init_weights(0)
    src = SyntheticTokenSource(cfg.vocab)

    def factory(start):
        return TokenPipeline(src, DataConfig(global_batch=2, seq_len=seq),
                             "cpu", cfg, start_step=start)
    return Trainer(model, AdamWConfig(lr=LR), TrainerConfig(
        steps=steps, ckpt_every=2, ckpt_dir=str(tmp_path), keep=2,
        log_every=100), factory)


def test_checkpoints_cross_the_packages(tmp_path):
    """xlstm's fp32 training state (masters and moments after 2 steps of
    the port trainer) restores through the reference's manager into its
    own trees leaf for leaf: with the masters kept, every leaf is float32
    as the reference's (its projections were bf16 words before, which the
    reference cannot read, ROADMAP F7).  recurrentgemma at bf16
    ``param_dtype``: a reference checkpoint of its (params, opt) after a
    jitted step restores through the port trainer (the gates widened, their
    moments fp32), and the port's own checkpoint of that state restores
    bit for bit, the gates' moments fp32, never the gates' bf16."""
    tr = _trainer(XL, tmp_path / "xl", steps=2, seq=64)
    params, opt = tr.run(0)
    cfg = tr.model.cfg
    jm = JaxModel(jax_config(XL, smoke=True), make_mesh(1, 1))
    jopt_cfg = JAdamW(lr=LR)
    like = (jm.abstract_params(),
            abstract_opt_state(jm.abstract_params(), jopt_cfg))
    step, (jp, jo) = JaxCkpt(str(tmp_path / "xl")).restore(None, like)
    assert step == 2
    want_p, want_o = to_jax_params(cfg, params), opt_to_jax(cfg, opt)
    for got, want in ((jp, want_p), (jo, want_o)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(g), w)
    assert jp["groups"]["b0"]["mix"]["wq"].dtype == np.float32

    over = dict(param_dtype="bfloat16")
    rcfg = dataclasses.replace(get_config(RG, smoke=True), **over)
    rjm = JaxModel(dataclasses.replace(jax_config(RG, smoke=True), **over),
                   make_mesh(1, 1))
    p0 = _jax(jax.tree.map(np.asarray, rjm.init_params(1)))
    (batch,) = _batches(rcfg, s=SEQ[RG], n=1, b=2)
    p1, o1, _ = jax.jit(jmake_train_step(rjm, jopt_cfg))(
        p0, jinit_opt(p0, jopt_cfg), _jax(batch))
    JaxCkpt(str(tmp_path / "ref")).save(3, (p1, o1), blocking=True)
    tr = _trainer(RG, tmp_path / "ref", steps=5, seq=16, **over)
    step, tparams, topt = tr.restore()
    assert step == 3
    want = from_jax_params(rcfg, jax.tree.map(np.asarray, p1))
    assert all(torch.equal(tparams[k].detach(), want[k].to(tparams[k].dtype))
               for k in want)
    wopt = opt_from_jax(rcfg, jax.tree.map(np.asarray, o1))
    for mom in ("m", "v"):
        assert topt[mom]["blocks.0.mix.w_a"].dtype == torch.float32
        assert all(torch.equal(topt[mom][k], wopt[mom][k])
                   for k in wopt[mom])
    params, opt = tr.run(0)     # steps 3 and 4, then its checkpoint at 5
    params = {k: p.detach().clone() for k, p in params.items()}
    step, rparams, ropt = tr.restore()
    assert step == 5
    assert all(torch.equal(rparams[k].detach(), p.detach())
               for k, p in params.items())
    for mom in ("m", "v"):
        assert ropt[mom]["blocks.0.mix.w_a"].dtype == torch.float32
        assert all(torch.equal(ropt[mom][k], opt[mom][k])
                   for k in opt[mom])


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_opt_state_converts_both_ways(mode):
    """The reference's AdamW state after one jitted step of recurrentgemma
    at bf16 ``param_dtype`` becomes the port's and goes back leaf for leaf:
    the widened gates' moments stay fp32 (or int8 ``{q, s}``), never the
    parameter's bf16."""
    jcfg = dataclasses.replace(jax_config(RG, smoke=True),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config(RG, smoke=True),
                              param_dtype="bfloat16")
    jm = JaxModel(jcfg, make_mesh(1, 1))
    opt_cfg = JAdamW(lr=LR, state_mode=mode)
    p0 = _jax(jax.tree.map(np.asarray, jm.init_params(0)))
    (batch,) = _batches(cfg, s=SEQ[RG], n=1, b=2)
    _, o1, _ = jax.jit(jmake_train_step(jm, opt_cfg))(
        p0, jinit_opt(p0, opt_cfg), _jax(batch))
    tree = jax.tree.map(np.asarray, o1)
    state = opt_from_jax(cfg, tree)
    back = opt_to_jax(cfg, state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch,seq", [(RG, "16"), (XL, "64")])
def test_launcher_trains_the_smoke_config_on_the_cpu(tmp_path, capsys, arch,
                                                     seq):
    tr = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                            "--steps", "3", "--batch", "2", "--seq", seq,
                            "--warmup", "1", "--ckpt-dir", str(tmp_path)])
    assert [m["step"] for m in tr.metrics] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in tr.metrics)
    out = capsys.readouterr().out
    assert "first loss" in out and "device=cpu" in out


def test_launcher_refuses_an_mlstm_length():
    """The mLSTM's chunkwise form takes fewer than 64 positions or a
    multiple of 64 (ROADMAP F10): the launcher refuses others before it
    builds anything."""
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", XL, "--smoke", "--device", "cpu",
                           "--seq", "100"])
