"""The port's training slice against the reference's train step, on the
CPU (the reference in its ``xla`` kernel mode, its step under
``jax.jit`` as its trainer runs it).

* ``Model.loss`` and its gradients for granite and internlm2, an MoE
  (grok-1's smoke config: the ``0.01 * aux / n_layers`` term),
  paligemma (its prefix's targets ignored), gemma2 (local and global
  layers, the attention and final softcaps), gemma3 (5 local to 1
  global, two RoPE thetas) and whisper (the encoder over the batch's
  frames, the cross-attention), fp32 compute: the loss within 1e-5 relative,
  every gradient leaf within 1e-4 of its scale.
* The train step (AdamW, clipping, bias corrections, weight decay) after
  1 and 3 steps for granite, internlm2, gemma2 and gemma3 at fp32: losses and grad norms
  within 1e-5 relative, and the parameters compared on their update (p -
  p0) relative to lr: at most 0.1% of the entries off by more than 1e-3
  lr (Adam's step-1 update is +-lr wherever |g| >> eps, so only entries
  whose gradient lies below the two frameworks' gradient difference can
  move, as far as 2 lr).  At bf16 compute (internlm2) the port's distance
  from the reference's fp32 run within twice the reference's own bf16
  distance from it: each token's NLL (the max over tokens), every
  gradient leaf, and the mean parameter update after 1 and 3 steps, on
  weights that are bf16 values (the port's K1 multiplies the bf16 cast of
  each master weight; the reference promotes its fp32 weights, so on
  other values the two would differ by the weights' rounding, not by the
  pipeline).  A scalar (the mean loss, the grad norm) is one draw of the
  rounding noise, so the rule is held on the vectors.
* Bitwise: the synthetic token stream, the memmap source, the int8
  moment codec (the jitted form, ROADMAP F4), the warmup's values and a
  one-step AdamW update at grad_clip 0 (fp32 and int8 moments); the
  cosine decay within 4 fp32 ulps (each library's fp32 cosine).
* ``tests/test_substrate.py``'s trainer checks restated on the port: data
  deterministic and resumable, tokens in vocab, AdamW decreasing a
  quadratic, int8 moments tracking fp32, gradient accumulation equal to
  one big batch, the trainer's loss falling, recovery from an injected
  failure, resume equal to uninterrupted (bitwise here), the straggler
  watchdog; and a checkpoint of an fp32 training state restored across the
  packages both ways; the launcher with ``--device cpu --smoke``.
* C3: the served internlm2 at bf16 compute takes bf16 x bf16 in every
  GEMM (its fp32 masters' served copy), and the copy follows the weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCkpt
from repro.configs import get_config as jax_config
from repro.data import DataConfig as JDataConfig
from repro.data import MemmapTokenSource as JMemmap
from repro.data import SyntheticTokenSource as JSynthetic
from repro.data import TokenPipeline as JPipeline
from repro.kernels import ops as jops
from repro.launch.mesh import make_mesh
from repro.models.lm import Model as JaxModel
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw as jadamw
from repro.optim import abstract_opt_state
from repro.optim import init_opt_state as jinit_opt
from repro.optim.schedule import warmup_cosine as jwarmup_cosine
from repro.train.step import make_train_step as jmake_train_step

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import (from_jax_params, opt_from_jax, opt_to_jax,
                                 to_jax_params)
from repro_torch.data import (DataConfig, MemmapTokenSource,
                              SyntheticTokenSource, TokenPipeline)
from repro_torch.kernels import ops as kops
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import Model
from repro_torch.optim import (AdamWConfig, adamw_update, constant,
                               global_norm, init_opt_state, warmup_cosine)
from repro_torch.optim import adamw as tadamw
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train.step import loss_and_grads, make_train_step
from repro_torch.train.trainer import (StragglerWatchdog, Trainer,
                                       TrainerConfig)

torch.set_num_threads(1)

LR = 1e-3
B, S, STEPS = 4, 32, 3


@pytest.fixture(autouse=True)
def _xla_mode():
    assert jops.kernel_mode() == "xla", "the reference must run its CPU path"


def _rel(got, want) -> float:
    g = np.asarray(got.detach().double() if torch.is_tensor(got) else got,
                   np.float64)
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))


def _round_bf16(params):
    """Every float leaf of more than one dimension rounded to bf16 values
    (held at its own dtype)."""
    def r(a):
        a = np.asarray(a)
        if a.dtype == np.float32 and a.ndim > 1:
            return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(
                jnp.float32))
        return a
    return jax.tree.map(r, params)


def _pair(arch, compute_dtype, bf16_values=False, **over):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True),
                               compute_dtype=compute_dtype, **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=compute_dtype, **over)
    jm = JaxModel(jcfg, make_mesh(1, 1))
    params = jax.tree.map(np.asarray, jm.init_params(0))
    if bf16_values:
        params = _round_bf16(params)
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(from_jax_params(tcfg, params))
    return jm, params, tm


def _batches(cfg, n=STEPS, b=B, s=S, seed=0):
    src, dcfg = JSynthetic(cfg.vocab, seed), JDataConfig(b, s, seed)
    out = []
    for i in range(n):
        toks = src.batch(i, slice(0, b), dcfg)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if cfg.prefix_tokens:
            rng = np.random.default_rng(100 + i)
            batch["patches"] = rng.standard_normal(
                (b, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
            batch = {k: (v[:, :s - cfg.prefix_tokens] if k != "patches"
                         else v) for k, v in batch.items()}
        if cfg.encdec:
            rng = np.random.default_rng(200 + i)
            batch["frames"] = rng.standard_normal(
                (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-3-8b", "internlm2-1.8b",
                                  "grok-1-314b", "paligemma-3b",
                                  "gemma2-27b", "gemma3-12b",
                                  "whisper-small"])
def test_loss_and_grads_match_the_reference(arch):
    jm, params, tm = _pair(arch, "float32")
    (batch,) = _batches(jm.cfg, n=1)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    tp = tm.train_params()
    loss, grads = loss_and_grads(tm, tp, _torch_batch(batch))
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    want = from_jax_params(tm.cfg, jax.tree.map(np.asarray, jg))
    assert set(want) == set(grads)
    for key, g in grads.items():
        assert _rel(g, want[key].numpy()) <= 1e-4, key


def test_moe_aux_and_prefix_targets_reach_the_loss():
    """grok's loss holds its load-balancing term (changing the routers
    moves it), paligemma's ignores its patch positions (targets there are
    never read)."""
    _, _, tm = _pair("grok-1-314b", "float32")
    (batch,) = _batches(tm.cfg, n=1)
    params = tm.train_params()
    h, aux = tm.train_forward(params, torch.from_numpy(batch["tokens"]))
    assert 0.5 < float(aux.detach()) / tm.cfg.n_layers < tm.cfg.n_experts
    _, _, pm = _pair("paligemma-3b", "float32")
    (batch,) = _batches(pm.cfg, n=1)
    tb = _torch_batch(batch)
    loss = pm.loss(pm.train_params(), tb)
    tb["patches"] = tb["patches"] * 2
    assert float(pm.loss(pm.train_params(), tb)) != float(loss)


def test_remat_recompute_is_bitwise_the_forward():
    """Per-block rematerialization changes no bit of the loss or of any
    gradient (the recomputed block is the forward's arithmetic)."""
    _, params, tm = _pair("internlm2-1.8b", "bfloat16")
    (batch,) = _batches(tm.cfg, n=1)
    l1, g1 = loss_and_grads(tm, tm.train_params(), _torch_batch(batch))
    tm.cfg = dataclasses.replace(tm.cfg, remat="none")
    l2, g2 = loss_and_grads(tm, tm.train_params(), _torch_batch(batch))
    assert torch.equal(l1, l2)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _reference_steps(jm, params, batches, opt_cfg=None):
    opt_cfg = opt_cfg or JAdamW(lr=LR)
    step = jax.jit(jmake_train_step(jm, opt_cfg))
    p = jax.tree.map(jnp.asarray, params)
    o = jinit_opt(p, opt_cfg)
    hist, trees = [], []
    for b in batches:
        p, o, m = step(p, o, jax.tree.map(jnp.asarray, b))
        hist.append((float(m["loss"]), float(m["grad_norm"])))
        trees.append(jax.tree.map(np.asarray, p))
    return hist, trees


def _port_steps(tm, batches, opt_cfg=None):
    opt_cfg = opt_cfg or AdamWConfig(lr=LR)
    params = tm.train_params()
    state = init_opt_state(params, opt_cfg)
    step = make_train_step(tm, opt_cfg)
    hist, snaps = [], []
    for b in batches:
        params, state, m = step(params, state, _torch_batch(b))
        hist.append((float(m["loss"]), float(m["grad_norm"])))
        snaps.append({k: p.detach().clone() for k, p in params.items()})
    return hist, snaps


@pytest.fixture(scope="module", params=["granite-3-8b", "internlm2-1.8b",
                                        "gemma2-27b", "gemma3-12b"])
def fp32_runs(request):
    jm, params, tm = _pair(request.param, "float32")
    p0 = {k: v.clone() for k, v in tm.state_dict().items()}
    batches = _batches(jm.cfg)
    ref = _reference_steps(jm, params, batches)
    port = _port_steps(tm, batches)
    return tm.cfg, p0, ref, port


@pytest.mark.parametrize("step", [0, STEPS - 1], ids=["1step", "3steps"])
def test_train_step_matches_the_reference_at_fp32(fp32_runs, step):
    cfg, p0, (jh, jtrees), (th, tsnaps) = fp32_runs
    for i in range(step + 1):
        assert abs(th[i][0] - jh[i][0]) <= 1e-5 * abs(jh[i][0])
        assert abs(th[i][1] - jh[i][1]) <= 1e-5 * abs(jh[i][1])
    want = from_jax_params(cfg, jtrees[step])
    off = total = 0
    for k, p in tsnaps[step].items():
        d = ((p.double() - p0[k].double())
             - (want[k].double() - p0[k].double())).abs() / LR
        off += int((d > 1e-3).sum())
        total += d.numel()
        assert float(d.max()) <= 2.2, k     # at most a flipped sign
    assert off <= 1e-3 * total, (off, total)


def _token_nll(h, embed, targets):
    """Each token's NLL [B, S] at f64 from the final-normed stream and the
    tied embedding (the loss before its mean)."""
    logits = np.asarray(h, np.float64) @ np.asarray(embed, np.float64).T
    mx = logits.max(-1, keepdims=True)
    lse = (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))[..., 0]
    return lse - np.take_along_axis(logits, targets[..., None], -1)[..., 0]


@pytest.fixture(scope="module")
def bf16_pair():
    jm, params, tm = _pair("internlm2-1.8b", "bfloat16", bf16_values=True)
    j32 = JaxModel(dataclasses.replace(jm.cfg, compute_dtype="float32"),
                   jm.mesh)
    return jm, j32, params, tm


def test_loss_and_grads_at_bf16_within_the_reference_noise(bf16_pair):
    """bf16 compute: each token's NLL and every gradient leaf lie as close
    to the reference's fp32 run as twice the reference's own bf16 run
    does (the max over tokens; each leaf against its own scale)."""
    jm, j32, params, tm = bf16_pair
    (batch,) = _batches(jm.cfg, n=1)
    jp, jb = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             batch)
    nll = {}
    for name, m in (("ref", jm), ("anchor", j32)):
        h = jax.jit(lambda p, b: m.forward(p, b, mode="train")[0])(jp, jb)
        nll[name] = _token_nll(np.asarray(h.astype(jnp.float32)),
                               params["embed"], batch["targets"])
    with torch.no_grad():
        h, _ = tm.train_forward(tm.train_params(),
                                torch.from_numpy(batch["tokens"]))
    nll["port"] = _token_nll(h.float().numpy(), params["embed"],
                             batch["targets"])
    err = np.abs(nll["port"] - nll["anchor"]).max()
    noise = np.abs(nll["ref"] - nll["anchor"]).max()
    assert err <= 2 * noise, (err, noise)
    grads = {name: from_jax_params(tm.cfg, jax.tree.map(
        np.asarray, jax.jit(jax.grad(m.loss))(jp, jb)))
        for name, m in (("ref", jm), ("anchor", j32))}
    _, tg = loss_and_grads(tm, tm.train_params(), _torch_batch(batch))
    for key, g in tg.items():
        a = grads["anchor"][key].double()
        err = float((g.double() - a).abs().max())
        noise = float((grads["ref"][key].double() - a).abs().max())
        assert err <= 2 * noise, (key, err, noise)


def test_train_step_at_bf16_within_the_reference_noise(bf16_pair):
    """One and three bf16 steps: the port's mean parameter update lies as
    close to the reference's fp32 run's as twice the reference's own bf16
    run's does (relative to lr)."""
    jm, j32, params, tm = bf16_pair
    batches = _batches(jm.cfg)
    _, jtrees = _reference_steps(jm, params, batches)
    _, atrees = _reference_steps(j32, params, batches)
    p0 = {k: v.clone().double() for k, v in tm.state_dict().items()}
    _, tsnaps = _port_steps(tm, batches)
    for i in (0, STEPS - 1):
        anchor = from_jax_params(tm.cfg, atrees[i])
        refb = from_jax_params(tm.cfg, jtrees[i])

        def mean_dist(snap):
            return sum(float(((snap[k].double() - p0[k])
                              - (anchor[k].double() - p0[k])).abs().sum())
                       for k in p0) / sum(v.numel() for v in p0.values())
        assert mean_dist(tsnaps[i]) <= 2 * mean_dist(refb), i


def test_gradient_accumulation_equals_one_big_batch():
    """1 big batch == the mean of 2 microbatches (the reference's check,
    on the port): the losses within 1e-3, the parameters within 5e-3."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              compute_dtype="float32")
    base = Model(cfg, device="cpu").init_weights(0)
    (batch,) = _batches(cfg, n=1, b=4, s=16)
    out = []
    for n in (1, 2):
        m = Model(cfg, device="cpu")
        m.load_state_dict(base.state_dict())
        params = m.train_params()
        opt = AdamWConfig(lr=LR)
        p, _, met = make_train_step(m, opt, n)(
            params, init_opt_state(params, opt), _torch_batch(batch))
        out.append((float(met["loss"]), {k: v.detach().clone()
                                         for k, v in p.items()}))
    assert abs(out[0][0] - out[1][0]) < 1e-3
    assert max(float((out[0][1][k] - out[1][1][k]).abs().max())
               for k in out[0][1]) < 5e-3


# ---------------------------------------------------------------------------
# the optimizer: bitwise where the reference's arithmetic can be followed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sqrt_scale", [False, True])
def test_int8_codec_is_bitwise_the_jitted_reference(sqrt_scale):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((33, 80)) * np.exp(rng.uniform(-8, 2, (33, 1)))
         ).astype(np.float32)
    if sqrt_scale:
        x = np.abs(x)
    x[3] = 0.0
    want = jax.jit(lambda a: jadamw._q8(a, sqrt_scale))(jnp.asarray(x))
    got = tadamw._q8(torch.from_numpy(x), sqrt_scale)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    back = jax.jit(lambda p: jadamw._dq8(p, sqrt_scale))(want)
    np.testing.assert_array_equal(tadamw._dq8(got, sqrt_scale).numpy(),
                                  np.asarray(back))


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_one_adamw_step_is_bitwise_the_reference(mode):
    """With grad_clip 0 (no global norm in the step) one AdamW update of
    the parameters and both moments is the jitted reference's bit for
    bit."""
    rng = np.random.default_rng(12)
    params = {"a": rng.standard_normal((6, 40)).astype(np.float32),
              "b": rng.standard_normal(24).astype(np.float32)}
    grads = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
             for k, v in params.items()}
    jcfg = JAdamW(lr=LR, grad_clip=0.0, state_mode=mode)
    jp = jax.tree.map(jnp.asarray, params)
    jp2, jo2 = jax.jit(lambda p, g, o: jadamw.adamw_update(p, g, o, jcfg))(
        jp, jax.tree.map(jnp.asarray, grads), jinit_opt(jp, jcfg))
    tcfg = AdamWConfig(lr=LR, grad_clip=0.0, state_mode=mode)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tp2, to2 = adamw_update(tp, {k: torch.from_numpy(v) for k, v in
                                 grads.items()}, init_opt_state(tp, tcfg),
                            tcfg)
    for k in params:
        np.testing.assert_array_equal(tp2[k].numpy(), np.asarray(jp2[k]))
    got = opt_to_jax_flat(to2)
    want = jax.tree.map(np.asarray, jo2)
    assert int(got["step"]) == int(want["step"]) == 1
    for k in params:
        for mom in ("m", "v"):
            g, w = got[mom][k], want[mom][k]
            if isinstance(w, dict):
                np.testing.assert_array_equal(g["q"], w["q"])
                np.testing.assert_array_equal(g["s"], w["s"])
            else:
                np.testing.assert_array_equal(g, w)


def opt_to_jax_flat(state):
    def host(t):
        return ({k: host(v) for k, v in t.items()} if isinstance(t, dict)
                else t.numpy())
    return host(state)


def test_schedules_follow_the_jitted_reference():
    """The warmup (XLA's multiply by the rounded reciprocal of the step
    count) and the constant bit for bit; the cosine decay within 4 fp32
    ulps (the two libraries' fp32 cosines differ in the last bit at some
    angles, the port's being the correctly rounded one, and the scaling
    after it carries that ulp on: 2 ulps at most, at a tenth of these
    steps)."""
    n = 400
    steps = jnp.arange(0, n, dtype=jnp.int32)
    want = np.asarray(jax.jit(jax.vmap(jwarmup_cosine(3e-4, 100, 300)))(
        steps))
    f = warmup_cosine(3e-4, 100, 300)
    got = np.array([float(f(torch.tensor(i, dtype=torch.int32)))
                    for i in range(n)], np.float32)
    np.testing.assert_array_equal(got[:100], want[:100])
    assert np.all(np.abs(got - want) <= 4 * np.spacing(want))
    assert float(constant(2e-3)(torch.tensor(5))) == np.float32(2e-3)


def test_global_norm_matches_the_reference():
    """The leaves' fp32 sums of squares added in the given order, then the
    square root: within 1e-6 of the reference's (each leaf's own sum runs
    in each library's reduction order)."""
    rng = np.random.default_rng(13)
    leaves = {f"x{i}": rng.standard_normal(n).astype(np.float32)
              for i, n in enumerate((7, 300, 1, 4096))}
    want = float(jax.jit(jadamw.global_norm)(
        jax.tree.map(jnp.asarray, leaves)))
    got = float(global_norm(torch.from_numpy(leaves[k])
                            for k in sorted(leaves)))
    assert abs(got - want) <= 1e-6 * want


def test_adamw_decreases_a_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init_opt_state(params, cfg)
    for _ in range(200):
        params, state = adamw_update(params, {"w": 2 * params["w"]}, state,
                                     cfg)
    assert float(params["w"].abs().max()) < 1e-2


def test_int8_moments_track_fp32():
    g = torch.Generator().manual_seed(0)
    w0 = torch.randn(16, 64, generator=g)
    tgt = torch.randn(16, 64, generator=g)

    def run(mode):
        cfg = AdamWConfig(lr=0.05, weight_decay=0.0, grad_clip=0.0,
                          state_mode=mode)
        params = {"w": w0.clone()}
        state = init_opt_state(params, cfg)
        for _ in range(100):
            params, state = adamw_update(params,
                                         {"w": params["w"] - tgt}, state, cfg)
        return float(((params["w"] - tgt) ** 2).mean())
    assert run("fp32") < 1e-2
    assert run("int8") < 5e-2


# ---------------------------------------------------------------------------
# the data
# ---------------------------------------------------------------------------

def test_synthetic_stream_is_bitwise_the_reference():
    for vocab, seed in ((256, 0), (92544, 3)):
        dcfg = DataConfig(global_batch=5, seq_len=33, seed=seed)
        src, jsrc = SyntheticTokenSource(vocab, seed), JSynthetic(vocab, seed)
        for step in (0, 1, 17):
            np.testing.assert_array_equal(
                src.batch(step, slice(0, 5), dcfg),
                jsrc.batch(step, slice(0, 5), JDataConfig(5, 33, seed)))


def test_pipeline_batches_are_the_references(tmp_path):
    """The pipeline's tokens, targets and paligemma's patches equal the
    reference pipeline's, step for step, and the memmap source reads a
    file the test writes as the reference does."""
    cfg = get_config("paligemma-3b", smoke=True)
    jcfg = jax_config("paligemma-3b", smoke=True)
    dcfg = DataConfig(global_batch=2, seq_len=24, seed=5)
    path = str(tmp_path / "tokens.bin")
    np.arange(1000, dtype=np.int32).tofile(path)
    for src, jsrc in ((SyntheticTokenSource(cfg.vocab, 5),
                       JSynthetic(cfg.vocab, 5)),
                      (MemmapTokenSource(path, cfg.vocab),
                       JMemmap(path, cfg.vocab))):
        p = TokenPipeline(src, dcfg, "cpu", cfg, start_step=2)
        jp = JPipeline(jsrc, JDataConfig(2, 24, 5), make_mesh(1, 1), jcfg,
                       start_step=2)
        for _ in range(2):
            (s, b), (js, jb) = next(p), next(jp)
            assert s == js
            assert set(b) == set(jb) == {"tokens", "targets", "patches"}
            for k in b:
                np.testing.assert_array_equal(b[k].numpy(),
                                              np.asarray(jb[k]))
        p.close()
        jp.close()


def test_data_deterministic_and_resumable():
    cfg = DataConfig(global_batch=4, seq_len=16, seed=3)
    src = SyntheticTokenSource(vocab=100, seed=3)
    p1 = TokenPipeline(src, cfg)
    first = [next(p1) for _ in range(5)]
    p1.close()
    p2 = TokenPipeline(src, cfg, start_step=3)
    s, b = next(p2)
    p2.close()
    assert s == 3
    assert torch.equal(b["tokens"], first[3][1]["tokens"])
    assert torch.equal(first[0][1]["tokens"][:, 1:],
                       first[0][1]["targets"][:, :-1])


def test_data_tokens_in_vocab():
    p = TokenPipeline(SyntheticTokenSource(vocab=50),
                      DataConfig(global_batch=2, seq_len=8))
    _, b = next(p)
    p.close()
    assert int(b["tokens"].max()) < 50 and int(b["tokens"].min()) >= 0


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _trainer(tmp_path, steps=12, fail_at=None, mode="fp32", ckpt_every=4):
    cfg = get_config("internlm2-1.8b", smoke=True)
    model = Model(cfg, device="cpu")
    tcfg = TrainerConfig(steps=steps, ckpt_every=ckpt_every,
                         ckpt_dir=str(tmp_path), keep=2, log_every=100,
                         fail_at_step=fail_at)
    src = SyntheticTokenSource(cfg.vocab)

    def factory(start):
        return TokenPipeline(src, DataConfig(global_batch=2, seq_len=32),
                             "cpu", cfg, start_step=start)
    return Trainer(model, AdamWConfig(lr=LR, state_mode=mode), tcfg,
                   factory)


def test_trainer_loss_decreases(tmp_path):
    tr = _trainer(tmp_path, steps=30)
    tr.run(0)
    losses = [m["loss"] for m in tr.metrics]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert all(np.isfinite(losses))


def test_trainer_without_checkpoints_writes_none(tmp_path):
    """``ckpt_every=0`` (the card's training phases past the first, whose
    state is tens of GB): the steps run and no checkpoint is written."""
    tr = _trainer(tmp_path, steps=3, ckpt_every=0)
    tr.run(0)
    assert [m["step"] for m in tr.metrics] == [0, 1, 2]
    assert tr.ckpt.latest_step() is None
    assert not list(tmp_path.iterdir())


def test_trainer_recovers_from_an_injected_failure(tmp_path):
    tr = _trainer(tmp_path, steps=10, fail_at=6)
    tr.run(0)
    steps_seen = [m["step"] for m in tr.metrics]
    # step 6 failed once, the trainer restored the step-4 checkpoint and
    # ran 4..9 again
    assert steps_seen.count(5) == 2
    assert steps_seen[-1] == 9
    assert tr.ckpt.latest_step() == 10


def test_trainer_reads_the_references_failure_variable(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("REPRO_FAIL_AT_STEP", "3")
    tr = _trainer(tmp_path, steps=6, ckpt_every=2)
    tr.run(0)
    assert [m["step"] for m in tr.metrics] == [0, 1, 2, 2, 3, 4, 5]


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_trainer_resume_matches_uninterrupted(tmp_path, mode):
    """A run stopped at its step-4 checkpoint and resumed lands on the
    uninterrupted run's parameters bit for bit (int8 moments through
    their ``{q, s}`` leaves)."""
    a = _trainer(tmp_path / "a", steps=8, mode=mode)
    pa, _ = a.run(0)
    pa = {k: v.detach().clone() for k, v in pa.items()}
    _trainer(tmp_path / "b", steps=4, mode=mode).run(0)
    b2 = _trainer(tmp_path / "b", steps=8, mode=mode)
    pb, _ = b2.run(0)
    assert [m["step"] for m in b2.metrics] == [4, 5, 6, 7]
    assert [m["loss"] for m in b2.metrics] == [m["loss"]
                                              for m in a.metrics[4:]]
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


def test_straggler_watchdog_flags_slow_steps():
    wd = StragglerWatchdog(factor=3.0, alpha=0.2)
    for s in range(10):
        wd.observe(s, 0.1)
    assert not wd.events
    wd.observe(10, 1.0)
    assert len(wd.events) == 1 and wd.events[0]["step"] == 10


def test_checkpoints_cross_the_packages(tmp_path):
    """The port trainer's checkpoint of an fp32 training state (params and
    AdamW state after 2 steps) restores through the reference's
    ``CheckpointManager`` into its own trees, leaf for leaf; a reference
    checkpoint of its (params, opt) restores through the port trainer."""
    tr = _trainer(tmp_path / "port", steps=2, ckpt_every=2)
    params, opt = tr.run(0)
    cfg = tr.model.cfg
    jm = JaxModel(jax_config("internlm2-1.8b", smoke=True), make_mesh(1, 1))
    jopt_cfg = JAdamW(lr=LR)
    like = (jm.abstract_params(),
            abstract_opt_state(jm.abstract_params(), jopt_cfg))
    step, (jp, jo) = JaxCkpt(str(tmp_path / "port")).restore(None, like)
    assert step == 2
    want_p, want_o = to_jax_params(cfg, params), opt_to_jax(cfg, opt)
    for got, want in ((jp, want_p), (jo, want_o)):
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(g), w)

    # the reverse: a reference (params, opt) written by its manager
    p0 = jax.tree.map(jnp.asarray, jm.init_params(1))
    o0 = jinit_opt(p0, jopt_cfg)
    (batch,) = _batches(jm.cfg, n=1, b=2)
    p1, o1, _ = jax.jit(jmake_train_step(jm, jopt_cfg))(
        p0, o0, jax.tree.map(jnp.asarray, batch))
    JaxCkpt(str(tmp_path / "ref")).save(3, (p1, o1), blocking=True)
    tr2 = _trainer(tmp_path / "ref", steps=4)
    step, tparams, topt = tr2.restore()
    assert step == 3
    want = from_jax_params(cfg, jax.tree.map(np.asarray, p1))
    assert all(torch.equal(tparams[k].detach(), want[k]) for k in want)
    wopt = opt_from_jax(cfg, jax.tree.map(np.asarray, o1))
    assert int(topt["step"]) == 1
    for mom in ("m", "v"):
        assert all(torch.equal(topt[mom][k], wopt[mom][k])
                   for k in wopt[mom])


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_opt_state_converts_both_ways(mode):
    """The reference's AdamW state after one jitted step becomes the
    port's and goes back leaf for leaf (int8: its ``{q, s}`` leaves,
    stacked groups' row scales per layer)."""
    jm = JaxModel(jax_config("internlm2-1.8b", smoke=True), make_mesh(1, 1))
    jcfg = JAdamW(lr=LR, state_mode=mode)
    p0 = jax.tree.map(jnp.asarray, jm.init_params(0))
    (batch,) = _batches(jm.cfg, n=1, b=2)
    _, o1, _ = jax.jit(jmake_train_step(jm, jcfg))(
        p0, jinit_opt(p0, jcfg), jax.tree.map(jnp.asarray, batch))
    tree = jax.tree.map(np.asarray, o1)
    cfg = get_config("internlm2-1.8b", smoke=True)
    state = opt_from_jax(cfg, tree)
    if mode == "int8":
        wq = state["m"]["blocks.1.ffn.down"]
        assert set(wq) == {"q", "s"} and wq["q"].dtype == torch.int8
        assert wq["s"].shape == (cfg.d_ff, 1)
    back = opt_to_jax(cfg, state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(g, w)


def test_launcher_trains_the_smoke_config_on_the_cpu(tmp_path, capsys):
    tr = launch_train.main(["--arch", "internlm2-1.8b", "--smoke",
                            "--device", "cpu", "--steps", "6", "--batch",
                            "2", "--seq", "16", "--warmup", "2",
                            "--ckpt-dir", str(tmp_path)])
    assert [m["step"] for m in tr.metrics] == list(range(6))
    assert all(np.isfinite(m["loss"]) for m in tr.metrics)
    assert tr.ckpt.latest_step() == 6
    out = capsys.readouterr().out
    assert "first loss" in out and "device=cpu" in out
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "internlm2-1.8b", "--smoke", "--device",
                           "cpu", "--model-mesh", "2"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_training_fields_are_the_references(arch):
    for smoke in (False, True):
        got, want = get_config(arch, smoke=smoke), jax_config(arch,
                                                              smoke=smoke)
        for f in ("opt_state_mode", "remat", "microbatches",
                  "grad_accum_dtype"):
            assert getattr(got, f) == getattr(want, f), (arch, smoke, f)


# ---------------------------------------------------------------------------
# C3: internlm2 served at bf16 from its fp32 masters
# ---------------------------------------------------------------------------

def test_served_internlm2_multiplies_bf16_by_bf16(monkeypatch):
    """internlm2's float32 masters at bf16 compute: every GEMM the fixed
    loop and the scheduler run takes a bf16 activation and a bf16 weight,
    as K1 requires on the card (the served copy of the projections), and
    the masters stay fp32."""
    cfg = get_config("internlm2-1.8b", smoke=True)
    assert (cfg.param_dtype, cfg.compute_dtype) == ("float32", "bfloat16")
    model = Model(cfg, device="cpu").init_weights(0)
    seen = []
    real = kops.matmul

    def spy(a, b, **kw):
        seen.append((a.dtype, b.dtype))
        return real(a, b, **kw)
    monkeypatch.setattr(kops, "matmul", spy)
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(0))
    eng = ServeEngine(model, ServeConfig(max_new_tokens=4))
    eng.generate_with_status_fixed({"tokens": toks})
    eng.generate({"tokens": toks})
    assert len(seen) > 4 * cfg.n_layers
    assert set(seen) == {(torch.bfloat16, torch.bfloat16)}, set(seen)
    assert model.blocks[0].attn.wo.dtype == torch.float32


def test_served_copy_follows_the_weights():
    """The served copy is made once and again only after a projection
    weight changes in place (its version counter): a model whose weights
    were tripled after its first prefill serves what a fresh model holding
    the tripled weights serves."""
    cfg = get_config("internlm2-1.8b", smoke=True)
    model = Model(cfg, device="cpu").init_weights(0)
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    first = model.served_blocks()
    assert model.served_blocks()[0] is first[0]
    model.prefill(toks)
    with torch.no_grad():
        model.blocks[1].ffn.up.mul_(3)
    assert model.served_blocks()[0] is not first[0]
    fresh = Model(cfg, device="cpu")
    fresh.load_state_dict(model.state_dict())
    assert torch.equal(model.prefill(toks)[0], fresh.prefill(toks)[0])
