"""recurrentgemma-9b's path through the port against the JAX reference, on
the CPU: the config copy (ROADMAP F8 pinned), the parameter tree both
ways, the RG-LRU mixer (``models/rglru.py``) against the reference's
``rglru_apply``, its scan against an f64 recurrence, the model's prefill
and decode step, ``generate_with_status``'s fall-through to the fixed
loop (bf16 and int8), the refusals, what the served path hands the
kernels (intercepted at ``kernels._cuda.launch``; the CUDA kernels run
only on the card, where ``chip_smoke.py`` holds them to these plain
versions), a checkpoint round trip, the launcher and the int8 build's
peak.

Tolerances, each with its reason:

* Both sides hold the same parameters, every weight rounded to
  bf16-representable values (the bf16-weight runs hold them as bf16, the
  fp32 runs as fp32: the same numbers).
* The mixer at fp32 compute within 1e-6 of its scale (the fp32 gate
  products sum in another order).  At bf16 compute its distance from the
  reference's fp32-compute run within twice the reference's own (the conv
  rounds as XLA's CPU fusion does and the scan combines the same pairs in
  the same order with the same FMAs, so the outputs are the reference's
  but for rare rounding flips of a bf16 product).  With saturated gates
  (tripled weights) both sides' distance from the f64 formula, the
  port's within 4x the reference's.
* The model's logits at fp32 compute within 1e-5 of their scale; at bf16
  compute their distance from the reference's fp32-compute run within 4x
  the reference's own (ROADMAP's consistency-budget rule, the fp32 run
  for the f64 oracle): the recurrent states carry each run's prefill
  roundings into every step.
* The scan against an f64 sequential recurrence: within 64 fp32 ulps of
  each row's largest state (log-depth sums round about log2(S) times).
* Greedy tokens through the engines are equal: bf16 weights at bf16
  compute, int8 weights at fp32 compute (each framework then quantizes
  the same fp32 activations).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.launch.mesh import make_mesh
from repro.models import rglru as jrglru
from repro.models.layers import TPCtx
from repro.models.lm import Model as JaxModel
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.quantize import QuantizedWeight
from repro_torch.launch import serve as tserve
from repro_torch.models import rglru
from repro_torch.models.lm import Model
from repro_torch.robust.guards import STATUS_OK
from repro_torch.serve.api import Request
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

ARCH = "recurrentgemma-9b"
H100_SMS = 132
PROMPT, STEPS, BATCH = 12, 8, 2


@pytest.fixture(autouse=True)
def _xla_mode():
    assert jops.kernel_mode() == "xla", "the reference must run its CPU path"


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_is_the_reference_copy(smoke):
    """Every field of the port's ``ArchConfig`` (``lru_width`` and
    ``conv_width`` included) equals the reference's, and so does the
    parameter count."""
    got, want = get_config(ARCH, smoke=smoke), jax_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(ArchConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.param_count() == want.param_count()
    assert ARCH in ARCH_IDS


def test_param_count_is_the_references_f8():
    """ROADMAP F8: the reference's ``param_count`` counts an RG-LRU
    mixer's gates and decay as ``3 w`` where its init builds two dense [w,
    w] gates and ``lam`` [w], so it says 8.52 B where the model holds 9.40
    B, 26 x 2 (w^2 - w) fewer.  The port copies the reckoning and states bytes from its
    tensors: 38 layers at full width, 12 of them local attention (16 q
    heads over one kv head of 256, window 2048), the gates at bf16 as the
    reference holds them (the served copy widens them to fp32)."""
    cfg = get_config(ARCH)
    model = Model(cfg, device="meta")
    held = sum(p.numel() for p in model.parameters())
    w = cfg.lru_width
    n_mix = sum(cfg.kind(i) == "rglru" for i in range(cfg.n_layers))
    assert (n_mix, cfg.n_layers - n_mix) == (26, 12)
    assert cfg.param_count() == 8_523_886_592
    assert held == 9_396_088_832
    assert held - cfg.param_count() == n_mix * 2 * (w * w - w)
    assert [cfg.kind(i) for i in (0, 1, 2, 36, 37)] == [
        "rglru", "rglru", "local", "rglru", "rglru"]
    assert (cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.window) == (256, 16, 1,
                                                                  2048)
    blk = model.blocks[0]
    assert not hasattr(blk, "attn") and blk.mix.w_a.dtype == torch.bfloat16
    assert blk.mix.in_x.dtype == torch.bfloat16
    assert blk.mix.lam.dtype == torch.float32
    assert model.blocks[2].attn.wqkv.dtype == torch.bfloat16
    assert sum(p.nbytes for p in model.parameters()) == 18_793_021_440


# ---------------------------------------------------------------------------
# the parameters, shared by the tests below
# ---------------------------------------------------------------------------

def _bf16_round(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _vary(params, rng, path=()):
    """Random norm scales and tripled attention and MLP weights (so greedy
    tokens vary; ``test_torch_int8_models.py``'s rule), every weight
    rounded to a bf16 value.  The RG-LRU mixers keep the reference's init
    scales: tripled, their gates saturate (``test_saturated_mixer_...``)."""
    for name, leaf in list(params.items()):
        if isinstance(leaf, dict):
            _vary(leaf, rng, (*path, name))
        elif name.startswith("ln") or name == "final_norm":
            params[name] = (0.5 * rng.standard_normal(leaf.shape)
                            ).astype(np.float32)
        elif name != "lam":
            scale = 1 if "mix" in path else 3
            params[name] = _bf16_round(np.asarray(leaf, np.float32) * scale)


@pytest.fixture(scope="module")
def params():
    """The reference's init of the smoke config (3 groups of 1: one group
    of (rglru, rglru, local) and the (rglru, rglru) tail), varied."""
    jm = JaxModel(jax_config(ARCH, smoke=True), make_mesh(1, 1))
    tree = jax.tree.map(np.asarray, jm.init_params(0))
    _vary(tree, np.random.default_rng(7))
    return tree


def _cfgs(compute, weights="float32"):
    over = dict(compute_dtype=compute, param_dtype=weights)
    return (dataclasses.replace(jax_config(ARCH, smoke=True), **over),
            dataclasses.replace(get_config(ARCH, smoke=True), **over))


def _jax_params(tree, weights):
    """The tree at ``weights`` for the reference (``lam`` and the norms
    stay fp32, as its defs keep them)."""
    def cast(path, leaf):
        name = str(path[-1].key)
        if weights == "bfloat16" and name != "lam" and not (
                name.startswith("ln") or name == "final_norm"):
            return jnp.asarray(leaf, jnp.bfloat16)
        return jnp.asarray(leaf)
    return jax.tree_util.tree_map_with_path(cast, tree)


class Pair:
    """The reference (one jit of prefill and one of decode) and the port
    on the same parameters, at one compute dtype and weight dtype."""

    def __init__(self, tree, compute, weights="float32"):
        jcfg, self.cfg = _cfgs(compute, weights)
        self.jm = JaxModel(jcfg, make_mesh(1, 1))
        self.jparams = _jax_params(tree, weights)
        self.tm = Model(self.cfg, device="cpu")
        self.tm.load_state_dict(from_jax_params(
            self.cfg, jax.tree.map(np.asarray, self.jparams)))
        self.prefill = jax.jit(lambda p, t, n: self.jm.prefill(
            p, {"tokens": t}, n), static_argnums=2)
        self.decode = jax.jit(self.jm.decode_step)

    def teacher_forced(self, toks, picks):
        """Both sides' logits [steps, B, v] over the prompt, then each step
        fed ``picks`` [B, steps]."""
        s, steps = toks.shape[1], picks.shape[1]
        jl, jc = self.prefill(self.jparams, jnp.asarray(toks), s + steps)
        tl, tc = self.tm.prefill(torch.from_numpy(toks), s + steps)
        js, ts = [np.asarray(jl, np.float64)], [tl.double().numpy()]
        for i in range(steps - 1):
            tok = picks[:, i:i + 1].astype(np.int32)
            jl, jc = self.decode(self.jparams, jc, jnp.asarray(tok),
                                 jnp.asarray(s + i, jnp.int32))
            tl, tc = self.tm.decode_step(tc, torch.from_numpy(tok), s + i)
            js.append(np.asarray(jl, np.float64))
            ts.append(tl.double().numpy())
        v = self.cfg.vocab
        return np.stack(js)[..., :v], np.stack(ts)[..., :v]


@pytest.fixture(scope="module")
def fp32(params):
    """fp32 weights (bf16 values) at fp32 compute."""
    return Pair(params, "float32")


@pytest.fixture(scope="module")
def bf16(params):
    """bf16 weights at bf16 compute, as on the card."""
    return Pair(params, "bfloat16", "bfloat16")


def _rel_err(got, want) -> float:
    g = np.asarray(got.double() if torch.is_tensor(got) else got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w)) / max(1.0, np.max(np.abs(w))))


def _tokens(cfg, seed=1, s=PROMPT):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (BATCH, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# the parameter tree
# ---------------------------------------------------------------------------

def test_convert_round_trip(params, bf16):
    """The reference's tree into the port (``lam`` fp32, the rest, the
    gates among them, bf16; the served copy holds the gates widened to
    fp32) and back (``to_jax_params``): every leaf equal, the group and
    the 2-block tail in their places."""
    cfg, tm = bf16.cfg, bf16.tm
    assert tm.blocks[0].mix.w_a.dtype == torch.bfloat16
    assert tm.served_blocks()[0].mix.w_a.dtype == torch.float32
    assert tm.blocks[0].mix.in_x.dtype == torch.bfloat16
    assert tm.blocks[4].mix.lam.dtype == torch.float32
    back = to_jax_params(cfg, tm.state_dict())
    want = jax.tree.map(np.asarray, bf16.jparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(want)):
        assert a.shape == b.shape and (a.dtype.itemsize
                                       == b.dtype.itemsize), path
    sd = tm.state_dict()
    again = from_jax_params(cfg, back)
    assert sorted(again) == sorted(sd)
    for key, t in sd.items():
        assert torch.equal(again[key].to(t.dtype), t), key
    np.testing.assert_array_equal(
        sd["blocks.3.mix.w_i"].float().numpy(),
        np.asarray(params["tail"]["t0"]["mix"]["w_i"], np.float32))
    np.testing.assert_array_equal(
        sd["blocks.1.mix.lam"].numpy(),
        params["groups"]["b1"]["mix"]["lam"][0])
    np.testing.assert_array_equal(
        sd["blocks.2.attn.wqkv"].float().numpy(),
        params["groups"]["b2"]["attn"]["wqkv"][0])


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

def _mix_case(params, compute, scale=1):
    """Layer 0's mixer on both sides at ``compute`` (its weights times
    ``scale``, ``lam`` as it is), a [2, 37, D] input and a one-token step
    after it."""
    _, cfg = _cfgs(compute)
    jcfg = jax_config(ARCH, smoke=True)
    cd = getattr(torch, compute)
    leaves = {k: v[0] if k == "lam" else _bf16_round(v[0] * scale)
              for k, v in params["groups"]["b0"]["mix"].items()}
    mix = rglru.RGLRU(cfg, cd, "cpu")
    for k, v in leaves.items():
        getattr(mix, k).data.copy_(torch.from_numpy(v))
    jp = {k: jnp.asarray(v) for k, v in leaves.items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    return cfg, cd, mix, jp, jcfg, leaves, x, xd


def _ref_mixer(jp, jcfg, compute, x, xd):
    """The reference's mixer at ``compute``: a prefill of x returning its
    state, then a decode step of xd from that state; outputs as fp32."""
    ctx = TPCtx(mesh=make_mesh(1, 1), sp=False,
                compute_dtype=jnp.dtype(compute))
    cd = jnp.dtype(compute)
    jp = {k: v if k == "lam" else v.astype(cd) for k, v in jp.items()}
    y, state = jax.jit(lambda p, x: jrglru.rglru_apply(
        p, x, jcfg, ctx, None, return_state=True))(jp, x.astype(cd))
    y2, state2 = jax.jit(lambda p, x, c: jrglru.rglru_apply(
        p, x, jcfg, ctx, c))(jp, xd.astype(cd), state)
    as32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return [as32(a) for a in (y, state["h"], state["conv"], y2, state2["h"],
                              state2["conv"])]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mixer_matches_reference(params, compute):
    """``rglru_apply`` against the reference's at prefill (the output and
    the state it returns) and at a decode step from that state.  At fp32
    every output within 1e-6 of its scale.  At bf16 each output's distance
    from the reference's fp32-compute run on the same (bf16) inputs within
    twice the reference's own (on this input the outputs are bitwise the
    reference's but for a rare rounding flip of a bf16 product), and the
    conv context within one bf16 rounding."""
    cfg, cd, mix, jp, jcfg, _, x, xd = _mix_case(params, compute)
    jx, jxd = (jnp.asarray(a).astype(jnp.dtype(compute)) for a in (x, xd))
    want = _ref_mixer(jp, jcfg, compute, jx, jxd)
    cache = rglru.rglru_cache(cfg, 2, cd, "cpu")
    y = rglru.rglru_apply(mix, torch.from_numpy(x).to(cd), cfg, cd, cache,
                          decode=False)
    got = [y, cache["h"].clone(), cache["conv"].clone()]
    y2 = rglru.rglru_apply(mix, torch.from_numpy(xd).to(cd), cfg, cd, cache,
                           decode=True)
    got += [y2, cache["h"], cache["conv"]]
    assert cache["h"].dtype == torch.float32 and cache["conv"].dtype == cd
    names = ("y", "h", "conv", "y step", "h step", "conv step")
    if compute == "float32":
        for name, g, w in zip(names, got, want):
            assert _rel_err(g, w) <= 1e-6, name
        return
    anchor = _ref_mixer(jp, jcfg, "float32", jx.astype(jnp.float32),
                        jxd.astype(jnp.float32))
    eps = float(torch.finfo(torch.bfloat16).eps)
    for name, g, w, a in zip(names, got, want, anchor):
        if "conv" in name:
            assert _rel_err(g, w) <= eps, name
        else:
            assert _rel_err(g, a) <= 2 * _rel_err(w, a), name


def _mixer_f64(leaves, x):
    """The mixer's formula in f64 (the conv, the gates, the sequential
    recurrence, the tanh gelu gate) on ``leaves`` and x [B, S, D]:
    returns (y, h after the last position)."""
    f = {k: np.asarray(v, np.float64) for k, v in leaves.items()}
    x = np.asarray(x, np.float64)
    xb, gb = x @ f["in_x"], x @ f["in_g"]
    cw, s = f["conv"].shape[0], x.shape[1]
    xp = np.concatenate([np.zeros((x.shape[0], cw - 1, xb.shape[2])), xb],
                        axis=1)
    xc = sum(xp[:, i:i + s] * f["conv"][i] for i in range(cw))
    r = 1 / (1 + np.exp(-(xc @ f["w_a"])))
    gi = 1 / (1 + np.exp(-(xc @ f["w_i"])))
    log_a = -8.0 * np.logaddexp(f["lam"], 0.0) * r
    b = np.sqrt(np.maximum(1 - np.exp(2 * log_a), 1e-12)) * gi * xc
    a = np.exp(log_a)
    h = np.zeros_like(b)
    for t in range(s):
        h[:, t] = a[:, t] * (h[:, t - 1] if t else 0.0) + b[:, t]
    gelu = 0.5 * gb * (1 + np.tanh(np.sqrt(2 / np.pi)
                                   * (gb + 0.044715 * gb ** 3)))
    return (h * gelu) @ f["out"], h[:, -1]


def test_saturated_mixer_within_the_references_error(params):
    """The mixer's weights tripled (as ``_vary`` leaves them not): the
    recurrence gate saturates (r -> 0, a -> 1), and ``sqrt(max(1 -
    exp(2 log_a), 1e-12))`` cancels, so that a one-ulp difference between
    two libraries' ``exp`` or ``sigmoid`` moves the gated input by a large
    part of itself.  At fp32 compute, the port's output and state lie
    within 4x the reference's own distance from the f64 formula (ROADMAP's
    consistency-budget rule)."""
    cfg, cd, mix, jp, jcfg, leaves, x, _ = _mix_case(params, "float32", 3)
    cache = rglru.rglru_cache(cfg, 2, cd, "cpu")
    y = rglru.rglru_apply(mix, torch.from_numpy(x), cfg, cd, cache,
                          decode=False)
    ry, rh, *_ = _ref_mixer(jp, jcfg, "float32", jnp.asarray(x),
                            jnp.asarray(x[:, :1]))
    ty, th = _mixer_f64(leaves, x)
    assert _rel_err(y, ty) <= 4 * _rel_err(ry, ty)
    assert _rel_err(cache["h"], th) <= 4 * _rel_err(rh, th)


def test_conv_state_carried(params):
    """A prefill of S positions then one decode step equals a prefill of
    S + 1 at its last position: the conv's left context and the state
    ``h`` are carried (fp32 compute, within 1e-6 of the scale: the step's
    FMA against the scan's combine, and the new token's projection, one
    row against the prefill's 38, sums in another order)."""
    cfg, cd, mix, *_, x, xd = _mix_case(params, "float32")
    xt = torch.from_numpy(np.concatenate([x, xd], axis=1))
    c1 = rglru.rglru_cache(cfg, 2, cd, "cpu")
    rglru.rglru_apply(mix, xt[:, :-1], cfg, cd, c1, decode=False)
    y1 = rglru.rglru_apply(mix, xt[:, -1:], cfg, cd, c1, decode=True)
    c2 = rglru.rglru_cache(cfg, 2, cd, "cpu")
    y2 = rglru.rglru_apply(mix, xt, cfg, cd, c2, decode=False)
    assert _rel_err(c1["conv"], c2["conv"].numpy()) <= 1e-6
    assert _rel_err(y1[:, 0], y2[:, -1].numpy()) <= 1e-6
    assert _rel_err(c1["h"], c2["h"].numpy()) <= 1e-6


@settings(max_examples=40, deadline=None)
@given(s=st.integers(1, 300), w=st.integers(1, 8), seed=st.integers(0, 99))
def test_scan_matches_f64_recurrence(s, w, seed):
    """``linear_scan`` (the reference's odd/even recursion) against the
    sequential recurrence h_t = a_t h_{t-1} + b_t in f64, decays in (0, 1]
    as the gates make them: within 64 fp32 ulps of each row's largest
    state."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, (2, s, w)).astype(np.float32)
    b = rng.standard_normal((2, s, w)).astype(np.float32)
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    want = np.zeros((2, s, w))
    h = np.zeros((2, w))
    for t in range(s):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        want[:, t] = h
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1.0)
    err = np.abs(got.double().numpy() - want) / scale
    assert err.max() <= 64 * np.finfo(np.float32).eps


def test_scan_is_the_references_bitwise(params):
    """At fp32 the scan is bitwise ``lax.associative_scan`` of the
    reference's combine, at odd and even lengths."""
    def combine(l, r):
        return l[0] * r[0], l[1] * r[0] + r[1]
    scan = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1)[1])
    rng = np.random.default_rng(5)
    for s in (2, 7, 64, 129):
        a = rng.uniform(0.5, 1.0, (2, s, 16)).astype(np.float32)
        b = rng.standard_normal((2, s, 16)).astype(np.float32)
        np.testing.assert_array_equal(
            rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b)),
            np.asarray(scan(a, b)))


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_reference(fp32, bf16):
    """The prefill of 12 tokens and 7 decode steps fed the same tokens: at
    fp32 compute every step's logits within 1e-5 of their scale; at bf16
    compute their distance from the reference's fp32-compute run within
    4x the reference's own (ROADMAP's consistency-budget rule, the fp32
    run for the f64 oracle).  Two bf16 runs carry independent roundings of
    the prefill's states into every step: from the same cache the port's
    decode step lies as close to the fp32 run as the reference's, and the
    trajectories here part by up to 2.2x the reference's distance."""
    toks = _tokens(fp32.cfg)
    picks = np.random.default_rng(4).integers(
        0, fp32.cfg.vocab, (BATCH, STEPS)).astype(np.int32)
    j32, t32 = fp32.teacher_forced(toks, picks)
    errs = [_rel_err(t, j) for t, j in zip(t32, j32)]
    assert max(errs) <= 1e-5, errs
    j16, t16 = bf16.teacher_forced(toks, picks)
    errs = [_rel_err(t, a) for t, a in zip(t16, j32)]
    noise = [_rel_err(j, a) for j, a in zip(j16, j32)]
    assert 0 < max(errs) <= 4 * max(noise), (errs, noise)


def test_decode_matches_prefill_within_the_port(bf16):
    """The reference's own check, in the port at bf16: a decode step at
    position S after a prefill of S tokens against a prefill of the S + 1
    tokens (the scan against the recurrence, the ring against K4 'local';
    the reference shows 0.019 of a 4.7 logit scale on this config); a
    changed last token moves the logits by more than 4x that."""
    tm = bf16.tm
    toks = torch.from_numpy(_tokens(bf16.cfg, s=24))
    _, cache = tm.prefill(toks[:, :-1], 24)
    got, _ = tm.decode_step(cache, toks[:, -1:], 23)
    want, _ = tm.prefill(toks)
    other = toks.clone()
    other[:, -1] = (other[:, -1] + 1) % bf16.cfg.vocab
    off, _ = tm.prefill(other)
    err = _rel_err(got, want.numpy())
    assert err <= 0.01, err
    assert _rel_err(off, want.numpy()) > 4 * err


def _generate_both(pair, int8):
    toks = _tokens(pair.cfg, seed=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JServeEngine(pair.jm, pair.jparams,
                            JServeConfig(max_new_tokens=STEPS, int8=int8))
    assert not jeng._paged_ok
    want = jeng.generate_with_status({"tokens": jnp.asarray(toks)})
    teng = ServeEngine(pair.tm, ServeConfig(max_new_tokens=STEPS, int8=int8))
    got = teng.generate_with_status({"tokens": torch.from_numpy(toks)})
    assert teng._sched is None and not teng._shim_cache   # no scheduler
    assert list(got.status) == list(want.status) == [STATUS_OK] * BATCH
    assert got.tokens.shape == (BATCH, STEPS)
    assert len(set(got.tokens.reshape(-1).tolist())) > 3
    return got.tokens, np.asarray(want.tokens)


@pytest.mark.parametrize("pair,int8", [("bf16", False), ("fp32", True)],
                         ids=["bf16", "int8-fp32-compute"])
def test_generate_with_status_falls_through_and_matches_reference(
        request, pair, int8):
    """``generate_with_status`` on the smoke config, bf16 weights at bf16
    compute and int8 weights at fp32 compute: the engine falls through to
    the fixed loop (the reference's ``_paged_ok`` is false too), every
    lane ok, and the greedy tokens equal the reference ``ServeEngine``'s
    on the same batch."""
    got, want = _generate_both(request.getfixturevalue(pair), int8)
    np.testing.assert_array_equal(got, want)


def test_int8_leaves_the_mixer_unquantized(fp32):
    """The int8 copy quantizes the local layers' ``wqkv``/``wo`` and every
    MLP, and shares each RG-LRU mixer and every norm scale (the
    reference's pass touches ``/attn/`` and ``/ffn/`` only); the
    releasing build quantizes in place the same leaves."""
    tm = fp32.tm
    q = tm.quantize_params_for_serving()
    for i, (blk, qb) in enumerate(zip(tm.blocks, q.blocks)):
        assert qb.ln1 is blk.ln1 and qb.ln2 is blk.ln2
        assert all(isinstance(getattr(qb.ffn, n), QuantizedWeight)
                   for n in ("gate", "up", "down"))
        if fp32.cfg.kind(i) == "rglru":
            assert qb.mix is blk.mix and not hasattr(qb, "attn")
        else:
            assert isinstance(qb.attn.wqkv, QuantizedWeight)
            assert isinstance(qb.attn.wo, QuantizedWeight)
    jq = fp32.jm.quantize_params_for_serving(fp32.jparams)
    for name, leaf in jq["groups"]["b0"]["mix"].items():
        assert leaf is fp32.jparams["groups"]["b0"]["mix"][name], name


def test_fp32_fallback_matches_reference(fp32):
    """The int8 fixed loop's saturation probe at a threshold that degrades
    every lane at its first decode step, and the fp32 fallback: each later
    step runs the float model beside the int8 one, and the lanes pick from
    the float logits.  Statuses, fault steps and tokens are the
    reference's (fp32 compute): the float steps advance no RG-LRU state
    the int8 steps read."""
    toks = _tokens(fp32.cfg, seed=2)
    kw = dict(max_new_tokens=STEPS, int8=True, saturation_threshold=1e-6,
              fp32_fallback=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = JServeEngine(fp32.jm, fp32.jparams, JServeConfig(**kw)
                            ).generate_with_status_fixed(
            {"tokens": jnp.asarray(toks)})
    got = ServeEngine(fp32.tm, ServeConfig(**kw)).generate_with_status_fixed(
        {"tokens": torch.from_numpy(toks)})
    assert got.status == list(want.status) == ["degraded_fp32"] * BATCH
    np.testing.assert_array_equal(got.fault_step, want.fault_step)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def test_fp32_fallback_step_leaves_the_state(fp32):
    """The fixed loop's float step for a degraded lane runs on a fork of
    the cache: the RG-LRU states it advances are the fork's, and the int8
    step after it starts from the state the reference's does (the
    reference discards the float step's cache)."""
    tm = fp32.tm
    toks = torch.from_numpy(_tokens(fp32.cfg))
    _, cache = tm.prefill(toks, PROMPT + 2)
    h0 = cache[0]["h"].clone()
    fork = cache.fork()
    tm.decode_step(fork, toks[:, :1], PROMPT)
    assert torch.equal(cache[0]["h"], h0)
    assert not torch.equal(fork[0]["h"], h0)
    assert fork[2]["k"] is cache[2]["k"]       # the ring buffers shared


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------

def test_not_pageable_refusals(fp32):
    """Not pageable, as the reference's ``_paged_ok``: ``new_paged_cache``
    raises (the reference's ``paged_cache_defs`` too), ``submit`` raises,
    a paged forward raises, and a block kind the port does not serve is
    refused with its name."""
    tm = fp32.tm
    assert not tm.supports_paged_serving
    assert not fp32.jm.supports_paged_serving
    with pytest.raises(ValueError, match="paged"):
        tm.new_paged_cache(16, 8)
    with pytest.raises(ValueError, match="paged"):
        fp32.jm.paged_cache_defs(16, 8)
    eng = ServeEngine(tm, ServeConfig(max_new_tokens=2))
    with pytest.raises(NotImplementedError):
        eng.submit(Request(id=0, tokens=np.arange(4)))
    with pytest.raises(NotImplementedError, match="pages"):
        tm.forward(torch.zeros((1, 1), dtype=torch.long), cache=[{}] * 5,
                   positions=torch.zeros((1, 1), dtype=torch.int32),
                   page_table=torch.zeros((1, 1), dtype=torch.int32))
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              block_pattern=("rglru", "mamba"))
    with pytest.raises(NotImplementedError, match="'mamba'"):
        Model(cfg, device="meta")


# ---------------------------------------------------------------------------
# what the launchers are handed
# ---------------------------------------------------------------------------

@pytest.fixture
def intercepted(monkeypatch):
    """Run the wrappers on CPU tensors up to the launch: the device checks
    pass, each launch is recorded, the card has 132 SMs."""
    calls = []
    monkeypatch.setattr(_cuda, "check", lambda *a, **kw: None)
    monkeypatch.setattr(_cuda, "launch",
                        lambda lib, fn, *args: calls.append((lib, fn, args)))
    monkeypatch.setattr(tmm, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(tfa, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(tmm, "_SPLIT_SCRATCH", {})
    before = dict(_cuda.LAUNCHES)
    tmm._device_plan.cache_clear()
    tmm._device_k2_plan.cache_clear()
    _cuda.reset_launches()
    for key in [k for k in _cuda.LAUNCHES if ":" in k]:
        del _cuda.LAUNCHES[key]
    yield calls
    _cuda.LAUNCHES.clear()
    _cuda.LAUNCHES.update(before)


def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_k4_launch_at_g16_hd256(intercepted):
    """The full model's local prefill shape (B 2, S 4160, 16 q heads over
    one kv head of 256, window 2048) reaches K4's launcher with the local
    mask code, the window and hd 256's scale, counted under its
    ``local+hd256`` variant."""
    hd = 256
    q, k = _bf(2, 4160, 16, hd), _bf(2, 4160, 1, hd)
    tfa.flash_attention_cuda(q, k, k, kind="local", window=2048)
    ((lib, fn, args),) = intercepted
    assert (lib, fn) == ("flash_attention", "k4_flash_prefill")
    assert len(args) + 1 == len(_cuda.SIGNATURES[lib][fn])
    assert args[4:] == (2, 4160, 4160, 16, 1, hd, hd ** -0.5,
                        tfa.MASK_CODES["local"], 2048, 0, 0.0)
    assert _cuda.LAUNCHES["flash_attention:local+hd256"] == 1


@pytest.fixture
def forced_wrappers(intercepted, monkeypatch):
    """Every kernel entry point of ``kernels.ops`` routed to its CUDA
    wrapper on CPU tensors, up to the launch: each wrapper's own checks
    run, and ``_cuda.check`` holds dtype, shape, contiguity and 16-byte
    alignment; a launch computes nothing."""
    import types

    def check(t, what, dtype, shape=None, align=16):
        assert t.dtype == dtype, (what, t.dtype)
        assert shape is None or tuple(t.shape) == tuple(shape), (what,
                                                                 t.shape)
        assert t.is_contiguous(), f"{what} must be contiguous"
        assert t.data_ptr() % align == 0, f"{what} must be aligned"
    monkeypatch.setattr(_cuda, "check", check)
    routed = types.SimpleNamespace(**vars(ref))
    routed.matmul_fused_ref = tmm.matmul_cuda
    routed.int8_matmul_ref = tmm.int8_matmul_cuda
    routed.quantize_rowwise_ref = ops.quantize_rowwise_cuda
    routed.flash_attention_ref = tfa.flash_attention_cuda
    monkeypatch.setattr(ops, "ref", routed)
    monkeypatch.setattr(ops, "rms_normalize", lambda x, scale, eps: (
        tmm.rmsnorm_cuda(x.reshape(-1, x.shape[-1]), scale, eps)
        .reshape(x.shape)))
    return intercepted


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_served_path_hands_the_kernels_valid_tensors(forced_wrappers, int8):
    """The smoke model at bf16 weights through a prefill of 4 x 20 tokens
    (past the window of 16: K4 'local', once for its one local layer) and
    one decode step, every kernel call through its wrapper.  One decode
    iteration's launches are those ``chip_smoke.py``'s
    ``decode_launches`` holds on the card: the row-norm kernel L + 1 times
    (the entry norm and each ``ln2``), the down GEMM's norm tail L times,
    the GEMMs three a layer (the MLP) and two a local layer (qkv and o;
    the mixers' projections are library products and the local layer's
    ring decodes in plain torch: no K5), and under int8 one K3 launch per
    int8 GEMM input (the MLP's, qkv's and o's) and the up GEMM's quantize
    in its store phase."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              param_dtype="bfloat16")
    model = Model(cfg, device="cpu").init_weights(0)
    if int8:
        model = model.quantize_params_for_serving()
    n, n_local = cfg.n_layers, sum(cfg.kind(i) == "local"
                                   for i in range(cfg.n_layers))
    toks = torch.zeros((4, 20), dtype=torch.long)
    logits, cache = model.prefill(toks, 24)
    assert logits.shape == (4, cfg.padded_vocab())
    assert _cuda.LAUNCHES["flash_attention"] == n_local == 1
    assert _cuda.LAUNCHES["flash_attention:local"] == 1
    _cuda.reset_launches()
    for key in [k for k in _cuda.LAUNCHES if ":" in k]:
        del _cuda.LAUNCHES[key]
    model.decode_step(cache, torch.zeros((4, 1), dtype=torch.long), 20)
    gemm = "int8_matmul" if int8 else "matmul"
    want = {"rmsnorm": n + 1, f"{gemm}:norm": n, gemm: 3 * n + 2 * n_local,
            "int8_matmul:quantize": n if int8 else 0, "int8_quantize": 0,
            "quantize": n + 2 * n_local if int8 else 0,
            "flash_attention": 0, "flash_decode": 0}
    assert {k: _cuda.LAUNCHES.get(k, 0) for k in want} == want


# ---------------------------------------------------------------------------
# checkpoints, the launcher and the int8 build's peak
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip(bf16, tmp_path):
    """The port's bf16 model saved in the reference's format (the gates
    back at bf16, ``lam`` fp32; bf16 leaves as 2-byte words, F7) and
    served by ``ServeEngine.from_checkpoint``: the leaves' dtypes are the
    reference's tree's, and the restored model's logits bitwise the
    saved model's."""
    cfg, tm = bf16.cfg, bf16.tm
    CheckpointManager(str(tmp_path)).save(
        2, to_jax_params(cfg, tm.state_dict()), blocking=True)
    text = (tmp_path / "step_00000002" / "manifest.json").read_text()
    assert "bfloat16" in text and "float32" in text
    eng = ServeEngine.from_checkpoint(Model(cfg, device="cpu"),
                                      str(tmp_path))
    toks = torch.from_numpy(_tokens(cfg))
    assert torch.equal(eng.model.prefill(toks)[0], tm.prefill(toks)[0])
    step, tree = CheckpointManager(str(tmp_path)).restore(2, cfg=cfg)
    mix = tree["groups"]["b0"]["mix"]
    assert str(mix["w_a"].dtype) != "float32" and mix["lam"].dtype == np.float32


def test_int8_peak_is_the_largest_real_block():
    """``int8_peak_bytes`` at full width: the float model plus the largest
    block's int8 copy (a local-attention block: its wqkv and wo beside the
    MLP), or with ``fp32_fallback`` the sum of every block's copy, each
    block's copy counted from its own tensors (an RG-LRU block's is its
    MLP alone)."""
    cfg = get_config(ARCH)
    model = Model(cfg, device="meta")
    copies = []
    for blk in model.blocks:
        q = type(blk).quantized(blk, cfg, model.compute_dtype)
        copies.append(sum(t.nbytes for m in q.modules()
                          if isinstance(m, QuantizedWeight)
                          for t in m.buffers()))
    float_bytes = sum(t.nbytes for t in model.state_dict().values())
    assert max(copies) == copies[2] > copies[0] == copies[1]
    assert tserve.int8_peak_bytes(cfg) == float_bytes + copies[2]
    assert tserve.int8_peak_bytes(cfg, True) == float_bytes + sum(copies)
    card = torch.device("cuda")
    assert tserve.int8_fits(cfg, card, total=80e9)
    assert tserve.int8_fits(cfg, card, True, total=80e9)


@pytest.mark.parametrize("extra", [[], ["--int8"]], ids=["bf16", "int8"])
def test_launcher_serves_the_smoke_config(capsys, extra):
    """``launch.serve --arch recurrentgemma-9b --smoke --device cpu``: a
    prompt of 20 tokens, past the window, bf16 and int8, every lane ok."""
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "20", "--max-new", "3", *extra])
    out = capsys.readouterr().out
    assert "recurrentgemma-9b-smoke" in out and "lane 1: ok" in out


def test_launcher_refuses_requests():
    with pytest.raises(SystemExit, match="recurrent state"):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--requests", "2"])
