"""xlstm-350m's path through the port against the JAX reference, on the
CPU: the config copy (ROADMAP F9 pinned), the parameter tree both ways,
the mLSTM and sLSTM mixers (``models/xlstm.py``) against the reference's
``mlstm_apply``/``slstm_apply``, the chunkwise form and the step against
an f64 recurrence, the causal conv inside the mLSTM, the model's prefill
and decode step, ``generate_with_status``'s fall-through to the fixed
loop (bf16 and int8), the int8 copy sharing every leaf, the refusals
(F10's prompt lengths, pages, ``--requests``), what the served path
hands the kernels (intercepted at ``kernels._cuda.launch``: the row-norm
kernel runs only on the card, where ``chip_smoke.py`` holds it to its
plain version), a checkpoint round trip and the launcher.

Tolerances, each with its reason:

* Both sides hold the same parameters, every weight rounded to a
  bf16-representable value (both hold fp32 masters; the reference casts
  the projections at use, the port's served copy once: the same
  numbers).
* The mixers at fp32 compute, each output and state within a bound of
  its scale: the sLSTM 1e-6 (its fp32 products, XLA's dot on the CPU
  against torch's, sum in other orders; 3.2e-7 measured), the mLSTM 5e-5
  (1.3e-5 measured on the tripled weights): the chunk's cumulative sums
  of the log forget gates also sum in another order (they reach tens,
  where an fp32 ulp is 2-4e-6), and the intra-chunk log decays are their
  differences, exponentiated.  At bf16 compute each output's distance
  from the reference's fp32-compute run within twice the reference's
  own, the conv context equal (the outputs are the reference's bits but
  for rare flips of a bf16 rounding).
* The chunkwise form and the step against the recurrence in f64, with
  gate scales that move the stabilizer and switch the normalizer's branch
  (``max(|n.q|, exp(-m))``), each row's error over the rounding an fp32
  evaluation of that row cannot avoid: the port's worst row within 4x the
  reference's own on the same inputs (ROADMAP's consistency-budget rule).
* The causal conv and its silu inside the mLSTM at bf16: bitwise.
* The model's logits at fp32 compute within 5e-5 of their scale (the
  mLSTM's bound, 1.4e-5 measured over 8 layers and 7 steps); at bf16
  compute their distance from the reference's fp32-compute run within 4x
  the reference's own (ROADMAP's consistency-budget rule): the recurrent
  states carry each run's prefill roundings into every step.
* Greedy tokens through the engines are equal at fp32 compute; at bf16
  compute up to each lane's first difference, which must fall at a near
  tie (the near-tie rule of ``test_torch_paligemma.py``), with at least
  half the steps before it; the int8 copy (which quantizes nothing)
  gives the float model's tokens bit for bit.
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
from repro.models import xlstm as jxlstm
from repro.models.layers import TPCtx
from repro.models.lm import Model as JaxModel
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.kernels import _cuda
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.quantize import QuantizedWeight
from repro_torch.launch import serve as tserve
from repro_torch.models import rglru, xlstm
from repro_torch.models.lm import Model
from repro_torch.robust.guards import STATUS_OK
from repro_torch.serve.api import Request
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

ARCH = "xlstm-350m"
PROMPT, STEPS, BATCH = 12, 8, 2


@pytest.fixture(autouse=True)
def _xla_mode():
    assert jops.kernel_mode() == "xla", "the reference must run its CPU path"


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_is_the_reference_copy(smoke):
    """Every field of the port's ``ArchConfig`` equals the reference's, and
    so does the parameter count."""
    got, want = get_config(ARCH, smoke=smoke), jax_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(ArchConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.param_count() == want.param_count()
    assert ARCH in ARCH_IDS


@pytest.mark.parametrize("smoke,counted,held", [
    (False, 265_805_824, 467_347_624), (True, 307_072, 570_140)],
    ids=["full", "smoke"])
def test_param_count_is_the_references_f9(smoke, counted, held):
    """ROADMAP F9: the reference's ``param_count`` counts an mLSTM's three
    [w, w] q/k/v (w = 2d) as ``3 w^2 / 4``, its gate maps, biases and norm
    as ``4 w``, and leaves out an sLSTM's ``out`` [d, d]; the model its
    init builds holds more.  The port copies the reckoning, holds the
    reference's parameters one for one (``n_params``), and states bytes
    from its tensors."""
    cfg = get_config(ARCH, smoke=smoke)
    model = Model(cfg, device="meta")
    assert cfg.param_count() == counted
    assert sum(p.numel() for p in model.parameters()) == held
    assert JaxModel(jax_config(ARCH, smoke=smoke),
                    make_mesh(1, 1)).n_params() == held
    d, nh = cfg.d_model, cfg.n_heads
    w = 2 * d
    kinds = [cfg.kind(i) for i in range(cfg.n_layers)]
    missed = (kinds.count("mlstm") * (3 * w * w - 3 * w * w // 4
                                      + 2 * w * nh + 2 * nh + w - 4 * w)
              + kinds.count("slstm") * d * d)
    assert held - counted == missed


def test_full_width_bytes():
    """24 layers at full width: 21 mLSTM blocks (hd 2d / 4 = 512) and 3
    sLSTM blocks, no FFN, no ``ln2``.  Every weight at fp32, the
    reference's float32 ``param_dtype`` (its training master: 75.6 MB an
    mLSTM block, the served copy casts the projections to bf16), the fp32
    embedding: 1.869 GB held, 88.5 MB of state a lane (the mLSTM's ``C``
    4.19 MB a layer)."""
    cfg = get_config(ARCH)
    model = Model(cfg, device="meta")
    kinds = [cfg.kind(i) for i in range(cfg.n_layers)]
    assert (kinds.count("mlstm"), kinds.count("slstm")) == (21, 3)
    assert kinds[7::8] == ["slstm"] * 3 and cfg.tail_blocks == ()
    m, s = model.blocks[0], model.blocks[7]
    assert not hasattr(m, "ln2") and not hasattr(m, "ffn")
    assert m.mix.wq.dtype == m.mix.up_x.dtype == torch.float32
    assert m.mix.w_i.dtype == m.mix.norm.dtype == torch.float32
    assert s.mix.w_in.dtype == s.mix.r.dtype == torch.float32
    assert s.mix.out.dtype == torch.float32
    assert model.embed.dtype == torch.float32

    def nbytes(mod):
        return sum(p.nbytes for p in mod.parameters())
    assert nbytes(m) == 75_608_096 and nbytes(s) == 25_190_400
    assert model.embed.nbytes == 206_045_184
    assert nbytes(model) == 1_869_390_496
    state = model.new_cache(1, 1)
    per_lane = sum(t.nbytes for layer in state for t in layer.values())
    assert state[0]["C"].shape == (1, 4, 512, 512)
    assert per_lane == 88_559_952


# ---------------------------------------------------------------------------
# the parameters, shared by the tests below
# ---------------------------------------------------------------------------

def _bf16_round(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _vary(params, rng, tripled):
    """Random norm scales (the blocks' ``ln1``, the mixers' ``norm``,
    ``final_norm``), the weights named in ``tripled`` tripled (all of them
    for None), every weight rounded to a bf16 value; the gate biases and
    the sLSTM's recurrent map ``r`` as the reference's init made them."""
    for name, leaf in list(params.items()):
        if isinstance(leaf, dict):
            _vary(leaf, rng, tripled)
        elif name.startswith("ln") or name in ("norm", "final_norm"):
            params[name] = (0.5 * rng.standard_normal(leaf.shape)
                            ).astype(np.float32)
        elif name not in ("b_i", "b_f", "bias"):
            scale = 3 if name != "r" and (tripled is None
                                          or name in tripled) else 1
            params[name] = _bf16_round(np.asarray(leaf, np.float32) * scale)


def _init_tree(tripled):
    """The reference's init of the smoke config (one group of seven mLSTM
    blocks and one sLSTM block), varied."""
    jm = JaxModel(jax_config(ARCH, smoke=True), make_mesh(1, 1))
    tree = jax.tree.map(np.asarray, jm.init_params(0))
    _vary(tree, np.random.default_rng(7), tripled)
    return tree


@pytest.fixture(scope="module")
def params():
    """Every weight tripled (the rule of ``test_torch_int8_models.py``):
    the mixers' tests."""
    return _init_tree(None)


@pytest.fixture(scope="module")
def model_params():
    """The model's tests: the mixers' output projections (``down``,
    ``out``) tripled, so that greedy tokens vary from step to step, and
    their input and gate maps at their init scales.  Tripled, the gate
    maps make the model chaotic: two fp32 runs that sum in other orders
    (the reference's and the port's) then part by a hundredth of the logit
    scale within eight decode steps."""
    return _init_tree(("down", "out"))


class Pair:
    """The reference (one jit of prefill and one of decode) and the port
    on the same parameters at one compute dtype (the config's float32
    ``param_dtype``: the reference casts its projections at use, the
    port's served copy holds them at the compute dtype)."""

    def __init__(self, tree, compute):
        over = dict(compute_dtype=compute)
        jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **over)
        self.cfg = dataclasses.replace(get_config(ARCH, smoke=True), **over)
        self.jm = JaxModel(jcfg, make_mesh(1, 1))
        self.jparams = jax.tree.map(jnp.asarray, tree)
        self.tm = Model(self.cfg, device="cpu")
        self.tm.load_state_dict(from_jax_params(self.cfg, tree))
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
def fp32(model_params):
    return Pair(model_params, "float32")


@pytest.fixture(scope="module")
def bf16(model_params):
    """bf16 compute, as on the card."""
    return Pair(model_params, "bfloat16")


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

def test_convert_round_trip(model_params, bf16):
    """The reference's tree into the port (every leaf at fp32, the
    reference's float32 masters; the served copy holds the projections at
    bf16) and back (``to_jax_params``): the same structure, three groups of
    the pattern with no ``ln2``, no ``ffn`` and no tail, every value
    equal."""
    cfg, tm = bf16.cfg, bf16.tm
    assert tm.blocks[0].mix.wq.dtype == torch.float32
    assert tm.served_blocks()[0].mix.wq.dtype == torch.bfloat16
    assert tm.blocks[7].mix.w_in.dtype == torch.float32
    back = to_jax_params(cfg, tm.state_dict())
    params = model_params
    assert jax.tree.structure(back) == jax.tree.structure(params)
    assert set(back["groups"]["b0"]) == {"ln1", "mix"} and back["tail"] == {}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(params)):
        got = torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
            torch.bfloat16).float().numpy() if a.dtype.itemsize == 2 else a
        np.testing.assert_array_equal(got, b, err_msg=str(path))
    sd = tm.state_dict()
    again = from_jax_params(cfg, back)
    assert sorted(again) == sorted(sd)
    for key, t in sd.items():
        assert torch.equal(again[key].to(t.dtype), t), key
    np.testing.assert_array_equal(sd["blocks.7.mix.r"].numpy(),
                                  params["groups"]["b7"]["mix"]["r"][0])


def test_init_follows_the_reference_schema():
    """``init_weights``: ``b_f`` is ``linspace(3, 6, n_heads)``, ``b_i``,
    the biases and the norms zero, ``r`` N(0, 0.05^2) whatever its fan-in,
    the conv's fan-in its width, ``w_in`` (widened at use) held at
    ``param_dtype`` (here bf16), as the reference holds it."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              param_dtype="bfloat16")
    model = Model(cfg, device="cpu").init_weights(0)
    m, s = model.blocks[0].mix, model.blocks[7].mix
    np.testing.assert_array_equal(m.b_f.numpy(), np.linspace(3, 6, 2))
    for t in (m.b_i, m.norm, s.bias, s.norm, model.blocks[3].ln1):
        assert not t.any()
    assert abs(float(s.r.std()) - 0.05) < 0.005
    assert abs(float(m.conv.float().std()) - 0.5) < 0.05
    assert s.w_in.dtype == torch.bfloat16
    assert s.r.dtype == torch.float32


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

def _mixer_case(params, kind, compute):
    """Layer 0's mLSTM or layer 7's sLSTM on both sides at ``compute``."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype=compute)
    cd = getattr(torch, compute)
    leaves = {k: v[0] for k, v in
              params["groups"]["b0" if kind == "mlstm" else "b7"]["mix"]
              .items()}
    mix = (xlstm.MLSTM if kind == "mlstm" else xlstm.SLSTM)(cfg, cd, "cpu")
    for k, v in leaves.items():
        getattr(mix, k).data.copy_(torch.from_numpy(np.array(v)))
    return cfg, cd, mix, {k: jnp.asarray(v) for k, v in leaves.items()}


def _ref_mixer(jp, kind, compute, x, xd):
    """The reference's mixer at ``compute``: a prefill of x returning its
    state, then a decode step of xd from it; every output as fp32."""
    jcfg = jax_config(ARCH, smoke=True)
    ctx = TPCtx(mesh=make_mesh(1, 1), sp=False,
                compute_dtype=jnp.dtype(compute))
    fn = jxlstm.mlstm_apply if kind == "mlstm" else jxlstm.slstm_apply
    cd = jnp.dtype(compute)
    y, state = jax.jit(lambda p, x: fn(p, x, jcfg, ctx, None,
                                       return_state=True))(
        jp, jnp.asarray(x).astype(cd))
    y2, state2 = jax.jit(lambda p, x, c: fn(p, x, jcfg, ctx, c))(
        jp, jnp.asarray(xd).astype(cd), state)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return ([f32(y)] + [f32(state[k]) for k in sorted(state)]
            + [f32(y2)] + [f32(state2[k]) for k in sorted(state2)])


def _port_mixer(cfg, cd, mix, kind, x, xd):
    apply = xlstm.mlstm_apply if kind == "mlstm" else xlstm.slstm_apply
    cache = (xlstm.mlstm_cache(cfg, 2, cd, "cpu") if kind == "mlstm"
             else xlstm.slstm_cache(cfg, 2, "cpu"))
    y = apply(mix, torch.from_numpy(x).to(cd), cfg, cd, cache, False)
    out = [y] + [cache[k].clone() for k in sorted(cache)]
    y2 = apply(mix, torch.from_numpy(xd).to(cd), cfg, cd, cache, True)
    return out + [y2] + [cache[k] for k in sorted(cache)], sorted(cache)


@pytest.mark.parametrize("s", [12, 64, 192])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mixer_matches_reference(params, compute, kind, s):
    """``mlstm_apply``/``slstm_apply`` against the reference's at prefill
    (S = 12, one chunk shorter than 64; 64; 192, three chunks: the carry)
    with the state it returns, and a decode step from that state.  At fp32
    every output and state within 5e-5 (mLSTM) or 1e-6 (sLSTM) of its
    scale.  At bf16 each output's and state's distance from the
    reference's fp32-compute run on the same inputs within twice the
    reference's own (plus 1e-6 for a state both runs keep at fp32), the
    conv context equal (tolerances in the module docstring)."""
    cfg, cd, mix, jp = _mixer_case(params, kind, compute)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    got, keys = _port_mixer(cfg, cd, mix, kind, x, xd)
    names = ["y", *keys, "y step", *(k + " step" for k in keys)]
    if compute == "float32":
        want = _ref_mixer(jp, kind, compute, x, xd)
        tol = 5e-5 if kind == "mlstm" else 1e-6
        for name, g, w in zip(names, got, want):
            assert _rel_err(g, w) <= tol, name
        return
    jx, jxd = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                          .astype(jnp.float32)) for a in (x, xd))
    want = _ref_mixer(jp, kind, compute, jx, jxd)
    anchor = _ref_mixer(jp, kind, "float32", jx, jxd)
    for name, g, w, a in zip(names, got, want, anchor):
        if name.startswith("conv"):
            np.testing.assert_array_equal(g.float().numpy(), w)
        else:
            assert _rel_err(g, a) <= 2 * _rel_err(w, a) + 1e-6, name


def test_causal_conv_is_bitwise_inside_the_mlstm(params):
    """At bf16 the mLSTM's conv branch, ``silu(causal_conv(x @ up_x))``
    rounded to bf16 (``rglru.causal_conv``: the last add at fp32 for the
    silu that widens it), is the reference's bit for bit, at prefill and
    at a decode step from the carried context."""
    cfg, cd, mix, jp = _mixer_case(params, "mlstm", "bfloat16")
    bf = jnp.bfloat16

    @jax.jit
    def ref_branch(x, state):
        xb = jnp.einsum("bsd,dw->bsw", x, jp["up_x"].astype(bf))
        xc, new = jrglru._causal_conv(xb, jp["conv"].astype(bf), state)
        return jax.nn.silu(xc.astype(jnp.float32)).astype(bf), new

    def port_branch(x, state):
        xb = torch.matmul(x, mix.up_x)
        xc, new = rglru.causal_conv(xb, mix.conv, state)
        return torch.nn.functional.silu(xc.float()).to(cd), new

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    state0 = jnp.zeros((2, cfg.conv_width - 1, 2 * cfg.d_model), bf)
    jy, jst = ref_branch(jnp.asarray(x, bf), state0)
    ty, tst = port_branch(torch.from_numpy(x).to(cd), None)
    jy2, _ = ref_branch(jnp.asarray(xd, bf), jst)
    ty2, _ = port_branch(torch.from_numpy(xd).to(cd), tst)
    for g, w in ((ty, jy), (ty2, jy2)):
        np.testing.assert_array_equal(
            g.float().numpy(), np.asarray(jnp.asarray(w, jnp.float32)))


def _recurrence_f64(q, k, v, logf, logi):
    """The mLSTM recurrence in f64, token by token, from C = n = 0, m = 0:
    h [B, S, H, hd], which branch of the normalizer each (b, t, h) took
    (True: |n.q|), and each row's rounding scale [B, S, H]: the size of
    the error an fp32 evaluation cannot avoid, ``|q|.|C| / den + |num|
    |q|.|n| / den^2`` (the same sums over the terms' magnitudes; the
    second term only where den is |n.q|), which a cancelling |n.q| or
    ``C^T q`` makes large."""
    q, k, v, logf, logi = (np.asarray(a, np.float64)
                           for a in (q, k, v, logf, logi))
    b, s, nh, hd = q.shape
    k = k * hd ** -0.5
    C, n = np.zeros((b, nh, hd, hd)), np.zeros((b, nh, hd))
    C_abs, n_abs = np.zeros_like(C), np.zeros_like(n)
    m = np.zeros((b, nh))
    h = np.zeros((b, s, nh, hd))
    branch = np.zeros((b, s, nh), bool)
    scale = np.zeros((b, s, nh))
    for t in range(s):
        m_new = np.maximum(logf[:, t] + m, logi[:, t])
        fw = np.exp(logf[:, t] + m - m_new)[..., None]
        iw = np.exp(logi[:, t] - m_new)[..., None]
        kv = k[:, t, :, :, None] * v[:, t, :, None]
        C = fw[..., None] * C + iw[..., None] * kv
        C_abs = fw[..., None] * C_abs + iw[..., None] * np.abs(kv)
        n = fw * n + iw * k[:, t]
        n_abs = fw * n_abs + iw * np.abs(k[:, t])
        qt = q[:, t]
        qn = np.abs((qt * n).sum(-1))
        floor = np.exp(-m_new)
        branch[:, t] = qn > floor
        den = np.maximum(qn, floor)
        den_abs = np.where(branch[:, t], (np.abs(qt) * n_abs).sum(-1), 0.0)
        num = np.einsum("bhd,bhde->bhe", qt, C)
        num_abs = np.einsum("bhd,bhde->bhe", np.abs(qt), C_abs)
        h[:, t] = num / den[..., None]
        scale[:, t] = (num_abs / den[..., None] + np.abs(num)
                       * (den_abs / den ** 2)[..., None]).max(-1)
        m = m_new
    return h, branch, scale


def _gate_inputs(s, seed, i_scale, f_bias):
    """q/k/v [16, S, 2, 16] and the log gates: 16 lanes, so that each
    form's worst row is a maximum over many rows (a single row's error is
    a matter of its summation order's luck)."""
    rng = np.random.default_rng(seed)
    b, nh, hd = 16, 2, 16
    q, k, v = (rng.standard_normal((b, s, nh, hd)).astype(np.float32)
               for _ in range(3))
    logi = (i_scale * rng.standard_normal((b, s, nh))).astype(np.float32)
    pre_f = (f_bias + 2 * rng.standard_normal((b, s, nh))).astype(np.float32)
    logf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(pre_f)))
    return q, k, v, logf, logi


_ref_chunks = jax.jit(lambda q, k, v, lf, li: jax.lax.scan(
    lambda c, inp: jxlstm._mlstm_chunk(c, *inp),
    (jnp.zeros((q.shape[0], q.shape[2], q.shape[3], q.shape[3])),
     jnp.zeros((q.shape[0], q.shape[2], q.shape[3])),
     jnp.zeros((q.shape[0], q.shape[2]))),
    tuple(jnp.moveaxis(t.reshape(t.shape[0], -1, min(64, t.shape[1]),
                                 *t.shape[2:]), 1, 0)
          for t in (q, k, v, lf, li)))[1])
_ref_step = jax.jit(jxlstm.mlstm_step)


def _port_forms(q, k, v, logf, logi):
    """The port's chunkwise form over S and its step token by token."""
    b, s, nh, hd = q.shape
    tq, tk, tv, tf, ti = (torch.from_numpy(np.array(a))
                          for a in (q, k, v, logf, logi))

    def zero():
        return (torch.zeros((b, nh, hd, hd)), torch.zeros((b, nh, hd)),
                torch.zeros((b, nh)))
    chunk = xlstm.prefill_chunk(s)
    carry, hs = zero(), []
    for t in range(0, s, chunk):
        sl = slice(t, t + chunk)
        carry, hc = xlstm.mlstm_chunk(carry, tq[:, sl], tk[:, sl], tv[:, sl],
                                      tf[:, sl], ti[:, sl])
        hs.append(hc)
    carry, steps = zero(), []
    for t in range(s):
        carry, ht = xlstm.mlstm_step(carry, tq[:, t], tk[:, t], tv[:, t],
                                     tf[:, t], ti[:, t])
        steps.append(ht)
    return torch.cat(hs, 1).numpy(), torch.stack(steps, 1).numpy()


def _ref_forms(q, k, v, logf, logi):
    b, s, nh, hd = q.shape
    hs = np.asarray(_ref_chunks(q, k, v, logf, logi))
    chunked = np.moveaxis(hs, 0, 1).reshape(b, s, nh, hd)
    carry = (jnp.zeros((b, nh, hd, hd)), jnp.zeros((b, nh, hd)),
             jnp.zeros((b, nh)))
    steps = []
    for t in range(s):
        carry, ht = _ref_step(carry, q[:, t], k[:, t], v[:, t], logf[:, t],
                              logi[:, t])
        steps.append(np.asarray(ht))
    return chunked, np.stack(steps, 1)


def _err(got, want, scale) -> float:
    """Worst (b, t, h) row's error over that row's rounding scale."""
    return float((np.abs(got - want).max(-1) / scale).max())


@settings(max_examples=12, deadline=None)
@given(s=st.sampled_from([1, 9, 64, 128]), seed=st.integers(0, 99),
       i_scale=st.sampled_from([0.5, 3.0, 8.0]),
       f_bias=st.sampled_from([-2.0, 1.0, 4.0]))
def test_chunkwise_and_step_within_the_references_error(s, seed, i_scale,
                                                        f_bias):
    """The port's chunkwise form (``mlstm_chunk`` over the chunks of S)
    and its step (``mlstm_step`` token by token) against the recurrence in
    f64, on gate inputs whose scales move the stabilizer m up and down and
    switch the normalizer between |n.q| and exp(-m), each row's error
    over its rounding scale (``_recurrence_f64``: a row whose |n.q|
    cancels to a thousandth of its terms is that much harder for any fp32
    order): each form's worst row within 4x the reference's same form's
    (``_mlstm_chunk`` under its ``lax.scan``, ``mlstm_step``), and within
    1e-4 of its scale (about 840 fp32 ulps; 6e-6 measured)."""
    args = _gate_inputs(s, seed, i_scale, f_bias)
    want, _, scale = _recurrence_f64(*args)
    got = _port_forms(*args)
    ref_forms = _ref_forms(*args)
    for g, r in zip(got, ref_forms):
        assert _err(g, want, scale) <= 4 * _err(r, want, scale)
        assert _err(g, want, scale) <= 1e-4


def test_gate_scales_reach_both_normalizer_branches():
    """The scales the property test draws take the normalizer down both
    branches, and the stabilizer both up past 0 and down below it."""
    seen = set()
    ms = []
    for i_scale, f_bias in ((0.5, -2.0), (8.0, 4.0)):
        args = _gate_inputs(64, 0, i_scale, f_bias)
        _, branch, _ = _recurrence_f64(*args)
        seen |= set(np.unique(branch).tolist())
        logf, logi = args[3].astype(np.float64), args[4].astype(np.float64)
        m = np.zeros(logf.shape[::2])
        for t in range(logf.shape[1]):
            m = np.maximum(logf[:, t] + m, logi[:, t])
            ms.append(m.copy())
    assert seen == {False, True}
    assert min(map(np.min, ms)) < -1 and max(map(np.max, ms)) > 5


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_reference(fp32, bf16):
    """The prefill of 12 tokens and 7 decode steps fed the same tokens: at
    fp32 compute every step's logits within 5e-5 of their scale; at bf16
    compute their distance from the reference's fp32-compute run within
    4x the reference's own (ROADMAP's consistency-budget rule)."""
    toks = _tokens(fp32.cfg)
    picks = np.random.default_rng(4).integers(
        0, fp32.cfg.vocab, (BATCH, STEPS)).astype(np.int32)
    j32, t32 = fp32.teacher_forced(toks, picks)
    errs = [_rel_err(t, j) for t, j in zip(t32, j32)]
    assert max(errs) <= 5e-5, errs
    j16, t16 = bf16.teacher_forced(toks, picks)
    errs = [_rel_err(t, a) for t, a in zip(t16, j32)]
    noise = [_rel_err(j, a) for j, a in zip(j16, j32)]
    assert 0 < max(errs) <= 4 * max(noise), (errs, noise)


def test_prefill_of_64_matches_reference(fp32):
    """A prefill of one full chunk (64 positions) at fp32 compute: the
    logits within 5e-5 of their scale."""
    toks = _tokens(fp32.cfg, s=64)
    jl, _ = fp32.prefill(fp32.jparams, jnp.asarray(toks), 64)
    tl, _ = fp32.tm.prefill(torch.from_numpy(toks))
    assert _rel_err(tl[:, :fp32.cfg.vocab],
                    np.asarray(jl)[:, :fp32.cfg.vocab]) <= 5e-5


def test_decode_matches_prefill_within_the_port(bf16):
    """The reference's own check (``test_archs_smoke.py``, which F1 keeps
    from running here), in the port at bf16: a decode step at position S
    after a prefill of S tokens against a prefill of the S + 1 tokens (the
    chunkwise form against the step); a changed last token moves the
    logits by more than 4x that."""
    tm = bf16.tm
    toks = torch.from_numpy(_tokens(bf16.cfg, s=24))
    _, cache = tm.prefill(toks[:, :-1], 24)
    got, _ = tm.decode_step(cache, toks[:, -1:], 23)
    want, _ = tm.prefill(toks)
    other = toks.clone()
    other[:, -1] = (other[:, -1] + 1) % bf16.cfg.vocab
    off, _ = tm.prefill(other)
    err = _rel_err(got, want.numpy())
    assert err <= 0.02, err
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


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_generate_with_status_falls_through_and_matches_reference(request,
                                                                  compute):
    """``generate_with_status`` on the smoke config: the engine falls
    through to the fixed loop (the reference's ``_paged_ok`` is false too),
    every lane ok.  At fp32 compute the greedy tokens equal the reference
    ``ServeEngine``'s on the same batch.  At bf16 compute, as on the card,
    the two frameworks round differently once a layer: XLA's CPU fusion
    feeds each standalone rmsnorm the unrounded fp32 sum of the residual
    add (its excess precision), while the port's row-norm kernel reads the
    bf16 stream, as every model of the port does; the recurrent states
    carry the difference into every later step (within 4x the reference's
    own bf16 noise, ``test_prefill_and_decode_match_reference``).  So each
    lane's tokens equal the reference's up to the step where they first
    differ, and that step must be a near tie: fed the reference's tokens,
    the port's pick lies below the reference's by no more than twice the
    two frameworks' summed differences on the pair.  At least half the
    lanes' steps lie before their lane's first difference."""
    pair = request.getfixturevalue(compute)
    got, want = _generate_both(pair, False)
    if compute == "fp32":
        np.testing.assert_array_equal(got, want)
        return
    got = np.asarray(got)
    jl, tl = pair.teacher_forced(_tokens(pair.cfg, seed=2), want)
    diff = np.abs(tl - jl)
    firsts = []
    for b in range(BATCH):
        apart = np.flatnonzero(got[b] != want[b])
        first = int(apart[0]) if apart.size else STEPS
        firsts.append(first)
        if first < STEPS:
            # up to ``first`` the port was fed the reference's tokens, so
            # its pick there is its teacher-forced argmax
            pick, mine = want[b, first], got[b, first]
            assert tl[first, b].argmax() == mine
            margin = jl[first, b, pick] - jl[first, b, mine]
            bound = 2 * (diff[first, b, pick] + diff[first, b, mine])
            assert margin <= bound, (
                f"lane {b} leaves the reference's tokens at step {first}, "
                f"where no near tie explains it: margin {margin:.4f}")
    print(f"steps equal per lane before the first difference: {firsts} of "
          f"{STEPS}")
    assert sum(firsts) >= BATCH * STEPS // 2, firsts


def test_int8_copy_serves_the_float_tokens(bf16):
    """``ServeConfig(int8=True)`` on the smoke config at bf16 compute: the
    int8 copy quantizes nothing (``test_int8_copy_shares_every_leaf``), so
    the engine serves the float model's tokens bit for bit, with the int8
    saturation probe on and every lane ok, as the reference's int8 engine
    serves its own float tokens."""
    got8, want8 = _generate_both(bf16, True)
    got, want = _generate_both(bf16, False)
    np.testing.assert_array_equal(got8, got)
    np.testing.assert_array_equal(want8, want)


def test_int8_copy_shares_every_leaf(fp32):
    """Every weight is a recurrent mixer's (no ``attn``, no ``ffn``): the
    int8 copy holds no ``QuantizedWeight`` and shares each mixer, norm and
    the embedding (the reference's pass touches ``/attn/`` and ``/ffn/``
    only, so its copy is its tree, leaf for leaf); the releasing build
    changes no tensor either, and its peak is the float model's."""
    tm = fp32.tm
    q = tm.quantize_params_for_serving()
    assert not any(isinstance(m, QuantizedWeight) for m in q.modules())
    assert q.embed is tm.embed and q.final_norm is tm.final_norm
    for blk, qb in zip(tm.blocks, q.blocks):
        assert qb.mix is blk.mix and qb.ln1 is blk.ln1
        assert not hasattr(qb, "ffn") and not hasattr(qb, "ln2")
    jq = fp32.jm.quantize_params_for_serving(fp32.jparams)
    for a, b in zip(jax.tree.leaves(jq), jax.tree.leaves(fp32.jparams)):
        assert a is b
    cfg = get_config(ARCH)
    float_bytes = sum(t.nbytes for t in
                      Model(cfg, device="meta").state_dict().values())
    assert tserve.int8_peak_bytes(cfg) == float_bytes
    assert tserve.int8_peak_bytes(cfg, True) == float_bytes


def test_fp32_fallback_step_leaves_the_state(fp32):
    """The fixed loop's float step for a degraded lane runs on a fork of
    the cache: the mLSTM and sLSTM states it advances are the fork's."""
    tm = fp32.tm
    toks = torch.from_numpy(_tokens(fp32.cfg))
    _, cache = tm.prefill(toks, PROMPT + 2)
    kept = {i: {k: t.clone() for k, t in cache[i].items()} for i in (0, 7)}
    fork = cache.fork()
    tm.decode_step(fork, toks[:, :1], PROMPT)
    for i, state in kept.items():
        for k, t in state.items():
            assert torch.equal(cache[i][k], t), (i, k)
            assert k == "conv" or not torch.equal(fork[i][k], t), (i, k)


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------

def test_refusals(fp32):
    """F10: a prefill of 96 tokens (neither below 64 nor a multiple of it)
    is refused by both (the reference's bare assert, the port's
    ValueError that names the rule) while 12, 64 and 128 serve; not
    pageable (``new_paged_cache`` and the reference's ``paged_cache_defs``
    raise, ``submit`` raises, a paged forward raises); an unknown block
    kind is refused with its name."""
    toks = _tokens(fp32.cfg, s=96)
    with pytest.raises(AssertionError):
        fp32.prefill(fp32.jparams, jnp.asarray(toks), 96)
    with pytest.raises(ValueError, match="multiple of 64"):
        fp32.tm.prefill(torch.from_numpy(toks))
    for s in (12, 64, 128):
        assert fp32.tm.prefill(torch.zeros((1, s), dtype=torch.long))[
            0].shape == (1, fp32.cfg.padded_vocab())
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
        tm.forward(torch.zeros((1, 1), dtype=torch.long), cache=[{}] * 8,
                   positions=torch.zeros((1, 1), dtype=torch.int32),
                   page_table=torch.zeros((1, 1), dtype=torch.int32))
    cfg = dataclasses.replace(fp32.cfg, block_pattern=("mamba",))
    with pytest.raises(NotImplementedError, match="'mamba'"):
        Model(cfg, device="meta")


@pytest.mark.parametrize("argv,reason", [
    (["--requests", "2"], "recurrent state"),
    (["--prompt-len", "96"], "multiple of 64")], ids=["requests", "f10"])
def test_launcher_refusals(argv, reason):
    with pytest.raises(SystemExit, match=reason):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", *argv])


# ---------------------------------------------------------------------------
# what the kernels are handed
# ---------------------------------------------------------------------------

@pytest.fixture
def forced_norms(monkeypatch):
    """Every kernel entry point of ``kernels.ops`` routed to its CUDA
    wrapper on CPU tensors, up to the launch: each wrapper's own checks
    run, ``_cuda.check`` holds dtype, shape, contiguity and 16-byte
    alignment, and each launch is recorded and computes nothing."""
    import types
    calls = []

    def check(t, what, dtype, shape=None, align=16):
        assert t.dtype == dtype, (what, t.dtype)
        assert shape is None or tuple(t.shape) == tuple(shape), (what,
                                                                 t.shape)
        assert t.is_contiguous(), f"{what} must be contiguous"
        assert t.data_ptr() % align == 0, f"{what} must be aligned"
    monkeypatch.setattr(_cuda, "check", check)
    monkeypatch.setattr(_cuda, "launch",
                        lambda lib, fn, *args: calls.append((lib, fn, args)))
    routed = types.SimpleNamespace(**vars(ref))
    routed.matmul_fused_ref = tmm.matmul_cuda
    routed.int8_matmul_ref = tmm.int8_matmul_cuda
    routed.quantize_rowwise_ref = ops.quantize_rowwise_cuda
    monkeypatch.setattr(ops, "ref", routed)
    monkeypatch.setattr(ops, "rms_normalize", lambda x, scale, eps: (
        tmm.rmsnorm_cuda(x.reshape(-1, x.shape[-1]), scale, eps)
        .reshape(x.shape)))
    before = dict(_cuda.LAUNCHES)
    _cuda.reset_launches()
    yield calls
    _cuda.LAUNCHES.clear()
    _cuda.LAUNCHES.update(before)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_served_path_launches_row_norms_only(forced_norms, int8):
    """At full width (d_model 1024, one period of the pattern: seven mLSTM
    blocks and one sLSTM block), bf16 compute as on the card: a prefill of
    2 x 8 tokens and one decode step hand ``_cuda.launch`` the row-norm
    kernel only, bf16 rows of N = 1024 (the entry norm, each next norm,
    the sLSTM's inner norm) and N = 2048 (the mLSTM's inner norm), 2 L + 1
    launches a forward; the int8 copy launches the same."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=8, vocab=256)
    model = Model(cfg, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    if int8:
        model = model.quantize_params_for_serving()
    n = cfg.n_layers
    logits, cache = model.prefill(torch.zeros((2, 8), dtype=torch.long))
    calls = list(forced_norms)
    forced_norms.clear()
    model.decode_step(cache, torch.zeros((2, 1), dtype=torch.long), 8)
    for rows, batch in ((2 * 8, calls), (2, list(forced_norms))):
        assert {(lib, fn) for lib, fn, _ in batch} == {
            ("matmul", "k1_rmsnorm_rows")}
        widths = [args[4] for _, _, args in batch]
        assert len(batch) == 2 * n + 1
        assert widths.count(2048) == 7 and widths.count(1024) == n + 2
        assert {args[3] for _, _, args in batch} == {rows}
    assert _cuda.LAUNCHES["rmsnorm"] == 2 * (2 * n + 1)
    assert sum(_cuda.LAUNCHES.values()) == _cuda.LAUNCHES["rmsnorm"]


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip(bf16, tmp_path):
    """The port's model saved in the reference's format (every leaf at
    fp32, the reference's float32 masters, so no bf16 words, F7) and
    served by ``ServeEngine.from_checkpoint``: the restored model's logits
    bitwise the saved model's."""
    cfg, tm = bf16.cfg, bf16.tm
    CheckpointManager(str(tmp_path)).save(
        2, to_jax_params(cfg, tm.state_dict()), blocking=True)
    text = (tmp_path / "step_00000002" / "manifest.json").read_text()
    assert "bfloat16" not in text and "float32" in text
    eng = ServeEngine.from_checkpoint(Model(cfg, device="cpu"),
                                      str(tmp_path))
    toks = torch.from_numpy(_tokens(cfg))
    assert torch.equal(eng.model.prefill(toks)[0], tm.prefill(toks)[0])
    _, tree = CheckpointManager(str(tmp_path)).restore(2, cfg=cfg)
    mix = tree["groups"]["b7"]["mix"]
    assert mix["w_in"].dtype == mix["r"].dtype == np.float32


@pytest.mark.parametrize("extra", [[], ["--int8"]], ids=["bf16", "int8"])
def test_launcher_serves_the_smoke_config(capsys, extra):
    """``launch.serve --arch xlstm-350m --smoke --device cpu``: a prompt
    of 64 tokens (one chunk), bf16 and int8, every lane ok."""
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "64", "--max-new", "3", *extra])
    out = capsys.readouterr().out
    assert "xlstm-350m-smoke" in out and "lane 1: ok" in out
