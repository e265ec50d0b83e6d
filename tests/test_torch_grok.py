"""grok-1-314b's path through the port against the JAX reference, on the
CPU: the config copy and its depth cut, the MoE at top-2 (``lax.top_k``'s
routing with its ties, the dispatch, the jitted combine, the whole
``moe_apply``), the G = 6 launches of K4-K6 (intercepted at
``kernels._cuda.launch``: the CUDA kernels run only on the card, where
``chip_smoke.py`` holds them to their plain versions), and the smoke
config (2 global layers, 4 experts top-2, capacity factor 8) served
through the fixed loop and the scheduler, float and int8.

Tolerances: the routing, the dispatch (sorted tokens, slots, kept flags,
gates) and the combine are bitwise the reference's, the combine at bf16
too (the reference's jit keeps the gate product unrounded; the port
follows it).  ``moe_apply`` at fp32 within 1e-5 of its scale.  Slice
level, at fp32 compute on the same parameters (``convert.from_jax_params``;
norm scales drawn from a numpy seed and block weights tripled so that
greedy tokens vary): prefill logits within 1e-4 of their scale, greedy
tokens equal in the fixed loop and the scheduler.  At bf16 compute the
reference's own eager and jitted runs of the expert gate ``silu(g) * h``
differ by bf16 ulps (XLA's fusion), so bf16 is held to the consistency
budget: each lane's tokens equal up to their first difference, which
must be a near tie, with at least half the steps compared.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels.quantize import QuantizedWeight as JQuantizedWeight
from repro.launch.mesh import make_mesh
from repro.models import moe as jmoe
from repro.models.layers import TPCtx
from repro.models.lm import Model as JaxModel
from repro.serve.api import Request as JRequest
from repro.serve.api import SamplingParams as JSamplingParams
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import from_jax_params
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels.quantize import QuantizedWeight
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import Model
from repro_torch.robust.guards import STATUS_OK
from repro_torch.serve.api import Request, SamplingParams
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

ARCH = "grok-1-314b"
H100_SMS = 132
PROMPT, STEPS, BATCH = 24, 8, 2


@pytest.fixture(autouse=True)
def _xla_mode():
    assert jops.kernel_mode() == "xla", "the reference must run its CPU path"


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_is_the_reference_copy(smoke):
    """Every field of the port's ``ArchConfig`` (the MoE fields included)
    equals the reference's, and so does the parameter count."""
    got, want = get_config(ARCH, smoke=smoke), jax_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(ArchConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.param_count() == want.param_count()
    assert (got.top_k, got.moe_shared_expert) == (2, False)
    assert ARCH in ARCH_IDS


def test_six_layers_fit_one_card():
    """The depth cut: 6 of 64 layers, 30.3 B parameters (a layer 9.84 GB in
    bf16, its 8 experts of 3 x 6144 x 32768 9.66 GB), 60.65 GB; 7 layers
    (70.49 GB) leave no room for a prefill's expert transients.  The
    scheduler's lanes take a 4160-token prompt and its 32 new tokens, and
    the attention-only int8 copy (0.53 GB) fits beside the bf16 model."""
    cfg = tserve.with_layers(get_config(ARCH), 6)
    assert cfg == dataclasses.replace(get_config(ARCH), n_layers=6)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff) == (
        6144, 48, 8, 128, 32768)
    assert 2 * cfg.param_count() == 60_650_385_408
    assert 2 * cfg.param_count() < 0.8 * 80e9 \
        < 2 * dataclasses.replace(cfg, n_layers=7).param_count()
    geom = tserve.geometry(ARCH)
    assert geom == tserve.GROK_GEOMETRY
    assert geom["max_seq_len"] >= 4160 + 32
    assert tserve.int8_fits(cfg, torch.device("cuda"), True, total=80e9)
    copy = tserve.int8_peak_bytes(cfg, True) - 2 * cfg.param_count()
    assert 0.5e9 < copy < 0.56e9


# ---------------------------------------------------------------------------
# the MoE at top-2 against the reference
# ---------------------------------------------------------------------------

TIES = np.array([
    [0.1, 0.3, 0.3, 0.3, 0.0],      # a three-way tie for the top
    [0.2, 0.2, 0.2, 0.2, 0.2],      # all tied
    [0.5, 0.1, 0.1, 0.2, 0.1],      # a three-way tie below the top 2
    [0.1, 0.4, 0.1, 0.4, 0.0],      # a two-way tie for the top
    [0.4, 0.2, 0.0, 0.2, 0.2],      # a three-way tie for second
], np.float32)


@pytest.mark.parametrize("k", [1, 2])
def test_top_k_is_lax_top_k(k):
    """``moe.top_k`` equals ``jax.lax.top_k`` in values and indices, on rows
    with two- and three-way ties (the lower index first, where
    ``torch.topk`` picks otherwise) and on softmax rows."""
    rng = np.random.default_rng(k)
    soft = np.asarray(jax.nn.softmax(jnp.asarray(
        rng.standard_normal((64, 8)).astype(np.float32)), -1))
    for probs in (TIES, soft):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe.top_k(torch.from_numpy(np.array(probs)), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@functools.lru_cache(maxsize=None)
def _moe_leaves():
    """The reference's init of the smoke config's first MoE, the router
    scaled up so that routing is uneven (numpy leaves, drawn once)."""
    jm = JaxModel(jax_config(ARCH, smoke=True), make_mesh(1, 1))
    params = jax.tree.map(np.asarray, jm.init_params(0))
    p = {k: v[0] for k, v in params["groups"]["b0"]["ffn"].items()}
    p["router"] = p["router"] * np.float32(8)
    return p


def _moe_pair(cf, n_tokens, seed):
    """The configs at capacity factor ``cf`` (fp32 compute), the
    reference's MoE parameters (``_moe_leaves``), the port's ``MoE`` on
    the same values, and tokens x [1, n, D] at fp32 drawn from ``seed``."""
    over = dict(capacity_factor=cf, compute_dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **over)
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **over)
    p = _moe_leaves()
    moe = tmoe.MoE(cfg, torch.float32, torch.device("cpu"))
    moe.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()})
    x = np.random.default_rng(seed).standard_normal(
        (1, n_tokens, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, {k: jnp.asarray(v) for k, v in p.items()}, moe, x


def _dispatch_both(cfg, jcfg, jp, x):
    """The reference's ``_dispatch_one_shard`` at k = 2 and the port's
    routing and ``dispatch`` on the same router probabilities."""
    n = x.shape[1]
    xt = x.reshape(n, -1)
    cap = tmoe.capacity(n, cfg)
    assert cap == jmoe._capacity(n, jcfg, 1)
    jprobs = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    _, jst, jdest, jsg, jkeep = jmoe._dispatch_one_shard(
        jnp.asarray(xt), jprobs, cap, cfg.n_experts, 2, jnp.float32)
    gates, expert = tmoe.top_k(torch.from_numpy(np.array(jprobs)), 2)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    got = tmoe.dispatch(expert, cfg.n_experts, cap, gates)
    return cap, got, (jst, jdest, jsg, jkeep)


CFS = [(8.0, 48), (0.5, 48), (0.25, 48)]


@pytest.mark.parametrize("cf,n_tokens", CFS,
                         ids=["no-drop", "overflow", "half-kept"])
def test_dispatch_is_the_references(cf, n_tokens):
    """Tokens, slots, kept flags and gates of the sorted entries bitwise
    the reference's on the same probabilities; the router's own within
    1e-5 of each value (its fp32 product's summation order).  At ``cf``
    8.0 nothing drops; at 0.5 and 0.25 entries overflow their expert, and
    at 0.25 some token keeps one of its two entries and loses the other
    (capacity drops each entry on its own)."""
    cfg, jcfg, jp, moe, x = _moe_pair(cf, n_tokens, seed=n_tokens + int(cf))
    _, (st, dest, keep, sg), want = _dispatch_both(cfg, jcfg, jp, x)
    for got, w in zip((st, dest, sg, keep), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    xt = torch.from_numpy(x.reshape(n_tokens, -1))
    # the router's fp32 product sums in another order than XLA's: its
    # probabilities agree to fp32 rounding of the logits, not bitwise
    np.testing.assert_allclose(
        tmoe.router_probs(xt, moe.router).numpy(),
        np.asarray(jax.nn.softmax(jnp.asarray(xt.numpy()) @ jp["router"],
                                  axis=-1)), rtol=1e-5, atol=1e-7)
    per_token = np.zeros(n_tokens, int)
    np.add.at(per_token, st.numpy(), keep.numpy().astype(int))
    assert (per_token.min() == 2) == (cf == 8.0)
    if cf == 0.25:
        assert (per_token == 1).any(), per_token


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_combine_is_the_jitted_references(compute):
    """From the same expert outputs ``ye`` and the same sorted entries
    (with overflow), ``moe.combine`` is bitwise the reference's
    ``_combine_one_shard`` under ``jax.jit``: at bf16 the gate is rounded
    to bf16 and the product kept at fp32 (the eager reference rounds the
    product too, and differs); the combine is the same whatever the order
    of the entries."""
    cfg, jcfg, jp, _, x = _moe_pair(0.5, 48, seed=5)
    cap, (st, dest, keep, sg), (jst, jdest, jsg, jkeep) = _dispatch_both(
        cfg, jcfg, jp, x)
    e, n, d = cfg.n_experts, 48, cfg.d_model
    td = getattr(torch, compute)
    ye = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (e, cap, d)).astype(np.float32)).to(td)
    jye = jnp.asarray(ye.float().numpy()).astype(getattr(jnp, compute))
    jitted = jax.jit(jmoe._combine_one_shard, static_argnames=("n", "e",
                                                               "cap"))
    want = np.asarray(jitted(jye, jst, jdest, jsg, jkeep, n=n, e=e, cap=cap))
    got = tmoe.combine(ye.reshape(e * cap, d), st, dest, sg, keep, n)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    eager = np.asarray(jmoe._combine_one_shard(jye, jst, jdest, jsg, jkeep,
                                               n=n, e=e, cap=cap))
    assert np.array_equal(eager, want) == (compute == "float32")
    perm = torch.from_numpy(np.random.default_rng(3).permutation(len(st)))
    again = tmoe.combine(ye.reshape(e * cap, d), st[perm], dest[perm],
                         sg[perm], keep[perm], n)
    assert torch.equal(again, got)


@pytest.mark.parametrize("cf,n_tokens", CFS + [(0.5, 200)],
                         ids=["no-drop", "overflow", "half-kept",
                              "overflow-long"])
def test_moe_apply_matches_reference(cf, n_tokens):
    """At fp32 the output within 1e-5 of its scale, the aux loss (top-1 at
    any k) within 1e-6, and ``kept`` True exactly where the reference kept
    both of a token's entries."""
    cfg, jcfg, jp, moe, x = _moe_pair(cf, n_tokens, seed=n_tokens + int(cf))
    _, _, (jst, _, _, jkeep) = _dispatch_both(cfg, jcfg, jp, x)
    ctx = TPCtx(mesh=make_mesh(1, 1), sp=False, compute_dtype=jnp.float32)
    jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, ctx)
    got = tmoe.moe_apply(moe, torch.from_numpy(x), cfg, torch.float32)
    w = np.asarray(jout, np.float64)
    assert float(np.abs(got.out.double().numpy() - w).max()) \
        <= 1e-5 * max(1.0, float(np.abs(w).max()))
    assert abs(float(got.aux) - float(jaux)) <= 1e-6
    kept = np.ones(n_tokens, bool)
    kept[np.asarray(jst)[~np.asarray(jkeep)]] = False
    np.testing.assert_array_equal(got.kept.numpy().reshape(-1), kept)
    assert kept.all() == (cf == 8.0)


def test_three_experts_a_token_are_refused():
    """k = 3 is refused by name, when the MoE is built and when it is
    applied: its fp32 combine would need an ordered fold."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), top_k=3)
    with pytest.raises(ValueError, match="top_k=3.*ordered fold"):
        Model(cfg, device="cpu")
    moe = tmoe.MoE(get_config(ARCH, smoke=True), torch.float32,
                   torch.device("cpu"))
    with pytest.raises(ValueError, match="top_k=3.*ordered fold"):
        tmoe.moe_apply(moe, torch.zeros((1, 4, cfg.d_model)), cfg,
                       torch.float32)


# ---------------------------------------------------------------------------
# the kernels at grok's shapes (G = 6), up to the launch
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
    _cuda.reset_launches()
    for key in [k for k in _cuda.LAUNCHES if ":" in k]:
        del _cuda.LAUNCHES[key]
    yield calls
    _cuda.LAUNCHES.clear()
    _cuda.LAUNCHES.update(before)


def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_attention_launches_at_g6(intercepted):
    """grok's attention, 48 q heads over 8 kv heads of 128: K4 at the fixed
    loop's 2 x 4160 prefill; K5 at its decode over a 4176-slot cache (one
    row of 6 heads a kv head, ``head_groups(6)``); K6 at the scheduler's
    geometry (8 lanes, 262 pages of 16 a lane), its decode body and its
    chunk body (q tiles of 21 positions x 6 heads: 21, 21, 21 and 1 of a
    64-position chunk, ``chunk_tiles(64, 6)``)."""
    assert tfa.head_groups(6) == (1, 6) and tfa.chunk_tiles(64, 6) == (21, 4)
    tfa.flash_attention_cuda(_bf(2, 4160, 48, 128), _bf(2, 4160, 8, 128),
                             _bf(2, 4160, 8, 128))
    kc = _bf(2, 4176, 8, 128)
    tfa.dense_decode_launch(_bf(2, 1, 8, 6, 128), kc, kc, 4170)
    pool = _bf(513, 16, 8, 128)
    table = torch.zeros((8, 262), dtype=torch.int32)
    for s in (1, 64):
        tfa.paged_decode_launch(_bf(8, s, 8, 6, 128), pool, pool, table,
                                torch.zeros((8, s), dtype=torch.int32))
    (_, k4, a4), (_, k5, a5), (_, k6, a6), (_, k6c, a6c) = intercepted
    assert (k4, k5, k6, k6c) == ("k4_flash_prefill", "k5_flash_decode",
                                 "k6_paged_decode", "k6_paged_chunk")
    assert a4[4:] == (2, 4160, 4160, 48, 8, 128, 128 ** -0.5, 0, 0, 0, 0.0)
    assert a5[6:13] == (2, 8, 1, 6, 128, 4176, 4170)
    assert a6[8:13] == (8, 8, 1, 6, 128)
    assert a6c[6:11] == (8, 64, 8, 6, 128)
    want = {"flash_attention": 1, "flash_decode": 1, "paged_decode": 2,
            "paged_decode:chunk": 1}
    assert {k: _cuda.LAUNCHES[k] for k in want} == want


# ---------------------------------------------------------------------------
# the slice against the reference
# ---------------------------------------------------------------------------

def _tree():
    """The reference's init of the smoke config with random norm scales and
    tripled block weights (so greedy tokens vary)."""
    jm = JaxModel(jax_config(ARCH, smoke=True), make_mesh(1, 1))
    params = jax.tree.map(np.asarray, jm.init_params(0))
    rng = np.random.default_rng(7)
    grp = params["groups"]["b0"]
    for name in ("ln1", "ln2"):
        grp[name] = (0.5 * rng.standard_normal(grp[name].shape)
                     ).astype(np.float32)
    for sub in ("attn", "ffn"):
        for name, w in grp[sub].items():
            grp[sub][name] = w * w.dtype.type(3)
    params["final_norm"] = (0.5 * rng.standard_normal(
        params["final_norm"].shape)).astype(np.float32)
    return params


class Pair:
    """The reference (one jit of prefill and one of decode) and the port on
    the same parameters at one compute dtype."""

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
def tree():
    return _tree()


@pytest.fixture(scope="module")
def fp32(tree):
    return Pair(tree, "float32")


@pytest.fixture(scope="module")
def bf16(tree):
    """bf16 compute, as on the card."""
    return Pair(tree, "bfloat16")


def _tokens(cfg, seed=1, s=PROMPT, batch=BATCH):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (batch, s)).astype(np.int32)


def _rel_err(got, want) -> float:
    g = np.asarray(got.double() if torch.is_tensor(got) else got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w)) / max(1.0, np.max(np.abs(w))))


def test_prefill_logits_match_reference(fp32):
    """The smoke slice's prefill at fp32 compute (K4 global at G = 2, the
    top-2 MoE in both layers): logits within 1e-4 of their scale, and no
    token of the call dropped (``Model.moe_kept``, every layer)."""
    toks = _tokens(fp32.cfg)
    jl, _ = fp32.prefill(fp32.jparams, jnp.asarray(toks), PROMPT + STEPS)
    tl, _ = fp32.tm.prefill(torch.from_numpy(toks), PROMPT + STEPS)
    assert _rel_err(tl, jl) <= 1e-4
    assert len(fp32.tm.moe_kept) == fp32.cfg.n_layers
    assert all(bool(k.all()) for k in fp32.tm.moe_kept)


def _fixed_both(pair, int8=False, batch=BATCH):
    toks = _tokens(pair.cfg, seed=2, batch=batch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JServeEngine(pair.jm, pair.jparams,
                            JServeConfig(max_new_tokens=STEPS, int8=int8))
    want = jeng.generate_with_status_fixed({"tokens": jnp.asarray(toks)})
    got = ServeEngine(pair.tm, ServeConfig(max_new_tokens=STEPS, int8=int8)
                      ).generate_with_status_fixed(
        {"tokens": torch.from_numpy(toks)})
    assert list(got.status) == list(want.status) == [STATUS_OK] * batch
    return toks, got.tokens, np.asarray(want.tokens)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_fixed_loop_greedy_tokens_match_reference(fp32, int8):
    """``generate_with_status_fixed`` (dense cache, K4 then K5) at fp32
    compute against the reference's same path, token for token, on the
    float model and on the attention-only int8 copy (each framework
    quantizes the same fp32 activations)."""
    _, got, want = _fixed_both(fp32, int8)
    np.testing.assert_array_equal(got, want)
    assert len(set(got[0].tolist())) > 1, "degenerate greedy stream"


_GEOM = dict(n_lanes=3, page_size=8, prefill_chunk=8, max_seq_len=64)
_REQS = [(21, 6), (40, 4), (17, 6), (33, 3), (26, 5)]   # (prompt, max_new)


def _serve_both(pair, prompts, news, int8=False):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JServeEngine(pair.jm, pair.jparams,
                            JServeConfig(int8=int8, **_GEOM))
    for i, (p, new) in enumerate(zip(prompts, news)):
        jeng.submit(JRequest(id=i, tokens=p, sampling=JSamplingParams(
            max_new_tokens=new)))
    want = {o.id: o for o in jeng.drain()}
    teng = ServeEngine(pair.tm, ServeConfig(int8=int8, **_GEOM))
    for i, (p, new) in enumerate(zip(prompts, news)):
        teng.submit(Request(id=i, tokens=p, sampling=SamplingParams(
            max_new_tokens=new)))
    got = {o.id: o for o in teng.drain()}
    assert set(got) == set(want) == set(range(len(prompts)))
    return got, want


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_scheduler_greedy_tokens_match_reference(fp32, int8):
    """The scheduler (``submit``/``drain``): five requests through three
    lanes (K6 global, decode and chunk; the top-2 MoE over every call's
    lanes) against the reference's scheduler, token for token, float and
    int8, at fp32 compute."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, fp32.cfg.vocab, n).astype(np.int32)
               for n, _ in _REQS]
    got, want = _serve_both(fp32, prompts, [new for _, new in _REQS], int8)
    for i in got:
        assert got[i].status == want[i].status == STATUS_OK
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
    assert len({t for o in got.values() for t in o.tokens.tolist()}) > 3


def test_bf16_tokens_within_the_consistency_budget(bf16, fp32):
    """At bf16 compute, as on the card: the fixed loop's greedy tokens equal
    the reference's up to each lane's first difference, and that step must
    be a near tie (fed the reference's tokens, the port's pick lies below
    the reference's by no more than twice the two frameworks' summed
    differences on the pair); at least half the lanes' steps compared.  The
    teacher-forced logits lie within 4x the reference's own bf16 noise
    (its distance from its fp32 run on the same tokens)."""
    toks, got, want = _fixed_both(bf16, batch=4)
    jl, tl = bf16.teacher_forced(toks, want)
    diff = np.abs(tl - jl)
    firsts = []
    for b in range(toks.shape[0]):
        apart = np.flatnonzero(got[b] != want[b])
        first = int(apart[0]) if apart.size else STEPS
        firsts.append(first)
        if first < STEPS:
            pick, mine = want[b, first], got[b, first]
            assert tl[first, b].argmax() == mine
            margin = jl[first, b, pick] - jl[first, b, mine]
            bound = 2 * (diff[first, b, pick] + diff[first, b, mine])
            assert margin <= bound, (
                f"lane {b} leaves the reference's tokens at step {first}, "
                f"where no near tie explains it: margin {margin:.4f}")
    assert sum(firsts) >= toks.shape[0] * STEPS // 2, firsts
    jl32, _ = fp32.teacher_forced(toks, want)
    noise = np.abs(jl - jl32).max(axis=-1)
    assert (diff.max(axis=-1) <= 4 * noise).all(), (diff.max(-1), noise)


def test_int8_copy_quantizes_the_attention_only(fp32):
    """The int8 copy's quantized leaves are exactly ``wqkv`` and ``wo``,
    bitwise the reference's pass (q and the column scales); the MoE (router
    and experts) and the norms are shared, and the reference leaves its
    experts float too."""
    jq = fp32.jm.quantize_params_for_serving(fp32.jparams)["groups"]["b0"]
    q = fp32.tm.quantize_params_for_serving()
    for layer, blk in enumerate(q.blocks):
        for name in ("wqkv", "wo"):
            got, want = getattr(blk.attn, name), jq["attn"][name]
            assert isinstance(got, QuantizedWeight)
            assert isinstance(want, JQuantizedWeight)
            np.testing.assert_array_equal(got.q.numpy(),
                                          np.asarray(want.q[layer]))
            np.testing.assert_array_equal(
                got.scale.numpy().reshape(-1),
                np.asarray(want.scale[layer]).reshape(-1))
        assert blk.ffn is fp32.tm.blocks[layer].ffn
        assert blk.ln2 is fp32.tm.blocks[layer].ln2
    assert {n for n, m in q.named_modules()
            if isinstance(m, QuantizedWeight)} == {
        f"blocks.{i}.attn.{w}" for i in range(fp32.cfg.n_layers)
        for w in ("wqkv", "wo")}
    assert not any(isinstance(v, JQuantizedWeight)
                   for v in jq["ffn"].values())


def test_launcher_serves_the_smoke_config(capsys):
    """``launch.serve --arch grok-1-314b --smoke --device cpu``: the fixed
    loop, ``--requests`` (the scheduler) and ``--int8``."""
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "20", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "grok-1-314b-smoke on cpu" in out and "lane 1: ok" in out
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                 "2"])
    assert "request 1:" in capsys.readouterr().out
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "20", "--max-new", "3", "--int8"])
    out = capsys.readouterr().out
    assert "grok-1-314b-smoke int8 on cpu" in out and "lane 1: ok" in out
