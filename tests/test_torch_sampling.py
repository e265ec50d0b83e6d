"""Sampled picks in the port against the JAX reference, on the CPU.

``serve.sampling`` computes the parts of ``jax.random`` the reference's
serving calls in torch: keys (``PRNGKey``, ``fold_in``, ``split``), the
threefry words and the uniforms are held bitwise to the installed jax.
The gumbel noise takes two ``log``s, whose last bit may differ between
XLA's and torch's implementations: it is held within one ulp of
``max(|g|, 1)``.  So ``categorical`` picks, and the engines' sampled
tokens, must be equal, a flip allowed only at a near tie that the test
recomputes from the reference's own scores (its logits over the
temperature plus its gumbel noise): the reference's score for its pick may
exceed its score for the port's pick by at most ``TIE_TOL``.  Where a
lane's tokens part, it is compared no further, and at least three in four
tokens must be compared equal.

Slice level: the internlm2-1.8b smoke config at fp32 compute with the
reference's ``init_params(0)`` (``convert.from_jax_params``) through the
fixed loop, the ``generate`` shim and the scheduler with per-request
sampling, beside the port's own counterparts of the reference's scheduler
tests of sampled requests and of the deprecated ``ServeConfig`` sampling
fields.
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
from repro.launch.mesh import make_mesh
from repro.models.lm import Model as JaxModel
from repro.serve.api import Request as JRequest
from repro.serve.api import SamplingParams as JSamplingParams
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models.lm import Model
from repro_torch.robust.guards import STATUS_OK
from repro_torch.serve import sampling
from repro_torch.serve.api import Request, SamplingParams
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

ARCH = "internlm2-1.8b"
PROMPT = 16
NEW = 6
TIE_TOL = 1e-4
SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 40 + 3, -5]
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16,
      "float16": torch.float16}
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
      "float16": jnp.float16}
_GEOM = dict(n_lanes=3, page_size=8, prefill_chunk=8, max_seq_len=64)


def _k(seed):
    return sampling.key_tensor(np.asarray(jax.random.PRNGKey(seed)))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ---------------------------------------------------------------------------
# keys, words, uniforms, gumbel, categorical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    got = sampling.prng_key(seed)
    assert got.dtype == np.uint32 and np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_split_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    steps = np.array([0, 1, 7, 31, 2 ** 31 - 1, -1], np.int32)
    want = np.asarray(jax.vmap(jax.random.fold_in, (None, 0))(
        key, jnp.asarray(steps)))
    got = sampling.fold_in(_k(seed).expand(len(steps), 2),
                           torch.from_numpy(steps))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    got_split = sampling.split(_k(seed), 3).numpy()
    assert np.array_equal(got_split,
                          np.asarray(jax.random.split(key, 3), np.int64))


@pytest.mark.parametrize("width", [32, 16, 8])
@pytest.mark.parametrize("shape", [(1000,), (3, 777)], ids=["v", "Bv"])
def test_random_bits_match_jax(shape, width):
    key = jax.random.PRNGKey(11)
    dt = {32: jnp.uint32, 16: jnp.uint16, 8: jnp.uint8}[width]
    want = np.asarray(jax.random.bits(key, shape, dt), np.int64)
    assert np.array_equal(sampling.random_bits(_k(11), shape, width).numpy(),
                          want)


def test_random_bits_per_lane_keys_match_vmap():
    """The scheduler's draw: one [v] row per lane from its folded key,
    which is not the [B, v] draw of one key."""
    base = jnp.stack([jax.random.PRNGKey(s) for s in (3, 11, 3)])
    steps = jnp.asarray([0, 4, 5], jnp.int32)
    keys = jax.vmap(jax.random.fold_in)(base, steps)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (700,)))(keys),
                      np.int64)
    tk = sampling.fold_in(sampling.key_tensor(np.asarray(base)),
                          torch.from_numpy(np.asarray(steps)))
    got = sampling.random_bits(tk, (700,), 32).numpy()
    assert np.array_equal(got, want)
    assert not np.array_equal(
        got, sampling.random_bits(tk[0], (3, 700), 32).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_uniform_matches_jax_bitwise(dtype):
    tiny = float(jnp.finfo(_J[dtype]).tiny)
    for lo in (0.0, tiny):
        want = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(5), (4, 999), _J[dtype], minval=lo,
            maxval=1.0).astype(jnp.float32))
        got = sampling.uniform(_k(5), (4, 999), _T[dtype], minval=lo)
        assert got.dtype == _T[dtype]
        assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gumbel_within_one_ulp(dtype):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(9), (8, 4096),
                                        _J[dtype]).astype(jnp.float32))
    got = _np(sampling.gumbel(_k(9), (8, 4096), _T[dtype]))
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    if dtype == "bfloat16":
        ulp = ulp * 2.0 ** 16
    assert np.all(np.abs(got - want) <= ulp)


def _near_tie(scores: np.ndarray, want: int, got: int) -> None:
    """The rule every token comparison takes where the port's pick is not
    the reference's: the reference's scores for the two picks tie within
    ``TIE_TOL``."""
    assert scores[want] - scores[got] <= TIE_TOL, (want, got,
                                                   scores[want] - scores[got])


@pytest.mark.parametrize("temp", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("per_lane", [False, True], ids=["one_key",
                                                         "lane_keys"])
def test_categorical_tokens_match_jax(temp, per_lane):
    """64 rows of a 4096-way draw at three temperatures, one key for all
    rows (the fixed loop's draw) or a folded key a row (the scheduler's)."""
    rng = np.random.default_rng(int(temp * 10) + per_lane)
    logits = (3.0 * rng.standard_normal((64, 4096))).astype(np.float32)
    scaled = logits / np.float32(temp)
    if per_lane:
        base = np.asarray(jax.random.PRNGKey(17))
        steps = np.arange(64, dtype=np.int32)
        keys = jax.vmap(jax.random.fold_in, (None, 0))(base, steps)
        want = np.asarray(jax.vmap(jax.random.categorical)(
            keys, jnp.asarray(scaled)))
        noise = np.asarray(jax.vmap(
            lambda k: jax.random.gumbel(k, (4096,)))(keys))
        tkeys = sampling.fold_in(_k(17).expand(64, 2),
                                 torch.from_numpy(steps))
    else:
        key = jax.random.PRNGKey(17)
        want = np.asarray(jax.random.categorical(key, jnp.asarray(scaled)))
        noise = np.asarray(jax.random.gumbel(key, (64, 4096)))
        tkeys = _k(17)
    got = sampling.categorical(tkeys, torch.from_numpy(scaled)).numpy()
    scores = scaled.astype(np.float64) + noise
    for r in np.flatnonzero(got != want):
        _near_tie(scores[r], want[r], got[r])
    assert np.mean(got == want) >= 0.75
    assert len(set(got.tolist())) > 32


# ---------------------------------------------------------------------------
# the engines against the reference's same calls
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _build():
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True),
                               compute_dtype="float32")
    jm = JaxModel(jcfg, make_mesh(1, 1))
    params = jax.tree.map(np.asarray, jm.init_params(0))
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               compute_dtype="float32")
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(from_jax_params(tcfg, params))
    return jm, jax.tree.map(jnp.asarray, params), tm


def _quiet(cls, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return cls(**kw)


def _ref_logits(jm, params, prompt: np.ndarray) -> np.ndarray:
    """The reference's last-position logits over the real vocab for each
    row of ``prompt`` (a full prefill: the teacher-forced recompute of a
    step)."""
    logits, _ = jm.prefill(params, {"tokens": jnp.asarray(prompt)},
                           max_len=prompt.shape[1] + 1)
    return np.asarray(logits, np.float64)[:, :jm.cfg.vocab]


def _hold(got: np.ndarray, want: np.ndarray, scores_at) -> None:
    """Tokens ``got [B, n]`` against the reference's ``want``: equal up
    to each lane's first parting, which must be a near tie of
    ``scores_at(lane, step)``; at least three in four compared equal."""
    assert got.shape == want.shape
    equal = 0
    for b in range(got.shape[0]):
        part = np.flatnonzero(got[b] != want[b])
        k = int(part[0]) if part.size else got.shape[1]
        equal += k
        if k < got.shape[1]:
            _near_tie(scores_at(b, k), want[b, k], got[b, k])
    assert equal >= 0.75 * got.size


def _prompts(jm, b=3):
    return np.random.default_rng(4).integers(
        0, jm.cfg.vocab, (b, PROMPT)).astype(np.int32)


@pytest.mark.parametrize("guards", [True, False], ids=["guarded", "eager"])
def test_fixed_loop_sampled_tokens_match_reference(guards):
    """``generate_with_status_fixed`` at ``greedy=False``: one key
    ``PRNGKey(seed)`` over the [B, v] draw, split after every decode step
    (the reference's jitted guarded pick multiplies by the temperature's
    reciprocal, its eager one divides)."""
    jm, params, tm = _build()
    toks = _prompts(jm)
    kw = dict(max_new_tokens=NEW, greedy=False, temperature=0.7,
              guards=guards)
    jeng = JServeEngine(jm, params, _quiet(JServeConfig, **kw))
    want = np.asarray(jeng.generate_with_status_fixed(
        {"tokens": jnp.asarray(toks)}, seed=5).tokens)
    res = ServeEngine(tm, _quiet(ServeConfig, **kw)
                      ).generate_with_status_fixed(
        {"tokens": torch.from_numpy(toks)}, seed=5)
    assert res.status == [STATUS_OK] * 3

    def scores_at(b, k):
        key = jax.random.PRNGKey(5)
        pick = key
        for _ in range(k):
            key, pick = jax.random.split(key)
        seq = np.concatenate([toks, want[:, :k]], axis=1)
        logits = _ref_logits(jm, params, seq) / 0.7
        return logits[b] + np.asarray(
            jax.random.gumbel(pick, logits.shape), np.float64)[b]
    _hold(res.tokens, want, scores_at)
    assert len(set(res.tokens.reshape(-1).tolist())) > 3


def test_shim_sampled_tokens_match_reference():
    """``generate(batch, seed)`` over the scheduler: every row a request
    of the ServeConfig's sampling rooted at ``seed``, each lane drawing
    its own ``[v]`` from ``fold_in(PRNGKey(seed), step)``."""
    jm, params, tm = _build()
    toks = _prompts(jm)
    kw = dict(max_new_tokens=NEW, greedy=False, temperature=0.9)
    want = np.asarray(JServeEngine(jm, params, _quiet(JServeConfig, **kw))
                      .generate({"tokens": jnp.asarray(toks)}, seed=3))
    got = ServeEngine(tm, _quiet(ServeConfig, **kw)).generate(
        {"tokens": torch.from_numpy(toks)}, seed=3)

    def scores_at(b, k):
        seq = np.concatenate([toks, want[:, :k]], axis=1)
        noise = jax.random.gumbel(
            jax.random.fold_in(jax.random.PRNGKey(3), k), (jm.cfg.vocab,))
        return (_ref_logits(jm, params, seq)[b] / np.float32(0.9)
                + np.asarray(noise, np.float64))
    _hold(got, want, scores_at)
    # every lane shares the seed but not its draw: the rows part
    assert not np.array_equal(got[0], got[1])


def test_scheduler_sampled_requests_match_reference():
    """Mixed greedy and sampled requests (own seeds and temperatures)
    through ``submit``/``drain`` on three lanes, against the reference's
    scheduler."""
    jm, params, tm = _build()
    rng = np.random.default_rng(8)
    specs = [(21, 6, None), (13, 4, (0.8, 11)), (17, 6, (1.0, 2)),
             (9, 5, None), (26, 5, (0.6, 11))]
    prompts = [rng.integers(0, jm.cfg.vocab, n).astype(np.int32)
               for n, _, _ in specs]
    jeng = JServeEngine(jm, params, _quiet(JServeConfig, **_GEOM))
    teng = ServeEngine(tm, ServeConfig(**_GEOM))
    for i, (p, (_, new, samp)) in enumerate(zip(prompts, specs)):
        t, seed = samp if samp else (1.0, 0)
        kw = dict(greedy=samp is None, temperature=t, max_new_tokens=new)
        jeng.submit(JRequest(id=i, tokens=p, seed=seed,
                             sampling=JSamplingParams(**kw)))
        teng.submit(Request(id=i, tokens=p, seed=seed,
                            sampling=SamplingParams(**kw)))
    want = {o.id: o for o in jeng.drain()}
    got = {o.id: o for o in teng.drain()}
    assert set(got) == set(want) == set(range(len(specs)))
    for i, (p, (_, new, samp)) in enumerate(zip(prompts, specs)):
        assert got[i].status == want[i].status == STATUS_OK
        w = np.asarray(want[i].tokens)

        def scores_at(_, k, p=p, w=w, samp=samp):
            logits = _ref_logits(jm, params,
                                 np.concatenate([p, w[:k]])[None])[0]
            if samp is None:
                return logits
            t, seed = samp
            noise = jax.random.gumbel(
                jax.random.fold_in(jax.random.PRNGKey(seed), k),
                (jm.cfg.vocab,))
            return logits / np.float32(t) + np.asarray(noise, np.float64)
        _hold(got[i].tokens[None], w[None], scores_at)


# ---------------------------------------------------------------------------
# the port's counterparts of the reference's scheduler tests
# ---------------------------------------------------------------------------

def _req(vocab, rid, n=PROMPT, seed0=0, **kw):
    toks = (np.arange(seed0, seed0 + n) * 7 % vocab)
    return Request(id=rid, tokens=toks.astype(np.int32), **kw)


def test_per_request_sampling_params():
    tm = _build()[2]
    eng = ServeEngine(tm, ServeConfig(max_new_tokens=NEW, n_lanes=2,
                                      page_size=8, prefill_chunk=8,
                                      max_seq_len=64))
    v = tm.cfg.vocab
    samp = SamplingParams(greedy=False, temperature=0.8, max_new_tokens=5)
    eng.submit(_req(v, "short", sampling=SamplingParams(max_new_tokens=2)))
    eng.submit(_req(v, "samp", seed0=3, seed=11, sampling=samp))
    outs = {o.id: o for o in eng.drain()}
    assert outs["short"].tokens.shape == (2,)
    assert outs["samp"].tokens.shape == (5,)
    # the sampled request's stream is rooted at its seed: the same
    # submission replays bitwise though the lane mix changed
    eng.submit(_req(v, "samp2", seed0=3, seed=11, sampling=samp))
    (replay,) = eng.drain()
    np.testing.assert_array_equal(replay.tokens, outs["samp"].tokens)
    # another seed draws another stream
    eng.submit(_req(v, "samp3", seed0=3, seed=12, sampling=samp))
    (other,) = eng.drain()
    assert not np.array_equal(other.tokens, outs["samp"].tokens)


def test_request_tokens_bitwise_stable_under_churn():
    """A sampled request's tokens are the same alone and amid greedy and
    sampled neighbours admitting and retiring around it, on bf16 weights
    (random norm scales, tripled block weights, as the greedy test in
    ``test_torch_paged.py``)."""
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True),
                              param_dtype="bfloat16")
    tm = Model(cfg, device="cpu").init_weights(1)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if p.dim() == 1:
                p.copy_(0.5 * torch.randn(p.shape, generator=gen))
            elif name != "embed":
                p.mul_(3)
    eng = ServeEngine(tm, ServeConfig(max_new_tokens=NEW, **_GEOM))
    v = cfg.vocab
    probe = _req(v, "probe", seed0=7, seed=21, sampling=SamplingParams(
        greedy=False, temperature=0.9, max_new_tokens=12))
    eng.submit(probe)
    alone = {o.id: o for o in eng.drain()}["probe"]
    for i, (n, new) in enumerate([(11, 2), (23, 3), (5, 4), (17, 2)]):
        if i == 1:
            eng.submit(probe)
        eng.submit(_req(v, f"n{i}", n=n, seed0=i + 1, seed=i, sampling=
                        SamplingParams(greedy=i % 2 == 0, temperature=1.0,
                                       max_new_tokens=new)))
    churned = {o.id: o for o in eng.drain()}
    assert len(churned) == 5
    assert all(o.status == STATUS_OK for o in churned.values())
    np.testing.assert_array_equal(churned["probe"].tokens, alone.tokens)
    assert len(set(alone.tokens.tolist())) > 1


def test_greedy_only_picks_draw_nothing(monkeypatch):
    """A pick in which no lane samples calls no part of the sampler."""
    tm = _build()[2]
    calls = []

    def drew(*args):
        calls.append(args)
        raise AssertionError("a greedy pick drew from the sampler")
    monkeypatch.setattr(sampling, "threefry2x32", drew)
    eng = ServeEngine(tm, ServeConfig(max_new_tokens=3, **_GEOM))
    eng.submit(_req(tm.cfg.vocab, "g"))
    assert eng.drain()[0].status == STATUS_OK
    ServeEngine(tm, ServeConfig(max_new_tokens=3)).generate_with_status_fixed(
        {"tokens": torch.zeros((2, 8), dtype=torch.int64)})
    assert not calls


def test_serve_config_sampling_fields_warn_deprecated():
    for kw in (dict(max_new_tokens=7), dict(eos_id=3), dict(greedy=False),
               dict(temperature=0.5)):
        with pytest.warns(DeprecationWarning, match=next(iter(kw))):
            ServeConfig(**kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ServeConfig()                   # defaults: silent


def test_sampling_defaults_inherit_deprecated_fields():
    sp = _quiet(ServeConfig, max_new_tokens=9, greedy=False,
                temperature=0.7).sampling_defaults()
    assert sp == SamplingParams(greedy=False, temperature=0.7,
                                max_new_tokens=9, eos_id=None)
    with pytest.raises(ValueError, match="temperature"):
        _quiet(ServeConfig, temperature=-1.0)
