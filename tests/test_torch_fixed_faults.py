"""The fixed-batch loop's guards in the port against the JAX reference, on
the CPU: the wall-clock budget (``request_timeout_s``) and the int8
saturation probe with its fp32 fallback.

Both engines serve the internlm2-1.8b smoke config at fp32 compute with
the reference's ``init_params(0)`` weights (``convert.from_jax_params``)
and the batch ``arange(16)`` as 2 x 8 tokens, and each call's statuses,
``timed_out``, ``n_steps``, ``fault_step`` and tokens must be the
reference's.  Within the port, a lane that stays healthy emits bitwise the
tokens it emits without ``fp32_fallback``: the float step runs before the
int8 step on the same dense cache, and the int8 step overwrites the K/V
slot the float step wrote.
"""
import dataclasses
import functools
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.mesh import make_mesh
from repro.models.lm import Model as JaxModel
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models.lm import Model
from repro_torch.robust.guards import (STATUS_DEGRADED, STATUS_OK,
                                       STATUS_TIMEOUT)
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

ARCH = "internlm2-1.8b"
TOKENS = np.arange(16, dtype=np.int32).reshape(2, 8)


def _params(vary: bool):
    """The reference's init, or (``vary``) with norm scales from a numpy
    seed and block weights tripled, as in ``test_torch_paged.py``, so that
    greedy tokens change from step to step."""
    jm = JaxModel(dataclasses.replace(jax_config(ARCH, smoke=True),
                                      compute_dtype="float32"),
                  make_mesh(1, 1))
    params = jax.tree.map(np.asarray, jm.init_params(0))
    if vary:
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
    return jm, params


@functools.lru_cache(maxsize=None)
def _build(vary: bool):
    jm, params = _params(vary)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               compute_dtype="float32")
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(from_jax_params(tcfg, params))
    return jm, jax.tree.map(jnp.asarray, params), tm


@pytest.fixture(params=[False, True], ids=["init", "varied"])
def models(request):
    return _build(request.param)


@pytest.fixture
def init_models():
    return _build(False)


@pytest.fixture
def varied_models():
    return _build(True)


def _port(tm, toks=TOKENS, **kw):
    return ServeEngine(tm, ServeConfig(**kw)).generate_with_status_fixed(
        {"tokens": torch.from_numpy(toks)})


def _reference(jm, params, toks=TOKENS, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = JServeEngine(jm, params, JServeConfig(**kw))
    return eng.generate_with_status_fixed({"tokens": jnp.asarray(toks)})


def _same(got, want):
    assert got.status == list(want.status)
    assert got.timed_out == want.timed_out
    assert got.n_steps == want.n_steps
    np.testing.assert_array_equal(got.fault_step, want.fault_step)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert got.admitted == want.admitted


# ---------------------------------------------------------------------------
# C1: the wall-clock budget
# ---------------------------------------------------------------------------

def test_timeout_matches_reference(init_models):
    jm, params, tm = init_models
    kw = dict(max_new_tokens=6, request_timeout_s=1e-9)
    got, want = _port(tm, **kw), _reference(jm, params, **kw)
    _same(got, want)
    assert got.status == [STATUS_TIMEOUT] * 2 and got.timed_out
    assert got.n_steps == 0 and got.fault_step.tolist() == [0, 0]
    assert got.tokens.shape == (2, 0)


def test_timeout_clock_starts_after_prefill(init_models, monkeypatch):
    """A slow prefill does not count against the budget."""
    tm = init_models[2]
    real = tm.prefill

    def slow(*a, **kw):
        out = real(*a, **kw)
        time.sleep(1.5)
        return out

    monkeypatch.setattr(tm, "prefill", slow)
    got = _port(tm, max_new_tokens=4, request_timeout_s=1.0)
    assert got.status == [STATUS_OK] * 2 and not got.timed_out
    assert got.n_steps == 4


def test_timeout_mid_loop_keeps_the_tokens_before_it(init_models,
                                                     monkeypatch):
    """A budget that runs out during the loop times out the running lanes
    at the next step's top: the tokens picked before stay, the later
    steps never run."""
    tm = init_models[2]
    want = _port(tm, max_new_tokens=6)
    real = tm.decode_step

    def slow(*a, **kw):
        time.sleep(0.6)
        return real(*a, **kw)

    monkeypatch.setattr(tm, "decode_step", slow)
    got = _port(tm, max_new_tokens=6, request_timeout_s=1.0)
    assert got.status == [STATUS_TIMEOUT] * 2 and got.timed_out
    assert got.n_steps == 2 and got.fault_step.tolist() == [2, 2]
    np.testing.assert_array_equal(got.tokens, want.tokens[:, :2])


# ---------------------------------------------------------------------------
# C2: the int8 saturation probe and the fp32 fallback
# ---------------------------------------------------------------------------

def test_saturation_degrades_like_reference(init_models):
    jm, params, tm = init_models
    kw = dict(max_new_tokens=8, int8=True, saturation_threshold=1e-6)
    got, want = _port(tm, **kw), _reference(jm, params, **kw)
    _same(got, want)
    assert got.status == [STATUS_DEGRADED] * 2
    assert got.fault_step.tolist() == [1, 1]


@pytest.mark.parametrize("threshold", [1e-6, 0.25])
def test_fixed_int8_guards_match_reference(models, threshold):
    """Statuses, fault steps and tokens of the int8 fixed loop, with and
    without the fallback, at a threshold that degrades and at the
    default."""
    jm, params, tm = models
    for fallback in (False, True):
        kw = dict(max_new_tokens=8, int8=True,
                  saturation_threshold=threshold, fp32_fallback=fallback)
        _same(_port(tm, **kw), _reference(jm, params, **kw))


def test_degraded_lanes_pick_from_the_float_model(models, monkeypatch):
    """Under fp32_fallback every decode step after the first degradation
    runs the float model on the same cache, and a degraded lane's token
    at each later step is the greedy pick of those float logits."""
    tm = models[2]
    fp_logits = []
    real = tm.decode_step

    def spy(cache, token, pos):
        logits, cache = real(cache, token, pos)
        fp_logits.append((pos, logits.clone()))
        return logits, cache

    monkeypatch.setattr(tm, "decode_step", spy)
    got = _port(tm, max_new_tokens=8, int8=True, saturation_threshold=1e-6,
                fp32_fallback=True)
    degraded = [i for i, s in enumerate(got.status) if s == STATUS_DEGRADED]
    assert degraded
    first = int(got.fault_step[degraded].min())
    assert [p for p, _ in fp_logits] == [TOKENS.shape[1] + i for i in
                                         range(first, got.n_steps - 1)]
    vocab = tm.cfg.vocab
    for pos, logits in fp_logits:
        step = pos - TOKENS.shape[1] + 1
        for lane in degraded:
            if step > got.fault_step[lane]:
                assert got.tokens[lane, step] == int(
                    torch.argmax(logits[lane, :vocab]))


def _int8_run(tm, monkeypatch, **kw):
    """The int8 fixed loop with every int8 decode step's logits kept."""
    eng = ServeEngine(tm, ServeConfig(max_new_tokens=8, int8=True, **kw))
    logits = []
    real = eng.model.decode_step

    def spy(cache, token, pos):
        out, cache = real(cache, token, pos)
        logits.append(out.clone())
        return out, cache

    monkeypatch.setattr(eng.model, "decode_step", spy)
    res = eng.generate_with_status_fixed({"tokens": torch.from_numpy(TOKENS)})
    return res, torch.stack(logits)


def test_healthy_lanes_bitwise_without_the_fallback(varied_models,
                                                   monkeypatch):
    """A lane that stays ok emits bitwise the tokens, and its int8 steps
    the logits, of a run without fp32_fallback, beside a degraded lane
    whose steps run the float model too (which writes the same cache
    slot first); with no lane degraded the float model never runs."""
    tm = varied_models[2]
    with_fb, fb_logits = _int8_run(tm, monkeypatch, fp32_fallback=True,
                                   saturation_threshold=0.01)
    without, logits = _int8_run(tm, monkeypatch, saturation_threshold=0.01)
    assert with_fb.status == without.status == [STATUS_DEGRADED, STATUS_OK]
    np.testing.assert_array_equal(with_fb.tokens[1], without.tokens[1])
    assert torch.equal(fb_logits[:, 1], logits[:, 1])
    calls = []
    real = tm.decode_step
    monkeypatch.setattr(tm, "decode_step",
                        lambda *a: calls.append(1) or real(*a))
    healthy = _port(tm, max_new_tokens=8, int8=True, fp32_fallback=True)
    assert healthy.status == [STATUS_OK] * 2 and not calls
    np.testing.assert_array_equal(
        healthy.tokens, _port(tm, max_new_tokens=8, int8=True).tokens)
