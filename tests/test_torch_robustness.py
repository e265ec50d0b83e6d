"""The robustness layer in the port against the JAX reference, on the CPU:
fault plans (non-finite and overscaled logits, host stalls, transient
failures), the retry wrapper, admission control and the config checks,
the port's counterparts of ``tests/test_robustness.py``'s serving drills.

Both engines serve the internlm2-1.8b smoke config at fp32 compute with
the reference's ``init_params(0)`` weights (``convert.from_jax_params``),
and every drill's statuses, ``fault_step``, ``n_steps``, ``timed_out``
and tokens must be the reference's same call's, through the
``generate_with_status`` shim over the scheduler and, where the drill
applies to it, through the fixed loop (``generate_with_status_fixed``).
Greedy picks, so tokens are held exactly.  The reference's two HLO tests
(the decode trace identical with guards on and off, the guarded int8
trace's invariants) have no counterpart: the port has no traced program
to audit (ROADMAP queue A, the static audit).
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
from repro.robust import FaultPlan as JFaultPlan
from repro.robust import LogitFault as JLogitFault
from repro.robust import StallFault as JStallFault
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine

import repro_torch.robust as robust
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models.lm import Model
from repro_torch.robust import (STATUS_DEGRADED, STATUS_NONFINITE, STATUS_OK,
                                STATUS_SHED, STATUS_TIMEOUT, FaultPlan,
                                LogitFault, NumericalHealthError, StallFault,
                                TransientServeError, generate_with_retry)
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

ARCH = "internlm2-1.8b"
PROMPT = 16
NEW = 6
PATHS = ["shim", "fixed"]


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


def _prompt(b=3):
    return (np.arange(b * PROMPT, dtype=np.int32).reshape(b, PROMPT)
            % _build()[2].cfg.vocab)


def _quiet(cls, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return cls(**kw)


@functools.lru_cache(maxsize=None)
def _engines(**kw):
    """The reference's and the port's engines of one config, built once."""
    jm, params, tm = _build()
    kw = dict(dict(max_new_tokens=NEW), **kw)
    return (JServeEngine(jm, params, _quiet(JServeConfig, **kw)),
            ServeEngine(tm, _quiet(ServeConfig, **kw)))


def _jplan(plan):
    """The reference's FaultPlan of the same faults."""
    if plan is None:
        return None
    return JFaultPlan(
        seed=plan.seed, enabled=plan.enabled,
        fail_first_generates=plan.fail_first_generates,
        logit_faults=tuple(JLogitFault(step=f.step, lanes=f.lanes,
                                       kind=f.kind, scale=f.scale)
                           for f in plan.logit_faults),
        stalls=tuple(JStallFault(step=f.step, seconds=f.seconds)
                     for f in plan.stalls))


def _call(eng, path, toks, plan=None):
    fn = (eng.generate_with_status if path == "shim"
          else eng.generate_with_status_fixed)
    return fn({"tokens": toks}, fault_plan=plan)


def _both(path, b=3, plan=None, **kw):
    """(port result, reference result) of one call with one fault plan
    (each side its own copy, so attempt counts do not mix)."""
    jeng, teng = _engines(**kw)
    toks = _prompt(b)
    want = _call(jeng, path, jnp.asarray(toks), _jplan(plan))
    got = _call(teng, path, torch.from_numpy(toks),
                None if plan is None else dataclasses.replace(plan))
    _same(got, want)
    return got, want


def _same(got, want):
    assert got.status == list(want.status)
    assert got.timed_out == want.timed_out
    assert got.n_steps == want.n_steps
    assert got.admitted == want.admitted
    np.testing.assert_array_equal(got.fault_step, want.fault_step)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


# ---------------------------------------------------------------------------
# no plan, or a disabled one: nothing changes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
def test_guards_on_equals_guards_off_bitwise(path):
    on, _ = _both(path)
    off, _ = _both(path, guards=False)
    np.testing.assert_array_equal(on.tokens, off.tokens)
    assert on.ok and off.ok


@pytest.mark.parametrize("path", PATHS)
def test_disabled_fault_plan_is_inert(path):
    """``FaultPlan(enabled=False)`` full of faults changes no bit."""
    plan = FaultPlan(enabled=False,
                     logit_faults=(LogitFault(step=1, lanes=(0,)),),
                     stalls=(StallFault(step=0, seconds=100.0),),
                     fail_first_generates=5)
    base, _ = _both(path)
    got, _ = _both(path, plan=plan)
    np.testing.assert_array_equal(got.tokens, base.tokens)
    assert got.status == [STATUS_OK] * 3 and got.ok


# ---------------------------------------------------------------------------
# non-finite logits: per-lane quarantine, peers bitwise unchanged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kind", ["nan", "inf", "ninf"])
def test_nonfinite_lane_quarantined_peers_unchanged(kind, path):
    base, _ = _both(path)
    got, _ = _both(path, plan=FaultPlan(logit_faults=(
        LogitFault(step=2, lanes=(1,), kind=kind),)))
    assert got.status[1] == STATUS_NONFINITE and got.fault_step[1] == 2
    assert list(got.lanes_with(STATUS_NONFINITE)) == [1]
    # the poisoned lane keeps its tokens before the fault, pad after
    np.testing.assert_array_equal(got.tokens[1, :2], base.tokens[1, :2])
    assert np.all(got.tokens[1, 2:] == 0)
    np.testing.assert_array_equal(got.tokens[[0, 2]], base.tokens[[0, 2]])
    assert got.status[0] == got.status[2] == STATUS_OK


@pytest.mark.parametrize("path", PATHS)
def test_nonfinite_at_step_zero_hits_prefill_logits(path):
    got, _ = _both(path, plan=FaultPlan(logit_faults=(
        LogitFault(step=0, lanes=(0,)),)))
    assert got.status[0] == STATUS_NONFINITE and got.fault_step[0] == 0
    assert np.all(got.tokens[0] == 0) and got.status[1] == STATUS_OK


@pytest.mark.parametrize("path", PATHS)
def test_on_nonfinite_raise_is_fail_stop(path):
    plan = FaultPlan(logit_faults=(LogitFault(step=1, lanes=(2,)),))
    jeng, teng = _engines(on_nonfinite="raise")
    with pytest.raises(Exception, match=r"step 1.*\[2\]"):
        _call(jeng, path, jnp.asarray(_prompt()), _jplan(plan))
    with pytest.raises(NumericalHealthError, match=r"step 1.*\[2\]"):
        _call(teng, path, torch.from_numpy(_prompt()), plan)


@pytest.mark.parametrize("path", PATHS)
def test_on_nonfinite_off_restores_prehardening_behavior(path):
    got, _ = _both(path, on_nonfinite="off", plan=FaultPlan(logit_faults=(
        LogitFault(step=1, lanes=(0,)),)))
    assert got.status == [STATUS_OK] * 3


# ---------------------------------------------------------------------------
# int8 saturation: degradation to the float model
# ---------------------------------------------------------------------------

def test_saturation_degrades_lane_to_fp32():
    int8 = dict(int8=True, fp32_fallback=True)
    base, _ = _both("shim", b=2, **int8)
    assert base.ok
    got, _ = _both("shim", b=2, plan=FaultPlan(logit_faults=(
        LogitFault(step=2, lanes=(0,), kind="scale", scale=100.0),)), **int8)
    assert got.status[0] == STATUS_DEGRADED and got.fault_step[0] == 2
    assert got.status[1] == STATUS_OK and got.n_steps == NEW
    v = _build()[2].cfg.vocab
    assert np.all((got.tokens[0] >= 0) & (got.tokens[0] < v))
    # a positive scale leaves the greedy pick of the fault step as it was
    np.testing.assert_array_equal(got.tokens[0, :3], base.tokens[0, :3])
    # after the trip the lane's tokens are the float engine's
    fp, _ = _both("shim", b=2)
    np.testing.assert_array_equal(got.tokens[0, 3:], fp.tokens[0, 3:])
    np.testing.assert_array_equal(got.tokens[1], base.tokens[1])


@pytest.mark.parametrize("path", PATHS)
def test_saturation_without_fallback_still_reports(path):
    got, _ = _both(path, b=2, int8=True, plan=FaultPlan(logit_faults=(
        LogitFault(step=1, lanes=(1,), kind="scale", scale=100.0),)))
    assert got.status[1] == STATUS_DEGRADED and got.fault_step[1] == 1
    assert got.status[0] == STATUS_OK and got.n_steps == NEW


# ---------------------------------------------------------------------------
# wall-clock budget, admission control
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
def test_stalled_host_step_becomes_structured_timeout(path):
    """A stall past the budget at step 2 times out both lanes there (a
    budget of 1.5 s, not the reference test's 0.25 s: the port's CPU
    prefill and first steps must stay inside it on a loaded host)."""
    kw = dict(request_timeout_s=1.5)
    jeng, teng = _engines(**kw)
    toks = _prompt(2)
    _call(jeng, path, jnp.asarray(toks))          # warm the reference's jits
    got, want = _both(path, b=2, plan=FaultPlan(stalls=(
        StallFault(step=2, seconds=2.0),)), **kw)
    assert got.timed_out
    assert got.status == [STATUS_TIMEOUT] * 2
    assert list(got.fault_step) == [2, 2] and got.n_steps == 2
    base, _ = _both(path, b=2, **kw)
    np.testing.assert_array_equal(got.tokens, base.tokens[:, :2])


@pytest.mark.parametrize("path", PATHS)
def test_admission_control_sheds_surplus_lanes(path):
    got, _ = _both(path, b=4, max_lanes=2)
    assert got.admitted == 2
    assert got.status == [STATUS_OK, STATUS_OK, STATUS_SHED, STATUS_SHED]
    assert np.all(got.tokens[2:] == 0)
    teng = _engines(max_lanes=2)[1]
    small = _call(teng, path, torch.from_numpy(_prompt(2)))
    np.testing.assert_array_equal(got.tokens[:2], small.tokens)


def test_stall_fires_once_per_drain_under_churn():
    """The scheduler's stall hook: a StallFault fires once per drain, at
    the first iteration in which any live lane reaches its step, and the
    shim's reset replays it on the next call."""
    teng = _engines()[1]
    slept = []
    plan = FaultPlan(stalls=(StallFault(step=1, seconds=0.0),))
    fired = set()
    plan.maybe_stall_lanes(np.array([1, 1, -1]), fired, sleep=slept.append)
    plan.maybe_stall_lanes(np.array([2, 1, 1]), fired, sleep=slept.append)
    assert slept == [0.0] and fired == {0}
    for _ in range(2):
        got = teng.generate_with_status({"tokens": torch.from_numpy(
            _prompt())}, fault_plan=plan)
        assert got.ok and not got.timed_out


# ---------------------------------------------------------------------------
# retry with backoff
# ---------------------------------------------------------------------------

def test_retry_absorbs_transients_with_exponential_backoff():
    teng = _engines()[1]
    slept = []
    got = generate_with_retry(teng, {"tokens": torch.from_numpy(_prompt())},
                              retries=2, backoff_s=0.01,
                              fault_plan=FaultPlan(fail_first_generates=2),
                              sleep=slept.append)
    assert got.ok and got.n_steps == NEW
    assert slept == [0.01, 0.02]
    _same(got, _engines()[0].generate_with_status(
        {"tokens": jnp.asarray(_prompt())}))


def test_retry_budget_exhausted_reraises():
    teng = _engines()[1]
    slept = []
    with pytest.raises(TransientServeError):
        generate_with_retry(teng, {"tokens": torch.from_numpy(_prompt())},
                            retries=1, backoff_s=0.01,
                            fault_plan=FaultPlan(fail_first_generates=3),
                            sleep=slept.append)
    assert slept == [0.01]


def test_retry_does_not_absorb_hard_failures():
    teng = _engines(on_nonfinite="raise")[1]
    slept = []
    with pytest.raises(NumericalHealthError):
        generate_with_retry(teng, {"tokens": torch.from_numpy(_prompt())},
                            retries=5, fault_plan=FaultPlan(logit_faults=(
                                LogitFault(step=0, lanes=(0,)),)),
                            sleep=slept.append)
    assert slept == []


def test_retry_parameter_validation():
    teng = _engines()[1]
    batch = {"tokens": torch.from_numpy(_prompt())}
    with pytest.raises(ValueError, match="retries"):
        generate_with_retry(teng, batch, retries=-1)
    with pytest.raises(ValueError, match="backoff_s"):
        generate_with_retry(teng, batch, backoff_s=-0.1)


# ---------------------------------------------------------------------------
# config and fault-plan validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,match", [
    (dict(max_new_tokens=0), "max_new_tokens"),
    (dict(temperature=-0.5), "temperature"),
    (dict(temperature=float("nan")), "temperature"),
    (dict(eos_id=-1), "eos_id"),
    (dict(pad_id=-2), "pad_id"),
    (dict(on_nonfinite="explode"), "on_nonfinite"),
    (dict(logits_dtype="float999"), "logits_dtype"),
    (dict(logits_dtype="int8"), "float dtype"),
    (dict(max_lanes=0), "max_lanes"),
    (dict(request_timeout_s=0.0), "request_timeout_s"),
    (dict(saturation_threshold=0.0), "saturation_threshold"),
    (dict(saturation_threshold=1.5), "saturation_threshold"),
    (dict(fp32_fallback=True), "fp32_fallback"),
])
def test_serve_config_rejects_bad_values(kwargs, match):
    with pytest.raises(ValueError, match=match):
        _quiet(ServeConfig, **kwargs)


def test_logit_fault_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown logit-fault kind"):
        LogitFault(step=0, lanes=(0,), kind="garbage")


def test_fault_plan_hooks_are_deterministic_and_cheap():
    plan = FaultPlan(stalls=(StallFault(step=3, seconds=7.5),),
                     logit_faults=(LogitFault(step=1, lanes=(1,),
                                              kind="scale", scale=2.0),))
    slept = []
    plan.maybe_stall(0, sleep=slept.append)
    plan.maybe_stall(3, sleep=slept.append)
    assert slept == [7.5]
    # a miss returns the same object (copy-on-write), a hit a new tensor
    x = torch.ones((2, 4))
    assert plan.perturb_logits(0, x) is x
    y = plan.perturb_logits(1, x)
    assert y is not x and torch.equal(x, torch.ones((2, 4)))
    assert y[1].tolist() == [2.0] * 4 and y[0].tolist() == [1.0] * 4
    assert plan.perturb_logits_lanes(np.array([1, 0]), x) is x


def test_robust_exports_the_reference_names():
    import repro.robust as jrobust
    assert sorted(robust.__all__) == sorted(jrobust.__all__)
    assert all(hasattr(robust, name) for name in robust.__all__)
