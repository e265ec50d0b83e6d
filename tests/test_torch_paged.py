"""Paged continuous batching in the port, against the JAX reference, on
the CPU: K6 (paged flash decode) as its plain version, the paged model
entry points, the scheduler and the engine.

K6 tolerances: against the reference's tiled mirror and its Pallas kernel
(interpret mode; one page per tile, ROADMAP F2) each bf16 output row is
within one (mirror) or two (Pallas, another tiling) bf16 ulps of its own
scale: the same fp32 softmax summed in another order, then one cast.
Within the port the claims are bitwise: a paged lane equals the same
history in a dense cache (page_size 16, so a 32-slot tile spans two
pages), an idle lane is exactly 0.0, and remapping a neighbour's pages
changes no bit of a lane.

Slice level: the same parameters (``convert.from_jax_params`` of the
reference's init, norm scales drawn from a numpy seed and block weights
tripled, as in ``test_torch_model.py``, so greedy tokens vary) serve the
same requests through the reference's ``ServeEngine`` and the port's, with
fp32 compute, float and int8 weights: every request gets the same greedy
tokens (with bf16 compute the int8 engine's tokens part from the
reference's where its bf16 rounding noise flips a near tie, so the token
test runs at fp32 compute).  The logits of ``prefill_chunk`` and
``decode_step_paged``, teacher-forced on the reference's tokens, agree
within 1e-4 of their scale with float weights (fp32 on both sides,
another summation order), within 1e-3 with int8 weights (the same
integer products; a one-ulp difference in a quantized activation's scale
or silu can move a value across a rounding boundary of the int8 grid,
one step of 1/127 of that row's absmax, which the next layers dilute),
and with bf16 compute within twice the reference's own bf16 noise.
"""
import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import flash_attention as jfa
from repro.launch.mesh import make_mesh
from repro.models import param as jpm
from repro.models.lm import Model as JaxModel
from repro.serve.api import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models.lm import Model
from repro_torch.robust.guards import (STATUS_DEGRADED, STATUS_NONFINITE,
                                       STATUS_OK, STATUS_SHED,
                                       STATUS_TIMEOUT)
from repro_torch.serve.api import Request, RequestOutput, SamplingParams
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.kv_cache import PageAllocator, PagedKVCache

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

BF16_EPS = float(torch.finfo(torch.bfloat16).eps)
ARCH = "internlm2-1.8b"
PROMPT = 16
NEW = 6


def _row_err(got: torch.Tensor, want) -> float:
    g = got.double().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = np.maximum(np.abs(w).max(-1), 1e-3)
    return float((np.abs(g - w).max(-1) / scale).max())


# ---------------------------------------------------------------------------
# K6: paged flash decode
# ---------------------------------------------------------------------------

def _paged_case(ps, s_q, seed=0, n_lanes=4, p_max=None, kv=2, g=2, hd=16):
    """Pools with shuffled pages, lanes at mixed positions, the last lane
    idle, unmapped (-1) pages past each lane's length."""
    rng = np.random.default_rng(seed)
    p_max = p_max or -(-64 // ps)
    n_pages = n_lanes * p_max
    bf = torch.bfloat16
    kp = torch.from_numpy(rng.standard_normal(
        (n_pages + 1, ps, kv, hd)).astype(np.float32)).to(bf)
    vp = torch.from_numpy(rng.standard_normal(
        (n_pages + 1, ps, kv, hd)).astype(np.float32)).to(bf)
    last = np.array([0, 37, p_max * ps - 1, -1])[:n_lanes]
    table = rng.permutation(n_pages).reshape(n_lanes, p_max).astype(np.int32)
    for l, p in enumerate(last):
        table[l, max(p, 0) // ps + 1:] = -1
    pos = last[:, None] - (s_q - 1) + np.arange(s_q)[None]
    pos = np.where((last[:, None] >= 0) & (pos >= 0), pos, -1)
    q = torch.from_numpy(rng.standard_normal(
        (n_lanes, s_q, kv, g, hd)).astype(np.float32)).to(bf)
    return (q, kp, vp, torch.from_numpy(table),
            torch.from_numpy(pos.astype(np.int32)))


def _jx(t: torch.Tensor):
    a = jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16
                    else t.numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


@pytest.mark.parametrize("s_q", [1, 5])
@pytest.mark.parametrize("ps", [8, 16, 64])
def test_k6_plain_matches_reference_mirror(ps, s_q):
    args = _paged_case(ps, s_q, seed=ps + s_q)
    got = ops.paged_flash_decode(*args)
    want = jfa.paged_flash_decode_xla(*(_jx(a) for a in args))
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    assert _row_err(got, want) <= BF16_EPS


def test_k6_within_budget_of_pallas_interpret():
    """The reference's Pallas kernel tiles one page per tile (F2): held
    within a budget, never bitwise."""
    args = _paged_case(16, 1, seed=3)
    got = ops.paged_flash_decode(*args)
    q, kp, vp, table, pos = (_jx(a) for a in args)
    want = jfa.paged_flash_decode_pallas(q, kp, vp, table, pos.reshape(-1),
                                         interpret=True)
    assert _row_err(got, want) <= 2 * BF16_EPS


@pytest.mark.parametrize("s_q", [1, 3])
def test_k6_paged_equals_dense_bitwise(s_q):
    """page_size 16: each 32-slot tile spans two pages, and a lane's
    output is bitwise the same history held in a dense cache."""
    q, kp, vp, table, pos = _paged_case(16, s_q, seed=11)
    got = ops.paged_flash_decode(q, kp, vp, table, pos)
    ps, p_max = kp.shape[1], table.shape[1]
    for lane in range(q.shape[0] - 1):          # the last lane is idle
        k_dense = torch.zeros((1, p_max * ps, *kp.shape[2:]), dtype=kp.dtype)
        v_dense = torch.zeros_like(k_dense)
        for page, phys in enumerate(table[lane].tolist()):
            if phys >= 0:
                k_dense[0, page * ps:(page + 1) * ps] = kp[phys]
                v_dense[0, page * ps:(page + 1) * ps] = vp[phys]
        for s in range(s_q):
            p = int(pos[lane, s])
            if p < 0:
                continue
            want = ops.flash_decode(q[lane:lane + 1, s:s + 1], k_dense,
                                    v_dense, p)
            assert torch.equal(got[lane:lane + 1, s:s + 1], want), (lane, s)


def test_k6_idle_lane_is_exact_zero():
    q, kp, vp, table, pos = _paged_case(16, 2, seed=5)
    kp[-1] = float("nan")                       # the trash page
    got = ops.paged_flash_decode(q, kp, vp, table, pos)
    assert (pos[-1] == -1).all()
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))


def test_k6_remapping_a_neighbour_changes_no_bit():
    q, kp, vp, table, pos = _paged_case(16, 1, seed=7)
    base = ops.paged_flash_decode(q, kp, vp, table, pos)
    # move lane 1's pages to fresh rows and scribble over the old ones
    kp2, vp2, table2 = kp.clone(), vp.clone(), table.clone()
    n = kp.shape[0] - 1
    free = sorted(set(range(n)) - set(table.flatten().tolist()))
    for i, old in enumerate([p for p in table[1].tolist() if p >= 0]):
        new = free[i]
        kp2[new], vp2[new] = kp[old], vp[old]
        kp2[old], vp2[old] = 9.0, -9.0
        table2[1, table[1].tolist().index(old)] = new
    got = ops.paged_flash_decode(q, kp2, vp2, table2, pos)
    assert torch.equal(got, base)


# ---------------------------------------------------------------------------
# slice level against the reference
# ---------------------------------------------------------------------------

def _models(arch, compute_dtype="float32"):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=compute_dtype)
    jm = JaxModel(jcfg, make_mesh(1, 1))
    params = jax.tree.map(np.asarray, jm.init_params(0))
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
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(from_jax_params(tcfg, params))
    return jm, jax.tree.map(jnp.asarray, params), tm


_GEOM = dict(n_lanes=3, page_size=8, prefill_chunk=8, max_seq_len=64)
_REQS = [(5, 6), (23, 4), (16, 6), (11, 3), (30, 5)]   # (prompt, max_new)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n).astype(np.int32) for n, _ in _REQS]


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "internlm2-1.8b"])
def test_engine_greedy_tokens_match_reference(arch, int8):
    jm, params, tm = _models(arch)
    prompts = _prompts(jm.cfg.vocab)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JServeEngine(jm, params, JServeConfig(int8=int8, **_GEOM))
    from repro.serve.api import SamplingParams as JSamplingParams
    for i, (p, (_, new)) in enumerate(zip(prompts, _REQS)):
        jeng.submit(JRequest(id=i, tokens=p, sampling=JSamplingParams(
            max_new_tokens=new)))
    want = {o.id: o for o in jeng.drain()}
    teng = ServeEngine(tm, ServeConfig(int8=int8, **_GEOM))
    for i, (p, (_, new)) in enumerate(zip(prompts, _REQS)):
        teng.submit(Request(id=i, tokens=p, sampling=SamplingParams(
            max_new_tokens=new)))
    got = {o.id: o for o in teng.drain()}
    assert set(got) == set(want) == set(range(len(_REQS)))
    for i in got:
        assert got[i].status == want[i].status == STATUS_OK
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
    assert len({t for o in got.values() for t in o.tokens.tolist()}) > 3


@pytest.mark.parametrize("arch,compute,int8", [
    ("granite-3-8b", "float32", False), ("granite-3-8b", "float32", True),
    ("internlm2-1.8b", "float32", False), ("internlm2-1.8b", "float32", True),
    ("granite-3-8b", "bfloat16", False), ("granite-3-8b", "bfloat16", True),
])
def test_paged_logits_match_reference(arch, compute, int8):
    """prefill_chunk over two chunks, then decode_step_paged, fed the
    reference's greedy tokens, on three lanes with the middle one idle.
    With bf16 compute the budget is the consistency rule of
    test_torch_model.py: twice the reference's own distance from its
    fp32-compute run on the same tokens."""
    jm, params, tm = _models(arch, compute)
    models = [jm]
    if compute != "float32":
        models.append(JaxModel(dataclasses.replace(
            jm.cfg, compute_dtype="float32"), jm.mesh))
    if int8:
        params = jm.quantize_params_for_serving(params)
        tm = tm.quantize_params_for_serving()
    ps, p_max, chunk, n_lanes = 8, 4, 8, 3
    n_pages = n_lanes * p_max
    jcaches = [jpm.initialize(jm.paged_cache_defs(n_pages, ps), 0)
               for _ in models]
    tcache = tm.new_paged_cache(n_pages, ps)
    table = np.array([[4, 0, 7, 2], [-1] * 4, [1, 11, 5, 9]], np.int32)
    toks = np.random.default_rng(5).integers(0, jm.cfg.vocab,
                                             (n_lanes, 2 * chunk))
    toks = toks.astype(np.int32)
    fns = [(jax.jit(m.prefill_chunk), jax.jit(m.decode_step_paged))
           for m in models]
    errs, noise = [], []

    def rel(got, want):   # the live lanes only: the idle row is garbage
        g = np.asarray(got, np.float64)[[0, 2]]
        w = np.asarray(want, np.float64)[[0, 2]]
        return float(np.abs(g - w).max() / max(1.0, np.abs(w).max()))

    def record(tl, jls):
        errs.append(rel(tl.double().numpy(), jls[0]))
        if len(jls) > 1:
            noise.append(rel(jls[0], jls[1]))
        return jls[0]

    for c in range(2):
        pos = np.where(np.arange(n_lanes)[:, None] == 1, -1,
                       c * chunk + np.arange(chunk)[None]).astype(np.int32)
        last = np.array([chunk - 1, -1, chunk - 1], np.int32)
        sl = toks[:, c * chunk:(c + 1) * chunk]
        jls = []
        for k, (j_chunk, _) in enumerate(fns):
            jl, jcaches[k] = j_chunk(params, jcaches[k], jnp.asarray(sl),
                                     jnp.asarray(pos), jnp.asarray(table),
                                     jnp.asarray(last))
            jls.append(jl)
        tl, _ = tm.prefill_chunk(tcache, torch.from_numpy(sl),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(table),
                                 torch.from_numpy(last))
        jl = record(tl, jls)
    for step in range(4):
        tok = np.asarray(jnp.argmax(jl[:, :jm.cfg.vocab], -1),
                         np.int32)[:, None]
        pos = np.array([2 * chunk + step, -1, 2 * chunk + step], np.int32)
        jls = []
        for k, (_, j_decode) in enumerate(fns):
            out, jcaches[k] = j_decode(params, jcaches[k], jnp.asarray(tok),
                                       jnp.asarray(pos), jnp.asarray(table))
            jls.append(out)
        tl, _ = tm.decode_step_paged(tcache, torch.from_numpy(tok.copy()),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(table))
        jl = record(tl, jls)
    if compute == "float32":
        assert max(errs) <= (1e-3 if int8 else 1e-4), errs
    else:
        assert max(errs) <= 2.0 * max(noise), (errs, noise)


# ---------------------------------------------------------------------------
# page allocator and kv-cache bookkeeping
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    return Model(get_config(ARCH, smoke=True), device="cpu").init_weights(0)


def _engine(model, **kw):
    geom = dict(max_new_tokens=NEW, n_lanes=3, page_size=8, prefill_chunk=8,
                max_seq_len=64)
    geom.update(kw)
    return ServeEngine(model, ServeConfig(**geom))


def _req(model, rid, n=PROMPT, seed0=0, **kw):
    toks = (np.arange(seed0, seed0 + n) * 7 % model.cfg.vocab)
    return Request(id=rid, tokens=toks.astype(np.int32), **kw)


def test_allocator_alloc_free_roundtrip():
    al = PageAllocator(4)
    a, b = al.alloc(2), al.alloc(2)
    assert sorted(a + b) == [0, 1, 2, 3]
    assert al.alloc(1) is None          # exhausted: None, not an exception
    al.free(a)
    assert al.n_free == 2 and sorted(al.alloc(2)) == sorted(a)


def test_allocator_handles_fragmented_free_list():
    al = PageAllocator(6)
    held = [al.alloc(1) for _ in range(6)]
    for h in (held[0], held[2], held[4]):
        al.free(h)
    assert sorted(al.alloc(3)) == sorted(held[0] + held[2] + held[4])


def test_allocator_rejects_double_and_unknown_free():
    al = PageAllocator(2)
    pages = al.alloc(1)
    al.free(pages)
    with pytest.raises(ValueError, match="double free"):
        al.free(pages)
    with pytest.raises(ValueError, match="unknown page"):
        al.free([99])


def test_allocator_validates_args():
    with pytest.raises(ValueError, match="n_pages"):
        PageAllocator(0)
    with pytest.raises(ValueError, match="alloc needs n >= 1"):
        PageAllocator(2).alloc(0)


def test_kv_cache_admit_release_recycles_pages(model):
    kv = PagedKVCache(model, n_lanes=2, n_pages=4, page_size=8,
                      pages_per_lane=2)
    assert kv.pools[0]["kp"].shape == (5, 8, model.cfg.n_kv_heads,
                                       model.cfg.hd)
    assert kv.admit(0, total_len=16)
    first = list(kv.lane_pages[0])
    assert (kv.table[0, :2] >= 0).all() and (kv.table[1] == -1).all()
    assert kv.table[0].tolist() == first
    kv.release(0)
    assert (kv.table[0] == -1).all()
    assert kv.admit(1, total_len=9)
    assert sorted(kv.lane_pages[1]) == sorted(first)


def test_kv_cache_table_device_reuploads_only_on_change(model):
    kv = PagedKVCache(model, n_lanes=2, n_pages=4, page_size=8,
                      pages_per_lane=2)
    t0 = kv.table_device()
    assert kv.table_device() is t0
    kv.admit(0, total_len=8)
    t1 = kv.table_device()
    assert t1 is not t0 and kv.table_device() is t1
    assert t1.tolist() == kv.table.tolist()


def test_kv_cache_fits_ever_bounds(model):
    kv = PagedKVCache(model, n_lanes=1, n_pages=100, page_size=8,
                      pages_per_lane=2)
    assert kv.fits_ever(16) and not kv.fits_ever(17)
    assert not kv.fits_ever(0) and not kv.fits_ever(-1)
    with pytest.raises(ValueError, match="total_len"):
        kv.pages_needed(0)


def test_admit_failure_modes_leave_pool_intact(model):
    kv = PagedKVCache(model, n_lanes=3, n_pages=4, page_size=8,
                      pages_per_lane=2)
    n0 = kv.allocator.n_free
    for total in (17, 0):
        with pytest.raises(ValueError, match="unservable"):
            kv.admit(0, total_len=total)
        assert kv.allocator.n_free == n0
    assert kv.admit(0, total_len=16) and kv.admit(1, total_len=9)
    assert kv.allocator.n_free == 0
    assert not kv.admit(2, total_len=8)
    assert kv.allocator.n_free == 0
    kv.release(0)
    kv.release(1)
    assert kv.allocator.n_free == n0


def test_page_pool_conserved_under_randomized_churn(model):
    kv = PagedKVCache(model, n_lanes=4, n_pages=6, page_size=8,
                      pages_per_lane=3)
    n0 = kv.allocator.n_free
    rng = np.random.default_rng(1234)
    held = {}
    saw_exhaustion = saw_unservable = False
    for _ in range(400):
        lane = int(rng.integers(0, 4))
        if lane in held:
            kv.release(lane)
            del held[lane]
        else:
            total = int(rng.integers(-3, 32))
            free_before = kv.allocator.n_free
            if not kv.fits_ever(total):
                saw_unservable = True
                with pytest.raises(ValueError, match="unservable"):
                    kv.admit(lane, total)
                assert kv.allocator.n_free == free_before
            elif kv.admit(lane, total):
                held[lane] = kv.pages_needed(total)
            else:
                saw_exhaustion = True
                assert kv.allocator.n_free == free_before
        assert kv.allocator.n_free == n0 - sum(held.values())
    assert saw_exhaustion and saw_unservable
    for lane in list(held):
        kv.release(lane)
    assert kv.allocator.n_free == n0


def test_paged_update_routes_invalid_writes_to_the_trash_page(model):
    from repro_torch.models.attention import paged_update
    kp = torch.zeros(4, 2, 1, 2)
    vp = torch.zeros(4, 2, 1, 2)
    new = torch.arange(1, 9, dtype=torch.float32).reshape(2, 2, 1, 2)
    table = torch.tensor([[2, -1], [0, 1]], dtype=torch.int32)
    pos = torch.tensor([[1, 2], [-1, 3]], dtype=torch.int32)
    paged_update(kp, vp, new, new, pos, table)
    assert kp[2, 1].tolist() == [[1.0, 2.0]]          # lane 0, position 1
    assert kp[1, 1].tolist() == [[7.0, 8.0]]          # lane 1, position 3
    assert kp[0].abs().sum() == 0                     # nothing else mapped
    assert kp[3].abs().sum() > 0                      # unmapped / idle


# ---------------------------------------------------------------------------
# typed API and config validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,msg", [
    (dict(max_new_tokens=0), "max_new_tokens"),
    (dict(temperature=-0.5), "temperature"),
    (dict(temperature=float("nan")), "temperature"),
    (dict(eos_id=-1), "eos_id"),
])
def test_sampling_params_rejects_bad_values(kwargs, msg):
    with pytest.raises(ValueError, match=msg):
        SamplingParams(**kwargs)


def test_request_validates_tokens():
    with pytest.raises(ValueError, match="non-empty 1-D"):
        Request(id=0, tokens=np.zeros((0,), np.int32))
    with pytest.raises(ValueError, match="non-empty 1-D"):
        Request(id=0, tokens=np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError, match="integer ids"):
        Request(id=0, tokens=np.zeros((4,), np.float32))
    assert Request(id=0, tokens=np.arange(4)).tokens.dtype == np.int32
    assert RequestOutput(id=0, tokens=np.zeros(0)).ok


@pytest.mark.parametrize("kwargs,msg", [
    (dict(n_lanes=0), "n_lanes"),
    (dict(page_size=0), "page_size"),
    (dict(prefill_chunk=0), "prefill_chunk"),
    (dict(max_seq_len=1), "max_seq_len"),
    (dict(n_pages=0), "n_pages"),
    (dict(eos_id=-2), "eos_id"),
    (dict(request_timeout_s=0.0), "request_timeout_s"),
    (dict(saturation_threshold=0.0), "saturation_threshold"),
    (dict(fp32_fallback=True), "fp32_fallback"),
])
def test_serve_config_rejects_bad_values(kwargs, msg):
    with pytest.raises(ValueError, match=msg):
        ServeConfig(**kwargs)


def test_sampled_requests_are_refused_at_submit(model):
    """No longer refused: sampled picks are ported
    (``test_torch_sampling.py``).  A sampled request queues with its own
    SamplingParams and seed, and drains like a greedy one."""
    eng = _engine(model)
    sp = SamplingParams(greedy=False, temperature=0.8, max_new_tokens=4)
    eng.submit(_req(model, "s", sampling=sp, seed=3))
    assert eng.scheduler.queue[0][1] == sp
    (o,) = eng.drain()
    assert o.id == "s" and o.status == STATUS_OK and o.tokens.shape == (4,)


# ---------------------------------------------------------------------------
# scheduler: admission, shed, churn, shapes
# ---------------------------------------------------------------------------

def test_submit_step_collect_roundtrip(model):
    eng = _engine(model)
    eng.submit(_req(model, "a"))
    eng.submit(_req(model, "b", seed0=3))
    stepped = []
    while eng.pending:
        stepped.extend(eng.step())
    outs = {o.id: o for o in eng.collect()}
    assert set(outs) == {"a", "b"} and len(stepped) == 2
    for o in outs.values():
        assert o.status == STATUS_OK and o.fault_step == -1
        assert o.tokens.shape == (NEW,) and o.prompt_len == PROMPT
        assert o.n_steps == NEW
    assert eng.collect() == []


def test_impossible_fit_sheds_structured(model):
    eng = _engine(model)
    eng.submit(_req(model, "big", n=70))
    (o,) = eng.drain()
    assert o.id == "big" and o.status == STATUS_SHED
    assert o.fault_step == -1 and o.tokens.size == 0 and o.n_steps == 0


def test_transient_page_exhaustion_queues_not_crashes(model):
    # 4 pages x 8 positions; each request needs 3 pages, so the second
    # waits for the first to retire
    eng = _engine(model, n_lanes=2, max_seq_len=24, n_pages=4)
    eng.submit(_req(model, "a"))
    eng.submit(_req(model, "b", seed0=5))
    outs = {o.id: o for o in eng.drain()}
    assert outs["a"].status == outs["b"].status == STATUS_OK
    assert outs["b"].tokens.shape == (NEW,)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_request_tokens_bitwise_stable_under_churn(int8):
    """A request's tokens are the same alone and amid neighbours admitting
    and retiring around it (page recycling, staggered prefills, other
    physical pages)."""
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True),
                              param_dtype="bfloat16")
    tm = Model(cfg, device="cpu").init_weights(1)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():   # random norm scales, tripled block weights
        for name, p in tm.named_parameters():
            if p.dim() == 1:
                p.copy_(0.5 * torch.randn(p.shape, generator=gen))
            elif name != "embed":
                p.mul_(3)
    eng = _engine(tm, int8=int8)
    probe = _req(tm, "probe", n=PROMPT, seed0=7,
                 sampling=SamplingParams(max_new_tokens=12))
    eng.submit(probe)
    alone = {o.id: o for o in eng.drain()}["probe"]
    for i, (n, new) in enumerate([(11, 2), (23, 3), (5, 4), (17, 2)]):
        if i == 1:
            eng.submit(probe)
        eng.submit(_req(tm, f"n{i}", n=n, seed0=i + 1,
                        sampling=SamplingParams(max_new_tokens=new)))
    churned = {o.id: o for o in eng.drain()}
    assert len(churned) == 5
    assert all(o.status == STATUS_OK for o in churned.values())
    np.testing.assert_array_equal(churned["probe"].tokens, alone.tokens)
    assert len(set(alone.tokens.tolist())) > 1


def test_call_shapes_fixed_after_warmup_under_churn(model, monkeypatch):
    """The port's form of "no recompilation under churn": every decode
    call is [L, 1] and every prefill call [L, C], whatever the requests."""
    eng = _engine(model)
    shapes = {"decode": set(), "chunk": set()}
    real_dec, real_chunk = model.decode_step_paged, model.prefill_chunk

    def dec(cache, token, positions, table):
        shapes["decode"].add((tuple(token.shape), tuple(positions.shape),
                              tuple(table.shape)))
        return real_dec(cache, token, positions, table)

    def chunk(cache, tokens, positions, table, last):
        shapes["chunk"].add((tuple(tokens.shape), tuple(positions.shape),
                             tuple(table.shape), tuple(last.shape)))
        return real_chunk(cache, tokens, positions, table, last)

    monkeypatch.setattr(model, "decode_step_paged", dec)
    monkeypatch.setattr(model, "prefill_chunk", chunk)
    eng.submit(_req(model, "w0"))
    eng.submit(_req(model, "w1", n=20, seed0=2))
    eng.drain()
    warm = {k: set(v) for k, v in shapes.items()}
    assert warm == {"decode": {((3, 1), (3,), (3, 8))},
                    "chunk": {((3, 8), (3, 8), (3, 8), (3,))}}
    for i in range(7):
        eng.submit(_req(model, f"c{i}", n=5 + 7 * (i % 4), seed0=i,
                        sampling=SamplingParams(max_new_tokens=1 + i % 5)))
    assert len(eng.drain()) == 7
    assert shapes == warm


def test_eos_stops_request_early(model):
    eng = _engine(model, n_lanes=2)
    eng.submit(_req(model, "free", seed0=4))
    (free,) = eng.drain()
    stop = int(free.tokens[2])
    eng.submit(_req(model, "stopped", seed0=4, sampling=SamplingParams(
        max_new_tokens=NEW, eos_id=stop)))
    (got,) = eng.drain()
    idx = int(np.argmax(free.tokens == stop))
    assert got.status == STATUS_OK and got.tokens.shape == (idx + 1,)
    np.testing.assert_array_equal(got.tokens, free.tokens[:idx + 1])


def test_chunked_prefill_matches_single_chunk(model):
    one = _engine(model, n_lanes=2, prefill_chunk=64)
    many = _engine(model, n_lanes=2, prefill_chunk=8)
    req = _req(model, "x", n=29, seed0=4)
    one.submit(req)
    many.submit(req)
    (a,) = one.drain()
    (b,) = many.drain()
    np.testing.assert_array_equal(a.tokens, b.tokens)


# ---------------------------------------------------------------------------
# generate(batch) shim vs the fixed loop, and the guards
# ---------------------------------------------------------------------------

def _batch(model, b=3):
    rng = np.random.default_rng(9)
    return {"tokens": torch.from_numpy(
        rng.integers(0, model.cfg.vocab, (b, PROMPT)).astype(np.int32))}


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_shim_equals_fixed_loop(model, int8):
    eng = ServeEngine(model, ServeConfig(max_new_tokens=NEW, int8=int8))
    p = _batch(model)
    shim = eng.generate_with_status(p)
    fixed = eng.generate_with_status_fixed(p)
    np.testing.assert_array_equal(shim.tokens, fixed.tokens)
    assert shim.status == fixed.status == [STATUS_OK] * 3
    np.testing.assert_array_equal(shim.fault_step, fixed.fault_step)
    assert shim.n_steps == fixed.n_steps == NEW
    np.testing.assert_array_equal(eng.generate(p), shim.tokens)


def test_shed_lanes_report_minus_one_fault_step(model):
    eng = ServeEngine(model, ServeConfig(max_new_tokens=NEW, max_lanes=2))
    p = _batch(model, b=4)
    for res in (eng.generate_with_status(p),
                eng.generate_with_status_fixed(p)):
        assert res.status[2:] == [STATUS_SHED, STATUS_SHED]
        assert (res.fault_step == -1).all() and res.admitted == 2


def test_scheduler_sheds_zero_length_request(model):
    """A zero-length request that bypassed ``Request`` validation comes
    back shed, not as a crash in the page arithmetic."""
    eng = _engine(model)
    eng.submit(types.SimpleNamespace(
        id="empty", tokens=np.zeros((0,), np.int32), seed=0,
        sampling=types.SimpleNamespace(max_new_tokens=0, greedy=True)))
    (o,) = eng.drain()
    assert o.id == "empty" and o.status == STATUS_SHED
    assert o.fault_step == -1 and o.tokens.size == 0 and o.prompt_len == 0


def test_shims_shed_zero_length_batch(model):
    eng = ServeEngine(model, ServeConfig(max_new_tokens=NEW))
    p = {"tokens": torch.zeros((3, 0), dtype=torch.int32)}
    for res in (eng.generate_with_status(p),
                eng.generate_with_status_fixed(p)):
        assert res.tokens.shape == (3, 0)
        assert res.status == [STATUS_SHED] * 3
        assert (res.fault_step == -1).all() and res.admitted == 0


def test_pick_probe_flags_saturation_past_calibration(model):
    eng = ServeEngine(model, ServeConfig(int8=True))
    v = model.cfg.vocab
    logits = torch.zeros(2, model.cfg.padded_vocab())
    logits[0, :v] = torch.linspace(-1, 1, v)
    logits[1, :v] = 4 * torch.linspace(-1, 1, v)
    logits[1, 5] = float("inf")
    tok, finite, absmax, sat = eng._pick_and_probe_lanes(
        logits, None, None, None, None, torch.tensor([1.0, 1.0]))
    assert tok.tolist() == [v - 1, 5]
    assert finite.tolist() == [True, False]
    assert absmax[0] == 1.0
    assert sat[0] <= 2.0 / v and sat[1] > 0.7


def test_saturated_lanes_degrade_onto_the_float_model(model, monkeypatch):
    """A lane whose probe saturates after calibration is marked
    degraded_fp32 at that step, and with fp32_fallback its decode steps
    run on the retained float model as well."""
    eng = _engine(model, int8=True, fp32_fallback=True)
    assert eng.model.int8 and eng.fp_model is model
    real = eng._pick_and_probe_lanes

    def saturating(logits, *pick_args):
        tok, fin, absmax, sat = real(logits, *pick_args)
        return tok, fin, absmax, torch.ones_like(sat)

    monkeypatch.setattr(eng, "_pick_and_probe_lanes", saturating)
    fp_calls = []
    real_fp = model.decode_step_paged
    monkeypatch.setattr(model, "decode_step_paged",
                        lambda *a: fp_calls.append(1) or real_fp(*a))
    eng.submit(_req(model, "x"))
    (o,) = eng.drain()
    assert o.status == STATUS_DEGRADED and o.fault_step == 1
    assert o.tokens.shape == (NEW,) and len(fp_calls) == NEW - 2


def test_nonfinite_lane_is_quarantined_while_peers_decode(model,
                                                         monkeypatch):
    """Lane 1's logits turn NaN at its third pick: that request alone is
    quarantined (its tokens end at the fault step), its peer decodes on
    to the tokens it emits alone."""
    eng = _engine(model, n_lanes=2)
    eng.submit(_req(model, "peer", seed0=10))
    (alone,) = eng.drain()
    real = model.decode_step_paged
    calls = []

    def poisoned(cache, token, positions, table):
        logits, cache = real(cache, token, positions, table)
        calls.append(1)
        if len(calls) == 2:
            logits = logits.clone()
            logits[1, 0] = float("nan")
        return logits, cache

    monkeypatch.setattr(model, "decode_step_paged", poisoned)
    eng.submit(_req(model, "peer", seed0=10))
    eng.submit(_req(model, "bad", seed0=20))
    outs = {o.id: o for o in eng.drain()}
    assert outs["bad"].status == STATUS_NONFINITE
    assert outs["bad"].fault_step == 2 and outs["bad"].tokens.size == 2
    assert outs["peer"].status == STATUS_OK
    np.testing.assert_array_equal(outs["peer"].tokens, alone.tokens)


def test_request_timeout_gives_structured_status(model):
    eng = _engine(model, request_timeout_s=1e-9)
    eng.submit(_req(model, "slow"))
    (o,) = eng.drain()
    assert o.status == STATUS_TIMEOUT and o.fault_step == 0
