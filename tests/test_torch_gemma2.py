"""gemma2's path through the port against the JAX reference, on the CPU:
the sliding-window ('local') and softcap variants of K4, K5 and K6 as their
plain versions, K7 (the adder tree), the local ring cache, the final
logit softcap, and greedy serving of the gemma2-27b smoke config (4
layers alternating local and global, window 16, attention softcap 50,
final softcap 30) through the scheduler and the fixed loop.

Tolerances: kernel outputs in bf16 within two bf16 ulps of each row's own
scale against the reference's Pallas kernels in interpret mode (online
softmax against one softmax, or another tiling, then the bf16 cast), fp32
outputs within 1e-5 of the output scale; K7 bitwise for int8 (integer
sums are exact) and within 1e-5 for floats (the reference's interpret
mode and the port fold in the same ascending order, but XLA may fuse the
casts differently).  Within the port, paged == dense is bitwise.  Slice
level, at fp32 compute with the same parameters on both sides
(``convert.from_jax_params``; norm scales drawn from a numpy seed and
block weights tripled so that greedy tokens vary), logits agree within
1e-4 of their scale and greedy tokens exactly, with prompts longer than
the window so that the ring wraps and the window masks.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels.addertree import addertree_pallas
from repro.launch.mesh import make_mesh
from repro.models import attention as jattn
from repro.models import param as jpm
from repro.models.lm import Model as JaxModel
from repro.serve.api import Request as JRequest
from repro.serve.api import SamplingParams as JSamplingParams
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models.lm import Model
from repro_torch.robust.guards import STATUS_OK
from repro_torch.serve.api import Request, SamplingParams
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

BF16_EPS = float(torch.finfo(torch.bfloat16).eps)
ARCH = "gemma2-27b"
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def _xla_mode():
    assert jops.kernel_mode() == "xla", "the reference must run its CPU path"


def _pair(rng, shape, dtype="bfloat16", scale=1.0):
    """The same values as a (jax, torch) pair: drawn in fp32, rounded once
    by torch, handed to JAX exactly through fp32."""
    t = torch.from_numpy((rng.standard_normal(shape) * scale)
                         .astype(np.float32)).to(_T[dtype])
    return jnp.asarray(t.float().numpy()).astype(_J[dtype]), t


def _row_err(got: torch.Tensor, want) -> float:
    g = got.double().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = np.maximum(np.abs(w).max(-1), 1e-3)
    return float((np.abs(g - w).max(-1) / scale).max())


# ---------------------------------------------------------------------------
# K4: flash prefill, local and softcap
# ---------------------------------------------------------------------------

# (b, sq, n_h, n_kv, hd, kind, extra): the reference's edge cases
# (tests/test_flash_attention.py) plus gemma2's local + softcap with a
# window smaller than one block, over several blocks
K4_CASES = [
    (2, 12, 2, 2, 16, "local", dict(window=4)),
    (1, 10, 4, 2, 16, "global", dict(softcap=5.0)),
    (1, 10, 4, 4, 20, "local", dict(window=3)),
    (2, 40, 4, 2, 16, "local", dict(window=5, softcap=2.0)),
    (1, 37, 4, 2, 16, "local", dict(window=16, softcap=50.0)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,n_h,n_kv,hd,kind,extra", K4_CASES)
def test_k4_variants_match_pallas_interpret(b, sq, n_h, n_kv, hd, kind,
                                            extra, dtype):
    rng = np.random.default_rng(sq + hd)
    jq, tq = _pair(rng, (b, sq, n_h, hd), dtype)
    jk, tk = _pair(rng, (b, sq, n_kv, hd), dtype)
    jv, tv = _pair(rng, (b, sq, n_kv, hd), dtype)
    want = jfa.flash_attention_pallas(jq, jk, jv, kind=kind, block_q=8,
                                      block_k=8, interpret=True, **extra)
    got = ops.flash_attention(tq, tk, tv, kind=kind, **extra)
    assert got.dtype == _T[dtype] and got.shape == tq.shape
    assert _row_err(got, want) <= (1e-5 if dtype == "float32"
                                   else 2 * BF16_EPS)


def test_k4_softcap_and_window_change_the_output():
    """Both variants bite at these shapes: dropping either moves rows by
    far more than the tolerance."""
    rng = np.random.default_rng(0)
    _, q = _pair(rng, (1, 40, 4, 16), "float32", scale=3.0)
    _, k = _pair(rng, (1, 40, 2, 16), "float32", scale=3.0)
    _, v = _pair(rng, (1, 40, 2, 16), "float32")
    base = ops.flash_attention(q, k, v, kind="local", window=5, softcap=2.0)
    for other in (dict(kind="global", softcap=2.0),
                  dict(kind="local", window=5)):
        assert float((ops.flash_attention(q, k, v, **other) - base
                      ).abs().max()) > 0.1


# ---------------------------------------------------------------------------
# K5: split-K flash decode with softcap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_splits", [1, 2])
def test_k5_softcap_matches_pallas_interpret(n_splits):
    b, kv_len, n_kv, g, hd, pos = 2, 75, 2, 4, 16, 61
    rng = np.random.default_rng(3 + n_splits)
    jq, tq = _pair(rng, (b, 1, n_kv, g, hd), scale=3.0)
    jk, tk = _pair(rng, (b, kv_len, n_kv, hd))
    jv, tv = _pair(rng, (b, kv_len, n_kv, hd))
    want = jfa.flash_decode_pallas(jq, jk, jv, jnp.int32(pos), softcap=2.0,
                                   n_splits=n_splits, interpret=True)
    got = ops.flash_decode(tq, tk, tv, pos, softcap=2.0, n_splits=n_splits)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    assert _row_err(got, want) <= 2 * BF16_EPS
    plain = ops.flash_decode(tq, tk, tv, pos, n_splits=n_splits)
    assert _row_err(plain, want) > 10 * BF16_EPS, "the softcap did not bite"


def test_k5_softcap_tiling_matches_the_f64_oracle():
    rng = np.random.default_rng(2)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s) * 3)
                 for s in ((2, 1, 2, 4, 16), (2, 70, 2, 16), (2, 70, 2, 16)))
    want = tref.flash_decode_ref(q, kc, vc, 45, softcap=2.0)
    got = ops.flash_decode(q, kc, vc, 45, softcap=2.0)
    assert got.dtype == torch.float64
    assert float((got - want).abs().max()) <= 1e-12


# ---------------------------------------------------------------------------
# K6: paged decode and prefill chunks, local and softcap
# ---------------------------------------------------------------------------

def _paged_case(ps, s_q, seed=0, n_lanes=4, p_max=None, kv=2, g=2, hd=16):
    """Pools with shuffled pages, lanes at mixed positions, the last lane
    idle, unmapped (-1) pages past each lane's length."""
    rng = np.random.default_rng(seed)
    p_max = p_max or -(-96 // ps)
    n_pages = n_lanes * p_max
    bf = torch.bfloat16

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(bf)
    kp, vp = rand(n_pages + 1, ps, kv, hd), rand(n_pages + 1, ps, kv, hd)
    last = np.array([3, 50, p_max * ps - 1, -1])[:n_lanes]
    table = rng.permutation(n_pages).reshape(n_lanes, p_max).astype(np.int32)
    for lane, p in enumerate(last):
        table[lane, max(p, 0) // ps + 1:] = -1
    pos = last[:, None] - (s_q - 1) + np.arange(s_q)[None]
    pos = np.where((last[:, None] >= 0) & (pos >= 0), pos, -1)
    q = rand(n_lanes, s_q, kv, g, hd, scale=3.0)
    return (q, kp, vp, torch.from_numpy(table),
            torch.from_numpy(pos.astype(np.int32)))


def _jx(t: torch.Tensor):
    a = jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16
                    else t.numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


K6_VARIANTS = [
    ("local", dict(window=20, softcap=2.0)),
    ("local", dict(window=5)),                  # window < one 32-slot tile
    ("global", dict(softcap=2.0)),
]


@pytest.mark.parametrize("s_q", [1, 5])
@pytest.mark.parametrize("kind,extra", K6_VARIANTS)
def test_k6_variants_match_reference_mirror(kind, extra, s_q):
    args = _paged_case(16, s_q, seed=s_q + len(extra))
    got = ops.paged_flash_decode(*args, kind=kind, **extra)
    want = jfa.paged_flash_decode_xla(*(_jx(a) for a in args), kind=kind,
                                      **extra)
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    assert _row_err(got, want) <= BF16_EPS
    assert torch.all(got[-1] == 0), "the idle lane is not exactly 0.0"


@pytest.mark.parametrize("kind,extra", K6_VARIANTS)
def test_k6_variants_within_budget_of_pallas_interpret(kind, extra):
    """The reference's Pallas kernel tiles one page per tile (ROADMAP F2):
    held within a budget, never bitwise."""
    args = _paged_case(16, 1, seed=3)
    got = ops.paged_flash_decode(*args, kind=kind, **extra)
    q, kp, vp, table, pos = (_jx(a) for a in args)
    want = jfa.paged_flash_decode_pallas(q, kp, vp, table, pos.reshape(-1),
                                         kind=kind, interpret=True, **extra)
    assert _row_err(got, want) <= 2 * BF16_EPS


@pytest.mark.parametrize("s_q", [1, 3])
def test_k6_global_softcap_paged_equals_dense_bitwise(s_q):
    """page_size 16: each 32-slot tile spans two pages; a global lane
    with softcap is bitwise the same history held in a dense cache."""
    q, kp, vp, table, pos = _paged_case(16, s_q, seed=11)
    got = ops.paged_flash_decode(q, kp, vp, table, pos, softcap=50.0)
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
                                    v_dense, p, softcap=50.0)
            assert torch.equal(got[lane:lane + 1, s:s + 1], want)


def test_k6_tiles_before_the_window_are_exact_zero_partials():
    """A tile wholly before a local row's window is (_NEG, 0, 0): what the
    kernel writes without reading it."""
    q, kp, vp, table, pos = _paged_case(16, 1, seed=5)
    m_t, l_t, acc_t = tfa.paged_tile_partials(q, kp, vp, table, pos,
                                              kind="local", window=5)
    lane = 1                                    # position 50: tile 0 dead
    assert torch.all(m_t[0, lane] == tfa._NEG)
    assert torch.all(l_t[0, lane] == 0) and torch.all(acc_t[0, lane] == 0)
    assert torch.all(l_t[1, lane] > 0)


def test_unported_kinds_raise_on_every_path():
    """Every kind of the reference's masks is ported to K4;
    a kind outside a kernel's set raises on every path: no mask of the
    reference is called 'sliding', the paged kernel serves no 'prefix' or
    'full' (whisper's encoder-decoder), K5 no ring kind ('local' and
    'chunked' layers decode their ring in plain torch), and no model
    block is 'prefix' (the reference's prefix-LM mask has no caller)."""
    rng = np.random.default_rng(0)
    _, q = _pair(rng, (1, 8, 2, 16))
    _, k = _pair(rng, (1, 8, 2, 16))
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, k, kind="sliding", window=4)
    for kind in ("prefix", "full"):
        with pytest.raises(NotImplementedError):
            ops.paged_flash_decode(*_paged_case(16, 1), kind=kind, window=4)
    for kind in ("local", "chunked"):
        with pytest.raises(NotImplementedError):
            ops.flash_decode(q[:, :1].reshape(1, 1, 2, 1, 16), k, k, 3,
                             kind=kind)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              block_pattern=("prefix",))
    with pytest.raises(NotImplementedError):
        Model(cfg, device="cpu")


# ---------------------------------------------------------------------------
# K7: the adder tree
# ---------------------------------------------------------------------------

def _partials(rng, shape, dtype):
    if dtype == "int8":
        t = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8))
        return jnp.asarray(t.numpy()), t
    return _pair(rng, shape, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"],
                         ids=["f32", "bf16", "i8"])
@pytest.mark.parametrize("s,m,n", [(2, 32, 32), (4, 64, 96), (7, 50, 33),
                                   (3, 1, 128)])
def test_k7_plain_matches_pallas_interpret(s, m, n, dtype):
    rng = np.random.default_rng(s + m)
    jp, tp = _partials(rng, (s, m, n), dtype)
    if dtype == "int8":
        want = addertree_pallas(jp, block=(32, 32), out_dtype=jnp.int32,
                                interpret=True)
        got = ops.addertree(tp, out_dtype=torch.int32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        want = addertree_pallas(jp, block=(32, 32), out_dtype=jnp.float32,
                                interpret=True)
        got = ops.addertree(tp, out_dtype=torch.float32)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_k7_default_out_dtype_and_ascending_fold():
    """The output keeps the partials' dtype by default, and floats fold
    in ascending s at fp32 (bitwise a left-to-right sum)."""
    rng = np.random.default_rng(1)
    _, p = _pair(rng, (5, 16, 24), "bfloat16")
    got = ops.addertree(p)
    want = p[0].float()
    for s in range(1, 5):
        want = want + p[s].float()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))
    with pytest.raises(ValueError):
        ops.addertree(p[0])


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def _models(compute_dtype="float32"):
    over = dict(compute_dtype=compute_dtype)
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **over)
    jm = JaxModel(jcfg, make_mesh(1, 1))
    params = jax.tree.map(np.asarray, jm.init_params(0))
    rng = np.random.default_rng(7)
    for b in params["groups"]:
        grp = params["groups"][b]
        for name in ("ln1", "ln2"):
            grp[name] = (0.5 * rng.standard_normal(grp[name].shape)
                         ).astype(np.float32)
        for sub, names in (("attn", ("wqkv", "wo")),
                           ("ffn", ("gate", "up", "down"))):
            for name in names:
                grp[sub][name] = grp[sub][name] * grp[sub][name].dtype.type(3)
    params["final_norm"] = (0.5 * rng.standard_normal(
        params["final_norm"].shape)).astype(np.float32)
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(from_jax_params(tcfg, params))
    return jm, jax.tree.map(jnp.asarray, params), tm


def _rel_err(got, want) -> float:
    g = np.asarray(got.double() if torch.is_tensor(got) else got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w)) / max(1.0, np.max(np.abs(w))))


def test_convert_maps_groups_and_tail():
    """Period 2 with a tail block (5 layers): group g's block i is layer
    2g + i, the tail block layer 4; the port's model takes the tree."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), n_layers=5)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), n_layers=5)
    params = jax.tree.map(np.asarray,
                          JaxModel(jcfg, make_mesh(1, 1)).init_params(3))
    params["tail"]["t0"]["ln2"] = np.full_like(params["tail"]["t0"]["ln2"], 7)
    sd = from_jax_params(tcfg, params)
    np.testing.assert_array_equal(
        sd["blocks.3.attn.wqkv"].numpy(),
        params["groups"]["b1"]["attn"]["wqkv"][1])
    np.testing.assert_array_equal(sd["blocks.2.ln1"].numpy(),
                                  params["groups"]["b0"]["ln1"][1])
    assert torch.all(sd["blocks.4.ln2"] == 7)
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(sd)
    assert [tcfg.kind(i) for i in range(5)] == ["local", "global"] * 2 + [
        "local"]


@pytest.mark.parametrize("seq", [10, 40])
def test_ring_cache_after_prefill_matches_reference(seq):
    """The local layer's ring buffer after a prefill of ``seq`` positions
    (shorter than the window of 16, and wrapping it), slot for slot
    against the reference's ``_prefill_attention``: each slot within one
    bf16 ulp of its row's scale (fp32 projections summed in another order,
    then the bf16 cast), the empty slots exactly zero on both sides."""
    jm, params, tm = _models()
    cfg = tm.cfg
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    w = min(cfg.window, 64)
    shape = (2, w, cfg.n_kv_heads, cfg.hd)
    empty = {"k": jnp.zeros(shape, jnp.bfloat16),
             "v": jnp.zeros(shape, jnp.bfloat16)}
    ap = jax.tree.map(lambda a: a[0], params["groups"]["b0"]["attn"])
    _, jcache, _ = jm._prefill_attention(ap, jnp.asarray(x), "local",
                                         jnp.arange(seq), 0, empty, 512)
    tcache = {"k": torch.zeros(shape, dtype=torch.bfloat16),
              "v": torch.zeros(shape, dtype=torch.bfloat16)}
    tattn.attention_apply(tm.blocks[0].attn, torch.from_numpy(x), cfg,
                          torch.float32, kind="local", theta=cfg.rope_theta,
                          positions=torch.arange(seq), cache=tcache)
    for name in ("k", "v"):
        want = np.asarray(jcache[name].astype(jnp.float32))
        got = tcache[name].float()
        filled = np.abs(want).reshape(2, w, -1).max(-1) > 0
        assert filled.sum() == 2 * min(seq, w)
        assert torch.all(got.reshape(2, w, -1)[~torch.from_numpy(filled)]
                         == 0)
        assert _row_err(got, want) <= BF16_EPS


def test_ring_decode_matches_reference_einsum():
    """The local ring decode (outside the kernels) against the reference's
    ``decode_attention_einsum`` on a ring that has wrapped."""
    rng = np.random.default_rng(4)
    jq, tq = _pair(rng, (2, 1, 2, 2, 16), scale=3.0)
    jk, tk = _pair(rng, (2, 16, 2, 16))
    jv, tv = _pair(rng, (2, 16, 2, 16))
    for pos, window in ((37, 16), (9, 16), (37, 12)):
        want = jattn.decode_attention_einsum(jq, jk, jv, jnp.int32(pos),
                                             kind="local", window=window,
                                             softcap=2.0)
        got = tattn.decode_attention(tq, tk, tv, pos, kind="local",
                                     window=window, softcap=2.0)
        assert _row_err(got, want) <= 2 * BF16_EPS


PROMPT, STEPS = 24, 6


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_fixed_loop_final_softcap_logits_match_reference(compute):
    """prefill then decode steps (K4 local + softcap, the ring, K5
    softcap), fed the reference's greedy tokens, with the final softcap,
    every logit inside [-30, 30].  The budget is the consistency rule of
    test_torch_model.py: at most twice the reference's own bf16 rounding
    noise (the distance between its bf16- and fp32-compute runs on the
    same tokens), at either compute dtype.  The fixed loop stores K/V in
    bf16 even at fp32 compute, and the ring rounds q and p to bf16, so an
    fp32-level difference between the two sides flips a stored bf16
    element now and then (one ulp, 2^-8 of it); the tripled weights carry
    that to about 1e-3 of the logit scale by the last layer.  The prefill
    logits, which attend the unrounded K/V, agree within 1e-4 at fp32
    compute."""
    jm, params, tm = _models(compute)
    other = "bfloat16" if compute == "float32" else "float32"
    anchor = JaxModel(dataclasses.replace(jm.cfg, compute_dtype=other),
                      jm.mesh)
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab, (2, PROMPT)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, PROMPT + STEPS))(
        params, batch)
    al, acache = jax.jit(lambda p, b: anchor.prefill(p, b, PROMPT + STEPS))(
        params, batch)
    tl, tcache = tm.prefill(torch.from_numpy(toks), PROMPT + STEPS)
    errs, noise = [_rel_err(tl, jl)], [_rel_err(jl, al)]
    if compute == "float32":
        assert errs[0] <= 1e-4, errs
    decode, adecode = jax.jit(jm.decode_step), jax.jit(anchor.decode_step)
    for i in range(STEPS):
        tok = jnp.argmax(jl[:, :jm.cfg.vocab], -1).astype(jnp.int32)[:, None]
        pos = jnp.asarray(PROMPT + i, jnp.int32)
        jl, jcache = decode(params, jcache, tok, pos)
        al, acache = adecode(params, acache, tok, pos)
        tl, tcache = tm.decode_step(tcache, torch.from_numpy(np.array(tok)),
                                    PROMPT + i)
        errs.append(_rel_err(tl, jl))
        noise.append(_rel_err(jl, al))
        assert float(tl.abs().max()) <= 30.0
    assert max(errs) <= 2.0 * max(noise), (errs, noise)


def test_paged_final_softcap_logits_match_reference():
    """prefill_chunk over three chunks, then decode_step_paged (K6 local
    and global with softcap), fed the reference's greedy tokens, on three
    lanes with the middle one idle: within 1e-4 at fp32 compute."""
    jm, params, tm = _models()
    ps, p_max, chunk, n_lanes = 8, 6, 8, 3
    n_pages = n_lanes * p_max
    jcache = jpm.initialize(jm.paged_cache_defs(n_pages, ps), 0)
    tcache = tm.new_paged_cache(n_pages, ps)
    table = np.array([[4, 0, 7, 2, 13, 16], [-1] * 6, [1, 11, 5, 9, 3, 17]],
                     np.int32)
    toks = np.random.default_rng(5).integers(
        0, jm.cfg.vocab, (n_lanes, 3 * chunk)).astype(np.int32)
    j_chunk, j_decode = jax.jit(jm.prefill_chunk), jax.jit(
        jm.decode_step_paged)
    errs = []

    def rel(t, j):   # the live lanes only: the idle row is garbage
        return _rel_err(t.double().numpy()[[0, 2]],
                        np.asarray(j, np.float64)[[0, 2]])

    for c in range(3):
        pos = np.where(np.arange(n_lanes)[:, None] == 1, -1,
                       c * chunk + np.arange(chunk)[None]).astype(np.int32)
        last = np.array([chunk - 1, -1, chunk - 1], np.int32)
        sl = toks[:, c * chunk:(c + 1) * chunk]
        jl, jcache = j_chunk(params, jcache, jnp.asarray(sl),
                             jnp.asarray(pos), jnp.asarray(table),
                             jnp.asarray(last))
        tl, _ = tm.prefill_chunk(tcache, torch.from_numpy(sl),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(table),
                                 torch.from_numpy(last))
        errs.append(rel(tl, jl))
    for step in range(4):
        tok = np.asarray(jnp.argmax(jl[:, :jm.cfg.vocab], -1),
                         np.int32)[:, None]
        pos = np.array([3 * chunk + step, -1, 3 * chunk + step], np.int32)
        jl, jcache = j_decode(params, jcache, jnp.asarray(tok),
                              jnp.asarray(pos), jnp.asarray(table))
        tl, _ = tm.decode_step_paged(tcache, torch.from_numpy(tok.copy()),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(table))
        errs.append(rel(tl, jl))
    assert max(errs) <= 1e-4, errs


_GEOM = dict(n_lanes=3, page_size=8, prefill_chunk=8, max_seq_len=64)
_REQS = [(21, 6), (40, 4), (17, 6), (33, 3), (26, 5)]   # (prompt, max_new)


def test_engine_greedy_tokens_match_reference():
    """The scheduler (``submit``/``drain``): five requests with prompts
    longer than the window through three lanes, against the reference's
    scheduler, token for token."""
    jm, params, tm = _models()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jm.cfg.vocab, n).astype(np.int32)
               for n, _ in _REQS]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JServeEngine(jm, params, JServeConfig(**_GEOM))
    for i, (p, (_, new)) in enumerate(zip(prompts, _REQS)):
        jeng.submit(JRequest(id=i, tokens=p, sampling=JSamplingParams(
            max_new_tokens=new)))
    want = {o.id: o for o in jeng.drain()}
    teng = ServeEngine(tm, ServeConfig(**_GEOM))
    for i, (p, (_, new)) in enumerate(zip(prompts, _REQS)):
        teng.submit(Request(id=i, tokens=p, sampling=SamplingParams(
            max_new_tokens=new)))
    got = {o.id: o for o in teng.drain()}
    assert set(got) == set(want) == set(range(len(_REQS)))
    for i in got:
        assert got[i].status == want[i].status == STATUS_OK
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
    assert len({t for o in got.values() for t in o.tokens.tolist()}) > 3


@pytest.mark.parametrize("path", ["fixed", "shim"])
def test_batch_greedy_tokens_match_reference(path):
    """``generate_with_status_fixed`` (dense cache, ring for the local
    layers) and the scheduler shim ``generate`` against the reference's
    same path, token for token.  The two paths are not held to each other
    for gemma2: the reference's own shim and fixed loop already part at
    the first token of a lane here (the chunked prefill attends K/V
    rounded to the bf16 pools, the fixed prefill attends them unrounded,
    and a near tie flips)."""
    jm, params, tm = _models()
    toks = np.random.default_rng(2).integers(
        0, jm.cfg.vocab, (2, PROMPT)).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JServeEngine(jm, params, JServeConfig(max_new_tokens=STEPS))
    eng = ServeEngine(tm, ServeConfig(max_new_tokens=STEPS))
    if path == "fixed":
        want = jeng.generate_with_status_fixed(
            {"tokens": jnp.asarray(toks)}).tokens
        res = eng.generate_with_status_fixed(
            {"tokens": torch.from_numpy(toks)})
        assert list(res.status) == [STATUS_OK] * 2
        got = res.tokens
    else:
        want = jeng.generate({"tokens": jnp.asarray(toks)})
        got = eng.generate({"tokens": toks})
    assert got.shape == (2, STEPS)
    np.testing.assert_array_equal(got, want)
    assert len(set(got[0].tolist())) > 1, "degenerate greedy stream"


def test_logits_vocab_slices_match_one_product(monkeypatch):
    """The logits upcast the embedding one vocabulary slice at a time;
    the slices change no logit beyond fp32 summation order, and the
    final softcap bounds them."""
    from repro_torch.models import loss
    rng = np.random.default_rng(6)
    h = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(np.float32))
    head = torch.from_numpy(rng.standard_normal((256, 16)).astype(
        np.float32) * 4).to(torch.bfloat16)
    whole = torch.matmul(h, head.float().t())
    monkeypatch.setattr(loss, "VOCAB_SLICE", 40)
    got = loss.vocab_parallel_logits(h, head)
    assert got.shape == (2, 3, 256)
    assert float((got - whole).abs().max()) <= 1e-5
    capped = loss.vocab_parallel_logits(h, head, final_softcap=3.0)
    assert float(capped.abs().max()) <= 3.0
    torch.testing.assert_close(capped, 3.0 * torch.tanh(whole / 3.0))


def test_ring_cache_sizes_and_launch_variant_keys():
    """A local layer's dense cache is a ring of min(window, max_len)
    slots; a variant's launch counts under its own key as well."""
    from repro_torch.kernels import _cuda
    tm = Model(get_config(ARCH, smoke=True), device="cpu")
    for max_len, ring in ((10, 10), (40, 16)):
        cache = tm.new_cache(1, max_len)
        assert [c["k"].shape[1] for c in cache] == [ring, max_len] * 2
    before = dict(_cuda.LAUNCHES)
    try:
        _cuda.count("paged_decode", local=True, softcap=True)
        _cuda.count("paged_decode", local=False, softcap=True)
        assert _cuda.LAUNCHES["paged_decode"] == \
            before["paged_decode"] + 2
        assert _cuda.LAUNCHES["paged_decode:local+softcap"] == \
            before.get("paged_decode:local+softcap", 0) + 1
        assert _cuda.LAUNCHES["paged_decode:softcap"] == \
            before.get("paged_decode:softcap", 0) + 1
    finally:
        _cuda.LAUNCHES.clear()
        _cuda.LAUNCHES.update(before)
