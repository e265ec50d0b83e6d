"""gemma3's path through the port against the JAX reference, on the CPU:
the config copy, head dim 256 in the plain versions of K4, K5 and K6, the
kernels' launch arguments and counts at hd 256 (intercepted at
``kernels._cuda.launch``: the CUDA kernels run only on the card, where
``chip_smoke.py`` holds them to these plain versions), and serving of a
narrow gemma3 (the smoke config's 6 layers, 5 local to 1 global, window
16, dual RoPE theta, at ``head_dim=256`` over 4 query and 2 kv heads)
through the fixed loop and the scheduler, float and int8 weights.

Tolerances are the gemma2 tests': kernel outputs in bf16 within two bf16
ulps of each row's own scale against the reference's Pallas kernels in
interpret mode (online softmax against one softmax, or another tiling,
then the bf16 cast), one ulp against its tiled XLA mirror (the same
tiles), fp32 outputs within 1e-5.  Within the port, paged == dense is
bitwise.  Slice level, at fp32 compute with the same parameters on both
sides (``convert.from_jax_params``; norm scales drawn from a numpy seed
and block weights tripled so that greedy tokens vary), prefill logits
agree within 1e-4 of their scale and greedy tokens exactly, with prompts
longer than the window so that the ring wraps and the window masks.
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
from repro.launch.mesh import make_mesh
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
from repro_torch.kernels import ops
from repro_torch.launch.serve import GEMMA3_GEOMETRY, geometry
from repro_torch.models.lm import Model
from repro_torch.robust.guards import STATUS_OK
from repro_torch.serve.api import Request, SamplingParams
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

BF16_EPS = float(torch.finfo(torch.bfloat16).eps)
ARCH = "gemma3-12b"
HD = 256
H100_SMS = 132
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


def _jx(t: torch.Tensor):
    a = jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16
                    else t.numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_is_the_reference_copy(smoke):
    """Every field of the port's ``ArchConfig`` equals the reference's,
    and so do the parameter count and the layer kinds."""
    got, want = get_config(ARCH, smoke=smoke), jax_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(ArchConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.param_count() == want.param_count()
    assert [got.kind(i) for i in range(got.n_layers)] == [
        want.block_pattern[i % want.pattern_period]
        for i in range(want.n_layers)]
    assert (got.n_groups, got.tail_blocks) == (want.n_groups,
                                               want.tail_blocks)
    assert ARCH in ARCH_IDS


def test_full_width_fits_one_card():
    """11.77 B parameters: 23.5 GB in bf16, and the int8 copy beside them
    fits an 80 GB card (``launch.serve.int8_fits``' rule); gemma2's
    scheduler geometry, past the 1024 window."""
    cfg = get_config(ARCH)
    assert cfg.param_count() == 11_765_395_200
    assert (cfg.hd, cfg.q_dim, cfg.kv_dim) == (256, 4096, 2048)
    assert 3 * cfg.param_count() < 0.8 * 80e9
    assert geometry(ARCH) == GEMMA3_GEOMETRY
    assert GEMMA3_GEOMETRY["max_seq_len"] > 4 * cfg.window


# ---------------------------------------------------------------------------
# the plain K4, K5 and K6 at hd 256 against the reference
# ---------------------------------------------------------------------------

K4_CASES = [
    (2, 24, 4, 2, "local", dict(window=5)),
    (1, 37, 4, 2, "local", dict(window=16)),
    (1, 20, 4, 2, "global", dict()),
    (1, 12, 2, 1, "global", dict(softcap=5.0)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,n_h,n_kv,kind,extra", K4_CASES)
def test_k4_hd256_matches_pallas_interpret(b, sq, n_h, n_kv, kind, extra,
                                           dtype):
    rng = np.random.default_rng(sq + n_h)
    jq, tq = _pair(rng, (b, sq, n_h, HD), dtype)
    jk, tk = _pair(rng, (b, sq, n_kv, HD), dtype)
    jv, tv = _pair(rng, (b, sq, n_kv, HD), dtype)
    want = jfa.flash_attention_pallas(jq, jk, jv, kind=kind, block_q=8,
                                      block_k=8, interpret=True, **extra)
    got = ops.flash_attention(tq, tk, tv, kind=kind, **extra)
    assert got.dtype == _T[dtype] and got.shape == tq.shape
    assert _row_err(got, want) <= (1e-5 if dtype == "float32"
                                   else 2 * BF16_EPS)


@pytest.mark.parametrize("n_splits", [1, 3])
def test_k5_hd256_matches_pallas_interpret(n_splits):
    b, kv_len, n_kv, g, pos = 2, 75, 2, 2, 61
    rng = np.random.default_rng(5 + n_splits)
    jq, tq = _pair(rng, (b, 1, n_kv, g, HD))
    jk, tk = _pair(rng, (b, kv_len, n_kv, HD))
    jv, tv = _pair(rng, (b, kv_len, n_kv, HD))
    want = jfa.flash_decode_pallas(jq, jk, jv, jnp.int32(pos),
                                   n_splits=n_splits, interpret=True)
    got = ops.flash_decode(tq, tk, tv, pos, n_splits=n_splits)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    assert _row_err(got, want) <= 2 * BF16_EPS


def _paged_case(ps, s_q, seed=0, n_lanes=4, p_max=None, kv=2, g=2):
    """Pools with shuffled pages, lanes at mixed positions, the last lane
    idle, unmapped (-1) pages past each lane's length."""
    rng = np.random.default_rng(seed)
    p_max = p_max or -(-96 // ps)
    n_pages = n_lanes * p_max
    bf = torch.bfloat16

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(bf)
    kp, vp = rand(n_pages + 1, ps, kv, HD), rand(n_pages + 1, ps, kv, HD)
    last = np.array([3, 50, p_max * ps - 1, -1])[:n_lanes]
    table = rng.permutation(n_pages).reshape(n_lanes, p_max).astype(np.int32)
    for lane, p in enumerate(last):
        table[lane, max(p, 0) // ps + 1:] = -1
    pos = last[:, None] - (s_q - 1) + np.arange(s_q)[None]
    pos = np.where((last[:, None] >= 0) & (pos >= 0), pos, -1)
    q = rand(n_lanes, s_q, kv, g, HD, scale=3.0)
    return (q, kp, vp, torch.from_numpy(table),
            torch.from_numpy(pos.astype(np.int32)))


K6_VARIANTS = [("local", dict(window=20)), ("local", dict(window=5)),
               ("global", dict())]


@pytest.mark.parametrize("s_q", [1, 6])
@pytest.mark.parametrize("kind,extra", K6_VARIANTS)
def test_k6_hd256_matches_reference_mirror(kind, extra, s_q):
    """Decode steps and prefill chunks against the reference's tiled XLA
    mirror (the same 32-slot tiles): one bf16 ulp of each row's scale,
    the idle lane exactly 0.0."""
    args = _paged_case(16, s_q, seed=s_q + len(extra))
    got = ops.paged_flash_decode(*args, kind=kind, **extra)
    want = jfa.paged_flash_decode_xla(*(_jx(a) for a in args), kind=kind,
                                      **extra)
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    assert _row_err(got, want) <= BF16_EPS
    assert torch.all(got[-1] == 0), "the idle lane is not exactly 0.0"


@pytest.mark.parametrize("kind,extra", K6_VARIANTS)
def test_k6_hd256_within_budget_of_pallas_interpret(kind, extra):
    """The reference's Pallas kernel tiles one page per tile (ROADMAP F2):
    held within a budget, never bitwise."""
    args = _paged_case(16, 1, seed=3)
    got = ops.paged_flash_decode(*args, kind=kind, **extra)
    q, kp, vp, table, pos = (_jx(a) for a in args)
    want = jfa.paged_flash_decode_pallas(q, kp, vp, table, pos.reshape(-1),
                                         kind=kind, interpret=True, **extra)
    assert _row_err(got, want) <= 2 * BF16_EPS


@pytest.mark.parametrize("ps", [8, 16])
def test_k6_hd256_paged_equals_dense_bitwise(ps):
    """A decode step (S == 1, the contract of K6's decode body): each live
    global lane is bitwise the same history held in a dense cache and
    decoded by K5's plain version; the idle lane is exactly 0.0.  (A chunk
    of S > 1 takes the chunk body, held to the plain version within a
    budget.)"""
    s_q = 1
    q, kp, vp, table, pos = _paged_case(ps, s_q, seed=11)
    got = ops.paged_flash_decode(q, kp, vp, table, pos)
    assert torch.all(got[-1] == 0)
    ps, p_max = kp.shape[1], table.shape[1]
    for lane in range(q.shape[0] - 1):
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
            assert torch.equal(got[lane:lane + 1, s:s + 1], want)


# ---------------------------------------------------------------------------
# what the launchers are handed at hd 256
# ---------------------------------------------------------------------------

@pytest.fixture
def intercepted(monkeypatch):
    """Run the wrappers on CPU tensors up to the launch: the device checks
    pass, the launch is recorded, the card has 132 SMs."""
    calls = []
    monkeypatch.setattr(_cuda, "check", lambda *a, **kw: None)
    monkeypatch.setattr(_cuda, "launch",
                        lambda lib, fn, *args: calls.append((lib, fn, args)))
    monkeypatch.setattr(tfa, "sm_count", lambda index: H100_SMS)
    before = dict(_cuda.LAUNCHES)
    _cuda.reset_launches()
    for key in [k for k in _cuda.LAUNCHES if ":" in k]:
        del _cuda.LAUNCHES[key]
    yield calls
    _cuda.LAUNCHES.clear()
    _cuda.LAUNCHES.update(before)


def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("kind,window,key", [
    ("local", 1024, "flash_attention:local+hd256"),
    ("global", 0, "flash_attention:hd256")])
def test_k4_launch_at_hd256(intercepted, kind, window, key):
    """gemma3's fixed-loop prefill shape (B 2, S 4160, 16 q heads over 8
    kv heads) reaches the launcher with hd 256 and its scale, and counts
    under its hd256 variant."""
    q, k = _bf(2, 4160, 16, HD), _bf(2, 4160, 8, HD)
    tfa.flash_attention_cuda(q, k, k, kind=kind, window=window)
    ((lib, fn, args),) = intercepted
    assert (lib, fn) == ("flash_attention", "k4_flash_prefill")
    assert len(args) + 1 == len(_cuda.SIGNATURES[lib][fn])
    # the mask code, window and prefix length, then the softcap
    assert args[4:] == (2, 4160, 4160, 16, 8, HD, HD ** -0.5,
                        tfa.MASK_CODES[kind], window, 0, 0.0)
    assert _cuda.LAUNCHES["flash_attention"] == 1
    assert _cuda.LAUNCHES[key] == 1


def test_k5_launch_at_hd256(intercepted):
    """The fixed loop's decode (B 2, KV 8, G 2, a 4176-slot cache): 16
    rows of 131 tiles split 17 ways, one wave of the 2 blocks an SM that
    fit at hd 256 (33 at hd 128, where 4 fit)."""
    q, kc = _bf(2, 1, 8, 2, HD), _bf(2, 4176, 8, HD)
    out, ws = tfa.dense_decode_launch(q, kc, kc, 4170)
    ((lib, fn, args),) = intercepted
    assert (lib, fn) == ("flash_attention", "k5_flash_decode")
    assert len(args) + 1 == len(_cuda.SIGNATURES[lib][fn])
    b, kv, rep, g, hd, length, pos, n_tiles, n_splits = args[6:15]
    assert (b, kv, rep, g, hd, length, pos) == (2, 8, 1, 2, HD, 4176, 4170)
    assert (n_tiles, n_splits) == (131, 17)
    assert ws.shape == (16, 131, 516)       # record_floats(2, 256)
    assert _cuda.LAUNCHES["flash_decode:hd256"] == 1


@pytest.mark.parametrize("kind,window,key", [
    ("local", 1024, "paged_decode:local+chunk+hd256"),
    ("global", 0, "paged_decode:chunk+hd256")])
def test_k6_chunk_launch_at_hd256(intercepted, kind, window, key):
    """A scheduler chunk at gemma3's geometry (8 lanes, S 64, page 16, 262
    pages a lane): one q tile of 64 positions x 2 heads, the chunk body
    at hd 256."""
    q, pool = _bf(8, 64, 8, 2, HD), _bf(513, 16, 8, HD)
    table = torch.zeros((8, 262), dtype=torch.int32)
    pos = torch.zeros((8, 64), dtype=torch.int32)
    out, ws = tfa.paged_decode_launch(q, pool, pool, table, pos, kind=kind,
                                      window=window)
    assert ws is None and tfa.chunk_tiles(64, 2) == (64, 1)
    ((lib, fn, args),) = intercepted
    assert (lib, fn) == ("flash_attention", "k6_paged_chunk")
    assert len(args) + 1 == len(_cuda.SIGNATURES[lib][fn])
    assert args[6:18] == (8, 64, 8, 2, HD, 262, 4, 513, HD ** -0.5,
                          tfa.MASK_CODES[kind], window, 0.0)
    assert _cuda.LAUNCHES["paged_decode"] == 1 and _cuda.LAUNCHES[key] == 1


def test_k6_decode_launch_at_hd256(intercepted):
    """A scheduler decode step at gemma3's geometry: 64 rows of 131 tiles,
    5 splits (9 at hd 128)."""
    q, pool = _bf(8, 1, 8, 2, HD), _bf(513, 16, 8, HD)
    table = torch.zeros((8, 262), dtype=torch.int32)
    pos = torch.zeros((8, 1), dtype=torch.int32)
    tfa.paged_decode_launch(q, pool, pool, table, pos, kind="local",
                            window=1024)
    ((lib, fn, args),) = intercepted
    assert fn == "k6_paged_decode"
    assert args[8:20] == (8, 8, 1, 2, HD, 262, 16, 131, 5, HD ** -0.5,
                          tfa.MASK_CODES["local"], 1024)
    assert _cuda.LAUNCHES["paged_decode:local+hd256"] == 1


@pytest.mark.parametrize("rows,n_tiles,hd,want", [
    (16, 131, 256, 17),    # gemma3's fixed loop: B 2 x KV 8
    (64, 131, 256, 5),     # gemma3's scheduler decode: 8 lanes x KV 8
    (16, 131, 128, 33),    # the same rows at hd 128 fill 4 blocks an SM
    (64, 131, 128, 9),
    (4096, 131, 256, 1),
    (1, 3, 256, 3)])
def test_decode_splits_count_the_blocks_that_fit_at_hd(rows, n_tiles, hd,
                                                       want):
    """One wave of the blocks that fit an SM at the row's head dim (the
    decode ring: 4 at hd <= 128, 2 at hd 256); at hd <= 128 it is
    ``default_splits``."""
    assert tfa.decode_blocks_per_sm(hd) == (2 if hd == 256 else 4)
    got = tfa.decode_splits(rows, n_tiles, H100_SMS, hd)
    assert got == want and 1 <= got <= n_tiles
    full = tfa.decode_blocks_per_sm(hd) * H100_SMS
    assert rows * got >= full or got == n_tiles or rows >= full
    assert rows * (got - 1) < full
    if hd <= 128:
        assert got == tfa.default_splits(rows, n_tiles, H100_SMS)


def test_head_dim_512_still_raises(intercepted):
    q, k = _bf(1, 8, 2, 512), _bf(1, 8, 2, 512)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.dense_decode_launch(_bf(1, 1, 2, 1, 512), k, k, 3)
    pool = _bf(3, 16, 2, 512)
    table = torch.zeros((1, 2), dtype=torch.int32)
    for s_q in (1, 4):
        with pytest.raises(ValueError, match="head_dim"):
            tfa.paged_decode_launch(_bf(1, s_q, 2, 1, 512), pool, pool,
                                    table, torch.zeros((1, s_q),
                                                       dtype=torch.int32))
    assert intercepted == []


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def _cfgs(**over):
    over = dict(head_dim=HD, **over)
    return (dataclasses.replace(jax_config(ARCH, smoke=True), **over),
            dataclasses.replace(get_config(ARCH, smoke=True), **over))


def _models(compute_dtype="float32"):
    jcfg, tcfg = _cfgs(compute_dtype=compute_dtype)
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


def test_convert_maps_six_period_groups_and_tail():
    """Period 6 with a tail of two blocks (8 layers): group 0's block i is
    layer i, tail block i layer 6 + i; layer 5 is the global one."""
    jcfg, tcfg = _cfgs(n_layers=8)
    params = jax.tree.map(np.asarray,
                          JaxModel(jcfg, make_mesh(1, 1)).init_params(3))
    assert sorted(params["groups"]) == [f"b{i}" for i in range(6)]
    params["tail"]["t1"]["ln2"] = np.full_like(params["tail"]["t1"]["ln2"], 7)
    sd = from_jax_params(tcfg, params)
    for i in range(6):
        np.testing.assert_array_equal(
            sd[f"blocks.{i}.attn.wqkv"].float().numpy(),
            np.asarray(params["groups"][f"b{i}"]["attn"]["wqkv"][0],
                       np.float32))
    np.testing.assert_array_equal(
        sd["blocks.6.ffn.up"].float().numpy(),
        np.asarray(params["tail"]["t0"]["ffn"]["up"][0], np.float32))
    assert torch.all(sd["blocks.7.ln2"] == 7)
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(sd)
    assert [tcfg.kind(i) for i in range(8)] == ["local"] * 5 + [
        "global", "local", "local"]
    assert tm._theta("global") == 1e6 and tm._theta("local") == 1e4


PROMPT, STEPS = 24, 6


def test_fixed_loop_logits_match_reference():
    """prefill then decode steps at fp32 compute (K4 local and global at
    hd 256, the ring, K5 at hd 256, the dual theta), fed the reference's
    greedy tokens: the prefill logits within 1e-4 of their scale; the
    decode steps within twice the reference's own bf16 rounding noise (the
    distance between its bf16- and fp32-compute runs), the budget of
    test_torch_gemma2.py, since the fixed loop stores K/V in bf16."""
    jm, params, tm = _models()
    anchor = JaxModel(dataclasses.replace(jm.cfg, compute_dtype="bfloat16"),
                      jm.mesh)
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab, (2, PROMPT)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, PROMPT + STEPS))(
        params, batch)
    al, acache = jax.jit(lambda p, b: anchor.prefill(p, b, PROMPT + STEPS))(
        params, batch)
    tl, tcache = tm.prefill(torch.from_numpy(toks), PROMPT + STEPS)
    assert _rel_err(tl, jl) <= 1e-4
    errs, noise = [], [_rel_err(jl, al)]
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
    assert max(errs) <= 2.0 * max(noise), (errs, noise)


_GEOM = dict(n_lanes=3, page_size=8, prefill_chunk=8, max_seq_len=64)
_REQS = [(21, 6), (40, 4), (17, 6), (33, 3), (26, 5)]   # (prompt, max_new)


def _forced(prompt, k, chunk_fn, decode_fn, picks, vocab):
    """The scheduler's math for one request on one lane, fed ``picks``:
    the prompt in chunks of ``prefill_chunk`` through page pools, then k
    decode steps.  ``chunk_fn(tokens, positions, table, last)`` and
    ``decode_fn(token, positions, table)`` take numpy arrays and return
    logits; returns the ``vocab`` logits that pick the request's token
    k."""
    ps, chunk, s = _GEOM["page_size"], _GEOM["prefill_chunk"], len(prompt)
    table = np.arange(-(-(s + k + 1) // ps), dtype=np.int32)[None]
    for c0 in range(0, s, chunk):
        n = min(chunk, s - c0)
        tk = np.zeros((1, chunk), np.int32)
        tk[0, :n] = prompt[c0:c0 + n]
        pos = np.full((1, chunk), -1, np.int32)
        pos[0, :n] = np.arange(c0, c0 + n)
        logits = chunk_fn(tk, pos, table, np.array([n - 1], np.int32))
    for i in range(k):
        logits = decode_fn(np.array([[picks[i]]], np.int32),
                           np.array([s + i], np.int32), table)
    return np.asarray(logits, np.float64)[0, :vocab]


def _forced_ref(jm, params, prompt, picks, k):
    """``_forced`` on the reference, compiled as its engine runs it (its
    int8 scale differs between compiled and eager: ROADMAP F4)."""
    from repro.models import param as jpm
    n_pages = -(-(len(prompt) + k + 1) // _GEOM["page_size"])
    state = {"c": jpm.initialize(jm.paged_cache_defs(
        n_pages, _GEOM["page_size"]), 0)}
    j_chunk, j_decode = jax.jit(jm.prefill_chunk), jax.jit(
        jm.decode_step_paged)

    def chunk_fn(tk, pos, table, last):
        out, state["c"] = j_chunk(params, state["c"], jnp.asarray(tk),
                                  jnp.asarray(pos), jnp.asarray(table),
                                  jnp.asarray(last))
        return out

    def decode_fn(tok, pos, table):
        out, state["c"] = j_decode(params, state["c"], jnp.asarray(tok),
                                   jnp.asarray(pos), jnp.asarray(table))
        return out
    return _forced(prompt, k, chunk_fn, decode_fn, picks, jm.cfg.vocab)


def _forced_port(tm, prompt, picks, k):
    """``_forced`` on the port's plain versions."""
    cache = tm.new_paged_cache(-(-(len(prompt) + k + 1)
                                 // _GEOM["page_size"]), _GEOM["page_size"])

    def chunk_fn(tk, pos, table, last):
        return tm.prefill_chunk(cache, *(torch.from_numpy(a) for a in
                                         (tk, pos, table, last)))[0].numpy()

    def decode_fn(tok, pos, table):
        return tm.decode_step_paged(cache, *(torch.from_numpy(a) for a in
                                             (tok, pos, table)))[0].numpy()
    return _forced(prompt, k, chunk_fn, decode_fn, picks, tm.cfg.vocab)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_engine_greedy_tokens_match_reference(int8):
    """The scheduler (``submit``/``drain``): five requests with prompts
    longer than the window through three lanes, against the reference's
    scheduler, token for token, with float and with int8 weights, up to a
    near tie.  At fp32 compute the two sides' K/V differ in the last fp32
    bits, and the bf16 page pools round a few elements apart (one bf16
    ulp), more of them at hd 256, and int8 activations a few elements a
    grid step apart; the tripled weights carry that to a few 1e-3 of the
    logit scale (1e-2 with int8), enough to flip a near tie.  So where a
    request's tokens part, the step is recomputed fed the reference's
    picks (``_forced_ref``, ``_forced_port``): the two sides' logits must
    differ by at most twice the reference's own rounding noise there (its
    distance from the same step at bf16 compute, the consistency rule of
    ``test_fixed_loop_logits_match_reference``), and the reference's
    logit for its pick may exceed its logit for the port's by at most
    twice that difference (a flip the difference explains;
    ``chip_smoke.py``'s card-against-CPU rule).  The request is compared
    no further; every token before it is equal, and at least three in
    four tokens are compared equal."""
    jm, params, tm = _models()
    anchor = JaxModel(dataclasses.replace(jm.cfg, compute_dtype="bfloat16"),
                      jm.mesh)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jm.cfg.vocab, n).astype(np.int32)
               for n, _ in _REQS]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JServeEngine(jm, params, JServeConfig(int8=int8, **_GEOM))
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
    equal = 0
    for i in got:
        assert got[i].status == want[i].status == STATUS_OK
        g, w = got[i].tokens, want[i].tokens
        assert g.shape == w.shape
        part = np.flatnonzero(g != w)
        k = int(part[0]) if part.size else g.size
        equal += k
        if k == g.size:
            continue
        jl = _forced_ref(jm, jeng.params, prompts[i], w, k)
        al = _forced_ref(anchor, jeng.params, prompts[i], w, k)
        tl = _forced_port(teng.model, prompts[i], w, k)
        assert int(np.argmax(jl)) == w[k]
        diff = float(np.abs(jl - tl).max())
        assert diff <= 2 * float(np.abs(jl - al).max()), (i, k)
        assert jl[w[k]] - jl[g[k]] <= 2 * diff, (i, k, diff)
    assert equal >= 0.75 * sum(new for _, new in _REQS)
    assert len({t for o in got.values() for t in o.tokens.tolist()}) > 3


def test_fixed_loop_greedy_tokens_match_reference():
    """``generate_with_status_fixed`` (dense cache, ring for the local
    layers) against the reference's same path, token for token."""
    jm, params, tm = _models()
    toks = np.random.default_rng(2).integers(
        0, jm.cfg.vocab, (2, PROMPT)).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JServeEngine(jm, params, JServeConfig(max_new_tokens=STEPS))
    want = jeng.generate_with_status_fixed(
        {"tokens": jnp.asarray(toks)}).tokens
    res = ServeEngine(tm, ServeConfig(max_new_tokens=STEPS)
                      ).generate_with_status_fixed(
        {"tokens": torch.from_numpy(toks)})
    assert list(res.status) == [STATUS_OK] * 2
    assert res.tokens.shape == (2, STEPS)
    np.testing.assert_array_equal(res.tokens, want)
    assert len(set(res.tokens[0].tolist())) > 1, "degenerate greedy stream"
