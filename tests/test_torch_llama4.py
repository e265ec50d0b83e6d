"""llama4-scout's path through the port against the JAX reference, on the
CPU: the config copy, the 'chunked' kind in the plain versions of K4 and
K6 and K4's 'prefix' kind against the reference's Pallas kernels (in
interpret mode) and its oracles, the MoE FFN against the reference's
``moe_apply``, the new variants' launch arguments and counts (intercepted
at ``kernels._cuda.launch``: the CUDA kernels run only on the card, where
``chip_smoke.py`` holds them to these plain versions), and the smoke
config (4 layers, 3 'chunked' to 1 global, window 16, 4 experts top-1
with a shared expert) served through the fixed loop and the scheduler.

Tolerances are the gemma3 tests': kernel outputs in bf16 within two bf16
ulps of each row's own scale against the reference's Pallas kernels in
interpret mode (online softmax against one softmax, or another tiling,
then the bf16 cast), one ulp against its tiled XLA mirror (the same
tiles), fp32 outputs within 1e-5 of their scale.  The MoE's dispatch
(sorted tokens, slots, kept flags) is exactly the reference's, its
outputs within 1e-5 at fp32.  Slice level, at fp32 compute with the same
parameters on both sides (``convert.from_jax_params``; norm scales drawn
from a numpy seed and block weights tripled so that greedy tokens vary),
prefill logits agree within 1e-4 of their scale and greedy tokens
exactly, with prompts past several chunk boundaries.
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
from repro.kernels import ref as jref
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
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import Model
from repro_torch.robust.guards import STATUS_OK
from repro_torch.serve.api import Request, SamplingParams
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

BF16_EPS = float(torch.finfo(torch.bfloat16).eps)
ARCH = "llama4-scout-17b-a16e"
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


def _jx(t: torch.Tensor):
    a = jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16
                    else t.numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _row_err(got: torch.Tensor, want) -> float:
    g = got.double().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = np.maximum(np.abs(w).max(-1), 1e-3)
    return float((np.abs(g - w).max(-1) / scale).max())


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_is_the_reference_copy(smoke):
    """Every field of the port's ``ArchConfig`` (the MoE fields included)
    equals the reference's, and so do the parameter count and the layer
    kinds."""
    got, want = get_config(ARCH, smoke=smoke), jax_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(ArchConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.param_count() == want.param_count()
    assert [got.kind(i) for i in range(got.n_layers)] == [
        want.block_pattern[i % want.pattern_period]
        for i in range(want.n_layers)]
    assert ARCH in ARCH_IDS


def test_eight_layers_fit_one_card():
    """The depth cut: 8 of 48 layers, 18.65 B parameters (2.20 B a layer,
    16 experts of 3 x 5120 x 8192 each), 37.3 GB in bf16; full width
    otherwise.  The scheduler's lanes pass the 8192-position chunk."""
    cfg = tserve.with_layers(get_config(ARCH), 8)
    assert cfg == dataclasses.replace(get_config(ARCH), n_layers=8)
    assert tserve.with_layers(get_config(ARCH), None) is get_config(ARCH)
    with pytest.raises(ValueError):
        tserve.with_layers(get_config(ARCH), 49)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (
        5120, 40, 8, 128)
    assert 2 * cfg.param_count() == 37_303_265_280
    assert [cfg.kind(i) for i in range(8)] == (
        ["chunked"] * 3 + ["global"]) * 2
    geom = tserve.geometry(ARCH)
    assert geom == tserve.LLAMA4_GEOMETRY
    assert geom["max_seq_len"] >= 8180 + 32 > cfg.window
    # the attention-only int8 copy (0.51 GB) fits beside the bf16 model
    assert tserve.int8_fits(cfg, torch.device("cuda"), True, total=80e9)
    assert tserve.int8_peak_bytes(cfg, True) < 2 * cfg.param_count() + 6e8


# ---------------------------------------------------------------------------
# K4 'chunked' and 'prefix' in the plain version
# ---------------------------------------------------------------------------

K4_CASES = [
    # the reference test's cases (tests/test_flash_attention.py:101-110)
    (1, 10, 4, 2, 16, "chunked", dict(window=4), 8),
    (1, 10, 4, 2, 16, "prefix", dict(prefix_len=3), 8),
    # G = 5 at hd 128, chunk boundaries inside the tiles
    (2, 40, 10, 2, 128, "chunked", dict(window=16), 8),
    # window 16 against tiles of 128: eight boundaries inside one q tile
    (1, 150, 2, 1, 16, "chunked", dict(window=16), 128),
    # prefix_len off a tile edge, and past the diagonal of early tiles
    (2, 37, 5, 1, 32, "prefix", dict(prefix_len=13), 8),
    (1, 150, 4, 2, 16, "prefix", dict(prefix_len=77), 128),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,n_h,n_kv,hd,kind,extra,block", K4_CASES)
def test_k4_new_kinds_match_pallas_interpret(b, sq, n_h, n_kv, hd, kind,
                                             extra, block, dtype):
    rng = np.random.default_rng(sq + n_h + hd)
    jq, tq = _pair(rng, (b, sq, n_h, hd), dtype)
    jk, tk = _pair(rng, (b, sq, n_kv, hd), dtype)
    jv, tv = _pair(rng, (b, sq, n_kv, hd), dtype)
    want = jfa.flash_attention_pallas(jq, jk, jv, kind=kind, block_q=block,
                                      block_k=block, interpret=True, **extra)
    got = ops.flash_attention(tq, tk, tv, kind=kind, **extra)
    assert got.dtype == _T[dtype] and got.shape == tq.shape
    assert _row_err(got, want) <= (1e-5 if dtype == "float32"
                                   else 2 * BF16_EPS)


@pytest.mark.parametrize("b,sq,n_h,n_kv,hd,kind,extra,block", K4_CASES)
def test_k4_new_kinds_match_reference_oracle(b, sq, n_h, n_kv, hd, kind,
                                             extra, block):
    """The plain version's mask term for term: against the reference's
    oracle ``ref.flash_attention_ref`` at fp32, and the port's
    ``attention_mask`` equal to ``attention_mask_ref`` bit for bit."""
    rng = np.random.default_rng(3 * sq + hd)
    jq, tq = _pair(rng, (b, sq, n_h, hd), "float32")
    jk, tk = _pair(rng, (b, sq, n_kv, hd), "float32")
    jv, tv = _pair(rng, (b, sq, n_kv, hd), "float32")
    want = jref.flash_attention_ref(jq, jk, jv, kind=kind, **extra)
    got = ref.flash_attention_ref(tq, tk, tv, kind=kind, **extra)
    assert _row_err(got, want) <= 1e-5
    qpos, kpos = np.arange(-1, sq), np.arange(sq)
    np.testing.assert_array_equal(
        ref.attention_mask(torch.from_numpy(qpos), torch.from_numpy(kpos),
                           kind, extra.get("window", 0),
                           extra.get("prefix_len", 0)).numpy(),
        np.asarray(jref.attention_mask_ref(jnp.asarray(qpos),
                                           jnp.asarray(kpos), kind=kind,
                                           **extra)))


# ---------------------------------------------------------------------------
# K6 'chunked' in the plain version
# ---------------------------------------------------------------------------

def _paged_case(s_q, seed=0, ps=16, kv=2, g=5, hd=16, last=(3, 15, 16, 50,
                                                            95, -1)):
    """Pools with shuffled pages, lanes at positions on both sides of the
    window-16 chunk boundaries, the last lane idle, unmapped (-1) pages
    past each lane's length."""
    rng = np.random.default_rng(seed)
    n_lanes, p_max = len(last), -(-96 // ps)
    n_pages = n_lanes * p_max
    bf = torch.bfloat16

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(bf)
    kp, vp = rand(n_pages + 1, ps, kv, hd), rand(n_pages + 1, ps, kv, hd)
    last = np.array(last)
    table = rng.permutation(n_pages).reshape(n_lanes, p_max).astype(np.int32)
    for lane, p in enumerate(last):
        table[lane, max(p, 0) // ps + 1:] = -1
    pos = last[:, None] - (s_q - 1) + np.arange(s_q)[None]
    pos = np.where((last[:, None] >= 0) & (pos >= 0), pos, -1)
    q = rand(n_lanes, s_q, kv, g, hd, scale=3.0)
    return (q, kp, vp, torch.from_numpy(table),
            torch.from_numpy(pos.astype(np.int32)))


@pytest.mark.parametrize("s_q", [1, 6, 20])
@pytest.mark.parametrize("window", [16, 5])
def test_k6_chunked_matches_reference_mirror(window, s_q):
    """Decode steps and prefill chunks against the reference's tiled XLA
    mirror (the same 32-slot tiles) at G = 5: one bf16 ulp of each row's
    scale, the idle lane exactly 0.0."""
    args = _paged_case(s_q, seed=s_q + window)
    got = ops.paged_flash_decode(*args, kind="chunked", window=window)
    want = jfa.paged_flash_decode_xla(*(_jx(a) for a in args),
                                      kind="chunked", window=window)
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    assert _row_err(got, want) <= BF16_EPS
    assert torch.all(got[-1] == 0), "the idle lane is not exactly 0.0"


def test_k6_chunked_within_budget_of_pallas_interpret():
    """The reference's Pallas kernel tiles one page per tile (ROADMAP F2):
    held within a budget, never bitwise."""
    args = _paged_case(1, seed=3)
    got = ops.paged_flash_decode(*args, kind="chunked", window=16)
    q, kp, vp, table, pos = (_jx(a) for a in args)
    want = jfa.paged_flash_decode_pallas(q, kp, vp, table, pos.reshape(-1),
                                         kind="chunked", window=16,
                                         interpret=True)
    assert _row_err(got, want) <= 2 * BF16_EPS


@pytest.mark.parametrize("s_q", [1, 6])
def test_k6_chunked_neighbour_isolation_bitwise(s_q):
    """Lane 1's output is bitwise independent of its neighbours' pages and
    positions (the reference's ``test_paged_neighbor_isolation_bitwise``
    with 'chunked')."""
    q, kp, vp, table, pos = _paged_case(s_q, seed=9)
    a = ops.paged_flash_decode(q, kp, vp, table, pos, kind="chunked",
                               window=16)
    others = torch.arange(table.shape[0]) != 1
    table2, pos2 = table.clone(), pos.clone()
    table2[others] = torch.roll(table[others], 1, dims=1)
    pos2[others] = torch.where(pos[others] >= 0, pos[others] // 2, -1)
    b = ops.paged_flash_decode(q, kp, vp, table2, pos2, kind="chunked",
                               window=16)
    assert torch.equal(a[1], b[1])


def test_chunked_ring_decode_matches_reference():
    """A chunked layer's dense decode is the ring buffer (the reference's
    ``decode_attention_einsum``): positions in the chunk of ``pos`` only,
    also after the ring has wrapped."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(4)
    jq, tq = _pair(rng, (2, 1, 2, 5, 16))
    jk, tk = _pair(rng, (2, 16, 2, 16))
    jv, tv = _pair(rng, (2, 16, 2, 16))
    for pos in (3, 15, 16, 40, 47):
        want = jattn.decode_attention_einsum(jq, jk, jv, jnp.int32(pos),
                                             kind="chunked", window=16)
        got = tattn.decode_attention_ring(tq, tk, tv, pos, kind="chunked",
                                          window=16)
        assert _row_err(got, want) <= BF16_EPS, pos


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


@pytest.mark.parametrize("shape,var,key,mask", [
    ((2, 8448, 40, 8, 128), dict(kind="chunked", window=8192),
     "flash_attention:chunked", (3, 8192, 0)),
    ((4, 512, 8, 1, 256), dict(kind="prefix", prefix_len=256),
     "flash_attention:prefix+hd256", (4, 0, 256))])
def test_k4_new_kind_launch(intercepted, shape, var, key, mask):
    """llama4's fixed prefill (2 x 8448, 40 q heads over 8, hd 128) and
    paligemma's would-be prefix shape (256 patches + 256 tokens, 8 heads
    over 1, hd 256) reach K4 with one mask code, the window and the prefix
    length, and count under their variants."""
    b, s, h, kv, hd = shape
    tfa.flash_attention_cuda(_bf(b, s, h, hd), _bf(b, s, kv, hd),
                             _bf(b, s, kv, hd), **var)
    ((lib, fn, args),) = intercepted
    assert (lib, fn) == ("flash_attention", "k4_flash_prefill")
    assert len(args) + 1 == len(_cuda.SIGNATURES[lib][fn])
    assert args[4:] == (b, s, s, h, kv, hd, hd ** -0.5, *mask, 0.0)
    assert _cuda.LAUNCHES["flash_attention"] == 1
    assert _cuda.LAUNCHES[key] == 1


def test_mask_args_refuse_what_the_kernels_do_not_take():
    assert tfa.mask_args("chunked", 16) == (3, 16, 0)
    assert tfa.mask_args("global", 16, 7) == (0, 0, 0)
    assert tfa.mask_args("prefix", 0, 7) == (4, 0, 7)
    for kind in ("chunked", "local"):
        with pytest.raises(ValueError):
            tfa.mask_args(kind, 0)
    with pytest.raises(ValueError):
        tfa.mask_args("prefix", 0, -1)
    with pytest.raises(NotImplementedError):
        tfa.mask_args("prefix", 0, 7, kinds=ref.PAGED_KINDS)


def test_k6_chunked_launches_at_g5(intercepted):
    """The scheduler at llama4's geometry (8 lanes, KV 8, G 5, page 16,
    514 pages a lane): a decode step on K6's decode body (``head_groups(5)``
    one row of 5 heads) and a 64-position chunk on its chunk body
    (``chunk_tiles(64, 5)``: q tiles of 25, 25 and 14 positions), each with
    the chunked mask code and the window."""
    assert tfa.head_groups(5) == (1, 5)
    assert tfa.chunk_tiles(64, 5) == (25, 3)
    pool = _bf(1025, 16, 8, 128)
    table = torch.zeros((8, 514), dtype=torch.int32)
    out, ws = tfa.paged_decode_launch(_bf(8, 1, 8, 5, 128), pool, pool,
                                      table,
                                      torch.zeros((8, 1), dtype=torch.int32),
                                      kind="chunked", window=8192)
    assert ws.shape == (64, 257, tfa._workspace(1, 1, 5, 128, "cpu")
                        .shape[-1])
    out, ws = tfa.paged_decode_launch(_bf(8, 64, 8, 5, 128), pool, pool,
                                      table,
                                      torch.zeros((8, 64), dtype=torch.int32),
                                      kind="chunked", window=8192)
    assert ws is None
    (_, dec, dargs), (_, chk, cargs) = intercepted
    assert dec == "k6_paged_decode" and chk == "k6_paged_chunk"
    assert dargs[8:13] == (8, 8, 1, 5, 128)
    assert dargs[17:20] == (128 ** -0.5, 3, 8192)
    assert cargs[6:11] == (8, 64, 8, 5, 128)
    assert cargs[14:17] == (128 ** -0.5, 3, 8192)
    assert _cuda.LAUNCHES["paged_decode:chunked"] == 1
    assert _cuda.LAUNCHES["paged_decode:chunked+chunk"] == 1


@pytest.fixture
def forced_wrappers(intercepted, monkeypatch):
    """Every kernel entry point of ``kernels.ops`` routed to its CUDA
    wrapper on CPU tensors, up to the launch (``test_torch_whisper.py``'s
    rehearsal, with the paged kernel too): each wrapper's own checks run,
    and ``_cuda.check`` holds dtype, shape, contiguity and 16-byte
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
    routed.flash_attention_ref = tfa.flash_attention_cuda
    monkeypatch.setattr(ops, "ref", routed)
    monkeypatch.setattr(ops, "rms_normalize", lambda x, scale, eps: (
        tmm.rmsnorm_cuda(x.reshape(-1, x.shape[-1]), scale, eps)
        .reshape(x.shape)))
    monkeypatch.setattr(ops, "flash_decode_tiled",
                        lambda q, k, v, pos, softcap, kind:
                        tfa.flash_decode_cuda(q, k, v, pos, None, softcap,
                                              kind))
    monkeypatch.setattr(ops, "paged_flash_decode_tiled",
                        tfa.paged_flash_decode_cuda)
    return intercepted


def _smoke_bf16():
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              param_dtype="bfloat16")
    return Model(cfg, device="cpu").init_weights(0)


def test_served_path_hands_the_kernels_valid_tensors(forced_wrappers):
    """The smoke model in bf16 through the fixed loop's prefill and one
    decode step, then a scheduler chunk and decode step, every kernel
    call through its wrapper with tensors it takes.  One decode iteration
    of each: the row-norm kernel 1 + 2 L times (the entry norm, each
    ``ln2`` and each standalone next norm after the MoE), no norm tail;
    the fixed loop's K5 on the global layers only (the chunked layers
    decode their ring in plain torch), the scheduler's K6 'chunked' on the
    chunked layers and K6 global on the other."""
    model = _smoke_bf16()
    cfg, n = model.cfg, model.cfg.n_layers
    logits, cache = model.prefill(torch.zeros((2, 40), dtype=torch.long), 44)
    assert logits.shape == (2, cfg.padded_vocab())
    assert _cuda.LAUNCHES["flash_attention:chunked"] == 3
    assert _cuda.LAUNCHES["flash_attention"] == 4
    _cuda.reset_launches()
    for key in [k for k in _cuda.LAUNCHES if ":" in k]:
        del _cuda.LAUNCHES[key]
    model.decode_step(cache, torch.zeros((2, 1), dtype=torch.long), 40)
    want = {"rmsnorm": 2 * n + 1, "matmul:norm": 0, "flash_decode": 1,
            "flash_attention": 0, "paged_decode": 0}
    assert {k: _cuda.LAUNCHES.get(k, 0) for k in want} == want
    pools = model.new_paged_cache(16, 8)
    table = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    pos = torch.arange(32, dtype=torch.int32).reshape(2, 16)
    _cuda.reset_launches()
    model.prefill_chunk(pools, torch.zeros((2, 16), dtype=torch.long), pos,
                        table, torch.full((2,), 15, dtype=torch.int32))
    assert _cuda.LAUNCHES["paged_decode:chunked+chunk"] == 3
    assert _cuda.LAUNCHES["paged_decode:chunk"] == 1
    _cuda.reset_launches()
    for key in [k for k in _cuda.LAUNCHES if ":" in k]:
        del _cuda.LAUNCHES[key]
    model.decode_step_paged(pools, torch.zeros((2, 1), dtype=torch.long),
                            torch.tensor([16, 31], dtype=torch.int32), table)
    want = {"rmsnorm": 2 * n + 1, "matmul:norm": 0, "paged_decode": n,
            "paged_decode:chunked": 3, "flash_decode": 0}
    assert {k: _cuda.LAUNCHES.get(k, 0) for k in want} == want


# ---------------------------------------------------------------------------
# the MoE FFN against the reference
# ---------------------------------------------------------------------------

def _moe_pair(jcfg, cfg, n_tokens, seed):
    """The reference's MoE parameters (its init of ``jcfg``, the router
    scaled up so that routing is uneven) and tokens x [1, n, D] at fp32,
    and the port's ``MoE`` of ``cfg`` on the same values."""
    jm = JaxModel(jcfg, make_mesh(1, 1))
    params = jax.tree.map(np.asarray, jm.init_params(seed))
    p = {k: v[0] for k, v in params["groups"]["b0"]["ffn"].items()}
    p["router"] = p["router"] * np.float32(8)
    moe = tmoe.MoE(cfg, torch.float32, torch.device("cpu"))
    moe.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()})
    x = np.random.default_rng(seed).standard_normal(
        (1, n_tokens, cfg.d_model)).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in p.items()}, moe, x


@pytest.mark.parametrize("cf,n_tokens", [(8.0, 48), (0.5, 48), (0.5, 200)],
                         ids=["no-drop", "overflow", "overflow-long"])
def test_moe_apply_matches_reference(cf, n_tokens):
    """At fp32: the capacity, the dispatch (tokens sorted by expert, their
    slots, the kept flags) exactly the reference's, the output within
    1e-5 of its scale and the aux loss within 1e-6; with ``cf`` 0.5 the 4
    experts' capacity holds fewer slots than there are tokens, so some
    overflow their expert and pass through as 0.0."""
    over = dict(capacity_factor=cf, compute_dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **over)
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **over)
    jp, moe, x = _moe_pair(jcfg, cfg, n_tokens, seed=n_tokens)
    cap = tmoe.capacity(n_tokens, cfg)
    assert cap == jmoe._capacity(n_tokens, jcfg, 1)
    xt = x.reshape(n_tokens, -1)
    jprobs = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    _, jst, jdest, _, jkeep = jmoe._dispatch_one_shard(
        jnp.asarray(xt), jprobs, cap, cfg.n_experts, 1, jnp.float32)
    probs = tmoe.router_probs(torch.from_numpy(xt), moe.router)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6)
    st, dest, keep = tmoe.dispatch(torch.argmax(probs, -1), cfg.n_experts,
                                   cap)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    ctx = TPCtx(mesh=make_mesh(1, 1), sp=False, compute_dtype=jnp.float32)
    jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, ctx)
    got = tmoe.moe_apply(moe, torch.from_numpy(x), cfg, torch.float32)
    w = np.asarray(jout, np.float64)
    assert float(np.abs(got.out.double().numpy() - w).max()) \
        <= 1e-5 * max(1.0, float(np.abs(w).max()))
    assert abs(float(got.aux) - float(jaux)) <= 1e-6
    dropped = int((~got.kept).sum())
    assert dropped == int((~np.asarray(jkeep)).sum())
    assert (dropped == 0) == (cf == 8.0)


def test_convert_carries_the_moe_tree():
    """The reference's stacked MoE leaves land under ``blocks.<i>.ffn``
    at their own shapes (no xyz layout), the router at fp32."""
    jcfg = jax_config(ARCH, smoke=True)
    tcfg = get_config(ARCH, smoke=True)
    params = jax.tree.map(np.asarray,
                          JaxModel(jcfg, make_mesh(1, 1)).init_params(3))
    sd = from_jax_params(tcfg, params)
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(sd)
    ffn = params["groups"]["b2"]["ffn"]
    assert sorted(ffn) == sorted(name for name, _ in
                                 tm.blocks[2].ffn.named_parameters())
    for name in ffn:
        np.testing.assert_array_equal(
            getattr(tm.blocks[2].ffn, name).float().numpy(), ffn[name][0])
    assert tm.blocks[2].ffn.router.dtype == torch.float32
    assert tm.blocks[1].ffn.w_down.shape == (4, 128, 64)


def test_int8_moe_is_refused():
    """No longer refused: an MoE model's int8 copy quantizes the
    attention's ``wqkv`` and ``wo`` and shares the MoE, as the reference's
    pass does (``test_torch_int8_models.py`` holds it to the reference).
    The engine serves that copy."""
    tm = Model(get_config(ARCH, smoke=True), device="cpu").init_weights(0)
    q = tm.quantize_params_for_serving()
    assert q.int8 and all(b.ffn is a.ffn for a, b in zip(tm.blocks,
                                                         q.blocks))
    eng = ServeEngine(tm, ServeConfig(int8=True))
    assert eng.model.int8 and eng.fp_model is None


# ---------------------------------------------------------------------------
# the slice against the reference
# ---------------------------------------------------------------------------

def _models(compute_dtype="float32", **over):
    over = dict(compute_dtype=compute_dtype, **over)
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **over)
    jm = JaxModel(jcfg, make_mesh(1, 1))
    params = jax.tree.map(np.asarray, jm.init_params(0))
    rng = np.random.default_rng(7)
    grp = params["groups"]
    for b in grp:
        for name in ("ln1", "ln2"):
            grp[b][name] = (0.5 * rng.standard_normal(grp[b][name].shape)
                            ).astype(np.float32)
        for sub in ("attn", "ffn"):
            for name, w in grp[b][sub].items():
                grp[b][sub][name] = w * w.dtype.type(3)
    params["final_norm"] = (0.5 * rng.standard_normal(
        params["final_norm"].shape)).astype(np.float32)
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(from_jax_params(tcfg, params))
    return jm, jax.tree.map(jnp.asarray, params), tm


def _rel_err(got, want) -> float:
    g = np.asarray(got.double() if torch.is_tensor(got) else got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w)) / max(1.0, np.max(np.abs(w))))


PROMPT, STEPS = 40, 6


def test_prefill_logits_match_reference():
    """The smoke slice's prefill at fp32 compute (K4 chunked and global,
    the MoE in every layer), prompts past two chunk boundaries: the
    logits within 1e-4 of their scale."""
    jm, params, tm = _models()
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab, (2, PROMPT)).astype(np.int32)
    jl, _ = jax.jit(lambda p, b: jm.prefill(p, b, PROMPT + STEPS))(
        params, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.prefill(torch.from_numpy(toks), PROMPT + STEPS)
    assert _rel_err(tl, jl) <= 1e-4
    assert len(tm.moe_kept) == tm.cfg.n_layers


def test_fixed_loop_greedy_tokens_match_reference():
    """``generate_with_status_fixed`` (dense cache, the ring for the
    chunked layers) against the reference's same path, token for token,
    the decode crossing the chunk boundary at 48."""
    jm, params, tm = _models()
    toks = np.random.default_rng(2).integers(
        0, jm.cfg.vocab, (2, PROMPT + 4)).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JServeEngine(jm, params, JServeConfig(max_new_tokens=STEPS))
    want = jeng.generate_with_status_fixed(
        {"tokens": jnp.asarray(toks)}).tokens
    res = ServeEngine(tm, ServeConfig(max_new_tokens=STEPS)
                      ).generate_with_status_fixed(
        {"tokens": torch.from_numpy(toks)})
    assert list(res.status) == [STATUS_OK] * 2
    np.testing.assert_array_equal(res.tokens, want)
    assert len(set(res.tokens[0].tolist())) > 1, "degenerate greedy stream"


_GEOM = dict(n_lanes=3, page_size=8, prefill_chunk=8, max_seq_len=64)
_REQS = [(21, 6), (40, 4), (17, 6), (33, 3), (26, 5)]   # (prompt, max_new)


def _serve_both(jm, params, tm, prompts, news):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JServeEngine(jm, params, JServeConfig(**_GEOM))
    for i, (p, new) in enumerate(zip(prompts, news)):
        jeng.submit(JRequest(id=i, tokens=p, sampling=JSamplingParams(
            max_new_tokens=new)))
    want = {o.id: o for o in jeng.drain()}
    teng = ServeEngine(tm, ServeConfig(**_GEOM))
    for i, (p, new) in enumerate(zip(prompts, news)):
        teng.submit(Request(id=i, tokens=p, sampling=SamplingParams(
            max_new_tokens=new)))
    got = {o.id: o for o in teng.drain()}
    assert set(got) == set(want) == set(range(len(prompts)))
    return got, want


def test_scheduler_greedy_tokens_match_reference():
    """The scheduler (``submit``/``drain``): five requests with prompts
    past the chunk boundaries through three lanes (K6 'chunked' and
    global, decode and chunk, the MoE over every call's lanes), against
    the reference's scheduler, token for token."""
    jm, params, tm = _models()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jm.cfg.vocab, n).astype(np.int32)
               for n, _ in _REQS]
    got, want = _serve_both(jm, params, tm, prompts,
                            [new for _, new in _REQS])
    for i in got:
        assert got[i].status == want[i].status == STATUS_OK
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
    assert len({t for o in got.values() for t in o.tokens.tolist()}) > 3


def test_a_lanes_tokens_depend_on_its_neighbours_under_moe_capacity():
    """With a capacity factor that overflows (1.0), a later lane's tokens
    change when only an earlier lane's prompt changes, in the reference
    and in the port alike (ROADMAP F6: capacity is shared by the tokens of
    one call); lane 0's tokens do not."""
    jm, params, tm = _models(capacity_factor=1.0)
    rng = np.random.default_rng(11)
    base = [rng.integers(0, jm.cfg.vocab, 24).astype(np.int32)
            for _ in range(3)]
    news = [8, 8, 8]
    runs = []
    for first in (base[0], rng.integers(0, jm.cfg.vocab, 24).astype(
            np.int32)):
        prompts = [base[0], first, base[2]]
        runs.append(_serve_both(jm, params, tm, prompts, news))
    for got, want in runs:
        for i in got:
            np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
    (a, _), (b, _) = runs
    np.testing.assert_array_equal(a[0].tokens, b[0].tokens)
    assert not np.array_equal(a[2].tokens, b[2].tokens)


def test_launcher_serves_the_smoke_config(capsys):
    """``launch.serve --arch llama4-scout-17b-a16e --smoke --device cpu``
    with ``--layers`` and ``--requests``; ``--int8`` (no longer refused)
    serves the attention-only int8 copy."""
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--layers",
                 "2", "--batch", "2", "--prompt-len", "20", "--max-new",
                 "3"])
    out = capsys.readouterr().out
    assert "llama4-scout-smoke on cpu" in out and "lane 1: ok" in out
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--layers",
                 "2", "--requests", "2"])
    assert "request 1:" in capsys.readouterr().out
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--layers",
                 "2", "--batch", "2", "--prompt-len", "20", "--max-new",
                 "3", "--int8"])
    out = capsys.readouterr().out
    assert "llama4-scout-smoke int8 on cpu" in out and "lane 1: ok" in out
