"""int8 serving where the port used to refuse it, on the CPU: llama4's
attention-only int8 copy (an MoE model's reference pass quantizes only
``wqkv`` and ``wo``) against the reference, and the releasing int8 build
(``Model.quantize_params_for_serving(release=True)``) that lets
gemma2-27b's int8 copy fit one card.

Tolerances: the quantized leaves are bitwise the reference's (the eager
weight pass divides by 127 as the reference's does, ROADMAP F4).  Greedy
tokens are equal at fp32 compute, where each framework quantizes the same
fp32 activations.  The MoE shares its capacity among the tokens of one
call (ROADMAP F6), so a lane's tokens can depend on its neighbours'
wherever an expert overflows; the smoke config's capacity factor of 8
drops no token here, which each served test checks, so every lane is
held.  The releasing build is bitwise the copying one.
"""
import dataclasses
import gc
import warnings
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels.quantize import QuantizedWeight as JQuantizedWeight
from repro.launch.mesh import make_mesh
from repro.models.lm import Model as JaxModel
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.quantize import QuantizedWeight
from repro_torch.launch import serve as tserve
from repro_torch.models.lm import Model
from repro_torch.robust.guards import STATUS_OK
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

LLAMA4 = "llama4-scout-17b-a16e"
GEMMA2 = "gemma2-27b"
H100_SMS = 132


@pytest.fixture(autouse=True)
def _xla_mode():
    assert jops.kernel_mode() == "xla", "the reference must run its CPU path"


def _models(arch, compute_dtype="float32"):
    """The reference and the port on the same parameters: the reference's
    init with random norm scales and tripled block weights (so greedy
    tokens vary)."""
    over = dict(compute_dtype=compute_dtype)
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jm = JaxModel(jcfg, make_mesh(1, 1))
    params = jax.tree.map(np.asarray, jm.init_params(0))
    rng = np.random.default_rng(7)
    for grp in params["groups"].values():
        for name in ("ln1", "ln2"):
            grp[name] = (0.5 * rng.standard_normal(grp[name].shape)
                         ).astype(np.float32)
        for sub in ("attn", "ffn"):
            for name, w in grp[sub].items():
                grp[sub][name] = w * w.dtype.type(3)
    params["final_norm"] = (0.5 * rng.standard_normal(
        params["final_norm"].shape)).astype(np.float32)
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(from_jax_params(tcfg, params))
    return jm, jax.tree.map(jnp.asarray, params), tm


def _quiet(cls, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return cls(**kw)


def _no_token_dropped(model):
    assert model.moe_kept and all(bool(k.all()) for k in model.moe_kept)


@pytest.fixture(scope="module")
def llama4_models():
    """The llama4 smoke pair at fp32 compute, shared by the tests of this
    file that only read it (each builds its own engines and int8 copies;
    none changes the float model)."""
    return _models(LLAMA4)


# ---------------------------------------------------------------------------
# llama4: the attention's int8 copy, the MoE shared
# ---------------------------------------------------------------------------

def test_llama4_int8_copy_is_the_references_attention_only_pass(
        llama4_models):
    """The port's quantized ``wqkv``/``wo`` are bitwise the leaves the
    reference's ``quantize_params_for_serving`` leaves (q and the column
    scales, the eager division of F4); the FFN (router, experts, shared
    expert) and the norms are shared, untouched, and the reference's stay
    float too."""
    jm, params, tm = llama4_models
    jq = jm.quantize_params_for_serving(params)["groups"]
    q = tm.quantize_params_for_serving()
    assert q.int8 and not tm.int8
    period = jm.cfg.pattern_period
    for layer, blk in enumerate(q.blocks):
        g, i = divmod(layer, period)
        jblk = jq[f"b{i}"]
        for name in ("wqkv", "wo"):
            got, want = getattr(blk.attn, name), jblk["attn"][name]
            assert isinstance(got, QuantizedWeight)
            assert isinstance(want, JQuantizedWeight)
            np.testing.assert_array_equal(got.q.numpy(),
                                          np.asarray(want.q[g]))
            np.testing.assert_array_equal(
                got.scale.numpy().reshape(-1),
                np.asarray(want.scale[g]).reshape(-1))
        assert blk.ffn is tm.blocks[layer].ffn
        assert blk.ln1 is tm.blocks[layer].ln1
        assert not any(isinstance(v, JQuantizedWeight)
                       for v in jblk["ffn"].values())
    assert not any(isinstance(m, QuantizedWeight)
                   for blk in q.blocks for m in blk.ffn.modules())


@pytest.mark.parametrize("path", ["fixed", "shim"])
def test_llama4_int8_tokens_match_reference(llama4_models, path):
    """int8 greedy tokens through ``generate_with_status_fixed`` (the
    dense cache, the chunked layers' ring) and through
    ``generate_with_status`` (the scheduler's shim) equal the reference's
    same calls at fp32 compute, prompts past the 16-position chunks; no
    token was dropped by the MoE (F6 does not apply)."""
    jm, params, tm = llama4_models
    toks = np.random.default_rng(2).integers(
        0, jm.cfg.vocab, (2, 44)).astype(np.int32)
    jeng = JServeEngine(jm, params, _quiet(JServeConfig, max_new_tokens=6,
                                           int8=True))
    teng = ServeEngine(tm, _quiet(ServeConfig, max_new_tokens=6, int8=True))
    name = ("generate_with_status_fixed" if path == "fixed"
            else "generate_with_status")
    want = getattr(jeng, name)({"tokens": jnp.asarray(toks)})
    got = getattr(teng, name)({"tokens": torch.from_numpy(toks)})
    assert list(got.status) == list(want.status) == [STATUS_OK] * 2
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert len(set(got.tokens.reshape(-1).tolist())) > 3
    _no_token_dropped(teng.model)


@pytest.fixture
def forced_wrappers(monkeypatch):
    """Every kernel entry point of ``kernels.ops`` routed to its CUDA
    wrapper on CPU tensors, up to the launch (``test_torch_whisper.py``'s
    rehearsal, with the paged kernel): each wrapper's own checks run, and
    ``_cuda.check`` holds dtype, shape, contiguity and 16-byte alignment;
    a launch is counted and computes nothing."""
    import types

    def check(t, what, dtype, shape=None, align=16):
        assert t.dtype == dtype, (what, t.dtype)
        assert shape is None or tuple(t.shape) == tuple(shape), (what,
                                                                 t.shape)
        assert t.is_contiguous(), f"{what} must be contiguous"
        assert t.data_ptr() % align == 0, f"{what} must be aligned"
    monkeypatch.setattr(_cuda, "check", check)
    monkeypatch.setattr(_cuda, "launch", lambda lib, fn, *args: None)
    monkeypatch.setattr(tmm, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(tfa, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(tmm, "_SPLIT_SCRATCH", {})
    tmm._device_plan.cache_clear()
    tmm._device_k2_plan.cache_clear()
    routed = types.SimpleNamespace(**vars(ref))
    routed.matmul_fused_ref = tmm.matmul_cuda
    routed.int8_matmul_ref = tmm.int8_matmul_cuda
    routed.quantize_rowwise_ref = ops.quantize_rowwise_cuda
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
    before = dict(_cuda.LAUNCHES)
    yield
    _cuda.LAUNCHES.clear()
    _cuda.LAUNCHES.update(before)


def _count_from_zero():
    _cuda.reset_launches()
    for key in [k for k in _cuda.LAUNCHES if ":" in k]:
        del _cuda.LAUNCHES[key]


def test_llama4_int8_decode_launches(forced_wrappers):
    """One int8 decode iteration of the bf16 smoke model, through the
    fixed loop's dense cache and the scheduler's pools, each kernel call
    through its wrapper: the row-norm kernel 2 L + 1 times (the entry
    norm, each ``ln2`` and each standalone norm after the MoE's residual
    add, which feeds the next layer's int8 qkv GEMM), K3 and K2 twice a
    layer (``wqkv`` and ``wo``, no epilogue variant), no K1, no norm or
    quantize tail and no row-quantize launch: the counts
    ``chip_smoke.py``'s ``decode_launches`` holds on the card."""
    cfg = dataclasses.replace(get_config(LLAMA4, smoke=True),
                              param_dtype="bfloat16")
    model = Model(cfg, device="cpu").init_weights(0)
    model = model.quantize_params_for_serving()
    n = cfg.n_layers
    want = {"rmsnorm": 2 * n + 1, "int8_matmul": 2 * n, "quantize": 2 * n,
            "matmul": 0, "int8_matmul:norm": 0, "int8_matmul:quantize": 0,
            "int8_quantize": 0}
    _, cache = model.prefill(torch.zeros((2, 40), dtype=torch.long), 44)
    _count_from_zero()
    model.decode_step(cache, torch.zeros((2, 1), dtype=torch.long), 40)
    assert {k: _cuda.LAUNCHES.get(k, 0) for k in want} == want
    assert _cuda.LAUNCHES["flash_decode"] == 1      # the global layer
    pools = model.new_paged_cache(16, 8)
    table = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    _count_from_zero()
    model.decode_step_paged(pools, torch.zeros((2, 1), dtype=torch.long),
                            torch.tensor([16, 31], dtype=torch.int32), table)
    assert {k: _cuda.LAUNCHES.get(k, 0) for k in want} == want
    assert _cuda.LAUNCHES["paged_decode:chunked"] == 3


# ---------------------------------------------------------------------------
# the releasing int8 build (gemma2-27b on one card)
# ---------------------------------------------------------------------------

def _gemma2_pair():
    """Two port models of the same smoke weights at bf16 compute."""
    _, _, tm = _models(GEMMA2, compute_dtype="bfloat16")
    twin = Model(tm.cfg, device="cpu")
    twin.load_state_dict(tm.state_dict())
    return tm, twin


def test_release_build_serves_bitwise_the_copy_build():
    """The block-by-block build that drops each block's float projections
    serves bitwise what the copying build serves: the same quantized
    leaves, prefill logits, and greedy tokens through the fixed loop and
    the scheduler (4 layers, local and global, softcaps)."""
    tm, twin = _gemma2_pair()
    copy = tm.quantize_params_for_serving()
    released = twin.quantize_params_for_serving(release=True)
    assert released is twin and released.int8
    for a, b in zip(copy.state_dict().items(),
                    released.state_dict().items()):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]
    toks = np.random.default_rng(4).integers(0, tm.cfg.vocab, (2, 30))
    want, _ = copy.prefill(torch.from_numpy(toks))
    got, _ = released.prefill(torch.from_numpy(toks))
    assert torch.equal(got, want)
    geom = dict(n_lanes=2, page_size=8, prefill_chunk=8, max_seq_len=48)
    for name in ("generate_with_status_fixed", "generate_with_status"):
        outs = [getattr(ServeEngine(m, _quiet(ServeConfig, int8=True,
                                              max_new_tokens=6, **geom)),
                        name)({"tokens": torch.from_numpy(toks)})
                for m in (copy, released)]
        assert [o.status for o in outs] == [[STATUS_OK] * 2] * 2
        np.testing.assert_array_equal(outs[0].tokens, outs[1].tokens)


def test_release_drops_every_float_projection():
    """After the releasing build no float projection is referenced:
    every float ``wqkv``/``wo``/``gate``/``up``/``down`` is freed (weak
    references dead), the model's only 2-D float parameter is the
    embedding, and the norm scales and the embedding are the ones it
    had."""
    tm, _ = _gemma2_pair()
    embed, ln1 = tm.embed, tm.blocks[0].ln1
    dead = [weakref.ref(p) for n, p in tm.named_parameters()
            if p.dim() == 2 and n != "embed"]
    assert len(dead) == 5 * tm.cfg.n_layers
    q = tm.quantize_params_for_serving(release=True)
    gc.collect()
    assert all(r() is None for r in dead)
    assert [n for n, p in q.named_parameters() if p.dim() == 2] == ["embed"]
    assert q.embed is embed and q.blocks[0].ln1 is ln1
    assert q.quantize_params_for_serving() is q
    with pytest.raises(ValueError, match="fp32_fallback"):
        ServeEngine(q, ServeConfig(int8=True, fp32_fallback=True))


def test_fp32_fallback_keeps_the_float_model():
    """With ``fp32_fallback`` the engine builds the int8 copy beside the
    float model and keeps it: the float model is untouched, not int8, and
    is the engine's fallback."""
    tm, twin = _gemma2_pair()
    eng = ServeEngine(tm, ServeConfig(int8=True, fp32_fallback=True))
    assert eng.fp_model is tm and not tm.int8 and eng.model.int8
    for a, b in zip(tm.state_dict().values(), twin.state_dict().values()):
        assert torch.equal(a, b)
    assert isinstance(tm.blocks[0].attn.wqkv, torch.nn.Parameter)


def _int8_block_bytes(cfg) -> int:
    """One block's int8 copy from the shapes: int8 values and an f32
    scale per output column of each quantized projection."""
    d, q, kv, f = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    shapes = [(d, q + 2 * kv), (q, d)]
    if not cfg.moe:
        shapes += [(d, f), (d, f), (f, d)]
    return sum(k * n + 4 * n for k, n in shapes)


@pytest.mark.parametrize("arch,layers,fits_release,fits_fallback", [
    (GEMMA2, None, True, False),
    ("gemma3-12b", None, True, True),
    (LLAMA4, 8, True, True),
    ("paligemma-3b", None, True, True)])
def test_int8_fits_arithmetic(arch, layers, fits_release, fits_fallback):
    """``int8_peak_bytes`` from the shapes: the float model (every weight
    at its config's ``param_dtype``: bf16, or paligemma's fp32 masters;
    the norm scales at fp32) plus one block's int8 copy on the releasing
    build, plus every block's under ``fp32_fallback``; an 80 GB card holds
    the peak under 0.8 of itself.  gemma2-27b: 54.45 GB + 0.57 GB fits,
    54.45 + 26.06 GB does not."""
    cfg = tserve.with_layers(get_config(arch), layers)
    d, n = cfg.d_model, cfg.n_layers
    width = 4 if cfg.param_dtype == "float32" else 2
    embed = cfg.padded_vocab() * d * width
    norms = 4 * d * (2 * n + 1)
    float_bytes = embed + norms + width * (cfg.param_count()
                                           - cfg.padded_vocab() * d
                                           - d * (2 * n + 1))
    if cfg.moe:    # the router is fp32
        float_bytes += 2 * n * d * cfg.n_experts
    block = _int8_block_bytes(cfg)
    assert tserve.int8_peak_bytes(cfg) == float_bytes + block
    assert tserve.int8_peak_bytes(cfg, True) == float_bytes + n * block
    card = torch.device("cuda")
    assert tserve.int8_fits(cfg, card, total=80e9) == fits_release
    assert tserve.int8_fits(cfg, card, True, total=80e9) == fits_fallback
    assert tserve.int8_fits(cfg, torch.device("cpu"), True)
    if arch == GEMMA2:
        assert round(float_bytes / 1e9, 2) == 54.45
        assert round(block * n / 1e9, 2) == 26.06


@pytest.mark.parametrize("argv", [[], ["--fp32-fallback"]],
                         ids=["release", "fallback"])
def test_launcher_serves_gemma2_int8(capsys, argv):
    """``launch.serve --arch gemma2-27b --int8`` on the smoke config: the
    releasing build (or the copy beside the bf16 model under
    ``--fp32-fallback``), every lane ok."""
    tserve.main(["--arch", GEMMA2, "--smoke", "--device", "cpu", "--int8",
                 "--batch", "2", "--prompt-len", "20", "--max-new", "3",
                 *argv])
    out = capsys.readouterr().out
    assert "gemma2-27b-smoke int8 on cpu" in out and "lane 1: ok" in out
