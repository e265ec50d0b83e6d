"""paligemma-3b's path through the port against the JAX reference, on the
CPU: the config copy, the parameter tree both ways, the patch prefix in
the prefill, the fixed loop that ``generate_with_status`` falls through
to (bf16 and int8 weights), the refusals, and what the served path hands
the kernels (intercepted at ``kernels._cuda.launch``: the CUDA kernels
run only on the card, where ``chip_smoke.py`` holds them to these plain
versions).

Tolerances, each with its reason:

* Both sides hold the same parameters, the block weights rounded to
  bf16-representable fp32 (the port serves a bf16 copy of its fp32
  masters at bf16 compute, the reference promotes its fp32 weights; on
  rounded weights both multiply the same numbers and only the order of
  summation differs; ``test_torch_train_encdec.py`` holds the unrounded
  masters and the int8 copy quantized from them).
* At fp32 compute the prefill logits are within 1e-4 of their scale; at
  bf16 compute within twice the reference's own bf16 rounding noise (its
  distance from the same prefill at fp32 compute), the rule of
  ``test_torch_model.py``.
* Greedy tokens through the engines are equal: bf16 weights at bf16
  compute, int8 weights at fp32 compute.  int8 at bf16 compute is held to
  the reference's own noise and, token by token, up to each lane's first
  near tie (``test_int8_at_bf16_compute_within_the_references_noise``).
* The reference attends to its prefix causally (ROADMAP F5): in the port,
  a change to patch 7 changes no bit at positions 0-6.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.launch.mesh import make_mesh
from repro.models.lm import Model as JaxModel
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.models.lm import Model
from repro_torch.robust.guards import STATUS_OK
from repro_torch.serve.api import Request
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

ARCH = "paligemma-3b"
H100_SMS = 132


@pytest.fixture(autouse=True)
def _xla_mode():
    assert jops.kernel_mode() == "xla", "the reference must run its CPU path"


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_is_the_reference_copy(smoke):
    """Every field of the port's ``ArchConfig`` (``prefix_tokens``
    included) equals the reference's, and so does the parameter count."""
    got, want = get_config(ARCH, smoke=smoke), jax_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(ArchConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.param_count() == want.param_count()
    assert ARCH in ARCH_IDS


def test_full_width_weights_on_the_card():
    """18 layers at full width: 8 q heads over 1 kv head of 256 (G = 8),
    the fp32 embedding (2.1 GB, read by the fp32 logits) and 7.93 GB of
    fp32 projections (the config's float32 masters; served from their
    3.96 GB bf16 copy), counted on the meta device; the int8 build
    fits."""
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.hd, cfg.n_heads // cfg.n_kv_heads,
            cfg.d_ff, cfg.prefix_tokens) == (18, 2048, 256, 8, 16384, 256)
    model = Model(cfg, device="meta")
    assert model.embed.dtype == torch.float32
    assert model.blocks[0].attn.wqkv.dtype == torch.float32
    assert model.blocks[0].ffn.down.dtype == torch.float32
    assert model.embed.nbytes == 2_107_637_760
    proj = sum(p.nbytes for n, p in model.named_parameters()
               if n.startswith("blocks.") and p.dim() == 2)
    assert proj == 2 * 3_963_617_280
    assert tserve.int8_fits(cfg, torch.device("cuda"), total=80e9)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def _bf16_round(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _models(compute_dtype="float32"):
    """The reference and the port on the same parameters: the reference's
    init with random norm scales and tripled block weights (so greedy
    tokens vary), every block weight rounded to bf16-representable fp32."""
    over = dict(compute_dtype=compute_dtype)
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **over)
    jm = JaxModel(jcfg, make_mesh(1, 1))
    params = jax.tree.map(np.asarray, jm.init_params(0))
    rng = np.random.default_rng(7)

    def vary(tree):
        for name, leaf in list(tree.items()):
            if isinstance(leaf, dict):
                vary(leaf)
            elif name.startswith("ln") or name == "final_norm":
                tree[name] = (0.5 * rng.standard_normal(leaf.shape)
                              ).astype(np.float32)
            else:
                tree[name] = _bf16_round(leaf * np.float32(3))
    vary(params["groups"])
    params["final_norm"] = (0.5 * rng.standard_normal(
        params["final_norm"].shape)).astype(np.float32)
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(from_jax_params(tcfg, params))
    return jm, jax.tree.map(jnp.asarray, params), tm


def _rel_err(got, want) -> float:
    g = np.asarray(got.double() if torch.is_tensor(got) else got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w)) / max(1.0, np.max(np.abs(w))))


PROMPT, STEPS, BATCH = 8, 8, 2


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    patches = rng.standard_normal((BATCH, cfg.prefix_tokens, cfg.d_model)
                                  ).astype(np.float32)
    return toks, patches


def test_convert_round_trip():
    """The reference's tree into the port (every leaf as it is: the fp32
    embedding, norm scales and projections, the masters) and back
    (``to_jax_params``): every leaf equal, bit for bit."""
    jm, params, _ = _models(compute_dtype="bfloat16")
    cfg = get_config(ARCH, smoke=True)
    tm = Model(cfg, device="cpu")
    tm.load_state_dict(from_jax_params(cfg, jax.tree.map(np.asarray,
                                                         params)))
    assert tm.embed.dtype == torch.float32
    assert tm.blocks[1].attn.wqkv.dtype == torch.float32
    back = from_jax_params(cfg, to_jax_params(cfg, tm.state_dict()))
    sd = tm.state_dict()
    assert sorted(back) == sorted(sd)
    for key, t in sd.items():
        assert back[key].dtype == t.dtype and torch.equal(back[key], t), key
    grp = params["groups"]["b0"]
    np.testing.assert_array_equal(
        sd["blocks.1.attn.wqkv"].numpy(),
        np.asarray(grp["attn"]["wqkv"][1]))
    np.testing.assert_array_equal(sd["embed"].numpy(),
                                  np.asarray(params["embed"]))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_prefill_logits_match_reference(compute):
    """The prefill over 8 patches and 8 text tokens: at fp32 compute the
    logits within 1e-4 of their scale; at bf16 within twice the
    reference's own distance from its fp32-compute prefill."""
    jm, params, tm = _models(compute)
    toks, patches = _batch(jm.cfg)
    batch = {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)}
    jl, _ = jax.jit(lambda p, b: jm.prefill(p, b, 24))(params, batch)
    tl, cache = tm.prefill(torch.from_numpy(toks), 24,
                           patches=torch.from_numpy(patches))
    assert cache[0]["k"].shape[1] == 24
    if compute == "float32":
        assert _rel_err(tl, jl) <= 1e-4
        return
    anchor = JaxModel(dataclasses.replace(jm.cfg, compute_dtype="float32"),
                      jm.mesh)
    al, _ = jax.jit(lambda p, b: anchor.prefill(p, b, 24))(params, batch)
    noise = _rel_err(jl, al)
    assert 0 < _rel_err(tl, jl) <= 2 * noise


def _teacher_forced(jm, params, tm, toks, patches, picks):
    """Both sides' logits [steps, B, v] over the prompt, then each step
    fed ``picks`` [B, steps] (the reference's tokens)."""
    p = jm.cfg.prefix_tokens + toks.shape[1]
    steps = picks.shape[1]
    jl, jc = jax.jit(lambda q, b: jm.prefill(q, b, p + steps))(
        params, {"tokens": jnp.asarray(toks),
                 "patches": jnp.asarray(patches)})
    tl, tc = tm.prefill(torch.from_numpy(toks), p + steps,
                        patches=torch.from_numpy(patches))
    decode = jax.jit(jm.decode_step)
    js, ts = [np.asarray(jl, np.float64)], [tl.double().numpy()]
    for i in range(steps - 1):
        tok = picks[:, i:i + 1].astype(np.int32)
        jl, jc = decode(params, jc, jnp.asarray(tok),
                        jnp.asarray(p + i, jnp.int32))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok), p + i)
        js.append(np.asarray(jl, np.float64))
        ts.append(tl.double().numpy())
    v = jm.cfg.vocab
    return np.stack(js)[..., :v], np.stack(ts)[..., :v]


def _generate_both(compute, int8):
    jm, params, tm = _models(compute)
    toks, patches = _batch(jm.cfg, seed=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JServeEngine(jm, params, JServeConfig(max_new_tokens=STEPS,
                                                     int8=int8))
    want = jeng.generate_with_status(
        {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)})
    teng = ServeEngine(tm, ServeConfig(max_new_tokens=STEPS, int8=int8))
    got = teng.generate_with_status({"tokens": torch.from_numpy(toks),
                                     "patches": torch.from_numpy(patches)})
    assert teng._sched is None and not teng._shim_cache   # no scheduler
    assert list(got.status) == list(want.status) == [STATUS_OK] * BATCH
    assert got.tokens.shape == (BATCH, STEPS)
    assert len(set(got.tokens.reshape(-1).tolist())) > 3
    return jm, jeng, teng, toks, patches, got.tokens, np.asarray(want.tokens)


@pytest.mark.parametrize("compute,int8", [("bfloat16", False),
                                          ("float32", True)],
                         ids=["bf16", "int8-fp32-compute"])
def test_generate_with_status_falls_through_and_matches_reference(compute,
                                                                  int8):
    """``generate_with_status`` on the smoke config, bf16 weights at bf16
    compute and int8 weights at fp32 compute: the engine falls through to
    the fixed loop (the model is not pageable), every lane ok, and the
    greedy tokens equal the reference ``ServeEngine``'s on the same
    batch."""
    *_, got, want = _generate_both(compute, int8)
    np.testing.assert_array_equal(got, want)


def test_int8_at_bf16_compute_within_the_references_noise():
    """int8 weights at bf16 compute, as on the card: each framework
    quantizes the activations of its own bf16 stream, so one rounding flip
    moves a whole int8 step (granite's smoke config shows the same 2% of
    the logit scale between the frameworks under int8).  Fed the
    reference's tokens, the port's logits at every step lie within twice
    the reference's own distance from its int8 run at fp32 compute, and
    each lane's greedy tokens equal the reference's up to its first near
    tie: a step where the reference's two best logits lie within twice
    the lane's distance between the two frameworks' logits."""
    jm, jeng, teng, toks, patches, got, want = _generate_both("bfloat16",
                                                              True)
    anchor = JaxModel(dataclasses.replace(jm.cfg, compute_dtype="float32"),
                      jm.mesh)
    jl, tl = _teacher_forced(jm, jeng.params, teng.model, toks, patches,
                             want)
    al, _ = _teacher_forced(anchor, jeng.params, teng.model, toks, patches,
                            want)
    errs = [_rel_err(t, j) for t, j in zip(tl, jl)]
    noise = [_rel_err(j, a) for j, a in zip(jl, al)]
    assert max(errs) <= 2 * max(noise), (errs, noise)
    top2 = np.sort(jl, -1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= 2 * np.abs(tl - jl).max(-1)
    for b in range(BATCH):
        first = int(np.argmax(near[:, b])) if near[:, b].any() else STEPS
        np.testing.assert_array_equal(got[b, :first], want[b, :first])


def test_decode_positions_count_the_prefix(monkeypatch):
    """The fixed loop's prompt is the patches and the text (the
    reference's ``engine.py:625``): its first decode step is at position
    P + S, and each later one a position further; the dense cache holds
    P + S + max_new slots."""
    cfg = get_config(ARCH, smoke=True)
    model = Model(cfg, device="cpu").init_weights(0)
    seen, slots = [], []
    step, prefill = model.decode_step, model.prefill

    def record_step(cache, token, pos):
        seen.append(pos)
        return step(cache, token, pos)

    def record_prefill(tokens, max_len=None, **kw):
        logits, cache = prefill(tokens, max_len, **kw)
        slots.append(cache[0]["k"].shape[1])
        return logits, cache
    monkeypatch.setattr(model, "decode_step", record_step)
    monkeypatch.setattr(model, "prefill", record_prefill)
    toks, patches = _batch(cfg)
    res = ServeEngine(model, ServeConfig(max_new_tokens=4)
                      ).generate_with_status(
        {"tokens": torch.from_numpy(toks),
         "patches": torch.from_numpy(patches)})
    p = cfg.prefix_tokens + PROMPT
    assert res.tokens.shape == (BATCH, 4)
    assert seen == [p, p + 1, p + 2] and slots == [p + 4]


def test_prefix_is_causal_bitwise():
    """ROADMAP F5 in the port: paligemma's layers keep their 'global'
    kind, so the patches are attended causally, as the reference's are.
    Adding 1.0 to patch 7 changes no bit of the stream at positions 0-6,
    and changes position 7 and every later one."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype="float32")
    model = Model(cfg, device="cpu").init_weights(0)
    toks, patches = _batch(cfg)
    toks = torch.from_numpy(toks)
    moved = patches.copy()
    moved[:, 7] += 1.0
    n = cfg.prefix_tokens + PROMPT
    outs = [model.forward(toks, cache=model.new_cache(BATCH, n),
                          patches=torch.from_numpy(p))
            for p in (patches, moved)]
    assert outs[0].shape == (BATCH, n, cfg.d_model)
    assert torch.equal(outs[0][:, :7], outs[1][:, :7])
    assert (outs[0][:, 7:] != outs[1][:, 7:]).any(-1).all()


@pytest.mark.parametrize("arch,kw", [
    (ARCH, {}),
    (ARCH, {"patches": torch.zeros((2, 7, 64))}),
    ("granite-3-8b", {"patches": torch.zeros((2, 8, 64))})],
    ids=["missing", "wrong-shape", "unexpected"])
def test_prefill_refuses_missing_or_unexpected_patches(arch, kw):
    model = Model(get_config(arch, smoke=True), device="cpu").init_weights(0)
    with pytest.raises(ValueError, match="patches"):
        model.prefill(torch.zeros((2, 4), dtype=torch.long), **kw)


def test_not_pageable_and_submit_raises():
    tm = Model(get_config(ARCH, smoke=True), device="cpu").init_weights(0)
    assert not tm.supports_paged_serving
    eng = ServeEngine(tm, ServeConfig(max_new_tokens=2))
    with pytest.raises(NotImplementedError):
        eng.submit(Request(id=0, tokens=np.arange(4)))


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


def test_attention_launches_at_g8_hd256(intercepted):
    """The full model's attention: K4 'global' over the 8 x 512 prompt
    (256 patches and 256 text tokens, 8 q heads over 1 kv head of 256:
    the causal mask code, no window, no prefix length) and K5 at decode
    (``head_groups(8)``: one row of all 8 heads), each counted under its
    ``hd256`` variant."""
    assert tfa.head_groups(8) == (1, 8)
    b, s, h, kv, hd = 8, 512, 8, 1, 256
    tfa.flash_attention_cuda(_bf(b, s, h, hd), _bf(b, s, kv, hd),
                             _bf(b, s, kv, hd))
    cache = _bf(b, s + 32, kv, hd)
    tfa.flash_decode_cuda(_bf(b, 1, kv, 8, hd), cache, cache, s + 5, None,
                          None, "global")
    (_, k4, args4), (_, k5, args5) = intercepted
    assert k4 == "k4_flash_prefill" and k5 == "k5_flash_decode"
    assert args4[4:] == (b, s, s, h, kv, hd, hd ** -0.5, 0, 0, 0, 0.0)
    assert _cuda.LAUNCHES["flash_attention:hd256"] == 1
    assert _cuda.LAUNCHES["flash_decode:hd256"] == 1


@pytest.fixture
def forced_wrappers(intercepted, monkeypatch):
    """Every kernel entry point of ``kernels.ops`` routed to its CUDA
    wrapper on CPU tensors, up to the launch (``test_torch_whisper.py``'s
    rehearsal): each wrapper's own checks run, and ``_cuda.check`` holds
    dtype, shape, contiguity and 16-byte alignment; a launch computes
    nothing."""
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
    return intercepted


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_served_path_hands_the_kernels_valid_tensors(forced_wrappers, int8):
    """The smoke model (its fp32 masters' bf16 copy, as on the card) through
    the prefill of 4 images' 8 patches and 8 text tokens (the GEMMs at 64
    rows) and one decode step, every kernel call through its wrapper.  One
    decode iteration's launches are the counts ``chip_smoke.py``'s
    ``decode_launches`` holds on the card: the row-norm kernel L + 1 times
    (the entry norm and each ``ln2``), the down GEMM's norm tail L times,
    K5 once a layer, and under int8 the up GEMM's quantize in its store
    phase and no row-quantize launch."""
    cfg = get_config(ARCH, smoke=True)
    model = Model(cfg, device="cpu").init_weights(0)
    if int8:
        model = model.quantize_params_for_serving()
    toks = torch.zeros((4, PROMPT), dtype=torch.long)
    patches = torch.zeros((4, cfg.prefix_tokens, cfg.d_model))
    logits, cache = model.prefill(toks, 20, patches=patches)
    assert logits.shape == (4, cfg.padded_vocab())
    assert _cuda.LAUNCHES["flash_attention"] == cfg.n_layers
    _cuda.reset_launches()
    for key in [k for k in _cuda.LAUNCHES if ":" in k]:
        del _cuda.LAUNCHES[key]
    model.decode_step(cache, torch.zeros((4, 1), dtype=torch.long), 16)
    n = cfg.n_layers
    gemm = "int8_matmul" if int8 else "matmul"
    want = {"rmsnorm": n + 1, f"{gemm}:norm": n, "flash_decode": n,
            "int8_matmul:quantize": n if int8 else 0, "int8_quantize": 0,
            "flash_attention": 0}
    assert {k: _cuda.LAUNCHES.get(k, 0) for k in want} == want


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_make_patches_shape_and_seed():
    cfg = get_config(ARCH, smoke=True)
    p = tserve.make_patches(cfg, 3, 0)
    assert p.shape == (3, cfg.prefix_tokens, cfg.d_model)
    assert p.dtype == torch.float32
    assert torch.equal(p, tserve.make_patches(cfg, 3, 0))
    assert not torch.equal(p, tserve.make_patches(cfg, 3, 1))


@pytest.mark.parametrize("extra", [[], ["--int8"]], ids=["bf16", "int8"])
def test_launcher_serves_the_smoke_config(capsys, extra):
    """``launch.serve --arch paligemma-3b --smoke --device cpu``: a prompt
    of the 8 patches and 8 text tokens, bf16 and int8, every lane ok."""
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "16", "--max-new", "3", *extra])
    out = capsys.readouterr().out
    assert "paligemma-3b-smoke" in out and "lane 1: ok" in out


@pytest.mark.parametrize("argv,reason", [
    (["--requests", "2"], "patches"),
    (["--prompt-len", "8"], "at least one text token")],
    ids=["requests", "no-text"])
def test_launcher_refusals(argv, reason):
    with pytest.raises(SystemExit, match=reason):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", *argv])
