"""whisper-small's path through the port against the JAX reference, on the
CPU: the config copy, the four kernel variants whisper runs in their plain
versions (K1 and K2 with ``activation='gelu'``, K4 and K5 with the 'full'
kind) against the reference's Pallas kernels in interpret mode, their
launch arguments and count keys (intercepted at ``kernels._cuda.launch``:
the CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
to these plain versions), and the smoke config served end to end.

Tolerances, each with its reason:

* K1 gelu: bf16 output within one bf16 ulp of each row's scale (fp32 sums
  in another order and the two frameworks' tanh may flip one rounding);
  fp32 output within 1e-5 of each row's scale.
* K2 gelu + quantize: q within one int8 step and the row scales within 2
  fp32 ulps (the two frameworks' gelu may differ by an ulp), the rule of
  ``test_torch_int8.py``'s gated quantize.
* K4 and K5 'full': bf16 within two bf16 ulps of each row's scale (online
  softmax against one softmax, or another tiling, then the bf16 cast),
  fp32 within 1e-5, the rule of ``test_torch_gemma3.py``.
* The model: both sides hold the same parameters, the block weights
  rounded to bf16-representable fp32 (the port serves a bf16 copy of its
  fp32 masters at bf16 compute, the reference promotes them; on rounded weights
  both multiply the same numbers and only the order of summation
  differs).  At fp32 compute the prefill logits are within 1e-4 of their
  scale and the decode steps within twice the reference's own bf16
  rounding noise (the K/V caches are bf16 on both sides).  Greedy tokens
  through the engines are equal.  A witness prints the distance to the
  reference on the unrounded fp32 weights and holds it under 5% of the
  logit scale (bf16 rounding of every weight moves the logits by about a
  percent).
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
from repro.kernels.epilogue import Epilogue as JEpilogue
from repro.kernels.matmul import matmul_pallas
from repro.launch.mesh import make_mesh
from repro.models.lm import Model as JaxModel
from repro.models.lm import _sinusoid as jax_sinusoid
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import from_jax_params
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.quantize import QuantizedWeight
from repro_torch.launch.serve import make_frames
from repro_torch.models.layers import sinusoid
from repro_torch.models.lm import Model
from repro_torch.robust.guards import STATUS_OK
from repro_torch.serve.api import Request
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

ARCH = "whisper-small"
BF16_EPS = float(torch.finfo(torch.bfloat16).eps)
F32_EPS = float(torch.finfo(torch.float32).eps)
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
    """Every field of the port's ``ArchConfig`` equals the reference's, and
    so does the parameter count."""
    got, want = get_config(ARCH, smoke=smoke), jax_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(ArchConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.param_count() == want.param_count()
    assert got.encdec and not got.gated_mlp and got.param_dtype == "float32"
    assert ARCH in ARCH_IDS


def test_full_width_weights_on_the_card():
    """Built on the meta device (no memory): 12 encoder and 12 decoder
    layers at d_model 768, 12 heads of 64, d_ff 3072, vocab 51865 padded
    to 51968, 0.24 B parameters (the reference's count leaves out the
    cross-attention), the projection weights at fp32 (0.80 GB: the
    config's float32 masters, served from their bf16 copy), the embedding
    and the norm scales at fp32."""
    cfg = get_config(ARCH)
    model = Model(cfg, device="meta")
    assert (len(model.blocks), len(model.encoder.blocks)) == (12, 12)
    assert (cfg.hd, cfg.q_dim, cfg.kv_dim, cfg.padded_vocab()) == (
        64, 768, 768, 51968)
    params = dict(model.named_parameters())
    total = sum(p.numel() for p in params.values())
    # the reference's count leaves out the cross-attention's four
    # matrices a layer and the encoder's final norm, and counts three
    # norms an encoder block where it holds two and two a decoder block
    # where it holds three (lnx)
    assert total == cfg.param_count() + 12 * 4 * 768 * 768 + 768
    assert 0.23e9 < total < 0.25e9
    proj = {n: p for n, p in params.items() if p.dim() == 2 and n != "embed"}
    assert all(p.dtype == torch.float32 for p in proj.values())
    # 0.80 GB of fp32 projections beside the 0.16 GB fp32 embedding
    assert 0.78e9 < 4 * sum(p.numel() for p in proj.values()) < 0.80e9
    assert params["embed"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for n, p in params.items()
               if p.dim() == 1)
    assert "blocks.0.ffn.gate" not in params
    assert not model.supports_paged_serving


def test_sinusoid_matches_reference():
    """fp32 within 2.5e-4: an angle of up to 1500 radians carries an fp32
    rounding of about 1e-4, and the two frameworks' exp, sin and cos
    differ by an ulp; at bf16, where the decoder and encoder add them,
    within one bf16 ulp."""
    for start, length, d in ((0, 24, 64), (37, 1, 64), (0, 1500, 768)):
        got = sinusoid(start, length, d, torch.float32)
        want = np.asarray(jax_sinusoid(start, length, d, jnp.float32))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.5e-4)
        got16 = sinusoid(start, length, d, torch.bfloat16).float().numpy()
        np.testing.assert_allclose(got16, want, rtol=0, atol=BF16_EPS)


# ---------------------------------------------------------------------------
# the plain K1, K2, K4 and K5 variants against the reference's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(8, 64, 128), (37, 96, 40)])
def test_k1_gelu_matches_pallas_interpret(m, k, n, dtype):
    """The plain up GEMM: gelu (tanh form) on the fp32 accumulator, cast."""
    rng = np.random.default_rng(m + n)
    ja, ta = _pair(rng, (m, k), dtype)
    jb, tb = _pair(rng, (k, n), dtype, scale=k ** -0.5 * 3)
    want = matmul_pallas(ja, jb, block=(16, 16, 16), interpret=True,
                         epilogue=JEpilogue(activation="gelu",
                                            out_dtype=_J[dtype]))
    got = ops.matmul(ta, tb, epilogue=Epilogue(activation="gelu",
                                               out_dtype=_T[dtype]))
    assert got.dtype == _T[dtype] and got.shape == (m, n)
    assert _row_err(got, want) <= (1e-5 if dtype == "float32" else BF16_EPS)


@pytest.mark.parametrize("m,k,n", [(8, 64, 128), (33, 70, 52),
                                   (100, 130, 70)])
def test_k2_gelu_quantize_matches_pallas_interpret(m, k, n):
    """The int8 up GEMM of the plain MLP (the reference's ``layers.py:
    369-371``): gelu(acc * sa * sb), then the rowwise quantize."""
    rng = np.random.default_rng(m + k)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    qa, sa = ref.quantize_rowwise_ref(a)
    qb, sb = ref.quantize_colwise_ref(w)
    q, s = ops.int8_matmul(qa, sa, qb, sb,
                           epilogue=Epilogue(activation="gelu",
                                             quantize=True))
    jq, js = matmul_pallas(_jx(qa), _jx(qb), block=(16, 16, 16),
                           interpret=True,
                           epilogue=JEpilogue(activation="gelu",
                                              quantize=True),
                           a_scale=_jx(sa), b_scale=_jx(sb))
    assert q.dtype == torch.int8 and s.shape == (m, 1)
    assert int(np.abs(q.numpy().astype(int) - np.asarray(jq, int)).max()) \
        <= 1
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2 * F32_EPS,
                               atol=0)


K4_FULL = [
    (2, 24, 24, 4, 4),      # encoder self-attention, Sq == Skv
    (1, 37, 37, 4, 2),      # ragged, grouped heads
    (2, 12, 37, 4, 4),      # cross-attention prefill: Sq != Skv, ragged
    (1, 5, 24, 2, 2),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,n_h,n_kv", K4_FULL)
def test_k4_full_matches_pallas_interpret(b, sq, skv, n_h, n_kv, dtype):
    rng = np.random.default_rng(sq + skv)
    hd = 16
    jq, tq = _pair(rng, (b, sq, n_h, hd), dtype, scale=2.0)
    jk, tk = _pair(rng, (b, skv, n_kv, hd), dtype, scale=2.0)
    jv, tv = _pair(rng, (b, skv, n_kv, hd), dtype)
    want = jfa.flash_attention_pallas(jq, jk, jv, kind="full", block_q=8,
                                      block_k=8, interpret=True)
    got = ops.flash_attention(tq, tk, tv, kind="full")
    assert got.dtype == _T[dtype] and got.shape == tq.shape
    assert _row_err(got, want) <= (1e-5 if dtype == "float32"
                                   else 2 * BF16_EPS)


@pytest.mark.parametrize("n_splits", [1, 3])
@pytest.mark.parametrize("kv_len", [24, 75])
def test_k5_full_matches_pallas_interpret(kv_len, n_splits):
    """Cross-attention decode: every slot live whatever ``pos`` says (the
    reference's kernel reads no position for 'full')."""
    b, n_kv, g, hd = 2, 4, 1, 16
    rng = np.random.default_rng(kv_len + n_splits)
    jq, tq = _pair(rng, (b, 1, n_kv, g, hd), scale=2.0)
    jk, tk = _pair(rng, (b, kv_len, n_kv, hd), scale=2.0)
    jv, tv = _pair(rng, (b, kv_len, n_kv, hd))
    want = jfa.flash_decode_pallas(jq, jk, jv, jnp.int32(3), kind="full",
                                   n_splits=n_splits, interpret=True)
    got = ops.flash_decode(tq, tk, tv, 3, kind="full")
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    assert _row_err(got, want) <= 2 * BF16_EPS
    # the plain version is the global decode at the last slot, bitwise
    assert torch.equal(got, ops.flash_decode(tq, tk, tv, kv_len - 1))
    want_ref = ref.flash_decode_ref(tq.double(), tk.double(), tv.double(),
                                    0, kind="full")
    assert _row_err(got, jnp.asarray(want_ref.float().numpy())) \
        <= 2 * BF16_EPS


def test_paged_kernel_refuses_full():
    pool = torch.zeros((3, 16, 2, 16), dtype=torch.bfloat16)
    q = torch.zeros((1, 1, 2, 1, 16), dtype=torch.bfloat16)
    table = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        ops.paged_flash_decode(q, pool, pool, table,
                               torch.zeros((1, 1), dtype=torch.int32),
                               kind="full")


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
    tmm._device_plan.cache_clear()
    tmm._device_k2_plan.cache_clear()
    _cuda.LAUNCHES.clear()
    _cuda.LAUNCHES.update(before)


def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("m,regime", [(8, "bytes"), (12000, "operations")])
def test_k1_gelu_launch(intercepted, m, regime):
    """The up GEMM [M, 768] x [768, 3072] at decode (8 rows) and over the
    encoder's 8 x 1500 frames: the gelu flag (2) and no gate operand,
    counted as ``matmul:gelu``."""
    out = tmm.matmul_cuda(_bf(m, 768), _bf(768, 3072),
                          Epilogue(activation="gelu",
                                   out_dtype=torch.bfloat16))
    ((lib, fn, args),) = intercepted
    assert (lib, fn) == ("matmul", "k1_matmul")
    assert len(args) + 1 == len(_cuda.SIGNATURES[lib][fn])
    assert args[4] is None                     # no operand2
    assert args[9:12] == (m, 3072, 768) and args[14] == tmm.EPI_GELU == 2
    assert tmm.k1_plan(m, 3072, 768, H100_SMS).regime == regime
    assert out.shape == (m, 3072)
    assert _cuda.LAUNCHES["matmul"] == 1 and _cuda.LAUNCHES["matmul:gelu"] == 1


@pytest.mark.parametrize("m,key,row_launches", [
    (8, "int8_matmul:gelu+quantize", 0), (512, "int8_matmul:gelu", 1)])
def test_k2_gelu_quantize_launch(intercepted, m, key, row_launches):
    """The int8 up GEMM: at decode (8 rows) its quantize is the store
    phase's tail (one launch, ``int8_matmul:gelu+quantize``); at a 512-row
    prefill the GEMM stores the gelu'd fp32 values and K3's row kernel
    quantizes them (``int8_matmul:gelu`` and ``int8_quantize``)."""
    qa = torch.zeros((m, 768), dtype=torch.int8)
    qt = torch.zeros((3072, 768), dtype=torch.int8)
    q, s = tmm.int8_matmul_cuda(qa, torch.ones(m, 1), qt.t(),
                                torch.ones(1, 3072),
                                Epilogue(activation="gelu", quantize=True))
    lib, fn, args = intercepted[0]
    assert fn == "k2_int8_matmul"
    assert len(args) + 1 == len(_cuda.SIGNATURES[lib][fn])
    assert args[7] is None and args[19] == tmm.EPI_GELU
    assert args[4] is not None and args[5] is None      # the fp32 values
    assert (args[12] is not None) == (row_launches == 0)
    assert len(intercepted) == 1 + row_launches
    assert q.shape == (m, 3072) and s.shape == (m, 1)
    assert _cuda.LAUNCHES[key] == 1
    assert _cuda.LAUNCHES["int8_quantize"] == row_launches
    assert "int8_matmul:quantize" not in _cuda.LAUNCHES


@pytest.mark.parametrize("sq,skv", [(1500, 1500), (64, 1500)])
def test_k4_full_launch(intercepted, sq, skv):
    """The encoder (8 clips x 1500 frames) and the cross-attention
    prefill (64 positions against 1500 frames): the full flag, window 0,
    Sq and Skv as given, counted as ``flash_attention:full``."""
    q, k = _bf(8, sq, 12, 64), _bf(8, skv, 12, 64)
    tfa.flash_attention_cuda(q, k, k, kind="full")
    ((lib, fn, args),) = intercepted
    assert (lib, fn) == ("flash_attention", "k4_flash_prefill")
    assert len(args) + 1 == len(_cuda.SIGNATURES[lib][fn])
    assert args[4:] == (8, sq, skv, 12, 12, 64, 64 ** -0.5,
                        tfa.MASK_CODES["full"], 0, 0, 0.0)
    assert _cuda.LAUNCHES["flash_attention:full"] == 1


def test_k5_full_launch(intercepted):
    """The cross-attention decode (8 clips, 12 kv heads of one query head,
    1500 frames): K5 at position 1499 whatever position it is given, 47
    tiles, counted as ``flash_decode:full``."""
    q, kc = _bf(8, 1, 12, 1, 64), _bf(8, 1500, 12, 64)
    out, ws = tfa.dense_decode_launch(q, kc, kc, 70, kind="full")
    ((lib, fn, args),) = intercepted
    assert (lib, fn) == ("flash_attention", "k5_flash_decode")
    b, kv, rep, g, hd, length, pos, n_tiles, n_splits = args[6:15]
    assert (b, kv, rep, g, hd, length, pos, n_tiles) == (
        8, 12, 1, 1, 64, 1500, 1499, 47)
    assert n_splits == tfa.decode_splits(96, 47, H100_SMS, 64)
    assert _cuda.LAUNCHES["flash_decode"] == 1
    assert _cuda.LAUNCHES["flash_decode:full"] == 1


@pytest.fixture
def forced_wrappers(intercepted, monkeypatch):
    """Every kernel entry point of ``kernels.ops`` routed to its CUDA
    wrapper on CPU tensors, up to the launch: each wrapper's own checks
    run, and ``_cuda.check`` holds dtype, shape, contiguity and 16-byte
    alignment (all but the device); a launch is recorded and computes
    nothing, so the outputs hold whatever their memory held.  A rehearsal
    of what the served path hands the kernels on the card."""
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
    """The smoke model at bf16 compute (its masters' bf16 copy, as on the
    card) through prefill (4 clips of 24 frames: the encoder's GEMMs at 96
    rows, the operations regime; a 16-token prompt: the decoder's at 64)
    and one decode step, every kernel call through its wrapper: every
    tensor a wrapper hands a kernel has the dtype, shape and layout the
    kernel takes.  One decode iteration's launches are the counts
    ``chip_smoke.py``'s ``decode_launches`` holds on the card: the
    row-norm kernel 2 L + 1 times (the entry norm, each ``lnx`` and
    ``ln2``), the down GEMM's norm tail L times, K5 twice a layer (one
    'full'), the gelu up GEMM L times (under int8 with its quantize in
    the store phase, and no row-quantize launch)."""
    cfg = get_config(ARCH, smoke=True)
    model = Model(cfg, device="cpu").init_weights(0)
    if int8:
        model = model.quantize_params_for_serving()
    toks = torch.zeros((4, 16), dtype=torch.long)
    frames = torch.zeros((4, cfg.enc_frames, cfg.d_model))
    logits, cache = model.prefill(toks, 20, frames=frames)
    assert logits.shape == (4, cfg.padded_vocab())
    for key in ("flash_attention:full", "flash_attention",
                "matmul:gelu", "int8_matmul:gelu" if int8 else "rmsnorm"):
        assert _cuda.LAUNCHES.get(key, 0) > 0, key
    _cuda.reset_launches()
    for key in [k for k in _cuda.LAUNCHES if ":" in k]:
        del _cuda.LAUNCHES[key]
    model.decode_step(cache, torch.zeros((4, 1), dtype=torch.long), 16)
    n = cfg.n_layers
    gemm = "int8_matmul" if int8 else "matmul"
    want = {"rmsnorm": 2 * n + 1, f"{gemm}:norm": n, "flash_decode": 2 * n,
            "flash_decode:full": n,
            ("int8_matmul:gelu+quantize" if int8 else "matmul:gelu"): n,
            "int8_quantize": 0, "flash_attention": 0}
    got = {k: _cuda.LAUNCHES.get(k, 0) for k in want}
    assert got == want


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def _bf16_round(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _models(compute_dtype="float32", rounded=True):
    """The reference and the port on the same parameters: the reference's
    init with random norm scales and tripled block weights (so greedy
    tokens vary), every block weight rounded to bf16-representable fp32
    where ``rounded``."""
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
                w = leaf * np.float32(3)
                tree[name] = _bf16_round(w) if rounded else w
    vary(params["groups"])
    vary(params["encoder"])
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
    frames = rng.standard_normal((BATCH, cfg.enc_frames, cfg.d_model)
                                 ).astype(np.float32)
    return toks, frames


def test_convert_maps_encoder_and_cross_attention():
    jm, params, tm = _models(rounded=False)
    sd = tm.state_dict()
    enc = params["encoder"]["blocks"]
    for i in range(jm.cfg.n_enc_layers):
        np.testing.assert_array_equal(
            sd[f"encoder.blocks.{i}.attn.wqkv"].numpy(),
            np.asarray(enc["attn"]["wqkv"][i]))
        np.testing.assert_array_equal(
            sd[f"encoder.blocks.{i}.ffn.up"].numpy(),
            np.asarray(enc["ffn"]["up"][i]).reshape(64, 128))
    grp = params["groups"]["b0"]
    np.testing.assert_array_equal(sd["blocks.1.lnx"].numpy(),
                                  np.asarray(grp["lnx"][1]))
    np.testing.assert_array_equal(sd["blocks.1.xattn.wv"].numpy(),
                                  np.asarray(grp["xattn"]["wv"][1]))
    np.testing.assert_array_equal(sd["encoder.final_norm"].numpy(),
                                  np.asarray(params["encoder"]["final_norm"]))
    assert not any(".gate" in key for key in sd)


def test_fixed_loop_logits_match_reference():
    """prefill (the encoder: K4 'full' and K1 gelu; the decoder's K4
    global, cross-attention prefill on K4 'full') then 8 decode steps (K5
    global and 'full' over the held encoder output) at fp32 compute, fed
    the reference's greedy tokens: the prefill logits within 1e-4 of
    their scale, the steps within twice the reference's own bf16
    rounding noise (its distance from the same run at bf16 compute)."""
    jm, params, tm = _models()
    anchor = JaxModel(dataclasses.replace(jm.cfg, compute_dtype="bfloat16"),
                      jm.mesh)
    toks, frames = _batch(jm.cfg)
    batch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, PROMPT + STEPS))(
        params, batch)
    al, acache = jax.jit(lambda p, b: anchor.prefill(p, b, PROMPT + STEPS))(
        params, batch)
    tl, tcache = tm.prefill(torch.from_numpy(toks), PROMPT + STEPS,
                            frames=torch.from_numpy(frames))
    assert tcache.enc_out.shape == (BATCH, jm.cfg.enc_frames, 64)
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


def test_unrounded_weights_witness():
    """The port at bf16 compute serves a bf16 copy of its fp32 masters;
    the reference at bf16 compute multiplies the unrounded fp32 ones.  Their
    prefill logits stay within 5% of the logit scale (printed)."""
    jm, params, _ = _models(compute_dtype="bfloat16", rounded=False)
    _, _, tm = _models(compute_dtype="bfloat16", rounded=False)
    toks, frames = _batch(jm.cfg)
    jl, _ = jax.jit(lambda p, b: jm.prefill(p, b, PROMPT))(
        params, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    tl, _ = tm.prefill(torch.from_numpy(toks), PROMPT,
                       frames=torch.from_numpy(frames))
    err = _rel_err(tl, jl)
    print(f"whisper smoke, bf16 compute: prefill logits {err:.3e} of their "
          f"scale from the reference on unrounded fp32 weights")
    assert err <= 0.05


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_generate_with_status_falls_through_and_matches_reference(int8):
    """``generate_with_status`` on the smoke config at bf16 compute, bf16
    and int8 weights: the engine falls through to the fixed loop (the
    model is not pageable), every lane ok, and the greedy tokens equal
    the reference ``ServeEngine``'s on the same batch."""
    jm, params, tm = _models(compute_dtype="bfloat16")
    toks, frames = _batch(jm.cfg, seed=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JServeEngine(jm, params, JServeConfig(max_new_tokens=STEPS,
                                                     int8=int8))
    want = jeng.generate_with_status(
        {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    teng = ServeEngine(tm, ServeConfig(max_new_tokens=STEPS, int8=int8))
    got = teng.generate_with_status({"tokens": torch.from_numpy(toks),
                                     "frames": torch.from_numpy(frames)})
    assert teng._sched is None and not teng._shim_cache   # no scheduler
    assert list(got.status) == list(want.status) == [STATUS_OK] * BATCH
    assert got.tokens.shape == (BATCH, STEPS)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert len(set(got.tokens.reshape(-1).tolist())) > 3


def test_not_pageable_and_submit_raises():
    tm = Model(get_config(ARCH, smoke=True), device="cpu").init_weights(0)
    assert not tm.supports_paged_serving
    eng = ServeEngine(tm, ServeConfig(max_new_tokens=2))
    with pytest.raises(NotImplementedError):
        eng.submit(Request(id=0, tokens=np.arange(4)))
    with pytest.raises(ValueError):
        tm.prefill(torch.zeros((1, 4), dtype=torch.long))   # no frames


def _quantized_paths(module) -> list:
    return sorted(f"{name}.{attr}" for name, mod in module.named_modules()
                  for attr in ("wqkv", "wo", "up", "down", "gate")
                  if isinstance(getattr(mod, attr, None), QuantizedWeight))


def test_quantize_pass_coverage_and_skips():
    """The reference's ``test_int8_serving.py:140-158`` on the port: the
    decoder's projections are quantized; the embedding and the norms are
    shared; the cross-attention and the encoder stay float, held as the
    served copy holds them (the fp32 masters cast once to the compute
    dtype); the pass is idempotent; the quantized values equal the
    reference's."""
    jm, params, tm = _models(compute_dtype="bfloat16")
    q = tm.quantize_params_for_serving()
    paths = _quantized_paths(q)
    assert any(p.endswith("attn.wqkv") for p in paths)
    assert any(p.endswith("attn.wo") for p in paths)
    assert any(p.endswith("ffn.up") for p in paths)
    assert any(p.endswith("ffn.down") for p in paths)
    assert not any("xattn" in p or "encoder" in p for p in paths)
    assert q.embed is tm.embed and q.final_norm is tm.final_norm
    assert q.encoder.final_norm is tm.encoder.final_norm
    bf = torch.bfloat16
    for qe, e in zip(q.encoder.blocks, tm.encoder.blocks):
        assert qe.ln1 is e.ln1 and qe.ln2 is e.ln2
        for w, want in ((qe.attn.wqkv, e.attn.wqkv), (qe.ffn.up, e.ffn.up)):
            assert w.dtype == bf and torch.equal(w, want.to(bf))
    for qb, b in zip(q.blocks, tm.blocks):
        assert qb.lnx is b.lnx
        for name in ("wq", "wk", "wv", "wo"):
            w = getattr(qb.xattn, name)
            assert w.dtype == bf and torch.equal(w, getattr(b.xattn,
                                                            name).to(bf))
    assert q.quantize_params_for_serving() is q
    jq = jm.quantize_params_for_serving(params)["groups"]["b0"]
    for i, blk in enumerate(q.blocks):
        got = blk.ffn.up
        k, n = got.q.shape
        np.testing.assert_array_equal(
            got.q.numpy(), np.asarray(jq["ffn"]["up"].q[i]).reshape(k, n))


def test_make_frames_shape_and_seed():
    cfg = get_config(ARCH, smoke=True)
    f = make_frames(cfg, 3, 0)
    assert f.shape == (3, cfg.enc_frames, cfg.d_model)
    assert f.dtype == torch.float32
    assert torch.equal(f, make_frames(cfg, 3, 0))
    assert not torch.equal(f, make_frames(cfg, 3, 1))
