"""The int8 serving slice of the port against the JAX reference, on the
CPU: K3 (rowwise quantize), K2 (int8 GEMM with the scales in the
epilogue), the weight pass and the int8 gated MLP.

Each kernel runs here as its plain PyTorch version (``kernels.ops``
dispatches a CPU tensor to it) and is held against the JAX Pallas kernel
in interpret mode on the same inputs, made from a numpy seed;
``chip_smoke.py`` holds the CUDA kernels against these plain versions on
the card.

Tolerances: K3, the weight pass and K2's fp32 output are bitwise (integer
accumulation is exact, and both sides divide and multiply in IEEE fp32).
K2's ``(q, scale)`` output may differ where the two frameworks' silu
differ by an ulp: q within +-1 and the scale within 2 fp32 ulps.  K2's
bf16 ``(value, normed)`` output: each row within one bf16 ulp of its scale
(one rounding flip).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.epilogue import Epilogue as JEpilogue
from repro.kernels.matmul import matmul_pallas
from repro.kernels.quantize import QuantizedWeight as JQuantizedWeight
from repro.kernels.quantize import quantize_rowwise_pallas
from repro.launch.mesh import make_mesh
from repro.models.lm import Model as JaxModel

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import _cuda, ops, ref
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.quantize import (QuantizedWeight,
                                          quantize_fixed_scale,
                                          quantize_weight_colwise,
                                          saturation_fraction)
from repro_torch.models import layers
from repro_torch.models.lm import Model

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

BF16_EPS = float(torch.finfo(torch.bfloat16).eps)
F32_EPS = float(torch.finfo(torch.float32).eps)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jx(t: torch.Tensor):
    """The same values on the JAX side (bf16 through fp32, exactly)."""
    a = jnp.asarray(_np(t))
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _row_err(got: torch.Tensor, want) -> float:
    g = got.double().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = np.maximum(np.abs(w).max(-1), 1e-3)
    return float((np.abs(g - w).max(-1) / scale).max())


# ---------------------------------------------------------------------------
# K3: rowwise quantize
# ---------------------------------------------------------------------------

def _ties(rows: int, n: int) -> np.ndarray:
    """Rows whose absmax is 127, so the scale is exactly 1.0 and x / scale
    lands on .5 ties that round-half-even must send to the even integer."""
    x = np.tile(np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -127.0],
                         np.float32), (rows, n // 7 + 1))[:, :n]
    x[:, 0] = 127.0
    return x


@pytest.mark.parametrize("shape,dtype,kind", [
    ((8, 64), torch.float32, "normal"),
    ((37, 130), torch.bfloat16, "normal"),
    ((0, 64), torch.float32, "normal"),
    ((5, 70), torch.float32, "ties"),
    ((3, 16), torch.float32, "zeros"),
])
def test_k3_plain_bitwise_equals_pallas_interpret(shape, dtype, kind):
    rng = np.random.default_rng(0)
    if kind == "ties":
        x = torch.from_numpy(_ties(*shape))
    elif kind == "zeros":
        x = torch.zeros(shape)
    else:
        x = torch.from_numpy((3 * rng.standard_normal(shape)
                              ).astype(np.float32))
    x = x.to(dtype)
    q, s = ops.quantize_rowwise(x)
    jq, js = quantize_rowwise_pallas(_jx(x), block_rows=8, interpret=True)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == shape and s.shape == (shape[0], 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if kind == "ties":
        assert q[0, :7].tolist() == [127, 2, 2, 0, -2, 126, -127]


def test_quantize_colwise_is_rowwise_of_the_transpose():
    """``ops.quantize_colwise`` is K3 on the transpose, bitwise; the weight
    pass's colwise quantize divides by 127 instead of multiplying by its
    rounded reciprocal, so its scales are within one fp32 ulp of it."""
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (70, 52)).astype(np.float32))
    q, s = ops.quantize_colwise(w)
    qt, st = ops.quantize_rowwise(w.t().contiguous())
    assert torch.equal(q, qt.t()) and torch.equal(s, st.reshape(1, -1))
    assert s.shape == (1, 52)
    q2, s2 = ref.quantize_colwise_ref(w)
    np.testing.assert_allclose(s.numpy(), s2.numpy(), rtol=F32_EPS, atol=0)
    assert int((q.int() - q2.int()).abs().max()) <= 1


def test_fixed_scale_quantize_counts_saturation():
    x = torch.tensor([[0.5, 1.0, 3.0, -4.0], [0.1, 0.2, 0.3, 0.4]])
    q = quantize_fixed_scale(x, torch.tensor([[1.0 / 127], [1.0 / 127]]))
    assert q[0].tolist() == [64, 127, 127, -127]
    np.testing.assert_allclose(saturation_fraction(q).numpy(), [0.75, 0.0])


# ---------------------------------------------------------------------------
# K2: int8 GEMM
# ---------------------------------------------------------------------------

_SHAPES = [(8, 16, 8), (33, 70, 52), (1, 128, 64), (100, 130, 70)]


def _int8_operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    qa, sa = ref.quantize_rowwise_ref(a)
    qb, sb = ref.quantize_colwise_ref(w)
    return (qa, sa, qb, sb), rng


def _jax_int8(qa, sa, qb, sb, ep, **kw):
    return matmul_pallas(_jx(qa), _jx(qb), block=(16, 16, 16),
                         interpret=True, epilogue=ep, a_scale=_jx(sa),
                         b_scale=_jx(sb), **kw)


@pytest.mark.parametrize("mkn", _SHAPES)
def test_k2_fp32_out_bitwise_equals_pallas_interpret(mkn):
    ops_, _ = _int8_operands(*mkn, seed=sum(mkn))
    got = ops.int8_matmul(*ops_)
    want = _jax_int8(*ops_, JEpilogue())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mkn", _SHAPES)
def test_k2_gated_quantize_matches_pallas_interpret(mkn):
    """The up GEMM's epilogue: silu(g) * (acc * sa * sb), then the rowwise
    quantize -> (q, scale)."""
    ops_, rng = _int8_operands(*mkn, seed=sum(mkn) + 1)
    m, _, n = mkn
    g = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)
                         ).to(torch.bfloat16)
    q, s = ops.int8_matmul(*ops_, epilogue=Epilogue(gate="silu",
                                                    quantize=True),
                           operand2=g)
    jq, js = _jax_int8(*ops_, JEpilogue(gate="silu", quantize=True),
                       operand2=_jx(g))
    assert q.dtype == torch.int8 and s.shape == (m, 1)
    assert int(np.abs(q.numpy().astype(int) - np.asarray(jq, int)).max()) \
        <= 1
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2 * F32_EPS,
                               atol=0)


@pytest.mark.parametrize("mkn", _SHAPES)
def test_k2_residual_rmsnorm_matches_pallas_interpret(mkn):
    """The down GEMM's epilogue: residual add, bf16 cast, then the rmsnorm
    of the cast value -> (value, normed)."""
    ops_, rng = _int8_operands(*mkn, seed=sum(mkn) + 2)
    m, _, n = mkn
    r = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)
                         ).to(torch.bfloat16)
    ns = torch.from_numpy(0.1 * rng.standard_normal(n).astype(np.float32))
    kw = dict(residual=True, norm="rmsnorm", out_dtype=torch.bfloat16)
    val, xn = ops.int8_matmul(*ops_, epilogue=Epilogue(**kw), residual=r,
                              norm_scale=ns)
    jv, jn = _jax_int8(*ops_, JEpilogue(residual=True, norm="rmsnorm",
                                        out_dtype=jnp.bfloat16),
                       residual=_jx(r), norm_scale=_jx(ns))
    assert val.dtype == torch.bfloat16
    assert _row_err(val, jv) <= BF16_EPS and _row_err(xn, jn) <= BF16_EPS
    assert torch.equal(xn, ops.rmsnorm(val, ns))


def test_k2_plain_upcasts_before_the_product():
    """An int8 torch.mm wraps; the plain version's accumulator is the
    exact integer sum even where it leaves the int8 and int16 ranges."""
    qa = torch.full((2, 256), 127, dtype=torch.int8)
    qb = torch.full((256, 3), -127, dtype=torch.int8)
    one = torch.ones(2, 1), torch.ones(1, 3)
    got = ops.int8_matmul(qa, one[0], qb, one[1])
    assert (got == -256 * 127 * 127).all()


def test_int8_pipeline_within_quantization_noise_of_float():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((128, 96)).astype(np.float32))
    qw = quantize_weight_colwise(w)
    got = ops.matmul(a, qw)
    rel = float(torch.linalg.norm(got - a @ w) / torch.linalg.norm(a @ w))
    assert rel < 0.03, rel
    # each weight within half a step of its column's int8 grid
    err = (qw.dequantize() - w).abs()
    assert bool((err <= 0.5 * qw.scale * (1 + 1e-6)).all())


def test_int8_epilogue_stages_outside_the_slice_raise():
    ops_, _ = _int8_operands(4, 16, 16, seed=0)
    for ep in (Epilogue(bias=True), Epilogue(quantize=True,
                                             quantize_axis="col")):
        with pytest.raises(NotImplementedError):
            ops.int8_matmul(*ops_, epilogue=ep)
    with pytest.raises(TypeError):
        ops.int8_matmul(ops_[0].float(), *ops_[1:])


# ---------------------------------------------------------------------------
# the weight pass and the int8 MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,param_dtype", [("granite-3-8b", "bfloat16"),
                                              ("internlm2-1.8b", None)])
def test_quantize_params_for_serving_bitwise_equals_reference(arch,
                                                              param_dtype):
    over = {"param_dtype": param_dtype} if param_dtype else {}
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jm = JaxModel(jcfg, make_mesh(1, 1))
    params = jm.init_params(0)
    jq = jm.quantize_params_for_serving(params)["groups"]["b0"]
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(from_jax_params(
        tcfg, jax.tree.map(np.asarray, params)))
    q = tm.quantize_params_for_serving()
    assert q.quantize_params_for_serving() is q and q.int8
    assert q.embed is tm.embed and q.blocks[0].ln1 is tm.blocks[0].ln1
    for i, blk in enumerate(q.blocks):
        for sub, name in (("attn", "wqkv"), ("attn", "wo"), ("ffn", "gate"),
                          ("ffn", "up"), ("ffn", "down")):
            got = getattr(getattr(blk, sub), name)
            want = jq[sub][name]
            assert isinstance(got, QuantizedWeight)
            assert isinstance(want, JQuantizedWeight)
            k, n = got.q.shape
            np.testing.assert_array_equal(
                got.q.numpy(), np.asarray(want.q[i]).reshape(k, n))
            np.testing.assert_array_equal(
                got.scale.numpy(), np.asarray(want.scale[i]).reshape(1, n))


@pytest.mark.parametrize("arch", ["granite-3-8b", "internlm2-1.8b"])
def test_quantized_weights_are_stored_k_major(arch):
    """The int8 copy stores each weight once as a contiguous [N, K] buffer
    (the s8 wgmma's K-major operand); ``q`` and ``as_matrix()`` are its
    [K, N] view, bitwise the reference's ``q``, and no copy is made when a
    GEMM takes it."""
    jcfg = jax_config(arch, smoke=True)
    tcfg = get_config(arch, smoke=True)
    jm = JaxModel(jcfg, make_mesh(1, 1))
    params = jm.init_params(0)
    jq = jm.quantize_params_for_serving(params)["groups"]["b0"]
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(from_jax_params(
        tcfg, jax.tree.map(np.asarray, params)))
    q = tm.quantize_params_for_serving()
    for i, blk in enumerate(q.blocks):
        for sub, name in (("attn", "wqkv"), ("attn", "wo"), ("ffn", "gate"),
                          ("ffn", "up"), ("ffn", "down")):
            w = getattr(getattr(blk, sub), name)
            k, n = w.q.shape
            assert w.qt.shape == (n, k) and w.qt.is_contiguous()
            qb, sb = w.as_matrix()
            assert qb.data_ptr() == w.qt.data_ptr() and qb.stride() == (1, k)
            assert torch.equal(qb, w.qt.t()) and sb.shape == (1, n)
            np.testing.assert_array_equal(
                w.qt.numpy(), np.asarray(jq[sub][name].q[i]).reshape(k, n).T)
            assert set(w.state_dict()) == {"qt", "scale"}


def test_k2_plain_takes_the_k_major_view():
    """The plain K2 gives bitwise the same product on the [N, K] buffer's
    [K, N] view as on a row-major copy."""
    (qa, sa, qb, sb), _ = _int8_operands(5, 48, 80, seed=3)
    view = qb.t().contiguous().t()
    assert not view.is_contiguous()
    for ep in (Epilogue(), Epilogue(out_dtype=torch.bfloat16)):
        assert torch.equal(ops.int8_matmul(qa, sa, view, sb, epilogue=ep),
                           ops.int8_matmul(qa, sa, qb, sb, epilogue=ep))


def test_int8_mlp_hands_q_scale_from_up_to_down(monkeypatch):
    """One standalone quantize per MLP: the down GEMM consumes the (q,
    scale) pair the up GEMM's epilogue emitted, never a requantized
    float tensor."""
    cfg = get_config("granite-3-8b", smoke=True)
    tm = Model(cfg, device="cpu").init_weights(0).quantize_params_for_serving()
    blk = tm.blocks[0]
    calls = {"quantize_rowwise": [], "int8_matmul": []}
    real_q, real_mm = ops.quantize_rowwise, ops.int8_matmul

    def spy_q(x):
        out = real_q(x)
        calls["quantize_rowwise"].append(out)
        return out

    def spy_mm(qa, sa, *rest, **kw):
        out = real_mm(qa, sa, *rest, **kw)
        calls["int8_matmul"].append(((qa, sa), kw.get("epilogue"), out))
        return out

    monkeypatch.setattr(ops, "quantize_rowwise", spy_q)
    monkeypatch.setattr(ops, "int8_matmul", spy_mm)
    x = torch.randn(3, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0)).to(torch.bfloat16)
    ffn = {n: getattr(blk.ffn, n) for n in ("gate", "up", "down")}
    h, xn = layers.mlp_apply(ffn, x, torch.bfloat16, residual=x,
                             norm_scale=blk.ln1)
    assert len(calls["quantize_rowwise"]) == 1
    gate, up, down = calls["int8_matmul"]
    assert gate[0][0] is up[0][0] is calls["quantize_rowwise"][0][0]
    assert up[1].quantize and up[1].gate == "silu"
    assert down[0][0] is up[2][0] and down[0][1] is up[2][1]
    assert h.shape == x.shape and xn.shape == x.shape


def test_cpu_int8_dispatch_never_touches_the_cuda_build():
    _cuda.reset_launches()
    ops_, _ = _int8_operands(4, 16, 16, seed=0)
    ops.int8_matmul(*ops_)
    ops.quantize_rowwise(torch.ones(2, 16))
    assert not _cuda._LIBS and not any(_cuda.LAUNCHES.values())
    from repro_torch.kernels.matmul import int8_matmul_cuda
    from repro_torch.kernels.quantize import quantize_rowwise_cuda
    with pytest.raises(ValueError, match="CUDA"):
        int8_matmul_cuda(*ops_, Epilogue())
    with pytest.raises(ValueError, match="CUDA"):
        quantize_rowwise_cuda(torch.ones(2, 16))



@pytest.mark.parametrize("n_layers", [2, 40])
def test_int8_witness_at_init_scales(n_layers):
    """At the reference's init scales the int8 copy's first logits stay
    within 10% of the logit scale of the bf16 model's (chip_smoke.py's
    INT8_WITNESS_TOL, K2 and K3 against K1 on the card), while a changed
    last token moves the bf16 logits by more than 4x that."""
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True),
                              param_dtype="bfloat16", n_layers=n_layers)
    tm = Model(cfg, device="cpu").init_weights(0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 32)))
    other = toks.clone()
    other[:, -1] = (other[:, -1] + 1) % cfg.vocab
    want = tm.prefill(toks)[0].double()
    got = tm.quantize_params_for_serving().prefill(toks)[0].double()
    off = tm.prefill(other)[0].double()

    def rel(a):
        return float(((a - want).abs().amax(-1)
                      / want.abs().amax(-1).clamp(min=1.0)).max())

    assert rel(got) <= 0.10
    assert rel(off) > 0.40
