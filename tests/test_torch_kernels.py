"""The port's kernel modules against the JAX reference, on the CPU.

Each kernel of the serving slice (K1 fused-epilogue GEMM, K4 flash
prefill, K5 split-K flash decode) runs here as its plain PyTorch version
(``repro_torch.kernels.ops`` dispatches a CPU tensor to it) and is held
against the JAX Pallas kernel in interpret mode on the same inputs, made
from a numpy seed.  The CUDA kernels themselves are held against these
plain versions on the card by ``chip_smoke.py``.

Tolerances: fp32 outputs within 1e-5 of the output scale (the two sides
sum in different orders); bf16 outputs within one bf16 ulp of the output
scale for the GEMM (a summation-order difference may flip one rounding),
two for attention (online softmax vs. one softmax, then the bf16 cast).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels.epilogue import Epilogue as JEpilogue
from repro.kernels.matmul import matmul_pallas
from repro.models.param import split_packed_columns as j_split

from repro_torch.core.maxeva_matmul import rank_order_sum, unshard_weight_xyz
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.models.param import pack_views, split_packed_columns

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

BF16_EPS = float(torch.finfo(torch.bfloat16).eps)
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(rng, shape, dtype, scale=1.0):
    """The same values as a (jax, torch) pair: drawn in fp32, rounded once
    by torch, handed to JAX exactly through fp32."""
    t = torch.from_numpy((rng.standard_normal(shape) * scale)
                         .astype(np.float32)).to(_T[dtype])
    return jnp.asarray(t.float().numpy()).astype(_J[dtype]), t


def _close(got: torch.Tensor, want, tol: float):
    g = got.double().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(1.0, float(np.max(np.abs(w))))
    err = float(np.max(np.abs(g - w)))
    assert err <= tol * scale, f"err {err:.3e} > {tol:.1e} x {scale:.3e}"


# ---------------------------------------------------------------------------
# K1: fused-epilogue GEMM
# ---------------------------------------------------------------------------

EPILOGUES = {
    "cast": dict(),
    "gate_silu": dict(gate="silu"),
    "residual_rmsnorm": dict(residual=True, norm="rmsnorm"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ep_name", list(EPILOGUES))
def test_k1_plain_matches_pallas_interpret(ep_name, dtype):
    m, k, n = 5, 70, 33
    rng = np.random.default_rng(11)
    ja, ta = _pair(rng, (m, k), dtype)
    jb, tb = _pair(rng, (k, n), dtype, k ** -0.5)
    jo, to = _pair(rng, (m, n), dtype)
    jr, tr = _pair(rng, (m, n), dtype)
    jn, tn = _pair(rng, (n,), "float32", 0.1)
    spec = EPILOGUES[ep_name]
    jep = JEpilogue(out_dtype=_J[dtype], **spec)
    tep = Epilogue(out_dtype=_T[dtype], **spec)
    jkw, tkw = {}, {}
    if "gate" in spec:
        jkw["operand2"], tkw["operand2"] = jo, to
    if "residual" in spec:
        jkw["residual"], tkw["residual"] = jr, tr
    if "norm" in spec:
        jkw["norm_scale"], tkw["norm_scale"] = jn, tn
    want = matmul_pallas(ja, jb, block=(32, 32, 32), interpret=True,
                         epilogue=jep, **jkw)
    got = ops.matmul(ta, tb, epilogue=tep, **tkw)
    tol = 1e-5 if dtype == "float32" else BF16_EPS
    if tep.norm == "rmsnorm":
        assert got[0].dtype == _T[dtype] and got[1].dtype == _T[dtype]
        _close(got[0], want[0], tol)
        _close(got[1], want[1], tol)
    else:
        assert got.dtype == _T[dtype]
        _close(got, want, tol)


def test_k1_fused_norm_is_store_then_rmsnorm():
    """The normed output is computed from the CAST value: bitwise the
    standalone rmsnorm of the stored value."""
    rng = np.random.default_rng(3)
    _, a = _pair(rng, (6, 40), "bfloat16")
    _, b = _pair(rng, (40, 24), "bfloat16")
    _, r = _pair(rng, (6, 24), "bfloat16")
    _, s = _pair(rng, (24,), "float32")
    ep = Epilogue(residual=True, norm="rmsnorm", out_dtype=torch.bfloat16)
    value, normed = ops.matmul(a, b, epilogue=ep, residual=r, norm_scale=s)
    assert torch.equal(normed, ops.rmsnorm(value, s, ep.norm_eps))


def test_epilogue_rejects_bad_specs():
    with pytest.raises(ValueError):
        Epilogue(activation="tanh")
    with pytest.raises(ValueError):
        Epilogue(gate="swish")
    with pytest.raises(ValueError):
        Epilogue(quantize=True, norm="rmsnorm")
    with pytest.raises(ValueError):
        Epilogue(norm_eps=0.0)
    a = torch.ones(2, 8)
    with pytest.raises(NotImplementedError):
        ops.matmul(a, torch.ones(8, 8), epilogue=Epilogue(quantize=True))
    with pytest.raises(ValueError):
        ops.matmul(a, torch.ones(8, 8), residual=a)


@pytest.mark.parametrize("spec", [dict(bias=True), dict(activation="silu"),
                                  dict(gate="mul"), dict(gate="relu")])
def test_epilogue_stages_outside_the_slice_raise(spec):
    """Stages no caller of this slice uses keep their fields but are not
    implemented: the plain version refuses them like the kernel does."""
    a = torch.ones(2, 8)
    with pytest.raises(NotImplementedError):
        ops.matmul(a, torch.ones(8, 8), epilogue=Epilogue(**spec),
                   operand2=torch.ones(2, 8) if "gate" in spec else None)


def test_packed_split_matches_reference_and_roundtrips():
    """granite's interleaved wqkv layout, at a small size: the port splits
    like the reference and ``pack_views`` inverts it."""
    q_dim, kv_dim, packing = 64, 16, 16
    x = np.arange(3 * (q_dim + 2 * kv_dim), dtype=np.float32).reshape(3, -1)
    want = j_split(x, (q_dim, kv_dim, kv_dim), packing)
    got = split_packed_columns(torch.from_numpy(x),
                               (q_dim, kv_dim, kv_dim), packing)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert torch.equal(pack_views(got, packing), torch.from_numpy(x))


def test_unshard_and_rank_order_sum():
    w = torch.arange(24, dtype=torch.float32).reshape(1, 4, 6)
    assert torch.equal(unshard_weight_xyz(w, 1), w[0])
    buf = torch.tensor([[1e8], [1.0], [-1e8]], dtype=torch.float32)
    # ascending fold: (1e8 + 1) + -1e8 == 0 at fp32, not 1
    assert rank_order_sum(buf).item() == 0.0


# ---------------------------------------------------------------------------
# K4: flash prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_h,n_kv", [(4, 2), (8, 2)])
def test_k4_plain_matches_pallas_interpret(n_h, n_kv, dtype):
    b, s, hd = 2, 13, 16                    # S not a multiple of the block
    rng = np.random.default_rng(n_h)
    jq, tq = _pair(rng, (b, s, n_h, hd), dtype)
    jk, tk = _pair(rng, (b, s, n_kv, hd), dtype)
    jv, tv = _pair(rng, (b, s, n_kv, hd), dtype)
    want = jfa.flash_attention_pallas(jq, jk, jv, kind="global", block_q=8,
                                      block_k=8, interpret=True)
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == _T[dtype] and got.shape == tq.shape
    _close(got, want, 1e-5 if dtype == "float32" else 2 * BF16_EPS)


# ---------------------------------------------------------------------------
# K5: split-K flash decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_splits", [1, 2])
def test_k5_plain_matches_pallas_interpret(n_splits):
    b, kv_len, n_kv, g, hd, pos = 2, 75, 2, 4, 16, 61
    rng = np.random.default_rng(5 + n_splits)
    jq, tq = _pair(rng, (b, 1, n_kv, g, hd), "bfloat16")
    jk, tk = _pair(rng, (b, kv_len, n_kv, hd), "bfloat16")
    jv, tv = _pair(rng, (b, kv_len, n_kv, hd), "bfloat16")
    want = jfa.flash_decode_pallas(jq, jk, jv, jnp.int32(pos),
                                   n_splits=n_splits, interpret=True)
    got = ops.flash_decode(tq, tk, tv, pos, n_splits=n_splits)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    _close(got, want, 2 * BF16_EPS)


def test_k5_bitwise_invariant_to_n_splits():
    rng = np.random.default_rng(9)
    _, q = _pair(rng, (2, 1, 2, 4, 16), "bfloat16")
    _, kc = _pair(rng, (2, 100, 2, 16), "bfloat16")
    _, vc = _pair(rng, (2, 100, 2, 16), "bfloat16")
    outs = [ops.flash_decode(q, kc, vc, 77, n_splits=s) for s in (1, 2, 4)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_k5_tiling_matches_the_f64_oracle():
    """At f64 the tiled decode and the plain untiled softmax agree to
    rounding: the tiling and the combine change no math."""
    rng = np.random.default_rng(2)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s))
                 for s in ((2, 1, 2, 4, 16), (2, 70, 2, 16), (2, 70, 2, 16)))
    want = ref.flash_decode_ref(q, kc, vc, 45)
    got = ops.flash_decode(q, kc, vc, 45)
    assert got.dtype == torch.float64
    assert float((got - want).abs().max()) <= 1e-12


def test_k5_masked_tiles_fold_as_zero():
    """Tiles past the position are (_NEG, 0, 0) and change no bit."""
    rng = np.random.default_rng(4)
    _, q = _pair(rng, (1, 1, 2, 2, 16), "float32")
    _, kc = _pair(rng, (1, 96, 2, 16), "float32")
    _, vc = _pair(rng, (1, 96, 2, 16), "float32")
    m_t, l_t, acc_t = tfa.decode_tile_partials(q, kc, vc, 20)
    assert torch.all(m_t[1:] == tfa._NEG) and torch.all(l_t[1:] == 0)
    assert torch.all(acc_t[1:] == 0)
    short = ops.flash_decode(q, kc[:, :32], vc[:, :32], 20)
    assert torch.equal(short, ops.flash_decode(q, kc, vc, 20))


def test_cpu_dispatch_never_touches_the_cuda_build():
    """The wrappers take the plain versions for CPU tensors: nothing is
    built or loaded, nothing is counted, and a CPU tensor handed to a
    kernel wrapper directly is refused."""
    _cuda.reset_launches()
    x = torch.ones(4, 16, dtype=torch.bfloat16)
    ops.matmul(x, torch.ones(16, 8, dtype=torch.bfloat16))
    ops.rmsnorm(x, torch.zeros(16))
    assert not _cuda._LIBS and not any(_cuda.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        from repro_torch.kernels.matmul import matmul_cuda
        matmul_cuda(x, torch.ones(16, 8, dtype=torch.bfloat16), Epilogue())
    with pytest.raises(TypeError):
        from repro_torch.kernels.matmul import matmul_cuda
        matmul_cuda(x.float(), torch.ones(16, 8), Epilogue())
