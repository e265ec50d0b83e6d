"""The row passes on the CPU: the rmsnorm's ordered mirror, the choice of
the fused tail and what the GEMM and row kernels' launchers are handed.

On the card the rmsnorm runs in one device routine (``rmsnorm_row`` in
``csrc/matmul.cu``), one warp a row, whose summation order depends on N
alone; a bytes-regime GEMM call (decode) runs it, or K2's row quantize,
in its store phase (``GemmPlan.row_tail``), every other call stores the
value and launches a row kernel.  ``ref.rmsnorm_rows_ref`` mirrors that
order; here it is held against the plain ``rms_normalize`` and the JAX
Pallas GEMM's norm stage in interpret mode (each row within one bf16 ulp
of its scale: another summation order may flip one rounding), and
against itself across row counts and neighbours (bitwise).  The kernels
run only on the card (``chip_smoke.py`` holds them bitwise against the
mirror and K3's plain version); here the launches are intercepted at
``kernels._cuda.launch``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.epilogue import Epilogue as JEpilogue
from repro.kernels.matmul import matmul_pallas
from repro.kernels.quantize import quantize_rowwise_pallas

from repro_torch.kernels import _cuda, ref
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels.epilogue import Epilogue, rms_normalize
from repro_torch.kernels.quantize import quantize_rowwise_cuda

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

H100_SMS = 132
BF16_EPS = float(torch.finfo(torch.bfloat16).eps)
BF = torch.bfloat16


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(BF)


def _f32(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


def _row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst row's error against that row's own scale."""
    g, w = got.double(), want.double()
    diff = (g - w).abs().amax(dim=-1)
    return float((diff / w.abs().amax(dim=-1).clamp(min=1e-3)).max())


def _jx(t: torch.Tensor):
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == BF else a


# ---------------------------------------------------------------------------
# the ordered mirror of the rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n", [(1, 8), (5, 200), (4, 4096), (3, 4608),
                                 (2, 12800)])
def test_mirror_is_within_an_ulp_of_rms_normalize(m, n):
    rng = np.random.default_rng(n + m)
    x = _bf16(rng, (m, n), 3.0)
    scale = _f32(rng, (n,), 0.1)
    got = ref.rmsnorm_rows_ref(x, scale, 1e-6)
    assert got.dtype == BF and got.shape == x.shape
    assert _row_err(got, rms_normalize(x, scale, 1e-6)) <= BF16_EPS


@pytest.mark.parametrize("m,k,n", [(5, 64, 256), (8, 96, 200),
                                   (3, 32, 1024)])
def test_mirror_is_within_an_ulp_of_the_pallas_norm_stage(m, k, n):
    """The reference's GEMM with the residual and the rmsnorm in its store
    phase, in interpret mode: the mirror of its stored value within one
    bf16 ulp of each row's scale of its normed output."""
    rng = np.random.default_rng(7 * n + k)
    a, b = _bf16(rng, (m, k)), _bf16(rng, (k, n), k ** -0.5)
    res = _bf16(rng, (m, n))
    scale = _f32(rng, (n,), 0.1)
    value, normed = matmul_pallas(
        _jx(a), _jx(b), block=(32, 32, 32), interpret=True,
        epilogue=JEpilogue(residual=True, norm="rmsnorm",
                           out_dtype=jnp.bfloat16),
        residual=_jx(res), norm_scale=_jx(scale))
    value = torch.from_numpy(np.array(jnp.asarray(value, jnp.float32))
                             ).to(BF)
    normed = torch.from_numpy(np.array(jnp.asarray(normed, jnp.float32)))
    got = ref.rmsnorm_rows_ref(value, scale, 1e-6)
    assert _row_err(got, normed) <= BF16_EPS


@pytest.mark.parametrize("n", [64, 4096, 4608])
def test_mirror_is_bitwise_invariant_to_m_and_the_other_rows(n):
    rng = np.random.default_rng(n)
    x = _bf16(rng, (9, n), 2.0)
    scale = _f32(rng, (n,), 0.1)
    full = ref.rmsnorm_rows_ref(x, scale, 1e-6)
    for m in (1, 2, 5, 8):
        assert torch.equal(ref.rmsnorm_rows_ref(x[:m], scale, 1e-6),
                           full[:m])
    other = x.clone()
    other[1:] = _bf16(rng, (8, n), 50.0)
    assert torch.equal(ref.rmsnorm_rows_ref(other, scale, 1e-6)[0], full[0])
    assert torch.equal(ref.rmsnorm_rows_ref(x[3:4], scale, 1e-6)[0],
                       full[3])


@pytest.mark.parametrize("shape,dtype", [((5, 256), BF), ((3, 4096), BF),
                                         ((2, 12800), torch.float32),
                                         ((9, 200), torch.float32)])
def test_k3_plain_is_bitwise_the_pallas_kernel(shape, dtype):
    x = (3 * _f32(np.random.default_rng(shape[1]), shape)).to(dtype)
    q, s = ref.quantize_rowwise_ref(x)
    jq, js = quantize_rowwise_pallas(_jx(x), block_rows=8, interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# the plan's choice of the fused tail
# ---------------------------------------------------------------------------

SHAPES = [(m, n, k) for m in (1, 2, 4, 5, 8, 16, 63, 64, 512, 8320)
          for n, k in ((4096, 12800), (12800, 4096), (4608, 36864),
                       (36864, 4608), (16384, 64), (16392, 64), (64, 64))]


@pytest.mark.parametrize("plan_fn", [tmm.k1_plan, tmm.k2_plan],
                         ids=["k1", "k2"])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_the_row_tail_is_chosen_by_the_shape_alone(plan_fn, m, n, k):
    plan = plan_fn(m, n, k, H100_SMS)
    assert plan == plan_fn(m, n, k, H100_SMS)
    assert plan.row_tail == (plan.regime == "bytes"
                             and n <= tmm.NORM_MAX_N)
    if plan.regime == "bytes":
        assert plan.arrival_counters(m, n, False) == -(-n // 128) + 2
        assert plan.arrival_counters(m, n, True) == -(-n // 128) + 2 + m


def test_the_widest_norm_row_is_the_kernels():
    """The plan's and the wrapper's widest rmsnorm row is the one the
    kernels stage in shared memory (``NORM_MAX_N`` in ``csrc/matmul.cu``),
    which its launchers refuse past."""
    src = (_cuda.CSRC / "matmul.cu").read_text()
    assert f"constexpr int NORM_MAX_N = {tmm.NORM_MAX_N};" in src


# ---------------------------------------------------------------------------
# what the launchers are handed
# ---------------------------------------------------------------------------

@pytest.fixture
def intercepted(monkeypatch):
    """Run the GEMM and row-kernel wrappers on CPU tensors up to the
    launch: the device checks pass, each launch is recorded, the card has
    132 SMs."""
    calls = []
    monkeypatch.setattr(_cuda, "check", lambda *a, **kw: None)
    monkeypatch.setattr(_cuda, "launch",
                        lambda lib, fn, *args: calls.append((lib, fn, args)))
    monkeypatch.setattr(tmm, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(tmm, "_SPLIT_SCRATCH", {})
    tmm._device_plan.cache_clear()
    tmm._device_k2_plan.cache_clear()
    _cuda.reset_launches()
    for key in [k for k in _cuda.LAUNCHES if ":" in k]:
        del _cuda.LAUNCHES[key]
    yield calls
    tmm._device_plan.cache_clear()
    tmm._device_k2_plan.cache_clear()
    _cuda.reset_launches()
    for key in [k for k in _cuda.LAUNCHES if ":" in k]:
        del _cuda.LAUNCHES[key]


def _args(lib, fn, args):
    """The launcher's arguments by the names of its C declaration."""
    names = {
        "k1_matmul": ("a", "b", "out", "residual", "operand2", "workspace",
                      "counters", "norm_scale", "normed", "M", "N", "K",
                      "splits", "tile_n", "epi_flags", "eps"),
        "k2_int8_matmul": ("a", "b", "a_scale", "b_scale", "out_f32",
                           "out_bf16", "residual", "operand2", "workspace",
                           "counters", "norm_scale", "normed", "q",
                           "q_scale", "M", "N", "K", "splits", "tile_n",
                           "epi_flags", "eps"),
    }[fn]
    assert len(args) + 1 == len(_cuda.SIGNATURES[lib][fn]) == len(names) + 1
    return dict(zip(names, args))


def _down_k1(m, n=256, k=512):
    rng = np.random.default_rng(m)
    ep = Epilogue(residual=True, norm="rmsnorm", out_dtype=BF)
    return tmm.matmul_cuda(_bf16(rng, (m, k)), _bf16(rng, (k, n)), ep,
                           residual=_bf16(rng, (m, n)),
                           norm_scale=_f32(rng, (n,)))


def _int8(m, k, n, ep, **kw):
    rng = np.random.default_rng(m + n)
    qa = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    qt = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    return tmm.int8_matmul_cuda(qa, torch.ones(m, 1), qt.t(),
                                torch.ones(1, n), ep, **kw)


def test_k1_decode_norm_is_one_launch_with_the_tail(intercepted):
    """The down GEMM at 8 rows: one K1 launch that writes the normed rows
    (counted as ``matmul:norm``), no row-norm launch."""
    value, normed = _down_k1(8)
    ((lib, fn, args),) = intercepted
    got = _args(lib, fn, args)
    assert fn == "k1_matmul"
    assert got["normed"] == normed.data_ptr() and got["norm_scale"]
    assert got["counters"] and got["eps"] == 1e-6
    assert _cuda.LAUNCHES["matmul"] == 1
    assert _cuda.LAUNCHES["matmul:norm"] == 1
    assert _cuda.LAUNCHES["rmsnorm"] == 0
    assert value.shape == normed.shape == (8, 256)


def test_k1_chunk_norm_is_a_gemm_and_a_row_launch(intercepted):
    """The down GEMM at 512 rows (a scheduler chunk): the GEMM stores the
    value, then one row-norm launch reads it."""
    value, normed = _down_k1(512)
    (l1, f1, a1), (l2, f2, a2) = intercepted
    got = _args(l1, f1, a1)
    assert got["normed"] is None and got["norm_scale"] is None
    assert got["counters"] is None and got["splits"] == 1
    assert (l2, f2) == ("matmul", "k1_rmsnorm_rows")
    assert a2[0] == value.data_ptr() and a2[2] == normed.data_ptr()
    assert a2[3:5] == (512, 256)
    assert _cuda.LAUNCHES["matmul"] == 1 and _cuda.LAUNCHES["rmsnorm"] == 1
    assert "matmul:norm" not in _cuda.LAUNCHES


def test_split_scratch_holds_the_call_counter_without_a_split(intercepted):
    """The int8 up GEMM at decode (gate and row quantize, 12800 columns)
    is not split over K, yet its fused quantize needs the call's counter
    and its 8 row maxima: ``split_scratch`` holds them, and the launch
    gets them."""
    m, k, n = 8, 4096, 12800
    plan = tmm.k2_plan(m, n, k, H100_SMS)
    assert plan.splits == 1 and plan.row_tail
    rng = np.random.default_rng(3)
    q, scale = _int8(m, k, n, Epilogue(gate="silu", quantize=True),
                     operand2=_bf16(rng, (m, n)))
    ((lib, fn, args),) = intercepted
    got = _args(lib, fn, args)
    _, cnt = tmm._SPLIT_SCRATCH[None]
    assert got["counters"] == cnt.data_ptr()
    assert cnt.numel() >= -(-n // 128) + 2 + m
    assert bool((cnt == 0).all())
    assert got["q"] == q.data_ptr() and got["q_scale"] == scale.data_ptr()
    assert got["out_f32"] and got["out_bf16"] is None
    assert got["normed"] is None and got["splits"] == 1
    assert q.dtype == torch.int8 and scale.shape == (m, 1)
    assert _cuda.LAUNCHES["int8_matmul:quantize"] == 1
    assert _cuda.LAUNCHES["int8_quantize"] == 0


@pytest.mark.parametrize("m,tail", [(4, True), (8, True), (512, False)])
def test_k2_row_passes_fuse_at_decode_only(intercepted, m, tail):
    """K2's down GEMM (residual and rmsnorm) and up GEMM (gate and row
    quantize): one launch each at decode rows; at a chunk's 512 rows the
    GEMM and a row launch each (``rmsnorm``, ``int8_quantize``)."""
    rng = np.random.default_rng(m)
    k, n = 256, 512
    down = Epilogue(residual=True, norm="rmsnorm", out_dtype=BF)
    value, normed = _int8(m, k, n, down, residual=_bf16(rng, (m, n)),
                          norm_scale=_f32(rng, (n,)))
    _int8(m, k, n, Epilogue(gate="silu", quantize=True),
          operand2=_bf16(rng, (m, n)))
    fns = [fn for _, fn, _ in intercepted]
    if tail:
        assert fns == ["k2_int8_matmul", "k2_int8_matmul"]
        first = _args(*intercepted[0])
        assert first["normed"] == normed.data_ptr() and first["q"] is None
        assert _cuda.LAUNCHES["int8_matmul:norm"] == 1
        assert _cuda.LAUNCHES["int8_matmul:quantize"] == 1
        assert _cuda.LAUNCHES["rmsnorm"] == _cuda.LAUNCHES[
            "int8_quantize"] == 0
    else:
        assert fns == ["k2_int8_matmul", "k1_rmsnorm_rows",
                       "k2_int8_matmul", "k3_quantize_rows"]
        assert all(_args(*intercepted[i])["normed"] is None
                   and _args(*intercepted[i])["q"] is None for i in (0, 2))
        assert _cuda.LAUNCHES["rmsnorm"] == 1
        assert _cuda.LAUNCHES["int8_quantize"] == 1
        assert not any(":" in key for key in _cuda.LAUNCHES)
    assert _cuda.LAUNCHES["int8_matmul"] == 2
    assert value.shape == normed.shape == (m, n)


def test_row_kernels_take_whole_vectors_or_raise(intercepted):
    """A row of the row kernels is whole 16-byte vectors: a bf16 width not
    a multiple of 8 (fp32: 4) raises before any launch, as does an rmsnorm
    row whose scale would not fit the kernel's shared memory."""
    with pytest.raises(ValueError, match="divisible by 8"):
        tmm.rmsnorm_cuda(torch.ones(2, 12, dtype=BF), torch.ones(12), 1e-6)
    wide = tmm.NORM_MAX_N + 8
    with pytest.raises(ValueError, match=f"at most {tmm.NORM_MAX_N}"):
        tmm.rmsnorm_cuda(torch.ones(2, wide, dtype=BF), torch.ones(wide),
                         1e-6)
    with pytest.raises(ValueError, match="divisible by 8"):
        quantize_rowwise_cuda(torch.ones(2, 12, dtype=BF))
    with pytest.raises(ValueError, match="divisible by 4"):
        quantize_rowwise_cuda(torch.ones(2, 6))
    q, s = quantize_rowwise_cuda(torch.ones(3, 12))
    ((lib, fn, args),) = intercepted
    assert fn == "k3_quantize_rows" and args[3:6] == (3, 12, 1)
    assert _cuda.LAUNCHES["quantize"] == 1 and q.shape == (3, 12)
