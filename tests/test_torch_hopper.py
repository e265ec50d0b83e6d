"""K1's launch plan, its plain split-K arithmetic and the C interface of
the CUDA kernels, on the CPU.

The K1 kernel (``csrc/matmul.cu``) picks its regime, tile width and K
split from ``kernels.matmul.k1_plan``, a pure function of the shape and
the card's SM count: the plan is checked here for every decode projection
of granite-3-8b and gemma2-27b at the H100's 132 SMs.  The bytes regime
sums each split's partial product and folds the partials in ascending
split order; its plain version (``ref.matmul_splitk_ref``) is held
against the adder tree (bitwise), against the unsplit plain GEMM and
against the JAX Pallas kernel in interpret mode (each output row within
two bf16 ulps of its scale: the splits sum in another order, which may
flip one rounding of the value and one more of the normed output).  The
ctypes argument list of every exported launcher must match its ``extern
"C"`` declaration, since a mismatch is not caught on the card.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.epilogue import Epilogue as JEpilogue
from repro.kernels.matmul import matmul_pallas

from repro_torch.configs import get_config
from repro_torch.kernels import _cuda, ref
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.matmul import (K1_BLOCKS_PER_SM, K2_K,
                                        K2_SMS_PER_BLOCK, k1_plan, k2_plan)

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

H100_SMS = 132
BF16_EPS = float(torch.finfo(torch.bfloat16).eps)
ARCHS = ("granite-3-8b", "gemma2-27b")
PROJECTIONS = ("qkv", "o", "gate", "up", "down")
EPILOGUES = {
    "cast": dict(),
    "gate_silu": dict(gate="silu"),
    "residual_rmsnorm": dict(residual=True, norm="rmsnorm"),
}


def _projection(arch: str, name: str):
    """(K, N) of one projection of a decoder block of ``arch``."""
    cfg = get_config(arch)
    d, ff = cfg.d_model, cfg.d_ff
    return {"qkv": (d, cfg.q_dim + 2 * cfg.kv_dim), "o": (cfg.q_dim, d),
            "gate": (d, ff), "up": (d, ff), "down": (ff, d)}[name]


def _row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst row's error against that row's own scale."""
    g, w = got.double(), want.double()
    diff = (g - w).abs().amax(dim=-1)
    return float((diff / w.abs().amax(dim=-1).clamp(min=1e-3)).max())


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("proj", PROJECTIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_k1_decode_grid_fills_the_card(arch, proj):
    """Every decode projection (M = 1 to 8 lanes) streams its weight from
    at least two blocks per SM."""
    k, n = _projection(arch, proj)
    for m in (1, 2, 4, 8):
        plan = k1_plan(m, n, k, H100_SMS)
        assert plan.regime == "bytes"
        assert plan.blocks >= K1_BLOCKS_PER_SM * H100_SMS, (m, plan)


SHAPES = [(m, n, k) for m in (1, 3, 8, 63, 64, 512, 8320)
          for n, k in ((64, 64), (200, 520), (4096, 4096), (4608, 36864),
                       (36864, 4608))]


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_k1_plan_depends_on_the_shape_alone(m, n, k):
    """The regime follows M; a bytes-regime split does not depend on M (so
    every row of a call sums in one order); the split ranges cover K once,
    contiguous and ascending."""
    plan = k1_plan(m, n, k, H100_SMS)
    assert plan == k1_plan(m, n, k, H100_SMS)
    if m >= 64:
        assert plan.regime == "operations"
        assert plan.splits == 1 and plan.cols in (128, 192, 256)
    else:
        assert plan.regime == "bytes"
        assert plan.rows >= m and plan.rows % 8 == 0
        assert {k1_plan(r, n, k, H100_SMS).splits for r in (1, 8, 63)} \
            == {plan.splits}
    ranges = plan.k_ranges(k)
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(b < e for b, e in ranges)
    assert all(e == b2 for (_, e), (b2, _) in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_k2_plan_depends_on_the_shape_alone(m, n, k):
    """K2's plan: K1's regimes and widths at 128 k a stage; the bytes
    regime's split does not depend on M and its ranges cover K once, in
    whole 128-value stages but the last."""
    plan = k2_plan(m, n, k, H100_SMS)
    assert plan == k2_plan(m, n, k, H100_SMS)
    assert plan.k_tile == K2_K and plan.k_tiles == -(-k // K2_K)
    if m >= 64:
        assert plan.regime == "operations" and plan.splits == 1
        assert plan.cols == k1_plan(m, n, k, H100_SMS).cols
    else:
        assert plan.regime == "bytes" and plan.cols == 128
        assert {k2_plan(r, n, k, H100_SMS).splits for r in (1, 8, 63)} \
            == {plan.splits}
    ranges = plan.k_ranges(k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(e == b2 for (_, e), (b2, _) in zip(ranges, ranges[1:]))
    assert all(b % K2_K == 0 for b, _ in ranges)


@pytest.mark.parametrize("proj", PROJECTIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_k2_decode_grid_holds_a_block_per_two_sms(arch, proj):
    """Every int8 decode projection streams its weight from at least one
    block per ``K2_SMS_PER_BLOCK`` SMs (or one block per k tile), with
    longer splits than K1's."""
    k, n = _projection(arch, proj)
    plan = k2_plan(8, n, k, H100_SMS)
    assert plan.regime == "bytes"
    assert plan.blocks >= min(-(-H100_SMS // K2_SMS_PER_BLOCK),
                              -(-n // 128) * plan.k_tiles)
    assert plan.splits <= k1_plan(8, n, k, H100_SMS).splits


# ---------------------------------------------------------------------------
# the plain split-K arithmetic
# ---------------------------------------------------------------------------

def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("m,n,k", [(8, 72, 300), (4, 200, 1030),
                                   (2, 64, 4096)])
def test_splitk_fold_is_the_adder_tree(m, n, k):
    """The fold of the split partials is bitwise the rank-order adder tree
    (K7's plain version) over the same partials."""
    plan = k1_plan(m, n, k, H100_SMS)
    assert plan.splits > 1
    rng = np.random.default_rng(m * 7 + n)
    a, b = _bf16(rng, (m, k)), _bf16(rng, (k, n), k ** -0.5)
    parts = ref.splitk_partials_ref(a, b, plan.k_ranges(k))
    assert parts.shape == (plan.splits, m, n)
    assert parts.dtype == torch.float32
    assert torch.equal(ref.splitk_fold_ref(parts, Epilogue()),
                       ref.addertree_ref(parts, torch.float32))


def _operands(rng, m, n, spec):
    kw = {}
    if "gate" in spec:
        kw["operand2"] = _bf16(rng, (m, n))
    if "residual" in spec:
        kw["residual"] = _bf16(rng, (m, n))
    if "norm" in spec:
        kw["norm_scale"] = torch.from_numpy(
            (rng.standard_normal(n) * 0.1).astype(np.float32))
    return kw


@pytest.mark.parametrize("ep_name", list(EPILOGUES))
def test_splitk_plain_matches_the_unsplit_plain(ep_name):
    """At gemma2's o-projection shape, cut to 96 columns, the split sum is
    within 2 bf16 ulps of each row's scale of the one-product version."""
    m, k, n = 8, 4096, 96
    plan = k1_plan(m, n, k, H100_SMS)
    assert plan.splits > 1
    rng = np.random.default_rng(5)
    a, b = _bf16(rng, (m, k)), _bf16(rng, (k, n), k ** -0.5)
    spec = EPILOGUES[ep_name]
    ep = Epilogue(out_dtype=torch.bfloat16, **spec)
    kw = _operands(rng, m, n, spec)
    got = ref.matmul_splitk_ref(a, b, ep, plan.k_ranges(k), **kw)
    want = ref.matmul_fused_ref(a, b, ep, **kw)
    pairs = zip(got, want) if ep.norm != "none" else [(got, want)]
    for g, w in pairs:
        assert g.dtype == torch.bfloat16
        assert _row_err(g, w) <= 2 * BF16_EPS


@pytest.mark.parametrize("ep_name", list(EPILOGUES))
def test_splitk_plain_matches_pallas_interpret(ep_name):
    """The split sum against the JAX GEMM in interpret mode on the same
    bf16 inputs: each row within 2 bf16 ulps of its scale."""
    m, k, n = 5, 300, 40
    plan = k1_plan(m, n, k, H100_SMS)
    assert plan.splits > 1
    rng = np.random.default_rng(17)
    a, b = _bf16(rng, (m, k)), _bf16(rng, (k, n), k ** -0.5)
    spec = EPILOGUES[ep_name]
    kw = _operands(rng, m, n, spec)

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)

    want = matmul_pallas(j(a), j(b), block=(32, 32, 32), interpret=True,
                         epilogue=JEpilogue(out_dtype=jnp.bfloat16, **spec),
                         **{key: j(v) for key, v in kw.items()})
    got = ref.matmul_splitk_ref(a, b, Epilogue(out_dtype=torch.bfloat16,
                                               **spec),
                                plan.k_ranges(k), **kw)
    if "norm" not in spec:
        got, want = [got], [want]
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(jnp.asarray(w, jnp.float32)))
        assert _row_err(g, w) <= 2 * BF16_EPS


# ---------------------------------------------------------------------------
# the C interface and the sources
# ---------------------------------------------------------------------------

def _extern_c():
    """{name: (source stem, parameter count)} of every ``extern "C"``
    launcher in ``csrc/*.cu``."""
    out = {}
    for path in sorted(_cuda.CSRC.glob("*.cu")):
        for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)',
                             path.read_text()):
            params = [p for p in m.group(2).split(",") if p.strip()]
            out[m.group(1)] = (path.stem, len(params))
    return out


@pytest.mark.parametrize("lib,fn", [(lib, fn)
                                    for lib, fns in _cuda.SIGNATURES.items()
                                    for fn in fns])
def test_signature_matches_the_extern_c_declaration(lib, fn):
    decl = _extern_c()
    assert fn in decl, f"{fn} is not declared extern \"C\" in csrc/"
    assert decl[fn] == (lib, len(_cuda.SIGNATURES[lib][fn]))


def test_every_extern_c_launcher_has_a_signature():
    assert set(_extern_c()) == {fn for fns in _cuda.SIGNATURES.values()
                                for fn in fns}


def test_k1_and_k4_run_on_wgmma_and_tma():
    """K1's float path and K4 issue wgmma and load through TMA; no WMMA is
    left on either."""
    header = (_cuda.CSRC / "hopper.cuh").read_text()
    assert "wgmma.mma_async" in header
    assert "cp.async.bulk.tensor" in header
    attn = (_cuda.CSRC / "flash_attention.cu").read_text()
    assert "wmma" not in attn.replace("wgmma", "")
    assert "wgmma_rs" in attn and "tma_load_3d" in attn
    mm = (_cuda.CSRC / "matmul.cu").read_text()
    k1 = mm[mm.index("// K1: bf16 GEMM, wgmma + TMA"):
            mm.index("constexpr int NORM_THREADS")]
    assert "wmma" not in k1.replace("wgmma", "")
    assert "wgmma_ss" in k1 and "tma_load_2d" in k1


def test_the_build_hash_covers_the_header(tmp_path, monkeypatch):
    """An edit of ``hopper.cuh`` alone rebuilds the libraries that include
    it."""
    for f in list(_cuda.CSRC.glob("*.cu")) + list(_cuda.CSRC.glob("*.cuh")):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    before = _cuda._target("matmul")
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _cuda._target("matmul") != before


def test_k2_and_the_chunk_body_run_on_wgmma_and_tma():
    """K2 issues the s8 wgmma on TMA-loaded K-major tiles (no WMMA is left
    in the port), and K6's chunk body K4's wgmma products on pages loaded
    by TMA."""
    header = (_cuda.CSRC / "hopper.cuh").read_text()
    assert "m64n256k32.s32.s8.s8" in header and "m64n8k32.s32.s8.s8" in header
    mm = (_cuda.CSRC / "matmul.cu").read_text()
    k2 = mm[mm.index("// K2: int8 GEMM, s8 wgmma + TMA"):
            mm.index("// K3: rowwise")]
    assert "wgmma_s8" in k2 and "tma_load_2d" in k2
    assert "wmma" not in mm.replace("wgmma", "")
    attn = (_cuda.CSRC / "flash_attention.cu").read_text()
    chunk = attn[attn.index("// K6, prefill chunks (S > 1)"):
                 attn.index("// K5 / K6: split-K flash decode")]
    assert "issue_scores" in chunk and "issue_pv" in chunk
    assert "tma_load_4d" in chunk and "tma_load_3d" in chunk
