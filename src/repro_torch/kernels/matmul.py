"""K1 and K2: the blocked GEMM with a fused epilogue, float and int8,
launched on the card.

K1 (``csrc/matmul.cu``, wgmma + TMA) has two regimes, chosen by the shape
alone (``k1_plan``): M >= 64 runs 128-row output tiles, 128 to 256 wide,
on the tensor cores; M < 64 swaps the operands so the weight fills
wgmma's 64-row side, streams it through a deep TMA ring and splits K
until the grid holds two blocks per SM; the last split of each column
block to arrive folds the fp32 split partials in ascending split order
before the epilogue (``split_scratch``).  ``ref.matmul_splitk_ref`` is
the plain version of that arithmetic.

``matmul_cuda`` and ``rmsnorm_cuda`` are the wrappers of K1 and of its
row-norm kernel in ``csrc/matmul.cu``; their plain PyTorch versions are
``ref.matmul_fused_ref`` and ``epilogue.rms_normalize``, which
``kernels.ops`` takes for tensors on the CPU.  The kernel takes bf16 x bf16
with an fp32 accumulator, and of the epilogue stages the serving path
uses: the cast to bf16, ``activation='gelu'`` (tanh form: whisper's
ungated up GEMM, counted as ``matmul:gelu``), ``gate='silu'`` with
``operand2``, the residual add, and ``norm='rmsnorm'``.  Any other stage
or dtype raises: the kernel never silently falls back.

The rmsnorm needs the whole row.  Where the plan says so
(``GemmPlan.row_tail``: the bytes regime, decode), the GEMM finishes it in
its store phase, in the same launch: the last column blocks to store their
columns (one per four rows) wait for the others, read the M stored rows
back from L2 and normalize them, one warp per row (counted as the variant
``matmul:norm``, not as a launch of ``rmsnorm``).  Otherwise the GEMM
stores the value and the row-norm kernel (one warp per row) normalizes
it.  Both run one device routine whose
summation order depends on N alone (``ref.rmsnorm_rows_ref`` is its
plain mirror), so a fused ``(value, normed)`` is bitwise
store-then-rmsnorm either way.

``int8_matmul_cuda`` wraps K2, ``k2_int8_matmul``: int8 x int8 into an
int32 accumulator on the s8 wgmma, with the row and column scales applied
first in the store phase; its plain version is ``ref.int8_matmul_ref``.
The s8 wgmma reads both operands K-major, so the weight is the [K, N]
view of a contiguous [N, K] buffer (``QuantizedWeight``); K2 runs K1's
two regimes and split rule with 128 k a stage (``k2_plan``), and its
split partials are int32, folded ascending by the last split to arrive.
It stores bf16 or fp32, after the gelu activation where asked
(``int8_matmul:gelu``; whisper's int8 up GEMM, whose quantize then counts
as ``int8_matmul:gelu+quantize`` at decode).  Under ``quantize`` it stores
the fp32 value in a
workspace; with the row tail the last column blocks to store quantize the
stored rows together, with scales from the call's row maxima
(``int8_matmul:quantize``); otherwise K3's row kernel does (counted as
``int8_quantize``).  Under
``norm='rmsnorm'`` it completes ``(value, normed)`` as K1 does
(``int8_matmul:norm`` or a launch of ``rmsnorm``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.quantize import quantize_rowwise_cuda


# K1's tiles (csrc/matmul.cu): the operations regime's rows and k per
# stage, and its column widths with their relative rates per column (a
# 128 x 256 tile carries the most work per byte loaded; the rates are
# launch/k1_widths.py's at 8320 rows on an H100, where every width fills
# its waves); the bytes regime's weight columns and k per stage, and the
# activation rows it rounds M up to.  K2 runs the same tiles with 128 k
# (128 bytes of int8) per stage, and weighs the widths by K1's rates.
K1_OPS_MIN_M = 64
K1_OPS_ROWS, K1_OPS_K = 128, 64
K1_OPS_COLS = {256: 1.0, 192: 0.88, 128: 0.71}
K1_DEC_TILE = (128, 64)
K1_DEC_ROWS = (8, 16, 32, 64)
K1_BLOCKS_PER_SM = 2
# K2: k per stage (one 128-byte swizzled row of int8); the bytes regime
# splits K until the grid holds one block per this many SMs, so that a
# split streams enough stages to amortize filling its ring
K2_K = 128
K2_SMS_PER_BLOCK = 2
# the widest rmsnorm row (csrc/matmul.cu's NORM_MAX_N: its fp32 scale is
# staged in shared memory), and so the widest row a GEMM finishes in its
# store phase
NORM_MAX_N = 16384


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """K1's or K2's launch for one shape: the regime, the block's output
    tile (``rows`` x ``cols``), k per stage, the blocks of the main kernel
    and the K split (bytes regime; 1 means no fold).  ``row_tail``: a row
    pass of the call (the rmsnorm, K2's row quantize) runs in its store
    phase, in the last column blocks to store (``arrival_counters``),
    rather than as a second launch."""

    regime: str
    rows: int
    cols: int
    k_tile: int
    k_tiles: int
    blocks: int
    splits: int
    row_tail: bool

    def arrival_counters(self, m: int, n: int, quantize: bool) -> int:
        """The zeroed counters a bytes-regime call of [m, n] takes, in
        ``csrc/matmul.cu``'s layout: one per 128-column block (a split
        call's fold), then the row tail's two (its column blocks' arrivals
        and its finished tail blocks), then under the fused quantize the
        ``m`` row maxima."""
        return -(-n // self.cols) + 2 + (m if quantize else 0)

    def k_ranges(self, k: int) -> List[Tuple[int, int]]:
        """[begin, end) of K that each split sums, in ascending split order:
        split i takes k tiles [i kt / s, (i + 1) kt / s) (the kernel's
        ``split_begin``)."""
        kt, s, bk = self.k_tiles, self.splits, self.k_tile
        return [(i * kt // s * bk, min((i + 1) * kt // s * bk, k))
                for i in range(s)]


def _gemm_plan(m: int, n: int, k: int, sms: int, ops_k: int,
               dec_k: int, dec_blocks: int) -> GemmPlan:
    if m >= K1_OPS_MIN_M:
        row_tiles = -(-m // K1_OPS_ROWS)
        cols = min(K1_OPS_COLS, key=lambda c: (
            -(-row_tiles * -(-n // c) // sms) * c / K1_OPS_COLS[c]))
        kt = -(-k // ops_k)
        return GemmPlan("operations", K1_OPS_ROWS, cols, ops_k, kt,
                        -(-m // K1_OPS_ROWS) * -(-n // cols), 1, False)
    bn = K1_DEC_TILE[0]
    rows = next(r for r in K1_DEC_ROWS if m <= r)
    kt = -(-k // dec_k)
    n_tiles = -(-n // bn)
    splits = max(1, min(kt, -(-dec_blocks // n_tiles)))
    return GemmPlan("bytes", rows, bn, dec_k, kt, n_tiles * splits, splits,
                    n <= NORM_MAX_N)


def k1_plan(m: int, n: int, k: int, sms: int) -> GemmPlan:
    """K1's launch plan, from the shape and the card's SM count only (never
    from data).  M >= 64 is the operations regime: one block per 128 x
    ``cols`` output tile, no split, ``cols`` the width of least estimated
    time, the waves of one-per-SM blocks its tiles take times its columns
    over its rate (the widest on a tie); no width changes the order in
    which an element's products are summed, so every M of the regime sums
    in one order.  M < 64 is the bytes regime: one block
    per 128 weight columns and per split, with K split into contiguous
    ranges of 64-deep tiles until the grid reaches ``K1_BLOCKS_PER_SM``
    blocks per SM (at most one split per k tile).  The split count does not
    depend on M, so every row of a bytes-regime call sums in the same
    order.  A bytes-regime call of at most ``NORM_MAX_N`` columns runs its
    rmsnorm in the store phase (``row_tail``): the last column blocks to
    store their columns, one per four rows, finish the rows together; an
    operations-regime call stores the value and launches the row-norm
    kernel after it.  The tail takes the card about as long as the
    row-norm launch it replaces at every M of the regime (``chip_smoke.py``
    times both at 2 to 63 rows) and saves the host that launch, so it is
    the rule there."""
    return _gemm_plan(m, n, k, sms, K1_OPS_K, K1_DEC_TILE[1],
                      K1_BLOCKS_PER_SM * sms)


def k2_plan(m: int, n: int, k: int, sms: int) -> GemmPlan:
    """K2's launch plan: K1's regimes and widths with ``K2_K`` = 128 int8
    values (one 128-byte row of a swizzled tile) of k per stage; the bytes
    regime splits K until the grid holds one block per
    ``K2_SMS_PER_BLOCK`` SMs.  Integer sums are exact, so no plan changes
    a bit.  The row tail follows K1's rule, for the rmsnorm and the row
    quantize alike (the quantize's last column blocks to store split the
    stored values into equal runs)."""
    return _gemm_plan(m, n, k, sms, K2_K, K2_K,
                      -(-sms // K2_SMS_PER_BLOCK))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def _device_plan(m: int, n: int, k: int, index: int) -> GemmPlan:
    return k1_plan(m, n, k, sm_count(index))


@functools.lru_cache(maxsize=4096)
def _device_k2_plan(m: int, n: int, k: int, index: int) -> GemmPlan:
    return k2_plan(m, n, k, sm_count(index))


_SPLIT_SCRATCH: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}


def split_scratch(device: torch.device, partials: int,
                  blocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scratch of a split or row-tail K1 or K2 call on ``device``: an fp32
    workspace of at least ``partials`` elements for the split partials,
    and at least ``blocks`` zeroed int32 arrival counters (a split call's
    one per column block, then a row-tail call's two and its row maxima:
    ``GemmPlan.arrival_counters``).  The block that folds a column, and the
    last tail block to finish the rows, reset theirs, so the counters are
    zero again when the kernel ends.  K1 and K2 calls on one device share both
    buffers and must therefore run on one stream (the port's only one).
    K5 and K6 take the same counters, one per row they split
    (``flash_attention.decode_splits``)."""
    ws, cnt = _SPLIT_SCRATCH.get(device.index, (None, None))
    if ws is None or ws.numel() < partials:
        ws = torch.empty(max(partials, 1 << 20), dtype=torch.float32,
                         device=device)
    if cnt is None or cnt.numel() < blocks:
        cnt = torch.zeros(max(blocks, 1024), dtype=torch.int32,
                          device=device)
    _SPLIT_SCRATCH[device.index] = (ws, cnt)
    return ws, cnt


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """Row rmsnorm of a bf16 ``[M, N]`` tensor with an fp32 ``[N]`` scale,
    N a multiple of 8 (16-byte rows): ``x * rsqrt(sum(x^2)/N + eps) * (1 +
    scale)``, one warp a row in the fixed order of
    ``ref.rmsnorm_rows_ref``."""
    m, n = x.shape
    _cuda.check(x, "rmsnorm input", torch.bfloat16)
    _cuda.check(scale, "rmsnorm scale", torch.float32, (n,))
    if n % 8 or n > NORM_MAX_N:
        raise ValueError(f"the row-norm kernel needs N divisible by 8 and "
                         f"at most {NORM_MAX_N}, got N={n}")
    out = torch.empty_like(x)
    if m == 0:
        return out
    _cuda.LAUNCHES["rmsnorm"] += 1
    _cuda.launch("matmul", "k1_rmsnorm_rows", x.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), m, n, float(eps))
    return out


# the kernels' epilogue flags (csrc/matmul.cu's EPI_SILU, EPI_GELU)
EPI_SILU, EPI_GELU = 1, 2


def _epilogue_operands(ep: Epilogue, m: int, n: int,
                       residual: Optional[torch.Tensor],
                       operand2: Optional[torch.Tensor],
                       norm_scale: Optional[torch.Tensor]) -> int:
    """Check the gate, residual and norm-scale operands the GEMM kernels
    read; returns the kernels' epilogue flags (the silu gate, the gelu
    activation)."""
    gate = ep.gate == "silu"
    if gate:
        if operand2 is None:
            raise ValueError("Epilogue.gate set but no operand2")
        _cuda.check(operand2, "operand2", torch.bfloat16, (m, n))
    if ep.residual:
        if residual is None:
            raise ValueError("Epilogue.residual set but no residual operand")
        _cuda.check(residual, "residual", torch.bfloat16, (m, n))
    if ep.norm == "rmsnorm":
        if norm_scale is None:
            raise ValueError("Epilogue.norm set but no norm_scale operand")
        _cuda.check(norm_scale, "rmsnorm scale", torch.float32, (n,))
    return (EPI_SILU if gate else 0) | (EPI_GELU if ep.activation == "gelu"
                                        else 0)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, ep: Epilogue, *,
                residual: Optional[torch.Tensor] = None,
                operand2: Optional[torch.Tensor] = None,
                norm_scale: Optional[torch.Tensor] = None):
    """``epilogue(a @ b)`` through the K1 kernel.  a [M, K], b [K, N], both
    bf16 and contiguous, K and N multiples of 8.  Returns ``[M, N]`` bf16
    (``ep.out_dtype`` bf16), or ``(value, normed)`` under
    ``norm='rmsnorm'``: one launch where the plan has the row tail, else
    the GEMM and the row-norm kernel.  With ``ep.out_dtype`` float32 and no
    other stage it is K1's fp32 store (``k1_matmul_f32``, counted as
    ``matmul:f32``): the accumulator written uncast, in the order
    ``k1_matmul`` sums it (the training path's weight gradients and its
    recomputed gate input)."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"the K1 kernel takes bf16 x bf16, got "
                        f"{a.dtype} x {b.dtype}")
    _cuda.check(a, "matmul A", torch.bfloat16)
    _cuda.check(b, "matmul B", torch.bfloat16)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not chain")
    m, k = a.shape
    n = b.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"the K1 kernel needs K and N divisible by 8, got "
                         f"K={k}, N={n}")
    if ep.bias or ep.quantize or ep.activation not in ("none", "gelu") \
            or ep.gate not in ("none", "silu"):
        raise NotImplementedError(
            f"the K1 kernel implements the cast, activation='gelu', "
            f"gate='silu', residual and rmsnorm stages; {ep} needs a later "
            f"slice")
    if ep.out_dtype == torch.float32:
        if not ep.is_identity:
            raise NotImplementedError(
                f"K1's fp32 store takes no epilogue stage, got {ep}")
        return _matmul_f32(a, b)
    if ep.out_dtype != torch.bfloat16:
        raise TypeError(f"the K1 kernel stores bf16 or fp32, got out_dtype "
                        f"{ep.out_dtype}")
    flags = _epilogue_operands(ep, m, n, residual, operand2, norm_scale)
    norm = ep.norm == "rmsnorm"
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    normed = None
    if m and n:
        plan = _device_plan(m, n, k, a.device.index)
        tail = norm and plan.row_tail
        normed = torch.empty_like(out) if tail else None
        ws = counters = None
        if plan.splits > 1 or tail:
            ws, counters = (t.data_ptr() for t in split_scratch(
                a.device, plan.splits * m * n,
                plan.arrival_counters(m, n, False)))
        _cuda.count("matmul", gelu=bool(flags & EPI_GELU), norm=tail)
        _cuda.launch("matmul", "k1_matmul", a.data_ptr(), b.data_ptr(),
                     out.data_ptr(), _ptr(residual if ep.residual else None),
                     _ptr(operand2 if flags & EPI_SILU else None), ws,
                     counters, _ptr(norm_scale if tail else None),
                     _ptr(normed), m, n, k, plan.splits, plan.cols, flags,
                     float(ep.norm_eps))
    if norm:
        if normed is None:
            normed = rmsnorm_cuda(out, norm_scale, ep.norm_eps)
        return out, normed
    return out


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1's fp32 store of ``a @ b`` (checked by ``matmul_cuda``): the plan,
    split and workspace of the bf16 store, no epilogue."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m and n:
        plan = _device_plan(m, n, k, a.device.index)
        ws = counters = None
        if plan.splits > 1:
            ws, counters = (t.data_ptr() for t in split_scratch(
                a.device, plan.splits * m * n,
                plan.arrival_counters(m, n, False)))
        _cuda.count("matmul", f32=True)
        _cuda.launch("matmul", "k1_matmul_f32", a.data_ptr(), b.data_ptr(),
                     out.data_ptr(), ws, counters, m, n, k, plan.splits,
                     plan.cols)
    return out


def int8_matmul_cuda(qa: torch.Tensor, sa: torch.Tensor, qb: torch.Tensor,
                     sb: torch.Tensor, ep: Epilogue, *,
                     residual: Optional[torch.Tensor] = None,
                     operand2: Optional[torch.Tensor] = None,
                     norm_scale: Optional[torch.Tensor] = None):
    """``epilogue(sa * sb * (qa @ qb))`` through the K2 kernel.  qa [M, K]
    int8 contiguous; qb [K, N] int8, the transposed view of a contiguous
    [N, K] weight (``QuantizedWeight``'s storage: the s8 wgmma reads both
    operands K-major); K and N multiples of 16; sa [M, 1] and sb [1, N]
    f32.  Returns ``[M, N]`` in ``ep.out_dtype`` (bf16 or fp32, default
    fp32), ``(q, scale)`` under ``quantize`` or ``(value, normed)`` under
    ``norm='rmsnorm'``; the row pass runs in the store phase where the
    plan has the row tail, else in K3's or the row-norm kernel."""
    if qa.dim() != 2 or qb.dim() != 2 or qa.shape[1] != qb.shape[0]:
        raise ValueError(f"int8 matmul shapes {tuple(qa.shape)} x "
                         f"{tuple(qb.shape)} do not chain")
    m, k = qa.shape
    n = qb.shape[1]
    _cuda.check(qa, "int8 matmul A", torch.int8)
    _cuda.check(qb.t(), "int8 matmul B's [N, K] storage (qb.t())",
                torch.int8)
    _cuda.check(sa, "a_scale", torch.float32, (m, 1))
    _cuda.check(sb, "b_scale", torch.float32, (1, n))
    if k % 16 or n % 16:
        raise ValueError(f"the K2 kernel needs K and N divisible by 16, got "
                         f"K={k}, N={n}")
    if ep.bias or ep.activation not in ("none", "gelu") \
            or ep.gate not in ("none", "silu") \
            or (ep.quantize and ep.quantize_axis != "row"):
        raise NotImplementedError(
            f"the K2 kernel implements the scales, activation='gelu', "
            f"gate='silu', the residual, the row quantize and the rmsnorm; "
            f"{ep} needs a later slice")
    out_dtype = torch.float32 if ep.quantize \
        else (ep.out_dtype or torch.float32)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the K2 kernel stores bf16 or fp32, got {out_dtype}")
    norm = ep.norm == "rmsnorm"
    if norm and out_dtype != torch.bfloat16:
        raise TypeError("the K2 rmsnorm output is bf16")
    flags = _epilogue_operands(ep, m, n, residual, operand2, norm_scale)
    out = torch.empty((m, n), dtype=out_dtype, device=qa.device)
    f32 = out_dtype == torch.float32
    q = q_scale = normed = None     # the fused row pass's outputs
    if m and n:
        plan = _device_k2_plan(m, n, k, qa.device.index)
        if plan.row_tail and ep.quantize:
            q = torch.empty((m, n), dtype=torch.int8, device=qa.device)
            q_scale = torch.empty((m, 1), dtype=torch.float32,
                                  device=qa.device)
        elif plan.row_tail and norm:
            normed = torch.empty_like(out)
        ws = counters = None
        if plan.splits > 1 or q is not None or normed is not None:
            # int32 partials in the fp32 workspace's storage
            ws, counters = (t.data_ptr() for t in split_scratch(
                qa.device, plan.splits * m * n,
                plan.arrival_counters(m, n, ep.quantize)))
        _cuda.count("int8_matmul", gelu=bool(flags & EPI_GELU),
                    norm=normed is not None, quantize=q is not None)
        _cuda.launch("matmul", "k2_int8_matmul", qa.data_ptr(), qb.data_ptr(),
                     sa.data_ptr(), sb.data_ptr(),
                     out.data_ptr() if f32 else None,
                     None if f32 else out.data_ptr(),
                     _ptr(residual if ep.residual else None),
                     _ptr(operand2 if flags & EPI_SILU else None), ws,
                     counters,
                     _ptr(norm_scale if normed is not None else None),
                     _ptr(normed), _ptr(q), _ptr(q_scale),
                     m, n, k, plan.splits, plan.cols, flags,
                     float(ep.norm_eps))
    if ep.quantize:
        if q is None:
            return quantize_rowwise_cuda(out, count="int8_quantize")
        return q, q_scale
    if norm:
        if normed is None:
            normed = rmsnorm_cuda(out, norm_scale, ep.norm_eps)
        return out, normed
    return out
