"""K5/K6's split-and-fold schedule, modelled in plain PyTorch on the CPU.

The CUDA kernel (``csrc/flash_attention.cu``, ``decode_kernel``) runs one
block per (row, split).  A row's live tiles are the 32-slot tiles from
slot 0 that hold one of its keys; the splits take contiguous ranges of
them; a tile past the position, wholly before a 'local' window or of an
idle row is neither computed, written nor folded; and the last split of a
row to arrive folds the row's live tiles in ascending order.  The model
below follows that schedule step by step on the plain version's partials
(``paged_tile_partials``; the kernel computes the same partials tile by
tile), with every workspace record a dead tile would own poisoned with
NaN, so a read of one would show.  Its output must be bitwise
``combine_tile_partials`` over all tiles (``torch.equal``), for random
positions, 'local' windows, idle rows, every split count from 1 to
n_tiles and any order of arrival: what makes the card's output the same
for every split count, and a paged lane the same as its dense history.
Against the JAX Pallas decode kernel in interpret mode the model's output
is within two bf16 ulps of the output scale, as the plain K5 is
(``tests/test_torch_kernels.py``).  The split count itself is a function
of the shape and the card's SM count alone.
"""
import inspect
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa

from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as tfa

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

TILE = tfa.DEFAULT_KV_TILE
NEG = tfa._NEG
BF16_EPS = float(torch.finfo(torch.bfloat16).eps)
H100_SMS = 132


def live_tiles(pos: int, window: int, n_tiles: int):
    """The kernel's lo, hi: the row's live tiles (empty when hi < lo)."""
    hi = -1 if pos < 0 else min(pos // TILE, n_tiles - 1)
    lo = max(0, pos - window + 1) // TILE if window > 0 else 0
    return lo, hi


def split_range(lo: int, hi: int, n_splits: int, split: int):
    """[begin, end) of the live tiles that block ``split`` computes."""
    per = -(-(hi - lo + 1) // n_splits)
    begin = lo + split * per
    return begin, max(begin, min(hi + 1, begin + per))


def fold(ws_m, ws_l, ws_acc, lo: int, hi: int):
    """The folding block: the max over the live tiles from NEG, then
    alpha = exp(m_t - m) and an ascending fp32 fold from tile lo."""
    m = torch.maximum(torch.full_like(ws_m[0], NEG),
                      ws_m[lo:hi + 1].amax(dim=0))
    alpha = torch.exp(ws_m[lo] - m)
    l, acc = ws_l[lo] * alpha, ws_acc[lo] * alpha[..., None]
    for t in range(lo + 1, hi + 1):
        alpha = torch.exp(ws_m[t] - m)
        l = l + ws_l[t] * alpha
        acc = acc + ws_acc[t] * alpha[..., None]
    return acc / torch.clamp(l, min=1e-30)[..., None]


def kernel_row(m_t, l_t, acc_t, pos: int, window: int, n_splits: int,
               arrival):
    """One row of the kernel's schedule.  ``m_t``/``l_t`` [T, G] and
    ``acc_t`` [T, G, hd] are the partials of the row's tiles; ``arrival``
    orders the splits.  Returns the row's output [G, hd] at fp32."""
    n_tiles = m_t.shape[0]
    lo, hi = live_tiles(pos, window, n_tiles)
    if hi < lo:                      # no key: exactly 0.0, nothing read
        return torch.zeros_like(acc_t[0])
    ws_m = torch.full_like(m_t, float("nan"))
    ws_l = torch.full_like(l_t, float("nan"))
    ws_acc = torch.full_like(acc_t, float("nan"))
    for arrived, split in enumerate(arrival, 1):
        begin, end = split_range(lo, hi, n_splits, split)
        ws_m[begin:end] = m_t[begin:end]
        ws_l[begin:end] = l_t[begin:end]
        ws_acc[begin:end] = acc_t[begin:end]
        if arrived == n_splits:      # the last to arrive folds the row
            return fold(ws_m, ws_l, ws_acc, lo, hi)
    raise AssertionError("a split never arrived")


def _paged_case(seed: int, kind: str, window: int, s_q: int):
    """A paged batch with an identity page table: 3 lanes of 5 pages of 16
    slots (3 tiles of 32 slots, the last short), positions drawn from the
    seed with idle rows (-1) among them.  Returns the plain partials per
    row (m_t [T, G], l_t, acc_t [T, G, hd]), their positions and the plain
    combine over all tiles [rows, G, hd]."""
    rng = np.random.default_rng(seed)
    n_lanes, kv, g, hd, ps, p_max = 3, 2, 2, 16, 16, 5
    q = torch.from_numpy(rng.standard_normal((n_lanes, s_q, kv, g, hd))
                         .astype(np.float32))
    pools = [torch.from_numpy(rng.standard_normal(
        (n_lanes * p_max + 1, ps, kv, hd)).astype(np.float32))
        for _ in range(2)]
    table = torch.arange(n_lanes * p_max, dtype=torch.int32).reshape(
        n_lanes, p_max)
    positions = torch.from_numpy(
        rng.integers(-1, p_max * ps, (n_lanes, s_q)).astype(np.int32))
    positions[0, 0] = -1
    m_t, l_t, acc_t = tfa.paged_tile_partials(
        q, *pools, table, positions, kind=kind, window=window)
    want = tfa.combine_tile_partials(m_t, l_t, acc_t)   # [L, KV, G, S, hd]
    rows = []
    for lane in range(n_lanes):
        for s in range(s_q):
            for h in range(kv):
                rows.append((m_t[:, lane, h, :, s], l_t[:, lane, h, :, s],
                             acc_t[:, lane, h, :, s],
                             int(positions[lane, s]),
                             want[lane, h, :, s]))
    return rows


CASES = [(seed, kind, window, s_q)
         for seed, (kind, window), s_q in [
             (0, ("global", 0), 1), (1, ("global", 0), 4),
             (2, ("local", 16), 1), (3, ("local", 16), 4),
             (4, ("local", 40), 4), (5, ("local", 33), 1),
             (6, ("local", 1), 4), (7, ("global", 0), 6)]]


@pytest.mark.parametrize("seed,kind,window,s_q", CASES)
def test_split_and_fold_is_bitwise_the_combine(seed, kind, window, s_q):
    perm = np.random.default_rng(seed + 100)
    for m_t, l_t, acc_t, pos, want in _paged_case(seed, kind, window, s_q):
        n_tiles = m_t.shape[0]
        for n_splits in range(1, n_tiles + 1):
            for arrival in (range(n_splits),
                            reversed(range(n_splits)),
                            perm.permutation(n_splits)):
                got = kernel_row(m_t, l_t, acc_t, pos, window, n_splits,
                                 list(arrival))
                assert torch.equal(got, want), (pos, n_splits)


@pytest.mark.parametrize("seed,kind,window,s_q", CASES[:4])
def test_dead_tiles_hold_exact_zero_partials(seed, kind, window, s_q):
    """What the kernel skips is (NEG, 0, 0) in the plain version, which
    folds in as exactly +0.0."""
    for m_t, l_t, acc_t, pos, _ in _paged_case(seed, kind, window, s_q):
        lo, hi = live_tiles(pos, window, m_t.shape[0])
        dead = [t for t in range(m_t.shape[0]) if not lo <= t <= hi]
        assert torch.all(m_t[dead] == NEG) and torch.all(l_t[dead] == 0)
        assert torch.all(acc_t[dead] == 0)


@pytest.mark.parametrize("n_live", [1, 2, 3, 7, 9, 131])
@pytest.mark.parametrize("lo", [0, 5])
def test_splits_take_each_live_tile_once_in_order(n_live, lo):
    hi = lo + n_live - 1
    for n_splits in range(1, n_live + 3):
        tiles = []
        for split in range(n_splits):
            begin, end = split_range(lo, hi, n_splits, split)
            tiles += range(begin, end)
        assert tiles == list(range(lo, hi + 1))


@pytest.mark.parametrize("pos,window,want", [
    (-1, 0, (0, -1)), (0, 0, (0, 0)), (31, 0, (0, 0)), (32, 0, (0, 1)),
    (4175, 0, (0, 130)), (4095, 4096, (0, 127)), (4096, 4096, (0, 128)),
    (4191, 4096, (3, 130)), (40, 16, (0, 1)), (70, 16, (1, 2)),
    (900, 0, (0, 8))])
def test_live_tiles(pos, window, want):
    """The live tiles, the last clamped to the cache's tiles (9 here at
    position 900, as in a 272-slot cache)."""
    n_tiles = 9 if pos == 900 else 131
    assert live_tiles(pos, window, n_tiles) == want


@pytest.mark.parametrize("n_splits", [1, 3])
def test_model_matches_pallas_interpret(n_splits):
    b, kv_len, n_kv, g, hd, pos = 2, 75, 2, 4, 16, 61
    rng = np.random.default_rng(11 + n_splits)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, 1, n_kv, g, hd), (b, kv_len, n_kv, hd),
                      (b, kv_len, n_kv, hd))]
    q, kc, vc = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    want = jfa.flash_decode_pallas(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, kc, vc)), jnp.int32(pos), n_splits=n_splits,
        interpret=True)
    m_t, l_t, acc_t = tfa.decode_tile_partials(q, kc, vc, pos)
    got = torch.stack([
        torch.stack([kernel_row(m_t[:, bi, h, :, 0], l_t[:, bi, h, :, 0],
                                acc_t[:, bi, h, :, 0], pos, 0, n_splits,
                                range(n_splits))
                     for h in range(n_kv)])
        for bi in range(b)])[:, None].to(torch.bfloat16)
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == w.shape
    err = float(np.max(np.abs(got.double().numpy() - w)))
    assert err <= 2 * BF16_EPS * max(1.0, float(np.max(np.abs(w))))


def test_split_count_depends_on_the_shape_alone():
    """``default_splits`` takes the rows, the tiles and the SM count, and
    nothing of the positions or the data."""
    params = list(inspect.signature(tfa.default_splits).parameters)
    assert params == ["rows", "n_tiles", "sms"]


@pytest.mark.parametrize("rows,n_tiles,want", [
    (32, 9, 9),        # granite's fixed loop: B 4 x KV 8, 272 slots
    (32, 131, 17),     # gemma2's fixed loop: B 2 x KV 16, 4176 slots
    (64, 131, 9),      # granite's scheduler decode: 8 lanes x KV 8
    (128, 131, 5),     # gemma2's scheduler decode: 8 lanes x KV 16
    (4096, 131, 1),    # a granite chunk: 8 lanes x 64 rows x KV 8
    (8192, 131, 1),    # a gemma2 chunk
    (1, 1, 1)])
def test_default_splits_fill_one_wave(rows, n_tiles, want):
    got = tfa.default_splits(rows, n_tiles, H100_SMS)
    assert got == want
    assert 1 <= got <= n_tiles
    full = tfa.DECODE_BLOCKS_PER_SM * H100_SMS
    assert rows * got >= full or got == n_tiles or rows >= full
    assert rows * (got - 1) < full


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_workspace_records(g, hd):
    """One record per (row, tile), 16-byte multiples as the kernel copies
    them, with acc, m and l where ``record_floats`` puts them."""
    ws = tfa._workspace(3, 5, g, hd, torch.device("cpu"))
    ws.zero_()
    m_t, l_t, acc_t = tfa.record_views(ws, g, hd)
    rec = ws.shape[-1]
    assert rec % 4 == 0 and rec == -(-g * (hd + 2) // 4) * 4
    assert m_t.shape == l_t.shape == (3, 5, g)
    assert acc_t.shape == (3, 5, g, hd)
    acc_t.fill_(1.0)
    m_t.fill_(2.0)
    l_t.fill_(3.0)
    flat = ws.reshape(-1, rec)
    assert torch.all(flat[:, :g * hd] == 1.0)
    assert torch.all(flat[:, g * hd:g * hd + g] == 2.0)
    assert torch.all(flat[:, g * hd + g:g * hd + 2 * g] == 3.0)
    assert torch.all(flat[:, g * hd + 2 * g:] == 0.0)


def test_the_record_layout_is_the_kernels():
    src = (_cuda.CSRC / "flash_attention.cu").read_text()
    assert re.search(r"return \(G \* \(HD \+ 2\) \+ 3\) / 4 \* 4;", src)
    assert "r[G * HD + g] = mx;" in src and "r[G * HD + G + g] = sum;" in src


@pytest.mark.parametrize("g", [0])
def test_the_kernel_refuses_query_groups_it_cannot_hold(g):
    q = torch.zeros(1, 1, 1, g, 16, dtype=torch.bfloat16)
    kc = torch.zeros(1, 32, 1, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="query heads per kv head"):
        tfa.flash_decode_cuda(q, kc, kc, 0)


@pytest.mark.parametrize("g", list(range(1, 18)) + [24, 32, 64])
def test_head_groups_hold_any_query_group(g):
    """A kv head's G query heads are rep kernel rows of G / rep heads: the
    fewest rows of at most G_MAX heads each, so every G up to G_MAX is one
    row and every larger G (recurrentgemma's 16) is served too."""
    rep, gk = tfa.head_groups(g)
    assert rep * gk == g and 1 <= gk <= tfa._G_MAX
    assert all(g % r or g // r > tfa._G_MAX for r in range(1, rep))
    assert (rep == 1) == (g <= tfa._G_MAX)


def test_the_kernel_holds_g_max_query_heads_a_block():
    src = (_cuda.CSRC / "flash_attention.cu").read_text()
    assert f"constexpr int G_MAX = {tfa._G_MAX};" in src


@pytest.mark.parametrize("g,hd", [(4, 16), (9, 16), (16, 32), (24, 16)])
def test_record_views_map_grouped_rows_to_heads(g, hd):
    """With G > G_MAX the workspace holds rep kernel rows per kv head;
    ``record_views`` gives head r * (G / rep) + j of the kv head the record
    of kernel row r's head j, as the kernel's q and out layouts do."""
    rep, gk = tfa.head_groups(g)
    rows, n_tiles = 3, 4
    ws = tfa._workspace(rows * rep, n_tiles, gk, hd, torch.device("cpu"))
    ws.zero_()
    for kr in range(rows * rep):
        for t in range(n_tiles):
            for j in range(gk):
                head = (kr % rep) * gk + j
                tag = float((kr // rep) * 1000 + t * 100 + head)
                ws[kr, t, gk * hd + j] = tag
                ws[kr, t, gk * hd + gk + j] = -tag
                ws[kr, t, j * hd:(j + 1) * hd] = tag + 0.5
    m_t, l_t, acc_t = tfa.record_views(ws, g, hd)
    want = (torch.arange(rows)[:, None, None] * 1000
            + torch.arange(n_tiles)[None, :, None] * 100
            + torch.arange(g)[None, None, :]).float()
    assert torch.equal(m_t, want) and torch.equal(l_t, -want)
    assert torch.equal(acc_t, (want + 0.5)[..., None].expand(-1, -1, -1, hd))


def test_one_launch_per_decode():
    """K5 and K6's decode body are one launcher each, partials and fold,
    beside K6's prefill-chunk body, and no partials-only or combine
    launcher or count is left."""
    fns = set(_cuda.SIGNATURES["flash_attention"])
    assert fns == {"k4_flash_prefill", "k4_flash_prefill_lse",
                   "k5_flash_decode", "k6_paged_decode", "k6_paged_chunk"}
    assert not {"decode_combine", "decode_partials",
                "paged_partials"} & set(_cuda.LAUNCHES)
    src = (_cuda.CSRC / "flash_attention.cu").read_text()
    assert "combine_kernel" not in src and "FOLD" not in src
    assert math.ceil(4176 / TILE) == 131
