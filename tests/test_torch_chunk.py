"""K6's two bodies, on the CPU: which one a call takes, the chunk body's
q tiles and what its launcher is handed.

A decode call (S == 1) keeps the split-K decode body, which carries the
paged == dense bitwise contract; a prefill chunk (S > 1) takes the
flash-prefill body (``k6_paged_chunk`` in ``csrc/flash_attention.cu``),
chosen by the shape alone.  The body itself runs only on the card
(``chip_smoke.py`` holds it against ``paged_flash_decode_tiled``); here
the launch is intercepted at ``kernels._cuda.launch`` to check its
arguments and counts, and the plain version of a chunk is held against
the JAX reference's tiled mirror at the chunk body's shapes (G = 16, a
padded tail), each bf16 row within one bf16 ulp of its scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa

from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as tfa

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

BF16_EPS = float(torch.finfo(torch.bfloat16).eps)


def _case(s_q, g=2, ps=16, kv=2, hd=16, n_lanes=3, p_max=8, seed=0):
    """Pools with shuffled pages, lanes whose chunks end at mixed
    positions, the last lane idle, lane 1 with a padded tail."""
    rng = np.random.default_rng(seed)
    n_pages = n_lanes * p_max
    bf = torch.bfloat16
    kp = torch.from_numpy(rng.standard_normal(
        (n_pages + 1, ps, kv, hd)).astype(np.float32)).to(bf)
    vp = torch.from_numpy(rng.standard_normal(
        (n_pages + 1, ps, kv, hd)).astype(np.float32)).to(bf)
    last = np.array([p_max * ps - 1, 40, -1])[:n_lanes]
    table = rng.permutation(n_pages).reshape(n_lanes, p_max).astype(np.int32)
    for lane, p in enumerate(last):
        table[lane, max(p, 0) // ps + 1:] = -1
    pos = last[:, None] - (s_q - 1) + np.arange(s_q)[None]
    pos = np.where((last[:, None] >= 0) & (pos >= 0), pos, -1)
    pos[1, -min(3, s_q - 1):] = -1
    q = torch.from_numpy(rng.standard_normal(
        (n_lanes, s_q, kv, g, hd)).astype(np.float32)).to(bf)
    return (q, kp, vp, torch.from_numpy(table),
            torch.from_numpy(pos.astype(np.int32)))


# ---------------------------------------------------------------------------
# the choice of body and the chunk body's tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s_q", [1, 2, 5, 32, 64, 512])
def test_body_is_chosen_by_the_shape_alone(s_q):
    assert tfa.paged_body(s_q) == ("k6_paged_decode" if s_q == 1
                                   else "k6_paged_chunk")


@pytest.mark.parametrize("s_q,g,want", [
    (64, 4, (32, 2)),     # granite-3-8b: 2 q tiles of 32 positions x 4
    (64, 2, (64, 1)),     # gemma2-27b: 1 q tile of 64 positions x 2
    (64, 16, (8, 8)),     # recurrentgemma-9b's grouping: 8 q tiles
    (32, 2, (32, 1)),     # the smoke configs' 32-token chunk
    (5, 128, (1, 5)),
    (7, 3, (7, 1)),
])
def test_chunk_tiles_hold_whole_positions(s_q, g, want):
    per, n_qt = tfa.chunk_tiles(s_q, g)
    assert (per, n_qt) == want
    assert per * g <= tfa.CHUNK_ROWS and per <= s_q
    assert (n_qt - 1) * per < s_q <= n_qt * per


@pytest.mark.parametrize("g", [0, 129])
def test_chunk_tiles_refuse_groups_they_cannot_hold(g):
    with pytest.raises(ValueError, match="query heads"):
        tfa.chunk_tiles(64, g)


@pytest.mark.parametrize("ps", [2, 12, 256])
def test_chunk_body_refuses_page_sizes_it_cannot_tile(ps):
    q, kp, vp, table, pos = _case(4, ps=ps, p_max=2)
    with pytest.raises(ValueError, match="page sizes"):
        tfa.paged_decode_launch(q, kp, vp, table, pos)


# ---------------------------------------------------------------------------
# what the launcher is handed
# ---------------------------------------------------------------------------

@pytest.fixture
def intercepted(monkeypatch):
    """Run ``paged_decode_launch`` on CPU tensors up to the launch: the
    device checks pass, the launch is recorded, the card has 132 SMs."""
    calls = []
    monkeypatch.setattr(_cuda, "check", lambda *a, **kw: None)
    monkeypatch.setattr(_cuda, "launch",
                        lambda lib, fn, *args: calls.append((lib, fn, args)))
    monkeypatch.setattr(tfa, "sm_count", lambda index: 132)
    _cuda.reset_launches()
    for key in [k for k in _cuda.LAUNCHES if ":" in k]:
        del _cuda.LAUNCHES[key]
    yield calls
    _cuda.reset_launches()


@pytest.mark.parametrize("var,key", [
    (dict(), "paged_decode:chunk"),
    (dict(kind="local", window=16, softcap=50.0),
     "paged_decode:local+softcap+chunk"),
])
def test_a_chunk_launches_the_chunk_body(intercepted, var, key):
    q, kp, vp, table, pos = _case(5, g=4, ps=8)
    out, ws = tfa.paged_decode_launch(q, kp, vp, table, pos, **var)
    assert ws is None and out.shape == q.shape
    ((lib, fn, args),) = intercepted
    assert (lib, fn) == ("flash_attention", "k6_paged_chunk")
    assert len(args) + 1 == len(_cuda.SIGNATURES[lib][fn])
    n_lanes, s_q, kv, g, hd = q.shape
    assert args[6:14] == (n_lanes, s_q, kv, g, hd, table.shape[1], 3,
                          kp.shape[0])
    assert args[14] == hd ** -0.5
    assert args[15] == tfa.MASK_CODES[var.get("kind", "global")]
    assert args[16] == var.get("window", 0)
    assert args[17] == var.get("softcap", 0.0)
    assert _cuda.LAUNCHES["paged_decode"] == 1 and _cuda.LAUNCHES[key] == 1


def test_a_decode_step_keeps_the_decode_body(intercepted):
    q, kp, vp, table, pos = _case(1, g=4)
    out, ws = tfa.paged_decode_launch(q, kp, vp, table, pos)
    assert isinstance(ws, torch.Tensor) and out.shape == q.shape
    ((lib, fn, args),) = intercepted
    assert (lib, fn) == ("flash_attention", "k6_paged_decode")
    assert len(args) + 1 == len(_cuda.SIGNATURES[lib][fn])
    assert _cuda.LAUNCHES["paged_decode"] == 1
    assert not any(k.endswith("chunk") for k in _cuda.LAUNCHES)


# ---------------------------------------------------------------------------
# the plain version at the chunk body's shapes, against the reference
# ---------------------------------------------------------------------------

def _jx(t: torch.Tensor):
    a = jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16
                    else t.numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


@pytest.mark.parametrize("g,kind,window,softcap", [
    (16, "global", 0, None),
    (2, "local", 16, 50.0),
    (4, "global", 0, 30.0),
])
def test_chunk_plain_matches_reference_mirror(g, kind, window, softcap):
    q, kp, vp, table, pos = _case(12, g=g)
    got = tfa.paged_flash_decode_tiled(q, kp, vp, table, pos, kind=kind,
                                       window=window, softcap=softcap)
    want = jfa.paged_flash_decode_xla(
        _jx(q), _jx(kp), _jx(vp), _jx(table), _jx(pos), kind=kind,
        window=window, softcap=softcap)
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    d = np.abs(got.double().numpy() - w).max(-1)
    scale = np.maximum(np.abs(w).max(-1), 1e-3)
    assert float((d / scale).max()) <= BF16_EPS
    assert bool((got[pos < 0] == 0).all())
