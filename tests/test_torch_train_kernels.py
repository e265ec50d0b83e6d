"""The training path's autograd Functions (``kernels.autograd``) and their
kernels' plain versions against autograd and the reference, on the CPU.

* K1 with each of its epilogues, the row norm and K4 against
  ``torch.autograd`` of the plain forward at f64 (the hand-written
  backwards are exact formulas: within 1e-10 of each gradient's scale),
  and against ``jax.grad`` of the reference's ``ref.matmul_fused_ref``,
  ``layers.rmsnorm`` and ``models/attention.py::flash_attention`` (the
  XLA scan the reference differentiates on this host) at fp32, within
  1e-5 of each gradient's scale (fp32 sums in other orders).
* ``ref.flash_attention_lse_ref`` and ``ref.flash_attention_bwd_ref`` (the
  plain versions of K4's log-sum-exp output and of K4's backward) at every
  kind and with the softcap, and the yardstick at the kernel's own kind
  for G = 1 and 4, head dims 32 and 64 and a ragged S.
* ``ref.flash_attention_bwd_ref`` at head dim 256 against ``jax.grad`` of
  the reference's oracle ``repro.kernels.ref.flash_attention_ref`` for
  'local', 'chunked', 'prefix', 'full' and 'local' with the softcap, at G
  = 1, 2 and 8: fp32, each gradient within 1e-5 of its scale (fp32 sums in
  other orders).
* ``models.loss.vocab_parallel_xent`` against the reference's, with the
  softcap and ignored targets.
* The CUDA wrappers' launch arguments (the launch intercepted): K1's fp32
  store, K4 with its log-sum-exp, K4's backward (its workspace padded to
  ``BWD_ROW_PAD`` rows; each kind's mask code, window and prefix length,
  the softcap, head dim 256, and the variant each launch counts under)
  and its refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.epilogue import Epilogue as JEpilogue
from repro.launch.mesh import make_mesh
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.loss import vocab_parallel_xent as jxent

from repro_torch.kernels import _cuda
from repro_torch.kernels import autograd as ag
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ref
from repro_torch.kernels.epilogue import Epilogue, rms_normalize
from repro_torch.models.loss import vocab_parallel_xent

torch.set_num_threads(1)

F64 = torch.float64
EPILOGUES = {
    "plain": dict(),
    "gate": dict(gate="silu"),
    "residual_norm": dict(residual=True, norm="rmsnorm"),
    "gelu": dict(activation="gelu"),
}


@pytest.fixture(autouse=True)
def _xla_mode():
    assert jops.kernel_mode() == "xla", "the reference must run its CPU path"


def _rel(got, want) -> float:
    g = np.asarray(got.detach().double() if torch.is_tensor(got) else got,
                   np.float64)
    w = np.asarray(want.detach().double() if torch.is_tensor(want) else want,
                   np.float64)
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))


def _inputs(m, k, n, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(dtype)
    return dict(a=t(m, k), w=t(k, n, scale=k ** -0.5), residual=t(m, n),
                operand2=t(m, n), norm_scale=t(n, scale=0.5),
                c1=t(m, n), c2=t(m, n))


def _plain_forward(a, w, spec, residual, operand2, norm_scale):
    """The epilogue written out in plain torch (autograd's reference)."""
    x = a @ w
    if spec.get("activation") == "gelu":
        x = torch.nn.functional.gelu(x, approximate="tanh")
    if spec.get("gate"):
        x = torch.nn.functional.silu(operand2) * x
    if spec.get("residual"):
        x = x + residual
    if spec.get("norm"):
        return x, rms_normalize(x, norm_scale.reshape(1, -1), 1e-6, F64)
    return x


def _objective(out, c1, c2):
    if isinstance(out, tuple):
        return (out[0] * c1).sum() + (out[1] * c2).sum()
    return (out * c1).sum()


@pytest.mark.parametrize("name", list(EPILOGUES))
def test_k1_function_is_autograd_at_f64(name):
    spec = EPILOGUES[name]
    x = _inputs(24, 32, 40, F64)
    leaves = {k: x[k].clone().requires_grad_() for k in
              ("a", "w", "residual", "operand2", "norm_scale")}
    got_out = ag.matmul(leaves["a"], leaves["w"], out_dtype=F64,
                        epilogue=Epilogue(**spec), **{
                            k: leaves[k] for k in ("residual", "operand2",
                                                   "norm_scale")})
    _objective(got_out, x["c1"], x["c2"]).backward()
    want_leaves = {k: x[k].clone().requires_grad_() for k in leaves}
    want_out = _plain_forward(**{k: want_leaves[k] for k in
                                 ("a", "w", "residual", "operand2",
                                  "norm_scale")}, spec=spec)
    _objective(want_out, x["c1"], x["c2"]).backward()
    for k in leaves:
        if want_leaves[k].grad is None:
            assert leaves[k].grad is None, k
            continue
        assert _rel(leaves[k].grad, want_leaves[k].grad) < 1e-10, k


@pytest.mark.parametrize("name", ["plain", "gate", "residual_norm"])
def test_k1_function_matches_jax_grad_of_the_reference(name):
    """fp32 gradients against ``jax.grad`` of ``ref.matmul_fused_ref``."""
    spec = EPILOGUES[name]
    x = _inputs(24, 32, 40, torch.float32, seed=1)
    names = ("a", "w", "residual", "operand2", "norm_scale")
    leaves = {k: x[k].clone().requires_grad_() for k in names}
    out = ag.matmul(leaves["a"], leaves["w"], out_dtype=torch.float32,
                    epilogue=Epilogue(**spec),
                    **{k: leaves[k] for k in names[2:]})
    _objective(out, x["c1"], x["c2"]).backward()

    jep = JEpilogue(out_dtype=jnp.float32, **spec)

    def f(a, w, residual, operand2, norm_scale):
        kw = {}
        if spec.get("residual"):
            kw["residual"] = residual
        if spec.get("gate"):
            kw["operand2"] = operand2
        if spec.get("norm"):
            kw["norm_scale"] = norm_scale
        y = jref.matmul_fused_ref(a, w, jep, **kw)
        c1, c2 = (jnp.asarray(x[c].numpy()) for c in ("c1", "c2"))
        if isinstance(y, tuple):
            return jnp.sum(y[0] * c1) + jnp.sum(y[1] * c2)
        return jnp.sum(y * c1)
    grads = jax.grad(f, argnums=tuple(range(5)))(
        *(jnp.asarray(x[k].numpy()) for k in names))
    for k, g in zip(names, grads):
        if not np.any(np.asarray(g)):
            continue    # a stage this epilogue does not take
        assert _rel(leaves[k].grad, np.asarray(g)) < 1e-5, k


def test_k1_function_bf16_weight_gradient_is_fp32():
    """The master weight's gradient comes back at its own dtype and
    width: an fp32 weight fed to a bf16 product gets an fp32 gradient (the
    fp32 store of A^T dC), not one rounded to bf16."""
    x = _inputs(16, 32, 24, torch.float32, seed=2)
    a = x["a"].to(torch.bfloat16).requires_grad_()
    w = x["w"].clone().requires_grad_()
    out = ag.matmul(a, w, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    (out.float() * x["c1"]).sum().backward()
    assert w.grad.dtype == torch.float32 and a.grad.dtype == torch.bfloat16
    dc = x["c1"].to(torch.bfloat16).float()
    want = a.detach().float().t() @ dc
    assert torch.allclose(w.grad, want, rtol=1e-6, atol=1e-6)


def test_rmsnorm_function_is_autograd_and_the_reference():
    rng = np.random.default_rng(3)
    x64 = torch.from_numpy(rng.standard_normal((2, 5, 48)))
    s64 = torch.from_numpy(rng.standard_normal(48) * 0.5)
    c = torch.from_numpy(rng.standard_normal((2, 5, 48)))
    xa, sa = x64.clone().requires_grad_(), s64.clone().requires_grad_()
    (ag.rmsnorm(xa, sa) * c).sum().backward()
    xb, sb = x64.clone().requires_grad_(), s64.clone().requires_grad_()
    (rms_normalize(xb, sb, 1e-6, F64) * c).sum().backward()
    assert _rel(xa.grad, xb.grad) < 1e-10 and _rel(sa.grad, sb.grad) < 1e-10
    xf, sf = (t.float().clone().requires_grad_() for t in (x64, s64))
    (ag.rmsnorm(xf, sf) * c.float()).sum().backward()
    gx, gs = jax.grad(lambda x, s: jnp.sum(
        jlayers.rmsnorm(x, s) * jnp.asarray(c.float().numpy())),
        argnums=(0, 1))(jnp.asarray(x64.float().numpy()),
                        jnp.asarray(s64.float().numpy()))
    assert _rel(xf.grad, np.asarray(gx)) < 1e-5
    assert _rel(sf.grad, np.asarray(gs)) < 1e-5


ATTN_CASES = [
    dict(kind="global"),
    dict(kind="local", window=5),
    dict(kind="chunked", window=8),
    dict(kind="prefix", prefix_len=6),
    dict(kind="global", softcap=2.0),
    dict(kind="local", window=7, softcap=3.0),
]


def _qkv(b, s, h, kv, hd, dtype, seed=0, skv=None):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    skv = skv or s
    return t(b, s, h, hd), t(b, skv, kv, hd), t(b, skv, kv, hd), \
        t(b, s, h, hd)


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in
                                                c.items()))
def test_flash_function_is_autograd_at_f64(case):
    """K4's Function (the plain LSE forward and the plain recomputing
    backward on the CPU) against autograd of ``ref.flash_attention_ref``
    at f64, GQA at G = 2."""
    q, k, v, c = _qkv(2, 19, 4, 2, 8, F64, seed=4)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    (ag.flash_attention(qa, ka, va, **case) * c).sum().backward()
    qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
    (ref.flash_attention_ref(qb, kb, vb, **case) * c).sum().backward()
    for got, want in ((qa, qb), (ka, kb), (va, vb)):
        assert _rel(got.grad, want.grad) < 1e-10


def test_flash_full_kind_backward_with_ragged_keys():
    """'full' (whisper's cross-attention shape: Skv != Sq) in the plain
    backward, against autograd at f64."""
    q, k, v, c = _qkv(1, 6, 2, 1, 8, F64, seed=5, skv=11)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = ref.flash_attention_lse_ref(qa, ka, va, kind="full")
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out.detach(),
                                             lse.detach(), c, kind="full")
    (ref.flash_attention_ref(qa, ka, va, kind="full") * c).sum().backward()
    for got, want in ((dq, qa), (dk, ka), (dv, va)):
        assert _rel(got, want.grad) < 1e-10


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("hd", [32, 64])
def test_flash_backward_ref_at_the_kernel_rows(hd, g):
    """The yardstick of K4's backward kernel at the kinds of shapes
    ``chip_smoke.py`` holds the kernel to beside internlm2's: 'global', G =
    1 (4 q heads over 4) and G = 4 (4 over 1), head dims 32 and 64, and S =
    72, a multiple of no kernel tile.  ``ref.flash_attention_bwd_ref``
    against autograd of ``ref.flash_attention_ref`` at f64."""
    q, k, v, c = _qkv(2, 72, 4, 4 // g, hd, F64, seed=7)
    out, lse = ref.flash_attention_lse_ref(q, k, v)
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, lse, c)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    (ref.flash_attention_ref(qa, ka, va) * c).sum().backward()
    for got, want in ((dq, qa), (dk, ka), (dv, va)):
        assert _rel(got, want.grad) < 1e-10


@pytest.mark.parametrize("case", [dict(kind="global"),
                                  dict(kind="local", window=6),
                                  dict(kind="global", softcap=5.0)],
                         ids=["global", "local", "softcap"])
def test_flash_function_matches_jax_grad_of_the_reference_scan(case):
    """fp32 gradients against ``jax.grad`` of the reference's XLA scan
    (``models/attention.py::flash_attention``, heads expanded: its kv
    heads repeated, whose gradients jax sums back)."""
    q, k, v, c = _qkv(2, 24, 4, 2, 16, torch.float32, seed=6)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (ag.flash_attention(*leaves, **case) * c).sum().backward()

    def f(q, k, v):
        kr, vr = (jnp.repeat(x, 2, axis=2) for x in (k, v))
        out = jattn.flash_attention(q, kr, vr, q_chunk=8, kv_chunk=8, **case)
        return jnp.sum(out * jnp.asarray(c.numpy()))
    grads = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for got, want in zip(leaves, grads):
        assert _rel(got.grad, np.asarray(want)) < 1e-5


HD256_CASES = [
    dict(kind="local", window=5),
    dict(kind="chunked", window=8),
    dict(kind="prefix", prefix_len=7),
    dict(kind="full"),
    dict(kind="local", window=6, softcap=2.5),
]


@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("case", HD256_CASES,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in
                                                c.items()))
def test_flash_backward_ref_at_hd256_matches_jax_grad(case, g):
    """The plain backward (K4's backward's yardstick on the card) at head
    dim 256, 20 positions, 8 q heads over 8 // G, from its own log-sum-exp
    forward, against ``jax.grad`` of the reference's attention oracle at
    fp32: each gradient within 1e-5 of its scale (fp32 sums in other
    orders)."""
    q, k, v, c = _qkv(1, 20, 8, 8 // g, 256, torch.float32, seed=8 + g)
    out, lse = ref.flash_attention_lse_ref(q, k, v, **case)
    got = ref.flash_attention_bwd_ref(q, k, v, out, lse, c, **case)

    def f(q, k, v):
        o = jref.flash_attention_ref(q, k, v, **case)
        return jnp.sum(o * jnp.asarray(c.numpy()))
    want = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for name, a, w in zip("qkv", got, want):
        assert _rel(a, np.asarray(w)) < 1e-5, name


@pytest.mark.parametrize("kind,window,prefix_len", [
    ("global", 0, 0), ("full", 0, 0), ("local", 7, 0), ("local", 40, 0),
    ("chunked", 7, 0), ("chunked", 30, 0), ("prefix", 0, 9),
    ("prefix", 0, 40)])
def test_live_keys_counts_the_masks_keys(kind, window, prefix_len):
    """``ref.live_keys`` (the operations bound's and the model-FLOP
    count's keys a query) is the mean over 30 queries of the keys
    ``ref.attention_mask`` keeps, a window or prefix longer than S
    included."""
    pos = torch.arange(30)
    mask = ref.attention_mask(pos, pos, kind, window, prefix_len)
    want = float(mask.sum()) / 30
    assert ref.live_keys(kind, 30, window, prefix_len) == pytest.approx(
        want, rel=1e-12)


@pytest.mark.parametrize("case", [dict(kind="global"),
                                  dict(kind="local", window=5, softcap=3.0)],
                         ids=["global", "local-softcap"])
def test_flash_backward_ref_by_kv_head_is_the_plain_backward(case):
    """The plain backward one kv head at a time (``chip_smoke.py``'s and
    ``launch/bwd_ab.py``'s yardstick of K4's backward) from bf16 values
    is the whole plain backward at fp32, and fp32 itself: 8 q heads over
    2, 24 positions."""
    q, k, v, c = _qkv(2, 24, 8, 2, 32, torch.float32, seed=9)
    q, k, v, c = (t.to(torch.bfloat16) for t in (q, k, v, c))
    out, lse = ref.flash_attention_lse_ref(q, k, v, **case)
    got = ref.flash_attention_bwd_ref_by_kv_head(q, k, v, out, lse, c,
                                                 **case)
    want = ref.flash_attention_bwd_ref(
        *(t.float() for t in (q, k, v, out)), lse, c.float(), **case)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)


def _causal_capped_bwd(q, k, v, out, lse, dout, softcap, fault):
    """The plain causal backward under a softcap at fp32, one kv head,
    with one of the faults ``launch/bwd_ab.py --plant`` plants into the
    kernel: dS without the cap's derivative, or P from the uncapped
    score against the capped lse."""
    hd, s = q.shape[-1], q.shape[1]
    raw = torch.einsum("bqhd,bkd->bhqk", q, k[:, :, 0]) * hd ** -0.5
    t = torch.tanh(raw / softcap)
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    score = raw if fault == "uncapped_p" else softcap * t
    p = torch.exp(score - lse[..., None]).masked_fill(~mask, 0.0)
    dv = torch.einsum("bhqk,bqhd->bkd", p, dout)[:, :, None]
    dp = torch.einsum("bqhd,bkd->bhqk", dout, v[:, :, 0])
    ds = p * (dp - (dout * out).sum(-1).transpose(1, 2)[..., None])
    if fault != "no_cap_derivative":
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhqk,bkd->bqhd", ds, k[:, :, 0]) * hd ** -0.5
    dk = torch.einsum("bhqk,bqhd->bkd", ds, q)[:, :, None] * hd ** -0.5
    return dq, dk, dv


def _worst_row_err(got, want):
    return max(float(((g - w).abs().amax(-1)
                      / w.abs().amax(-1).clamp(min=1e-3)).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("fault", [None, "no_cap_derivative", "uncapped_p"])
def test_softcap_faults_show_only_with_scores_at_the_cap(fault):
    """Why ``chip_smoke.py``'s capped row scales q by 10: at gemma2's
    softcap of 50 and head dim 128 (256 positions, 4 q heads over 1),
    standard normal q and k give scores of about N(0, 1), where a
    backward without the cap's derivative stays within K4_BWD_TOL (2e-2)
    of each row's scale of the plain one; with q times 10 the scores
    reach the cap and either fault is off by more than 0.5.  Without a
    fault this backward is ``ref.flash_attention_bwd_ref``."""
    for qscale in (1.0, 10.0):
        q, k, v, c = _qkv(1, 256, 4, 1, 128, torch.float32, seed=10)
        q = q * qscale
        out, lse = ref.flash_attention_lse_ref(q, k, v, softcap=50.0)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, c,
                                           softcap=50.0)
        err = _worst_row_err(
            _causal_capped_bwd(q, k, v, out, lse, c, 50.0, fault), want)
        if fault is None:
            assert err < 1e-5
        elif qscale == 10.0:
            assert err > 0.5
        elif fault == "no_cap_derivative":
            assert err < 2e-2


def test_variant_keys_are_what_the_wrappers_count(intercepted):
    """``_cuda.variant_key`` of ``k4_variants`` names the key the
    backward's launch adds one to (``chip_smoke.py`` reads each kernels
    row's launches under it), and the bare name where no variant is on."""
    q, k = _bf(1, 64, 2, 256), _bf(1, 64, 1, 256)
    tfa.flash_attention_bwd_cuda(q, k, k, q, torch.zeros(1, 2, 64), q,
                                 kind="local", window=16, softcap=50.0)
    key = _cuda.variant_key("flash_attention_bwd",
                            **tfa.k4_variants("local", 50.0, 256))
    assert key == "flash_attention_bwd:local+softcap+hd256"
    assert _cuda.LAUNCHES[key] == 1
    assert _cuda.variant_key("flash_attention_bwd", **tfa.k4_variants(
        "global", None, 128)) == "flash_attention_bwd"


def test_lse_is_the_log_sum_exp_of_the_attended_scores():
    q, k, v, _ = _qkv(1, 9, 2, 1, 8, F64, seed=7)
    out, lse = ref.flash_attention_lse_ref(q, k, v, kind="local", window=3,
                                           softcap=2.0)
    assert torch.equal(out, ref.flash_attention_ref(q, k, v, kind="local",
                                                    window=3, softcap=2.0))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.expand(-1, -1, 2, -1)) * 8 ** -0.5
    s = 2.0 * torch.tanh(s / 2.0)
    i = torch.arange(9)
    live = (i[None] <= i[:, None]) & (i[:, None] - i[None] < 3)
    want = torch.logsumexp(s.masked_fill(~live, -torch.inf), dim=-1)
    assert _rel(lse, want) < 1e-12


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_vocab_parallel_xent_matches_the_reference(softcap):
    """The chunked fp32 cross-entropy (chunks of 8 over 24 positions,
    targets < 0 ignored, the final softcap) and its gradients with respect
    to the stream and the head, against the reference's at fp32."""
    rng = np.random.default_rng(8)
    h = rng.standard_normal((2, 24, 16)).astype(np.float32)
    head = (rng.standard_normal((40, 16)) * 0.5).astype(np.float32)
    tgt = rng.integers(0, 40, (2, 24)).astype(np.int32)
    tgt[0, :5] = -1
    tgt[1, 20:] = -1
    ht, headt = (torch.from_numpy(x).requires_grad_() for x in (h, head))
    loss = vocab_parallel_xent(ht, headt, torch.from_numpy(tgt), chunk=8,
                               final_softcap=softcap)
    loss.backward()
    ctx = jlayers.TPCtx(mesh=make_mesh(1, 1), sp=False,
                        compute_dtype=jnp.float32)
    jl, (gh, ghead) = jax.value_and_grad(
        lambda a, b: jxent(a, b, jnp.asarray(tgt), ctx, chunk=8,
                           final_softcap=softcap), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(head))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    assert _rel(ht.grad, np.asarray(gh)) < 1e-5
    assert _rel(headt.grad, np.asarray(ghead)) < 1e-5


def test_vocab_parallel_xent_refuses_ragged_chunks():
    with pytest.raises(AssertionError):
        vocab_parallel_xent(torch.zeros(1, 12, 4), torch.zeros(8, 4),
                            torch.zeros(1, 12, dtype=torch.int32), chunk=8)


def test_embed_gradient_sums_repeated_rows():
    table = torch.randn(6, 4, dtype=F64, requires_grad=True)
    ids = torch.tensor([[1, 3, 1], [5, 1, 0]], dtype=torch.int32)
    c = torch.randn(2, 3, 4, dtype=F64)
    (ag.embed(table, ids, F64) * c).sum().backward()
    want = torch.zeros(6, 4, dtype=F64).index_add_(0, ids.reshape(-1).long(),
                                                    c.reshape(-1, 4))
    assert _rel(table.grad, want) < 1e-15


# ---------------------------------------------------------------------------
# the CUDA wrappers, the launch intercepted
# ---------------------------------------------------------------------------

@pytest.fixture
def intercepted(monkeypatch):
    calls = []
    monkeypatch.setattr(_cuda, "check", lambda *a, **kw: None)
    monkeypatch.setattr(_cuda, "launch",
                        lambda lib, fn, *args: calls.append((lib, fn, args)))
    monkeypatch.setattr(tmm, "sm_count", lambda index: 132)
    tmm._device_plan.cache_clear()
    before = dict(_cuda.LAUNCHES)
    _cuda.reset_launches()
    for key in [k for k in _cuda.LAUNCHES if ":" in k]:
        del _cuda.LAUNCHES[key]
    yield calls
    tmm._device_plan.cache_clear()
    _cuda.LAUNCHES.clear()
    _cuda.LAUNCHES.update(before)


def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("m,k,n", [(2048, 16384, 8192), (8, 4096, 6144)])
def test_k1_fp32_store_launch(intercepted, m, k, n):
    """K1's fp32 store: ``k1_matmul_f32`` with k1_plan's regime, split and
    width, counted as ``matmul:f32``; the bytes regime (M < 64) gets the
    split workspace.  Any other stage with an fp32 store is refused."""
    out = tmm.matmul_cuda(_bf(m, k), _bf(k, n),
                          Epilogue(out_dtype=torch.float32))
    assert out.dtype == torch.float32 and out.shape == (m, n)
    ((lib, fn, args),) = intercepted
    assert (lib, fn) == ("matmul", "k1_matmul_f32")
    assert len(args) + 1 == len(_cuda.SIGNATURES[lib][fn])
    plan = tmm.k1_plan(m, n, k, 132)
    assert args[5:] == (m, n, k, plan.splits, plan.cols)
    assert (args[3] is None) == (plan.splits == 1)
    assert _cuda.LAUNCHES["matmul"] == 1 == _cuda.LAUNCHES["matmul:f32"]
    with pytest.raises(NotImplementedError):
        tmm.matmul_cuda(_bf(m, k), _bf(k, n),
                        Epilogue(residual=True, out_dtype=torch.float32),
                        residual=_bf(m, n))


def test_k4_lse_launch(intercepted):
    """internlm2's training microbatch (4 x 4096, 16 q heads over 8, hd
    128): ``k4_flash_prefill_lse`` takes k4_flash_prefill's arguments with
    the lse buffer [B, H, S] fp32 after the output, counted under the
    ``lse`` variant."""
    q, k = _bf(4, 4096, 16, 128), _bf(4, 4096, 8, 128)
    out, lse = tfa.flash_attention_lse_cuda(q, k, k)
    assert lse.shape == (4, 16, 4096) and lse.dtype == torch.float32
    ((lib, fn, args),) = intercepted
    assert (lib, fn) == ("flash_attention", "k4_flash_prefill_lse")
    assert len(args) + 1 == len(_cuda.SIGNATURES[lib][fn])
    assert args[4] == lse.data_ptr()
    assert args[5:] == (4, 4096, 4096, 16, 8, 128, 128 ** -0.5, 0, 0, 0, 0.0)
    assert _cuda.LAUNCHES["flash_attention:lse"] == 1


@pytest.mark.parametrize("hd", [16, 128])
def test_k4_backward_launch(intercepted, hd):
    q, k = _bf(4, 4096, 16, hd), _bf(4, 4096, 8, hd)
    lse = torch.zeros(4, 16, 4096)
    dq, dk, dv = tfa.flash_attention_bwd_cuda(q, k, k, q, lse, q)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    ((lib, fn, args),) = intercepted
    assert (lib, fn) == ("flash_backward", "k4_flash_backward")
    assert len(args) + 1 == len(_cuda.SIGNATURES[lib][fn])
    assert args[10:] == (4, 4096, 16, 8, hd, hd ** -0.5, 0, 0, 0, 0.0)
    assert _cuda.LAUNCHES["flash_attention_bwd"] == 1
    assert not [key for key in _cuda.LAUNCHES
                if key.startswith("flash_attention_bwd:")]


@pytest.mark.parametrize("kw,args,variant", [
    (dict(kind="local", window=16), (1, 16, 0, 0.0), "local"),
    (dict(kind="full"), (2, 0, 0, 0.0), "full"),
    (dict(softcap=50.0), (0, 0, 0, 50.0), "softcap"),
    (dict(hd=256), (0, 0, 0, 0.0), "hd256"),
    (dict(kind="chunked", window=24), (3, 24, 0, 0.0), "chunked"),
    (dict(kind="prefix", prefix_len=40), (4, 0, 40, 0.0), "prefix"),
    (dict(kind="local", window=4096, softcap=50.0), (1, 4096, 0, 50.0),
     "local+softcap"),
    (dict(kind="local", window=1024, hd=256), (1, 1024, 0, 0.0),
     "local+hd256"),
], ids=["local", "full", "softcap", "hd256", "chunked", "prefix",
        "local-softcap", "local-hd256"])
def test_k4_backward_launches_each_kind(intercepted, kw, args, variant):
    """Each kind, the softcap and head dim 256 launch the kernel with the
    kind's mask code, its window and prefix length (``mask_args``: 0 where
    the kind has none) and the softcap, each counted under its variant as
    the forward counts its own ('global' with a window passes window 0:
    the model hands every layer its config's window)."""
    hd = kw.pop("hd", 128)
    q, k = _bf(1, 64, 2, hd), _bf(1, 64, 1, hd)
    tfa.flash_attention_bwd_cuda(q, k, k, q, torch.zeros(1, 2, 64), q, **kw)
    ((lib, fn, got),) = intercepted
    assert (lib, fn) == ("flash_backward", "k4_flash_backward")
    assert len(got) + 1 == len(_cuda.SIGNATURES[lib][fn])
    assert got[10:16] == (1, 64, 2, 1, hd, hd ** -0.5)
    assert got[16:] == args
    assert _cuda.LAUNCHES["flash_attention_bwd"] == 1
    assert _cuda.LAUNCHES[f"flash_attention_bwd:{variant}"] == 1


def test_k4_backward_workspace_rows_are_padded(intercepted, monkeypatch):
    """At a ragged S (1000, G = 4, hd 64) the launch arguments are the
    shape's, and the workspace holds the D and lse log2(e) rows padded
    to ``BWD_ROW_PAD`` (1024), which the kernel copies in whole runs of 64
    and 128 rows."""
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **kw: made.append(a[0]) or empty(*a, **kw))
    q, k = _bf(2, 1000, 8, 64), _bf(2, 1000, 2, 64)
    tfa.flash_attention_bwd_cuda(q, k, k, q, torch.zeros(2, 8, 1000), q)
    ((lib, fn, args),) = intercepted
    assert args[10:] == (2, 1000, 8, 2, 64, 64 ** -0.5, 0, 0, 0, 0.0)
    assert made == [(2, 2, 8, 1024)]


def test_k4_backward_global_ignores_the_window(intercepted):
    """'global' with the config's window (gemma's global layers) launches
    with window 0, as the forward does."""
    q, k = _bf(1, 64, 2, 256), _bf(1, 64, 1, 256)
    tfa.flash_attention_bwd_cuda(q, k, k, q, torch.zeros(1, 2, 64), q,
                                 kind="global", window=1024)
    ((_, _, got),) = intercepted
    assert got[16:] == (0, 0, 0, 0.0)
    assert _cuda.LAUNCHES["flash_attention_bwd:hd256"] == 1


@pytest.mark.parametrize("kw,exc,match", [
    (dict(kind="full", skv=96), NotImplementedError, "Skv == Sq"),
    (dict(hd=96), ValueError, "head_dim"),
    (dict(kind="local", window=0), ValueError, "window"),
    (dict(kind="sliding"), NotImplementedError, "not ported"),
    (dict(softcap=-1.0), ValueError, "softcap"),
])
def test_k4_backward_refuses_what_it_does_not_take(intercepted, kw, exc,
                                                   match):
    """The backward kernel takes every kind at Sq == Skv and head dims 16
    to 256: 'full' over other keys (cross-attention, whisper's training
    slice), another head dim, a window below 1, an unknown kind and a
    negative softcap raise with the reason and launch nothing."""
    hd, skv = kw.pop("hd", 128), kw.pop("skv", 64)
    q, k = _bf(1, 64, 2, hd), _bf(1, skv, 1, hd)
    with pytest.raises(exc, match=match):
        tfa.flash_attention_bwd_cuda(q, k, k, q, torch.zeros(1, 2, 64), q,
                                     **kw)
    assert not intercepted
