"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 — mLSTM and
sLSTM blocks, 7:1. [arXiv:2405.04517]

The reference's FULL and SMOKE field for field (its ``seq_shard_activations``
is a sharding setting the port has no field for).  24 layers with a period-8 pattern: three groups of seven mLSTM
blocks and one sLSTM block, no tail.  ``d_ff`` is 0: an xLSTM block
carries its own up and down projections and has no FFN and no ``ln2``.
The mLSTM expands to ``w = 2 d`` (2048), so its head dim is ``2 d /
n_heads`` = 512, not ``head_dim`` (256, which nothing of the model
reads); the sLSTM runs at ``w = d`` with four heads of 256.

``param_count`` is the reference's reckoning, which counts an mLSTM's
q/k/v as ``3 w^2 / 4`` where it holds three dense [w, w] matrices, and
leaves out the sLSTM's ``out`` [d, d]: 265.8 M where the model holds
467.3 M (ROADMAP F9).  ``param_dtype`` stays the reference's float32,
its training master: the port holds every weight at fp32 (the
projections' bf16 serving copy is ``Model.served_blocks``'), and states
byte counts from its tensors."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    gated_mlp=False,
    microbatches=2,
)

SMOKE = ArchConfig(
    name="xlstm-350m-smoke",
    family="ssm",
    n_layers=8,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    head_dim=32,
    d_ff=0,
    vocab=256,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    gated_mlp=False,
)
