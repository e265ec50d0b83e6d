"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216 — SigLIP + gemma backbone. [arXiv:2407.07726]

The reference's FULL and SMOKE field for field (its ``skip_shapes`` and
``seq_shard_activations`` are settings the port has no field for).  The SigLIP tower is a stub: the model takes
precomputed patch embeddings [B, prefix_tokens, d_model] in front of the
text tokens.  Its block pattern is ``("global",)``, so the backbone
attends to the patches causally, as the reference does.  ``param_dtype``
stays the reference's float32: every weight is an fp32 master, which
training updates, and serving reads the projections' copy at the compute
dtype (``models.lm.Model.served_blocks``)."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    block_pattern=("global",),
    prefix_tokens=256,
    gated_mlp=True,
    microbatches=2,
)

SMOKE = ArchConfig(
    name="paligemma-3b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab=256,
    block_pattern=("global",),
    prefix_tokens=8,
    gated_mlp=True,
)
