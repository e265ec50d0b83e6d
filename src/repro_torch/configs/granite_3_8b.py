"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 — GQA, bf16 parameters."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab=49155,
    block_pattern=("global",),
    gated_mlp=True,
    param_dtype="bfloat16",
    microbatches=4,
)

SMOKE = ArchConfig(
    name="granite-3-8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    block_pattern=("global",),
    gated_mlp=True,
)
