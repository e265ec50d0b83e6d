"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 — GQA, fp32 parameters."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92544,
    block_pattern=("global",),
    gated_mlp=True,
    microbatches=2,
)

SMOKE = ArchConfig(
    name="internlm2-1.8b-smoke",
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
