"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local+global alternating, logit softcap. [arXiv:2408.00118]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    block_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    gated_mlp=True,
    param_dtype="bfloat16",
    microbatches=8,
)

SMOKE = ArchConfig(
    name="gemma2-27b-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab=256,
    block_pattern=("local", "global"),
    window=16,
    attn_softcap=50.0,
    final_softcap=30.0,
    gated_mlp=True,
)
