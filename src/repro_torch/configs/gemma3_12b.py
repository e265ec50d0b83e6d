"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) hd=256 d_ff=15360
vocab=262144 — 5:1 local:global, window 1024, dual RoPE theta (1e4 on the
local layers, 1e6 on the global ones). [hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    block_pattern=("local",) * 5 + ("global",),
    window=1024,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    gated_mlp=True,
    param_dtype="bfloat16",
    microbatches=4,
)

SMOKE = ArchConfig(
    name="gemma3-12b-smoke",
    family="dense",
    n_layers=6,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    block_pattern=("local",) * 5 + ("global",),
    window=16,
    rope_theta_global=1_000_000.0,
    gated_mlp=True,
)
