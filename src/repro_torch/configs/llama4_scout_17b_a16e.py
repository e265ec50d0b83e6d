"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192,
MoE 16 experts top-1 + shared expert, early fusion, iRoPE-style 3:1
chunked:global attention. [hf:meta-llama/Llama-4-Scout-17B-16E]

The reference's FULL and SMOKE field for field (its ``fsdp_params`` is a
sharding setting the port has no field for).  On
one card the port serves FULL cut in depth only
(``dataclasses.replace(FULL, n_layers=8)``, ``launch.serve --layers``):
two whole periods of the pattern at full width."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    block_pattern=("chunked", "chunked", "chunked", "global"),
    window=8192,
    moe=True,
    n_experts=16,
    top_k=1,
    moe_shared_expert=True,
    gated_mlp=True,
    param_dtype="bfloat16",
    microbatches=8,
)

SMOKE = ArchConfig(
    name="llama4-scout-smoke",
    family="moe",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    block_pattern=("chunked", "chunked", "chunked", "global"),
    window=16,
    moe=True,
    n_experts=4,
    top_k=1,
    capacity_factor=8.0,
    moe_shared_expert=True,
    gated_mlp=True,
)
