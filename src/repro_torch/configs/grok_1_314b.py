"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1]

The reference's FULL and SMOKE field for field (its ``fsdp_params`` and
``skip_shapes`` are settings the port has no field for).  At bf16 a
layer is 9.84 GB (its experts 9.66 GB) and all 64 are 631 GB: on one card the port serves FULL cut in depth only
(``dataclasses.replace(FULL, n_layers=6)``, ``launch.serve --layers 6``,
60.65 GB), full width otherwise."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    block_pattern=("global",),
    moe=True,
    n_experts=8,
    top_k=2,
    gated_mlp=True,
    param_dtype="bfloat16",
    opt_state_mode="int8",
    microbatches=8,
    grad_accum_dtype="bfloat16",
)

SMOKE = ArchConfig(
    name="grok-1-314b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    block_pattern=("global",),
    moe=True,
    n_experts=4,
    top_k=2,
    capacity_factor=8.0,
    gated_mlp=True,
)
