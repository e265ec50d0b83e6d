"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, 2 recurrent : 1 attention.
[arXiv:2402.19427]

The reference's FULL and SMOKE field for field (its ``fsdp_params`` and
``seq_shard_activations`` are sharding settings the port has no field
for).  38 layers with a period-3 pattern: 12 groups of
(rglru, rglru, local) and a 2-block (rglru, rglru) tail, 26 RG-LRU mixers
(``models.rglru``) and 12 local-attention blocks, 16 q heads over one kv
head of 256 (G = 16).  ``param_count`` is the reference's reckoning,
which counts an RG-LRU mixer's gates and decay as ``3 * w`` where it holds
two dense [w, w] gates and a [w] decay: 8.52 B where the model holds 9.40
B (ROADMAP F8).  The port states byte counts from its tensors."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    lru_width=4096,
    conv_width=4,
    gated_mlp=True,
    param_dtype="bfloat16",
    microbatches=4,
)

SMOKE = ArchConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    n_layers=5,   # 1 full group + (rglru, rglru) tail, like the real 38
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab=256,
    block_pattern=("rglru", "rglru", "local"),
    window=16,
    lru_width=64,
    conv_width=4,
    gated_mlp=True,
)
