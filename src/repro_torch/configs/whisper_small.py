"""whisper-small [audio]: 12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865
— encoder-decoder; conv frontend STUBBED. [arXiv:2212.04356]

The conv frontend is a stub: the encoder takes precomputed frame
embeddings [B, 1500, d_model], 12 bidirectional layers over them; the
decoder is 12 causal layers with cross-attention, sinusoidal positions
(no RoPE) and a plain GELU MLP.  ``param_dtype`` stays the reference's
float32: every weight is an fp32 master, which training updates, and
serving reads the projections' copy at the compute dtype (the encoder's
and the cross-attention's among them: ``models.lm.Model.served_blocks``,
``served_encoder``)."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    block_pattern=("global",),
    encdec=True,
    n_enc_layers=12,
    enc_frames=1500,
    gated_mlp=False,       # whisper uses plain GELU MLPs
    tie_embeddings=True,
    microbatches=2,
)

SMOKE = ArchConfig(
    name="whisper-small-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    block_pattern=("global",),
    encdec=True,
    n_enc_layers=2,
    enc_frames=24,
    gated_mlp=False,
)
