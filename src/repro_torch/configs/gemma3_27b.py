"""gemma3-27b — 5:1 local:global attention, 128k context, 256k vocab.
[hf:google/gemma-3-1b-pt; unverified]  62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144.  62 = 10 full blocks of [local x5, global] + 2
remainder local layers."""

from repro_torch.configs.base import ATTN, ATTN_LOCAL, LayerPos, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="decoder",
        num_layers=62,
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262_144,
        block=(
            LayerPos(mixer=ATTN_LOCAL),
            LayerPos(mixer=ATTN_LOCAL),
            LayerPos(mixer=ATTN_LOCAL),
            LayerPos(mixer=ATTN_LOCAL),
            LayerPos(mixer=ATTN_LOCAL),
            LayerPos(mixer=ATTN),
        ),
        sliding_window=1024,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b-smoke",
        family="decoder",
        num_layers=8,  # one block of 6 + 2 remainder — exercises the remainder path
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block=(
            LayerPos(mixer=ATTN_LOCAL),
            LayerPos(mixer=ATTN_LOCAL),
            LayerPos(mixer=ATTN_LOCAL),
            LayerPos(mixer=ATTN_LOCAL),
            LayerPos(mixer=ATTN_LOCAL),
            LayerPos(mixer=ATTN),
        ),
        sliding_window=8,
        remat="none",
        attn_chunk=16,
    )
