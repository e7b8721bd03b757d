"""granite-3-2b — dense GQA.
[hf:ibm-granite/granite-3.0-2b-base; hf]  40L d_model=2048 32H (GQA kv=8)
d_ff=8192 vocab=49155.  head_dim = 2048/32 = 64."""

from repro_torch.configs.base import ATTN, LayerPos, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        family="decoder",
        num_layers=40,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=49_155,
        block=(LayerPos(mixer=ATTN),),
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b-smoke",
        family="decoder",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=251,  # odd vocab (like 49155) exercises unaligned unembed
        block=(LayerPos(mixer=ATTN),),
        remat="none",
        attn_chunk=16,
    )
