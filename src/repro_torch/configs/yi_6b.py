"""yi-6b — llama-architecture dense GQA.
[arXiv:2403.04652; hf]  32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000."""

from repro_torch.configs.base import ATTN, LayerPos, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        family="decoder",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64_000,
        block=(LayerPos(mixer=ATTN),),
        rope_theta=5_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-smoke",
        family="decoder",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block=(LayerPos(mixer=ATTN),),
        remat="none",
        attn_chunk=16,
    )
