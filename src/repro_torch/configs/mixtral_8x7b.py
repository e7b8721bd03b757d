"""mixtral-8x7b — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000."""

from repro_torch.configs.base import (
    ATTN_LOCAL,
    MLP_MOE,
    LayerPos,
    ModelConfig,
    MoEConfig,
)


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="decoder",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32_000,
        block=(LayerPos(mixer=ATTN_LOCAL, mlp=MLP_MOE),),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
        sliding_window=4096,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke",
        family="decoder",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block=(LayerPos(mixer=ATTN_LOCAL, mlp=MLP_MOE),),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128, group_size=32),
        sliding_window=8,
        remat="none",
        attn_chunk=16,
    )
