"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed experts, top-6.
[arXiv:2401.06066; hf]  28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400."""

from repro_torch.configs.base import (
    ATTN,
    MLP_MOE,
    LayerPos,
    ModelConfig,
    MoEConfig,
)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="decoder",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=102_400,
        block=(LayerPos(mixer=ATTN, mlp=MLP_MOE),),
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2),
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke",
        family="decoder",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        block=(LayerPos(mixer=ATTN, mlp=MLP_MOE),),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96, num_shared=2,
                      group_size=32),
        remat="none",
        attn_chunk=16,
    )
