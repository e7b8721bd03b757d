"""jamba-v0.1-52b — hybrid Mamba + attention (1:7), MoE 16e top-2.
[arXiv:2403.19887; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536.  Block of 8: attention at position 4, Mamba elsewhere; MoE on
odd positions (16 MoE layers total)."""

from repro_torch.configs.base import (
    ATTN,
    MAMBA,
    MLP_DENSE,
    MLP_MOE,
    LayerPos,
    MambaConfig,
    ModelConfig,
    MoEConfig,
)


def _block(attn_pos: int = 4, size: int = 8):
    return tuple(
        LayerPos(
            mixer=ATTN if i == attn_pos else MAMBA,
            mlp=MLP_MOE if i % 2 == 1 else MLP_DENSE,
        )
        for i in range(size)
    )


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="decoder",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65_536,
        block=_block(),
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=64),
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-smoke",
        family="decoder",
        num_layers=8,  # one full hybrid block
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block=_block(),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128, group_size=32),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2, head_dim=16, chunk=8),
        remat="none",
        attn_chunk=16,
    )
