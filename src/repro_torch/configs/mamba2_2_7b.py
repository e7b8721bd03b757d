"""mamba2-2.7b — pure SSM, state-space duality (SSD), attention-free.
[arXiv:2405.21060; unverified]  64L d_model=2560 d_ff=0 vocab=50280
ssm_state=128.  d_inner=5120, head_dim=64 -> 80 SSD heads."""

from repro_torch.configs.base import MAMBA, MLP_NONE, LayerPos, MambaConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="decoder",
        num_layers=64,
        d_model=2560,
        num_heads=1,       # attention-free; placeholders
        num_kv_heads=1,
        head_dim=64,
        d_ff=0,
        vocab_size=50_280,
        block=(LayerPos(mixer=MAMBA, mlp=MLP_NONE),),
        mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke",
        family="decoder",
        num_layers=3,
        d_model=64,
        num_heads=1,
        num_kv_heads=1,
        head_dim=16,
        d_ff=0,
        vocab_size=256,
        block=(LayerPos(mixer=MAMBA, mlp=MLP_NONE),),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2, head_dim=16, chunk=8),
        tie_embeddings=True,
        remat="none",
    )
