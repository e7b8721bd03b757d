"""internlm2-20b — dense GQA.
[arXiv:2403.17297; hf]  48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544."""

from repro_torch.configs.base import ATTN, LayerPos, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        family="decoder",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92_544,
        block=(LayerPos(mixer=ATTN),),
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b-smoke",
        family="decoder",
        num_layers=3,
        d_model=48,
        num_heads=6,
        num_kv_heads=2,
        head_dim=8,
        d_ff=96,
        vocab_size=256,
        block=(LayerPos(mixer=ATTN),),
        remat="none",
        attn_chunk=16,
    )
