"""llava-next-34b — VLM backbone (yi-34b-class decoder); anyres vision tiling
stubbed (input_specs supplies pre-projected patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  60L d_model=7168 56H
(GQA kv=8) d_ff=20480 vocab=64000.  2880 patch positions (4 tiles + base
x 576, anyres)."""

from repro_torch.configs.base import ATTN, LayerPos, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="decoder",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64_000,
        block=(LayerPos(mixer=ATTN),),
        frontend="vision",
        num_patches=2880,
        rope_theta=5_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b-smoke",
        family="decoder",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block=(LayerPos(mixer=ATTN),),
        frontend="vision",
        num_patches=8,
        remat="none",
        attn_chunk=16,
    )
