"""whisper-medium — encoder-decoder; conv/mel frontend stubbed (input_specs
supplies precomputed frame embeddings).
[arXiv:2212.04356; unverified]  24L(+24 enc) d_model=1024 16H d_ff=4096
vocab=51865, 1500 encoder frames (30 s audio)."""

from repro_torch.configs.base import (
    ATTN,
    EncoderConfig,
    LayerPos,
    ModelConfig,
)


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="encdec",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51_865,
        block=(LayerPos(mixer=ATTN),),
        encoder=EncoderConfig(num_layers=24, num_frames=1500),
        frontend="audio",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke",
        family="encdec",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block=(LayerPos(mixer=ATTN),),
        encoder=EncoderConfig(num_layers=2, num_frames=24),
        frontend="audio",
        tie_embeddings=True,
        remat="none",
        attn_chunk=16,
    )
