"""llama-3.2-vision-11b — [vlm] 40L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256 — cross-attn image layers.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision tower is a stub: precomputed (B, num_image_tokens, d_model)
patch embeddings.  Every 5th decoder block gets a gated cross-attention
layer (8 of 40), mirroring the public checkpoint's cross-attn placement.
The port runs it through ``LM.prefill(modality_input=)`` and
``LM.decode_step``; the engines refuse it, as the reference's do (its
eager ``Engine`` passes no source).
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

ARCH_ID = "llama-3.2-vision-11b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        num_layers=40,
        d_model=4096,
        d_ff=14_336,
        vocab_size=128_256,
        attention=AttentionConfig(
            kind="gqa", num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=500_000.0),
        block_pattern=("attn",) * 5,
        cross_attn_every=5,
        num_image_tokens=1600,
        norm="rmsnorm",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        num_layers=4, d_model=64, d_ff=128, vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                                  head_dim=16, rope_theta=500_000.0),
        block_pattern=("attn",) * 2,
        cross_attn_every=2,
        num_image_tokens=16,
        ce_chunk=64)
