"""whisper-base — [audio] 6L d_model=512 8H (GQA kv=8) d_ff=2048
vocab=51865 — enc-dec, conv frontend (stub).  [arXiv:2212.04356; unverified]

The conv1d/mel frontend is a stub: precomputed (B, 1500, d_model) frame
embeddings (``configs.specs.modality_spec``).  Decoder blocks
cross-attend to the encoder output every layer.  The port runs it through
``LM.prefill(modality_input=)`` and ``LM.decode_step``; the engines refuse
it, as the reference's do (its eager ``Engine`` passes no source).
"""
from repro_torch.configs.base import AttentionConfig, EncoderConfig, ModelConfig

ARCH_ID = "whisper-base"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        num_layers=6,
        d_model=512,
        d_ff=2048,
        vocab_size=51_865,
        attention=AttentionConfig(
            kind="gqa", num_heads=8, num_kv_heads=8, head_dim=64,
            rope_theta=10_000.0),
        encoder=EncoderConfig(num_layers=6, max_source_len=1500),
        norm="layernorm",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        num_layers=2, d_model=64, d_ff=128, vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=4,
                                  head_dim=16, rope_theta=10_000.0),
        encoder=EncoderConfig(num_layers=2, max_source_len=64),
        ce_chunk=64)
