"""deepseek-coder-33b — [dense] 62L d_model=7168 56H (GQA kv=8)
d_ff=19200 vocab=32256 — llama-arch.  [arXiv:2401.14196; hf]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

ARCH_ID = "deepseek-coder-33b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=62,
        d_model=7168,
        d_ff=19_200,
        vocab_size=32_256,
        attention=AttentionConfig(
            kind="gqa", num_heads=56, num_kv_heads=8, head_dim=128,
            rope_theta=100_000.0),
        norm="rmsnorm",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        num_layers=2, d_model=64, d_ff=160, vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                                  head_dim=16, rope_theta=100_000.0),
        ce_chunk=64)
