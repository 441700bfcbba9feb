"""rwkv6-1.6b — [ssm] 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536
— Finch, data-dependent decay.  [arXiv:2404.05892; unverified]

Attention-free: 32 WKV heads of 64 carry a constant-size recurrent state
per slot, so the eager ``Engine`` serves it (``PagedEngine`` refuses SSM
blocks).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "rwkv6-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        num_layers=24,
        d_model=2048,
        d_ff=7168,
        vocab_size=65_536,
        attention=None,
        ssm=SSMConfig(kind="rwkv6", head_dim=64),
        block_pattern=("rwkv6",),
        norm="layernorm",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        num_layers=2, d_model=64, d_ff=128, vocab_size=512,
        ssm=SSMConfig(kind="rwkv6", head_dim=16),
        ce_chunk=64)
