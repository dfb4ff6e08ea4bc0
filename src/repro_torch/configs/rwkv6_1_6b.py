"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892].

Attention-free RNN: 24L, d_model=2048, d_ff=7168, vocab=65536; head size 64
(32 wkv heads), data-dependent decay via DDLerp low-rank modulation.
Decode state is O(1) in context — long_500k is native.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm", source="arXiv:2404.05892",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=7168, vocab_size=65536,
        rwkv_head_dim=64, rwkv_lora=64,
        norm_type="layernorm", max_seq_len=1_000_000,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="rwkv6-1.6b-smoke", n_layers=2, d_model=128, d_ff=256,
        vocab_size=512, rwkv_head_dim=32, rwkv_lora=16, n_heads=4,
        n_kv_heads=4, max_seq_len=128)


register("rwkv6-1.6b", full, smoke)
