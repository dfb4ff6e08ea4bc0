"""Hymba-1.5B [arXiv:2411.13676].

Hybrid-head architecture: every layer runs attention heads and Mamba (SSM)
heads **in parallel** on the same input, fused by learned per-channel scales
and a mean.  32L, d_model=1600, 25 heads (GQA kv=5), d_ff=5504, vocab=32001,
ssm_state=16.  Attention heads use a sliding window (as in the paper's
efficient configuration), which also makes long_500k decode native.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid", source="arXiv:2411.13676",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
        d_ff=5504, vocab_size=32001,
        ssm_state=16, ssm_conv=4, sliding_window=2048,
        norm_type="rmsnorm", gated_mlp=True, act="silu",
        tie_embeddings=True, max_seq_len=8192,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="hymba-1.5b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_head=32, d_ff=256, vocab_size=512, ssm_state=4,
        sliding_window=32, max_seq_len=128, attn_chunk=0)


register("hymba-1.5b", full, smoke)
