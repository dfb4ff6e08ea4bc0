"""ChatGLM3-6B [arXiv:2406.12793].

Dense decoder, 28L, d_model=4096, 32 heads (GQA kv=2), d_ff=13696,
vocab=65024.  2D RoPE — rotary applied to half of each head dim
(rope_fraction=0.5) — and QKV biases.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense", source="arXiv:2406.12793",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_head=128,
        d_ff=13696, vocab_size=65024,
        qkv_bias=True, rope_fraction=0.5, norm_type="rmsnorm",
        gated_mlp=True, act="silu", max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="chatglm3-6b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_head=32, d_ff=256, vocab_size=512, max_seq_len=128,
        attn_chunk=0)


register("chatglm3-6b", full, smoke)
