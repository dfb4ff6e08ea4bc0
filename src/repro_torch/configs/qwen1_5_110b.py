"""Qwen1.5-110B [hf:Qwen/Qwen1.5-0.5B family, scaled card].

Dense decoder, 80L, d_model=8192, 64 heads (GQA kv=8), d_ff=49152,
vocab=152064.  QKV projection biases (the Qwen1.5 signature), RMSNorm,
SwiGLU, untied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense", source="hf:Qwen/Qwen1.5-0.5B",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=49152, vocab_size=152064,
        qkv_bias=True, norm_type="rmsnorm", gated_mlp=True, act="silu",
        rope_theta=1_000_000.0, max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen1.5-110b-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=2, d_head=32, d_ff=512, vocab_size=512, max_seq_len=256,
        attn_chunk=0)


register("qwen1.5-110b", full, smoke)
