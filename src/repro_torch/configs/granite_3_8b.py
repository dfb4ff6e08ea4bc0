"""Granite-3 8B [hf:ibm-granite/granite-3.0-2b-base family].

Dense decoder, 40L, d_model=4096, 32 heads (GQA kv=8), d_ff=12800,
vocab=49155.  RMSNorm, SwiGLU, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b", family="dense",
        source="hf:ibm-granite/granite-3.0-2b-base",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=12800, vocab_size=49155,
        norm_type="rmsnorm", gated_mlp=True, act="silu",
        tie_embeddings=True, rope_theta=10_000_000.0, max_seq_len=8192,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="granite-3-8b-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=2, d_head=32, d_ff=512, vocab_size=512, max_seq_len=256,
        attn_chunk=0)


register("granite-3-8b", full, smoke)
