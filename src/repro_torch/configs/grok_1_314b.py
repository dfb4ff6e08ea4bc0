"""Grok-1 314B [hf:xai-org/grok-1].

MoE decoder, 64L, d_model=6144, 48 heads (GQA kv=8), vocab=131072.
8 routed experts top-2, per-expert d_ff=32768, gated GELU, logit
soft-capping at 30 (grok signature), RMSNorm.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe", source="hf:xai-org/grok-1",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
        d_ff=32768, vocab_size=131072,
        n_experts=8, n_shared_experts=0, experts_per_token=2,
        d_ff_expert=32768,
        norm_type="rmsnorm", gated_mlp=True, act="gelu",
        logit_soft_cap=30.0, max_seq_len=8192,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="grok-1-314b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_head=32, d_ff=256, vocab_size=512,
        n_experts=4, experts_per_token=2, d_ff_expert=128,
        max_seq_len=128, attn_chunk=0)


register("grok-1-314b", full, smoke)
