"""DeepSeek-V2-Lite (16B total / 2.4B active) [arXiv:2405.04434].

27L, d_model=2048, 16 heads, MLA attention with kv_lora_rank=512
(qk_nope=128, qk_rope=64, v=128), vocab=102400.  MoE FFN: 64 routed experts
top-6 + 2 shared experts, per-expert d_ff=1408; layer 0 uses a dense FFN
(d_ff=10944).

Note: the assignment bracket mentions "160 routed" which is full DeepSeek-V2;
the primary spec line says 64e top-6 (= the Lite model card) — we follow the
primary spec.  See DESIGN.md §5.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", source="arXiv:2405.04434",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1408, vocab_size=102400,
        use_mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128,
        n_experts=64, n_shared_experts=2, experts_per_token=6,
        d_ff_expert=1408, d_ff_dense=10944, first_dense_layers=1,
        norm_type="rmsnorm", gated_mlp=True, act="silu", max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="deepseek-v2-lite-16b-smoke", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_head=32, d_ff=128, vocab_size=512,
        kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        n_experts=4, n_shared_experts=1, experts_per_token=2,
        d_ff_expert=64, d_ff_dense=128, first_dense_layers=1,
        max_seq_len=128, attn_chunk=0)


register("deepseek-v2-lite-16b", full, smoke)
