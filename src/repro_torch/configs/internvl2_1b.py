"""InternVL2-1B [arXiv:2404.16821].

VLM: InternViT-300M vision encoder (STUB per assignment — ``input_specs``
provides precomputed patch embeddings) + Qwen2-0.5B language backbone:
24L, d_model=896, 14 heads (GQA kv=2), d_ff=4864, vocab=151655, QKV bias,
tied embeddings.  An MLP projector maps ViT features (1024) to d_model.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm", source="arXiv:2404.16821",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
        d_ff=4864, vocab_size=151655,
        qkv_bias=True, norm_type="rmsnorm", gated_mlp=True, act="silu",
        tie_embeddings=True, rope_theta=1_000_000.0,
        is_vlm=True, n_patches=256, vit_dim=1024, max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="internvl2-1b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_head=32, d_ff=256, vocab_size=512,
        n_patches=4, vit_dim=48, max_seq_len=128, attn_chunk=0)


register("internvl2-1b", full, smoke)
