"""Whisper-base [arXiv:2212.04356].

Encoder-decoder speech model.  The mel-spectrogram + conv frontend is a STUB
per the assignment: ``input_specs`` provides precomputed frame embeddings
(B, 1500, d_model).  Backbone: 6 encoder + 6 decoder layers, d_model=512,
8 heads (MHA — "GQA kv=8" with 8 heads), d_ff=2048, vocab=51865.
LayerNorm, GELU (non-gated), projection biases, tied decoder embeddings.

Skips: ``long_500k`` (see DESIGN.md §5 — bounded source/target lengths make
a 524k-token decode meaningless for the family).
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio", source="arXiv:2212.04356",
        n_layers=6, n_encoder_layers=6, is_encoder_decoder=True,
        d_model=512, n_heads=8, n_kv_heads=8, d_head=64,
        d_ff=2048, vocab_size=51865,
        norm_type="layernorm", gated_mlp=False, act="gelu",
        qkv_bias=True, o_bias=True, tie_embeddings=True,
        n_frames=1500, frontend_dim=512, max_target_positions=448,
        max_seq_len=4096,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="whisper-base-smoke", n_layers=2, n_encoder_layers=2,
        d_model=128, n_heads=4, n_kv_heads=4, d_head=32, d_ff=256,
        vocab_size=512, n_frames=16, frontend_dim=128, max_seq_len=128,
        attn_chunk=0)


register("whisper-base", full, smoke)
