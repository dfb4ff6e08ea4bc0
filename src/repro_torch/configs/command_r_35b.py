"""Command R 35B [hf:CohereForAI/c4ai-command-r-v01].

Dense decoder, 40L, d_model=8192, 64 heads (GQA kv=8), d_ff=22528,
vocab=256000.  Cohere-style parallel residual block (attention and FFN both
read one pre-norm), no projection biases, tied embeddings, large rope theta.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense",
        source="hf:CohereForAI/c4ai-command-r-v01",
        n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=22528, vocab_size=256000,
        parallel_block=True, norm_type="layernorm", gated_mlp=True,
        act="silu", tie_embeddings=True, rope_theta=8_000_000.0,
        max_seq_len=131072,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="command-r-35b-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=2, d_head=32, d_ff=512, vocab_size=512, max_seq_len=256,
        attn_chunk=0)


register("command-r-35b", full, smoke)
