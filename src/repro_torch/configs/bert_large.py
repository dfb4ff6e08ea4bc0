"""BERT-Large — the paper's own model (Table 1: 24L, hidden 1024,
intermediate 4096, max seq 512, ADAM).

The paper fine-tunes sequence classification; our framework exercises the
same backbone as a layered LM stack (the L2L schedule is agnostic to the
head).  Depth variants (12/24/48/96 layers, Table 2) are produced with
``.replace(n_layers=...)`` by the memory benchmark.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="bert-large", family="dense", source="arXiv:1810.04805 / paper",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
        d_ff=4096, vocab_size=30522,
        norm_type="layernorm", gated_mlp=False, act="gelu",
        qkv_bias=True, o_bias=True, max_seq_len=512,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="bert-large-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_head=32, d_ff=256, vocab_size=512, max_seq_len=128,
        attn_chunk=0)


register("bert-large", full, smoke)
