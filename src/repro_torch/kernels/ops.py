"""Model-layout wrappers around the kernels (``repro/kernels/ops.py``)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention_fwd_bhsd
from repro_torch.kernels.rmsnorm import rmsnorm_2d


def flash_attention(q, k, v, *, causal=True, window=0, soft_cap=0.0,
                    block_q=128, block_k=128):
    """q: (B,S,H,D), k/v: (B,S,Hkv,D) (model layout) -> (B,S,H,D).
    Forward only in this slice; the kernel reads the transposed views
    through strides, so no copy is made."""
    o, _ = flash_attention_fwd_bhsd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, soft_cap=soft_cap, block_q=block_q,
        block_k=block_k)
    return o.transpose(1, 2)


def rmsnorm(x, scale, *, eps=1e-6):
    """x: (..., d) -> same shape (forward only)."""
    shape = x.shape
    return rmsnorm_2d(x.reshape(-1, shape[-1]), scale,
                      eps=eps, block_rows=1).reshape(shape)
