"""Model-layout wrappers around the kernels (``repro/kernels/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (flash_attention_bwd_bhsd,
                                                 flash_attention_fwd_bhsd)
from repro_torch.kernels.fused_adam import fused_adam_flat
from repro_torch.kernels.ref import ref_rmsnorm
from repro_torch.kernels.rmsnorm import rmsnorm_2d


class _FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the reference's custom VJP): the
    forward kernel (K2) saves ``(q, k, v, o, lse)``; the backward
    recomputes the probabilities in K3a/K3b.  Every tensor is read and
    written through strides in the model's (B, S, H, D) layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, soft_cap, block_q, block_k):
        o, lse = flash_attention_fwd_bhsd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, soft_cap=soft_cap,
            block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, window, soft_cap, block_q, block_k)
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, do):
        causal, window, soft_cap, block_q, block_k = ctx.cfg
        if soft_cap != 0.0:
            raise NotImplementedError(
                "soft-capped attention has no backward kernel")
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd_bhsd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), o, lse,
            do.transpose(1, 2), causal=causal, window=window,
            block_q=block_q, block_k=block_k)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None, None, None, None)


def flash_attention(q, k, v, *, causal=True, window=0, soft_cap=0.0,
                    block_q=128, block_k=128):
    """q: (B,S,H,D), k/v: (B,S,Hkv,D) (model layout) -> (B,S,H,D).
    Differentiable (K3 backward); the kernels read the transposed views
    through strides, so no copy is made."""
    return _FlashAttention.apply(q, k, v, causal, window, soft_cap, block_q,
                                 block_k)


def fused_adam(p, g, m, v, a, clip_scale, *, b1=0.9, b2=0.999, eps=1e-8,
               wd=0.0, wd_form=None):
    """Any-shaped params: flattened (the kernel masks its ragged tail, so
    nothing is padded), the fused update (K1), reshaped back.
    -> (p', m', v')."""
    shape = p.shape
    p2, m2, v2 = fused_adam_flat(
        p.reshape(-1), g.reshape(-1), m.reshape(-1), v.reshape(-1), a,
        clip_scale, b1=b1, b2=b2, eps=eps, wd=wd, wd_form=wd_form)
    return p2.view(shape), m2.view(shape), v2.view(shape)


def rmsnorm(x, scale, *, eps=1e-6):
    """x: (..., d) -> same shape (forward only)."""
    shape = x.shape
    return rmsnorm_2d(x.reshape(-1, shape[-1]), scale,
                      eps=eps, block_rows=1).reshape(shape)


class _RMSNormDiff(torch.autograd.Function):
    """Differentiable RMSNorm (the reference's ``_rmsnorm_ad``): the
    forward kernel (K5) saves ``(x, scale)``; the backward is the vjp of
    the plain function (``ref_rmsnorm``: f32 mean of squares, rsqrt,
    scale, cast back) recomputed from them, as the reference's backward is
    ``jax.vjp`` of ``_rmsnorm_reference`` and no kernel."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        rmsnorm_diff.forwards += 1
        return rmsnorm(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        xd, sd = x.detach().requires_grad_(), scale.detach().requires_grad_()
        with torch.enable_grad():
            out = ref_rmsnorm(xd, sd, eps=ctx.eps)
            dx, dscale = torch.autograd.grad(out, (xd, sd), g)
        return dx, dscale, None


def rmsnorm_diff(x, scale, *, eps=1e-6):
    """Differentiable RMSNorm: x (..., d), scale (d,) -> (..., d).  K5 in
    the forward (its plain version for CPU tensors), the recomputed vjp in
    the backward.  ``rmsnorm_diff.forwards`` counts the forwards, so a
    caller can tell that a path went through it (each launches K5 once on
    a CUDA tensor)."""
    return _RMSNormDiff.apply(x, scale, eps)


rmsnorm_diff.forwards = 0
