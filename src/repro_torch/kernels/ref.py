"""Plain PyTorch versions of the kernels (the counterpart of
``repro/kernels/ref.py``).

Each repeats its kernel's arithmetic on whole tensors: the wrappers run
them for CPU tensors, the CPU tests hold them to the JAX kernels in
interpret mode, and ``chip_smoke.py`` holds each CUDA/Triton kernel to
its plain version on the card.  Nothing on the CUDA path calls them.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1.0e30


def ref_copy_rows(src, start: int, size: int, device=None):
    """Rows ``[start, start+size)`` of a stacked ``(N, W)`` buffer, as a new
    tensor on ``device`` (default: the source's)."""
    return src[start:start + size].to(device or src.device, copy=True)


def ref_rmsnorm(x, scale, *, eps=1e-6):
    """RMSNorm in f32, cast back to x's dtype (``_rmsnorm_kernel``)."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def ref_attention(q, k, v, *, causal=True, window=0, soft_cap=0.0):
    """q: (B,H,Sq,D), k/v: (B,Hkv,Sk,D) with Hkv dividing H -> (o, lse).

    The whole score matrix at once, with the flash kernel's numerics: q
    cast to f32 before the scale, masked scores at the finite -1e30, the
    normaliser clamped at 1e-30; o in q's dtype, lse f32 (B,H,Sq)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    rep = H // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = (q.float() * (1.0 / math.sqrt(D))) @ kf.transpose(-1, -2)
    if soft_cap > 0:
        s = soft_cap * torch.tanh(s / soft_cap)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    allow = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        allow &= kp <= qp
    if window > 0:
        allow &= (qp - kp) < window
    s = torch.where(allow, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = (p @ vf) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse
