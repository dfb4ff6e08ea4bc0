"""Plain PyTorch versions of the kernels (the counterpart of
``repro/kernels/ref.py``).

Each repeats its kernel's arithmetic on whole tensors: the wrappers run
them for CPU tensors, the CPU tests hold them to the JAX kernels in
interpret mode, and ``chip_smoke.py`` holds each CUDA/Triton kernel to
its plain version on the card.  Nothing on the CUDA path calls them but
``sqrt_rn``, the square root that the optimizers' per-leaf chain shares
with K1's plain version.
"""
from __future__ import annotations

import math

import numpy as np
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


def ref_attention(q, k, v, *, causal=True, window=0, soft_cap=0.0,
                  tensor_cores=False):
    """q: (B,H,Sq,D), k/v: (B,Hkv,Sk,D) with Hkv dividing H -> (o, lse).

    The whole score matrix at once, with the flash kernel's numerics: q
    cast to f32 before the scale, masked scores at the finite -1e30, the
    normaliser clamped at 1e-30; o in q's dtype, lse f32 (B,H,Sq).

    ``tensor_cores=True`` emulates the rounding points of the bf16 (wgmma)
    kernel instead: the scale applied to the f32 product q·k, and p
    rounded to bf16 before p·v (the normaliser sums the f32 p)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    rep = H // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    scale = 1.0 / math.sqrt(D)
    if tensor_cores:
        s = (q.float() @ kf.transpose(-1, -2)) * scale
    else:
        s = (q.float() * scale) @ kf.transpose(-1, -2)
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
    if tensor_cores:
        p = p.to(torch.bfloat16).float()
    o = (p @ vf) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def sqrt_rn(x):
    """The correctly rounded square root of an f32 or f64 tensor (K1's
    ``tl.sqrt_rn``).  On the card ``torch.sqrt`` is correctly rounded;
    PyTorch's CPU kernel is not (about 0.6% of f32 inputs land one ulp
    off, on one H100's host and on a CPU without a card), so on the CPU
    numpy's ``sqrt`` takes it.  The host optimizer's update then equals
    the card's bit for bit."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.numpy()))


def ref_adam(p, g, m, v, a, clip_scale, *, b1=0.9, b2=0.999, eps=1e-8,
             wd=0.0, wd_form=False):
    """Fused Adam/AdamW (``_adam_kernel``) as the eager chain of the
    per-leaf optimizers, term by term: adam ``p - (a*m)/(√v+eps)``, adamw
    (``wd_form``) ``p - a*(m/(√v+eps) + wd*p)``.  -> (p', m', v')."""
    gf = g.float() * clip_scale
    m2 = b1 * m + (1 - b1) * gf
    v2 = b2 * v + (1 - b2) * gf * gf
    pf = p.float()
    if wd_form:
        newp = pf - a * (m2 / (sqrt_rn(v2) + eps) + wd * pf)
    else:
        newp = pf - a * m2 / (sqrt_rn(v2) + eps)
    return newp.to(p.dtype), m2, v2


def ref_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0,
                      delta=None, tensor_cores=False):
    """Flash-attention backward (``_fa_dq_kernel`` + ``_fa_dkv_kernel``)
    on whole tensors: p recomputed from (q, k, lse) with the finite -1e30
    mask, ``delta = rowsum(do*o)``, dq = scale·dS K, dk = dS^T (q·scale),
    dv = P^T dO; GQA's dk/dv summed over each kv head's q heads.
    q/o/do (B,H,Sq,D), k/v (B,Hkv,Sk,D) -> (dq, dk, dv) in the inputs'
    dtypes.  ``delta`` may be given in place of ``o``.

    ``tensor_cores=True`` emulates the rounding points of the bf16 (wgmma)
    dq and dk/dv kernels: the scale applied to the f32 product q·k, P^T and
    dS (dS^T) rounded to bf16 before their products, and dq's and dk's
    scale applied after the sum."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    Hkv = k.shape[1]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    qs = q.float() * scale
    dof = do.float()
    if delta is None:
        delta = (dof * o.float()).sum(-1)
    if tensor_cores:
        s = (q.float() @ kf.transpose(-1, -2)) * scale
    else:
        s = qs @ kf.transpose(-1, -2)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    allow = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        allow &= kp <= qp
    if window > 0:
        allow &= (qp - kp) < window
    s = torch.where(allow, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[..., None])
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    if tensor_cores:
        pr, dsr = (t.to(torch.bfloat16).float() for t in (p, ds))
        dq = (dsr @ kf) * scale
        dk = (dsr.transpose(-1, -2) @ q.float()) * scale
    else:
        dq = (ds @ kf) * scale
        pr, dk = p, ds.transpose(-1, -2) @ qs
    dk = dk.view(B, Hkv, rep, Sk, D).sum(2)
    dv = (pr.transpose(-1, -2) @ dof).view(B, Hkv, rep, Sk, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
