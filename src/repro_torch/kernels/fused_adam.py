"""K1, fused Adam/AdamW update, in Triton.

Replaces ``_adam_kernel`` / ``fused_adam_flat`` of
``repro/kernels/fused_adam.py``: one elementwise pass over flat
``p, g, m, v`` that applies the clip scale, both moment updates and the
parameter step, reading each input once and writing ``p', m', v'`` once.
The step size ``a`` and the clip scale are runtime arguments, so one
compiled kernel serves every step; the association (``wd_form``) is a
``tl.constexpr``.  One program per 4096-element block.

Bound on an H100: bytes — 28 per element for f32 ``p`` (16 read, 12
written), 0.105 ms for one packed BERT-Large layer (12,596,224 elements)
at 3.35 TB/s.

Numerics: the kernel equals the eager torch chain of ``optim.adam`` /
``optim.adamw`` bit for bit, so the packed relay's update (this kernel,
once per dtype segment) and the unpacked per-leaf update agree exactly.
To that end the launch turns off Triton's contraction of ``a*b + c``
into FMAs (``enable_fp_fusion=False``: torch rounds each product), and
the division and square root are the round-to-nearest forms
(``tl.div_rn``, ``tl.sqrt_rn``: Triton's defaults are approximate).  The
constants ``b1, 1-b1, b2, 1-b2, eps, wd`` are computed in Python and
passed as f32 arguments, as torch casts its Python scalars.

``triton`` is imported inside the launching function: the module imports
on a machine without it.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.ref import ref_adam

__all__ = ["fused_adam_flat", "fused_adam_flat_plain", "BLOCK"]

BLOCK = 4096


def fused_adam_flat_plain(p, g, m, v, a, clip_scale, *, b1=0.9, b2=0.999,
                          eps=1e-8, wd=0.0, wd_form=None, block=16384):
    """Plain version (``block`` only tiles)."""
    return ref_adam(p, g, m, v, a, clip_scale, b1=b1, b2=b2, eps=eps, wd=wd,
                    wd_form=bool(wd) if wd_form is None else wd_form)


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def adam_kernel(p_ptr, g_ptr, m_ptr, v_ptr, po_ptr, mo_ptr, vo_ptr, n,
                    a, clip, b1, omb1, b2, omb2, eps, wd,
                    WD_FORM: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32) * clip
        m = b1 * tl.load(m_ptr + offs, mask=mask, other=0.0) + omb1 * g
        v = b2 * tl.load(v_ptr + offs, mask=mask, other=0.0) + omb2 * g * g
        p = tl.load(p_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        d = tl.sqrt_rn(v) + eps
        if WD_FORM:
            newp = p - a * (tl.div_rn(m, d) + wd * p)
        else:
            newp = p - tl.div_rn(a * m, d)
        tl.store(po_ptr + offs, newp.to(po_ptr.dtype.element_ty), mask=mask)
        tl.store(mo_ptr + offs, m, mask=mask)
        tl.store(vo_ptr + offs, v, mask=mask)

    return triton, adam_kernel


def fused_adam_flat(p, g, m, v, a, clip_scale, *, b1=0.9, b2=0.999,
                    eps=1e-8, wd=0.0, wd_form=None, block=16384):
    """All tensors 1-D of equal length: p any float type, g/m/v f32.
    ``a`` (step size, bias correction included) and ``clip_scale`` are
    scalars (floats or 0-d tensors).  ``wd_form`` forces the adamw
    association even at wd = 0 (None: inferred from wd).  -> new
    (p', m', v').  CPU tensors run the plain version; CUDA tensors launch
    the Triton kernel on the current stream (``block`` keeps the
    reference's signature; the kernel tiles by ``BLOCK``)."""
    wd_form = bool(wd) if wd_form is None else wd_form
    ts = (p, g, m, v)
    if all(t.device.type == "cpu" for t in ts):
        return fused_adam_flat_plain(p, g, m, v, a, clip_scale, b1=b1, b2=b2,
                                     eps=eps, wd=wd, wd_form=wd_form)
    if p.device.type != "cuda" or any(t.device != p.device for t in ts):
        raise ValueError("fused_adam_flat: p, g, m, v must share one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    n = p.shape[0]
    if any(t.dim() != 1 or t.shape[0] != n or not t.is_contiguous()
           for t in ts):
        raise ValueError("fused_adam_flat: p, g, m, v must be contiguous 1-D "
                         f"of one length, got {[tuple(t.shape) for t in ts]}")
    if any(t.dtype != torch.float32 for t in (g, m, v)) or \
            p.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"fused_adam_flat: dtypes {p.dtype}, {g.dtype}, "
                         f"{m.dtype}, {v.dtype} (p float, g/m/v f32)")
    triton, kern = _kernel()
    po, mo, vo = torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)
    f = lambda x: float(x)        # an f32 0-d tensor's value, exactly
    kern[(triton.cdiv(n, BLOCK),)](
        p, g, m, v, po, mo, vo, n, f(a), f(clip_scale), f(b1), f(1 - b1),
        f(b2), f(1 - b2), f(eps), f(wd), WD_FORM=bool(wd_form), BLOCK=BLOCK,
        num_warps=8, enable_fp_fusion=False)
    fused_adam_flat.launches += 1
    return po, mo, vo


fused_adam_flat.launches = 0
