"""K5, fused RMSNorm forward, in Triton.

Replaces ``_rmsnorm_kernel`` / ``rmsnorm_2d`` of
``repro/kernels/rmsnorm.py``.  The work is one row reduction (the f32 mean
of squares over d) and an elementwise scale: Triton expresses that as one
program per row with the whole row in one block (``tl.sum``), so the row
is read once and written once.  Bound on an H100: bytes at prefill shapes
((4*2048, 4096) bf16 moves 134 MB); at decode shapes ((4, 4096), 81
launches per sweep) launch latency, far above the 64 KB the call moves.

``triton`` is imported inside the launching function: the module imports
on a machine without it, and the CPU path never needs it.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.ref import ref_rmsnorm

__all__ = ["rmsnorm_2d", "rmsnorm_2d_plain"]

triton = tl = None   # bound by _kernel() on first launch


def rmsnorm_2d_plain(x, scale, *, eps=1e-6, block_rows=256):
    """Plain version of ``rmsnorm_2d`` (``block_rows`` only tiles)."""
    return ref_rmsnorm(x, scale, eps=eps)


@functools.lru_cache(maxsize=None)
def _kernel():
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, s_ptr, o_ptr, d, x_stride, o_stride, eps,
                       BLOCK_D: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < d
        x = tl.load(x_ptr + row * x_stride + cols, mask=mask,
                    other=0.0).to(tl.float32)
        ms = tl.sum(x * x, axis=0) / d
        s = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = x * (1.0 / tl.sqrt(ms + eps)) * s
        tl.store(o_ptr + row * o_stride + cols,
                 y.to(o_ptr.dtype.element_ty), mask=mask)

    return rmsnorm_kernel


def rmsnorm_2d(x, scale, *, eps=1e-6, block_rows=256):
    """x: (R, d), scale: (d,) -> (R, d) in x's dtype; RMSNorm in f32.

    CPU tensors run the plain version; CUDA tensors launch the Triton
    kernel on the current stream."""
    R, d = x.shape
    block_rows = min(block_rows, R)
    assert R % block_rows == 0, f"rows {R} must tile by {block_rows}"
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_2d_plain(x, scale, eps=eps)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm_2d: x on {x.device}, scale on "
                         f"{scale.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"rmsnorm_2d: unsupported dtype {x.dtype}")
    if x.stride(1) != 1 or not scale.is_contiguous() or scale.shape != (d,):
        raise ValueError("rmsnorm_2d: rows and scale must be contiguous, "
                         f"scale of shape ({d},)")
    kern = _kernel()
    out = torch.empty((R, d), dtype=x.dtype, device=x.device)
    block_d = triton.next_power_of_2(d)
    kern[(R,)](x, scale, out, d, x.stride(0), out.stride(0), eps,
               BLOCK_D=block_d, num_warps=min(16, max(1, block_d // 256)))
    rmsnorm_2d.launches += 1
    return out


rmsnorm_2d.launches = 0
