"""K5, fused RMSNorm forward, in CUDA C++ (``csrc/rmsnorm.cu``).

Replaces ``_rmsnorm_kernel`` / ``rmsnorm_2d`` of
``repro/kernels/rmsnorm.py``.  The work is one row reduction (the f32 mean
of squares over d) and an elementwise scale, with the row kept in
registers between the two, so it is read once and written once.  Bound on
an H100: bytes at prefill shapes ((4*2048, 4096) bf16 moves 134 MB); at
decode shapes ((4, 4096), 81 launches per decode step) the host's launch
path, far above the 64 KB the call moves.  So the wrapper checks only what
the kernel needs, allocates with ``torch.empty_like`` and calls the C entry
point through ctypes with its argument types set once.

Two routes, each launch counted on ``rmsnorm_2d.launches_by_route``:

- ``"cuda"`` (the default, every launch of the serve path): the CUDA C++
  kernel.
- ``"triton"``: the Triton kernel the port had before, kept only so that
  ``chip_smoke.py`` can time it beside the CUDA kernel.  ``triton`` is
  imported inside its launching function: the module imports on a machine
  without it, and the CPU path never needs it.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_rmsnorm

__all__ = ["rmsnorm_2d", "rmsnorm_2d_plain"]

ROUTES = ("cuda", "triton")
# the C entry point's dtype codes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the widest row the kernel holds in registers: 2048 vectors of 16 bytes
_MAX_ROW_BYTES = 2048 * 16

triton = tl = None   # bound by _triton_kernel() on first launch


def rmsnorm_2d_plain(x, scale, *, eps=1e-6, block_rows=256):
    """Plain version of ``rmsnorm_2d`` (``block_rows`` only tiles)."""
    return ref_rmsnorm(x, scale, eps=eps)


@functools.lru_cache(maxsize=None)
def _triton_kernel():
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


def _refusal(x, scale) -> str:
    """Why ``rmsnorm_2d`` refuses ``(x, scale)`` on the card."""
    if x.device.type != "cuda" or scale.device != x.device:
        return f"x on {x.device}, scale on {scale.device} (one CUDA device)"
    if x.dtype not in _DTYPE_CODES or scale.dtype not in _DTYPE_CODES:
        return f"dtypes {x.dtype}, {scale.dtype} (f32, bf16 or f16)"
    if x.stride(1) != 1:
        return "the rows must be contiguous"
    if x.shape[1] * x.element_size() > _MAX_ROW_BYTES:
        return f"rows of {x.shape[1]} elements (at most {_MAX_ROW_BYTES} bytes)"
    return f"scale {tuple(scale.shape)} must be a contiguous ({x.shape[1]},)"


def rmsnorm_2d(x, scale, *, eps=1e-6, block_rows=256, route="cuda"):
    """x: (R, d) with d contiguous (any row stride; rows up to 32 KB on the
    card), scale: (d,) -> (R, d) in x's dtype; RMSNorm in f32.  Forward
    only: a tensor that requires grad, while grad is enabled, is refused
    on either device (``kernels.ops.rmsnorm_diff`` is the differentiable
    one).

    CPU tensors run the plain version whatever the route; CUDA tensors
    launch the ``route``'s kernel on the current stream.  Every check here
    runs once per decode-step norm, so each is the cheapest that tells."""
    if route not in ROUTES:
        raise ValueError(f"rmsnorm_2d: route {route!r} not in {ROUTES}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        # the kernel writes a fresh tensor autograd cannot follow: a
        # gradient through it would be cut without a word
        raise RuntimeError("rmsnorm_2d is forward only: use "
                           "kernels.ops.rmsnorm_diff under autograd")
    R, d = x.shape
    block_rows = min(block_rows, R)
    assert R % block_rows == 0, f"rows {R} must tile by {block_rows}"
    if x.is_cpu and scale.is_cpu:
        return rmsnorm_2d_plain(x, scale, eps=eps)
    xt, st = _DTYPE_CODES.get(x.dtype), _DTYPE_CODES.get(scale.dtype)
    dev = x.get_device()
    if xt is None or st is None or not x.is_cuda \
            or scale.get_device() != dev or x.stride(1) != 1 \
            or d * x.element_size() > _MAX_ROW_BYTES \
            or scale.shape != (d,) or not scale.is_contiguous():
        raise ValueError("rmsnorm_2d: " + _refusal(x, scale))
    # with d contiguous, empty_like gives a contiguous out (x is either
    # contiguous or not dense), which the kernel writes rows d apart
    out = torch.empty_like(x)
    if route == "cuda":
        err = build.library().rmsnorm_fwd(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), R, d,
            x.stride(0), eps, xt, st, torch._C._cuda_getCurrentRawStream(dev))
        if err:
            build.check(err, "rmsnorm_fwd")
    else:
        block_d = 1 << (d - 1).bit_length()
        _triton_kernel()[(R,)](x, scale, out, d, x.stride(0), out.stride(0),
                               eps, BLOCK_D=block_d,
                               num_warps=min(16, max(1, block_d // 256)))
    rmsnorm_2d.launches += 1
    rmsnorm_2d.launches_by_route[route] += 1
    return out


rmsnorm_2d.launches = 0
rmsnorm_2d.launches_by_route = dict.fromkeys(ROUTES, 0)
