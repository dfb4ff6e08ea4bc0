"""K2, flash-attention forward, and K3a / K3b, its backward, in CUDA C++.

Replaces ``_fa_kernel`` / ``flash_attention_fwd_bhsd`` of
``repro/kernels/flash_attention.py``: online-softmax attention that keeps
the score matrix on chip and returns ``o`` and the per-row ``lse``; and
``_fa_dq_kernel`` / ``_fa_dkv_kernel`` / ``flash_attention_bwd_bhsd``:
``delta = rowsum(do·o)`` in plain torch, as the reference computes it,
then dq (K3a: one block per (b·h, q tile), a loop over key tiles) and
dk/dv (K3b: one block per (b·hkv, key tile), a loop over the kv head's q
heads and their q tiles), each recomputing p from ``(q, k, lse)``.  No
atomics, so deterministic.  Bound: operations at prefill and training
lengths.  ``kernels.ops.flash_attention`` wraps forward and backward in a
``torch.autograd.Function``.

Two routes, chosen by dtype (``route_for``), each launch counted on its
wrapper's ``launches_by_route``:

- ``"wgmma"`` (bf16, the serve and train paths' dtype): K2, K3a and K3b
  run their products on the tensor cores (``csrc/flash_attention_sm90.cu``,
  ``csrc/flash_attention_dq_sm90.cu``, ``csrc/flash_attention_bwd_sm90.cu``),
  with tiles loaded by TMA through tensor maps that the C entry points
  encode from the pointers and strides given here.  A bf16 call those maps
  cannot describe raises (``check_tma``); it never drops to another kernel.
- ``"cuda_core"`` (f32): the exact f32 kernels on the CUDA cores
  (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``), which
  the f32 parity checks need.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_attention, ref_attention_bwd

__all__ = ["flash_attention_fwd_bhsd", "flash_attention_fwd_bhsd_plain",
           "flash_attention_bwd_bhsd", "flash_attention_bwd_bhsd_plain",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "route_for",
           "check_tma"]

_HEAD_DIMS = (32, 64, 128)
ROUTES = ("wgmma", "cuda_core")


def route_for(dtype) -> str:
    """The route a CUDA call of K2 / K3a / K3b takes: bf16 -> the
    tensor-core (wgmma) kernels, f32 -> the exact CUDA-core ones."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "cuda_core"
    raise ValueError(f"flash attention: dtype {dtype} (f32 or bf16)")


def check_tma(*tensors) -> None:
    """Raise unless every (B, H, S, D) tensor can be described by the
    wgmma kernels' TMA tensor maps: bf16, D in (32, 64, 128) and
    contiguous, a 16-byte aligned base, and every stride of a dim with
    more than one entry a multiple of 16 bytes (8 bf16 elements).  Runs
    before any launch; the common case costs a few attribute reads."""
    for t in tensors:
        n, st = t.shape, t.stride()
        if t.dtype != torch.bfloat16 or len(n) != 4 \
                or n[3] not in _HEAD_DIMS or st[3] != 1 \
                or t.data_ptr() % 16 or (n[0] > 1 and st[0] % 8) \
                or (n[1] > 1 and st[1] % 8) or (n[2] > 1 and st[2] % 8):
            raise ValueError("wgmma route: " + _tma_refusal(t))


def _tma_refusal(t) -> str:
    """Why ``check_tma`` refuses ``t``."""
    if t.dtype != torch.bfloat16:
        return f"dtype {t.dtype} (bf16 only)"
    if t.dim() != 4 or t.shape[3] not in _HEAD_DIMS:
        return f"shape {tuple(t.shape)} (head dim in {_HEAD_DIMS})"
    if t.stride(3) != 1:
        return "the head dim must be contiguous"
    if t.data_ptr() % 16:
        return "base pointer not 16-byte aligned"
    return (f"strides {t.stride()} of {tuple(t.shape)} not multiples of 16 "
            "bytes")


def _route(q, route):
    route = route or route_for(q.dtype)
    if route not in ROUTES:
        raise ValueError(f"flash attention: route {route!r} not in {ROUTES}")
    return route


def flash_attention_fwd_bhsd_plain(q, k, v, *, causal=True, window=0,
                                   soft_cap=0.0, block_q=128, block_k=128):
    """Plain version: q (B,H,Sq,D), k/v (B,Hkv,Sk,D) -> (o, lse)."""
    return ref_attention(q, k, v, causal=causal, window=window,
                         soft_cap=soft_cap)


def _check(q, k, v):
    B, H, Sq, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B \
            or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("flash attention: q, k, v must share one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or \
            q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype} (f32 or bf16, all alike)")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {D} not in {_HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash attention: the head dim must be contiguous")
    if B * H > 65535:
        raise ValueError(f"flash attention: B*H = {B * H} blocks too many")


def flash_attention_fwd_bhsd(q, k, v, *, causal=True, window=0,
                             soft_cap=0.0, block_q=128, block_k=128,
                             route=None):
    """q (B,H,Sq,D), k/v (B,Hkv,Sk,D) with Hkv dividing H (GQA: the kernel
    reads KV head h // (H/Hkv)) -> (o (B,H,Sq,D) in q's dtype,
    lse (B,H,Sq) f32).  Inputs may be strided views (D contiguous).
    ``block_q``/``block_k`` keep the reference's tiling contract.
    ``route`` (default ``route_for(q.dtype)``) names the kernel; "wgmma"
    takes bf16 only."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    block_q, block_k = min(block_q, Sq), min(block_k, Sk)
    assert Sq % block_q == 0 and Sk % block_k == 0, \
        f"seq ({Sq},{Sk}) must tile by ({block_q},{block_k})"
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_fwd_bhsd_plain(
            q, k, v, causal=causal, window=window, soft_cap=soft_cap)
    _check(q, k, v)
    route = _route(q, route)
    if route == "wgmma":
        check_tma(q, k, v)
    # o is allocated (B, S, H, D) — the model's layout — and written
    # through strides; callers get the (B, H, S, D) view
    o = torch.empty((B, Sq, H, D), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, o)
                                      for s in t.stride()[:3]))
    lib = build.library()
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, k.shape[1], Sq, Sk, D, strides,
            1.0 / math.sqrt(D), int(causal), int(window), float(soft_cap))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "wgmma":
        build.check(lib.fa_fwd_sm90(*head, stream), "fa_fwd_sm90")
    else:
        build.check(lib.fa_fwd(*head, int(q.dtype == torch.bfloat16), stream),
                    "fa_fwd")
    flash_attention_fwd_bhsd.launches += 1
    flash_attention_fwd_bhsd.launches_by_route[route] += 1
    return o, lse


flash_attention_fwd_bhsd.launches = 0
flash_attention_fwd_bhsd.launches_by_route = dict.fromkeys(ROUTES, 0)


def flash_attention_bwd_bhsd_plain(q, k, v, o, lse, do, *, causal=True,
                                   window=0, block_q=128, block_k=128):
    """Plain version of ``flash_attention_bwd_bhsd``."""
    return ref_attention_bwd(q, k, v, o, lse, do, causal=causal,
                             window=window)


def _check_bwd(q, k, v, do, lse, delta):
    _check(q, k, v)
    B, H, Sq, D = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or do.stride(3) != 1:
        raise ValueError(f"flash attention bwd: do {tuple(do.shape)} "
                         f"{do.dtype} (want q's shape and dtype, D "
                         "contiguous)")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Sq) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash attention bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype} (want contiguous "
                             f"f32 ({B}, {H}, {Sq}))")


def _bwd_args(q, k, v, do, grads, causal, window):
    B, H, Sq, D = q.shape
    strides = (ctypes.c_int64 * 21)(
        *(s for t in (q, k, v, do, *grads) for s in t.stride()[:3]))
    return strides, (B, H, k.shape[1], Sq, k.shape[2], D), \
        (1.0 / math.sqrt(D), int(causal), int(window),
         int(q.dtype == torch.bfloat16),
         torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=True,
                           window=0, route=None):
    """K3a: dq (B,H,Sq,D) in q's dtype (a view of a (B,Sq,H,D) tensor).
    ``route`` as for ``flash_attention_fwd_bhsd``."""
    if q.device.type == "cpu":
        return ref_attention_bwd(q, k, v, None, lse, do, causal=causal,
                                 window=window, delta=delta)[0]
    _check_bwd(q, k, v, do, lse, delta)
    route = _route(q, route)
    if route == "wgmma":
        check_tma(q, k, v, do)
    B, H, Sq, D = q.shape
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    strides, dims, tail = _bwd_args(q, k, v, do, (dq, dq, dq), causal,
                                    window)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    lib = build.library()
    if route == "wgmma":   # tail = (scale, causal, window, is_bf16, stream)
        err = lib.fa_bwd_dq_sm90(*ptrs, *dims, strides, *tail[:3], tail[4])
        build.check(err, "fa_bwd_dq_sm90")
    else:
        build.check(lib.fa_bwd_dq(*ptrs, *dims, strides, *tail), "fa_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.launches_by_route[route] += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=True,
                            window=0, route=None):
    """K3b: (dk, dv), each (B,Hkv,Sk,D) in k's dtype (views of
    (B,Sk,Hkv,D) tensors), summed over each kv head's q heads.  ``route``
    as for ``flash_attention_fwd_bhsd``."""
    if q.device.type == "cpu":
        return ref_attention_bwd(q, k, v, None, lse, do, causal=causal,
                                 window=window, delta=delta)[1:]
    _check_bwd(q, k, v, do, lse, delta)
    route = _route(q, route)
    if route == "wgmma":
        check_tma(q, k, v, do)
    B, Hkv, Sk, D = k.shape
    dk, dv = (torch.empty((B, Sk, Hkv, D), dtype=k.dtype,
                          device=k.device).transpose(1, 2) for _ in range(2))
    strides, dims, tail = _bwd_args(q, k, v, do, (dk, dk, dv), causal,
                                    window)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    lib = build.library()
    if route == "wgmma":   # tail = (scale, causal, window, is_bf16, stream)
        err = lib.fa_bwd_dkv_sm90(*ptrs, *dims, strides, *tail[:3], tail[4])
        build.check(err, "fa_bwd_dkv_sm90")
    else:
        err = lib.fa_bwd_dkv(*ptrs, *dims, strides, *tail)
        build.check(err, "fa_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.launches_by_route[route] += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.launches_by_route = dict.fromkeys(ROUTES, 0)


def flash_attention_bwd_bhsd(q, k, v, o, lse, do, *, causal=True, window=0,
                             block_q=128, block_k=128):
    """-> (dq, dk, dv) shaped like (q, k, v).  ``delta = rowsum(do·o)`` in
    plain torch, then K3a and K3b (CUDA, by ``route_for``) or the plain
    version (CPU).  No soft cap: the reference's backward has none."""
    if all(t.device.type == "cpu" for t in (q, k, v, o, lse, do)):
        return flash_attention_bwd_bhsd_plain(q, k, v, o, lse, do,
                                              causal=causal, window=window)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                                window=window)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                                     window=window)
    return dq, dk, dv
