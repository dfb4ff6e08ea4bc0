"""Pinned host memory by allocation kind, for measuring and testing K4 on
each (``chip_smoke.py``'s k4-sweep, ``tests/test_torch_relay_copy.py``):

* ``"pinned"`` — ``torch.empty(pin_memory=True)``, PyTorch's caching host
  allocator: what the relay's rows (the EPS, the sinks, the stash) use;
* ``"mapped"`` — ``cudaHostAlloc(Portable | Mapped)``;
* ``"write_combined"`` — ``cudaHostAlloc(Portable | Mapped |
  WriteCombined)``, pages the CPU maps write-combined;
* ``"huge_pages"`` — anonymous memory with ``MADV_HUGEPAGE``, page-locked
  by ``cudaHostRegister(Portable | Mapped)``.

The last three come from the kernel library's C entry points
(``csrc/relay_copy.cu``) through ctypes, wrapped in a CPU tensor
(``is_pinned()`` holds, so K4 takes it) that gives its memory back when
the last view of it dies.  None of them beat ``"pinned"`` on the card
(``relay_copy``'s source note), so the relay keeps PyTorch's allocator.
The CPU reads write-combined memory uncached: read such a buffer on the
card.
"""
from __future__ import annotations

import ctypes
import math
import mmap

import torch

from repro_torch.kernels import build

PORTABLE, MAPPED, WRITE_COMBINED = 1, 2, 4
KINDS = ("pinned", "mapped", "write_combined", "huge_pages")

_HUGE = 2 << 20               # a transparent huge page
_MADV_HUGEPAGE = 14
_live = {"blocks": 0, "bytes": 0}


def _cuda_alloc(flags):
    def alloc(nbytes: int):
        ptr = ctypes.c_void_p()
        build.check(build.library().rc_host_alloc(nbytes, flags,
                                                  ctypes.byref(ptr)),
                    "cudaHostAlloc")
        return ptr.value, None

    def free(ptr, _base, _nbytes):
        build.check(build.library().rc_host_free(ptr), "cudaFreeHost")
    return alloc, free


def _libc():
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_long)
    libc.munmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t)
    libc.madvise.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int)
    return libc


def _huge_alloc(nbytes: int):
    libc = _libc()
    total = nbytes + _HUGE
    base = libc.mmap(None, total, mmap.PROT_READ | mmap.PROT_WRITE,
                     mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS, -1, 0)
    if base in (None, ctypes.c_void_p(-1).value):
        raise MemoryError(f"mmap of {total} bytes failed")
    ptr = (base + _HUGE - 1) // _HUGE * _HUGE
    libc.madvise(ptr, nbytes, _MADV_HUGEPAGE)
    ctypes.memset(ptr, 0, nbytes)            # fault the pages in
    build.check(build.library().rc_host_register(ptr, nbytes,
                                                 PORTABLE | MAPPED),
                "cudaHostRegister")
    return ptr, base


def _huge_free(ptr, base, nbytes):
    build.check(build.library().rc_host_unregister(ptr), "cudaHostUnregister")
    _libc().munmap(base, nbytes + _HUGE)


_BACKENDS = {"mapped": _cuda_alloc(PORTABLE | MAPPED),
             "write_combined": _cuda_alloc(PORTABLE | MAPPED | WRITE_COMBINED),
             "huge_pages": (_huge_alloc, _huge_free)}


class _Block:
    """One allocation, owned by the ctypes array that the tensors from
    ``empty`` view (their storage keeps the array alive): freed, once the
    card is idle, when the last of them dies."""

    def __init__(self, ptr: int, base, nbytes: int, kind: str):
        self.ptr, self.base, self.nbytes, self.kind = ptr, base, nbytes, kind
        _live["blocks"] += 1
        _live["bytes"] += nbytes

    def __del__(self):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        _BACKENDS[self.kind][1](self.ptr, self.base, self.nbytes)
        _live["blocks"] -= 1
        _live["bytes"] -= self.nbytes


def empty(shape, dtype, kind: str = "pinned"):
    """An uninitialized CPU tensor of ``shape`` and ``dtype`` in pinned host
    memory of ``kind``."""
    if kind not in KINDS:
        raise ValueError(f"host_alloc: kind {kind!r} not in {KINDS}")
    shape = tuple(shape)
    numel = math.prod(shape)
    nbytes = numel * torch.empty((), dtype=dtype).element_size()
    if kind == "pinned" or nbytes == 0:
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    ptr, base = _BACKENDS[kind][0](nbytes)
    buf = (ctypes.c_uint8 * nbytes).from_address(ptr)
    buf.block = _Block(ptr, base, nbytes, kind)
    return torch.frombuffer(buf, dtype=dtype, count=numel).view(shape)


def live() -> dict:
    """Blocks and bytes that ``empty`` holds (``"pinned"`` excluded)."""
    return dict(_live)
