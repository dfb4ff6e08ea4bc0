"""K4, the relay copy: the slot mover of every relay stop.

Replaces ``_copy_kernel`` / ``copy_rows`` / ``fetch_slot`` of
``repro/kernels/relay_copy.py`` (a Pallas DMA pipeline paced by two
rotating semaphores).  The CUDA counterpart (``csrc/relay_copy.cu``) is a
copy kernel that reads the pinned host source through its mapped device
address over PCIe and writes the slot in HBM: TMA bulk copies through
shared memory for 16-byte-aligned chunks, a load/store loop for others.
One launch per chunk of the same chunk plan, on the caller's current
stream (the relay's copy stream), whose order stands in for the
semaphores.  Bound on an H100: a slot's bytes over PCIe 5.0 x16 (64 GB/s
each way); the card's SM-side reads of host memory stop near 28 GB/s,
below the copy engine's rate (see the source note).  The grid is
``BLOCKS_PER_SM`` blocks per SM: 2 to 8 copied at most 8% faster on the
card and would take more of the shared memory the layers need.

A pageable host source is not mapped into the card's address space, so a
host source that is not pinned raises.

The write-back direction (``writeback_rows`` / ``writeback_slot``, the
counterpart of the reference's ``writeback_slot``) moves a relay stop's
products (updated weights and Adam slots, shipped gradients, the boundary
stash) out of HBM into their row of a stacked ``(N, ...)`` buffer in
pinned host memory: the same kernel family with the mapped host row as
the destination, through the load/store loop (SM stores to host memory
are posted writes).  The chunk plan is the reference's for a product: the
whole leaf as one flat row, split in two halves.  Bound: the row's bytes
over PCIe 5.0 x16.  A device destination takes the same kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.tree import tree_map
from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_copy_rows as copy_rows_plain

__all__ = ["copy_rows", "copy_rows_plain", "fetch_slot", "writeback_rows",
           "writeback_rows_plain", "writeback_slot", "_chunk_plan"]


def _chunk_plan(size: int, width: int) -> tuple:
    """Static (row, col_lo, col_hi) chunks for a (size, width) slot: one
    per stacked row; a single-row slot splits into two half rows (the
    reference's plan, so the TPU's two semaphores have two DMAs to rotate
    through).  Each chunk is one launch of the copy kernel."""
    if size >= 2 or width < 2:
        return tuple((r, 0, width) for r in range(size))
    h = width // 2
    return ((0, 0, h), (0, h, width))


BLOCKS_PER_SM = 1


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def copy_rows(src, start: int, *, size: int, device=None, out=None,
              blocks=None, bulk=True):
    """Rows ``[start, start+size)`` of a stacked ``(N, W)`` buffer, moved
    into a ``(size, W)`` tensor on ``device`` (default: the source's):
    ``out`` when given (the relay's ring slots), else a new one.
    Bit-exact.  CPU -> CPU runs the plain version; a CUDA destination
    launches K4 on the current stream, from pinned host or device memory,
    with a grid of ``blocks`` (default ``BLOCKS_PER_SM`` per SM); ``bulk``
    False moves aligned chunks with the load/store loop instead of the
    TMA (for comparing the two)."""
    dev = src.device if device is None else torch.device(device)
    if out is not None:
        dev = out.device
    if dev.type == "cpu" and src.device.type == "cpu":
        got = copy_rows_plain(src, start, size)
        return got if out is None else out.copy_(got)
    if dev.type != "cuda":
        raise ValueError(f"copy_rows: destination {dev} is not a CUDA device")
    if src.dim() != 2 or not src.is_contiguous():
        raise ValueError("copy_rows: source must be a contiguous (N, W) buffer")
    if src.device.type == "cpu":
        if not src.is_pinned():
            raise ValueError("copy_rows: host source must be pinned "
                             "(pageable memory is not mapped on the card)")
    elif src.device != dev:
        raise ValueError(f"copy_rows: source on {src.device}, "
                         f"destination {dev}")
    n, w = src.shape
    if not (0 <= start and start + size <= n and size >= 1):
        raise ValueError(f"copy_rows: rows [{start}, {start + size}) "
                         f"outside 0..{n}")
    if out is None:
        dst = torch.empty((size, w), dtype=src.dtype, device=dev)
    elif out.shape != (size, w) or out.dtype != src.dtype \
            or not out.is_contiguous():
        raise ValueError(f"copy_rows: out {tuple(out.shape)} {out.dtype}, "
                         f"want contiguous ({size}, {w}) {src.dtype}")
    else:
        dst = out
    es = src.element_size()
    plan = [v for r, lo, hi in _chunk_plan(size, w)
            for v in (r, lo * es, hi * es)]          # columns in bytes
    chunks = (ctypes.c_int64 * len(plan))(*plan)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if blocks is None:
        blocks = BLOCKS_PER_SM * _sm_count(index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.library().rc_copy_rows(
        src.data_ptr(), dst.data_ptr(), start, 0, w * es, chunks,
        len(plan) // 3, int(blocks), int(bulk), stream)
    build.check(err, "rc_copy_rows")
    copy_rows.launches += 1
    copy_rows.bytes += size * w * es
    return dst


copy_rows.launches = 0
copy_rows.bytes = 0          # bytes moved by the launches counted


def _flat_width(shape) -> int:
    w = 1
    for d in shape[1:]:
        w *= d
    return w


def fetch_slot(stacked, start: int, size: int, *, squeeze: bool = False,
               device=None, out=None):
    """Stream-in of one relay stop: ``size`` stacked rows of every leaf of
    a ``(N, ...)`` tree (plain tree or ``packing.Packed``), each moved by
    ``copy_rows`` — into ``out`` (a same-structured tree of ``(size, ...)``
    slots) when given.  ``squeeze`` drops the leading axis for the G=1
    slot.  Degenerate leaves (empty rows) are sliced: nothing to copy."""
    def one(a, dst=None):
        w = _flat_width(a.shape)
        if a.shape[0] == 0 or w == 0:
            got = a[start:start + size].to(device or a.device)
        else:
            got = copy_rows(a.reshape(a.shape[0], w), start, size=size,
                            device=device,
                            out=None if dst is None else dst.view(size, w))
            got = got.view((size,) + tuple(a.shape[1:]))
        return got[0] if squeeze else got
    if out is None:
        return tree_map(one, stacked)
    return tree_map(one, stacked, out)


def writeback_rows_plain(src, dst, row: int):
    """Plain version of ``writeback_rows``: ``dst[row] = src``."""
    dst[row].copy_(src)
    return dst


def writeback_rows(src, dst, row: int, *, blocks=None):
    """Write one layer's product ``src`` (a contiguous tensor) into row
    ``row`` of the stacked buffer ``dst`` (``(N,) + src.shape``, same
    dtype), bit-exact.  CPU -> CPU runs the plain version; a CUDA source
    launches K4's write-back on the current stream (the relay's copy
    stream), into pinned host memory or device memory.  Returns ``dst``."""
    if src.device.type == "cpu" and dst.device.type == "cpu":
        return writeback_rows_plain(src, dst, row)
    if src.device.type != "cuda":
        raise ValueError(f"writeback_rows: source on {src.device}, "
                         "not a CUDA device")
    if dst.device.type == "cpu":
        if not dst.is_pinned():
            raise ValueError("writeback_rows: host destination must be "
                             "pinned (pageable memory is not mapped on "
                             "the card)")
    elif dst.device != src.device:
        raise ValueError(f"writeback_rows: source on {src.device}, "
                         f"destination {dst.device}")
    if dst.dtype != src.dtype or tuple(dst.shape[1:]) != tuple(src.shape) \
            or not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError(f"writeback_rows: src {tuple(src.shape)} "
                         f"{src.dtype} into dst {tuple(dst.shape)} "
                         f"{dst.dtype} (both contiguous)")
    if not 0 <= row < dst.shape[0]:
        raise ValueError(f"writeback_rows: row {row} outside "
                         f"0..{dst.shape[0]}")
    w = src.numel()
    if w == 0:
        return dst
    es = src.element_size()
    plan = [v for r, lo, hi in _chunk_plan(1, w)
            for v in (r, lo * es, hi * es)]
    chunks = (ctypes.c_int64 * len(plan))(*plan)
    index = src.device.index if src.device.index is not None \
        else torch.cuda.current_device()
    if blocks is None:
        blocks = BLOCKS_PER_SM * _sm_count(index)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = build.library().rc_copy_rows(
        src.data_ptr(), dst.data_ptr(), 0, row, w * es, chunks,
        len(plan) // 3, int(blocks), 0, stream)
    build.check(err, "rc_copy_rows (write-back)")
    writeback_rows.launches += 1
    writeback_rows.bytes += w * es
    return dst


writeback_rows.launches = 0
writeback_rows.bytes = 0


def writeback_slot(tree, *, out, row: int):
    """Write-back of one relay stop's products: every leaf of ``tree``
    (one layer's tensors; a plain tree or ``packing.Packed``) into row
    ``row`` of the same-structured stacked tree ``out``, each moved by
    ``writeback_rows``.  Returns ``out``."""
    tree_map(lambda a, d: writeback_rows(a, d, row), tree, out)
    return out
