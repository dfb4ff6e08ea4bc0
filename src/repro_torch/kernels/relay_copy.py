"""K4, the relay copy: the slot mover of every relay stop.

Replaces ``_copy_kernel`` / ``copy_rows`` / ``fetch_slot`` /
``writeback_slot`` of ``repro/kernels/relay_copy.py`` (a Pallas DMA
pipeline paced by two rotating semaphores).  The CUDA counterpart
(``csrc/relay_copy.cu``) is a copy kernel that reads or writes pinned host
memory through its mapped device address over PCIe, with HBM on the other
side.  The reference's chunk plan becomes byte spans (``_spans``), each
one launch on the caller's current stream (the relay's copy stream),
whose order stands in for the semaphores.

Bound: the slot's bytes over PCIe 5.0 x16, 64 GB/s each way.  What holds
SM-side reads of host memory below it is a budget of reads in flight on
the host's side, not the kernel (``chip_smoke.py``'s k4-sweep on one
H100, 700 W, on two hosts).  On the first, every design reads pinned
memory at 26-28 GB/s against ``copy_``'s 45: TMA tiles of 4, 16 or 64 KB,
16-byte loads in whole 128-byte lines (plain, or with a 128- or 256-byte
L2 prefetch), tiles interleaved over the grid or one contiguous run per
block, 4 to 132 blocks, and on every allocation kind of
``kernels.host_alloc``.  One
dependent read takes 1.34 µs (1.49 µs from write-combined memory), and
rate x round trip is ~36 KiB on both: write-combined memory reads no
faster.  On the second the same designs read at 49-51 GB/s, 0.9x
``copy_``: 64 KiB in flight at 1.31 µs.  Either way 4 blocks reach the
rate and 1 or 2 do not.  SM stores are posted writes: 50-52 GB/s from 2
blocks on, whatever the design, 1.0-1.06x ``copy_``'s time.

So the design keeps the rate and gives the SMs back: both directions take
the line loop (``ROUTES["lines"]``) on ``LINE_BLOCKS`` blocks, the plan's
adjacent chunks merged into one span and a chunk's head and tail short of
a 128-byte line of host memory peeled off into their own launches.  A
2048-token granite prefill layer beside such a fetch runs far closer to
its time alone than beside the TMA kernel over every SM (the layer line
of ``chip_smoke.py``, in ``PERF.md``).  And on 8 blocks each, a fetch
and write-backs run together on two streams add up in part (22 + 43 GB/s
against 27 and 49 alone on the first host, 31 + 48 against 51 and 51 on
the second), where the kernels over every SM did not (22 + 18): the relay
runs its write-backs on a stream of their own (``core.relay``).  Those
kernels (TMA tiles over every SM for the fetch, the word loop over every
SM for the write-back) stay reachable as ``route="tma_tiles"`` and
``route="words"`` for timing only.

A pageable host buffer is not mapped into the card's address space, so a
host side that is not pinned raises.  The write-back direction
(``writeback_rows`` / ``writeback_slot``) moves a relay stop's products
(updated weights and Adam slots, shipped gradients, the boundary stash)
out of HBM into their row of a stacked ``(N, ...)`` buffer in pinned host
memory; its chunk plan is the reference's for a product, the whole leaf
as one flat row split in two halves.  A device destination takes the same
kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.tree import tree_map
from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_copy_rows as copy_rows_plain

__all__ = ["copy_rows", "copy_rows_plain", "fetch_slot", "writeback_rows",
           "writeback_rows_plain", "writeback_slot", "Route", "ROUTES",
           "FETCH_ROUTE", "WRITEBACK_ROUTE", "LINE_BLOCKS", "_chunk_plan",
           "_spans"]

LINE = 128                    # bytes in a cache line / PCIe request


def _chunk_plan(size: int, width: int) -> tuple:
    """Static (row, col_lo, col_hi) chunks for a (size, width) slot: one
    per stacked row; a single-row slot splits into two half rows (the
    reference's plan, so the TPU's two semaphores have two DMAs to rotate
    through)."""
    if size >= 2 or width < 2:
        return tuple((r, 0, width) for r in range(size))
    h = width // 2
    return ((0, 0, h), (0, h, width))


class Route(NamedTuple):
    """How K4 moves a span: ``method`` "words" (16-byte load/store loop,
    one word per thread per step over the whole grid), "tma" (cp.async.bulk
    tiles of ``tile`` bytes through shared memory, ``stages`` in flight per
    block), "lines" / "lines128" / "lines256" (16-byte words in whole
    128-byte lines, plain loads or non-coherent loads with a 128- or
    256-byte L2 prefetch); ``blocks`` (0: one per SM); ``span`` gives each
    block one contiguous run of tiles (else tile k of a block is block + k
    * grid); ``lines`` merges the plan's adjacent chunks and splits them at
    the 128-byte lines of host memory (``_spans``), else each chunk is one
    launch."""
    method: str
    tile: int = 16384
    stages: int = 4
    blocks: int = 0
    span: bool = False
    lines: bool = False


_METHODS = {"words": 0, "tma": 1, "lines": 2, "lines128": 3, "lines256": 4}

# the k4-sweep's grid: 4 blocks reach the read rate on both hosts (1 reads
# 16-17 GB/s, 2 26-29), 8 keep a margin; the copy holds 8 of 132 SMs
LINE_BLOCKS = 8

ROUTES = {
    "lines": Route("lines", blocks=LINE_BLOCKS, lines=True),
    # the kernels K4 took before: TMA bulk copies of 16 KB tiles
    # interleaved over one block per SM (fetch), the 16-byte word loop
    # over one block per SM (write-back); one launch per chunk of the plan
    "tma_tiles": Route("tma"),
    "words": Route("words"),
}
FETCH_ROUTE = WRITEBACK_ROUTE = "lines"


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _spans(plan, es: int, row_bytes: int, src_row0: int, dst_row0: int, *,
           src_addr: int = 0, dst_addr: int = 0, host_is_src: bool = True,
           lines: bool = False) -> list:
    """Byte spans ``(src_offset, dst_offset, bytes)`` of a chunk plan
    (``(row, col_lo, col_hi)`` in elements of ``es`` bytes) between rows
    ``src_row0 + row`` of the source and ``dst_row0 + row`` of the
    destination, both ``row_bytes`` apart: one per chunk, or with
    ``lines`` a chunk joined to the span before it when both sides continue
    it, and a span whose two sides agree modulo 16 bytes split at the
    128-byte lines of the host side (the source's address ``src_addr``
    when ``host_is_src``, else ``dst_addr``): a head up to the first line
    boundary, a body of whole lines, a tail.  Every byte of the plan lies
    in exactly one span."""
    out = []
    for r, lo, hi in plan:
        s = (src_row0 + r) * row_bytes + lo * es
        d = (dst_row0 + r) * row_bytes + lo * es
        n = (hi - lo) * es
        if n <= 0:
            continue
        if lines and out and out[-1][0] + out[-1][2] == s \
                and out[-1][1] + out[-1][2] == d:
            out[-1] = (out[-1][0], out[-1][1], out[-1][2] + n)
        else:
            out.append((s, d, n))
    if not lines:
        return out
    split = []
    for s, d, n in out:
        if (src_addr + s - dst_addr - d) % 16:
            split.append((s, d, n))
            continue
        head = min(n, -((src_addr + s) if host_is_src else (dst_addr + d))
                   % LINE)
        body = (n - head) // LINE * LINE
        for off, m in ((0, head), (head, body), (head + body,
                                                 n - head - body)):
            if m:
                split.append((s + off, d + off, m))
    return split


def _route(route) -> Route:
    return ROUTES[route] if isinstance(route, str) else route


def _launch(src, dst, spans, route: Route, index: int, stream) -> None:
    flat = [v for sp in spans for v in sp]
    arr = (ctypes.c_int64 * max(1, len(flat)))(*flat)
    blocks = route.blocks or _sm_count(index)
    err = build.library().rc_copy_spans(
        src.data_ptr(), dst.data_ptr(), arr, len(spans),
        _METHODS[route.method], route.tile, route.stages, int(blocks),
        int(route.span), stream.cuda_stream)
    build.check(err, "rc_copy_spans")


def _count(fn, route, nbytes: int) -> None:
    fn.launches += 1
    fn.bytes += nbytes
    if isinstance(route, str):             # by name: a Route is a measurement
        fn.launches_by_route[route] += 1


def copy_rows(src, start: int, *, size: int, device=None, out=None,
              route=None):
    """Rows ``[start, start+size)`` of a stacked ``(N, W)`` buffer, moved
    into a ``(size, W)`` tensor on ``device`` (default: the source's):
    ``out`` when given (the relay's ring slots), else a new one.
    Bit-exact.  CPU -> CPU runs the plain version; a CUDA destination
    launches K4 on the current stream, from pinned host or device memory,
    by ``route`` (a name in ``ROUTES`` or a ``Route``; default
    ``FETCH_ROUTE``)."""
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
    route = FETCH_ROUTE if route is None else route
    r = _route(route)
    es = src.element_size()
    spans = _spans(_chunk_plan(size, w), es, w * es, start, 0,
                   src_addr=src.data_ptr(), dst_addr=dst.data_ptr(),
                   host_is_src=True, lines=r.lines)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev)
    _launch(src, dst, spans, r, index, stream)
    _count(copy_rows, route, size * w * es)
    return dst


copy_rows.launches = 0
copy_rows.bytes = 0          # bytes moved by the launches counted
copy_rows.launches_by_route = {name: 0 for name in ROUTES}


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


def writeback_rows(src, dst, row: int, *, route=None):
    """Write one layer's product ``src`` (a contiguous tensor) into row
    ``row`` of the stacked buffer ``dst`` (``(N,) + src.shape``, same
    dtype), bit-exact.  CPU -> CPU runs the plain version; a CUDA source
    launches K4's write-back on the current stream (the relay's copy
    stream), into pinned host memory or device memory, by ``route``
    (default ``WRITEBACK_ROUTE``).  Returns ``dst``."""
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
    route = WRITEBACK_ROUTE if route is None else route
    r = _route(route)
    es = src.element_size()
    spans = _spans(_chunk_plan(1, w), es, w * es, 0, row,
                   src_addr=src.data_ptr(), dst_addr=dst.data_ptr(),
                   host_is_src=False, lines=r.lines)
    index = src.device.index if src.device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(src.device)
    _launch(src, dst, spans, r, index, stream)
    _count(writeback_rows, route, w * es)
    return dst


writeback_rows.launches = 0
writeback_rows.bytes = 0
writeback_rows.launches_by_route = {name: 0 for name in ROUTES}


def writeback_slot(tree, *, out, row: int):
    """Write-back of one relay stop's products: every leaf of ``tree``
    (one layer's tensors; a plain tree or ``packing.Packed``) into row
    ``row`` of the same-structured stacked tree ``out``, each moved by
    ``writeback_rows``.  Returns ``out``."""
    tree_map(lambda a, d: writeback_rows(a, d, row), tree, out)
    return out
