"""Unified relay executor — the one place that issues layer-relay copies
(the port of ``repro/core/relay.py``).

Every layer-major pass (prefill, serve decode; training's passes next) is
a per-layer ``body`` run under one schedule:

* **streams** — stacked ``(N, ...)`` trees (plain or ``packing.Packed``),
  relayed stop by stop onto the compute device;
* **layer groups** — G layers per stop (``layers_per_relay``); a depth not
  divisible by G leaves a short remainder stop, run after the full stops
  going forward and before them in reverse;
* **a prefetch ring** — k slots in flight (``prefetch_depth``): the copy
  for stop i+k (i-k in reverse) is issued before stop i computes; the edge
  stops re-fetch a clamped stop, as the reference does, and drop it.

On CUDA the copies run on a dedicated copy stream into a fixed ring of
k + 1 slot buffers per stream, allocated once per pass: fetch n fills
buffer n mod (k + 1) after waiting on the compute-stream event that
released it, and the compute stream waits on the fill's event before the
layers read it.  The buffers are marked with ``record_stream`` for the
compute stream, so the caching allocator does not hand their memory to a
later copy while a layer still reads it.  Device memory for weights is
thus exactly G·(1 + k) layer slots however far the host runs ahead (a
fresh allocation per fetch let the host queue ~10 slots: 12.2 GB
reserved for 2.55 GB allocated, chip_smoke.py on one H100 80GB HBM3 at
700 W).  A stream resting in pinned host memory is always fetched
through the relay-copy kernel (K4); a device-resident stream is
sliced as a view under ``transport="xla"`` and copied through K4 under
``"pallas"``, as the reference's transports do.  On the CPU "pallas"
runs K4's plain version and "xla" slices.  Every (G, k, pack, transport)
computes bit-identical results (tests/test_torch_serve.py).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from repro_torch.core.eps import Placement
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import relay_copy


class Stream(NamedTuple):
    """One stacked tree relayed by a ``relay_scan``."""
    placement: Placement
    stacked: Any                 # (N, ...) tree (possibly packing.Packed)


def _index(tree, j: int):
    return tree_map(lambda a: a[j], tree)


def _stack(ys_list):
    return tree_map(lambda *ls: torch.stack(ls), *ys_list)


def relay_scan(body: Callable, init, streams: Sequence[Stream], *,
               xs=None, reverse: bool = False, group: int = 1,
               prefetch: int = 0, transport: str = "xla", device="cpu",
               copy_stream=None, active: Optional[tuple] = None,
               idle_body: Optional[Callable] = None):
    """Run ``body(carry, slots, x) -> (carry, ys)`` once per layer.

    ``slots`` is a tuple of single-layer trees on ``device``, one per
    stream; ``x`` the layer's slice of ``xs`` (a view: a body may update
    it in place); ``ys`` per-layer outputs, stacked to ``(N, ...)`` in
    layer order (or None).  ``reverse=True`` walks layers N-1..0 and still
    stacks ``ys`` in forward order.  Returns ``(carry, ys)``.

    ``copy_stream`` is the CUDA stream the fetches run on; pass the same
    one to every pass (the caching allocator reuses a freed slot's memory
    only for later allocations on the stream it was allocated on).
    """
    assert active is None and idle_body is None, \
        "dynamic depth (active / idle_body) is not ported yet"
    streams = tuple(streams)
    assert streams, "relay_scan needs at least one stream"
    n = tree_leaves(streams[0].stacked)[0].shape[0]
    G = max(1, int(group))
    K = max(0, int(prefetch))
    S = n // G                    # full stops
    R = n - S * G                 # remainder stop (0 when G divides N)
    device = torch.device(device)
    if device.type == "cuda":
        compute = torch.cuda.current_stream(device)
        copier = copy_stream or torch.cuda.Stream(device)
        copier.wait_stream(compute)   # params written before the relay
    else:
        compute = copier = None

    squeeze = G == 1
    n_bufs = K + 1                # slot buffers per kernel-fetched stream
    bufs = [None] * n_bufs        # bufs[j][si]: stream si's G-layer slot
    freed = [None] * n_bufs       # compute event: buffer j read for good
    n_fetched = 0

    def kernel_fetched(s: Stream) -> bool:
        return transport == "pallas" or \
            tree_leaves(s.stacked)[0].device.type != device.type

    def fetch(start: int, size: int):
        """One copy per stream (per leaf or dtype segment) for a
        ``size``-layer slot.  On CUDA it runs on the copy stream into ring
        buffer n % (k+1), behind the compute event that released it."""
        nonlocal n_fetched
        j = n_fetched % n_bufs
        n_fetched += 1
        if copier is None:
            slots = tuple(
                relay_copy.fetch_slot(s.stacked, start, size, device=device)
                if kernel_fetched(s) else
                s.placement.dev(tree_map(lambda a: a[start:start + size],
                                         s.stacked))
                for s in streams)
            return slots, None, j
        with torch.cuda.stream(copier):
            if bufs[j] is None:
                bufs[j] = tuple(
                    tree_map(lambda a: torch.empty(
                        (G,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=device), s.stacked)
                    if kernel_fetched(s) else None for s in streams)
                for t in tree_leaves(bufs[j]):
                    t.record_stream(compute)
            if freed[j] is not None:
                copier.wait_event(freed[j])
            slots = tuple(
                relay_copy.fetch_slot(
                    s.stacked, start, size, device=device,
                    out=tree_map(lambda b: b[:size], buf))
                if buf is not None else
                s.placement.dev(tree_map(lambda a: a[start:start + size],
                                         s.stacked))
                for s, buf in zip(streams, bufs[j]))
        ready = torch.cuda.Event()
        ready.record(copier)
        return slots, ready, j

    def consume(fetched):
        slots, ready, _ = fetched
        if ready is not None:
            compute.wait_event(ready)
        return tuple(_index(t, 0) for t in slots) if squeeze else slots

    def release(fetched):
        """After the stop's layers are issued: its buffer may be refilled
        once the compute stream has run them."""
        if copier is not None:
            freed[fetched[2]] = torch.cuda.Event()
            freed[fetched[2]].record(compute)

    def run_stop(carry, slots, start: int, size: int):
        """Per-layer loop over one fetched G-layer slot."""
        ys = [None] * size
        order = range(size - 1, -1, -1) if reverse else range(size)
        for j in order:
            x_j = None if xs is None else _index(xs, start + j)
            carry, ys[j] = body(carry, tuple(_index(s, j) for s in slots),
                                x_j)
        return carry, (None if all(y is None for y in ys) else _stack(ys))

    def run(carry, i: int, fetched):
        slots = consume(fetched)
        if G == 1:
            out = body(carry, slots, None if xs is None else _index(xs, i))
        else:
            out = run_stop(carry, slots, i * G, G)
        release(fetched)
        return out

    def run_remainder(carry):
        fetched = fetch(S * G, R)
        out = run_stop(carry, consume(fetched), S * G, R)
        release(fetched)
        return out

    carry = init
    ys_main = [None] * S
    ys_rem = None
    if reverse and R:
        carry, ys_rem = run_remainder(carry)
    stops = range(S - 1, -1, -1) if reverse else range(S)
    if S and K == 0:
        for i in stops:
            carry, ys_main[i] = run(carry, i, fetch(i * G, G))
    elif S:
        first, step = (S - 1, -1) if reverse else (0, 1)
        pending = [fetch(min(max(first + step * d, 0), S - 1) * G, G)
                   for d in range(K)]
        for i in stops:
            nxt = max(i - K, 0) if reverse else min(i + K, S - 1)
            fetched = fetch(nxt * G, G)
            carry, ys_main[i] = run(carry, i, pending[0])
            pending = pending[1:] + [fetched]
    if not reverse and R:
        carry, ys_rem = run_remainder(carry)
    return carry, _combine_ys(ys_main, ys_rem, G)


def _combine_ys(ys_main, ys_rem, group: int):
    """Per-stop ys (+ the remainder's) -> one (N, ...) tree in layer order."""
    parts = [y for y in ys_main if y is not None]
    if group == 1:
        return _stack(parts) if parts else ys_rem
    if ys_rem is not None:
        parts.append(ys_rem)
    if not parts:
        return None
    return tree_map(lambda *ls: torch.cat(ls), *parts)
