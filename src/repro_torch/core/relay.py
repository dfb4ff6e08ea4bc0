"""Unified relay executor — the one place that issues layer-relay copies
(the port of ``repro/core/relay.py``).

Every layer-major pass (prefill, serve decode, training's forward,
backward and trailing update) is a per-layer ``body`` run under one
schedule:

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
computes bit-identical results (tests/test_torch_serve.py,
tests/test_torch_train.py).

The host is held at most two stops ahead of the device: before it issues
a fetch it waits until the compute stream has run the stop before the
one it last issued (the device still has that last stop queued, so it
does not idle while the host issues the next).  Without that bound nothing stops the host from issuing the whole
pass at once, and every product still waiting for its write-back (below)
would hold its device memory meanwhile: device memory would grow with
depth.

**Per-layer inputs (``xs``)**, e.g. the boundary stash of the backward,
are a stacked ``(N, ...)`` tree fetched one stop at a time with the
weights: a tree resting in pinned host memory is copied by K4 into its
own ring of k + 1 slot buffers on the copy stream (the reference moves it
with ``device_put``); a device-resident tree is sliced as views (a body
may update them in place: the decode caches).

**Products that go back to the EPS (``sinks``).**  A training body
returns per-layer products (the stash, updated weights and optimizer
slots, shipped gradients); each goes to a ``Sink``, an ``(N, ...)`` tree
in its placement's resting place, and layer i's product is written into
row i as soon as it is made: through K4's write-back
(``relay_copy.writeback_slot``) into pinned host memory, or into a
device buffer (K4 under ``transport="pallas"``, ``copy_`` under "xla").
So host-placed products never gather on the device.  Ordering: the
write-backs run on the engine's write-back stream, beside the fetches on
its copy stream, so the link carries both directions at once (the rates
are in ``relay_copy``'s source note).  Each write-back waits on an event
of the compute stream that
made the product, and the product is marked with ``record_stream`` for
the write-back stream so its memory is not reused before the write has
read it.  Each fetch first makes the copy stream wait for every
write-back issued so far, which puts each row's write-back before any
later fetch of that row, in the same step (the backward reading the
forward's stash, the trailing update reading the shipped gradients) and
in the next step's forward.  A write-back into a pinned block that an
earlier fetch still reads cannot happen either: every product's compute
waited on a fetch of its own pass, behind all earlier fetches on the
copy stream (and the engine joins both streams at the end of a step).
A host reader of a sink synchronizes first.

**Dynamic depth (``active``).**  ``active=(lo, hi)`` runs ``body`` on the
rows inside the window and ``idle_body`` on the rows outside it, as the
reference's gate does.  The reference fetches and re-ships idle rows
because one traced program has fixed shapes; here the relay is eager, so
a stop wholly outside the window is neither fetched nor written back,
and the prefetch ring runs over the window's stops only (in reverse the
first stop is the one that holds row hi - 1).  A G-layer stop that
straddles the window is fetched whole and runs its idle rows one by one.
An idle row writes no sink row: the caller owns those rows (carried over
from its inputs, or zeros).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from repro_torch.core.eps import Placement, pinned_empty
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import relay_copy


class Stream(NamedTuple):
    """One stacked tree relayed by a ``relay_scan``."""
    placement: Placement
    stacked: Any                 # (N, ...) tree (possibly packing.Packed)


class Sink:
    """Where one per-layer product of a relay rests: an ``(n, ...)`` tree
    (plain or ``packing.Packed``) allocated at the first write in the
    placement's resting place (pinned host memory when the placement is
    enabled on CUDA, else the product's device) and filled row by row.
    ``tree`` is the result."""

    def __init__(self, placement: Placement, n: int, *, transport="xla",
                 stream=None):
        self.placement = placement
        self.n = n
        self.transport = transport
        self.stream = stream          # the CUDA stream the write-backs run on
        self.tree = None

    def write(self, row: int, tree) -> None:
        """Row ``row`` <- ``tree`` (one layer's product)."""
        tree = tree_map(lambda a: a.contiguous(), tree)
        leaves = tree_leaves(tree)
        if not leaves:            # a stateless optimizer's empty slots
            self.tree = tree
            return
        on_cuda = leaves[0].device.type == "cuda"
        host = on_cuda and self.placement.enabled
        if self.tree is None:
            self.tree = tree_map(
                lambda a: pinned_empty((self.n,) + tuple(a.shape), a.dtype,
                                       self.placement.owned) if host else
                torch.empty((self.n,) + tuple(a.shape), dtype=a.dtype,
                            device=a.device), tree)
        if not on_cuda:
            relay_copy.writeback_slot(tree, out=self.tree, row=row)
            return
        writer = self.stream
        compute = torch.cuda.current_stream(leaves[0].device)
        made = torch.cuda.Event()
        made.record(compute)
        with torch.cuda.stream(writer):
            writer.wait_event(made)
            if host or self.transport == "pallas":
                relay_copy.writeback_slot(tree, out=self.tree, row=row)
            else:
                tree_map(lambda a, d: d[row].copy_(a), tree, self.tree)
        for a in leaves:
            a.record_stream(writer)


def n_stops(n_layers: int, group: int) -> int:
    """Relay stops one pass makes over ``n_layers`` (ceil division)."""
    g = max(1, group)
    return -(-n_layers // g)


def stop_bounds(n_layers: int, group: int, start: int = 0) -> tuple:
    """``(lo, hi)`` layer ranges of each relay stop over ``n_layers``
    layers beginning at ``start``: G full stops plus the short remainder,
    ``n_stops(n_layers, group)`` entries.  The chunk schedule the disk
    tier's read ring shares with the relay (``core.tierstore``): one
    contiguous read per stop."""
    g = max(1, group)
    return tuple((start + lo, start + min(lo + g, n_layers))
                 for lo in range(0, n_layers, g))


def depth_window(dyn: bool, n_active, capacity: int):
    """The relay window ``(0, n_active)`` of a dynamic-depth call (None
    without ``dynamic_depth``), with the reference's asserts."""
    if not dyn:
        assert n_active is None, \
            "n_active needs ExecutionConfig.dynamic_depth"
        return None
    assert n_active is not None, \
        "dynamic_depth: the call takes the run depth n_active"
    n = int(n_active)
    assert 0 <= n <= capacity, f"n_active {n} outside 0..{capacity}"
    return (0, n)


def _index(tree, j: int):
    return tree_map(lambda a: a[j], tree)


def _rows(tree, start: int, size: int):
    return tree_map(lambda a: a[start:start + size], tree)


def relay_scan(body: Callable, init, streams: Sequence[Stream], *,
               xs=None, sinks: Sequence[Sink] = (), sink_row0: int = 0,
               reverse: bool = False, group: int = 1, prefetch: int = 0,
               transport: str = "xla", device="cpu", copy_stream=None,
               writeback_stream=None, active: Optional[tuple] = None,
               idle_body: Optional[Callable] = None):
    """Run ``body(carry, slots, x) -> (carry, ys)`` once per layer.

    ``slots`` is a tuple of single-layer trees on ``device``, one per
    stream; ``x`` the layer's slice of ``xs`` (or None); ``ys`` None, or a
    tuple with one product per sink, written into row ``sink_row0 + i`` of
    that sink for layer i.  ``reverse=True`` walks layers N-1..0.
    Returns ``(carry, tuple(sink.tree for sink in sinks) or None)``.

    ``copy_stream`` is the CUDA stream the fetches run on, and
    ``writeback_stream`` the one the sinks' write-backs run on (default:
    the copy stream); pass the engine's streams to every pass (the caching
    allocator reuses a freed slot's memory only for later allocations on
    the stream it was allocated on).  Every fetch waits for the
    write-backs issued before it.

    ``active=(lo, hi)`` (ints, local rows) gates the layers: rows outside
    the window run ``idle_body(carry, slots, x) -> (carry, ys)`` (default:
    the carry passes through, no product); ``slots`` and ``x`` are None
    for a row whose stop lies wholly outside the window and is not
    fetched.
    """
    streams = tuple(streams)
    sinks = tuple(sinks)
    assert streams, "relay_scan needs at least one stream"
    n = tree_leaves(streams[0].stacked)[0].shape[0]
    G = max(1, int(group))
    K = max(0, int(prefetch))
    S = n // G                    # full stops
    R = n - S * G                 # remainder stop (0 when G divides N)
    lo, hi = (0, n) if active is None else (max(0, int(active[0])),
                                            min(n, int(active[1])))
    idle_body = idle_body or _pass_through
    # the rows [f_lo, f_hi) of the stops the window reaches: its full
    # stops [s_lo, s_hi), and the remainder stop when rem_on; the rows
    # outside are neither fetched nor run
    f_lo, f_hi = ((min(lo // G * G, S * G), n if hi > S * G
                   else -(-hi // G) * G) if lo < hi else (0, 0))
    s_lo, s_hi = f_lo // G, min(f_hi, S * G) // G
    rem_on = f_hi > S * G
    device = torch.device(device)
    if device.type == "cuda":
        compute = torch.cuda.current_stream(device)
        copier = copy_stream or torch.cuda.Stream(device)
        copier.wait_stream(compute)   # params written before the relay
    else:
        compute = copier = None
    host_xs = (copier is not None and xs is not None
               and tree_leaves(xs)[0].device.type == "cpu")

    n_bufs = K + 1                # slot buffers per kernel-fetched stream
    bufs = [None] * n_bufs        # bufs[j]: (per-stream slot, xs slot)
    freed = [None] * n_bufs       # compute event: buffer j read for good
    released = []                 # compute events of the stops run so far
    n_fetched = 0

    def kernel_fetched(s: Stream) -> bool:
        leaves = tree_leaves(s.stacked)
        return transport == "pallas" or not leaves or \
            leaves[0].device.type != device.type

    def fetch(start: int, size: int):
        """One copy per stream (per leaf or dtype segment) for a
        ``size``-layer slot, plus the stop's rows of ``xs``.  On CUDA it
        runs on the copy stream into ring buffer n % (k+1), behind the
        compute event that released it."""
        nonlocal n_fetched
        j = n_fetched % n_bufs
        n_fetched += 1
        if copier is None:
            slots = tuple(
                relay_copy.fetch_slot(s.stacked, start, size, device=device)
                if kernel_fetched(s) else
                s.placement.dev(_rows(s.stacked, start, size))
                for s in streams)
            x = None if xs is None else _rows(xs, start, size)
            return slots, x, None, j
        if len(released) >= 2:
            released[-2].synchronize()
        if writeback_stream is not None and writeback_stream != copier:
            copier.wait_stream(writeback_stream)
        with torch.cuda.stream(copier):
            if bufs[j] is None:
                alloc = lambda a: torch.empty(
                    (G,) + tuple(a.shape[1:]), dtype=a.dtype, device=device)
                bufs[j] = (tuple(tree_map(alloc, s.stacked)
                                 if kernel_fetched(s) else None
                                 for s in streams),
                           tree_map(alloc, xs) if host_xs else None)
                for t in tree_leaves(bufs[j]):
                    t.record_stream(compute)
            if freed[j] is not None:
                copier.wait_event(freed[j])
            sbufs, xbuf = bufs[j]
            slots = tuple(
                relay_copy.fetch_slot(
                    s.stacked, start, size, device=device,
                    out=tree_map(lambda b: b[:size], buf))
                if buf is not None else
                s.placement.dev(_rows(s.stacked, start, size))
                for s, buf in zip(streams, sbufs))
            if xs is None:
                x = None
            elif host_xs:
                x = relay_copy.fetch_slot(
                    xs, start, size, device=device,
                    out=tree_map(lambda b: b[:size], xbuf))
            else:
                x = _rows(xs, start, size)
        ready = torch.cuda.Event()
        ready.record(copier)
        return slots, x, ready, j

    def run_stop(carry, fetched, start: int, size: int):
        """Per-layer loop over one fetched ``size``-layer slot; each
        layer's products go to their sinks."""
        slots, x, ready, j = fetched
        if ready is not None:
            compute.wait_event(ready)
        order = range(size - 1, -1, -1) if reverse else range(size)
        for l in order:
            fn = body if lo <= start + l < hi else idle_body
            carry, ys = fn(carry, tuple(_index(s, l) for s in slots),
                           None if x is None else _index(x, l))
            if ys is not None:
                assert len(ys) == len(sinks), \
                    f"body returned {len(ys)} products for {len(sinks)} sinks"
                for sink, y in zip(sinks, ys):
                    sink.write(sink_row0 + start + l, y)
        if copier is not None:
            # the stop's layers are issued: its buffer may be refilled
            # once the compute stream has run them
            freed[j] = torch.cuda.Event()
            freed[j].record(compute)
            released.append(freed[j])
            del released[:-2]
        return carry

    def skip(carry, rows):
        """Idle rows of stops the window does not reach: nothing fetched."""
        for _ in rows:
            carry, ys = idle_body(carry, None, None)
            assert ys is None, "an unfetched idle row has no product"
        return carry

    def clamp(i):
        return min(max(i, s_lo), s_hi - 1)

    carry = skip(init, range(f_hi, n) if reverse else range(f_lo))
    if reverse and rem_on:
        carry = run_stop(carry, fetch(S * G, R), S * G, R)
    stops = range(s_hi - 1, s_lo - 1, -1) if reverse else range(s_lo, s_hi)
    if stops and K == 0:
        for i in stops:
            carry = run_stop(carry, fetch(i * G, G), i * G, G)
    elif stops:
        step = -1 if reverse else 1
        pending = [fetch(clamp(stops[0] + step * d) * G, G)
                   for d in range(K)]
        for i in stops:
            fetched = fetch(clamp(i + step * K) * G, G)
            carry = run_stop(carry, pending[0], i * G, G)
            pending = pending[1:] + [fetched]
    if not reverse and rem_on:
        carry = run_stop(carry, fetch(S * G, R), S * G, R)
    carry = skip(carry, range(f_lo) if reverse else range(f_hi, n))
    return carry, (tuple(s.tree for s in sinks) if sinks else None)


def _pass_through(carry, slots, x):
    return carry, None
