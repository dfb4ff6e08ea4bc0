"""The optimizer on the host (``ExecutionConfig.host_optimizer``): the EPS
applies each layer's update to its own rows, the paper's CPU optimizer
(the port of the reference's ``compute_on("device_host")`` update,
``repro/core/l2l.py:192-200``).

Under Algorithm 4 (L2L-p) the reverse relay fetches only the weights.
The device computes a layer's gradient (scaled, clipped, its finiteness
flag) and K4 writes it back, with the flag, into one row of a small ring
of pinned gradient rows on the write-back stream; an event marks the
write.  One worker thread waits on that event, runs the optimizer's
per-leaf ``update`` on CPU views of the layer's pinned rows (weights,
slots, the gradient row) and writes the new weights and slots into the
step's output rows, while the main thread issues the backward of the
next layer.  A ring row is written again only after the worker has
finished reading it.  Under Algorithm 3 the gradients are already in a
host sink when the backward ends, and ``update_rows`` runs the same
update over them: nothing is fetched and nothing written back.  On a
data mesh each gradient row is the global one when it reaches the ring
(``core.l2l`` sums it over the ranks on the device before its
write-back), so every rank's host update is the same.

Ordering rules: the CPU reads a row that a kernel wrote only after that
row's event (K4 writes through the SMs, so only the event orders it); it
writes only into rows its caller allocated where no kernel reads them
(``core.l2l`` allocates the step's output rows just after a synchronize).

The update is the per-leaf chain on zero-copy views of packed rows (K1
is not on this path), the same ops in the same order as on the card, so
the two agree bit for bit.  On the CPU device the same thread and ring
run with no events, so the CPU tests exercise the ordering code.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import torch

from repro_torch.core import packing
from repro_torch.core.tree import tree_leaves, tree_map


def _row(tree, i: int):
    return tree_map(lambda a: a[i], tree)


class HostOptimizer:
    """One step's host-side updates of a layer group.

    ``update(grads, slots, params, step)`` is the optimizer's per-leaf
    update; ``w`` / ``o`` the group's input rows and ``new_w`` / ``new_o``
    the step's output rows, all on the host (``packing.Packed`` rows when
    ``packed``).  With ``amp`` a layer whose flag is 0 keeps its rows.

    ``ring`` (a ``relay.Sink`` of a few rows, shaped like one layer's
    ``(gradient, flag)``) makes the object a relay sink: ``write(l, (dw,
    flag))`` hands layer l to the worker thread.  ``join()`` waits for
    every update and raises the first error a worker met."""

    def __init__(self, update: Callable, w, o, new_w, new_o, step: int, *,
                 packed: bool, amp: bool, ring=None):
        self.update = update
        self.w, self.o, self.new_w, self.new_o = w, o, new_w, new_o
        self.step = step
        self.packed = packed
        self.amp = amp
        self.ring = ring
        self.pending = [None] * (ring.n if ring is not None else 0)
        self.n_written = 0
        self.pool = ThreadPoolExecutor(1, thread_name_prefix="eps-optimizer")
        self.update_ms: list = []     # CPU time of each layer's update
        self.wait_s = 0.0             # main thread blocked on the worker

    @property
    def tree(self):
        return self.new_w, self.new_o

    def write(self, row: int, product) -> None:
        """Relay sink: layer ``row``'s ``(gradient, flag)`` goes into the
        next ring row (once the worker has read it), then to the worker."""
        r = self.n_written % self.ring.n
        self.n_written += 1
        if self.pending[r] is not None:
            t0 = time.perf_counter()
            self.pending[r].result()
            self.wait_s += time.perf_counter() - t0
        self.ring.write(r, product)
        ready = None
        if self.ring.stream is not None:
            ready = torch.cuda.Event()
            ready.record(self.ring.stream)
        self.pending[r] = self.pool.submit(self._apply, row,
                                           _row(self.ring.tree, r), ready)

    def update_rows(self, rows, grads) -> None:
        """Algorithm 3: update ``rows`` from the gradient rows of
        ``grads``, which the host may read now."""
        for l in rows:
            self._apply(l, (_row(grads, l), None), None)

    def _apply(self, l: int, got, ready: Optional[torch.cuda.Event]):
        if ready is not None:
            ready.synchronize()
        t0 = time.perf_counter()
        g, flag = got
        w, o = _row(self.w, l), _row(self.o, l)
        dst_w, dst_o = _row(self.new_w, l), _row(self.new_o, l)
        if self.amp and flag is not None and not bool(flag):
            # a non-finite layer keeps its rows (the device path's where)
            new_w, new_o = w, o
        elif self.packed:
            spec = w.spec
            new_w, new_o = self.update(packing.unpack(g),
                                       packing.unpack_opt(spec, o),
                                       packing.unpack(w), self.step)
            dst_w = packing.unpack(dst_w)
            dst_o = packing.unpack_opt(spec, dst_o)
        else:
            new_w, new_o = self.update(g, o, w, self.step)
        for d, s in zip(tree_leaves(dst_w) + tree_leaves(dst_o),
                        tree_leaves(new_w) + tree_leaves(new_o)):
            d.copy_(s)
        self.update_ms.append((time.perf_counter() - t0) * 1e3)

    def join(self) -> None:
        t0 = time.perf_counter()
        try:
            for job in self.pending:
                if job is not None:
                    job.result()
        finally:
            self.close()
            self.wait_s += time.perf_counter() - t0

    def close(self) -> None:
        """Stop the worker once it has run what it was given."""
        self.pool.shutdown(wait=True)
