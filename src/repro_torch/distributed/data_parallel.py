"""The data axes of a mesh as one process group, and the collectives the
data-parallel relay makes over it.

``DataParallel(mesh)`` is one rank's view of the mesh's data axes
("pod" x "data", flattened pod major): its group, its index and the
group's size.  The relay (``core.l2l``, ``core.baseline``) sums over it
with ``all_reduce_`` (one tensor, in place) and ``reduce_tree`` (a tree's
leaves packed into one flat row per dtype, one collective for the row);
each call is counted with its bytes (the payload one rank contributes)
and timed: with CUDA events around it on the current stream (read after
the caller's synchronize, never inside the step), else by the host's
clock.  ``begin()`` zeroes the counts; ``stats()`` reads them.

The MoE layers (``models.moe``) make two collectives of their own over
the group, counted apart from the gradient rows (``moe_calls`` by kind):
``stats`` sums the router's per-expert counts and probability sums (the
load-balance statistics of the global batch; ``sum_stats``, whose
backward is the identity, so each rank's vjp gives its own tokens' share
and the layer's gradient row adds the shares once) and ``counts``
gathers every rank's per-expert integer counts (``gather_counts``: the
global dispatch's slot offsets).

The collectives are plain ``torch.distributed.all_reduce`` sums: no DDP,
no float atomics.  An all-reduce over one rank is the identity, so a world
of one gives the meshless results bit for bit.  Every rank checks that it
starts from the same state as the others (``check_replicas``: a checksum
of the state's bits from every rank, gathered over the group), and a
failed collective is not caught.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.tree import tree_leaves, tree_unflatten_like
from repro_torch.distributed import sharding as shd

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_MIX = 1_000_003
_MOD = 2 ** 61 - 1


def data_group(mesh):
    """The process group of this rank's data axes on a DeviceMesh (the
    default group's ranks that share its model coordinate)."""
    import torch.distributed as dist
    names = list(mesh.mesh_dim_names)
    axes = [a for a in shd.DATA_AXES if a in names]
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    # pod x data: one group per model coordinate, made on every rank in
    # the same order
    grid = mesh.mesh.permute(
        *[names.index(a) for a in axes],
        *[i for i, n in enumerate(names) if n not in axes])
    grid = grid.reshape(shd.data_size(mesh), -1)
    me = dist.get_rank()
    mine = None
    for col in range(grid.shape[1]):
        ranks = [int(r) for r in grid[:, col]]
        g = dist.new_group(ranks)
        if me in ranks:
            mine = g
    return mine


def tree_checksum(tree) -> int:
    """A checksum of a tree's bits (leaf by leaf, in flatten order: the
    integer sum of each leaf's words, mixed): equal trees give equal sums
    on every rank.  Pinned rows are read on the host in row chunks."""
    h = 0
    for a in tree_leaves(tree):
        if not torch.is_tensor(a):
            a = torch.as_tensor(a)
        flat = a.detach().contiguous().reshape(-1)
        words = flat.view(_BITS[flat.element_size()])
        s = 0
        step = 1 << 24
        for i in range(0, words.numel(), step):
            s += int(words[i:i + step].sum(dtype=torch.int64))
        h = (h * _MIX + s) % _MOD
    return h


class DataParallel:
    """One rank of the mesh's data axes and the collectives over them."""

    def __init__(self, mesh):
        import torch.distributed as dist
        self.mesh = mesh
        self.world = shd.data_size(mesh)
        self.rank = shd.data_index(mesh)
        self.group = data_group(mesh)
        self.backend = dist.get_backend(self.group)
        self.begin()

    # -- accounting ---------------------------------------------------------
    def begin(self):
        """Zero the counts and timers (the start of a step)."""
        self.calls = 0
        self.bytes = 0
        self.moe_calls = {"stats": 0, "counts": 0}
        self.moe_bytes = 0
        self._events = {False: [], True: []}
        self._host_s = {False: 0.0, True: 0.0}

    def stats(self) -> dict:
        """All-reduces, bytes and milliseconds since ``begin`` (the MoE's
        own apart); the device time is read from the events, so call this
        after a synchronize."""
        ms = {}
        for moe in (False, True):
            ms[moe] = self._host_s[moe] * 1e3
            for a, b in self._events[moe]:
                b.synchronize()
                ms[moe] += a.elapsed_time(b)
        return {"all_reduces": self.calls, "all_reduce_bytes": self.bytes,
                "all_reduce_ms": ms[False],
                "moe_collectives": dict(self.moe_calls),
                "moe_collective_bytes": self.moe_bytes,
                "moe_collective_ms": ms[True]}

    # -- collectives --------------------------------------------------------
    def _timed(self, t, fn, moe: bool):
        if t.device.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn()
            ev[1].record()
            self._events[moe].append(ev)
            return out
        t0 = time.perf_counter()
        out = fn()
        self._host_s[moe] += time.perf_counter() - t0
        return out

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data axes, in place; returns it."""
        import torch.distributed as dist
        self.calls += 1
        self.bytes += t.numel() * t.element_size()
        self._timed(t, lambda: dist.all_reduce(t, group=self.group), False)
        return t

    def sum_stats(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data axes forward, the identity backward:
        the MoE router's statistics (counted as ``stats``)."""
        return _SumStats.apply(t, self)

    def _sum_stats_(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        self.moe_calls["stats"] += 1
        self.moe_bytes += t.numel() * t.element_size()
        self._timed(t, lambda: dist.all_reduce(t, group=self.group), True)
        return t

    def gather_counts(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's integer ``t`` stacked in rank order ``(world,
        ...)``: the MoE's per-expert counts (counted as ``counts``)."""
        import torch.distributed as dist
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        self.moe_calls["counts"] += 1
        self.moe_bytes += t.numel() * t.element_size()
        self._timed(t, lambda: dist.all_gather(parts, t, group=self.group),
                    True)
        return torch.stack(parts)

    def reduce_tree(self, tree):
        """The tree summed over the data axes: its leaves packed into one
        flat row per dtype (flatten order), one collective for the row,
        views of it in the tree's structure."""
        leaves = tree_leaves(tree)
        out = [None] * len(leaves)
        for dt in sorted({a.dtype for a in leaves}, key=str):
            idx = [i for i, a in enumerate(leaves) if a.dtype == dt]
            row = self.all_reduce_(torch.cat(
                [leaves[i].reshape(-1) for i in idx]))
            off = 0
            for i in idx:
                n = leaves[i].numel()
                out[i] = row[off:off + n].view(leaves[i].shape)
                off += n
        return tree_unflatten_like(tree, out)

    # -- replicas -----------------------------------------------------------
    def gather_checksums(self, *trees) -> list:
        """``[rank][tree]`` checksums of the given trees over the group, in
        rank order (a CUDA tensor carries them over NCCL, a CPU one over
        gloo)."""
        import torch.distributed as dist
        device = "cuda" if self.backend == "nccl" else "cpu"
        mine = torch.tensor([tree_checksum(t) for t in trees],
                            dtype=torch.int64, device=device)
        got = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(got, mine, group=self.group)
        return [[int(x) for x in g] for g in got]

    def check_replicas(self, *trees) -> list:
        """Raise unless every rank holds the same bits in ``trees`` (the
        starting state: one seed, or one snapshot, on every rank).
        Returns this rank's checksums."""
        every = self.gather_checksums(*trees)
        if any(row != every[0] for row in every):
            raise RuntimeError(
                f"data-parallel ranks hold different states: checksums "
                f"{every} (rank order)")
        return every[self.rank]


class _SumStats(torch.autograd.Function):
    """Sum over the data group forward, identity backward: a statistic of
    the global batch whose cotangent each rank applies to its own
    tokens."""

    @staticmethod
    def forward(ctx, t, dp):
        return dp._sum_stats_(t.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None
