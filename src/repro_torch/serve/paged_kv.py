"""Paged KV cache: fixed-size pages from a shared pool + per-slot tables
(the port of ``repro/serve/paged_kv.py``).

For continuous batching the sequence axis is cut into fixed-size
**pages** held in one pool per cache leaf::

    paged leaf   (n_layers, n_pages, page_size, ...)   # k/v/pos
    slot leaf    (n_layers, max_batch, ...)            # recurrent state

and a **page table** ``(max_batch, pages_per_slot)`` of physical page ids
(-1 = unmapped) maps each batch slot's logical ring positions onto pool
pages.  The scheduler hands pages out from a free list and takes them
back when a request leaves; slots and pages are recycled without
changing any shape — the tables are int32 inputs of the tick.

The decode blocks are reused unchanged: at each relay stop the tick
**gathers** a slot-contiguous view ``(B, pages_per_slot * page_size,
...)`` from the pool (logical page order, so the view IS the contiguous
cache), runs the layer's decode on it, then **scatters back** only the
positions written this tick.  Unmapped pages read physical page 0, and
their ``pos`` entries are forced to -1 so attention masks them.

The pools live on the compute device and are updated IN PLACE (the
reference returns new pools and donates the old ones).  torch has no
dropping scatter, so the writes the reference sends out of bounds
(``pos < 0`` rows, unmapped pages, padded claim lists) are taken out on
the host before any index reaches the device: ``tick_index`` builds one
tick's index tensors from the scheduler's numpy arrays in one transfer,
and no function here reads a device tensor back (no sync).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models.common import ParamSpec, is_spec


def is_paged_spec(spec: ParamSpec) -> bool:
    """A cache leaf pages iff it is laid out (batch, seq, ...) — the KV /
    position leaves.  Per-slot recurrent state has no seq axis and stays
    slot-major."""
    return tuple(spec.axes[:2]) == ("batch", "seq")


def _is_pos(spec: ParamSpec) -> bool:
    return tuple(spec.axes) == ("batch", "seq")


class GroupPages(NamedTuple):
    """Static paging metadata for one decode group's cache tree."""
    spec: dict              # per-layer cache ParamSpec tree (serve shape)
    paged: dict             # same structure: bool per leaf


def _map_specs(fn, spec_tree, *trees):
    return tree_map(fn, spec_tree, *trees, is_leaf=is_spec)


def group_pages(model, max_batch: int, max_seq: int):
    """Per decode group: the per-layer cache spec at the serve shape and
    its paged/slot classification."""
    out = []
    for g in model.decode_groups():
        spec = g.cache_spec(max_batch, max_seq)
        out.append(GroupPages(spec, _map_specs(is_paged_spec, spec)))
    return tuple(out)


def pool_specs(model, *, max_batch: int, page_size: int, n_pages: int,
               max_seq: int):
    """Pooled ParamSpec trees, one per decode group, leaves stacked over
    the group's layers: paged leaves become (n_layers, n_pages, page_size,
    ...), slot leaves (n_layers, max_batch, ...)."""
    out = []
    for g, gp in zip(model.decode_groups(),
                     group_pages(model, max_batch, max_seq)):
        def one(spec, paged, _n=g.n_layers):
            if paged:
                shape = (_n, n_pages, page_size) + tuple(spec.shape[2:])
                axes = ("layers", "pages") + tuple(spec.axes[1:])
            else:
                shape = (_n,) + tuple(spec.shape)
                axes = ("layers",) + tuple(spec.axes)
            return ParamSpec(shape, axes, spec.init, spec.scale)
        out.append(_map_specs(one, gp.spec, gp.paged))
    return tuple(out)


def init_pool(model, *, max_batch: int, page_size: int, n_pages: int,
              max_seq: int, dtype=None, device="cpu"):
    """The page pools on ``device``: zeros in ``dtype`` (default the
    model's compute dtype) for data leaves, int32 -1 for pos leaves."""
    dtype = dtype or model.dtype()
    specs = pool_specs(model, max_batch=max_batch, page_size=page_size,
                       n_pages=n_pages, max_seq=max_seq)

    def one(spec):
        if spec.axes[-1] == "seq" and len(spec.shape) == 3:    # pos leaf
            return torch.full(spec.shape, -1, dtype=torch.int32,
                              device=device)
        assert spec.init == "zeros", f"cache leaf init {spec.init!r}"
        return torch.zeros(spec.shape, dtype=dtype, device=device)

    return tuple(tree_map(one, s, is_leaf=is_spec) for s in specs)


# ---------------------------------------------------------------------------
# one tick's indices, made on the host
# ---------------------------------------------------------------------------
class TickIndex(NamedTuple):
    """Device index tensors of one tick (``tick_index``)."""
    safe: torch.Tensor      # (B, P) int64: table, unmapped -> page 0
    mapped: torch.Tensor    # (B, P*page_size) bool: logical page mapped
    rows: torch.Tensor      # (n,) int64: batch row of each kept write
    slots: torch.Tensor     # (n,) int64: its logical slot in the view
    phys: torch.Tensor      # (n,) int64: its physical page
    offset: torch.Tensor    # (n,) int64: its offset in that page
    active: torch.Tensor    # (B,) bool: row owns live per-slot state


def tick_index(table, pos, active, page_size: int, device="cpu") -> TickIndex:
    """The index tensors ``gather_view`` and ``scatter_new`` use, computed
    in numpy from the tick's host arrays — ``table`` (B, P) physical page
    ids (-1 unmapped), ``pos`` (B, T) positions written this tick (-1
    padding), ``active`` (B,) — and moved to ``device`` together.  A
    write is kept iff its row's ``pos >= 0`` and its logical page is
    mapped: the writes the reference drops out of bounds."""
    table = np.asarray(table, np.int64)
    pos = np.asarray(pos, np.int64)
    active = np.asarray(active, bool)
    B, P = table.shape
    live = P * page_size
    slot = np.mod(pos, live)                                 # (B, T)
    lp = np.minimum(slot // page_size, P - 1)
    phys = np.take_along_axis(table, lp, axis=1)
    keep = (pos >= 0) & (phys >= 0)
    rows = np.broadcast_to(np.arange(B)[:, None], pos.shape)
    ints = np.concatenate([
        np.maximum(table, 0).reshape(-1),
        np.repeat(table >= 0, page_size, axis=1).reshape(-1),
        rows[keep], slot[keep], phys[keep], np.mod(slot, page_size)[keep],
        active.astype(np.int64)])
    dev = torch.from_numpy(ints).to(device)
    n = int(keep.sum())
    cuts = np.cumsum([B * P, B * live, n, n, n, n])
    safe, mapped, rows_, slots, phys_, offset, act = torch.tensor_split(
        dev, cuts.tolist())
    return TickIndex(safe.view(B, P), mapped.view(B, live).bool(), rows_,
                     slots, phys_, offset, act.bool())


# ---------------------------------------------------------------------------
# gather / scatter between the pool and slot-contiguous views
# ---------------------------------------------------------------------------
def gather_view(pool_layer, pages: GroupPages, table, page_size: int,
                index: Optional[TickIndex] = None):
    """One layer's pool -> the contiguous (B, P*page_size, ...) per-slot
    view the decode blocks expect (fresh tensors, the per-slot state
    leaves copied).  ``table``: (B, P) physical page ids, -1 = unmapped;
    unmapped pages read physical page 0 but their ``pos`` entries are
    forced to -1, so attention masks them.
    ``index``: this tick's ``tick_index`` (else made from ``table``)."""
    if index is None:
        B = len(table)
        index = tick_index(table, np.zeros((B, 0), np.int64),
                           np.zeros(B, bool), page_size,
                           tree_leaves(pool_layer)[0].device)
    B, P = index.safe.shape

    def one(spec, leaf):
        if not is_paged_spec(spec):
            # a copy: the decode blocks write recurrent state in place,
            # and only the active rows may reach the pool (scatter_new)
            return leaf.clone()
        g = leaf[index.safe].reshape((B, P * page_size)
                                     + tuple(leaf.shape[2:]))
        if _is_pos(spec):
            g = torch.where(index.mapped, g, torch.full_like(g, -1))
        return g

    return _map_specs(one, pages.spec, pool_layer)


def scatter_new(pool_layer, new_view, pages: GroupPages, table, pos, active,
                index: Optional[TickIndex] = None):
    """Write back ONE tick's updates IN PLACE: for paged leaves, only the
    slots written this tick (logical slot ``pos % (P*page_size)`` per row,
    the decode blocks' ring arithmetic) go into their physical pages; rows
    with ``pos < 0`` and slots whose logical page is unmapped are dropped.
    Per-slot leaves take the new value on active rows and keep the old
    elsewhere.  Returns ``pool_layer``.

    pool_layer/new_view: one layer's trees; table: (B, P); pos: (B, T);
    active: (B,) — host arrays, or pass this tick's ``index``."""
    if index is None:
        # page_size from the first paged leaf (all share it by
        # construction); a group without one never reads it
        sized = [leaf.shape[1] for s, leaf in zip(
            tree_leaves(pages.spec, is_leaf=is_spec),
            tree_leaves(pool_layer)) if is_paged_spec(s)]
        index = tick_index(table, pos, active, sized[0] if sized else 1,
                           tree_leaves(pool_layer)[0].device)

    def one(spec, old, new):
        if is_paged_spec(spec):
            vals = new[index.rows, index.slots]
            old.index_put_((index.phys, index.offset), vals.to(old.dtype))
        else:
            keep = index.active.view((-1,) + (1,) * (old.dim() - 1))
            old.copy_(torch.where(keep, new.to(old.dtype), old))
        return old

    return _map_specs(one, pages.spec, pool_layer, new_view)


# ---------------------------------------------------------------------------
# claim-time resets
# ---------------------------------------------------------------------------
def reset_claim(pools, groups, page_ids, slot_ids):
    """Invalidate freshly claimed pages and zero the claimed slots' state,
    IN PLACE.  ``page_ids``: (R,) physical pages being handed to a new
    request — their pooled ``pos`` entries go to -1 so stale positions
    from the previous owner can never pass the attention mask.
    ``slot_ids``: (Q,) batch slots being claimed — their per-slot state
    leaves are zeroed.  Both are host arrays padded with -1 (skipped).
    Returns ``pools``."""
    pages = np.asarray(page_ids, np.int64)
    slots = np.asarray(slot_ids, np.int64)
    pages, slots = pages[pages >= 0], slots[slots >= 0]
    for pool, gp in zip(pools, groups):
        dev = tree_leaves(pool)[0].device
        pid = torch.from_numpy(pages).to(dev) if len(pages) else None
        sid = torch.from_numpy(slots).to(dev) if len(slots) else None

        def one(spec, leaf):
            if is_paged_spec(spec):
                if _is_pos(spec) and pid is not None:
                    leaf[:, pid] = -1
            elif sid is not None:
                leaf[:, sid] = 0
            return leaf
        _map_specs(one, gp.spec, pool)
    return pools


def pool_bytes(model, *, max_batch: int, page_size: int, n_pages: int,
               max_seq: int, cache_dtype_bytes: int = 2):
    """(kv_page_bytes, slot_state_bytes, n_paged_leaves) — the analytic
    footprint of the pools (memory_model's serve-mode terms)."""
    specs = pool_specs(model, max_batch=max_batch, page_size=page_size,
                       n_pages=n_pages, max_seq=max_seq)
    groups = group_pages(model, max_batch, max_seq)
    kv = slot = npaged = 0
    for spec_tree, gp in zip(specs, groups):
        for s, paged in zip(tree_leaves(spec_tree, is_leaf=is_spec),
                            tree_leaves(gp.paged)):
            size = 1
            for d in s.shape:
                size *= d
            # pos leaves are int32 (4B); data leaves ride the cache dtype
            nbytes = size * (4 if s.axes[-1] == "seq" and len(s.shape) == 3
                             and paged else cache_dtype_bytes)
            if paged:
                kv += nbytes
                npaged += 1
            else:
                slot += nbytes
    return kv, slot, npaged
