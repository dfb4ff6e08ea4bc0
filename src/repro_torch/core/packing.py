"""Packed flat-buffer parameter relay (``ExecutionConfig.pack_params``),
the weight half of ``repro.core.packing``.

Each layer of a stacked group is coalesced into ONE contiguous flat buffer
per dtype, so a relay stop moves one large copy per layer instead of one
per leaf.  A stacked group packs to ``(N_layers, W)`` segments; a layer
slice to ``(W,)``.  Leaves are taken in the reference's flatten order
(dicts by sorted key, ``core.tree``), so the packed rows are
byte-identical to the JAX package's (tests/test_torch_models.py).

``unpack`` returns views into the relayed buffer: the layer apply reads
straight out of the copy's destination.

Optimizer slots pack SLOT-MAJOR and aligned to the weight layout
(``pack_opt``): ``{"m": Packed, "v": Packed}`` with the weight spec's keys
and offsets, so slot element i pairs with weight element i and the fused
update runs once per dtype segment (byte-identical to the reference's
rows, tests/test_torch_train.py).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.tree import (tree_flatten_up_to, tree_leaves, tree_map,
                                   tree_unflatten_like)

_DTYPE_KEYS = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16", torch.float64: "float64",
               torch.int32: "int32", torch.int64: "int64"}


def dtype_key(dtype) -> str:
    """Segment key of a leaf dtype — the same string as ``str(jnp.dtype)``."""
    return _DTYPE_KEYS[dtype]


class LeafSlot(NamedTuple):
    """Where one original leaf lives inside its dtype segment."""
    key: str                      # segment key == the leaf's dtype name
    offset: int                   # element offset within the segment
    size: int                     # element count
    shape: Tuple[int, ...]        # ONE layer's shape (no stacked axis)


class PackSpec(NamedTuple):
    """Static layout of a packed tree."""
    template: Any                 # the original tree's structure (leaves 0)
    leaves: Tuple[LeafSlot, ...]  # one per original leaf, flatten order
    seg_sizes: Tuple[Tuple[str, int], ...]   # (key, total elements)

    @property
    def keys(self):
        return tuple(k for k, _ in self.seg_sizes)


class Packed:
    """Dict of dtype-keyed flat segments plus its PackSpec; a tree node
    whose children are the segments in sorted key order."""
    __slots__ = ("segs", "spec")

    def __init__(self, segs: dict, spec: PackSpec):
        self.segs = dict(segs)
        self.spec = spec

    def __tree_children__(self):
        return [self.segs[k] for k in sorted(self.segs)]

    def __tree_rebuild__(self, children):
        return Packed(dict(zip(sorted(self.segs), children)), self.spec)

    def __repr__(self):
        segs = {k: tuple(v.shape) for k, v in self.segs.items()}
        return f"Packed({segs})"


def is_packed(x) -> bool:
    return isinstance(x, Packed)


def _layer_shape(leaf, stacked: bool):
    return tuple(leaf.shape[1:] if stacked else leaf.shape)


def build_spec(tree, stacked: bool = True) -> PackSpec:
    """Derive the static layout from a (stacked) tree of tensors.  Segment
    assignment and offsets follow flatten order, segregated by dtype."""
    offsets: dict = {}
    slots = []
    for leaf in tree_leaves(tree):
        key = dtype_key(leaf.dtype)
        shape = _layer_shape(leaf, stacked)
        size = 1
        for d in shape:
            size *= int(d)
        off = offsets.get(key, 0)
        slots.append(LeafSlot(key, off, size, shape))
        offsets[key] = off + size
    # keep the structure only: the spec must not hold the tensors alive
    template = tree_map(lambda _: 0, tree)
    return PackSpec(template, tuple(slots), tuple(sorted(offsets.items())))


def pack(tree, spec: PackSpec = None, stacked: bool = True) -> Packed:
    """Coalesce a tree into per-dtype flat segments (new tensors on the
    leaves' device)."""
    if spec is None:
        spec = build_spec(tree, stacked=stacked)
    leaves = tree_leaves(tree)
    assert len(leaves) == len(spec.leaves), \
        f"tree has {len(leaves)} leaves, spec describes {len(spec.leaves)}"
    by_key: dict = {k: [] for k in spec.keys}
    for leaf, slot in zip(leaves, spec.leaves):
        got = _layer_shape(leaf, stacked)
        assert got == tuple(slot.shape), f"leaf shape {got} != spec {slot.shape}"
        by_key[slot.key].append(leaf.reshape(leaf.shape[0], -1) if stacked
                                else leaf.reshape(-1))
    segs = {}
    for key, parts in by_key.items():
        dts = {p.dtype for p in parts}
        assert len(dts) == 1, \
            f"segment {key!r} mixes dtypes {sorted(map(str, dts))}"
        segs[key] = torch.cat(parts, dim=-1)
    return Packed(segs, spec)


def unpack(packed: Packed):
    """Inverse of ``pack``: a slice + view per leaf, no copy."""
    out = []
    for slot in packed.spec.leaves:
        seg = packed.segs[slot.key]
        piece = seg.narrow(-1, slot.offset, slot.size)
        lead = seg.shape[:-1]            # (N,) stacked, (G,) slot, () layer
        out.append(piece.view(tuple(lead) + tuple(slot.shape)))
    return tree_unflatten_like(packed.spec.template, out)


def pack_params(params: dict) -> dict:
    """Pack the stacked layer groups; ``embed`` / ``head`` stay plain trees
    (they are never relayed)."""
    return {**params,
            "groups": tuple(g if is_packed(g) else pack(g)
                            for g in params["groups"])}


def unpack_params(params: dict) -> dict:
    return {**params,
            "groups": tuple(unpack(g) if is_packed(g) else g
                            for g in params["groups"])}


# ---------------------------------------------------------------------------
# Optimizer-state packing (slot-major, weight-aligned)
# ---------------------------------------------------------------------------
def opt_slot_names(opt_tree, spec: PackSpec) -> Tuple[str, ...]:
    """Slot keys of a per-leaf optimizer state ({leaf: {"m":..,"v":..}}),
    asserted uniform across leaves; () for stateless optimizers (sgd)."""
    dicts = tree_flatten_up_to(spec.template, opt_tree)
    if not dicts:
        return ()
    first = tuple(sorted(dicts[0]))
    for d in dicts:
        assert isinstance(d, dict) and tuple(sorted(d)) == first, \
            f"non-uniform optimizer slots: {sorted(d)} vs {list(first)}"
    return first


def pack_opt(spec: PackSpec, opt_tree, stacked: bool = True) -> dict:
    """{slot: Packed} with segments ALIGNED to the weight spec (same keys,
    same offsets)."""
    dicts = tree_flatten_up_to(spec.template, opt_tree)
    return {s: pack(tree_unflatten_like(spec.template,
                                        [d[s] for d in dicts]),
                    spec=spec, stacked=stacked)
            for s in opt_slot_names(opt_tree, spec)}


def unpack_opt(spec: PackSpec, packed_slots: dict):
    """Inverse of ``pack_opt``: rebuild {leaf: {slot: tensor}} (views)."""
    slots = tuple(sorted(packed_slots))
    unpacked = {s: tree_leaves(unpack(packed_slots[s])) for s in slots}
    per_leaf = [{s: unpacked[s][i] for s in slots}
                for i in range(len(spec.leaves))]
    return tree_unflatten_like(spec.template, per_leaf)


def opt_is_packed(group_opt) -> bool:
    return (isinstance(group_opt, dict)
            and all(is_packed(v) for v in group_opt.values()))


def pack_opt_state(opt: dict, params_packed: dict) -> dict:
    """Pack the ``groups`` of an opt-state dict against the packed params'
    specs."""
    return {**opt, "groups": tuple(
        pack_opt(g_p.spec, g_opt)
        if is_packed(g_p) and not opt_is_packed(g_opt) else g_opt
        for g_opt, g_p in zip(opt["groups"], params_packed["groups"]))}


def unpack_opt_state(opt: dict, params_packed: dict) -> dict:
    return {**opt, "groups": tuple(
        unpack_opt(g_p.spec, g_opt)
        if is_packed(g_p) and opt_is_packed(g_opt) else g_opt
        for g_opt, g_p in zip(opt["groups"], params_packed["groups"]))}
