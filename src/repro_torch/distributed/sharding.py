"""Logical-axis -> mesh-axis sharding rules (the port of
``repro/distributed/sharding.py``, name for name).

Params, activations, caches and batches declare logical axes
(``models.common.ParamSpec.axes``); these functions map them onto the
production mesh ("pod", "data", "model") as the reference's GSPMD rules
do, with the same divisibility fallbacks (hymba's 25 heads or whisper's
51865 vocab cannot split 16 ways: that dim is replicated and the ffn /
vocab dims that do divide carry the model axis).

Key placements:
  batch       -> ("pod","data")       (data parallel)
  heads/kv    -> "model"              (tensor parallel attention)
  ffn/expert_ffn -> "model"           (tensor parallel mlp)
  experts     -> "model"              (expert parallel, deepseek)
  vocab       -> "model"              (sharded embedding/logits)
  cache seq   -> "model"              (decode: distributed KV slots)
  layers      -> None                 (the L2L relay axis: never sharded)

``zero_shard_data`` additionally shards the stacked layer params over the
data axes when the leading dims divide (ZeRO-style EPS partitioning).

A mesh here is anything with a ``{axis name: size}`` shape: a
``torch.distributed.device_mesh.DeviceMesh`` (its ``mesh_dim_names`` and
``mesh.shape``), or a shape-only stand-in whose ``shape`` is that mapping
(the reference's tests use one).  ``P`` is the port's own partition spec,
a tuple of per-dimension mesh axes (None, a name, or a tuple of names);
it equals the JAX ``PartitionSpec`` with the same entries as a tuple.
``shardings`` gives, per leaf, the pspec, its DTensor placement list
(``Shard(i)`` / ``Replicate()`` per mesh dimension) and its resting
place; ``shard_batch`` cuts a global batch to one rank's rows, as a
``NamedSharding`` with ``P("data")`` lays them out (contiguous blocks in
rank order), and ``local_shape`` / ``shard_leaf`` cut a whole leaf to one
rank's block under its pspec the same way (``distributed.
tensor_parallel`` gathers the blocks back over the model group).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

from repro_torch.core.tree import tree_map
from repro_torch.models.common import is_spec

DATA_AXES = ("pod", "data")


class P(tuple):
    """A partition spec: one entry per array dimension, each None
    (replicated), a mesh axis name, or a tuple of names (sharded over
    their product, major to minor).  A one-name tuple is kept as the bare
    name, as JAX's ``PartitionSpec`` keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return "P" + super().__repr__()


def is_pspec(x) -> bool:
    """A P is a tuple: map over pspec trees with ``is_leaf=is_pspec``."""
    return isinstance(x, P)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh or a shape-only stand-in."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, (int(n) for n in mesh.mesh.shape)))
    return {k: int(v) for k, v in dict(mesh.shape).items()}


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(name, tuple):
        return int(math.prod(shape[n] for n in name))
    return shape[name]


def _data_axes(mesh):
    shape = mesh_shape(mesh)
    return tuple(a for a in DATA_AXES if a in shape) or None


def data_size(mesh) -> int:
    """The data-parallel width: the product of the mesh's data axes."""
    return 1 if mesh is None else _axis_size(mesh, _data_axes(mesh))


def model_size(mesh) -> int:
    return 1 if mesh is None else mesh_shape(mesh).get("model", 1)


def make_rules(cfg, mesh, *, kind: str = "train",
               batch_size: Optional[int] = None) -> dict:
    """Logical axis -> mesh axis (or tuple / None)."""
    model_ax = "model" if "model" in mesh_shape(mesh) else None
    m = _axis_size(mesh, model_ax)
    data_ax = _data_axes(mesh)
    d = _axis_size(mesh, data_ax)

    def fits(n):
        return model_ax if (m > 1 and n % m == 0) else None

    rules = {
        "batch": data_ax if (batch_size is None or batch_size % d == 0)
        else None,
        "layers": None,
        "d_model": None,
        "heads": fits(cfg.n_heads),
        "kv": fits(cfg.n_kv_heads),
        "head_dim": None,
        "ffn": fits(cfg.d_ff),
        "expert_ffn": None,
        "experts": None,
        "vocab": fits(cfg.vocab_size),
        "heads_x_dim": fits(cfg.d_model),
        "lora": None,
        "state": None,
        "conv": None,
        "seq": None,
    }
    if cfg.n_experts:
        if m > 1 and cfg.n_experts % m == 0:
            rules["experts"] = model_ax          # expert parallel (deepseek)
            rules["expert_ffn"] = None
        else:
            rules["experts"] = None
            rules["expert_ffn"] = fits(cfg.d_ff_expert)  # TP inside experts
    if kind == "decode":
        # distributed KV cache: shard the seq slots over "model"; the kv
        # head dim stays replicated (can't double-use the axis).
        rules = dict(rules, seq=model_ax, kv=None, heads=rules["heads"])
    if kind == "hybrid_state":
        rules = dict(rules, ffn=fits(cfg.d_model))
    return rules


def spec_to_pspec(axes: tuple, rules: dict, shape: tuple = None,
                  mesh=None) -> P:
    """axes: tuple of logical names (or None) per dim -> P.  No mesh axis
    is used twice (later dims lose) and, when shape and mesh are given, an
    assignment whose dim is not divisible by the axis size is dropped
    (the dim is replicated)."""
    used = set()
    entries = []
    for i, ax in enumerate(axes):
        mesh_ax = rules.get(ax) if ax is not None else None
        flat = (mesh_ax if isinstance(mesh_ax, tuple)
                else (mesh_ax,) if mesh_ax else ())
        if mesh_ax is None or any(f in used for f in flat):
            entries.append(None)
            continue
        if shape is not None and mesh is not None:
            if shape[i] % _axis_size(mesh, mesh_ax) != 0:
                entries.append(None)
                continue
        used.update(flat)
        entries.append(mesh_ax)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def pspec_tree(spec_tree, rules: dict, mesh=None):
    """ParamSpec tree -> P tree."""
    return tree_map(lambda s: spec_to_pspec(s.axes, rules, s.shape, mesh),
                    spec_tree, is_leaf=is_spec)


def dtensor_placements(pspec: P, mesh) -> list:
    """The DTensor placement list of ``pspec`` on ``mesh``: per mesh
    dimension, in the mesh's order, ``Shard(i)`` when array dim i is split
    over that axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for i, entry in enumerate(pspec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                dim_of[ax] = i
    return [Shard(dim_of[ax]) if ax in dim_of else Replicate()
            for ax in mesh_shape(mesh)]


class Sharding(NamedTuple):
    """One leaf's layout: its pspec, the DTensor placements of it on the
    mesh, and where the leaf rests ("device" or "pinned_host")."""
    pspec: P
    placements: list
    memory_kind: str = "device"


def shardings(spec_tree, rules: dict, mesh, memory_kind=None):
    """ParamSpec tree -> ``Sharding`` tree on ``mesh``."""
    mk = memory_kind or "device"

    def one(s):
        ps = spec_to_pspec(s.axes, rules, s.shape, mesh)
        return Sharding(ps, dtensor_placements(ps, mesh), mk)
    return tree_map(one, spec_tree, is_leaf=is_spec)


def activation_pspec(rules: dict, with_ub: bool = False) -> P:
    """(B,S,d) or (UB,B,S,d) activations: batch data-parallel."""
    b = rules.get("batch")
    return P(None, b) if with_ub else P(b)


def batch_pspecs(cfg, shape, mesh, rules) -> dict:
    """Pspecs for the input batch dict."""
    from repro_torch.models.model import batch_spec
    return pspec_tree(batch_spec(cfg, shape), rules)


def param_shardings(model, mesh, rules, *, weight_stream=False,
                    zero_shard_data=False):
    """Shardings for the full param tree {"embed","head","groups"}.
    Groups rest in pinned host memory when ``weight_stream`` (the EPS; on
    the card the port's pinned rows are physical)."""
    specs = model.param_specs()
    kind_groups = "pinned_host" if weight_stream else "device"
    emb = shardings(specs["embed"], rules, mesh)
    head = shardings(specs["head"], rules, mesh)
    g_rules = dict(rules)
    if zero_shard_data:
        g_rules["layers"] = _data_axes(mesh)
    groups = tuple(shardings(g, g_rules, mesh, memory_kind=kind_groups)
                   for g in specs["groups"])
    return {"embed": emb, "head": head, "groups": groups}


def layer_slice_pspecs(model, mesh, rules):
    """Per-group pspec tree for ONE layer (no stacked axis): what one relay
    slot of the group is laid out as."""
    return tuple(pspec_tree(g.spec, rules) for g in model.groups)


def _coordinate(mesh) -> dict:
    """``{axis name: this rank's index}`` from a DeviceMesh's coordinate or
    a stand-in's ``coordinate`` mapping."""
    shape = mesh_shape(mesh)
    if hasattr(mesh, "get_coordinate"):
        return dict(zip(shape, mesh.get_coordinate()))
    return dict(mesh.coordinate)


def _axes_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (the first major)."""
    shape, coord = mesh_shape(mesh), _coordinate(mesh)
    idx = 0
    for ax in axes or ():
        idx = idx * shape[ax] + int(coord[ax])
    return idx


def data_index(mesh) -> int:
    """This rank's index along the data axes (pod major, data minor)."""
    return _axes_index(mesh, _data_axes(mesh))


def model_index(mesh) -> int:
    """This rank's index along the "model" axis (0 without one)."""
    if mesh is None or "model" not in mesh_shape(mesh):
        return 0
    return _axes_index(mesh, ("model",))


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape, pspec: P, mesh) -> tuple:
    """The shape of one rank's block of a leaf of ``shape`` laid out as
    ``pspec``: each dim a pspec entry names is split by its axes' size."""
    out = list(shape)
    for i, entry in enumerate(pspec):
        if entry is not None:
            n = _axis_size(mesh, entry)
            assert out[i] % n == 0, (tuple(shape), pspec, n)
            out[i] //= n
    return tuple(out)


def shard_leaf(a, pspec: P, mesh):
    """This rank's contiguous block of the whole leaf ``a`` under
    ``pspec`` (a view): along each split dim the block at the rank's index
    over that entry's axes, as a ``NamedSharding`` lays blocks out."""
    for i, entry in enumerate(pspec):
        if entry is None:
            continue
        n = _axis_size(mesh, entry)
        per = a.shape[i] // n
        a = a.narrow(i, _axes_index(mesh, _names(entry)) * per, per)
    return a


def stacked_pspec(pspec: P) -> P:
    """The pspec of a stacked ``(N, ...)`` leaf from its one-layer pspec
    (the relay axis is never split)."""
    return P(None, *pspec) if len(pspec) else P()


def is_split_over(pspec: P, axis: str = "model") -> bool:
    """Whether ``pspec`` splits some dim over ``axis``."""
    return any(e is not None and axis in _names(e) for e in pspec)


def shard_batch(batch: dict, mesh, rules: dict,
                n_microbatches: int = 1) -> dict:
    """One rank's rows of a global batch: every array's leading (batch)
    dim, which ``batch_pspecs`` puts on ``rules["batch"]``, is cut to this
    rank's contiguous block (rank order, as ``P("data")`` lays rows out);
    a replicated batch (``rules["batch"]`` None) is returned whole.

    With ``n_microbatches`` UB > 1 the cut is made inside each microbatch:
    the global batch is UB contiguous microbatches (the engines'
    ``_reshape_ub``), and the rank's rows are its block of each, in
    microbatch order, as the reference's stash ``P(None, batch)`` lays a
    microbatched batch out.  So the rank's microbatch u is the r-th block
    of the global microbatch u: a statistic or a dispatch formed over the
    data group per microbatch (the MoE's) is the global microbatch's."""
    b_ax = rules.get("batch")
    if b_ax is None:
        return dict(batch)
    n = _axis_size(mesh, b_ax)
    i = data_index(mesh)
    ub = int(n_microbatches)
    out = {}
    for k, a in batch.items():
        rows = a.shape[0]
        assert rows % (n * ub) == 0, \
            (f"batch {k!r} of {rows} rows does not split over {n} ranks "
             f"in {ub} microbatches")
        per = rows // (n * ub)
        if ub == 1:
            out[k] = a[i * per:(i + 1) * per]
            continue
        blocks = a.reshape(ub, n * per, *a.shape[1:])[:, i * per:
                                                      (i + 1) * per]
        out[k] = blocks.reshape(ub * per, *a.shape[1:])
    return out
