"""The port's sharding rules, pspecs and placements against the
reference's (``repro.distributed.sharding``, ``repro.engine.placement``),
exactly, on shape-only meshes (the rules read axis sizes, never devices):
``make_rules`` for every config on the production, multi-pod and two small
meshes, each kind, a batch that divides the data axes and one that does
not; ``spec_to_pspec`` / ``pspec_tree`` over every param, decode-cache and
batch leaf; ``layer_slice_pspecs``; ``param_shardings`` with and without
``zero_shard_data``; the pspecs ``placements_for`` gives packed and
unpacked; the DTensor placement lists (their local shapes against JAX's
``NamedSharding.shard_shape``); ``shard_batch``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs.base import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import list_archs as jlist_archs  # noqa: E402
from repro.core.schedule import ExecutionConfig as JExec  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.engine import placement as jplacement  # noqa: E402
from repro.models.model import LayeredModel as JModel  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, get_config, list_archs  # noqa: E402,E501
from repro_torch.core.schedule import ExecutionConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.engine.placement import placements_for  # noqa: E402
from repro_torch.models.model import LayeredModel  # noqa: E402

ARCHS = list_archs()
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}, {"data": 4, "model": 1})
KINDS = ("train", "decode", "hybrid_state")


class FakeMesh:
    """Shape-only stand-in (the rules never touch devices)."""
    def __init__(self, coordinate=None, **shape):
        self.shape = shape
        self.coordinate = coordinate or {}


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))


def _same(port_tree, ref_tree):
    got = tree_leaves(port_tree, is_leaf=shd.is_pspec)
    want = _jleaves(ref_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, shd.P) and tuple(g) == tuple(w), (g, w)


def test_every_config_is_covered():
    assert len(ARCHS) == 11 and ARCHS == jlist_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_make_rules_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in MESHES:
        d = shape.get("pod", 1) * shape["data"]
        for kind in KINDS:
            for batch in (None, 4 * d, 4 * d + 1):
                got = shd.make_rules(cfg, FakeMesh(**shape), kind=kind,
                                     batch_size=batch)
                want = jshd.make_rules(jcfg, FakeMesh(**shape), kind=kind,
                                       batch_size=batch)
                assert got == want, (shape, kind, batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_pspecs_of_every_leaf_equal_the_reference(arch):
    """Params (whole and one layer slice), decode caches and the batch of
    every input shape, with and without the mesh's divisibility check."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    model, jmodel = LayeredModel(cfg), JModel(jcfg)
    for shape in MESHES:
        mesh = FakeMesh(**shape)
        for kind in KINDS:
            rules = shd.make_rules(cfg, mesh, kind=kind)
            jrules = jshd.make_rules(jcfg, mesh, kind=kind)
            for m in (None, mesh):
                _same(shd.pspec_tree(model.param_specs(), rules, m),
                      jshd.pspec_tree(jmodel.param_specs(), jrules, m))
                _same(shd.pspec_tree(model.cache_specs(8, 64), rules, m),
                      jshd.pspec_tree(jmodel.cache_specs(8, 64), jrules, m))
            _same(shd.layer_slice_pspecs(model, mesh, rules),
                  jshd.layer_slice_pspecs(jmodel, mesh, jrules))
            for name, ishape in INPUT_SHAPES.items():
                _same(shd.batch_pspecs(cfg, ishape, mesh, rules),
                      jshd.batch_pspecs(jcfg, JSHAPES[name], mesh, jrules))


@pytest.mark.parametrize("zero", [False, True])
def test_param_shardings_equal_the_reference(monkeypatch, zero):
    """``zero_shard_data`` puts the stacked layer axis on the data axes
    where it divides; the memory kind is the port's (pinned host rows
    are physical on the card)."""
    monkeypatch.setattr(jshd, "NamedSharding",
                        lambda mesh, spec, memory_kind=None: spec)
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for shape in MESHES:
            mesh = FakeMesh(**shape)
            got = shd.param_shardings(
                LayeredModel(cfg), mesh, shd.make_rules(cfg, mesh),
                weight_stream=True, zero_shard_data=zero)
            want = jshd.param_shardings(
                JModel(jcfg), mesh, jshd.make_rules(jcfg, mesh),
                weight_stream=True, zero_shard_data=zero)
            is_sh = lambda x: isinstance(x, shd.Sharding)
            _same(tuple(s.pspec for s in tree_leaves(got, is_leaf=is_sh)),
                  want)
            kinds = {s.memory_kind for s in tree_leaves(got["groups"],
                                                        is_leaf=is_sh)}
            assert kinds == {"pinned_host"}


@pytest.mark.parametrize("pack", [False, True])
def test_placements_for_gives_the_reference_pspecs(monkeypatch, pack):
    """Packed: P() for the rows and P(None, batch) for the stash; unpacked:
    the layer-slice pspecs and, per slot, the optimizer's (pspecs_like)."""
    seen = {}

    def capture(exec_cfg, n, mesh=None, **kw):
        seen.update(kw)
    monkeypatch.setattr(jplacement, "make_placements", capture)
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for shape in MESHES:
            mesh = FakeMesh(**shape)
            got = placements_for(LayeredModel(cfg), ExecutionConfig(
                pack_params=pack), mesh=mesh)
            jplacement.placements_for(JModel(jcfg), JExec(pack_params=pack),
                                      mesh=mesh)
            _same(tuple(p.pspec for p in got.weights),
                  seen["weight_pspecs"])
            _same(tuple(p.pspec for p in got.opts), seen["opt_pspecs"])
            assert tuple(got.stash.pspec) == tuple(seen["stash_pspec"])


@pytest.mark.parametrize("spec,shape,mesh", [
    (("model", None, ("pod", "data")), (32, 5, 64),
     {"pod": 2, "data": 16, "model": 16}),
    ((None, ("data",)), (4, 32, 8), {"data": 16, "model": 16}),
    ((), (7, 3), {"data": 2, "model": 4}),
])
def test_dtensor_placements_lay_out_as_jax_shards(spec, shape, mesh):
    """A DTensor placement list splits each dim over the mesh dims that
    shard it: the local shape is JAX's ``shard_shape`` for the same
    pspec."""
    from torch.distributed.tensor import Replicate, Shard
    pl = shd.dtensor_placements(shd.P(*spec), FakeMesh(**mesh))
    assert len(pl) == len(mesh)
    local = list(shape)
    for size, p in zip(mesh.values(), pl):
        assert isinstance(p, (Shard, Replicate))
        if isinstance(p, Shard):
            local[p.dim] //= size
    jmesh = AbstractMesh(tuple(mesh.values()), tuple(mesh))
    assert tuple(local) == NamedSharding(jmesh, JP(*spec)).shard_shape(shape)


def test_shardings_of_every_param_leaf_lay_out_as_jax_shards():
    cfg = get_config("deepseek-v2-lite-16b")
    mesh = {"pod": 2, "data": 16, "model": 16}
    rules = shd.make_rules(cfg, FakeMesh(**mesh))
    specs = LayeredModel(cfg).param_specs()
    got = shd.shardings(specs, rules, FakeMesh(**mesh))
    is_sh = lambda x: isinstance(x, shd.Sharding)
    jmesh = AbstractMesh(tuple(mesh.values()), tuple(mesh))
    from repro_torch.models.common import is_spec
    for s, sp in zip(tree_leaves(got, is_leaf=is_sh),
                     tree_leaves(specs, is_leaf=is_spec)):
        local = list(sp.shape)
        for size, p in zip(mesh.values(), s.placements):
            if hasattr(p, "dim"):
                local[p.dim] //= size
        assert tuple(local) == NamedSharding(
            jmesh, JP(*s.pspec)).shard_shape(sp.shape)


@pytest.mark.parametrize("rules,shape,want", [
    ({"a": "model", "b": "model", "c": ("pod", "data")}, None,
     ("model", None, ("pod", "data"))),
    ({"seq": "model"}, (1500,), ()),
    ({"seq": "model"}, (1600,), ("model",)),
])
def test_spec_to_pspec_equals_the_reference(rules, shape, want):
    axes = tuple(rules) if shape is None else ("seq",)
    mesh = None if shape is None else FakeMesh(model=16)
    got = shd.spec_to_pspec(axes, rules, shape, mesh)
    assert tuple(got) == want == tuple(
        jshd.spec_to_pspec(axes, rules, shape, mesh))


@pytest.mark.parametrize("mesh", [{"data": 4, "model": 1},
                                  {"pod": 2, "data": 2, "model": 1}])
def test_shard_batch_takes_each_ranks_contiguous_rows(mesh):
    """Rank i of d takes rows [i B/d, (i+1) B/d), as NamedSharding with
    P(("pod", "data")) lays rows out; the ranks' rows cover the batch."""
    batch = {"tokens": np.arange(24).reshape(8, 3),
             "mask": np.ones((8, 3), np.float32)}
    cfg = get_config("bert-large")
    axes = [a for a in ("pod", "data") if a in mesh]
    got = []
    for i in range(int(np.prod([mesh[a] for a in axes]))):
        coord = dict(zip(axes, np.unravel_index(i, [mesh[a] for a in axes])))
        fm = FakeMesh(coordinate={**coord, "model": 0}, **mesh)
        part = shd.shard_batch(batch, fm, shd.make_rules(cfg, fm))
        got.append(part["tokens"])
        jmesh = AbstractMesh(tuple(mesh.values()), tuple(mesh))
        assert part["tokens"].shape == NamedSharding(
            jmesh, JP(tuple(axes))).shard_shape((8, 3))
    assert np.array_equal(np.concatenate(got), batch["tokens"])
