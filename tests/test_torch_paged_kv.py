"""The port's paged KV pool (``repro_torch/serve/paged_kv.py``) against the
reference's (``repro/serve/paged_kv.py``) on the same pools, tables and
positions, bit for bit: ``init_pool``, ``pool_bytes``, ``gather_view``
(unmapped pages), ``scatter_new`` (``pos < 0`` rows, unmapped pages, a
ring that wraps, per-slot leaves on active rows) and ``reset_claim``
(padded claim lists); and the decode blocks' ``ring_scatter`` into the
gathered view, which drops ``pos < 0`` entries without a device sync."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.common import ParamSpec as JSpec  # noqa: E402
from repro.models.model import LayeredModel as JModel  # noqa: E402
from repro.serve import paged_kv as jpk  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.common import ParamSpec  # noqa: E402
from repro_torch.models.model import LayeredModel  # noqa: E402
from repro_torch.serve import paged_kv as pk  # noqa: E402

B, P, PS, N_PAGES = 3, 4, 4, 10        # 3 slots of 4 pages of 4 positions
LIVE = P * PS

# one layer's cache tree: k/v/pos paged, plus a per-slot state leaf "h"
_LEAVES = {"k": ((B, LIVE, 2, 3), ("batch", "seq", "kv", "head_dim")),
           "v": ((B, LIVE, 2, 3), ("batch", "seq", "kv", "head_dim")),
           "pos": ((B, LIVE), ("batch", "seq")),
           "h": ((B, 5), ("batch", "d_model"))}


def _pages(spec_cls, mod):
    spec = {k: spec_cls(s, a, "zeros") for k, (s, a) in _LEAVES.items()}
    return mod.GroupPages(spec, {k: mod.is_paged_spec(v)
                                 for k, v in spec.items()})


def _pool(seed):
    """One layer's pool as numpy: paged (N_PAGES, PS, ...), slot (B, ...)."""
    rs = np.random.RandomState(seed)
    return {"k": rs.randn(N_PAGES, PS, 2, 3).astype(np.float32),
            "v": rs.randn(N_PAGES, PS, 2, 3).astype(np.float32),
            "pos": rs.randint(-1, 40, size=(N_PAGES, PS)).astype(np.int32),
            "h": rs.randn(B, 5).astype(np.float32)}


def _view(seed):
    rs = np.random.RandomState(seed)
    return {"k": rs.randn(B, LIVE, 2, 3).astype(np.float32),
            "v": rs.randn(B, LIVE, 2, 3).astype(np.float32),
            "pos": rs.randint(0, 40, size=(B, LIVE)).astype(np.int32),
            "h": rs.randn(B, 5).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _same(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


# slot 0 maps pages 2, 5, 7 (logical page 1 unmapped), slot 1 pages 0-1,
# slot 2 nothing
TABLE = np.array([[2, -1, 5, 7], [0, 1, -1, -1], [-1, -1, -1, -1]], np.int32)

# (pos, active): positions written this tick, per row
SCATTERS = {
    # a prefill chunk, a decode row with padding, an empty row
    "chunk": (np.array([[8, 9, 10], [4, -1, -1], [-1, -1, -1]]),
              np.array([True, True, False])),
    # a ring that wraps: positions past LIVE land mod LIVE
    "ring-wrap": (np.array([[30, 31, 32], [20, 21, 22], [-1, -1, -1]]),
                  np.array([True, True, False])),
    # writes into an unmapped logical page are dropped
    "unmapped": (np.array([[4, 5, 6], [9, 10, 11], [0, 1, 2]]),
                 np.array([True, True, True])),
    # an inactive row keeps its per-slot state whatever pos says
    "inactive": (np.array([[12, 13, -1], [0, 1, 2], [-1, -1, -1]]),
                 np.array([True, False, False])),
}


def test_gather_view_bitwise():
    pool = _pool(0)
    got = pk.gather_view(_t(pool), _pages(ParamSpec, pk),
                         TABLE, PS)
    want = jpk.gather_view(_j(pool), _pages(JSpec, jpk),
                           jnp.asarray(TABLE), PS)
    _same(got, want)
    # unmapped pages read invalid positions
    assert bool((got["pos"][2] == -1).all())
    assert bool((got["pos"][0, PS:2 * PS] == -1).all())


@pytest.mark.parametrize("case", sorted(SCATTERS))
def test_scatter_new_bitwise(case):
    pos, active = SCATTERS[case]
    pos = pos.astype(np.int32)
    pool, view = _pool(1), _view(2)
    port_pool = _t(pool)
    out = pk.scatter_new(port_pool, _t(view), _pages(ParamSpec, pk), TABLE,
                         pos, active)
    want = jpk.scatter_new(_j(pool), _j(view), _pages(JSpec, jpk),
                           jnp.asarray(TABLE), jnp.asarray(pos),
                           jnp.asarray(active))
    _same(out, want)
    assert out["k"] is port_pool["k"]               # written in place
    # the same through one tick's precomputed index
    again = _t(pool)
    idx = pk.tick_index(TABLE, pos, active, PS)
    pk.scatter_new(again, _t(view), _pages(ParamSpec, pk), None, None,
                   None, index=idx)
    _same(again, want)


def test_reset_claim_bitwise():
    pages = _pages(ParamSpec, pk)
    stacked = {k: np.stack([v, v + 1]) for k, v in _pool(3).items()}
    page_ids = np.array([4, -1, 7, 0, -1, -1], np.int32)   # padded
    slot_ids = np.array([2, -1, -1], np.int32)
    port = (_t(stacked),)
    pk.reset_claim(port, (pages,), page_ids, slot_ids)
    (want,) = jpk.reset_claim((_j(stacked),), (_pages(JSpec, jpk),),
                              jnp.asarray(page_ids), jnp.asarray(slot_ids))
    _same(port[0], want)
    # all padding: nothing moves
    port = (_t(stacked),)
    pk.reset_claim(port, (pages,), -np.ones(4, np.int32),
                   -np.ones(2, np.int32))
    _same(port[0], stacked)


SHAPES = [dict(max_batch=3, page_size=8, n_pages=12, max_seq=32),
          dict(max_batch=8, page_size=16, n_pages=128, max_seq=384)]


@pytest.mark.parametrize("kw", SHAPES, ids=["smoke", "serve-continuous"])
def test_init_pool_and_pool_bytes_match(kw):
    cfg = get_config("granite-3-8b", "smoke")
    model, jmodel = LayeredModel(cfg), JModel(jget_config("granite-3-8b",
                                                          "smoke"))
    (got,) = pk.init_pool(model, **kw)
    (want,) = jpk.init_pool(jmodel, **kw)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      w.astype(np.float32), err_msg=k)
    for arch, variant in (("granite-3-8b", "smoke"), ("granite-3-8b", "full"),
                          ("chatglm3-6b", "full"), ("qwen1.5-110b", "full")):
        for cb in (2, 4):
            assert pk.pool_bytes(
                LayeredModel(get_config(arch, variant)), cache_dtype_bytes=cb,
                **kw) == jpk.pool_bytes(JModel(jget_config(arch, variant)),
                                        cache_dtype_bytes=cb, **kw)


@pytest.mark.parametrize("pos", [
    [[13, 14, 15], [-1, -1, -1], [3, -1, -1]],   # a chunk, padding, a decode
    [[-1, -1, -1], [-1, -1, -1], [-1, -1, -1]],  # nothing kept
    [[-1, 15, 16], [0, 1, 2], [31, -1, 33]],     # wraps mod LIVE
], ids=["chunk", "none-kept", "ring-wrap"])
def test_ring_scatter_drops_like_reference(pos):
    """The view update inside the decode block: ``pos < 0`` entries are
    dropped (the reference aims them out of bounds), kept ones land at
    ``pos % LIVE``, for the data leaves and the pos leaf."""
    pos = np.array(pos, np.int32)
    view = _view(4)
    new = np.random.RandomState(5).randn(B, 3, 2, 3).astype(np.float32)
    got = attn.ring_scatter(torch.from_numpy(view["k"].copy()),
                            torch.from_numpy(new), torch.from_numpy(pos))
    want = jattn.ring_scatter(jnp.asarray(view["k"]), jnp.asarray(new),
                              jnp.asarray(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = attn.ring_scatter(torch.from_numpy(view["pos"].copy()),
                            torch.from_numpy(pos), torch.from_numpy(pos))
    want = jattn.ring_scatter(jnp.asarray(view["pos"]), jnp.asarray(pos),
                              jnp.asarray(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-1.6b"])
def test_recurrent_pools_match(arch):
    """The recurrent families' pools: hymba pages its KV beside per-slot
    Mamba state, rwkv6 pages nothing.  ``init_pool`` and ``pool_bytes``
    equal the reference's; one layer's ``scatter_new`` without a
    precomputed index (rwkv6 has no paged leaf to size a page from)
    writes the active rows' state only, as the reference's; and
    ``gather_view`` hands out copies of the slot leaves, so a decode
    block that writes its state in place leaves the pool as it was."""
    kw = SHAPES[0]
    model, jmodel = (LayeredModel(get_config(arch, "smoke")),
                     JModel(jget_config(arch, "smoke")))
    (got,) = pk.init_pool(model, **kw)
    (want,) = jpk.init_pool(jmodel, **kw)
    flat = _flat(got)
    jflat = _flat(want)
    assert sorted(flat) == sorted(jflat)
    for k, w in jflat.items():
        w = np.asarray(w)
        assert tuple(flat[k].shape) == w.shape, k
        np.testing.assert_array_equal(flat[k].float().numpy(),
                                      w.astype(np.float32), err_msg=k)
    assert pk.pool_bytes(model, **kw) == jpk.pool_bytes(jmodel, **kw)
    (gp,), (jgp,) = (pk.group_pages(model, kw["max_batch"], kw["max_seq"]),
                     jpk.group_pages(jmodel, kw["max_batch"], kw["max_seq"]))
    paged = [k for k, v in _flat(gp.paged).items() if v]
    assert paged == ([] if arch.startswith("rwkv") else
                     ["kv/k", "kv/pos", "kv/v"])
    rs = np.random.RandomState(6)
    layer = {k: rs.randn(*v.shape[1:]).astype(np.float32)
             for k, v in flat.items() if not k.endswith("pos")}
    layer.update({k: np.full(v.shape[1:], -1, np.int32)
                  for k, v in flat.items() if k.endswith("pos")})
    new = {k: (v + 1 if v.dtype != np.int32 else v) for k, v in layer.items()}
    Pn = kw["max_seq"] // kw["page_size"]
    table = np.arange(kw["max_batch"] * Pn, dtype=np.int32).reshape(-1, Pn)
    pos = np.array([[3], [-1], [7]], np.int32)
    active = np.array([True, False, True])
    port = _unflat(_t(layer))
    view = pk.gather_view(port, gp, table, kw["page_size"])
    for v in _flat(view).values():
        if v.is_floating_point():
            v.add_(1.0)                         # a block writing in place
    for k, v in _flat(port).items():
        np.testing.assert_array_equal(v.numpy(), layer[k], err_msg=k)
    out = pk.scatter_new(port, _unflat(_t(new)), gp, table, pos, active)
    ref = jpk.scatter_new(_unflat(_j(layer)), _unflat(_j(new)), jgp,
                          jnp.asarray(table), jnp.asarray(pos),
                          jnp.asarray(active))
    _same(_flat(out), _flat(ref))


def _flat(tree, prefix=""):
    """A nested dict -> {"a/b": leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _unflat(flat):
    out = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out
