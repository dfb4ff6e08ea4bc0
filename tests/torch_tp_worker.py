"""One rank of the tensor-parallel checks of
tests/test_torch_tensor_parallel.py (run as a subprocess; imports torch
and the port only).

    python tests/torch_tp_worker.py IN.npz OUT.npz STORE RANK WORLD

``IN.npz`` holds, per configuration, the parameters (``<arch>/p/<i>``, in
the reference's flatten order) and the global batch (``<arch>/b/<key>``),
as tests/torch_dp_worker.py reads them.  With WORLD 2 the rank joins a
gloo group over the file STORE, builds a ``(data=1, model=2)`` mesh and
runs every entry point on its blocks: two l2l-p train steps (unpacked:
the sharded relay), grads, prefill, decode_init and two decode steps,
then two baseline steps and grads; for bert-large the knob points (one
step each), pack on, the Engine's own init, a snapshot beside the
meshless one, save / restore / two steps against four steps, and the
refusals.  With WORLD 4 it runs one bert-large train step and grads on a
``(data=2, model=2)`` mesh.  Whole trees are gathered over the model
group before they are written: results go to ``OUT.npz`` as flat arrays.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from torch_dp_worker import batch_of, flat

from repro_torch import bridge
from repro_torch import engine as engines
from repro_torch.configs.base import get_config
from repro_torch.core.schedule import ExecutionConfig
from repro_torch.core.tree import tree_map
from repro_torch.distributed.data_parallel import tree_checksum
from repro_torch.distributed.sharding import shard_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import is_spec
from repro_torch.models.model import LayeredModel

# chatglm3-6b's shape with one kv head: the kv leaves stay whole, the q
# heads split
ARCHS = ("bert-large", "granite-3-8b", "chatglm3-6b-kv1")
BASE = dict(n_microbatches=2, weight_stream=True, pack_params=False,
            prefetch_depth=1, transport="pallas", offload_stash=True)
KNOBS = ({}, dict(prefetch_depth=0), dict(layers_per_relay=2),
         dict(stash_every=2),
         dict(prefetch_depth=0, layers_per_relay=2, stash_every=2))
LIVE = 10                       # decode cache slots (prompt 8 + 2 steps)


def cfg_of(arch):
    if arch == "chatglm3-6b-kv1":
        return get_config("chatglm3-6b", "smoke").replace(
            dtype="float32", use_pallas=True, n_kv_heads=1)
    return get_config(arch, "smoke").replace(dtype="float32",
                                             use_pallas=True)


def params_of(inp, arch):
    like = LayeredModel(cfg_of(arch)).param_specs()
    it = iter(range(10 ** 6))
    return tree_map(lambda _: inp[f"{arch}/p/{next(it)}"], like,
                    is_leaf=is_spec)


def whole_state(pnp):
    """The whole unpacked state at step 0 as numpy trees."""
    opt = tree_map(lambda a: {"m": np.zeros(a.shape, np.float32),
                              "v": np.zeros(a.shape, np.float32)}, pnp)
    return pnp, {k: opt[k] for k in ("embed", "head", "groups")}


def rank_state(eng, pnp):
    p, o = whole_state(pnp)
    return bridge.train_state_to_rank(p, o, 0, eng.tp)


def gathered(eng, state):
    """(params, opt) of a rank's state, gathered whole, flat."""
    p, o, _, _ = bridge.gather_train_state(state, eng.tp)
    return flat(p), flat(o)


def train(eng, state, batch, put, tag, steps=2):
    for i in range(steps):
        state, m = eng.train_step(state, batch)
        put(f"{tag}/train{i}/loss", [float(m["loss"])])
        put(f"{tag}/train{i}/grad_norm", [float(m["grad_norm"])])
        if i == 0:
            # Adam's first step leaves m = (1 - b1)·g: the step's gradient
            _, o = gathered(eng, state)
            put(f"{tag}/train0/m", o[0::2])
            put(f"{tag}/train0/collectives",
                [m["model_collectives"][k] for k in ("sum", "max",
                                                     "gather")])
    return state


def entry_points(eng, pnp, batch, put, tag):
    state = train(eng, rank_state(eng, pnp), batch, put, tag)
    p, o = gathered(eng, state)
    put(f"{tag}/train/params", p)
    put(f"{tag}/whole", [tree_checksum(eng.tp.whole_leaves(state.params)),
                         tree_checksum(eng.tp.whole_leaves(
                             state.legacy_opt()))])
    params = bridge.params_to_rank(pnp, eng.tp)
    loss, grads = eng.grads(params, batch)
    put(f"{tag}/grads/loss", [float(loss)])
    put(f"{tag}/grads/grads", flat(bridge.gather_params(grads, eng.tp)))
    return params


def serve(eng, params, batch, put, tag):
    put(f"{tag}/prefill", [eng.prefill(params,
                                       {"tokens": batch["tokens"][:, :8]})])
    caches, last = eng.decode_init(params, batch["tokens"][:, :8], LIVE)
    logits = [last]
    for i in range(2):
        lg, caches = eng.decode_step(params, caches,
                                     batch["tokens"][:, 8 + i:9 + i], 8 + i)
        logits.append(lg[:, -1])
    put(f"{tag}/decode", logits)
    put(f"{tag}/cache_kv_heads", [caches[0]["k"].shape[3]])


def bert_only(inp, put, mesh, tmp):
    arch = "bert-large"
    cfg, pnp, batch = cfg_of(arch), params_of(inp, arch), batch_of(inp, arch)
    # the knob points, one train step each, inside the mesh
    for j, kw in enumerate(KNOBS):
        e = engines.create("l2l-p", cfg, ExecutionConfig(**{**BASE, **kw}),
                           device="cpu", mesh=mesh)
        new, m = e.train_step(rank_state(e, pnp), batch)
        p, o = gathered(e, new)
        put(f"knob{j}", [float(m["loss"])] + p + o)
    # pack on: the layers whole on both ranks, embed and head split
    e = engines.create("l2l-p", cfg, ExecutionConfig(**{**BASE,
                                                         "pack_params": True}),
                       device="cpu", mesh=mesh)
    train(e, rank_state(e, pnp), batch, put, "pack", steps=1)
    # the Engine's own init: the blocks of the one-process draw
    eng = engines.create("l2l-p", cfg, ExecutionConfig(**BASE),
                         device="cpu", mesh=mesh)
    st = eng.init(torch.Generator().manual_seed(3))
    put("init/rank", flat(bridge.train_state_to_numpy(st)[0]))
    one = engines.create("l2l-p", cfg, ExecutionConfig(**BASE), device="cpu")
    whole = one.init(torch.Generator().manual_seed(3))
    put("init/one", flat(eng.tp.shard(whole.params)))
    # a snapshot at M = 2 against the meshless one of the gathered state
    st = rank_state(eng, pnp)
    for _ in range(2):
        st, _ = eng.train_step(st, batch)
    eng.save(os.path.join(tmp, "tp"), st, step=2)
    p, o, _, _ = bridge.gather_train_state(st, eng.tp)
    if dist.get_rank() == 0:
        whole = bridge.train_state_from_numpy(p, o, 2)
        one.save(os.path.join(tmp, "one"), whole, step=2)
    dist.barrier()
    # save, restore and two more steps against four steps
    back, step = eng.restore(os.path.join(tmp, "tp"))
    for _ in range(2):
        back, _ = eng.train_step(back, batch)
        st, _ = eng.train_step(st, batch)
    put("restored", [step] + sum(gathered(eng, back), []))
    put("unbroken", [step] + sum(gathered(eng, st), []))


def refusals(inp, put, mesh):
    refused = []
    for arch in ("deepseek-v2-lite-16b", "hymba-1.5b"):
        try:
            engines.create("l2l-p", get_config(arch, "smoke"),
                           ExecutionConfig(), device="cpu", mesh=mesh)
            refused.append(0)
        except NotImplementedError:
            refused.append(1)
    eng = engines.create("l2l-p", cfg_of("bert-large"), ExecutionConfig(),
                         device="cpu", mesh=mesh)
    try:
        eng.serve_session(bridge.params_to_rank(
            params_of(inp, "bert-large"), eng.tp), max_batch=2, max_seq=16)
        refused.append(0)
    except NotImplementedError:
        refused.append(1)
    put("refused", refused)


def run_model(inp, put, tmp):
    mesh = make_mesh({"data": 1, "model": 2}, "cpu")
    for arch in ARCHS:
        cfg, pnp, batch = (cfg_of(arch), params_of(inp, arch),
                           batch_of(inp, arch))
        mine = lambda k, v, _a=arch: put(f"{_a}/{k}", v)
        eng = engines.create("l2l-p", cfg, ExecutionConfig(**BASE),
                             device="cpu", mesh=mesh)
        params = entry_points(eng, pnp, batch, mine, "l2l")
        serve(eng, params, batch, mine, "l2l")
        base = engines.create("baseline", cfg, ExecutionConfig(**BASE),
                              device="cpu", mesh=mesh)
        entry_points(base, pnp, batch, mine, "base")
    bert_only(inp, put, mesh, tmp)
    refusals(inp, put, mesh)


def run_data_model(inp, put):
    mesh = make_mesh({"data": 2, "model": 2}, "cpu")
    arch = "bert-large"
    pnp = params_of(inp, arch)
    batch = shard_batch(batch_of(inp, arch), mesh, {"batch": ("data",)})
    eng = engines.create("l2l-p", cfg_of(arch), ExecutionConfig(**BASE),
                         device="cpu", mesh=mesh)
    train(eng, rank_state(eng, pnp), batch, put, "dm", steps=1)


def main(argv):
    inp_path, out_path, store, rank, world = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    inp = np.load(inp_path)
    out = {}

    def put(key, arrays):
        for i, a in enumerate(arrays):
            out[f"{key}/{i}"] = np.asarray(a)

    if world == 2:
        run_model(inp, put, os.path.dirname(out_path))
    else:
        run_data_model(inp, put)
    dist.destroy_process_group()
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
