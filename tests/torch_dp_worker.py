"""One rank of the data-parallel checks of tests/test_torch_data_parallel.py
(run as a subprocess; imports torch and the port only).

    python tests/torch_dp_worker.py IN.npz OUT.npz STORE RANK WORLD

``IN.npz`` holds, per architecture, the parameters (``<arch>/p/<i>``, in
the reference's flatten order) and the global batch (``<arch>/b/<key>``).
With WORLD 2 the rank joins a gloo group over the file STORE and runs,
on its rows of the batch (``shard_batch``), every entry point of an l2l-p
engine on a ``data=2`` mesh: two train steps, grads, prefill,
decode_init and two decode steps; then the knob points, each one train
step; then the mesh checks of the Engine (MoE on two data ranks and on
a model axis of 2 and the VLM family on a model axis of 2 accepted,
``serve_session`` on two data ranks refused).
With WORLD 1 it runs the same entry points on a ``data=1`` mesh and
without a mesh.  Results go to ``OUT.npz`` as flat arrays.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch import engine as engines
from repro_torch.configs.base import get_config
from repro_torch.core.schedule import ExecutionConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.distributed.sharding import shard_batch
from repro_torch.launch.mesh import (make_debug_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.models.common import is_spec
from repro_torch.models.model import LayeredModel

ARCHS = ("bert-large", "granite-3-8b")
BASE = dict(n_microbatches=2, weight_stream=True, pack_params=True,
            prefetch_depth=1, transport="pallas", offload_stash=True)
KNOBS = ({}, dict(prefetch_depth=0), dict(layers_per_relay=2),
         dict(stash_every=2), dict(pack_params=False),
         dict(prefetch_depth=0, layers_per_relay=2, stash_every=2,
              pack_params=False))
LIVE = 10                       # decode cache slots (prompt 8 + 2 steps)


def cfg_of(arch):
    return get_config(arch, "smoke").replace(dtype="float32",
                                             use_pallas=True)


def params_of(inp, arch):
    """The numpy parameter tree of ``arch`` from IN.npz."""
    like = LayeredModel(cfg_of(arch)).param_specs()
    it = iter(range(10 ** 6))
    return tree_map(lambda _: inp[f"{arch}/p/{next(it)}"], like,
                    is_leaf=is_spec)


def state_of(pnp):
    """An unpacked TrainState at step 0: the params, zeroed Adam slots."""
    opt = tree_map(lambda a: {"m": np.zeros(a.shape, np.float32),
                              "v": np.zeros(a.shape, np.float32)}, pnp)
    return bridge.train_state_from_numpy(
        pnp, {k: opt[k] for k in ("embed", "head", "groups")}, 0)


def batch_of(inp, arch):
    pre = f"{arch}/b/"
    return {k[len(pre):]: torch.from_numpy(inp[k]) for k in inp.files
            if k.startswith(pre)}


def flat(tree):
    return [np.asarray(a) for a in tree_leaves(tree)]


def entry_points(eng, params, batch, put, serve=True):
    """Every entry point on this rank's rows (``serve``: prefill and
    decode too); results through put(name, arrays)."""
    state = state_of(params)
    eng.check_replicas(state)
    params = bridge.params_from_numpy(params)
    for i in range(2):
        state, m = eng.train_step(state, batch)
        put(f"train{i}/loss", [float(m["loss"])])
        put(f"train{i}/grad_norm", [float(m["grad_norm"])])
        put(f"train{i}/weight_sum", [float(m["weight_sum"])])
        if "all_reduces" in m:
            put(f"train{i}/all_reduces", [m["all_reduces"]])
    p, o, _, _ = bridge.train_state_to_numpy(state)
    put("train/params", flat(p))
    put("train/opt", flat(o))
    loss, grads = eng.grads(params, batch)
    put("grads/loss", [float(loss)])
    put("grads/grads", flat(grads))
    if not serve:
        return state
    put("prefill", [eng.prefill(params, {"tokens": batch["tokens"][:, :8]})])
    # decode: the prompt, then the batch's next two tokens (teacher forced)
    caches, last = eng.decode_init(params, batch["tokens"][:, :8], LIVE)
    logits = [last]
    for i in range(2):
        lg, caches = eng.decode_step(params, caches,
                                     batch["tokens"][:, 8 + i:9 + i], 8 + i)
        logits.append(lg[:, -1])
    put("decode", logits)
    return state


def run_dp(inp, put, world):
    mesh = make_debug_mesh(data=world, model=1, device_type="cpu")
    # the production mesh needs its 256 ranks: the assert names both sizes
    try:
        make_production_mesh(device_type="cpu")
        put("production_mesh", [""])
    except AssertionError as e:
        put("production_mesh", [str(e)])
    for arch in ARCHS:
        cfg = cfg_of(arch)
        params = params_of(inp, arch)
        batch = shard_batch(batch_of(inp, arch), mesh,
                            {"batch": ("data",)})
        eng = engines.create("l2l-p", cfg, ExecutionConfig(**BASE),
                             device="cpu", mesh=mesh)
        entry_points(eng, params, batch,
                     lambda k, v, _a=arch: put(f"{_a}/{k}", v))
        # the knob points, one train step each, inside the mesh
        st0 = state_of(params)
        for j, kw in enumerate(KNOBS):
            e = engines.create("l2l-p", cfg, ExecutionConfig(**{**BASE,
                                                                 **kw}),
                               device="cpu", mesh=mesh)
            new, m = e.train_step(st0, batch)
            p, o, _, _ = bridge.train_state_to_numpy(new)
            put(f"{arch}/knob{j}", [float(m["loss"])] + flat(p) + flat(o))
    refused = []
    # MoE runs on both axes (tests/test_torch_moe_parallel.py), the VLM
    # family on the model axis (tests/test_torch_modality_parallel.py):
    # 0, 0, 0
    for arch, shape in (("deepseek-v2-lite-16b", {"data": world,
                                                  "model": 1}),
                        ("deepseek-v2-lite-16b", {"data": 1,
                                                  "model": world}),
                        ("internvl2-1b", {"data": 1, "model": world})):
        m = mesh if shape["data"] == world else make_mesh(shape, "cpu")
        try:
            engines.create("l2l-p", get_config(arch, "smoke"),
                           ExecutionConfig(), device="cpu", mesh=m)
            refused.append(0)
        except NotImplementedError:
            refused.append(1)
    # serve_session on two data ranks (continuous batching runs on one)
    eng = engines.create("l2l-p", cfg_of("bert-large"), ExecutionConfig(),
                         device="cpu", mesh=mesh)
    try:
        eng.serve_session(bridge.params_from_numpy(
            params_of(inp, "bert-large")), max_batch=2, max_seq=16)
        refused.append(0)
    except NotImplementedError:
        refused.append(1)
    put("refused", refused)


def run_one(inp, put):
    mesh = make_mesh({"data": 1, "model": 1}, "cpu")
    for arch in ARCHS:
        cfg = cfg_of(arch)
        params = params_of(inp, arch)
        batch = batch_of(inp, arch)
        for tag, m in (("mesh", mesh), ("none", None)):
            for name in ("l2l-p", "baseline"):
                eng = engines.create(name, cfg, ExecutionConfig(**BASE),
                                     device="cpu", mesh=m)
                # prefill and decode make no collective on any engine
                entry_points(eng, params, batch,
                             lambda k, v, _p=f"{arch}/{tag}/{name}/":
                             put(_p + k, v), serve=name == "l2l-p")


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

    if world == 1:
        run_one(inp, put)
    else:
        run_dp(inp, put, world)
    dist.destroy_process_group()
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
