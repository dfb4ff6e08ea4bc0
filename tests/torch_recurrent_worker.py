"""One rank of the recurrent families' mesh checks of
tests/test_torch_recurrent_parallel.py (run as a subprocess; imports
torch and the port only).

    python tests/torch_recurrent_worker.py IN.npz OUT.npz STORE RANK WORLD

``IN.npz`` holds, per case of ``CASES``, the parameters (``<case>/p/<i>``,
in the reference's flatten order) and the global batch
(``<case>/b/<key>``).  With WORLD 2 the rank joins a gloo group over the
file STORE, builds a ``(data=1, model=2)`` mesh and runs every entry
point of each case on its blocks: two l2l-p train steps (unpacked: the
sharded relay), grads, prefill, decode_init and two decode steps (the
cache's local shapes beside), then two steps and grads under l2l (Alg 3)
and the baseline; rank 0 runs two steps and grads of each case on the
port's meshless engine; for hymba with heads that do not divide and
rwkv6 the knob points (one step each), pack on, and a snapshot beside the
meshless one.  With WORLD 4 it runs one step, grads, prefill and decode of each
case on ``(data=2, model=2)``, each rank on its rows of every call.
Whole trees are gathered over the model group before they are written:
results go to ``OUT.npz`` as flat arrays.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from torch_dp_worker import batch_of, flat
from torch_tp_worker import BASE, KNOBS, gathered, whole_state

from repro_torch import bridge
from repro_torch import engine as engines
from repro_torch.configs.base import get_config
from repro_torch.core.schedule import ExecutionConfig
from repro_torch.core.tree import tree_map
from repro_torch.distributed.data_parallel import tree_checksum
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import is_spec
from repro_torch.models.model import LayeredModel

# hymba smoke splits its 4 q and 2 kv heads over 2 ranks; with 5 q heads
# over 1 kv head (GQA 5, as the full config's 25 over 5) the attention
# runs whole on every rank while mamba and the MLP split, as on the card
CASES = {"hymba": ("hymba-1.5b", {}),
         "hymba-h5": ("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 1}),
         "rwkv6": ("rwkv6-1.6b", {})}
# the cases of the knob, pack and snapshot checks
MORE = ("hymba-h5", "rwkv6")
LIVE = 10                       # decode cache slots (prompt 8 + 2 steps)


def cfg_of(case, get=get_config):
    name, kw = CASES[case]
    return get(name, "smoke").replace(dtype="float32", **kw)


def params_of(inp, case):
    like = LayeredModel(cfg_of(case)).param_specs()
    it = iter(range(10 ** 6))
    return tree_map(lambda _: inp[f"{case}/p/{next(it)}"], like,
                    is_leaf=is_spec)


def rank_state(eng, pnp):
    if eng.tp is None:
        return bridge.train_state_from_numpy(*whole_state(pnp), 0)
    return bridge.train_state_to_rank(*whole_state(pnp), 0, eng.tp)


def cache_shapes(cfg, caches):
    """The shapes of one group's stacked decode cache: hymba's kv ring and
    mamba state, rwkv6's wkv state and shifts."""
    c = caches[0]
    if cfg.family == "hybrid":
        return [c["kv"]["k"].shape, c["ssm"]["h"].shape,
                c["ssm"]["conv"].shape]
    return [c["wkv"].shape, c["tm_shift"].shape, c["cm_shift"].shape]


def entry_points(eng, case, inp, put, tag, serve=True, steps=2):
    """``steps`` train steps (losses, grad norms, the first step's Adam m
    gathered whole, its collectives), the leaves no pspec splits
    (checksums), grads (gathered whole) and, with ``serve``, prefill and
    decode_init with two decode steps; each call on this rank's rows (its
    block of each microbatch), with their global indices.  Without a mesh
    (``eng.tp`` None): the steps and grads alone."""
    pnp, whole = params_of(inp, case), batch_of(inp, case)
    rows, tp = eng.local_rows, eng.tp
    batch = rows(whole, "train_step")
    st = rank_state(eng, pnp)
    for i in range(steps):
        st, m = eng.train_step(st, batch)
        put(f"{tag}/train{i}/loss", [float(m["loss"])])
        put(f"{tag}/train{i}/grad_norm", [float(m["grad_norm"])])
        if i == 0 and tp is None:
            put(f"{tag}/train0/m",
                flat(bridge.train_state_to_numpy(st)[1])[0::2])
        elif i == 0:
            put(f"{tag}/train0/m", gathered(eng, st)[1][0::2])
            put(f"{tag}/train0/collectives",
                [m["model_collectives"][k] for k in ("sum", "max",
                                                     "gather")])
    if tp is None:
        loss, grads = eng.grads(bridge.params_from_numpy(pnp), batch)
        put(f"{tag}/grads/loss", [float(loss)])
        put(f"{tag}/grads/grads", flat(bridge.params_to_numpy(grads)))
        return
    put(f"{tag}/whole", [tree_checksum(tp.whole_leaves(st.params)),
                         tree_checksum(tp.whole_leaves(st.legacy_opt()))])
    params = bridge.params_to_rank(pnp, tp)
    loss, grads = eng.grads(params, batch)
    put(f"{tag}/grads/loss", [float(loss)])
    put(f"{tag}/grads/grads", flat(bridge.gather_params(grads, tp)))
    put(f"{tag}/grads/whole", [tree_checksum(tp.whole_leaves(grads))])
    if not serve:
        return
    B = whole["tokens"].shape[0]
    prompt = whole["tokens"][:, :8]
    put(f"{tag}/prefill", [eng.prefill(params,
                                       rows({"tokens": prompt}, "prefill"))])
    put(f"{tag}/prefill_rows",
        [rows({"i": torch.arange(B)}, "prefill")["i"]])
    caches, last = eng.decode_init(
        params, rows({"t": prompt}, "decode_init")["t"], LIVE)
    logits = [last]
    for i in range(2):
        tok = rows({"t": whole["tokens"][:, 8 + i:9 + i]},
                   "decode_step")["t"]
        lg, caches = eng.decode_step(params, caches, tok, 8 + i)
        logits.append(lg[:, -1])
    put(f"{tag}/decode", logits)
    put(f"{tag}/decode_rows",
        [rows({"i": torch.arange(B)}, "decode_step")["i"]])
    put(f"{tag}/cache_shapes", [list(s) for s in cache_shapes(
        eng.model.cfg, caches)])


def knobs(case, inp, put, mesh, cfg_of=cfg_of, params_of=params_of):
    """The knob points inside the mesh, one train step each (``cfg_of`` /
    ``params_of``: a worker's own cases)."""
    cfg, pnp, batch = cfg_of(case), params_of(inp, case), batch_of(inp, case)
    for j, kw in enumerate(KNOBS):
        e = engines.create("l2l-p", cfg, ExecutionConfig(**{**BASE, **kw}),
                           device="cpu", mesh=mesh)
        new, m = e.train_step(rank_state(e, pnp), batch)
        p, o, _, _ = bridge.gather_train_state(new, e.tp)
        put(f"{case}/knob{j}", [float(m["loss"])] + flat(p) + flat(o))


def pack_and_snapshot(case, inp, put, mesh, tmp, cfg_of=cfg_of,
                      params_of=params_of):
    """Pack on (the layers whole on both ranks), one step; then a snapshot
    at M = 2 after one step beside the meshless one of the gathered
    state."""
    cfg, pnp, batch = cfg_of(case), params_of(inp, case), batch_of(inp, case)
    e = engines.create("l2l-p", cfg, ExecutionConfig(**{**BASE,
                                                         "pack_params": True}),
                       device="cpu", mesh=mesh)
    new, m = e.train_step(rank_state(e, pnp), batch)
    put(f"{case}/pack/train0/loss", [float(m["loss"])])
    put(f"{case}/pack/train0/m", gathered(e, new)[1][0::2])
    ex = ExecutionConfig(**BASE)
    eng = engines.create("l2l-p", cfg, ex, device="cpu", mesh=mesh)
    st, _ = eng.train_step(rank_state(eng, pnp), batch)
    eng.save(os.path.join(tmp, f"{case}_tp"), st, step=1)
    p, o, _, _ = bridge.gather_train_state(st, eng.tp)
    if dist.get_rank() == 0:
        one = engines.create("l2l-p", cfg, ex, device="cpu")
        one.save(os.path.join(tmp, f"{case}_one"),
                 bridge.train_state_from_numpy(p, o, 1), step=1)
    dist.barrier()


def main(argv):
    inp_path, out_path, store, rank, world = argv[:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    inp = np.load(inp_path)
    out = {}

    def put(key, arrays):
        for i, a in enumerate(arrays):
            out[f"{key}/{i}"] = np.asarray(a)

    ex = ExecutionConfig(**BASE)
    if world == 4:
        mesh = make_mesh({"data": 2, "model": 2}, "cpu")
        for case in CASES:
            eng = engines.create("l2l-p", cfg_of(case), ex, device="cpu",
                                 mesh=mesh)
            entry_points(eng, case, inp, put, f"{case}/dm", steps=1)
    else:
        mesh = make_mesh({"data": 1, "model": 2}, "cpu")
        for case in CASES:
            for name in ("l2l-p", "l2l", "baseline"):
                eng = engines.create(name, cfg_of(case), ex, device="cpu",
                                     mesh=mesh)
                entry_points(eng, case, inp, put, f"{case}/{name}",
                             serve=name == "l2l-p")
        if rank == 0:
            # the port's meshless engine: two steps and grads
            for case in CASES:
                one = engines.create("l2l-p", cfg_of(case), ex, device="cpu")
                entry_points(one, case, inp, put, f"{case}/one",
                             serve=False)
        for case in MORE:
            knobs(case, inp, put, mesh)
            pack_and_snapshot(case, inp, put, mesh,
                              os.path.dirname(out_path))
    dist.destroy_process_group()
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
