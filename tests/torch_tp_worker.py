"""One rank of the tensor-parallel checks of
tests/test_torch_tensor_parallel.py and of the MoE mesh checks of
tests/test_torch_moe_parallel.py (run as a subprocess; imports torch and
the port only).

    python tests/torch_tp_worker.py IN.npz OUT.npz STORE RANK WORLD [moe]

``IN.npz`` holds, per configuration, the parameters (``<arch>/p/<i>``,
in the reference's flatten order) and the global batch
(``<arch>/b/<key>``), as tests/torch_dp_worker.py reads them.  With
WORLD 2 the rank joins a gloo group over the file STORE, builds a
``(data=1, model=2)`` mesh and runs every entry point on its blocks: two
l2l-p train steps (unpacked: the sharded relay), grads, prefill,
decode_init and two decode steps, then two baseline steps and grads; for
bert-large the knob points (one step each), pack on, the Engine's own
init, a snapshot beside the meshless one, save / restore / two steps
against four steps, and the refusal (``serve_session`` on a mesh; the
hybrid, SSM, VLM and audio families build).  With WORLD 4 it runs one bert-large train step and grads on a
``(data=2, model=2)`` mesh.  Whole trees are gathered over the model
group before they are written: results go to ``OUT.npz`` as flat arrays.

With ``moe`` (the MoE family, ``MOE_CASES``): WORLD 2 runs
deepseek-v2-lite and grok-1 (and grok-1 with 3 experts: tensor parallel
inside them) on ``(data=1, model=2)``, then deepseek-v2-lite (and at a
capacity that drops pairs) on ``(data=2, model=1)`` over the same two
ranks, each rank on its block of every microbatch: every entry point,
the baseline once, the knob points, pack on, a snapshot beside the
meshless one, and the dispatch at the function level (the pairs the
global dispatch keeps; the grouped dispatch, ``moe_ep_constraint``);
WORLD 4 runs deepseek-v2-lite on ``(data=2, model=2)``.
"""
import math
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
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten_like
from repro_torch.distributed.data_parallel import tree_checksum
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
# the MoE cases: (arch, config overrides); grok-1 with 3 experts puts
# expert_ffn on "model" (3 experts do not split over 2 ranks); the
# dropping capacity keeps ceil(32·6/64·0.5) = 2 of ~6 pairs an expert
MOE_CASES = {"deepseek": ("deepseek-v2-lite-16b", {}),
             "grok": ("grok-1-314b", {}),
             "grok-e3": ("grok-1-314b", {"n_experts": 3}),
             "deepseek-drop": ("deepseek-v2-lite-16b",
                               {"capacity_factor": 0.5})}


def cfg_of(arch):
    if arch in MOE_CASES:
        name, kw = MOE_CASES[arch]
        return get_config(name, "smoke").replace(dtype="float32", **kw)
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
    """Each family on the model axis (the hybrid, SSM, VLM and audio
    families build) and ``serve_session`` on a mesh: 1 where
    NotImplementedError is raised, its message beside."""
    refused, said = [], []
    for arch in ("hymba-1.5b", "rwkv6-1.6b", "internvl2-1b", "whisper-base"):
        try:
            engines.create("l2l-p", get_config(arch, "smoke"),
                           ExecutionConfig(), device="cpu", mesh=mesh)
            refused.append(0)
        except NotImplementedError as e:
            refused.append(1)
            said.append(str(e))
    eng = engines.create("l2l-p", cfg_of("bert-large"), ExecutionConfig(),
                         device="cpu", mesh=mesh)
    try:
        eng.serve_session(bridge.params_to_rank(
            params_of(inp, "bert-large"), eng.tp), max_batch=2, max_seq=16)
        refused.append(0)
    except NotImplementedError as e:
        refused.append(1)
        said.append(str(e))
    put("refused", refused)
    put("refused_messages", said)


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
    eng = engines.create("l2l-p", cfg_of(arch), ExecutionConfig(**BASE),
                         device="cpu", mesh=mesh)
    batch = eng.local_rows(batch_of(inp, arch), "train_step")
    train(eng, rank_state(eng, pnp), batch, put, "dm", steps=1)


# ---------------------------------------------------------------------------
# MoE on the mesh
# ---------------------------------------------------------------------------
def moe_entry_points(eng, case, inp, put, tag, serve=True, steps=2):
    """Two train steps (loss, grad norm, aux; the first step's Adam m
    gathered whole), grads (whole), the whole-leaf checksums and, with
    ``serve``, prefill (this rank's rows and their global indices) and
    decode_init with two decode steps, on this rank's rows of every
    call (its block of each microbatch)."""
    pnp, whole = params_of(inp, case), batch_of(inp, case)
    rows = eng.local_rows
    batch = rows(whole, "train_step")
    tp = eng.tp
    st = (rank_state(eng, pnp) if tp is not None
          else bridge.train_state_from_numpy(*whole_state(pnp), 0))
    for i in range(steps):
        st, m = eng.train_step(st, batch)
        put(f"{tag}/train{i}/loss", [float(m["loss"])])
        put(f"{tag}/train{i}/grad_norm", [float(m["grad_norm"])])
        if "aux" in m:
            put(f"{tag}/train{i}/aux", [float(m["aux"])])
        if i == 0:
            o = (gathered(eng, st)[1] if tp is not None
                 else flat(bridge.train_state_to_numpy(st)[1]))
            put(f"{tag}/train0/m", o[0::2])
            put(f"{tag}/train0/moe", [m.get("moe_collectives", {}).get(k, 0)
                                      for k in ("stats", "counts")])
            put(f"{tag}/train0/all_reduces", [m.get("all_reduces", 0)])
    if tp is not None:
        put(f"{tag}/whole", [tree_checksum(tp.whole_leaves(st.params)),
                             tree_checksum(tp.whole_leaves(
                                 st.legacy_opt()))])
        params = bridge.params_to_rank(pnp, tp)
    else:
        params = bridge.params_from_numpy(pnp)
    put(f"{tag}/params", [tree_checksum(st.params)])
    loss, grads = eng.grads(params, batch)
    put(f"{tag}/grads/loss", [float(loss)])
    g = (bridge.gather_params(grads, tp) if tp is not None
         else bridge.params_to_numpy(grads))
    put(f"{tag}/grads/grads", flat(g))
    put(f"{tag}/grads/router", [g["groups"][-1]["ffn"]["router"]])
    if tp is not None:
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


def moe_dispatch(inp, put, mesh):
    """The dispatch at the function level on the data ranks: the pairs
    the global dispatch keeps at a dropping capacity, and the grouped
    dispatch's output, aux and vjp (``moe_ep_constraint``)."""
    from repro_torch.distributed.data_parallel import DataParallel
    from repro_torch.models import moe
    dp = DataParallel(mesh)
    w = tree_map(torch.from_numpy, params_of(inp, "deepseek-drop")
                 ["groups"][-1]["ffn"])
    w = tree_map(lambda a: a[0].clone(), w)           # the first MoE layer
    x = rows_of(torch.from_numpy(inp["fn/x"]), dp)
    cfg = cfg_of("deepseek-drop")
    xf = x.reshape(-1, x.shape[-1])
    _, top_i, _ = moe._route(w, xf, cfg, dp=dp)
    E, k = cfg.n_experts, cfg.experts_per_token
    counts = torch.nn.functional.one_hot(top_i.reshape(-1), E).sum(0)
    offset = dp.gather_counts(counts)[:dp.rank].sum(0)
    T = xf.shape[0] * dp.world
    C = min(max(1, math.ceil(T * k / E * cfg.capacity_factor)), T)
    keep = moe._dispatch(xf, top_i, C, E, k, offset=offset)[2]
    put("fn/keep", [keep])
    # the grouped dispatch, with its vjp (each rank's share of dw)
    g_cfg = cfg.replace(moe_ep_constraint=True)
    leaves = [a.requires_grad_() for a in tree_leaves(w)]
    wl = tree_unflatten_like(w, leaves)
    xg = x.clone().requires_grad_()
    before = dict(dp.moe_calls)
    y, aux = moe.moe_apply(wl, xg, g_cfg, dp=dp)
    ct = rows_of(torch.from_numpy(inp["fn/ct"]), dp)
    torch.autograd.backward([y, aux], [ct, torch.tensor(0.5)])
    put("fn/grouped", [y.detach(), aux.detach(), xg.grad]
        + [a.grad for a in leaves])
    put("fn/moe", [dp.moe_calls[k] - before[k] for k in ("stats", "counts")])


def rows_of(a, dp):
    per = a.shape[0] // dp.world
    return a[dp.rank * per:(dp.rank + 1) * per]


def run_moe(inp, put, tmp, world):
    ex = ExecutionConfig(**BASE)
    if world == 4:
        mesh = make_mesh({"data": 2, "model": 2}, "cpu")
        eng = engines.create("l2l-p", cfg_of("deepseek"), ex, device="cpu",
                             mesh=mesh)
        moe_entry_points(eng, "deepseek", inp, put, "dm", steps=1)
        return
    mesh = make_mesh({"data": 1, "model": 2}, "cpu")
    for case in ("deepseek", "grok", "grok-e3"):
        eng = engines.create("l2l-p", cfg_of(case), ex, device="cpu",
                             mesh=mesh)
        moe_entry_points(eng, case, inp, put, f"{case}/tp",
                         serve=case != "grok-e3")
    cfg, pnp = cfg_of("deepseek"), params_of(inp, "deepseek")
    base = engines.create("baseline", cfg, ex, device="cpu", mesh=mesh)
    moe_entry_points(base, "deepseek", inp, put, "deepseek/base",
                     serve=False)
    batch = batch_of(inp, "deepseek")
    knobs(cfg, pnp, batch, put, mesh, "tp")
    # pack on: the layers whole on both ranks, embed and head split
    e = engines.create("l2l-p", cfg, ExecutionConfig(**{**BASE,
                                                         "pack_params": True}),
                       device="cpu", mesh=mesh)
    new, m = e.train_step(rank_state(e, pnp), batch)
    put("pack/train0/loss", [float(m["loss"])])
    put("pack/train0/m", gathered(e, new)[1][0::2])
    # a snapshot at M = 2 against the meshless one of the gathered state
    eng = engines.create("l2l-p", cfg, ex, device="cpu", mesh=mesh)
    st, _ = eng.train_step(rank_state(eng, pnp), batch)
    eng.save(os.path.join(tmp, "moe_tp"), st, step=1)
    p, o, _, _ = bridge.gather_train_state(st, eng.tp)
    if dist.get_rank() == 0:
        one = engines.create("l2l-p", cfg, ex, device="cpu")
        one.save(os.path.join(tmp, "moe_one"),
                 bridge.train_state_from_numpy(p, o, 1), step=1)
    dist.barrier()
    mesh = make_mesh({"data": 2, "model": 1}, "cpu")
    for case in ("deepseek", "deepseek-drop"):
        eng = engines.create("l2l-p", cfg_of(case), ex, device="cpu",
                             mesh=mesh)
        moe_entry_points(eng, case, inp, put, f"{case}/dp")
    if dist.get_rank() == 0:
        # the dropping capacity without a mesh (the port's meshless engine
        # is held to the reference's in tests/test_torch_moe.py)
        one = engines.create("l2l-p", cfg_of("deepseek-drop"), ex,
                             device="cpu")
        moe_entry_points(one, "deepseek-drop", inp, put, "deepseek-drop/one")
    knobs(cfg, pnp, eng.local_rows(batch, "train_step"), put, mesh, "dp")
    moe_dispatch(inp, put, mesh)


def knobs(cfg, pnp, batch, put, mesh, tag):
    """The knob points inside the mesh, one train step each."""
    for j, kw in enumerate(KNOBS):
        e = engines.create("l2l-p", cfg, ExecutionConfig(**{**BASE, **kw}),
                           device="cpu", mesh=mesh)
        st = (rank_state(e, pnp) if e.tp is not None
              else bridge.train_state_from_numpy(*whole_state(pnp), 0))
        new, m = e.train_step(st, batch)
        p, o, _, _ = (bridge.gather_train_state(new, e.tp) if e.tp
                      is not None else bridge.train_state_to_numpy(new))
        put(f"{tag}/knob{j}", [float(m["loss"])] + flat(p) + flat(o))


def main(argv):
    inp_path, out_path, store, rank, world = argv[:5]
    moe = argv[5:] == ["moe"]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    inp = np.load(inp_path)
    out = {}

    def put(key, arrays):
        for i, a in enumerate(arrays):
            out[f"{key}/{i}"] = np.asarray(a)

    if moe:
        run_moe(inp, put, os.path.dirname(out_path), world)
    elif world == 2:
        run_model(inp, put, os.path.dirname(out_path))
    else:
        run_data_model(inp, put)
    dist.destroy_process_group()
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
