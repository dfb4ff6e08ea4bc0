"""The MoE family on the mesh on the CPU: expert parallelism (and tensor
parallelism inside the experts where they do not divide) and MLA's heads
over the model axis, the router's statistics and the capacity dispatch
over the data axes.  Gloo ranks (tests/torch_tp_worker.py with ``moe``:
two ranks on ``(data=1, model=2)`` then ``(data=2, model=1)``, four on
``(data=2, model=2)``), each on its blocks and its block of every
microbatch, gathered and held to the JAX reference's meshless engine at
the global batch on the same numpy inputs: train step, grads, prefill and
decode within ``test_torch_tensor_parallel.py``'s bounds, the aux loss
and the router's gradient, the leaves no pspec splits bit for bit equal
across the ranks, the relay knobs bit for bit inside the mesh, pack on
within the bounds of pack off, a snapshot at M = 2 byte for byte the
meshless one.  At a dropping capacity on two data ranks, the train
steps and grads against the reference's meshless engine, prefill and
decode against the port's meshless engine (which tests/test_torch_moe.py
holds to the reference at such a capacity).  At the function level on
two data ranks: the pairs a dropping capacity's global dispatch keeps
are the reference's, and the grouped dispatch (``moe_ep_constraint``) is
the reference's grouped path run as the reference runs it, under ``with
mesh:`` over two forced host devices in a JAX subprocess.  The train CLI
on two data ranks.

deepseek-v2-lite (MLA, 4 experts top-2 and a shared expert, a dense
layer 0) and grok-1 (GQA, 4 experts top-2, no shared) at smoke size, and
grok-1 with 3 experts; f32, parameters drawn with numpy at fan-in scales
(``repro_torch.testing.fan_in_params``).  One spawn of the six processes,
the JAX subprocess and the CLI for the module; the JAX reference runs
beside them."""
import json
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import engine as jengines  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core.schedule import ExecutionConfig as JExec  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.tensor_parallel import \
    TensorParallel  # noqa: E402
from repro_torch.models.model import LayeredModel  # noqa: E402
from repro_torch.testing import fan_in_params  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
# torch_tp_worker.MOE_CASES, as the JAX configs read them
CASES = {"deepseek": ("deepseek-v2-lite-16b", {}),
         "grok": ("grok-1-314b", {}),
         "grok-e3": ("grok-1-314b", {"n_experts": 3}),
         "deepseek-drop": ("deepseek-v2-lite-16b", {"capacity_factor": 0.5})}
N_KNOBS = 5                      # torch_tp_worker.KNOBS, the first the base
B, S, UB = 8, 16, 2
LOSS_REL, GRAD_REL, LOGIT_REL = 1e-5, 1e-4, 1e-4
WHATS = ("train", "grads", "prefill", "decode")


def _cfg(case, get=get_config):
    name, kw = CASES[case]
    return get(name, "smoke").replace(dtype="float32", **kw)


def _draw(case):
    """numpy parameters (port flatten order) and a global batch."""
    rs = np.random.RandomState(20 + list(CASES).index(case))
    cfg = _cfg(case)
    params = fan_in_params(LayeredModel(cfg).param_specs(),
                           lambda shape: rs.randn(*shape))
    leaves = [np.asarray(a, np.float32) for a in tree_leaves(params)]
    mask = np.ones((B, S), np.float32)
    mask[1, -3:] = 0.0                      # a weighted loss, as padding
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "mask": mask}
    return leaves, batch


def _env(**kw):
    return {**os.environ, "PYTHONPATH": f"{SRC}{os.pathsep}{HERE}",
            "OMP_NUM_THREADS": "1", **kw}


def _spawn(tmp, inp, world):
    store = str(tmp / f"store{world}")
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_tp_worker.py"), inp,
         str(tmp / f"out{world}_{r}.npz"), store, str(r), str(world), "moe"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env()) for r in range(world)]


def _cli(tmp):
    """The train CLI on two data ranks under ``torch.distributed.run``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port", str(port),
         "-m", "repro_torch.launch.train", "--device", "cpu",
         "--mesh", "data=2", "--arch", "deepseek-v2-lite-16b", "--variant",
         "smoke", "--batch", "4", "--seq", "16", "--ub", "2", "--steps", "2",
         "--weight-stream", "--ckpt-dir", str(tmp / "ck")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env())


GROUPED = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.base import get_config
from repro.models import moe
inp = np.load({inp!r})
cfg = get_config("deepseek-v2-lite-16b", "smoke").replace(
    dtype="float32", capacity_factor=0.5, moe_ep_constraint=True)
names = sorted(k for k in inp.files if k.startswith("fn/w/"))
w = {{}}
for k in names:
    node = w
    parts = k[len("fn/w/"):].split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {{}})
    node[parts[-1]] = jnp.asarray(inp[k])
x, ct = jnp.asarray(inp["fn/x"]), jnp.asarray(inp["fn/ct"])
mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
f = lambda w, x: moe.moe_apply(w, x, cfg)
with mesh:
    (y, aux), vjp = jax.vjp(jax.jit(f), w, x)
    dw, dx = vjp((ct, jnp.float32(0.5)))
out = {{"y": np.asarray(y), "aux": np.asarray(aux), "dx": np.asarray(dx)}}
out.update({{"dw/" + "/".join(str(getattr(k, "key", k)) for k in path):
             np.asarray(a) for path, a in
             jax.tree_util.tree_flatten_with_path(dw)[0]}})
# the meshless global dispatch of the same input: the pairs it keeps
cfg = cfg.replace(moe_ep_constraint=False)
xf = x.reshape(-1, cfg.d_model)
_, top_i, _ = moe._route(w, xf, cfg)
T, E, k = xf.shape[0], cfg.n_experts, cfg.experts_per_token
C = min(max(1, int(np.ceil(T * k / E * cfg.capacity_factor))), T)
out["keep"] = np.asarray(moe._dispatch(xf, top_i, C, E, k)[2])
out["y_global"] = np.asarray(jax.jit(f)(w, x)[0])
np.savez({out!r}, **out)
"""


def _grouped(tmp, inp):
    """The reference's grouped dispatch on a (data=2, model=1) mesh of two
    forced host devices, in a JAX subprocess."""
    code = GROUPED.format(src=SRC, inp=inp, out=str(tmp / "grouped.npz"))
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=_env(JAX_PLATFORMS="cpu"))


def _fn_inputs(leaves):
    """One MoE layer's weights (the first of deepseek's MoE group) and an
    input and cotangent for the function-level dispatch checks."""
    cfg = _cfg("deepseek")
    specs = LayeredModel(cfg).param_specs()
    flat = iter(leaves)
    params = tree_map(lambda _: next(flat), specs,
                      is_leaf=lambda x: hasattr(x, "axes"))
    w = params["groups"][-1]["ffn"]
    rs = np.random.RandomState(7)
    out = {"fn/x": rs.randn(4, 16, cfg.d_model).astype(np.float32),
           "fn/ct": rs.randn(4, 16, cfg.d_model).astype(np.float32)}

    def walk(node, path):
        for k in sorted(node):
            if isinstance(node[k], dict):
                walk(node[k], path + [k])
            else:
                out["fn/w/" + "/".join(path + [k])] = node[k][0]
    walk(w, [])
    return out


def _reference(case, leaves, batch, serve=True):
    """The JAX l2l-p engine on the whole batch without a mesh: two train
    steps (the first one's Adam slots give the gradients), prefill and
    decode."""
    from repro.engine.state import TrainState as JState
    cfg = _cfg(case, jget_config)
    eng = jengines.create("l2l-p", cfg, JExec(n_microbatches=UB),
                          donate=False)
    it = iter(leaves)
    params = jax.tree.map(lambda _: jnp.asarray(next(it)),
                          eng.model.param_specs(),
                          is_leaf=lambda x: hasattr(x, "axes"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = JState.from_legacy(params, eng._init_opt_legacy(params))
    out = {}
    for i in range(2):
        state, m = eng.train_step(state, jb)
        for k in ("loss", "grad_norm", "aux"):
            out[f"train{i}/{k}"] = float(m[k])
        if i == 0:
            # Adam's first step leaves m = (1 - b1)·g = 0.1·g
            opt = jpacking.unpack_opt_state(state.legacy_opt(),
                                            state.params)
            is_slot = lambda x: isinstance(x, dict) and "m" in x
            g = jax.tree.map(lambda s: np.asarray(s["m"]) / np.float32(0.1),
                             {k: opt[k] for k in ("embed", "head", "groups")},
                             is_leaf=is_slot)
            out["grads"] = jax.tree.leaves(g)
            out["router"] = g["groups"][-1]["ffn"]["router"]
    if not serve:
        return out
    prompt = jb["tokens"][:, :8]
    out["prefill"] = [np.asarray(eng.prefill(params, {"tokens": prompt}))]
    caches, last = eng.decode_init(params, prompt, 10)
    logits = [np.asarray(last)]
    for i in range(2):
        lg, caches = eng.decode_step(params, caches,
                                     jb["tokens"][:, 8 + i:9 + i],
                                     jnp.int32(8 + i))
        logits.append(np.asarray(lg[:, -1]))
    out["decode"] = logits
    return out


def _port_reference(out, pre):
    """The reference's keys from the port's meshless run ``pre``."""
    ref = {f"train{i}/{k}": float(_get(out, f"{pre}/train{i}/{k}")[0])
           for i in range(2) for k in ("loss", "grad_norm", "aux")}
    ref["grads"] = [m / np.float32(0.1) for m in _get(out, f"{pre}/train0/m")]
    for what in ("prefill", "decode"):
        ref[what] = _get(out, f"{pre}/{what}")
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_mesh")
    drawn = {c: _draw(c) for c in CASES}
    inp = {}
    for c, (leaves, batch) in drawn.items():
        inp.update({f"{c}/p/{i}": x for i, x in enumerate(leaves)})
        inp.update({f"{c}/b/{k}": v for k, v in batch.items()})
    fn = _fn_inputs(drawn["deepseek-drop"][0])
    inp.update(fn)
    path = str(tmp / "in.npz")
    np.savez(path, **inp)
    procs = (_spawn(tmp, path, 2) + _spawn(tmp, path, 4)
             + [_grouped(tmp, path), _cli(tmp)])
    try:
        ref = {c: _reference(c, *drawn[c],
                             serve=c not in ("grok-e3", "deepseek-drop"))
               for c in CASES}
    finally:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs[:-1], logs):
        assert p.returncode == 0, log[-3000:]
    load = lambda name: dict(np.load(str(tmp / name)))
    ranks = [load("out2_0.npz"), load("out2_1.npz")]
    # the dropping capacity's prefill and decode: the port's meshless
    # engine (held to the reference's in tests/test_torch_moe.py)
    one = _port_reference(ranks[0], "deepseek-drop/one")
    for what in ("prefill", "decode"):
        ref["deepseek-drop"][what] = one[what]
    grouped = load("grouped.npz")
    return dict(ranks=ranks,
                four=[load(f"out4_{r}.npz") for r in range(4)], ref=ref,
                keep=grouped["keep"], y_global=grouped["y_global"],
                grouped=grouped,
                fn=fn, tmp=tmp, cli=(procs[-1].returncode, logs[-1],
                                     str(tmp / "ck")))


def _get(out, key):
    """The arrays stored under ``key`` (``key/0``, ``key/1``, ...)."""
    n = 0
    while f"{key}/{n}" in out:
        n += 1
    assert n, key
    return [out[f"{key}/{i}"] for i in range(n)]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got, want, rel):
    assert len(got) == len(want)
    worst = max(_rel_l2(g, w) for g, w in zip(got, want))
    assert worst <= rel, worst


def _rows(outs, pre, what):
    """The global rows of a data-parallel call from every rank's rows and
    their global indices."""
    got = [_get(o, f"{pre}/{what}") for o in outs]
    idx = [_get(o, f"{pre}/{what}_rows")[0] for o in outs]
    whole = []
    for j in range(len(got[0])):
        parts = np.concatenate([g[j] for g in got])
        order = np.argsort(np.concatenate(idx))
        whole.append(parts[order])
    return whole


def _check(outs, pre, ref, what, data_ranks):
    """One entry point of every rank against the reference."""
    for out in outs:
        if what == "train":
            for i in range(2 if f"{pre}/train1/loss/0" in out else 1):
                for k in ("loss", "grad_norm", "aux"):
                    got = float(_get(out, f"{pre}/train{i}/{k}")[0])
                    want = ref[f"train{i}/{k}"]
                    assert abs(got - want) <= LOSS_REL * abs(want), \
                        (i, k, got, want)
            _close([m / np.float32(0.1)
                    for m in _get(out, f"{pre}/train0/m")],
                   ref["grads"], GRAD_REL)
        elif what == "grads":
            got = float(_get(out, f"{pre}/grads/loss")[0])
            assert abs(got - ref["train0/loss"]) <= \
                LOSS_REL * ref["train0/loss"]
            _close(_get(out, f"{pre}/grads/grads"), ref["grads"], GRAD_REL)
    if what in ("prefill", "decode"):
        # model ranks return the whole logits; data ranks their rows
        groups = ([[o] for o in outs] if data_ranks == 1
                  else [outs[m::len(outs) // data_ranks]
                        for m in range(len(outs) // data_ranks)])
        for group in groups:
            got = (_get(group[0], f"{pre}/{what}") if data_ranks == 1
                   else _rows(group, pre, what))
            _close(got, ref[what], LOGIT_REL)


@pytest.mark.parametrize("case,what", [
    (c, w) for c in ("deepseek", "grok") for w in WHATS]
    + [("grok-e3", "train"), ("grok-e3", "grads")])
def test_model_ranks_match_the_reference(runs, case, what):
    """l2l-p on two model ranks (experts split 2 + 2; grok-1 with 3
    experts: their columns split, the router whole), gathered, against
    the reference's meshless engine: losses, grad norms and the aux within
    1e-5 relative, each gradient leaf within 1e-4 relative L2, the whole
    logits of prefill, decode_init and two decode steps within 1e-4."""
    _check(runs["ranks"], f"{case}/tp", runs["ref"][case], what, 1)


@pytest.mark.parametrize("what", WHATS)
def test_data_ranks_match_the_reference(runs, what):
    """deepseek-v2-lite on two data ranks, each on its block of every
    microbatch (the router's statistics and the global dispatch over the
    data group), against the reference at the global batch: the same
    bounds; prefill's and decode's rows put back in global order."""
    _check(runs["ranks"], "deepseek/dp", runs["ref"]["deepseek"], what, 2)


@pytest.mark.parametrize("what", WHATS)
def test_data_and_model_ranks_match_the_reference(runs, what):
    """One step, grads, prefill and decode on (data=2, model=2): the
    same bounds on all four ranks."""
    _check(runs["four"], "dm", runs["ref"]["deepseek"], what, 2)


def test_baseline_on_model_ranks_matches_the_reference(runs):
    """The baseline engine's autograd on two model ranks: its aux counted
    once in the loss, the same bounds as l2l-p's."""
    ref = runs["ref"]["deepseek"]
    for out in runs["ranks"]:
        for i in range(2):
            got = float(_get(out, f"deepseek/base/train{i}/loss")[0])
            assert abs(got - ref[f"train{i}/loss"]) <= \
                LOSS_REL * ref[f"train{i}/loss"]
        _close(_get(out, "deepseek/base/grads/grads"), ref["grads"],
               GRAD_REL)


@pytest.mark.parametrize("mesh", ["tp", "dp", "dm"])
def test_aux_and_router_gradient_match_the_reference(runs, mesh):
    """The load-balance loss of both steps within 1e-5 of the reference's
    on every rank (its statistics the global microbatch's), and the
    router's gradient (gathered over the model ranks: each holds its
    experts' columns) within 1e-4 relative L2: the combine weights pass
    ``copy_in``, so no rank's share of the softmax's gradient is lost."""
    ref = runs["ref"]["deepseek"]
    outs = runs["four"] if mesh == "dm" else runs["ranks"]
    pre = "dm" if mesh == "dm" else f"deepseek/{mesh}"
    for out in outs:
        for i in range(2 if mesh != "dm" else 1):
            got = float(_get(out, f"{pre}/train{i}/aux")[0])
            assert abs(got - ref[f"train{i}/aux"]) <= \
                LOSS_REL * ref[f"train{i}/aux"]
        router = _get(out, f"{pre}/grads/router")[0]
        assert _rel_l2(router, ref["router"]) <= GRAD_REL
        assert np.abs(router).max() > 0


@pytest.mark.parametrize("case", ["deepseek", "grok", "grok-e3"])
def test_unsplit_leaves_agree_bitwise_across_model_ranks(runs, case):
    """The leaves no pspec splits (norms, MLA's latent path, a whole
    router under tensor parallelism inside the experts) and their Adam
    slots after two steps, and their gradients, hold the same bits on both
    model ranks; so do the gathered gradients and the losses."""
    r0, r1 = runs["ranks"]
    for key in ("whole", "grads/whole", "grads/grads", "train0/loss",
                "train1/loss", "grads/loss"):
        k = f"{case}/tp/{key}"
        for a, b in zip(_get(r0, k), _get(r1, k)):
            assert np.array_equal(a, b), k


def test_data_ranks_end_on_the_same_state(runs):
    """Two data ranks of deepseek-v2-lite (and at the dropping capacity)
    end their steps on the same bits (checksums), and the four ranks of
    (data=2, model=2) gather the same gradient."""
    r0, r1 = runs["ranks"]
    for case in ("deepseek", "deepseek-drop"):
        assert np.array_equal(_get(r0, f"{case}/dp/params")[0],
                              _get(r1, f"{case}/dp/params")[0])
    first = runs["four"][0]
    for out in runs["four"][1:]:
        for a, b in zip(_get(out, "dm/grads/grads"),
                        _get(first, "dm/grads/grads")):
            assert np.array_equal(a, b)


def test_global_dispatch_keeps_the_reference_pairs(runs):
    """At capacity factor 0.5 on two data ranks: each rank adds the
    counts of the ranks before it to its slot cumsum, and the pairs kept
    (rank order) are exactly those the meshless reference keeps, some of
    them dropped."""
    keep = np.concatenate([_get(o, "fn/keep")[0] for o in runs["ranks"]])
    assert keep.shape == runs["keep"].shape
    assert np.array_equal(keep, runs["keep"])
    assert 0 < keep.sum() < keep.size


def test_dropping_capacity_on_data_ranks_matches_the_reference(runs):
    """deepseek-v2-lite at capacity factor 0.5 on two data ranks: the
    global dispatch drops the pairs the meshless dispatch drops, so two
    steps (two layers, two microbatches) and grads stay within the bounds
    of the reference's meshless engine at the global batch, as the port's
    meshless engine does; prefill and decode within the bounds of the
    port's meshless engine (which tests/test_torch_moe.py holds to the
    reference's at a dropping capacity)."""
    ref = runs["ref"]["deepseek-drop"]
    for what in WHATS:
        _check(runs["ranks"], "deepseek-drop/dp", ref, what, 2)
    for what in ("train", "grads"):
        _check(runs["ranks"][:1], "deepseek-drop/one", ref, what, 1)


def test_grouped_dispatch_matches_the_reference_grouped_path(runs):
    """``moe_ep_constraint`` on two data ranks: each rank's rows are one
    dispatch group with C from T / 2, as the reference's
    ``_dispatch_groups`` under ``with mesh:`` (data=2) gives it: the
    output, the aux (global statistics), dx and the weights' gradient
    (the two ranks' shares summed) within the bounds; at this capacity
    the grouped output is not the global dispatch's."""
    ref = runs["grouped"]
    outs = [_get(o, "fn/grouped") for o in runs["ranks"]]
    y = np.concatenate([o[0] for o in outs])
    _close([y], [ref["y"]], LOGIT_REL)
    assert _rel_l2(y, runs["y_global"]) > 1e-2
    for o in outs:
        assert abs(float(o[1]) - float(ref["aux"])) <= \
            LOSS_REL * float(ref["aux"])
    _close([np.concatenate([o[2] for o in outs])], [ref["dx"]], GRAD_REL)
    names = sorted(k[len("fn/w/"):] for k in runs["fn"]
                   if k.startswith("fn/w/"))
    dw = [outs[0][3 + i] + outs[1][3 + i] for i in range(len(names))]
    _close(dw, [ref[f"dw/{n}"] for n in names], GRAD_REL)
    for o in runs["ranks"]:
        # one statistics sum, no count exchange
        assert [int(x) for x in _get(o, "fn/moe")] == [1, 0]


@pytest.mark.parametrize("mesh", ["tp", "dp"])
def test_knob_points_are_bitwise_inside_the_mesh(runs, mesh):
    """prefetch 0 / 1, G 1 / 2, stash_every 1 / 2 on two model ranks and
    on two data ranks: one train step each, the same bits as the base
    point's."""
    for out in runs["ranks"]:
        base = _get(out, f"{mesh}/knob0")
        for knob in range(1, N_KNOBS):
            got = _get(out, f"{mesh}/knob{knob}")
            assert len(got) == len(base)
            for a, b in zip(got, base):
                assert np.array_equal(a, b), knob


def test_pack_on_matches_pack_off_within_bounds(runs):
    """With pack_params the packed rows stay whole on each model rank (the
    experts are not split, the data statistics still apply): held to the
    reference and to pack off within the bounds."""
    ref = runs["ref"]["deepseek"]
    for out in runs["ranks"]:
        got = float(_get(out, "pack/train0/loss")[0])
        assert abs(got - ref["train0/loss"]) <= LOSS_REL * ref["train0/loss"]
        m = [a / np.float32(0.1) for a in _get(out, "pack/train0/m")]
        _close(m, ref["grads"], GRAD_REL)
        off = [a / np.float32(0.1)
               for a in _get(out, "deepseek/tp/train0/m")]
        _close(m, off, GRAD_REL)


def test_a_snapshot_at_two_model_ranks_is_the_meshless_snapshot(runs):
    """``Engine.save`` of deepseek-v2-lite at M = 2 gathers the expert
    blocks and rank 0 writes: every file byte for byte what a meshless
    engine writes for the gathered state."""
    tp, one = (runs["tmp"] / "moe_tp" / "ckpt_1",
               runs["tmp"] / "moe_one" / "ckpt_1")
    names = sorted(os.listdir(tp))
    assert names == sorted(os.listdir(one)) and names
    for n in names:
        assert (tp / n).read_bytes() == (one / n).read_bytes(), n


def test_the_moe_collectives_are_counted(runs):
    """An l2l-p step of deepseek-v2-lite (one MoE layer, 2 microbatches)
    on two data ranks makes per MoE layer call one statistics sum and one
    count exchange: the forward and the recompute, 4 of each; the
    gradient rows stay the dense count (a row per layer, the static tree,
    the loss weight and sum).  On two model ranks none."""
    for out in runs["ranks"]:
        assert [int(x) for x in _get(out, "deepseek/dp/train0/moe")] == \
            [4, 4]
        assert int(_get(out, "deepseek/dp/train0/all_reduces")[0]) == 2 + 3
        assert [int(x) for x in _get(out, "deepseek/tp/train0/moe")] == \
            [0, 0]


def test_the_train_cli_on_two_data_ranks(runs):
    """``torch.distributed.run`` of the train CLI with deepseek-v2-lite
    and ``--mesh data=2``: the MoE's collectives a step in its JSON line,
    the two ranks' checksums equal, one snapshot written (by rank 0)."""
    rc, log, d = runs["cli"]
    assert rc == 0, log
    line = json.loads([ln for ln in log.splitlines()
                       if ln.startswith("{")][-1])
    assert line["world"] == 2 and line["mesh"] == "data=2"
    assert line["moe_collectives_per_step"] == {"stats": 4, "counts": 4}
    sums = line["rank_checksums"]
    assert len(sums) == 2 and sums[0] == sums[1]
    assert sorted(os.listdir(d)) == ["ckpt_2"]


def _mesh(shape, coord):
    return SimpleNamespace(shape=shape, coordinate=coord,
                           get_group=lambda name: None)


@pytest.mark.parametrize("arch,n_experts,split", [
    ("deepseek-v2-lite-16b", 64, "experts"),
    ("grok-1-314b", 8, "experts"),
    ("grok-1-314b", 3, "expert_ffn")])
def test_each_model_rank_holds_its_expert_block(arch, n_experts, split):
    """At full width on two model ranks: the rules put the experts on
    "model" when they divide (rank r holds experts [r E/2, (r+1) E/2) of
    ``w_gate`` / ``w_in`` / ``w_out`` and the router's matching columns),
    else the experts' columns (the router whole); MLA's heads split, its
    latent path whole."""
    cfg = get_config(arch, "full").replace(n_experts=n_experts)
    specs = LayeredModel(cfg).param_specs()
    shape = {"data": 1, "model": 2}
    rules = shd.make_rules(cfg, _mesh(shape, {"data": 0, "model": 0}))
    for r in range(2):
        tp = TensorParallel(_mesh(shape, {"data": 0, "model": r}), cfg,
                            specs, rules)
        ffn = tp.layer_pspecs[-1]["ffn"]
        if split == "experts":
            assert tp.experts and not tp.expert_ffn
            E2 = n_experts // 2
            assert tp.expert_block() == (r * E2, (r + 1) * E2)
            assert ffn["router"] == shd.P(None, "model")
            assert ffn["experts"]["w_in"] == shd.P("model")
        else:
            assert tp.expert_ffn and not tp.experts
            assert tp.expert_block() == (0, n_experts)
            assert ffn["router"] == shd.P()
            assert ffn["experts"]["w_in"] == shd.P(None, None, "model")
            assert ffn["experts"]["w_out"] == shd.P(None, "model")
        if cfg.use_mla:
            a = tp.layer_pspecs[-1]["attn"]
            for k in ("wq", "w_uk", "w_uv", "wo"):
                assert shd.is_split_over(a[k]), k
            for k in ("w_dkv", "w_kr", "kv_norm"):
                assert not shd.is_split_over(a[k]), k


def test_shard_batch_cuts_each_microbatch(runs):
    """With ``n_microbatches`` UB the rank's rows are its block of each
    global microbatch, in microbatch order; UB = 1 is the contiguous
    block, and a world of one keeps every row in place.  ``Engine.
    local_rows`` on two data ranks picks the cut by entry point:
    prefill's rows (its microbatches, as train_step's and grads') are the
    rank's block of each global microbatch, decode's the rank's block of
    the whole call; the meshless engine keeps every row."""
    rows = np.arange(8)
    for d in (1, 2):
        for r in range(d):
            m = _mesh({"data": d, "model": 1}, {"data": r, "model": 0})
            rules = {"batch": ("data",)}
            got = shd.shard_batch({"i": rows}, m, rules, 2)["i"]
            per = 4 // d
            want = np.concatenate([rows[u * 4 + r * per:u * 4 + (r + 1) * per]
                                   for u in range(2)])
            assert np.array_equal(got, want)
            one = shd.shard_batch({"i": rows}, m, rules)["i"]
            assert np.array_equal(one, rows[r * 8 // d:(r + 1) * 8 // d])
    for r, out in enumerate(runs["ranks"]):
        per = B // UB // 2
        want = np.concatenate([np.arange(u * B // UB + r * per,
                                         u * B // UB + (r + 1) * per)
                               for u in range(UB)])
        assert np.array_equal(_get(out, "deepseek/dp/prefill_rows")[0],
                              want)
        assert np.array_equal(_get(out, "deepseek/dp/decode_rows")[0],
                              np.arange(r * B // 2, (r + 1) * B // 2))
    for what in ("prefill_rows", "decode_rows"):
        assert np.array_equal(
            _get(runs["ranks"][0], f"deepseek-drop/one/{what}")[0],
            np.arange(B))
