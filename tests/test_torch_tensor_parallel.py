"""Tensor parallelism over the mesh's model axis on the CPU: two gloo ranks
on a ``(data=1, model=2)`` mesh (tests/torch_tp_worker.py, one process
each, one file store), each on its blocks of the heads, ffn columns and
(where it divides) vocabulary, gathered and held to the JAX reference's
meshless engine on the same numpy inputs; the leaves no pspec splits bit
for bit equal across the ranks; the relay knobs bit for bit inside the
mesh; pack on (the layers whole on every rank) within the bounds of pack
off; four ranks on ``(data=2, model=2)`` within the bounds of two; a
snapshot at M = 2 byte for byte the meshless one; the hybrid, SSM, VLM
and audio families built on the model axis, ``serve_session`` on it
refused.

bert-large (layernorm, MHA with biases, vocab 512: vocab-parallel),
granite-3-8b (RMSNorm, GQA kv 2 -> 1 a rank, tied vocab-parallel
embedding) and chatglm3-6b's shape with one kv head (whole kv leaves,
heads split) at smoke size, f32, parameters drawn with numpy at fan-in
scales (``repro_torch.testing.fan_in_params``).  One spawn of the six
processes and of the train CLI on two model ranks for the module; the
JAX reference runs beside them."""
import json
import os
import socket
import subprocess
import sys

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
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.tensor_parallel import \
    TensorParallel  # noqa: E402
from repro_torch.models.model import LayeredModel  # noqa: E402
from repro_torch.testing import fan_in_params  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
ARCHS = ("bert-large", "granite-3-8b", "chatglm3-6b-kv1")
N_KNOBS = 5                      # torch_tp_worker.KNOBS, the first the base
B, S = 4, 16
LOSS_REL, GRAD_REL, LOGIT_REL = 1e-5, 1e-4, 1e-4


def _cfg(arch, get=get_config):
    if arch == "chatglm3-6b-kv1":
        return get("chatglm3-6b", "smoke").replace(n_kv_heads=1)
    return get(arch, "smoke")


def _draw(arch):
    """numpy parameters (port flatten order) and a global batch."""
    rs = np.random.RandomState(10 + ARCHS.index(arch))
    cfg = _cfg(arch)
    params = fan_in_params(LayeredModel(cfg).param_specs(),
                           lambda shape: rs.randn(*shape))
    leaves = [np.asarray(a, np.float32) for a in tree_leaves(params)]
    mask = np.ones((B, S), np.float32)
    mask[1, -3:] = 0.0                      # a weighted loss, as padding
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "mask": mask}
    return leaves, batch


def _env():
    return {**os.environ, "PYTHONPATH": f"{SRC}{os.pathsep}{HERE}",
            "OMP_NUM_THREADS": "1"}


def _spawn(tmp, inp, world):
    store = str(tmp / f"store{world}")
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_tp_worker.py"), inp,
         str(tmp / f"out{world}_{r}.npz"), store, str(r), str(world)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env()) for r in range(world)]


def _cli(tmp):
    """The train CLI on two model ranks under ``torch.distributed.run``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port", str(port),
         "-m", "repro_torch.launch.train", "--device", "cpu",
         "--mesh", "data=1,model=2", "--arch", "bert-large", "--variant",
         "smoke", "--d-model", "32", "--n-layers", "2", "--batch", "4",
         "--seq", "16", "--ub", "2", "--steps", "2", "--weight-stream",
         "--ckpt-dir", str(tmp / "ck")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env())


def _reference(arch, leaves, batch):
    """The JAX l2l-p engine on the whole batch without a mesh: two train
    steps (the first one's Adam slots give the gradients), prefill and
    decode."""
    from repro.engine.state import TrainState as JState
    cfg = _cfg(arch, jget_config).replace(dtype="float32")
    eng = jengines.create("l2l-p", cfg, JExec(n_microbatches=2),
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
        out[f"train{i}/loss"] = float(m["loss"])
        out[f"train{i}/grad_norm"] = float(m["grad_norm"])
        if i == 0:
            # Adam's first step leaves m = (1 - b1)·g = 0.1·g
            opt = jpacking.unpack_opt_state(state.legacy_opt(),
                                            state.params)
            out["grads"] = [np.asarray(s["m"]) / np.float32(0.1)
                            for s in jax.tree.leaves(
                {k: opt[k] for k in ("embed", "head", "groups")},
                is_leaf=lambda x: isinstance(x, dict) and "m" in x)]
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    drawn = {a: _draw(a) for a in ARCHS}
    inp = {}
    for a, (leaves, batch) in drawn.items():
        inp.update({f"{a}/p/{i}": x for i, x in enumerate(leaves)})
        inp.update({f"{a}/b/{k}": v for k, v in batch.items()})
    path = str(tmp / "in.npz")
    np.savez(path, **inp)
    procs = _spawn(tmp, path, 2) + _spawn(tmp, path, 4) + [_cli(tmp)]
    try:
        ref = {a: _reference(a, *drawn[a]) for a in ARCHS}
    finally:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs[:-1], logs):
        assert p.returncode == 0, log
    load = lambda name: dict(np.load(str(tmp / name)))
    return dict(ranks=[load("out2_0.npz"), load("out2_1.npz")],
                four=[load(f"out4_{r}.npz") for r in range(4)], ref=ref,
                tmp=tmp, cli=(procs[-1].returncode, logs[-1],
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


def _train_close(out, pre, ref):
    """Two steps' losses and grad norms within ``LOSS_REL`` of the
    reference, the first step's gradient (its Adam m / 0.1) within
    ``GRAD_REL`` per leaf."""
    for i in range(2):
        for k in ("loss", "grad_norm"):
            got = float(_get(out, f"{pre}/train{i}/{k}")[0])
            want = ref[f"train{i}/{k}"]
            assert abs(got - want) <= LOSS_REL * abs(want), (i, k, got, want)
    _close([m / np.float32(0.1) for m in _get(out, f"{pre}/train0/m")],
           ref["grads"], GRAD_REL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", ["train", "grads", "prefill", "decode"])
def test_model_ranks_match_the_reference(runs, arch, what):
    """l2l-p on two model ranks (the sharded relay), gathered, against the
    reference's meshless engine: losses and grad norms within 1e-5
    relative, each gradient leaf within 1e-4 relative L2, the whole logits
    of prefill, decode_init and two decode steps within 1e-4 relative L2
    on every rank."""
    ref = runs["ref"][arch]
    for out in runs["ranks"]:
        pre = f"{arch}/l2l"
        if what == "train":
            _train_close(out, pre, ref)
        elif what == "grads":
            got = float(_get(out, f"{pre}/grads/loss")[0])
            assert abs(got - ref["train0/loss"]) <= \
                LOSS_REL * ref["train0/loss"]
            _close(_get(out, f"{pre}/grads/grads"), ref["grads"], GRAD_REL)
        else:
            _close(_get(out, f"{pre}/{what}"), ref[what], LOGIT_REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_baseline_on_model_ranks_matches_the_reference(runs, arch):
    """The baseline engine's autograd on two model ranks: the same bounds
    as l2l-p's against the reference."""
    ref = runs["ref"][arch]
    for out in runs["ranks"]:
        _train_close(out, f"{arch}/base", ref)
        _close(_get(out, f"{arch}/base/grads/grads"), ref["grads"],
               GRAD_REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_agree_bitwise(runs, arch):
    """The leaves no pspec splits (norms, biases on d_model, whole kv
    leaves, a whole vocabulary) and their Adam slots hold the same bits on
    both ranks after two steps (checksums), and the gathered states,
    gradients and losses are the same bits."""
    r0, r1 = runs["ranks"]
    for eng in ("l2l", "base"):
        for key in ("whole", "train/params", "train0/loss", "train1/loss",
                    "grads/grads", "grads/loss"):
            k = f"{arch}/{eng}/{key}"
            for a, b in zip(_get(r0, k), _get(r1, k)):
                assert np.array_equal(a, b), k


@pytest.mark.parametrize("knob", range(1, N_KNOBS))
def test_knob_points_are_bitwise_inside_the_mesh(runs, knob):
    """prefetch 0 / 1, G 1 / 2, stash_every 1 / 2 on the two model ranks:
    one train step each, the same bits as the base point's."""
    for out in runs["ranks"]:
        got, base = _get(out, f"knob{knob}"), _get(out, "knob0")
        assert len(got) == len(base)
        for a, b in zip(got, base):
            assert np.array_equal(a, b)


def test_pack_on_matches_pack_off_within_bounds(runs):
    """With pack_params the packed rows are replicated over the model axis
    and the layers run whole on each rank (only embed and head split): not
    the same partition, so held within the bounds, not bit for bit; the
    pack-on step has no collective in its layers."""
    ref = runs["ref"]["bert-large"]
    for out in runs["ranks"]:
        got = float(_get(out, "pack/train0/loss")[0])
        assert abs(got - ref["train0/loss"]) <= LOSS_REL * ref["train0/loss"]
        m = [a / np.float32(0.1) for a in _get(out, "pack/train0/m")]
        _close(m, ref["grads"], GRAD_REL)
        off = [a / np.float32(0.1)
               for a in _get(out, "bert-large/l2l/train0/m")]
        _close(m, off, GRAD_REL)
        packed = _get(out, "pack/train0/collectives")
        sharded = _get(out, "bert-large/l2l/train0/collectives")
        assert int(packed[0]) < int(sharded[0])


def test_data_and_model_axes_match_the_model_axis(runs):
    """One bert-large step on (data=2, model=2): each data group trains on
    its half of the batch, the layer rows are summed over the data group;
    loss and gradient within the bounds of (data=1, model=2)'s, and every
    rank gathers the same bits."""
    one = runs["ranks"][0]
    first = runs["four"][0]
    got = float(_get(first, "dm/train0/loss")[0])
    want = float(_get(one, "bert-large/l2l/train0/loss")[0])
    assert abs(got - want) <= LOSS_REL * abs(want)
    _close(_get(first, "dm/train0/m"), _get(one, "bert-large/l2l/train0/m"),
           GRAD_REL)
    for out in runs["four"][1:]:
        for a, b in zip(_get(out, "dm/train0/m"), _get(first, "dm/train0/m")):
            assert np.array_equal(a, b)


def test_init_gives_each_rank_its_slice_of_the_one_process_draw(runs):
    """``Engine.init`` on a model rank draws every leaf whole from the
    seeded generator and keeps its block: the slice of the meshless
    engine's draw, bit for bit."""
    for out in runs["ranks"]:
        for a, b in zip(_get(out, "init/rank"), _get(out, "init/one")):
            assert a.shape == b.shape and np.array_equal(a, b)
    a0, a1 = (_get(out, "init/rank") for out in runs["ranks"])
    assert any(x.shape != y.shape or not np.array_equal(x, y)
               for x, y in zip(a0, a1))


def test_a_snapshot_is_the_meshless_snapshot(runs):
    """``Engine.save`` at M = 2 gathers the split leaves and rank 0 writes:
    every file byte for byte what a meshless engine writes for the
    gathered state."""
    tp, one = runs["tmp"] / "tp" / "ckpt_2", runs["tmp"] / "one" / "ckpt_2"
    names = sorted(os.listdir(tp))
    assert names == sorted(os.listdir(one)) and names
    for n in names:
        assert (tp / n).read_bytes() == (one / n).read_bytes(), n


def test_save_restore_and_two_steps_equal_four_steps(runs):
    """Restore slices each rank's blocks out of the whole snapshot: two
    steps from it end on the same bits as four uninterrupted steps."""
    for out in runs["ranks"]:
        got, want = _get(out, "restored"), _get(out, "unbroken")
        assert int(got[0]) == 2 and len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


def test_the_cache_holds_the_local_kv_heads(runs):
    """The decode cache of a rank holds its kv heads: bert-large 4 -> 2,
    granite 2 -> 1, and with one whole kv head the one its q heads read."""
    for out in runs["ranks"]:
        for arch, kv in zip(ARCHS, (2, 1, 1)):
            assert int(_get(out, f"{arch}/l2l/cache_kv_heads")[0]) == kv


class _Mesh:
    """A shape-only mesh of one rank (its ``coordinate``), as the
    reference's sharding tests use."""

    def __init__(self, shape, coordinate):
        self.shape, self.coordinate = shape, coordinate

    def get_group(self, name):
        return None


@pytest.mark.parametrize("n_heads,n_kv,m,blocks", [
    (32, 2, 4, [(0, 1), (0, 1), (1, 2), (1, 2)]),     # chatglm3-6b at M = 4
    (4, 1, 2, [(0, 1), (0, 1)]),
    (8, 2, 4, [(0, 1), (0, 1), (1, 2), (1, 2)]),
    (24, 6, 4, None),                    # 6 q heads a rank, groups of 4
])
def test_kv_block_maps_each_rank_to_the_kv_heads_its_q_heads_read(
        n_heads, n_kv, m, blocks):
    """q head h reads kv head h // (H / KV): rank r's q heads
    [r H/M, (r+1) H/M) read the kv heads of ``kv_block``; a split whose
    local q heads do not fall into equal groups raises."""
    cfg = get_config("chatglm3-6b", "smoke").replace(
        n_heads=n_heads, n_kv_heads=n_kv, d_ff=256 * m)
    specs = LayeredModel(cfg).param_specs()
    shape = {"data": 1, "model": m}
    rules = shd.make_rules(cfg, _Mesh(shape, {"data": 0, "model": 0}))
    assert rules["heads"] == "model" and rules["kv"] is None
    for r in range(m):
        mesh = _Mesh(shape, {"data": 0, "model": r})
        if blocks is None:
            with pytest.raises(NotImplementedError):
                TensorParallel(mesh, cfg, specs, rules)
            continue
        tp = TensorParallel(mesh, cfg, specs, rules)
        want = blocks[r]
        assert tp.kv_block() == want
        g = n_heads // n_kv
        hl = n_heads // m
        assert {h // g for h in range(r * hl, (r + 1) * hl)} == \
            set(range(*want))


def test_shard_leaf_cuts_each_ranks_contiguous_block():
    """``local_shape`` / ``shard_leaf`` on every leaf of granite-3-8b's
    smoke specs at M = 2: the rank's block is the r-th contiguous slice of
    each dim its pspec puts on "model", and the blocks in rank order are
    the whole leaf."""
    cfg = get_config("granite-3-8b", "smoke")
    specs = LayeredModel(cfg).param_specs()
    shape = {"data": 1, "model": 2}
    rules = shd.make_rules(cfg, _Mesh(shape, {"data": 0, "model": 0}))
    tp = TensorParallel(_Mesh(shape, {"data": 0, "model": 0}), cfg, specs,
                        rules)
    leaves = tree_leaves(specs, is_leaf=lambda x: hasattr(x, "axes"))
    pspecs = tree_leaves(tp.param_pspecs, is_leaf=shd.is_pspec)
    assert len(leaves) == len(pspecs)
    n_split = 0
    for spec, p in zip(leaves, pspecs):
        whole = torch.arange(int(np.prod(spec.shape))).reshape(spec.shape)
        blocks = [shd.shard_leaf(whole, p, _Mesh(shape, {"data": 0,
                                                         "model": r}))
                  for r in range(2)]
        assert tuple(blocks[0].shape) == shd.local_shape(spec.shape, p,
                                                         _Mesh(shape, {}))
        dims = [i for i, e in enumerate(p) if e == "model"]
        n_split += bool(dims)
        cat = torch.cat(blocks, dims[0]) if dims else blocks[0]
        assert torch.equal(cat, whole)
    # wq, wk, wv, wo, w_gate, w_in, w_out and the tied embedding
    assert n_split == 8


def test_moe_other_families_and_serve_session_are_refused(runs):
    """On (data=1, model=2) hymba-1.5b (hybrid) and rwkv6-1.6b (SSM) build
    (tests/test_torch_recurrent_parallel.py runs them), as do
    internvl2-1b (VLM) and whisper-base (audio)
    (tests/test_torch_modality_parallel.py) and the MoE family
    (tests/test_torch_moe_parallel.py); ``serve_session`` on the mesh
    raises NotImplementedError, its message naming it."""
    for out in runs["ranks"]:
        assert [int(x) for x in _get(out, "refused")] == [0, 0, 0, 0, 1]
        said = [str(x) for x in _get(out, "refused_messages")]
        assert len(said) == 1 and "serve_session" in said[0], said


def test_the_collectives_are_counted(runs):
    """A bert-large l2l-p step on two model ranks counts its sums, maxes
    and gathers: per layer and microbatch the attention and MLP outputs in
    the forward, again in the recompute, and both inputs' cotangents in
    the backward (6); the embedding's sum in the forward and in its vjp,
    the head's input cotangent and the cross-entropy's sum per microbatch
    (4); a finite flag per layer and for the static tree, the
    cross-entropy's max per microbatch; the norms of the split leaves (a
    layer each, the static tree); serving gathers its logits."""
    cfg = get_config("bert-large", "smoke")
    n, ub = cfg.n_layers, 2
    for out in runs["ranks"]:
        s, mx, g = (int(x) for x in _get(out, "bert-large/l2l/train0/"
                                         "collectives"))
        assert (s, mx, g) == (6 * n * ub + 4 * ub + n + 1, n + 1 + ub, 0)


def test_the_train_cli_on_two_model_ranks(runs):
    """``torch.distributed.run`` of the train CLI with ``--mesh
    data=1,model=2``: the model collectives a step in its JSON line, the
    two ranks' checksums of their whole leaves equal, one snapshot written
    (by rank 0)."""
    rc, log, d = runs["cli"]
    assert rc == 0, log
    line = json.loads([ln for ln in log.splitlines()
                       if ln.startswith("{")][-1])
    assert line["world"] == 2 and line["mesh"] == "data=1,model=2"
    assert line["model_collectives_per_step"]["sum"] > 0
    sums = line["model_checksums"]
    assert len(sums) == 2 and sums[0] == sums[1]
    assert sorted(os.listdir(d)) == ["ckpt_2"]
