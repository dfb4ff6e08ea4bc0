"""The hybrid and SSM families on the mesh's model axis on the CPU:
hymba-1.5b's mamba channels, MLP columns (and attention heads where they
divide) and rwkv6-1.6b's heads, channel-mix columns and vocabulary over
"model", by the reference's train rules.  Gloo ranks
(tests/torch_recurrent_worker.py: two on ``(data=1, model=2)``, four on
``(data=2, model=2)``), each on its blocks and its rows of every call,
gathered and held to the JAX reference's meshless engine at the global
batch on the same numpy inputs: train step, grads, prefill and decode
under l2l-p, train step and grads under l2l and the baseline, within
``test_torch_tensor_parallel.py``'s bounds; the gradients of mamba's
``w_in`` (its ``[x | z]`` columns split unevenly between x and z) and
``w_bcdt`` (row-parallel, its output read by every rank's channels) and
of rwkv6's ``decay_a`` / ``decay_b`` / ``ln_scale`` (whole leaves a rank
uses a block of) named; the leaves no pspec splits bit for bit equal
across the ranks; the relay knobs bit for bit inside the mesh; pack on
within the bounds of pack off; a snapshot at M = 2 byte for byte the
meshless one; the decode caches hold the rank's mamba channels and RWKV
heads.

hymba smoke (4 q heads over 2 kv: the attention splits), hymba smoke
with 5 q heads over 1 kv head (the attention runs whole on both ranks,
as the full config's 25 over 5 does on the card) and rwkv6 smoke; f32,
parameters drawn with numpy at fan-in scales
(``repro_torch.testing.fan_in_params``).  One spawn of the six processes
for the module; the JAX reference runs beside them."""
import os
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
from repro_torch.models.common import is_spec  # noqa: E402
from repro_torch.models.model import LayeredModel  # noqa: E402
from repro_torch.testing import fan_in_params  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
# torch_recurrent_worker.CASES, as the JAX configs read them
CASES = {"hymba": ("hymba-1.5b", {}),
         "hymba-h5": ("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 1}),
         "rwkv6": ("rwkv6-1.6b", {})}
MORE = ("hymba-h5", "rwkv6")     # torch_recurrent_worker.MORE
N_KNOBS = 5                      # torch_tp_worker.KNOBS, the first the base
B, S, UB = 8, 16, 2
LOSS_REL, GRAD_REL, LOGIT_REL = 1e-5, 1e-4, 1e-4
# rwkv6's gradients (and grad norm) against the reference: at these f32
# fan-in draws both packages' gradients stand ~1e-4 to 2e-4 in relative
# L2 from an f64 run of the port (test_rwkv6_bound_is_f32_rounding), so
# the two stand ~1e-4 apart with no mesh at all; the mesh is held to the
# port's meshless engine within GRAD_REL besides
# (test_model_ranks_match_the_meshless_port)
GRAD_REL_SSM = 5e-4
WHATS = ("train", "grads", "prefill", "decode")
LIVE_SLOTS = 10                  # torch_recurrent_worker.LIVE
# the leaves whose gradients cross the ranks in ways a plain column or
# row split does not (each named in the asserts)
NAMED = {"hybrid": (("mamba", "w_in"), ("mamba", "w_bcdt")),
         "ssm": (("tm", "decay_a"), ("tm", "decay_b"), ("tm", "ln_scale"))}


def _cfg(case, get=get_config):
    name, kw = CASES[case]
    return get(name, "smoke").replace(dtype="float32", **kw)


def _draw(case):
    """numpy parameters (port flatten order) and a global batch."""
    rs = np.random.RandomState(40 + list(CASES).index(case))
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


def _named(case):
    """{name: flat leaf index} of the ``NAMED`` leaves of a case."""
    cfg = _cfg(case)
    it = iter(range(10 ** 6))
    idx = tree_map(lambda _: next(it), LayeredModel(cfg).param_specs(),
                   is_leaf=is_spec)
    return {"/".join(k): idx["groups"][0][k[0]][k[1]]
            for k in NAMED[cfg.family]}


def _spawn(tmp, inp, world):
    store = str(tmp / f"store{world}")
    env = {**os.environ, "PYTHONPATH": f"{SRC}{os.pathsep}{HERE}",
           "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_recurrent_worker.py"),
         inp, str(tmp / f"out{world}_{r}.npz"), store, str(r), str(world)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(world)]


def _reference(case, leaves, batch):
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
        for k in ("loss", "grad_norm"):
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
    tmp = tmp_path_factory.mktemp("recurrent_mesh")
    drawn = {c: _draw(c) for c in CASES}
    inp = {}
    for c, (leaves, batch) in drawn.items():
        inp.update({f"{c}/p/{i}": x for i, x in enumerate(leaves)})
        inp.update({f"{c}/b/{k}": v for k, v in batch.items()})
    path = str(tmp / "in.npz")
    np.savez(path, **inp)
    procs = _spawn(tmp, path, 2) + _spawn(tmp, path, 4)
    try:
        ref = {c: _reference(c, *drawn[c]) for c in CASES}
    finally:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    load = lambda name: dict(np.load(str(tmp / name)))
    return dict(ranks=[load(f"out2_{r}.npz") for r in range(2)],
                four=[load(f"out4_{r}.npz") for r in range(4)], ref=ref,
                tmp=tmp)


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
    order = np.argsort(np.concatenate(idx))
    return [np.concatenate([g[j] for g in got])[order]
            for j in range(len(got[0]))]


def _grad_rel(case):
    return GRAD_REL_SSM if _cfg(case).family == "ssm" else GRAD_REL


def _check(outs, pre, ref, what, data_ranks=1, grad_rel=GRAD_REL):
    """One entry point of every rank against the reference: losses within
    ``LOSS_REL``, grad norms and each gradient leaf within ``grad_rel``,
    logits within ``LOGIT_REL``."""
    for out in outs:
        if what == "train":
            for i in range(2 if f"{pre}/train1/loss/0" in out else 1):
                for k, bound in (("loss", LOSS_REL), ("grad_norm", grad_rel)):
                    got = float(_get(out, f"{pre}/train{i}/{k}")[0])
                    want = ref[f"train{i}/{k}"]
                    assert abs(got - want) <= bound * abs(want), \
                        (i, k, got, want)
            _close([m / np.float32(0.1)
                    for m in _get(out, f"{pre}/train0/m")],
                   ref["grads"], grad_rel)
        elif what == "grads":
            got = float(_get(out, f"{pre}/grads/loss")[0])
            assert abs(got - ref["train0/loss"]) <= \
                LOSS_REL * ref["train0/loss"]
            _close(_get(out, f"{pre}/grads/grads"), ref["grads"], grad_rel)
    if what in ("prefill", "decode"):
        # model ranks return the whole logits; data ranks their rows
        n = len(outs) // data_ranks
        for m in range(n):
            _close(_rows(outs[m::n], pre, what), ref[what], LOGIT_REL)


@pytest.mark.parametrize("case,what", [(c, w) for c in CASES for w in WHATS])
def test_model_ranks_match_the_reference(runs, case, what):
    """l2l-p on two model ranks, gathered, against the reference's meshless
    engine: two steps' losses and grad norms within 1e-5 relative, each
    gradient leaf within 1e-4 relative L2, the whole logits of prefill,
    decode_init and two decode steps within 1e-4."""
    _check(runs["ranks"], f"{case}/l2l-p", runs["ref"][case], what,
           grad_rel=_grad_rel(case))


@pytest.mark.parametrize("case", list(CASES))
def test_model_ranks_match_the_meshless_port(runs, case):
    """l2l-p, l2l and the baseline on two model ranks and l2l-p on
    (data=2, model=2), held to the port's own meshless l2l-p engine on
    the same inputs: losses and grad norms within ``LOSS_REL``, every
    gradient leaf within ``GRAD_REL`` (rwkv6 included: what separates it
    from the reference is f32 rounding of the model, not the mesh)."""
    one = runs["ranks"][0]
    want = {f"train{i}/{k}": float(_get(one, f"{case}/one/train{i}/{k}")[0])
            for i in range(2) for k in ("loss", "grad_norm")}
    want["grads"] = _get(one, f"{case}/one/grads/grads")
    for outs, pre, d in ((runs["ranks"], "l2l-p", 1),
                         (runs["ranks"], "l2l", 1),
                         (runs["ranks"], "baseline", 1),
                         (runs["four"], "dm", 2)):
        for what in ("train", "grads"):
            _check(outs, f"{case}/{pre}", want, what, d)
    # the meshless port's steps are the gradients' own: m = 0.1 g
    _close([m / np.float32(0.1)
            for m in _get(one, f"{case}/one/train0/m")], want["grads"],
           GRAD_REL)


def test_rwkv6_bound_is_f32_rounding(runs):
    """What ``GRAD_REL_SSM`` bounds: the port's meshless f32 gradients of
    rwkv6 and the reference's each stand within half of it (relative L2,
    every leaf) of the port's whole model in f64 on the same draw
    (``full_loss``, autograd), so the two packages stand within it of
    each other with no mesh: f32 rounding of the model, not the mesh."""
    cfg = _cfg("rwkv6").replace(dtype="float64", param_dtype="float64")
    leaves, batch = _draw("rwkv6")
    it = iter(leaves)
    params = tree_map(lambda _: torch.tensor(next(it), dtype=torch.float64,
                                             requires_grad=True),
                      LayeredModel(cfg).param_specs(), is_leaf=is_spec)
    loss, _ = LayeredModel(cfg).full_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    f64 = [a.grad.numpy() for a in tree_leaves(params)]
    port = _get(runs["ranks"][0], "rwkv6/one/grads/grads")
    for got in (port, runs["ref"]["rwkv6"]["grads"]):
        worst = max(_rel_l2(g.astype(np.float64), w)
                    for g, w in zip(got, f64))
        assert worst <= GRAD_REL_SSM / 2, worst


@pytest.mark.parametrize("case", list(CASES))
def test_data_and_model_ranks_match_the_reference(runs, case):
    """One step, grads, prefill and decode on (data=2, model=2), each rank
    on its rows of every call: the same bounds on all four ranks, the
    rows of prefill and decode put back in global order."""
    for what in WHATS:
        _check(runs["four"], f"{case}/dm", runs["ref"][case], what, 2,
               _grad_rel(case))


@pytest.mark.parametrize("name", ["l2l", "baseline"])
def test_alg3_and_baseline_on_model_ranks_match_the_reference(runs, name):
    """Two steps and grads under Alg 3 (l2l) and the baseline engine's
    autograd on two model ranks: the same bounds as l2l-p's."""
    for case in CASES:
        for what in ("train", "grads"):
            _check(runs["ranks"], f"{case}/{name}", runs["ref"][case], what,
                   grad_rel=_grad_rel(case))


@pytest.mark.parametrize("case", list(CASES))
def test_named_gradients_match_the_reference(runs, case):
    """hymba's mamba ``w_in`` (its ``[x | z]`` block gathered forward, the
    cotangent summed and sliced backward) and ``w_bcdt`` (B, C and dt
    through ``copy_in``); rwkv6's ``decay_a``, ``decay_b`` and
    ``ln_scale`` (whole, each rank's channels through ``copy_in``): each
    within 1e-4 relative L2 of the reference's gradient under every
    engine on two model ranks and on (data=2, model=2), and not zero."""
    ref = runs["ref"][case]["grads"]
    named = _named(case)
    sources = [(o, f"{case}/{e}") for o in runs["ranks"]
               for e in ("l2l-p", "l2l", "baseline")]
    sources += [(o, f"{case}/dm") for o in runs["four"]]
    for out, pre in sources:
        grads = _get(out, f"{pre}/grads/grads")
        for name, i in named.items():
            assert np.abs(ref[i]).max() > 0, name
            assert _rel_l2(grads[i], ref[i]) <= _grad_rel(case), \
                (pre, name)


@pytest.mark.parametrize("case", list(CASES))
def test_unsplit_leaves_agree_bitwise_across_model_ranks(runs, case):
    """The leaves no pspec splits (norms, hymba's attention where its
    heads do not divide, rwkv6's mixing and decay leaves) and their Adam
    slots after two steps, and their gradients, hold the same bits on both
    model ranks; so do the gathered gradients and the losses."""
    r0, r1 = runs["ranks"]
    for e in ("l2l-p", "l2l", "baseline"):
        for key in ("whole", "grads/whole", "grads/grads", "train0/loss",
                    "train1/loss", "grads/loss"):
            k = f"{case}/{e}/{key}"
            for a, b in zip(_get(r0, k), _get(r1, k)):
                assert np.array_equal(a, b), k


@pytest.mark.parametrize("case", MORE)
def test_knob_points_are_bitwise_inside_the_mesh(runs, case):
    """prefetch 0 / 1, G 1 / 2, stash_every 1 / 2 on two model ranks: one
    train step each, the same bits as the base point's."""
    for out in runs["ranks"]:
        base = _get(out, f"{case}/knob0")
        for knob in range(1, N_KNOBS):
            got = _get(out, f"{case}/knob{knob}")
            assert len(got) == len(base)
            for a, b in zip(got, base):
                assert np.array_equal(a, b), knob


@pytest.mark.parametrize("case", MORE)
def test_pack_on_matches_pack_off_within_bounds(runs, case):
    """With pack_params the packed rows stay whole on each model rank (only
    the vocabulary splits): held to the reference and to pack off within
    the bounds."""
    ref = runs["ref"][case]
    for out in runs["ranks"]:
        got = float(_get(out, f"{case}/pack/train0/loss")[0])
        assert abs(got - ref["train0/loss"]) <= LOSS_REL * ref["train0/loss"]
        m = [a / np.float32(0.1) for a in _get(out, f"{case}/pack/train0/m")]
        _close(m, ref["grads"], _grad_rel(case))
        off = [a / np.float32(0.1)
               for a in _get(out, f"{case}/l2l-p/train0/m")]
        _close(m, off, GRAD_REL)


@pytest.mark.parametrize("case", MORE)
def test_a_snapshot_at_two_model_ranks_is_the_meshless_snapshot(runs, case):
    """``Engine.save`` at M = 2 gathers the blocks and rank 0 writes:
    every file byte for byte what a meshless engine writes for the
    gathered state."""
    tp, one = (runs["tmp"] / f"{case}_tp" / "ckpt_1",
               runs["tmp"] / f"{case}_one" / "ckpt_1")
    names = sorted(os.listdir(tp))
    assert names == sorted(os.listdir(one)) and names
    for n in names:
        assert (tp / n).read_bytes() == (one / n).read_bytes(), n


def test_the_caches_hold_the_local_channels_and_heads(runs):
    """decode_init's caches on two model ranks: hymba's mamba state holds
    64 of 128 channels (``h`` and the conv window), its kv ring 1 of 2 kv
    heads where the heads split and the one kv head whole where they do
    not; rwkv6's wkv state holds 2 of 4 heads, its shifts whole.  On
    (data=2, model=2) the same, for 4 of the 8 rows."""
    L, K = 2, 4
    want = {"hymba": [(L, B, LIVE_SLOTS, 1, 32), (L, B, 64, 4),
                      (L, B, K - 1, 64)],
            "hymba-h5": [(L, B, LIVE_SLOTS, 1, 32), (L, B, 64, 4),
                         (L, B, K - 1, 64)],
            "rwkv6": [(L, B, 2, 32, 32), (L, B, 128), (L, B, 128)]}
    for case, shapes in want.items():
        for outs, pre, rows in ((runs["ranks"], "l2l-p", B),
                                (runs["four"], "dm", B // 2)):
            for out in outs:
                got = [tuple(int(x) for x in s)
                       for s in _get(out, f"{case}/{pre}/cache_shapes")]
                assert got == [(s[0], rows) + s[2:] for s in shapes], \
                    (case, pre, got)


def test_the_collectives_are_counted(runs):
    """An l2l-p step on two model ranks counts its gathers: hymba's
    ``[x | z]`` (one a layer a microbatch, forward and recompute: 2 x 2 x
    2 = 8), none for rwkv6, whose vocabulary splits but whose logits are
    only gathered to serve."""
    for out in runs["ranks"]:
        for case, gathers in (("hymba", 8), ("hymba-h5", 8), ("rwkv6", 0)):
            calls = [int(x) for x in
                     _get(out, f"{case}/l2l-p/train0/collectives")]
            assert calls[2] == gathers, (case, calls)
            assert calls[0] > 0, (case, calls)


def _mesh(shape, coord):
    return SimpleNamespace(shape=shape, coordinate=coord,
                           get_group=lambda name: None)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-1.6b"])
def test_each_model_rank_holds_its_block_at_full_width(arch):
    """At full width on two model ranks, by the reference's train rules:
    hymba's 25 q and 5 kv heads do not divide (attention whole, no split
    flag), its ffn (5504) does: the MLP's columns and every mamba leaf's
    1600 channels (``w_in``'s 3200 columns: x on rank 0, z on rank 1) and
    the state's ``h`` and conv window; the vocabulary (32001) whole.
    rwkv6's ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` columns, ``w_o`` rows,
    ``u`` and the wkv state by heads (16 of 32), the channel mix by ffn,
    the vocabulary (65536) split; the mixing, decay and norm leaves
    whole."""
    cfg = get_config(arch, "full")
    specs = LayeredModel(cfg).param_specs()
    shape = {"data": 1, "model": 2}
    rules = shd.make_rules(cfg, _mesh(shape, {"data": 0, "model": 0}))
    for r in range(2):
        tp = TensorParallel(_mesh(shape, {"data": 0, "model": r}), cfg,
                            specs, rules)
        layer = tp.layer_pspecs[0]
        model = LayeredModel(cfg, tp=tp)
        cache = model.groups[0].cache_spec(4, 16)
        if cfg.family == "hybrid":
            assert tp.ffn and not tp.heads and not tp.kv and not tp.vocab
            assert tp.channel_block(cfg.d_model) == (800 * r, 800 * (r + 1))
            for k in ("w_in", "conv", "w_dt", "dt_bias", "a_log",
                      "d_skip"):
                assert layer["mamba"][k] == (shd.P("model") if k in (
                    "dt_bias", "a_log", "d_skip") else shd.P(None,
                                                             "model")), k
            for k in ("w_bcdt", "w_out"):
                assert layer["mamba"][k] == shd.P("model"), k
            for k in ("wq", "wk", "wv", "wo"):
                assert not shd.is_split_over(layer["attn"][k]), k
            assert cache["ssm"]["h"].shape == (4, 800, cfg.ssm_state)
            assert cache["ssm"]["conv"].shape == (4, cfg.ssm_conv - 1, 800)
            assert cache["kv"]["k"].shape[2] == cfg.n_kv_heads
        else:
            assert tp.heads and tp.heads_x_dim and tp.ffn and tp.vocab
            for k in ("w_r", "w_k", "w_v", "w_g"):
                assert layer["tm"][k] == shd.P(None, "model"), k
            assert layer["tm"]["w_o"] == shd.P("model")
            assert layer["tm"]["u"] == shd.P("model")
            assert layer["cm"]["w_k"] == shd.P(None, "model")
            assert layer["cm"]["w_v"] == shd.P("model")
            for k in ("mu_x", "mu", "lora_a", "lora_b", "decay_a",
                      "decay_b", "w0", "ln_scale"):
                assert not shd.is_split_over(layer["tm"][k]), k
            for k in ("mu_k", "mu_r", "w_r"):
                assert not shd.is_split_over(layer["cm"][k]), k
            assert cache["wkv"].shape == (4, 16, 64, 64)
            assert cache["tm_shift"].shape == (4, cfg.d_model)
