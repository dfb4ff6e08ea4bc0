"""The VLM and audio families on the mesh's model axis on the CPU:
internvl2-1b's heads, MLP columns and vocabulary over "model" with its
patch projection whole on every rank, and whisper-base's encoder,
decoder and cross-attention heads, MLP columns and vocabulary over
"model" with ``enc_ln_post`` whole, by the reference's train rules.  Gloo
ranks (tests/torch_modality_worker.py: two on ``(data=1, model=2)``,
four on ``(data=2, model=2)``), each on its blocks and its rows of every
call, gathered and held to the JAX reference's meshless engine at the
global batch on the same numpy inputs: train step, grads, prefill and
decode under l2l-p, train step and grads under l2l and the baseline,
within ``test_torch_tensor_parallel.py``'s bounds; the gradients of
``proj_w`` / ``proj_b`` (whole leaves fed the cotangent the layers'
``copy_in``s summed), of ``enc_ln_post`` and every encoder leaf (reached
only through the cross-attention memory's cotangent, summed over the
decoder's layers and over the ranks' heads) and of the decoder's
cross-attention ``wk`` / ``wv`` named; the leaves no pspec splits bit for
bit equal across the ranks; the relay knobs bit for bit inside the mesh;
pack on within the bounds of pack off; a snapshot at M = 2 byte for byte
the meshless one; the decode caches (whisper's cross-attention K/V too)
hold the rank's kv heads.

internvl2-1b smoke and whisper-base smoke, each with its vocabulary of
512 (split over the two ranks) and of 511 (whole, as the full configs'
odd vocabularies on the card); f32, parameters drawn with numpy at
fan-in scales (``repro_torch.testing.fan_in_params``).  One spawn of the
six processes for the module; the JAX reference runs beside them."""
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
# torch_modality_worker.CASES, as the JAX configs read them
CASES = {"vlm": ("internvl2-1b", {}),
         "vlm-v511": ("internvl2-1b", {"vocab_size": 511}),
         "audio": ("whisper-base", {}),
         "audio-v511": ("whisper-base", {"vocab_size": 511})}
MORE = ("vlm", "audio")          # torch_modality_worker.MORE
N_KNOBS = 5                      # torch_tp_worker.KNOBS, the first the base
B, S, UB = 8, 16, 2
PROMPT = 8                       # torch_modality_worker.PROMPT
LOSS_REL, GRAD_REL, LOGIT_REL = 1e-5, 1e-4, 1e-4
WHATS = ("train", "grads", "prefill", "decode")
LIVE_SLOTS = 10                  # torch_modality_worker.LIVE


def _cfg(case, get=get_config):
    name, kw = CASES[case]
    return get(name, "smoke").replace(dtype="float32", **kw)


def _draw(case):
    """numpy parameters (port flatten order) and a global batch with its
    patches or frames."""
    rs = np.random.RandomState(60 + list(CASES).index(case))
    cfg = _cfg(case)
    params = fan_in_params(LayeredModel(cfg).param_specs(),
                           lambda shape: rs.randn(*shape))
    leaves = [np.asarray(a, np.float32) for a in tree_leaves(params)]
    mask = np.ones((B, S), np.float32)
    mask[1, -3:] = 0.0                      # a weighted loss, as padding
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "mask": mask}
    if cfg.family == "audio":
        batch["frames"] = rs.randn(B, cfg.n_frames,
                                   cfg.d_model).astype(np.float32)
    else:
        batch["patches"] = rs.randn(B, cfg.n_patches,
                                    cfg.vit_dim).astype(np.float32)
    return leaves, batch


def _named(case):
    """{name: flat leaf index} of the leaves whose gradients cross the
    ranks in ways a plain column or row split does not: internvl2's patch
    projection; whisper's ``enc_ln_post``, every encoder leaf but the k
    bias (``_exact_zero``) and the decoder's cross-attention ``wk`` /
    ``wv``."""
    cfg = _cfg(case)
    it = iter(range(10 ** 6))
    idx = tree_map(lambda _: next(it), LayeredModel(cfg).param_specs(),
                   is_leaf=is_spec)
    if cfg.family == "vlm":
        return {k: idx["embed"][k] for k in ("proj_w", "proj_b")}
    out = {f"enc_ln_post/{k}": i
           for k, i in idx["embed"]["enc_ln_post"].items()}
    enc = idx["groups"][0]
    out.update({f"encoder/{a}/{b}": enc[a][b] for a in enc for b in enc[a]
                if enc[a][b] not in _exact_zero(case)})
    out.update({f"xattn/{k}": idx["groups"][1]["xattn"][k]
                for k in ("wk", "wv")})
    return out


def _spawn(tmp, inp, world):
    store = str(tmp / f"store{world}")
    env = {**os.environ, "PYTHONPATH": f"{SRC}{os.pathsep}{HERE}",
           "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_modality_worker.py"),
         inp, str(tmp / f"out{world}_{r}.npz"), store, str(r), str(world)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(world)]


def _reference(case, leaves, batch):
    """The JAX l2l-p engine on the whole batch without a mesh: two train
    steps (the first one's Adam slots give the gradients), prefill with
    the stub and decode (whisper's decode_init with the frames,
    internvl2's on text, as the reference decodes its backbone)."""
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
    prompt = jb["tokens"][:, :PROMPT]
    key = "frames" if cfg.family == "audio" else "patches"
    out["prefill"] = [np.asarray(eng.prefill(params, {"tokens": prompt,
                                                      key: jb[key]}))]
    frames = {"frames": jb["frames"]} if cfg.family == "audio" else {}
    caches, last = eng.decode_init(params, prompt, LIVE_SLOTS, **frames)
    logits = [np.asarray(last)]
    for i in range(2):
        lg, caches = eng.decode_step(params, caches,
                                     jb["tokens"][:, PROMPT + i:PROMPT + 1
                                                  + i],
                                     jnp.int32(PROMPT + i))
        logits.append(np.asarray(lg[:, -1]))
    out["decode"] = logits
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("modality_mesh")
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


def _exact_zero(case):
    """Flat indices of the gradient leaves that are zero in exact
    arithmetic: whisper's attention k biases (no rope, so ``bk`` shifts
    each query's scores by one constant, which the softmax drops).  Their
    computed gradients are rounding noise (~1e-10), so a relative L2
    between two of them says nothing; ``_close`` holds them in absolute
    terms instead."""
    cfg = _cfg(case)
    if cfg.family != "audio":
        return frozenset()
    it = iter(range(10 ** 6))
    idx = tree_map(lambda _: next(it), LayeredModel(cfg).param_specs(),
                   is_leaf=is_spec)
    return frozenset(g[a]["bk"] for g in idx["groups"]
                     for a in ("attn", "xattn") if a in g)


def _close(got, want, rel, zero=frozenset()):
    """Each leaf within ``rel`` relative L2 of ``want``'s; the leaves of
    ``zero`` (``_exact_zero``) within ``rel`` times the largest entry of
    all of ``want``, absolutely."""
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        if i in zero:
            err = float(np.abs(g - w).max())
            assert err <= rel * scale, (i, err, scale)
        else:
            assert _rel_l2(g, w) <= rel, (i, _rel_l2(g, w))


def _rows(outs, pre, what):
    """The global rows of a data-parallel call from every rank's rows and
    their global indices."""
    got = [_get(o, f"{pre}/{what}") for o in outs]
    idx = [_get(o, f"{pre}/{what}_rows")[0] for o in outs]
    order = np.argsort(np.concatenate(idx))
    return [np.concatenate([g[j] for g in got])[order]
            for j in range(len(got[0]))]


def _check(outs, pre, ref, what, data_ranks=1):
    """One entry point of every rank against the reference: losses within
    ``LOSS_REL``, grad norms and each gradient leaf within ``GRAD_REL``
    (``_close``), logits within ``LOGIT_REL``."""
    zero = _exact_zero(pre.split("/")[0])
    for out in outs:
        if what == "train":
            for i in range(2 if f"{pre}/train1/loss/0" in out else 1):
                for k, bound in (("loss", LOSS_REL), ("grad_norm", GRAD_REL)):
                    got = float(_get(out, f"{pre}/train{i}/{k}")[0])
                    want = ref[f"train{i}/{k}"]
                    assert abs(got - want) <= bound * abs(want), \
                        (i, k, got, want)
            _close([m / np.float32(0.1)
                    for m in _get(out, f"{pre}/train0/m")],
                   ref["grads"], GRAD_REL, zero)
        elif what == "grads":
            got = float(_get(out, f"{pre}/grads/loss")[0])
            assert abs(got - ref["train0/loss"]) <= \
                LOSS_REL * ref["train0/loss"]
            _close(_get(out, f"{pre}/grads/grads"), ref["grads"], GRAD_REL,
                   zero)
    if what in ("prefill", "decode"):
        # model ranks return the whole logits; data ranks their rows
        n = len(outs) // data_ranks
        for m in range(n):
            _close(_rows(outs[m::n], pre, what), ref[what], LOGIT_REL)


@pytest.mark.parametrize("case,what", [(c, w) for c in CASES for w in WHATS])
def test_model_ranks_match_the_reference(runs, case, what):
    """l2l-p on two model ranks, gathered, against the reference's meshless
    engine: two steps' losses and grad norms within 1e-5 / 1e-4 relative,
    each gradient leaf within 1e-4 relative L2, the whole logits of
    prefill (with the patches or frames), decode_init and two decode
    steps within 1e-4."""
    _check(runs["ranks"], f"{case}/l2l-p", runs["ref"][case], what)


@pytest.mark.parametrize("case", list(CASES))
def test_model_ranks_match_the_meshless_port(runs, case):
    """l2l-p, l2l and the baseline on two model ranks and l2l-p on
    (data=2, model=2), held to the port's own meshless l2l-p engine on
    the same inputs: losses within ``LOSS_REL``, grad norms and every
    gradient leaf within ``GRAD_REL``."""
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
           GRAD_REL, _exact_zero(case))


@pytest.mark.parametrize("case", list(CASES))
def test_data_and_model_ranks_match_the_reference(runs, case):
    """One step, grads, prefill and decode on (data=2, model=2), each rank
    on its rows of every call (the frames and patches cut with the
    tokens): the same bounds on all four ranks, the rows of prefill and
    decode put back in global order."""
    for what in WHATS:
        _check(runs["four"], f"{case}/dm", runs["ref"][case], what, 2)


@pytest.mark.parametrize("name", ["l2l", "baseline"])
def test_alg3_and_baseline_on_model_ranks_match_the_reference(runs, name):
    """Two steps and grads under Alg 3 (l2l) and the baseline engine's
    autograd on two model ranks: the same bounds as l2l-p's."""
    for case in CASES:
        for what in ("train", "grads"):
            _check(runs["ranks"], f"{case}/{name}", runs["ref"][case], what)


@pytest.mark.parametrize("case", list(CASES))
def test_named_gradients_match_the_reference(runs, case):
    """internvl2's ``proj_w`` / ``proj_b`` (whole on every rank, fed the
    input cotangent the layers' ``copy_in``s summed); whisper's
    ``enc_ln_post``, every leaf of the encoder (whose cotangent comes only
    through the memory: a rank that did not sum the memory's cotangent
    over the heads would hold its own heads' share here while every
    decoder gradient stayed right) and the decoder's cross-attention
    ``wk`` / ``wv``: each within 1e-4 relative L2 of the reference's
    gradient under every engine on two model ranks and on (data=2,
    model=2), and not zero."""
    ref = runs["ref"][case]["grads"]
    named = _named(case)
    sources = [(o, f"{case}/{e}") for o in runs["ranks"]
               for e in ("l2l-p", "l2l", "baseline")]
    sources += [(o, f"{case}/dm") for o in runs["four"]]
    for out, pre in sources:
        grads = _get(out, f"{pre}/grads/grads")
        for name, i in named.items():
            assert np.abs(ref[i]).max() > 0, name
            assert _rel_l2(grads[i], ref[i]) <= GRAD_REL, (pre, name)


@pytest.mark.parametrize("case", list(CASES))
def test_unsplit_leaves_agree_bitwise_across_model_ranks(runs, case):
    """The leaves no pspec splits (the norms, internvl2's ``proj_w`` /
    ``proj_b``, whisper's ``enc_ln_post`` and ``bo``s, the vocabulary of
    511) and their Adam slots after two steps, and their gradients, hold
    the same bits on both model ranks; so do the gathered gradients and
    the losses."""
    r0, r1 = runs["ranks"]
    for e in ("l2l-p", "l2l", "baseline"):
        for key in ("whole", "grads/whole", "grads/grads", "train0/loss",
                    "train1/loss", "grads/loss"):
            k = f"{case}/{e}/{key}"
            for a, b in zip(_get(r0, k), _get(r1, k)):
                assert np.array_equal(a, b), k


def test_knob_points_are_bitwise_inside_the_mesh(runs):
    """prefetch 0 / 1, G 1 / 2, stash_every 1 / 2 on two model ranks: one
    train step each of internvl2 and whisper (vocabulary split), the same
    bits as the base point's."""
    for case in MORE:
        for out in runs["ranks"]:
            base = _get(out, f"{case}/knob0")
            for knob in range(1, N_KNOBS):
                got = _get(out, f"{case}/knob{knob}")
                assert len(got) == len(base)
                for a, b in zip(got, base):
                    assert np.array_equal(a, b), (case, knob)


def test_pack_on_matches_pack_off_within_bounds(runs):
    """With pack_params the packed rows stay whole on each model rank (only
    the vocabulary splits): internvl2 and whisper held to the reference
    and to pack off within the bounds."""
    for case in MORE:
        ref = runs["ref"][case]
        for out in runs["ranks"]:
            got = float(_get(out, f"{case}/pack/train0/loss")[0])
            assert abs(got - ref["train0/loss"]) <= \
                LOSS_REL * ref["train0/loss"]
            m = [a / np.float32(0.1)
                 for a in _get(out, f"{case}/pack/train0/m")]
            _close(m, ref["grads"], GRAD_REL, _exact_zero(case))
            off = [a / np.float32(0.1)
                   for a in _get(out, f"{case}/l2l-p/train0/m")]
            _close(m, off, GRAD_REL, _exact_zero(case))


def test_a_snapshot_at_two_model_ranks_is_the_meshless_snapshot(runs):
    """``Engine.save`` at M = 2 gathers the blocks and rank 0 writes: for
    internvl2 and whisper every file byte for byte what a meshless engine
    writes for the gathered state."""
    for case in MORE:
        tp, one = (runs["tmp"] / f"{case}_tp" / "ckpt_1",
                   runs["tmp"] / f"{case}_one" / "ckpt_1")
        names = sorted(os.listdir(tp))
        assert names == sorted(os.listdir(one)) and names
        for n in names:
            assert (tp / n).read_bytes() == (one / n).read_bytes(), \
                (case, n)


def test_the_caches_hold_the_local_kv_heads(runs):
    """decode_init's caches on two model ranks: internvl2's kv ring holds
    1 of its 2 kv heads; whisper's decoder ring and its cross-attention
    K/V over the 16 frames hold 2 of 4.  On (data=2, model=2) the same,
    for 4 of the 8 rows."""
    L = 2
    kv = (L, B, LIVE_SLOTS, 1, 32)
    ring, cross = (L, B, LIVE_SLOTS, 2, 32), (L, B, 16, 2, 32)
    want = {"vlm": [kv, kv], "vlm-v511": [kv, kv],
            "audio": [ring, cross, cross],
            "audio-v511": [ring, cross, cross]}
    for case, shapes in want.items():
        for outs, pre, rows in ((runs["ranks"], "l2l-p", B),
                                (runs["four"], "dm", B // 2)):
            for out in outs:
                got = [tuple(int(x) for x in s)
                       for s in _get(out, f"{case}/{pre}/cache_shapes")]
                assert got == [(s[0], rows) + s[2:] for s in shapes], \
                    (case, pre, got)


def _mesh(shape, coord):
    return SimpleNamespace(shape=shape, coordinate=coord,
                           get_group=lambda name: None)


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-base"])
def test_each_model_rank_holds_its_block_at_full_width(arch):
    """At full width on two model ranks, by the reference's train rules:
    internvl2's 14 q heads split 7 a rank over 1 of its 2 kv heads, its
    ffn (4864) splits, its vocabulary (151655, odd) stays whole, and the
    patch projection (``proj_w`` on ("lora", "d_model"), ``proj_b``) is
    whole on every rank.  whisper's 8 heads and 8 kv heads split 4 a
    rank in the encoder's and decoder's self-attention and the decoder's
    cross-attention, its ffn (2048) splits, its vocabulary (51865) and
    ``enc_ln_post`` stay whole; the decoder's cache holds 4 kv heads of
    the ring and of the cross-attention K/V over 1500 frames."""
    cfg = get_config(arch, "full")
    specs = LayeredModel(cfg).param_specs()
    shape = {"data": 1, "model": 2}
    rules = shd.make_rules(cfg, _mesh(shape, {"data": 0, "model": 0}))
    for r in range(2):
        tp = TensorParallel(_mesh(shape, {"data": 0, "model": r}), cfg,
                            specs, rules)
        assert tp.heads and tp.kv and tp.ffn and not tp.vocab
        assert tp.local_kv_heads() == cfg.n_kv_heads // 2
        model = LayeredModel(cfg, tp=tp)
        embed = tp.static_pspecs["embed"]
        assert not shd.is_split_over(embed["tok"])
        for g, layer in enumerate(tp.layer_pspecs):
            attns = ("attn", "xattn") if "xattn" in layer else ("attn",)
            for a in attns:
                for k in ("wq", "wk", "wv"):
                    assert layer[a][k] == shd.P(None, "model"), (g, a, k)
                assert layer[a]["wo"] == shd.P("model"), (g, a)
        cache = model.groups[-1].cache_spec(4, 16)
        if cfg.family == "vlm":
            for k in ("proj_w", "proj_b"):
                assert not shd.is_split_over(embed[k]), k
            assert cache["k"].shape == (4, 16, 1, 64)
        else:
            assert len(tp.layer_pspecs) == 2
            for k in ("scale", "bias"):
                assert not shd.is_split_over(embed["enc_ln_post"][k]), k
            assert cache["kv"]["k"].shape == (4, 16, 4, 64)
            for k in ("xk", "xv"):
                assert cache[k].shape == (4, 1500, 4, 64), k
