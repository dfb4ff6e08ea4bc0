"""The MoE family through the port's engines on the CPU: deepseek-v2-lite
(MLA; a dense layer 0, then MoE layers: two layer groups joined by a
transition) and grok-1 (GQA MoE, logit soft-cap) at smoke size, against
the JAX package on the same numpy inputs, f32, and the port against
itself.

* the full-width configs build; the transitions (identity, no memory);
* ``full_loss`` (both groups, aux included) against the JAX model's;
* greedy ``decode_init`` / ``decode_step`` tokens and logits and
  ``Engine.prefill`` against the JAX engine's;
* ``Engine.grads`` under l2l-p against the JAX engine's: every leaf, the
  router's included, whose gradient carries the load-balance loss's
  share only when the per-layer vjp differentiates ``(y, aux)`` with the
  cotangent ``(dx, S_loss / UB)``;
* one ``train_step`` under Alg 4 (l2l-p), Alg 3 (l2l) and the host
  optimizer against the JAX engine's l2l-p step;
* the reference's knob points ``(G, k, pack)`` in {(1, 0, F), (2, 2, T),
  (3, 1, F)} (tests/test_relay.py; G = 3 relays each one-layer group
  whole) and the train knobs (K, transport, the stash's place, Alg 3,
  the host optimizer) bit for bit inside the port, and l2l-p against the
  baseline (tests/test_equivalence.py's bound).

Parameters are drawn at the usual fan-in scales
(``repro_torch.testing.fan_in_params``) for the gradient checks, and
the reference's own init for serving."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import engine as jengines  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core.schedule import ExecutionConfig as JExec  # noqa: E402
from repro.engine.state import TrainState as JState  # noqa: E402
from repro.models.model import LayeredModel as JModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import engine as engines  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.schedule import ExecutionConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models.common import is_spec  # noqa: E402
from repro_torch.models.model import LayeredModel  # noqa: E402
from repro_torch.testing import fan_in_params, init_numpy  # noqa: E402,E501

ARCHS = ["deepseek-v2-lite-16b", "grok-1-314b"]
SLICE = dict(weight_stream=True, pack_params=True, prefetch_depth=1,
             transport="pallas", offload_stash=True, n_microbatches=2)
B, S = 4, 16
PROMPT, STEPS = 8, 4


def _cfg(arch):
    return get_config(arch, "smoke").replace(dtype="float32")


def _jcfg(arch):
    return jget_config(arch, "smoke").replace(dtype="float32")


def _batch(vocab, seed=0):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, S), np.float32)
    mask[0, -3:] = 0.0
    return {"tokens": rs.randint(0, vocab, (B, S)).astype(np.int32),
            "targets": rs.randint(0, vocab, (B, S)).astype(np.int32),
            "mask": mask}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rel_max(a, b):
    """max |a - b| over max |b| across a tree (tests/test_equivalence)."""
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    num = max(float(np.abs(x - y).max()) for x, y in zip(la, lb))
    return num / max(max(float(np.abs(y).max()) for y in lb), 1e-12)


def _engine(name, arch, **kw):
    return engines.create(name, _cfg(arch), ExecutionConfig(**kw),
                          device="cpu")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_configs_build(arch):
    """LayeredModel builds each config at full width: the reference's
    groups, and its ParamSpec shapes leaf for leaf (no weight drawn)."""
    model = LayeredModel(get_config(arch, "full"))
    jmodel = JModel(jget_config(arch, "full"))
    assert [(g.name, g.n_layers) for g in model.groups] == \
        [(g.name, g.n_layers) for g in jmodel.groups]
    got = tree_leaves(model.param_specs(), is_leaf=is_spec)
    want = jax.tree.leaves(jmodel.param_specs(),
                           is_leaf=lambda x: type(x).__name__ == "ParamSpec")
    assert [tuple(s.shape) for s in got] == [tuple(s.shape) for s in want]
    if arch.startswith("deepseek"):
        assert [g.n_layers for g in model.groups] == [1, 26]
        assert model.groups[1].spec["ffn"]["experts"]["w_in"].shape == \
            (64, 2048, 1408)


@pytest.mark.parametrize("pack", [False, True])
def test_streaming_init_equals_model_init(pack):
    """Engine.init_params draws group by group, layer by layer, into the
    relay layout: the same values as the model's init from the same seed,
    at the reference's scales per group (std 1/sqrt(n_layers of the
    group): 1 for the dense group's one layer, 1/sqrt(3) for 3 MoE
    layers)."""
    cfg = _cfg(ARCHS[0]).replace(n_layers=4)
    eng = engines.create("l2l", cfg, ExecutionConfig(
        weight_stream=True, pack_params=pack), device="cpu")
    got = eng._relay_params(eng.init_params(torch.Generator().manual_seed(5)))
    want = eng._relay_params(eng.model.init_params(
        torch.Generator().manual_seed(5)))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(want)))
    w = eng.model.init_params(torch.Generator().manual_seed(5))
    dense, moe = w["groups"]
    assert abs(float(dense["ffn"]["w_in"].std()) - 1.0) < 0.05
    assert abs(float(moe["ffn"]["experts"]["w_in"].std()) - 3 ** -0.5) < 0.02


def test_transitions_are_the_identity():
    model = LayeredModel(_cfg(ARCHS[0]))
    x = torch.randn(2, 3, model.cfg.d_model)
    assert model.transition_x(1, None, x, None) is x
    assert model.transition(1, None, x, None) == (x, None)


@pytest.fixture(scope="module", params=ARCHS)
def drawn(request):
    """numpy parameters at the usual fan-in scales, zero Adam slots, a
    batch, and the JAX engine's l2l-p step from them (its gradients read
    back from Adam's first moment, m = 0.1 g after one step)."""
    arch = request.param
    jeng = jengines.create("l2l-p", _jcfg(arch), JExec(n_microbatches=2),
                           donate=False)
    # the draws need the parameters' shapes only
    shapes = jeng.model.abstract_params()
    rs = np.random.RandomState(0)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          fan_in_params(shapes,
                                        lambda s: rs.randn(*s)))
    opt = _np({k: v for k, v in jeng._init_opt_legacy(params).items()
               if k in ("embed", "head", "groups")})
    batch = _batch(jeng.model.cfg.vocab_size)
    state = JState.from_legacy(jax.tree.map(jnp.asarray, params),
                               jeng._init_opt_legacy(params))
    new, metrics = jeng.train_step(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    is_slot = lambda x: isinstance(x, dict) and set(x) == {"m", "v"}
    grads = jax.tree.map(lambda s: np.asarray(s["m"]) / np.float32(0.1),
                         _np({k: new.legacy_opt()[k]
                              for k in ("embed", "head", "groups")}),
                         is_leaf=is_slot)
    return dict(arch=arch, params=params, opt=opt, batch=batch,
                loss=float(metrics["loss"]), aux=float(metrics["aux"]),
                grads=grads, new_params=_np(new.params))


def test_full_loss_matches_jax(drawn):
    """Both groups through the transition, aux included: the loss and the
    aux within 1e-6 relative (f32, sums in other orders)."""
    arch = drawn["arch"]
    jl, (_, _, jaux) = jax.jit(JModel(_jcfg(arch)).full_loss)(
        jax.tree.map(jnp.asarray, drawn["params"]),
        {k: jnp.asarray(v) for k, v in drawn["batch"].items()})
    with torch.no_grad():
        tl, (_, _, taux) = LayeredModel(_cfg(arch)).full_loss(
            bridge.params_from_numpy(drawn["params"]),
            _tbatch(drawn["batch"]))
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    assert float(taux) > 0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def test_grads_match_jax(drawn):
    """Engine.grads under l2l-p (the slice's knobs) against the JAX
    engine: the loss to 1e-5, every part to tests/test_equivalence.py's
    1e-5, and each router's gradient to 1e-5 relative L2 (without the aux
    cotangent it misses the load-balance share)."""
    loss, grads = _engine("l2l-p", drawn["arch"], **SLICE).grads(
        bridge.params_from_numpy(drawn["params"]), _tbatch(drawn["batch"]))
    assert abs(float(loss) - drawn["loss"]) <= 1e-5 * drawn["loss"]
    got = bridge.params_to_numpy(grads)
    for part in ("embed", "head", "groups"):
        assert _rel_max(got[part], drawn["grads"][part]) < 1e-5, part
    moe = got["groups"][-1]["ffn"]
    want = drawn["grads"]["groups"][-1]["ffn"]
    assert _rel_l2(moe["router"], want["router"]) <= 1e-5


STEP_ENGINES = {"alg4": ("l2l-p", {}), "alg3": ("l2l", {}),
                "host": ("l2l-p", dict(host_optimizer=True))}


@pytest.mark.parametrize("which", sorted(STEP_ENGINES))
def test_train_step_matches_jax(drawn, which):
    """One step (Adam) against the JAX engine's l2l-p step: the loss and
    aux to 1e-5, the updated params to 1e-5 where |g| > 1e-4 (Adam's first
    step moves an element by ~lr·sign(g): tests/test_torch_train.py)."""
    name, kw = STEP_ENGINES[which]
    eng = _engine(name, drawn["arch"], **{**SLICE, **kw})
    state = bridge.train_state_from_numpy(drawn["params"], drawn["opt"], 0,
                                          pack=True)
    new, metrics = eng.train_step(state, _tbatch(drawn["batch"]))
    params, _, step, _ = bridge.train_state_to_numpy(new)
    assert step == 1
    assert abs(float(metrics["loss"]) - drawn["loss"]) <= 1e-5 * drawn["loss"]
    assert abs(float(metrics["aux"]) - drawn["aux"]) <= 1e-5 * drawn["aux"]
    for part in ("embed", "head", "groups"):
        for w, g, gr in zip(jax.tree.leaves(drawn["new_params"][part]),
                            jax.tree.leaves(params[part]),
                            jax.tree.leaves(drawn["grads"][part])):
            keep = np.abs(gr) > 1e-4
            np.testing.assert_allclose(g[keep], w[keep], rtol=1e-5,
                                       atol=1e-6)


# the reference's (G, prefetch, pack) points; G = 3 is larger than either
# group, which it relays whole
KNOBS = [(1, 0, False), (2, 2, True), (3, 1, False)]


@pytest.mark.parametrize("g,k,pack", KNOBS)
def test_grads_knob_points_are_bitwise(drawn, g, k, pack):
    arch, params = drawn["arch"], bridge.params_from_numpy(drawn["params"])
    batch = _tbatch(drawn["batch"])
    want = _engine("l2l-p", arch, n_microbatches=2).grads(params, batch)
    got = _engine("l2l-p", arch, n_microbatches=2, layers_per_relay=g,
                  prefetch_depth=k, pack_params=pack,
                  transport="pallas" if pack else "xla").grads(params, batch)
    assert float(got[0]) == float(want[0])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got[1]), tree_leaves(want[1])))


TRAIN_GRID = [("l2l-p", dict(stash_every=2, offload_stash=True,
                             pack_params=True, transport="pallas")),
              ("l2l-p", dict(layers_per_relay=3, prefetch_depth=2,
                             stash_every=3)),
              ("l2l", dict(SLICE, stash_every=2)),
              ("l2l-p", dict(SLICE, host_optimizer=True)),
              ("l2l", dict(SLICE, host_optimizer=True))]


@pytest.fixture(scope="module")
def grid_base():
    arch = ARCHS[0]
    eng = _engine("l2l-p", arch, n_microbatches=2)
    st = eng.init(torch.Generator().manual_seed(5))
    batch = _tbatch(_batch(eng.model.cfg.vocab_size, seed=1))
    return arch, st, batch, _step_leaves(eng, st, batch)


def _step_leaves(eng, st, batch):
    new, m = eng.train_step(st, batch)
    p, o, _, _ = bridge.train_state_to_numpy(new)
    return float(m["loss"]), jax.tree.leaves(p), jax.tree.leaves(o)


@pytest.mark.parametrize("name,kw", TRAIN_GRID)
def test_train_knobs_are_bitwise(grid_base, name, kw):
    """deepseek smoke from the port's own init (std 1/sqrt(n_layers), as
    the reference's): the step's loss, params and Adam slots equal the
    plain schedule's bit for bit at every point."""
    arch, st, batch, want = grid_base
    got = _step_leaves(_engine(name, arch, **{"n_microbatches": 2, **kw}),
                       st, batch)
    assert got[0] == want[0]
    assert all(np.array_equal(a, b) for a, b in zip(got[1], want[1]))
    assert all(np.array_equal(a, b) for a, b in zip(got[2], want[2]))


def test_l2lp_matches_baseline(drawn):
    """Alg 2 (the whole model, gradients accumulated over the
    microbatches) against Alg 4, the same step: params and loss to
    tests/test_equivalence.py's 1e-5."""
    arch, batch = drawn["arch"], _tbatch(drawn["batch"])
    outs = {}
    for name in ("baseline", "l2l-p"):
        state = bridge.train_state_from_numpy(drawn["params"], drawn["opt"],
                                              0)
        new, m = _engine(name, arch, n_microbatches=2).train_step(state,
                                                                  batch)
        outs[name] = (bridge.train_state_to_numpy(new)[0], float(m["loss"]))
    assert _rel_max(outs["baseline"][0], outs["l2l-p"][0]) < 1e-5
    assert abs(outs["baseline"][1] - outs["l2l-p"][1]) < 1e-5


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """The JAX engine's greedy run and prefill logits at the reference's
    init scales (the port's init, seed 0)."""
    cfg = _jcfg(request.param)
    eng = jengines.create("l2l", cfg, JExec(), donate=False)
    params = jax.tree.map(jnp.asarray, init_numpy(cfg, 0))
    prompt = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, PROMPT)).astype(np.int32)
    caches, last = eng.decode_init(params, jnp.asarray(prompt),
                                   PROMPT + STEPS)
    logits = [np.asarray(last)]
    tok = jnp.argmax(last, -1).astype(jnp.int32)[:, None]
    toks = [np.asarray(tok)]
    for i in range(STEPS):
        lg, caches = eng.decode_step(params, caches, tok,
                                     jnp.int32(PROMPT + i))
        logits.append(np.asarray(lg[:, -1]))
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
    prefill = np.asarray(eng.prefill(params, {"tokens": jnp.asarray(prompt)}))
    return dict(arch=request.param, params=_np(params), prompt=prompt,
                tokens=np.concatenate(toks, 1), logits=np.stack(logits),
                prefill=prefill)


def test_serving_matches_jax_engine(served):
    """The serve knobs (weight_stream, pack, prefetch 1, the relay-copy
    transport): greedy tokens equal, decode logits within 1e-4 relative
    L2, and Engine.prefill's last-token logits within 1e-4 of the JAX
    prefill's (the capacity path, both packages)."""
    eng = engines.create("l2l", _cfg(served["arch"]), ExecutionConfig(
        weight_stream=True, pack_params=True, prefetch_depth=1,
        transport="pallas"), device="cpu")
    params = bridge.params_from_numpy(served["params"])
    prompt = torch.from_numpy(served["prompt"])
    caches, last = eng.decode_init(params, prompt, PROMPT + STEPS)
    logits, tok = [last], last.argmax(-1)[:, None]
    toks = [tok]
    for i in range(STEPS):
        lg, caches = eng.decode_step(params, caches, tok, PROMPT + i)
        logits.append(lg[:, -1])
        tok = lg[:, -1].argmax(-1)[:, None]
        toks.append(tok)
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(),
                                  served["tokens"])
    assert _rel_l2(torch.stack(logits).numpy(), served["logits"]) <= 1e-4
    pf = eng.prefill(params, {"tokens": prompt})
    assert _rel_l2(pf.numpy(), served["prefill"]) <= 1e-4


def test_moe_clis_run_on_cpu(capsys):
    """``--arch deepseek-v2-lite-16b`` through the port's train CLI (l2l-p,
    the slice's knobs) and serve CLI (one-shot and continuous)."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    arch = ["--device", "cpu", "--arch", ARCHS[0], "--variant", "smoke"]
    losses = train_cli.main(arch + [
        "--steps", "2", "--batch", "4", "--seq", "16", "--ub", "2",
        "--weight-stream", "--pack", "--prefetch", "1", "--transport",
        "pallas", "--offload-stash"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    serve_cli.main(arch + ["--mode", "oneshot", "--batch", "2",
                           "--prompt-len", "8", "--gen", "4", "--pack"])
    serve_cli.main(arch + ["--requests", "3", "--max-batch", "2",
                           "--prompt-len", "8", "--gen", "4",
                           "--prefill-chunk", "4", "--pack"])
    out = capsys.readouterr().out
    assert '"final_step": 2' in out and "done=3" in out
