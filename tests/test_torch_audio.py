"""whisper-base (the ``audio`` family: an encoder over stubbed frames, a
decoder that cross-attends to the encoder's normed output) through the
port's engines on the CPU, at smoke size (2 + 2 layers, d 128, 4 heads,
16 frames) against the JAX package on the same numpy inputs, f32, and
the port against itself:

* the full-width config builds: the reference's two groups (encoder,
  decoder with ``has_mem``) and ParamSpec shapes leaf for leaf;
* the loss, ``Engine.grads`` and two ``train_step`` s under baseline, l2l
  and l2l-p against the JAX engine's: the memory's gradient summed over
  the decoder's layers and carried through ``transition_mem`` into the
  encoder;
* the reference's knob grids on whisper, bit for bit inside the port:
  ``tests/test_stash.py`` (K, G, k, pack), ``tests/test_relay.py`` (G, k,
  pack), ``tests/test_prefetch.py`` (k) and ``tests/test_packing.py``
  (pack); the host optimizer against the device's;
* ``decode_init`` with frames and ``decode_step`` against the JAX
  engine's, ``Engine.prefill`` with frames against the JAX prefill's, and
  ``tests/test_decode_consistency.py``'s check at the reference's init;
* the reference's ``add_modality_stubs`` case
  (``tests/test_data_checkpoint.py``), in the port;
* a zeroed cross-attention output (``xattn`` ``wo``, ``bo``) fails the
  gradient check;
* a snapshot round trip, the serve CLI (forced to one-shot, as the
  reference's; ``ServeEngine`` refuses the family) and the train CLI.

On the card (marker ``card``; ``python -m pytest -m card --noconftest
tests/test_torch_audio.py``, which needs no JAX): a decoder layer's
forward and vjp at full width against 1500 frames of memory, against the
same call on the CPU.  Gradient checks draw the parameters at the usual
fan-in scales (``repro_torch.testing``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import bridge  # noqa: E402
from repro_torch import engine as engines  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.schedule import ExecutionConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data.synthetic import add_modality_stubs  # noqa: E402
from repro_torch.models.common import is_spec  # noqa: E402
from repro_torch.models.model import LayeredModel  # noqa: E402
from repro_torch.testing import fan_in_params, init_numpy  # noqa: E402,E501

ARCH = "whisper-base"
SLICE = dict(weight_stream=True, pack_params=True, prefetch_depth=1,
             transport="pallas", offload_stash=True, n_microbatches=2)
SERVE = dict(weight_stream=True, pack_params=True, prefetch_depth=1,
             transport="pallas")
B, S = 4, 12
PROMPT, STEPS = 8, 4
BOUND = 1e-5                    # tests/test_equivalence.py's


def _cfg(**kw):
    return get_config(ARCH, "smoke").replace(dtype="float32", **kw)


def _jcfg():
    from repro.configs.base import get_config as jget_config
    return jget_config(ARCH, "smoke").replace(dtype="float32")


def _batch(cfg, seed=0):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, S), np.float32)
    mask[0, -3:] = 0.0
    return add_modality_stubs(
        {"tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "targets": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "mask": mask}, cfg, np.random.default_rng(seed))


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rel_max(la, lb):
    """max |a - b| over max |b| across two leaf lists (a part's k-bias
    gradients, zero in exact arithmetic, are rounding noise of ~1e-10)."""
    num = max(float(np.abs(x - y).max()) for x, y in zip(la, lb))
    return num / max(max(float(np.abs(y).max()) for y in lb), 1e-12)


def _engine(name, **kw):
    return engines.create(name, _cfg(), ExecutionConfig(**kw), device="cpu")


def _grads_close(got, want, bound=BOUND):
    """Each part (embed, head, each group) within ``bound`` of ``want``."""
    import jax
    parts = [("embed",), ("head",), ("groups", 0), ("groups", 1)]

    def part(tree, path):
        for k in path:
            tree = tree[k]
        return jax.tree.leaves(tree)
    return all(_rel_max(part(got, p), part(want, p)) < bound for p in parts)


def _bitwise(a, b):
    return float(a[0]) == float(b[0]) and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a[1]),
                                          tree_leaves(b[1])))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_full_width_config_builds():
    """An encoder of 6 layers, then a decoder of 6 with cross-attention
    memory, the reference's ParamSpec shapes leaf for leaf (no weight
    drawn); f32 bytes per layer 12.6 MB (encoder), 16.8 MB (decoder)."""
    import jax
    from repro.configs.base import get_config as jget_config
    from repro.models.model import LayeredModel as JModel
    from repro_torch.models.common import param_bytes
    model = LayeredModel(get_config(ARCH, "full"))
    jmodel = JModel(jget_config(ARCH, "full"))
    assert [(g.name, g.n_layers, g.is_encoder, g.has_mem)
            for g in model.groups] == \
        [(g.name, g.n_layers, g.is_encoder, g.has_mem)
         for g in jmodel.groups] == [("encoder", 6, True, False),
                                     ("decoder", 6, False, True)]
    got = tree_leaves(model.param_specs(), is_leaf=is_spec)
    want = jax.tree.leaves(jmodel.param_specs(),
                           is_leaf=lambda x: type(x).__name__ == "ParamSpec")
    assert [tuple(s.shape) for s in got] == [tuple(s.shape) for s in want]
    assert [round(param_bytes(g.spec) / 1e6, 1) for g in model.groups] == \
        [12.6, 16.8]


@pytest.fixture(scope="module")
def drawn():
    """numpy parameters at the usual fan-in scales, zero Adam slots, a
    batch with frames, and the JAX engine's two l2l-p steps from them
    (the first step's gradients read back from Adam's first moment,
    m = 0.1 g)."""
    import jax
    import jax.numpy as jnp
    from repro import engine as jengines
    from repro.core.schedule import ExecutionConfig as JExec
    from repro.engine.state import TrainState as JState
    jeng = jengines.create("l2l-p", _jcfg(), JExec(n_microbatches=2),
                           donate=False)
    # the draws need the parameters' shapes only
    shapes = jeng.model.abstract_params()
    rs = np.random.RandomState(0)
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        fan_in_params(shapes,
                      lambda s: rs.randn(*s)))
    opt = jax.tree.map(np.asarray, {
        k: v for k, v in jeng._init_opt_legacy(params).items()
        if k in ("embed", "head", "groups")})
    batch = _batch(jeng.model.cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = JState.from_legacy(jax.tree.map(jnp.asarray, params),
                               jeng._init_opt_legacy(params))
    losses = []
    for i in range(2):
        state, metrics = jeng.train_step(state, jbatch)
        losses.append(float(metrics["loss"]))
        if i == 0:
            is_slot = lambda x: isinstance(x, dict) and set(x) == {"m", "v"}
            grads = jax.tree.map(
                lambda s: np.asarray(s["m"]) / np.float32(0.1),
                jax.tree.map(np.asarray, {k: state.legacy_opt()[k] for k in
                                          ("embed", "head", "groups")}),
                is_leaf=is_slot)
    return dict(params=params, opt=opt, batch=batch, losses=losses,
                grads=grads, new_params=jax.tree.map(np.asarray,
                                                     state.params))


def test_full_loss_matches_jax(drawn):
    import jax
    import jax.numpy as jnp
    from repro.models.model import LayeredModel as JModel
    jl, _ = jax.jit(JModel(_jcfg()).full_loss)(
        jax.tree.map(jnp.asarray, drawn["params"]),
        {k: jnp.asarray(v) for k, v in drawn["batch"].items()})
    with torch.no_grad():
        tl, _ = LayeredModel(_cfg()).full_loss(
            bridge.params_from_numpy(drawn["params"]),
            _tbatch(drawn["batch"]))
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))


def test_modality_stubs_match_the_reference():
    """The reference's tests/test_data_checkpoint.py case for whisper:
    the port's stub frames are the reference's, array for array."""
    from repro.configs.base import get_config as jget_config
    from repro.data.synthetic import add_modality_stubs as jstubs
    cfg = get_config(ARCH, "smoke")
    b = add_modality_stubs({"tokens": np.zeros((2, 8), np.int32)}, cfg)
    assert b["frames"].shape == (2, cfg.n_frames, cfg.d_model)
    want = jstubs({"tokens": np.zeros((2, 8), np.int32)},
                  jget_config(ARCH, "smoke"))
    np.testing.assert_array_equal(b["frames"], want["frames"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
GRAD_ENGINES = {"baseline": ("baseline", dict(n_microbatches=2)),
                "l2l": ("l2l", SLICE), "l2l-p": ("l2l-p", SLICE)}


@pytest.mark.parametrize("which", sorted(GRAD_ENGINES))
def test_grads_match_jax(drawn, which):
    """Engine.grads against the JAX engine's l2l-p gradients: the loss to
    1e-5 and each part (embed, head, encoder, decoder) to 1e-5."""
    name, kw = GRAD_ENGINES[which]
    loss, grads = _engine(name, **kw).grads(
        bridge.params_from_numpy(drawn["params"]), _tbatch(drawn["batch"]))
    assert abs(float(loss) - drawn["losses"][0]) <= BOUND * drawn["losses"][0]
    assert _grads_close(bridge.params_to_numpy(grads), drawn["grads"])


def test_zeroed_cross_attention_output_fails_the_check(drawn):
    """The decoder's cross-attention output projection (wo, bo) zeroed in
    the port only: the gradients leave the JAX engine's by more than
    1e-2, so the check sees the memory path."""
    params = bridge.params_from_numpy(drawn["params"])
    xa = params["groups"][1]["xattn"]
    xa["wo"], xa["bo"] = torch.zeros_like(xa["wo"]), torch.zeros_like(xa["bo"])
    _, grads = _engine("l2l-p", **SLICE).grads(params,
                                               _tbatch(drawn["batch"]))
    assert not _grads_close(bridge.params_to_numpy(grads), drawn["grads"],
                            1e-2)


@pytest.mark.parametrize("which", sorted(GRAD_ENGINES))
def test_two_train_steps_match_jax(drawn, which):
    """Two steps (Adam, lr 1e-3): each loss within 1e-5 of the JAX l2l-p
    engine's, and the params after them within 1e-5 where the first
    step's |g| > 1e-4 (Adam moves an element by ~lr sign(g))."""
    import jax
    name, kw = GRAD_ENGINES[which]
    eng = _engine(name, **kw)
    state = bridge.train_state_from_numpy(drawn["params"], drawn["opt"], 0,
                                          pack=kw.get("pack_params", False))
    batch = _tbatch(drawn["batch"])
    losses = []
    for _ in range(2):
        state, metrics = eng.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    for got, want in zip(losses, drawn["losses"]):
        assert abs(got - want) <= BOUND * want, (losses, drawn["losses"])
    params, _, step, _ = bridge.train_state_to_numpy(state)
    assert step == 2
    for part in ("embed", "head", "groups"):
        for w, g, gr in zip(jax.tree.leaves(drawn["new_params"][part]),
                            jax.tree.leaves(params[part]),
                            jax.tree.leaves(drawn["grads"][part])):
            keep = np.abs(gr) > 1e-4
            np.testing.assert_allclose(g[keep], w[keep], rtol=1e-5,
                                       atol=1e-6)


@pytest.fixture(scope="module")
def knob_ref(drawn):
    """The grids' common point: K 1, G 1, k 0, unpacked (l2l-p, UB 2)."""
    return _engine("l2l-p", n_microbatches=2).grads(
        bridge.params_from_numpy(drawn["params"]), _tbatch(drawn["batch"]))


# tests/test_stash.py's whisper grid (K, G, k, pack): the encoder and the
# decoder's depths divide by none of K = 3, 4
@pytest.mark.parametrize("se,g,k,pack", [(2, 2, 1, True), (3, 1, 2, False),
                                         (4, 3, 0, False)])
def test_stash_grid_is_bitwise(drawn, knob_ref, se, g, k, pack):
    got = _engine("l2l-p", n_microbatches=2, stash_every=se,
                  layers_per_relay=g, prefetch_depth=k, pack_params=pack,
                  transport="pallas" if pack else "xla").grads(
        bridge.params_from_numpy(drawn["params"]), _tbatch(drawn["batch"]))
    assert _bitwise(got, knob_ref)


# tests/test_relay.py's (G, k, pack), tests/test_prefetch.py's k = 1 and
# tests/test_packing.py's pack with k = 1
@pytest.mark.parametrize("g,k,pack", [(2, 2, True), (3, 1, False),
                                      (1, 1, False), (1, 1, True)])
def test_relay_prefetch_pack_points_are_bitwise(drawn, knob_ref, g, k,
                                                pack):
    got = _engine("l2l-p", n_microbatches=2, layers_per_relay=g,
                  prefetch_depth=k, pack_params=pack).grads(
        bridge.params_from_numpy(drawn["params"]), _tbatch(drawn["batch"]))
    assert _bitwise(got, knob_ref)


def test_host_optimizer_equals_the_device_optimizer(drawn):
    """The host optimizer's step against K1's (its plain version here),
    two groups with memory: the loss, params and Adam slots bit for
    bit."""
    outs = []
    for kw in ({}, dict(host_optimizer=True)):
        eng = _engine("l2l-p", **{**SLICE, **kw})
        state = bridge.train_state_from_numpy(drawn["params"], drawn["opt"],
                                              0, pack=True)
        new, m = eng.train_step(state, _tbatch(drawn["batch"]))
        p, o, _, _ = bridge.train_state_to_numpy(new)
        outs.append((float(m["loss"]), tree_leaves(p), tree_leaves(o)))
    assert outs[0][0] == outs[1][0]
    assert all(np.array_equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    assert all(np.array_equal(a, b) for a, b in zip(outs[0][2], outs[1][2]))


def test_snapshot_round_trip(drawn, tmp_path):
    """A step, a save, a restore into a fresh engine (unpacked, another
    layout), a second step: the same bits as two unbroken steps."""
    import jax
    batch = _tbatch(drawn["batch"])
    eng = _engine("l2l-p", **SLICE)
    s1, _ = eng.train_step(bridge.train_state_from_numpy(
        drawn["params"], drawn["opt"], 0, pack=True), batch)
    s2, _ = eng.train_step(s1, batch)
    eng.save(str(tmp_path), s1)
    other = _engine("l2l-p", n_microbatches=2)
    back, step = other.restore(str(tmp_path))
    assert step == 1
    s2b, _ = other.train_step(back, batch)
    a, b = bridge.train_state_to_numpy(s2), bridge.train_state_to_numpy(s2b)
    assert all(np.array_equal(x, y) for x, y in
               zip(jax.tree.leaves(a[:2]), jax.tree.leaves(b[:2])))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _jax_decode(params, prompt, frames):
    """The JAX package's ``decode.prefill`` with frames (what the JAX
    engine's decode_init runs), then STEPS greedy steps of its engine:
    (logits (STEPS + 1, B, V), tokens, the engine)."""
    import jax
    import jax.numpy as jnp
    from repro import engine as jengines
    from repro.core import decode as jdec
    from repro.core.schedule import ExecutionConfig as JExec
    jeng = jengines.create("l2l", _jcfg(), JExec(), donate=False)
    jp = jax.tree.map(jnp.asarray, params)
    caches, last = jax.jit(lambda p, t, f: jdec.prefill(
        jeng.model, p, t, PROMPT + STEPS, frames=f))(
        jp, jnp.asarray(prompt), jnp.asarray(frames))
    logits, toks = [np.asarray(last)], []
    for i in range(STEPS):
        tok = jnp.argmax(logits[-1], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        lg, caches = jeng.decode_step(jp, caches, tok, jnp.int32(PROMPT + i))
        logits.append(np.asarray(lg[:, -1]))
    return np.stack(logits), np.concatenate(toks, 1), jeng


def test_decode_with_frames_matches_jax(drawn):
    """decode_init with frames (the encoder's pass and the cross K/V
    through the relay), then greedy decode_step, under the serve knobs:
    the tokens equal the JAX engine's, the logits within 1e-5 relative
    L2; Engine.prefill with frames within 1e-5 of the JAX prefill."""
    import jax
    import jax.numpy as jnp
    frames = drawn["batch"]["frames"][:2]
    prompt = drawn["batch"]["tokens"][:2, :PROMPT]
    want, want_toks, jeng = _jax_decode(drawn["params"], prompt, frames)
    eng = engines.create("l2l", _cfg(), ExecutionConfig(**SERVE),
                         device="cpu")
    tp = bridge.params_from_numpy(drawn["params"])
    caches, last = eng.decode_init(tp, torch.from_numpy(prompt),
                                   PROMPT + STEPS,
                                   frames=torch.from_numpy(frames))
    held = tree_leaves(caches)
    logits, toks = [last], []
    for i in range(STEPS):
        tok = logits[-1].argmax(-1)[:, None]
        toks.append(tok)
        lg, caches = eng.decode_step(tp, caches, tok, PROMPT + i)
        logits.append(lg[:, -1])
    assert all(a is b for a, b in zip(tree_leaves(caches), held))
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(), want_toks)
    assert _rel_l2(torch.stack(logits).numpy(), want) <= BOUND
    batch = {"tokens": prompt, "frames": frames}
    pf = eng.prefill(tp, _tbatch(batch))
    jpf = jeng.prefill(jax.tree.map(jnp.asarray, drawn["params"]),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    assert _rel_l2(pf.numpy(), np.asarray(jpf)) <= BOUND


def test_decode_matches_the_full_forward_at_the_reference_init():
    """tests/test_decode_consistency.py for whisper, in the port: at the
    reference's init scales (the port's init, seed 0), 12 tokens fed one by one after the
    encoder's pass give the full forward's last logits (the reference's
    bound, 2e-3 relative max), and the JAX decode.prefill's (1e-3)."""
    import jax
    import jax.numpy as jnp
    from repro.core import decode as jdec
    from repro.models.model import LayeredModel as JModel
    jmodel = JModel(_jcfg())
    params = jax.tree.map(jnp.asarray, init_numpy(_jcfg(), 0))
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                                         _jcfg().vocab_size))
    frames = np.array(jax.random.normal(
        jax.random.PRNGKey(2), (2, _jcfg().n_frames, _jcfg().d_model),
        jnp.float32))
    _, want = jax.jit(lambda p, t, f: jdec.prefill(
        jmodel, p, t, live_seq=12, frames=f))(params, jnp.asarray(toks),
                                               jnp.asarray(frames))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, params))
    model = LayeredModel(_cfg())
    batch = {"tokens": torch.from_numpy(toks), "frames":
             torch.from_numpy(frames)}
    with torch.no_grad():
        static = {"embed": tp["embed"], "head": tp["head"]}
        x, mem = model.prepare(static, batch)
        for gi, group in enumerate(model.groups):
            if gi:
                x, mem = model.transition(gi, static, x, batch)
            ctx = model.train_ctx(batch, group)
            for li in range(group.n_layers):
                x, _ = group.apply(tree_map(lambda a, _l=li: a[_l],
                                            tp["groups"][gi]), x, mem, ctx)
        full = model.decode_logits(static, x[:, -1:])[:, 0].numpy()
    eng = engines.create("l2l", _cfg(), ExecutionConfig(), device="cpu")
    _, last = eng.decode_init(tp, batch["tokens"], 12,
                              frames=batch["frames"])
    last = last.numpy()
    assert np.abs(last - full).max() / np.abs(full).max() < 2e-3
    assert np.abs(last - np.asarray(want)).max() / \
        np.abs(np.asarray(want)).max() < 1e-3


def test_serve_cli_runs_oneshot_and_serve_engine_refuses(capsys):
    """The serve CLI with --arch whisper-base runs one-shot (continuous
    batching asked for or not, as the reference's); ServeEngine refuses
    the family."""
    from repro_torch.launch.serve import main
    from repro_torch.serve import ServeConfig
    toks = main(["--device", "cpu", "--arch", ARCH, "--variant", "smoke",
                 "--batch", "2", "--prompt-len", "8", "--gen", "4",
                 "--weight-stream", "--pack", "--prefetch", "1",
                 "--transport", "pallas"])
    assert toks.shape == (2, 4)
    assert "prefill:" in capsys.readouterr().out
    eng = _engine("l2l")
    with pytest.raises(NotImplementedError):
        eng.serve_session(eng.init_params(torch.Generator().manual_seed(0)),
                          ServeConfig(max_batch=2, max_seq=16))


def test_train_cli_runs_on_cpu(capsys):
    """``--arch whisper-base`` through the train CLI (l2l-p, the slice's
    knobs and K = 2: the frames come from add_modality_stubs)."""
    from repro_torch.launch import train as train_cli
    losses = train_cli.main([
        "--device", "cpu", "--arch", ARCH, "--variant", "smoke", "--steps",
        "2", "--batch", "4", "--seq", "16", "--ub", "2", "--weight-stream",
        "--pack", "--prefetch", "1", "--transport", "pallas",
        "--offload-stash", "--stash-every", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert '"final_step": 2' in capsys.readouterr().out


# ---- on the card --------------------------------------------------------
@pytest.mark.card
def test_decoder_layer_on_card_matches_cpu():
    """A decoder layer at full width (d 512, 8 heads), f32, B=2 x 64
    target tokens against 1500 frames of memory, at fan-in scales: the
    forward and the vjp with respect to (w, x, mem) on the card against
    the CPU's, 1e-4 relative L2 per leaf; the k biases' gradients, zero in
    exact arithmetic, within 1e-4 of their attention's largest on both.
    TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH, "full").replace(dtype="float32")
    group = LayeredModel(cfg).groups[1]
    gen = torch.Generator().manual_seed(0)
    rand = lambda s: torch.randn(s, generator=gen)
    w = fan_in_params(group.spec, rand)
    x, gy = rand((2, 64, cfg.d_model)), rand((2, 64, cfg.d_model))
    mem = rand((2, cfg.n_frames, cfg.d_model))

    def run(dev):
        from repro_torch.models.blocks import Ctx
        ww = tree_map(lambda a: a.to(dev).requires_grad_(), w)
        leaves = tree_leaves(ww)
        xx, mm = (t.to(dev).requires_grad_() for t in (x, mem))
        ar = lambda n: torch.arange(n, dtype=torch.int32,
                                    device=dev).expand(2, n)
        ctx = Ctx(positions=ar(64), mem_positions=ar(cfg.n_frames))
        y, _ = group.apply(ww, xx, mm, ctx)
        g = torch.autograd.grad(y, leaves + [xx, mm], gy.to(dev))
        return [t.detach().cpu().numpy() for t in (y,) + g]

    names = _leaf_names(w) + ["x", "mem"]
    (y, *got), (y_cpu, *want) = run("cuda"), run("cpu")
    assert _rel_l2(y, y_cpu) <= 1e-4
    top = {n.split(".")[0]: 0.0 for n in names}
    for n, g in zip(names, want):
        top[n.split(".")[0]] = max(top[n.split(".")[0]], np.abs(g).max())
    for n, a, b in zip(names, got, want):
        if n.endswith(".bk"):
            # attention is invariant to a k bias (no rope): its gradient
            # is rounding noise on both devices
            assert max(np.abs(a).max(), np.abs(b).max()) <= \
                1e-4 * top[n.split(".")[0]], n
        else:
            assert _rel_l2(a, b) <= 1e-4, n


def _leaf_names(tree, prefix=""):
    """Dotted names of a nested dict's leaves, in flatten order."""
    if not isinstance(tree, dict):
        return [prefix]
    return [n for k in sorted(tree)
            for n in _leaf_names(tree[k], f"{prefix}.{k}" if prefix else k)]
