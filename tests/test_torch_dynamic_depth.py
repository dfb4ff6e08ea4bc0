"""Dynamic depth in the port (``ExecutionConfig.dynamic_depth``): the run
depth n is an argument of every entry point, the layers past it are
neither fetched nor run, and their rows stay as they were.

Held to the JAX engine's dynamic-depth calls (gradients at capacity 4
with n = 3; prefill, decode_init and decode_step of granite smoke), to
the port's own static depth-n engine bit for bit across the relay knobs,
and to the reference's asserts; then the serve tick under dynamic depth,
the baseline's normalization and the train CLI's flags.

On the card (marker ``card``; ``python -m pytest -m card --noconftest
tests/test_torch_dynamic_depth.py``, which needs no JAX): granite-3-8b
at full width, capacity 4, trained at n = 2 through the pinned-host
relay: rows 2-3 are never fetched by K4 and come out unchanged.  JAX is
imported inside the tests only."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import bridge  # noqa: E402
from repro_torch import engine as engines  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.schedule import ExecutionConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import relay_copy  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.testing import fan_in_params, init_numpy  # noqa: E402,E501

CAP, N_RUN = 4, 3
B, S = 4, 16


def _batch(vocab, seed=0):
    rs = np.random.RandomState(seed)
    return {"tokens": rs.randint(0, vocab, (B, S)).astype(np.int32),
            "targets": rs.randint(0, vocab, (B, S)).astype(np.int32),
            "mask": np.ones((B, S), np.float32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _cfg(arch="bert-large", n=CAP):
    return get_config(arch, "smoke").replace(dtype="float32", n_layers=n,
                                             use_pallas=True)


def _engine(name, n=CAP, arch="bert-large", **kw):
    return engines.create(name, _cfg(arch, n), ExecutionConfig(**kw),
                          device="cpu")


def _first(tree, n):
    """The first n layers of the stacked groups (unpacked params)."""
    return {**tree, "groups": tuple(tree_map(lambda a: a[:n], g)
                                    for g in tree["groups"])}


def _fan_in(like, seed=0):
    rs = np.random.RandomState(seed)
    drawn = fan_in_params(like, lambda shape: rs.randn(*shape))
    return tree_map(lambda a: np.asarray(a, np.float32), drawn)


@pytest.fixture(scope="module")
def params_np():
    """bert-large smoke at capacity 4, at the usual scales (numpy)."""
    like = bridge.params_to_numpy(_engine("l2l-p").model.init_params(
        torch.Generator().manual_seed(0)))
    return _fan_in(like)


def test_grads_match_jax_dynamic_grads(params_np):
    """The port's grads at capacity 4 with n = 3 against the JAX engine's
    dynamic-depth grads: 1e-5 per part (tests/test_equivalence.py's
    bound), the tail rows exactly 0 on both sides."""
    import jax
    import jax.numpy as jnp
    from repro import engine as jengines
    from repro.configs.base import get_config as jget_config
    from repro.core.schedule import ExecutionConfig as JExec
    knobs = dict(n_microbatches=2, stash_every=2, layers_per_relay=2,
                 prefetch_depth=1, dynamic_depth=True)
    jcfg = jget_config("bert-large", "smoke").replace(dtype="float32",
                                                      n_layers=CAP)
    jeng = jengines.create("l2l-p", jcfg, JExec(**knobs), donate=False)
    batch = _batch(jcfg.vocab_size)
    jloss, jgrads = jeng.grads(jax.tree.map(jnp.asarray, params_np),
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               N_RUN)
    jgrads = jax.tree.map(np.asarray, jgrads)
    loss, grads = _engine("l2l-p", **knobs).grads(
        bridge.params_from_numpy(params_np), _tbatch(batch), n_layers=N_RUN)
    got = bridge.params_to_numpy(grads)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * float(jloss)
    for part in ("embed", "head", "groups"):
        la, lb = jax.tree.leaves(got[part]), jax.tree.leaves(jgrads[part])
        err = max(float(np.abs(a - b).max()) for a, b in zip(la, lb))
        assert err <= 1e-5 * max(float(np.abs(b).max()) for b in lb), part
    for a, b in zip(jax.tree.leaves(got["groups"]),
                    jax.tree.leaves(jgrads["groups"])):
        assert not a[N_RUN:].any() and not b[N_RUN:].any()


# (K, G, prefetch, pack, transport, n): K = 2 does not divide n = 3, G = 2
# and G = 3 leave a stop that straddles the window, n = 1 leaves whole
# stops idle
_KNOBS = [(1, 1, 1, False, "pallas", 3), (2, 2, 1, True, "pallas", 3),
          (1, 2, 2, False, "pallas", 3), (2, 1, 1, True, "xla", 3),
          (4, 3, 1, True, "pallas", 3), (2, 2, 0, False, "xla", 1)]


def _knobs(K, G, k, pk, t):
    return dict(n_microbatches=2, stash_every=K, layers_per_relay=G,
                prefetch_depth=k, pack_params=pk, transport=t)


@pytest.mark.parametrize("K,G,k,pk,t,n", _KNOBS)
def test_dynamic_grads_equal_static_depth_n(params_np, monkeypatch, K, G, k,
                                            pk, t, n):
    """Bitwise on the active rows and the loss, exactly 0 on the tail."""
    batch = _tbatch(_batch(_cfg().vocab_size))
    params = bridge.params_from_numpy(params_np)
    fetches = []
    fetch = relay_copy.fetch_slot
    monkeypatch.setattr(relay_copy, "fetch_slot", lambda *a, **kw: (
        fetches.append(a[1:3]), fetch(*a, **kw))[1])
    dyn = _engine("l2l-p", **_knobs(K, G, k, pk, t), dynamic_depth=True)
    loss_d, g_d = dyn.grads(params, batch, n_layers=n)
    n_dyn = len(fetches)
    stat = _engine("l2l-p", n=n, **_knobs(min(K, n), G, k, pk, t))
    loss_s, g_s = stat.grads(_first(params, n), batch)
    if t == "pallas" and G == 1 and K == 1:
        # the idle rows are not fetched: as many fetches as the static
        # engine makes (the relay at capacity would make more), none
        # past row n
        assert n_dyn == len(fetches) - n_dyn > 0
        assert max(a + b for a, b in fetches[:n_dyn]) <= n
    assert float(loss_d) == float(loss_s)
    for part in ("embed", "head"):
        for a, b in zip(tree_leaves(g_d[part]), tree_leaves(g_s[part])):
            assert torch.equal(a, b), part
    for a, b in zip(tree_leaves(g_d["groups"]), tree_leaves(g_s["groups"])):
        assert torch.equal(a[:n], b)
        assert not a[n:].any()


@pytest.fixture(scope="module")
def train_state():
    eng = _engine("l2l-p", n_microbatches=2)
    return eng.init(torch.Generator().manual_seed(3))


@pytest.mark.parametrize("name,kw", [
    ("l2l-p", dict(pack_params=True, prefetch_depth=1, layers_per_relay=2)),
    ("l2l", dict(stash_every=2, transport="pallas")),
    ("l2l-p", dict(host_optimizer=True, pack_params=True, prefetch_depth=1)),
    ("l2l", dict(host_optimizer=True, layers_per_relay=3))])
def test_train_step_leaves_idle_rows_and_matches_static(train_state, name,
                                                         kw):
    batch = _tbatch(_batch(_cfg().vocab_size, seed=1))
    kw = dict(n_microbatches=2, **kw)
    dyn = _engine(name, dynamic_depth=True, **kw)
    new, m = dyn.train_step(train_state, batch, n_layers=N_RUN)
    p0, o0, _, _ = bridge.train_state_to_numpy(train_state)
    p1, o1, step, _ = bridge.train_state_to_numpy(new)
    assert step == 1
    for a, b in zip(tree_leaves((p1["groups"], o1["groups"])),
                    tree_leaves((p0["groups"], o0["groups"]))):
        assert a[N_RUN:].tobytes() == b[N_RUN:].tobytes()
    # the active rows, the static parts and the loss: the static engine's
    stat = _engine(name, n=N_RUN, **kw)
    st_n = train_state.replace(
        params=_first(train_state.params, N_RUN),
        opt_state={**train_state.opt_state, "groups": tuple(
            tree_map(lambda a: a[:N_RUN], g)
            for g in train_state.opt_state["groups"])})
    want, ms = stat.train_step(st_n, batch)
    pw, ow, _, _ = bridge.train_state_to_numpy(want)
    assert float(m["loss"]) == float(ms["loss"])
    for a, b in zip(tree_leaves((p1["groups"], o1["groups"])),
                    tree_leaves((pw["groups"], ow["groups"]))):
        assert np.array_equal(a[:N_RUN], b)
    for part in ("embed", "head"):
        for a, b in zip(tree_leaves((p1[part], o1[part])),
                        tree_leaves((pw[part], ow[part]))):
            assert np.array_equal(a, b)


SERVE = dict(weight_stream=True, pack_params=True, prefetch_depth=1,
             transport="pallas", n_microbatches=2, dynamic_depth=True)
SCAP, SRUN, PROMPT, STEPS = 3, 2, 6, 3


@pytest.fixture(scope="module")
def serve_reference():
    """The JAX engine's dynamic-depth prefill and greedy run of granite
    smoke at capacity 3, run depth 2."""
    import jax
    import jax.numpy as jnp
    from repro import engine as jengines
    from repro.configs.base import get_config as jget_config
    from repro.core.schedule import ExecutionConfig as JExec
    from repro.models import common as jcommon
    cfg = jget_config("granite-3-8b", "smoke").replace(
        dtype="float32", use_pallas=True, n_layers=SCAP)
    eng = jengines.create("l2l", cfg, JExec(**SERVE), donate=False)
    params = jax.tree.map(jnp.asarray, init_numpy(cfg, 0))
    prompt = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, PROMPT)).astype(np.int32)
    prev = jcommon.use_pallas_rmsnorm(True)
    try:
        caches, last = eng.decode_init(params, jnp.asarray(prompt),
                                       PROMPT + STEPS, n_layers=SRUN)
        logits, toks = [np.asarray(last)], []
        tok = jnp.argmax(last, -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        for i in range(STEPS):
            lg, caches = eng.decode_step(params, caches, tok,
                                         jnp.int32(PROMPT + i), SRUN)
            logits.append(np.asarray(lg[:, -1]))
            tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
            toks.append(np.asarray(tok))
        prefill = np.asarray(eng.prefill(
            params, {"tokens": jnp.asarray(prompt)}, SRUN))
    finally:
        jcommon.use_pallas_rmsnorm(prev)
    return dict(params=jax.tree.map(np.asarray, params), prompt=prompt,
                tokens=np.concatenate(toks, 1), logits=np.stack(logits),
                prefill=prefill)


def _greedy(eng, params, prompt, n_layers=None):
    caches, last = eng.decode_init(params, prompt, PROMPT + STEPS,
                                   n_layers=n_layers)
    logits, tok = [last], last.argmax(-1)[:, None]
    toks = [tok]
    for i in range(STEPS):
        lg, caches = eng.decode_step(params, caches, tok, PROMPT + i,
                                     n_layers=n_layers)
        logits.append(lg[:, -1])
        tok = lg[:, -1].argmax(-1)[:, None]
        toks.append(tok)
    return torch.cat(toks, 1), torch.stack(logits), caches


def test_prefill_and_decode_match_jax(serve_reference):
    ref = serve_reference
    eng = _engine("l2l", n=SCAP, arch="granite-3-8b", **SERVE)
    params = bridge.params_from_numpy(ref["params"])
    prompt = torch.from_numpy(ref["prompt"])
    toks, logits, caches = _greedy(eng, params, prompt, n_layers=SRUN)
    np.testing.assert_array_equal(toks.numpy(), ref["tokens"])
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=1e-4,
                               rtol=1e-4)
    got = eng.prefill(params, {"tokens": prompt}, n_layers=SRUN)
    np.testing.assert_allclose(got.numpy(), ref["prefill"], atol=1e-4,
                               rtol=1e-4)
    # the idle layer's cache rows were never written
    for c in caches:
        assert (c["pos"][SRUN:] == -1).all()
        assert not c["k"][SRUN:].any() and not c["v"][SRUN:].any()
    # and a static 2-layer engine on the same first rows: bit for bit
    stat = _engine("l2l", n=SRUN, arch="granite-3-8b",
                   **{**SERVE, "dynamic_depth": False})
    toks_s, logits_s, _ = _greedy(stat, _first(params, SRUN), prompt)
    assert torch.equal(toks, toks_s) and torch.equal(logits, logits_s)
    assert torch.equal(got, stat.prefill(_first(params, SRUN),
                                         {"tokens": prompt}))


def test_serve_session_under_dynamic_depth(serve_reference):
    """The continuous-batching tick takes no depth: under dynamic_depth it
    relays every layer, as the reference's does, and gives the tokens of
    the engine without it."""
    params = bridge.params_from_numpy(serve_reference["params"])
    prompts = serve_reference["prompt"]
    out = []
    for dyn in (False, True):
        eng = _engine("l2l", n=SCAP, arch="granite-3-8b",
                      **{**SERVE, "dynamic_depth": dyn})
        srv = eng.serve_session(params, max_batch=2, page_size=4,
                                n_pages=16, max_seq=16, prefill_chunk=4)
        for p in prompts:
            srv.submit(p.tolist(), max_new=3)
        out.append([list(r.generated) for r in srv.run()])
    assert out[0] == out[1] and all(len(g) == 3 for g in out[0])


def test_the_asserts(params_np):
    params = bridge.params_from_numpy(params_np)
    batch = _tbatch(_batch(_cfg().vocab_size))
    dyn = _engine("l2l-p", n_microbatches=2, dynamic_depth=True)
    with pytest.raises(AssertionError, match="exceeds capacity"):
        dyn.grads(params, batch, n_layers=CAP + 1)
    with pytest.raises(AssertionError, match="needs ExecutionConfig"):
        _engine("l2l-p", n_microbatches=2).grads(params, batch, n_layers=2)
    with pytest.raises(AssertionError, match="divide the capacity"):
        _engine("l2l-p", n_microbatches=2, stash_every=3,
                dynamic_depth=True).grads(params, batch, n_layers=2)


def test_baseline_turns_dynamic_depth_off(params_np):
    """As the reference's BaselineEngine: no relay, so no run depth; the
    whole model trains and an explicit n_layers asserts."""
    eng = _engine("baseline", n_microbatches=2, dynamic_depth=True)
    assert not eng.exec_cfg.dynamic_depth
    batch = _tbatch(_batch(_cfg().vocab_size))
    params = bridge.params_from_numpy(params_np)
    loss, _ = eng.grads(params, batch)
    want, _ = _engine("baseline", n_microbatches=2).grads(params, batch)
    assert float(loss) == float(want)
    with pytest.raises(AssertionError, match="needs ExecutionConfig"):
        eng.grads(params, batch, n_layers=2)


def test_train_cli_dynamic_depth(capsys):
    argv = ["--device", "cpu", "--variant", "smoke", "--steps", "2",
            "--batch", "4", "--seq", "16", "--ub", "2", "--log-every", "1"]
    losses = train_cli.main(argv + ["--dynamic-depth", "--run-layers", "1",
                                    "--pack", "--prefetch", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert '"run_layers": 1' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train_cli.main(argv + ["--run-layers", "1"])


# ---- on the card ------------------------------------------------------
@pytest.mark.card
def test_idle_rows_not_fetched_on_card(monkeypatch):
    """granite-3-8b at full width, capacity 4, f32 rows and Adam slots
    pinned in host memory, one step at n = 2: no K4 fetch reads rows 2-3
    of the weights or the slots, and those rows come out bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = get_config("granite-3-8b", "full").replace(n_layers=4,
                                                     use_pallas=True)
    eng = engines.create("l2l-p", cfg, ExecutionConfig(
        weight_stream=True, pack_params=True, prefetch_depth=1,
        transport="pallas", offload_stash=True, dynamic_depth=True))
    state = eng.init(torch.Generator("cuda").manual_seed(0))
    rows = {t.data_ptr(): name for name, t in (
        [("w", state.params["groups"][0].segs["float32"])]
        + [(k, p.segs["float32"])
           for k, p in state.opt_state["groups"][0].items()])}
    reads = []
    fetch = relay_copy.fetch_slot

    def spy(stacked, start, size, **kw):
        for a in tree_leaves(stacked):
            if a.data_ptr() in rows:
                reads.append((rows[a.data_ptr()], start, size))
        return fetch(stacked, start, size, **kw)
    monkeypatch.setattr(relay_copy, "fetch_slot", spy)
    k4 = relay_copy.copy_rows.launches
    rs = np.random.RandomState(0)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (2, 64)),
             "targets": rs.randint(0, cfg.vocab_size, (2, 64)),
             "mask": np.ones((2, 64), np.float32)}
    new, m = eng.train_step(state, batch, n_layers=2)
    assert np.isfinite(float(m["loss"]))
    assert relay_copy.copy_rows.launches > k4
    assert {r[0] for r in reads} == {"w", "m", "v"}
    assert max(start + size for _, start, size in reads) <= 2
    torch.cuda.synchronize()
    for a, b in zip(tree_leaves((new.params["groups"],
                                 new.opt_state["groups"])),
                    tree_leaves((state.params["groups"],
                                 state.opt_state["groups"]))):
        assert torch.equal(a[2:], b[2:])
        assert not torch.equal(a[:2], b[:2])
