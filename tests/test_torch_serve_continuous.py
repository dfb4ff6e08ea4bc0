"""Continuous-batching serve in the port (``repro_torch.serve``) on the CPU:
the port's ServeEngine against the JAX package's ServeEngine (greedy
tokens equal, request by request) in the reference's four dense parity
cases, its ``mla-moe`` case (deepseek-v2-lite: MLA's compressed paged
cache, MoE, two decode groups in each tick) and its ``hybrid`` and ``ssm``
cases (hymba-1.5b: paged KV beside per-slot Mamba state; rwkv6-1.6b: per-
slot state only, no paged leaf) under the port's slice knobs; crowded
equals solo, bit for bit, for granite and for both recurrent families,
inside the port; slot and page recycling; the ServeEngine's validation;
grouped decode attention on and off; and the CLI's ``--mode continuous``.

On the card (marker ``card``; ``python -m pytest -m card --noconftest
tests/test_torch_serve_continuous.py``, which needs no JAX): crowded
equals solo for a 2-layer granite-3-8b ServeEngine at full width, through
the pinned-host relay.  JAX is imported inside the tests only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import bridge  # noqa: E402
from repro_torch.testing import init_numpy  # noqa: E402
from repro_torch import engine as engines  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.schedule import ExecutionConfig  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serve import ServeConfig  # noqa: E402

# the port's serving slice knobs, added to every case on the port's side
PORT_KNOBS = dict(weight_stream=True, pack_params=True, transport="pallas")

# the reference's PARITY_CASES (tests/test_serve.py) the port runs: arch,
# exec knobs, max_seq, prefill_chunk
CASES = [
    ("granite-3-8b", {}, 32, 1),
    ("granite-3-8b", dict(weight_stream=True, layers_per_relay=2,
                          prefetch_depth=1, pack_params=True), 32, 1),
    ("granite-3-8b", dict(decode_window=16), 16, 1),  # max_seq IS the window
    ("granite-3-8b", {}, 32, 4),                      # chunked prefill
    ("deepseek-v2-lite-16b", {}, 32, 1),              # MLA + MoE
    ("hymba-1.5b", {}, 32, 1),                        # recurrent families
    ("rwkv6-1.6b", {}, 32, 1),
]
CASE_IDS = ["dense", "dense-G2pf1pack", "window", "chunked-prefill",
            "mla-moe", "hybrid", "ssm"]

# 4 requests for 3 slots: the last one joins when the first leaves; in the
# window case the 11-token prompt decodes past the 16-position ring
LENS, NEWS = (8, 5, 11, 7), (5, 3, 8, 4)


def _prompts(vocab, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, size=(n,)).astype(np.int32) for n in LENS]


def _scfg(max_seq, chunk, **kw):
    return dict(max_batch=3, page_size=8, n_pages=12, max_seq=max_seq,
                prefill_chunk=chunk, **kw)


def _port(cfg, **exec_kw):
    return engines.create("l2l", cfg, ExecutionConfig(**exec_kw),
                          device="cpu")


def _serve(eng, params, scfg, prompts, news):
    srv = eng.serve_session(params, ServeConfig(**scfg))
    reqs = [srv.submit(p, n) for p, n in zip(prompts, news)]
    srv.run()
    return srv, [r.generated for r in reqs]


@pytest.mark.parametrize("arch,exec_kw,max_seq,chunk", CASES, ids=CASE_IDS)
def test_greedy_tokens_match_jax_serve_engine(arch, exec_kw, max_seq, chunk):
    import jax
    import jax.numpy as jnp
    from repro import engine as jengines
    from repro.configs.base import get_config as jget_config
    from repro.core.schedule import ExecutionConfig as JExec
    from repro.serve.engine import ServeConfig as JServeConfig

    jcfg = jget_config(arch, "smoke").replace(dtype="float32")
    jeng = jengines.create("l2l", jcfg, JExec(**exec_kw), donate=False)
    params = jax.tree.map(jnp.asarray, init_numpy(jcfg, 0))
    prompts = _prompts(jcfg.vocab_size)
    scfg = _scfg(max_seq, chunk)
    jsrv = jeng.serve_session(params, JServeConfig(**scfg))
    jreqs = [jsrv.submit(p, n) for p, n in zip(prompts, NEWS)]
    jsrv.run()

    cfg = get_config(arch, "smoke").replace(dtype="float32")
    srv, got = _serve(_port(cfg, **{**PORT_KNOBS, **exec_kw}),
                      bridge.params_from_numpy(
                          jax.tree.map(np.asarray, params)),
                      scfg, prompts, NEWS)
    assert got == [r.generated for r in jreqs]
    assert srv.n_ticks == jsrv.n_ticks
    assert srv.stats()["free_pages"] == 12 and srv.stats()["free_slots"] == 3


@pytest.fixture(scope="module")
def granite():
    cfg = get_config("granite-3-8b", "smoke")
    params = _port(cfg).model.init_params(torch.Generator().manual_seed(0))
    return cfg, params


def _crowded_vs_solo(eng, params, vocab, scfg):
    """A request's tokens alone, and with strangers joining and leaving
    the other slots while it decodes (``tests/test_serve.py:234``)."""
    rng = np.random.RandomState(1)
    pa = rng.randint(0, vocab, size=(8,)).astype(np.int32)
    srv = eng.serve_session(params, ServeConfig(**scfg))
    solo = srv.submit(pa, 10)
    srv.run()
    srv = eng.serve_session(params, ServeConfig(**scfg))
    crowded = srv.submit(pa, 10)
    srv.tick()
    srv.tick()
    b = srv.submit(rng.randint(0, vocab, size=(5,)), 3)
    srv.tick()
    srv.tick()
    c = srv.submit(rng.randint(0, vocab, size=(11,)), 4)
    srv.run()
    return solo.generated, crowded.generated, b, c


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-1.6b"])
def test_recurrent_crowded_equals_solo_bitwise(arch):
    """The per-slot state of a request is its own: strangers joining and
    leaving the other slots (their state zeroed at claim, written only on
    active rows) leave its tokens unchanged bit for bit."""
    cfg = get_config(arch, "smoke")
    eng = _port(cfg, prefetch_depth=1, **PORT_KNOBS)
    params = eng.model.init_params(torch.Generator().manual_seed(0))
    solo, crowded, b, c = _crowded_vs_solo(eng, params, cfg.vocab_size,
                                           _scfg(32, 4))
    assert eng.serve_session(params, ServeConfig(**_scfg(32, 4))) \
        .cfg.prefill_chunk == 1
    assert crowded == solo and len(solo) == 10
    assert len(b.generated) == 3 and len(c.generated) == 4


@pytest.mark.parametrize("chunk", [1, 4])
def test_crowded_equals_solo_bitwise(granite, chunk):
    cfg, params = granite
    solo, crowded, b, c = _crowded_vs_solo(
        _port(cfg, prefetch_depth=1, **PORT_KNOBS), params, cfg.vocab_size,
        _scfg(32, chunk))
    assert crowded == solo and len(solo) == 10
    assert len(b.generated) == 3 and len(c.generated) == 4


def test_slot_and_page_recycling_through_many_requests(granite):
    cfg, params = granite
    eng = _port(cfg, **PORT_KNOBS)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, size=(6,)).astype(np.int32)
               for _ in range(6)]
    scfg = dict(max_batch=2, page_size=8, n_pages=6, max_seq=32)
    _, alone = _serve(eng, params, scfg, prompts[:1], [4])
    srv, got = _serve(eng, params, scfg, prompts, [4] * 6)
    assert all(len(g) == 4 for g in got)
    # later requests ride recycled slots and pages, and still decode as
    # they would alone
    _, last = _serve(eng, params, scfg, prompts[5:], [4])
    assert got[0] == alone[0] and got[5] == last[0]
    st = srv.stats()
    assert st["free_pages"] == 6 and st["free_slots"] == 2
    assert st["ticks"] == srv.n_ticks and st["tokens_out"] == 24


def test_pages_and_slots_bound_admission(granite):
    """A request waits on pages as well as slots: 2 slots, pages for one."""
    cfg, params = granite
    srv = _port(cfg).serve_session(params, ServeConfig(
        max_batch=2, page_size=8, n_pages=4, max_seq=32))
    a = srv.submit(np.arange(20, dtype=np.int32), 6)       # 4 pages
    b = srv.submit(np.arange(3, dtype=np.int32), 2)
    assert a.status == "active" and b.status == "queued"
    srv.run()
    assert len(a.generated) == 6 and len(b.generated) == 2
    assert b.t_first > a.t_done - 1e-9


def test_serve_engine_validation(granite):
    cfg, params = granite
    eng = _port(cfg)
    with pytest.raises(ValueError, match="page_size must divide"):
        eng.serve_session(params, ServeConfig(page_size=7, max_seq=32))
    with pytest.raises(ValueError, match="cannot back even one"):
        eng.serve_session(params, ServeConfig(page_size=8, n_pages=3,
                                              max_seq=32))
    with pytest.raises(ValueError, match="must equal decode_window"):
        _port(cfg, decode_window=16).serve_session(
            params, ServeConfig(page_size=8, max_seq=32))
    srv = eng.serve_session(params, max_batch=2, page_size=8, n_pages=8,
                            max_seq=16)
    with pytest.raises(ValueError, match="exceeds slot capacity"):
        srv.submit(np.zeros(16, np.int32), 1)
    # the audio family is refused, as by the reference's ServeEngine (its
    # encoder K/V is per request, not paged)
    whisper = _port(get_config("whisper-base", "smoke"))
    with pytest.raises(NotImplementedError, match="family"):
        whisper.serve_session(whisper.init_params(
            torch.Generator().manual_seed(0)), ServeConfig(max_seq=32))


def test_grouped_decode_attn_on_and_off(granite):
    cfg, params = granite
    cfg = cfg.replace(dtype="float32")
    prompts = _prompts(cfg.vocab_size, seed=3)
    runs = [_serve(_port(cfg.replace(grouped_decode_attn=g), **PORT_KNOBS),
                   params, _scfg(32, 4), prompts, NEWS)[1]
            for g in (False, True)]
    assert runs[0] == runs[1]


def test_continuous_cli_runs_in_process(capsys):
    reqs = serve_cli.main([
        "--device", "cpu", "--variant", "smoke", "--requests", "5",
        "--max-batch", "2", "--prompt-len", "8", "--gen", "4",
        "--prefill-chunk", "4", "--max-pending", "2", "--weight-stream",
        "--pack", "--prefetch", "1", "--transport", "pallas"])
    assert [r.status for r in reqs].count("done") == 4
    assert [r.status for r in reqs].count("rejected") == 1
    assert all(len(r.generated) == 4 for r in reqs if r.status == "done")
    out = capsys.readouterr().out
    assert "tok/s" in out and "rejected=1" in out


# ---- on the card --------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
def test_crowded_equals_solo_on_card(cuda):
    """granite-3-8b at full width, 2 layers, bf16 compute, f32 rows pinned
    in host memory and fetched by K4: the same tokens alone and crowded."""
    cfg = get_config("granite-3-8b", "full").replace(n_layers=2,
                                                     use_pallas=True)
    eng = engines.create("l2l", cfg, ExecutionConfig(
        weight_stream=True, pack_params=True, prefetch_depth=1,
        transport="pallas"))
    params = eng.init_params(torch.Generator(cuda).manual_seed(0))
    solo, crowded, b, c = _crowded_vs_solo(eng, params, cfg.vocab_size,
                                           _scfg(32, 4))
    assert crowded == solo and len(solo) == 10
    assert len(b.generated) == 3 and len(c.generated) == 4
