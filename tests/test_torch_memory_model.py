"""The port's analytic memory/time model (``repro_torch/core/memory_model.py``)
against the reference's (``repro/core/memory_model.py``): the same
integers and floats for the same model and knobs, at full width
(arithmetic only, no weights) for granite-3-8b, bert-large,
chatglm3-6b, deepseek-v2-lite-16b (two layer groups: a dense layer 0,
26 MoE layers of 2.339 GB in f32), hymba-1.5b and rwkv6-1.6b (per-slot
recurrent state in the serve pools; rwkv6 pages nothing); and the Engine
facades' ``memory_estimate`` / ``serve_memory_estimate`` with each
engine's ``memory_mode``."""
import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro import engine as jengines  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import memory_model as jmm  # noqa: E402
from repro.core.schedule import ExecutionConfig as JExec  # noqa: E402
from repro.models.model import LayeredModel as JModel  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import engine as engines  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import memory_model as mm  # noqa: E402
from repro_torch.core.schedule import ExecutionConfig  # noqa: E402
from repro_torch.models.model import LayeredModel  # noqa: E402
from repro_torch.serve import ServeConfig  # noqa: E402

ARCHS = ["granite-3-8b", "bert-large", "chatglm3-6b", "deepseek-v2-lite-16b",
         "hymba-1.5b", "rwkv6-1.6b", "internvl2-1b", "whisper-base"]


def _models(arch):
    return (LayeredModel(get_config(arch, "full")),
            JModel(jget_config(arch, "full")))


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


# the l2l knob grid: stash placement, G, prefetch, pack, K, tiers
_L2L = [dict(offload_stash=o, layers_per_relay=g, prefetch_depth=k,
             pack_params=p, stash_every=s, transport=t)
        for o, g, k, p, s, t in itertools.product(
            (False, True), (1, 3), (0, 1), (False, True), (1, 5),
            ("xla", "pallas"))]
_EXTRA = [dict(stash_every=4, segment_scan=False),
          dict(tiers=3, host_budget=0, prefetch_depth=2),
          dict(tiers=3, host_budget=3 * 10 ** 9, prefetch_depth=2,
               layers_per_relay=2),
          dict(model_shards=4, pack_params=True)]


@pytest.mark.parametrize("arch", ARCHS)
def test_estimate_matches_reference(arch):
    model, jmodel = _models(arch)
    shape = dict(batch=32, seq=512, n_microbatches=4)
    for mode in ("baseline", "baseline_remat"):
        _same(mm.estimate(model, mode=mode, **shape),
              jmm.estimate(jmodel, mode=mode, **shape))
    for mode in ("l2l", "l2l_p"):
        for kw in _L2L + _EXTRA:
            _same(mm.estimate(model, mode=mode, **shape, **kw),
                  jmm.estimate(jmodel, mode=mode, **shape, **kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_estimate_serve_matches_reference(arch):
    model, jmodel = _models(arch)
    for ws, k, g, pack, t, chunk in itertools.product(
            (False, True), (0, 1), (1, 2), (False, True), ("xla", "pallas"),
            (1, 64)):
        kw = dict(max_batch=8, page_size=16, n_pages=128, max_seq=384,
                  prefill_chunk=chunk, weight_stream=ws, prefetch_depth=k,
                  layers_per_relay=g, pack_params=pack, transport=t)
        _same(mm.estimate_serve(model, **kw),
              jmm.estimate_serve(jmodel, **kw))


def test_time_model_matches_reference():
    _same(mm.paper_worked_example(), jmm.paper_worked_example())
    t, jt = mm.paper_worked_example(), jmm.paper_worked_example()
    assert (t.baseline(), t.l2l(), t.l2l_p()) == \
        (jt.baseline(), jt.l2l(), jt.l2l_p())
    # for_config takes the machine's rates from the caller; at the
    # reference's defaults the two give the same model
    rates = dict(flops_per_s=197e12, eps_flops=2e12, hb=100e9)
    for arch in ARCHS:
        model, jmodel = _models(arch)
        a = mm.for_config(model, batch=32, seq=512, u=4, **rates)
        b = jmm.for_config(jmodel, batch=32, seq=512, u=4)
        _same(a, b)
        assert (a.baseline(), a.l2l(), a.l2l_p()) == \
            (b.baseline(), b.l2l(), b.l2l_p())


@pytest.mark.parametrize("name", ["baseline", "l2l", "l2l-p"])
def test_engine_estimates_match_reference(name):
    knobs = dict(weight_stream=True, pack_params=True, prefetch_depth=1,
                 transport="pallas", offload_stash=True, n_microbatches=2)
    for remat in ((False, True) if name == "baseline" else (False,)):
        cfg = get_config("bert-large", "smoke")
        eng = engines.create(name, cfg, ExecutionConfig(remat=remat, **knobs),
                             device="cpu")
        jeng = jengines.create(name, jget_config("bert-large", "smoke"),
                               JExec(remat=remat, **knobs), donate=False)
        assert eng.memory_mode == jeng.memory_mode
        _same(eng.memory_estimate(batch=8, seq=64),
              jeng.memory_estimate(batch=8, seq=64))
        if name == "baseline":
            # the port's baseline drops weight_stream (it has no relay);
            # serving runs through the l2l engines
            continue
        scfg = dict(max_batch=4, page_size=8, n_pages=16, max_seq=32,
                    prefill_chunk=4)
        _same(eng.serve_memory_estimate(ServeConfig(**scfg)),
              jeng.serve_memory_estimate(JServeConfig(**scfg)))


def test_deepseek_v2_lite_integers():
    """deepseek-v2-lite's figures at full width: the f32 bytes of its two
    groups' layers (0.324 GB dense, 2.339 GB per MoE layer) and of the
    embedding, and the l2l-p estimate's device and EPS split, equal to the
    reference's."""
    import math
    import jax
    from repro_torch.models.common import param_bytes
    model, jmodel = _models("deepseek-v2-lite-16b")
    is_jspec = lambda x: type(x).__name__ == "ParamSpec"

    def jbytes(tree):
        return sum(4 * math.prod(s.shape)
                   for s in jax.tree.leaves(tree, is_leaf=is_jspec))

    dense, moe = (param_bytes(g.spec) for g in model.groups)
    assert (dense, moe) == tuple(jbytes(g.spec) for g in jmodel.groups)
    assert (round(dense / 1e9, 3), round(moe / 1e9, 3)) == (0.324, 2.339)
    assert param_bytes(model.param_specs()["embed"]) == 838_860_800
    kw = dict(batch=8, seq=512, n_microbatches=2, offload_stash=True,
              pack_params=True, prefetch_depth=1, transport="pallas")
    got = mm.estimate(model, mode="l2l_p", **kw)
    _same(got, jmm.estimate(jmodel, mode="l2l_p", **kw))
    assert got.total_device < got.total_host


def test_serve_slot_state_follows_max_batch_for_recurrent():
    """tests/test_memory_model.py's test in the port, and the slot-state
    and page bytes of both recurrent families at full width equal to the
    reference's integers."""
    model = LayeredModel(get_config("rwkv6-1.6b", "smoke"))
    b4 = mm.estimate_serve(model, max_batch=4, page_size=8, n_pages=16,
                           max_seq=64)
    b8 = mm.estimate_serve(model, max_batch=8, page_size=8, n_pages=16,
                           max_seq=64)
    assert b4.slot_state_bytes > 0
    assert b8.slot_state_bytes == 2 * b4.slot_state_bytes
    # rwkv has NO paged leaves: the whole cache is per-slot state
    assert b4.kv_page_bytes == 0
    kw = dict(max_batch=8, page_size=16, n_pages=64, max_seq=256)
    got = {}
    for arch in ("hymba-1.5b", "rwkv6-1.6b"):
        model, jmodel = _models(arch)
        a, b = mm.estimate_serve(model, **kw), jmm.estimate_serve(jmodel, **kw)
        _same(a, b)
        got[arch] = (a.kv_page_bytes, a.slot_state_bytes)
    # bf16 state: hymba's h (8, 1600, 16) and conv window (8, 3, 1600) per
    # layer, 32 layers; rwkv6's wkv (8, 32, 64, 64) and two shifts (8, 2048)
    # per layer, 24 layers
    assert got["hymba-1.5b"][1] == 32 * 2 * 8 * (1600 * 16 + 3 * 1600)
    assert got["rwkv6-1.6b"] == (0, 24 * 2 * 8 * (32 * 64 * 64 + 2 * 2048))
    assert got["hymba-1.5b"][0] == 32 * 64 * 16 * (2 * 2 * 5 * 64 + 4)
