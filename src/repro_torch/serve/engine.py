"""The serve tick: ONE relay sweep per decode step for every live slot (the
port of ``repro/serve/engine.py``).

``make_serve_tick`` is ``core.decode.make_serve_step`` restated over the
paged pool: the SAME ``relay_scan`` (G-layer grouping, k-deep prefetch
ring, packed rows, the pinned EPS streams fetched by K4) walks the layer
stack once per tick, and at each stop the body gathers the
slot-contiguous cache view from the page pool, runs the group's
unmodified decode block for ALL in-flight requests at once, and scatters
this tick's new entries back into the pool in place.  The per-layer
fetch from host memory is therefore paid once per tick, not once per
request — the layer-major continuous-batching claim.

Everything dynamic (tokens, positions, page tables, active mask, claim
lists, sampling knobs) enters as fixed-shape numpy arrays from the
Scheduler, so every tick has the shape (max_batch, prefill_chunk,
pages_per_slot) and requests join and leave mid-flight.  The index
tensors are made on the host once per tick (``paged_kv.tick_index``);
the one wait for the card per tick is the sampled tokens going to the
host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.relay import Stream, relay_scan
from repro_torch.serve import paged_kv, sampling
from repro_torch.serve.scheduler import Request, Scheduler


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Shape of the serve session.

    * ``max_seq``  — logical cache positions per slot; must equal
      ``decode_window`` when the engine decodes with a ring.
    * ``n_pages``  — physical page pool shared by all slots; admission
      blocks (never deadlocks) when reservations would exceed it.
    * ``prefill_chunk`` — prompt tokens a prefilling slot feeds per tick
      (extra query rows on the same sweep); recurrent families (ssm /
      hybrid) are strictly single-token and force 1.
    """
    max_batch: int = 4
    page_size: int = 8
    n_pages: int = 32
    max_seq: int = 64
    prefill_chunk: int = 1
    # host-side admission bound (not a shape knob): submits beyond this
    # many queued-but-unadmitted requests are rejected, not queued
    # (0 = unbounded).  Rejections/evictions show up in ``stats()``.
    max_pending: int = 0


def make_serve_tick(model, exec_cfg, placements, serve_cfg: ServeConfig,
                    device="cpu", copy_stream=None):
    """Returns tick(params, pools, plan arrays) -> (tokens (B,) on the
    device, pools updated in place).  The tick takes no depth: under
    ``dynamic_depth`` it relays every layer, as the reference's does."""
    device = torch.device(device)
    page_size = serve_cfg.page_size
    dgroups = model.decode_groups()
    gidx = [i for i, g in enumerate(model.groups) if not g.is_encoder]
    gpages = paged_kv.group_pages(model, serve_cfg.max_batch,
                                  serve_cfg.max_seq)

    def tick(params, pools, tokens, pos, table, active, last_idx, seeds,
             sample_pos, temp, top_k, new_pages, new_slots):
        # claim-time hygiene first: new pages' pos -> -1, new slots'
        # recurrent state -> 0 (both no-ops when the id lists are padding)
        paged_kv.reset_claim(pools, gpages, new_pages, new_slots)
        index = paged_kv.tick_index(table, pos, active, page_size, device)
        tok = torch.from_numpy(np.asarray(tokens, np.int64)).to(device)
        pos_t = torch.from_numpy(np.asarray(pos, np.int32)).to(device)
        static = {"embed": params["embed"], "head": params["head"]}
        x = model.decode_embed(static, tok, pos_t)
        ctx = model.decode_ctx(pos_t, window=exec_cfg.decode_window)
        for di, group in enumerate(dgroups):
            def body(x_c, slots, pool_l, _g=group, _gp=gpages[di]):
                (w,) = slots
                if exec_cfg.pack_params:
                    w = packing.unpack(w)
                view = paged_kv.gather_view(pool_l, _gp, None, page_size,
                                            index=index)
                x2, new_view = _g.decode(w, x_c, view, None, ctx)
                paged_kv.scatter_new(pool_l, new_view, _gp, None, None,
                                     None, index=index)
                return x2, None

            x, _ = relay_scan(
                body, x, (Stream(placements.weights[gidx[di]],
                                 params["groups"][gidx[di]]),),
                xs=pools[di], group=exec_cfg.layers_per_relay,
                prefetch=exec_cfg.prefetch_depth,
                transport=exec_cfg.transport, device=device,
                copy_stream=copy_stream)
        # the last real row of each slot, then the head on those rows only
        # (rows are independent: the same logits as the whole (B, T) head)
        rows = torch.arange(x.shape[0], device=device)
        last = torch.from_numpy(np.asarray(last_idx, np.int64)).to(device)
        logits = model.decode_logits(static, x[rows, last][:, None])[:, 0]
        return sampling.sample(logits, seeds, sample_pos, temp,
                               top_k), pools

    return tick


class ServeEngine:
    """A continuous-batching serve session over an existing Engine.

    Owns the page pools (on the engine's device), the Scheduler and the
    tick; the Engine contributes its model, ExecutionConfig, EPS
    placements and copy stream, so every relay knob (weight_stream /
    prefetch / group / pack / transport / window) composes with serving
    unchanged::

        srv = eng.serve_session(params, ServeConfig(max_batch=8))
        srv.submit(prompt_ids, max_new=32)
        finished = srv.run()              # tick until idle
        finished[0].generated             # -> token ids
    """

    def __init__(self, engine, params, serve_cfg: Optional[ServeConfig]
                 = None):
        serve_cfg = serve_cfg or ServeConfig()
        model = engine.model
        fam = model.cfg.family
        if fam == "audio":
            raise NotImplementedError(
                "continuous-batching serve does not cover the audio "
                "family (encoder cross-KV is per-request, not paged)")
        if fam in ("ssm", "hybrid") and serve_cfg.prefill_chunk != 1:
            # recurrent state admits exactly one token per step
            serve_cfg = dataclasses.replace(serve_cfg, prefill_chunk=1)
        window = engine.exec_cfg.decode_window
        if window and serve_cfg.max_seq != window:
            raise ValueError(
                f"ServeConfig.max_seq ({serve_cfg.max_seq}) must equal "
                f"decode_window ({window}) — the ring IS the slot")
        if serve_cfg.max_seq % serve_cfg.page_size:
            raise ValueError("page_size must divide max_seq")
        P = serve_cfg.max_seq // serve_cfg.page_size
        if serve_cfg.n_pages < P:
            raise ValueError(
                f"n_pages ({serve_cfg.n_pages}) cannot back even one "
                f"slot ({P} pages)")

        self.engine = engine
        self.model = model
        self.cfg = serve_cfg
        self.params = engine._relay_params(params)
        self.scheduler = Scheduler(
            max_batch=serve_cfg.max_batch, page_size=serve_cfg.page_size,
            n_pages=serve_cfg.n_pages, max_seq=serve_cfg.max_seq,
            prefill_chunk=serve_cfg.prefill_chunk, window=window,
            max_pending=serve_cfg.max_pending)
        self.pools = paged_kv.init_pool(
            model, max_batch=serve_cfg.max_batch,
            page_size=serve_cfg.page_size, n_pages=serve_cfg.n_pages,
            max_seq=serve_cfg.max_seq, device=engine.device)
        self._tick = make_serve_tick(model, engine.exec_cfg,
                                     engine.placements, serve_cfg,
                                     engine.device, engine.copy_stream)
        self._t0 = time.monotonic()
        self.n_ticks = 0
        self.tokens_out = 0

    # ------------------------------------------------------------------
    def _now(self) -> float:
        return time.monotonic() - self._t0

    def submit(self, prompt, max_new: int, **kw) -> Request:
        """Queue a request.  ``ttl=`` (seconds) / ``ttl_ticks=`` set a
        deadline after which it is evicted — pending or mid-flight — and
        its slot/pages recycled; ``Request.status`` tells how it ended
        (done / evicted / rejected)."""
        return self.scheduler.submit(prompt, max_new, now=self._now(),
                                     **kw)

    def tick(self) -> List[Request]:
        """Run one relay sweep for all live slots; returns the requests
        that left the system this tick — finished normally or evicted at
        their deadline (empty when idle or none left)."""
        plan = self.scheduler.plan_tick(now=self._now())
        evicted = self.scheduler.take_evicted()
        if plan is None:
            return evicted
        with torch.inference_mode():
            toks, self.pools = self._tick(
                self.params, self.pools, plan.tokens, plan.pos, plan.table,
                plan.active, plan.last_idx, plan.seeds, plan.sample_pos,
                plan.temp, plan.top_k, plan.new_pages, plan.new_slots)
            toks = toks.cpu().numpy()            # the tick's one sync
        self.n_ticks += 1
        self.tokens_out += int(plan.sample.sum())
        return evicted + self.scheduler.record(toks, now=self._now())

    def run(self, max_ticks: int = 100_000) -> List[Request]:
        """Tick until every submitted request has finished."""
        done: List[Request] = []
        for _ in range(max_ticks):
            if self.scheduler.idle:
                break
            done.extend(self.tick())
        else:
            raise RuntimeError(f"serve did not drain in {max_ticks} ticks")
        return done

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        out = dict(self.scheduler.stats())
        out.update(ticks=self.n_ticks, tokens_out=self.tokens_out,
                   elapsed_s=self._now())
        return out
