"""Analytic memory/time model — equations (1)-(7) of the paper,
parameterized by a model and the execution knobs (the port of
``repro/core/memory_model.py``: the same arithmetic, the same integers for
the same model and knobs).

The byte split of what the schedule keeps on the device and what rests
in the EPS (pinned host memory), from the layers' ParamSpecs and the
activation shapes.  It models the reference's buffers, not PyTorch's
caching allocator: ``chip_smoke.py`` prints it beside the measured peak
without tying the two.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.l2l import segment_bounds
from repro_torch.core.relay import n_stops
from repro_torch.core.tierstore import demote_plan, ring_depth
from repro_torch.core.tree import tree_leaves
from repro_torch.models.common import is_spec, param_bytes
from repro_torch.models.model import LayeredModel
from repro_torch.serve.paged_kv import pool_bytes


def bytes_per(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}[dtype]


@dataclass
class MemoryReport:
    # bytes
    params_device: int          # weights resident in HBM
    params_host: int            # weights resident in EPS (host DRAM)
    opt_state: int              # wherever the optimizer lives (4x rule)
    activations: int            # intermediate activations at peak
    stash: int                  # layer-boundary stash (device or host)
    stash_on_host: bool
    total_device: int = 0
    total_host: int = 0
    # DMA issue counts per relay STOP per direction (l2l modes).  The
    # BYTES of eq. (2)/(3)'s transit terms are layout-independent; what
    # pack_params changes is how many host<->HBM copies carry them: the
    # per-leaf relay issues one copy per param leaf (and per optimizer
    # slot leaf in l2l_p), the packed relay one copy per dtype segment
    # (weights) / per optimizer slot (m, v).  A stop covers
    # ``layers_per_relay`` stacked layers in the SAME copies (the slice
    # just grows a leading axis), so ``relay_stops`` — total stops one
    # pass makes over the depth, sum of ceil(n_layers/G) per group, or of
    # per-segment ceilings when ``stash_every`` > 1 segments the pass —
    # is the trip-count multiplier.  Small copies are latency-bound, so
    # relay_stops * relay_copies_* — not the byte total — is the eq. (6)
    # relay-term factor the packed/grouped layouts attack.
    relay_copies_weights: int = 0
    relay_copies_opt: int = 0
    relay_stops: int = 0
    # --- constant-memory stash (stash_every = K) ------------------------
    # The stash term above is ceil(N/K)*mb*A instead of N*mb*A: only
    # every K-th layer boundary is checkpointed (stash_boundaries counts
    # them).  The backward pays for it by re-streaming each K-segment's
    # weights forward to recompute the missing boundaries:
    # recompute_layers extra layer-forwards per step (N - ceil(N/K) — the
    # flop side) issued over recompute_stops extra weight-relay stops
    # (the DMA side, ceil((len-1)/G) per segment).  Each recomputed
    # boundary is re-hosted into the STASH tier and fetched back per
    # layer (the K=1 protocol), so the recompute working set —
    # recompute_buffer = (largest segment - 1) boundaries — rides the
    # stash placement: host bytes under offload_stash (total stash-tier
    # peak ceil(N/K)+K-1 boundaries, the Chen sqrt-N curve), device bytes
    # otherwise; the device transit/activation terms never see K.  With
    # K = 1 all four reduce to the historical model (stash_boundaries =
    # N, zeros).
    stash_boundaries: int = 0
    recompute_layers: int = 0
    recompute_stops: int = 0
    recompute_buffer: int = 0
    # --- program size (scan over segments) -------------------------------
    # How many RELAY INSTANCES the reference's lowered train step contains
    # — distinct relay scans its compiler must lower, NOT trip counts
    # (those are ``relay_stops``).  Its unrolled K > 1 schedule had one
    # relay per segment per phase: ~3·ceil(N/K) instances (fwd +
    # recompute + bwd); with ``segment_scan`` every phase drives its
    # segments through ONE outer scan, an O(1)-in-depth count (plus at
    # most one extra set for the N mod K remainder).  K = 1 was never
    # unrolled.  The port's eager loop lowers nothing; the count is kept
    # so the two reports compare.
    relay_instances: int = 0
    # --- storage tier (tiers = 3: HBM <- pinned host <- mmap/NVMe) -------
    # The cold row tail of the stacked EPS state (weights + optimizer
    # slots; gradients are transit, never demoted) that lives in the
    # on-disk SegmentStore under the host budget — planned by the SAME
    # ``tierstore.demote_plan`` the runtime executes, so the accounting
    # cannot drift from the chain.  ``disk_reads`` counts the per-step
    # stage-in segment reads: ceil(demoted / G) relay-stop chunks per
    # group, each fetching 1 weight segment + opt_slots slot segments
    # (stage-out writes the same bytes back; writes are not counted
    # here).  ``disk_read_ahead_cap`` is the prefetch ring's EFFECTIVE
    # depth: the configured prefetch_depth, shrunk by the watchdog so
    # the in-flight chunks fit the host-budget slack
    # (``tierstore.ring_depth``) — degrade, don't OOM.
    params_disk: int = 0
    opt_disk: int = 0
    total_disk: int = 0
    demoted_layers: int = 0
    disk_reads: int = 0
    disk_read_ahead_cap: int = 0
    # --- serve mode (continuous batching, estimate_serve) ---------------
    # The serve-time device residents replacing the training stash terms:
    # the paged KV pool (n_pages fixed-size pages shared by all slots —
    # the knob that decouples cache memory from max_batch * max_seq), the
    # per-slot recurrent state (SSM/conv/RWKV leaves, max_batch-major),
    # and the tick's relay DMA trip count (sum of ceil(n_layers/G) over
    # decode groups — paid ONCE per tick for ALL in-flight requests; the
    # per-request DMA cost is relay_stops_per_tick / batch).
    kv_page_bytes: int = 0
    slot_state_bytes: int = 0
    relay_stops_per_tick: int = 0
    # --- relay transport (ExecutionConfig.transport) ----------------------
    # The reference's transport="pallas" runs each relay copy through a
    # double-buffered DMA pipeline: at most TWO chunks of the slot are in
    # flight at once, so its working set beyond the (already-counted)
    # destination slot is the 2-chunk DMA window — 2 * slot_bytes /
    # chunks_per_slot (one chunk per stacked row for G >= 2, two half-row
    # chunks for single-layer slots).  Zero under "xla".  (The port's K4
    # copies straight into the slot and stages nothing; the term is the
    # reference's, kept so the two reports compare.)
    transport_buffer: int = 0

    def finalize(self):
        self.total_device = (self.params_device + self.activations
                             + self.kv_page_bytes + self.slot_state_bytes
                             + self.transport_buffer
                             + (0 if self.stash_on_host
                                else self.stash + self.recompute_buffer))
        self.total_host = (self.params_host + self.opt_state
                           + ((self.stash + self.recompute_buffer)
                              if self.stash_on_host else 0))
        self.total_disk = self.params_disk + self.opt_disk
        return self


def _layer_bytes(model: LayeredModel, dtype_bytes: int):
    """(max single-layer bytes, total stacked-layer bytes)."""
    per_layer = [param_bytes(g.spec, dtype_bytes) for g in model.groups]
    totals = [p * g.n_layers for p, g in zip(per_layer, model.groups)]
    return max(per_layer), sum(totals)


def _slot_bytes(model: LayeredModel, dtype_bytes: int, group: int) -> int:
    """Largest relay-slot bytes: a slot holds min(G, n_layers) stacked
    layers (G may exceed a shallow group's depth — the slot is then just
    that group's whole stack), so the peak is over groups of that."""
    return max(param_bytes(g.spec, dtype_bytes) * min(group, g.n_layers)
               for g in model.groups)


def estimate(model: LayeredModel, *, batch: int, seq: int,
             n_microbatches: int = 1, mode: str = "l2l",
             offload_stash: bool = False, opt_slots: int = 2,
             act_dtype_bytes: int = 2, param_dtype_bytes: int = 4,
             prefetch_depth: int = 0,
             pack_params: bool = False,
             layers_per_relay: int = 1,
             stash_every: int = 1,
             segment_scan: bool = True,
             tiers: int = 2,
             host_budget: int = 0,
             model_shards: int = 1,
             transport: str = "xla") -> MemoryReport:
    """Modes:
      baseline      eq. (1): everything device-resident
      baseline_remat eq. (1) with the N*L*mb*X term reduced to boundaries
      l2l           eq. (2): one layer (+1 transit buffer) on device,
                    stash of N*mb*A boundaries on device
      l2l_p         eq. (3)/(4): + weight/grad transit buffers; stash to
                    host when offload_stash (the constant-memory variant)

    ``prefetch_depth`` (k) and ``layers_per_relay`` (G) — l2l modes only —
    make the paper's "the executing layer(s)'s footprint" plural explicit:
    the relay ring keeps G·(1 + k) full layer slots in HBM (one G-layer
    compute slot + k in-flight DMA slots), so the device weight-transit
    footprint is G·(1 + k) × eq. (2)/(3)'s — still O(1) in depth N.  A
    slot never holds more than a group's whole stack, so G is capped at
    the deepest group's depth in the footprint.  G also divides the
    relay trip count: one pass makes ``relay_stops`` = sum over groups
    of ceil(n_layers / G) stops instead of N.

    ``stash_every`` (K, l2l modes only) is the constant-memory stash:
    only every K-th layer boundary is checkpointed, so the stash term
    drops from N*mb*A to ceil(N/K)*mb*A — sublinear in depth wherever it
    lives (device or, with ``offload_stash``, EPS host).  The price is
    accounted in ``recompute_layers`` (N - ceil(N/K) extra layer-forwards
    per step) and ``recompute_stops`` (the extra forward weight-relay
    stops the backward issues to recompute each segment's missing
    boundaries), and in ``recompute_buffer``: the (largest segment - 1)
    recomputed boundaries the STASH TIER transiently holds while a
    segment's backward runs (host under ``offload_stash``, device
    otherwise — without offload the stash-tier peak is the Chen
    ceil(N/K) + K - 1 sqrt-N curve).  Because every relay then runs over
    one K-segment, the device relay slot is capped at min(G, K, depth)
    layers — K < G shrinks the weight-transit footprint too.  K = 1
    reproduces today's model byte-for-byte.

    ``segment_scan`` (l2l modes, K > 1 only) changes no byte term — it is
    purely a PROGRAM-SIZE knob of the reference, reported in
    ``relay_instances``: the distinct relay scans its lowered train step
    contains.  True drives all of a phase's segments through one outer
    scan — O(1) instances in depth; False the unrolled per-segment
    program — ~3·ceil(N/K) instances.

    ``pack_params`` (l2l modes only) does NOT change any byte term — the
    transit buffers of eq. (2)/(3) hold the same elements whether they
    arrive as one flat segment or N leaf arrays.  What it changes is the
    reported ``relay_copies_*`` DMA issue counts: per-leaf relay pays one
    host<->HBM copy per param leaf per stop per direction (plus one per
    optimizer-slot leaf in l2l_p), the packed relay one copy per dtype
    segment (weights) and one per optimizer slot (m, v) — the
    latency-bound small-transfer term eq. (6) hides inside its bandwidth
    model.

    ``tiers``/``host_budget`` (l2l modes only) account the storage tier:
    with ``tiers = 3`` the coldest stacked rows of the EPS state (weights
    + opt slots; grads are transit) demote to the on-disk SegmentStore —
    planned by the SAME ``tierstore.demote_plan`` the runtime executes
    (``host_budget = 0`` demotes everything: fully streamed).  Demoted
    bytes move from ``params_host``/``opt_state`` into
    ``params_disk``/``opt_disk``; ``disk_reads`` counts the per-step
    stage-in segment reads and ``disk_read_ahead_cap`` the
    watchdog-shrunk effective prefetch depth (``tierstore.ring_depth``).

    ``transport`` (l2l modes only) accounts the reference's copy kernel's
    double-buffer window: ``"pallas"`` adds ``transport_buffer`` = two
    in-flight DMA chunks of the relay slot (one chunk per stacked slot
    row when the slot is grouped, two half-row chunks for a single-layer
    slot); ``"xla"`` adds nothing.

    ``model_shards`` divides the per-device/per-host BYTE terms (relay
    slot, host-resident stack, opt state, disk tier) for a program model-
    sharded over that many devices — the relay slot a device fetches and
    the stack a host holds are 1/shards of the full layer.  Activation /
    stash terms are NOT divided (batch-sharding is a separate axis):
    the estimate stays conservative.  ``host_budget`` is then PER HOST.
    """
    cfg = model.cfg
    d = cfg.d_model
    L_max, L_total = _layer_bytes(model, param_dtype_bytes)
    n_layers = sum(g.n_layers for g in model.groups)
    # A: boundary activation bytes per sample; X: intra-layer activation
    # bytes per sample (attention scores excluded — flash/chunked streaming)
    A = seq * d * act_dtype_bytes
    ff = max(cfg.d_ff, cfg.d_ff_expert * max(cfg.experts_per_token, 1)
             if cfg.n_experts else cfg.d_ff)
    X = seq * (2 * d + 2 * ff) * act_dtype_bytes
    ub = max(1, batch // max(n_microbatches, 1))

    if mode.startswith("baseline"):
        act = batch * X * (1 if mode.endswith("remat") else n_layers)
        stash = n_layers * batch * A if mode.endswith("remat") else 0
        return MemoryReport(
            params_device=L_total,
            params_host=0,
            opt_state=(1 + opt_slots) * L_total,   # grads + adam m,v
            activations=act,
            stash=stash, stash_on_host=False).finalize()

    G = max(1, layers_per_relay)
    K = max(1, stash_every)
    transit = 2 if mode == "l2l" else 4            # eq.(2) vs eq.(3)
    transit *= 1 + prefetch_depth                  # ring of G-layer slots
    # a slot holds min(G, group depth) layers — G beyond the deepest
    # group adds no residency (the remainder-only pass).  With
    # stash_every = K > 1 every relay runs over one K-segment, so the
    # slot is further capped at the segment length: min(G, K, depth).
    slot = _slot_bytes(model, param_dtype_bytes, min(G, K) if K > 1 else G)
    # DMA issues per relay stop per direction (largest group): the
    # per-leaf relay pays one copy per leaf; the packed relay one per
    # dtype segment (a single param_dtype here) / per optimizer slot.
    # Grouping keeps these counts (the slice grows a leading G axis) but
    # divides the trip count: relay_stops = sum ceil(n_layers / G)
    # (relay.n_stops — the executor's own arithmetic).
    n_leaves = max(len(tree_leaves(g.spec, is_leaf=is_spec))
                   for g in model.groups)
    copies_w = 1 if pack_params else n_leaves
    copies_o = ((opt_slots if pack_params else n_leaves * opt_slots)
                if mode == "l2l_p" else 0)
    # constant-memory stash: ceil(N/K) checkpointed boundaries per group;
    # the backward re-streams each segment's first len-1 layers forward
    # to recompute the in-between boundaries (extra stops + layer flops)
    segs = [segment_bounds(g.n_layers, K) for g in model.groups]
    if K == 1:
        stops = sum(n_stops(g.n_layers, G) for g in model.groups)
    else:
        # K > 1 segments every forward/backward pass: one relay per
        # segment, so a pass issues ceil(len/G) stops per segment —
        # more than ceil(N/G) when K is not a multiple of G
        stops = sum(n_stops(s1 - s0, G)
                    for gsegs in segs for s0, s1 in gsegs)
    n_ckpt = sum(len(s) for s in segs)
    rec_layers = n_layers - n_ckpt
    rec_stops = sum(n_stops(s1 - s0 - 1, G)
                    for gsegs in segs for s0, s1 in gsegs if s1 - s0 > 1)
    # recompute working set: while one segment's backward runs, the
    # stash tier additionally holds its seg_len - 1 recomputed
    # boundaries (the entry is one of the persistent checkpoints)
    rec_buffer = (max(max(s1 - s0 for s0, s1 in gsegs)
                      for gsegs in segs) - 1) * batch * A if K > 1 else 0
    # program size: distinct relay instances the lowered step contains.
    # K = 1 was never segmented: one fwd + one bwd relay (+ trailing
    # update relay under the non-eager optimizer) per group.
    upd = 1 if mode == "l2l" else 0
    if K == 1:
        instances = len(model.groups) * (2 + upd)
    elif not segment_scan:
        # unrolled: one fwd + one bwd relay per segment, one recompute
        # relay per multi-layer segment — grows with ceil(N/K)
        n_rec = sum(1 for gsegs in segs for s0, s1 in gsegs if s1 - s0 > 1)
        instances = (sum(2 * len(gsegs) for gsegs in segs) + n_rec
                     + len(model.groups) * upd)
    else:
        # one outer scan per phase (fwd relay; rec + bwd relays share the
        # reverse scan body) plus the N mod K remainder's relays outside
        instances = 0
        for g in model.groups:
            R = g.n_layers % K
            instances += 3 + upd
            if R:
                instances += 2 + (1 if R > 1 else 0)
    # --- model sharding + storage tier -----------------------------------
    shards = max(1, int(model_shards))
    shard = lambda b: -(-b // shards)              # ceil: stay conservative
    per_layer_w = [shard(param_bytes(g.spec, param_dtype_bytes))
                   for g in model.groups]
    # demotable stacked state per layer row: weights + the opt slots that
    # live alongside them in the store (grads are transit, never stored)
    per_layer_state = [p * (1 + opt_slots) for p in per_layer_w]
    n_list = [g.n_layers for g in model.groups]
    L_total_s = sum(p * n for p, n in zip(per_layer_w, n_list))
    params_host = L_total_s
    opt_host = (1 + opt_slots) * L_total_s         # EPS-resident
    params_disk = opt_disk = demoted = reads = cap = 0
    if tiers >= 3:
        hot = demote_plan(per_layer_state, n_list, host_budget)
        dem = [n - h for h, n in zip(hot, n_list)]
        demoted = sum(dem)
        params_disk = sum(d_ * p for d_, p in zip(dem, per_layer_w))
        opt_disk = sum(d_ * p * opt_slots
                       for d_, p in zip(dem, per_layer_w))
        params_host -= params_disk
        opt_host -= opt_disk
        # stage-in reads: ceil(demoted / G) chunks per group, each
        # fetching 1 weight segment + opt_slots slot segments
        reads = sum(n_stops(d_, G) * (1 + opt_slots) for d_ in dem if d_)
        if demoted:
            chunk = G * max(s for d_, s in zip(dem, per_layer_state)
                            if d_)
            resident = sum(h * s for h, s in zip(hot, per_layer_state))
            cap = ring_depth(prefetch_depth, chunk,
                             max(0, host_budget - resident),
                             bounded=host_budget > 0)
    # pallas transport: the copy kernel keeps two DMA chunks of a slot in
    # flight (one chunk per stacked row of a grouped slot, two half-row
    # chunks for a single-layer slot)
    slot_rows = min(G, K) if K > 1 else G
    chunks = slot_rows if slot_rows >= 2 else 2
    trans_buf = (-(-2 * shard(slot) // chunks)
                 if transport == "pallas" else 0)
    return MemoryReport(
        params_device=transit * shard(slot),
        params_host=params_host,
        opt_state=opt_host,
        activations=ub * X,                        # recompute working set
        stash=n_ckpt * batch * A,
        stash_on_host=offload_stash,
        relay_copies_weights=copies_w,
        relay_copies_opt=copies_o,
        relay_stops=stops,
        stash_boundaries=n_ckpt,
        recompute_layers=rec_layers,
        recompute_stops=rec_stops,
        recompute_buffer=rec_buffer,
        relay_instances=instances,
        params_disk=params_disk,
        opt_disk=opt_disk,
        demoted_layers=demoted,
        disk_reads=reads,
        disk_read_ahead_cap=cap,
        transport_buffer=trans_buf).finalize()


def estimate_serve(model: LayeredModel, *, max_batch: int, page_size: int,
                   n_pages: int, max_seq: int, prefill_chunk: int = 1,
                   weight_stream: bool = True, prefetch_depth: int = 0,
                   pack_params: bool = False, layers_per_relay: int = 1,
                   act_dtype_bytes: int = 2, cache_dtype_bytes: int = 2,
                   param_dtype_bytes: int = 4,
                   transport: str = "xla") -> MemoryReport:
    """Serve-mode byte split for the continuous-batching engine
    (``repro_torch.serve``): no optimizer / stash terms; instead the device
    holds the paged KV pool, the per-slot recurrent state and — with
    ``weight_stream`` — the G·(1 + prefetch) relay slots of eq. (2)'s
    weight transit (the whole stack stays EPS-resident).  The per-tick
    relay DMA trip count lands in ``relay_stops_per_tick``: layer-major
    continuous batching pays it once per tick for every in-flight
    request, so its per-request share shrinks as concurrency grows.
    """
    cfg = model.cfg
    d = cfg.d_model
    L_max, L_total = _layer_bytes(model, param_dtype_bytes)
    G = max(1, layers_per_relay)
    kv, slot_state, _ = pool_bytes(
        model, max_batch=max_batch, page_size=page_size, n_pages=n_pages,
        max_seq=max_seq, cache_dtype_bytes=cache_dtype_bytes)
    ff = max(cfg.d_ff, cfg.d_ff_expert * max(cfg.experts_per_token, 1)
             if cfg.n_experts else cfg.d_ff)
    # the tick's live activations: max_batch rows x prefill_chunk query
    # positions through one layer's working set
    act = max_batch * prefill_chunk * (2 * d + 2 * ff) * act_dtype_bytes
    if weight_stream:
        slot = _slot_bytes(model, param_dtype_bytes, G)
        params_device = (1 + prefetch_depth) * slot
        params_host = L_total
    else:
        params_device, params_host, slot = L_total, 0, 0
    trans_buf = (-(-2 * slot // (G if G >= 2 else 2))
                 if transport == "pallas" and weight_stream else 0)
    n_leaves = max(len(tree_leaves(g.spec, is_leaf=is_spec))
                   for g in model.groups)
    stops = sum(n_stops(g.n_layers, G) for g in model.decode_groups())
    return MemoryReport(
        params_device=params_device,
        params_host=params_host,
        opt_state=0,
        activations=act,
        stash=0, stash_on_host=False,
        relay_copies_weights=1 if pack_params else n_leaves,
        relay_stops=stops,
        kv_page_bytes=kv,
        slot_state_bytes=slot_state,
        relay_stops_per_tick=stops if weight_stream else 0,
        transport_buffer=trans_buf).finalize()


# ---------------------------------------------------------------------------
# Time model — equations (5)-(7)
# ---------------------------------------------------------------------------
@dataclass
class TimeModel:
    n_layers: int
    layer_bytes: float          # L in bytes
    f_t: float                  # forward time per microbatch (s)
    b_t: float                  # backward time per microbatch (s)
    o_t: float                  # optimizer time on device (s)
    o_tc: float                 # optimizer time on EPS/CPU (s)
    hb: float                   # host->device bandwidth bytes/s
    u: int                      # microbatches per minibatch

    def baseline(self) -> float:                       # eq. (5)
        return self.n_layers * self.u * (self.f_t + self.b_t) + self.o_t

    def l2l(self) -> float:                            # eq. (6)
        relay = self.n_layers * 2 * self.layer_bytes / self.hb
        compute = self.n_layers * self.u * (2 * self.f_t + self.b_t)
        return relay + compute + self.o_tc

    def l2l_p(self) -> float:                          # eq. (7)
        compute = self.n_layers * self.u * (2 * self.f_t + self.b_t)
        opt_exposed = max(0.0, self.o_tc
                          - self.n_layers * self.u * self.b_t)
        relay_exposed = max(0.0, self.n_layers * (
            self.layer_bytes / self.hb - self.u * self.f_t))
        return compute + opt_exposed + relay_exposed


def paper_worked_example() -> TimeModel:
    """§3.1.2: BERT-Large, V100 @30 TFLOPs effective, mb=64, u=16 (ub=4),
    fwd 12 GFLOP/layer/sample, bwd 24, optimizer 100 GFLOP, EPS 300 GFLOPs,
    PCIe 16 GB/s, L = 350M params / 24 layers * 4B."""
    tf = 30e12
    return TimeModel(
        n_layers=24,
        layer_bytes=350e6 / 24 * 4,
        f_t=12e9 * 4 / tf,
        b_t=24e9 * 4 / tf,
        o_t=100e9 / tf,
        o_tc=100e9 / 300e9,
        hb=16e9,
        u=16)


def for_config(model: LayeredModel, *, batch: int, seq: int, u: int,
               flops_per_s: float, eps_flops: float,
               hb: float) -> TimeModel:
    """Time model for an architecture on a given machine: ``flops_per_s``
    the device's compute rate, ``eps_flops`` the host optimizer's, ``hb``
    the host -> device rate in bytes/s (the caller names its machine's;
    no default stands in for a measurement)."""
    cfg = model.cfg
    n_active = cfg.param_count(active_only=True)
    L_max, L_total = _layer_bytes(model, 4)
    n_layers = sum(g.n_layers for g in model.groups)
    ub = max(1, batch // u)
    tokens = ub * seq
    f = 2 * n_active / n_layers * tokens / flops_per_s
    return TimeModel(
        n_layers=n_layers, layer_bytes=L_max,
        f_t=f, b_t=2 * f,
        o_t=10 * cfg.param_count() / flops_per_s,
        o_tc=10 * cfg.param_count() / eps_flops,
        hb=hb, u=u)
