"""Execution schedule configuration (the port's copy of
``repro.core.schedule``).

The same frozen dataclass, with the same fields, defaults and checks, so
a configuration reads the same in both packages.  The port runs the
serving slice of it so far: ``weight_stream``, ``layers_per_relay`` (G),
``prefetch_depth`` (k), ``pack_params``, ``transport``, ``n_microbatches``
(prefill) and ``decode_window``.  The training knobs are carried for the
next slice and are not read yet.

The device weight footprint is G·(1 + k) layer slots — the paper §3.1's
"the executing layer(s)" — while every (G, k, pack) combination computes
bit-identical results (tests/test_torch_serve.py).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ExecutionConfig:
    n_microbatches: int = 1
    # --- L2L memory policies -------------------------------------------
    offload_stash: bool = False     # eq.(4): stash -> pinned host
    weight_stream: bool = False     # EPS: stacked layers live in pinned host
    # --- storage-tier EPS (HBM <- pinned host <- disk) -------------------
    tiers: int = 2
    host_budget_bytes: int = 0
    tier_dir: str = ""
    tier_retries: int = 3
    tier_backoff_s: float = 0.01
    # --- constant-memory stash (every-K boundary checkpointing) ----------
    stash_every: int = 1
    segment_scan: bool = True
    # --- runtime-dynamic depth -------------------------------------------
    dynamic_depth: bool = False
    # --- relay pipelining: k slots whose copies are issued k stops ahead
    # of their consumer (0 = fetch at the top of the consuming stop)
    prefetch_depth: int = 0
    # --- layer-group scheduling: G stacked layers per relay stop ---------
    layers_per_relay: int = 1
    # --- relay transport --------------------------------------------------
    # The two values keep the reference's names.  In the port a fetch from
    # a pinned-host stream always goes through the relay-copy kernel (K4);
    # a device-resident stream is sliced as a view under "xla" and copied
    # through K4 under "pallas".  Bit-identical either way.
    transport: str = "xla"
    # --- packed relay: one flat buffer per dtype per layer ---------------
    pack_params: bool = False
    # --- L2L-p ----------------------------------------------------------
    eager_optimizer: bool = True    # Alg 4 (False = Alg 3)
    host_optimizer: bool = False
    # --- gradient clipping ----------------------------------------------
    clip_mode: str = "none"         # none | per_layer
    clip_norm: float = 1.0
    # --- anomaly sentinel -------------------------------------------------
    skip_nonfinite: bool = False
    # --- mixed precision --------------------------------------------------
    loss_scale_init: float = 0.0
    loss_scale_growth: int = 200
    # --- baseline-only ----------------------------------------------------
    remat: bool = False
    # --- serving ---------------------------------------------------------
    decode_window: int = 0          # ring-buffer window (0 = full cache)
    # --- analysis ---------------------------------------------------------
    unroll_layers: bool = False

    def __post_init__(self):
        assert self.n_microbatches >= 1
        assert self.clip_mode in ("none", "per_layer")
        assert self.prefetch_depth >= 0, \
            "prefetch_depth: k in-flight relay slots (0 = no pipelining)"
        assert self.layers_per_relay >= 1, \
            "layers_per_relay: G >= 1 layers moved per relay stop"
        assert self.transport in ("xla", "pallas"), \
            "transport: 'xla' (device_put at scan boundaries) or " \
            "'pallas' (double-buffered DMA copy kernel)"
        assert self.stash_every >= 1, \
            "stash_every: K >= 1 layers per stashed boundary " \
            "(1 = stash every layer boundary)"
        assert self.segment_scan or not self.dynamic_depth, \
            "dynamic_depth needs the segment-scan driver (a traced " \
            "depth cannot gate unrolled per-segment programs)"
        assert self.tiers in (2, 3), \
            "tiers: 2 = HBM <- pinned host, 3 = + mmap/NVMe segment store"
        assert self.host_budget_bytes >= 0
        assert self.tier_retries >= 0
        assert self.tier_backoff_s >= 0.0
