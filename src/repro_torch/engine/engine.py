"""The Engine facade — the public way to run a schedule (the port of
``repro/engine/engine.py``)::

    from repro_torch import engine as engines

    eng = engines.create("l2l", get_config("granite-3-8b"), ExecutionConfig(
        weight_stream=True, pack_params=True, prefetch_depth=1))
    params = eng.init_params(torch.Generator("cuda").manual_seed(0))
    caches, logits = eng.decode_init(params, prompt, live_seq=32)
    logits, caches = eng.decode_step(params, caches, token, cur_pos=16)
    srv = eng.serve_session(params, ServeConfig(max_batch=8, max_seq=384))
    srv.submit(prompt_ids, max_new=16); done = srv.run()

    eng = engines.create("l2l-p", get_config("bert-large"), ExecutionConfig(
        n_microbatches=4, weight_stream=True, pack_params=True,
        prefetch_depth=1, transport="pallas", offload_stash=True))
    state = eng.init(torch.Generator("cuda").manual_seed(0))
    state, metrics = eng.train_step(state, batch)
    loss, grads = eng.grads(state, batch)
    eng.save("ckpts", state)                      # ckpts/ckpt_<step>/
    state, step = eng.restore("ckpts")            # newest good snapshot

Registered schedules: ``baseline`` (Alg 1/2), ``l2l`` (Alg 3, trailing
update), ``l2l-p`` (Alg 4, eager per-layer update).  An Engine runs on
``cuda`` unless it is built with ``device="cpu"``; on a machine without a
card it raises instead of moving to the CPU.  The optimizer defaults to
``adam()``; with ``host_optimizer`` its layer updates run on the host
over the pinned rows (``core.host_opt``).  With ``dynamic_depth``,
``train_step``, ``grads``, ``prefill``, ``decode_init`` and
``decode_step`` take ``n_layers``, the run depth (default: the
capacity); the layers past it are not fetched and their rows stay as
they were.  A training step is functional: it returns a new state and
leaves the one it was given as it was.  When it returns, the compute
stream has been ordered behind the step's last fetch and write-back (each
on its own stream); a host reader of the pinned rows synchronizes first
(``save`` does).  Snapshots (``checkpoint.io``) are the unpacked per-leaf
trees of the reference, so the two packages restore each other's.

With ``tiers=3`` the EPS gains the disk tier (``tier``, a
``core.tierstore.TierChain`` over a verified segment store in
``tier_dir``, a fresh temporary directory when it is empty): ``init`` and
``restore`` adopt the state (the cold rows of each group go to the store
under ``host_budget_bytes``, a ``Demoted`` placeholder keeps the hot
rows), ``train_step`` stages the demoted rows in before the step and out
after it, ``save`` stages in and makes its directory the store's rebuild
source, and ``grads``, ``prefill``, ``decode_init``, ``decode_step`` and
``serve_session`` read them back read-only (once per staged-out state,
the weights alone).  The groups' pinned rows are then blocks of their own
(``core.eps.pinned_empty``), so the host memory a staged-out state frees
goes back to the system.  Results are the ``tiers=2`` results bit for
bit.

On a mesh (``mesh=``, a ``torch.distributed.device_mesh.DeviceMesh`` of
the initialized world, ``launch.mesh``) the Engine runs the mesh's data
axes ("pod" x "data"), one process a rank: each entry point takes this
rank's rows of the batch (``local_rows``) and
returns this rank's outputs.  ``rules`` default to
``make_rules(cfg, mesh, kind="train")`` and the placements carry their
pspecs (``engine.placement.placements_for``).  ``train_step`` and
``grads`` sum over the data axes (``core.l2l``, ``core.baseline``: each
layer's gradient once, the static tree once, the loss weight and the
loss), so their loss, grad norm, weight sum and new state are the global
batch's on every rank; their metrics count the all-reduces and bytes.
``init`` and ``restore`` check by checksum that every rank holds the same
state.

A "model" axis over 1 runs every family tensor parallel
(``distributed.tensor_parallel``): each rank holds and relays its blocks
of the heads (MLA's, whisper's encoder, decoder and cross-attention
heads too), ffn columns, experts (or, where the experts do not divide,
their columns), mamba's channels, RWKV's heads and (where it divides)
vocabulary, the model's own autograd sums over the model group, the
norms and finite flags agree over it, ``prefill`` and the decode calls
return the whole logits, and the decode caches hold the rank's kv heads
(MLA's latent whole; whisper's cross-attention K/V too), mamba channels
and RWKV heads.  internvl2's patch projection and whisper's
``enc_ln_post`` stay whole on every rank.  ``init`` draws every leaf
whole and keeps the rank's block; ``init`` and ``restore`` also check
that the leaves no pspec splits agree over the model group; ``save``
gathers and rank 0 writes the meshless snapshot; ``restore`` slices.
With ``pack_params`` the packed rows stay whole on every model rank
(the reference's placements) and only the embedding and head split.
Metrics count the model group's collectives.

A MoE config on more than one data rank forms the router's statistics
and its capacity dispatch over the data group (``models.moe``): each
call's rows are the rank's block of the reference's call, each
microbatch of ``train_step``, ``grads`` and ``prefill`` included
(``local_rows(batch, entry)`` cuts a global batch so for each entry
point), and ``train_step``'s metrics count the MoE's own collectives
apart.  ``serve_session`` on a mesh of more than one rank raises
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.base import ModelConfig
from repro_torch.core import baseline as _baseline
from repro_torch.core import decode as _decode, l2l as _l2l, packing
from repro_torch.core import tierstore
from repro_torch.core.eps import pinned_empty
from repro_torch.core.memory_model import (MemoryReport, estimate,
                                           estimate_serve)
from repro_torch.core.schedule import ExecutionConfig
from repro_torch.core.tree import tree_map
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.data_parallel import DataParallel
from repro_torch.distributed.tensor_parallel import TensorParallel
from repro_torch.engine.placement import placements_for
from repro_torch.engine.registry import register
from repro_torch.engine.state import TrainState
from repro_torch.kernels import relay_copy
from repro_torch.models.common import is_spec
from repro_torch.models.model import LayeredModel
from repro_torch.optim import Optimizer, adam
from repro_torch.serve.engine import ServeConfig, ServeEngine


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device without a card
    raises (no silent move to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to run on the CPU")
    return device


class Engine:
    """Lifecycle facade over a schedule's relay functions."""
    name = "base"
    memory_mode = "baseline"
    # gradient rows in flight to the host optimizer (Alg 4, host_optimizer)
    grad_ring = 2

    def __init__(self, model, exec_cfg: Optional[ExecutionConfig] = None, *,
                 optimizer: Optional[Optimizer] = None, device="cuda",
                 mesh=None, rules=None, placements=None):
        if isinstance(model, ModelConfig):
            model = LayeredModel(model)
        self.model = model
        self.optimizer = optimizer or adam()
        self.device = resolve_device(device)
        self.exec_cfg = self._normalize_cfg(exec_cfg or ExecutionConfig())
        self.mesh = mesh
        self.rules = rules
        self.dp = None
        self.tp = None
        if mesh is not None:
            if rules is None:
                self.rules = shd.make_rules(model.cfg, mesh, kind="train")
            self.dp = DataParallel(mesh)
            if shd.model_size(mesh) > 1:
                # packed rows are replicated over "model": the layers run
                # whole on every model rank
                self.tp = TensorParallel(
                    mesh, model.cfg, model.param_specs(), self.rules,
                    shard_layers=not self.exec_cfg.pack_params)
            # the MoE's router statistics and dispatch range over the
            # data group's rows
            moe_dp = (self.dp if model.cfg.n_experts and self.dp.world > 1
                      else None)
            if self.tp is not None or moe_dp is not None:
                self.model = model = LayeredModel(model.cfg, tp=self.tp,
                                                  dp=moe_dp)
        self.placements = placements or placements_for(
            model, self.exec_cfg, mesh, self.rules, self.optimizer,
            self.device)
        # one copy stream for every relay pass of this engine, so freed
        # slots are reused instead of allocated anew on a fresh stream; the
        # training passes' write-backs run beside it on a stream of their
        # own
        cuda = self.device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self.writeback_stream = (torch.cuda.Stream(self.device) if cuda
                                 else None)
        self._fns: dict = {}

    def _normalize_cfg(self, exec_cfg: ExecutionConfig) -> ExecutionConfig:
        return exec_cfg

    # -- storage tier (ExecutionConfig.tiers = 3) ---------------------------
    @property
    def tier(self):
        """The live disk tier (``core.tierstore.TierChain``), or None with
        two tiers; built at first use from ``placements.disk``."""
        spec = self.placements.disk
        if spec is None:
            return None
        if "tier" not in self._fns:
            root = spec.directory or tempfile.mkdtemp(prefix="eps-tier-")
            store = tierstore.SegmentStore(root, retries=spec.retries,
                                           backoff_s=spec.backoff_s)
            self._fns["tier"] = tierstore.TierChain(
                store, host_budget=spec.host_budget,
                layers_per_relay=self.exec_cfg.layers_per_relay,
                prefetch_depth=self.exec_cfg.prefetch_depth,
                pin=self.device.type == "cuda")
        return self._fns["tier"]

    def _materialize(self, state_or_params):
        """The params (of a TrainState or as given) with the demoted rows
        read back from the segment store (read-only, cached by the chain
        per staged-out state)."""
        params = getattr(state_or_params, "params", state_or_params)
        tier = self.tier
        return params if tier is None else tier.materialize_params(params)

    # -- parameters ---------------------------------------------------------
    def init_params(self, generator: torch.Generator):
        """Random parameters from ``generator`` (on this engine's device
        type), already in the relay layout: embedding and head on the
        device; each layer group drawn ONE LAYER AT A TIME on the device
        and written into its resting place — pinned host memory when
        ``weight_stream`` on CUDA, packed rows when ``pack_params`` — so a
        model larger than the card initializes without ever being whole on
        it.  The values equal ``model.init_params`` from the same seed; on
        the model axis every leaf is drawn whole and the rank keeps its
        block (``TensorParallel.shard``), the slice of the one-process
        draw."""
        m, dev, tp = self.model, self.device, self.tp
        embed, head = m.init_static(generator, dev)
        if tp is not None:
            embed, head = tp.shard_static(embed, head)
        groups = []
        for gi, g in enumerate(m.groups):
            place = self.placements.weights[gi]
            dest = None
            for li, layer in enumerate(m.init_layers(gi, generator, dev)):
                if tp is not None:
                    layer = tp.shard_layer(gi, layer)
                row = packing.pack(layer, stacked=False) \
                    if self.exec_cfg.pack_params else layer
                if dest is None:
                    dest = tree_map(
                        lambda a: pinned_empty(
                            (g.n_layers,) + tuple(a.shape), a.dtype,
                            place.owned) if place.enabled else torch.empty(
                            (g.n_layers,) + tuple(a.shape), dtype=a.dtype,
                            device=dev), row)
                # K4's write-back, into pinned or device rows
                relay_copy.writeback_slot(
                    tree_map(lambda a: a.contiguous(), row), out=dest,
                    row=li)
            groups.append(dest)
        return {"embed": embed, "head": head, "groups": tuple(groups)}

    def _to_dev(self, tree):
        return tree_map(lambda a: a.to(self.device), tree)

    def _place_params(self, params):
        """Params in the layout and place the relay expects: with
        ``pack_params`` the stacked groups as per-dtype flat rows; the
        groups in their resting place (pinned host when streaming), the
        embedding and head on the device.  Idempotent."""
        if self.tp is not None:
            self.tp.check_local(params, self.model.param_specs())
        p = packing.pack_params(params) if self.exec_cfg.pack_params \
            else params
        return {"embed": self._to_dev(p["embed"]),
                "head": self._to_dev(p["head"]),
                "groups": tuple(self.placements.weights[gi].host(g)
                                for gi, g in enumerate(p["groups"]))}

    def _relay_params(self, params):
        """``_place_params``, cached by object identity: a serving loop
        that passes the same params every token converts them once."""
        cached = self._fns.get("_relay_cache")
        if cached is not None and cached[0] is params:
            return cached[1]
        placed = self._place_params(params)
        self._fns["_relay_cache"] = (params, placed)
        return placed

    # -- training -----------------------------------------------------------
    def _init_opt_legacy(self, params) -> dict:
        return _l2l.init_opt_state(self.optimizer, params, self.exec_cfg)

    def _place_opt(self, opt: dict, params: dict) -> dict:
        """Optimizer state beside its params: packed like them, the group
        slots in their resting place, the rest on the device."""
        if self.exec_cfg.pack_params:
            opt = packing.pack_opt_state(opt, params)
        out = {**opt, "embed": self._to_dev(opt["embed"]),
               "head": self._to_dev(opt["head"]),
               "groups": tuple(self.placements.opts[gi].host(g)
                               for gi, g in enumerate(opt["groups"]))}
        if "loss_scale" in opt:
            out["loss_scale"] = self._to_dev(opt["loss_scale"])
        return out

    def init(self, generator: torch.Generator) -> TrainState:
        """Parameters (``init_params``, in the relay layout and place)
        and zeroed optimizer slots beside them."""
        params = self.init_params(generator)
        state = TrainState.from_legacy(
            params, self._place_opt(self._init_opt_legacy(params), params))
        self.check_replicas(state)
        if self.tier is not None:
            state = self.tier.adopt(state, step=0)
        return state

    def check_replicas(self, state: TrainState):
        """On a mesh: raise unless every data rank holds this state bit for
        bit (weights, optimizer slots: each rank's blocks) and every model
        rank the same leaves where no pspec splits them, checked by
        checksum; returns this rank's ``(weights, slots)`` checksums over
        the data group.  None without a mesh."""
        if self.dp is None:
            return None
        if self.device.type == "cuda":
            # the pinned rows were written by kernels the host did not see
            torch.cuda.synchronize(self.device)
        if self.tp is not None:
            self.tp.check_replicas(state.params, state.legacy_opt())
        return self.dp.check_replicas(state.params, state.opt_state)

    def _begin(self):
        for group in (self.dp, self.tp):
            if group is not None:
                group.begin()

    def _place_state(self, state: TrainState):
        params = self._place_params(state.params)
        return params, self._place_opt(state.legacy_opt(), params)

    def _batch(self, batch):
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    # the entry points that split their rows into microbatches
    # (``core.l2l._reshape_ub``), and those that run a call whole
    _UB_ENTRIES = ("train_step", "grads", "prefill")
    _WHOLE_ENTRIES = ("decode_init", "decode_step")

    def local_rows(self, batch: dict, entry: str) -> dict:
        """This rank's rows of a global ``batch`` (a dict of arrays, the
        batch dim leading) for the entry point ``entry``: the batch as it
        is without a mesh; on a mesh the rank's contiguous block of each
        of the ``n_microbatches`` microbatches for ``train_step``,
        ``grads`` and ``prefill``, and of the whole call for
        ``decode_init`` and ``decode_step``.  So the rank's rows of every
        call a MoE dispatches over the data group are the r-th block of
        the reference's rows of that call (its router statistics, its
        capacity drops and its aux are the global batch's)."""
        if entry in self._UB_ENTRIES:
            ub = self.exec_cfg.n_microbatches
        elif entry in self._WHOLE_ENTRIES:
            ub = 1
        else:
            raise ValueError(f"no entry point {entry!r}: one of "
                             f"{self._UB_ENTRIES + self._WHOLE_ENTRIES}")
        if self.mesh is None:
            return dict(batch)
        return shd.shard_batch(batch, self.mesh, self.rules, ub)

    def _make_step(self):
        return _l2l.make_train_step(self.model, self.optimizer,
                                    self.exec_cfg, self.placements,
                                    self.device, self.copy_stream,
                                    self.writeback_stream,
                                    grad_ring=self.grad_ring, dp=self.dp,
                                    tp=self.tp)

    def _make_grads(self):
        return _l2l.make_grads_fn(self.model, self.exec_cfg, self.placements,
                                  self.device, self.copy_stream,
                                  self.writeback_stream, dp=self.dp,
                                  tp=self.tp)

    def _end_of_step(self):
        if self.copy_stream is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_stream(self.copy_stream)
            compute.wait_stream(self.writeback_stream)

    def _depth(self, n_layers) -> tuple:
        """The run-depth argument of a dynamic-depth call, ``(n,)`` (the
        capacity when ``n_layers`` is None), or ``()`` without
        ``dynamic_depth``, where ``n_layers`` must be None."""
        if not self.exec_cfg.dynamic_depth:
            assert n_layers is None, \
                "n_layers needs ExecutionConfig.dynamic_depth"
            return ()
        cap = sum(g.n_layers for g in self.model.groups)
        n = cap if n_layers is None else int(n_layers)
        assert 0 <= n <= cap, f"n_layers {n} exceeds capacity {cap}"
        return (n,)

    def train_step(self, state: TrainState, batch, n_layers=None):
        """One optimizer step: (state, batch) -> (new state, metrics).  A
        state in another layout or place (unpacked, on the CPU, from
        ``bridge``) is converted first."""
        if "train_step" not in self._fns:
            self._fns["train_step"] = self._make_step()
        depth = self._depth(n_layers)
        tier = self.tier
        if tier is not None:
            state = tier.stage_in(state)
        params, opt = self._place_state(state)
        del state
        self._begin()
        with torch.no_grad():
            new_p, new_o, metrics = self._fns["train_step"](
                params, opt, self._batch(batch), *depth)
        self._end_of_step()
        if self.dp is not None:
            metrics["all_reduces"] = self.dp.calls
            metrics["all_reduce_bytes"] = self.dp.bytes
            if self.model.dp is not None:
                metrics["moe_collectives"] = dict(self.dp.moe_calls)
        if self.tp is not None:
            metrics["model_collectives"] = dict(self.tp.calls)
            metrics["model_collective_bytes"] = sum(self.tp.bytes.values())
        del params, opt
        state = TrainState.from_legacy(new_p, new_o)
        del new_p, new_o
        if tier is not None:
            state = tier.stage_out(state)
        return state, metrics

    def grads(self, state_or_params, batch, n_layers=None):
        """(loss, grads) of the schedule, without an update; grads in the
        unpacked layout (zeros past a run depth)."""
        if "grads" not in self._fns:
            self._fns["grads"] = self._make_grads()
        depth = self._depth(n_layers)
        params = self._materialize(state_or_params)
        self._begin()
        with torch.no_grad():
            out = self._fns["grads"](self._place_params(params),
                                     self._batch(batch), *depth)
        self._end_of_step()
        return out

    # -- checkpoints --------------------------------------------------------
    def state_fingerprint(self) -> str:
        """The on-disk layout a snapshot binds to (arch, depth, width,
        vocab, optimizer); the relay knobs are absent, so snapshots
        interchange across them.  The reference's string, character for
        character."""
        cfg = self.model.cfg
        return (f"{cfg.name}:L{cfg.n_layers}:d{cfg.d_model}:"
                f"v{cfg.vocab_size}:opt={self.optimizer.name}")

    def save(self, directory: str, state: TrainState,
             step: Optional[int] = None, prefix: str = "ckpt",
             keep_last: int = 0) -> str:
        """Write ``state`` as ``<directory>/<prefix>_<step>/`` in the
        unpacked per-leaf layout (packed rows are viewed through their
        PackSpecs), crash-consistently; ``keep_last=N`` prunes all but the
        N newest snapshots.  Waits for the card first: the pinned rows are
        written by kernels the host does not see.  With the disk tier the
        state is staged in whole, and ``directory`` becomes the store's
        rebuild source.

        On a mesh every rank calls it: the split leaves are gathered over
        the model group, and rank 0 alone writes the meshless snapshot of
        the whole state (the same bytes a meshless engine writes); the
        other ranks return its path."""
        if self.tier is not None:
            state = self.tier.stage_in(state)
            self.tier.attach_checkpoints(directory, prefix, self)
        step = int(state.step) if step is None else int(step)
        params, opt = state.params, state.legacy_opt()
        if self.exec_cfg.pack_params:
            opt = packing.unpack_opt_state(opt, params)
            params = packing.unpack_params(params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.tp is not None:
            params, opt = self.tp.gather(params), self.tp.gather(opt)
        opt["step"] = np.asarray(opt["step"], np.int32)
        if self.mesh is not None and torch.distributed.get_rank() != 0:
            return ckpt_io.snapshot_path(directory, step, prefix)
        return ckpt_io.save_train_state(
            directory, params, opt, step, prefix=prefix,
            keep_last=keep_last, fingerprint=self.state_fingerprint())

    def _snapshot_like(self):
        """(params, opt) of the snapshot layout as ``meta`` tensors, from
        the model's ParamSpecs and the optimizer's slots: shapes and dtypes
        with no storage."""
        dt = self.model.param_dtype()
        params = tree_map(lambda s: torch.empty(s.shape, dtype=dt,
                                                device="meta"),
                          self.model.param_specs(), is_leaf=is_spec)
        opt = self._init_opt_legacy(params)
        opt["step"] = torch.empty((), dtype=torch.int32, device="meta")
        return params, opt

    def restore(self, directory: str, step: Optional[int] = None,
                prefix: str = "ckpt"):
        """-> (TrainState, step) from the newest snapshot that verifies
        (crc32 and fingerprint), or ``step``'s; a corrupt newest snapshot
        falls back to the previous good one.  The groups go straight from
        the host copy into their resting place (pinned rows when
        streaming, packed when ``pack_params``); only the embedding and
        head reach the device whole.  On the model axis each rank reads the
        whole snapshot and keeps its blocks."""
        like_p, like_o = self._snapshot_like()
        params, opt, step = ckpt_io.restore_train_state(
            directory, like_p, like_o, step=step, prefix=prefix,
            fingerprint=self.state_fingerprint())
        if self.tp is not None:
            params, opt = self.tp.shard(params), self.tp.shard(opt)
        params = self._place_params(params)
        state = TrainState.from_legacy(params, self._place_opt(opt, params))
        self.check_replicas(state)
        if self.tier is not None:
            state = self.tier.adopt(state, step=step)
            self.tier.attach_checkpoints(directory, prefix, self)
        return state, step

    # -- inference ----------------------------------------------------------
    def prefill(self, params, batch, n_layers=None):
        """Last-token logits (B, vocab) of a prompt batch
        (``{"tokens": (B, S)}``, with ``"patches"`` for internvl2 and
        ``"frames"`` for whisper) under the layer-major relay."""
        if "prefill" not in self._fns:
            self._fns["prefill"] = _l2l.make_prefill_fn(
                self.model, self.exec_cfg, self.placements, self.device,
                self.copy_stream)
        depth = self._depth(n_layers)
        self._begin()
        with torch.inference_mode():
            batch = tree_map(lambda a: a.to(self.device), batch)
            return self._fns["prefill"](
                self._relay_params(self._materialize(params)), batch, *depth)

    def decode_init(self, params, tokens, live_seq: int, frames=None,
                    n_layers=None):
        """Fill the decode caches from a prompt, one token per serve step
        (whisper: ``frames`` (B, n_frames, d) go through the encoder
        first).  Returns (caches, last_logits)."""
        self._depth(n_layers)
        self._begin()
        with torch.inference_mode():
            return _decode.prefill(
                self.model, self._relay_params(self._materialize(params)),
                tokens.to(self.device), live_seq, exec_cfg=self.exec_cfg,
                placements=self.placements, device=self.device,
                copy_stream=self.copy_stream,
                frames=None if frames is None else frames.to(self.device),
                n_layers=n_layers)

    def decode_step(self, params, caches, token, cur_pos, n_layers=None):
        """One decode step: (logits (B, T, V), caches updated in place)."""
        if "decode_step" not in self._fns:
            self._fns["decode_step"] = _decode.make_serve_step(
                self.model, self.exec_cfg, self.placements, self.device,
                self.copy_stream)
        depth = self._depth(n_layers)
        self._begin()
        with torch.inference_mode():
            return self._fns["decode_step"](
                self._relay_params(self._materialize(params)), caches,
                token.to(self.device),
                cur_pos, *depth)


    # -- continuous-batching serve ------------------------------------------
    def serve_session(self, state_or_params, serve_cfg=None, **kw):
        """Open a continuous-batching serve session (``repro_torch.serve``):
        a paged-KV ServeEngine over this engine's model, relay knobs,
        placements and copy stream.  ``serve_cfg`` is a ``ServeConfig``;
        keyword shape knobs (max_batch, page_size, ...) build one when
        omitted::

            srv = eng.serve_session(params, max_batch=8, max_seq=64)
            srv.submit(prompt_ids, max_new=32)
            done = srv.run()
        """
        if shd.data_size(self.mesh) > 1 or shd.model_size(self.mesh) > 1:
            # the reference's serve package reads no mesh
            raise NotImplementedError(
                f"serve_session on a mesh of {shd.mesh_shape(self.mesh)}: "
                "continuous batching runs on one rank (prefill, decode_init "
                "and decode_step run each rank's rows and heads)")
        params = self._materialize(state_or_params)
        if serve_cfg is None:
            serve_cfg = ServeConfig(**kw)
        return ServeEngine(self, params, serve_cfg)

    def serve_memory_estimate(self, serve_cfg, **kw) -> MemoryReport:
        """Analytic serve-mode byte split (paged pool + slot state +
        relay transit) for this engine's knobs at a ServeConfig shape."""
        kw.setdefault("weight_stream", self.exec_cfg.weight_stream)
        kw.setdefault("prefetch_depth", self.exec_cfg.prefetch_depth)
        kw.setdefault("pack_params", self.exec_cfg.pack_params)
        kw.setdefault("layers_per_relay", self.exec_cfg.layers_per_relay)
        kw.setdefault("transport", self.exec_cfg.transport)
        return estimate_serve(
            self.model, max_batch=serve_cfg.max_batch,
            page_size=serve_cfg.page_size, n_pages=serve_cfg.n_pages,
            max_seq=serve_cfg.max_seq,
            prefill_chunk=serve_cfg.prefill_chunk, **kw)

    # -- analysis -----------------------------------------------------------
    def memory_estimate(self, *, batch: int, seq: int,
                        **kw) -> MemoryReport:
        """Analytic two-tier device/EPS byte split (paper eqs. 1-4) for
        this engine's schedule at the given shape."""
        kw.setdefault("n_microbatches", self.exec_cfg.n_microbatches)
        kw.setdefault("offload_stash", self.exec_cfg.offload_stash)
        kw.setdefault("stash_every", self.exec_cfg.stash_every)
        kw.setdefault("segment_scan", self.exec_cfg.segment_scan)
        kw.setdefault("prefetch_depth", self.exec_cfg.prefetch_depth)
        kw.setdefault("pack_params", self.exec_cfg.pack_params)
        kw.setdefault("layers_per_relay", self.exec_cfg.layers_per_relay)
        kw.setdefault("tiers", self.exec_cfg.tiers)
        kw.setdefault("host_budget", self.exec_cfg.host_budget_bytes)
        kw.setdefault("transport", self.exec_cfg.transport)
        return estimate(self.model, batch=batch, seq=seq,
                        mode=self.memory_mode, **kw)


@register("baseline")
class BaselineEngine(Engine):
    """Algorithms 1/2: conventional execution, the whole model on the
    device; Alg 2 (gradient accumulation) when ``n_microbatches > 1``."""
    name = "baseline"

    @property
    def memory_mode(self):
        return "baseline_remat" if self.exec_cfg.remat else "baseline"

    def _normalize_cfg(self, exec_cfg):
        # no relay: the packed layout, the copy transport, the EPS (and
        # its host optimizer) and the relay's run-depth gate are L2L
        # concerns
        return dataclasses.replace(exec_cfg, pack_params=False,
                                   transport="xla", weight_stream=False,
                                   offload_stash=False, dynamic_depth=False,
                                   host_optimizer=False)

    def init_params(self, generator: torch.Generator):
        params = self.model.init_params(generator, self.device)
        return params if self.tp is None else self.tp.shard(params)

    def _init_opt_legacy(self, params):
        return _baseline.init_opt_state(self.optimizer, params)

    def _make_step(self):
        return _baseline.make_train_step(self.model, self.optimizer,
                                         self.exec_cfg, dp=self.dp,
                                         tp=self.tp)

    def _make_grads(self):
        return _baseline.make_grads_fn(self.model, self.exec_cfg,
                                       dp=self.dp)


@register("l2l")
class L2LEngine(Engine):
    """Algorithm 3: layer-major relay, gradients shipped to the EPS and
    applied in a trailing relay; serves exactly as ``l2l-p``."""
    name = "l2l"
    memory_mode = "l2l"

    def _normalize_cfg(self, exec_cfg):
        return dataclasses.replace(exec_cfg, eager_optimizer=False)


@register("l2l-p")
class L2LPEngine(Engine):
    """Algorithm 4 (L2L-p): the optimizer for layer l runs inside the
    reverse relay; serves exactly as ``l2l``."""
    name = "l2l-p"
    memory_mode = "l2l_p"

    def _normalize_cfg(self, exec_cfg):
        return dataclasses.replace(exec_cfg, eager_optimizer=True)
