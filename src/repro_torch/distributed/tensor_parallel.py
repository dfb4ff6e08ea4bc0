"""The mesh's "model" axis: Megatron-style tensor parallelism derived from
the leaves' pspecs.

The reference runs the model axis through GSPMD with no explicit
tensor-parallel code (``make_rules`` maps ``heads``, ``kv``, ``ffn`` and
``vocab`` onto "model"); whatever the partitioner does, the program
computes the unsharded function.  The port computes that function with
explicit collectives over the model group (the ranks that share every
other mesh coordinate).  Rank r holds the r-th contiguous block of every
dim a pspec puts on "model" (``distributed.sharding.shard_leaf``):

* attention: ``wq`` / ``bq`` (and ``wk`` / ``wv`` / ``bk`` / ``bv`` when
  the kv heads divide) are column-parallel, ``wo`` row-parallel; when the
  kv heads do not divide, the kv leaves stay whole and rank r uses the kv
  heads its q heads map to (``kv_block``).  ``bo`` is added once, after
  the sum;
* MLP: ``w_in`` / ``w_gate`` / ``b_in`` column-parallel, ``w_out``
  row-parallel, ``b_out`` added once;
* mamba (``models.ssm``, hymba's SSM branch), on ``ffn``: rank r holds
  the r-th block of the ``dI`` channels of ``conv``, ``w_dt``,
  ``dt_bias``, ``a_log``, ``d_skip``, the rows of ``w_bcdt`` and
  ``w_out``, and the r-th contiguous block of ``w_in``'s ``[x | z]``
  columns (at M = 2 all of x on rank 0, all of z on rank 1): the
  projection is gathered whole (``gather_split``) and each rank takes its
  channels of x and of z.  ``w_bcdt``'s product is summed over the group
  and passes ``copy_in``: B, C and dt feed every rank's channels;
* RWKV-6 (``models.ssm``): ``w_r`` / ``w_k`` / ``w_v`` / ``w_g``
  column-parallel and ``w_o`` row-parallel on ``heads_x_dim``, ``u`` on
  ``heads`` (the channel block is whole heads, so the per-head groupnorm
  stays local), the channel mix on ``ffn``; the decay and ``ln_scale``
  are whole and rank r uses its channels of them through ``copy_in``;
* MoE (``models.moe``): with ``experts`` on "model" (expert
  parallelism, E divisible by M) rank r holds experts
  ``[r E/M, (r+1) E/M)`` (``expert_block``) and the router's matching
  columns; the whole logits are gathered (``gather_last``), every rank
  routes alike, runs its experts only and the combine is summed over the
  group.  With ``expert_ffn`` on "model" instead (E not divisible) the
  experts' ``w_gate`` / ``w_in`` are column-parallel, ``w_out``
  row-parallel, and the router stays whole;
* vocabulary (when it divides): a masked local embedding lookup summed
  over the group, local logits, a vocab-parallel cross-entropy
  (``xent``), the whole logits gathered for serving;
* everything on ``d_model`` (norms, residuals) replicated, the same bits
  on every rank.

The collectives sit in three ``torch.autograd.Function``s: ``copy_in``
(identity forward, sum backward) at a column-parallel input, ``reduce``
(sum forward, identity backward) at a row-parallel output and
``gather_last`` (gather forward, slice backward) for the logits, so the
per-layer vjp of the relay, the baseline's autograd and the recompute all
reduce where they must with no special case.  Each call is counted with
its kind, its bytes (the payload one rank contributes) and its time (CUDA
events on the current stream, read after a synchronize; else the host's
clock): ``begin()`` zeroes the counts, ``stats()`` reads them.

With ``pack_params`` the packed rows are replicated over "model", as the
reference's placements make them: the layers run whole on every model
rank (``shard_layers=False``) and only the embedding and head keep their
rules' shards.
"""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from repro_torch.core.tree import (tree_flatten_up_to, tree_leaves,
                                   tree_map, tree_unflatten_like)
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import is_pspec

KINDS = ("sum", "max", "gather")


class TensorParallel:
    """One rank of the mesh's model axis: its group, which dims of the
    model it splits, and the counted collectives over the group.

    ``param_specs`` is the model's whole ParamSpec tree (``LayeredModel.
    param_specs()``); ``rules`` the sharding rules.  ``shard_layers``
    False (the packed relay) keeps every layer leaf whole."""

    def __init__(self, mesh, cfg, param_specs, rules, *,
                 shard_layers: bool = True):
        self.mesh = mesh
        self.size = shd.model_size(mesh)
        self.rank = shd.model_index(mesh)
        self.group = mesh.get_group("model")
        on = lambda ax: rules.get(ax) == "model"
        self.vocab = on("vocab")
        self.heads = shard_layers and on("heads")
        self.kv = shard_layers and on("kv")
        self.ffn = shard_layers and on("ffn")
        self.heads_x_dim = shard_layers and on("heads_x_dim")
        self.experts = shard_layers and on("experts")
        self.expert_ffn = shard_layers and on("expert_ffn")
        self.shard_layers = shard_layers
        self.n_heads, self.n_kv_heads = cfg.n_heads, cfg.n_kv_heads
        self.n_experts = cfg.n_experts
        self.static_pspecs = {
            k: shd.pspec_tree(param_specs[k], rules, mesh)
            for k in ("embed", "head")}
        layer = tuple(
            shd.pspec_tree(tree_map(lambda s: s._replace(
                shape=s.shape[1:], axes=s.axes[1:]), g,
                is_leaf=lambda x: hasattr(x, "axes")), rules, mesh)
            for g in param_specs["groups"])
        if not shard_layers:
            layer = tuple(tree_map(lambda _: shd.P(), p, is_leaf=is_pspec)
                          for p in layer)
        self.layer_pspecs = layer
        self.param_pspecs = {
            **self.static_pspecs,
            "groups": tuple(tree_map(shd.stacked_pspec, p, is_leaf=is_pspec)
                            for p in layer)}
        if self.heads and not self.kv:
            self.kv_block()              # raises on a mapping it cannot cut
        if cfg.family == "ssm" and self.heads != self.heads_x_dim:
            raise NotImplementedError(
                f"{cfg.rwkv_heads} RWKV heads of width {cfg.rwkv_head_dim} "
                f"over {self.size} model ranks: the heads and their "
                "channels must split alike")
        self._check_splits(param_specs["groups"], rules)
        self.begin()

    def _check_splits(self, group_specs, rules):
        """Raise unless every layer leaf on a logical axis this rank
        splits (``heads``, ``kv``, ``ffn``, ``heads_x_dim``, ``experts``,
        ``expert_ffn``) is split: the model functions read the flags, not
        the leaves' shapes, so a dim the axis does not divide cannot stay
        whole."""
        split = {ax for ax in ("heads", "kv", "ffn", "heads_x_dim",
                               "experts", "expert_ffn") if getattr(self, ax)}
        for g, p in zip(group_specs, self.layer_pspecs):
            for s, ps in zip(tree_leaves(g, is_leaf=lambda x: hasattr(
                    x, "axes")), tree_leaves(p, is_leaf=is_pspec)):
                axes = s.axes[1:]
                for i, ax in enumerate(axes):
                    if ax in split and (i >= len(ps) or ps[i] is None):
                        raise NotImplementedError(
                            f"a leaf of shape {tuple(s.shape[1:])} on "
                            f"{axes}: its {ax!r} dim {s.shape[1 + i]} does "
                            f"not split over {self.size} model ranks")

    # -- accounting ---------------------------------------------------------
    def begin(self):
        """Zero the counts and timers (the start of a call)."""
        self.calls = dict.fromkeys(KINDS, 0)
        self.bytes = dict.fromkeys(KINDS, 0)
        self._events = []
        self._host_s = 0.0

    def stats(self) -> dict:
        """Collectives by kind, bytes and milliseconds since ``begin``; the
        device time is read from the events, so call this after a
        synchronize."""
        ms = self._host_s * 1e3
        for a, b in self._events:
            b.synchronize()
            ms += a.elapsed_time(b)
        return {"model_collectives": dict(self.calls),
                "model_collective_bytes": sum(self.bytes.values()),
                "model_collective_ms": ms}

    def _counted(self, kind, t, fn):
        self.calls[kind] += 1
        self.bytes[kind] += t.numel() * t.element_size()
        if t.device.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn()
            ev[1].record()
            self._events.append(ev)
            return out
        t0 = time.perf_counter()
        out = fn()
        self._host_s += time.perf_counter() - t0
        return out

    # -- collectives --------------------------------------------------------
    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (or maxed) over the model group, in place."""
        import torch.distributed as dist
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        self._counted(op, t, lambda: dist.all_reduce(t, op=red,
                                                     group=self.group))
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        import torch.distributed as dist
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        self._counted("gather", t, lambda: dist.all_gather(
            parts, t, group=self.group))
        return torch.cat(parts, dim=dim)

    def copy_in(self, x):
        """Identity forward, sum over the group backward: the input of a
        column-parallel product (or a whole leaf a rank uses a block of)."""
        return _CopyIn.apply(x, self)

    def reduce(self, x):
        """Sum over the group forward, identity backward: the output of a
        row-parallel product."""
        return _Reduce.apply(x, self)

    def gather_last(self, x):
        """The last dim gathered over the group forward, this rank's block
        of the cotangent backward: the whole logits."""
        return _GatherLast.apply(x, self)

    def gather_split(self, x):
        """The last dim gathered over the group forward; backward, the
        cotangent summed over the group, then this rank's block (a
        reduce-scatter, as one all-reduce and a slice): the whole output
        of a column-parallel product that every rank reads a part of
        (mamba's ``[x | z]``, whose rank-r block is not rank r's
        channels).  One gather forward, one sum backward."""
        return self.copy_in(self.gather_last(x))

    def channel_block(self, n: int) -> tuple:
        """``(lo, hi)``: this rank's contiguous block of an ``n``-sized
        channel dim split over the group."""
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    # -- attention ----------------------------------------------------------
    def kv_block(self) -> tuple:
        """``(lo, hi)``: the kv heads this rank's q heads
        ``[r H/M, (r+1) H/M)`` map to (q head h reads kv head
        ``h // (H / KV)``) when the kv heads stay whole.  The local q heads
        must split evenly over them (each reads one kv head, or each kv
        head serves whole groups), so the kernels see a uniform GQA."""
        H, KV = self.n_heads, self.n_kv_heads
        hl, g = H // self.size, H // KV
        if hl % g and g % hl:
            raise NotImplementedError(
                f"{H} q heads over {self.size} model ranks with {KV} whole "
                "kv heads: a rank's q heads do not map onto its kv heads "
                "in equal groups")
        lo = self.rank * hl // g
        hi = ((self.rank + 1) * hl - 1) // g + 1
        return lo, hi

    # -- experts ------------------------------------------------------------
    def expert_block(self) -> tuple:
        """``(lo, hi)``: the experts this rank holds and runs (all of them
        unless the experts are split over the group)."""
        if not self.experts:
            return 0, self.n_experts
        per = self.n_experts // self.size
        return self.rank * per, (self.rank + 1) * per

    def local_kv_heads(self) -> int:
        """The kv heads one rank computes with (its cache's kv dim)."""
        if self.kv:
            return self.n_kv_heads // self.size
        if self.heads:
            lo, hi = self.kv_block()
            return hi - lo
        return self.n_kv_heads

    # -- vocabulary ---------------------------------------------------------
    def embed(self, tok_local, tokens, dtype):
        """The vocab-parallel lookup: this rank's rows of the table for the
        tokens it owns, zeros for the others, summed over the group."""
        vl = tok_local.shape[0]
        local = tokens.long() - self.rank * vl
        inside = (local >= 0) & (local < vl)
        rows = F.embedding(local.clamp(0, vl - 1), tok_local).to(dtype)
        return self.reduce(torch.where(inside[..., None], rows,
                                       torch.zeros((), dtype=dtype,
                                                   device=rows.device)))

    def xent(self, logits_local, targets, mask):
        """The vocab-parallel cross-entropy of local logits:
        -> (loss_sum, weight_sum), as ``models.common.softmax_xent``."""
        return _VocabXent.apply(logits_local.float(), targets, mask,
                                self), mask.sum()

    # -- norms and flags ----------------------------------------------------
    def norm_sq(self, tree, pspecs) -> torch.Tensor:
        """The squared global norm of a tree laid out as ``pspecs``: the
        squares of the split leaves summed over the group (one
        collective), each whole leaf counted once."""
        sq = {True: [], False: []}
        for p, sub in zip(tree_leaves(pspecs, is_leaf=is_pspec),
                          tree_flatten_up_to(pspecs, tree, is_pspec)):
            sq[shd.is_split_over(p)] += [torch.sum(torch.square(a.float()))
                                         for a in tree_leaves(sub)]
        whole = sum(sq[False])
        if not sq[True]:
            return whole
        part = sum(sq[True]).reshape(1).clone()
        return whole + self.all_reduce_(part)[0]

    def all_true(self, flag: torch.Tensor) -> torch.Tensor:
        """A boolean flag agreed over the group (every rank's true)."""
        bad = (~flag).to(torch.int32).reshape(1)
        return self.all_reduce_(bad, "max")[0] == 0

    # -- trees --------------------------------------------------------------
    def _map(self, fn, tree, pspecs):
        """``fn(leaf, pspec)`` over a param-shaped ``tree`` (or a state tree
        whose leaves are slot dicts: each slot takes its param's pspec).
        A packed group (layers whole) passes through."""
        flat_p = tree_leaves(pspecs, is_leaf=is_pspec)
        subs = tree_flatten_up_to(pspecs, tree, is_pspec)
        out = [tree_map(lambda a, _p=p: fn(a, _p), t)
               for p, t in zip(flat_p, subs)]
        return tree_unflatten_like(pspecs, out, is_leaf=is_pspec)

    def shard_layer(self, gi: int, layer):
        """This rank's blocks of one whole layer of group ``gi``."""
        return self._map(lambda a, p: shd.shard_leaf(a, p, self.mesh)
                         .contiguous(), layer, self.layer_pspecs[gi])

    def shard_static(self, embed, head):
        """This rank's blocks of the whole embedding and head trees."""
        return tuple(self._map(lambda a, p: shd.shard_leaf(a, p, self.mesh)
                               .contiguous(), t, self.static_pspecs[k])
                     for k, t in (("embed", embed), ("head", head)))

    def check_local(self, params, specs):
        """Raise unless ``params`` holds this rank's blocks: every leaf of
        the embedding, head and unpacked groups at its local shape under
        the whole model's ``specs`` (a whole tree given to a sharded
        engine goes through ``shard`` first)."""
        from repro_torch.core import packing
        is_spec = lambda x: hasattr(x, "axes")
        pairs = [(k, params[k], specs[k], self.param_pspecs[k])
                 for k in ("embed", "head")]
        pairs += [(f"groups/{i}", g, s, p) for i, (g, s, p) in enumerate(
            zip(params["groups"], specs["groups"],
                self.param_pspecs["groups"])) if not packing.is_packed(g)]
        for name, tree, spec, pspec in pairs:
            for s, p, a in zip(tree_leaves(spec, is_leaf=is_spec),
                               tree_leaves(pspec, is_leaf=is_pspec),
                               tree_leaves(tree)):
                want = shd.local_shape(s.shape, p, self.mesh)
                if tuple(a.shape) != want:
                    raise ValueError(
                        f"{name}: a leaf of shape {tuple(a.shape)} where "
                        f"model rank {self.rank} holds {want} of "
                        f"{tuple(s.shape)} ({p}): shard whole trees with "
                        "TensorParallel.shard")

    def _tree_pspecs(self, tree):
        """The pspec tree of a params-shaped ``{"embed", "head", "groups"}``
        tree; a packed group's pspecs are its whole rows."""
        from repro_torch.core import packing
        groups = tuple(shd.P() if packing.is_packed(g) else p
                       for g, p in zip(tree["groups"],
                                       self.param_pspecs["groups"]))
        return {"embed": self.param_pspecs["embed"],
                "head": self.param_pspecs["head"], "groups": groups}

    def shard(self, tree):
        """This rank's blocks of a whole params-shaped tree (params, their
        gradients, or the optimizer's ``{"embed", "head", "groups"}``
        slots), as contiguous copies."""
        sub = {k: tree[k] for k in ("embed", "head", "groups")}
        out = self._map(lambda a, p: shd.shard_leaf(a, p, self.mesh)
                        .contiguous(), sub, self._tree_pspecs(sub))
        return {**tree, **out}

    def gather(self, tree):
        """The whole tree of this rank's blocks (every rank calls it: one
        all-gather per split leaf, in flatten order)."""
        sub = {k: tree[k] for k in ("embed", "head", "groups")}

        def one(a, p):
            for dim, entry in enumerate(p):
                if entry is not None:
                    assert entry == "model", p
                    return self.all_gather(a, dim)
            return a
        out = self._map(one, sub, self._tree_pspecs(sub))
        return {**tree, **out}

    def whole_leaves(self, tree) -> list:
        """The leaves of a params- or slots-shaped tree that no pspec
        splits (the same on every model rank)."""
        sub = {k: tree[k] for k in ("embed", "head", "groups")}
        pspecs = self._tree_pspecs(sub)
        return [t for p, t in zip(tree_leaves(pspecs, is_leaf=is_pspec),
                                  tree_flatten_up_to(pspecs, sub, is_pspec))
                if not shd.is_split_over(p)]

    def gather_checksums(self, *trees) -> list:
        """``[rank][tree]`` checksums of the given trees over the model
        group, in rank order (over a CPU tensor for gloo)."""
        import torch.distributed as dist
        from repro_torch.distributed.data_parallel import tree_checksum
        nccl = dist.get_backend(self.group) == "nccl"
        mine = torch.tensor([tree_checksum(t) for t in trees],
                            dtype=torch.int64,
                            device="cuda" if nccl else "cpu")
        got = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(got, mine, group=self.group)
        return [[int(x) for x in g] for g in got]

    def check_replicas(self, params, opt_state) -> list:
        """Raise unless every model rank holds the same bits in the leaves
        no pspec splits (weights and their optimizer slots); returns this
        rank's checksums."""
        every = self.gather_checksums(self.whole_leaves(params),
                                      self.whole_leaves(opt_state))
        if any(row != every[0] for row in every):
            raise RuntimeError(
                f"model ranks hold different replicated leaves: checksums "
                f"{every} (rank order)")
        return every[self.rank]


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce_(g.contiguous().clone()), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[-1]
        return tp.all_gather(x, x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.tp.rank, ctx.n
        return g[..., r * n:(r + 1) * n], None


class _VocabXent(torch.autograd.Function):
    """Cross-entropy over vocab-parallel f32 logits (B, S, V/M) -> the
    masked loss sum.  The forward takes the max over the group, then the
    sum of exponentials and the gold logit (from its owning rank) in one
    collective; the backward is local: (softmax - onehot) · mask."""

    @staticmethod
    def forward(ctx, logits, targets, mask, tp):
        vl = logits.shape[-1]
        m = tp.all_reduce_(logits.amax(-1).contiguous(), "max")
        e = torch.exp(logits - m[..., None])
        local = targets.long() - tp.rank * vl
        inside = (local >= 0) & (local < vl)
        idx = local.clamp(0, vl - 1)
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        both = tp.all_reduce_(torch.stack(
            [e.sum(-1), torch.where(inside, gold, torch.zeros_like(gold))]))
        lse = torch.log(both[0]) + m
        nll = (lse - both[1]) * mask
        ctx.save_for_backward(e, both[0], idx, inside, mask)
        return nll.sum()

    @staticmethod
    def backward(ctx, g):
        e, s, idx, inside, mask = ctx.saved_tensors
        p = e / s[..., None]
        p = p.scatter_add(-1, idx[..., None],
                          -inside[..., None].to(p.dtype))
        return p * (mask * g)[..., None].to(p.dtype), None, None, None
