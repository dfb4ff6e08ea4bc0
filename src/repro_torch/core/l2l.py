"""L2L (layer-to-layer) execution — Algorithms 3 and 4 of the paper (the
port of ``repro/core/l2l.py``).

The loop inversion is the whole trick: the LAYER loop is outer, the
MICROBATCH loop inner.  The outer loop is a ``relay_scan`` over the
group's stacked ``(N, ...)`` parameters, which rest in pinned host memory
with ``weight_stream`` and reach HBM one relay stop at a time.

Forward (Alg 3 lines 2-6): for l in layers: for u in microbatches: run
layer l on microbatch u; stash ONLY the layer-boundary activation, into
pinned host memory with ``offload_stash`` (eq. (4), constant memory),
through K4's write-back.

Head: per microbatch, the loss and its vjp scaled by ``S_loss / W_total``.

Backward (Alg 3 lines 7-11 / Alg 4): a reverse relay over layers; per
microbatch, RECOMPUTE the layer's forward from its stashed input and take
its vjp — ``torch.autograd.grad`` on detached leaf views of the relayed
slot takes the place of ``jax.vjp`` — and accumulate (dw, dx).  With
``eager_optimizer`` (Alg 4, L2L-p) the optimizer for layer l runs in the
same reverse stop and its products (updated weights, Adam slots) are
written back to the EPS row by row; otherwise (Alg 3) the gradients are
shipped to the EPS and a trailing relay applies the updates.

``stash_every`` = K > 1 stores only each K-segment's entry boundary; the
backward re-streams each segment's weights forward to recompute the K-1
missing boundaries (re-hosted into the stash tier as they are produced)
and then runs the segment's recompute-vjp relay.  In eager PyTorch the
reference's unrolled and ``segment_scan`` schedules are one Python loop
over the segments.  Every (G, k, pack, K, transport) point gives
bit-identical gradients and updates (tests/test_torch_train.py).

Packed relay (``pack_params``): weights and Adam slots arrive as
``packing.Packed`` flat rows; the vjp differentiates the unpacked views,
every gradient-side reduction (scale, clip, finiteness) stays on the
tree, and the eager update runs once per dtype segment through
``Optimizer.flat_update`` (the fused Adam kernel, K1).

The step is functional, as the reference's is: it returns new parameter
and optimizer buffers (new pinned rows for the EPS) and leaves its inputs
as they were, so a caller may keep the prior state (``skip_nonfinite``
returns it as it was).  The host's caching allocator recycles the
buffers of states the caller drops, so the EPS takes twice its size in
pinned memory at the peak.

Dynamic depth (``dynamic_depth``): the step takes the run depth n as an
int; every relay gets the window ``(0, n)`` (with K > 1 each segment
``(0, clip(n - s0, 0, K))``, as the reference's ``segment_scan`` gives
it), and the layers past n are neither fetched nor run.  Their rows of
the new weights and optimizer slots are the input rows, carried over bit
for bit; Algorithm 3's gradient rows there are zeros.  The host writes
those rows right after a synchronize at the step's start, where no
kernel reads them.

The optimizer on the host (``host_optimizer``, ``core.host_opt``): the
reverse relay fetches only the weights, each layer's gradient goes back
to a pinned ring row and a worker thread applies the update to the
layer's rows on the CPU while the device runs the next layer's backward
(Algorithm 4); under Algorithm 3 the trailing update is a host loop over
the gradient rows.  The step joins every update before it returns.

Layer groups (deepseek's dense layer 0, then its MoE layers; whisper's
encoder, then its decoder): the forward runs group by group, each
group's input saved for the vjp of the ``transition`` into it; the
backward walks the groups in reverse, each with its own placements,
optimizer slots, stash segments and sinks, and the transition's vjp
carries dx back (the static params take its share: none for the
identity).  A layer's vjp differentiates its ``(y, aux)`` with the
cotangent ``(dx, S_loss / UB)``, so the MoE router's load-balance loss
reaches its gradient.

Cross-attention memory (``has_mem``, whisper's decoder): the
transition makes the group's memory per microbatch (the encoder's
output through ``enc_ln_post``), which every layer of the group reads
beside its input.  The backward takes each layer's vjp with
respect to (w, x, mem) and sums ``dmem`` over the group's layers, in
reverse layer order on every knob point (no atomics: the knob grid stays
bitwise); the stash's boundary recompute reads the same memory.  The
transition's vjp then carries ``dmem`` through ``transition_mem`` into
the encoder's last output (dx) and ``enc_ln_post``'s gradient.

The disk tier (``tiers=3``) is invisible here, as in the reference: the
Engine's ``core.tierstore.TierChain`` re-materializes the demoted rows
before a step and writes them back after it.  ``dynamic_depth`` over
more than one group asserts (as the reference).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import packing
from repro_torch.core.eps import EPSPlacements, make_placements, \
    pinned_empty
from repro_torch.core.host_opt import HostOptimizer
from repro_torch.core.relay import Sink, Stream, depth_window, relay_scan
from repro_torch.core.schedule import ExecutionConfig
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten_like
from repro_torch.distributed.sharding import is_pspec, is_split_over
from repro_torch.kernels import relay_copy
from repro_torch.optim import Optimizer, clip_by_norm, tree_global_norm


def _reshape_ub(tree, ub: int):
    def one(a):
        assert a.shape[0] % ub == 0, \
            f"batch {a.shape[0]} not divisible by n_microbatches {ub}"
        return a.reshape(ub, a.shape[0] // ub, *a.shape[1:])
    return tree_map(one, tree)


def _tree_add(a, b):
    return tree_map(torch.add, a, b)


def _zeros_f32(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def _rows(tree, s0: int, s1: int):
    return tree_map(lambda a: a[s0:s1], tree)


def segment_bounds(n_layers: int, every: int) -> tuple:
    """``(start, stop)`` layer ranges of the stash segments: boundaries at
    layer indices = 0 (mod K), a short remainder segment at the end."""
    k = max(1, int(every))
    return tuple((s, min(s + k, n_layers)) for s in range(0, n_layers, k))


def _resting(place, like, device, dtype=None, rows=None):
    """An uninitialized stacked tree shaped like ``like`` (``rows`` rows
    when given) where ``place`` keeps a sink's rows: pinned host memory
    when the placement is enabled on CUDA, else ``device``."""
    host = device.type == "cuda" and place.enabled

    def empty(a):
        shape = a.shape if rows is None else (rows,) + tuple(a.shape[1:])
        if host:
            return pinned_empty(shape, dtype or a.dtype, place.owned)
        return torch.empty(shape, dtype=dtype or a.dtype, device=device)
    return tree_map(empty, like)


def _carry_rows(dst, src, n: int):
    """Rows ``[n:]`` of ``dst`` <- those of ``src`` (zeros when None)."""
    if src is None:
        tree_map(lambda d: d[n:].zero_(), dst)
    else:
        tree_map(lambda d, a: d[n:].copy_(a[n:]), dst, src)
    return dst


def _vjp(fn, inputs: list, cotangent, zeros: bool = True):
    """``torch.autograd.grad`` of ``fn(*leaves)`` at detached leaves of
    ``inputs`` -> (output, grads).  ``fn`` returns one tensor, or a tuple
    of outputs with a tuple of cotangents (an output that is not a tensor
    needing grad, as a dense block's aux 0.0, takes none).  An input the
    outputs do not depend on gets zeros (``jax.vjp``'s answer), or None
    with ``zeros=False``."""
    leaves = [a.detach().requires_grad_() for a in inputs]
    with torch.enable_grad():
        out = fn(leaves)
        outs, cots = ((out, cotangent) if isinstance(out, tuple)
                      else ((out,), (cotangent,)))
        pairs = [(o, c) for o, c in zip(outs, cots)
                 if torch.is_tensor(o) and o.requires_grad]
        # no output depends on an input (whisper's prepare reads no
        # parameter): every gradient is absent
        grads = (torch.autograd.grad([o for o, _ in pairs], leaves,
                                     grad_outputs=[c for _, c in pairs],
                                     allow_unused=True)
                 if pairs else [None] * len(leaves))
    if zeros:
        grads = [torch.zeros_like(a) if g is None else g
                 for a, g in zip(leaves, grads)]
    detach = lambda o: o.detach() if torch.is_tensor(o) else o
    out = tuple(map(detach, out)) if isinstance(out, tuple) else detach(out)
    return out, list(grads)


def _finite(tree, tp=None, pspecs=None) -> torch.Tensor:
    """Whether every leaf is finite; on the model axis agreed over the
    group when a pspec splits a leaf (each rank sees its block)."""
    flag = torch.stack([torch.isfinite(g).all()
                        for g in tree_leaves(tree)]).all()
    if tp is not None and any(map(is_split_over, tree_leaves(
            pspecs, is_leaf=is_pspec))):
        flag = tp.all_true(flag)
    return flag


def _where(flag, new, old):
    return tree_map(lambda n, o: torch.where(flag, n, o), new, old)


def _make_packed_update(optimizer: Optimizer, run_opt) -> Callable:
    """Per-layer optimizer step on ``Packed`` flat buffers: the fused
    update once per dtype segment when the optimizer has a
    ``flat_update`` and Adam-shaped slots, else unpack -> per-leaf
    ``run_opt`` -> repack.  Both are bit-identical to the unpacked
    schedule."""
    def packed_update(dw, opt_l, w_pk, step):
        spec = w_pk.spec
        if optimizer.flat_update is not None and \
                tuple(sorted(opt_l)) == ("m", "v"):
            g_pk = dw if packing.is_packed(dw) \
                else packing.pack(dw, spec=spec, stacked=False)
            new_p, new_m, new_v = {}, {}, {}
            for key in sorted(w_pk.segs):
                new_p[key], new_m[key], new_v[key] = optimizer.flat_update(
                    w_pk.segs[key], g_pk.segs[key], opt_l["m"].segs[key],
                    opt_l["v"].segs[key], step)
            return (packing.Packed(new_p, spec),
                    {"m": packing.Packed(new_m, spec),
                     "v": packing.Packed(new_v, spec)})
        dw_t = packing.unpack(dw) if packing.is_packed(dw) else dw
        nw, no = run_opt(dw_t, packing.unpack_opt(spec, opt_l),
                         packing.unpack(w_pk), step)
        return (packing.pack(nw, spec=spec, stacked=False),
                packing.pack_opt(spec, no, stacked=False))
    return packed_update


# ===========================================================================
# Training step factory
# ===========================================================================
def make_train_step(model, optimizer: Optimizer, exec_cfg: ExecutionConfig,
                    placements: Optional[EPSPlacements] = None,
                    device="cpu", copy_stream=None,
                    writeback_stream=None, grad_ring: int = 2,
                    dp=None, tp=None) -> Callable:
    """Returns step(params, opt_state, batch[, n_active]) -> (params',
    opt_state', metrics).  ``opt_state`` = {"step": int, "embed", "head",
    "groups" [, "loss_scale"]} — build with ``init_opt_state``.  With
    ``dynamic_depth`` the step takes ``n_active``, the run depth (0 to
    the capacity).  On CUDA the relay's fetches run on ``copy_stream``
    and its write-backs on ``writeback_stream`` (each made when not
    given).  ``grad_ring``: gradient rows in flight to the host optimizer
    (Algorithm 4 with ``host_optimizer``).

    ``dp`` (a ``distributed.data_parallel.DataParallel``): the batch is
    this rank's rows, and the step sums over the data axes in these places
    only: the loss weight ``W_total`` before the head's cotangent
    ``S_loss / W_total`` uses it, each layer's gradient once (its
    microbatch sum, in one flat f32 row, before the ``/ S_loss``), the
    static tree's gradient once, and the loss sum for the metric.  The
    finite flags, clips, norms, updates and shipments that follow all see
    the global gradient, so the ranks stay bit for bit equal.

    ``tp`` (a ``distributed.tensor_parallel.TensorParallel``): the model's
    layers compute on this rank's blocks and reduce over the model group
    inside their own autograd (the per-layer vjp needs nothing more); the
    finite flags are agreed over the group and the norms (clips, the
    grad norm) sum the squares of the split leaves over it, each whole
    leaf once."""
    groups = model.groups
    device = torch.device(device)
    if placements is None:
        placements = make_placements(exec_cfg, len(groups), device)
    if device.type == "cuda" and copy_stream is None:
        copy_stream = torch.cuda.Stream(device)
    if device.type == "cuda" and writeback_stream is None:
        writeback_stream = torch.cuda.Stream(device)
    UB = exec_cfg.n_microbatches
    PK = exec_cfg.pack_params
    SE = exec_cfg.stash_every
    EAGER = exec_cfg.eager_optimizer
    HOST = exec_cfg.host_optimizer
    DYN = exec_cfg.dynamic_depth
    CLIP = exec_cfg.clip_mode == "per_layer"
    amp = exec_cfg.loss_scale_init > 0
    NG = len(groups)
    if DYN:
        assert NG == 1, "dynamic_depth supports single-group models"
        assert groups[0].n_layers % SE == 0, \
            "dynamic_depth needs stash_every to divide the capacity depth"
    assert grad_ring >= 1, "the host optimizer needs a gradient row"
    sp = placements.stash
    run_opt = optimizer.update
    packed_update = _make_packed_update(optimizer, run_opt)

    def relay(body, init, streams, **kw):
        return relay_scan(body, init, streams,
                          group=exec_cfg.layers_per_relay,
                          prefetch=exec_cfg.prefetch_depth,
                          transport=exec_cfg.transport, device=device,
                          copy_stream=copy_stream,
                          writeback_stream=writeback_stream, **kw)

    def sink(place, n, tree=None):
        out = Sink(place, n, transport=exec_cfg.transport,
                   stream=writeback_stream)
        out.tree = tree
        return out

    def param_sinks(gi, W, O, n_act):
        """Group gi's new weights' and slots' sinks; rows past the run
        depth are the input rows (written here, where no kernel reads
        them)."""
        N = groups[gi].n_layers
        wp, op = placements.weights[gi], placements.opts[gi]
        outs = (sink(wp, N), sink(op, N))
        if n_act < N:
            outs[0].tree = _carry_rows(_resting(wp, W, device), W, n_act)
            outs[1].tree = _carry_rows(_resting(op, O, device), O, n_act)
        return outs

    def step(params, opt_state, batch, n_active=None):
        win = depth_window(DYN, n_active, groups[0].n_layers)
        n_acts = ((win[1],) if win is not None
                  else tuple(g.n_layers for g in groups))
        hosts = []
        try:
            return run(params, opt_state, batch, n_acts, hosts)
        finally:
            for h in hosts:
                h.close()

    def apply_ub(group, ctx, w, x_c, mem):
        ys = []
        aux_l = 0.0
        for u in range(UB):
            y, a = group.apply(w, x_c[u], None if mem is None else mem[u],
                               ctx)
            ys.append(y)
            aux_l = aux_l + a
        return torch.stack(ys), aux_l

    def run(params, opt_state, batch, n_acts, hosts):
        static = {"embed": params["embed"], "head": params["head"]}
        Ws, Os = params["groups"], opt_state["groups"]
        wps, ops = placements.weights, placements.opts
        opt_step = opt_state["step"]
        batch_ub = _reshape_ub(batch, UB)
        ub = [tree_map(lambda a, _u=u: a[_u], batch_ub) for u in range(UB)]
        W_total = batch["mask"].sum()
        if dp is not None:
            W_total = dp.all_reduce_(W_total)
        W_total = W_total.clamp_min(1.0)
        f32 = dict(dtype=torch.float32, device=W_total.device)
        S_loss = (opt_state["loss_scale"]["scale"] if amp
                  else torch.ones((), **f32))
        ctxs = [model.train_ctx(ub[0], g) for g in groups]
        bounds = [segment_bounds(g.n_layers, SE) for g in groups]

        def seg_hi(gi, s0, s1):
            """Active rows of group gi's segment [s0, s1): the window
            (0, hi)."""
            return min(max(n_acts[gi] - s0, 0), s1 - s0)

        # ------------------------------------------------------------
        # OUTPUT ROWS the host writes (rows the run depth leaves idle,
        # the host optimizer's): allocated after a synchronize, so no
        # queued kernel still reads their blocks, and no write-back is
        # still landing in the input rows they copy
        # ------------------------------------------------------------
        if HOST:
            # a pinned copy when the weights rest on the card
            W_hosts = [ops[gi].host(Ws[gi]) for gi in range(NG)]
        if device.type == "cuda" and (HOST or any(
                n < g.n_layers for n, g in zip(n_acts, groups))):
            torch.cuda.synchronize(device)
        grads_outs, outs, upds, host_opts = ([None] * NG for _ in range(4))
        for gi, group in enumerate(groups):
            N, n_act, W, O = group.n_layers, n_acts[gi], Ws[gi], Os[gi]
            wp, op = wps[gi], ops[gi]
            if not EAGER:             # Alg 3's gradient rows (zeros idle)
                gplace = op if HOST else wp
                grads_outs[gi] = sink(gplace, N, _carry_rows(_resting(
                    gplace, W, device, torch.float32), None, n_act)
                    if n_act < N else None)
            if HOST:
                W_host = W_hosts[gi]
                new_w = _carry_rows(_resting(op, W_host, device), W_host,
                                    n_act)
                new_o = _carry_rows(_resting(op, O, device), O, n_act)
                ring = None
                if EAGER:
                    ring = sink(op, grad_ring, (
                        _resting(op, W_host, device, torch.float32,
                                 rows=grad_ring),
                        _resting(op, torch.empty(grad_ring,
                                                 dtype=torch.int32), device)))
                host_opts[gi] = HostOptimizer(run_opt, W_host, O, new_w,
                                              new_o, opt_step, packed=PK,
                                              amp=amp, ring=ring)
                hosts.append(host_opts[gi])
                outs[gi] = (host_opts[gi],) if EAGER else (grads_outs[gi],)
            elif EAGER:
                outs[gi] = param_sinks(gi, W, O, n_act)
            else:
                outs[gi], upds[gi] = ((grads_outs[gi],),
                                      param_sinks(gi, W, O, n_act))

        # ------------------------------------------------------------
        # FORWARD: layer-major relay through the groups, stash of each
        # layer's input; a group's input is saved for its transition's
        # vjp
        # ------------------------------------------------------------
        x_ub = torch.stack([model.prepare(static, b)[0] for b in ub])
        group_inputs = [None] * NG
        mems = [None] * NG        # per group: its memory per microbatch
        stashes = [None] * NG     # the stash sink (K = 1), the entries (K > 1)
        aux_total = torch.zeros((), **f32)
        for gi, group in enumerate(groups):
            if gi > 0:
                group_inputs[gi] = x_prev = x_ub
                x_ub = torch.stack([model.transition_x(gi, static, x_prev[u],
                                                       ub[u])
                                    for u in range(UB)])
                if group.has_mem:
                    mems[gi] = torch.stack([model.transition_mem(
                        gi, static, x_prev[u], ub[u]) for u in range(UB)])
            W, N, aux = Ws[gi], group.n_layers, []

            def fwd_body(x_c, slots, _x, _stash=True, _g=group,
                         _ctx=ctxs[gi], _aux=aux, _mem=mems[gi]):
                (w,) = slots
                y_ub, aux_l = apply_ub(_g, _ctx,
                                       packing.unpack(w) if PK else w, x_c,
                                       _mem)
                _aux.append(aux_l)
                return y_ub, ((x_c,) if _stash else None)

            if SE == 1:
                stashes[gi] = sink(sp, N)
                x_ub, _ = relay(fwd_body, x_ub, (Stream(wps[gi], W),),
                                sinks=(stashes[gi],), active=(0, n_acts[gi]))
            else:
                # only each K-segment's entry boundary is checkpointed
                stashes[gi] = sink(sp, len(bounds[gi]))
                for si, (s0, s1) in enumerate(bounds[gi]):
                    hi = seg_hi(gi, s0, s1)
                    if not hi:
                        continue
                    stashes[gi].write(si, x_ub)
                    x_ub, _ = relay(
                        lambda x_c, sl, x, _b=fwd_body: _b(x_c, sl, x, False),
                        x_ub, (Stream(wps[gi], _rows(W, s0, s1)),),
                        active=(0, hi))
            aux_total = aux_total + torch.as_tensor(sum(aux), **f32) / UB

        # ------------------------------------------------------------
        # HEAD: loss + dL/dx per microbatch (and d_static from the head)
        # ------------------------------------------------------------
        s_leaves = tree_leaves(static)
        d_static = _zeros_f32(static)
        loss_sum = torch.zeros((), **f32)
        dx = []
        for u in range(UB):
            def head(ls, _u=u):
                st = tree_unflatten_like(static, ls[:-1])
                return model.head_loss(st, ls[-1], ub[_u])[0]
            loss_u, g = _vjp(head, s_leaves + [x_ub[u]], S_loss / W_total)
            d_static = _tree_add(d_static, tree_unflatten_like(
                static, [a.float() for a in g[:-1]]))
            loss_sum = loss_sum + loss_u
            dx.append(g[-1])
        dx_ub = torch.stack(dx)
        if dp is not None:
            loss_sum = dp.all_reduce_(loss_sum)
        loss = loss_sum / W_total + aux_total

        # ------------------------------------------------------------
        # BACKWARD: reverse relay group by group; recompute-vjp per
        # layer; eager opt; each transition's vjp carries dx back
        # ------------------------------------------------------------
        # the cotangent of a layer's (y, aux): (dx, S_loss / UB), as the
        # loss adds each layer's aux summed over microbatches over UB
        d_aux = S_loss / UB

        def bwd_body(core, slots, stash_l, _g, _ctx, _mem, _gi):
            """Recompute-vjp microbatch loop (+ eager update) of one
            layer.  With pack_params the vjp differentiates the UNPACKED
            views and every gradient-side reduction stays on the tree.
            With a memory the vjp also gives dmem, summed into the carry's
            ``dmem_c`` layer by layer."""
            w_dev = slots[0]
            opt_l = slots[1] if len(slots) > 1 else None
            dx_c, dmem_c, gn_c, nf_c = core
            w_tree = packing.unpack(w_dev) if PK else w_dev
            w_leaves = tree_leaves(w_tree)
            nw = len(w_leaves)
            # the layer's gradient accumulates in one flat f32 row (views
            # in flatten order), which a data mesh sums in one collective
            row = torch.zeros(sum(a.numel() for a in w_leaves),
                              dtype=torch.float32, device=w_leaves[0].device)
            dw, off = [], 0
            for a in w_leaves:
                dw.append(row[off:off + a.numel()].view(a.shape))
                off += a.numel()
            dxin, dmem = [], []
            for u in range(UB):
                def layer(ls):
                    return _g.apply(tree_unflatten_like(w_tree, ls[:nw]),
                                    ls[nw], None if _mem is None else
                                    ls[nw + 1], _ctx)
                _, g = _vjp(layer, w_leaves + [stash_l[u]] + (
                    [] if _mem is None else [_mem[u]]), (dx_c[u], d_aux))
                for a, b in zip(dw, g[:nw]):
                    a.add_(b.float())
                dxin.append(g[nw])
                dmem.extend(g[nw + 1:])
            if _mem is not None:
                dmem_c = dmem_c + torch.stack(dmem)
            if dp is not None:
                dp.all_reduce_(row)
            dw = tree_unflatten_like(w_tree, [g / S_loss for g in dw])
            ps = None if tp is None else tp.layer_pspecs[_gi]
            finite_l = _finite(dw, tp, ps)
            if CLIP:
                dw, _ = clip_by_norm(dw, exec_cfg.clip_norm, tp, ps)
            gn_c = gn_c + torch.where(
                finite_l, tree_global_norm(dw, tp, ps) ** 2, 0.0)
            nf_c = nf_c + torch.where(finite_l, 0, 1)
            # the gradient as it travels: one flat f32 row aligned to the
            # weight layout when packed
            dw_out = (packing.pack(dw, spec=w_dev.spec, stacked=False)
                      if PK else dw)
            if EAGER and HOST:
                # to the host optimizer, with the layer's finite flag
                out = ((dw_out, finite_l.to(torch.int32)),)
            elif EAGER:
                new_w, new_opt = (packed_update if PK else run_opt)(
                    dw, opt_l, w_dev, opt_step)
                if amp:
                    # a non-finite layer skips ITS update (eager updates
                    # cannot wait for a global check)
                    new_w = _where(finite_l, new_w, w_dev)
                    new_opt = _where(finite_l, new_opt, opt_l)
                out = (new_w, new_opt)
            else:
                # Alg 3: the gradient is shipped to the EPS
                out = (dw_out,)
            return (torch.stack(dxin), dmem_c, gn_c, nf_c), out

        # Alg 4 on the card fetches the Adam slots with the weights; the
        # host optimizer reads them where they rest
        with_opt = EAGER and not HOST
        core = (dx_ub, None, torch.zeros((), **f32),
                torch.zeros((), dtype=torch.int32, device=W_total.device))
        for gi in reversed(range(NG)):
            group, W, O = groups[gi], Ws[gi], Os[gi]
            wp, op = wps[gi], ops[gi]
            mem = mems[gi]
            # the group's dmem starts at zero and sums over its layers
            core = (core[0], None if mem is None else torch.zeros_like(mem),
                    ) + core[2:]
            body = (lambda c, sl, x, _g=group, _ctx=ctxs[gi], _m=mem, _i=gi:
                    bwd_body(c, sl, x, _g, _ctx, _m, _i))
            if SE == 1:
                streams = [Stream(wp, W)] + \
                    ([Stream(op, O)] if with_opt else [])
                core, _ = relay(body, core, streams, xs=stashes[gi].tree,
                                reverse=True, sinks=outs[gi],
                                active=(0, n_acts[gi]))
            else:
                def rec_body(x_c, slots, _x, _g=group, _ctx=ctxs[gi],
                             _m=mem):
                    """One layer of the boundary recompute (with the same
                    memory as the forward): its OUTPUT boundary goes to
                    the segment's stash rows."""
                    (w,) = slots
                    y_ub, _ = apply_ub(_g, _ctx,
                                       packing.unpack(w) if PK else w, x_c,
                                       _m)
                    return y_ub, (y_ub,)

                for si in reversed(range(len(bounds[gi]))):
                    s0, s1 = bounds[gi][si]
                    hi = seg_hi(gi, s0, s1)
                    if not hi:
                        continue
                    entry = _row_to_device(stashes[gi].tree, si, device,
                                           copy_stream, writeback_stream)
                    seg = sink(sp, s1 - s0)
                    seg.write(0, entry)
                    if hi > 1:
                        relay(rec_body, entry,
                              (Stream(wp, _rows(W, s0, s1 - 1)),),
                              sinks=(seg,), sink_row0=1, active=(0, hi - 1))
                    streams = [Stream(wp, _rows(W, s0, s1))]
                    if with_opt:
                        streams.append(Stream(op, _rows(O, s0, s1)))
                    core, _ = relay(body, core, streams, xs=seg.tree,
                                    reverse=True, sinks=outs[gi],
                                    sink_row0=s0, active=(0, hi))
            if gi > 0:
                # the transition's vjp back to group gi-1's output: dx
                # through transition_x, dmem through transition_mem; the
                # static params take their share (none for the identity)
                dx_prev = []
                for u in range(UB):
                    parts = [(model.transition_x, core[0][u])]
                    if mem is not None:
                        parts.append((model.transition_mem, core[1][u]))
                    dxp = None
                    for fn, cot in parts:
                        def trans(ls, _u=u, _fn=fn):
                            return _fn(gi, tree_unflatten_like(
                                static, ls[:-1]), ls[-1], ub[_u])
                        _, g = _vjp(trans, s_leaves + [group_inputs[gi][u]],
                                    cot, zeros=False)
                        d_static = tree_unflatten_like(static, [
                            a if b is None else a + b.float() for a, b in
                            zip(tree_leaves(d_static), g[:-1])])
                        if g[-1] is not None:
                            dxp = g[-1] if dxp is None else dxp + g[-1]
                    dx_prev.append(torch.zeros_like(group_inputs[gi][u])
                                   if dxp is None else dxp)
                core = (torch.stack(dx_prev), None) + core[2:]
        dx_ub, _, gnorm_sq, nonfinite = core

        # ---- prepare (embedding) vjp ---------------------------------
        for u in range(UB):
            def prep(ls, _u=u):
                return model.prepare(tree_unflatten_like(static, ls),
                                     ub[_u])[0]
            _, g = _vjp(prep, s_leaves, dx_ub[u])
            d_static = _tree_add(d_static, tree_unflatten_like(
                static, [a.float() for a in g]))
        if dp is not None:
            d_static = dp.reduce_tree(d_static)
        sps = None if tp is None else tp.static_pspecs
        gnorm_sq = gnorm_sq + tree_global_norm(d_static, tp, sps) ** 2

        # ------------------------------------------------------------
        # UPDATES: static params; layer params here if not eager (Alg 3)
        # ------------------------------------------------------------
        d_static = tree_map(lambda g: g / S_loss, d_static)
        finite_s = _finite(d_static, tp, sps)
        nonfinite = nonfinite + torch.where(finite_s, 0, 1)
        if CLIP:
            d_static, _ = clip_by_norm(d_static, exec_cfg.clip_norm, tp, sps)
        static_opt = {"embed": opt_state["embed"], "head": opt_state["head"]}
        new_static, new_static_opt = optimizer.update(
            d_static, static_opt, static, opt_step)
        if amp:
            new_static = _where(finite_s, new_static, static)
            new_static_opt = _where(finite_s, new_static_opt, static_opt)

        new_ws, new_os = [None] * NG, [None] * NG
        if HOST:
            if not EAGER:
                # Alg 3: a host loop over the shipped gradient rows, once
                # their write-backs have landed
                if writeback_stream is not None:
                    landed = torch.cuda.Event()
                    landed.record(writeback_stream)
                    landed.synchronize()
                for gi in range(NG):
                    host_opts[gi].update_rows(range(n_acts[gi]),
                                              grads_outs[gi].tree)
            for gi, host in enumerate(host_opts):
                host.join()
                # back to the card when the weights rest there
                new_ws[gi], new_os[gi] = wps[gi].host(host.new_w), host.new_o
        elif EAGER:
            for gi in range(NG):
                new_ws[gi], new_os[gi] = outs[gi][0].tree, outs[gi][1].tree
        else:
            # Alg 3: a trailing relay over each group's layers — weights,
            # the shipped gradients and the optimizer slots stream in
            # together
            def upd_body(_, slots, _x):
                w, g, o = slots
                return None, (packed_update if PK else run_opt)(
                    g, o, w, opt_step)

            for gi in range(NG):
                _, (new_ws[gi], new_os[gi]) = relay(
                    upd_body, None, (Stream(wps[gi], Ws[gi]),
                                     Stream(wps[gi], grads_outs[gi].tree),
                                     Stream(ops[gi], Os[gi])),
                    sinks=upds[gi], active=(0, n_acts[gi]))

        new_params = {"embed": new_static["embed"],
                      "head": new_static["head"], "groups": tuple(new_ws)}
        new_opt = {"step": opt_step + 1, "embed": new_static_opt["embed"],
                   "head": new_static_opt["head"], "groups": tuple(new_os)}
        metrics = {"loss": loss, "aux": aux_total,
                   "grad_norm": torch.sqrt(gnorm_sq), "weight_sum": W_total}
        if HOST:
            metrics["host_update_ms"] = [ms for h in hosts
                                         for ms in h.update_ms]
            metrics["host_wait_s"] = sum(h.wait_s for h in hosts)
        if exec_cfg.skip_nonfinite:
            # anomaly sentinel: ANY non-finite layer/static gradient
            # rejects the whole step — the prior params, optimizer slots
            # and step counter come back as they were (the step never
            # writes its inputs).  The AMP loss scale still adapts.
            bad = bool(nonfinite > 0)
            if bad:
                new_params = params
                new_opt = {k: opt_state[k]
                           for k in ("step", "embed", "head", "groups")}
            metrics["skipped_steps"] = int(bad)
            metrics["nonfinite_layers"] = nonfinite
        if amp:
            ls = opt_state["loss_scale"]
            any_bad = nonfinite > 0
            good = torch.where(any_bad, 0, ls["good_steps"] + 1)
            scale = torch.where(any_bad,
                                torch.clamp(ls["scale"] * 0.5, min=1.0),
                                ls["scale"])
            grow = good >= exec_cfg.loss_scale_growth
            scale = torch.where(grow, scale * 2.0, scale)
            good = torch.where(grow, 0, good).to(torch.int32)
            new_opt["loss_scale"] = {"scale": scale, "good_steps": good}
            metrics["loss_scale"] = scale
            metrics["nonfinite_layers"] = nonfinite
        return new_params, new_opt, metrics

    return step


def _row_to_device(tree, row: int, device, copy_stream, writeback_stream):
    """Row ``row`` of a stacked tree on the compute device: from pinned
    host memory by K4 on the copy stream, behind the write-backs issued so
    far, the compute stream waiting for it."""
    if device.type != "cuda" or tree_leaves(tree)[0].device.type == "cuda":
        return tree_map(lambda a: a[row], tree)
    compute = torch.cuda.current_stream(device)
    copy_stream.wait_stream(writeback_stream)
    with torch.cuda.stream(copy_stream):
        out = relay_copy.fetch_slot(tree, row, 1, squeeze=True,
                                    device=device)
    compute.wait_stream(copy_stream)
    for a in tree_leaves(out):
        a.record_stream(compute)
    return out


# ===========================================================================
# Loss + grads only (no optimizer) — for equivalence tests
# ===========================================================================
def make_grads_fn(model, exec_cfg: ExecutionConfig,
                  placements: Optional[EPSPlacements] = None, device="cpu",
                  copy_stream=None, writeback_stream=None,
                  dp=None, tp=None) -> Callable:
    """Returns grads(params, batch[, n_active]) -> (loss, grads) computed
    with the L2L schedule (layer-major, recompute, trailing gradient
    shipment): the train step with an 'optimizer' that stores the
    gradient.  Only the schedule and layout knobs carry over (no AMP,
    clip, eager or host update); with ``dynamic_depth`` the rows past
    ``n_active`` come out zero.  With ``dp`` the loss and gradients are
    the global batch's, with ``tp`` this rank's blocks of them
    (``make_train_step``)."""
    cfg = ExecutionConfig(
        n_microbatches=exec_cfg.n_microbatches,
        offload_stash=exec_cfg.offload_stash,
        weight_stream=exec_cfg.weight_stream,
        stash_every=exec_cfg.stash_every,
        segment_scan=exec_cfg.segment_scan,
        dynamic_depth=exec_cfg.dynamic_depth,
        prefetch_depth=exec_cfg.prefetch_depth,
        pack_params=exec_cfg.pack_params,
        layers_per_relay=exec_cfg.layers_per_relay,
        transport=exec_cfg.transport,
        eager_optimizer=False, clip_mode="none")
    collector = _grad_collector()
    if placements is None:
        placements = make_placements(cfg, len(model.groups), device)
    base_step = make_train_step(model, collector, cfg, placements, device,
                                copy_stream, writeback_stream, dp=dp, tp=tp)

    def fn(params, batch, n_active=None):
        opt = init_opt_state(collector, params)
        # the collector's slots rest beside their weights (pinned rows when
        # streaming), where the trailing relay fetches them; the rows past
        # a run depth keep their zeros
        opt["groups"] = tuple(placements.opts[gi].host(g)
                              for gi, g in enumerate(opt["groups"]))
        _, new_opt, metrics = base_step(params, opt, batch, n_active)
        is_slot = lambda x: isinstance(x, dict) and set(x) == {"m"}
        unwrap = lambda t: tree_map(lambda s: s["m"], t, is_leaf=is_slot)
        grads = {"embed": unwrap(new_opt["embed"]),
                 "head": unwrap(new_opt["head"]),
                 "groups": tuple(packing.unpack(g) if packing.is_packed(g)
                                 else g for g in
                                 (unwrap(g) for g in new_opt["groups"]))}
        return metrics["loss"], grads

    return fn


def _grad_collector() -> Optimizer:
    """An 'optimizer' that stores the gradient into its state and leaves
    the params untouched."""
    def init(params):
        return tree_map(lambda p: {"m": torch.zeros(
            p.shape, dtype=torch.float32, device=p.device)}, params)

    def update(grads, state, params, step):
        return params, tree_map(lambda g: {"m": g.float()}, grads)

    return Optimizer("collect", init, update)


def init_opt_state(optimizer: Optimizer, params,
                   exec_cfg: Optional[ExecutionConfig] = None) -> dict:
    """Optimizer slots beside the params, on their devices; a packed group
    gets slot-major flat rows aligned to its weight spec."""
    def group_opt(g):
        if packing.is_packed(g):
            return packing.pack_opt(g.spec, optimizer.init(packing.unpack(g)))
        return optimizer.init(g)

    state = {"step": 0,
             "embed": optimizer.init(params["embed"]),
             "head": optimizer.init(params["head"]),
             "groups": tuple(group_opt(g) for g in params["groups"])}
    if exec_cfg is not None and exec_cfg.loss_scale_init > 0:
        dev = tree_leaves(params["embed"])[0].device
        state["loss_scale"] = {
            "scale": torch.tensor(exec_cfg.loss_scale_init,
                                  dtype=torch.float32, device=dev),
            "good_steps": torch.zeros((), dtype=torch.int32, device=dev)}
    return state


# ===========================================================================
# Prefill (inference forward): layer-major relay, no stash, no backward
# ===========================================================================
def make_prefill_fn(model, exec_cfg: ExecutionConfig,
                    placements: Optional[EPSPlacements] = None,
                    device="cpu", copy_stream=None) -> Callable:
    """Returns prefill(params, batch[, n_active]) -> last-token logits
    (B, vocab): the full prompt forward under the L2L weight relay; with
    ``dynamic_depth`` over the first ``n_active`` layers only."""
    if placements is None:
        placements = make_placements(exec_cfg, len(model.groups), device)
    UB = exec_cfg.n_microbatches
    DYN = exec_cfg.dynamic_depth
    if DYN:
        assert len(model.groups) == 1, \
            "dynamic_depth supports single-group models"

    def prefill(params, batch, n_active=None):
        win = depth_window(DYN, n_active, model.groups[0].n_layers)
        static = {"embed": params["embed"], "head": params["head"]}
        batch_ub = _reshape_ub(batch, UB)
        ub_batches = [tree_map(lambda a, _u=u: a[_u], batch_ub)
                      for u in range(UB)]
        x_ub = torch.stack([model.prepare(static, b)[0] for b in ub_batches])
        for gi, group in enumerate(model.groups):
            mem = None
            if gi > 0:
                x_prev = x_ub
                x_ub = torch.stack([model.transition_x(gi, static, x_prev[u],
                                                       ub_batches[u])
                                    for u in range(UB)])
                if group.has_mem:
                    mem = torch.stack([model.transition_mem(
                        gi, static, x_prev[u], ub_batches[u])
                        for u in range(UB)])
            ctx = model.train_ctx(ub_batches[0], group)

            def fwd_body(x_c, slots, _x, _g=group, _ctx=ctx, _mem=mem):
                (w,) = slots
                if exec_cfg.pack_params:
                    w = packing.unpack(w)
                return torch.stack([_g.apply(
                    w, x_c[u], None if _mem is None else _mem[u], _ctx)[0]
                    for u in range(UB)]), None

            x_ub, _ = relay_scan(
                fwd_body, x_ub, (Stream(placements.weights[gi],
                                        params["groups"][gi]),),
                group=exec_cfg.layers_per_relay,
                prefetch=exec_cfg.prefetch_depth,
                transport=exec_cfg.transport, device=device,
                copy_stream=copy_stream, active=win)
        logits = [model.decode_logits(static, x_ub[u][:, -1:, :])[:, 0]
                  for u in range(UB)]
        return torch.cat(logits)

    return prefill
