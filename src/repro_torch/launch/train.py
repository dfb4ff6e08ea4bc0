"""Training CLI (the port of ``repro/launch/train.py``): end-to-end
single-card training through the Engine facade — L2L-p by default, the
Alg-3 L2L or the baseline for comparison — on the synthetic LM data::

    PYTHONPATH=src python -m repro_torch.launch.train --arch bert-large \\
        --variant full --engine l2l-p --steps 5 --batch 32 --seq 512 \\
        --ub 4 --weight-stream --pack --prefetch 1 --transport pallas \\
        --offload-stash

Runs on the card unless ``--device cpu``.  Prints each logged step's loss,
grad norm and wall time (``step <n>`` lines), then one JSON line.

Checkpoints and preemption, as the reference's CLI has them::

    ... --ckpt-dir ckpts --ckpt-every 5 --keep-last 2 --resume auto

``--ckpt-every N`` saves after every N-th step (``ckpt_<step>/``, the
unpacked layout ``checkpoint.io`` writes, which the reference reads);
``--resume auto`` restarts from the newest snapshot in ``--ckpt-dir`` that
verifies (a fresh run when there is none), ``--resume DIR`` from DIR's
(an error when it has none).  SIGTERM or SIGINT finishes the step in
flight, saves, writes ``PREEMPTED.json`` (``{"step", "signal"}``) and
exits 0; a clean finish removes the marker and saves the last step if no
periodic save did.  ``data.batch(i)`` is seeded per step, so a resumed run
replays the same data: its final state equals an uninterrupted run's bit
for bit.

``--host-optimizer`` runs the layer updates on the host over the pinned
rows (the paper's CPU optimizer); ``--dynamic-depth --run-layers N``
trains the first N layers of the stack (default: all), the rest
unfetched and unchanged.  ``--tiers 3 --host-budget B --tier-dir D`` puts
the verified disk tier under the EPS: the layer rows past B bytes of
weights and optimizer slots rest in segment files in D (a fresh temporary
directory when D is empty) between steps, and the JSON line carries the
tier's ``tier_metrics``.

Data parallel over the mesh's data axes, one process a rank, launched by
``torch.distributed.run`` (which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and the rendezvous address)::

    python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --mesh data=2 ... --batch 32

``--mesh data=N[,model=M]`` needs a world of N·M ranks (a single
process with ``--mesh data=1`` runs a world of one over a file store); a
process group that does not start raises.  ``--batch`` is the global
batch: each rank trains on its data rows of ``data.batch(i)``, its
block of each of the ``--ub`` microbatches
(``Engine.local_rows``), and the layer relay sums each
layer's gradient over the data ranks once (``core.l2l``), so the ranks
of a data group end each step with the same state; a MoE config sums
its router statistics and its dispatch counts over the data ranks too
(the JSON line counts them as ``moe_collectives_per_step``).
``model=M`` > 1 (the dense, MoE, hybrid and SSM families) splits the
heads, the ffn columns, the experts (or their columns where the experts
do not divide), mamba's channels, RWKV's heads and a vocabulary that
divides over M ranks
(``distributed.tensor_parallel``): each rank holds and relays its
blocks.  ``--dist-backend`` is nccl on the card,
gloo with ``--device cpu``.  Only rank 0 prints, writes snapshots and
``PREEMPTED.json`` (every rank takes part in a save: the split leaves
are gathered first); every rank restores.  The JSON line adds the
world, the backend, the all-reduces, bytes and milliseconds a step, and
every rank's final checksums of the weights and the optimizer slots (its
blocks; the run fails if the ranks of a data group differ); on a model
axis also the model group's collectives, bytes and milliseconds a step
and every rank's checksums of the leaves no pspec splits (the run fails
if the model ranks differ).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import tempfile
import time

import numpy as np
import torch

from repro_torch import engine as engines
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.base import get_config
from repro_torch.core.schedule import ExecutionConfig
from repro_torch.data.synthetic import (DataConfig, SyntheticLM,
                                        add_modality_stubs)
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import get_optimizer, make_schedule

PREEMPT_MARKER = "PREEMPTED.json"


def parse_args(argv=None):
    """-> (parser, args) of the command line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bert-large")
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--engine", default="l2l",
                    choices=["l2l", "l2l-p", "baseline"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ub", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--lr-schedule", default="cosine")
    ap.add_argument("--optimizer", default="adam",
                    choices=["adam", "adamw", "lamb", "sgd"])
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--no-eager", action="store_true",
                    help="with --engine l2l: trailing optimizer (Alg 3) "
                         "instead of the eager L2L-p schedule")
    ap.add_argument("--offload-stash", action="store_true",
                    help="boundary stash in pinned host memory")
    ap.add_argument("--stash-every", type=int, default=1,
                    help="K: stash every K-th layer boundary, recompute "
                         "the others in the backward")
    ap.add_argument("--weight-stream", action="store_true",
                    help="weights and optimizer slots rest in pinned host "
                         "memory (the EPS)")
    ap.add_argument("--prefetch", type=int, default=0,
                    help="k: relay stops in flight ahead of compute")
    ap.add_argument("--group", type=int, default=1,
                    help="G: layers per relay stop")
    ap.add_argument("--pack", action="store_true",
                    help="one flat row per dtype per layer; the eager "
                         "update runs fused on the flat segments")
    ap.add_argument("--transport", default="xla", choices=["xla", "pallas"],
                    help="'pallas': device-resident rows move through the "
                         "relay-copy kernel too")
    ap.add_argument("--skip-nonfinite", action="store_true",
                    help="reject a step whose gradients hold inf/nan")
    ap.add_argument("--tiers", type=int, default=2, choices=[2, 3],
                    help="2: HBM <- pinned host; 3: and a verified "
                         "on-disk segment store under it, the cold rows "
                         "staged around every step (bit for bit the "
                         "same results)")
    ap.add_argument("--host-budget", type=int, default=0,
                    help="with --tiers 3: bytes of stacked weights and "
                         "optimizer slots resident on the host; the rows "
                         "past it demote to disk, coldest first (0: all)")
    ap.add_argument("--tier-dir", default="",
                    help="with --tiers 3: the segment store's directory "
                         "(default: a fresh temporary directory)")
    ap.add_argument("--host-optimizer", action="store_true",
                    help="the layer updates run on the host over the "
                         "pinned rows (the paper's CPU optimizer)")
    ap.add_argument("--dynamic-depth", action="store_true",
                    help="the run depth is an argument of each step")
    ap.add_argument("--run-layers", type=int, default=0,
                    help="with --dynamic-depth: layers to run "
                         "(0 = all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-pallas", action="store_true",
                    help="attention through the flash kernels (K2, K3) "
                         "where the model tiles by them")
    ap.add_argument("--dtype", default="",
                    choices=["", "float32", "bfloat16"],
                    help="compute dtype (default: the config's)")
    ap.add_argument("--mesh", default="",
                    help="data=N[,model=M]: data parallel over N ranks, "
                         "tensor parallel over M (launch N*M ranks with "
                         "torch.distributed.run)")
    ap.add_argument("--dist-backend", default="",
                    choices=["", "nccl", "gloo"],
                    help="the process group's backend (default: nccl on "
                         "the card, gloo with --device cpu)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--keep-last", type=int, default=0,
                    help="keep only the newest N snapshots (0 = all)")
    ap.add_argument("--resume", default="",
                    help="'auto': the newest verified snapshot in "
                         "--ckpt-dir (a fresh run when none); or a "
                         "checkpoint directory (an error when it holds no "
                         "good snapshot)")
    ap.add_argument("--step-delay-ms", type=int, default=0,
                    help="sleep after every step (widens the window for "
                         "preemption tests)")
    return ap, ap.parse_args(argv)


def setup(ap, args):
    """-> (engine name, model config, optimizer, ExecutionConfig) of the
    command line: what a one-process run of it trains with."""
    engine_name = args.engine
    if engine_name == "l2l" and not args.no_eager:
        engine_name = "l2l-p"
    elif engine_name == "l2l-p" and args.no_eager:
        ap.error("--no-eager contradicts --engine l2l-p "
                 "(use --engine l2l --no-eager for Algorithm 3)")

    cfg = get_config(args.arch, args.variant)
    over = {"max_seq_len": max(cfg.max_seq_len, args.seq)}
    if args.d_model:
        over.update(d_model=args.d_model, d_ff=args.d_model * 4,
                    n_heads=max(1, args.d_model // 64),
                    n_kv_heads=max(1, min(cfg.n_kv_heads,
                                          args.d_model // 64)))
    if args.n_layers:
        over["n_layers"] = args.n_layers
    if args.dtype:
        over["dtype"] = args.dtype
    if args.use_pallas:
        over["use_pallas"] = True
    cfg = cfg.replace(**over)
    opt = get_optimizer(
        args.optimizer,
        schedule=make_schedule(args.lr, warmup=args.warmup,
                               total=args.steps, kind=args.lr_schedule))
    exec_cfg = ExecutionConfig(
        n_microbatches=args.ub, offload_stash=args.offload_stash,
        stash_every=args.stash_every, weight_stream=args.weight_stream,
        prefetch_depth=args.prefetch, layers_per_relay=args.group,
        pack_params=args.pack, transport=args.transport,
        tiers=args.tiers, host_budget_bytes=args.host_budget,
        tier_dir=args.tier_dir, host_optimizer=args.host_optimizer,
        skip_nonfinite=args.skip_nonfinite,
        dynamic_depth=args.dynamic_depth,
        clip_mode="per_layer" if args.clip > 0 else "none",
        clip_norm=args.clip)
    return engine_name, cfg, opt, exec_cfg


def batch_at(args, cfg, data, i) -> dict:
    """The global batch of step i: ``data.batch(i)`` and its modality
    stubs are functions of i alone, so a resumed run replays the data."""
    rng = np.random.default_rng((args.seed, i))
    return {k: torch.from_numpy(v) for k, v in
            add_modality_stubs(data.batch(i), cfg, rng).items()}


def make_data(args, cfg) -> SyntheticLM:
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, global_batch=args.batch,
                                  seed=args.seed))


def main(argv=None):
    ap, args = parse_args(argv)
    engine_name, cfg, opt, exec_cfg = setup(ap, args)
    mesh, backend = _init_mesh(args, ap)
    rank = 0 if mesh is None else torch.distributed.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    if exec_cfg.tier_dir and _world(mesh) > 1:
        # each rank's segment store in a directory of its own
        exec_cfg = dataclasses.replace(exec_cfg, tier_dir=os.path.join(
            exec_cfg.tier_dir, f"rank{rank}"))
    if args.run_layers and not args.dynamic_depth:
        ap.error("--run-layers needs --dynamic-depth")
    run_layers = ((args.run_layers or cfg.n_layers)
                  if args.dynamic_depth else None)
    eng = engines.create(engine_name, cfg, exec_cfg, optimizer=opt,
                         device=args.device, mesh=mesh)
    dev = eng.device
    say(f"arch={cfg.name} engine={eng.name} layers={cfg.n_layers} "
        f"d={cfg.d_model} device={dev} world={_world(mesh)}", flush=True)
    start_step, resumed_from = 0, None
    state = None
    if args.resume:
        resume_dir = args.ckpt_dir if args.resume == "auto" else args.resume
        if not resume_dir:
            ap.error("--resume auto needs --ckpt-dir")
        good = ckpt_io.latest_good(resume_dir,
                                   fingerprint=eng.state_fingerprint())
        if good is not None:
            state, start_step = eng.restore(resume_dir, step=good)
            resumed_from = good
            say(f"resumed from {resume_dir} at step {start_step} "
                  f"(verified snapshot)", flush=True)
        elif args.resume != "auto":
            raise SystemExit(
                f"--resume {resume_dir}: no verifiable checkpoint")
    if state is None:
        state = eng.init(torch.Generator(device=dev).manual_seed(args.seed))

    # preemption: finish the step in flight, save, exit resumable
    stop = {"sig": None}

    def on_signal(signum, frame):
        stop["sig"] = signum

    old_handlers = {s: signal.signal(s, on_signal)
                    for s in (signal.SIGTERM, signal.SIGINT)}

    def save_snapshot(step):
        # every rank gathers, rank 0 writes; the others wait until the
        # snapshot is whole
        eng.save(args.ckpt_dir, state, step=step, keep_last=args.keep_last)
        if mesh is not None:
            torch.distributed.barrier()
        return step

    data = make_data(args, cfg)
    losses, times, reduces = [], [], []
    skipped = 0
    preempted = False
    last_saved = start_step if resumed_from is not None else None
    for i in range(start_step, args.steps):
        batch = batch_at(args, cfg, data, i)
        batch = eng.local_rows(batch, "train_step")
        t0 = time.perf_counter()
        state, metrics = eng.train_step(state, batch, n_layers=run_layers)
        loss = float(metrics["loss"])          # waits for the step
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        if eng.dp is not None:
            reduces.append(eng.dp.stats())
        if eng.tp is not None:
            reduces[-1].update(eng.tp.stats())
        skipped += int(metrics.get("skipped_steps", 0))
        if (i - start_step) % args.log_every == 0 or i == args.steps - 1:
            say(f"step {i:5d}  loss {loss:8.4f}  gnorm "
                  f"{float(metrics['grad_norm']):8.3f}  {times[-1]:.3f}s",
                  flush=True)
        if args.step_delay_ms:
            time.sleep(args.step_delay_ms / 1e3)
        if args.ckpt_dir and args.ckpt_every and \
                (i + 1) % args.ckpt_every == 0:
            last_saved = save_snapshot(i + 1)
        if _agree_stop(stop["sig"], mesh, dev):
            preempted = True
            if args.ckpt_dir:
                if last_saved != i + 1:
                    last_saved = save_snapshot(i + 1)
                if rank == 0:
                    with open(os.path.join(args.ckpt_dir, PREEMPT_MARKER),
                              "w") as f:
                        json.dump({"step": i + 1,
                                   "signal": int(stop["sig"] or 0),
                                   "total_steps": args.steps}, f)
            break
    for s, h in old_handlers.items():
        signal.signal(s, h)
    if args.ckpt_dir and not preempted:
        # the last step is saved once, whether or not a periodic save was
        if last_saved != args.steps:
            last_saved = save_snapshot(args.steps)
        marker = os.path.join(args.ckpt_dir, PREEMPT_MARKER)
        if rank == 0 and os.path.exists(marker):
            os.remove(marker)
    steady = (float(np.mean(times[1:])) if len(times) > 1 else None)
    dist_line = {"world": _world(mesh), "backend": backend}
    if mesh is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sums = eng.dp.gather_checksums(state.params, state.opt_state)
        dist_line.update(
            mesh=args.mesh, rank_checksums=sums,
            all_reduces_per_step=(reduces[-1]["all_reduces"] if reduces
                                  else None),
            all_reduce_bytes_per_step=(reduces[-1]["all_reduce_bytes"]
                                       if reduces else None),
            all_reduce_ms=[r["all_reduce_ms"] for r in reduces])
        if eng.model.dp is not None:
            dist_line.update(
                moe_collectives_per_step=(reduces[-1]["moe_collectives"]
                                          if reduces else None),
                moe_collective_bytes_per_step=(
                    reduces[-1]["moe_collective_bytes"] if reduces
                    else None))
        if eng.tp is not None:
            whole = eng.tp.gather_checksums(
                eng.tp.whole_leaves(state.params),
                eng.tp.whole_leaves(state.legacy_opt()))
            dist_line.update(
                model_checksums=whole,
                model_collectives_per_step=(
                    reduces[-1]["model_collectives"] if reduces else None),
                model_collective_bytes_per_step=(
                    reduces[-1]["model_collective_bytes"] if reduces
                    else None),
                model_collective_ms=[r["model_collective_ms"]
                                     for r in reduces])
    say(json.dumps({"final_loss": losses[-1] if losses else None,
                      "initial_loss": losses[0] if losses else None,
                      "first_step_s": times[0] if times else None,
                      "steady_s_per_step": steady,
                      "run_layers": run_layers, "steps": args.steps, "final_step": int(state.step),
                      "resumed_from": resumed_from, "preempted": preempted,
                      "skipped_steps": skipped, "device": str(dev),
                      "tier_metrics": (eng.tier.metrics
                                       if eng.tier is not None else None),
                      "losses": losses, "step_s": times, **dist_line}),
        flush=True)
    if mesh is not None:
        torch.distributed.destroy_process_group()
        if any(row != sums[0] for row in sums):
            raise SystemExit(f"the data-parallel ranks ended apart: {sums}")
        if eng.tp is not None and any(row != whole[0] for row in whole):
            raise SystemExit(
                f"the model ranks' replicated leaves ended apart: {whole}")
    return losses


def _world(mesh) -> int:
    return 1 if mesh is None else torch.distributed.get_world_size()


def _init_mesh(args, ap):
    """The process group and data mesh of ``--mesh`` (None, None without
    it): the world from ``torch.distributed.run``'s environment; a
    single process with no rendezvous address runs a world of one over a
    file store.  A group that does not start raises."""
    if not args.mesh:
        return None, None
    shape = {}
    for part in args.mesh.split(","):
        k, _, v = part.partition("=")
        if k not in ("pod", "data", "model") or not v.isdigit():
            ap.error(f"--mesh {args.mesh!r}: expected data=N[,model=M]")
        shape[k] = int(v)
    shape.setdefault("model", 1)
    cuda = torch.device(args.device).type == "cuda"
    backend = args.dist_backend or ("nccl" if cuda else "gloo")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if cuda and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    init = "env://"
    if "MASTER_ADDR" not in os.environ:
        if world != 1:
            ap.error(f"a world of {world} needs torch.distributed.run's "
                     "rendezvous (MASTER_ADDR / MASTER_PORT)")
        init = "file://" + tempfile.mktemp(prefix="train-pg-")
    torch.distributed.init_process_group(backend, init_method=init,
                                         rank=rank, world_size=world)
    return make_mesh(shape, "cuda" if cuda else "cpu"), backend


def _agree_stop(sig, mesh, dev) -> bool:
    """Whether any rank was signalled to stop (every rank stops after the
    same step)."""
    if mesh is None:
        return sig is not None
    nccl = torch.distributed.get_backend() == "nccl"
    flag = torch.tensor([int(sig is not None)],
                        device=dev if nccl else "cpu")
    torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
    return bool(flag.item())

if __name__ == "__main__":
    main()
