"""Serving CLI: continuous batching by default, one-shot mode beside
it (the port of ``repro/launch/serve.py``)::

    # continuous batching: paged KV, per-request join/leave, one relay
    # sweep per decode tick for all in-flight requests
    PYTHONPATH=src python -m repro_torch.launch.serve --variant full \
        --weight-stream --pack --prefetch 1 --transport pallas \
        --requests 12 --max-batch 8 --prompt-len 128 --gen 16 \
        --prefill-chunk 64

    # one fixed batch: prefill, then lockstep decode
    PYTHONPATH=src python -m repro_torch.launch.serve --mode oneshot \
        --variant full --weight-stream --pack --prefetch 1 --transport pallas

whisper-base (``--arch whisper-base``) always runs one-shot, on random
frames; internvl2-1b serves its language backbone (text only) either way.

Runs on the card unless ``--device cpu``.  With ``--weight-stream`` the
layer stack rests in pinned host memory and every decode step (every
tick) relays it through HBM one slot at a time.  The first tick / step
pays one-time costs (kernel builds, allocator warm-up) and is timed
apart.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import engine as engines
from repro_torch.configs.base import get_config
from repro_torch.core.schedule import ExecutionConfig
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.sampling import sample_batch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def default_page_size(max_seq):
    """Largest divisor of max_seq not above max_seq // 4 (>= 1), so the
    default paging always satisfies the divide constraint for arbitrary
    --prompt-len/--gen combinations."""
    p = max(1, max_seq // 4)
    while max_seq % p:
        p -= 1
    return p


def run_oneshot(eng, cfg, args):
    """One fixed batch: prefill the caches, then decode in lockstep."""
    dev = eng.device
    params = eng.init_params(
        torch.Generator(device=dev).manual_seed(args.seed))
    live = args.cache_len or (args.window if args.window
                              else args.prompt_len + args.gen)
    prompt = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator(device=dev).manual_seed(args.seed + 1),
        device=dev)
    frames = None
    if cfg.family == "audio":
        frames = torch.randn(
            (args.batch, cfg.n_frames, cfg.d_model),
            generator=torch.Generator(device=dev).manual_seed(2),
            device=dev).to(torch.bfloat16)

    def pick(logits, pos):
        return sample_batch(logits, temperature=args.temperature,
                            top_k=args.top_k, seed=args.seed,
                            position=pos)[:, None]

    t0 = time.perf_counter()
    caches, last_logits = eng.decode_init(params, prompt, live, frames=frames)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = pick(last_logits, args.prompt_len - 1)
    out_tokens = [tok]
    # the first step pays one-time costs (kernel builds, allocator warm-up)
    t0 = time.perf_counter()
    logits, caches = eng.decode_step(params, caches, tok, args.prompt_len)
    tok = pick(logits[:, -1], args.prompt_len)
    out_tokens.append(tok)
    _sync(dev)
    t_first = time.perf_counter() - t0

    steady_steps = max(args.gen - 2, 0)
    t0 = time.perf_counter()
    for i in range(steady_steps):
        pos = args.prompt_len + 1 + i
        logits, caches = eng.decode_step(params, caches, tok, pos)
        tok = pick(logits[:, -1], pos)
        out_tokens.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    toks = torch.cat(out_tokens, dim=1)
    n_steady = args.batch * steady_steps
    print(f"arch={cfg.name} device={dev} B={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} cache={live} "
          f"temp={args.temperature} top_k={args.top_k}")
    print(f"prefill: {t_prefill:.2f}s  first decode step: {t_first:.2f}s  "
          f"steady decode: {t_decode:.2f}s ({n_steady} tok -> "
          f"{n_steady / max(t_decode, 1e-9):.1f} tok/s)")
    print("sample:", toks[0, :16].tolist())
    return toks


def run_continuous(eng, cfg, args):
    """Continuous batching: requests join/leave a shared slot pool; every
    decode tick is ONE relay sweep for all in-flight sequences."""
    params = eng.init_params(
        torch.Generator(device=eng.device).manual_seed(args.seed))
    max_seq = args.window or (args.prompt_len + args.gen)
    scfg = ServeConfig(
        max_batch=args.max_batch,
        page_size=args.page_size or default_page_size(max_seq),
        n_pages=args.n_pages or 4 * args.max_batch,
        max_seq=max_seq, prefill_chunk=args.prefill_chunk,
        max_pending=args.max_pending)
    srv = eng.serve_session(params, scfg)
    rng = np.random.RandomState(args.seed + 1)
    reqs = [srv.submit(rng.randint(0, cfg.vocab_size,
                                   size=(args.prompt_len,)),
                       args.gen, temperature=args.temperature,
                       top_k=args.top_k, seed=args.seed + i,
                       ttl=args.ttl)
            for i in range(args.requests)]

    t0 = time.perf_counter()
    srv.tick()                          # the first tick pays one-time costs
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv.run()
    t_serve = time.perf_counter() - t0

    lat = [r.t_done - r.t_submit for r in reqs if r.t_done is not None]
    tok_lat = [b - a for r in reqs
               for a, b in zip(r.token_times, r.token_times[1:])]
    n_tok = sum(len(r.generated) for r in reqs)
    st = srv.stats()
    print(f"arch={cfg.name} device={eng.device} requests={args.requests} "
          f"max_batch={scfg.max_batch} pages={scfg.n_pages}x"
          f"{scfg.page_size} prompt={args.prompt_len} gen={args.gen}")
    print(f"first tick: {t_first:.2f}s  serve: {t_serve:.2f}s "
          f"({n_tok} tok -> {n_tok / max(t_serve, 1e-9):.1f} tok/s, "
          f"{srv.n_ticks} ticks)  done={st['finished'] - st['evicted']} "
          f"rejected={st['rejected']} evicted={st['evicted']}")
    if tok_lat:
        print(f"per-token latency p50/p99: "
              f"{np.percentile(tok_lat, 50) * 1e3:.1f}/"
              f"{np.percentile(tok_lat, 99) * 1e3:.1f} ms")
    if lat:
        print(f"per-request latency p50/p99: {np.percentile(lat, 50):.2f}/"
              f"{np.percentile(lat, 99):.2f} s")
    print("sample:", reqs[0].generated[:16])
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("continuous", "oneshot"),
                    default="continuous")
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4,
                    help="oneshot: fixed decode batch")
    ap.add_argument("--requests", type=int, default=8,
                    help="continuous: number of requests to serve")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="continuous: in-flight slot pool size")
    ap.add_argument("--page-size", type=int, default=0,
                    help="continuous: KV page size (0 = max_seq/4)")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="continuous: KV page pool (0 = 4*max_batch)")
    ap.add_argument("--prefill-chunk", type=int, default=1,
                    help="continuous: prompt tokens per tick while "
                         "prefilling")
    ap.add_argument("--ttl", type=float, default=0.0,
                    help="continuous: per-request deadline in seconds — "
                         "requests still pending or mid-decode past it "
                         "are evicted and their slot/pages recycled "
                         "(0 = no deadline)")
    ap.add_argument("--max-pending", type=int, default=0,
                    help="continuous: admission bound — submits beyond "
                         "this many queued requests are rejected "
                         "(0 = unbounded)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples with per-request seeds")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k best logits (0 = off)")
    ap.add_argument("--weight-stream", action="store_true")
    ap.add_argument("--prefetch", type=int, default=0,
                    help="k-deep decode weight-relay prefetch ring")
    ap.add_argument("--group", type=int, default=1,
                    help="G = layers per decode relay stop")
    ap.add_argument("--pack", action="store_true",
                    help="packed relay: one flat buffer per layer per dtype")
    ap.add_argument("--transport", default="xla", choices=["xla", "pallas"],
                    help="device-resident streams: view ('xla') or the "
                         "relay-copy kernel ('pallas'); pinned streams "
                         "always use the kernel")
    ap.add_argument("--window", type=int, default=0,
                    help="ring-buffer window (long-context mode)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, args.variant)
    eng = engines.create("l2l", cfg, ExecutionConfig(
        weight_stream=args.weight_stream, prefetch_depth=args.prefetch,
        layers_per_relay=args.group, pack_params=args.pack,
        transport=args.transport, decode_window=args.window),
        device=args.device)
    if args.mode == "oneshot" or cfg.family == "audio":
        # continuous batching refuses the audio family (its encoder K/V
        # is per request, not paged)
        return run_oneshot(eng, cfg, args)
    return run_continuous(eng, cfg, args)


if __name__ == "__main__":
    main()
