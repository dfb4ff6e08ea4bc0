"""Serving driver, one-shot mode: one fixed batch, prefill, then lockstep
decode (the port of ``repro/launch/serve.py --mode oneshot``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --mode oneshot \
        --variant full --weight-stream --pack --prefetch 1 --transport pallas

Runs on the card unless ``--device cpu``.  With ``--weight-stream`` the
layer stack rests in pinned host memory and every decode step relays it
through HBM one slot at a time.  The continuous-batching mode comes with
a later slice of the port.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import engine as engines
from repro_torch.configs.base import get_config
from repro_torch.core.schedule import ExecutionConfig
from repro_torch.serve.sampling import sample_batch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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

    def pick(logits, pos):
        return sample_batch(logits, temperature=args.temperature,
                            top_k=args.top_k, seed=args.seed,
                            position=pos)[:, None]

    t0 = time.perf_counter()
    caches, last_logits = eng.decode_init(params, prompt, live)
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("oneshot",), default="oneshot")
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
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
    return run_oneshot(eng, cfg, args)


if __name__ == "__main__":
    main()
