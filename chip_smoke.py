#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root, one card

Phases, one JSON line each:

1. build    — compile the CUDA C++ kernels from the checkout's sources
              (one nvcc per source, all started together);
   sm90-kernels — the wgmma kernels (K2, K3a and K3b's bf16 route) at
              each head dim, nine in all: ptxas's registers and spill
              bytes, their dynamic shared memory and the HGMMA instructions
              in their SASS (both must be: no spills, tensor-core
              instructions present);
2. init     — granite-3-8b at full width, random weights from a seeded CUDA
              generator, drawn layer by layer into the pinned-host EPS;
3. kernels  — every kernel (serving: K2, K4 fetch, K5; training: K1,
              K2, K3a, K3b, K4 write-back) against its plain PyTorch
              version on the card, at the paths' shapes, with times; the
              bf16 K2, K3a and K3b rows also time the CUDA-core kernel bf16
              took before (``previous_ms``, in turns with the new one) and
              give SDPA's own error against the plain version
              (``library_err``); K3a's and K3b's ``library_ms`` is SDPA's
              whole backward as device time (its kernels' spans under
              torch.profiler, taken in the library phase after the train
              phase, as no profiler may run before the timed phases);
              K5's rows time the CUDA kernel, the Triton kernel it
              replaced (``previous_ms``) and ``F.rms_norm`` in turns, from
              a CUDA graph and eagerly (``eager_ms``,
              ``previous_eager_ms``, ``library_eager_ms``); K4's rows time
              the relay's route, the kernel it replaced (``previous_ms``)
              and ``copy_`` in turns on the same buffers, with the host
              allocation and the grid, and K4 is checked bit for bit on
              every host allocation kind (``k4_checks``); hymba-1.5b's
              attention: K2 at its window prefill (1, 4096, 25, 64), 5 kv
              heads, window 2048, against SDPA with the window as a
              boolean mask over the kv heads repeated, K3a / K3b at its
              training microbatch (4, 512, 25, 64), and K5 at its width
              1600; internvl2-1b's attention (GQA 14 over 2): K2 at its
              prefill (2, 2304, 14, 64) against SDPA over the kv heads
              repeated, K3a / K3b at its training microbatch (4, 768, 14,
              64), K5 at its width 896; grok-1-314b's: K2 at its prefill
              (2, 2048, 48, 128) over 8 kv heads against SDPA over them
              repeated, K5 at its width 6144; the f32 routes of K2, K3a
              and K3b (the CUDA-core kernels the f32 gradient checks run)
              at bert-large's microbatch (8, 512, 16, 64) beside SDPA in
              f32, bounded by the card's f32 rate outside the tensor
              cores; K4 each way at an internvl2 layer
              row (59.6 MB) and whisper-base's encoder and decoder rows
              (12.6 / 16.8 MB) against ``copy_``; the model axis's
              per-rank shapes: K2 and K3a / K3b at bert-large's 8 of 16
              heads, K2 at granite-3-8b's 16 of 32 q heads over 4 kv,
              K2 at internvl2's prefill (2, 2304, 7, 64) and K3a / K3b at
              its training microbatch (4, 768, 7, 64) over 1 kv head,
              and K4 each way at one model rank's layer rows (bert-large,
              granite-3-8b, hymba-1.5b, rwkv6-1.6b, deepseek-v2-lite's MoE
              layer, internvl2's layer, whisper's encoder and decoder
              layers); then
   k4-sweep — K4's designs, one lever at a time, on one granite row
              pinned host -> HBM and one bert-large row back, on each
              host allocation kind, with ``copy_``; a fetch and
              write-backs together on two streams; the round trip of one
              read of host memory (``k4_sweep``);
   layer    — one decode layer's compute time beside one row copy, and one
              2048-token prefill layer alone and beside row fetches by
              the relay's route, by the kernel it replaced and by
              ``copy_``;
4. grid     — the relay knobs (pack, prefetch, G, resting place) at smoke
              size on the card: results bitwise equal;
5. serve    — the l2l engine (weight_stream, pack_params, prefetch 1,
              transport "pallas", use_pallas): decode_init on 4 prompts of
              16 tokens, then 8 greedy decode steps;
6. prefill  — Engine.prefill on the same prompts, held to decode_init's
              last-token logits (bf16 and f32, depth 1 and full), then one
              prefill at B=2, S=2048;
   launches — K2, K4 and K5's counts over the serving path (the serve
              phase and phase 6's two prefills), read before the
              comparison engines run;
   serve-dense — chatglm3-6b (all 28 layers unless the host cannot pin
              them), command-r-35b and qwen1.5-110b (2 layers) at full
              width through the serve phase's engine settings: decode_init
              on 4 prompts of 16 tokens, 4 greedy steps, Engine.prefill held
              to decode_init's last-token logits (and in f32 at depth 1,
              where qwen's K5 rows reach their 32 KB limit); the counters
              set to 0 before each model and read after its prefill;
   serve-continuous — (run right after the serve phase, on its pinned
              rows) granite-3-8b at full width and depth 20 (the first 20
              of the serve phase's 40 rows) through a
              continuous-batching ServeEngine with the serve phase's
              engine settings (8 slots, 128 pages of 16 positions, 384
              per slot, prefill chunks of 64): 12 greedy requests
              (prompts of 32-256 tokens, 8-16 new) that wait on slots and
              pages and join as others leave, the counters set to 0 just
              before the first tick and read after the last; ticks,
              seconds, tok/s, the median tick, K4 fetches and K5 launches
              per tick, the scheduler's stats, the peak beside
              ``Engine.serve_memory_estimate``; every request done, every
              page and slot free, the peak under 25% of the model's
              bytes; then the request that waited longest alone through a
              fresh ServeEngine, its tokens equal to the crowd's bit for
              bit; then at depth 2 in f32, three requests against
              decode_init / decode_step with each prompt on every row,
              tokens equal;
7. train-grid — the training knobs (pack, prefetch, G, stash_every,
              where weights and stash rest, l2l against l2l-p) at smoke
              size on the card: loss, params and Adam slots bitwise equal;
8. identity — bert-large at full width, depth 2, f32: one l2l-p step
              against the baseline engine on the same batch;
   checkpoint — bert-large at full width, depth 2, under l2l-p with
              pinned rows: 2 steps, Engine.save, restore into a fresh engine,
              2 more steps, against 4 uninterrupted steps bit for bit;
   train-rmsnorm — chatglm3-6b at full width, depth 2 (an RMSNorm model,
              GQA 16), l2l-p with the train phase's knobs: 2 steps at B=8,
              S=512, UB=2 with every counter set to 0 just before and read
              just after (K5 under grad: ``rmsnorm_diff``); then Engine.grads
              in f32 against the same call with K5's plain version patched
              in, every norm scale's gradient not zero, and K3a/K3b at the
              path's GQA-16 microbatch against their plain version;
   dynamic-depth — (run after serve-continuous, on the serve phase's
              pinned rows) ``ExecutionConfig.dynamic_depth``, the counters set
              to 0 just before and read just after: granite-3-8b at full
              width and the serve phase's depth with its settings,
              decode_init and 2 greedy steps on its 4 prompts at run depth
              n = 40 (tokens equal to the serve phase's, bit for bit) and
              n = 20 on the same engine and rows, on the prompts' first 4
              tokens (tok/s, K4 fetches per step, relay GB/s at both); bert-large at full width,
              capacity 24, the train phase's settings, one step at n = 12
              (rows 12-23 of the weights and Adam slots unchanged bit for
              bit) and one at n = 24, the steps' peaks side by side.  Not
              counted: the n = 12 loss against a static 12-layer engine's
              first step on the same rows, and a capacity-4 granite engine
              at n = 2 against a static 2-layer one on the same rows
              (prefill and decode logits), each bit for bit;
   serve-moe — deepseek-v2-lite-16b (MLA, 64 routed experts top 6 and 2
              shared, a dense layer 0 then MoE layers: two layer groups)
              at full width and depth 4 through the serve phase's
              engine settings, the counters set to 0 just before and read just
              after: decode_init on 4 prompts of 16 tokens, 4 greedy
              steps, Engine.prefill on them and at B=2 x S=2048 (the
              capacity path), then 12 greedy requests (prompts of 32-128
              tokens, 8-16 new) into 8 slots with prefill chunks of 16
              (128 rows a tick, the dense MoE path); not counted: the
              request that waited longest alone (bit for bit the crowd's),
              the 2048-token prefill's peak at depth 3 (within 5% of depth
              4's), prefill against decode_init in f32 at depth 2, one
              fetch of each row kind;
   train-moe — deepseek-v2-lite-16b at full width and depth 2 (the dense
              layer 0 + 1 MoE layer), l2l-p with the
              train phase's knobs,
              2 steps at B=8, S=512, UB=2, the counters set to 0 just
              before and read just after; then Engine.grads in f32 at depth
              2 against the baseline engine at fan-in scales, and one step
              at depth 2 run twice from the same state, bitwise;
   serve-grok — (run last, after memory-model, when the host holds
              little else) grok-1-314b at full width (d 6144, 48
              heads over 8, 8 experts top 2 of d_ff 32768, vocab 131072,
              logits capped at 30 by a soft cap) and the depth the host
              can pin (at most 1, for time: a 19.7 GB f32 row pins a
              power of two; MemAvailable
              printed, and the phase fails if one layer cannot be
              pinned), drawn layer by layer on the card, through the
              serve phase's engine settings, counted: decode_init on 4
              prompts of 4 tokens, 2 greedy steps, Engine.prefill at 4 x
              16 and 2 x 2048; logits finite and within the cap, every
              token's 2 of 8 experts distinct, one fetch a layer and the
              ring's re-fetch; not counted: one K4 fetch of a whole
              19.7 GB row against ``copy_`` in turns, bit for bit against
              the plain version;
   serve-recurrent — hymba-1.5b (32 layers: attention heads, GQA 25
              over 5 with a 2048-token window, beside Mamba heads off one
              norm) and rwkv6-1.6b (24 layers: WKV6, layernorm, no
              attention) at full width and depth through the serve
              phase's engine settings, the counters set to 0 just before
              each model and read just after: decode_init on 4 prompts of
              16 tokens, 8 greedy steps, Engine.prefill on them and at
              B=2 x S=2048, for hymba also at B=1 x S=4096 (its window
              masks; K2 once a layer), then 12 greedy requests into 8
              slots (one token a tick); not counted: the request that
              waited longest alone (bit for bit the crowd's), prefill
              against decode_init in f32 at depth 2 and in bf16 at depths
              1, 4 (also at fan-in scales) and full, one layer's scan
              timed;
   train-recurrent — each at full width under l2l-p (hymba at 4 of its
              32 layers, rwkv6 at 3 of its 24:
              its WKV step loop is
              host-bound) with the train phase's knobs, 3 steps at B=8,
              S=512, UB=2, the
              counters set to 0 just before and read just after; then
              Engine.grads in f32 at depth 2 against the baseline engine,
              the relay knobs (pack, prefetch, G) at depth 3 against the
              plain schedule, and one step at depth 2 run twice: bitwise;
   serve-vlm — internvl2-1b (24 layers, d 896, 14 heads over 2; 256
              stub patches of 1024 projected in front of the tokens) at
              full width and depth through the serve phase's engine
              settings, the counters set to 0 just before and read just
              after: decode_init on 4 text prompts of 128 tokens (the
              reference decodes the language backbone), 8 greedy steps,
              Engine.prefill at 4 x 128 and 2 x 2048 tokens behind the
              patches (384 and 2304 positions: the flash kernels' 128-row
              tiles); not counted: text-only prefill against decode_init
              in f32 at depth 2 and in bf16 at depth 1 (bounded) and full
              depth (printed);
   train-vlm — internvl2-1b at full width and depth under l2l-p with the
              train phase's knobs, B=8 x 512 tokens behind 256 patches,
              UB=2, 3 steps, counted; then the train-recurrent checks
              (grads in f32 at depth 2 against the baseline, the relay
              knobs with K = 2 at depth 3, a repeated step: bitwise);
   serve-audio — whisper-base (6 encoder + 6 decoder layers, d 512, 1500
              stub frames) at full width and depth, ``use_pallas=False``
              (1500 frames do not tile by 128: plain attention, as the
              reference must run it), counted: decode_init with the
              frames on 4 prompts of 16 (the encoder's one-shot pass and
              the decoder's cross K/V through the relay: its fetches
              printed), 8 greedy steps, Engine.prefill at 4 x 448 target
              tokens; not counted: prefill against decode_init at full
              depth in f32 at fan-in scales (bounded) and at the
              reference's init in f32 and bf16 (printed);
   train-audio — whisper-base under l2l-p with the train phase's knobs,
              B=8 x 448 target tokens with 1500 frames, UB=2, 3 steps,
              counted; then the train-vlm checks;
   tier     — the disk tier (``tiers=3``): tier-train, bert-large at
              full width and 8 of its 24 layers under l2l-p with the train
              phase's knobs, B=32 x 512, UB=4, 2 steps with 4 of the 8 layers'
              weights and Adam slots demoted to segment files under
              build/ (counted from the tier engine's init to its last
              step), its state bit for bit a two-tier run's from the same
              init, the host bytes it holds after its steps below the
              two-tier run's by at least half the demoted bytes; the step
              seconds beside the two-tier steps, the tier's stage-in,
              stage-out and pinning seconds, its read and write GB/s and
              the filesystem of its directory; tier-serve, internvl2-1b at full width and depth
              with 12 of its 24 layers demoted through the serve phase's
              settings, counted: Engine.prefill at 4 x (128 + 256),
              decode_init on 4 prompts of 16 and 4 greedy steps, bit for
              bit the same calls of a two-tier engine;
9. train    — bert-large at full width and all 24 layers, l2l-p with
              weight_stream, pack_params, prefetch 1, transport "pallas",
              use_pallas, offload_stash, Adam: the peak HBM of two steps
              at depth 12, then 5 steps at B=32, S=512, UB=4 on one
              repeated synthetic batch, every kernel counter set to 0
              just before and read just after (step 1's rows kept for the
              next phase);
   host-optimizer — the train phase's engine with ``host_optimizer``, 3
              steps on the same batch (5 before PR 24), the counters set to 0 just before
              and read just after: step 1's rows held to the train phase's
              (max abs 1e-6, an equal loss; whether bitwise is printed,
              and when bitwise the three losses equal the train phase's first),
              and the square root of layer 0's second moment on the
              card against PyTorch's CPU kernel and ``sqrt_rn`` (which
              must agree with the card);
              per step the seconds, relay GB each way, K4 fetches and
              write-backs, K1 launches (must be 0), the CPU's update ms
              per layer and the main thread's wait on the worker; then
              one profiled step of the train phase and one of this
              phase (the device's idle share), after every timed phase;
   library  — SDPA backward's device time and K3a's and K3b's, under
              torch.profiler, into the kernel rows (hymba's too);
   scan-profile — one layer's sequence scan of each recurrent family at
              the 2 x 2048 prefill's shape under torch.profiler: device
              time, device operations, wall time;
   recurrent-profile — one train-recurrent step of each family at
              depth 1 under torch.profiler: the device's idle share and
              its time by kernel;
   train-dp — data parallel over the mesh's data
              axes, bert-large at full width and 3 of its 24 layers,
              B=32 x 512, UB=4,
              l2l-p through the train CLI's configuration: (a) in this
              process, NCCL over a world of one (a FileStore under
              build/) and a (data=1, model=1) mesh, 3 steps counted beside
              3 meshless steps from the same state, bit for bit (losses,
              weight and Adam checksums), 6 layer rows + the static tree
              + 2 scalars all-reduced a step; (b) two gloo ranks on this
              card through ``python -m torch.distributed.run -m
              repro_torch.launch.train --mesh data=2``, each rank its own
              pinned EPS: the ranks' final checksums equal, the losses
              beside (a)'s meshless ones; its f32 check (depth 2,
              fan-in scales, one step, against one process on the whole
              batch: losses 1e-5, each leaf's update 1e-3 relative L2)
              runs in the tp phase's world on the CLI's relay; wall
              time, reduction ms and GB a step for each part;
   tp       — the mesh's model axis: two gloo ranks on this card through
              ``python -m torch.distributed.run chip_smoke.py --tp-rank``
              on a (data=1, model=2) mesh.  train-tp: bert-large at full
              width (8 of 16 heads, 2048 of 4096 ffn columns, 15261 of
              30522 vocabulary rows a rank), depth 2, B=32 x 512, UB=4,
              l2l-p unpacked through the train CLI's configuration, 3
              steps counted (each rank's weights the slices of the
              one-process draw by checksum, the ranks' replicated leaves
              and Adam slots equal, the losses within 1e-3 of one
              process), then in f32 at depth 2 and fan-in scales, one
              draw on every rank, one step on the CLI's relay, against
              one process (losses 1e-5, updates 1e-3);
              serve-tp: granite-3-8b at full width (16 of 32 q heads, 4 of
              8 kv heads, 6400 of 12800 ffn columns, the 49155-row
              vocabulary whole), depth 2, weight_stream unpacked, counted:
              decode_init on 4 prompts of 16, 4 greedy steps, prefill
              (within the serve phase's 0.35 of decode_init, top-1 on 3 of
              4 rows), bf16 logits within 0.35 of one process on the same
              weights, in f32 at fan-in scales tokens equal and logits
              within 1e-4; model-group collectives, bytes and ms a step,
              K2/K3a/K3b/K4 launches a step, tok/s, K4 GB a step a rank;
              then the MoE family (``tp_rank_moe``), deepseek-v2-lite at
              full width (8 of 16 heads, experts 32 of 64 and the router's
              matching columns, 1408 of the shared experts' 2816 columns,
              5472 of layer 0's 10944, 51200 of 102400 vocabulary rows a
              rank): train-moe-tp, the dense layer 0 and one MoE layer,
              B=8 x 512, UB=2, l2l-p unpacked, 1 step counted (the
              weights the one-process slices, the replicated leaves and
              Adam slots equal, losses within 1e-3 of one process);
              train-moe-dp, the same on a (data=2, model=1) mesh over the
              same ranks, packed (K1), prefetch 0, each rank its block of
              every microbatch, counted (checksums equal, losses within
              1e-3 of one process, the MoE's statistics sums and count
              exchanges a step apart from the gradient rows); each then in
              f32 at fan-in scales, one step on its own relay, against
              one process (losses 1e-5, aux 1e-5, updates 1e-3);
              serve-moe-tp, depth 3, weight_stream unpacked, counted:
              decode_init on 4 prompts of 16, 4 greedy steps, prefill,
              bf16 logits within 0.35 of one process, in f32 at fan-in
              scales on the same relay tokens equal and logits within
              1e-4 of one process, K4 GB a step a
              rank beside one process's; and train-dp's f32 check
              (``tp_rank_dp_f32``) on the (data=2, model=1) mesh; then
              the hybrid and SSM families (``tp_rank_recurrent``):
              train-hybrid-tp, hymba-1.5b at full width (its 25 q and 5 kv
              heads do not split over 2: the attention runs whole on each
              rank; 800 of 1600 mamba channels, 2752 of 5504 MLP columns,
              the 32001-row vocabulary whole), depth 2, B=8 x 512, UB=2,
              l2l-p unpacked through the train CLI's configuration, 2
              steps counted (the weights the one-process slices, the
              replicated leaves and Adam slots equal, losses within 1e-3
              of one process), one f32 step at fan-in scales on the CLI's
              relay against one process (losses 1e-5, updates 1e-3), and
              its decode in f32 at depth 1 (decode_init on 4 prompts of
              16, 2 greedy steps: tokens equal, logits within 1e-4);
              serve-ssm-tp, rwkv6-1.6b at full width (16 of 32 heads, 1024
              of 2048 channels, 3584 of 7168 ffn columns, 32768 of 65536
              vocabulary rows a rank), depth 2, weight_stream unpacked,
              counted: decode_init on 4 prompts of 16, 4 greedy steps,
              prefill, bf16 logits within 0.35 of one process, in f32 at
              fan-in scales tokens equal and logits within 1e-4, then one
              f32 l2l-p step at depth 1 on the relay against one process
              (losses 1e-5, updates 1e-3); then the VLM and audio families
              (``tp_rank_modality``): train-vlm-tp, internvl2-1b at full
              width (7 of 14 q heads over 1 of 2 kv heads, 2432 of 4864
              MLP columns, the 151655-row vocabulary and the patch
              projection whole), depth 2, B=8 x (512 + 256 patches), UB=2,
              l2l-p unpacked through the train CLI's configuration, 2
              steps counted (the weights the one-process slices, the
              replicated leaves and Adam slots equal, losses within 1e-3
              of one process), one f32 step at fan-in scales on the CLI's
              relay against one process (losses 1e-5, updates 1e-3), and
              its decode in f32 at depth 1 (decode_init on 4 text prompts
              of 128, 2 greedy steps, prefill behind 256 patches: tokens
              equal, logits within 1e-4); serve-audio-tp, whisper-base at
              full width and depth (6 + 6 layers, 4 of 8 heads and kv
              heads in each attention, 1024 of 2048 MLP columns, the
              51865-row vocabulary and enc_ln_post whole; plain attend),
              weight_stream unpacked, counted: decode_init on 4 prompts of
              16 with 1500 frames, 4 greedy steps, prefill, bf16 logits
              within 0.35 of one process, K4 GB a step a rank beside one
              process's, in f32 at fan-in scales tokens equal and logits
              within 1e-4, then one f32 l2l-p step at full depth on the
              relay against one process (losses 1e-5, updates 1e-3: the
              memory's cotangent summed over the ranks into the encoder);
   memory-model — ``Engine.memory_estimate`` for the train phase's
              bert-large at depths 24 and 12 beside its peaks, and the
              serve estimate beside serve-continuous's peak (printed, not
              tied: the model counts the reference's buffers);
10. launches — every kernel's count over the thirty main paths
              (serve, serve-dense, serve-continuous, train, train-rmsnorm,
              dynamic-depth, host-optimizer, train-dp, serve-moe, train-moe,
              serve-hymba, train-hymba, serve-rwkv6, train-rwkv6,
              serve-vlm, train-vlm, serve-audio, train-audio, serve-grok,
              tier-train, tier-serve, train-tp, serve-tp, train-moe-tp,
              train-moe-dp, serve-moe-tp, train-hybrid-tp, serve-ssm-tp,
              train-vlm-tp, serve-audio-tp (summed over the two ranks);
              each of a path's kernels > 0, K1 0 on host-optimizer, K2
              and K3 0 on the five MoE paths, K2, K3 and K5 0 on the rwkv6
              paths (serve-ssm-tp's too) and whisper's (serve-audio-tp's
              too)),
              and the counts by route: every
              bf16 K2, K3a and K3b
              launch on the wgmma route, none on the CUDA-core one, every
              K5 launch on the CUDA route, none on the Triton one, and every
              K4 fetch and write-back on the relay's route ("lines"), none
              on the kernels it replaced.

Then the kernel table line (each kernel's launches in all and by path),
the card's name and power limit, and the result line.  Every phase line
carries ``elapsed_s``, the seconds since the script started.  Any failed
check raises, so the script exits nonzero and
prints no result line.  TF32 is off for matmuls and cuDNN
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``) so f32 comparisons are f32.
The depth is cut (never the width) only when the host cannot hold the
pinned EPS; the depth used is printed.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_HBM_BPS = 3.35e12        # bytes/s, H100 SXM data sheet
H100_BF16_OPS = 989e12        # dense bf16 tensor-core FLOP/s
H100_F32_OPS = 67e12          # f32 FLOP/s outside the tensor cores
PCIE5_X16_BPS = 64e9          # bytes/s each way


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line gains the seconds since the start,
    the process's resident bytes (pinned host memory included) and the
    host's MemAvailable."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T0, 1),
               "process_rss_bytes": rss_bytes(),
               "host_mem_available_bytes": mem_available()}
    print(json.dumps(obj), flush=True)


def rss_bytes() -> int:
    """This process's resident set (VmRSS of /proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def time_ms(torch, fn, reps, warmup=2):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps):
    """Mean device time of ``fn`` with the host out of the way: ``reps``
    calls captured in one CUDA graph, the graph replayed and timed with
    events.  At small shapes ``time_ms``'s back-to-back eager calls time
    the host's issue rate, not the kernel."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * reps)


def device_ms(torch, fn, reps):
    """Mean device time of ``fn``: the summed spans of the device kernels
    and copies that ``reps`` eager calls ran, under torch.profiler.  For a
    call a CUDA graph cannot capture (SDPA's backward runs in the autograd
    engine).  Only after the timed phases: runs that profiled before the
    train phase took longer per train step on the host, as if the
    profiler left every later launch dearer."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    # a trace that caught no device span at all is taken again (one run of
    # the script saw CUPTI return none for one K3 call; the others ran)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    raise AssertionError("the profiler saw no device time in three traces")


def rotation(torch, fns, reps, timer=graph_ms):
    """Mean time of each of ``fns`` (by ``graph_ms`` unless another
    ``timer`` is given), timed in order and then in reverse order (new,
    old, old, new; or a, b, c, c, b, a) on the same inputs."""
    times = [timer(torch, f, reps) for f in (*fns, *fns[::-1])]
    n = len(fns)
    return tuple((times[i] + times[2 * n - 1 - i]) / 2 for i in range(n))


def reset_counts(counters):
    """Set every kernel counter (and its per-route counts) to 0."""
    for c in counters:
        c.launches = 0
        for r in getattr(c, "launches_by_route", ()):
            c.launches_by_route[r] = 0


def route_counts(counters):
    """The launches by route of the kernels in ``counters`` (name ->
    wrapper) that have routes: K2, K3a, K3b (wgmma / cuda_core) and K5
    (cuda / triton)."""
    return {n: dict(c.launches_by_route) for n, c in counters.items()
            if hasattr(c, "launches_by_route")}


def mem_available() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def host_depth(layer_bytes: int, n_layers: int, reserve: int) -> int:
    """Layers whose pinned EPS fits in MemAvailable beside ``reserve``
    bytes.  Pinned allocations are rounded up to a power of two."""
    avail = mem_available()
    depth = n_layers
    while depth > 1 and \
            2 ** math.ceil(math.log2(depth * layer_bytes)) + reserve > avail:
        depth -= 1
    return depth


def bf16_ulp_ok(torch, got, ref):
    """|got - ref| <= one bf16 ulp of ref, elementwise."""
    _, e = torch.frexp(ref.float())
    ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)
    return bool(((got.float() - ref.float()).abs() <= ulp).all())


def host_facts():
    """The host's CPU model and the card's PCIe link (where nvidia-smi
    reads it): two calls may land on two hosts."""
    facts = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key = ln.split(":", 1)[0].strip()
                if key in ("vendor_id", "cpu family", "model", "model name") \
                        and key not in facts:
                    facts[key] = ln.split(":", 1)[1].strip()
    except OSError:
        pass
    facts["cpus"] = os.cpu_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,"
         "pcie.link.width.current,pcie.link.gen.max,pcie.link.width.max",
         "--format=csv,noheader"], capture_output=True, text=True)
    facts["pcie_gen_width_current_max"] = (smi.stdout.strip() or None
                                           if smi.returncode == 0 else None)
    return facts


def k4_checks(torch, rc, ha, dev):
    """K4 bit for bit on every host allocation kind, by the relay's route
    and the one it replaced: the fetch of a half-row plan (one row, split
    in two chunks) and a multi-row plan, and the write-back of one row;
    rows of 1024 f32 (16-byte aligned), 1028 f32 (row 1 starts 16 bytes
    into a 128-byte line: a head and a tail peeled off), 1001 f32 (4-byte
    aligned) and 1001 bytes (1-byte).  Returns the count of checks."""
    checks = 0
    for kind in ha.KINDS:
        for dt, w in ((torch.float32, 1024), (torch.float32, 1028),
                      (torch.float32, 1001), (torch.uint8, 1001)):
            vals = torch.arange(3 * w).remainder(251).to(dt).view(3, w)
            src = ha.empty((3, w), dt, kind=kind)
            src.copy_(vals)                    # the CPU writes, never reads
            dst = ha.empty((3, w), dt, kind=kind)
            for route in (rc.FETCH_ROUTE, "tma_tiles", "words"):
                for r0, sz in ((1, 1), (0, 3)):
                    got = rc.copy_rows(src, r0, size=sz, device=dev,
                                       route=route)
                    assert torch.equal(got.cpu(), vals[r0:r0 + sz]), \
                        ("k4 fetch", kind, dt, w, route, r0, sz)
                    checks += 1
                dst.copy_(torch.zeros_like(vals))
                rc.writeback_rows(vals[1].to(dev), dst, 1, route=route)
                back = torch.empty(3, w, dtype=dt, device=dev)
                rc.copy_rows(dst, 0, size=3, out=back)   # read on the card
                want = torch.zeros_like(vals)
                want[1] = vals[1]
                assert torch.equal(back.cpu(), want), \
                    ("k4 write-back", kind, dt, w, route)
                checks += 1
    return checks


def k4_sweep(torch, rc, ha, build, dev, fetch_bytes, wb_bytes, kinds,
             fetch_arms, wb_arms, duplex_arms, reps=2):
    """GB/s of K4's designs on one row pinned host -> HBM (``fetch_bytes``)
    and one row HBM -> pinned host (``wb_bytes``), for every host
    allocation kind in ``kinds`` and every arm (label -> ``Route``), with
    ``copy_`` on each buffer; each arm checked bitwise once, then timed
    ``reps`` times in a pass over all arms and again in a pass in reverse
    order (the mean of the two).  ``duplex_arms``: (fetch route, write-back
    route) pairs launched together on two streams, each direction's GB/s
    beside its own alone."""
    g = torch.Generator(dev).manual_seed(21)
    nf, nw = fetch_bytes // 4, wb_bytes // 4
    want_f = torch.randn(nf, generator=g, device=dev)
    want_w = torch.randn(nw, generator=g, device=dev)
    d_f = torch.empty_like(want_f)
    host_f, host_w = {}, {}
    t0 = time.perf_counter()
    for k in kinds:
        host_f[k] = ha.empty((1, nf), torch.float32, kind=k)
        host_w[k] = ha.empty((1, nw), torch.float32, kind=k)
        rc.writeback_rows(want_f, host_f[k], 0)
    torch.cuda.synchronize()
    alloc_s = time.perf_counter() - t0
    check = torch.empty_like(want_w)

    def fetch(k, route):
        return lambda: rc.copy_rows(host_f[k], 0, size=1, out=d_f[None],
                                    route=route)

    def wb(k, route):
        return lambda: rc.writeback_rows(want_w, host_w[k], 0, route=route)

    def lib_fetch(k):
        return lambda: d_f.copy_(host_f[k][0], non_blocking=True)

    def lib_wb(k):
        return lambda: host_w[k][0].copy_(want_w, non_blocking=True)

    cases = []                     # (direction, kind, label, fn)
    for k in kinds:
        for label, route in fetch_arms.items():
            d_f.zero_()
            fetch(k, route)()
            torch.cuda.synchronize()
            assert torch.equal(d_f, want_f), ("k4 fetch arm", k, label)
            cases.append(("fetch", k, label, fetch(k, route)))
        cases.append(("fetch", k, "copy_", lib_fetch(k)))
        for label, route in wb_arms.items():
            rc.writeback_rows(torch.zeros_like(want_w), host_w[k], 0)
            wb(k, route)()
            check.copy_(host_w[k][0])
            torch.cuda.synchronize()
            assert torch.equal(check, want_w), ("k4 write-back arm", k, label)
            cases.append(("writeback", k, label, wb(k, route)))
        cases.append(("writeback", k, "copy_", lib_wb(k)))
    ms = {}
    for order in (cases, cases[::-1]):
        for d, k, label, fn in order:
            n = reps if d == "fetch" else 4 * reps
            ms.setdefault((d, k, label), []).append(
                time_ms(torch, fn, n, warmup=1))
    out = {"phase": "k4-sweep", "host": host_facts(),
           "fetch_bytes": fetch_bytes, "writeback_bytes": wb_bytes,
           "alloc_s": alloc_s, "reps": reps,
           "is_pinned": {k: host_f[k].is_pinned() for k in kinds},
           "GBps": {}}
    for (d, k, label), t in ms.items():
        nbytes = fetch_bytes if d == "fetch" else wb_bytes
        out["GBps"].setdefault(d, {}).setdefault(k, {})[label] = \
            nbytes / (sum(t) / len(t)) / 1e6
    # duplex: one fetch and write-backs of as many bytes, on two streams
    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    n_wb = max(1, fetch_bytes // wb_bytes)
    duplex = {}
    for k in kinds:
        for fl, wl in duplex_arms:
            fr = fetch_arms.get(fl)
            wr = wb_arms.get(wl)
            f_fn = lib_fetch(k) if fl == "copy_" else fetch(k, fr)
            w_fn = lib_wb(k) if wl == "copy_" else wb(k, wr)

            def run(on_f, on_w):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                torch.cuda.synchronize()
                start = torch.cuda.Event()
                start.record()
                if on_f:
                    s1.wait_event(start)
                    with torch.cuda.stream(s1):
                        ev[0].record()
                        f_fn()
                        ev[1].record()
                if on_w:
                    s2.wait_event(start)
                    with torch.cuda.stream(s2):
                        ev[2].record()
                        for _ in range(n_wb):
                            w_fn()
                        ev[3].record()
                torch.cuda.synchronize()
                return (fetch_bytes / ev[0].elapsed_time(ev[1]) / 1e6
                        if on_f else None,
                        n_wb * wb_bytes / ev[2].elapsed_time(ev[3]) / 1e6
                        if on_w else None)
            run(True, True)
            alone_f, _ = run(True, False)
            _, alone_w = run(False, True)
            both_f, both_w = run(True, True)
            duplex.setdefault(k, {})[f"{fl} + {wl}"] = {
                "fetch_alone": alone_f, "writeback_alone": alone_w,
                "fetch_duplex": both_f, "writeback_duplex": both_w}
    out["duplex_GBps"] = duplex
    # the round trip of one read: a chain of indices 4224 bytes apart (a
    # new line and page each step), followed by one thread; then the bytes
    # in flight that the best SM-side fetch rate implies (Little's law)
    stride, steps = 528, 20000
    chain = torch.arange(nf // 2, device=dev, dtype=torch.int64) + stride
    last = torch.zeros(1, dtype=torch.int64, device=dev)
    bufs = {"hbm": chain.clone()}
    for k in kinds:
        bufs[k] = host_f[k].view(torch.int64)
        rc.writeback_rows(chain, bufs[k], 0)
    torch.cuda.synchronize()
    out["read_latency_us"], out["in_flight_KiB"] = {}, {}
    for k, b in bufs.items():
        us = []
        for _ in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            build.check(build.library().rc_chase(
                b.data_ptr(), steps, last.data_ptr(),
                torch.cuda.current_stream().cuda_stream), "rc_chase")
            ev[1].record()
            ev[1].synchronize()
            us.append(ev[0].elapsed_time(ev[1]) * 1e3 / steps)
        assert int(last) == steps * stride, int(last)
        out["read_latency_us"][k] = min(us)
        if k != "hbm":
            best = max(v for a, v in out["GBps"]["fetch"][k].items()
                       if a != "copy_")
            out["in_flight_KiB"][k] = best * min(us) / 1.024
    del host_f, host_w, bufs
    return out


SWEEP_KINDS = ("pinned", "mapped", "write_combined", "huge_pages")


def k4_arms(rc):
    """The k4-sweep's arms (label -> ``relay_copy.Route``): the relay's
    route, the kernels before it, and each lever by itself — the request
    shape (TMA tiles of 4, 16, 64 KB; 16-byte words in whole lines, plain
    or with a 128- or 256-byte L2 prefetch), the locality (tiles
    interleaved over the grid or one run per block) and the SMs used;
    then the duplex pairs."""
    R = rc.Route
    route, prev_f, prev_w = rc.FETCH_ROUTE, "tma_tiles", "words"
    fetch = {f"{route} (route)": rc.ROUTES[route],
             f"{prev_f} (before)": rc.ROUTES[prev_f],
             "words/132": R("words")}
    wb = {f"{route} (route)": rc.ROUTES[route],
          f"{prev_w} (before)": rc.ROUTES[prev_w]}
    for m in ("lines", "lines128", "lines256"):
        fetch[f"{m}/132"] = R(m, lines=True)
    wb["lines/132"] = R("lines", lines=True)
    for tile, stages in ((4096, 16), (65536, 2)):
        for arms in (fetch, wb):
            arms[f"tma{tile // 1024}K/132"] = R("tma", tile=tile,
                                                stages=stages, lines=True)
    for arms in (fetch, wb):
        arms["lines/132/span"] = R("lines", lines=True, span=True)
        arms["tma16K/132/span"] = R("tma", lines=True, span=True)
    for b in (1, 2, 4, 16, 33, 66):
        for arms in (fetch, wb):
            arms[f"lines/{b}"] = R("lines", lines=True, blocks=b)
    for b in (8, 16, 33, 66):
        fetch[f"tma16K/{b}"] = R("tma", lines=True, blocks=b)
    duplex = [(f"{prev_f} (before)", f"{prev_w} (before)"),
              (f"{route} (route)", f"{route} (route)"), ("copy_", "copy_")]
    return fetch, wb, duplex


def train_kernel_rows(torch, F, dev, g, fa, fadam, kops, rc, ref, get_config,
                      LayeredModel, tree_leaves, is_spec):
    """K1, K3a, K3b and K4's write-back against their plain versions at
    the training path's shapes (bert-large), with times."""
    rows = []
    bert = get_config("bert-large", "full")
    specs = LayeredModel(bert).param_specs()
    n = sum(math.prod(sp.shape[1:]) for sp in
            tree_leaves(specs["groups"][0], is_leaf=is_spec))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # K1: one packed bert-large layer (12,596,224 elements); f32 masters
    # are the path's (timed), bf16 masters checked too; bitwise to the
    # eager chain, which the per-leaf optimizer runs
    for pdt in (torch.float32, torch.bfloat16):
        p = torch.randn(n, generator=g, device=dev).to(pdt)
        gr = torch.randn(n, generator=g, device=dev) * 1e-2
        m = torch.randn(n, generator=g, device=dev) * 1e-3
        v = torch.rand(n, generator=g, device=dev) * 1e-5
        a = torch.tensor(3.1e-4)
        for wd_form, wd in ((False, 0.0), (True, 0.01)):
            got = fadam.fused_adam_flat(p, gr, m, v, a, 1.0, wd=wd,
                                        wd_form=wd_form)
            plain = fadam.fused_adam_flat_plain(p, gr, m, v, a, 1.0, wd=wd,
                                                wd_form=wd_form)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(got, plain)), \
                f"fused adam not bitwise to its plain version ({pdt})"
        if pdt != torch.float32:
            continue
        ps, ms_, vs_ = [p.clone()], [m.clone()], [v.clone()]
        steps = [torch.ones((), device=dev)]
        rows.append({
            "name": "fused_adam", "route": "triton",
            "source": "src/repro_torch/kernels/fused_adam.py",
            "replaces": "src/repro/kernels/fused_adam.py:23",
            "shape": [n], "dtype": "float32 p, g, m, v",
            "max_abs_err": 0.0, "bitwise": True,
            "ms": time_ms(torch, lambda: fadam.fused_adam_flat(
                p, gr, m, v, a, 1.0), 20),
            "plain_ms": time_ms(torch, lambda: fadam.fused_adam_flat_plain(
                p, gr, m, v, a, 1.0), 20),
            "library_ms": time_ms(torch, lambda: torch._fused_adam_(
                ps, [gr], ms_, vs_, [], steps, lr=3.1e-4, beta1=0.9,
                beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
                maximize=False), 20),
            "bound_ms": 28 * n / H100_HBM_BPS * 1e3, "bound_by": "bytes"})
    del p, gr, m, v, ps, ms_, vs_, got, plain

    # K3a / K3b as the path calls them: the backward of
    # kernels.ops.flash_attention on the model's (B, S, H, D) layout, at
    # bert-large's heads and one microbatch of the train phase, causal
    B, S, H, D = 8, 512, bert.n_heads, bert.d_head
    pairs = B * H * S * (S + 1) // 2
    for dt, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        q, k, v = (torch.randn(B, S, H, D, generator=g, device=dev).to(dt)
                   .requires_grad_() for _ in range(3))
        o = kops.flash_attention(q, k, v, causal=True)
        do = torch.randn(o.shape, generator=g, device=dev).to(dt)
        got = torch.autograd.grad(o, (q, k, v), do)
        qt, kt, vt, ot, dot = (t.detach().transpose(1, 2)
                               for t in (q, k, v, o, do))
        _, lse = fa.flash_attention_fwd_bhsd(qt, kt, vt, causal=True)
        plain = fa.flash_attention_bwd_bhsd_plain(qt, kt, vt, ot, lse, dot,
                                                  causal=True)
        torch.cuda.synchronize()
        errs = [float((x.float() - y.transpose(1, 2).float()).abs().max())
                for x, y in zip(got, plain)]
        top = max(float(y.float().abs().max()) for y in plain)
        # both sides sum in f32, in other orders; bf16 outputs may round
        # to each other's neighbour: 1e-2 of the largest gradient (a bf16
        # ulp is 2^-8 relative); f32 1e-5 of it
        assert max(errs) <= tol * top, (dt, errs, top)
        if dt != torch.bfloat16:
            continue
        delta = (dot.float() * ot.float()).sum(-1).contiguous()
        qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        ref_o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        lib = torch.autograd.grad(ref_o, (qs, ks, vs), dot, retain_graph=True)
        lib_errs = [float((x.float() - y.float()).abs().max())
                    for x, y in zip(lib, plain)]
        # the bf16 route's own rounding points, emulated in plain torch
        emu = ref.ref_attention_bwd(qt, kt, vt, ot, lse, dot, causal=True,
                                    tensor_cores=True)
        emu_errs = [float((x.float() - y.transpose(1, 2).float()).abs().max())
                    for x, y in zip(got, emu)]
        # SDPA's backward runs in the autograd engine, which a CUDA graph
        # cannot capture here: eager calls give the host's share; its
        # device time comes after the timed phases (backward_device_ms)
        lib_eager_ms = time_ms(torch, lambda: torch.autograd.grad(
            ref_o, (qs, ks, vs), dot, retain_graph=True), 5)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_bhsd_plain(
            qt, kt, vt, ot, lse, dot, causal=True), 5)
        in_bytes = 4 * q.numel() * 2 + 2 * lse.numel() * 4
        for name, ops, err, lerr, emu_err, out_bytes, line, src, kern in (
                ("flash_attention_bwd_dq", 6 * D * pairs, errs[0],
                 lib_errs[0], emu_errs[0], 2 * q.numel(), 145,
                 "flash_attention_dq_sm90.cu", fa.flash_attention_bwd_dq),
                ("flash_attention_bwd_dkv", 8 * D * pairs, max(errs[1:]),
                 max(lib_errs[1:]), max(emu_errs[1:]), 4 * q.numel(), 174,
                 "flash_attention_bwd_sm90.cu", fa.flash_attention_bwd_dkv)):
            def fn(kern=kern):
                return kern(qt, kt, vt, dot, lse, delta, causal=True)

            def prev(kern=kern):      # the CUDA-core kernel bf16 took before
                return kern(qt, kt, vt, dot, lse, delta, causal=True,
                            route="cuda_core")
            nbytes = in_bytes + out_bytes
            ms, prev_ms = rotation(torch, (fn, prev), 20)
            rows.append({
                "name": name, "route": "cuda", "kernel_route": "wgmma",
                "source": "src/repro_torch/kernels/csrc/" + src,
                "replaces": f"src/repro/kernels/flash_attention.py:{line}",
                "shape": [B, S, H, D], "layout": "BSHD", "dtype": "bfloat16",
                "max_abs_err": err, "max_abs_grad": top,
                "emulation_err": emu_err,
                "ms": ms, "previous_ms": prev_ms,
                "eager_ms": time_ms(torch, fn, 20),
                "timing": "ms, previous_ms: a CUDA graph of the calls, "
                          "the old and new kernels in turns; profiled_ms, "
                          "library_ms: the summed device spans of eager "
                          "calls under torch.profiler, after the timed "
                          "phases (backward_device_ms); eager_ms, "
                          "plain_ms, library_eager_ms: back-to-back eager "
                          "calls",
                "plain_ms": plain_ms, "plain_covers": "dq, dk and dv",
                "library_eager_ms": lib_eager_ms,
                "library_err": lerr,
                "library_covers": "SDPA backward: dq, dk and dv",
                "bound_ms": max(ops / H100_BF16_OPS,
                                nbytes / H100_HBM_BPS) * 1e3,
                "bound_by": ("operations" if ops / H100_BF16_OPS
                             > nbytes / H100_HBM_BPS else "bytes")})
    del q, k, v, o, do, got, qt, kt, vt, ot, dot, plain, qs, ks, vs, ref_o

    # K4 write-back: a packed f32 weight row and one layer's bf16 stash
    # (UB=4 microbatches of 8 x 512 x 1024) from HBM into pinned rows: the
    # line loop on LINE_BLOCKS blocks, the word loop over every SM it
    # replaced (previous_ms) and copy_, in turns on the same buffers
    for dt, w in ((torch.float32, n), (torch.bfloat16, 4 * 8 * 512 * 1024)):
        src = torch.randn(w, generator=g, device=dev).to(dt)
        dst = torch.zeros(2, w, dtype=dt, pin_memory=True)
        for route in (rc.WRITEBACK_ROUTE, "words"):
            dst[1].zero_()
            rc.writeback_rows(src, dst, 1, route=route)
            torch.cuda.synchronize()
            assert torch.equal(dst[1], src.cpu()) and not dst[0].any(), \
                ("relay write-back is not bit-exact", route)
        nbytes = w * src.element_size()
        ms, prev_ms, lib_ms = rotation(torch, (
            lambda: rc.writeback_rows(src, dst, 1),
            lambda: rc.writeback_rows(src, dst, 1, route="words"),
            lambda: dst[0].copy_(src, non_blocking=True)), 5, timer=time_ms)
        rows.append({
            "name": "relay_copy_writeback", "route": "cuda",
            "kernel_route": rc.WRITEBACK_ROUTE, "previous_route": "words",
            "source": "src/repro_torch/kernels/csrc/relay_copy.cu",
            "replaces": "src/repro/kernels/relay_copy.py:128",
            "shape": [1, w], "dtype": str(dt).split(".")[1],
            "host_alloc": "pinned (torch.empty(pin_memory=True))",
            "grid_blocks": rc.LINE_BLOCKS, "previous_grid_blocks": sms,
            "max_abs_err": 0.0, "ms": ms, "previous_ms": prev_ms,
            "library_ms": lib_ms,
            "timing": "ms, previous_ms, library_ms (copy_): back-to-back "
                      "calls, in turns on the same buffers",
            "plain_ms": time_ms(torch, lambda: rc.writeback_rows_plain(
                src, dst, 0), 5),
            "bound_ms": nbytes / PCIE5_X16_BPS * 1e3, "bound_by": "bytes",
            "achieved_GBps": nbytes / ms / 1e6,
            "previous_GBps": nbytes / prev_ms / 1e6,
            "library_GBps": nbytes / lib_ms / 1e6})
    return rows


def train_phase(torch, engines, ExecutionConfig, bert, knobs, SyntheticLM,
                DataConfig, adam, make_schedule, counters, dev):
    """2 l2l-p steps of bert-large at full width and depth 12 for the
    peak-memory comparison, then 5 at depth 24 with every counter set to
    0 just before and read just after.  Returns (line, step 1's state
    tensors and loss, (engine, state, batch) for the profiled step that
    comes after the timed phases)."""
    import numpy as np
    B, S, UB, STEPS = 32, 512, 4, 5
    opt = adam(schedule=make_schedule(1e-4, warmup=10))
    cfg = bert.replace(use_pallas=True)

    def build(depth):
        e = engines.create("l2l-p", cfg.replace(n_layers=depth),
                           ExecutionConfig(n_microbatches=UB, **knobs),
                           optimizer=opt)
        t0 = time.perf_counter()
        st = e.init(torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        return e, st, time.perf_counter() - t0

    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                   seed=0)).batch(0).items()}

    # the paper's claim: device memory does not grow with depth (depth 12
    # first, so the depth-24 state kept for the profile is not counted)
    eng, state, _ = build(12)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, _m = eng.train_step(state, batch)
    torch.cuda.synchronize()
    peak12 = torch.cuda.max_memory_allocated()
    reserved12 = torch.cuda.max_memory_reserved()
    del eng, state, _m
    free_host(torch)

    eng, state, init_s = build(cfg.n_layers)
    eps = state.params["groups"][0].segs["float32"]
    layer_bytes = eps.shape[1] * 4
    stash_row = UB * (B // UB) * S * cfg.d_model * 2
    eps_bytes = sum(a.numel() * a.element_size() for a in
                    [eps] + [s.segs["float32"] for s in
                             state.opt_state["groups"][0].values()])
    from repro_torch.core.tree import tree_leaves
    model_params = eps.numel() + sum(
        p.numel() for p in tree_leaves((state.params["embed"],
                                        state.params["head"])))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    fetch0, wb0 = counters["relay_copy"].bytes, \
        counters["relay_copy_writeback"].bytes
    steps = []
    for i in range(STEPS):
        t0 = time.perf_counter()
        state, metrics = eng.train_step(state, batch)
        issued = time.perf_counter() - t0     # the host's share of the step
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append({"step": i, "s": dt, "host_issue_s": issued,
                      "tok_per_s": B * S / dt, "loss": loss,
                      "grad_norm": float(metrics["grad_norm"])})
        emit({"phase": "train-step", **steps[-1]})
        if i == 0:       # the host-optimizer phase's reference rows
            step1 = {"tensors": state_tensors(torch, state), "loss": loss}
    launches = {n: c.launches for n, c in counters.items()}
    routes = route_counts(counters)
    fetched = counters["relay_copy"].bytes - fetch0   # the stash's too
    written = counters["relay_copy_writeback"].bytes - wb0
    peak24 = torch.cuda.max_memory_allocated()
    reserved24 = torch.cuda.max_memory_reserved()
    steady = float(np.mean([s["s"] for s in steps[1:]]))
    out = {
        "phase": "train", "arch": cfg.name, "depth": cfg.n_layers,
        "d_model": cfg.d_model, "batch": B, "seq": S, "microbatches": UB,
        "knobs": knobs, "init_s": init_s, "steps": steps,
        "steady_s_per_step": steady, "steady_tok_per_s": B * S / steady,
        "relay_in_bytes_per_step": fetched / STEPS,
        "relay_out_bytes_per_step": written / STEPS,
        "relay_in_GBps": fetched / STEPS / steady / 1e9,
        "relay_out_GBps": written / STEPS / steady / 1e9,
        "layer_row_bytes": layer_bytes, "stash_row_bytes": stash_row,
        "eps_pinned_bytes": eps_bytes,
        "params_plus_adam_bytes": 12 * model_params,
        "peak_allocated_bytes": peak24, "peak_reserved_bytes": reserved24,
        "launches_per_step": {n: v / STEPS for n, v in launches.items()},
        "launches": launches, "routes": routes}
    assert all(np.isfinite(s["loss"]) for s in steps), steps
    assert steps[-1]["loss"] < steps[0]["loss"], \
        "loss on the repeated batch did not fall over 5 steps"
    out["peak_allocated_bytes_by_depth"] = {"12": peak12, "24": peak24}
    out["peak_reserved_bytes_by_depth"] = {"12": reserved12,
                                           "24": reserved24}
    return out, step1, (eng, state, batch)


def free_host(torch):
    """Return freed device and pinned blocks (the next phase pins its
    own EPS)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()


# the dense configurations the port's blocks cover, served at full width:
# (arch, depth cap); chatglm3-6b at full depth (28 layers, 22.9 GB of f32
# rows), the two d-8192 models at 2 layers (2.8 and 5.4 GB per f32 row)
DENSE_SERVE = (("chatglm3-6b", 0), ("command-r-35b", 2), ("qwen1.5-110b", 2))


def serve_dense_phase(torch, engines, ExecutionConfig, exec_cfg, get_config,
                      LayeredModel, tree_leaves, is_spec, packing,
                      sample_batch, counters, dev):
    """decode_init on 4 prompts of 16 tokens and 4 greedy decode steps of
    each DENSE_SERVE model through the granite serve phase's engine
    settings, then Engine.prefill held to decode_init's last-token logits;
    the counters set to 0 just before each model and read just after its
    prefill.  Then the same prefill against decode_init in f32 at depth 1
    (K5's f32 rows reach their 32 KB limit at d 8192), not counted."""
    B, P, GEN = 4, 16, 4
    out, launches, routes = [], {}, {}
    for arch, cap in DENSE_SERVE:
        full = get_config(arch, "full")
        row = 4 * sum(math.prod(sp.shape[1:]) for sp in tree_leaves(
            LayeredModel(full).param_specs()["groups"][0], is_leaf=is_spec))
        depth = host_depth(row, full.n_layers, reserve=24 * 2 ** 30)
        depth = min(depth, cap) if cap else depth
        cfg = full.replace(n_layers=depth, use_pallas=True)
        eng = engines.create("l2l", cfg, exec_cfg)
        t0 = time.perf_counter()
        params = eng.init_params(torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        eps = params["groups"][0].segs["float32"]
        assert eps.is_pinned() and eps.shape == (depth, row // 4)
        prompt = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                               generator=torch.Generator(dev).manual_seed(1))
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters.values())
        t0 = time.perf_counter()
        caches, last = eng.decode_init(params, prompt, P + GEN)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        tok = sample_batch(last)[:, None]
        toks = [tok]
        t0 = time.perf_counter()
        for i in range(GEN):
            logits, caches = eng.decode_step(params, caches, tok, P + i)
            assert bool(torch.isfinite(logits).all()), (arch, "logits")
            tok = sample_batch(logits[:, -1])[:, None]
            toks.append(tok)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        pl = eng.prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        got = {n: c.launches for n, c in counters.items()}
        got_routes = route_counts(counters)
        toks = torch.cat(toks, dim=1)
        rel = float((pl.float() - last.float()).norm() / last.float().norm())
        agree = int((pl.argmax(-1) == last.argmax(-1)).sum())
        # f32 at depth 1: a wrong mask, position or cache slot shows as O(1)
        e1 = engines.create("l2l", cfg.replace(n_layers=1, dtype="float32"),
                            exec_cfg)
        sub = {**params, "groups": (packing.Packed(
            {"float32": eps[:1]}, params["groups"][0].spec),)}
        _, r1 = e1.decode_init(sub, prompt, P)
        g1 = e1.prefill(sub, {"tokens": prompt})
        gap1 = float((g1.float() - r1.float()).norm() / r1.float().norm())
        line = {"arch": arch, "depth": depth, "full_depth": full.n_layers,
                "d_model": cfg.d_model, "heads": [cfg.n_heads,
                                                  cfg.n_kv_heads],
                "norm": cfg.norm_type, "layer_row_bytes": row,
                "eps_pinned_bytes": depth * row, "init_s": init_s,
                "tokens": toks.tolist(), "decode_init_s": t_init,
                "decode_s": t_dec, "tok_per_s": B * GEN / t_dec,
                "relay_GBps": GEN * depth * row / t_dec / 1e9,
                "rel_l2_prefill_vs_decode_init": {"bf16_full": rel,
                                                  "f32_depth1": gap1},
                "argmax_agree": agree, "launches": got,
                "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        emit({"phase": "serve-dense", **line})
        out.append(line)
        # f32 at depth 1: the granite prefill phase's 1e-4; bf16 at the
        # depth served, with the same top-1 token on all but at most one
        # row: 0.25 beyond 4 layers (chatglm3-6b's 28 measured 0.110),
        # 0.05 at 4 (measured 0.007 and 0.013), where granite's phase
        # allows 0.35 at its 40 (measured 0.138)
        assert toks.shape == (B, GEN + 1) and bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()), arch
        assert bool(torch.isfinite(pl).all()), arch
        line["bf16_bound"] = 0.25 if depth > 4 else 0.05
        assert gap1 <= 1e-4 and rel <= line["bf16_bound"] and \
            agree >= B - 1, line
        for n, v in got.items():
            launches[n] = launches.get(n, 0) + v
        for n, r in got_routes.items():
            for k, v in r.items():
                routes.setdefault(n, {}).setdefault(k, 0)
                routes[n][k] += v
        del eng, e1, params, eps, caches, last, logits, pl, sub, r1, g1
        free_host(torch)
    return out, launches, routes


# serve-continuous: granite-3-8b's crowd (ServeConfig, requests, seed)
CROWD = dict(max_batch=8, page_size=16, max_seq=384, n_pages=128,
             prefill_chunk=64)
CROWD_REQUESTS = 12


CONT_DEPTH = 20       # serve-continuous's depth: the first 20 of 40 rows


def serve_continuous_phase(torch, np, engines, exec_cfg, cfg, params,
                           model_bytes, layer_bytes, packing, ServeConfig,
                           counters, dev):
    """granite-3-8b at full width and depth 20 (the first rows of the serve
    phase's pinned EPS, ``params``) through a continuous-batching
    ServeEngine with the serve phase's engine settings: 12 greedy
    requests (prompts of 32-256 tokens, 8-16 new tokens, from a seed)
    into 8 slots and 128 pages of 16 positions, so requests wait on slots
    and on pages and join as others leave; the counters set to 0 just
    before the crowd's first tick and read just after its last.  Then one
    of the requests alone through a fresh ServeEngine (its tokens must
    equal the crowd's bit for bit), and at depth 2 in f32 three requests
    against decode_init / decode_step with each prompt on every row.
    ``model_bytes`` is the whole model's (all 40 layers).
    -> (line, launches, routes)."""
    depth = min(CONT_DEPTH, cfg.n_layers)
    cfg = cfg.replace(n_layers=depth)
    eng = engines.create("l2l", cfg, exec_cfg)
    eps = params["groups"][0].segs["float32"][:depth]
    params = {**params, "groups": (packing.Packed(
        {"float32": eps}, params["groups"][0].spec),)}
    assert eps.is_pinned() and eps.is_contiguous()
    scfg = ServeConfig(**CROWD)
    rs = np.random.RandomState(3)
    lens = rs.randint(32, 257, size=CROWD_REQUESTS)
    news = rs.randint(8, 17, size=CROWD_REQUESTS)
    prompts = [rs.randint(0, cfg.vocab_size, size=(int(n),)).astype(np.int32)
               for n in lens]

    def serve(reqs_in):
        """Submit, tick until idle; -> (server, requests, tick seconds,
        seconds, [active, pending, unreserved free pages] after each
        tick)."""
        srv = eng.serve_session(params, scfg)
        reqs = [srv.submit(p, int(n)) for p, n in reqs_in]
        ticks, occupancy = [], []
        t0 = time.perf_counter()
        while not srv.scheduler.idle:
            t1 = time.perf_counter()
            srv.tick()
            ticks.append(time.perf_counter() - t1)
            st = srv.scheduler.stats()
            occupancy.append([st["active"], st["pending"],
                              st["free_pages"] - st["reserved_pages"]])
        return srv, reqs, ticks, time.perf_counter() - t0, occupancy

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    srv, reqs, ticks, secs, occupancy = serve(zip(prompts, news))
    launches = {n: c.launches for n, c in counters.items()}
    routes = route_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    stats = srv.stats()
    n_tok = sum(len(r.generated) for r in reqs)
    est = eng.serve_memory_estimate(scfg)
    # the request that waited longest for a slot: alone it must decode
    # the same tokens as in the crowd
    pick = max(range(CROWD_REQUESTS), key=lambda i: reqs[i].t_first)
    _, (solo,), solo_ticks, solo_s, _ = serve([(prompts[pick],
                                                news[pick])])
    n = len(ticks)
    line = {
        "phase": "serve-continuous", "arch": cfg.name, "depth": cfg.n_layers,
        "serve_config": CROWD, "requests": CROWD_REQUESTS,
        "prompt_lens": lens.tolist(), "max_new": news.tolist(),
        "reduced": f"depth 40 -> {depth}: chip_smoke.py's time limit",
        "ticks": n, "seconds": secs,
        "tokens": n_tok, "tok_per_s": n_tok / secs,
        "tick_s_median": float(np.median(ticks)),
        "tick_s_first": ticks[0],
        "relay_fetches_per_tick": launches["relay_copy"] / n,
        "relay_GBps": launches["relay_copy"] * layer_bytes / secs / 1e9,
        "rmsnorm_per_tick": launches["rmsnorm"] / n,
        "scheduler_stats": stats,
        "active_pending_free_pages_by_tick": occupancy,
        "peak_allocated_bytes": peak,
        "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
        "model_param_bytes": model_bytes, "peak_over_model": peak / model_bytes,
        "estimate_serve_total_device_bytes": est.total_device,
        "estimate_serve_kv_page_bytes": est.kv_page_bytes,
        "estimate_serve": {k: getattr(est, k) for k in (
            "params_device", "activations", "kv_page_bytes",
            "transport_buffer", "relay_stops_per_tick")},
        "solo": {"request": pick, "prompt_len": int(lens[pick]),
                 "max_new": int(news[pick]), "ticks": len(solo_ticks),
                 "seconds": solo_s,
                 "tok_per_s": len(solo.generated) / solo_s,
                 "tick_s_median": float(np.median(solo_ticks)),
                 "tokens": solo.generated},
        "crowd_tokens": [r.generated for r in reqs],
        "launches": launches}
    emit({k: v for k, v in line.items() if k != "crowd_tokens"})
    for r, m in zip(reqs, news):
        assert r.status == "done" and len(r.generated) == m and all(
            0 <= t < cfg.vocab_size for t in r.generated), (r.rid, r.status)
    assert stats["free_pages"] == CROWD["n_pages"] and \
        stats["free_slots"] == CROWD["max_batch"] and \
        stats["reserved_pages"] == 0 and stats["active"] == 0 and \
        stats["pending"] == 0, stats
    assert solo.generated == reqs[pick].generated, \
        ("crowded and solo tokens differ", pick)
    assert peak < 0.25 * model_bytes, "device footprint above 25% of the model"

    # f32 at depth 2: three requests through the tick against the one-shot
    # path with each prompt repeated on all three rows (the reference's
    # own bar, tests/test_serve.py's greedy reference)
    e2 = engines.create("l2l", cfg.replace(n_layers=2, dtype="float32"),
                        exec_cfg)
    sub = {**params, "groups": (packing.Packed(
        {"float32": eps[:2]}, params["groups"][0].spec),)}
    f32 = ServeConfig(max_batch=3, page_size=8, n_pages=12, max_seq=32,
                      prefill_chunk=8)
    short = [rs.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
             for n in (24, 13, 7)]
    srv2 = e2.serve_session(sub, f32)
    got = [srv2.submit(p, 6) for p in short]
    srv2.run()
    want = []
    for p in short:
        toks = torch.from_numpy(np.tile(p, (3, 1))).to(dev)
        caches, last = e2.decode_init(sub, toks, f32.max_seq)
        tok = last.argmax(-1)[:, None]
        out = [int(tok[0, 0])]
        for i in range(5):
            logits, caches = e2.decode_step(sub, caches, tok, len(p) + i)
            tok = logits[:, -1].argmax(-1)[:, None]
            out.append(int(tok[0, 0]))
        want.append(out)
    line["f32_depth2"] = {"tokens": [r.generated for r in got],
                          "oneshot_tokens": want}
    emit({"phase": "serve-continuous-f32", **line["f32_depth2"]})
    assert [r.generated for r in got] == want, line["f32_depth2"]
    del eng, e2, params, sub, eps, srv, srv2
    free_host(torch)
    return line, launches, routes


def k3_gqa_check(torch, dev, fa, kops, cfg, B, S):
    """K3a and K3b at a training microbatch of ``cfg``'s heads (chatglm3:
    32 q over 2 kv heads, a GQA group of 16), bf16, causal, against the
    plain version; graph-timed."""
    g = torch.Generator(dev).manual_seed(12)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16() \
        .requires_grad_()
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=dev).bfloat16()
            .requires_grad_() for _ in range(2))
    o = kops.flash_attention(q, k, v, causal=True)
    do = torch.randn(o.shape, generator=g, device=dev).bfloat16()
    got = torch.autograd.grad(o, (q, k, v), do)
    qt, kt, vt, ot, dot = (t.detach().transpose(1, 2)
                           for t in (q, k, v, o, do))
    _, lse = fa.flash_attention_fwd_bhsd(qt, kt, vt, causal=True)
    plain = fa.flash_attention_bwd_bhsd_plain(qt, kt, vt, ot, lse, dot,
                                              causal=True)
    torch.cuda.synchronize()
    errs = [float((x.float() - y.transpose(1, 2).float()).abs().max())
            for x, y in zip(got, plain)]
    tops = [float(y.float().abs().max()) for y in plain]
    delta = (dot.float() * ot.float()).sum(-1).contiguous()
    dq_ms = graph_ms(torch, lambda: fa.flash_attention_bwd_dq(
        qt, kt, vt, dot, lse, delta, causal=True), 20)
    dkv_ms = graph_ms(torch, lambda: fa.flash_attention_bwd_dkv(
        qt, kt, vt, dot, lse, delta, causal=True), 20)
    plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_bhsd_plain(
        qt, kt, vt, ot, lse, dot, causal=True), 5)
    pairs = B * H * S * (S + 1) // 2
    out = {"shape": [B, S, H, D], "kv_heads": Hkv, "group": H // Hkv,
           "dtype": "bfloat16", "dq_max_abs_err": errs[0],
           "dk_max_abs_err": errs[1], "dv_max_abs_err": errs[2],
           "max_abs_grad": tops, "dq_ms": dq_ms, "dkv_ms": dkv_ms,
           "plain_ms": plain_ms, "plain_covers": "dq, dk and dv",
           "dq_bound_ms": 6 * D * pairs / H100_BF16_OPS * 1e3,
           "dkv_bound_ms": 8 * D * pairs / H100_BF16_OPS * 1e3,
           "dkv_blocks": -(-S // 128) * B * Hkv}
    # as the train kernel rows: 1e-2 of the largest gradient of each
    assert all(e <= 1e-2 * t for e, t in zip(errs, tops)), out
    return out


def train_rmsnorm_phase(torch, engines, ExecutionConfig, knobs, get_config,
                        SyntheticLM, DataConfig, adam, make_schedule,
                        counters, kops, rms, fa, dev):
    """chatglm3-6b at full width, depth 2, under l2l-p: 2 steps with every
    counter set to 0 just before and read just after (K5 under grad); then
    one Engine.grads in f32 against the same call with K5's plain version
    patched in, and K3 at the path's GQA-16 shape."""
    import numpy as np
    from repro_torch.core.tree import tree_leaves_with_path
    from repro_torch.testing import fan_in_params
    B, S, UB, STEPS, DEPTH = 8, 512, 2, 2, 2
    full = get_config("chatglm3-6b", "full")
    cfg = full.replace(n_layers=DEPTH, use_pallas=True)
    opt = adam(schedule=make_schedule(1e-4, warmup=10))
    eng = engines.create("l2l-p", cfg, ExecutionConfig(n_microbatches=UB,
                                                       **knobs),
                         optimizer=opt)
    t0 = time.perf_counter()
    state = eng.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                   seed=0)).batch(0).items()}
    eps = state.params["groups"][0].segs["float32"]
    eps_bytes = sum(a.numel() * a.element_size() for a in
                    [eps] + [s.segs["float32"] for s in
                             state.opt_state["groups"][0].values()])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    forwards0 = kops.rmsnorm_diff.forwards
    steps = []
    for i in range(STEPS):
        t0 = time.perf_counter()
        state, metrics = eng.train_step(state, batch)
        issued = time.perf_counter() - t0
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append({"step": i, "s": dt, "host_issue_s": issued,
                      "tok_per_s": B * S / dt, "loss": loss,
                      "grad_norm": float(metrics["grad_norm"])})
    launches = {n: c.launches for n, c in counters.items()}
    routes = route_counts(counters)
    diff_forwards = kops.rmsnorm_diff.forwards - forwards0
    peak = torch.cuda.max_memory_allocated()
    out = {"phase": "train-rmsnorm", "arch": full.name, "depth": DEPTH,
           "full_depth": full.n_layers,
           "reduced": f"depth {full.n_layers} -> {DEPTH}: a full-depth f32 "
                      "EPS with Adam slots is ~69 GB pinned",
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "batch": B, "seq": S,
           "microbatches": UB, "knobs": knobs, "init_s": init_s,
           "eps_pinned_bytes": eps_bytes, "steps": steps,
           "steady_s_per_step": float(np.mean([s["s"] for s in steps[1:]])),
           "peak_allocated_bytes": peak,
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "rmsnorm_diff_forwards": diff_forwards,
           "launches_per_step": {n: v / STEPS for n, v in launches.items()}}
    assert all(np.isfinite(s["loss"]) for s in steps), steps
    # K5 ran under grad: the differentiable forwards, each one K5 launch
    # on the CUDA route
    assert diff_forwards > 0 and \
        routes["rmsnorm"]["cuda"] >= diff_forwards, (diff_forwards, routes)
    del eng, state, eps, metrics
    free_host(torch)

    # Engine.grads in f32 (the CUDA-core attention, K5's f32 kernel) against
    # the same call with K5's plain version patched in, at the usual scales
    # (fan_in_params): 1e-4 relative L2 per leaf; every norm scale's
    # gradient finite and not zero, layer by layer.  At the reference's own
    # init (std 1/sqrt(depth) per matrix, scores in the thousands) the
    # backward amplifies a norm output's last bit.  A second witness there:
    # the plain version against itself with the norm computed in f64 and
    # rounded once to f32 (the correctly rounded output, which differs from
    # the f32 plain version's by an ulp where K5's does); K5's distance is
    # bounded by 10 times the witness's
    ge = engines.create("l2l-p", cfg.replace(dtype="float32"),
                        ExecutionConfig(n_microbatches=UB, **knobs))

    def f64_norm(x, scale, *, eps, **_):
        xd = x.double()
        return (xd * torch.rsqrt((xd * xd).mean(-1, keepdim=True) + eps)
                * scale.double()).to(x.dtype)

    def grads_with(norm, params):
        kernel = kops.rmsnorm_2d
        kops.rmsnorm_2d = norm
        try:
            return ge.grads(params, batch)
        finally:
            kops.rmsnorm_2d = kernel

    def distance(got, want):
        (loss_a, ga), (loss_b, gb) = got, want
        torch.cuda.synchronize()
        rels = {key: float((a.float() - b.float()).norm() / b.float().norm())
                for (key, a), (_, b) in zip(tree_leaves_with_path(ga),
                                            tree_leaves_with_path(gb))}
        worst = max(rels, key=rels.get)
        return {"max_rel_l2_per_leaf": rels[worst], "worst_leaf": worst,
                "leaves": len(rels), "loss_rel": abs(float(loss_a) - float(
                    loss_b)) / abs(float(loss_b))}

    def compare(params):
        k5 = rms.rmsnorm_2d.launches_by_route["cuda"]
        kern = ge.grads(params, batch)
        k5 = rms.rmsnorm_2d.launches_by_route["cuda"] - k5
        plain = grads_with(rms.rmsnorm_2d_plain, params)
        wit = distance(grads_with(f64_norm, params), plain)
        return kern[1], {"k5_launches": k5, "loss_kernel": float(kern[0]),
                         "loss_plain": float(plain[0]),
                         **distance(kern, plain),
                         "f64_norm_vs_plain": wit}

    _, at_init = compare(ge.init_params(torch.Generator(dev).manual_seed(1)))
    g1 = torch.Generator(dev).manual_seed(1)
    grads_k, check = compare(fan_in_params(
        ge.model.param_specs(),
        lambda shape: torch.randn(shape, generator=g1, device=dev)))
    layers = grads_k["groups"][0]
    scales = [layers["ln1"]["scale"], layers["ln2"]["scale"],
              grads_k["head"]["ln_f"]["scale"][None]]
    nonzero = [int(g.abs().sum(-1).gt(0).sum()) for g in scales]
    finite = all(bool(torch.isfinite(g).all()) for g in scales)
    out["grads_check"] = {
        "dtype": "float32", "params": "fan-in scales (fan_in_params)",
        **check, "bound_rel_l2": 1e-4, "norm_scale_rows_nonzero": nonzero,
        "norm_scale_rows": [g.shape[0] for g in scales],
        "norm_scale_grad_abs_mean": [float(g.abs().mean()) for g in scales],
        "at_reference_init": {**at_init, "bound": "10x f64_norm_vs_plain"}}
    assert check["k5_launches"] > 0 and finite and \
        check["max_rel_l2_per_leaf"] <= 1e-4 and \
        nonzero == out["grads_check"]["norm_scale_rows"] and \
        check["loss_rel"] <= 1e-5, out["grads_check"]
    assert at_init["k5_launches"] > 0 and at_init["max_rel_l2_per_leaf"] \
        <= 10 * at_init["f64_norm_vs_plain"]["max_rel_l2_per_leaf"], \
        out["grads_check"]
    del ge, grads_k, layers, scales
    free_host(torch)
    out["k3_gqa"] = k3_gqa_check(torch, dev, fa, kops, cfg, B // UB, S)
    return out, launches, routes


def dynamic_depth_phase(torch, engines, ExecutionConfig, exec_cfg, cfg,
                        params, prompt, serve_tokens, packing, sample_batch,
                        bert,
                        knobs, SyntheticLM, DataConfig, adam, make_schedule,
                        counters, dev):
    """Dynamic depth on the card (``ExecutionConfig.dynamic_depth``).  The
    path, with the counters set to 0 just before and read just after:

    * serve: granite-3-8b at full width and the serve phase's depth with
      the serve phase's settings and rows (``params``, its pinned EPS),
      decode_init and 2 greedy steps on its 4 prompts at n = depth
      (tokens equal to the serve phase's first ones), then at n = depth /
      2 on the same engine and rows, on the prompts' first 4 tokens;
    * train: bert-large at full width, capacity 24, the train phase's
      settings, one step at n = 12 (rows 12-23 of the weights and Adam
      slots unchanged bit for bit), then one at n = 24; the peaks side by
      side.

    Then the comparisons: the n = 12 loss against a static 12-layer
    engine's first step on the same rows, and a capacity-4 granite engine
    at n = 2 against a static 2-layer engine on the same first two rows
    (prefill and decode logits), each bit for bit."""
    import dataclasses
    import numpy as np
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.engine.state import TrainState
    B, P = prompt.shape
    live = P + len(serve_tokens[0]) - 1    # the serve phase's cache
    GEN = 2           # of the serve phase's 8 steps: the phase's time budget
    # the half depth fills its caches from the prompts' first tokens: its
    # tok/s and fetches a step need no full prompt
    HALF_PROMPT = 4
    serve_tokens = [row[:GEN + 1] for row in serve_tokens]
    dyn_cfg = dataclasses.replace(exec_cfg, dynamic_depth=True)
    out = {"phase": "dynamic-depth", "arch": cfg.name,
           "capacity": cfg.n_layers, "batch": B, "prompt": P, "steps": GEN}
    eng = engines.create("l2l", cfg, dyn_cfg)
    fetch = counters["relay_copy"]
    reset_counts(counters.values())
    by_depth = {}
    for n in (cfg.n_layers, cfg.n_layers // 2):
        pr = prompt if n == cfg.n_layers else prompt[:, :HALF_PROMPT]
        t0 = time.perf_counter()
        caches, last = eng.decode_init(params, pr, live, n_layers=n)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        tok = sample_batch(last)[:, None]
        toks = [tok]
        f0, b0 = fetch.launches, fetch.bytes
        t0 = time.perf_counter()
        for i in range(GEN):
            logits, caches = eng.decode_step(params, caches, tok,
                                             pr.shape[1] + i, n_layers=n)
            tok = sample_batch(logits[:, -1])[:, None]
            toks.append(tok)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        by_depth[str(n)] = {
            "prompt": pr.shape[1], "decode_init_s": t_init, "decode_s": dt,
            "tok_per_s": B * GEN / dt,
            "fetches_per_step": (fetch.launches - f0) / GEN,
            "relay_GBps": (fetch.bytes - b0) / dt / 1e9,
            "tokens": torch.cat(toks, 1).tolist()}
        del caches, last, logits
    out["serve"] = by_depth
    del eng, params
    free_host(torch)

    Bt, S, UB = 32, 512, 4
    tcfg = bert.replace(use_pallas=True)
    opt = adam(schedule=make_schedule(1e-4, warmup=10))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(vocab_size=tcfg.vocab_size, seq_len=S, global_batch=Bt,
                   seed=0)).batch(0).items()}
    eng = engines.create("l2l-p", tcfg, ExecutionConfig(
        n_microbatches=UB, dynamic_depth=True, **knobs), optimizer=opt)
    state0 = state = eng.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    steps, after12 = [], None
    for n in (12, tcfg.n_layers):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state, m = eng.train_step(state, batch, n_layers=n)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        # the step's own growth: the states kept for the comparisons
        # below hold their embedding and head on the device
        steps.append({"n": n, "s": time.perf_counter() - t0, "loss": loss,
                      "peak_allocated_bytes": peak,
                      "allocated_at_start_bytes": start,
                      "step_peak_growth_bytes": peak - start})
        if n == 12:
            after12 = state
    launches = {k: c.launches for k, c in counters.items()}
    routes = route_counts(counters)
    out["train"] = steps
    rows = tree_leaves((state0.params["groups"], state0.opt_state["groups"]))
    new_rows = tree_leaves((after12.params["groups"],
                            after12.opt_state["groups"]))
    out["idle_rows_unchanged"] = all(
        torch.equal(a[12:], b[12:]) for a, b in zip(new_rows, rows))
    out["active_rows_moved"] = all(
        not torch.equal(a[:12], b[:12]) for a, b in zip(new_rows, rows))
    del eng, state, after12, rows, new_rows
    # a static 12-layer engine's first step on the same rows
    se = engines.create("l2l-p", tcfg.replace(n_layers=12),
                        ExecutionConfig(n_microbatches=UB, **knobs),
                        optimizer=opt)
    first12 = lambda t: tree_map(lambda a: a[:12], t)
    st12 = TrainState(
        params={**state0.params,
                "groups": (first12(state0.params["groups"][0]),)},
        opt_state={**state0.opt_state,
                   "groups": (first12(state0.opt_state["groups"][0]),)},
        step=state0.step)
    _, ms = se.train_step(st12, batch)
    out["static12_loss"] = float(ms["loss"])
    del se, st12, state0, ms
    free_host(torch)

    # capacity 4 at n = 2 against a static 2-layer engine, the same rows
    e4 = engines.create("l2l", cfg.replace(n_layers=4), dyn_cfg)
    p4 = e4.init_params(torch.Generator(dev).manual_seed(0))
    e2 = engines.create("l2l", cfg.replace(n_layers=2), exec_cfg)
    g4 = p4["groups"][0]
    p2 = {**p4, "groups": (packing.Packed(
        {k: v[:2] for k, v in g4.segs.items()}, g4.spec),)}

    def run(e, p, **kw):
        caches, lg = e.decode_init(p, prompt, P + 1, **kw)
        step, _ = e.decode_step(p, caches, lg.argmax(-1)[:, None], P, **kw)
        return [lg, step[:, -1], e.prefill(p, {"tokens": prompt}, **kw)]

    got, want = run(e4, p4, n_layers=2), run(e2, p2)
    out["capacity4_n2_equals_static2"] = all(
        torch.equal(a, b) for a, b in zip(got, want))
    del e4, p4, e2, p2, g4, got, want
    free_host(torch)

    full_n, half_n = str(cfg.n_layers), str(cfg.n_layers // 2)
    out["tokens_equal_serve_phase"] = \
        by_depth[full_n]["tokens"] == serve_tokens
    out["launches"] = launches
    assert out["tokens_equal_serve_phase"], (by_depth[full_n]["tokens"],
                                             serve_tokens)
    assert by_depth[half_n]["fetches_per_step"] \
        < by_depth[full_n]["fetches_per_step"], by_depth
    assert out["idle_rows_unchanged"] and out["active_rows_moved"], out
    assert steps[0]["loss"] == out["static12_loss"], out
    assert out["capacity4_n2_equals_static2"], out
    assert all(np.isfinite(s["loss"]) for s in steps), steps
    return out, launches, routes


def host_optimizer_phase(torch, engines, ExecutionConfig, bert, knobs,
                         SyntheticLM, DataConfig, adam, make_schedule,
                         counters, step1, train_losses, dev):
    """bert-large at full width and depth with the train phase's engine
    plus ``host_optimizer``: 3 steps on the train phase's batch, every
    counter set to 0 just before and read just after.  Step 1's rows are
    held to the train phase's step-1 rows (``step1``: the reference's bar,
    max abs 1e-6 and an equal loss); when they are bitwise the five losses
    equal the train phase's.  Returns (line, launches, routes, (engine,
    state, batch)): the profiled step comes after the timed phases."""
    import numpy as np
    from repro_torch.kernels.ref import sqrt_rn
    B, S, UB, STEPS = 32, 512, 4, 3
    cfg = bert.replace(use_pallas=True)
    opt = adam(schedule=make_schedule(1e-4, warmup=10))
    eng = engines.create("l2l-p", cfg, ExecutionConfig(
        n_microbatches=UB, host_optimizer=True, **knobs), optimizer=opt)
    t0 = time.perf_counter()
    state = eng.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                   seed=0)).batch(0).items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    fetch, wb = counters["relay_copy"], counters["relay_copy_writeback"]
    steps = []
    for i in range(STEPS):
        f0, w0 = (fetch.launches, fetch.bytes), (wb.launches, wb.bytes)
        k1 = counters["fused_adam"].launches
        t0 = time.perf_counter()
        state, metrics = eng.train_step(state, batch)
        issued = time.perf_counter() - t0
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ms = metrics["host_update_ms"]
        steps.append({
            "step": i, "s": dt, "host_issue_s": issued, "loss": loss,
            "tok_per_s": B * S / dt,
            "relay_in_GB": (fetch.bytes - f0[1]) / 1e9,
            "relay_out_GB": (wb.bytes - w0[1]) / 1e9,
            "k4_fetches": fetch.launches - f0[0],
            "k4_writebacks": wb.launches - w0[0],
            "k1_launches": counters["fused_adam"].launches - k1,
            "cpu_update_ms_median": float(np.median(ms)),
            "cpu_update_ms_max": float(np.max(ms)),
            "cpu_update_s_total": float(np.sum(ms)) / 1e3,
            "main_thread_wait_s": metrics["host_wait_s"]})
        emit({"phase": "host-optimizer-step", **steps[-1]})
        if i == 0:
            got = state_tensors(torch, state)
            bitwise = all(torch.equal(a, b)
                          for a, b in zip(got, step1["tensors"]))
            diff = 0.0 if bitwise else max(
                float((a - b).abs().max())
                for a, b in zip(got, step1["tensors"]))
            # the update's one op that is not correctly rounded everywhere:
            # the square root of layer 0's second moment, on the card, by
            # PyTorch's CPU kernel and by the CPU route the update takes
            v = state.opt_state["groups"][0]["v"].segs["float32"][0].clone()
            card = torch.sqrt(v.to(dev)).cpu()
            sqrt_check = {"elements": v.numel(),
                          "torch_sqrt_cpu_vs_card": int(
                              (torch.sqrt(v) != card).sum()),
                          "sqrt_rn_cpu_vs_card": int(
                              (sqrt_rn(v) != card).sum())}
            del got, v, card
    launches = {k: c.launches for k, c in counters.items()}
    routes = route_counts(counters)
    steady = float(np.mean([s["s"] for s in steps[1:]]))
    out = {"phase": "host-optimizer", "arch": cfg.name,
           "depth": cfg.n_layers, "batch": B, "seq": S, "microbatches": UB,
           "knobs": {**knobs, "host_optimizer": True}, "init_s": init_s,
           "steps": steps, "steady_s_per_step": steady,
           "steady_tok_per_s": B * S / steady,
           "step1_max_abs_vs_device_optimizer": diff,
           "step1_bitwise": bitwise, "sqrt_check": sqrt_check,
           "step1_loss": steps[0]["loss"],
           "step1_loss_device_optimizer": step1["loss"],
           "losses_equal_train_phase":
               [s["loss"] for s in steps] == train_losses[:STEPS],
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "torch_threads": torch.get_num_threads()}
    assert all(s["k1_launches"] == 0 for s in steps), steps
    assert diff <= 1e-6 and steps[0]["loss"] == step1["loss"], out
    assert sqrt_check["sqrt_rn_cpu_vs_card"] == 0, sqrt_check
    assert not bitwise or out["losses_equal_train_phase"], out
    return out, launches, routes, (eng, state, batch)


# the MoE family: deepseek-v2-lite-16b (MLA; a dense layer 0, then MoE
# layers of 64 routed experts, top 6, and 2 shared), at full width
MOE_ARCH = "deepseek-v2-lite-16b"
# depths 4 / 2 (cut to make room for the MoE paths on the mesh)
MOE_SERVE_DEPTH, MOE_TRAIN_DEPTH = 4, 2
# serve-moe's crowd: 8 slots x 16-row chunks = 128 rows = 2E, so every
# tick takes the exact dense MoE path
MOE_CROWD = dict(max_batch=8, page_size=16, max_seq=160, n_pages=64,
                 prefill_chunk=16)


def group_rows(LayeredModel, tree_leaves, is_spec, full):
    """f32 bytes of one layer of each layer group (deepseek: the dense
    layer 0, a MoE layer)."""
    return tuple(4 * sum(math.prod(sp.shape) for sp in
                         tree_leaves(g.spec, is_leaf=is_spec))
                 for g in LayeredModel(full).groups)


def moe_depth(rows, want: int, copies: int, reserve: int) -> int:
    """The depth (dense layer 0 + MoE layers, at most ``want``) whose
    pinned rows fit beside ``reserve`` bytes: ``copies`` copies of each
    group's stacked rows (host_depth's rounding)."""
    n_moe = host_depth(copies * rows[1], want - 1,
                       reserve + copies * 2 ** math.ceil(
                           math.log2(rows[0])))
    return 1 + n_moe


def _sub(packing, params, dense_eps, moe_eps, n_moe):
    """The first 1 + ``n_moe`` layers of a packed two-group EPS."""
    return {**params, "groups": (
        packing.Packed({"float32": dense_eps}, params["groups"][0].spec),
        packing.Packed({"float32": moe_eps[:n_moe]},
                       params["groups"][1].spec))}


def serve_moe_phase(torch, np, engines, exec_cfg, get_config, LayeredModel,
                    tree_leaves, is_spec, packing, rc, ServeConfig,
                    sample_batch, counters, dev):
    """deepseek-v2-lite-16b at full width and depth 4 (the dense layer 0 +
    3 MoE layers) with the serve phase's engine settings, every counter
    set to 0 just before and read just after: decode_init on 4 prompts of
    16 tokens, 4 greedy steps, Engine.prefill on the prompts and one at
    B=2 x S=2048 (the capacity path; MLA's plain attention in chunks of
    512), then 12 greedy requests (prompts of 32-128 tokens, 8-16 new)
    into 8 slots with prefill chunks of 16 (128 rows a tick: the dense
    MoE path).  Not counted: the request that waited longest alone (its
    tokens equal to the crowd's bit for bit), the same 2048-token prefill
    at depth 3 (its peak within 5% of depth 4's: a group boundary does not
    make the footprint grow), prefill against decode_init in f32 at depth
    2, and one fetch of each row kind timed.  -> (line, launches,
    routes)."""
    B, P, GEN = 4, 16, 4
    full = get_config(MOE_ARCH, "full")
    rows = group_rows(LayeredModel, tree_leaves, is_spec, full)
    depth = moe_depth(rows, MOE_SERVE_DEPTH, 1, 24 * 2 ** 30)
    cfg = full.replace(n_layers=depth, use_pallas=True)
    eng = engines.create("l2l", cfg, exec_cfg)
    t0 = time.perf_counter()
    params = eng.init_params(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dense_eps = params["groups"][0].segs["float32"]
    moe_eps = params["groups"][1].segs["float32"]
    assert dense_eps.is_pinned() and moe_eps.is_pinned()
    assert dense_eps.shape == (1, rows[0] // 4) and \
        moe_eps.shape == (depth - 1, rows[1] // 4)
    eps_bytes = rows[0] + (depth - 1) * rows[1]
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    long = torch.randint(0, cfg.vocab_size, (2, 2048), device=dev,
                         generator=torch.Generator(dev).manual_seed(2))
    rs = np.random.RandomState(5)
    n_req = 12
    lens = rs.randint(32, 129, size=n_req)
    news = rs.randint(8, 17, size=n_req)
    prompts = [rs.randint(0, cfg.vocab_size, size=(int(n),)).astype(np.int32)
               for n in lens]
    scfg = ServeConfig(**MOE_CROWD)

    def serve(eng_, params_, reqs_in):
        srv = eng_.serve_session(params_, scfg)
        reqs = [srv.submit(p, int(n)) for p, n in reqs_in]
        ticks = []
        t0 = time.perf_counter()
        while not srv.scheduler.idle:
            t1 = time.perf_counter()
            srv.tick()
            ticks.append(time.perf_counter() - t1)
        return srv, reqs, ticks, time.perf_counter() - t0

    # ---------------------------------------------- the counted main path
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    t0 = time.perf_counter()
    caches, last = eng.decode_init(params, prompt, P + GEN)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tok = sample_batch(last)[:, None]
    toks = [tok]
    f0 = counters["relay_copy"].launches
    b0 = counters["relay_copy"].bytes
    t0 = time.perf_counter()
    for i in range(GEN):
        logits, caches = eng.decode_step(params, caches, tok, P + i)
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
        tok = sample_batch(logits[:, -1])[:, None]
        toks.append(tok)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    fetches_per_step = (counters["relay_copy"].launches - f0) / GEN
    step_bytes = (counters["relay_copy"].bytes - b0) / GEN
    decode_peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    pl = eng.prefill(params, {"tokens": prompt})
    torch.cuda.synchronize()
    t_pf = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pl2 = eng.prefill(params, {"tokens": long})
    torch.cuda.synchronize()
    t_pf2 = time.perf_counter() - t0
    peak_by_depth = {str(depth): torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    f0 = counters["relay_copy"].launches
    srv, reqs, ticks, secs = serve(eng, params, zip(prompts, news))
    crowd_fetches = counters["relay_copy"].launches - f0
    launches = {n: c.launches for n, c in counters.items()}
    routes = route_counts(counters)
    crowd_peak = torch.cuda.max_memory_allocated()
    stats = srv.stats()
    toks = torch.cat(toks, dim=1)

    # ---------------------------------------------------- not counted
    pick = max(range(n_req), key=lambda i: reqs[i].t_first)
    _, (solo,), solo_ticks, solo_s = serve(eng, params,
                                           [(prompts[pick], news[pick])])
    d4 = min(3, depth)
    e4 = engines.create("l2l", cfg.replace(n_layers=d4), exec_cfg)
    sub4 = _sub(packing, params, dense_eps, moe_eps, d4 - 1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pl4 = e4.prefill(sub4, {"tokens": long})
    torch.cuda.synchronize()
    peak_by_depth[str(d4)] = torch.cuda.max_memory_allocated()
    e2 = engines.create("l2l", cfg.replace(n_layers=2, dtype="float32"),
                        exec_cfg)
    sub2 = _sub(packing, params, dense_eps, moe_eps, 1)
    _, r2 = e2.decode_init(sub2, prompt, P)
    g2 = e2.prefill(sub2, {"tokens": prompt})
    gap2 = float((g2.float() - r2.float()).norm() / r2.float().norm())
    rel = float((pl.float() - last.float()).norm() / last.float().norm())
    agree = int((pl.argmax(-1) == last.argmax(-1)).sum())
    slot = torch.empty((1, rows[1] // 4), dtype=torch.float32, device=dev)
    moe_ms = time_ms(torch, lambda: rc.copy_rows(moe_eps, 0, size=1,
                                                 device=dev, out=slot), 3,
                     warmup=1)
    dense_ms = time_ms(torch, lambda: rc.copy_rows(
        dense_eps, 0, size=1, device=dev, out=slot[:, :rows[0] // 4]), 3,
        warmup=1)
    n = len(ticks)
    line = {
        "phase": "serve-moe", "arch": full.name, "depth": depth,
        "full_depth": full.n_layers,
        "groups": [[g.name, g.n_layers] for g in eng.model.groups],
        "reduced": f"depth {full.n_layers} -> {depth} (1 dense + "
                   f"{depth - 1} MoE): host memory for the pinned EPS",
        "d_model": cfg.d_model, "heads": cfg.n_heads,
        "experts": [cfg.n_experts, cfg.experts_per_token,
                    cfg.n_shared_experts],
        "kv_lora_rank": cfg.kv_lora_rank, "vocab": cfg.vocab_size,
        "layer_row_bytes": {"dense": rows[0], "moe": rows[1]},
        "eps_pinned_bytes": eps_bytes, "init_s": init_s,
        "batch": B, "prompt": P, "steps": GEN, "tokens": toks.tolist(),
        "decode_init_s": t_init, "decode_s": t_dec,
        "tok_per_s": B * GEN / t_dec,
        "relay_fetches_per_step": fetches_per_step,
        "relay_bytes_per_step": step_bytes,
        "relay_GBps": GEN * step_bytes / t_dec / 1e9,
        "ms_per_moe_row_fetch": moe_ms, "ms_per_dense_row_fetch": dense_ms,
        "moe_row_fetch_GBps": rows[1] / moe_ms / 1e6,
        "decode_peak_allocated_bytes": decode_peak,
        "prefill_16_s": t_pf, "prefill_2048_s": t_pf2,
        "prefill_tok_per_s_2048": 2 * 2048 / t_pf2,
        "rel_l2_prefill_vs_decode_init": {"bf16_full": rel,
                                          "f32_depth2": gap2},
        "argmax_agree": agree,
        "prefill_2048_peak_allocated_by_depth": peak_by_depth,
        "peak_ratio": peak_by_depth[str(depth)] / peak_by_depth[str(d4)],
        "continuous": {
            "serve_config": MOE_CROWD, "requests": n_req,
            "prompt_lens": lens.tolist(), "max_new": news.tolist(),
            "ticks": n, "seconds": secs,
            "tokens": sum(len(r.generated) for r in reqs),
            "tok_per_s": sum(len(r.generated) for r in reqs) / secs,
            "tick_s_median": float(np.median(ticks)),
            "relay_fetches_per_tick": crowd_fetches / n,
            "scheduler_stats": stats,
            "peak_allocated_bytes": crowd_peak,
            "solo": {"request": pick, "ticks": len(solo_ticks),
                     "seconds": solo_s,
                     "tok_per_s": len(solo.generated) / solo_s,
                     "tokens": solo.generated}},
        "launches": launches}
    emit(line)
    assert toks.shape == (B, GEN + 1) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all())
    assert pl2.shape == (2, cfg.vocab_size) and \
        bool(torch.isfinite(pl2).all()) and bool(torch.isfinite(pl4).all())
    # one fetch a layer, and the prefetch ring's clamped re-fetch at the
    # end of each group's pass (41 for granite's 40 layers)
    assert fetches_per_step == depth + 2, fetches_per_step
    # the constant-memory claim across the group boundary
    assert abs(line["peak_ratio"] - 1) <= 0.05, peak_by_depth
    # f32 at depth 2: the dense phases' 1e-4; bf16 at the depth served:
    # granite's 0.35 at 40 layers, the same top-1 token on all but one row
    assert gap2 <= 1e-4 and rel <= 0.35 and agree >= B - 1, \
        line["rel_l2_prefill_vs_decode_init"]
    for r, m in zip(reqs, news):
        assert r.status == "done" and len(r.generated) == m and all(
            0 <= t < cfg.vocab_size for t in r.generated), (r.rid, r.status)
    assert stats["free_pages"] == MOE_CROWD["n_pages"] and \
        stats["free_slots"] == MOE_CROWD["max_batch"] and \
        stats["reserved_pages"] == 0 and stats["active"] == 0 and \
        stats["pending"] == 0, stats
    assert solo.generated == reqs[pick].generated, \
        ("crowded and solo tokens differ", pick)
    del eng, e4, e2, params, sub4, sub2, dense_eps, moe_eps, caches, slot, \
        srv, pl, pl2, pl4, last, logits, r2, g2
    free_host(torch)
    return line, launches, routes


def train_moe_phase(torch, np, engines, ExecutionConfig, knobs, get_config,
                    LayeredModel, tree_leaves, is_spec, SyntheticLM,
                    DataConfig, adam, make_schedule, counters, dev):
    """deepseek-v2-lite-16b at full width and depth 2 (the dense layer 0 +
    one MoE layer) under l2l-p with the train phase's knobs, B=8 x S=512,
    UB=2, 2 steps, every counter set to 0 just before and read just
    after.  Then, not counted: Engine.grads in f32 at depth 2 under l2l-p
    against the baseline engine on the same batch at fan-in scales
    (tests/test_equivalence.py's bound), and one l2l-p step at depth 2 run
    twice from the same state: bitwise (no float atomics in the MoE's
    dispatch, combine and router).  -> (line, launches, routes)."""
    from repro_torch.testing import fan_in_params
    B, S, UB, STEPS = 8, 512, 2, 2
    full = get_config(MOE_ARCH, "full")
    rows = group_rows(LayeredModel, tree_leaves, is_spec, full)
    # w, m and v, twice at the step's peak (the step is functional)
    depth = moe_depth(rows, MOE_TRAIN_DEPTH, 6, 16 * 2 ** 30)
    assert depth >= 2, "the host cannot pin one MoE layer's training state"
    cfg = full.replace(n_layers=depth, use_pallas=True)
    opt = adam(schedule=make_schedule(1e-4, warmup=10))
    eng = engines.create("l2l-p", cfg, ExecutionConfig(n_microbatches=UB,
                                                       **knobs),
                         optimizer=opt)
    t0 = time.perf_counter()
    state = eng.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                   seed=0)).batch(0).items()}
    eps_bytes = 3 * (rows[0] + (depth - 1) * rows[1])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    fetch0, wb0 = counters["relay_copy"].bytes, \
        counters["relay_copy_writeback"].bytes
    steps = []
    for i in range(STEPS):
        t0 = time.perf_counter()
        state, metrics = eng.train_step(state, batch)
        issued = time.perf_counter() - t0
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append({"step": i, "s": dt, "host_issue_s": issued,
                      "tok_per_s": B * S / dt, "loss": loss,
                      "aux": float(metrics["aux"]),
                      "grad_norm": float(metrics["grad_norm"])})
    launches = {n: c.launches for n, c in counters.items()}
    routes = route_counts(counters)
    fetched = counters["relay_copy"].bytes - fetch0
    written = counters["relay_copy_writeback"].bytes - wb0
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.mean([s["s"] for s in steps[1:]]))
    out = {"phase": "train-moe", "arch": full.name, "depth": depth,
           "full_depth": full.n_layers,
           "reduced": f"depth {full.n_layers} -> {depth} (1 dense + "
                      f"{depth - 1} MoE): w, m and v pinned, twice at the "
                      "step's peak",
           "d_model": cfg.d_model, "batch": B, "seq": S,
           "microbatches": UB, "knobs": knobs, "init_s": init_s,
           "eps_pinned_bytes": eps_bytes, "steps": steps,
           "steady_s_per_step": steady,
           "relay_in_bytes_per_step": fetched / STEPS,
           "relay_out_bytes_per_step": written / STEPS,
           "relay_in_GBps": fetched / STEPS / steady / 1e9,
           "relay_out_GBps": written / STEPS / steady / 1e9,
           "peak_allocated_bytes": peak,
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "launches_per_step": {n: v / STEPS for n, v in launches.items()}}
    assert all(np.isfinite(s["loss"]) and s["aux"] > 0 for s in steps), steps
    del eng, state, metrics
    free_host(torch)

    # Engine.grads in f32 at depth 2: l2l-p (the train knobs) against the
    # baseline engine, parameters at fan-in scales
    g2 = cfg.replace(n_layers=2, dtype="float32")
    gen = torch.Generator(dev).manual_seed(1)
    params = fan_in_params(LayeredModel(g2).param_specs(),
                           lambda shape: torch.randn(shape, generator=gen,
                                                     device=dev))
    lb, gb = engines.create("baseline", g2, ExecutionConfig(
        n_microbatches=UB)).grads(params, batch)
    ll, gl = engines.create("l2l-p", g2, ExecutionConfig(
        n_microbatches=UB, **knobs)).grads(params, batch)
    torch.cuda.synchronize()
    # the l2l-p gradients of the layers rest in pinned rows
    lb_ = tree_leaves(gb)
    la = [a.to(b.device) for a, b in zip(tree_leaves(gl), lb_)]
    max_abs = max(float((a - b).abs().max()) for a, b in zip(la, lb_))
    rel_l2 = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                 for a, b in zip(la, lb_))
    rel_max = max_abs / max(float(b.abs().max()) for b in lb_)
    router = float(gl["groups"][1]["ffn"]["router"].abs().mean())
    out["grads_check"] = {
        "dtype": "float32", "depth": 2,
        "params": "fan-in scales (fan_in_params)",
        "loss_l2l_p": float(ll), "loss_baseline": float(lb),
        "max_abs": max_abs, "max_rel_l2_per_leaf": rel_l2,
        "rel_max": rel_max, "bound_rel_max": 1e-5,
        "bitwise": all(torch.equal(a, b) for a, b in zip(la, lb_)),
        "router_grad_abs_mean": router}
    assert rel_max <= 1e-5 and router > 0 and \
        abs(float(ll) - float(lb)) <= 1e-5 * abs(float(lb)), \
        out["grads_check"]
    del params, gb, gl, la, lb_
    free_host(torch)

    # one l2l-p step at depth 2, twice from the same state: bitwise
    e2 = engines.create("l2l-p", cfg.replace(n_layers=2), ExecutionConfig(
        n_microbatches=UB, **knobs), optimizer=opt)
    s0 = e2.init(torch.Generator(dev).manual_seed(2))
    a, ma = e2.train_step(s0, batch)
    b, mb = e2.train_step(s0, batch)
    torch.cuda.synchronize()
    ta = tree_leaves((a.params, a.opt_state))
    tb = tree_leaves((b.params, b.opt_state))
    out["repeat_check"] = {
        "depth": 2, "losses": [float(ma["loss"]), float(mb["loss"])],
        "tensors": len(ta),
        "bitwise": float(ma["loss"]) == float(mb["loss"]) and all(
            torch.equal(x, y) for x, y in zip(ta, tb))}
    emit(out)
    assert out["repeat_check"]["bitwise"], out["repeat_check"]
    del e2, s0, a, b, ta, tb
    free_host(torch)
    return out, launches, routes


# the recurrent families at full width, host allowing at full depth:
# hymba-1.5b (attention heads beside Mamba heads off one norm, GQA 25 over
# 5, a 2048-token window) and rwkv6-1.6b (WKV6, layernorm, no attention)
RECURRENT_ARCHS = ("hymba-1.5b", "rwkv6-1.6b")
# the train phases' depth caps (0: the full depth, host allowing): rwkv6's
# host-bound WKV loop made its 24-layer step 10-19 s
TRAIN_DEPTH_CAP = {"hymba-1.5b": 4, "rwkv6-1.6b": 3}
# serve-recurrent's crowd: a recurrent family feeds one token a tick (the
# ServeEngine forces prefill_chunk to 1), so the prompts stay short
REC_CROWD = dict(max_batch=8, page_size=16, max_seq=48, n_pages=24,
                 prefill_chunk=16)


def window_pairs(B, H, S, window) -> int:
    """(query, key) pairs a causal attention with ``window`` computes."""
    w = window or S
    return B * H * sum(min(i + 1, w) for i in range(S))


def scan_fn(torch, ssm, cfg, B, S, dev):
    """One layer's sequence scan at (B, S) on random inputs of the path's
    dtypes: hymba's ``selective_scan`` over (B, S, d, N) f32 a and b, or
    rwkv6's WKV step scan over (B, H, S, hd) f32 (S sequential steps).
    -> (fn, description)."""
    g = torch.Generator(dev).manual_seed(21)
    if cfg.family == "hybrid":
        shape = (B, S, cfg.d_model, cfg.ssm_state)
        a = torch.rand(shape, generator=g, device=dev)
        b = torch.randn(shape, generator=g, device=dev)
        return (lambda: ssm.selective_scan(a, b)), {
            "scan": "selective_scan (doubling, ceil(log2 S) passes)",
            "shape": list(shape)}
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    r, k, v = (torch.randn(B, H, S, hd, generator=g, device=dev)
               for _ in range(3))
    w = torch.rand(B, H, S, hd, generator=g, device=dev)
    u = torch.randn(H, hd, generator=g, device=dev)
    s0 = torch.zeros(B, H, hd, hd, device=dev)
    return (lambda: ssm._wkv_step_scan(r, k, v, w, u, s0)), {
        "scan": "_wkv_step_scan (S sequential steps)",
        "shape": [B, H, S, hd]}


def gqa_attention_rows(torch, F, dev, g, fa, kops, ref, cfg, fwd, bwd,
                       cells):
    """K2 at a model's prefill shape ``fwd`` = (B, S) and K3a / K3b at its
    training microbatch ``bwd`` = (B, S) (None: K2 only), bf16, causal,
    the model's GQA heads and window, against their plain versions,
    graph-timed; ``cells`` names the two.  hymba: K2 at its window
    prefill (1, 4096, 25, 64) over 5 kv heads, window 2048 (the window
    masks from query 2048 on), K3 at
    (4, 512, 25, 64); internvl2: K2 at (2, 2304, 14, 64) over 2 kv heads
    (2 x 2048 tokens behind 256 patches), K3 at (4, 768, 14, 64).  K2's
    library time is SDPA over the kv heads repeated, the window as an
    explicit boolean mask where there is one; K3's comes from
    ``backward_device_ms`` (SDPA's backward over the kv heads repeated,
    after the timed phases)."""
    rows = []
    H, Hkv, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.sliding_window
    B, S = fwd
    q = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=dev).bfloat16()
            for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = kops.flash_attention(q, k, v, causal=True, window=W)
    lse = fa.flash_attention_fwd_bhsd(qt, kt, vt, causal=True, window=W)[1]
    po, plse = fa.flash_attention_fwd_bhsd_plain(qt, kt, vt, causal=True,
                                                 window=W)
    emu, _ = ref.ref_attention(qt, kt, vt, causal=True, window=W,
                               tensor_cores=True)
    i = torch.arange(S, device=dev)
    mask = ((i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < W)
            if W else None)
    ke, ve = (t.repeat_interleave(H // Hkv, dim=1) for t in (kt, vt))

    def sdpa():
        return F.scaled_dot_product_attention(qt, ke, ve, attn_mask=mask,
                                              is_causal=mask is None)
    lib_o = sdpa()
    torch.cuda.synchronize()
    err = float((o.float() - po.transpose(1, 2).float()).abs().max())
    lerr = float((lse - plse).abs().max())
    assert err <= 2e-2 and lerr <= 2e-2, ("K2", cells[0], err, lerr)
    pairs = window_pairs(B, H, S, W)
    ops = 4 * D * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * 2 + lse.numel() * 4
    rows.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "kernel_route": "wgmma", "cell": cells[0],
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:46",
        "shape": [B, S, H, D], "layout": "BSHD", "kv_heads": Hkv,
        "window": W, "dtype": "bfloat16", "pairs": pairs,
        "pairs_without_window": window_pairs(B, H, S, 0),
        "max_abs_err": err, "lse_max_abs_err": lerr,
        "emulation_err": float((o.float() - emu.transpose(1, 2).float())
                               .abs().max()),
        "ms": graph_ms(torch, lambda: fa.flash_attention_fwd_bhsd(
            qt, kt, vt, causal=True, window=W), 10),
        "plain_ms": time_ms(torch, lambda: fa.flash_attention_fwd_bhsd_plain(
            qt, kt, vt, causal=True, window=W), 3),
        "library_ms": graph_ms(torch, sdpa, 10),
        "library_covers": ("SDPA, the window as a boolean mask, kv heads "
                           "repeated" if W else
                           "SDPA, causal, kv heads repeated"),
        "library_err": float((lib_o.float() - po.float()).abs().max()),
        "timing": "ms, library_ms: a CUDA graph of the calls; plain_ms: "
                  "back-to-back eager calls",
        "bound_ms": max(ops / H100_BF16_OPS, nbytes / H100_HBM_BPS) * 1e3,
        "bound_by": ("operations" if ops / H100_BF16_OPS
                     > nbytes / H100_HBM_BPS else "bytes")})
    del q, k, v, qt, kt, vt, o, lse, po, plse, emu, ke, ve, lib_o, mask
    if bwd is None:                     # a model the paths do not train
        return rows

    B, S = bwd
    q = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16() \
        .requires_grad_()
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=dev).bfloat16()
            .requires_grad_() for _ in range(2))
    o = kops.flash_attention(q, k, v, causal=True, window=W)
    do = torch.randn(o.shape, generator=g, device=dev).bfloat16()
    got = torch.autograd.grad(o, (q, k, v), do)
    qt, kt, vt, ot, dot = (t.detach().transpose(1, 2)
                           for t in (q, k, v, o, do))
    _, lse = fa.flash_attention_fwd_bhsd(qt, kt, vt, causal=True, window=W)
    plain = fa.flash_attention_bwd_bhsd_plain(qt, kt, vt, ot, lse, dot,
                                              causal=True, window=W)
    emu = ref.ref_attention_bwd(qt, kt, vt, ot, lse, dot, causal=True,
                                window=W, tensor_cores=True)
    torch.cuda.synchronize()
    errs = [float((x.float() - y.transpose(1, 2).float()).abs().max())
            for x, y in zip(got, plain)]
    emu_errs = [float((x.float() - y.transpose(1, 2).float()).abs().max())
                for x, y in zip(got, emu)]
    tops = [float(y.float().abs().max()) for y in plain]
    # as the train kernel rows: 1e-2 of the largest gradient of each
    assert all(e <= 1e-2 * t for e, t in zip(errs, tops)), (errs, tops)
    delta = (dot.float() * ot.float()).sum(-1).contiguous()
    plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_bhsd_plain(
        qt, kt, vt, ot, lse, dot, causal=True, window=W), 5)
    pairs = window_pairs(B, H, S, W)
    in_bytes = (3 * q.numel() + 2 * k.numel()) * 2 + 2 * lse.numel() * 4
    for name, ops, err, emu_err, top, out_bytes, line, src, kern in (
            ("flash_attention_bwd_dq", 6 * D * pairs, errs[0], emu_errs[0],
             tops[0], 2 * q.numel(), 145, "flash_attention_dq_sm90.cu",
             fa.flash_attention_bwd_dq),
            ("flash_attention_bwd_dkv", 8 * D * pairs, max(errs[1:]),
             max(emu_errs[1:]), max(tops[1:]), 4 * k.numel(), 174,
             "flash_attention_bwd_sm90.cu", fa.flash_attention_bwd_dkv)):
        nbytes = in_bytes + out_bytes
        rows.append({
            "name": name, "route": "cuda", "kernel_route": "wgmma",
            "cell": cells[1],
            "source": "src/repro_torch/kernels/csrc/" + src,
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "shape": [B, S, H, D], "layout": "BSHD", "kv_heads": Hkv,
            "window": W, "dtype": "bfloat16", "max_abs_err": err,
            "max_abs_grad": top, "emulation_err": emu_err,
            "ms": graph_ms(torch, lambda kern=kern: kern(
                qt, kt, vt, dot, lse, delta, causal=True, window=W), 20),
            "plain_ms": plain_ms, "plain_covers": "dq, dk and dv",
            "timing": "ms: a CUDA graph of the calls; library_ms, "
                      "profiled_ms: device spans under torch.profiler "
                      "after the timed phases; plain_ms: eager calls",
            "bound_ms": max(ops / H100_BF16_OPS,
                            nbytes / H100_HBM_BPS) * 1e3,
            "bound_by": ("operations" if ops / H100_BF16_OPS
                         > nbytes / H100_HBM_BPS else "bytes")})
    return rows


def serve_recurrent_phase(torch, np, engines, exec_cfg, arch, get_config,
                          LayeredModel, tree_leaves, is_spec, packing, ssm,
                          ServeConfig, sample_batch, counters, dev):
    """``arch`` (hymba-1.5b or rwkv6-1.6b) at full width and, host
    allowing, full depth with the serve phase's engine settings, every
    counter set to 0 just before and read just after: decode_init on 4
    prompts of 16 tokens, 8 greedy steps, Engine.prefill on the prompts
    and at B=2 x S=2048 (for hymba also at B=1 x S=4096, where its 2048
    window masks), then 12 greedy requests (prompts of 8-32 tokens, 4-8
    new) into 8 slots (the ServeEngine forces a recurrent family's prefill
    chunk to 1).  Not counted: the request that waited longest alone (its
    tokens equal to the crowd's bit for bit), prefill against decode_init
    in f32 at depth 2 and in bf16 at depths 1, 4 (also at fan-in scales)
    and the full depth, one layer's scan at the 2 x 2048 prefill's shape
    timed.  -> (line, launches, routes)."""
    from repro_torch.testing import fan_in_params
    B, P, GEN = 4, 16, 8
    full = get_config(arch, "full")
    (row,) = group_rows(LayeredModel, tree_leaves, is_spec, full)
    depth = host_depth(row, full.n_layers, reserve=24 * 2 ** 30)
    cfg = full.replace(n_layers=depth, use_pallas=True)
    hybrid = cfg.family == "hybrid"
    eng = engines.create("l2l", cfg, exec_cfg)
    t0 = time.perf_counter()
    params = eng.init_params(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eps = params["groups"][0].segs["float32"]
    assert eps.is_pinned() and eps.shape == (depth, row // 4)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    long = torch.randint(0, cfg.vocab_size, (2, 2048), device=dev,
                         generator=torch.Generator(dev).manual_seed(2))
    longer = torch.randint(0, cfg.vocab_size, (1, 4096), device=dev,
                           generator=torch.Generator(dev).manual_seed(3))
    rs = np.random.RandomState(6)
    n_req = 12
    lens = rs.randint(8, 33, size=n_req)
    news = rs.randint(4, 9, size=n_req)
    prompts = [rs.randint(0, cfg.vocab_size, size=(int(n),)).astype(np.int32)
               for n in lens]
    scfg = ServeConfig(**REC_CROWD)

    def serve(reqs_in):
        srv = eng.serve_session(params, scfg)
        reqs = [srv.submit(p, int(n)) for p, n in reqs_in]
        ticks = []
        t0 = time.perf_counter()
        while not srv.scheduler.idle:
            t1 = time.perf_counter()
            srv.tick()
            ticks.append(time.perf_counter() - t1)
        return srv, reqs, ticks, time.perf_counter() - t0

    # ---------------------------------------------- the counted main path
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    t0 = time.perf_counter()
    caches, last = eng.decode_init(params, prompt, P + GEN)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tok = sample_batch(last)[:, None]
    toks = [tok]
    f0, b0 = counters["relay_copy"].launches, counters["relay_copy"].bytes
    t0 = time.perf_counter()
    for i in range(GEN):
        logits, caches = eng.decode_step(params, caches, tok, P + i)
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
        tok = sample_batch(logits[:, -1])[:, None]
        toks.append(tok)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    fetches_per_step = (counters["relay_copy"].launches - f0) / GEN
    step_bytes = (counters["relay_copy"].bytes - b0) / GEN
    decode_peak = torch.cuda.max_memory_allocated()
    pl = eng.prefill(params, {"tokens": prompt})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pl2 = eng.prefill(params, {"tokens": long})
    torch.cuda.synchronize()
    t_pf2 = time.perf_counter() - t0
    peak_2048 = torch.cuda.max_memory_allocated()
    pf4 = {}
    if hybrid:
        k2 = counters["flash_attention_fwd"].launches
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pl4 = eng.prefill(params, {"tokens": longer})
        torch.cuda.synchronize()
        pf4 = {"prefill_4096_s": time.perf_counter() - t0,
               "prefill_4096_k2_launches":
                   counters["flash_attention_fwd"].launches - k2,
               "prefill_4096_peak_allocated_bytes":
                   torch.cuda.max_memory_allocated()}
        assert pl4.shape == (1, cfg.vocab_size) and \
            bool(torch.isfinite(pl4).all())
    torch.cuda.reset_peak_memory_stats()
    f0, b0 = counters["relay_copy"].launches, counters["relay_copy"].bytes
    srv, reqs, ticks, secs = serve(zip(prompts, news))
    crowd_fetches = counters["relay_copy"].launches - f0
    crowd_bytes = counters["relay_copy"].bytes - b0
    launches = {n: c.launches for n, c in counters.items()}
    routes = route_counts(counters)
    crowd_peak = torch.cuda.max_memory_allocated()
    stats = srv.stats()
    toks = torch.cat(toks, dim=1)

    # ---------------------------------------------------- not counted
    pick = max(range(n_req), key=lambda i: reqs[i].t_first)
    _, (solo,), solo_ticks, solo_s = serve([(prompts[pick], news[pick])])

    def gap(d, dt, sub=None):
        """prefill's last logits against decode_init's, relative L2, at
        depth d in dtype dt: on the first d rows, or on ``sub``."""
        e = engines.create("l2l", cfg.replace(n_layers=d, dtype=dt),
                           exec_cfg)
        sub = sub or {**params, "groups": (packing.Packed(
            {"float32": eps[:d]}, params["groups"][0].spec),)}
        _, want = e.decode_init(sub, prompt, P)
        got = e.prefill(sub, {"tokens": prompt})
        return float((got.float() - want.float()).norm()
                     / want.float().norm())

    gen = torch.Generator(dev).manual_seed(4)
    fan = fan_in_params(LayeredModel(cfg.replace(n_layers=4)).param_specs(),
                        lambda shape: torch.randn(shape, generator=gen,
                                                  device=dev))
    gaps = {"f32_depth2": gap(2, "float32"), "bf16_depth1": gap(1, "bfloat16"),
            "bf16_depth4": gap(4, "bfloat16"),
            "bf16_full": float((pl.float() - last.float()).norm()
                               / last.float().norm()),
            "bf16_depth4_fan_in": gap(4, "bfloat16", fan)}
    del fan
    agree = int((pl.argmax(-1) == last.argmax(-1)).sum())
    fn, scan = scan_fn(torch, ssm, cfg, 2, 2048, dev)
    with torch.inference_mode():
        scan["ms_per_layer"] = time_ms(torch, fn, 2, warmup=1)
    scan["timing"] = ("CUDA events around eager calls: the host's issue "
                      "time where it is the longer")
    est = eng.serve_memory_estimate(scfg)
    n = len(ticks)
    line = {
        "phase": "serve-recurrent", "arch": full.name, "depth": depth,
        "full_depth": full.n_layers, "family": cfg.family,
        "reduced": (None if depth == full.n_layers else
                    f"depth {full.n_layers} -> {depth}: host memory for "
                    "the pinned EPS"),
        "d_model": cfg.d_model, "vocab": cfg.vocab_size,
        "heads": ([cfg.n_heads, cfg.n_kv_heads, cfg.d_head] if hybrid
                  else [cfg.rwkv_heads, cfg.rwkv_head_dim]),
        "window": cfg.sliding_window, "layer_row_bytes": row,
        "eps_pinned_bytes": depth * row, "init_s": init_s,
        "batch": B, "prompt": P, "steps": GEN, "tokens": toks.tolist(),
        "decode_init_s": t_init, "decode_s": t_dec,
        "tok_per_s": B * GEN / t_dec,
        "relay_fetches_per_step": fetches_per_step,
        "relay_bytes_per_step": step_bytes,
        "relay_GBps": GEN * step_bytes / t_dec / 1e9,
        "decode_peak_allocated_bytes": decode_peak,
        "prefill_2048_s": t_pf2, "prefill_tok_per_s_2048": 2 * 2048 / t_pf2,
        "prefill_2048_peak_allocated_bytes": peak_2048, **pf4,
        "scan_layer": scan,
        "rel_l2_prefill_vs_decode_init": gaps,
        "argmax_agree": agree,
        "continuous": {
            "serve_config": REC_CROWD,
            "prefill_chunk_run": srv.cfg.prefill_chunk, "requests": n_req,
            "prompt_lens": lens.tolist(), "max_new": news.tolist(),
            "ticks": n, "seconds": secs,
            "tokens": sum(len(r.generated) for r in reqs),
            "tok_per_s": sum(len(r.generated) for r in reqs) / secs,
            "tick_s_median": float(np.median(ticks)),
            "relay_fetches_per_tick": crowd_fetches / n,
            "relay_GBps": crowd_bytes / secs / 1e9,
            "scheduler_stats": stats,
            "peak_allocated_bytes": crowd_peak,
            "estimate_serve": {k: getattr(est, k) for k in (
                "kv_page_bytes", "slot_state_bytes", "total_device")},
            "solo": {"request": pick, "ticks": len(solo_ticks),
                     "seconds": solo_s,
                     "tok_per_s": len(solo.generated) / solo_s,
                     "tokens": solo.generated}},
        "launches": launches}
    emit(line)
    assert toks.shape == (B, GEN + 1) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all())
    assert pl2.shape == (2, cfg.vocab_size) and bool(torch.isfinite(pl2).all())
    # one fetch a layer, and the prefetch ring's clamped re-fetch at the
    # end of the pass
    assert fetches_per_step == depth + 1, fetches_per_step
    if hybrid:
        # the 4096-token prefill ran K2 (window 2048) once a layer
        assert pf4["prefill_4096_k2_launches"] == depth, pf4
    # f32 at depth 2: the dense phases' 1e-4 (a wrong mask, position or
    # state shows as O(1)); bf16 at depth 1 and at depth 4 with fan-in
    # scales: 0.1.  bf16 at full depth is printed, not bounded: at the
    # reference's init (std 1/sqrt(depth) for every matrix) the stack
    # amplifies the decode's bf16 state rounding (the reference's cast
    # points) without limit
    assert gaps["f32_depth2"] <= 1e-4 and gaps["bf16_depth1"] <= 0.1 and \
        gaps["bf16_depth4_fan_in"] <= 0.1, gaps
    assert srv.cfg.prefill_chunk == 1, srv.cfg
    for r, m in zip(reqs, news):
        assert r.status == "done" and len(r.generated) == m and all(
            0 <= t < cfg.vocab_size for t in r.generated), (r.rid, r.status)
    assert stats["free_pages"] == REC_CROWD["n_pages"] and \
        stats["free_slots"] == REC_CROWD["max_batch"] and \
        stats["active"] == 0 and stats["pending"] == 0, stats
    assert solo.generated == reqs[pick].generated, \
        ("crowded and solo tokens differ", pick)
    del eng, params, eps, caches, srv, pl, pl2, last, logits, fn
    pf4.clear()
    free_host(torch)
    return line, launches, routes


VLM_ARCH = "internvl2-1b"
AUDIO_ARCH = "whisper-base"
# internvl2's text lengths: (S + 256 patches) % 128 == 0, the flash
# kernels' tiling (prompts of 128: 384 positions; prefill rows of 2048:
# 2304; train rows of 512: 768)
VLM_PROMPT, VLM_PREFILL = 128, 2048
VLM_TRAIN = dict(batch=8, seq=512, ub=2)
# whisper's decoder: at most 448 target positions (max_target_positions)
AUDIO_TARGET = 448


def modality_k4_rows(torch, dev, g, rc, ref, get_config, LayeredModel,
                     tree_leaves, is_spec):
    """K4 at the modality families' layer rows, f32, each way: an
    internvl2 layer (14.9 M elements) and whisper's encoder and decoder
    layers (3.15 M, 4.20 M) (``k4_rows``)."""
    cells = []
    for arch in (VLM_ARCH, AUDIO_ARCH):
        full = get_config(arch, "full")
        cells += [(f"{full.name} {gname} row", nbytes) for gname, nbytes in
                  zip([gr.name for gr in LayeredModel(full).groups],
                      group_rows(LayeredModel, tree_leaves, is_spec, full))]
    return k4_rows(torch, dev, g, rc, ref, cells)


def k4_rows(torch, dev, g, rc, ref, cells):
    """K4 at each ``(cell, bytes)`` row, f32, each way: pinned host -> HBM
    by the relay's route and back by its write-back route, against
    ``copy_`` in turns on the same buffers, each bit for bit against its
    plain version."""
    rows = []
    for cell, nbytes in cells:
        n = nbytes // 4
        host = torch.empty(2, n, dtype=torch.float32, pin_memory=True)
        host.copy_(torch.randn(2, n, generator=g, device=dev).cpu())
        slot = torch.empty(1, n, dtype=torch.float32, device=dev)
        got = rc.copy_rows(host, 1, size=1, device=dev, out=slot)
        plain = ref.ref_copy_rows(host, 1, 1, device=dev)
        torch.cuda.synchronize()
        assert torch.equal(got, plain), ("relay_copy", cell)
        ms, lib_ms = rotation(torch, (
            lambda: rc.copy_rows(host, 1, size=1, device=dev, out=slot),
            lambda: slot.copy_(host[1:2], non_blocking=True)), 5,
            timer=time_ms)
        common = {"route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/relay_copy.cu",
                  "cell": cell, "shape": [1, n], "dtype": "float32",
                  "host_alloc": "pinned (torch.empty(pin_memory=True))",
                  "grid_blocks": rc.LINE_BLOCKS,
                  "timing": "ms, library_ms (copy_): back-to-back "
                            "calls, in turns on the same buffers; "
                            "plain_ms: eager calls",
                  "bound_ms": nbytes / PCIE5_X16_BPS * 1e3,
                  "bound_by": "bytes"}
        rows.append({
            "name": "relay_copy", **common,
            "kernel_route": rc.FETCH_ROUTE,
            "replaces": "src/repro/kernels/relay_copy.py:58",
            "max_abs_err": 0.0, "ms": ms, "library_ms": lib_ms,
            "plain_ms": time_ms(torch, lambda: ref.ref_copy_rows(
                host, 1, 1, device=dev), 5),
            "achieved_GBps": nbytes / ms / 1e6,
            "library_GBps": nbytes / lib_ms / 1e6})
        src = slot[0].clone()
        host[0].zero_()
        rc.writeback_rows(src, host, 0)
        torch.cuda.synchronize()
        assert torch.equal(host[0], src.cpu()), ("write-back", cell)
        ms, lib_ms = rotation(torch, (
            lambda: rc.writeback_rows(src, host, 0),
            lambda: host[0].copy_(src, non_blocking=True)), 5,
            timer=time_ms)
        rows.append({
            "name": "relay_copy_writeback", **common,
            "kernel_route": rc.WRITEBACK_ROUTE,
            "replaces": "src/repro/kernels/relay_copy.py:128",
            "max_abs_err": 0.0, "ms": ms, "library_ms": lib_ms,
            "plain_ms": time_ms(torch, lambda: rc.writeback_rows_plain(
                src, host, 0), 5),
            "achieved_GBps": nbytes / ms / 1e6,
            "library_GBps": nbytes / lib_ms / 1e6})
        del host, slot, got, plain, src
    return rows


def serve_vlm_phase(torch, np, engines, exec_cfg, get_config, LayeredModel,
                    tree_leaves, is_spec, packing, sample_batch, counters,
                    dev):
    """internvl2-1b at full width and, host allowing, full depth with the
    serve phase's engine settings, every counter set to 0 just before and
    read just after: decode_init on 4 text prompts of 128 tokens (the
    reference decodes the language backbone), 8 greedy steps,
    Engine.prefill at 4 x 128 tokens and at 2 x 2048 tokens, each behind
    256 stub patches (384 and 2304 positions: K2 at GQA 7 once a layer).
    Not counted: prefill against decode_init on the text-only backbone
    in f32 at depth 2 and in bf16 at depth 1 (bounded) and at the full
    depth (printed).  -> (line, launches, routes)."""
    B, P, GEN = 4, VLM_PROMPT, 8
    full = get_config(VLM_ARCH, "full")
    (row,) = group_rows(LayeredModel, tree_leaves, is_spec, full)
    depth = host_depth(row, full.n_layers, reserve=24 * 2 ** 30)
    cfg = full.replace(n_layers=depth, use_pallas=True)
    eng = engines.create("l2l", cfg, exec_cfg)
    t0 = time.perf_counter()
    params = eng.init_params(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eps = params["groups"][0].segs["float32"]
    assert eps.is_pinned() and eps.shape == (depth, row // 4)
    gen = torch.Generator(dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                           generator=gen)
    long = torch.randint(0, cfg.vocab_size, (2, VLM_PREFILL), device=dev,
                         generator=gen)
    # the stub ViT features, f32 as add_modality_stubs makes them
    patches = torch.randn(B, cfg.n_patches, cfg.vit_dim, device=dev,
                          generator=gen)

    # ---------------------------------------------- the counted main path
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    t0 = time.perf_counter()
    caches, last = eng.decode_init(params, prompt, P + GEN)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tok = sample_batch(last)[:, None]
    toks = [tok]
    f0, b0 = counters["relay_copy"].launches, counters["relay_copy"].bytes
    t0 = time.perf_counter()
    for i in range(GEN):
        logits, caches = eng.decode_step(params, caches, tok, P + i)
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
        tok = sample_batch(logits[:, -1])[:, None]
        toks.append(tok)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    fetches_per_step = (counters["relay_copy"].launches - f0) / GEN
    step_bytes = (counters["relay_copy"].bytes - b0) / GEN
    decode_peak = torch.cuda.max_memory_allocated()
    k2 = counters["flash_attention_fwd"].launches
    t0 = time.perf_counter()
    pl = eng.prefill(params, {"tokens": prompt, "patches": patches})
    torch.cuda.synchronize()
    t_pf = time.perf_counter() - t0
    k2_small = counters["flash_attention_fwd"].launches - k2
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pl2 = eng.prefill(params, {"tokens": long, "patches": patches[:2]})
    torch.cuda.synchronize()
    t_pf2 = time.perf_counter() - t0
    peak_2048 = torch.cuda.max_memory_allocated()
    launches = {n: c.launches for n, c in counters.items()}
    routes = route_counts(counters)
    toks = torch.cat(toks, dim=1)

    # ---------------------------------------------------- not counted
    text = cfg.replace(is_vlm=False)

    def gap(d, dt):
        """Text-only prefill's last logits against decode_init's,
        relative L2, on the first d rows in dtype dt."""
        e = engines.create("l2l", text.replace(n_layers=d, dtype=dt),
                           exec_cfg)
        sub = {**params, "groups": (packing.Packed(
            {"float32": eps[:d]}, params["groups"][0].spec),)}
        _, want = e.decode_init(sub, prompt, P)
        got = e.prefill(sub, {"tokens": prompt})
        return float((got.float() - want.float()).norm()
                     / want.float().norm())

    gaps = {"f32_depth2": gap(2, "float32"), "bf16_depth1": gap(1, "bfloat16"),
            "bf16_full": gap(depth, "bfloat16")}
    line = {
        "phase": "serve-vlm", "arch": full.name, "depth": depth,
        "full_depth": full.n_layers, "family": cfg.family,
        "reduced": (None if depth == full.n_layers else
                    f"depth {full.n_layers} -> {depth}: host memory for "
                    "the pinned EPS"),
        "d_model": cfg.d_model, "vocab": cfg.vocab_size,
        "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.d_head],
        "patches": [cfg.n_patches, cfg.vit_dim], "layer_row_bytes": row,
        "eps_pinned_bytes": depth * row, "init_s": init_s,
        "batch": B, "prompt": P, "steps": GEN, "tokens": toks.tolist(),
        "decode_init_s": t_init, "decode_s": t_dec,
        "tok_per_s": B * GEN / t_dec,
        "relay_fetches_per_step": fetches_per_step,
        "relay_bytes_per_step": step_bytes,
        "relay_GBps": GEN * step_bytes / t_dec / 1e9,
        "decode_peak_allocated_bytes": decode_peak,
        "prefill_128_positions": P + cfg.n_patches, "prefill_128_s": t_pf,
        "prefill_128_k2_launches": k2_small,
        "prefill_2048_positions": VLM_PREFILL + cfg.n_patches,
        "prefill_2048_s": t_pf2,
        "prefill_tok_per_s_2048": 2 * (VLM_PREFILL + cfg.n_patches) / t_pf2,
        "prefill_2048_peak_allocated_bytes": peak_2048,
        "rel_l2_text_prefill_vs_decode_init": gaps,
        "launches": launches}
    emit(line)
    assert toks.shape == (B, GEN + 1) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all())
    for x, n in ((pl, B), (pl2, 2)):
        assert x.shape == (n, cfg.vocab_size) and bool(torch.isfinite(x).all())
    assert fetches_per_step == depth + 1, fetches_per_step
    assert k2_small == depth, k2_small
    # f32 at depth 2: the dense phases' 1e-4; bf16 at depth 1: 0.1
    assert gaps["f32_depth2"] <= 1e-4 and gaps["bf16_depth1"] <= 0.1, gaps
    del eng, params, eps, caches, pl, pl2, last, logits, patches
    free_host(torch)
    return line, launches, routes


def serve_audio_phase(torch, np, engines, exec_cfg, get_config, LayeredModel,
                      tree_leaves, is_spec, sample_batch, counters, dev):
    """whisper-base at full width and depth (6 encoder + 6 decoder
    layers) with the serve phase's engine settings and ``use_pallas=False``
    (its 1500 frames do not tile by the flash kernel's 128-row block:
    attention is the plain ``attend``), every counter set to 0 just
    before and read just after: decode_init with 1500 stub frames on 4
    prompts of 16 tokens (the encoder's one-shot pass and the decoder's
    cross K/V through the relay, then a serve step a token), 8 greedy
    steps, Engine.prefill at 4 x 448 target tokens with the frames.  Not
    counted: prefill against decode_init at full depth in f32 at fan-in
    scales (bounded) and at the reference's init in f32 and bf16 (printed:
    its std-1/sqrt(6) matrices make the 1500-key softmax ill-conditioned).
    -> (line, launches, routes)."""
    from repro_torch.testing import fan_in_params
    B, P, GEN = 4, 16, 8
    full = get_config(AUDIO_ARCH, "full")
    cfg = full.replace(use_pallas=False)
    enc_row, dec_row = group_rows(LayeredModel, tree_leaves, is_spec, full)
    eng = engines.create("l2l", cfg, exec_cfg)
    t0 = time.perf_counter()
    params = eng.init_params(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    assert all(g.segs["float32"].is_pinned() for g in params["groups"])
    gen = torch.Generator(dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                           generator=gen)
    targets = torch.randint(0, cfg.vocab_size, (B, AUDIO_TARGET),
                            device=dev, generator=gen)
    frames = torch.randn(B, cfg.n_frames, cfg.d_model, device=dev,
                         generator=gen).to(torch.bfloat16)

    # ---------------------------------------------- the counted main path
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    t0 = time.perf_counter()
    caches, last = eng.decode_init(params, prompt, P + GEN, frames=frames)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_fetches = counters["relay_copy"].launches
    tok = sample_batch(last)[:, None]
    toks = [tok]
    f0, b0 = counters["relay_copy"].launches, counters["relay_copy"].bytes
    t0 = time.perf_counter()
    for i in range(GEN):
        logits, caches = eng.decode_step(params, caches, tok, P + i)
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
        tok = sample_batch(logits[:, -1])[:, None]
        toks.append(tok)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    fetches_per_step = (counters["relay_copy"].launches - f0) / GEN
    step_bytes = (counters["relay_copy"].bytes - b0) / GEN
    decode_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pl = eng.prefill(params, {"tokens": targets, "frames": frames})
    torch.cuda.synchronize()
    t_pf = time.perf_counter() - t0
    peak_pf = torch.cuda.max_memory_allocated()
    launches = {n: c.launches for n, c in counters.items()}
    routes = route_counts(counters)
    toks = torch.cat(toks, dim=1)
    # decode_init's fetches beyond its P serve steps: the encoder's pass
    # and the decoder's cross K/V pass
    one_shot = init_fetches - P * fetches_per_step

    # ---------------------------------------------------- not counted
    def gap(dt, p=params):
        e = engines.create("l2l", cfg.replace(dtype=dt), exec_cfg)
        f = frames.to(getattr(torch, dt))
        _, want = e.decode_init(p, prompt, P, frames=f)
        got = e.prefill(p, {"tokens": prompt, "frames": f})
        return float((got.float() - want.float()).norm()
                     / want.float().norm())

    fan = fan_in_params(LayeredModel(cfg).param_specs(),
                        lambda shape: torch.randn(shape, generator=gen,
                                                  device=dev))
    gaps = {"f32_full_fan_in": gap("float32", fan), "f32_full": gap("float32"),
            "bf16_full": gap("bfloat16")}
    del fan
    n_enc, n_dec = cfg.n_encoder_layers, cfg.n_layers
    line = {
        "phase": "serve-audio", "arch": full.name,
        "depth": [n_enc, n_dec], "family": cfg.family,
        "use_pallas": cfg.use_pallas,
        "attention": "attend (plain): 1500 frames do not tile by 128",
        "d_model": cfg.d_model, "vocab": cfg.vocab_size,
        "frames": cfg.n_frames, "layer_row_bytes": [enc_row, dec_row],
        "eps_pinned_bytes": n_enc * enc_row + n_dec * dec_row,
        "init_s": init_s, "batch": B, "prompt": P, "steps": GEN,
        "tokens": toks.tolist(), "decode_init_s": t_init,
        "decode_init_fetches": init_fetches,
        "one_shot_pass_fetches": one_shot,
        "decode_s": t_dec, "tok_per_s": B * GEN / t_dec,
        "relay_fetches_per_step": fetches_per_step,
        "relay_bytes_per_step": step_bytes,
        "relay_GBps": GEN * step_bytes / t_dec / 1e9,
        "decode_peak_allocated_bytes": decode_peak,
        "prefill_targets": AUDIO_TARGET, "prefill_s": t_pf,
        "prefill_peak_allocated_bytes": peak_pf,
        "rel_l2_prefill_vs_decode_init": gaps,
        "launches": launches}
    emit(line)
    assert toks.shape == (B, GEN + 1) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all())
    assert pl.shape == (B, cfg.vocab_size) and bool(torch.isfinite(pl).all())
    # a decode step relays the decoder only (one fetch a layer, and the
    # ring's clamped re-fetch); the one-shot pass each group once, and
    # the ring's re-fetch per group
    assert fetches_per_step == n_dec + 1, fetches_per_step
    assert one_shot == n_enc + n_dec + 2, one_shot
    # f32 at full depth and fan-in scales: the dense phases' 1e-4
    assert gaps["f32_full_fan_in"] <= 1e-4, gaps
    del eng, params, caches, pl, last, logits, frames
    free_host(torch)
    return line, launches, routes


def _depths(cfg, n):
    """``cfg`` at depth n: whisper's encoder and decoder both."""
    return cfg.replace(n_layers=n, **({"n_encoder_layers": n}
                                      if cfg.n_encoder_layers else {}))


def train_family_phase(torch, np, engines, ExecutionConfig, knobs, arch,
                       get_config, LayeredModel, tree_leaves, is_spec,
                       SyntheticLM, DataConfig, add_modality_stubs, adam,
                       make_schedule, counters, dev, *, phase, seq=512,
                       depth_cap=0):
    """``arch`` at full width and, host allowing, full depth (at most
    ``depth_cap`` layers when given) under l2l-p with the train phase's
    knobs, B=8 x S=``seq``, UB=2, 3 steps, every counter set to 0 just
    before and read just after (internvl2's 256 patches and whisper's
    1500 frames from ``add_modality_stubs``; whisper with
    ``use_pallas=False``, every other family with the flash kernels).
    Then, not counted: Engine.grads in f32 at depth 2 under l2l-p against
    the baseline engine at fan-in scales, the relay knobs (pack,
    prefetch, G; for the modality families also K = stash_every) at depth
    3 in bf16 against the plain schedule's grads bit for bit, and one
    l2l-p step at depth 2 run twice from the same state, bitwise.
    -> (line, launches, routes)."""
    from repro_torch.testing import fan_in_params
    B, S, UB, STEPS = 8, seq, 2, 3
    full = get_config(arch, "full")
    rows = group_rows(LayeredModel, tree_leaves, is_spec, full)
    if len(rows) == 1:
        # w, m and v, twice at the step's peak (the step is functional)
        depth = host_depth(6 * rows[0], depth_cap or full.n_layers,
                           reserve=16 * 2 ** 30)
    else:
        # whisper-base: 6 + 6 layers of 12.6 / 16.8 MB, pinned whole
        depth = full.n_layers
    assert depth >= 3, "the host cannot pin three layers' training state"
    audio = full.family == "audio"
    cfg = full.replace(n_layers=depth, use_pallas=not audio)
    opt = adam(schedule=make_schedule(1e-4, warmup=10))
    eng = engines.create("l2l-p", cfg, ExecutionConfig(n_microbatches=UB,
                                                       **knobs),
                         optimizer=opt)
    t0 = time.perf_counter()
    state = eng.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {k: torch.from_numpy(v).to(dev) for k, v in add_modality_stubs(
        SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                               global_batch=B, seed=0)).batch(0), cfg,
        np.random.default_rng(0)).items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    fetch0, wb0 = counters["relay_copy"].bytes, \
        counters["relay_copy_writeback"].bytes
    steps = []
    for i in range(STEPS):
        t0 = time.perf_counter()
        state, metrics = eng.train_step(state, batch)
        issued = time.perf_counter() - t0
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append({"step": i, "s": dt, "host_issue_s": issued,
                      "tok_per_s": B * S / dt, "loss": loss,
                      "grad_norm": float(metrics["grad_norm"])})
    launches = {n: c.launches for n, c in counters.items()}
    routes = route_counts(counters)
    fetched = counters["relay_copy"].bytes - fetch0
    written = counters["relay_copy_writeback"].bytes - wb0
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.mean([s["s"] for s in steps[1:]]))
    out = {"phase": phase, "arch": full.name, "depth": depth,
           "full_depth": full.n_layers,
           "encoder_depth": cfg.n_encoder_layers or None,
           "reduced": (None if depth == full.n_layers else
                       f"depth {full.n_layers} -> {depth}: " + (
                           f"the phase's cap ({depth_cap})"
                           if depth == depth_cap else
                           "w, m and v pinned, twice at the step's peak")),
           "use_pallas": cfg.use_pallas,
           "positions": S + (cfg.n_patches if cfg.is_vlm else 0),
           "frames": cfg.n_frames if audio else None,
           "d_model": cfg.d_model, "batch": B, "seq": S,
           "microbatches": UB, "knobs": knobs, "init_s": init_s,
           "eps_pinned_bytes": 3 * sum(
               r * g.n_layers for r, g in zip(rows, eng.model.groups)),
           "steps": steps,
           "steady_s_per_step": steady,
           "relay_in_bytes_per_step": fetched / STEPS,
           "relay_out_bytes_per_step": written / STEPS,
           "relay_in_GBps": fetched / STEPS / steady / 1e9,
           "relay_out_GBps": written / STEPS / steady / 1e9,
           "peak_allocated_bytes": peak,
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "launches_per_step": {n: v / STEPS for n, v in launches.items()}}
    assert all(np.isfinite(s["loss"]) for s in steps), steps
    del eng, state, metrics
    free_host(torch)

    # Engine.grads in f32 at depth 2: l2l-p (the train knobs) against the
    # baseline engine, parameters at fan-in scales
    g2 = _depths(cfg, 2).replace(dtype="float32")
    gen = torch.Generator(dev).manual_seed(1)
    params = fan_in_params(LayeredModel(g2).param_specs(),
                           lambda shape: torch.randn(shape, generator=gen,
                                                     device=dev))
    lb, gb = engines.create("baseline", g2, ExecutionConfig(
        n_microbatches=UB)).grads(params, batch)
    ll, gl = engines.create("l2l-p", g2, ExecutionConfig(
        n_microbatches=UB, **knobs)).grads(params, batch)
    torch.cuda.synchronize()
    lb_ = tree_leaves(gb)
    la = [a.to(b.device) for a, b in zip(tree_leaves(gl), lb_)]
    max_abs = max(float((a - b).abs().max()) for a, b in zip(la, lb_))
    rel_max = max_abs / max(float(b.abs().max()) for b in lb_)
    out["grads_check"] = {
        "dtype": "float32", "depth": 2,
        "params": "fan-in scales (fan_in_params)",
        "loss_l2l_p": float(ll), "loss_baseline": float(lb),
        "max_abs": max_abs, "rel_max": rel_max, "bound_rel_max": 1e-5,
        "bitwise": all(torch.equal(a, b) for a, b in zip(la, lb_))}
    assert rel_max <= 1e-5 and \
        abs(float(ll) - float(lb)) <= 1e-5 * abs(float(lb)), \
        out["grads_check"]
    del gb, gl, la, lb_

    # the relay knobs at depth 3 (G = 2 does not divide it), bf16 compute:
    # every point's grads equal the plain schedule's bit for bit
    g3 = _depths(cfg, 3)
    p3 = fan_in_params(LayeredModel(g3).param_specs(),
                       lambda shape: torch.randn(shape, generator=gen,
                                                 device=dev))
    b3 = {k: v[:4] for k, v in batch.items()}
    want = engines.create("l2l-p", g3, ExecutionConfig(
        n_microbatches=UB)).grads(p3, b3)
    grid = [dict(weight_stream=True, pack_params=pk, prefetch_depth=k,
                 layers_per_relay=gr, transport="pallas")
            for pk, k, gr in ((False, 0, 1), (True, 1, 2), (False, 1, 3),
                              (True, 2, 1))]
    if cfg.is_vlm or audio:
        # the constant-memory stash: K = 2 does not divide the depth
        grid.append(dict(weight_stream=True, pack_params=True,
                         prefetch_depth=1, transport="pallas",
                         offload_stash=True, stash_every=2))
    for kw in grid:
        got = engines.create("l2l-p", g3, ExecutionConfig(
            n_microbatches=UB, **kw)).grads(p3, b3)
        torch.cuda.synchronize()
        assert float(got[0]) == float(want[0]) and all(
            torch.equal(a.to(b.device), b) for a, b in
            zip(tree_leaves(got[1]), tree_leaves(want[1]))), kw
    out["knob_grid"] = {"depth": 3, "batch": [4, S], "points": grid,
                        "bitwise": True}
    del params, p3, want, got
    free_host(torch)

    # one l2l-p step at depth 2, twice from the same state: bitwise
    e2 = engines.create("l2l-p", _depths(cfg, 2), ExecutionConfig(
        n_microbatches=UB, **knobs), optimizer=opt)
    s0 = e2.init(torch.Generator(dev).manual_seed(2))
    a, ma = e2.train_step(s0, batch)
    b, mb = e2.train_step(s0, batch)
    torch.cuda.synchronize()
    ta = tree_leaves((a.params, a.opt_state))
    tb = tree_leaves((b.params, b.opt_state))
    out["repeat_check"] = {
        "depth": 2, "losses": [float(ma["loss"]), float(mb["loss"])],
        "tensors": len(ta),
        "bitwise": float(ma["loss"]) == float(mb["loss"]) and all(
            torch.equal(x, y) for x, y in zip(ta, tb))}
    emit(out)
    assert out["repeat_check"]["bitwise"], out["repeat_check"]
    del e2, s0, a, b, ta, tb
    free_host(torch)
    return out, launches, routes


def f32_attention_rows(torch, F, dev, g, fa):
    """The f32 routes of K2, K3a and K3b (the CUDA-core kernels,
    ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``, which
    the f32 gradient checks run) at bert-large's training microbatch (8,
    512, 16, 64), causal, against their plain versions, graph-timed, with
    SDPA in f32 beside them (TF32 is off: an f32 product); the bound is
    the operations over the card's f32 rate outside the tensor cores."""
    B, S, H, D = 8, 512, 16, 64
    pairs = B * H * S * (S + 1) // 2
    q, k, v, do = (torch.randn(B, H, S, D, generator=g, device=dev)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd_bhsd(q, k, v, causal=True)
    po, plse = fa.flash_attention_fwd_bhsd_plain(q, k, v, causal=True)
    delta = (do * o).sum(-1).contiguous()
    plain = fa.flash_attention_bwd_bhsd_plain(q, k, v, o, lse, do,
                                              causal=True)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                        causal=True)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    lib_o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    torch.cuda.synchronize()
    top = max(float(y.abs().max()) for y in plain)
    errs = {"fwd": float((o - po).abs().max()),
            "dq": float((dq - plain[0]).abs().max()),
            "dkv": max(float((dk - plain[1]).abs().max()),
                       float((dv - plain[2]).abs().max()))}
    assert errs["fwd"] <= 1e-4 and errs["dq"] <= 1e-5 * top and \
        errs["dkv"] <= 1e-5 * top, (errs, top)
    lib_fwd = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 10)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lib_o, (qs, ks, vs), do, retain_graph=True), 5)
    plain_bwd = time_ms(torch, lambda: fa.flash_attention_bwd_bhsd_plain(
        q, k, v, o, lse, do, causal=True), 3)
    in_bytes = 4 * (q.numel() * 3 + lse.numel())
    rows = []
    for name, ops, err, nbytes, ms, plain_ms, lib_ms, line, src in (
            ("flash_attention_fwd", 4 * D * pairs, errs["fwd"],
             in_bytes + 4 * q.numel(),
             graph_ms(torch, lambda: fa.flash_attention_fwd_bhsd(
                 q, k, v, causal=True), 10),
             time_ms(torch, lambda: fa.flash_attention_fwd_bhsd_plain(
                 q, k, v, causal=True), 3), lib_fwd, 46,
             "flash_attention.cu"),
            ("flash_attention_bwd_dq", 6 * D * pairs, errs["dq"],
             in_bytes + 4 * (2 * q.numel() + lse.numel()),
             graph_ms(torch, lambda: fa.flash_attention_bwd_dq(
                 q, k, v, do, lse, delta, causal=True), 10),
             plain_bwd, lib_bwd, 145, "flash_attention_bwd.cu"),
            ("flash_attention_bwd_dkv", 8 * D * pairs, errs["dkv"],
             in_bytes + 4 * (3 * q.numel() + lse.numel()),
             graph_ms(torch, lambda: fa.flash_attention_bwd_dkv(
                 q, k, v, do, lse, delta, causal=True), 10),
             plain_bwd, lib_bwd, 174, "flash_attention_bwd.cu")):
        rows.append({
            "name": name, "route": "cuda", "kernel_route": "cuda_core",
            "cell": "f32 (the gradient checks)",
            "source": "src/repro_torch/kernels/csrc/" + src,
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "shape": [B, S, H, D], "layout": "BHSD", "dtype": "float32",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "library_covers": ("SDPA f32 forward" if line == 46 else
                               "SDPA f32 backward (dq, dk and dv), eager"),
            "timing": "ms, and SDPA's forward: a CUDA graph of the calls; "
                      "SDPA's backward and plain_ms: back-to-back eager "
                      "calls",
            "bound_ms": max(ops / H100_F32_OPS, nbytes / H100_HBM_BPS) * 1e3,
            "bound_by": ("operations" if ops / H100_F32_OPS
                         > nbytes / H100_HBM_BPS else "bytes")})
    return rows


def fs_type(path) -> tuple:
    """(mount point, filesystem type) of the mount that holds ``path``,
    from /proc/mounts."""
    real = os.path.realpath(path)
    best = ("", "unknown")
    with open("/proc/mounts") as f:
        for ln in f:
            _, mnt, typ = ln.split()[:3]
            inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) > len(best[0]):
                best = (mnt, typ)
    return best


TIER_DIR = ROOT / "build" / "chip_smoke_tier"
TIER_HOT = 12          # of internvl2's 24 layers kept on the host (serve)
# tier-train: 8 of bert-large's 24 layers, 4 of them kept on the host
TIER_TRAIN_DEPTH, TIER_TRAIN_HOT = 8, 4


def tier_phase(torch, np, engines, ExecutionConfig, bert, knobs, exec_cfg,
               get_config, LayeredModel, tree_leaves, is_spec, SyntheticLM,
               DataConfig, adam, make_schedule, sample_batch, counters, dev):
    """The disk tier (``tiers=3``) on the card.  train: bert-large at full
    width and ``TIER_TRAIN_DEPTH`` (8) of its 24 layers under l2l-p with
    the train phase's knobs, B=32 x 512, UB=4, 2 steps, with
    ``host_budget_bytes`` keeping 4 of the 8 layers' weights and Adam
    slots on the host and the other 4 in segment files
    under build/, every counter set to 0 just before the tier engine's
    init and read after its last step; its state after the 2 steps against
    a two-tier run's from the same init, bit for bit (the two-tier run
    first, not counted), and the host bytes each run holds after its
    steps (the process's resident set, pinned memory included, with
    PyTorch's caches emptied, over its value before the engine): the
    tier's below the two-tier run's by at least half the demoted bytes.
    serve: internvl2-1b at full width and depth with
    the serve phase's settings and 12 of its 24 layers demoted, read back
    once: Engine.prefill at 4 x (128 + 256) and decode_init on 4 prompts
    of 16 tokens with 4 greedy steps, against the same calls of a two-tier
    engine, bit for bit (counted: the tier engine's calls).  Prints step
    seconds beside the two-tier steps, the tier's stage-in and stage-out
    seconds, its disk read and write GB/s, the seconds spent pinning, and
    the filesystem the tier directory is on.
    -> ({"tier-train": line, "tier-serve": line}, launches, routes)."""
    import dataclasses
    import shutil
    from repro_torch.core import tierstore
    from repro_torch.kernels import host_alloc
    B, S, UB, STEPS = 32, 512, 4, 2
    cfg = bert.replace(use_pallas=True, n_layers=TIER_TRAIN_DEPTH)
    opt = adam(schedule=make_schedule(1e-4, warmup=10))
    (row,) = group_rows(LayeredModel, tree_leaves, is_spec, cfg)
    per_layer = 3 * row                     # weights, Adam m and v
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                   seed=0)).batch(0).items()}
    shutil.rmtree(TIER_DIR, ignore_errors=True)
    TIER_DIR.mkdir(parents=True)
    mount, fstype = fs_type(TIER_DIR)

    def make(tiers, sub):
        return engines.create("l2l-p", cfg, ExecutionConfig(
            n_microbatches=UB, tiers=tiers,
            host_budget_bytes=TIER_TRAIN_HOT * per_layer,
            tier_dir=str(TIER_DIR / sub), **knobs), optimizer=opt)

    def steps(eng, state):
        out = []
        for _ in range(STEPS):
            m0 = dict(eng.tier.metrics) if eng.tier else {}
            t0 = time.perf_counter()
            state, m = eng.train_step(state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            rec = {"s": time.perf_counter() - t0, "loss": loss}
            if eng.tier:
                rec.update({k: v - m0[k] for k, v in eng.tier.metrics.items()
                            if k.endswith("_s") or k.endswith("bytes")})
            out.append(rec)
        return state, out

    def resident():
        # what the process holds, PyTorch's device and pinned caches
        # emptied (the blocks a step freed are not the state's)
        free_host(torch)
        time.sleep(1.0)
        return rss_bytes()

    base2 = resident()
    e2 = make(2, "two")
    s2, two = steps(e2, e2.init(torch.Generator(dev).manual_seed(0)))
    held2 = resident() - base2
    reset_counts(counters.values())
    base3 = resident()
    e3 = make(3, "train")
    t0 = time.perf_counter()
    s3 = e3.init(torch.Generator(dev).manual_seed(0))
    init_s = time.perf_counter() - t0
    adopt = dict(e3.tier.metrics)
    s3, three = steps(e3, s3)
    launches = {"tier-train": {n: c.launches for n, c in counters.items()}}
    routes = {"tier-train": route_counts(counters)}
    owned = host_alloc.live()["bytes"]
    held3 = resident() - base3
    demoted_bytes = (cfg.n_layers - TIER_TRAIN_HOT) * per_layer
    m = e3.tier.metrics
    demoted = [tierstore.is_demoted(g) for g in
               s3.params["groups"] + s3.opt_state["groups"]]
    full = e3.tier.stage_in(s3)
    torch.cuda.synchronize()
    a, b = tree_leaves((full.params, full.opt_state)), \
        tree_leaves((s2.params, s2.opt_state))
    bitwise = len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(a, b)) and [r["loss"] for r in two] == \
        [r["loss"] for r in three]
    est = e3.memory_estimate(batch=B, seq=S)
    train = {
        "phase": "tier-train", "arch": cfg.name, "depth": cfg.n_layers,
        "batch": B, "seq": S, "microbatches": UB, "knobs": knobs,
        "host_budget_bytes": TIER_TRAIN_HOT * per_layer,
        "layer_state_bytes": per_layer,
        "tier_dir": str(TIER_DIR), "tier_mount": mount, "tier_fs": fstype,
        "tier_fs_note": ("tmpfs: the segment files are in RAM, not on a "
                         "disk" if fstype == "tmpfs" else ""),
        "init_s": init_s, "adopt_write_bytes": adopt["write_bytes"],
        "steps_two_tiers": two, "steps": three,
        "steady_s_two_tiers": float(np.mean([r["s"] for r in two[1:]])),
        "steady_s": float(np.mean([r["s"] for r in three[1:]])),
        "tier_metrics": m,
        "read_GBps": m["read_bytes"] / max(m["load_s"], 1e-9) / 1e9,
        "write_GBps": (m["write_bytes"] - adopt["write_bytes"])
        / max(m["stage_out_s"] - adopt["stage_out_s"], 1e-9) / 1e9,
        "memory_model_demoted_layers": est.demoted_layers,
        "all_groups_demoted_between_steps": all(demoted),
        "host_bytes_after_steps": {
            "tiers_2": held2, "tiers_3": held3,
            "demoted_bytes": demoted_bytes,
            "tiers_3_owned_pinned_bytes": owned,
            "measure": "VmRSS (pinned memory included) after the last "
                       "step, PyTorch's caches emptied, less VmRSS before "
                       "the engine"},
        "bitwise_two_tiers": bitwise, "launches": launches["tier-train"]}
    emit(train)
    assert bitwise, "tiers=3 state differs from tiers=2"
    assert m["demoted_layers"] == cfg.n_layers - TIER_TRAIN_HOT, m
    assert est.demoted_layers == m["demoted_layers"], est.demoted_layers
    assert m["async_stage_hits"] > 0 and m["async_stage_misses"] == 0, m
    assert all(demoted) and m["quarantined"] == 0 and m["retries"] == 0, m
    # the tier's point: the demoted rows are not held between calls
    assert held3 <= held2 - demoted_bytes // 2, train["host_bytes_after_steps"]
    del e2, s2, e3, s3, full, a, b
    free_host(torch)

    # serving through the tier: internvl2-1b, 12 of 24 layers demoted
    vcfg = get_config(VLM_ARCH, "full").replace(use_pallas=True)
    (vrow,) = group_rows(LayeredModel, tree_leaves, is_spec, vcfg)
    gen = torch.Generator(dev).manual_seed(1)
    P, GEN = 16, 4
    prompt = torch.randint(0, vcfg.vocab_size, (4, P), device=dev,
                           generator=gen)
    batch = {"tokens": torch.randint(0, vcfg.vocab_size, (4, VLM_PROMPT),
                                     device=dev, generator=gen),
             "patches": torch.randn(4, vcfg.n_patches, vcfg.vit_dim,
                                    device=dev, generator=gen)}

    def serve(eng):
        state = eng.init(torch.Generator(dev).manual_seed(0))
        t0 = time.perf_counter()
        pl = eng.prefill(state, batch)
        torch.cuda.synchronize()
        t_pf = time.perf_counter() - t0
        caches, last = eng.decode_init(state, prompt, P + GEN)
        tok = sample_batch(last)[:, None]
        outs = [pl, last]
        t0 = time.perf_counter()
        for i in range(GEN):
            logits, caches = eng.decode_step(state, caches, tok, P + i)
            tok = sample_batch(logits[:, -1])[:, None]
            outs.append(logits)
        torch.cuda.synchronize()
        return outs, t_pf, time.perf_counter() - t0

    v2 = engines.create("l2l", vcfg, exec_cfg)
    want, pf2, dec2 = serve(v2)
    del v2
    free_host(torch)
    reset_counts(counters.values())
    v3 = engines.create("l2l", vcfg, dataclasses.replace(
        exec_cfg, tiers=3, host_budget_bytes=TIER_HOT * 3 * vrow,
        tier_dir=str(TIER_DIR / "serve")))
    got, pf3, dec3 = serve(v3)
    launches["tier-serve"] = {n: c.launches for n, c in counters.items()}
    routes["tier-serve"] = route_counts(counters)
    vm = v3.tier.metrics
    serve_line = {
        "phase": "tier-serve", "arch": vcfg.name, "depth": vcfg.n_layers,
        "host_budget_bytes": TIER_HOT * 3 * vrow, "tier_metrics": vm,
        "prefill_4x384_s": {"tiers_3": pf3, "tiers_2": pf2},
        "decode_4_steps_s": {"tiers_3": dec3, "tiers_2": dec2},
        "bitwise_two_tiers": all(torch.equal(x, y)
                                 for x, y in zip(got, want)),
        "launches": launches["tier-serve"]}
    emit(serve_line)
    assert serve_line["bitwise_two_tiers"], "tiers=3 serving differs"
    assert vm["demoted_layers"] == vcfg.n_layers - TIER_HOT, vm
    del v3, got, want
    shutil.rmtree(TIER_DIR, ignore_errors=True)
    free_host(torch)
    return {"tier-train": train, "tier-serve": serve_line}, launches, routes


GROK_ARCH = "grok-1-314b"
# one layer: the script's time limit (a second 19.7 GB layer costs ~15 s
# of drawing, pinning and fetching); the host could pin 2
GROK_DEPTH_CAP = 1
# the phase runs last and holds nothing on the host beside its EPS and
# the process: with 24 GiB, 93.5 GB of MemAvailable on an H100 host left
# depth 1
GROK_RESERVE = 16 * 2 ** 30


def grok_phase(torch, np, engines, exec_cfg, get_config, LayeredModel,
               tree_leaves, is_spec, rc, ref, sample_batch, counters, dev):
    """grok-1-314b at full width (d 6144, 48 heads over 8, 8 experts top
    2 of d_ff 32768, vocab 131072, logits soft-capped at 30), f32 masters,
    served with the serve phase's settings at the depth the host can pin
    (at most ``GROK_DEPTH_CAP``; a layer is a 19.7 GB f32 row, pinned as
    a power of two),
    drawn layer by layer on the card.  Every counter set to 0 just before
    and read just after: decode_init on 4 prompts of 4 tokens, 2 greedy
    steps, Engine.prefill at 4 x 16 and 2 x 2048.  Checks: finite logits
    within the cap, the router's 2 of 8 distinct experts for every token.
    Not counted: one K4 fetch of a whole 19.7 GB row against ``copy_``, in
    turns, and against the plain version bit for bit; in f32 at fan-in
    scales (``fan_in_params``, one layer drawn on the card and relayed
    from there), the prefill's last-position logits against decode_init's
    on the 4 prompts within the dense phases' 1e-4 relative L2.
    -> (line, launches, routes)."""
    import dataclasses
    from repro_torch.models import moe
    from repro_torch.testing import fan_in_params
    # 2 greedy steps: each is a fetch of the rows, ~2.2 s on a ~27 GB/s
    # host
    B, P, GEN = 4, 4, 2
    full = get_config(GROK_ARCH, "full")
    (row,) = group_rows(LayeredModel, tree_leaves, is_spec, full)
    avail = mem_available()
    one = 2 ** math.ceil(math.log2(row))
    emit({"phase": "serve-grok-host", "mem_available_bytes": avail,
          "layer_row_bytes": row, "pinned_block_one_layer": one})
    assert one <= avail, f"cannot pin one grok-1 layer: MemAvailable {avail}"
    depth = min(GROK_DEPTH_CAP, host_depth(row, full.n_layers,
                                           reserve=GROK_RESERVE))
    cfg = full.replace(n_layers=depth, use_pallas=True)
    eng = engines.create("l2l", cfg, exec_cfg)
    t0 = time.perf_counter()
    params = eng.init_params(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eps = params["groups"][0].segs["float32"]
    assert eps.is_pinned() and eps.shape == (depth, row // 4)

    # K4 on one whole row, before the relay's ring takes its slots
    slot = torch.empty((1, row // 4), dtype=torch.float32, device=dev)
    rc.copy_rows(eps, 0, size=1, out=slot)
    plain = ref.ref_copy_rows(eps, 0, 1, device=dev)
    torch.cuda.synchronize()
    exact = bool(torch.equal(slot, plain))
    del plain
    runs = {"k4": [], "copy_": []}
    for name in ("k4", "copy_", "copy_", "k4"):
        fn = ((lambda: rc.copy_rows(eps, 0, size=1, out=slot))
              if name == "k4" else
              (lambda: slot.copy_(eps[0:1], non_blocking=True)))
        runs[name].append(time_ms(torch, fn, 1, warmup=0))
    t0 = time.perf_counter()
    ref.ref_copy_rows(eps, 0, 1, device=dev)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    del slot
    torch.cuda.empty_cache()
    k4_ms, copy_ms = (sum(runs[n]) / 2 for n in ("k4", "copy_"))
    k4 = {"name": "relay_copy", "route": "cuda",
          "kernel_route": rc.FETCH_ROUTE, "cell": "grok-1 layer row",
          "source": "src/repro_torch/kernels/csrc/relay_copy.cu",
          "replaces": "src/repro/kernels/relay_copy.py:58",
          "shape": [1, row // 4], "dtype": "float32", "bitwise": exact,
          "max_abs_err": 0.0 if exact else None,
          "ms": k4_ms, "library_ms": copy_ms, "plain_ms": plain_ms,
          "runs_ms": runs,
          "timing": "one call each, K4, copy_, copy_, K4; plain_ms: one "
                    "call by the host clock",
          "bound_ms": row / PCIE5_X16_BPS * 1e3, "bound_by": "bytes",
          "achieved_GBps": row / k4_ms / 1e6,
          "library_GBps": row / copy_ms / 1e6}
    assert exact, "K4 is not bit-exact on a 19.7 GB row"

    # the router: every token's 2 of 8 experts, distinct
    picks = []
    route = moe._route

    def watched(w, xf, cfg_, *args):
        top_w, top_i, aux = route(w, xf, cfg_, *args)
        picks.append((top_i.shape[1], int(top_i.min()), int(top_i.max()),
                      bool((top_i[:, 0] != top_i[:, 1]).all())))
        return top_w, top_i, aux

    gen = torch.Generator(dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                           generator=gen)
    long = torch.randint(0, cfg.vocab_size, (2, 2048), device=dev,
                         generator=gen)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    moe._route = watched
    try:
        t0 = time.perf_counter()
        caches, last = eng.decode_init(params, prompt, P + GEN)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        tok = sample_batch(last)[:, None]
        toks, caps = [tok], [float(last.float().abs().max())]
        f0, b0 = counters["relay_copy"].launches, \
            counters["relay_copy"].bytes
        t0 = time.perf_counter()
        for i in range(GEN):
            logits, caches = eng.decode_step(params, caches, tok, P + i)
            assert bool(torch.isfinite(logits).all()), "non-finite logits"
            caps.append(float(logits.float().abs().max()))
            tok = sample_batch(logits[:, -1])[:, None]
            toks.append(tok)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        fetches = (counters["relay_copy"].launches - f0) / GEN
        step_bytes = (counters["relay_copy"].bytes - b0) / GEN
        decode_peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        pl = eng.prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        t_pf = time.perf_counter() - t0
        t0 = time.perf_counter()
        pl2 = eng.prefill(params, {"tokens": long})
        torch.cuda.synchronize()
        t_pf2 = time.perf_counter() - t0
    finally:
        moe._route = route
    launches = {n: c.launches for n, c in counters.items()}
    routes = route_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    caps += [float(pl.float().abs().max()), float(pl2.float().abs().max())]
    toks = torch.cat(toks, dim=1)
    # not counted: prefill against decode_init in f32 at fan-in scales
    # (the reference's init, std 1/sqrt(depth) on every stacked matrix,
    # amplifies f32 rounding at these widths), one layer drawn on the
    # card and relayed from there through one slot
    del caches, eng, params, eps
    free_host(torch)
    f32 = cfg.replace(dtype="float32", n_layers=1)
    gen = torch.Generator(dev).manual_seed(4)
    fan = fan_in_params(LayeredModel(f32).param_specs(),
                        lambda shape: torch.randn(shape, generator=gen,
                                                  device=dev))
    e32 = engines.create("l2l", f32, dataclasses.replace(
        exec_cfg, weight_stream=False, pack_params=False, prefetch_depth=0))
    _, r32 = e32.decode_init(fan, prompt, P)
    g32 = e32.prefill(fan, {"tokens": prompt})
    gap32 = float((g32 - r32).norm() / r32.norm())
    del e32, fan, r32, g32
    line = {
        "phase": "serve-grok", "arch": full.name, "depth": depth,
        "full_depth": full.n_layers, "mem_available_bytes": avail,
        "reserve_bytes": GROK_RESERVE,
        "reduced": f"depth {full.n_layers} -> {depth}: chip_smoke.py's "
                   f"time limit (at most {GROK_DEPTH_CAP}) and host memory "
                   f"for the pinned EPS (a {row} B row pins "
                   f"{2 ** math.ceil(math.log2(depth * row))} B)",
        "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
        "experts": [cfg.n_experts, cfg.experts_per_token],
        "d_ff_expert": cfg.d_ff_expert, "vocab": cfg.vocab_size,
        "logit_soft_cap": cfg.logit_soft_cap, "layer_row_bytes": row,
        "init_s": init_s, "batch": B, "prompt": P, "steps": GEN,
        "tokens": toks.tolist(), "decode_init_s": t_init, "decode_s": t_dec,
        "tok_per_s": B * GEN / t_dec, "s_per_step": t_dec / GEN,
        "relay_fetches_per_step": fetches,
        "relay_bytes_per_step": step_bytes,
        "relay_GBps": GEN * step_bytes / t_dec / 1e9,
        "decode_peak_allocated_bytes": decode_peak,
        "peak_allocated_bytes": peak,
        "prefill_16_s": t_pf, "prefill_2048_s": t_pf2,
        "prefill_tok_per_s_2048": 2 * 2048 / t_pf2,
        "max_abs_logit": max(caps),
        "rel_l2_prefill_vs_decode_init": {"f32_fan_in_depth1": gap32},
        "router_calls": len(picks),
        "router_picks": sorted(set(picks)), "k4_row": k4,
        "launches": launches}
    emit(line)
    assert toks.shape == (B, GEN + 1) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all())
    assert bool(torch.isfinite(pl).all()) and bool(torch.isfinite(pl2).all())
    assert max(caps) <= cfg.logit_soft_cap, caps
    # f32 at fan-in scales: the dense phases' 1e-4
    assert gap32 <= 1e-4, gap32
    assert picks and all(p[0] == 2 and p[1] >= 0 and p[2] < cfg.n_experts
                         and p[3] for p in picks), sorted(set(picks))
    # one fetch a layer and the prefetch ring's clamped re-fetch
    assert fetches == depth + 1, fetches
    del pl, pl2, last, logits
    free_host(torch)
    return line, launches, routes


DP_DIR = ROOT / "build" / "chip_smoke_dp"
# 3 of bert-large's 24 layers (the chip time of the mesh's phases)
DP_DEPTH = 3
# the train CLI's arguments of both train-dp runs: the train phase's
# model, batch and knobs (l2l-p; Adam, its schedule and the per-layer
# clip are the CLI's)
DP_ARGV = ["--arch", "bert-large", "--variant", "full", "--engine", "l2l-p",
           "--n-layers", str(DP_DEPTH),
           "--steps", "3", "--batch", "32", "--seq", "512", "--ub", "4",
           "--weight-stream", "--pack", "--prefetch", "1",
           "--transport", "pallas", "--offload-stash", "--use-pallas",
           "--log-every", "1", "--seed", "0"]
# the f32 check: depth 2, B=8, UB=2, one step from one draw of fan-in
# parameters (``tp_rank_dp_f32``)
DP_F32 = ["--n-layers", "2", "--dtype", "float32", "--batch", "8",
          "--ub", "2", "--steps", "1"]
DP_RANKS = 2
# bounds of the f32 check against one process on the whole batch (the
# ranks' microbatches hold other rows: sums in other orders)
DP_LOSS_REL = 1e-5
DP_UPDATE_REL = 1e-3


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun(tail, ranks=None):
    """Start ``python -m torch.distributed.run`` on ``ranks`` gloo ranks on
    this card -> (process, start time): of ``tail``, a script and its
    arguments, or by default of the train CLI with the arguments ``tail``
    on ``DP_RANKS`` data ranks.  Its output goes to a pipe that
    ``torchrun_line`` reads."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "4"}
    if ranks is None:
        ranks = DP_RANKS
        tail = ["-m", "repro_torch.launch.train", *tail,
                "--mesh", f"data={DP_RANKS}", "--dist-backend", "gloo"]
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", str(ranks), "--master-addr", "127.0.0.1",
           "--master-port", str(free_port()), *tail]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=str(ROOT)), time.perf_counter()


def torchrun_line(started, log, timeout):
    """Wait for a ``torchrun`` -> (rank 0's JSON line, seconds); the whole
    output goes to chiprun_out/<log>.  A run past ``timeout`` is killed."""
    proc, t0 = started
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    seconds = time.perf_counter() - t0
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / log).write_text(out)
    assert proc.returncode == 0, \
        f"torchrun exited {proc.returncode}:\n{out[-5000:]}"
    line = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])
    return line, seconds


def train_dp_phase(torch, np, engines, counters, dev):
    """Data-parallel l2l-p on the data axes (``--mesh data=N``), two parts.

    (a) In process: NCCL over a world of one (a FileStore under build/),
    a (data=1, model=1) mesh; bert-large at full width and ``DP_DEPTH``
    (3) of its 24 layers through the train CLI's configuration
    (``DP_ARGV``): 3 steps on the mesh, the counters set to 0 just before
    and read just after, beside 3 meshless steps from the same state:
    losses, weights and Adam slots bit for bit (checksums); 6 layer rows
    + the static tree + 2 scalars reduced a step; the step times side by
    side.
    (b) Two gloo ranks on this card through the train CLI under
    ``torch.distributed.run`` (each rank its own pinned EPS): the bf16
    main path, its ranks' final checksums equal, its losses beside (a)'s
    meshless ones.  Its f32 check runs in the tp phase's world
    (``tp_rank_dp_f32``: one process start-up less)."""
    import shutil
    import torch.distributed as dist
    from repro_torch.distributed.data_parallel import tree_checksum
    from repro_torch.launch import train as cli
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import is_spec
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    out = {"phase": "train-dp", "ranks_b": DP_RANKS}

    def run(eng, state, args, cfg, steps):
        data = cli.make_data(args, cfg)
        losses, times = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            state, m = eng.train_step(state, cli.batch_at(args, cfg, data, i))
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return state, losses, times, m

    def sums(state):
        torch.cuda.synchronize()
        return [tree_checksum(state.params), tree_checksum(state.opt_state)]

    # ------------------------------------------------------------ (a)
    t_a = time.perf_counter()
    ap, args = cli.parse_args(DP_ARGV)
    name, cfg, opt, exec_cfg = cli.setup(ap, args)
    torch.cuda.set_device(0)
    store = dist.FileStore(str(DP_DIR / "pg_store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = make_mesh({"data": 1, "model": 1}, "cuda")
        plain = engines.create(name, cfg, exec_cfg, optimizer=opt)
        meshed = engines.create(name, cfg, exec_cfg, optimizer=opt,
                                mesh=mesh)
        st0 = plain.init(torch.Generator(dev).manual_seed(args.seed))
        meshed.check_replicas(st0)
        ref_state, ref_losses, ref_times, _ = run(plain, st0, args, cfg, 3)
        want = sums(ref_state)
        del ref_state
        reset_counts(counters.values())
        got_state, losses, times, m = run(meshed, st0, args, cfg, 3)
        launches = {n: c.launches for n, c in counters.items()}
        routes = route_counts(counters)
        stats = meshed.dp.stats()
        got = sums(got_state)
        del got_state, st0, plain, meshed
    finally:
        dist.destroy_process_group()
    free_host(torch)
    n_red = cfg.n_layers + 1 + 2
    out["a"] = {
        "backend": "nccl", "world": 1, "arch": cfg.name,
        "depth": cfg.n_layers, "batch": args.batch, "seq": args.seq,
        "microbatches": args.ub, "losses": losses,
        "meshless_losses": ref_losses, "step_s": times,
        "meshless_step_s": ref_times, "checksums": got,
        "meshless_checksums": want,
        "all_reduces_per_step": m["all_reduces"],
        "all_reduce_GB_per_step": m["all_reduce_bytes"] / 1e9,
        "all_reduce_ms_last_step": stats["all_reduce_ms"],
        "seconds": time.perf_counter() - t_a}
    emit({"phase": "train-dp-a", **out["a"]})
    assert losses == ref_losses and got == want, out["a"]
    assert m["all_reduces"] == n_red, (m["all_reduces"], n_red)

    # ------------------------------------------------------- (b) bf16
    line, secs = torchrun_line(torchrun(DP_ARGV), "train_dp_bf16.log", 600)
    rel = [abs(a - b) / abs(b) for a, b in zip(line["losses"], ref_losses)]
    out["b_bf16"] = {
        "world": line["world"], "backend": line["backend"],
        "losses": line["losses"], "one_process_losses": ref_losses,
        "loss_rel_to_one_process": rel, "step_s": line["step_s"],
        "rank_checksums": line["rank_checksums"],
        "one_process_checksums": want,
        "all_reduces_per_step": line["all_reduces_per_step"],
        "all_reduce_GB_per_step": line["all_reduce_bytes_per_step"] / 1e9,
        "all_reduce_ms": line["all_reduce_ms"], "seconds": secs}
    emit({"phase": "train-dp-b-bf16", **out["b_bf16"]})
    sums_b = line["rank_checksums"]
    assert line["world"] == DP_RANKS and len(sums_b) == DP_RANKS and \
        all(s == sums_b[0] for s in sums_b), sums_b
    assert line["all_reduces_per_step"] == n_red
    assert all(np.isfinite(line["losses"])), line["losses"]

    shutil.rmtree(DP_DIR, ignore_errors=True)
    free_host(torch)
    return out, launches, routes


TP_RANKS = 2
# train-tp: bert-large at full width (16 heads, d_ff 4096, vocab 30522:
# 8 heads, 2048 columns and 15261 rows a rank), depth 2, the train
# phase's batch, l2l-p unpacked (the sharded relay) through the train
# CLI's configuration
TP_ARGV = ["--arch", "bert-large", "--variant", "full", "--engine", "l2l-p",
           "--n-layers", "2", "--steps", "3", "--batch", "32", "--seq", "512",
           "--ub", "4", "--weight-stream", "--prefetch", "1",
           "--transport", "pallas", "--offload-stash", "--use-pallas",
           "--log-every", "1", "--seed", "0", "--mesh", f"model={TP_RANKS}"]
# its f32 check, train-dp's
TP_F32 = DP_F32
# the bf16 losses against one process at the same depth and batch
TP_LOSS_REL_BF16 = 1e-3
# serve-tp: granite-3-8b at full width (32 heads over 8 kv: 16 over 4 a
# rank; d_ff 12800: 6400; vocab 49155 does not split: whole on both),
# depth 2 (the chip time of the MoE paths beside it), weight_stream
# unpacked
TP_SERVE_DEPTH = 2
TP_SERVE = dict(batch=4, prompt=16, gen=4)
# the serve phase's bound of prefill against decode_init in bf16 (granite
# at the reference's init: one process at depth 4 stands 0.062 apart)
TP_SERVE_BF16 = 0.35
TP_SERVE_F32 = 1e-4
TP_K3_CELL = "bert-large train microbatch per model rank"
TP_VLM_K3_CELL = "internvl2 train microbatch per model rank"
# the MoE family on the mesh (one torch.distributed.run with train-tp and
# serve-tp): deepseek-v2-lite at full width (8 of 16 heads, 32 of 64
# experts and the router's matching columns, 1408 of the shared experts'
# 2816 columns, 5472 of layer 0's 10944, 51200 of 102400 vocabulary rows
# a model rank).  train-moe-tp: the dense layer 0 and one MoE layer, B=8 x
# 512, UB=2, 1 l2l-p step unpacked (the sharded relay) on (data=1,
# model=2); train-moe-dp: the same on (data=2, model=1), packed (K1), 4 of
# the 8 rows a rank (its block of each microbatch); serve-moe-tp: depth 3
# on (data=1, model=2), weight_stream unpacked.  Each against one process
# at the same depth and batch; in f32 at fan-in scales from one draw, the
# ranks on the same relay, one process with its weights on the card
TP_MOE_TRAIN = dict(depth=2, batch=8, seq=512, ub=2, steps=1, f32_steps=1)
TP_MOE_SERVE_DEPTH = 3
TP_MOE_AUX_REL = 1e-5


def tp_layer_bytes(cfg, ranks, LayeredModel, tree_leaves, is_spec,
                   group: int = 0) -> int:
    """One layer's f32 bytes (of layer group ``group``) on a rank of a
    model axis of ``ranks``: its blocks of the split leaves, the other
    leaves whole."""
    from types import SimpleNamespace
    from repro_torch.distributed import sharding as shd
    mesh = SimpleNamespace(shape={"data": 1, "model": ranks})
    rules = shd.make_rules(cfg, mesh)
    return 4 * sum(math.prod(shd.local_shape(
        s.shape, shd.spec_to_pspec(s.axes, rules, s.shape, mesh), mesh))
        for s in tree_leaves(LayeredModel(cfg).groups[group].spec,
                             is_leaf=is_spec))


TP_PATHS = ("train-tp", "serve-tp", "train-moe-tp", "train-moe-dp",
            "serve-moe-tp", "train-hybrid-tp", "serve-ssm-tp",
            "train-vlm-tp", "serve-audio-tp")
# the hybrid and SSM families on the model axis (``tp_rank_recurrent``).
# train-hybrid-tp: hymba-1.5b at full width (its 25 q and 5 kv heads do
# not split over 2 ranks: the attention runs whole on each; 800 of 1600
# mamba channels and 2752 of 5504 MLP columns a rank; the 32001-row
# vocabulary whole), depth 2, B=8 x 512, UB=2, 2 l2l-p steps unpacked (the
# sharded relay) through the train CLI's configuration; its f32 check
# (``TP_F32``) at depth 2 on the same relay
TP_HYBRID_ARGV = ["--arch", "hymba-1.5b", "--variant", "full",
                  "--engine", "l2l-p", "--n-layers", "2", "--steps", "2",
                  "--batch", "8", "--seq", "512", "--ub", "2",
                  "--weight-stream", "--prefetch", "1",
                  "--transport", "pallas", "--offload-stash", "--use-pallas",
                  "--log-every", "1", "--seed", "0",
                  "--mesh", f"model={TP_RANKS}"]
# then hymba's decode in f32 at depth 1 on the same ranks: decode_init on
# TP_SERVE's prompts and 2 greedy steps against one process
TP_HYBRID_DECODE = dict(depth=1, steps=2)
# serve-ssm-tp: rwkv6-1.6b at full width (16 of 32 heads, 1024 of 2048
# channels, 3584 of 7168 ffn columns, 32768 of 65536 vocabulary rows a
# rank), depth 2, weight_stream unpacked, TP_SERVE's prompts and steps;
# then one l2l-p step in f32 at depth 1 on the relay against one process
# (the decay's and ln_scale's gradients cross the ranks)
TP_SSM_SERVE_DEPTH = 2
TP_SSM_TRAIN = dict(depth=1, batch=8, seq=256, ub=2)
# the VLM and audio families on the model axis (``tp_rank_modality``).
# train-vlm-tp: internvl2-1b at full width (7 of 14 q heads over 1 of 2
# kv heads and 2432 of 4864 MLP columns a rank; the 151655-row tied
# vocabulary and the patch projection whole on each), depth 2,
# B=8 x (512 tokens + 256 patches), UB=2, 2 l2l-p steps unpacked (the
# sharded relay) through the train CLI's configuration; its f32 check
# (``TP_F32``) at depth 2 on the same relay
TP_VLM_ARGV = ["--arch", "internvl2-1b", "--variant", "full",
               "--engine", "l2l-p", "--n-layers", "2", "--steps", "2",
               "--batch", "8", "--seq", "512", "--ub", "2",
               "--weight-stream", "--prefetch", "1",
               "--transport", "pallas", "--offload-stash", "--use-pallas",
               "--log-every", "1", "--seed", "0",
               "--mesh", f"model={TP_RANKS}"]
# then its decode in f32 at depth 1 on the same ranks (decode_init on
# ``tp_prompt``'s text prompts, 2 greedy steps, prefill behind the
# patches) against one process
TP_VLM_DECODE = dict(depth=1, steps=2)
# serve-audio-tp: whisper-base at full width and depth (6 + 6 layers; 4
# of 8 heads and kv heads in each attention, 1024 of 2048 MLP columns a
# rank; the 51865-row vocabulary and enc_ln_post whole), weight_stream
# unpacked, TP_SERVE's prompts and steps with 1500 frames; then one l2l-p
# step in f32 at full depth on the relay against one process (the
# memory's cotangent crosses the ranks into the encoder)
TP_AUDIO_TRAIN = dict(batch=8, seq=64, ub=2)


def drawn_state(torch, e, seed: int = 11):
    """A step-0 state of engine ``e`` at fan-in scales, every leaf drawn
    whole on the card from ``seed`` (the same bits on every rank) and kept
    as ``e`` holds it (a model rank's blocks)."""
    from repro_torch.engine.state import TrainState
    from repro_torch.testing import fan_in_params
    g = torch.Generator("cuda").manual_seed(seed)
    p = fan_in_params(e.model.param_specs(), lambda shape: torch.randn(
        shape, generator=g, device="cuda"))
    p = e._place_params(e.tp.shard(p) if e.tp else p)
    return TrainState.from_legacy(p, e._place_opt(e._init_opt_legacy(p), p))


def f32_rel(np, tree_leaves, got, want, p0, skip=()) -> float:
    """The largest relative L2 of a leaf's update, ``got`` against
    ``want`` from ``p0`` (numpy trees), over the leaves whose flat index
    is not in ``skip``."""
    return max(float(np.linalg.norm(a - b) / max(np.linalg.norm(b - c),
                                                  1e-30))
               for i, (a, b, c) in enumerate(zip(tree_leaves(got),
                                                 tree_leaves(want), p0))
               if i not in skip)


def exact_zero_leaves(cfg) -> set:
    """Flat indices (the params' flatten order) of the leaves whose
    gradient is zero in exact arithmetic: whisper's attention k biases
    (no rope: ``bk`` shifts each query's scores by one constant, which
    the softmax drops).  Their computed gradients are rounding noise
    (~1e-10), and Adam's first update of each entry is about the step
    size with the noise's sign, so two correct runs' updates of them
    differ by ~1.4x their norm: an update check holds them apart."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models.common import is_spec
    from repro_torch.models.model import LayeredModel
    if cfg.family != "audio":
        return set()
    it = iter(range(10 ** 6))
    idx = tree_map(lambda _: next(it), LayeredModel(cfg).param_specs(),
                   is_leaf=is_spec)
    return {g[a]["bk"] for g in idx["groups"] for a in ("attn", "xattn")
            if a in g}


def tp_phase(torch, counters):
    """The mesh's model axis: ``TP_RANKS`` gloo ranks on this card, one
    ``torch.distributed.run`` of this script with ``--tp-rank``
    (``tp_rank``): train-tp, then serve-tp, each rank's log under
    chiprun_out/.  -> ({"train-tp": line, "serve-tp": line}, launches,
    routes), the launches summed over the ranks."""
    t0 = time.perf_counter()
    line, secs = torchrun_line(torchrun([str(ROOT / "chip_smoke.py"),
                                         "--tp-rank"], TP_RANKS),
                               "tp_ranks.log", 900)
    ranks = line["tp_ranks"]
    out, launches, routes = {}, {}, {}
    for key in TP_PATHS:
        got = [r[key] for r in ranks]
        launches[key] = {n: sum(g["launches"][n] for g in got)
                         for n in counters}
        routes[key] = {n: {k: sum(g["routes"][n][k] for g in got)
                           for k in got[0]["routes"][n]}
                       for n in got[0]["routes"]}
        out[key] = {"phase": key, "ranks": len(got), **got[0],
                    "launches": launches[key],
                    "rank1": {k: got[1][k] for k in got[1]
                              if k not in ("launches", "routes")}}
        emit(out[key])
    # train-dp's f32 check, made in this world (``tp_rank_dp_f32``)
    out["train-dp-f32"] = {"phase": "train-dp-b-f32",
                           **ranks[0]["train-dp-f32"]}
    emit(out["train-dp-f32"])
    out["torchrun_s"] = secs
    out["seconds"] = time.perf_counter() - t0
    return out, launches, routes


def tp_cli_train(np, torch, mesh, rank, counters, check, key, argv,
                 per_rank):
    """One train path of the tp phase on ``mesh`` through the train CLI's
    configuration ``argv`` (l2l-p unpacked: the sharded relay): the
    rank's weights checked against the slices of the one-process draw
    (checksums), the CLI's steps with every counter set to 0 just before
    and read just after, the ranks' checksums of the leaves no pspec
    splits (and their Adam slots) equal; rank 0 then runs one process
    from the same seed and holds the losses within ``TP_LOSS_REL_BF16``;
    then in f32 (``TP_F32``: depth 2, B=8, UB=2, one step) at fan-in
    scales from one draw, the ranks on the CLI's sharded, weight-streamed
    relay, the gathered state against one process (its weights on the
    card) within ``DP_LOSS_REL`` (losses) and ``DP_UPDATE_REL`` (each
    leaf's update).  ``per_rank(eng, cfg)`` gives the line's per-rank
    widths.  -> the path's line (rank 0's with the comparisons)."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch import engine as engines
    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed.data_parallel import tree_checksum
    from repro_torch.kernels import relay_copy as rc
    from repro_torch.launch import train as cli
    dev = torch.device("cuda")

    def sync_sums(*trees):
        torch.cuda.synchronize()
        return [tree_checksum(t) for t in trees]

    t_phase = time.perf_counter()
    ap, args = cli.parse_args(argv)
    name, cfg, opt, exec_cfg = cli.setup(ap, args)
    assert not exec_cfg.pack_params
    eng = engines.create(name, cfg, exec_cfg, optimizer=opt, mesh=mesh)
    one = engines.create(name, cfg, exec_cfg, optimizer=opt)
    st0 = eng.init(torch.Generator(dev).manual_seed(args.seed))
    whole = one.init(torch.Generator(dev).manual_seed(args.seed))
    slices = sync_sums(st0.params)[0] == sync_sums(
        eng.tp.shard(whole.params))[0]
    data = cli.make_data(args, cfg)
    batches = [eng.local_rows(cli.batch_at(args, cfg, data, i), "train_step")
               for i in range(args.steps)]
    torch.cuda.synchronize()
    st, losses, times, colls = st0, [], [], []
    reset_counts(counters.values())
    fetched, written = rc.copy_rows.bytes, rc.writeback_rows.bytes
    for b in batches:
        t0 = time.perf_counter()
        st, m = eng.train_step(st, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        colls.append(eng.tp.stats())
    launches = {n: c.launches for n, c in counters.items()}
    routes = route_counts(counters)
    k4_gb = {"fetch": (rc.copy_rows.bytes - fetched) / args.steps / 1e9,
             "writeback": (rc.writeback_rows.bytes - written) / args.steps
             / 1e9}
    torch.cuda.synchronize()
    whole_sums = eng.tp.gather_checksums(
        eng.tp.whole_leaves(st.params), eng.tp.whole_leaves(st.legacy_opt()))
    line = {"arch": cfg.name, "depth": cfg.n_layers, "batch": args.batch,
            "seq": args.seq, "microbatches": args.ub, "dtype": cfg.dtype,
            **per_rank(eng, cfg),
            "weights_are_slices_of_one_process": slices,
            "losses": losses, "step_s": times,
            "model_collectives_per_step": colls[-1]["model_collectives"],
            "model_collective_GB_per_step":
                colls[-1]["model_collective_bytes"] / 1e9,
            "model_collective_ms": [c["model_collective_ms"]
                                    for c in colls],
            "k4_GB_per_step_per_rank": k4_gb,
            "launches_per_step": {n: v / args.steps
                                  for n, v in launches.items()},
            "whole_leaf_checksums": whole_sums, "launches": launches,
            "routes": routes}
    del st, st0, eng
    check(slices, f"{key}: the weights are not the one-process slices")
    check(all(r == whole_sums[0] for r in whole_sums),
          f"{key}: the replicated leaves differ")
    check(all(np.isfinite(losses)), f"{key}: a loss is not finite")
    if rank == 0:
        ref, ref_times = whole, []
        ref_losses = []
        for b in batches:
            t0 = time.perf_counter()
            ref, m = one.train_step(ref, b)
            ref_losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ref_times.append(time.perf_counter() - t0)
        line["one_process_losses"] = ref_losses
        line["one_process_step_s"] = ref_times
        line["loss_rel_to_one_process"] = [
            abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        del ref
        check(max(line["loss_rel_to_one_process"]) <= TP_LOSS_REL_BF16,
              f"{key}: bf16 losses apart from one process")
    del whole, one
    free_host(torch)
    dist.barrier()

    # the f32 check: depth 2 at fan-in scales, one draw on every rank; the
    # ranks on the CLI's configuration (the sharded, weight-streamed relay
    # with the offloaded stash), one process with its weights on the card
    t0 = time.perf_counter()
    ap, args = cli.parse_args(argv + TP_F32)
    name, cfg, opt, exec_cfg = cli.setup(ap, args)
    assert exec_cfg.weight_stream and not exec_cfg.pack_params
    eng = engines.create(name, cfg, exec_cfg, optimizer=opt, mesh=mesh)
    data = cli.make_data(args, cfg)
    batches = [cli.batch_at(args, cfg, data, i) for i in range(args.steps)]
    st = drawn_state(torch, eng)
    f32_losses = []
    for b in batches:
        st, m = eng.train_step(st, eng.local_rows(b, "train_step"))
        f32_losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    got = bridge.gather_params(st.params, eng.tp)
    del st, eng
    free_host(torch)
    dist.barrier()
    if rank == 0:
        one = engines.create(name, cfg, dataclasses.replace(
            exec_cfg, weight_stream=False, offload_stash=False),
            optimizer=opt)
        ref = drawn_state(torch, one)
        p0 = tree_leaves(bridge.params_to_numpy(ref.params))
        one_losses = []
        for b in batches:
            ref, m = one.train_step(ref, b)
            one_losses.append(float(m["loss"]))
        upd = f32_rel(np, tree_leaves, got,
                      bridge.params_to_numpy(ref.params), p0)
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(f32_losses, one_losses))
        line["f32"] = {"depth": cfg.n_layers, "batch": args.batch,
                       "init": "fan-in scales (repro_torch.testing."
                               "fan_in_params), one draw",
                       "ranks": "weight-streamed, sharded relay (the CLI's)",
                       "losses": f32_losses,
                       "one_process_losses": one_losses,
                       "loss_rel_max": loss_rel, "update_rel_l2_max": upd,
                       "bounds": {"loss_rel": DP_LOSS_REL,
                                  "update_rel_l2": DP_UPDATE_REL},
                       "seconds": time.perf_counter() - t0}
        del ref, one
        check(loss_rel <= DP_LOSS_REL and upd <= DP_UPDATE_REL,
              f"{key}: f32 apart from one process")
    del got
    free_host(torch)
    line["seconds"] = time.perf_counter() - t_phase
    return line


def tp_rank(np, torch):
    """One rank of ``tp_phase`` (run by ``torch.distributed.run`` with
    ``--tp-rank``): a (data=1, model=TP_RANKS) mesh over gloo on this
    card.

    train-tp: bert-large through the train CLI's configuration
    (``TP_ARGV``): the rank's weights checked against the slices of the
    one-process draw (checksums), 3 steps with every counter set to 0 just
    before and read just after, the ranks' checksums of the leaves no
    pspec splits (and their Adam slots) equal; rank 0 then runs one
    process from the same seed and holds the losses within
    ``TP_LOSS_REL_BF16``; then in f32 at depth 2 and fan-in scales from
    one draw, the ranks on the CLI's sharded, weight-streamed relay, the
    gathered state against one process (its weights on the card) within
    ``DP_LOSS_REL`` (losses) and ``DP_UPDATE_REL`` (each leaf's update).

    serve-tp: granite-3-8b at depth ``TP_SERVE_DEPTH``, weight_stream
    unpacked: decode_init on 4 prompts of 16 tokens, 4 greedy steps and
    prefill, counted; prefill against decode_init within
    ``TP_SERVE_BF16``; rank 0 holds decode_init's and prefill's logits to
    one process on the same weights (bf16: ``TP_SERVE_BF16``); then in
    f32 at fan-in scales, tokens equal and every step's logits within
    ``TP_SERVE_F32`` of one process.  Rank 0 prints every rank's results
    as one JSON line."""
    import torch.distributed as dist
    from repro_torch import engine as engines
    from repro_torch.configs.base import get_config
    from repro_torch.core.schedule import ExecutionConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed.data_parallel import tree_checksum
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_adam as fadam
    from repro_torch.kernels import relay_copy as rc
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.testing import fan_in_params
    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    mesh = make_mesh({"data": 1, "model": TP_RANKS}, "cuda")
    counters = {"relay_copy": rc.copy_rows,
                "relay_copy_writeback": rc.writeback_rows,
                "rmsnorm": rms.rmsnorm_2d,
                "flash_attention_fwd": fa.flash_attention_fwd_bhsd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                "fused_adam": fadam.fused_adam_flat}
    mine, fails = {}, []

    def check(ok, what):
        """A failed check fails the rank after every result is printed."""
        if not ok:
            fails.append(what)

    def done(key, line):
        mine[key] = line
        print(json.dumps({"tp_rank": rank, "phase": key, **line},
                         default=str), flush=True)

    def sync_sums(*trees):
        torch.cuda.synchronize()
        return [tree_checksum(t) for t in trees]

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    # ------------------------------------------------------------ train-tp
    line = tp_cli_train(np, torch, mesh, rank, counters, check, "train-tp",
                        TP_ARGV, lambda e, c: {
                            "heads_per_rank": c.n_heads // TP_RANKS,
                            "d_ff_per_rank": c.d_ff // TP_RANKS,
                            "vocab_per_rank": (c.vocab_size // TP_RANKS
                                               if e.tp.vocab
                                               else c.vocab_size)})
    done("train-tp", line)
    dist.barrier()

    # ------------------------------------------------------------ serve-tp
    t_phase = time.perf_counter()
    full = get_config("granite-3-8b", "full")
    cfg = full.replace(use_pallas=True, n_layers=TP_SERVE_DEPTH)
    ex = ExecutionConfig(weight_stream=True, pack_params=False,
                         prefetch_depth=1, transport="pallas")
    B, P, GEN = TP_SERVE["batch"], TP_SERVE["prompt"], TP_SERVE["gen"]
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))

    def greedy(e, params, steps):
        return tp_greedy(torch, e, params, prompt, steps)

    eng = engines.create("l2l", cfg, ex, mesh=mesh)
    t0 = time.perf_counter()
    reset_counts(counters.values())
    params = eng.init_params(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks, logits, pl, step = greedy(eng, params, GEN)
    launches = {n: c.launches for n, c in counters.items()}
    routes = route_counts(counters)
    layer_bytes = sum(a[0].numel() * a.element_size()
                      for a in tree_leaves(params["groups"]))
    # one K4 launch a leaf a layer fetch (the unpacked relay)
    fetches = step["fetches"] / len(tree_leaves(params["groups"]))
    gap = rel(pl, logits[0])
    agree = int((pl.argmax(-1) == logits[0].argmax(-1)).sum())
    line = {"arch": full.name, "depth": cfg.n_layers, "batch": B,
            "prompt": P, "steps": GEN,
            "heads_per_rank": [eng.tp.n_heads // TP_RANKS,
                               eng.tp.local_kv_heads()],
            "d_ff_per_rank": cfg.d_ff // TP_RANKS,
            "vocab_split": eng.tp.vocab, "init_s": init_s,
            "tokens": toks.tolist(), "decode_init_s": step["init_s"],
            "decode_s": step["decode_s"],
            "tok_per_s": B * GEN / step["decode_s"],
            "layer_bytes_per_rank": layer_bytes,
            "layer_fetches_per_step": fetches / GEN,
            "k4_GB_per_step": fetches / GEN * layer_bytes / 1e9,
            "rel_l2_prefill_vs_decode_init": gap, "argmax_agree": agree,
            "model_collectives_last_step": step["collectives"],
            "launches": launches, "routes": routes}
    check(gap <= TP_SERVE_BF16 and agree >= B - 1,
          "serve-tp: prefill apart from decode_init")
    check(bool(torch.isfinite(pl).all()) and pl.shape == (B, cfg.vocab_size),
          "serve-tp: prefill's logits")
    if rank == 0:
        # one process on the same weights (the same seed: the whole draw)
        one = engines.create("l2l", cfg, ex)
        wparams = one.init_params(torch.Generator(dev).manual_seed(0))
        line["weights_are_slices_of_one_process"] = sync_sums(params)[0] == \
            sync_sums(eng.tp.shard(wparams))[0]
        _, o_logits, o_pl, _ = greedy(one, wparams, 0)
        line["bf16_rel_l2_to_one_process"] = {
            "decode_init": rel(logits[0], o_logits[0]),
            "prefill": rel(pl, o_pl)}
        line["one_process_rel_l2_prefill_vs_decode_init"] = rel(
            o_pl, o_logits[0])
        del one, wparams
        check(line["weights_are_slices_of_one_process"],
              "serve-tp: the weights are not the one-process slices")
        check(max(line["bf16_rel_l2_to_one_process"].values())
              <= TP_SERVE_BF16, "serve-tp: bf16 apart from one process")
    del params, eng
    free_host(torch)
    dist.barrier()
    # f32 at fan-in scales: tokens equal, logits within TP_SERVE_F32
    c32 = cfg.replace(dtype="float32")
    eng = engines.create("l2l", c32, ex, mesh=mesh)
    g = torch.Generator(dev).manual_seed(5)
    wparams = fan_in_params(eng.model.param_specs(), lambda shape:
                            torch.randn(shape, generator=g, device=dev))
    toks32, logits32, pl32, _ = greedy(eng, eng.tp.shard(wparams), GEN)
    del eng
    if rank == 0:
        one = engines.create("l2l", c32, ex)
        o_toks, o_logits, o_pl, _ = greedy(one, wparams, GEN)
        worst = max([rel(a, b) for a, b in zip(logits32, o_logits)]
                    + [rel(pl32, o_pl)])
        line["f32"] = {"init": "fan-in scales", "tokens": toks32.tolist(),
                       "tokens_equal": bool(torch.equal(toks32, o_toks)),
                       "logits_rel_l2_max": worst, "bound": TP_SERVE_F32}
        del one
        check(line["f32"]["tokens_equal"] and worst <= TP_SERVE_F32,
              "serve-tp: f32 apart from one process")
    del wparams
    free_host(torch)
    line["seconds"] = time.perf_counter() - t_phase
    done("serve-tp", line)

    dist.barrier()
    tp_rank_moe(np, torch, mesh, rank, counters, check, done)
    dist.barrier()
    tp_rank_recurrent(np, torch, mesh, rank, counters, check, done)
    dist.barrier()
    tp_rank_modality(np, torch, mesh, rank, counters, check, done)

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if rank == 0:
        print(json.dumps({"tp_ranks": every}), flush=True)
    dist.destroy_process_group()
    assert not fails, fails


def tp_rank_moe(np, torch, mesh, rank, counters, check, done):
    """The MoE family on the mesh, in ``tp_rank``'s world (``TP_RANKS``
    gloo ranks on this card), deepseek-v2-lite at full width:

    train-moe-tp: ``TP_MOE_TRAIN`` on ``mesh`` (data=1, model=2), l2l-p
    unpacked, bf16, Adam: the rank's weights the slices of the one-process
    draw (checksums), 1 step with every counter set to 0 just before and
    read just after, the ranks' replicated leaves and Adam slots equal;
    rank 0 holds the losses to one process at the same depth and batch
    (its weights on the card) within ``TP_LOSS_REL_BF16``; then in f32 at
    fan-in scales, one step of the ranks on the same relay (K4 fetching
    and writing back each rank's expert blocks), the gathered weights
    against one process within ``DP_LOSS_REL`` (losses), ``DP_UPDATE_REL``
    (each leaf's update) and ``TP_MOE_AUX_REL`` (the aux), each state
    drawn whole from one seed on every rank.

    train-moe-dp: the same on a (data=2, model=1) mesh over the same
    ranks, packed (K1 runs) without the prefetch ring (two ranks' packed
    MoE rows with their Adam slots share the card), each rank on its
    block of each microbatch of
    the global batch (the router's statistics and the dispatch over the
    data group), counted; the ranks' checksums equal; rank 0 holds the
    losses to the same one process (bf16), and the f32 run on the same
    packed relay (K1 on the packed rows) from the same draw to the same
    one-process f32 run; the data group's collectives a step, the MoE's
    apart from the gradient rows.

    serve-moe-tp: depth ``TP_MOE_SERVE_DEPTH`` on ``mesh``, weight_stream
    unpacked, counted: decode_init on 4 prompts of 16, 4 greedy steps and
    prefill; bf16 logits within ``TP_SERVE_BF16`` of one process on the
    same weights; in f32 at fan-in scales, the ranks on the same
    weight-streamed relay, tokens equal and logits within
    ``TP_SERVE_F32`` of one process; K4's GB a step a rank beside one
    process's."""
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch import engine as engines
    from repro_torch.configs.base import get_config
    from repro_torch.core import packing
    from repro_torch.core.schedule import ExecutionConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.distributed.data_parallel import tree_checksum
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adam, make_schedule
    from repro_torch.testing import fan_in_params
    dev = torch.device("cuda")
    T = TP_MOE_TRAIN
    full = get_config(MOE_ARCH, "full")
    cfg = full.replace(n_layers=T["depth"], use_pallas=True)
    c32 = cfg.replace(dtype="float32")
    knobs = dict(n_microbatches=T["ub"], weight_stream=True,
                 prefetch_depth=1, transport="pallas", offload_stash=True)
    # packed (the data path) without the prefetch ring: two ranks share
    # the card, and the ring's clamped re-fetch of the 2.3 GB MoE row
    # with its Adam slots would double each rank's peak (results are the
    # same bits at every prefetch depth)
    ex = {False: ExecutionConfig(pack_params=False, **knobs),
          True: ExecutionConfig(pack_params=True,
                                **{**knobs, "prefetch_depth": 0})}
    # the one process holds the numbers, not the relay: its weights rest
    # on the card and nothing is pinned
    ex_card = ExecutionConfig(n_microbatches=T["ub"])
    opt = lambda: adam(schedule=make_schedule(1e-4, warmup=10))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=T["seq"],
                   global_batch=T["batch"], seed=0)).batch(i).items()}
        for i in range(T["steps"])]
    mesh_dp = make_mesh({"data": TP_RANKS, "model": 1}, "cuda")

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    def sync_sums(*trees):
        torch.cuda.synchronize()
        return [tree_checksum(t) for t in trees]

    def steps(eng, st):
        """The counted steps on this rank's rows -> (state, line)."""
        bs = [eng.local_rows(b, "train_step") for b in batches]
        torch.cuda.synchronize()
        reset_counts(counters.values())
        losses, aux, times, colls = [], [], [], []
        for b in bs:
            t0 = time.perf_counter()
            st, m = eng.train_step(st, b)
            losses.append(float(m["loss"]))
            aux.append(float(m["aux"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            colls.append({**eng.dp.stats(),
                          **(eng.tp.stats() if eng.tp else {})})
        launches = {n: c.launches for n, c in counters.items()}
        line = {"arch": full.name, "depth": cfg.n_layers,
                "batch": T["batch"], "rows_per_rank": bs[0]["tokens"].shape[0],
                "seq": T["seq"], "microbatches": T["ub"], "dtype": cfg.dtype,
                "pack": eng.exec_cfg.pack_params, "losses": losses,
                "aux": aux, "step_s": times, "collectives_per_step": colls,
                "launches_per_step": {n: v / T["steps"]
                                      for n, v in launches.items()},
                "launches": launches, "routes": route_counts(counters)}
        return st, line

    def f32_run(eng):
        """The ranks' f32 steps on the relay of the counted run."""
        st = drawn_state(torch, eng)
        losses, aux = [], []
        for b in batches[:T["f32_steps"]]:
            st, m = eng.train_step(st, eng.local_rows(b, "train_step"))
            losses.append(float(m["loss"]))
            aux.append(float(m["aux"]))
        torch.cuda.synchronize()
        # the weights alone
        got = (bridge.gather_params(st.params, eng.tp) if eng.tp
               else bridge.params_to_numpy(packing.unpack_params(
                   st.params)))
        return losses, aux, got

    def f32_check(line, key, losses, aux, got):
        if rank != 0:
            return
        upd = f32_rel(np, tree_leaves, got, one32["params"], one32["p0"])
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, one32["losses"]))
        aux_rel = max(abs(a - b) / abs(b)
                      for a, b in zip(aux, one32["aux"]))
        line["f32"] = {"depth": c32.n_layers, "batch": T["batch"],
                       "init": "fan-in scales (repro_torch.testing."
                               "fan_in_params), one draw",
                       "ranks": "the relay of the counted run",
                       "losses": losses, "aux": aux,
                       "one_process_losses": one32["losses"],
                       "one_process_aux": one32["aux"],
                       "loss_rel_max": loss_rel, "aux_rel_max": aux_rel,
                       "update_rel_l2_max": upd,
                       "bounds": {"loss_rel": DP_LOSS_REL,
                                  "aux_rel": TP_MOE_AUX_REL,
                                  "update_rel_l2": DP_UPDATE_REL}}
        check(loss_rel <= DP_LOSS_REL and upd <= DP_UPDATE_REL
              and aux_rel <= TP_MOE_AUX_REL,
              f"{key}: f32 apart from one process")

    # ------------------------------------------------------- train-moe-tp
    t_phase = time.perf_counter()
    eng = engines.create("l2l-p", cfg, ex[False], optimizer=opt(),
                         mesh=mesh)
    held = [eng.init(torch.Generator(dev).manual_seed(0))]
    one = engines.create("l2l-p", cfg, ex_card, optimizer=opt())
    # the one-process draw (rank 0 trains it; rank 1 needs its weights)
    g0 = torch.Generator(dev).manual_seed(0)
    whole = [one.init(g0) if rank == 0 else one.init_params(g0)]
    slices = sync_sums(held[0].params)[0] == sync_sums(eng.tp.shard(
        getattr(whole[0], "params", whole[0])))[0]
    # no reference to the first state outlives its step: the second step
    # reuses its pinned blocks
    st, line = steps(eng, held.pop())
    torch.cuda.synchronize()
    whole_sums = eng.tp.gather_checksums(
        eng.tp.whole_leaves(st.params), eng.tp.whole_leaves(st.legacy_opt()))
    lo, hi = eng.tp.expert_block()
    line.update({"heads_per_rank": cfg.n_heads // TP_RANKS,
                 "experts_per_rank": [lo, hi],
                 "shared_columns_per_rank": cfg.n_shared_experts
                 * cfg.d_ff_expert // TP_RANKS,
                 "dense_ffn_columns_per_rank": cfg.d_ff_dense // TP_RANKS,
                 "vocab_per_rank": (cfg.vocab_size // TP_RANKS
                                    if eng.tp.vocab else cfg.vocab_size),
                 "weights_are_slices_of_one_process": slices,
                 "whole_leaf_checksums": whole_sums})
    del st, eng
    check(slices, "train-moe-tp: the weights are not the one-process slices")
    check(all(r == whole_sums[0] for r in whole_sums),
          "train-moe-tp: the replicated leaves differ")
    check(all(np.isfinite(line["losses"])) and min(line["aux"]) > 0,
          "train-moe-tp: a loss or aux is not finite")
    # the other rank's cached blocks go back before one process runs
    free_host(torch)
    dist.barrier()
    one_bf16 = None
    if rank == 0:
        ref, ref_losses, ref_times = whole.pop(), [], []
        for b in batches:
            t0 = time.perf_counter()
            ref, m = one.train_step(ref, b)
            ref_losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ref_times.append(time.perf_counter() - t0)
        one_bf16 = {"losses": ref_losses, "step_s": ref_times}
        line["one_process_losses"] = ref_losses
        line["one_process_step_s"] = ref_times
        line["loss_rel_to_one_process"] = [
            abs(a - b) / abs(b) for a, b in zip(line["losses"], ref_losses)]
        del ref
        check(max(line["loss_rel_to_one_process"]) <= TP_LOSS_REL_BF16,
              "train-moe-tp: bf16 losses apart from one process")
    del whole, one
    free_host(torch)
    dist.barrier()
    # f32 from one draw: the two ranks on the counted run's relay, then
    # one process on rank 0
    t0 = time.perf_counter()
    eng = engines.create("l2l-p", c32, ex[False], optimizer=opt(),
                         mesh=mesh)
    tp32 = f32_run(eng)
    del eng
    free_host(torch)
    dist.barrier()
    one32 = {}
    if rank == 0:
        one = engines.create("l2l-p", c32, ex_card, optimizer=opt())
        ref = drawn_state(torch, one)
        one32["p0"] = tree_leaves(bridge.params_to_numpy(ref.params))
        one32["losses"], one32["aux"] = [], []
        for b in batches[:T["f32_steps"]]:
            ref, m = one.train_step(ref, b)
            one32["losses"].append(float(m["loss"]))
            one32["aux"].append(float(m["aux"]))
        one32["params"] = bridge.params_to_numpy(ref.params)
        del ref, one
    f32_check(line, "train-moe-tp", *tp32)
    del tp32
    free_host(torch)
    line["f32_seconds"] = time.perf_counter() - t0
    line["seconds"] = time.perf_counter() - t_phase
    done("train-moe-tp", line)
    dist.barrier()

    # ------------------------------------------------------- train-moe-dp
    t_phase = time.perf_counter()
    eng = engines.create("l2l-p", cfg, ex[True], optimizer=opt(),
                         mesh=mesh_dp)
    st, line = steps(eng, eng.init(torch.Generator(dev).manual_seed(0)))
    sums = eng.dp.gather_checksums(st.params, st.opt_state)
    last = line["collectives_per_step"][-1]
    line.update({"rank_checksums": sums,
                 "gradient_all_reduces_per_step": last["all_reduces"],
                 "gradient_all_reduce_GB_per_step":
                     last["all_reduce_bytes"] / 1e9,
                 "moe_collectives_per_step": last["moe_collectives"],
                 "moe_collective_bytes_per_step":
                     last["moe_collective_bytes"]})
    del st, eng
    check(all(r == sums[0] for r in sums),
          "train-moe-dp: the data ranks' states differ")
    check(all(np.isfinite(line["losses"])) and min(line["aux"]) > 0,
          "train-moe-dp: a loss or aux is not finite")
    if rank == 0:
        # one process at the same depth, seed and global batch:
        # train-moe-tp's
        line["one_process_losses"] = one_bf16["losses"]
        line["loss_rel_to_one_process"] = [
            abs(a - b) / abs(b)
            for a, b in zip(line["losses"], one_bf16["losses"])]
        check(max(line["loss_rel_to_one_process"]) <= TP_LOSS_REL_BF16,
              "train-moe-dp: bf16 losses apart from one process")
    free_host(torch)
    t0 = time.perf_counter()
    eng = engines.create("l2l-p", c32, ex[True], optimizer=opt(),
                         mesh=mesh_dp)
    f32_check(line, "train-moe-dp", *f32_run(eng))
    del eng, one32
    free_host(torch)
    line["f32_seconds"] = time.perf_counter() - t0
    line["seconds"] = time.perf_counter() - t_phase
    done("train-moe-dp", line)
    dist.barrier()
    tp_rank_dp_f32(np, torch, mesh_dp, rank, check, done)
    dist.barrier()

    # ------------------------------------------------------- serve-moe-tp
    t_phase = time.perf_counter()
    scfg = full.replace(n_layers=TP_MOE_SERVE_DEPTH, use_pallas=True)
    sx = ExecutionConfig(weight_stream=True, pack_params=False,
                         prefetch_depth=1, transport="pallas")
    B, P, GEN = TP_SERVE["batch"], TP_SERVE["prompt"], TP_SERVE["gen"]
    prompt = torch.randint(0, scfg.vocab_size, (B, P), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))

    def greedy(e, params, n):
        return tp_greedy(torch, e, params, prompt, n)

    eng = engines.create("l2l", scfg, sx, mesh=mesh)
    t0 = time.perf_counter()
    reset_counts(counters.values())
    params = eng.init_params(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks, logits, pl, info = greedy(eng, params, GEN)
    launches = {n: c.launches for n, c in counters.items()}
    routes = route_counts(counters)
    gap = rel(pl, logits[0])
    line = {"arch": full.name, "depth": scfg.n_layers, "batch": B,
            "prompt": P, "steps": GEN, "init_s": init_s,
            "experts_per_rank": list(eng.tp.expert_block()),
            "tokens": toks.tolist(), "decode_init_s": info["init_s"],
            "decode_s": info["decode_s"],
            "tok_per_s": B * GEN / info["decode_s"],
            "k4_GB_per_step": info["fetched_bytes"] / GEN / 1e9,
            "k4_launches_per_step": info["fetches"] / GEN,
            "rel_l2_prefill_vs_decode_init": gap,
            "model_collectives_last_step": info["collectives"],
            "launches": launches, "routes": routes}
    check(bool(torch.isfinite(pl).all()) and pl.shape == (B, scfg.vocab_size),
          "serve-moe-tp: prefill's logits")
    check(gap <= TP_SERVE_BF16, "serve-moe-tp: prefill apart from "
                                "decode_init")
    if rank == 0:
        one = engines.create("l2l", scfg, sx)
        wparams = one.init_params(torch.Generator(dev).manual_seed(0))
        line["weights_are_slices_of_one_process"] = sync_sums(params)[0] == \
            sync_sums(eng.tp.shard(wparams))[0]
        _, o_logits, o_pl, o_info = greedy(one, wparams, GEN)
        line["one_process_k4_GB_per_step"] = \
            o_info["fetched_bytes"] / GEN / 1e9
        line["one_process_tok_per_s"] = B * GEN / o_info["decode_s"]
        line["bf16_rel_l2_to_one_process"] = {
            "decode_init": rel(logits[0], o_logits[0]),
            "prefill": rel(pl, o_pl)}
        del one, wparams
        check(line["weights_are_slices_of_one_process"],
              "serve-moe-tp: the weights are not the one-process slices")
        check(max(line["bf16_rel_l2_to_one_process"].values())
              <= TP_SERVE_BF16, "serve-moe-tp: bf16 apart from one process")
    del params, eng
    free_host(torch)
    dist.barrier()
    s32 = scfg.replace(dtype="float32")
    # the ranks on the counted run's relay; one process with its weights
    # on the card
    eng = engines.create("l2l", s32, sx, mesh=mesh)
    g = torch.Generator(dev).manual_seed(5)
    wparams = fan_in_params(eng.model.param_specs(), lambda shape:
                            torch.randn(shape, generator=g, device=dev))
    toks32, logits32, pl32, _ = greedy(eng, eng.tp.shard(wparams), GEN)
    del eng
    if rank == 0:
        one = engines.create("l2l", s32, ExecutionConfig())
        o_toks, o_logits, o_pl, _ = greedy(one, wparams, GEN)
        worst = max([rel(a, b) for a, b in zip(logits32, o_logits)]
                    + [rel(pl32, o_pl)])
        line["f32"] = {"init": "fan-in scales", "tokens": toks32.tolist(),
                       "tokens_equal": bool(torch.equal(toks32, o_toks)),
                       "logits_rel_l2_max": worst, "bound": TP_SERVE_F32}
        del one
        check(line["f32"]["tokens_equal"] and worst <= TP_SERVE_F32,
              "serve-moe-tp: f32 apart from one process")
    del wparams
    free_host(torch)
    line["seconds"] = time.perf_counter() - t_phase
    done("serve-moe-tp", line)


def tp_greedy(torch, e, params, prompt, n, stub=None):
    """decode_init on ``prompt``, ``n`` greedy steps, then prefill of the
    prompt -> (tokens, the logits of decode_init and each step, prefill's,
    info: decode_init's and the steps' seconds, the steps' K4 fetches and
    bytes and the last step's model collectives).  ``stub``: the modality
    input (``tp_stub``), whisper's frames to decode_init and prefill,
    internvl2's patches to prefill only (it decodes text)."""
    from repro_torch.kernels import relay_copy as rc
    from repro_torch.serve.sampling import sample_batch
    P = prompt.shape[1]
    stub = stub or {}
    t0 = time.perf_counter()
    caches, last = e.decode_init(params, prompt, P + n,
                                 **{k: v for k, v in stub.items()
                                    if k == "frames"})
    torch.cuda.synchronize()
    info = {"init_s": time.perf_counter() - t0}
    tok = sample_batch(last)[:, None]
    toks, logits = [tok], [last]
    f0, b0 = rc.copy_rows.launches, rc.copy_rows.bytes
    t0 = time.perf_counter()
    for i in range(n):
        lg, caches = e.decode_step(params, caches, tok, P + i)
        tok = sample_batch(lg[:, -1])[:, None]
        toks.append(tok)
        logits.append(lg[:, -1])
    torch.cuda.synchronize()
    info.update(decode_s=time.perf_counter() - t0,
                fetches=rc.copy_rows.launches - f0,
                fetched_bytes=rc.copy_rows.bytes - b0,
                collectives=e.tp.stats() if e.tp else None)
    pl = e.prefill(params, {"tokens": prompt, **stub})
    torch.cuda.synchronize()
    return torch.cat(toks, 1), logits, pl, info


def tp_prompt(torch, cfg):
    """``TP_SERVE``'s prompts of ``cfg``'s vocabulary, the same on every
    rank; internvl2's of ``VLM_PROMPT`` tokens (its prefill runs the
    flash kernel behind 256 patches: 384 positions tile by 128, 272 would
    not)."""
    B = TP_SERVE["batch"]
    P = VLM_PROMPT if cfg.is_vlm else TP_SERVE["prompt"]
    dev = torch.device("cuda")
    return torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))


def tp_stub(torch, cfg):
    """The modality input of ``TP_SERVE``'s batch in ``cfg``'s dtype, the
    same on every rank: whisper's frames, internvl2's patches, else
    nothing."""
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(2)
    B, dt = TP_SERVE["batch"], getattr(torch, cfg.dtype)
    if cfg.family == "audio":
        return {"frames": torch.randn(B, cfg.n_frames, cfg.d_model,
                                      generator=g, device=dev).to(dt)}
    if cfg.is_vlm:
        return {"patches": torch.randn(B, cfg.n_patches, cfg.vit_dim,
                                       generator=g, device=dev).to(dt)}
    return {}


def tp_row_bytes(cfg, group: int = 0):
    """One layer's f32 bytes (of layer group ``group``) whole and on one
    model rank."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.common import is_spec
    from repro_torch.models.model import LayeredModel
    return {"whole": 4 * sum(math.prod(s.shape) for s in tree_leaves(
                LayeredModel(cfg).groups[group].spec, is_leaf=is_spec)),
            "per_rank": tp_layer_bytes(cfg, TP_RANKS, LayeredModel,
                                       tree_leaves, is_spec, group)}


def tp_fan_in_decode(torch, mesh, rank, check, key, cfg, n,
                     dtype="float32"):
    """In ``dtype`` at fan-in scales, the ranks on the serve relay
    (weight_stream unpacked), one process with its weights on the card:
    decode_init on ``TP_SERVE``'s prompts (and ``tp_stub``), ``n`` greedy
    steps and prefill; in f32 the tokens equal and every step's logits
    and prefill's within ``TP_SERVE_F32``, in bf16 the logits within
    ``TP_SERVE_BF16`` (the tokens printed).  -> rank 0's line (None on
    the others)."""
    import torch.distributed as dist
    from repro_torch import engine as engines
    from repro_torch.core.schedule import ExecutionConfig
    from repro_torch.testing import fan_in_params
    dev = torch.device("cuda")
    sx = ExecutionConfig(weight_stream=True, pack_params=False,
                         prefetch_depth=1, transport="pallas")

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    c = cfg.replace(dtype=dtype)
    f32 = dtype == "float32"
    bound = TP_SERVE_F32 if f32 else TP_SERVE_BF16
    eng = engines.create("l2l", c, sx, mesh=mesh)
    g = torch.Generator(dev).manual_seed(5)
    wparams = fan_in_params(eng.model.param_specs(), lambda shape:
                            torch.randn(shape, generator=g, device=dev))
    prompt, stub = tp_prompt(torch, c), tp_stub(torch, c)
    toks, logits, pl, _ = tp_greedy(torch, eng, eng.tp.shard(wparams),
                                    prompt, n, stub)
    del eng
    out = None
    if rank == 0:
        one = engines.create("l2l", c, ExecutionConfig())
        o_toks, o_logits, o_pl, _ = tp_greedy(torch, one, wparams, prompt,
                                              n, stub)
        worst = max([rel(a, b) for a, b in zip(logits, o_logits)]
                    + [rel(pl, o_pl)])
        out = {"depth": c.n_layers, "dtype": dtype, "init": "fan-in scales",
               "steps": n, "tokens": toks.tolist(),
               "tokens_equal": bool(torch.equal(toks, o_toks)),
               "logits_rel_l2_max": worst, "bound": bound}
        del one
        check((out["tokens_equal"] or not f32) and worst <= bound,
              f"{key}: {dtype} apart from one process")
    del wparams
    free_host(torch)
    dist.barrier()
    return out


def tp_rank_recurrent(np, torch, mesh, rank, counters, check, done):
    """The hybrid and SSM families on the mesh's model axis, in
    ``tp_rank``'s world (``TP_RANKS`` gloo ranks on this card):

    train-hybrid-tp: hymba-1.5b at full width through ``TP_HYBRID_ARGV``
    (``tp_cli_train``: the weights the one-process slices, 2 steps
    counted, the replicated leaves and Adam slots equal, losses within
    ``TP_LOSS_REL_BF16`` of one process, then one f32 step at fan-in
    scales on the CLI's relay within ``DP_LOSS_REL`` / ``DP_UPDATE_REL``
    of one process); then its decode in f32 at depth 1
    (``TP_HYBRID_DECODE``): tokens equal and logits within
    ``TP_SERVE_F32`` of one process.

    serve-ssm-tp: rwkv6-1.6b at depth ``TP_SSM_SERVE_DEPTH``,
    weight_stream unpacked, counted: decode_init on 4 prompts of 16, 4
    greedy steps and prefill; bf16 logits within ``TP_SERVE_BF16`` of one
    process on the same weights; in f32 at fan-in scales on the same
    relay, tokens equal and logits within ``TP_SERVE_F32`` of one process;
    then one l2l-p step in f32 at depth 1 on the relay (``TP_SSM_TRAIN``)
    against one process within ``DP_LOSS_REL`` / ``DP_UPDATE_REL``."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config

    # ---------------------------------------------------- train-hybrid-tp
    t_phase = time.perf_counter()
    line = tp_cli_train(
        np, torch, mesh, rank, counters, check, "train-hybrid-tp",
        TP_HYBRID_ARGV, lambda e, c: {
            "attention_heads_split": e.tp.heads,
            "heads": [c.n_heads, c.n_kv_heads],
            "mamba_channels_per_rank": (c.d_model // TP_RANKS if e.tp.ffn
                                        else c.d_model),
            "d_ff_per_rank": c.d_ff // TP_RANKS if e.tp.ffn else c.d_ff,
            "vocab_per_rank": (c.vocab_size // TP_RANKS if e.tp.vocab
                               else c.vocab_size),
            "layer_f32_bytes": tp_row_bytes(c.replace(n_layers=1))})
    check(not line["attention_heads_split"]
          and line["mamba_channels_per_rank"] == 800,
          "train-hybrid-tp: not the reference's partition")
    dist.barrier()
    hymba = get_config("hymba-1.5b", "full").replace(
        n_layers=TP_HYBRID_DECODE["depth"], use_pallas=True)
    line["decode_f32"] = tp_fan_in_decode(torch, mesh, rank, check,
                                          "train-hybrid-tp", hymba,
                                          TP_HYBRID_DECODE["steps"])
    line["seconds"] = time.perf_counter() - t_phase
    done("train-hybrid-tp", line)
    dist.barrier()

    # ------------------------------------------------------- serve-ssm-tp
    t_phase = time.perf_counter()
    full = get_config("rwkv6-1.6b", "full")
    cfg = full.replace(n_layers=TP_SSM_SERVE_DEPTH)
    line = tp_serve_counted(
        torch, mesh, rank, counters, check, "serve-ssm-tp", cfg,
        lambda tp, c: {
            "heads_per_rank": (c.rwkv_heads // TP_RANKS
                               if tp.heads_x_dim else c.rwkv_heads),
            "channels_per_rank": (c.d_model // TP_RANKS
                                  if tp.heads_x_dim else c.d_model),
            "d_ff_per_rank": c.d_ff // TP_RANKS if tp.ffn else c.d_ff,
            "vocab_per_rank": (c.vocab_size // TP_RANKS if tp.vocab
                               else c.vocab_size),
            "layer_f32_bytes": tp_row_bytes(full.replace(n_layers=1))})
    check(line["heads_per_rank"] == 16 and line["vocab_per_rank"] == 32768,
          "serve-ssm-tp: not the reference's partition")
    check(line["rel_l2_prefill_vs_decode_init"] <= TP_SERVE_BF16,
          "serve-ssm-tp: prefill apart from decode_init")
    line["f32"] = tp_fan_in_decode(torch, mesh, rank, check,
                                   "serve-ssm-tp", cfg, TP_SERVE["gen"])

    # one f32 train step at depth 1 on the relay: the decay's and
    # ln_scale's gradients cross the ranks through copy_in
    line["train_f32"] = tp_f32_train_step(
        np, torch, mesh, rank, check, "serve-ssm-tp",
        full.replace(n_layers=TP_SSM_TRAIN["depth"], dtype="float32"),
        TP_SSM_TRAIN)
    line["seconds"] = time.perf_counter() - t_phase
    done("serve-ssm-tp", line)


def tp_rank_modality(np, torch, mesh, rank, counters, check, done):
    """The VLM and audio families on the mesh's model axis, in
    ``tp_rank``'s world (``TP_RANKS`` gloo ranks on this card):

    train-vlm-tp: internvl2-1b at full width through ``TP_VLM_ARGV``
    (``tp_cli_train``: the weights the one-process slices, 2 steps
    counted, the replicated leaves (the patch projection, the norms, the
    whole vocabulary) and their Adam slots equal, losses within
    ``TP_LOSS_REL_BF16`` of one process, then one f32 step at fan-in
    scales on the CLI's relay within ``DP_LOSS_REL`` / ``DP_UPDATE_REL``
    of one process); then its decode in f32 at depth 1
    (``TP_VLM_DECODE``): tokens equal and logits (prefill's behind the
    patches too) within ``TP_SERVE_F32`` of one process.

    serve-audio-tp: whisper-base at full width and depth,
    weight_stream unpacked, counted (``tp_serve_counted``): decode_init on
    4 prompts of 16 with 1500 frames, 4 greedy steps and prefill; bf16
    logits within ``TP_SERVE_BF16`` of one process on the same weights;
    in f32 at fan-in scales on the same relay, tokens equal and logits
    within ``TP_SERVE_F32`` of one process; then one l2l-p step in f32 at
    full depth on the relay (``TP_AUDIO_TRAIN``) against one process
    within ``DP_LOSS_REL`` / ``DP_UPDATE_REL``: the encoder's gradients
    and ``enc_ln_post``'s come only through the memory's cotangent, which
    each rank must sum over the group."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config

    # ------------------------------------------------------- train-vlm-tp
    t_phase = time.perf_counter()
    line = tp_cli_train(
        np, torch, mesh, rank, counters, check, "train-vlm-tp",
        TP_VLM_ARGV, lambda e, c: {
            "heads_per_rank": [c.n_heads // TP_RANKS if e.tp.heads
                               else c.n_heads, e.tp.local_kv_heads()],
            "d_ff_per_rank": c.d_ff // TP_RANKS if e.tp.ffn else c.d_ff,
            "vocab_per_rank": (c.vocab_size // TP_RANKS if e.tp.vocab
                               else c.vocab_size),
            "patches": c.n_patches,
            "layer_f32_bytes": tp_row_bytes(c.replace(n_layers=1))})
    check(line["heads_per_rank"] == [7, 1]
          and line["d_ff_per_rank"] == 2432
          and line["vocab_per_rank"] == 151655,
          "train-vlm-tp: not the reference's partition")
    dist.barrier()
    vlm = get_config(VLM_ARCH, "full").replace(
        n_layers=TP_VLM_DECODE["depth"], use_pallas=True)
    line["decode_f32"] = tp_fan_in_decode(torch, mesh, rank, check,
                                          "train-vlm-tp", vlm,
                                          TP_VLM_DECODE["steps"])
    line["seconds"] = time.perf_counter() - t_phase
    done("train-vlm-tp", line)
    dist.barrier()

    # ----------------------------------------------------- serve-audio-tp
    # use_pallas=False: the 1500 frames do not tile by the flash kernel's
    # block (attention is the plain attend, as on one rank)
    t_phase = time.perf_counter()
    full = get_config(AUDIO_ARCH, "full").replace(use_pallas=False)
    # at the reference's init (std 1/sqrt(6) stacked matrices) the
    # 1500-key cross-attention softmax is ill-conditioned: bf16 rounding
    # alone moves the logits far (printed beside one process's own bf16
    # against f32); the bf16 bound is held at fan-in scales
    line = tp_serve_counted(
        torch, mesh, rank, counters, check, "serve-audio-tp", full,
        lambda tp, c: {
            "depth": [c.n_encoder_layers, c.n_layers],
            "heads_per_rank": [c.n_heads // TP_RANKS if tp.heads
                               else c.n_heads, tp.local_kv_heads()],
            "d_ff_per_rank": c.d_ff // TP_RANKS if tp.ffn else c.d_ff,
            "vocab_per_rank": (c.vocab_size // TP_RANKS if tp.vocab
                               else c.vocab_size),
            "frames": c.n_frames,
            "layer_f32_bytes": [tp_row_bytes(c, gi) for gi in (0, 1)]},
        bound_bf16=False)
    check(line["heads_per_rank"] == [4, 4]
          and line["d_ff_per_rank"] == 1024
          and line["vocab_per_rank"] == 51865,
          "serve-audio-tp: not the reference's partition")
    line["bf16_fan_in"] = tp_fan_in_decode(
        torch, mesh, rank, check, "serve-audio-tp", full, TP_SERVE["gen"],
        "bfloat16")
    line["f32"] = tp_fan_in_decode(torch, mesh, rank, check,
                                   "serve-audio-tp", full, TP_SERVE["gen"])
    line["train_f32"] = tp_f32_train_step(
        np, torch, mesh, rank, check, "serve-audio-tp",
        full.replace(dtype="float32"), TP_AUDIO_TRAIN)
    line["seconds"] = time.perf_counter() - t_phase
    done("serve-audio-tp", line)


def tp_serve_counted(torch, mesh, rank, counters, check, key, cfg, per_rank,
                     bound_bf16=True):
    """The counted part of a serve path on the model axis: ``cfg``'s
    weights at the reference's init (seed 0) on the ranks'
    weight-streamed, unpacked relay; every counter set to 0 just before
    and read just after the init, decode_init on ``tp_prompt``'s prompts
    (with ``tp_stub``'s input), ``TP_SERVE``'s greedy steps and prefill.
    Rank 0 then runs one process on the same weights: the ranks' weights
    its slices, decode_init's and prefill's bf16 logits within
    ``TP_SERVE_BF16`` of its, its K4 bytes a step and tok/s beside.
    ``per_rank(tp, cfg)`` gives the line's per-rank widths.  Without
    ``bound_bf16`` the bf16 logits against one process are printed, not
    bounded, beside one process's own bf16 logits against its f32 ones
    on the same weights and inputs (what the init's conditioning makes
    of bf16 rounding alone).  -> the line (prefill against decode_init
    printed, not bounded)."""
    import torch.distributed as dist
    from repro_torch import engine as engines
    from repro_torch.core.schedule import ExecutionConfig
    from repro_torch.distributed.data_parallel import tree_checksum
    dev = torch.device("cuda")
    B, GEN = TP_SERVE["batch"], TP_SERVE["gen"]
    sx = ExecutionConfig(weight_stream=True, pack_params=False,
                         prefetch_depth=1, transport="pallas")

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    def sync_sums(*trees):
        torch.cuda.synchronize()
        return [tree_checksum(t) for t in trees]

    prompt, stub = tp_prompt(torch, cfg), tp_stub(torch, cfg)
    eng = engines.create("l2l", cfg, sx, mesh=mesh)
    t0 = time.perf_counter()
    reset_counts(counters.values())
    params = eng.init_params(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks, logits, pl, info = tp_greedy(torch, eng, params, prompt, GEN,
                                       stub)
    launches = {n: c.launches for n, c in counters.items()}
    routes = route_counts(counters)
    tp = eng.tp
    line = {"arch": cfg.name, "depth": cfg.n_layers, "batch": B,
            "prompt": prompt.shape[1], "steps": GEN, "init_s": init_s,
            **per_rank(tp, cfg),
            "tokens": toks.tolist(), "decode_init_s": info["init_s"],
            "decode_s": info["decode_s"],
            "tok_per_s": B * GEN / info["decode_s"],
            "k4_GB_per_step": info["fetched_bytes"] / GEN / 1e9,
            "k4_launches_per_step": info["fetches"] / GEN,
            "rel_l2_prefill_vs_decode_init": rel(pl, logits[0]),
            "model_collectives_last_step": info["collectives"],
            "launches": launches, "routes": routes}
    check(bool(torch.isfinite(pl).all()) and pl.shape == (B, cfg.vocab_size),
          f"{key}: prefill's logits")
    if rank == 0:
        one = engines.create("l2l", cfg, sx)
        wparams = one.init_params(torch.Generator(dev).manual_seed(0))
        line["weights_are_slices_of_one_process"] = sync_sums(params)[0] == \
            sync_sums(tp.shard(wparams))[0]
        _, o_logits, o_pl, o_info = tp_greedy(torch, one, wparams, prompt,
                                              GEN, stub)
        line["one_process_k4_GB_per_step"] = \
            o_info["fetched_bytes"] / GEN / 1e9
        line["one_process_tok_per_s"] = B * GEN / o_info["decode_s"]
        line["bf16_rel_l2_to_one_process"] = {
            "decode_init": rel(logits[0], o_logits[0]),
            "prefill": rel(pl, o_pl)}
        if not bound_bf16:
            one = engines.create("l2l", cfg.replace(dtype="float32"), sx)
            _, f_logits, f_pl, _ = tp_greedy(
                torch, one, wparams, prompt, 0,
                {k: v.float() for k, v in stub.items()})
            line["one_process_bf16_rel_l2_to_f32"] = {
                "decode_init": rel(o_logits[0], f_logits[0]),
                "prefill": rel(o_pl, f_pl)}
        del one, wparams
        check(line["weights_are_slices_of_one_process"],
              f"{key}: the weights are not the one-process slices")
        check(not bound_bf16 or max(line["bf16_rel_l2_to_one_process"]
                                    .values()) <= TP_SERVE_BF16,
              f"{key}: bf16 apart from one process")
    del params, eng, tp
    free_host(torch)
    dist.barrier()
    return line


def tp_f32_train_step(np, torch, mesh, rank, check, key, c32, T):
    """One l2l-p step of the f32 config ``c32`` at fan-in scales
    (``drawn_state``) on ``T``'s batch (with its modality stubs), the
    ranks on the weight-streamed, sharded relay, against one process with
    its weights on the card on the whole batch: the loss within
    ``DP_LOSS_REL`` and each leaf's update within ``DP_UPDATE_REL``.
    -> rank 0's line (None on the others)."""
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch import engine as engines
    from repro_torch.core.schedule import ExecutionConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.synthetic import (DataConfig, SyntheticLM,
                                            add_modality_stubs)
    from repro_torch.optim import adam, make_schedule
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    opt = lambda: adam(schedule=make_schedule(1e-4, warmup=10))
    raw = SyntheticLM(DataConfig(vocab_size=c32.vocab_size, seq_len=T["seq"],
                                 global_batch=T["batch"], seed=0)).batch(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in add_modality_stubs(
        raw, c32, np.random.default_rng(0)).items()}
    eng = engines.create("l2l-p", c32, ExecutionConfig(
        n_microbatches=T["ub"], weight_stream=True, pack_params=False,
        prefetch_depth=1, transport="pallas", offload_stash=True),
        optimizer=opt(), mesh=mesh)
    st, m = eng.train_step(drawn_state(torch, eng),
                           eng.local_rows(batch, "train_step"))
    loss = float(m["loss"])
    torch.cuda.synchronize()
    got = bridge.gather_params(st.params, eng.tp)
    del st, eng
    free_host(torch)
    dist.barrier()
    out = None
    if rank == 0:
        one = engines.create("l2l-p", c32, ExecutionConfig(
            n_microbatches=T["ub"]), optimizer=opt())
        ref = drawn_state(torch, one)
        p0 = tree_leaves(bridge.params_to_numpy(ref.params))
        ref, m = one.train_step(ref, batch)
        want = bridge.params_to_numpy(ref.params)
        zero = exact_zero_leaves(c32)
        upd = f32_rel(np, tree_leaves, got, want, p0, zero)
        loss_rel = abs(loss - float(m["loss"])) / abs(float(m["loss"]))
        out = {**T, "depth": [c32.n_encoder_layers, c32.n_layers]
               if c32.n_encoder_layers else c32.n_layers,
               "init": "fan-in scales (repro_torch.testing."
                       "fan_in_params), one draw",
               "ranks": "weight-streamed, sharded relay", "loss": loss,
               "one_process_loss": float(m["loss"]), "loss_rel": loss_rel,
               "update_rel_l2_max": upd,
               "bounds": {"loss_rel": DP_LOSS_REL,
                          "update_rel_l2": DP_UPDATE_REL},
               "seconds": time.perf_counter() - t0}
        if zero:
            # printed, not bounded (``exact_zero_leaves``)
            out["exact_zero_grad_leaves"] = len(zero)
            out["exact_zero_grad_update_rel_l2_max"] = max(
                f32_rel(np, tree_leaves, got, want, p0,
                        set(range(len(p0))) - {i}) for i in zero)
        del ref, one
        check(loss_rel <= DP_LOSS_REL and upd <= DP_UPDATE_REL,
              f"{key}: the f32 train step apart from one process")
    del got
    free_host(torch)
    return out


def tp_rank_dp_f32(np, torch, mesh_dp, rank, check, done):
    """train-dp's f32 check, in the tp phase's world (one process start-up
    less than a torchrun of its own): bert-large at depth 2 through the
    train CLI's configuration (``DP_ARGV`` + ``DP_F32``) on ``mesh_dp``
    (data=2, model=1), each rank on its block of each microbatch, on the
    CLI's
    weight-streamed, packed relay, one step from one draw at fan-in
    scales, the ranks' checksums equal; rank 0 holds the gathered weights
    to one process (its weights on the card) on the whole batch within
    ``DP_LOSS_REL`` (losses) and ``DP_UPDATE_REL`` (each leaf's
    update)."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch import engine as engines
    from repro_torch.core import packing
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import train as cli
    t0 = time.perf_counter()
    ap, args = cli.parse_args(DP_ARGV + DP_F32)
    name, cfg, opt, exec_cfg = cli.setup(ap, args)
    assert exec_cfg.weight_stream and exec_cfg.pack_params
    data = cli.make_data(args, cfg)
    batches = [cli.batch_at(args, cfg, data, i) for i in range(args.steps)]
    eng = engines.create(name, cfg, exec_cfg, optimizer=opt, mesh=mesh_dp)
    st, losses = drawn_state(torch, eng), []
    for b in batches:
        st, m = eng.train_step(st, eng.local_rows(b, "train_step"))
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    sums = eng.dp.gather_checksums(st.params, st.opt_state)
    got = bridge.params_to_numpy(packing.unpack_params(st.params))
    last = eng.dp.stats()
    del st, eng
    free_host(torch)
    line = {"depth": cfg.n_layers, "batch": args.batch, "dtype": "float32",
            "init": "fan-in scales (repro_torch.testing.fan_in_params), "
                    "one draw",
            "ranks": "weight-streamed, packed relay (the CLI's)",
            "losses": losses, "rank_checksums": sums,
            "all_reduces_per_step": last["all_reduces"],
            "all_reduce_GB_per_step": last["all_reduce_bytes"] / 1e9,
            "all_reduce_ms": last["all_reduce_ms"]}
    check(all(r == sums[0] for r in sums),
          "train-dp-b-f32: the data ranks' states differ")
    if rank == 0:
        one = engines.create(name, cfg, dataclasses.replace(
            exec_cfg, weight_stream=False, offload_stash=False),
            optimizer=opt)
        ref = drawn_state(torch, one)
        p0 = tree_leaves(bridge.params_to_numpy(packing.unpack_params(
            ref.params)))
        one_losses = []
        for b in batches:
            ref, m = one.train_step(ref, b)
            one_losses.append(float(m["loss"]))
        upd = f32_rel(np, tree_leaves, got, bridge.params_to_numpy(
            packing.unpack_params(ref.params)), p0)
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, one_losses))
        line.update(one_process_losses=one_losses, loss_rel_max=loss_rel,
                    update_rel_l2_max=upd,
                    bounds={"loss_rel": DP_LOSS_REL,
                            "update_rel_l2": DP_UPDATE_REL})
        del ref, one
        check(loss_rel <= DP_LOSS_REL and upd <= DP_UPDATE_REL,
              "train-dp-b-f32: f32 apart from one process")
    free_host(torch)
    line["seconds"] = time.perf_counter() - t0
    done("train-dp-f32", line)


def state_tensors(torch, state):
    """Every tensor of a train state on the host: the pinned rows as they
    are (a step never writes its inputs), the device's as copies."""
    from repro_torch.core.tree import tree_leaves
    torch.cuda.synchronize()
    return [a if a.device.type == "cpu" else a.to("cpu") for a in
            tree_leaves((state.params, state.opt_state))]


def checkpoint_phase(torch, engines, ExecutionConfig, knobs, bert,
                     SyntheticLM, DataConfig, adam, make_schedule, bridge,
                     tree_leaves, dev):
    """bert-large at full width and depth 2 (the identity phase's model)
    under l2l-p with pinned rows: 2 steps, Engine.save from the pinned
    rows, restore into a fresh engine, 2 more steps; losses, final params
    and Adam slots against an uninterrupted 4-step run, bit for bit."""
    import numpy as np
    import shutil
    B, S, UB = 8, 512, 2
    cfg = bert.replace(n_layers=2)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=2))
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()} for i in range(4)]

    def make():
        return engines.create("l2l-p", cfg, ExecutionConfig(
            n_microbatches=UB, **knobs), optimizer=adam(
                schedule=make_schedule(1e-4, warmup=10)))

    def run(eng, state, steps):
        losses = []
        for i in steps:
            state, m = eng.train_step(state, batches[i])
            losses.append(float(m["loss"]))
        return state, losses

    def leaves(state):
        p, o, step, _ = bridge.train_state_to_numpy(state)
        return tree_leaves(p) + tree_leaves(o), step

    ea = make()
    want, want_losses = run(ea, ea.init(torch.Generator(dev).manual_seed(9)),
                            range(4))
    want_leaves, want_step = leaves(want)
    del want
    free_host(torch)
    eb = make()
    half, losses = run(eb, eb.init(torch.Generator(dev).manual_seed(9)),
                       range(2))
    assert half.params["groups"][0].segs["float32"].is_pinned()
    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    t0 = time.perf_counter()
    path = eb.save(str(ckdir), half)
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    del eb, half
    free_host(torch)
    ec = make()
    t0 = time.perf_counter()
    back, step = ec.restore(str(ckdir))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    assert step == 2 and back.params["groups"][0].segs["float32"].is_pinned()
    final, more = run(ec, back, range(2, 4))
    got_leaves, got_step = leaves(final)
    shutil.rmtree(ckdir, ignore_errors=True)
    out = {"phase": "checkpoint", "arch": bert.name, "depth": 2,
           "batch": B, "seq": S, "microbatches": UB, "knobs": knobs,
           "snapshot_bytes": nbytes, "save_s": save_s,
           "restore_s": restore_s,
           "save_GBps": nbytes / save_s / 1e9,
           "restore_GBps": nbytes / restore_s / 1e9,
           "losses_uninterrupted": want_losses,
           "losses_resumed": losses + more,
           "leaves": len(got_leaves)}
    out["bitwise"] = (want_losses == losses + more and got_step == want_step
                      and len(got_leaves) == len(want_leaves) and all(
                          a.dtype == b.dtype and a.tobytes() == b.tobytes()
                          for a, b in zip(got_leaves, want_leaves)))
    assert out["bitwise"], out
    del ec, back, final
    free_host(torch)
    return out


def backward_device_ms(torch, F, dev, fa, rows, gqa):
    """SDPA backward's device time and K3a's and K3b's own, each by
    ``device_ms`` on fresh inputs: at the K3a and K3b rows' shape (their
    ``library_ms`` and ``profiled_ms``) and at the GQA shape of ``gqa``
    (``k3_gqa_check``'s result, which gains the same keys).  With kv heads
    fewer than q heads, SDPA gets them repeated inside the autograd graph,
    so its backward also sums dk and dv over each group, as K3b does."""
    def measure(B, S, H, Hkv, D, window=0):
        g = torch.Generator(dev).manual_seed(11)
        q, do = (torch.randn(B, S, H, D, generator=g, device=dev)
                 .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
        k, v = (torch.randn(B, S, Hkv, D, generator=g, device=dev)
                .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
        o, lse = fa.flash_attention_fwd_bhsd(q, k, v, causal=True,
                                             window=window)
        delta = (do.float() * o.float()).sum(-1).contiguous()
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        ke, ve = (ks, vs) if Hkv == H else (
            t.repeat_interleave(H // Hkv, dim=1) for t in (ks, vs))
        ref_o = F.scaled_dot_product_attention(qs, ke, ve, is_causal=True)
        res = {"shape": [B, S, H, D], "kv_heads": Hkv,
               "sdpa_backward_device_ms": device_ms(
                   torch, lambda: torch.autograd.grad(
                       ref_o, (qs, ks, vs), do, retain_graph=True), 20)}
        for kern in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
            res[kern.__name__ + "_device_ms"] = device_ms(
                torch, lambda kern=kern: kern(q, k, v, do, lse, delta,
                                              causal=True, window=window), 20)
        return res

    B, S, H, D = next(r["shape"] for r in rows
                      if r["name"] == "flash_attention_bwd_dq")
    out = {"phase": "library", **measure(B, S, H, H, D)}
    k3 = [r for r in rows if r["name"] in ("flash_attention_bwd_dq",
                                           "flash_attention_bwd_dkv")]
    for r in k3:
        if "cell" not in r:
            r["library_ms"] = out["sdpa_backward_device_ms"]
            r["profiled_ms"] = out[r["name"] + "_device_ms"]
    # hymba's microbatch (GQA 25 over 5; its 2048 window covers S = 512,
    # so SDPA's causal mask is the same mask), internvl2's (GQA 14 over
    # 2, S = 768) and both model ranks' shapes (bert-large's 8 heads,
    # internvl2's 7 over 1)
    for cell, key in (("hymba train microbatch", "hymba"),
                      ("internvl2 train microbatch", "internvl2"),
                      (TP_K3_CELL, "bert_large_per_model_rank"),
                      (TP_VLM_K3_CELL, "internvl2_per_model_rank")):
        cr = [r for r in k3 if r.get("cell") == cell]
        B, S, H, D = cr[0]["shape"]
        assert cr[0]["window"] == 0 or cr[0]["window"] >= S
        out[key] = measure(B, S, H, cr[0]["kv_heads"], D, cr[0]["window"])
        for r in cr:
            r["library_ms"] = out[key]["sdpa_backward_device_ms"]
            r["profiled_ms"] = out[key][r["name"] + "_device_ms"]
            r["library_covers"] = ("SDPA backward over the kv heads "
                                   "repeated: dq, dk and dv")
    B, S, H, D = gqa["shape"]
    out["gqa"] = measure(B, S, H, gqa["kv_heads"], D)
    gqa["library_ms"] = out["gqa"]["sdpa_backward_device_ms"]
    gqa["library_covers"] = ("SDPA backward over the kv heads repeated: "
                             "dq, dk and dv")
    return out


def scan_profile(torch, ssm, get_config, dev):
    """After the timed phases: one layer's sequence scan of each recurrent
    family at the 2 x 2048 prefill's shape (``scan_fn``) under
    torch.profiler: its device time (the summed spans), the device
    operations it launched, and the wall time of the call."""
    from torch.profiler import ProfilerActivity, profile
    out = {"phase": "scan-profile"}
    for arch in RECURRENT_ARCHS:
        fn, info = scan_fn(torch, ssm, get_config(arch, "full"), 2, 2048,
                           dev)
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        out[arch] = {**info, "device_ms": sum(spans) / 1e3,
                     "device_launches": len(spans), "wall_ms": wall * 1e3}
        del fn
    return out


def recurrent_profiles(torch, engines, ExecutionConfig, knobs, get_config,
                       SyntheticLM, DataConfig, adam, make_schedule, dev):
    """After the timed phases: one l2l-p step of each recurrent family at
    full width and depth 1, with train-recurrent's knobs and batch, under
    torch.profiler (``profile_step``, after one step unprofiled): the
    device's idle share of the step and its time by kernel.  (Depth 1: the
    host's processing of rwkv6's profile, ~8200 launches a layer and
    microbatch, grows with depth.)"""
    out = {"phase": "recurrent-profile", "depth": 1}
    for arch in RECURRENT_ARCHS:
        cfg = get_config(arch, "full").replace(n_layers=1, use_pallas=True)
        eng = engines.create("l2l-p", cfg, ExecutionConfig(
            n_microbatches=2, **knobs), optimizer=adam(
                schedule=make_schedule(1e-4, warmup=10)))
        state = eng.init(torch.Generator(dev).manual_seed(0))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
            DataConfig(vocab_size=cfg.vocab_size, seq_len=512,
                       global_batch=8, seed=0)).batch(0).items()}
        state, m = eng.train_step(state, batch)
        float(m["loss"])
        out[arch] = profile_step(torch, eng, state, batch)
        del eng, state, m
        free_host(torch)
    return out


def profile_step(torch, eng, state, batch):
    """One more step under torch.profiler (after the counted ones): the
    device's busy share of the wall time (the union of kernel and copy
    intervals on any stream) and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = eng.train_step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda t: -t[1])
    return {"wall_s": wall, "device_busy_s": busy / 1e6,
            "device_idle_share": 1.0 - busy / 1e6 / wall,
            "device_events": len(spans),
            "top_device_ms": [{"name": k[:80], "ms": ms, "count": c}
                              for k, ms, c in by_name[:14]],
            "attention_device_ms": [{"name": k[:80], "ms": ms, "count": c}
                                    for k, ms, c in by_name
                                    if "::fa_" in k],
            "device_ms_total": sum(ms for _, ms, _ in by_name)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=0,
                    help="layers to serve (0 = all that the host can pin)")
    ap.add_argument("--tp-rank", action="store_true",
                    help="run one rank of the tp phase (started by the "
                         "phase itself under torch.distributed.run)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tp_rank:
        return tp_rank(np, torch)
    import torch.nn.functional as F

    from repro_torch import bridge
    from repro_torch import engine as engines
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import (DataConfig, SyntheticLM,
                                            add_modality_stubs)
    from repro_torch.kernels import fused_adam as fadam
    from repro_torch.optim import adam, make_schedule
    from repro_torch.core.schedule import ExecutionConfig
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import host_alloc as ha
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import relay_copy as rc
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.core import packing
    from repro_torch.core.decode import init_caches
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import ssm
    from repro_torch.models.common import is_spec
    from repro_torch.models.model import LayeredModel
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.sampling import sample_batch

    dev = torch.device("cuda")
    report = {}

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    build.library()
    ptxas = []
    for log in sorted(build.BUILD_DIR.glob("*.ptxas.log")):
        ptxas += [ln.strip() for ln in log.read_text().splitlines()
                  if "registers" in ln or "spill" in ln]
    report["build"] = {"phase": "build",
                       "seconds": round(time.perf_counter() - t0, 3),
                       "ptxas": ptxas}
    emit(report["build"])
    # the wgmma kernels: ptxas's registers and spills, the shared memory
    # they launch with, and the tensor-core instructions in their SASS
    sm90 = build.kernel_report()
    report["sm90"] = {"phase": "sm90-kernels", "kernels": {
        n: {k: v for k, v in r.items() if k != "symbol"}
        for n, r in sm90.items()}}
    emit(report["sm90"])
    assert len(sm90) == 9 and all(
        r["hgmma"] > 0 and r["spill_store_bytes"] == 0
        and r["spill_load_bytes"] == 0 for r in sm90.values()), sm90

    exec_cfg = ExecutionConfig(weight_stream=True, pack_params=True,
                               prefetch_depth=1, transport="pallas")

    # ----------------------------------------------------------------- init
    full = get_config("granite-3-8b", "full")
    cfg = full.replace(use_pallas=True)
    specs = LayeredModel(full).param_specs()
    layer_elems = sum(math.prod(sp.shape[1:]) for sp in
                      tree_leaves(specs["groups"][0], is_leaf=is_spec))
    model_bytes = 4 * sum(math.prod(sp.shape)
                          for sp in tree_leaves(specs, is_leaf=is_spec))
    layer_bytes = layer_elems * 4
    depth = args.depth or host_depth(layer_bytes, full.n_layers,
                                     reserve=24 * 2 ** 30)
    cfg = cfg.replace(n_layers=depth)
    eng = engines.create("l2l", cfg, exec_cfg)
    t0 = time.perf_counter()
    params = eng.init_params(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    eps = params["groups"][0].segs["float32"]
    report["init"] = {
        "phase": "init", "arch": full.name, "depth": depth,
        "full_depth": full.n_layers, "d_model": cfg.d_model,
        "d_ff": cfg.d_ff, "layer_elems": layer_elems,
        "eps_shape": list(eps.shape), "eps_pinned": eps.is_pinned(),
        "model_param_bytes_full_depth": model_bytes,
        "seconds": round(time.perf_counter() - t0, 3)}
    assert eps.is_pinned() and eps.shape[1] == layer_elems
    emit(report["init"])

    # -------------------------------------------------------------- kernels
    g = torch.Generator(dev).manual_seed(7)
    rows = []

    # K4: one packed f32 granite layer row out of the pinned EPS by the line
    # loop on LINE_BLOCKS blocks, the TMA kernel over every SM it replaced
    # (previous_ms) and copy_, in turns on the same buffers
    start = min(1, depth - 1)
    got = rc.copy_rows(eps, start, size=1, device=dev)
    old = rc.copy_rows(eps, start, size=1, device=dev, route="tma_tiles")
    plain = ref.ref_copy_rows(eps, start, 1, device=dev)
    torch.cuda.synchronize()
    assert torch.equal(got, plain) and torch.equal(old, plain), \
        "relay_copy is not bit-exact"
    slot = torch.empty_like(plain)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ms, prev_ms, lib_ms = rotation(torch, (
        lambda: rc.copy_rows(eps, start, size=1, device=dev, out=slot),
        lambda: rc.copy_rows(eps, start, size=1, device=dev, out=slot,
                             route="tma_tiles"),
        lambda: slot.copy_(eps[start:start + 1], non_blocking=True)), 5,
        timer=time_ms)
    k4 = {"name": "relay_copy", "route": "cuda",
          "kernel_route": rc.FETCH_ROUTE, "previous_route": "tma_tiles",
          "source": "src/repro_torch/kernels/csrc/relay_copy.cu",
          "replaces": "src/repro/kernels/relay_copy.py:58",
          "shape": [1, layer_elems], "dtype": "float32",
          "host_alloc": "pinned (torch.empty(pin_memory=True))",
          "grid_blocks": rc.LINE_BLOCKS, "previous_grid_blocks": sms,
          "max_abs_err": float((got - plain).abs().max()),
          "ms": ms, "previous_ms": prev_ms, "library_ms": lib_ms,
          "timing": "ms, previous_ms, library_ms (copy_): back-to-back "
                    "calls, in turns on the same buffers",
          "plain_ms": time_ms(torch, lambda: ref.ref_copy_rows(
              eps, start, 1, device=dev), 5),
          "bound_ms": layer_bytes / PCIE5_X16_BPS * 1e3, "bound_by": "bytes",
          "achieved_GBps": layer_bytes / ms / 1e6,
          "previous_GBps": layer_bytes / prev_ms / 1e6,
          "library_GBps": layer_bytes / lib_ms / 1e6}
    assert torch.equal(slot, plain), "relay_copy is not bit-exact"
    k4["checks"] = k4_checks(torch, rc, ha, dev)
    rows.append(k4)
    del got, old, plain, slot

    # K5: decode rows and prefill rows of granite, bf16, f32 scale: the
    # CUDA kernel, the Triton kernel it replaced and F.rms_norm in turns,
    # from a CUDA graph (device time) and eagerly (the host's launch path
    # included, which is what a decode step pays), and the 8 slots x 64
    # rows of a serve-continuous tick; then qwen1.5-110b's
    # d 8192 as serve-dense gives it: the decode rows and the 4 x 16 prompt
    # rows in bf16, and the prompt rows in f32 (32 KB rows, the kernel's
    # widest), the depth-1 check's dtype; then deepseek-v2-lite's at the
    # serve-moe prefill's 2 x 2048 rows: MLA's kv_norm (width 512) and the
    # block norms (2048); then hymba-1.5b's width 1600 at its decode rows
    # and its 2 x 2048 prefill's.  bf16 within one bf16 ulp of the
    # plain version; f32 within 1e-5 of its largest value (the sums run in
    # another order)
    qwen = get_config("qwen1.5-110b", "full")
    moe_cfg = get_config(MOE_ARCH, "full")
    hymba = get_config("hymba-1.5b", "full")
    vlm_cfg = get_config(VLM_ARCH, "full")
    grok = get_config(GROK_ARCH, "full")
    for R, d, dt in ((4, cfg.d_model, torch.bfloat16),
                     (4 * 2048, cfg.d_model, torch.bfloat16),
                     (CROWD["max_batch"] * CROWD["prefill_chunk"],
                      cfg.d_model, torch.bfloat16),
                     (4, qwen.d_model, torch.bfloat16),
                     (4 * 16, qwen.d_model, torch.bfloat16),
                     (4 * 16, qwen.d_model, torch.float32),
                     (2 * 2048, moe_cfg.kv_lora_rank, torch.bfloat16),
                     (2 * 2048, moe_cfg.d_model, torch.bfloat16),
                     (4, hymba.d_model, torch.bfloat16),
                     (2 * 2048, hymba.d_model, torch.bfloat16),
                     (4, vlm_cfg.d_model, torch.bfloat16),
                     (2 * (VLM_PREFILL + vlm_cfg.n_patches), vlm_cfg.d_model,
                      torch.bfloat16),
                     (4, grok.d_model, torch.bfloat16),
                     (2 * 2048, grok.d_model, torch.bfloat16)):
        scale = 1.0 + 0.1 * torch.randn(d, generator=g, device=dev)
        wb = scale.to(dt)
        x = torch.randn(R, d, generator=g, device=dev).to(dt)
        got = rms.rmsnorm_2d(x, scale, eps=cfg.norm_eps)
        old = rms.rmsnorm_2d(x, scale, eps=cfg.norm_eps, route="triton")
        plain = rms.rmsnorm_2d_plain(x, scale, eps=cfg.norm_eps)
        torch.cuda.synchronize()
        for out_, what in ((got, "rmsnorm"), (old, "triton rmsnorm")):
            if dt == torch.bfloat16:
                assert bf16_ulp_ok(torch, out_, plain), \
                    f"{what} ({R}, {d}) beyond 1 bf16 ulp"
            else:
                assert float((out_ - plain).abs().max()) <= \
                    1e-5 * float(plain.abs().max()), f"{what} ({R}, {d}) f32"
        nbytes = 2 * R * d * x.element_size() + d * 4
        fns = (lambda: rms.rmsnorm_2d(x, scale, eps=cfg.norm_eps),
               lambda: rms.rmsnorm_2d(x, scale, eps=cfg.norm_eps,
                                      route="triton"),
               lambda: F.rms_norm(x, (d,), wb, cfg.norm_eps))
        ms, prev_ms, lib_ms = rotation(torch, fns, 50)
        eager, prev_eager, lib_eager = rotation(torch, fns, 50, time_ms)
        rows.append({
            "name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:17",
            "shape": [R, d], "dtype": str(dt).replace("torch.", ""),
            "max_abs_err": float((got.float() - plain.float()).abs().max()),
            "previous_max_abs_err": float((old.float() - plain.float())
                                          .abs().max()),
            "ms": ms, "previous_ms": prev_ms, "library_ms": lib_ms,
            "eager_ms": eager, "previous_eager_ms": prev_eager,
            "library_eager_ms": lib_eager,
            "timing": "ms, previous_ms (the Triton kernel), library_ms "
                      "(F.rms_norm, weight in x's dtype): a CUDA graph of "
                      "the calls; eager_ms, previous_eager_ms, "
                      "library_eager_ms, plain_ms: back-to-back eager "
                      "calls; each set in turns",
            "plain_ms": time_ms(torch, lambda: rms.rmsnorm_2d_plain(
                x, scale, eps=cfg.norm_eps), 50),
            "bound_ms": nbytes / H100_HBM_BPS * 1e3, "bound_by": "bytes"})

    # K2 as the paths call it: kernels.ops.flash_attention on the model's
    # (B, S, H, D) layout, read and written through strides: at granite's
    # GQA heads (32 q, 8 kv, D 128), the B=2, S=2048 prefill and the serve
    # phase's 4 prompts of 16 tokens; at bert-large's (16 heads of 64), one
    # training microbatch (B=8, S=512).  bf16 (the paths' dtype: the wgmma
    # kernel, timed in turns with the CUDA-core kernel bf16 took before) and
    # f32 (the CUDA-core kernel).  lse comes from the same strided call.
    # Then the dense models' heads: chatglm3-6b's (32 q over 2 kv, a GQA
    # group of 16) at a train-rmsnorm microbatch (B=4, S=512) and at
    # serve-dense's prompts, and command-r-35b's and qwen1.5-110b's (64 over
    # 8, D 128, the same for both) at serve-dense's prompts.
    bert_cfg = get_config("bert-large", "full")
    glm = get_config("chatglm3-6b", "full")
    cr = get_config("command-r-35b", "full")
    assert (cr.n_heads, cr.n_kv_heads, cr.d_head) == \
        (qwen.n_heads, qwen.n_kv_heads, qwen.d_head)
    for B_, S, H, Hkv, Dh in (
            (2, 2048, cfg.n_heads, cfg.n_kv_heads, cfg.d_head),
            (4, 16, cfg.n_heads, cfg.n_kv_heads, cfg.d_head),
            (8, 512, bert_cfg.n_heads, bert_cfg.n_heads, bert_cfg.d_head),
            (4, 512, glm.n_heads, glm.n_kv_heads, glm.d_head),
            (4, 16, glm.n_heads, glm.n_kv_heads, glm.d_head),
            (4, 16, qwen.n_heads, qwen.n_kv_heads, qwen.d_head)):
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            q = torch.randn(B_, S, H, Dh, generator=g, device=dev).to(dt)
            k = torch.randn(B_, S, Hkv, Dh, generator=g, device=dev).to(dt)
            v = torch.randn(B_, S, Hkv, Dh, generator=g, device=dev).to(dt)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            o = kops.flash_attention(q, k, v, causal=True)
            lse = fa.flash_attention_fwd_bhsd(qt, kt, vt, causal=True)[1]
            po, plse = fa.flash_attention_fwd_bhsd_plain(qt, kt, vt,
                                                         causal=True)
            po = po.transpose(1, 2)
            torch.cuda.synchronize()
            assert o.shape == q.shape and not qt.is_contiguous()
            err = float((o.float() - po.float()).abs().max())
            lerr = float((lse - plse).abs().max())
            assert err <= tol and lerr <= tol, \
                f"flash attention B={B_} S={S} {dt}: o err {err}, lse {lerr}"
            if dt != torch.bfloat16:
                continue
            ke = kt.repeat_interleave(H // Hkv, dim=1)
            ve = vt.repeat_interleave(H // Hkv, dim=1)
            lib_o = F.scaled_dot_product_attention(qt, ke, ve, is_causal=True)
            emu_o, _ = ref.ref_attention(qt, kt, vt, causal=True,
                                         tensor_cores=True)
            ops = 4 * B_ * H * Dh * (S * (S + 1) // 2)
            nbytes = (2 * q.numel() + 2 * k.numel()) * 2 + lse.numel() * 4
            reps = 20 if S > 256 else 50
            fns = (lambda: fa.flash_attention_fwd_bhsd(qt, kt, vt,
                                                       causal=True),
                   lambda: fa.flash_attention_fwd_bhsd(
                       qt, kt, vt, causal=True, route="cuda_core"))
            ms, prev_ms = rotation(torch, fns, reps)
            eager_ms, prev_eager_ms = rotation(torch, fns, reps, time_ms)
            rows.append({
                "name": "flash_attention_fwd", "route": "cuda",
                "kernel_route": "wgmma",
                "source": "src/repro_torch/kernels/csrc/"
                          "flash_attention_sm90.cu",
                "replaces": "src/repro/kernels/flash_attention.py:46",
                "shape": [B_, S, H, Dh], "layout": "BSHD", "kv_heads": Hkv,
                "dtype": "bfloat16",
                "max_abs_err": err, "lse_max_abs_err": lerr,
                "emulation_err": float((o.float() - emu_o.transpose(1, 2)
                                        .float()).abs().max()),
                "ms": ms, "previous_ms": prev_ms,
                "plain_ms": time_ms(torch, lambda: fa
                                    .flash_attention_fwd_bhsd_plain(
                                        qt, kt, vt, causal=True), reps),
                "library_ms": graph_ms(torch, lambda: F
                                       .scaled_dot_product_attention(
                                           qt, ke, ve, is_causal=True), reps),
                "library_err": float((lib_o.float() - po.transpose(1, 2)
                                      .float()).abs().max()),
                "timing": "ms, previous_ms, library_ms: a CUDA graph of "
                          "the calls; eager_ms, previous_eager_ms: "
                          "back-to-back eager calls, the host's issue time "
                          "included",
                "eager_ms": eager_ms, "previous_eager_ms": prev_eager_ms,
                "bound_ms": max(ops / H100_BF16_OPS,
                                nbytes / H100_HBM_BPS) * 1e3,
                "bound_by": ("operations" if ops / H100_BF16_OPS
                             > nbytes / H100_HBM_BPS else "bytes")})
    del q, k, v, qt, kt, vt, o, lse, po, plse, ke, ve, x, got, old, plain, \
        lib_o, emu_o, fns
    rows += train_kernel_rows(torch, F, dev, g, fa, fadam, kops, rc, ref,
                              get_config, LayeredModel, tree_leaves, is_spec)
    # hymba's attention: K2 at its window prefill, K3a and K3b at its
    # training microbatch (GQA 25 over 5, window 2048); internvl2's: K2 at
    # the serve-vlm prefill (2 x 2048 tokens behind 256 patches), K3a and
    # K3b at the train-vlm microbatch (4 x 512 tokens behind 256 patches;
    # GQA 14 over 2)
    rows += gqa_attention_rows(torch, F, dev, g, fa, kops, ref, hymba,
                               (1, 4096), (4, 512),
                               ("hymba window prefill",
                                "hymba train microbatch"))
    rows += gqa_attention_rows(
        torch, F, dev, g, fa, kops, ref, vlm_cfg,
        (2, VLM_PREFILL + vlm_cfg.n_patches),
        (VLM_TRAIN["batch"] // VLM_TRAIN["ub"],
         VLM_TRAIN["seq"] + vlm_cfg.n_patches),
        ("internvl2 prefill", "internvl2 train microbatch"))
    # grok-1's prefill (2 x 2048, GQA 48 over 8, D 128; served, not
    # trained), then the f32 routes of K2, K3a and K3b
    rows += gqa_attention_rows(torch, F, dev, g, fa, kops, ref, grok,
                               (2, 2048), None, ("grok-1 prefill",))
    # the model axis's per-rank shapes (tp phase): bert-large's training
    # microbatch over 8 of its 16 heads, granite-3-8b's prompts over 16 of
    # its 32 q heads and 4 of its 8 kv heads
    bert_full = get_config("bert-large", "full")
    rows += gqa_attention_rows(
        torch, F, dev, g, fa, kops, ref,
        bert_full.replace(n_heads=bert_full.n_heads // TP_RANKS,
                          n_kv_heads=bert_full.n_kv_heads // TP_RANKS),
        (8, 512), (8, 512), ("bert-large microbatch per model rank",
                             TP_K3_CELL))
    rows += gqa_attention_rows(
        torch, F, dev, g, fa, kops, ref,
        full.replace(n_heads=full.n_heads // TP_RANKS,
                     n_kv_heads=full.n_kv_heads // TP_RANKS),
        (TP_SERVE["batch"], TP_SERVE["prompt"]), None,
        ("granite-3-8b prompts per model rank",))
    # internvl2 on a model rank (train-vlm-tp): 7 of its 14 q heads over 1
    # of its 2 kv heads (GQA 7 over a single kv head), K2 at the serve-vlm
    # prefill, K3a and K3b at the train-vlm microbatch
    rows += gqa_attention_rows(
        torch, F, dev, g, fa, kops, ref,
        vlm_cfg.replace(n_heads=vlm_cfg.n_heads // TP_RANKS,
                        n_kv_heads=vlm_cfg.n_kv_heads // TP_RANKS),
        (2, VLM_PREFILL + vlm_cfg.n_patches),
        (VLM_TRAIN["batch"] // VLM_TRAIN["ub"],
         VLM_TRAIN["seq"] + vlm_cfg.n_patches),
        ("internvl2 prefill per model rank", TP_VLM_K3_CELL))
    rows += f32_attention_rows(torch, F, dev, g, fa)
    # K4 at the modality families' rows: an internvl2 layer (59.6 MB f32)
    # and whisper's encoder and decoder layers (12.6 / 16.8 MB), each
    # way, against copy_
    rows += modality_k4_rows(torch, dev, g, rc, ref, get_config,
                             LayeredModel, tree_leaves, is_spec)
    # K4 at one model rank's layer rows: bert-large's, granite-3-8b's,
    # hymba-1.5b's, rwkv6-1.6b's, deepseek-v2-lite's MoE layer (32 of
    # its 64 experts), internvl2's and whisper's encoder and decoder
    # layers
    rows += k4_rows(torch, dev, g, rc, ref, [
        (f"{c.name} layer per model rank", tp_layer_bytes(
            c, TP_RANKS, LayeredModel, tree_leaves, is_spec))
        for c in (bert_full, full, get_config("hymba-1.5b", "full"),
                  get_config("rwkv6-1.6b", "full"))] + [
        ("deepseek-v2-lite-16b MoE layer per model rank", tp_layer_bytes(
            moe_cfg, TP_RANKS, LayeredModel, tree_leaves, is_spec, 1))] + [
        (f"{c.name} {gr.name + ' ' if gr.name != 'layers' else ''}"
         "layer per model rank", tp_layer_bytes(
            c, TP_RANKS, LayeredModel, tree_leaves, is_spec, gi))
        for c in (vlm_cfg, get_config(AUDIO_ARCH, "full"))
        for gi, gr in enumerate(LayeredModel(c).groups)])
    torch.cuda.empty_cache()
    report["kernels"] = {"phase": "kernels", "rows": rows}
    emit(report["kernels"])

    # ------------------------------------------------------------- k4-sweep
    wb_bytes = next(r["shape"][1] * 4 for r in rows
                    if r["name"] == "relay_copy_writeback")
    t0 = time.perf_counter()
    report["k4_sweep"] = k4_sweep(torch, rc, ha, build, dev, layer_bytes,
                                  wb_bytes, SWEEP_KINDS, *k4_arms(rc))
    report["k4_sweep"]["seconds"] = time.perf_counter() - t0
    emit(report["k4_sweep"])

    # one decode layer's compute at the serve shape, its slot already in
    # HBM: what the relay has to hide behind each row copy
    with torch.inference_mode():
        slot = rc.copy_rows(eps, 0, size=1, device=dev)[0]
        w0 = packing.unpack(packing.Packed({"float32": slot},
                                           params["groups"][0].spec))
        cache0 = {k: v[0] for k, v in
                  init_caches(eng.model, 4, 24, device=dev)[0].items()}
        x0 = torch.randn(4, 1, cfg.d_model, generator=g,
                         device=dev).to(torch.bfloat16)
        ctx0 = eng.model.decode_ctx(3)
        layer = eng.model.groups[0].decode
        row_ms = [time_ms(torch, lambda r=r: rc.copy_rows(
            eps, r, size=1, device=dev, out=slot[None]), 1, warmup=0)
            for r in range(depth)]
        report["layer"] = {
            "phase": "layer", "shape": [4, 1, cfg.d_model],
            "decode_layer_ms": time_ms(torch, lambda: layer(
                w0, x0, cache0, None, ctx0), 10),
            "row_copy_ms": {"min": min(row_ms), "max": max(row_ms),
                            "mean": sum(row_ms) / len(row_ms)}}
        # one prefill layer (B=2 x 2048 tokens) alone (warm), then three
        # beside four row fetches on a second stream by the relay's route,
        # by the one it replaced and by copy_ (the copy engine), in turns:
        # what the fetch costs the layer it hides
        xp = torch.randn(2, 2048, cfg.d_model, generator=g,
                         device=dev).to(torch.bfloat16)
        ctxp = eng.model.train_ctx(
            {"tokens": torch.zeros(2, 2048, dtype=torch.long, device=dev)},
            eng.model.groups[0])
        apply = eng.model.groups[0].apply
        spare = torch.empty_like(slot)[None]
        side = torch.cuda.Stream(dev)

        def beside(route):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                ev[0].record()
                for r in range(4):
                    if route == "copy_":
                        spare.copy_(eps[r % depth:r % depth + 1],
                                    non_blocking=True)
                    else:
                        rc.copy_rows(eps, r % depth, size=1, out=spare,
                                     route=route)
                ev[1].record()
            ev[2].record()
            for _ in range(3):
                apply(w0, xp, None, ctxp)
            ev[3].record()
            torch.cuda.synchronize()
            return ev[2].elapsed_time(ev[3]) / 3, ev[0].elapsed_time(ev[1]) / 4

        alone = time_ms(torch, lambda: apply(w0, xp, None, ctxp), 3)
        routes_ = (rc.FETCH_ROUTE, "tma_tiles", "copy_")
        runs = {r: [] for r in routes_}
        for r in routes_ + routes_[::-1]:
            runs[r].append(beside(r))
        report["layer"]["prefill_layer"] = {
            "shape": [2, 2048, cfg.d_model], "alone_ms": alone,
            "beside_fetch_ms": {r: sum(v[0] for v in runs[r]) / 2
                                for r in routes_},
            "fetch_ms_beside_layers": {r: sum(v[1] for v in runs[r]) / 2
                                       for r in routes_}}
    emit(report["layer"])
    del slot, w0, cache0, xp, spare

    # ----------------------------------------------------------------- grid
    # the relay ring on the card: pack x prefetch x G (at a depth G=2 does
    # not divide) x where the stream rests, all bitwise equal to the plain
    # schedule (deterministic kernels, the same ops per layer)
    small = get_config("granite-3-8b", "smoke").replace(
        n_layers=3, use_pallas=True)
    base_eng = engines.create("l2l", small, ExecutionConfig())
    sp = base_eng.model.init_params(torch.Generator(dev).manual_seed(3),
                                    device=dev)
    sprompt = torch.randint(0, small.vocab_size, (2, 8), device=dev,
                            generator=torch.Generator(dev).manual_seed(4))

    def greedy(e):
        caches, lg = e.decode_init(sp, sprompt, 11)
        outs = [lg]
        for i in range(3):
            lg, caches = e.decode_step(
                sp, caches, outs[-1].argmax(-1)[:, None], 8 + i)
            outs.append(lg[:, -1])
        outs.append(e.prefill(sp, {"tokens": sprompt}))
        return outs

    want = greedy(base_eng)
    combos = [dict(weight_stream=True, pack_params=pk, prefetch_depth=k,
                   layers_per_relay=gr, transport="pallas")
              for pk in (False, True) for k in (0, 1) for gr in (1, 2)]
    combos += [dict(weight_stream=False, pack_params=True, prefetch_depth=1,
                    layers_per_relay=2, transport=t) for t in ("xla",
                                                               "pallas")]
    for kw in combos:
        got = greedy(engines.create("l2l", small, ExecutionConfig(**kw)))
        assert all(torch.equal(a, b) for a, b in zip(want, got)), kw
    report["grid"] = {"phase": "grid", "configs": len(combos) + 1,
                      "bitwise": True}
    emit(report["grid"])
    del sp

    # ---------------------------------------------------------------- serve
    counters = {"relay_copy": rc.copy_rows, "rmsnorm": rms.rmsnorm_2d,
                "flash_attention_fwd": fa.flash_attention_fwd_bhsd}
    reset_counts(counters.values())
    B, P, GEN = 4, 16, 8
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    caches, last = eng.decode_init(params, prompt, P + GEN)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tok = sample_batch(last)[:, None]
    out = [tok]
    fetches0 = rc.copy_rows.launches
    norms0 = rms.rmsnorm_2d.launches
    t_issue = 0.0
    t0 = time.perf_counter()
    for i in range(GEN):
        t1 = time.perf_counter()
        logits, caches = eng.decode_step(params, caches, tok, P + i)
        t_issue += time.perf_counter() - t1
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
        tok = sample_batch(logits[:, -1])[:, None]
        out.append(tok)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    toks = torch.cat(out, dim=1)
    assert toks.shape == (B, GEN + 1) and bool(((toks >= 0) &
                                                (toks < cfg.vocab_size)).all())
    relay_bytes = (rc.copy_rows.launches - fetches0) * layer_bytes
    report["serve"] = {
        "phase": "serve", "engine": "l2l", "batch": B, "prompt": P,
        "steps": GEN, "depth": depth, "tokens": toks.tolist(),
        "decode_init_s": t_init, "decode_s": t_dec,
        "tok_per_s": B * GEN / t_dec,
        "relay_GBps": relay_bytes / t_dec / 1e9,
        "relay_fetches_per_step": (rc.copy_rows.launches - fetches0) / GEN,
        "rmsnorm_per_step": (rms.rmsnorm_2d.launches - norms0) / GEN,
        "ms_per_fetch": t_dec * 1e3 / (rc.copy_rows.launches - fetches0),
        "host_issue_s": t_issue,
        "peak_device_bytes": peak,
        "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
        "reserved_at_start_bytes": reserved0,
        "model_param_bytes": model_bytes,
        "peak_over_model": peak / model_bytes}
    emit(report["serve"])
    assert peak < 0.25 * model_bytes, "device footprint above 25% of the model"

    # -------------------------------------------------------------- prefill
    before = {n: c.launches for n, c in counters.items()}
    t0 = time.perf_counter()
    pl = eng.prefill(params, {"tokens": prompt})
    torch.cuda.synchronize()
    t_pf = time.perf_counter() - t0
    per_prefill = {n: c.launches - before[n] for n, c in counters.items()}
    diff = (pl.float() - last.float())
    rel = float(diff.norm() / last.float().norm())
    agree = int((pl.argmax(-1) == last.argmax(-1)).sum())
    long = torch.randint(0, cfg.vocab_size, (2, 2048), device=dev,
                         generator=torch.Generator(dev).manual_seed(2))
    t0 = time.perf_counter()
    pl2 = eng.prefill(params, {"tokens": long})
    torch.cuda.synchronize()
    t_pf2 = time.perf_counter() - t0
    # the main path ends here: its launch counts, before the comparisons
    # below run more engines on the same kernels
    launches = {n: c.launches for n, c in counters.items()}
    serve_routes = route_counts(counters)
    report["prefill"] = {
        "phase": "prefill", "shape_16": list(pl.shape), "seconds_16": t_pf,
        "launches_per_prefill": per_prefill,
        "max_abs_vs_decode_init": float(diff.abs().max()),
        "max_abs_logit": float(last.float().abs().max()),
        "argmax_agree": agree,
        "shape_2048": list(pl2.shape), "seconds_2048": t_pf2,
        "prefill_tok_per_s_2048": 2 * 2048 / t_pf2}
    # prefill against decode_init at depth 1 and at full depth, in f32 (the
    # flash and RMSNorm kernels in their f32 paths) and bf16: the gap is
    # rounding noise that grows sub-linearly with depth (a wrong mask,
    # position or cache slot shows at depth 1 already, as O(1))
    def gap(d, dt):
        e = engines.create("l2l", cfg.replace(n_layers=d, dtype=dt), exec_cfg)
        sub = {**params, "groups": (packing.Packed(
            {"float32": eps[:d]}, params["groups"][0].spec),)}
        _, ref_last = e.decode_init(sub, prompt, P)
        got = e.prefill(sub, {"tokens": prompt})
        return float((got.float() - ref_last.float()).norm()
                     / ref_last.float().norm())

    gaps = {"f32_depth1": gap(1, "float32"), "bf16_depth1": gap(1, "bfloat16"),
            "f32_full": gap(depth, "float32"), "bf16_full": rel}
    report["prefill"]["rel_l2_vs_decode_init"] = gaps
    emit(report["prefill"])
    # bounds: f32 1e-4 at depth 1 (measured 8e-6) and 1e-3 at full depth
    # (1.2e-4); bf16 0.35 at full depth (0.138; uncorrelated logits ~1.4)
    # with the same top-1 token on all but at most one row
    assert gaps["f32_depth1"] <= 1e-4 and gaps["f32_full"] <= 1e-3, gaps
    assert gaps["bf16_full"] <= 0.35 and agree >= B - 1, gaps
    assert pl2.shape == (2, cfg.vocab_size) and bool(torch.isfinite(pl2).all())

    serve_launches = launches
    emit({"launches": {"serve": serve_launches},
          "routes": {"serve": serve_routes}})
    assert all(n > 0 for n in serve_launches.values()), serve_launches
    # every bf16 K2 launch of the serving path took the wgmma route, every
    # K5 launch the CUDA kernel
    assert serve_routes["flash_attention_fwd"] == {
        "wgmma": serve_launches["flash_attention_fwd"], "cuda_core": 0}, \
        serve_routes
    assert serve_routes["rmsnorm"] == {
        "cuda": serve_launches["rmsnorm"], "triton": 0}, serve_routes
    # and every K4 fetch the relay's route
    assert serve_routes["relay_copy"] == {
        rc.FETCH_ROUTE: serve_launches["relay_copy"], "tma_tiles": 0,
        "words": 0}, serve_routes

    del caches, pl, pl2, last, logits
    serve_counters = counters
    counters = {"relay_copy": rc.copy_rows,
                "relay_copy_writeback": rc.writeback_rows,
                "rmsnorm": rms.rmsnorm_2d,
                "flash_attention_fwd": fa.flash_attention_fwd_bhsd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                "fused_adam": fadam.fused_adam_flat}
    bert = get_config("bert-large", "full").replace(use_pallas=True)
    slice_knobs = dict(weight_stream=True, pack_params=True,
                       prefetch_depth=1, transport="pallas",
                       offload_stash=True)

    # ----------------------------------------------------- serve-continuous
    # on the serve phase's pinned EPS (no second init of granite)
    t0 = time.perf_counter()
    report["serve_continuous"], cont_launches, cont_routes = \
        serve_continuous_phase(torch, np, engines, exec_cfg, cfg, params,
                               model_bytes, layer_bytes, packing,
                               ServeConfig, counters, dev)
    report["serve_continuous"]["phase_seconds"] = time.perf_counter() - t0

    # -------------------------------------------------------- dynamic-depth
    t0 = time.perf_counter()
    report["dynamic_depth"], dyn_launches, dyn_routes = dynamic_depth_phase(
        torch, engines, ExecutionConfig, exec_cfg, cfg, params, prompt,
        report["serve"]["tokens"], packing, sample_batch, bert, slice_knobs,
        SyntheticLM, DataConfig, adam, make_schedule, counters, dev)
    report["dynamic_depth"]["phase_seconds"] = time.perf_counter() - t0
    emit(report["dynamic_depth"])

    # the serving state goes before the next phases pin theirs
    del eng, params, eps
    free_host(torch)

    # ---------------------------------------------------------- serve-dense
    t0 = time.perf_counter()
    dense, dense_launches, dense_routes = serve_dense_phase(
        torch, engines, ExecutionConfig, exec_cfg, get_config, LayeredModel,
        tree_leaves, is_spec, packing, sample_batch, serve_counters, dev)
    report["serve_dense"] = {"phase": "serve-dense", "models": dense,
                             "seconds": time.perf_counter() - t0}

    def leaves_np(state):
        p, o, _, _ = bridge.train_state_to_numpy(state)
        return tree_leaves(p), tree_leaves(o)

    # ----------------------------------------------------------- train-grid
    # the training knobs on the card, at smoke size and a depth that G=2
    # and K=2 do not divide: every point bitwise equal to the plain
    # schedule (deterministic kernels; K1 equals the per-leaf chain)
    small_b = get_config("bert-large", "smoke").replace(n_layers=3,
                                                        use_pallas=True)
    gen = torch.Generator(dev).manual_seed(8)
    sbatch = {"tokens": torch.randint(0, small_b.vocab_size, (4, 64),
                                      generator=gen, device=dev),
              "targets": torch.randint(0, small_b.vocab_size, (4, 64),
                                       generator=gen, device=dev),
              "mask": torch.ones(4, 64, device=dev)}
    base_t = engines.create("l2l-p", small_b,
                            ExecutionConfig(n_microbatches=2))
    st0 = base_t.init(torch.Generator(dev).manual_seed(5))

    def train_once(e):
        new, m = e.train_step(st0, sbatch)
        return (float(m["loss"]),) + leaves_np(new)

    want = train_once(base_t)
    tcombos = [("l2l-p", dict(weight_stream=True, offload_stash=True,
                              transport="pallas", pack_params=pk,
                              prefetch_depth=k, layers_per_relay=gr,
                              stash_every=se))
               for pk in (False, True) for k in (0, 1) for gr in (1, 2)
               for se in (1, 2)]
    tcombos += [("l2l-p", dict(pack_params=True, prefetch_depth=1,
                               transport=t)) for t in ("xla", "pallas")]
    tcombos += [("l2l", dict(slice_knobs, stash_every=se)) for se in (1, 2)]
    tcombos += [("l2l", dict(prefetch_depth=1, layers_per_relay=2))]
    for name, kw in tcombos:
        got = train_once(engines.create(name, small_b, ExecutionConfig(
            n_microbatches=2, **kw)))
        assert got[0] == want[0] and \
            all(np.array_equal(a, b) for a, b in zip(got[1], want[1])) and \
            all(np.array_equal(a, b) for a, b in zip(got[2], want[2])), \
            (name, kw)
    report["train_grid"] = {"phase": "train-grid",
                            "configs": len(tcombos) + 1, "bitwise": True}
    emit(report["train_grid"])
    del st0, base_t

    # ------------------------------------------------------------- identity
    # L2L-p against Algorithm 2 at bert-large width, depth 2, f32: the
    # bounds of tests/test_equivalence.py (rel 1e-5)
    icfg = bert.replace(n_layers=2, dtype="float32")
    ibatch = SyntheticLM(DataConfig(vocab_size=bert.vocab_size, seq_len=512,
                                    global_batch=8, seed=1)).batch(0)
    be = engines.create("baseline", icfg, ExecutionConfig(n_microbatches=2))
    ist = be.init(torch.Generator(dev).manual_seed(6))
    nb, mb = be.train_step(ist, ibatch)
    le = engines.create("l2l-p", icfg, ExecutionConfig(n_microbatches=2,
                                                       **slice_knobs))
    nl, ml = le.train_step(ist, ibatch)
    pb, pl_ = leaves_np(nb)[0], leaves_np(nl)[0]
    rel_params = max(float(np.abs(a - b).max()) for a, b in zip(pl_, pb)) \
        / max(float(np.abs(b).max()) for b in pb)
    rel_loss = abs(float(ml["loss"]) - float(mb["loss"])) / float(mb["loss"])
    report["identity"] = {"phase": "identity", "depth": 2,
                          "loss_l2l_p": float(ml["loss"]),
                          "loss_baseline": float(mb["loss"]),
                          "loss_rel": rel_loss, "params_rel": rel_params}
    emit(report["identity"])
    assert rel_loss <= 1e-5 and rel_params <= 1e-5, report["identity"]
    del be, ist, nb, le, nl, pb, pl_
    gc.collect()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- checkpoint
    report["checkpoint"] = checkpoint_phase(
        torch, engines, ExecutionConfig, slice_knobs, bert, SyntheticLM,
        DataConfig, adam, make_schedule, bridge, tree_leaves, dev)
    emit(report["checkpoint"])

    # -------------------------------------------------------- train-rmsnorm
    report["train_rmsnorm"], rms_launches, rms_routes = train_rmsnorm_phase(
        torch, engines, ExecutionConfig, slice_knobs, get_config, SyntheticLM,
        DataConfig, adam, make_schedule, counters, kops, rms, fa, dev)
    emit(report["train_rmsnorm"])

    # ------------------------------------------------------------ serve-moe
    t0 = time.perf_counter()
    report["serve_moe"], smoe_launches, smoe_routes = serve_moe_phase(
        torch, np, engines, exec_cfg, get_config, LayeredModel, tree_leaves,
        is_spec, packing, rc, ServeConfig, sample_batch, counters, dev)
    report["serve_moe"]["phase_seconds"] = time.perf_counter() - t0

    # ------------------------------------------------------------ train-moe
    t0 = time.perf_counter()
    report["train_moe"], tmoe_launches, tmoe_routes = train_moe_phase(
        torch, np, engines, ExecutionConfig, slice_knobs, get_config,
        LayeredModel, tree_leaves, is_spec, SyntheticLM, DataConfig, adam,
        make_schedule, counters, dev)
    report["train_moe"]["phase_seconds"] = time.perf_counter() - t0
    emit({"phase": "moe-seconds",
          "serve_moe": report["serve_moe"]["phase_seconds"],
          "train_moe": report["train_moe"]["phase_seconds"]})

    # ------------------------------------------ serve- and train-recurrent
    rec_launches, rec_routes = {}, {}
    for arch in RECURRENT_ARCHS:
        key = arch.split("-")[0]
        t0 = time.perf_counter()
        line, rec_launches["serve-" + key], rec_routes["serve-" + key] = \
            serve_recurrent_phase(torch, np, engines, exec_cfg, arch,
                                  get_config, LayeredModel, tree_leaves,
                                  is_spec, packing, ssm, ServeConfig,
                                  sample_batch, counters, dev)
        line["phase_seconds"] = time.perf_counter() - t0
        report["serve_recurrent_" + key] = line
        t0 = time.perf_counter()
        line, rec_launches["train-" + key], rec_routes["train-" + key] = \
            train_family_phase(torch, np, engines, ExecutionConfig,
                               slice_knobs, arch, get_config, LayeredModel,
                               tree_leaves, is_spec, SyntheticLM, DataConfig,
                               add_modality_stubs, adam, make_schedule,
                               counters, dev, phase="train-recurrent",
                               depth_cap=TRAIN_DEPTH_CAP.get(arch, 0))
        line["phase_seconds"] = time.perf_counter() - t0
        report["train_recurrent_" + key] = line
    emit({"phase": "recurrent-seconds", **{
        k: v["phase_seconds"] for k, v in report.items()
        if "recurrent" in k}})

    # ------------------------------------ serve- and train-vlm, -audio
    mod_launches, mod_routes = {}, {}
    t0 = time.perf_counter()
    report["serve_vlm"], mod_launches["serve-vlm"], \
        mod_routes["serve-vlm"] = serve_vlm_phase(
            torch, np, engines, exec_cfg, get_config, LayeredModel,
            tree_leaves, is_spec, packing, sample_batch, counters, dev)
    report["serve_vlm"]["phase_seconds"] = time.perf_counter() - t0
    for arch, key, seq in ((VLM_ARCH, "vlm", VLM_TRAIN["seq"]),
                           (AUDIO_ARCH, "audio", AUDIO_TARGET)):
        if key == "audio":
            t0 = time.perf_counter()
            report["serve_audio"], mod_launches["serve-audio"], \
                mod_routes["serve-audio"] = serve_audio_phase(
                    torch, np, engines, exec_cfg, get_config, LayeredModel,
                    tree_leaves, is_spec, sample_batch, counters, dev)
            report["serve_audio"]["phase_seconds"] = \
                time.perf_counter() - t0
        t0 = time.perf_counter()
        line, mod_launches["train-" + key], mod_routes["train-" + key] = \
            train_family_phase(torch, np, engines, ExecutionConfig,
                               slice_knobs, arch, get_config, LayeredModel,
                               tree_leaves, is_spec, SyntheticLM, DataConfig,
                               add_modality_stubs, adam, make_schedule,
                               counters, dev, phase="train-" + key, seq=seq)
        line["phase_seconds"] = time.perf_counter() - t0
        report["train_" + key] = line
    emit({"phase": "modality-seconds", **{
        k: report[k]["phase_seconds"] for k in (
            "serve_vlm", "train_vlm", "serve_audio", "train_audio")}})

    # ----------------------------------------------------------------- tier
    t0 = time.perf_counter()
    report["tier"], tier_launches, tier_routes = tier_phase(
        torch, np, engines, ExecutionConfig, bert, slice_knobs, exec_cfg,
        get_config, LayeredModel, tree_leaves, is_spec, SyntheticLM,
        DataConfig, adam, make_schedule, sample_batch, counters, dev)
    emit({"phase": "tier-seconds", "tier": time.perf_counter() - t0})

    # ---------------------------------------------------------------- train
    report["train"], step1, train_keep = train_phase(
        torch, engines, ExecutionConfig, bert, slice_knobs, SyntheticLM,
        DataConfig, adam, make_schedule, counters, dev)
    train_launches = report["train"].pop("launches")
    train_routes = report["train"].pop("routes")

    # ------------------------------------------------------- host-optimizer
    t0 = time.perf_counter()
    report["host_optimizer"], host_launches, host_routes, host_keep = \
        host_optimizer_phase(torch, engines, ExecutionConfig, bert,
                             slice_knobs, SyntheticLM, DataConfig, adam,
                             make_schedule, counters, step1,
                             [s["loss"] for s in report["train"]["steps"]],
                             dev)
    report["host_optimizer"]["phase_seconds"] = time.perf_counter() - t0
    del step1


    # the profiled steps, after every timed phase
    report["train"]["profile"] = profile_step(torch, *train_keep)
    del train_keep
    emit(report["train"])
    report["host_optimizer"]["profile"] = profile_step(torch, *host_keep)
    del host_keep
    free_host(torch)
    emit(report["host_optimizer"])
    report["library"] = backward_device_ms(torch, F, dev, fa, rows,
                                           report["train_rmsnorm"]["k3_gqa"])
    emit(report["library"])
    report["scan_profile"] = scan_profile(torch, ssm, get_config, dev)
    emit(report["scan_profile"])
    report["recurrent_profile"] = recurrent_profiles(
        torch, engines, ExecutionConfig, slice_knobs, get_config,
        SyntheticLM, DataConfig, adam, make_schedule, dev)
    emit(report["recurrent_profile"])

    # ------------------------------------------------------------- train-dp
    # after the profiled steps: a process group started and destroyed in
    # this process, and two more processes on the card, come after every
    # single-process measurement but serve-grok's
    t0 = time.perf_counter()
    report["train_dp"], dp_launches, dp_routes = train_dp_phase(
        torch, np, engines, counters, dev)
    report["train_dp"]["phase_seconds"] = time.perf_counter() - t0
    emit(report["train_dp"])

    # ------------------------------------------------------------------- tp
    # the model axis: two more processes on the card, beside train-dp's
    report["tp"], tp_launches, tp_routes = tp_phase(torch, counters)
    emit({"phase": "tp-seconds", "torchrun": report["tp"]["torchrun_s"],
          "tp": report["tp"]["seconds"]})

    # --------------------------------------------------------- memory-model
    # the analytic model (the reference's buffers, not PyTorch's
    # allocator) beside this run's peaks: printed, not tied
    def train_estimate(depth):
        e = engines.create("l2l-p", bert.replace(n_layers=depth),
                           ExecutionConfig(n_microbatches=4, **slice_knobs))
        return e.memory_estimate(batch=32, seq=512).total_device
    peaks = report["train"]["peak_allocated_bytes_by_depth"]
    cont = report["serve_continuous"]
    report["memory_model"] = {
        "phase": "memory-model",
        "bert_large_train": {d: {"estimate_total_device_bytes":
                                 train_estimate(int(d)),
                                 "peak_allocated_bytes": peaks[d]}
                             for d in ("24", "12")},
        "granite_serve_continuous": {
            "estimate_total_device_bytes":
                cont["estimate_serve_total_device_bytes"],
            "estimate_kv_page_bytes": cont["estimate_serve_kv_page_bytes"],
            "peak_allocated_bytes": cont["peak_allocated_bytes"]}}
    emit(report["memory_model"])

    # ----------------------------------------------------------- serve-grok
    # last, when the host holds little else: a grok-1 layer pins 32 GB
    # (the host hands 64 unpinned GB back only after seconds, which the
    # phases after it would have to wait for)
    t0 = time.perf_counter()
    report["serve_grok"], grok_launches, grok_routes = grok_phase(
        torch, np, engines, exec_cfg, get_config, LayeredModel, tree_leaves,
        is_spec, rc, ref, sample_batch, counters, dev)
    report["serve_grok"]["phase_seconds"] = time.perf_counter() - t0

    # ------------------------------------------------------------- launches
    launches = {"serve": serve_launches, "serve-dense": dense_launches,
                "serve-continuous": cont_launches,
                "train": train_launches, "train-rmsnorm": rms_launches,
                "dynamic-depth": dyn_launches,
                "host-optimizer": host_launches, "train-dp": dp_launches,
                "serve-moe": smoe_launches, "train-moe": tmoe_launches,
                **rec_launches, **mod_launches, "serve-grok": grok_launches,
                **tier_launches, **tp_launches}
    routes = {"serve": serve_routes, "serve-dense": dense_routes,
              "serve-continuous": cont_routes,
              "train": train_routes, "train-rmsnorm": rms_routes,
              "dynamic-depth": dyn_routes, "host-optimizer": host_routes,
              "train-dp": dp_routes,
              "serve-moe": smoe_routes, "train-moe": tmoe_routes,
              **rec_routes, **mod_routes, "serve-grok": grok_routes,
              **tier_routes, **tp_routes}
    emit({"launches": launches, "routes": routes})
    assert len(launches) == 30, sorted(launches)
    for path in [p for p in launches if p != "serve"]:
        got, by = launches[path], routes[path]
        # every bf16 K2, K3a and K3b launch of the path took the wgmma route
        for n in ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv"):
            if n in by:
                assert by[n] == {"wgmma": got[n], "cuda_core": 0}, (path, n,
                                                                   by)
        # every K5 launch the CUDA kernel
        assert by["rmsnorm"] == {"cuda": got["rmsnorm"], "triton": 0}, \
            (path, by)
        # and every K4 fetch and write-back the relay's route
        for n, route in (("relay_copy", rc.FETCH_ROUTE),
                         ("relay_copy_writeback", rc.WRITEBACK_ROUTE)):
            if n in by:
                assert by[n] == {route: got[n], "tma_tiles": 0, "words": 0}, \
                    (path, n, by)
    train_kernels = ("relay_copy", "relay_copy_writeback",
                     "flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv", "fused_adam")
    path_kernels = {"serve": ("relay_copy", "rmsnorm", "flash_attention_fwd"),
                    "serve-dense": ("relay_copy", "rmsnorm",
                                    "flash_attention_fwd"),
                    "serve-continuous": ("relay_copy", "rmsnorm"),
                    "train": train_kernels,
                    "train-rmsnorm": train_kernels + ("rmsnorm",),
                    "dynamic-depth": train_kernels + ("rmsnorm",),
                    "host-optimizer": train_kernels[:-1],
                    "train-dp": train_kernels,
                    "serve-moe": ("relay_copy", "rmsnorm"),
                    "train-moe": ("relay_copy", "relay_copy_writeback",
                                  "rmsnorm", "fused_adam"),
                    "serve-hymba": ("relay_copy", "rmsnorm",
                                    "flash_attention_fwd"),
                    "train-hymba": train_kernels + ("rmsnorm",),
                    "serve-rwkv6": ("relay_copy",),
                    "train-rwkv6": ("relay_copy", "relay_copy_writeback",
                                    "fused_adam"),
                    "serve-vlm": ("relay_copy", "rmsnorm",
                                  "flash_attention_fwd"),
                    "train-vlm": train_kernels + ("rmsnorm",),
                    "serve-audio": ("relay_copy",),
                    "train-audio": ("relay_copy", "relay_copy_writeback",
                                    "fused_adam"),
                    "serve-grok": ("relay_copy", "rmsnorm",
                                   "flash_attention_fwd"),
                    "tier-train": train_kernels,
                    "tier-serve": ("relay_copy", "rmsnorm",
                                   "flash_attention_fwd"),
                    # unpacked: no K1 (the fused update takes packed rows)
                    "train-tp": train_kernels[:-1],
                    "serve-tp": ("relay_copy", "rmsnorm",
                                 "flash_attention_fwd"),
                    # deepseek-v2-lite on the mesh: MLA is plain attend
                    "train-moe-tp": ("relay_copy", "relay_copy_writeback",
                                     "rmsnorm"),
                    "train-moe-dp": ("relay_copy", "relay_copy_writeback",
                                     "rmsnorm", "fused_adam"),
                    "serve-moe-tp": ("relay_copy", "rmsnorm"),
                    # hymba on the mesh: its attention whole on each rank
                    "train-hybrid-tp": train_kernels[:-1] + ("rmsnorm",),
                    "serve-ssm-tp": ("relay_copy",),
                    # internvl2 on the mesh: GQA 7 over 1 kv head a rank
                    "train-vlm-tp": train_kernels[:-1] + ("rmsnorm",),
                    "serve-audio-tp": ("relay_copy",)}
    for path, names in path_kernels.items():
        assert all(launches[path].get(n, 0) > 0 for n in names), \
            (path, launches[path])
    # MLA attention is plain arithmetic in both packages (the reference's
    # mla_attention calls no kernel, use_pallas or not): no K2 or K3 on
    # the MoE paths
    for path in ("serve-moe", "train-moe", "train-moe-tp", "train-moe-dp",
                 "serve-moe-tp"):
        assert all(launches[path][n] == 0 for n in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")), (path, launches[path])
    # rwkv6 has no attention and norms by layernorm (plain arithmetic in
    # both packages): no K2, K3 or K5 on its paths; nor on whisper's,
    # layernorm with use_pallas=False (its 1500 frames do not tile by the
    # flash kernel's block)
    for path in ("serve-rwkv6", "train-rwkv6", "serve-ssm-tp",
                 "serve-audio", "train-audio", "serve-audio-tp"):
        assert all(launches[path][n] == 0 for n in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv", "rmsnorm")), (path, launches[path])
    # the host optimizer's path runs no K1: the update is on the host
    assert launches["host-optimizer"]["fused_adam"] == 0, launches
    total = {n: sum(launches[p].get(n, 0) for p in launches)
             for n in counters}

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "previous_ms", "library_err", "achieved_GBps")
    main_rows = {}
    for r in rows:                      # the first row of each kernel: the
        main_rows.setdefault(r["name"], r)   # path's shape, its dtype
    table = [{**{k: ({**r, "launches": total[n]}).get(k) for k in keys},
              "launches_by_path": {p: launches[p].get(n, 0)
                                   for p in launches}}
             for n, r in main_rows.items()]
    assert len(table) == 7, sorted(main_rows)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_smoke.json").write_text(
        json.dumps({**report, "launches": launches}, indent=1))
    emit({"kernels": table})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
