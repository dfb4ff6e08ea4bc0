"""Token sampling: greedy / temperature / top-k with a per-request random
stream (the port of ``repro/serve/sampling.py``).

``temperature == 0`` rows are exactly ``argmax`` with the first-max tie
rule, the same in both frameworks — greedy serving matches the reference
token for token.  Stochastic rows draw from a ``torch.Generator`` seeded
from the row's (seed, position) pair only, so a request replays the same
tokens whichever batch row it sits in.  Those draws cannot match JAX's
PRNG; they are deterministic within the port.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _row_seed(seed: int, position: int) -> int:
    return ((int(seed) & 0xFFFFFFFF) << 32) | (max(int(position), 0)
                                               & 0xFFFFFFFF)


def sample(logits, seeds, positions, temperature, top_k):
    """(B, V) logits -> (B,) int64 tokens.

    temperature: (B,) — 0 = greedy; top_k: (B,) — 0 = full vocab, else
    keep entries >= the k-th largest (ties all kept); seeds/positions:
    (B,) — the per-request stream, ignored on greedy rows.  All four are
    host sequences (lists, or the serve tick's numpy arrays), read on the
    host, so no row's check waits for the card."""
    lf = logits.float()
    out = torch.argmax(lf, dim=-1)
    V = lf.shape[-1]
    for b in range(lf.shape[0]):
        temp = float(temperature[b])
        if temp <= 0:
            continue
        row = lf[b]
        k = int(top_k[b])
        if k > 0:
            thresh = torch.topk(row, min(k, V)).values[-1]
            row = torch.where(row >= thresh, row, torch.full_like(row, NEG_INF))
        gen = torch.Generator(device=lf.device)
        gen.manual_seed(_row_seed(seeds[b], positions[b]))
        probs = torch.softmax(row / max(temp, 1e-6), dim=-1)
        out[b] = torch.multinomial(probs, 1, generator=gen)[0]
    return out


def sample_batch(logits, *, temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0, position=0):
    """Uniform settings for the one-shot serve path: rows share
    (temperature, top_k) and draw independently (row index added to the
    seed)."""
    B = logits.shape[0]
    return sample(logits, [seed + b for b in range(B)], [position] * B,
                  [temperature] * B, [top_k] * B)
