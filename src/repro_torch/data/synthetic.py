"""Synthetic LM data pipeline (the port's own copy of
``repro/data/synthetic.py``: numpy only, so a batch equals the
reference's token for token for the same seed and step).

Deterministic, seekable token streams (no external datasets in this
container): a mixture of (a) a Zipf-distributed unigram stream, (b) short
repeated n-gram motifs (so a model can actually LEARN something — the
convergence benchmarks need a learnable signal), and (c) a tiny fraction of
uniform noise.  Documents are delimited and packed into fixed-length
sequences with next-token targets, mirroring a production LM pipeline
(tokenize -> pack -> shard by host).

Everything is a pure function of (seed, index) so any host in a multi-pod
job can materialize exactly its shard without coordination.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 8
    n_motifs: int = 64
    motif_frac: float = 0.7        # fraction of tokens from repeated motifs
    pad_id: int = 0
    # host sharding
    host_index: int = 0
    host_count: int = 1


class SyntheticLM:
    """Seekable synthetic token source + packer."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed motif bank (learnable structure)
        self.motifs = root.integers(1, v, size=(cfg.n_motifs, cfg.motif_len),
                                    dtype=np.int64)
        # Zipf-ish unigram distribution over the vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.unigram = p / p.sum()

    def _doc(self, rng: np.random.Generator, min_len=64, max_len=512):
        n = int(rng.integers(min_len, max_len))
        out = []
        while len(out) < n:
            if rng.random() < self.cfg.motif_frac:
                m = self.motifs[int(rng.integers(0, self.cfg.n_motifs))]
                out.extend(m.tolist())
            else:
                out.append(int(rng.choice(self.cfg.vocab_size,
                                          p=self.unigram)))
        return out[:n]

    def batch(self, step: int) -> dict:
        """Deterministic global batch for ``step`` — this host's shard."""
        cfg = self.cfg
        assert cfg.global_batch % cfg.host_count == 0
        per_host = cfg.global_batch // cfg.host_count
        B, S = per_host, cfg.seq_len
        toks = np.zeros((B, S + 1), np.int64)
        for b in range(B):
            # unique, seekable stream per (step, global row)
            row = cfg.host_index * per_host + b
            rng = np.random.default_rng(
                (cfg.seed, step, row))
            buf: list = []
            while len(buf) < S + 1:
                buf.extend(self._doc(rng))
                buf.append(cfg.pad_id)        # doc delimiter
            toks[b] = buf[:S + 1]
        tokens = toks[:, :-1].astype(np.int32)
        targets = toks[:, 1:].astype(np.int32)
        mask = (targets != cfg.pad_id).astype(np.float32)
        return {"tokens": tokens, "targets": targets, "mask": mask}

    def batches(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def add_modality_stubs(batch: dict, cfg, rng: Optional[np.random.Generator]
                       = None) -> dict:
    """Attach the stubbed frontend embeddings (whisper's audio frames,
    internvl2's vision patches) as deterministic pseudo features."""
    rng = rng or np.random.default_rng(1234)
    B = batch["tokens"].shape[0]
    if cfg.family == "audio":
        batch = dict(batch, frames=rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32))
    if cfg.is_vlm:
        batch = dict(batch, patches=rng.standard_normal(
            (B, cfg.n_patches, cfg.vit_dim)).astype(np.float32))
    return batch
