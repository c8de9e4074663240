"""Deterministic synthetic data pipeline.

Counterpart of ``repro.data.pipeline``, with its own copy of the numpy
generator: for the same ``(seed, step, shard)`` the tokens are the
reference's bit for bit.  Token streams are keyed by (seed, step, shard)
so that
  * restarts resume bit-identically (checkpoint stores only the step),
  * each data-parallel shard draws a disjoint sub-batch (shard_id/num_shards),
  * no filesystem or network dependency.

The "corpus" is a mixture of Zipfian unigrams and short repeated n-gram
motifs.  Batches are drawn on the host and handed out as int64 tensors on
the stream's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_prob: float = 0.5


def _zipf_probs(cfg: DataConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    p = ranks ** (-cfg.zipf_a)
    return (p / p.sum()).astype(np.float32)


class SyntheticStream:
    """Host-side deterministic batch source, placed on ``device`` (the card
    by default; raises without one unless ``device="cpu"``)."""

    def __init__(self, cfg: DataConfig, *, shard_id: int = 0,
                 num_shards: int = 1, device: str | torch.device = "cuda"):
        if cfg.global_batch % num_shards != 0:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {num_shards} shards")
        self.cfg = cfg
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.device = resolve_device(device)
        self._probs = _zipf_probs(cfg)

    def batch_at(self, step: int) -> dict:
        """The shard's sub-batch for ``step`` (pure function of step):
        {"tokens", "labels"} [b, seq_len], labels the next tokens."""
        cfg = self.cfg
        b = cfg.global_batch // self.num_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 97 + self.shard_id)
        tokens = rng.choice(cfg.vocab_size, size=(b, cfg.seq_len + 1),
                            p=self._probs).astype(np.int32)
        # overwrite random spans with repeated motifs (learnable structure)
        n_motifs = int(cfg.motif_prob * b)
        for _ in range(n_motifs):
            row = rng.integers(0, b)
            motif = rng.integers(0, cfg.vocab_size, size=cfg.motif_len)
            reps = cfg.seq_len // cfg.motif_len
            tokens[row, : reps * cfg.motif_len] = np.tile(motif, reps)[
                : reps * cfg.motif_len]
        t = torch.from_numpy(tokens).to(self.device, torch.long)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
