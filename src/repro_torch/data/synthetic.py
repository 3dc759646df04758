"""Synthetic LM token pipeline — deterministic, shardable, restartable.

The port of ``repro.data.synthetic`` (``src/repro/data/synthetic.py``),
numpy only and unchanged: batches are bit-equal to the reference's for
every ``(step, host)``. They come back as numpy; the train loop moves
them to the device.

The stream is indexed by (step, host) so restart-after-failure resumes
exactly (fault tolerance depends on this determinism), and each host
generates only its shard of the global batch (no cross-host I/O).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import errors


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234


class SyntheticTokenStream:
    """Zipf-distributed token ids (natural-language-ish marginals)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        if cfg.global_batch % num_hosts:
            raise errors.InvalidArgError("global_batch must divide across hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.host_batch = cfg.global_batch // num_hosts
        # Zipf weights over the vocab (truncated, normalized)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        w = 1.0 / ranks**1.1
        self._probs = w / w.sum()

    def batch(self, step: int) -> dict:
        """Deterministic batch for (step, host): resume == replay."""
        seed = (self.cfg.seed * 1_000_003 + step) * 4096 + self.host_id
        rng = np.random.default_rng(seed)
        toks = rng.choice(
            self.cfg.vocab_size,
            size=(self.host_batch, self.cfg.seq_len + 1),
            p=self._probs,
        ).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
