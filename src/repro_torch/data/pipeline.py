"""Token data pipeline: synthetic + memmap-backed, deterministic, sharded.

A copy of ``repro/data/pipeline.py`` (numpy only): the same batches, bit
for bit, for each (seed, step, shard). Batches are numpy arrays; the
train step moves them to the parameters' device.

Determinism contract (straggler/elastic requirement, DESIGN.md §5): batch
content is a pure function of (seed, step, shard) — any host can recompute
any other host's shard after a failure, and resharding after an elastic
resize changes only the shard→host assignment, never the sample order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticLM", "MemmapTokens", "make_batches"]


@dataclasses.dataclass
class SyntheticLM:
    """Zipf-distributed synthetic tokens (shape-exact stand-in corpus)."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
        if self.global_batch % n_shards:
            raise ValueError("global_batch must divide by n_shards")
        b = self.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        # zipfian token distribution, clipped into vocab
        toks = rng.zipf(1.3, size=(b, self.seq_len)).astype(np.int64)
        toks = (toks - 1) % self.vocab_size
        return {"tokens": toks.astype(np.int32)}


@dataclasses.dataclass
class MemmapTokens:
    """Memory-mapped pre-tokenized corpus (one flat int32 file)."""

    path: str
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")
        self._n_seqs = len(self._data) // self.seq_len

    @classmethod
    def write_corpus(cls, path: str, tokens: np.ndarray) -> None:
        mm = np.memmap(path, dtype=np.int32, mode="w+", shape=tokens.shape)
        mm[:] = tokens
        mm.flush()

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
        b = self.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        idx = rng.integers(0, self._n_seqs, size=b)
        seqs = np.stack([
            self._data[i * self.seq_len:(i + 1) * self.seq_len] for i in idx])
        return {"tokens": (seqs % self.vocab_size).astype(np.int32)}


def make_batches(source, start_step: int = 0, shard: int = 0,
                 n_shards: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield source.batch(step, shard, n_shards)
        step += 1
