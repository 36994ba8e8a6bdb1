"""Deterministic, resumable data pipeline (the port's own copy of
``repro.data.pipeline``, which is numpy only: batches are byte-identical).

Two sources:
  * ``SyntheticLM`` — stateless PRNG token stream: batch(step) is a pure
    function of (seed, step), so restart-at-step-k is exact (fault
    tolerance / elasticity: any host can reproduce any shard of any step).
  * ``MemmapTokens`` — file-backed token corpus (np.memmap), sharded by
    (host, step) with the same pure-function indexing.

Both emit the global batch as numpy int32 ``tokens`` / ``targets`` (B, S);
the trainer moves it to its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    corpus_path: Optional[str] = None      # None -> synthetic


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rs = np.random.Generator(np.random.Philox(key=c.seed, counter=step))
        toks = rs.integers(0, c.vocab_size, (c.global_batch, c.seq_len + 1),
                           dtype=np.int64).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def shard_at(self, step: int, shard: int, n_shards: int):
        b = self.batch_at(step)
        rows = self.cfg.global_batch // n_shards
        sl = slice(shard * rows, (shard + 1) * rows)
        return {k: v[sl] for k, v in b.items()}


class MemmapTokens:
    """Token file (int32 flat) chunked into (seq_len+1) windows, strided by a
    step-indexed permutation so resume is exact."""

    def __init__(self, cfg: DataConfig):
        assert cfg.corpus_path
        self.cfg = cfg
        self.data = np.memmap(cfg.corpus_path, dtype=np.int32, mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq_len

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rs = np.random.Generator(np.random.Philox(key=c.seed ^ 0xDA7A,
                                                  counter=step))
        idx = rs.integers(0, self.n_windows, (c.global_batch,))
        toks = np.stack([
            np.asarray(self.data[i * c.seq_len:(i * c.seq_len) + c.seq_len + 1])
            for i in idx])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}


def make_source(cfg: DataConfig):
    if cfg.corpus_path:
        return MemmapTokens(cfg)
    return SyntheticLM(cfg)


def iterate(source, start_step: int = 0) -> Iterator:
    step = start_step
    while True:
        yield step, source.batch_at(step)
        step += 1
