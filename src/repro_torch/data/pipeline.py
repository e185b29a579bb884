"""Deterministic synthetic data: token streams for LM training and time
series with planted motifs/discords for the NATSA engine — port of
`repro.data.pipeline`, numpy only, whose outputs are the reference's bit
for bit (the port keeps its own copy; it imports nothing of `repro`).

Design points for the 1000+-node posture:
  * host-sharded loading — each data-parallel host materializes ONLY its
    batch shard, keyed by (seed, step, shard), so restart at any step
    reproduces the same global batch without coordination;
  * no filesystem dependency (synthetic), but the iterator protocol matches
    what a file-backed loader would expose (checkpointable cursor = step).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-ish structure so the loss is learnable (pure uniform tokens
    # give a flat loss -> tests couldn't assert learning)
    n_states: int = 8


class TokenStream:
    """Deterministic pseudo-corpus: per-(step, shard) reproducible batches."""

    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed random transition table + per-state emission tables
        self.trans = rng.dirichlet(np.ones(cfg.n_states) * 0.5,
                                   size=cfg.n_states)
        self.emit = rng.integers(0, cfg.vocab_size,
                                 size=(cfg.n_states, 64)).astype(np.int32)

    def batch(self, step: int, *, shard: int = 0, n_shards: int = 1):
        """Returns {tokens, labels} for this host's shard of global batch."""
        cfg = self.cfg
        assert cfg.global_batch % n_shards == 0
        b = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + shard)
        states = rng.integers(0, cfg.n_states, size=b)
        toks = np.empty((b, cfg.seq_len + 1), np.int32)
        for t in range(cfg.seq_len + 1):
            pick = rng.random(b)
            cum = np.cumsum(self.trans[states], axis=1)
            states = (pick[:, None] < cum).argmax(axis=1)
            toks[:, t] = self.emit[states, rng.integers(0, 64, size=b)]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# time series generators (NATSA engine inputs)


def random_walk(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=n)).astype(np.float32)


def sines_with_noise(n: int, period: float = 50.0, noise: float = 0.1,
                     seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32)
    return (np.sin(2 * np.pi * t / period)
            + noise * rng.normal(size=n)).astype(np.float32)


def plant_motif(ts: np.ndarray, positions: list[int], length: int,
                amplitude: float = 4.0, seed: int = 1) -> np.ndarray:
    """Insert the same non-periodic chirp at each position."""
    t = np.linspace(0, 1, length)
    pattern = (np.sin(2 * np.pi * (2 * t + 6 * t * t)) * amplitude)
    out = ts.copy()
    for p in positions:
        out[p:p + length] += pattern.astype(ts.dtype)
    return out


def plant_discord(ts: np.ndarray, position: int, length: int,
                  magnitude: float = 8.0) -> np.ndarray:
    out = ts.copy()
    out[position:position + length] += np.linspace(
        0, magnitude, length).astype(ts.dtype)
    return out


def ecg_like(n: int, bpm_period: int = 180, seed: int = 0) -> np.ndarray:
    """Synthetic quasi-periodic 'heartbeat' train (paper's motivating domain)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32)
    phase = (t % bpm_period) / bpm_period
    spike = np.exp(-((phase - 0.3) ** 2) / 0.001) - 0.3 * np.exp(
        -((phase - 0.45) ** 2) / 0.004)
    drift = 0.3 * np.sin(2 * np.pi * t / (bpm_period * 13.7))
    return (spike + drift + 0.05 * rng.normal(size=n)).astype(np.float32)
