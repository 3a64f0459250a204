"""Deterministic, shardable synthetic data, as ``repro.data.pipeline``.

Batches are generated from ``(seed, step)`` alone with numpy, so any
step's batch is reproducible and equals the JAX package's byte for
byte; only the containers differ (torch tensors here). Each host takes
its slice of the global batch (``host_shard_slice``).

Both streams are learnable. CIFAR: Gaussian images around one of ten
class means (a function of the seed alone). LM: Zipf unigrams with about
half the positions overwritten by a deterministic successor
``(tok * 7 + 1) % V``. :class:`Prefetcher` makes batches on a
background thread.
"""

from __future__ import annotations

import dataclasses
import functools
import queue
import threading
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 32
    seq_len: int = 512
    vocab_size: int = 32000
    num_classes: int = 10
    image_size: int = 32
    num_hosts: int = 1
    host_id: int = 0


def host_shard_slice(cfg: DataConfig) -> tuple[int, int]:
    """(start, size) of the global batch owned by this host."""
    if cfg.global_batch % cfg.num_hosts:
        raise ValueError(f"global_batch {cfg.global_batch} not divisible by "
                         f"{cfg.num_hosts} hosts")
    per_host = cfg.global_batch // cfg.num_hosts
    return cfg.host_id * per_host, per_host


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    # Stateless: (seed, step) determines the batch on every host.
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))


@functools.lru_cache(maxsize=8)
def cifar_class_means(cfg: DataConfig) -> np.ndarray:
    """The per-class image means ``[classes, size, size, 3]``, float32: a
    function of ``cfg.seed`` alone."""
    rng0 = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0xC1FA]))
    return rng0.normal(
        0.0, 1.0, (cfg.num_classes, cfg.image_size, cfg.image_size, 3)
    ).astype(np.float32)


def cifar_batch_at(cfg: DataConfig, step: int) -> dict:
    """The synthetic-CIFAR batch of ``step``: ``{"images": float32 [per_host,
    size, size, 3], "labels": int32 [per_host], "step"}``, CPU tensors.
    Random access into the stateless stream: :func:`synthetic_cifar_batches`
    yields ``cifar_batch_at(cfg, 0), cifar_batch_at(cfg, 1), ...``."""
    start, per_host = host_shard_slice(cfg)
    class_means = cifar_class_means(cfg)
    rng = _batch_rng(cfg, step)
    labels = rng.integers(0, cfg.num_classes, cfg.global_batch)
    noise = rng.normal(
        0.0, 1.0, (cfg.global_batch, cfg.image_size, cfg.image_size, 3)
    ).astype(np.float32)
    images = class_means[labels] * 0.8 + noise
    sl = slice(start, start + per_host)
    return {"images": torch.from_numpy(np.ascontiguousarray(images[sl])),
            "labels": torch.from_numpy(labels[sl].astype(np.int32)),
            "step": step}


def synthetic_cifar_batches(cfg: DataConfig) -> Iterator[dict]:
    """Class-conditional Gaussian images, a learnable 10-way problem:
    :func:`cifar_batch_at` for steps 0, 1, ..."""
    step = 0
    while True:
        yield cifar_batch_at(cfg, step)
        step += 1


def synthetic_lm_batches(cfg: DataConfig) -> Iterator[dict]:
    """``{"tokens", "labels": int32 [per_host, seq_len], "step"}`` for
    steps 0, 1, ...: Zipf(1.1) unigrams, about half the positions
    replaced by their predecessor's successor ``(tok * 7 + 1) % V``;
    labels are the tokens shifted by one. CPU tensors."""
    start, per_host = host_shard_slice(cfg)
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    step = 0
    while True:
        rng = _batch_rng(cfg, step)
        base = rng.choice(cfg.vocab_size,
                          size=(cfg.global_batch, cfg.seq_len + 1), p=probs)
        succ = (base[:, :-1] * 7 + 1) % cfg.vocab_size
        mask = rng.random((cfg.global_batch, cfg.seq_len)) < 0.5
        base[:, 1:][mask] = succ[mask]
        tokens = base.astype(np.int32)[start:start + per_host]
        yield {"tokens": torch.from_numpy(np.ascontiguousarray(tokens[:, :-1])),
               "labels": torch.from_numpy(np.ascontiguousarray(tokens[:, 1:])),
               "step": step}
        step += 1


class Prefetcher:
    """Iterates ``it`` on a background thread, up to ``depth`` items ahead,
    so batch synthesis overlaps the device's work."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
