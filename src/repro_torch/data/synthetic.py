"""Synthetic class-conditional image datasets and the LM token stream
(numpy).

Each class c is a Gaussian blob around a class prototype with within-class
variability, so clients whose label mixtures overlap have genuinely similar
data — the property the EM weights are meant to discover. The same seed
gives byte-identical arrays to the reference package's generator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import numpy as np


@dataclass
class SyntheticImageDataset:
    x: np.ndarray              # (N, H, W, C) float32 in [0, 1]
    y: np.ndarray              # (N,) int32
    n_classes: int

    def __len__(self) -> int:
        return len(self.y)


def synthetic_image_dataset(seed: int, n_samples: int, *, image_size: int = 32,
                            channels: int = 3, n_classes: int = 10,
                            noise: float = 0.35) -> SyntheticImageDataset:
    """Class-conditional Gaussian-prototype images."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.5, 0.25,
                        (n_classes, image_size, image_size, channels))
    # low-frequency structure so convs have something to learn
    xs = np.linspace(0, 2 * np.pi, image_size)
    wave = np.sin(xs)[None, :, None, None] * np.cos(xs)[None, None, :, None]
    protos = protos + 0.3 * wave * (np.arange(n_classes)[:, None, None, None]
                                    / n_classes)
    y = rng.integers(0, n_classes, n_samples).astype(np.int32)
    x = protos[y] + rng.normal(0.0, noise, (n_samples, image_size, image_size,
                                            channels))
    return SyntheticImageDataset(np.clip(x, 0, 1).astype(np.float32), y,
                                 n_classes)


def make_client_datasets(base: SyntheticImageDataset,
                         client_indices: List[np.ndarray]
                         ) -> List[SyntheticImageDataset]:
    return [SyntheticImageDataset(base.x[idx], base.y[idx], base.n_classes)
            for idx in client_indices]


def stack_datasets(datasets: List[SyntheticImageDataset]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad per-client datasets to a common length and stack them
    client-major: ``(x (N, K_max, ...), y (N, K_max), lengths (N,) int32,
    mask (N, K_max) bool)``. Padding is zeros; index draws stay inside
    ``[0, lengths[i])`` so padded rows are never trained on."""
    k_max = max(len(d) for d in datasets)
    n = len(datasets)
    d0 = datasets[0]
    x = np.zeros((n, k_max) + d0.x.shape[1:], d0.x.dtype)
    y = np.zeros((n, k_max), d0.y.dtype)
    mask = np.zeros((n, k_max), bool)
    for i, d in enumerate(datasets):
        k = len(d)
        x[i, :k] = d.x
        y[i, :k] = d.y
        mask[i, :k] = True
    lengths = np.asarray([len(d) for d in datasets], np.int32)
    return x, y, lengths, mask


def token_batch_stream(seed: int, *, batch: int, seq_len: int, vocab: int,
                       n_batches: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic LM stream: Zipf unigrams + deterministic bigram bleed so
    next-token prediction is learnable. The reference's draws, byte for
    byte: ``tokens`` and ``labels`` (batch, seq_len) int32, labels the
    tokens shifted by one."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    i = 0
    while n_batches == 0 or i < n_batches:
        base = rng.choice(vocab, size=(batch, seq_len + 1), p=probs)
        # bigram structure: with p=0.5, token t+1 = (token t * 7 + 13) % vocab
        follow = (base * 7 + 13) % vocab
        use = rng.random((batch, seq_len + 1)) < 0.5
        toks = np.where(use, np.roll(follow, 1, axis=1), base)
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        i += 1
