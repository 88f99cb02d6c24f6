"""Non-IID client partitioning (Sec V-A): Dirichlet(alpha_d = 0.1) label
distribution per client, 75/25 train-test (numpy)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, *,
                        alpha: float = 0.1, seed: int = 0,
                        min_per_client: int = 20) -> List[np.ndarray]:
    """Per-client index arrays: class mass split across clients by
    Dirichlet(alpha) draws, redrawn until every client has
    ``min_per_client`` samples."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    while True:
        client_idx: List[List[int]] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            share = rng.dirichlet([alpha] * n_clients)
            counts = (share * len(idx_by_class[c])).astype(int)
            counts[-1] = len(idx_by_class[c]) - counts[:-1].sum()
            start = 0
            for ci, cnt in enumerate(counts):
                client_idx[ci].extend(idx_by_class[c][start:start + cnt])
                start += cnt
        sizes = [len(ci) for ci in client_idx]
        if min(sizes) >= min_per_client:
            break
    return [np.asarray(sorted(ci), dtype=np.int64) for ci in client_idx]


def train_test_split(idx: np.ndarray, *, test_frac: float = 0.25,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(idx))
    n_test = max(1, int(len(idx) * test_frac))
    return idx[perm[n_test:]], idx[perm[:n_test]]
