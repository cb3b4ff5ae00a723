"""rom-comma's K-fold split and per-fold normalization, worked out again from
the raw CSV (reference storage.py:162-204 and :440-558):

  - each consecutive block of K rows carries one permutation of the fold
    labels 0..K-1, shuffled by Python's ``random`` in row order, the final
    partial block a shuffled prefix; fold k trains on the rows not labelled k;
  - each fold's inputs go to [0, 1] by the training rows' mean -/+ sqrt(3)
    std, clipped 1e-12 from either end, then to N(0, 1) by the inverse normal
    CDF; its outputs are standardized by the training rows' mean and std."""

from __future__ import annotations

import itertools
import math
import random
from pathlib import Path
from typing import List, Tuple

import numpy as np
import pandas as pd
import torch

UNIFORM_MARGIN = 1.0e-12


def read_csv(csv: Path) -> np.ndarray:
    """The raw (N, M + L) table of a rom-comma data.csv."""
    return pd.read_csv(csv, sep=',', header=[0, 1], index_col=0).to_numpy(dtype=np.float64)


def fold_labels(N: int, K: int, seed: int) -> List[int]:
    """Per-row fold labels, as Python's random seeded with ``seed`` gives them."""
    rnd = random.Random(seed)
    blocks = [list(range(K)) for _ in range(N // K)] + [list(range(N % K))]
    for block in blocks:
        rnd.shuffle(block)
    return list(itertools.chain(*blocks))


def normalized_fold(table: np.ndarray, labels: List[int], k: int, M: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold k's normalized training (X (n, M), Y (n, L)), float64 on the CPU."""
    rows = [row for row, label in enumerate(labels) if label != k]
    data = torch.as_tensor(table[rows], dtype=torch.float64)
    mean = data.mean(dim=0)
    std = data.std(dim=0, correction=1)
    semi = std * math.sqrt(3.0)
    low, width = mean - semi, 2.0 * semi
    X = torch.clamp((data[:, :M] - low[:M]) / width[:M], UNIFORM_MARGIN, 1.0 - UNIFORM_MARGIN)
    X = torch.special.ndtri(X)
    Y = (data[:, M:] - mean[M:]) / std[M:]
    return X, Y
