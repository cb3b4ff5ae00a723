"""The north star's data: X ~ N(0, 1) of shape (N, M) and
Y = sin(x0) + x1^2 / 2 + 0.1 eps, so the first-order indices concentrate on
inputs 0 and 1 and every other input is noise.

The program stages X and Y in float32, so both are drawn in float64 and
rounded to values float32 holds: the program and the reference then see the
same numbers."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np


def sample(config: Dict[str, Any], seed: int):
    """(X (N, M), Y (N, 1)) float64, every value one float32 holds."""
    N, M = int(config['N']), int(config['M'])
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, M))
    Y = (np.sin(X[:, :1]) + 0.5 * X[:, 1:2] ** 2
         + float(config['noise']) * rng.standard_normal((N, 1)))
    return (X.astype(np.float32).astype(np.float64), Y.astype(np.float32).astype(np.float64))


def make(config: Dict[str, Any], seed: int, folder: Path) -> Dict[str, Any]:
    """{'X': X, 'Y': Y}; nothing is written."""
    X, Y = sample(config, seed)
    return {'X': X, 'Y': Y}
