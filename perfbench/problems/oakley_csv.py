"""A user's CSV of OAKLEY2004 (rom-comma's ``user/functions.py``, L=3): a
centred Latin hypercube of N rows in [0, 1]^M, the three modified Oakley &
O'Hagan (2004) functions of its first 7 columns, each with Gaussian noise of
``noise`` times its own standard deviation, written as rom-comma's data.csv
(a two-row header of ('X', 'X.m') and ('Y', 'Y.l') columns and an index).

The functions are the benchmark's own copy of the public formulas,

    y = a1.x + a2.sin(x) + a3.cos(x) + x Q x^T,   x = -1 + 2 X[:, :7],

with rom-comma's three parameterizations (lin7, quad7, balanced_quad7)."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np
import pandas as pd

ACTIVE = 7


def _linspace(start: float, stop: float, shape) -> np.ndarray:
    return np.linspace(start, stop, int(np.prod(shape)), endpoint=True).reshape(shape)


def _oakley(x: np.ndarray, a1, a2, a3, Q) -> np.ndarray:
    return x @ a1 + np.sin(x) @ a2 + np.cos(x) @ a3 + np.einsum('nm,mk,nk->n', x, Q, x)


def functions(X: np.ndarray) -> np.ndarray:
    """The three outputs (N, 3) of OAKLEY2004 at X (N, M >= 7) in [0, 1]^M."""
    x = -1.0 + 2.0 * X[:, :ACTIVE]
    a = _linspace(7.0, 3.5, [ACTIVE])
    zero = np.zeros(ACTIVE)
    return np.stack([_oakley(x, a, zero, zero, np.zeros((ACTIVE, ACTIVE))),
                     _oakley(x, a, zero, zero, _linspace(7.0, 1.0, [ACTIVE, ACTIVE])),
                     _oakley(x, -a, zero, zero, _linspace(1.0, 7.0, [ACTIVE, ACTIVE]))], axis=1)


def sample(config: Dict[str, Any], seed: int):
    """(X (N, M), Y (N, 3)) float64 from the seed alone."""
    N, M = int(config['N']), int(config['M'])
    rng = np.random.default_rng(seed)
    X = (np.stack([rng.permutation(N) for _ in range(M)], axis=1) + 0.5) / N
    Y = functions(X)
    Y = Y + float(config['noise']) * np.std(Y, axis=0) * rng.standard_normal(Y.shape)
    return X, Y


def make(config: Dict[str, Any], seed: int, folder: Path) -> Dict[str, Any]:
    """Write the CSV under ``folder`` and return {'csv': its path}."""
    X, Y = sample(config, seed)
    columns = ([('X', f'X.{m}') for m in range(X.shape[1])] +
               [('Y', f'Y.{l}') for l in range(Y.shape[1])])
    frame = pd.DataFrame(np.concatenate((X, Y), axis=1),
                         columns=pd.MultiIndex.from_tuples(columns), dtype=float)
    csv = Path(folder) / 'data.csv'
    frame.to_csv(csv, sep=',', index=True)
    return {'csv': csv}
