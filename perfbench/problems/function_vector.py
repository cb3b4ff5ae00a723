"""benchmark_script's sampled repository: rom-comma's ALL function vector
(``user/functions.py``: ishigami x3, sobol_g x3, oakley2004 x3, L = 9) on a
centred Latin hypercube of N rows in [0, 1]^M, with noise of covariance
``noise_magnitude``^2 times a random trace-normalized (L, L) matrix
(``GaussianNoise.Variance(L, magnitude, is_covariant, is_determined=True)``)
scaled by each output's standard deviation, written as rom-comma's data.csv
(a two-row header of ('X', 'X.m') and ('Y', 'Y.l') columns and an index).

The functions are the benchmark's own copy of the public formulas, each on
``loc + scale * X[:, :m]``:

    ishigami:   sin x1 + A sin^2 x2 + B x3^4 sin x1,           loc -pi, scale 2 pi, m 3
    sobol_g':   prod_j ((1 + al_j)|2 x_j - 1|^al_j + a_j) / (1 + a_j),   loc 0, scale 1, m 5
    oakley2004: a1.x + a2.sin x + a3.cos x + x Q x^T,           loc -1, scale 2, m 7

with rom-comma's parameterizations. Everything is drawn from the seed alone:
the design, the noise covariance and the noise."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np
import pandas as pd


def _linspace(start: float, stop: float, shape) -> np.ndarray:
    return np.linspace(start, stop, int(np.prod(shape)), endpoint=True).reshape(shape)


def _ishigami(x: np.ndarray, A: float, B: float) -> np.ndarray:
    return np.sin(x[:, 0]) + A * np.sin(x[:, 1]) ** 2 + B * x[:, 2] ** 4 * np.sin(x[:, 0])


def _sobol_g(x: np.ndarray, a, alpha: float) -> np.ndarray:
    a = np.asarray(a, dtype=float)
    x = x - np.floor(x)
    return np.prod(((1.0 + alpha) * np.abs(2.0 * x - 1.0) ** alpha + a) / (1.0 + a), axis=1)


def _oakley(x: np.ndarray, a1, Q) -> np.ndarray:
    return x @ a1 + np.einsum('nm,mk,nk->n', x, Q, x)


def functions(X: np.ndarray) -> np.ndarray:
    """The nine outputs (N, 9) of ALL at X (N, M >= 7) in [0, 1]^M."""
    xi = -np.pi + 2.0 * np.pi * X[:, :3]
    xs = X[:, :5]
    xo = -1.0 + 2.0 * X[:, :7]
    weak, strong = [3, 6, 9, 18, 27], [1 / 2, 1, 2, 4, 8]
    a = _linspace(7.0, 3.5, [7])
    return np.stack([_ishigami(xi, 7.0, 0.1), _ishigami(xi, 20.0, 1.0), _ishigami(xi, 0.0, 0.0),
                     _sobol_g(xs, weak, 2.0), _sobol_g(xs, strong, 2.0), _sobol_g(xs, strong, 4.0),
                     _oakley(xo, a, np.zeros((7, 7))), _oakley(xo, a, _linspace(7.0, 1.0, [7, 7])),
                     _oakley(xo, -a, _linspace(1.0, 7.0, [7, 7]))], axis=1)


def noise_covariance(L: int, magnitude: float, covariant: bool, rng) -> np.ndarray:
    """A random trace-normalized SPD (L, L) matrix times magnitude^2
    (diagonal only where not ``covariant``)."""
    A = 2.0 * rng.random((L, L)) - 1.0
    C = A @ A.T
    C /= np.trace(C) / L
    if not covariant:
        C = np.diag(np.diag(C))
    return C * magnitude ** 2


def sample(config: Dict[str, Any], seed: int):
    """(X (N, M), Y (N, 9)) float64 from the seed alone."""
    N, M = int(config['N']), int(config['M'])
    rng = np.random.default_rng(seed)
    X = (np.stack([rng.permutation(N) for _ in range(M)], axis=1) + 0.5) / N
    Y = functions(X)
    C = noise_covariance(Y.shape[1], float(config['noise']), bool(config['noise_covariant']), rng)
    noise = rng.multivariate_normal(np.zeros(Y.shape[1]), C, size=N)
    return X, Y + np.std(Y, axis=0) * noise


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
