"""Sampling and Design of Experiments (reference: romcomma/user/sample.py).
Counterpart of ``romcomma_tpu/user/sample.py``, of which it ports what the
GPR workflow uses: the Latin-hypercube DOE, artificial Gaussian noise with the
reference's labelling scheme, and ``Function``, which builds a Repository by
sampling a ``functions.Vector`` over a DOE.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import pandas as pd
import scipy.stats

from romcomma_tpu_torch.data.storage import Repository
from romcomma_tpu_torch.user import functions


class DOE:
    """Sampling methods for inputs."""

    Method = Callable[..., np.ndarray]

    @staticmethod
    def latin_hypercube(N: int, M: int, is_centered: bool = True, **kwargs):
        # kwargs forward to the sampler (notably ``seed`` for reproducible
        # designs — the qmc engine is otherwise freshly random per call).
        return scipy.stats.qmc.LatinHypercube(M, scramble=not is_centered,
                                              **kwargs).random(N)


class GaussianNoise:
    """Zero-mean multivariate Gaussian noise sampler (sample.py:103-183)."""

    class Variance:
        """Artificially generated (L,L) noise (co)variance.

        NOTE (reference quirk, preserved): ``is_determined=True`` generates a
        *random* trace-normalized SPD matrix while ``False`` produces the fixed
        formula (-1)^(i-j)/(1+|i-j|) — the inverse of what the docstring
        suggests (reference sample.py:132-150).
        """

        def __init__(self, L: int, magnitude: float, is_covariant: bool = False,
                     is_determined: bool = True):
            self.magnitude, self.is_covariant, self.is_determined = magnitude, is_covariant, is_determined
            if self.is_determined:
                self._matrix = 2 * np.random.random_sample((L, L)) - np.ones((L, L))
                self._matrix = np.matmul(self._matrix, self._matrix.transpose())
                self._matrix /= np.trace(self._matrix) / L
            else:
                self._matrix = np.array([[(-1) ** (i - j) / (1.0 + abs(i - j))
                                          for i in range(L)] for j in range(L)])
            if not self.is_covariant:
                self._matrix = np.diag(np.diag(self._matrix))
            self._matrix *= self.magnitude ** 2

        @property
        def matrix(self) -> np.ndarray:
            return self._matrix

        @property
        def meta(self) -> Dict[str, Any]:
            return {'generator': 'determined' if self.is_determined else 'undetermined',
                    'is_covariant': 'covariance' if self.is_covariant else 'variance',
                    'magnitude': self.magnitude}

        def __call__(self) -> np.ndarray:
            return self._matrix

        def __format__(self, format_spec: Any) -> str:
            return (f'{"d." if self.is_determined else "u."}'
                    f'{"c." if self.is_covariant else "v."}{100 * self.magnitude:.2f}')

    def __init__(self, N: int, variance):
        self._variance = np.atleast_2d(variance)
        if len(self._variance.shape) == 2 and self._variance.shape[0] == 1:
            self._variance = np.diagflat(self._variance)
        elif self._variance.shape[0] != self._variance.shape[1] or len(self._variance.shape) > 2:
            raise IndexError(f'variance.shape = {self._variance.shape} should be (L,) or (L,L).')
        self._rvs = scipy.stats.multivariate_normal.rvs(mean=None, cov=self._variance, size=N)
        self._rvs.shape = (N, self._variance.shape[1])

    @property
    def variance(self) -> np.ndarray:
        return self._variance

    def __call__(self, repo: Optional[Repository] = None) -> np.ndarray:
        if repo is not None:
            repo.data.df.iloc[:, :] = np.concatenate((repo.X, repo.Y + self._rvs), axis=1)
            repo.data.write()
        return self._rvs


class Function:
    """Build a Repository by sampling ``f(DOE(N,M)) + std(Y) * noise``;
    persists the injected noise covariance as ``likelihood.variance.csv``
    ground truth (reference sample.py:186-254)."""

    def __init__(self, root: Path | str, doe: DOE.Method, function_vector: functions.Vector,
                 N: int, M: int, noise_variance: 'GaussianNoise.Variance',
                 ext: Optional[str] = None, overwrite_existing: bool = False, **kwargs: Any):
        self._N, self._noise_variance = N, noise_variance
        folder = (Path(root) / f'{function_vector.name}.M.{M:d}.{self._noise_variance}.N.{N:d}'
                  f'{"" if ext is None else "." + ext}')
        if folder.is_dir() and not overwrite_existing:
            self._repo = Repository(folder)
        else:
            self._repo = self._construct(
                folder=folder, X=doe(N, M, **kwargs), function_vector=function_vector,
                noise=GaussianNoise(N, self._noise_variance())(repo=None),
                origin_meta={'DOE': doe.__name__, 'function_vector': function_vector.meta,
                             'noise': self._noise_variance.meta})
            pd.DataFrame(self._noise_variance()).to_csv(folder / 'likelihood.variance.csv')

    @property
    def repo(self) -> Repository:
        return self._repo

    def _construct(self, folder: Path | str, X: np.ndarray, function_vector: functions.Vector,
                   noise: np.ndarray, origin_meta: Dict[str, Any]) -> Repository:
        Y = function_vector(X)
        std = np.reshape(np.std(Y, axis=0), (1, -1))
        Y = Y + std * noise
        columns = ([('X', f'X.{i:d}') for i in range(X.shape[1])] +
                   [('Y', f'Y.{i:d}') for i in range(Y.shape[1])])
        df = pd.DataFrame(np.concatenate((X, Y), axis=1),
                          columns=pd.MultiIndex.from_tuples(columns), dtype=float)
        return Repository.from_df(folder=folder, df=df, meta={'origin': origin_meta})
