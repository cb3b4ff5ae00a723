"""Sampling and Design of Experiments (reference: romcomma/user/sample.py).
Counterpart of ``romcomma_tpu/user/sample.py``: host-side data preparation,
namely DOE generators, artificial Gaussian noise with the reference's
labelling scheme, ``Function``, which builds a Repository by sampling a
``functions.Vector`` over a DOE, ``PCA`` and the sampling CLI:

    python -m romcomma_tpu_torch.user.sample LHS <csv> <M> <N> [<N> ...]
    python -m romcomma_tpu_torch.user.sample PCA <csv> <root>
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import pandas as pd
import scipy.stats

from romcomma_tpu_torch.base.definitions import write_once
from romcomma_tpu_torch.data.storage import Frame, Repository, Fold
from romcomma_tpu_torch.user import functions


def permute_axes(new_order: Optional[Sequence]) -> Optional[np.ndarray]:
    """Rotation matrix reordering input axes (reference sample.py:38-46)."""
    return None if new_order is None else np.eye(len(new_order))[new_order, :]


class DOE:
    """Sampling methods for inputs."""

    Method = Callable[..., np.ndarray]

    @staticmethod
    def latin_hypercube(N: int, M: int, is_centered: bool = True, **kwargs):
        # kwargs forward to the sampler (notably ``seed`` for reproducible
        # designs — the qmc engine is otherwise freshly random per call).
        return scipy.stats.qmc.LatinHypercube(M, scramble=not is_centered,
                                              **kwargs).random(N)

    @staticmethod
    def full_factorial(N: int, M: int) -> np.ndarray:
        """Centered full-factorial grid with ``N // M`` levels per axis.

        Returns the cartesian product of ``M`` axes, each holding ``N // M``
        cell-centered levels in [0, 1): an ``((N//M)**M, M)`` design matrix
        (exactly ``N`` points when ``M == 1``).

        NOTE (reference quirk, fixed as romcomma_tpu fixes it): the reference
        implementation (sample.py:69-81) concatenates 1-D level arrays along
        ``axis=1`` and so raises ``AxisError`` for every input. This is a
        working design of its evident intent.
        """
        levels_per_axis = N // M
        if levels_per_axis < 1:
            raise ValueError(f'full_factorial needs N >= M, got N={N}, M={M}.')
        rows = levels_per_axis ** M
        if rows > 2 ** 24:
            # N is a levels budget, not a row count: a caller passing a sample
            # budget as N at M ~ 30 would otherwise get an astronomically
            # large design instead of an error. 2^24 rows (~4 GB at M=30 in
            # float64) is far beyond any design this package trains on.
            raise ValueError(
                f'full_factorial produces (N // M)**M = {levels_per_axis}**{M} '
                f'= {rows:.3e} rows: N is a levels budget (N // M levels '
                'per axis), not a sample count; use latin_hypercube for '
                'sample-budget designs.')
        centers = (np.arange(levels_per_axis) + 0.5) / levels_per_axis
        mesh = np.meshgrid(*(M * (centers,)), indexing='ij')
        return np.stack([axis.ravel() for axis in mesh], axis=-1)

    @staticmethod
    def space_filling_test(X: np.ndarray, o: int) -> Dict[str, float]:
        """Distance-to-nearest metrics for o test points (sample.py:83-100)."""
        N, M = X.shape
        test = DOE.latin_hypercube(o, M)
        distance = test[:, np.newaxis, :] - X[np.newaxis, :, :]
        distance = np.sqrt(np.amin(np.einsum('iIM, iIM -> iI', distance, distance), axis=1))
        cell_diag = np.power(N, -1 / M) * np.sqrt(M)
        return {'perfect hard upper bound': cell_diag,
                'perfect expected upper bound': cell_diag / np.sqrt(6),
                'perfect expected lower bound': cell_diag / 3,
                'max': np.amax(distance, axis=0), 'mean': np.mean(distance),
                'SD': np.std(distance)}


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
            write_once(pd.DataFrame(self._noise_variance()).to_csv,
                       folder / 'likelihood.variance.csv')

    @property
    def repo(self) -> Repository:
        return self._repo

    def collection(self, sub_folder: Union[Path, str]) -> Dict[str, Any]:
        return {'folder': self._repo.folder / sub_folder, 'N': self._N,
                'noise': self._noise_variance.magnitude}

    def un_rotate_folds(self) -> 'Function':
        """Clone fold ``K`` as an un-rotated fold ``K+1`` (behavioural parity
        with reference sample.py:203-211, re-expressed as romcomma_tpu does).

        The clone's ``X_rotation`` is inverted (transposed), its test data is
        re-written in raw (de-normalized) units, and fold ``K``'s de-normalized
        test data is dropped at the repository root as ``undo_from.csv``.
        The setter composes old @ new, as romcomma_tpu's does, so the clone's
        stored rotation R is replaced by R @ R.T, the identity.
        """
        repo, K = self._repo, self._repo.K
        shutil.copytree(repo.fold_folder(K), repo.fold_folder(K + 1))

        clone = Fold(repo, K + 1)
        clone.X_rotation = clone.X_rotation.T
        raw_test = clone.normalization.undo_from(clone.test_data.df)
        Frame(clone.test_csv, raw_test)

        source = Fold(repo, K)
        Frame(repo.folder / 'undo_from.csv',
              source.normalization.undo_from(source.test_data.df))
        return self

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


def PCA(root: str | Path, csv: str | Path) -> Path:
    """PCA-rotate a csv into root/PCA (reference sample.py:256-267)."""
    root, csv = Path(root), Path(csv)
    Repository.from_csv(root, csv, PCA=True)
    return root / 'PCA'


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Rudimentary sampling functionality.')
    parser.add_argument('function', help='The acronym of the function to use. LHS or PCA.', type=str)
    parser.add_argument('csv', help='The path of the csv containing the data to be analysed.', type=Path)
    parser.add_argument('arguments', help='The arguments required by the specified function.', nargs='*')
    args = parser.parse_args(argv)
    match args.function.upper():
        case 'LHS':
            if len(args.arguments) < 2:
                raise ValueError('LHS takes at least 2 arguments: M then N values.')
            M = int(args.arguments[0])
            if M < 1:
                raise ValueError(f'Number of inputs M={M} must be >= 1.')
            for N in args.arguments[1:]:
                N = int(N)
                if N < 1:
                    raise ValueError('Number of samples must be >= 1.')
                pd.DataFrame(DOE.latin_hypercube(N, M)).to_csv(args.csv.with_stem(args.csv.stem + f'.{N}'))
            print(f'Root path is {args.csv.parent}.')
        case 'PCA':
            if len(args.arguments) != 1:
                raise ValueError('PCA takes one argument, namely the root folder.')
            print(f'Root path is {PCA(Path(args.arguments[0]), args.csv)}.')
        case _:
            raise NameError(f'Unrecognized function: {args.function}. Use LHS or PCA.')


if __name__ == '__main__':
    main()
