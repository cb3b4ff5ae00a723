"""Dataset persistence: Repository, Fold, Normalization.

Host-side (pandas/numpy) data preparation, byte-compatible with the reference
formats (romcomma/data/storage.py): a Repository is a folder holding
``data.csv`` (two header rows: X/Y group + column name, plus an index column)
and ``meta.json``; Folds are subfolders ``fold.k`` adding ``test.csv``,
``normalization.csv`` and a cumulative ``X_rotation.csv``.

Semantic traps preserved from the reference (SURVEY.md §7):
  - ``into_K_folds(K)`` with K>0 adds an *improper* fold indexed K that trains
    AND tests on all data; negative K suppresses it (storage.py:162-204).
  - ``rotate_folds`` falls back to a random special-orthogonal rotation when
    given a wrong-shaped or non-orthogonal matrix (storage.py:206-221).
  - X normalization assumes Uniform inputs: affine to U[0,1] clipped at
    1e-12, then inverse-normal transformed to N(0,1); Y is standardized.
    Both use *training* statistics for train and test (storage.py:414-437).
  - X_rotation composes cumulatively on disk (storage.py:385-396).
"""

from __future__ import annotations

import itertools
import json
import random
import shutil
from copy import deepcopy
from enum import IntEnum, auto
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import scipy.stats


class Frame:
    """A pd.DataFrame backed by a csv file with the dataset header layout
    (2 header rows + index column), reference storage.py:39-88."""

    CSV_OPTIONS: Dict[str, Any] = {'sep': ',', 'header': [0, 1], 'index_col': 0}

    def __init__(self, csv: Path | str = Path(), df: pd.DataFrame | None = None, **kwargs):
        self._csv = Path(csv)
        if self.is_empty:
            assert df is None or df.empty, 'csv is an empty path, but df is not empty.'
            self.df = pd.DataFrame() if df is None else df
        elif df is None or df.empty:
            self.df = pd.read_csv(self._csv, **{**Frame.CSV_OPTIONS, **kwargs})
        else:
            self.df = df
            self.write()

    @property
    def csv(self) -> Path:
        return self._csv

    @property
    def is_empty(self) -> bool:
        return 0 == len(self._csv.parts)

    def write(self):
        assert not self.is_empty, 'refusing to write an empty Frame (no csv/df attached).'
        self.df.to_csv(path_or_buf=self._csv, sep=Frame.CSV_OPTIONS['sep'], index=True)

    def __repr__(self) -> str:
        return str(self._csv)


class Repository:
    """A folder containing ``data.csv`` and ``meta.json``, optionally holding
    Folds (reference storage.py:91-343)."""

    class InitMode(IntEnum):
        READ_META_ONLY = auto()
        READ = auto()
        CREATE = auto()

    META: Dict[str, Any] = {'csv_kwargs': Frame.CSV_OPTIONS, 'data': {}, 'K': 0,
                            'shuffle before folding': False}

    CSV_OPTIONS: Dict[str, Any] = {'skiprows': None, 'index_col': 0}

    def __init__(self, folder: Path | str, **kwargs):
        self._folder = Path(folder)
        self._meta_json = self._folder / 'meta.json'
        self._csv = self._folder / 'data.csv'
        self._data: Optional[Frame] = None
        init_mode = kwargs.get('init_mode', Repository.InitMode.READ)
        if init_mode <= Repository.InitMode.READ:
            self._meta = self.read_meta()
            if init_mode is Repository.InitMode.READ:
                self._data = Frame(self._csv)
        else:
            shutil.rmtree(self._folder, ignore_errors=True)
            self._folder.mkdir(mode=0o777, parents=True, exist_ok=False)

    # -- basic accessors ---------------------------------------------------- #

    @property
    def folder(self) -> Path:
        return self._folder

    @property
    def data(self) -> Frame:
        return self._data

    @property
    def X(self) -> pd.DataFrame:
        return self._data.df[self._meta['data']['X_heading']]

    @property
    def Y(self) -> pd.DataFrame:
        return self._data.df[self._meta['data']['Y_heading']]

    @property
    def meta(self) -> Dict[str, Any]:
        return self._meta

    @property
    def N(self) -> int:
        return self._meta['data']['N']

    @property
    def M(self) -> int:
        return self._meta['data']['M']

    @property
    def L(self) -> int:
        return self._meta['data']['L']

    @property
    def K(self) -> int:
        return self._meta['K']

    def read_meta(self) -> Dict[str, Any]:
        with open(self._meta_json, mode='r') as file:
            return json.load(file)

    def write_meta(self):
        with open(self._meta_json, mode='w') as file:
            json.dump(self._meta, file, indent=8)

    def _update_meta(self):
        self._meta.update({'data': {'X_heading': self._data.df.columns.values[0][0],
                                    'Y_heading': self._data.df.columns.values[-1][0]}})
        self._meta['data'].update({'N': self._data.df.shape[0], 'M': self.X.shape[1],
                                   'L': self.Y.shape[1]})
        self.write_meta()

    # -- folds -------------------------------------------------------------- #

    @property
    def folds(self) -> range:
        if isinstance(self, Fold) or self.K < 1:
            return range(0, 0)
        return range(self.K + (1 if self._meta.get('has_improper_fold', False) else 0))

    def fold_folder(self, k: int) -> Path:
        return self._folder / f'fold.{k:d}'

    @staticmethod
    def _fold_labels(N: int, K: int) -> List[int]:
        """Per-row fold labels for the round-robin K-fold assignment: each
        consecutive block of K rows carries one shuffled permutation of the
        fold labels 0..K-1 (the final partial block a shuffled prefix), so
        every fold's test share is spread evenly along the row order.

        The `random` consumption order is byte-format-critical: it must
        reproduce the reference's fold assignment exactly
        (reference storage.py:192-203), so blocks shuffle in row order.
        """
        blocks = [list(range(K)) for _ in range(N // K)]
        blocks.append(list(range(N % K)))
        for block in blocks:
            random.shuffle(block)
        return list(itertools.chain(*blocks))

    def into_K_folds(self, K: int, shuffle_before_folding: bool = False,
                     normalization: Optional[Path | str] = None,
                     is_normalization_applicable: bool = True) -> 'Repository':
        """K-fold split; K>0 additionally creates the improper fold indexed K
        containing all data as both train and test (reference storage.py:162-204)."""
        data = self._data.df
        N = data.shape[0]
        if not (1 <= abs(K) <= N):
            raise IndexError(f'fold count K={K:d} must satisfy 1 <= K <= N={N:d}.')
        for k in range(max(abs(K), self.K) + 1):
            shutil.rmtree(self.fold_folder(k), ignore_errors=True)
        rows = list(range(N))
        if shuffle_before_folding:
            random.shuffle(rows)
        self._meta.update({'K': abs(K), 'shuffle before folding': shuffle_before_folding,
                           'has_improper_fold': K > 0})
        self.write_meta()
        normalization = (Normalization(self, self._data.df).csv if normalization is None
                         else normalization)

        def make_fold(k: int, train_rows: List[int], test_rows: List[int]):
            Fold.from_dfs(parent=self, k=k, data=data.iloc[train_rows],
                          test_data=data.iloc[test_rows], normalization=normalization,
                          is_normalization_applicable=is_normalization_applicable)

        if K > 0:      # the improper fold trains AND tests on all data
            make_fold(K, rows, rows)
        K = abs(K)
        labels = self._fold_labels(N, K)
        for k in range(K):
            train_rows = [row for row, label in zip(rows, labels) if label != k]
            test_rows = [row for row, label in zip(rows, labels) if label == k]
            # K=1 leaves no train rows: that single fold trains on its test set.
            make_fold(k, train_rows or test_rows, test_rows)
        return self

    def rotate_folds(self, rotation: Optional[np.ndarray]) -> 'Repository':
        """Apply one (M,M) rotation to every fold's inputs; invalid input
        triggers a random special-orthogonal rotation (storage.py:206-221)."""
        M = self.M
        if rotation is None:
            rotation = np.eye(M)
        elif rotation.shape != (M, M) or not np.allclose(np.dot(rotation, rotation.T), np.eye(M)):
            rotation = scipy.stats.special_ortho_group.rvs(M)
        for k in self.folds:
            Fold(self, k).X_rotation = rotation
        return self

    def Y_split(self):
        """Split into L single-output sub-repositories ``Y.l`` (storage.py:226-243)."""
        if isinstance(self, Fold):
            raise TypeError('Cannot Y_split a Fold, only a Repository.')
        for l in range(self.L):
            destination = self._folder / f'Y.{l:d}'
            indices = np.append(np.arange(self.M), self.M + l)
            data = self._data.df.take(indices, axis=1)
            meta = deepcopy(self._meta)
            meta['data']['L'] = 1
            Repository.from_df(destination, data, meta)

    @property
    def Y_splits(self) -> List[Tuple[int, Path]]:
        return [(int(Y_dir.suffix[1:]), Y_dir) for Y_dir in self._folder.glob('Y.[0-9]*')]

    # -- constructors ------------------------------------------------------- #

    @classmethod
    def from_df(cls, folder: Path | str, df: pd.DataFrame,
                meta: Dict | None = None) -> 'Repository':
        repo = Repository(folder, init_mode=Repository.InitMode.CREATE)
        repo._meta = dict(cls.META) | ({} if meta is None else meta)
        repo._data = Frame(repo._csv, df)
        repo._update_meta()
        return repo

    @classmethod
    def from_csv(cls, folder: Path | str, csv: Path | str, PCA: bool = False,
                 meta: Dict | None = None, **kwargs) -> 'Repository':
        """Create from a user csv; PCA=True additionally builds a single fold
        rotated onto the input principal components (storage.py:303-343)."""
        csv = Path(csv)
        origin_csv_kwargs = dict(cls.CSV_OPTIONS) | kwargs
        data = Frame(csv, **origin_csv_kwargs)
        meta = dict(cls.META) if meta is None else dict(cls.META) | meta
        meta['origin'] = {'csv': str(csv.absolute()), 'origin_csv_kwargs': origin_csv_kwargs}
        repo = cls.from_df(folder, data.df, meta)
        if PCA:
            repo = repo.into_K_folds(-1)
            fold = Repository(repo.fold_folder(0))
            X = fold.X.values
            cov = np.cov(X, rowvar=False)
            eigenvalues, eigenvectors = np.linalg.eigh(cov)
            idx = eigenvalues.argsort()[::-1]
            eigenvalues, eigenvectors = eigenvalues[idx], eigenvectors[:, idx]
            repo = repo.rotate_folds(eigenvectors.T)
            fold = Fold(repo, 0)
            fold.data.df.iloc[:, :fold.M] /= np.sqrt(eigenvalues)
            fold.test_data.df.iloc[:, :fold.M] /= np.sqrt(eigenvalues)
            fold.data.write()
            fold.test_data.write()
            folder = repo.fold_folder(0)
            folder.rename(folder.parent / 'PCA')
        return repo

    def __repr__(self) -> str:
        return str(self._folder)

    def __str__(self) -> str:
        return self._folder.name


class Fold(Repository):
    """A Repository plus ``test.csv``, a Normalization, and a cumulative
    ``X_rotation.csv`` (reference storage.py:346-437)."""

    def __init__(self, parent: Repository, k: int, **kwargs):
        init_mode = kwargs.get('init_mode', Repository.InitMode.READ)
        super().__init__(parent.fold_folder(k), init_mode=init_mode)
        self._X_rotation = self._folder / 'X_rotation.csv'
        self._test_csv = self._folder / 'test.csv'
        if init_mode == Repository.InitMode.READ:
            self._test_data = Frame(self._test_csv)
            self._normalization = Normalization(self)

    @property
    def normalization(self) -> 'Normalization':
        return self._normalization

    @property
    def test_csv(self) -> Path:
        return self._test_csv

    @property
    def test_data(self) -> Frame:
        return self._test_data

    @property
    def test_x(self) -> pd.DataFrame:
        return self._test_data.df[self._meta['data']['X_heading']]

    @property
    def test_y(self) -> pd.DataFrame:
        return self._test_data.df[self._meta['data']['Y_heading']]

    def _X_rotate(self, frame: Frame, rotation: np.ndarray):
        frame.df.iloc[:, :self.M] = np.einsum('Nm,Mm->NM', frame.df.iloc[:, :self.M], rotation)
        frame.write()

    @property
    def X_rotation(self) -> np.ndarray:
        return (pd.read_csv(self._X_rotation, header=[0], index_col=0).values
                if self._X_rotation.exists() else np.eye(self.M))

    @X_rotation.setter
    def X_rotation(self, value: np.ndarray):
        self._X_rotate(self._data, value)
        self._X_rotate(self._test_data, value)
        old_value = self.X_rotation
        pd.DataFrame(np.matmul(old_value, value)).to_csv(self._X_rotation)

    @classmethod
    def from_dfs(cls, parent: Repository, k: int, data: pd.DataFrame,
                 test_data: pd.DataFrame, normalization: Optional[Path | str] = None,
                 is_normalization_applicable: bool = True) -> 'Fold':
        fold = cls(parent, k, init_mode=Repository.InitMode.CREATE)
        fold._meta = dict(cls.META) | parent.meta | {'k': k}
        fold._normalization = Normalization(fold, data, is_normalization_applicable)
        if normalization is not None:
            # The copy lands on disk only: apply_to below still uses the
            # already-computed in-memory (training) stats, exactly like the
            # reference (storage.py:429-435 — the Frame is already cached).
            shutil.copy(Path(normalization), fold._normalization.csv)
        fold._data = Frame(fold._csv, fold._normalization.apply_to(data))
        fold._test_data = Frame(fold._test_csv, fold._normalization.apply_to(test_data))
        fold._update_meta()
        return fold


class Normalization:
    """Per-fold normalization: X Uniform -> U[0,1] (clipped 1e-12) ->
    N(0,1) via the inverse normal CDF; Y standardized. Stats persist as rows
    mean/std/rng/min/max of ``normalization.csv`` (storage.py:440-558)."""

    UNIFORM_MARGIN: float = 1.0e-12

    def __init__(self, fold: Repository, data: Optional[pd.DataFrame] = None,
                 is_applicable: bool = True):
        self._fold = fold
        self._is_applicable = is_applicable
        self._frame: Optional[Frame] = None
        if self.csv.exists():
            self._frame = Frame(self.csv)
        elif data is not None:
            mean = data.mean(); mean.name = 'mean'
            std = data.std(); std.name = 'std'
            semi_range = std * np.sqrt(3); semi_range.name = 'rng'
            m_min = mean - semi_range; m_min.name = 'min'
            m_max = mean + semi_range; m_max.name = 'max'
            df = pd.concat((mean, std, 2 * semi_range, m_min, m_max), axis=1)
            self._frame = Frame(self.csv, df.T)

    @property
    def csv(self) -> Path:
        return self._fold.folder / 'normalization.csv'

    @property
    def frame(self) -> Frame:
        if self._frame is None:
            self._frame = Frame(self.csv)
        return self._frame

    @property
    def is_applicable(self) -> bool:
        return self._is_applicable

    @property
    def _relevant_stats(self):
        df = self.frame.df
        M = self._fold.M
        return (df.iloc[df.index.get_loc('min'), :M], df.iloc[df.index.get_loc('rng'), :M],
                df.iloc[df.index.get_loc('mean'), M:], df.iloc[df.index.get_loc('std'), M:])

    def apply_to(self, df: pd.DataFrame) -> pd.DataFrame:
        if not self._is_applicable:
            return df
        X_min, X_rng, Y_mean, Y_std = self._relevant_stats
        X = df.iloc[:, :len(X_min)].copy(deep=True)
        Y = df.iloc[:, len(X_min):].copy(deep=True)
        X = (X.sub(X_min.values, axis=1).div(X_rng.values, axis=1)
             .clip(lower=self.UNIFORM_MARGIN, upper=1 - self.UNIFORM_MARGIN))
        X.iloc[:, :] = scipy.stats.norm.ppf(X, loc=0, scale=1)
        Y = Y.sub(Y_mean.values, axis=1).div(Y_std.values, axis=1)
        return pd.concat((X, Y), axis=1)

    def undo_from(self, df: pd.DataFrame) -> pd.DataFrame:
        if not self._is_applicable:
            return df
        X_min, X_rng, Y_mean, Y_std = self._relevant_stats
        X = df.iloc[:, :len(X_min)].copy(deep=True)
        Y = df.iloc[:, len(X_min):].copy(deep=True)
        X.iloc[:, :] = scipy.stats.norm.cdf(X, loc=0, scale=1)
        X = X.mul(X_rng.values, axis=1).add(X_min.values, axis=1)
        Y = Y.mul(Y_std.values, axis=1).add(Y_mean.values, axis=1)
        return pd.concat((X, Y), axis=1)

    def unscale_Y(self, dfY: pd.DataFrame) -> pd.DataFrame:
        """Scale back by Y std without re-adding the mean — for SDs
        (storage.py:505-513)."""
        if not self._is_applicable:
            return dfY
        _, _, _, Y_std = self._relevant_stats
        return dfY.copy(deep=True).mul(Y_std.values, axis=1)

    def __repr__(self) -> str:
        return str(self.csv)
