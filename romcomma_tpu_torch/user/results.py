"""Result collection: cross-fold/cross-folder CSV concatenation with
provenance columns (reference: romcomma/user/results.py). Counterpart of
``romcomma_tpu/user/results.py``."""

from __future__ import annotations

from pathlib import Path
from shutil import rmtree
from typing import Any, Dict, Union

import numpy as np
import pandas as pd

from romcomma_tpu_torch.data.storage import Repository, Fold


class Collect:
    """Concatenate named csvs across folders or folds, inserting provenance
    columns (fold k, N, model name, ...) from right to left
    (reference results.py:45-128)."""

    write_options: Dict[str, Any] = {'index': False, 'float_format': '%.6f'}

    def __init__(self, csvs: Dict[str, Dict[str, Any]] | None = None,
                 folders: Dict[str, Dict[str, Any]] | None = None,
                 ignore_missing: bool = False, **kwargs: Any):
        self.csvs = {} if csvs is None else csvs
        self.folders = {} if folders is None else folders
        self.ignore_missing = ignore_missing
        self.write_options = dict(Collect.write_options) | kwargs

    def __call__(self, dst: Union[Repository, Path, str], is_existing_deleted=False, **kwargs: Any):
        if isinstance(dst, Repository):
            return self.from_folds(dst, is_existing_deleted, **kwargs)
        return self.from_folders(dst, is_existing_deleted, **kwargs)

    def from_folders(self, dst: Union[Path, str], is_existing_deleted=False, **kwargs: Any) -> 'Collect':
        dst = Path(dst)
        if is_existing_deleted:
            rmtree(dst, ignore_errors=True)
        dst.mkdir(mode=0o777, parents=True, exist_ok=True)
        for csv, read_options in self.csvs.items():
            results = None
            for folder, columns in self.folders.items():
                file = Path(folder) / f'{csv}.csv'
                if file.exists() or not self.ignore_missing:
                    result = pd.read_csv(file, **read_options)
                    for key, value in columns.items():
                        result.insert(0, key, np.full(result.shape[0], value), True)
                    results = (result.copy(deep=True) if results is None
                               else pd.concat([results, result.copy(deep=True)],
                                              axis=0, ignore_index=True))
            if not (results is None and self.ignore_missing):
                results.to_csv(dst / f'{csv}.csv', **(self.write_options | kwargs))
        return self

    def from_folds(self, dst: Repository, is_existing_deleted=False, **kwargs: Any) -> 'Collect':
        if isinstance(dst, Fold):
            raise NotADirectoryError('dst is a Fold, which cannot contain other Folds.')
        # meta.json is all that's needed (k, N): skip the data/test/
        # normalization CSV reads a full Fold construction would pay.
        folds = tuple(Fold(dst, k, init_mode=Repository.InitMode.READ_META_ONLY)
                      for k in dst.folds)
        for sub_folder, extra_columns in self.folders.items():
            folders = {fold.folder / sub_folder: {'fold': fold.meta['k'], 'N': fold.N} | extra_columns
                       for fold in folds}
            Collect(self.csvs, folders, self.ignore_missing).from_folders(
                dst.folder / sub_folder, is_existing_deleted, **kwargs)
        return self
