"""Persistence kernel: Frame (CSV-backed matrix), Data (folder of Frames),
Model (folder + meta.json + Data).

Functional-core / persistent-shell counterpart of the reference's
``romcomma/base/classes.py``. The on-disk formats are identical — each model
parameter is a ``<name>.csv`` with a leading index column, plus a
``meta.json`` — but the in-memory design differs: parameters are plain numpy
arrays flowing into torch functions, not live TF variables. Frames are
write-through on mutation, exactly like the reference (base/classes.py:47-59),
so every model remains resumable from disk at all times.
"""

from __future__ import annotations

import json
import shutil
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import pandas as pd


class Frame:
    """A pandas DataFrame bound 1:1 to ``<csv>.csv`` on disk.

    ``csv`` is the path *without* the ``.csv`` suffix, as in the reference
    (base/classes.py:34-123). Mutating ``np`` writes through to disk.
    """

    def __init__(self, csv: Path | str, data=None, index=None, columns=None, dtype=None, **kwargs):
        self.csv = Path(csv)
        self._write_options: Dict[str, Any] = {}
        if data is None:
            self._df = pd.read_csv(self._path, **({'index_col': 0} | kwargs))
        else:
            self._df = pd.DataFrame(data, index=index, columns=columns, dtype=dtype)
            self.write(**kwargs)

    @property
    def _path(self) -> Path:
        return self.csv.with_suffix(f'{self.csv.suffix}.csv')

    @property
    def df(self) -> pd.DataFrame:
        return self._df

    @property
    def np(self) -> np.ndarray:
        return self._df.values

    @np.setter
    def np(self, value):
        self._df.iloc[:, :] = np.asarray(value)
        self.write()

    def write(self, **kwargs: Any) -> 'Frame':
        self._write_options |= kwargs
        self._df.to_csv(self._path, **self._write_options)
        return self

    def broadcast_value(self, target_shape: Tuple[int, int], is_diagonal: bool = True) -> 'Frame':
        """Broadcast the stored matrix to ``target_shape``; square targets are
        diagonalized when ``is_diagonal`` (reference: base/classes.py:72-89)."""
        try:
            values = np.array(np.broadcast_to(self.np, target_shape))
        except ValueError:
            raise IndexError(f'{self.csv} has shape {self._df.shape} which cannot be broadcast to {target_shape}.')
        if is_diagonal and target_shape[0] > 1:
            values = np.diag(np.diagonal(values))
        self._df = pd.DataFrame(values)
        return self.write()

    def __call__(self) -> np.ndarray:
        return self.np

    def __repr__(self) -> str:
        return str(self.csv)


class Data:
    """A folder of named Frames with per-field default values.

    Subclasses define ``FIELDS: dict[str, np.ndarray]`` mapping field name to
    its default (2d) value — the counterpart of the reference's
    subclass-overridden NamedTuple (base/classes.py:127-236).
    """

    FIELDS: Dict[str, np.ndarray] = {}

    def __init__(self, folder: Path | str, read: bool = False, **kwargs):
        """Create (or read) the Data folder. ``kwargs`` override fields after
        reading defaults/disk, and are written through."""
        self._folder = Path(folder)
        if not read:
            self._folder.mkdir(mode=0o777, parents=True, exist_ok=True)
        self._frames: Dict[str, Frame] = {}
        for field, default in self.FIELDS.items():
            if field in kwargs and kwargs[field] is not None:
                self._frames[field] = Frame(self._folder / field, np.atleast_2d(np.asarray(kwargs[field])))
            elif read:
                self._frames[field] = Frame(self._folder / field)
            else:
                self._frames[field] = Frame(self._folder / field, np.atleast_2d(default))

    @property
    def folder(self) -> Path:
        return self._folder

    @property
    def frames(self) -> Dict[str, Frame]:
        return self._frames

    def __getattr__(self, name: str) -> Frame:
        frames = object.__getattribute__(self, '_frames')
        if name in frames:
            return frames[name]
        raise AttributeError(name)

    def asdict(self) -> Dict[str, Frame]:
        return dict(self._frames)

    def replace(self, **kwargs) -> 'Data':
        """Overwrite fields (writes through to CSV), reference base/classes.py:155-160."""
        for key, value in kwargs.items():
            value = np.asarray(value)
            self._frames[key] = Frame(self._folder / key, np.atleast_2d(value))
        return self

    @staticmethod
    def delete(folder: Path | str) -> Path:
        folder = Path(folder)
        shutil.rmtree(folder, ignore_errors=True)
        return folder

    @staticmethod
    def empty(folder: Path | str) -> Path:
        folder = Data.delete(folder)
        folder.mkdir(mode=0o777, parents=True, exist_ok=False)
        return folder

    @staticmethod
    def copy(src_folder: Path | str, dst_folder: Path | str) -> Path:
        dst_folder = Data.delete(dst_folder)
        shutil.copytree(src=src_folder, dst=dst_folder)
        return dst_folder


class Model(ABC):
    """Abstract persistent model: a folder holding a Data parameter set and a
    ``meta.json`` (reference: base/classes.py:239-321)."""

    class Data(Data):
        FIELDS: Dict[str, np.ndarray] = {}

    #: Default meta, overridden by meta.json on disk, then by call-site kwargs.
    META: Dict[str, Any] = {}

    def __init__(self, folder: Path | str, read_data: bool = False, **kwargs):
        self._folder = Path(folder)
        self._meta_json = self._folder / 'meta.json'
        if not read_data:
            self._folder.mkdir(mode=0o777, parents=True, exist_ok=True)
        self._data = self.Data(self._folder, read=read_data, **kwargs)
        self._implementation = None

    @property
    def folder(self) -> Path:
        return self._folder

    @property
    def data(self) -> Data:
        return self._data

    @data.setter
    def data(self, value: Data):
        self._data = value

    def read_meta(self) -> Dict[str, Any]:
        with open(self._meta_json, mode='r') as file:
            return json.load(file)

    def write_meta(self, meta: Dict[str, Any]):
        with open(self._meta_json, mode='w') as file:
            json.dump(meta, file, indent=8, default=str)

    @abstractmethod
    def calibrate(self, **kwargs) -> Dict[str, Any]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return str(self._folder)

    def __str__(self) -> str:
        return self._folder.name
