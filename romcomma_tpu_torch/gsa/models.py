"""Persistent GSA models: the m-slice loop and S/T/V/W CSV composition.
Counterpart of ``romcomma_tpu/gsa/models.py`` (reference: romcomma/gsa/models.py)."""

from __future__ import annotations

from abc import abstractmethod
from enum import IntEnum, auto
from typing import Any, Dict, List, Tuple

import numpy as np
import pandas as pd
import torch

from romcomma_tpu_torch.base.classes import Data, Model
from romcomma_tpu_torch.base.definitions import write_once
from romcomma_tpu_torch.gsa.calibrators import ClosedSobol, ClosedSobolWithError, marginalize_all
from romcomma_tpu_torch.models.gpr import GPR


class GSA(Model):
    """Generic Sobol' calculation (reference gsa/models.py:35-160)."""

    class Kind(IntEnum):
        FIRST_ORDER = auto()
        CLOSED = auto()
        TOTAL = auto()

    ALL_KINDS: List['GSA.Kind'] = None  # filled below

    META: Dict[str, Any] = {}

    class Data(Data):
        FIELDS: Dict[str, np.ndarray] = {}

    def __init__(self, gp: GPR, kind: 'GSA.Kind', m: int = -1,
                 is_error_calculated: bool = False, **kwargs: Any):
        """Single-use object: construct then ``calibrate()`` once
        (reference gsa/models.py:139-160)."""
        self.gp = gp
        self.is_error_calculated = is_error_calculated
        self.kind = kind
        m = m if 0 <= m < gp.M else -1
        name = kind.name.lower() if m == -1 else f'{kind.name.lower()}.{m}'
        folder = gp.folder / 'gsa' / name
        super().__init__(folder, read_data=False)
        self.meta = {'folder': str(folder), 'm': m, 'M': gp.M} | dict(self.META) | kwargs
        self.write_meta(self.meta)

    @staticmethod
    def _columns(M: int, m_cols: int, m_list: List[int]) -> pd.Index:
        """Output columns: the m indices, appending M (and -1) as needed
        (reference gsa/models.py:49-63)."""
        if m_cols > len(m_list):
            m_list = m_list + [M]
        if m_cols > len(m_list):
            m_list = [-1] + m_list
        return pd.Index(m_list, name='m')

    @staticmethod
    def _index(shape: List[int]) -> pd.MultiIndex:
        """Row MultiIndex over output pairs (reference gsa/models.py:65-75)."""
        indices = [list(range(l)) for l in shape[:-1]]
        return pd.MultiIndex.from_product(indices, names=[f'l.{l}' for l in range(len(indices))])

    @property
    def _m_dataset(self) -> List[Tuple[int, int]]:
        """The slices to marginalize: FIRST_ORDER [m,m+1], CLOSED [0,m+1],
        TOTAL [m+1,M] (reference gsa/models.py:77-90)."""
        m, M = self.meta['m'], self.meta['M']
        ms = range(M) if m < 0 else [m]
        if self.kind == GSA.Kind.FIRST_ORDER:
            return [(mm, mm + 1) for mm in ms]
        elif self.kind == GSA.Kind.CLOSED:
            return [(0, mm + 1) for mm in ms]
        return [(mm + 1, M) for mm in ms]

    @property
    @abstractmethod
    def calibrator(self) -> ClosedSobol:
        raise NotImplementedError

    @abstractmethod
    def _post_calibrate(self, extras: Dict[str, torch.Tensor],
                        results: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _compose_and_save(self, results: Dict[str, np.ndarray]):
        """(reference gsa/models.py:102-115)"""
        m, M = self.meta['m'], self.meta['M']
        m_list = list(range(M)) if m < 0 else [m]
        for key in self._data.frames.keys():
            result = results.get(key, None)
            if result is not None:
                shape = list(result.shape)
                df = pd.DataFrame(result.reshape(-1, shape[-1]),
                                  columns=GSA._columns(M, shape[-1], m_list),
                                  index=GSA._index(shape))
                write_once(df.to_csv, self._folder / f'{key}.csv', float_format='%.6f')

    def calibrate(self, method: str = None, precomputed=None, **kwargs) -> Dict[str, Any]:
        """Marginalize every m-slice, concat along a new last axis,
        post-process, save (reference gsa/models.py:117-137).
        ``precomputed=(results, extras)`` skips the marginalization: run.gsa
        computes all kinds in one pass (calibrators.marginalize_all_kinds)
        and feeds each Sobol its share."""
        if precomputed is None:
            results, extras = marginalize_all(self.gp, tuple(self._m_dataset),
                                              self.is_error_calculated, **self.meta)
        else:
            results, extras = precomputed
            results = dict(results)
        results = self._post_calibrate(extras, results)
        self._compose_and_save({key: value.cpu().numpy() for key, value in results.items()})
        return self.meta


GSA.ALL_KINDS = [kind for kind in GSA.Kind]


class Sobol(GSA):
    """The concrete Sobol' GSA with S/T/V/W outputs (reference gsa/models.py:163-214)."""

    class Data(Data):
        FIELDS = {'S': np.atleast_2d(None), 'T': np.atleast_2d(None),
                  'V': np.atleast_2d(None), 'W': np.atleast_2d(None)}

    META: Dict[str, Any] = ClosedSobolWithError.META

    @property
    def calibrator(self) -> ClosedSobol:
        """A fresh calibrator of this GSA's model and meta, with standard
        errors where they are calculated (romcomma_tpu gsa/models.py:134-137);
        ``calibrate`` runs its own pass."""
        return (ClosedSobolWithError(self.gp, **self.meta) if self.is_error_calculated
                else ClosedSobol(self.gp, **self.meta))

    def _post_calibrate(self, extras: Dict[str, torch.Tensor],
                        results: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Append the m=M column; TOTAL converts S to S_M - S_complement
        (reference gsa/models.py:207-214)."""
        results['V'] = torch.cat([results['V'], extras['V0'][..., None]], dim=-1)
        results['S'] = (extras['S'][..., None] - results['S']
                        if self.kind == GSA.Kind.TOTAL else results['S'])
        results['S'] = torch.cat([results['S'], extras['S'][..., None]], dim=-1)
        if 'T' in results and not self.meta['is_T_partial']:
            results['T'] = (extras['T'][..., None] + results['T']
                            if self.kind == GSA.Kind.TOTAL else results['T'])
            results['T'] = torch.cat([results['T'], extras['T'][..., None]], dim=-1)
        return results
