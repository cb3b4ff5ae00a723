"""Persistent Kernel wrappers (reference: romcomma/gpr/kernels.py).

A Kernel is a Model folder holding ``variance.csv`` ((L,L), (1,L) or (1,1))
and ``lengthscales.csv`` ((L,M) or (L,1)); ``calibrate`` merely resolves the
trainability META flags. The compute lives in ``romcomma_tpu_torch.models.gp`` —
there is no per-output object tuple (reference gpr/kernels.py:163-180): the
functional core loops over L instead.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple, Type

import numpy as np

from romcomma_tpu_torch.base.classes import Data, Model


class Kernel(Model):
    """Abstract persistent kernel (reference gpr/kernels.py:30-160)."""

    class Data(Data):
        FIELDS = {'variance': np.atleast_2d(2.0), 'lengthscales': np.atleast_2d(5.0)}

    META: Dict[str, Any] = {'variance': True, 'covariance': False,
                            'lengthscales': {'variant': True, 'covariant': False}}

    @classmethod
    def TYPE_IDENTIFIER(cls) -> str:
        """'kernels.<ClassName>' — stored in the GPR's data.csv and kept
        identical to the reference for on-disk compatibility
        (gpr/kernels.py:72-76)."""
        return 'kernels.' + cls.__name__

    @classmethod
    def TypeFromIdentifier(cls, type_identifier: str) -> Type['Kernel']:
        for kernel_type in cls.__subclasses__():
            if kernel_type.TYPE_IDENTIFIER() == type_identifier:
                return kernel_type
        raise TypeError(f'Kernel TypeIdentifier {type_identifier!r} unrecognized.')

    def __init__(self, folder: Path | str, read_data: bool = False, **kwargs):
        super().__init__(folder, read_data, **kwargs)
        variance_shape = self._data.variance.df.shape
        self._L = variance_shape[1]
        self._M = self._data.lengthscales.df.shape[1]
        self.broadcast_parameters(variance_shape, self._M)

    @property
    def L(self) -> int:
        return self._L

    @property
    def M(self) -> int:
        return self._M

    @property
    def is_covariant(self) -> bool:
        return self._data.variance.df.shape[0] > 1

    def broadcast_parameters(self, variance_shape: Tuple[int, int], M: int) -> 'Kernel':
        """Grow (1,1)->(1,L)->(L,L diagonal) variance and isotropic->ARD
        lengthscales (reference gpr/kernels.py:121-139)."""
        if variance_shape != self._data.variance.df.shape:
            self._data.variance.broadcast_value(target_shape=variance_shape, is_diagonal=True)
            self._L = variance_shape[1]
        if (self._L, M) != self._data.lengthscales.df.shape:
            self._data.lengthscales.broadcast_value(target_shape=(self._L, M), is_diagonal=False)
            self._M = M
        return self

    def calibrate(self, **kwargs: Any) -> Dict[str, Any]:
        """Resolve trainability flags only (reference gpr/kernels.py:59-70)."""
        return dict(self.META) | kwargs


class RBF(Kernel):
    """ARD-RBF kernel: k(d) = sigma^2 exp(-1/2 r^2)."""
    pass
