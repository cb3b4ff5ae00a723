"""GSA primitives: the (un-normalized) Gaussian pdf algebra.

Counterpart of ``romcomma_tpu/gsa/base.py`` and of the reference's
``romcomma/gsa/base.py``. ``Gaussian`` stores a pdf as a broadcast-aware
(exponent, cho_diag) pair so *ratios* of Gaussians cost one exp and no
overflow (reference gsa/base.py:52-127). Broadcast semantics, including the
LBunch axis-insertion rule and the equal-shape outer-product rule, are
reproduced exactly, since every ClosedSobol einsum downstream depends on them.

Everything here runs in float64 on the device of its inputs: the card has
native float64, so none of the JAX package's emulated-float64 exp tiers
(``shifted_exp``, ``exp_mode_of``, ``ff_exp_nonpos``) or its reduce-instead-
of-einsum switch (``contract_by_reduce``) carry over.
"""

from __future__ import annotations

import copy
from abc import ABC, abstractmethod
from typing import Dict, Sequence

import torch

from romcomma_tpu_torch.ops.linalg import tri_solve


def diag_det(tensor: torch.Tensor) -> torch.Tensor:
    """Determinant of a diagonal tensor stored as its last axis."""
    return torch.prod(tensor, dim=-1)


class Calibrator(ABC):
    """Interface to a GSA calibrator."""

    @abstractmethod
    def marginalize(self, m) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class Gaussian:
    """An un-normalized Gaussian pdf held as (exponent, cho_diag).

    ``pdf = exp(exponent) / prod(cho_diag, -1)``: the 2*pi factor is omitted
    throughout, exactly as in the reference (gsa/base.py:52-66).
    """

    exponent: torch.Tensor
    cho_diag: torch.Tensor

    def __init__(self, mean: torch.Tensor, variance: torch.Tensor,
                 is_variance_diagonal: bool, ordinate=None, LBunch: int = 2):
        mean = torch.as_tensor(mean)
        variance = torch.as_tensor(variance, device=mean.device)
        ordinate = torch.as_tensor(0.0 if ordinate is None else ordinate, dtype=mean.dtype,
                                   device=mean.device)
        variance_cho = (torch.sqrt(variance) if is_variance_diagonal
                        else torch.linalg.cholesky(variance))
        # Equal-shape rule: ordinate and mean expand into each other's batch
        # dims (outer product), reference gsa/base.py:108-112.
        if ordinate.shape == mean.shape:
            shape = list(ordinate.shape)
            fill = [1] * (len(shape) - 1)
            ordinate = ordinate.reshape(shape[:-1] + fill + [shape[-1]])
            mean = mean.reshape(fill + shape)
        ordinate = ordinate - mean
        # LBunch rule: insert broadcast axes into variance_cho every LBunch
        # output dims, reference gsa/base.py:114-118.
        insertions = variance_cho.ndim - (1 if is_variance_diagonal else 2)
        insertions -= insertions % LBunch
        for axis in range(insertions, 0, -LBunch):
            variance_cho = torch.unsqueeze(variance_cho, axis)
        if is_variance_diagonal:
            target = tuple(variance_cho.shape[:-2]) + tuple(ordinate.shape[-2:])
            exponent = ordinate / torch.broadcast_to(variance_cho, target)
        else:
            exponent = torch.squeeze(tri_solve(variance_cho, ordinate[..., None]), -1)
        self.exponent = -0.5 * torch.einsum('...o, ...o -> ...', exponent, exponent)
        self.cho_diag = (variance_cho if is_variance_diagonal
                         else torch.diagonal(variance_cho, dim1=-2, dim2=-1))

    @property
    def det(self) -> torch.Tensor:
        """sqrt-determinant of the covariance (product of Cholesky diagonal)."""
        return torch.prod(self.cho_diag, dim=-1)

    @property
    def pdf(self) -> torch.Tensor:
        return torch.exp(self.exponent) / self.det

    def expand_dims(self, axes: Sequence[int]) -> 'Gaussian':
        result = copy.copy(self)
        for axis in sorted(axes, reverse=True):
            result.exponent = torch.unsqueeze(result.exponent, axis)
            result.cho_diag = torch.unsqueeze(result.cho_diag, (axis - 1) if axis < 0 else axis)
        return result

    def __truediv__(self, other: 'Gaussian') -> 'Gaussian':
        result = copy.copy(self)
        result.exponent = self.exponent - other.exponent
        result.cho_diag = self.cho_diag / other.cho_diag
        return result


def sym_check(tensor: torch.Tensor, transposition: Sequence[int]) -> torch.Tensor:
    """Symmetry residual: debug reduction (reference gsa/base.py:129-130)."""
    return torch.sum((tensor - torch.permute(tensor, tuple(transposition))) ** 2)


def mean(tensor: torch.Tensor) -> torch.Tensor:
    """Mean: debug reduction (reference gsa/base.py:133-135)."""
    return torch.sum(tensor) / tensor.numel()


def sos(tensor: torch.Tensor) -> torch.Tensor:
    """Sum of squares: debug reduction (reference gsa/base.py:138-140)."""
    return torch.sum(tensor * tensor)


def ms(tensor: torch.Tensor) -> torch.Tensor:
    """Mean square: debug reduction (reference gsa/base.py:143-145)."""
    return sos(tensor) / tensor.numel()


def rms(tensor: torch.Tensor) -> torch.Tensor:
    """Root mean square: debug reduction (reference gsa/base.py:148-150)."""
    return torch.sqrt(ms(tensor))
