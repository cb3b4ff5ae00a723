"""Constrained-parameter transforms (softplus bijectors).

Counterpart of ``romcomma_tpu/ops/transforms.py``. The reference constrains
positive hyperparameters through gpflow's ``positive()`` bijector: softplus,
optionally shifted by a lower bound. The same transforms act here on raw
tensors, so L-BFGS works in unconstrained space.
"""

from __future__ import annotations

import numpy as np
import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    # logaddexp, not torch.nn.functional.softplus: the latter returns x itself
    # above its threshold of 20, which is off by log1p(exp(-x)) ~ 2e-9 there.
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y: torch.Tensor) -> torch.Tensor:
    # log(exp(y) - 1), stable: y + log1p(-exp(-y))
    return y + torch.log(-torch.expm1(-y))


def positive(raw: torch.Tensor, lower: float = 0.0) -> torch.Tensor:
    """Constrained value from raw: lower + softplus(raw)."""
    return lower + softplus(raw)


def positive_inverse(value: torch.Tensor, lower: float = 0.0) -> torch.Tensor:
    """Raw parameter from constrained value."""
    return inv_softplus(value - lower)


def np_inv_softplus(y: np.ndarray) -> np.ndarray:
    y = np.asarray(y, dtype=np.float64)
    return y + np.log1p(-np.exp(-y))


def tril_indices_strict(L: int):
    """Row/col indices of the strictly-lower triangle, row-major — the packing
    order the reference uses for the trainable Cholesky lower triangle
    (gpf/base.py:93-94)."""
    rows, cols = np.tril_indices(L, k=-1)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order]


def pack_tril_strict(mat: np.ndarray) -> np.ndarray:
    """Flatten the strictly-lower triangle of (L,L) mat, row-major."""
    rows, cols = tril_indices_strict(mat.shape[-1])
    return np.asarray(mat)[..., rows, cols]


def build_tril(diag: torch.Tensor, flat_lower: torch.Tensor) -> torch.Tensor:
    """Lower-triangular matrix from diagonal (L,) and strict-lower flat vector."""
    rows, cols = tril_indices_strict(diag.shape[-1])
    out = torch.diag(diag)
    if len(rows):
        out = out.index_put((torch.as_tensor(rows), torch.as_tensor(cols)), flat_lower)
    return out
