"""Generalized least squares regression (reference: romcomma/user/regression.py:36-58).
Counterpart of ``romcomma_tpu/user/regression.py``: a double-Cholesky solve in
float64 on the compute device."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from romcomma_tpu_torch.base.definitions import device
from romcomma_tpu_torch.ops.linalg import cholesky, tri_solve


def gls(X, y, cov_y, is_through_origin: bool = False,
        on: Optional[torch.device] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """GLS linear regression.

    Args:
        X: (N,M) regressors. y: (N,1) observations. cov_y: (N,N) covariance.
        is_through_origin: True constrains y(0)=0 (no intercept column).
        on: the device to compute on (default: the compute device).
    Returns: ((M[+1],1) coefficients, their covariance matrix), float64 on
        that device; the intercept, when present, is the LAST coefficient (the
        reference pads a ones column on the right, regression.py:49-50).
    """
    on = device() if on is None else on
    X, y, cov_y = (torch.as_tensor(a, dtype=torch.float64, device=on) for a in (X, y, cov_y))
    if not is_through_origin:
        X = torch.nn.functional.pad(X, (0, 1), value=1.0)
    cov_cho = cholesky(cov_y)
    precision_cho_X = tri_solve(cov_cho, X)
    precision_cho_y = tri_solve(cov_cho, y)
    cov_beta_cho = cholesky(precision_cho_X.T @ precision_cho_X)
    inv = tri_solve(cov_beta_cho, torch.eye(X.shape[-1], dtype=X.dtype, device=on))
    cov_beta = inv.T @ inv
    beta = cov_beta.T @ (precision_cho_X.T @ precision_cho_y)
    return beta, cov_beta
