"""Dense linear algebra helpers for the GP hot path, on ``torch.linalg``
(cuSOLVER and cuBLAS on a CUDA device). Counterpart of
``romcomma_tpu/ops/linalg.py``."""

from __future__ import annotations

import math

import torch


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, batched over leading dims. Like the JAX
    package's, a factorization that breaks down yields NaN instead of raising,
    so an optimizer sees a non-finite objective and backs off."""
    chol, info = torch.linalg.cholesky_ex(a)
    return chol.masked_fill((info > 0)[..., None, None], math.nan)


def tri_solve(chol: torch.Tensor, b: torch.Tensor, lower: bool = True,
              trans: bool = False) -> torch.Tensor:
    """Solve chol x = b (or cholᵀ x = b) for triangular chol; batch
    dimensions broadcast against each other."""
    dt = torch.promote_types(chol.dtype, b.dtype)
    chol, b = chol.to(dt), b.to(dt)
    if trans:
        return torch.linalg.solve_triangular(chol.mT, b, upper=lower)
    return torch.linalg.solve_triangular(chol, b, upper=not lower)


def cho_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (chol cholᵀ) x = b given the lower Cholesky factor; batched."""
    return tri_solve(chol, tri_solve(chol, b, lower=True, trans=False),
                     lower=True, trans=True)


def add_diag(a: torch.Tensor, d) -> torch.Tensor:
    """Add d (scalar or (N,) vector) to the diagonal of (..., N, N) a."""
    n = a.shape[-1]
    d = torch.as_tensor(d, dtype=a.dtype, device=a.device)
    return a + torch.eye(n, dtype=a.dtype, device=a.device) * d[..., None]


def mvn_logpdf(y: torch.Tensor, mean: torch.Tensor, chol: torch.Tensor) -> torch.Tensor:
    """Multivariate-normal log density of columns of y (N,D) under N(mean, chol cholᵀ).

    Matches gpflow.logdensities.multivariate_normal: returns (D,) — one log
    density per column of y (reference call: gpf/models.py:82).
    """
    alpha = tri_solve(chol, y - mean, lower=True)
    num_dims = y.shape[0]
    p = -0.5 * torch.sum(alpha * alpha, dim=0)
    p = p - 0.5 * num_dims * math.log(2.0 * math.pi)
    return p - torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)))
