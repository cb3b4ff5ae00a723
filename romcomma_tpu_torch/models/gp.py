"""Functional variant GP core: log marginal likelihood, calibration,
prediction and posterior factors, as plain functions on tensors.

Counterpart of the variant half of ``romcomma_tpu/models/gp.py``: L
independent ARD-RBF GPs. Where the JAX package vmaps over the output axis,
the grams and factorizations here carry the L axis as a batch dimension, and
the L calibrations are independent L-BFGS-B descents run one after the other
(the reference's per-GP scipy optimizations, gpr/models.py:359-361).

Shapes follow the reference conventions, so a GSA layer can consume
``K_cho`` (L,N,N) and ``K_inv_Y`` (L,1,N) unchanged (gpr/models.py:427-444).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from romcomma_tpu_torch.models.params import (VariantParams, variant_constrain,
                                              variant_select)
from romcomma_tpu_torch.ops import lbfgs
from romcomma_tpu_torch.ops.gram import rbf_gram, rbf_gram_variant
from romcomma_tpu_torch.ops.linalg import add_diag, cho_solve, cholesky, mvn_logpdf, tri_solve


def _noisy_chol_single(x, lengthscales, variance, noise):
    k = rbf_gram(x, x, lengthscales, variance)
    return cholesky(add_diag(k, noise))


def lml_single(raw: VariantParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """LML of ONE output's GP. raw leaves are unbatched: raw_variance scalar,
    raw_lengthscales (M,) or (1,), raw_noise scalar. y: (N,)."""
    c = variant_constrain(raw)
    chol = _noisy_chol_single(x, c['lengthscales'], c['variance'], c['noise'])
    return torch.sum(mvn_logpdf(y[:, None], torch.zeros_like(y)[:, None], chol))


def lml_variant(raw: VariantParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-output LML vector (L,). raw batched over L; y: (N,L)."""
    return torch.stack([lml_single(variant_select(raw, l), x, y[:, l])
                        for l in range(y.shape[1])])


def _merge(p: VariantParams, frozen: VariantParams, mask: Dict[str, float]) -> VariantParams:
    """eff = frozen + mask * (p - frozen): frozen leaves never move."""
    return {name: frozen[name] + mask[name] * (p[name] - frozen[name]) for name in p}


def calibrate_variant(raw: VariantParams, mask: Dict[str, float], x: torch.Tensor,
                      y: torch.Tensor, maxiter: int = 5000, gtol: float = 1e-16,
                      ftol: float = lbfgs.SCIPY_FTOL
                      ) -> Tuple[VariantParams, torch.Tensor, torch.Tensor]:
    """L independent L-BFGS-B maximizations of the per-output LML.

    mask values are 0/1 floats switching trainability per the reference META
    system. x/y are cast to the params' working dtype, which sets the compute
    precision (float32 fast path or float64 verification). Returns
    (raw_opt (batched over L), lml (L,), iterations (L,))."""
    wd = raw['raw_variance'].dtype
    x, y = x.to(wd), y.to(wd)
    results = []
    for l in range(y.shape[1]):
        frozen = {name: value.detach() for name, value in variant_select(raw, l).items()}
        y_l = y[:, l]

        def objective(p: VariantParams) -> torch.Tensor:
            value = -lml_single(_merge(p, frozen, mask), x, y_l)
            # +inf (not NaN) on factorization breakdown; lbfgs.minimize then
            # reports it to scipy as a large value so the line search backs off.
            return torch.where(torch.isfinite(value), value, torch.inf)

        res = lbfgs.minimize(objective, frozen, maxiter=maxiter, gtol=gtol, ftol=ftol)
        results.append((_merge(res.params, frozen, mask), -res.value, res.iterations))
    raw_opt = {name: torch.stack([eff[name] for eff, _, _ in results]) for name in raw}
    lml = torch.tensor([value for _, value, _ in results], dtype=torch.float64)
    iterations = torch.tensor([its for _, _, its in results])
    return raw_opt, lml, iterations


def predict_variant(raw: VariantParams, x: torch.Tensor, y: torch.Tensor, xs: torch.Tensor,
                    y_instead_of_f: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean/variance at xs. Returns (mean (o,L), var (o,L))."""
    c = variant_constrain(raw)
    K = rbf_gram_variant(x, x, c['lengthscales'], c['variance'])        # (L,N,N)
    chol = cholesky(add_diag(K, c['noise'][:, None]))
    Ks = rbf_gram_variant(x, xs, c['lengthscales'], c['variance'])      # (L,N,o)
    A = tri_solve(chol, Ks)                                             # (L,N,o)
    alpha = tri_solve(chol, y.T[..., None])                             # (L,N,1)
    mean = torch.einsum('lno,lni->ol', A, alpha)
    # Clamp at zero against f32 cancellation (predictive var is >= 0 exactly).
    var_f = torch.clamp(c['variance'][None, :] - torch.einsum('lno,lno->ol', A, A), min=0.0)
    var = var_f + c['noise'][None, :] if y_instead_of_f else var_f
    return mean, var


def predict_variant_from_factors(raw: VariantParams, K_cho: torch.Tensor,
                                 K_inv_Y: torch.Tensor, x: torch.Tensor, xs: torch.Tensor,
                                 y_instead_of_f: bool = True
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean/variance at xs reusing a cached factorization: only
    O(N o) work per call. The variance solve runs in the working dtype."""
    c = variant_constrain(raw)
    Ks = rbf_gram_variant(x, xs, c['lengthscales'], c['variance'])      # (L,N,o)
    mean = torch.einsum('lno,lin->ol', Ks.to(K_inv_Y.dtype), K_inv_Y)
    A = tri_solve(K_cho.to(Ks.dtype), Ks)                               # (L,N,o)
    var_f = torch.clamp(c['variance'][None, :] - torch.einsum('lno,lno->ol', A, A), min=0.0)
    var = var_f + c['noise'][None, :] if y_instead_of_f else var_f
    return mean, var.to(mean.dtype)


def predict_variant_full(raw: VariantParams, x: torch.Tensor, y: torch.Tensor,
                         xs: torch.Tensor, full_cov: bool = False,
                         full_output_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latent prediction p(f*|Y) with the reference's full-covariance shape
    contract (gpf/models.py:84-111): the L independent GPs have zero
    cross-output covariance, so the (L,L) blocks are diagonal embeddings of
    the per-output posterior covariances. Returns (mean (n,L), var) with var
    (n,L); (n,L,L) if full_output_cov; (n,n,L,L) if full_cov."""
    full_output_cov = True if full_cov else full_output_cov
    c = variant_constrain(raw)
    L = y.shape[1]
    K = rbf_gram_variant(x, x, c['lengthscales'], c['variance'])
    chol = cholesky(add_diag(K, c['noise'][:, None]))
    Ks = rbf_gram_variant(x, xs, c['lengthscales'], c['variance'])      # (L,N,n)
    A = tri_solve(chol, Ks)
    alpha = tri_solve(chol, y.T[..., None])                             # (L,N,1)
    mean = torch.einsum('lno,lni->ol', A, alpha)                        # (n,L)
    Knn = rbf_gram_variant(xs, xs, c['lengthscales'], c['variance'])    # (L,n,n)
    f_var = Knn - torch.einsum('lna,lnb->lab', A, A)                    # (L,n,n)
    eye_L = torch.eye(L, dtype=x.dtype, device=x.device)
    if full_cov:
        return mean, torch.einsum('lab,lj->abjl', f_var, eye_L)
    diag = torch.diagonal(f_var, dim1=-2, dim2=-1)                      # (L,n)
    if full_output_cov:
        return mean, torch.einsum('ln,lj->njl', diag, eye_L)            # (n,L,L)
    return mean, diag.T                                                 # (n,L)


def posterior_factors_variant(raw: VariantParams, x: torch.Tensor, y: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K_cho (L,N,N), K_inv_Y (L,1,N)): the GSA inputs (gpr/models.py:427-444).

    ALWAYS computed and returned in float64, on the device of x: a float32
    Cholesky breaks down once cond(K) ~ N s2 / noise crosses 1/eps_f32, and
    the GSA contractions downstream cancel catastrophically unless their
    inputs carry float64 precision."""
    c = variant_constrain({name: value.to(torch.float64) for name, value in raw.items()})
    x64, y64 = x.to(torch.float64), y.to(torch.float64)
    K = rbf_gram_variant(x64, x64, c['lengthscales'], c['variance'])
    chol = cholesky(add_diag(K, c['noise'][:, None]))
    k_inv_y = cho_solve(chol, y64.T[..., None])                         # (L,N,1)
    return chol, k_inv_y.mT                                             # (L,1,N)
