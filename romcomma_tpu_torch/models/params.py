"""GP hyperparameters and their constrained/unconstrained transforms.

Counterpart of ``romcomma_tpu/models/params.py``. The raw (unconstrained)
parameters are a plain dict of tensors. Of L independent ARD-RBF GPs:

    raw_variance (L,), raw_lengthscales (L,M) or (L,1), raw_noise (L,)

Of one covariant multi-output ARD-RBF GP:

    raw_kernel_chol_diag (L,), kernel_chol_lower (L(L-1)/2,), raw_lengthscales (L,M),
    raw_noise_chol_diag (L,), noise_chol_lower (L(L-1)/2,)

Constraint conventions (identical to the reference):
  - kernel signal variance: softplus, floored at init to
    KERNEL_VARIANCE_FLOOR = 1.0005e-6 (gpr/kernels.py:176).
  - lengthscales: softplus.
  - likelihood noise variance: 1e-6 + softplus (gpflow Gaussian default lower
    bound), floored at init to 1.0001e-6 (gpr/models.py:62-65).
  - covariant (L,L) covariances are parameterized by their Cholesky:
    diagonal = 1e-3 + softplus (gpf/base.py:35,90), strict lower triangle
    unconstrained, packed row-major (gpf/base.py:93-94).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from romcomma_tpu_torch.base.definitions import (CHOLESKY_DIAGONAL_LOWER_BOUND,
                                                 KERNEL_VARIANCE_FLOOR,
                                                 LIKELIHOOD_VARIANCE_FLOOR, FLOAT,
                                                 TORCH_FLOAT, device)
from romcomma_tpu_torch.ops.transforms import (build_tril, pack_tril_strict, positive,
                                               positive_inverse)

#: gpflow's Gaussian-likelihood lower bound on noise variance.
NOISE_LOWER_BOUND = 1e-6

#: The raw variant parameters, in the field order of romcomma_tpu's VariantParams.
VARIANT_FIELDS = ('raw_variance', 'raw_lengthscales', 'raw_noise')

#: The raw covariant parameters, in the field order of romcomma_tpu's CovariantParams.
COVARIANT_FIELDS = ('raw_kernel_chol_diag', 'kernel_chol_lower', 'raw_lengthscales',
                    'raw_noise_chol_diag', 'noise_chol_lower')

VariantParams = Dict[str, torch.Tensor]
CovariantParams = Dict[str, torch.Tensor]


def variant_init(variance: np.ndarray, lengthscales: np.ndarray, noise: np.ndarray,
                 on: Optional[torch.device] = None) -> VariantParams:
    """Raw params from constrained values (with reference floors), at FLOAT()
    on ``on`` (default: the compute device).

    variance: (L,) kernel variances; lengthscales: (L,M); noise: (L,).
    """
    dt = FLOAT()
    on = device() if on is None else on

    def tensor(a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=dt), device=on)

    variance = np.maximum(np.asarray(variance, dtype=dt).reshape(-1), KERNEL_VARIANCE_FLOOR)
    noise = np.maximum(np.asarray(noise, dtype=dt).reshape(-1), LIKELIHOOD_VARIANCE_FLOOR)
    return {'raw_variance': positive_inverse(tensor(variance), 0.0),
            'raw_lengthscales': positive_inverse(tensor(lengthscales), 0.0),
            'raw_noise': positive_inverse(tensor(noise), NOISE_LOWER_BOUND)}


def _from_jax(fields: Sequence[str], raw: Sequence, on: Optional[torch.device]):
    on = device() if on is None else on
    return {name: torch.tensor(np.asarray(leaf), device=on)
            for name, leaf in zip(fields, raw, strict=True)}


def variant_from_jax(raw: Sequence, on: Optional[torch.device] = None) -> VariantParams:
    """The port's raw params from romcomma_tpu's ``VariantParams`` leaves
    (raw_variance (L,), raw_lengthscales (L,M), raw_noise (L,)), given as
    numpy arrays in that order; a VariantParams NamedTuple converted with
    ``np.asarray`` leaf by leaf qualifies. Values and dtypes carry over
    unchanged."""
    return _from_jax(VARIANT_FIELDS, raw, on)


def covariant_from_jax(raw: Sequence, on: Optional[torch.device] = None) -> CovariantParams:
    """The port's raw covariant params from romcomma_tpu's ``CovariantParams``
    leaves, as numpy arrays in COVARIANT_FIELDS order (the covariant twin of
    ``variant_from_jax``). Values and dtypes carry over unchanged."""
    return _from_jax(COVARIANT_FIELDS, raw, on)


def variant_constrain(p: VariantParams) -> Dict[str, torch.Tensor]:
    return {'variance': positive(p['raw_variance'], 0.0),
            'lengthscales': positive(p['raw_lengthscales'], 0.0),
            'noise': positive(p['raw_noise'], NOISE_LOWER_BOUND)}


def variant_mask(kernel_variance: bool = True, lengthscales: bool = True,
                 noise: bool = True) -> Dict[str, float]:
    """Trainability mask matching the reference META flag system
    (gpr/kernels.py:54-70, gpr/models.py:71-80). 1.0 = trainable."""
    return {'raw_variance': float(kernel_variance),
            'raw_lengthscales': float(lengthscales),
            'raw_noise': float(noise)}


def variant_select(p: VariantParams, l: int) -> VariantParams:
    """The raw params of output l alone: scalar variance and noise, (M,) lengthscales."""
    return {name: value[l] for name, value in p.items()}


def _chol_init(cov: np.ndarray, on: torch.device):
    """Raw (diag, strict-lower) pair at FLOAT() from an SPD (L,L) matrix. The
    factorization and inverse softplus run in float64; only the raw leaves
    land at the working dtype, so they do not promote a float32 chain."""
    chol = np.linalg.cholesky(np.asarray(cov, dtype=np.float64))
    diag = np.diagonal(chol)
    if np.min(diag) <= CHOLESKY_DIAGONAL_LOWER_BOUND:
        # The reference raises here (gpf/base.py:88-89); romcomma_tpu clamps
        # just above the bound so broadcastable tiny variances stay constructible.
        diag = np.maximum(diag, CHOLESKY_DIAGONAL_LOWER_BOUND * (1 + 1e-6))
    raw_diag = positive_inverse(torch.tensor(diag, dtype=torch.float64),
                                CHOLESKY_DIAGONAL_LOWER_BOUND)
    dt = TORCH_FLOAT()
    return (raw_diag.to(device=on, dtype=dt),
            torch.tensor(pack_tril_strict(chol), dtype=dt, device=on))


def covariant_init(kernel_cov: np.ndarray, lengthscales: np.ndarray, noise_cov: np.ndarray,
                   on: Optional[torch.device] = None) -> CovariantParams:
    """Raw covariant params from (L,L) kernel/noise covariances and (L,M)
    lengthscales, at FLOAT() on ``on`` (default: the compute device)."""
    on = device() if on is None else on
    kd, kl = _chol_init(kernel_cov, on)
    nd, nl = _chol_init(noise_cov, on)
    lengthscales = torch.tensor(np.asarray(lengthscales, dtype=FLOAT()), device=on)
    return {'raw_kernel_chol_diag': kd, 'kernel_chol_lower': kl,
            'raw_lengthscales': positive_inverse(lengthscales, 0.0),
            'raw_noise_chol_diag': nd, 'noise_chol_lower': nl}


def covariant_constrain(p: CovariantParams) -> Dict[str, torch.Tensor]:
    kchol = build_tril(positive(p['raw_kernel_chol_diag'], CHOLESKY_DIAGONAL_LOWER_BOUND),
                       p['kernel_chol_lower'])
    nchol = build_tril(positive(p['raw_noise_chol_diag'], CHOLESKY_DIAGONAL_LOWER_BOUND),
                       p['noise_chol_lower'])
    return {'F': kchol @ kchol.T,
            'lengthscales': positive(p['raw_lengthscales'], 0.0),
            'noise_cov': nchol @ nchol.T,
            'noise_chol': nchol}


def covariant_mask(kernel_variance: bool = True, kernel_covariance: bool = False,
                   lengthscales: bool = False, noise_variance: bool = True,
                   noise_covariance: bool = True) -> Dict[str, float]:
    """Covariant trainability mask. Reference defaults: kernel Cholesky diag
    trains, kernel off-diagonals and lengthscales are frozen; the noise
    covariance trains fully (gpr/kernels.py:54-57, gpr/models.py:57-60)."""
    return {'raw_kernel_chol_diag': float(kernel_variance),
            'kernel_chol_lower': float(kernel_covariance),
            'raw_lengthscales': float(lengthscales),
            'raw_noise_chol_diag': float(noise_variance),
            'noise_chol_lower': float(noise_covariance)}
