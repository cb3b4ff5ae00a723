"""Variant GP hyperparameters and their constrained/unconstrained transforms.

Counterpart of the variant half of ``romcomma_tpu/models/params.py``. The
raw (unconstrained) parameters of L independent ARD-RBF GPs are a plain dict
of tensors:

    raw_variance (L,), raw_lengthscales (L,M) or (L,1), raw_noise (L,)

Constraint conventions (identical to the reference):
  - kernel signal variance: softplus, floored at init to
    KERNEL_VARIANCE_FLOOR = 1.0005e-6 (gpr/kernels.py:176).
  - lengthscales: softplus.
  - likelihood noise variance: 1e-6 + softplus (gpflow Gaussian default lower
    bound), floored at init to 1.0001e-6 (gpr/models.py:62-65).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from romcomma_tpu_torch.base.definitions import (KERNEL_VARIANCE_FLOOR,
                                                 LIKELIHOOD_VARIANCE_FLOOR, FLOAT, device)
from romcomma_tpu_torch.ops.transforms import positive, positive_inverse

#: gpflow's Gaussian-likelihood lower bound on noise variance.
NOISE_LOWER_BOUND = 1e-6

#: The raw variant parameters, in the field order of romcomma_tpu's VariantParams.
VARIANT_FIELDS = ('raw_variance', 'raw_lengthscales', 'raw_noise')

VariantParams = Dict[str, torch.Tensor]


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


def variant_from_jax(raw: Sequence, on: Optional[torch.device] = None) -> VariantParams:
    """The port's raw params from romcomma_tpu's ``VariantParams`` leaves
    (raw_variance (L,), raw_lengthscales (L,M), raw_noise (L,)), given as
    numpy arrays in that order; a VariantParams NamedTuple converted with
    ``np.asarray`` leaf by leaf qualifies. Values and dtypes carry over
    unchanged."""
    on = device() if on is None else on
    return {name: torch.tensor(np.asarray(leaf), device=on)
            for name, leaf in zip(VARIANT_FIELDS, raw, strict=True)}


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
