"""Global dtype registry, reference floors and the compute device.

Counterpart of ``romcomma_tpu/base/definitions.py``. ``ROMCOMMA_X64`` is read
once, at import: ``1`` (the default) makes float64 the working dtype
everywhere (the verification mode); ``0`` selects the float32 fast path, in
which every float32 gram on a CUDA device goes through the hand-written
unit-gram kernel. The posterior factorization is float64 in both modes.

Float32 matrix products run in true float32: TF32 keeps about three decimal
digits, which the gram, every linear solve and every variance cancellation
downstream cannot afford (the counterpart of the JAX package's
``jax_default_matmul_precision='highest'``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')

#: Quantities smaller than this are considered zero (reference: base/definitions.py:36).
EFFECTIVELY_ZERO = 1.0e-64

#: Lower bound on the diagonal of a trainable covariance Cholesky (reference: gpf/base.py:35).
CHOLESKY_DIAGONAL_LOWER_BOUND = 1e-3

#: Floor on likelihood noise variance (reference: gpr/models.py:62-65).
LIKELIHOOD_VARIANCE_FLOOR = 1.0001e-6

#: Floor on kernel signal variance (reference: gpr/kernels.py:176).
KERNEL_VARIANCE_FLOOR = 1.0005e-6

_F32_MODE = os.environ.get('ROMCOMMA_X64', '1') == '0'


def FLOAT() -> np.dtype:
    """The default float dtype: float64 (verification) unless ROMCOMMA_X64=0
    selected the float32 fast path."""
    return np.dtype(np.float32) if _F32_MODE else np.dtype(np.float64)


def INT() -> np.dtype:
    """The default int dtype."""
    return np.dtype(np.int32) if _F32_MODE else np.dtype(np.int64)


def TORCH_FLOAT() -> torch.dtype:
    """FLOAT() as a torch dtype."""
    return torch.float32 if _F32_MODE else torch.float64


def device() -> torch.device:
    """The compute device: the current CUDA device when there is one, else the CPU."""
    return torch.device('cuda') if torch.cuda.is_available() else torch.device('cpu')
