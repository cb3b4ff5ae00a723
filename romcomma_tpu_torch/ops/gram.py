"""ARD-RBF gram construction. Counterpart of ``romcomma_tpu/ops/gram.py``.

The squared distance is computed by the matmul expansion

    ||u - v||^2 = ||u||^2 + ||v||^2 - 2 u.v

so no (A,B,M) difference tensor is ever built. Float32 CUDA tensors go to the
fused unit-gram kernel (ops.gram_kernels); everything else (float64, or any
CPU tensor) takes the plain path below, which is also the kernel's oracle.

Variant kernel (independent outputs, gpflow RBF per output l):
    K_l[n,n'] = s2_l * exp(-1/2 sum_m ((x_n[m]-x_n'[m]) / lam_l[m])^2)
Covariant kernel (MOStationary/RBF, reference gpf/kernels.py:140-154):
    K[l,n,j,n'] = F[l,j] * exp(-1/2 sum_m (x_n[m]/lam_l[m] - x_n'[m]/lam_j[m])^2)
i.e. the cross-output blocks difference the *differently scaled* inputs, one
(L*A, L*B) unit gram over the inputs scaled per output and stacked.
"""

from __future__ import annotations

import torch

from romcomma_tpu_torch.ops import gram_kernels


def _sqdist(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances between rows of u (...,A,M) and v (...,B,M),
    by matmul expansion, clamped at 0 against cancellation."""
    uu = torch.sum(u * u, dim=-1)
    vv = torch.sum(v * v, dim=-1)
    uv = u @ v.mT
    return torch.clamp(uu[..., :, None] + vv[..., None, :] - 2.0 * uv, min=0.0)


def _use_kernel(*tensors: torch.Tensor) -> bool:
    """Route float32 CUDA compute to the fused kernel; the plain path stays the
    float64/CPU implementation."""
    return all(t.dtype == torch.float32 and t.is_cuda for t in tensors)


def rbf_gram(x1: torch.Tensor, x2: torch.Tensor, lengthscales: torch.Tensor,
             variance: torch.Tensor) -> torch.Tensor:
    """Single-output ARD-RBF gram: variance * exp(-1/2 ||(x1-x2)/ls||^2).

    Args:
        x1: (A,M) inputs. x2: (B,M) inputs.
        lengthscales: (M,), (1,) or scalar. variance: scalar.
    Returns: (A,B).
    """
    if _use_kernel(x1, x2, lengthscales, variance):
        return gram_kernels.rbf_gram_kernel(x1, x2, lengthscales, variance)
    ls = torch.broadcast_to(lengthscales, (x1.shape[-1],))
    return variance * torch.exp(-0.5 * _sqdist(x1 / ls, x2 / ls))


def rbf_gram_variant(x1: torch.Tensor, x2: torch.Tensor, lengthscales: torch.Tensor,
                     variance: torch.Tensor) -> torch.Tensor:
    """Per-output ARD-RBF grams; a float32 CUDA build is one kernel launch.

    Args:
        x1: (A,M), or (L,A,M) with inputs of their own per member.
        x2: (B,M), or (L,B,M).
        lengthscales: (L,M) or (L,1). variance: (L,).
    Returns: (L,A,B).
    """
    if _use_kernel(x1, x2, lengthscales, variance):
        return gram_kernels.rbf_gram_variant_kernel(x1, x2, lengthscales, variance)
    ls = lengthscales[:, None, :]
    return variance[:, None, None] * torch.exp(-0.5 * _sqdist(x1 / ls, x2 / ls))


def rbf_gram_covariant(x1: torch.Tensor, x2: torch.Tensor, lengthscales: torch.Tensor,
                       F: torch.Tensor) -> torch.Tensor:
    """Covariant multi-output ARD-RBF gram.

    Args:
        x1: (A,M). x2: (B,M). lengthscales: (L,M). F: (L,L) signal covariance.
    Returns: (L,A,L,B).
    """
    if _use_kernel(x1, x2, lengthscales, F):
        return gram_kernels.rbf_gram_covariant_kernel(x1, x2, lengthscales, F)
    L = lengthscales.shape[0]
    unit = torch.exp(-0.5 * _sqdist(gram_kernels.stack_scaled(x1, lengthscales),
                                    gram_kernels.stack_scaled(x2, lengthscales)))
    return F[:, None, :, None] * unit.reshape(L, x1.shape[0], L, x2.shape[0])


def rbf_gram_covariant_unit(x: torch.Tensor, lengthscales: torch.Tensor) -> torch.Tensor:
    """Unit-variance covariant gram (L,N,L,N): the factor the reference
    caches when only the variances train (gpf/kernels.py:74-104). A float32
    CUDA build is one kernel launch on one stacked operand."""
    L, N = lengthscales.shape[0], x.shape[0]
    u = gram_kernels.stack_scaled(x, lengthscales)
    if _use_kernel(x, lengthscales):
        unit = gram_kernels.unit_gram(u, u)
    else:
        unit = torch.exp(-0.5 * _sqdist(u, u))
    return unit.reshape(L, N, L, N)
