"""The exact log marginal likelihood of the covariant multi-output ARD-RBF
Gaussian process and its gradient, written out in plain torch:

    K = F o E + Sigma kron I_N,   E[(l,a),(i,b)] = exp(-|x_a/ls_l - x_b/ls_i|^2 / 2),
    Y stacked output-major: yy[(l,a)] = y[a, l],   alpha = K^-1 yy,
    lml = -yy^T alpha / 2 - sum log diag chol(K) - L N log(2 pi) / 2,

F (L,L) the signal covariance and Sigma (L,L) the noise covariance. With
W = alpha alpha^T - K^-1 (Rasmussen & Williams 2006, eq. 5.9) the partials
in F and Sigma as free matrices are

    dlml/dF[l,i] = 1/2 sum_ab W[(l,a),(i,b)] E[(l,a),(i,b)],
    dlml/dSigma[l,i] = 1/2 sum_a W[(l,a),(i,a)].

The optimizer's coordinates are the Cholesky factors' leaves
(``chol_parameters``): F = C C^T, C lower triangular with the diagonal
1e-3 + softplus(raw_diag) and the strict lower triangle ``lower``, packed row
by row; Sigma the same. With G the partial in F, dlml/dC = (G + G^T) C, so
dlml/draw_diag = diag((G + G^T) C) sigmoid(raw_diag) and dlml/dlower the
strict lower entries of (G + G^T) C. The lengthscales are held fixed.

Departures from rom-comma's ``gpf/models.py:73-82`` (GPflow's autograd
through the same K): the gradient is the analytic one above, not autograd
through the factorization; the lengthscales are not differentiated (the
covariant model trains with them frozen by default); and the (LN, LN) system
is built, factorized and inverted in place, block by block, so that at L N =
44280 in float64 it holds two (LN, LN) buffers at most (31.4 GB).

'direct' sums the squared differences input by input (exact on the
diagonal whatever the lengthscales); 'expansion' forms the cross term by a
matmul, so that a TF32 setting reaches it (the control)."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

#: The lower bound of a Cholesky factor's diagonal (rom-comma's gpf/base.py).
DIAGONAL_FLOOR = 1e-3
#: Rows a block of squared differences.
BLOCK = 2048


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)), stable for any x."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def lower_indices(L: int) -> Tuple[list, list]:
    """Row and column of each strict lower entry of an (L, L) matrix, row by row."""
    rows = [r for r in range(L) for _ in range(r)]
    cols = [c for r in range(L) for c in range(r)]
    return rows, cols


def cholesky_factor(raw_diag: torch.Tensor, lower: torch.Tensor) -> torch.Tensor:
    """C (L, L): the diagonal DIAGONAL_FLOOR + softplus(raw_diag), the strict
    lower triangle ``lower`` row by row."""
    L = raw_diag.shape[0]
    C = torch.diag(DIAGONAL_FLOOR + softplus(raw_diag))
    rows, cols = lower_indices(L)
    if rows:
        C[rows, cols] = lower
    return C


def unit_block(x: torch.Tensor, ls_l: torch.Tensor, ls_i: torch.Tensor,
               form: str = 'direct') -> torch.Tensor:
    """exp(-|x_a/ls_l - x_b/ls_i|^2 / 2), (N, N)."""
    u, v = x / ls_l, x / ls_i
    if form == 'expansion':
        sq = torch.clamp(torch.sum(u * u, 1)[:, None] + torch.sum(v * v, 1)[None, :]
                         - 2.0 * (u @ v.T), min=0.0)
        return torch.exp_(sq.mul_(-0.5))
    N = x.shape[0]
    out = torch.empty((N, N), dtype=x.dtype, device=x.device)
    for start in range(0, N, BLOCK):
        stop = min(N, start + BLOCK)
        sq = torch.zeros((stop - start, N), dtype=x.dtype, device=x.device)
        for m in range(x.shape[1]):
            d = u[start:stop, m, None] - v[None, :, m]
            sq.addcmul_(d, d)
        out[start:stop] = torch.exp_(sq.mul_(-0.5))
    return out


def value_and_grad(x: torch.Tensor, y: torch.Tensor, ls: torch.Tensor, F: torch.Tensor,
                   noise: torch.Tensor, form: str = 'direct') -> Dict[str, torch.Tensor]:
    """{'lml', 'F' (L, L), 'noise' (L, L)}: the LML and its partials in F and
    Sigma as free matrices, in x's dtype. x (N, M), y (N, L), ls (L, M), F and
    noise (L, L). A factorization that breaks down gives NaN."""
    N, L = x.shape[0], y.shape[1]
    LN = L * N
    K = torch.empty((LN, LN), dtype=x.dtype, device=x.device)
    for l in range(L):
        for i in range(L):
            block = K[l * N:(l + 1) * N, i * N:(i + 1) * N]
            block.copy_(unit_block(x, ls[l], ls[i], form)).mul_(F[l, i])
            block.diagonal().add_(noise[l, i])
    chol, info = torch.linalg.cholesky_ex(K)
    del K
    if int(info) != 0:
        nan = torch.full((L, L), math.nan, dtype=x.dtype, device=x.device)
        return {'lml': nan[0, 0], 'F': nan, 'noise': nan}
    yy = y.T.reshape(LN, 1)
    alpha = torch.cholesky_solve(yy, chol)
    lml = (-0.5 * torch.sum(yy * alpha) - torch.sum(torch.log(torch.diagonal(chol)))
           - 0.5 * LN * math.log(2.0 * math.pi))
    W = torch.cholesky_inverse(chol)
    del chol
    W.neg_().addr_(alpha[:, 0], alpha[:, 0])                 # alpha alpha^T - K^-1
    dF = torch.empty((L, L), dtype=x.dtype, device=x.device)
    dnoise = torch.empty((L, L), dtype=x.dtype, device=x.device)
    for l in range(L):
        for i in range(L):
            block = W[l * N:(l + 1) * N, i * N:(i + 1) * N]
            dnoise[l, i] = 0.5 * torch.sum(torch.diagonal(block))
            dF[l, i] = 0.5 * torch.sum(block * unit_block(x, ls[l], ls[i], form))
    return {'lml': lml, 'F': dF, 'noise': dnoise}


def chol_parameters(point: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """F and Sigma from the optimizer's leaves ``raw_kernel_chol_diag``,
    ``kernel_chol_lower``, ``raw_noise_chol_diag``, ``noise_chol_lower``."""
    CF = cholesky_factor(point['raw_kernel_chol_diag'], point['kernel_chol_lower'])
    CS = cholesky_factor(point['raw_noise_chol_diag'], point['noise_chol_lower'])
    return {'F': CF @ CF.T, 'noise': CS @ CS.T, 'CF': CF, 'CS': CS}


def _leaf_grads(G: torch.Tensor, C: torch.Tensor, raw_diag: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d/draw_diag, d/dlower) from G, the partial in the free matrix C C^T."""
    dC = (G + G.T) @ C
    rows, cols = lower_indices(C.shape[0])
    return torch.diagonal(dC) * torch.sigmoid(raw_diag), dC[rows, cols]


def chol_value_and_grad(x: torch.Tensor, y: torch.Tensor, ls: torch.Tensor,
                        point: Dict[str, torch.Tensor], form: str = 'direct'
                        ) -> Dict[str, torch.Tensor]:
    """The LML and its gradient in the optimizer's leaves (``chol_parameters``):
    {'lml', 'raw_kernel_chol_diag', 'kernel_chol_lower', 'raw_noise_chol_diag',
    'noise_chol_lower'}, all in x's dtype."""
    dt = x.dtype
    point = {name: value.to(dt) for name, value in point.items()}
    p = chol_parameters(point)
    out = value_and_grad(x, y, ls.to(dt), p['F'], p['noise'], form)
    kd, kl = _leaf_grads(out['F'], p['CF'], point['raw_kernel_chol_diag'])
    nd, nl = _leaf_grads(out['noise'], p['CS'], point['raw_noise_chol_diag'])
    return {'lml': out['lml'], 'raw_kernel_chol_diag': kd, 'kernel_chol_lower': kl,
            'raw_noise_chol_diag': nd, 'noise_chol_lower': nl}
