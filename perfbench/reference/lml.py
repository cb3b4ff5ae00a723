"""The exact log marginal likelihood of an ARD-RBF Gaussian process and its
gradient, from the textbook (Rasmussen & Williams 2006, eqs. 2.30 and 5.9):

    K = s2 exp(-|x_a/ls - x_b/ls|^2 / 2) + noise I,   alpha = K^-1 y,
    lml = -y^T alpha / 2 - sum log diag chol(K) - N log(2 pi) / 2,
    d lml / d theta = tr((alpha alpha^T - K^-1) dK/dtheta) / 2,

with dK/ds2 = Knn / s2, dK/dnoise = I and dK/dls_m = Knn (x_am - x_bm)^2 /
ls_m^3, Knn the signal gram. Plain torch in the dtype given.

The reference ('direct') sums the squared differences input by input, in
row blocks: exact on the diagonal and for near neighbours whatever the
lengthscales, where the matmul expansion |u_a|^2 + |u_b|^2 - 2 u_a.u_b loses
every digit once |u| is large (a line search tries lengthscales of 1e-12).
The control ('expansion') forms the cross term by a matmul, so that a TF32
setting reaches it, as a gram kernel that dropped to one TF32 pass would."""

from __future__ import annotations

import math
from typing import Dict

import torch

BLOCK = 2048


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)), stable for any x."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _blocks(N: int, block: int = BLOCK):
    for start in range(0, N, block):
        yield start, min(N, start + block)


def squared_distances(u: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """|u_a - u_b|^2 for the rows a of [start, stop) against every row b,
    summed input by input."""
    sq = torch.zeros((stop - start, u.shape[0]), dtype=u.dtype, device=u.device)
    for m in range(u.shape[1]):
        d = u[start:stop, m, None] - u[None, :, m]
        sq.addcmul_(d, d)
    return sq


def signal_gram(x: torch.Tensor, ls: torch.Tensor, s2: torch.Tensor,
                form: str = 'direct') -> torch.Tensor:
    """s2 exp(-|u_a - u_b|^2 / 2) with u = x / ls."""
    u = x / ls
    if form == 'expansion':
        uu = torch.sum(u * u, dim=1)
        sq = torch.clamp(uu[:, None] + uu[None, :] - 2.0 * (u @ u.T), min=0.0)
        return s2 * torch.exp(-0.5 * sq)
    K = torch.empty((x.shape[0], x.shape[0]), dtype=x.dtype, device=x.device)
    for start, stop in _blocks(x.shape[0]):
        K[start:stop] = s2 * torch.exp(-0.5 * squared_distances(u, start, stop))
    return K


def value_and_grad(x: torch.Tensor, y: torch.Tensor, ls: torch.Tensor, s2: torch.Tensor,
                   noise: torch.Tensor, form: str = 'direct') -> Dict[str, torch.Tensor]:
    """{'lml', 'ls' (M,), 's2', 'noise'}: the LML and its gradient in the
    constrained hyperparameters, all in x's dtype. x (N, M), y (N,), ls (M,),
    s2 and noise scalars. A factorization that breaks down gives NaN."""
    N, M = x.shape
    Knn = signal_gram(x, ls, s2, form)
    K = Knn.clone()
    K.diagonal().add_(noise)
    chol, info = torch.linalg.cholesky_ex(K)
    del K
    if int(info) != 0:
        nan = torch.full((), math.nan, dtype=x.dtype, device=x.device)
        return {'lml': nan, 'ls': torch.full_like(ls, math.nan), 's2': nan, 'noise': nan}
    alpha = torch.cholesky_solve(y.reshape(N, 1), chol)[:, 0]
    lml = (-0.5 * torch.dot(y.reshape(N), alpha) - torch.sum(torch.log(torch.diagonal(chol)))
           - 0.5 * N * math.log(2.0 * math.pi))
    W = torch.cholesky_inverse(chol)
    del chol
    W.neg_().add_(torch.outer(alpha, alpha))           # alpha alpha^T - K^-1
    dnoise = 0.5 * torch.sum(torch.diagonal(W))
    P = W.mul_(Knn)                                    # (alpha alpha^T - K^-1) o Knn
    del Knn
    ds2 = 0.5 * torch.sum(P) / s2
    if form == 'expansion':
        xx = x * x
        term = xx.T @ torch.sum(P, dim=1) + xx.T @ torch.sum(P, dim=0) - 2.0 * torch.sum(
            x * (P @ x), dim=0)
    else:
        term = torch.zeros(M, dtype=x.dtype, device=x.device)
        for start, stop in _blocks(N):
            for m in range(M):
                d = x[start:stop, m, None] - x[None, :, m]
                term[m] += torch.sum(P[start:stop] * d * d)
    dls = 0.5 * term / ls ** 3
    return {'lml': lml, 'ls': dls, 's2': ds2, 'noise': dnoise}
