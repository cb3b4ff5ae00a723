"""Closed-form Sobol' indices of one output's ARD-RBF GP posterior, with
their standard errors: rom-comma's ClosedSobolWithError (reference
gsa/calibrators.py:31-402) for one output, a diagonal signal variance and
partial errors (``is_T_partial``), written out as N x N matrices, slice by
slice, in row blocks.

With lam^2 = ls^2 and, per input dim m, Phi = 1/(lam^2+1), Gamma = 1-Phi,
Upsilon = 1/(lam^2+2), G = x Phi, the centred weights

    g0_n   = s2 sqrt(prod_m lam^2 Phi) exp(-sum_m x_nm^2 Phi_m / 2),
    g0KY   = g0 * alpha - mean(g0 * alpha),        alpha = K^-1 y,

and, over the dims m of a slice S,

    H(p,q)   = exp(sum_S [2 G_p G_q - Phi (G_p^2 + G_q^2)] / (2 (1-Phi^2)))
               / prod_S sqrt(1-Phi^2),
    Om(N,n)  = exp(sum_S [-(k G_N - G_n)^2 / (2 v) + G_n^2 / (2 Phi)
                          - Upsilon G_N^2 / (2 (1 - Upsilon Phi))])
               / prod_S sqrt(v (1 - Upsilon Phi) / Phi),
    with Pi = 1/(1 + Phi + Phi^2/Gamma), Om_m = Phi^2 Pi / Gamma,
    C = Gamma (1-Upsilon) / (1 - Phi Upsilon), k = Om_m C / Gamma,
    v = Gamma Phi + Phi^2 Pi + Om_m^2 C,

the slice's conditional variance, its error integral and its index are

    V_S = g0KY^T H g0KY,    f = g0 * (H g0KY),
    W_S = 4 (pf g0KY^T Om g0KY - f^T K^-1 f),  pf = s2 sqrt(prod_m lam^2 Upsilon),
    S = V_S / V_M,   T = sqrt(|W_S|) / V_M.

rom-comma's kinds: 'first_order' takes S of the slice [m, m+1); 'total'
takes 1 - S of the slice [m+1, M), whose T it reports as it is. The empty
slice has V = 0 and T = 0. Every exponent is a rank-|S| matrix product plus
row and column terms, so a float32 or TF32 setting reaches it."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from perfbench.reference.lml import signal_gram

KINDS = ('first_order', 'total')


def slices(kind: str, M: int) -> List[Tuple[int, int]]:
    if kind == 'first_order':
        return [(m, m + 1) for m in range(M)]
    if kind == 'total':
        return [(m + 1, M) for m in range(M)]
    raise ValueError(f'kind {kind!r}')


def noisy_gram_cholesky(X: torch.Tensor, ls: torch.Tensor, s2: float, noise: float
                        ) -> torch.Tensor:
    """The lower Cholesky factor of s2 exp(-|x_a/ls - x_b/ls|^2 / 2) + noise I
    (the reference's gram, perfbench/reference/lml.py)."""
    K = signal_gram(X, ls, torch.as_tensor(s2, dtype=X.dtype, device=X.device))
    K.diagonal().add_(noise)
    chol, info = torch.linalg.cholesky_ex(K)
    del K
    if int(info) != 0:
        raise FloatingPointError(f'the noisy gram is not positive definite (info {int(info)})')
    return chol


def _per_dim(ls: torch.Tensor) -> Dict[str, torch.Tensor]:
    lam2 = ls * ls
    Phi = 1.0 / (lam2 + 1.0)
    Gamma = 1.0 - Phi
    Ups = 1.0 / (lam2 + 2.0)
    Pi = 1.0 / (1.0 + Phi + Phi * Phi / Gamma)
    Om = Phi * Phi * Pi / Gamma
    C = Gamma * (1.0 - Ups) / (1.0 - Phi * Ups)
    k = Om * C / Gamma
    v = Gamma * Phi + Phi * Phi * Pi + Om * Om * C
    Psi = 1.0 - Phi * Phi
    return {
        'lam2': lam2, 'Phi': Phi, 'Ups': Ups,
        # H: cross, row and column coefficients, and the log of its divisor
        'H_cross': 1.0 / Psi, 'H_row': -Phi / (2.0 * Psi), 'H_col': -Phi / (2.0 * Psi),
        'H_logdet': 0.5 * torch.log(Psi),
        # Om: the same four
        'O_cross': k / v, 'O_row': -k * k / (2.0 * v) - Ups / (2.0 * (1.0 - Ups * Phi)),
        'O_col': -1.0 / (2.0 * v) + 1.0 / (2.0 * Phi),
        'O_logdet': 0.5 * (torch.log(v) + torch.log(1.0 - Ups * Phi) - torch.log(Phi)),
    }


def _apply(G: torch.Tensor, idx: slice, c: Dict[str, torch.Tensor], family: str,
           right: torch.Tensor, block: int) -> torch.Tensor:
    """E right (N, k) for E the family's matrix over the slice, in row blocks."""
    Gs = G[:, idx]
    G2 = Gs * Gs
    cross = Gs * c[f'{family}_cross'][idx]
    row = G2 @ c[f'{family}_row'][idx]
    col = G2 @ c[f'{family}_col'][idx]
    logdet = torch.sum(c[f'{family}_logdet'][idx])
    Er = torch.empty_like(right)
    for start in range(0, G.shape[0], block):
        stop = min(G.shape[0], start + block)
        E = cross[start:stop] @ Gs.T
        E += row[start:stop, None]
        E += col[None, :]
        E -= logdet
        Er[start:stop] = torch.exp_(E) @ right
    return Er


def indices(X: torch.Tensor, y: torch.Tensor, ls: torch.Tensor, s2: float, noise: float,
            block: int = 2048) -> Dict[str, object]:
    """{'alpha' (N,), 'V_M', 'S': {kind: [M]}, 'T': {kind: [M]}} for the GP of
    inputs X (N, M), outputs y (N,) and hyperparameters ls (M,), s2, noise,
    all in X's dtype on X's device."""
    N, M = X.shape
    chol = noisy_gram_cholesky(X, ls, s2, noise)
    alpha = torch.cholesky_solve(y.reshape(N, 1), chol)[:, 0]
    c = _per_dim(ls)
    G = X * c['Phi']
    g0 = s2 * torch.exp(0.5 * torch.sum(torch.log(c['lam2'] * c['Phi']))
                        - 0.5 * (X * X) @ c['Phi'])
    g0KY = g0 * alpha
    g0KY = g0KY - torch.mean(g0KY)
    pf = s2 * torch.exp(0.5 * torch.sum(torch.log(c['lam2'] * c['Ups'])))
    wanted = [(0, M)] + [s for kind in KINDS for s in slices(kind, M)]
    V, Om, F = {}, {}, {}
    for s in dict.fromkeys(wanted):
        if s[0] == s[1]:
            continue
        Hg = _apply(G, slice(*s), c, 'H', g0KY[:, None], block)[:, 0]
        V[s] = torch.dot(g0KY, Hg)
        F[s] = g0 * Hg
        Om[s] = torch.dot(g0KY, _apply(G, slice(*s), c, 'O', g0KY[:, None], block)[:, 0])
    keys = list(F)
    Z = torch.linalg.solve_triangular(chol, torch.stack([F[s] for s in keys], dim=1),
                                      upper=False)
    fKf = dict(zip(keys, torch.sum(Z * Z, dim=0)))
    V_M = V[(0, M)]
    S, T = {}, {}
    for kind in KINDS:
        S[kind], T[kind] = [], []
        for s in slices(kind, M):
            if s[0] == s[1]:
                v, t = 0.0, 0.0
            else:
                v = float(V[s] / V_M)
                t = float(torch.sqrt(torch.abs(4.0 * (pf * Om[s] - fKf[s]))) / V_M)
            S[kind].append(1.0 - v if kind == 'total' else v)
            T[kind].append(t)
    return {'alpha': alpha, 'V_M': float(V_M), 'S': S, 'T': T}
