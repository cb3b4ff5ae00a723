"""Closed Sobol' indices of L independent ARD-RBF GP posteriors (a diagonal
signal covariance F: each output l its own s2_l, lengthscales ls_l and
noise), with the standard errors of rom-comma's ClosedSobolWithError when
``is_T_partial`` is False (reference gsa/calibrators.py:146-402): the error
of S = V_m / V_M as a ratio, not of V_m alone. Written out as N x N matrices
of Gaussian integrals in closed form, one per input dim, in float64.

With x ~ N(0, I_M) and, per output, alpha = K^-1 y, the posterior mean
fbar(x) = sum_n alpha_n s2 prod_d e_nd(x_d), e_nd(t) = exp(-(t - X_nd)^2 /
(2 ls_d^2)), g_nd = E e_nd, g0_n = s2 prod_d g_nd, and the centred weights
c_n = g0_n alpha_n - mean(g0 alpha), the conditional variance of the slice
m (its input set) is

    V_m[l, i] = c_l^T H_m c_i,    H_m[n, n'] = prod_{d in m} E[e_nd e_n'd] / (g_nd g_n'd),

e of output l and e' of output i (their own lengthscales). Over the
posterior of output l, the covariance of V_m and V_m' (the error
integrals) is

    W(m, m') = 4 (A(m, m') - f_m^T K^-1 f_m'),    f_m = g0 o (H_m c),
    A(m, m')  = s2 c^T P c,  P[n, n'] = prod_d E_{t, t'}[r_nd(t)^[d in m] r_n'd(t')^[d in m']
                                                  exp(-(t - t')^2 / (2 ls_d^2))],

r = e / g, t and t' independent N(0, 1). S = V_m / V_M; its error is the
delta method's with rom-comma's mixed term, whose first part is A(m, m)
where the covariance of V_m and V_M has A(m, M) (its MIXED rank equation
integrates over the slice's dims alone):

    T^2 = (W(m, m) - 2 S W~(m) + S^2 W(M, M)) / V_M^2,
    W~(m) = 4 (A(m, m) - f_m^T K^-1 f_M).

Every expectation is E over N(0, I) of exp(a quadratic): per dim, log of
each factor is row a^2 + col b^2 + cross a b + const in a = X_nd, b =
X_n'd, summed over the dims and exponentiated in row blocks. S is returned
for every pair of outputs, T for each output's own index (the diagonal)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


def _one_dim(ls_a: torch.Tensor, ls_b: torch.Tensor):
    """Per dim (row, col, cross, const) of log E_t[e(t; a, ls_a) e(t; b, ls_b)]
    / (g(a) g(b)), t ~ N(0, 1): the H factor."""
    pa, pb = 1.0 / ls_a ** 2, 1.0 / ls_b ** 2
    s = 1.0 / (pa + pb + 1.0)
    row = 0.5 * pa * pa * s - 0.5 * pa + 0.5 / (ls_a ** 2 + 1.0)
    col = 0.5 * pb * pb * s - 0.5 * pb + 0.5 / (ls_b ** 2 + 1.0)
    cross = pa * pb * s
    const = (0.5 * torch.log(s) - 0.5 * torch.log(ls_a ** 2 / (ls_a ** 2 + 1.0))
             - 0.5 * torch.log(ls_b ** 2 / (ls_b ** 2 + 1.0)))
    return row, col, cross, const


def _two_dim(ls: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Per dim (row, col, cross, const) of log E_{t,t'}[r(t; a)^u r(t'; b)^v
    exp(-(t - t')^2 / (2 ls^2))], t, t' ~ N(0, 1) independent, u and v 0 or
    1 by dim: the P factor."""
    p = 1.0 / ls ** 2
    # the quadratic form's matrix plus the identity, [[p u + p + 1, -p], [-p, p v + p + 1]]
    a11, a22, a12 = p * u + p + 1.0, p * v + p + 1.0, -p
    det = a11 * a22 - a12 * a12
    s11, s22, s12 = a22 / det, a11 / det, -a12 / det
    log_g = 0.5 * torch.log(ls ** 2 / (ls ** 2 + 1.0))
    g_row = 0.5 / (ls ** 2 + 1.0)
    row = 0.5 * s11 * (p * u) ** 2 - 0.5 * p * u + u * g_row
    col = 0.5 * s22 * (p * v) ** 2 - 0.5 * p * v + v * g_row
    cross = s12 * (p * u) * (p * v)
    const = -0.5 * torch.log(det) - (u + v) * log_g
    return row, col, cross, const


def _quad(Xa: torch.Tensor, Xb: torch.Tensor, coefficients, dims: torch.Tensor,
          right: torch.Tensor, block: int) -> torch.Tensor:
    """exp(sum_{d in dims} row_d a^2 + col_d b^2 + cross_d a b + const_d) @ right,
    in row blocks: (N, k)."""
    row, col, cross, const = (c * dims for c in coefficients)
    r = (Xa * Xa) @ row
    c = (Xb * Xb) @ col
    k = torch.sum(const)
    Xc = Xa * cross
    out = torch.empty((Xa.shape[0], right.shape[1]), dtype=Xa.dtype, device=Xa.device)
    for start in range(0, Xa.shape[0], block):
        stop = min(Xa.shape[0], start + block)
        E = Xc[start:stop] @ Xb.T
        E += r[start:stop, None]
        E += c[None, :]
        E += k
        out[start:stop] = torch.exp_(E) @ right
    return out


def indices(X: torch.Tensor, Y: torch.Tensor, ls: torch.Tensor, s2: torch.Tensor,
            noise: torch.Tensor, slices: List[Tuple[int, int]], block: int = 2048,
            gram: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """{'S' (L, L, len(slices)), 'T' (L, len(slices)), 'V_M' (L, L)} of the L
    GPs of inputs X (N, M), outputs Y (N, L), lengthscales ls (L, M),
    variances s2 (L,) and noises (L,), each slice an input interval [a, b),
    all in X's dtype on X's device. T is each output's own. ``gram``, where
    given, holds the (lengthscales, variances) of K in place of ls and s2
    (a model that factorizes K at values a rounding away from those its
    indices integrate)."""
    N, M = X.shape
    L = Y.shape[1]
    one = torch.ones(M, dtype=X.dtype, device=X.device)
    ls_k, s2_k = (ls, s2) if gram is None else gram
    chols, c = [], []
    for l in range(L):
        u = X / ls_k[l]
        K = torch.zeros((N, N), dtype=X.dtype, device=X.device)
        for m in range(M):                          # squared differences input by input
            d = u[:, m, None] - u[None, :, m]
            K.addcmul_(d, d)
        K = s2_k[l] * torch.exp_(K.mul_(-0.5))
        K.diagonal().add_(noise[l])
        chol = torch.linalg.cholesky(K)
        del K
        alpha = torch.cholesky_solve(Y[:, l:l + 1], chol)[:, 0]
        lam2 = ls[l] ** 2
        g0 = s2[l] * torch.exp(0.5 * torch.sum(torch.log(lam2 / (lam2 + 1.0)))
                               - 0.5 * (X * X) @ (1.0 / (lam2 + 1.0)))
        w = g0 * alpha
        chols.append((chol, g0))
        c.append(w - torch.mean(w))
    full = (0, M)
    wanted = list(dict.fromkeys(list(slices) + [full]))
    masks = {s: torch.zeros(M, dtype=X.dtype, device=X.device).index_fill_(
        0, torch.arange(s[0], s[1], device=X.device), 1.0) for s in wanted}
    V = {s: torch.empty((L, L), dtype=X.dtype, device=X.device) for s in wanted}
    Hc: Dict[tuple, torch.Tensor] = {}
    for l in range(L):
        for i in range(L):
            coeff = _one_dim(ls[l], ls[i])
            for s in wanted:
                Hci = _quad(X, X, coeff, masks[s], c[i][:, None], block)[:, 0]
                V[s][l, i] = torch.dot(c[l], Hci)
                if l == i:
                    Hc[l, s] = Hci
    V_M = V[full]
    S = torch.stack([V[s] / torch.sqrt(torch.outer(torch.diagonal(V_M), torch.diagonal(V_M)))
                     for s in slices], dim=-1)
    T = torch.empty((L, len(slices)), dtype=X.dtype, device=X.device)
    for l in range(L):
        chol, g0 = chols[l]
        f = {s: g0 * Hc[l, s] for s in wanted}
        keys = list(f)
        Z = torch.linalg.solve_triangular(chol, torch.stack([f[s] for s in keys], 1), upper=False)
        Z = dict(zip(keys, Z.T))

        def A(s):
            P = _quad(X, X, _two_dim(ls[l], masks[s], masks[s]), one, c[l][:, None], block)
            return s2[l] * torch.dot(c[l], P[:, 0])
        W_MM = 4.0 * (A(full) - torch.dot(Z[full], Z[full]))
        for j, s in enumerate(slices):
            A_s, ratio = A(s), V[s][l, l] / V_M[l, l]
            W_ss = 4.0 * (A_s - torch.dot(Z[s], Z[s]))
            W_mixed = 4.0 * (A_s - torch.dot(Z[s], Z[full]))
            Q = W_ss - 2.0 * ratio * W_mixed + ratio * ratio * W_MM
            T[l, j] = torch.sqrt(torch.abs(Q)) / V_M[l, l]
    return {'S': S, 'T': T, 'V_M': V_M}
