"""Likelihood math layer: Gauss-Hermite quadrature base + multivariate
Gaussian closed forms. Counterpart of ``romcomma_tpu/models/likelihoods.py``.

Mirrors the reference's ``MOGaussian(QuadratureLikelihood)``
(reference gpf/likelihoods.py:34-96): the reference subclasses gpflow's
QuadratureLikelihood, whose Gauss-Hermite fallbacks serve any non-conjugate
likelihood, and overrides every quadrature method with the Gaussian closed
form. No training path calls it: the exact GPR evaluates its LML in
``models.gp``. It is here for parity, and as the extension point for
non-exact likelihoods.

The quadrature grid is a tensor product of probabilists' Gauss-Hermite nodes
computed on the host in float64 at construction, so every quadrature method
is one broadcast evaluation over a (n_quad**L,) node axis. The closed-form
subclass never touches the grid.

Conventions follow the reference: flattened data carries the latent axis
FIRST, so a rank-1 tensor of length L*N reshapes to (L, N)
(gpf/likelihoods.py:58-66); ``predict_mean_and_var`` accepts Fvar of rank 2
(diagonal (N, L)), 3 ((N, L, L)) or 4 ((N, P, L, L)) (gpf/likelihoods.py:83-94).

Every tensor lives on one device at one dtype, the likelihood's: by default
the compute device and the working dtype (``base.definitions``); inputs are
moved there.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from romcomma_tpu_torch.base.definitions import TORCH_FLOAT, device
from romcomma_tpu_torch.ops.linalg import cholesky, mvn_logpdf, tri_solve

#: Default number of Gauss-Hermite nodes per latent dimension (gpflow's
#: DEFAULT_NUM_GAUSS_HERMITE_POINTS, the base the reference inherits).
DEFAULT_NUM_GAUSS_HERMITE: int = 20


def gauss_hermite_grid(dim: int, n: int = DEFAULT_NUM_GAUSS_HERMITE,
                       dtype: Optional[torch.dtype] = None, on: Optional[torch.device] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tensor-product Gauss-Hermite grid for E_{x~N(0,I_dim)}[f(x)].

    Returns (nodes, weights): nodes (n**dim, dim) and weights (n**dim,)
    with sum(weights) == 1, such that E[f] ~= sum_k w_k f(nodes_k).
    Computed on the host in float64 numpy, then cast to ``dtype`` (default
    the working dtype) on ``on`` (default the compute device).
    """
    x, w = np.polynomial.hermite.hermgauss(n)      # physicists': e^{-x^2}
    x = x * np.sqrt(2.0)                           # -> N(0,1) nodes
    w = w / np.sqrt(np.pi)                         # -> probability weights
    grids = np.meshgrid(*([x] * dim), indexing='ij')
    nodes = np.stack([g.reshape(-1) for g in grids], axis=-1)
    weights = np.ones(n ** dim)
    for g in np.meshgrid(*([w] * dim), indexing='ij'):
        weights = weights * g.reshape(-1)
    dtype, on = dtype or TORCH_FLOAT(), device() if on is None else on
    return (torch.as_tensor(nodes, dtype=dtype, device=on),
            torch.as_tensor(weights, dtype=dtype, device=on))


class QuadratureLikelihood:
    """Gauss-Hermite fallback implementations over a diagonal latent
    posterior: the contract of gpflow's QuadratureLikelihood that the
    reference's MOGaussian extends (gpf/likelihoods.py:34,56).

    Subclasses implement the per-point log density ``log_prob_point`` and
    the conditional moments; the base turns them into ``predict_mean_and_
    var`` / ``predict_log_density`` / ``variational_expectations`` by
    quadrature over F ~ N(Fmu, diag(Fvar)).

    All quadrature entry points take per-point arrays: Fmu, Fvar (N, L)
    diagonal; Y (N, L).

    Like gpflow's QuadratureLikelihood in the reference, this base has no
    caller in the package: MOGaussian below overrides every quadrature
    method with its closed form. It is the extension point for user-defined
    non-conjugate likelihoods.
    """

    def __init__(self, latent_dim: int, observation_dim: int,
                 n_quad: int = DEFAULT_NUM_GAUSS_HERMITE, dtype: Optional[torch.dtype] = None,
                 on: Optional[torch.device] = None):
        self.latent_dim = int(latent_dim)
        self.observation_dim = int(observation_dim)
        self._nodes, self._weights = gauss_hermite_grid(self.latent_dim, n_quad, dtype, on)

    def _tensor(self, a) -> torch.Tensor:
        """a on the likelihood's device, at its dtype."""
        return torch.as_tensor(a, dtype=self._nodes.dtype, device=self._nodes.device)

    # -- subclass surface ---------------------------------------------------
    def log_prob_point(self, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """log p(Y | F) per point: F, Y (..., L) -> (...)."""
        raise NotImplementedError

    def conditional_mean_point(self, F: torch.Tensor) -> torch.Tensor:
        """E[Y | F] per point: (..., L) -> (..., L)."""
        raise NotImplementedError

    def conditional_variance_point(self, F: torch.Tensor) -> torch.Tensor:
        """Var[Y | F] (diagonal) per point: (..., L) -> (..., L)."""
        raise NotImplementedError

    # -- quadrature implementations ------------------------------------------
    def _f_nodes(self, Fmu, Fvar) -> torch.Tensor:
        """Latent samples at the grid: (N, L) x2 -> (Q, N, L)."""
        Fmu, Fvar = self._tensor(Fmu), self._tensor(Fvar)
        scale = torch.sqrt(torch.clamp(Fvar, min=0.0))
        return Fmu[None] + self._nodes[:, None, :] * scale[None]

    def quad_variational_expectations(self, Fmu, Fvar, Y) -> torch.Tensor:
        """E_{q(F)}[log p(Y|F)] per point: (N,)."""
        logp = self.log_prob_point(self._f_nodes(Fmu, Fvar), self._tensor(Y)[None])
        return torch.tensordot(self._weights, logp, dims=1)

    def quad_predict_log_density(self, Fmu, Fvar, Y) -> torch.Tensor:
        """log E_{q(F)}[p(Y|F)] per point via logsumexp: (N,)."""
        logp = self.log_prob_point(self._f_nodes(Fmu, Fvar), self._tensor(Y)[None])
        shift = torch.max(logp, dim=0).values
        mix = torch.tensordot(self._weights, torch.exp(logp - shift[None]), dims=1)
        return shift + torch.log(mix)

    def quad_predict_mean_and_var(self, Fmu, Fvar) -> Tuple[torch.Tensor, torch.Tensor]:
        """E[Y], Var[Y] under q(F): both (N, L).

        Var[Y] = E[Var[Y|F]] + Var[E[Y|F]] (law of total variance).
        """
        f = self._f_nodes(Fmu, Fvar)
        ey = self.conditional_mean_point(f)                    # (Q, N, L)
        vy = self.conditional_variance_point(f)                # (Q, N, L)
        mean = torch.tensordot(self._weights, ey, dims=1)
        e_var = torch.tensordot(self._weights, vy, dims=1)
        e_y2 = torch.tensordot(self._weights, ey * ey, dims=1)
        return mean, e_var + (e_y2 - mean * mean)


class MOGaussian(QuadratureLikelihood):
    """Non-diagonal multivariate Gaussian likelihood: the multivariate
    version of a Gaussian likelihood, with every quadrature method
    overridden by its closed form (gpf/likelihoods.py:34-96).

    ``variance`` is the (L, L) noise covariance, taken as given and
    symmetrized; its Cholesky factor is NaN where it is not positive
    definite, as ``ops.linalg.cholesky`` gives it.
    """

    def __init__(self, variance, n_quad: int = DEFAULT_NUM_GAUSS_HERMITE,
                 dtype: Optional[torch.dtype] = None, on: Optional[torch.device] = None):
        dtype, on = dtype or TORCH_FLOAT(), device() if on is None else on
        variance = torch.as_tensor(variance, dtype=dtype, device=on)
        if variance.dim() != 2 or variance.shape[0] != variance.shape[1]:
            raise IndexError(f'MOGaussian variance must be (L, L), got '
                             f'{tuple(variance.shape)}.')
        sym = 0.5 * (variance + variance.T)
        self.variance = sym
        self.cholesky = cholesky(sym)
        super().__init__(latent_dim=sym.shape[0], observation_dim=sym.shape[0], n_quad=n_quad,
                         dtype=dtype, on=on)

    # -- reference shape helpers (gpf/likelihoods.py:58-66) ------------------
    def N(self, data) -> int:
        """Samples in data whose last axis is the concatenated L*N."""
        return int(data.shape[-1]) // self.latent_dim

    def split_axis_shape(self, data) -> Tuple[int, int]:
        """Split the final LN axis into (L, N)."""
        return self.latent_dim, self.N(data)

    def _noise(self, n: int) -> torch.Tensor:
        """Sigma (x) I_n as a dense (Ln, Ln)."""
        return torch.kron(self.variance, torch.eye(n, dtype=self.variance.dtype,
                                                   device=self.variance.device))

    def add_to(self, Fvar) -> torch.Tensor:
        """Add the noise Sigma (x) I_N to an (LN, LN) latent covariance
        (gpf/likelihoods.py:67-70)."""
        Fvar = self._tensor(Fvar)
        return Fvar + self._noise(self.N(Fvar))

    # -- closed forms (flattened (L*N,) convention) ---------------------------
    def log_prob(self, F, Y) -> torch.Tensor:
        """sum_n log N(Y_n; F_n, Sigma) over the (L, N) columns
        (gpf/likelihoods.py:72-75)."""
        y = torch.reshape(self._tensor(Y), self.split_axis_shape(Y))
        f = torch.reshape(self._tensor(F), self.split_axis_shape(F))
        return torch.sum(mvn_logpdf(y, f, self.cholesky))

    def conditional_mean(self, F) -> torch.Tensor:
        return self._tensor(F)

    def conditional_variance(self, F) -> torch.Tensor:
        """Sigma (x) I_N as a dense (LN, LN) (gpf/likelihoods.py:80-81)."""
        return self._noise(self.N(F))

    def predict_mean_and_var(self, Fmu, Fvar) -> Tuple[torch.Tensor, torch.Tensor]:
        """Add the noise to the latent moments, by Fvar rank
        (gpf/likelihoods.py:83-94): 4 -> (1,1,L,L); 3 -> (1,L,L);
        2 -> diagonal (1,L)."""
        Fmu, Fvar = self._tensor(Fmu), self._tensor(Fvar)
        L = self.latent_dim
        if Fvar.dim() == 4:
            lhvar = torch.reshape(self.variance, (1, 1, L, L))
        elif Fvar.dim() == 3:
            lhvar = torch.reshape(self.variance, (1, L, L))
        elif Fvar.dim() == 2:
            lhvar = torch.reshape(torch.diagonal(self.variance), (1, L))
        else:
            raise IndexError(f'Fvar has {Fvar.dim()} dimensions, when it '
                             f'should have 2, 3, or 4.')
        return Fmu, Fvar + lhvar

    def predict_log_density(self, Fmu, Fvar, Y) -> torch.Tensor:
        """log N(Y; Fmu, Fvar + Sigma (x) I_N) with (LN, LN) Fvar
        (gpf/likelihoods.py:96-97)."""
        Fmu, Y = self._tensor(Fmu), self._tensor(Y)
        chol = cholesky(self.add_to(Fvar))
        alpha = tri_solve(chol, (Y - Fmu)[:, None], lower=True)
        ln = Y.shape[-1]
        return (-0.5 * torch.sum(alpha * alpha)
                - 0.5 * ln * math.log(2.0 * math.pi)
                - torch.sum(torch.log(torch.diagonal(chol))))

    def variational_expectations(self, Fmu, Fvar, Y) -> torch.Tensor:
        """E_{N(F; Fmu, Fvar)}[log p(Y|F)] in closed form
        (gpf/likelihoods.py:99-101):
        log N(Y; Fmu, Sigma (x) I_N) - tr((Sigma (x) I_N)^{-1} Fvar) / 2.

        Fvar is the dense (LN, LN) latent covariance. The trace term is
        computed through the (L, L) Cholesky on the (L, N, L, N)-blocked
        view, with no (LN, LN) factorization (the conditional variance is
        Kronecker; its inverse acts blockwise)."""
        lp = self.log_prob(Fmu, Y)
        L, n = self.split_axis_shape(Fmu)
        # tr((Sigma^{-1} (x) I) Fvar) = sum_n tr(Sigma^{-1} Fvar[:, n, :, n])
        blocks = torch.reshape(self._tensor(Fvar), (L, n, L, n))
        diag_blocks = torch.einsum('injn->ij', blocks)           # (L, L)
        half = tri_solve(self.cholesky, diag_blocks, lower=True)
        solved = tri_solve(self.cholesky, half, lower=True, trans=True)
        return lp - 0.5 * torch.trace(solved)

    # -- quadrature contract (diagonal per-point view) ------------------------
    def log_prob_point(self, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        d = Y - F
        alpha = tri_solve(self.cholesky, d[..., None], lower=True)[..., 0]
        return (-0.5 * torch.sum(alpha * alpha, dim=-1)
                - 0.5 * self.latent_dim * math.log(2.0 * math.pi)
                - torch.sum(torch.log(torch.diagonal(self.cholesky))))

    def conditional_mean_point(self, F: torch.Tensor) -> torch.Tensor:
        return F

    def conditional_variance_point(self, F: torch.Tensor) -> torch.Tensor:
        return torch.broadcast_to(torch.diagonal(self.variance), F.shape)
