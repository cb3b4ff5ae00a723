"""The port's likelihood layer (models/likelihoods.py and
gpr.Likelihood.mo_gaussian) against romcomma_tpu's, in float64 on the CPU, on
the cases of tests/test_likelihoods.py: the Gauss-Hermite grid, MOGaussian's
closed forms and its quadrature forms. Every value is held to romcomma_tpu's
at TOL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romcomma_tpu.models import likelihoods as jax_likelihoods
from romcomma_tpu.models.gpr import Likelihood as JaxLikelihood
from romcomma_tpu_torch.base.definitions import pinned_device
from romcomma_tpu_torch.models import likelihoods
from romcomma_tpu_torch.models.gpr import Likelihood


@pytest.fixture(scope='module', autouse=True)
def _on_the_cpu():
    """The port computes on the CPU here because the tests ask for it: it
    raises where there is no CUDA device and nothing was asked for."""
    with pinned_device(torch.device('cpu')):
        yield


torch.set_num_threads(1)

#: Both packages evaluate the same float64 formulas; they differ only in the
#: order of their reductions and in their LAPACK calls.
TOL = 1e-10


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


@pytest.fixture(scope='module')
def moments():
    """tests/test_likelihoods.py's moments."""
    rng = np.random.default_rng(7)
    N, L = 11, 2
    Fmu = rng.normal(size=(N, L))
    Fvar = rng.uniform(0.01, 0.2, size=(N, L))
    Y = Fmu + rng.normal(size=(N, L)) * 0.5
    A = rng.normal(size=(L, L)) * 0.3
    sigma = A @ A.T + 0.5 * np.eye(L)
    return Fmu, Fvar, Y, sigma


@pytest.mark.parametrize('dim, n', [(1, 20), (2, 16), (3, 5)])
def test_gauss_hermite_grid(dim, n):
    nodes, weights = likelihoods.gauss_hermite_grid(dim, n)
    want_nodes, want_weights = jax_likelihoods.gauss_hermite_grid(dim, n)
    assert nodes.dtype == torch.float64 and nodes.shape == (n ** dim, dim)
    _close(nodes, want_nodes)
    _close(weights, want_weights)


@pytest.mark.parametrize('method', ['quad_variational_expectations', 'quad_predict_log_density'])
def test_quadrature_forms(moments, method):
    Fmu, Fvar, Y, sigma = moments
    got = getattr(likelihoods.MOGaussian(sigma, n_quad=30), method)(Fmu, Fvar, Y)
    want = getattr(jax_likelihoods.MOGaussian(sigma, n_quad=30), method)(
        jnp.asarray(Fmu), jnp.asarray(Fvar), jnp.asarray(Y))
    _close(got, want)


def test_quadrature_mean_and_var(moments):
    Fmu, Fvar, _, sigma = moments
    got = likelihoods.MOGaussian(sigma).quad_predict_mean_and_var(Fmu, Fvar)
    want = jax_likelihoods.MOGaussian(sigma).quad_predict_mean_and_var(jnp.asarray(Fmu),
                                                                       jnp.asarray(Fvar))
    for g, w in zip(got, want):
        _close(g, w)


def test_closed_forms_flattened_convention(moments):
    """log_prob, predict_log_density, variational_expectations, add_to and
    conditional_variance on the (L*N,) latent-axis-first flattening."""
    Fmu, _, Y, sigma = moments
    L, n = sigma.shape[0], 5
    f = np.asfortranarray(Fmu[:n]).T.reshape(-1)
    y = np.asfortranarray(Y[:n]).T.reshape(-1)
    B = np.random.default_rng(8).normal(size=(L * n, L * n)) * 0.1
    fvar = B @ B.T + 0.3 * np.eye(L * n)
    port, jax_lik = likelihoods.MOGaussian(sigma), jax_likelihoods.MOGaussian(sigma)
    assert port.N(y) == jax_lik.N(jnp.asarray(y)) == n
    _close(port.log_prob(f, y), jax_lik.log_prob(jnp.asarray(f), jnp.asarray(y)))
    for method in ('predict_log_density', 'variational_expectations'):
        _close(getattr(port, method)(f, fvar, y),
               getattr(jax_lik, method)(jnp.asarray(f), jnp.asarray(fvar), jnp.asarray(y)))
    _close(port.add_to(fvar), jax_lik.add_to(jnp.asarray(fvar)))
    _close(port.conditional_variance(f), jax_lik.conditional_variance(jnp.asarray(f)))
    _close(port.conditional_mean(f), f)


@pytest.mark.parametrize('shape', [(4, 2), (4, 2, 2), (4, 3, 2, 2)])
def test_predict_mean_and_var_rank_rules(moments, shape):
    sigma = moments[3]
    Fvar = np.random.default_rng(9).uniform(size=shape)
    Fmu = np.zeros(shape[:-1] if len(shape) > 2 else shape)
    got = likelihoods.MOGaussian(sigma).predict_mean_and_var(Fmu, Fvar)
    want = jax_likelihoods.MOGaussian(sigma).predict_mean_and_var(jnp.asarray(Fmu),
                                                                  jnp.asarray(Fvar))
    for g, w in zip(got, want):
        _close(g, w)


def test_what_both_refuse(moments):
    sigma = moments[3]
    with pytest.raises(IndexError):
        likelihoods.MOGaussian(sigma).predict_mean_and_var(np.zeros(2), np.zeros((1,) * 5))
    with pytest.raises(IndexError):
        likelihoods.MOGaussian(np.ones((2, 3)))


@pytest.mark.parametrize('variance', [[[0.2, 0.3, 0.4]], [[0.5, 0.1], [0.1, 0.3]]],
                         ids=['variant', 'covariant'])
def test_likelihood_mo_gaussian(tmp_path, variance):
    """The persistent Likelihood's variance frame feeds the math layer: a
    variant (1, L) row diagonalizes, a covariant (L, L) stays as it is."""

    class Parent:
        folder = tmp_path

    got = Likelihood(Parent(), read_data=False, variance=np.array(variance)).mo_gaussian()
    want = JaxLikelihood(Parent(), read_data=False, variance=np.array(variance)).mo_gaussian()
    _close(got.variance, want.variance)
    _close(got.cholesky, want.cholesky)
    assert got.latent_dim == want.latent_dim
