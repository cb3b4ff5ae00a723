"""The port's variant GP core against the pinned reference constants and
against romcomma_tpu.models.gp at float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romcomma_tpu.models import gp as jax_gp
from romcomma_tpu.models import params as jax_params
from romcomma_tpu_torch.models import gp, params
from test_reference_fixture import (F_VARIANCE, LML_CONVERGED, LML_PER_OUTPUT, LML_TOTAL,
                                    MEAN_FACTOR)

torch.set_num_threads(1)

TOL = 1e-10


def _fixture():
    data = np.linspace(1, 50, 50).reshape(5, 10).T
    raw = params.variant_init(np.array([0.5, 0.5]), np.array([[0.01] * 3, [0.03] * 3]),
                              np.array([1e-4, 1e-4]), on=torch.device('cpu'))
    return torch.tensor(data[:, :3]), torch.tensor(data[:, 3:]), raw


def _random_problem(seed=0, N=30, M=4, L=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, M))
    Y = np.stack([np.sin((l + 1.0) * X[:, 0]) + 0.3 * X[:, l % M] for l in range(L)], axis=1)
    Y = Y + 0.05 * rng.normal(size=(N, L))
    values = (rng.uniform(0.5, 2.0, L), rng.uniform(0.5, 3.0, (L, M)), rng.uniform(0.01, 0.1, L))
    return X, Y, values


def _np(leaves):
    return [np.asarray(leaf) for leaf in leaves]


def test_pinned_lml():
    X, Y, raw = _fixture()
    lml = gp.lml_variant(raw, X, Y).numpy()
    np.testing.assert_allclose(lml, LML_PER_OUTPUT, rtol=TOL)
    np.testing.assert_allclose(lml.sum(), LML_TOTAL, rtol=TOL)


def test_pinned_predict():
    X, Y, raw = _fixture()
    mean, fvar = gp.predict_variant(raw, X, Y, X, y_instead_of_f=False)
    np.testing.assert_allclose(mean.numpy(), Y.numpy() * MEAN_FACTOR, rtol=TOL)
    np.testing.assert_allclose(fvar.numpy(), np.full((10, 2), F_VARIANCE), rtol=TOL)
    _, yvar = gp.predict_variant(raw, X, Y, X, y_instead_of_f=True)
    np.testing.assert_allclose((yvar - fvar).numpy(), np.full((10, 2), 1e-4), rtol=TOL)


def test_pinned_convergence_endpoint():
    X, Y, raw = _fixture()
    _, lml, iterations = gp.calibrate_variant(raw, params.variant_mask(), X, Y,
                                              maxiter=5000, gtol=1e-16)
    np.testing.assert_allclose(lml.numpy(), LML_CONVERGED, rtol=1e-5)
    assert np.all(iterations.numpy() < 200)


def test_lml_value_and_gradient_match_jax():
    X, Y, values = _random_problem()
    jraw = jax_params.variant_init(*values)
    want, want_grad = jax.value_and_grad(lambda r: jnp.sum(jax_gp.lml_variant(r, X, Y)))(jraw)
    raw = {name: value.requires_grad_(True)
           for name, value in params.variant_from_jax(_np(jraw), on=torch.device('cpu')).items()}
    got = gp.lml_variant(raw, torch.tensor(X), torch.tensor(Y))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jax_gp.lml_variant(jraw, X, Y)),
                               rtol=TOL)
    np.testing.assert_allclose(got.sum().item(), float(want), rtol=TOL)
    grads = torch.autograd.grad(got.sum(), [raw[name] for name in params.VARIANT_FIELDS])
    for g, w in zip(grads, want_grad):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_variant_from_jax_round_trips_variant_init():
    _, _, values = _random_problem(seed=1)
    jraw = jax_params.variant_init(*values)
    carried = params.variant_from_jax(_np(jraw), on=torch.device('cpu'))
    native = params.variant_init(*values, on=torch.device('cpu'))
    for name, leaf in zip(params.VARIANT_FIELDS, jraw):
        assert carried[name].dtype == native[name].dtype == torch.float64
        np.testing.assert_array_equal(carried[name].numpy(), np.asarray(leaf))
        np.testing.assert_allclose(native[name].numpy(), np.asarray(leaf), rtol=1e-15, atol=1e-15)
    for name, value in params.variant_constrain(carried).items():
        np.testing.assert_allclose(value.numpy(), np.asarray(jax_params.variant_constrain(jraw)[name]),
                                   rtol=1e-15)
    with pytest.raises(ValueError):
        params.variant_from_jax(_np(jraw)[:2])


def test_posterior_and_predictions_match_jax():
    X, Y, values = _random_problem(seed=2, N=25, M=3, L=2)
    xs = np.random.default_rng(3).normal(size=(7, 3))
    jraw = jax_params.variant_init(*values)
    raw = params.variant_from_jax(_np(jraw), on=torch.device('cpu'))
    tX, tY, txs = map(torch.tensor, (X, Y, xs))
    for got, want in zip(gp.posterior_factors_variant(raw, tX, tY),
                         jax_gp.posterior_factors_variant(jraw, X, Y)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    K_cho, K_inv_Y = gp.posterior_factors_variant(raw, tX, tY)
    for y_instead_of_f in (True, False):
        pairs = [(gp.predict_variant(raw, tX, tY, txs, y_instead_of_f),
                  jax_gp.predict_variant(jraw, X, Y, xs, y_instead_of_f)),
                 (gp.predict_variant_from_factors(raw, K_cho, K_inv_Y, tX, txs, y_instead_of_f),
                  jax_gp.predict_variant_from_factors(jraw, jnp.asarray(K_cho.numpy()),
                                                      jnp.asarray(K_inv_Y.numpy()), X, xs,
                                                      y_instead_of_f))]
        for got, want in pairs:
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    for full_cov, full_output_cov in [(False, False), (False, True), (True, False)]:
        got = gp.predict_variant_full(raw, tX, tY, txs, full_cov, full_output_cov)
        want = jax_gp.predict_variant_full(jraw, X, Y, xs, full_cov=full_cov,
                                           full_output_cov=full_output_cov)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
