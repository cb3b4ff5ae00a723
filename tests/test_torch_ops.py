"""The port's transforms and linear algebra against romcomma_tpu.ops at
float64, on the same numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romcomma_tpu.ops import linalg as jax_linalg
from romcomma_tpu.ops import transforms as jax_transforms
from romcomma_tpu_torch.ops import linalg, transforms

torch.set_num_threads(1)

TOL = 1e-12


def _spd(rng, n, batch=()):
    a = rng.normal(size=batch + (n, n))
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_transforms_match():
    rng = np.random.default_rng(0)
    raw = rng.normal(scale=10.0, size=40)          # reaches softplus's large-x regime
    value = rng.uniform(0.01, 30.0, size=40)
    _close(transforms.softplus(torch.tensor(raw)), jax_transforms.softplus(jnp.asarray(raw)))
    _close(transforms.inv_softplus(torch.tensor(value)),
           jax_transforms.inv_softplus(jnp.asarray(value)))
    for lower in (0.0, 1e-6, 1e-3):
        _close(transforms.positive(torch.tensor(raw), lower),
               jax_transforms.positive(jnp.asarray(raw), lower))
        _close(transforms.positive_inverse(torch.tensor(value), lower),
               jax_transforms.positive_inverse(jnp.asarray(value), lower))
    np.testing.assert_array_equal(transforms.np_inv_softplus(value),
                                  jax_transforms.np_inv_softplus(value))


@pytest.mark.parametrize('L', [1, 2, 4])
def test_strict_tril_pack_matches(L):
    mat = np.random.default_rng(L).normal(size=(L, L))
    for got, want in zip(transforms.tril_indices_strict(L), jax_transforms.tril_indices_strict(L)):
        np.testing.assert_array_equal(got, want)
    flat = transforms.pack_tril_strict(mat)
    np.testing.assert_array_equal(flat, jax_transforms.pack_tril_strict(mat))
    diag = np.abs(np.diagonal(mat)) + 1.0
    _close(transforms.build_tril(torch.tensor(diag), torch.tensor(flat)),
           jax_transforms.build_tril(jnp.asarray(diag), jnp.asarray(flat)))


def test_linalg_matches():
    rng = np.random.default_rng(1)
    a = _spd(rng, 9, (3,))
    b = rng.normal(size=(3, 9, 4))
    chol = linalg.cholesky(torch.tensor(a))
    jchol = jax_linalg.cholesky(jnp.asarray(a))
    _close(chol, jchol)
    for lower, trans in [(True, False), (True, True)]:
        _close(linalg.tri_solve(chol, torch.tensor(b), lower=lower, trans=trans),
               jax_linalg.tri_solve(jchol, jnp.asarray(b), lower=lower, trans=trans))
    upper = chol.mT.contiguous()
    for trans in (False, True):
        _close(linalg.tri_solve(upper, torch.tensor(b), lower=False, trans=trans),
               jax_linalg.tri_solve(jnp.swapaxes(jchol, -1, -2), jnp.asarray(b),
                                    lower=False, trans=trans))
    # batch dimensions broadcast: one factor against a batch of right-hand sides
    _close(linalg.tri_solve(chol[0], torch.tensor(b)),
           jax_linalg.tri_solve(jchol[0], jnp.asarray(b)))
    _close(linalg.cho_solve(chol, torch.tensor(b)), jax_linalg.cho_solve(jchol, jnp.asarray(b)))
    d = rng.uniform(0.1, 1.0, size=9)
    for diag in (0.3, d):
        _close(linalg.add_diag(torch.tensor(a), diag), jax_linalg.add_diag(jnp.asarray(a), diag))
    y, mean = rng.normal(size=(9, 2)), rng.normal(size=(9, 1))
    _close(linalg.mvn_logpdf(torch.tensor(y), torch.tensor(mean), chol[1]),
           jax_linalg.mvn_logpdf(jnp.asarray(y), jnp.asarray(mean), jchol[1]))


def test_cholesky_breakdown_is_nan_not_an_error():
    a = np.diag([1.0, -1.0, 2.0])
    lower = np.tril_indices(3)
    assert np.isnan(linalg.cholesky(torch.tensor(a)).numpy()[lower]).all()
    assert np.isnan(np.asarray(jax_linalg.cholesky(jnp.asarray(a)))[lower]).all()
