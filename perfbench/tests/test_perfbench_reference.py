"""The plain reference against the port at tiny sizes on the CPU, in float64:
the LML's value and gradient, the Sobol' indices and their errors of both
kinds, and one fold's split and normalization."""

import random

import numpy as np
import pytest
import torch

from perfbench.problems import north_star, oakley_csv
from perfbench.reference import folds as ref_folds
from perfbench.reference import lml as ref_lml
from perfbench.reference import sobol as ref_sobol


@pytest.fixture(autouse=True)
def _cpu():
    from romcomma_tpu_torch.base.definitions import pinned_device
    torch.set_num_threads(2)
    with pinned_device(torch.device('cpu')):
        yield


@pytest.mark.parametrize('form', ['direct', 'expansion'])
def test_lml_value_and_gradient(form):
    from romcomma_tpu_torch.models.gp import ExactLML
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((90, 4)))
    y = torch.tensor(np.sin(x[:, 0].numpy()) + 0.1 * rng.standard_normal(90))
    ls = torch.tensor([0.7, 1.3, 2.0, 9.0], dtype=torch.float64, requires_grad=True)
    s2 = torch.tensor(1.4, dtype=torch.float64, requires_grad=True)
    noise = torch.tensor(0.03, dtype=torch.float64, requires_grad=True)
    value = ExactLML.apply(ls, s2, noise, x, y)
    grads = torch.autograd.grad(value, (ls, s2, noise))
    ref = ref_lml.value_and_grad(x, y, ls.detach(), s2.detach(), noise.detach(), form)
    assert float(ref['lml']) == pytest.approx(float(value.detach()), rel=1e-12)
    for got, want in zip(grads, (ref['ls'], ref['s2'], ref['noise'])):
        np.testing.assert_allclose(want.numpy(), got.numpy(), rtol=1e-9, atol=1e-9)


def test_direct_gram_keeps_its_diagonal_at_tiny_lengthscales():
    """A line search tries lengthscales of 1e-12: the noisy gram is then
    (s2 + noise) I, which the matmul expansion loses."""
    x = torch.tensor(np.random.default_rng(1).uniform(size=(50, 3)))
    K = ref_lml.signal_gram(x, torch.tensor([1e-12, 1.0, 1.0], dtype=torch.float64),
                            torch.tensor(0.5, dtype=torch.float64))
    np.testing.assert_allclose(torch.diagonal(K).numpy(), 0.5, rtol=1e-15)
    assert float(torch.max(torch.abs(K - torch.diag(torch.diagonal(K))))) == 0.0


def test_sobol_indices_and_errors():
    from romcomma_tpu_torch.parallel.distributed import DistributedGP
    X, Y = north_star.sample({'N': 160, 'M': 4, 'noise': 0.1}, 7)
    ls, s2, noise = np.array([1.3, 2.1, 5.0, 30.0]), 1.7, 0.02
    dgp = DistributedGP(160, torch.device('cpu'), dense_kernels=True)
    x_dev, y_dev = dgp.stage(X, Y)
    got = dgp.sobol_indices(ls, s2, noise, x_dev, y_dev, X, kind=('first_order', 'total'),
                            error=True)
    ref = ref_sobol.indices(torch.tensor(X), torch.tensor(Y[:, 0]), torch.tensor(ls), s2,
                            noise, block=64)
    for kind in ('first_order', 'total'):
        # the two grams round apart by ~1e-16 |x / ls|^2, which K^-1 amplifies
        np.testing.assert_allclose([got['S'][kind][m] for m in range(4)], ref['S'][kind],
                                   rtol=1e-7, atol=1e-12)
        # T is sqrt(|W|) / V_M, W a difference of terms larger by ~1e4 here
        np.testing.assert_allclose([got['T'][kind][m] for m in range(4)], ref['T'][kind],
                                   rtol=1e-4, atol=1e-7)


def test_fold_split_and_normalization(tmp_path):
    from romcomma_tpu_torch.data.storage import Fold, Repository
    config = {'N': 60, 'M': 8, 'L': 3, 'noise': 0.04}
    csv = oakley_csv.make(config, 11, tmp_path)['csv']
    repo = Repository.from_csv(tmp_path / 'repo', csv)
    random.seed(11)
    repo.into_K_folds(4)
    table = ref_folds.read_csv(csv)
    labels = ref_folds.fold_labels(60, 4, 11)
    for k in (0, 3):
        X, Y = ref_folds.normalized_fold(table, labels, k, 8)
        fold = Fold(repo, k)
        np.testing.assert_allclose(X.numpy(), fold.X.to_numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(Y.numpy(), fold.Y.to_numpy(), rtol=1e-12, atol=1e-12)
