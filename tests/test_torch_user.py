"""The rest of the port's user/ and Kernel.TypeFromParameters against
romcomma_tpu's, on the CPU: sample's permute_axes, DOE.full_factorial (and its
guard), DOE.space_filling_test, Function.collection, Function.un_rotate_folds,
PCA and the sampling CLI; results.copy; regression.gls; TypeFromParameters.
Trees are compared byte for byte, as tests/test_torch_storage.py compares
them; numbers at TOL."""

import random
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from romcomma_tpu.models import kernels as jax_kernels
from romcomma_tpu.user import functions as jax_functions
from romcomma_tpu.user import regression as jax_regression
from romcomma_tpu.user import results as jax_results
from romcomma_tpu.user import sample as jax_sample
from romcomma_tpu_torch.base.definitions import pinned_device
from romcomma_tpu_torch.models import kernels
from romcomma_tpu_torch.user import functions, regression, results, sample
from test_torch_storage import _assert_same_bytes, _files


@pytest.fixture(scope='module', autouse=True)
def _on_the_cpu():
    """The port computes on the CPU here because the tests ask for it: it
    raises where there is no CUDA device and nothing was asked for."""
    with pinned_device(torch.device('cpu')):
        yield


torch.set_num_threads(1)

#: float64 on both sides; only the order of reductions and the LAPACK calls differ.
TOL = 1e-10


def _origin_csv(path: Path, N=30, M=4, L=2, seed=3) -> Path:
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(N, M)) @ rng.normal(size=(M, M))       # correlated inputs for PCA
    Y = np.stack([np.sin(X[:, 0]) + X[:, 1] ** 2, X[:, 2] * X[:, 3]], axis=1)[:, :L]
    columns = ([('X', f'X.{i}') for i in range(M)] + [('Y', f'Y.{i}') for i in range(L)])
    pd.DataFrame(np.concatenate([X, Y], axis=1),
                 columns=pd.MultiIndex.from_tuples(columns)).to_csv(path)
    return path


@pytest.mark.parametrize('order', [[2, 0, 1], [1, 2, 0], [0, 1, 2, 3], None])
def test_permute_axes(order):
    got, want = sample.permute_axes(order), jax_sample.permute_axes(order)
    if order is None:
        assert got is None and want is None
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('N, M', [(8, 1), (27, 3), (10, 2), (30, 5)])
def test_full_factorial(N, M):
    np.testing.assert_array_equal(sample.DOE.full_factorial(N, M),
                                  jax_sample.DOE.full_factorial(N, M))


@pytest.mark.parametrize('N, M', [(2, 3), (300, 30)], ids=['no-level', 'past-2^24-rows'])
def test_full_factorial_guard(N, M):
    """Both refuse N < M and a design of more than 2^24 rows."""
    for package in (sample, jax_sample):
        with pytest.raises(ValueError):
            package.DOE.full_factorial(N, M)


def test_space_filling_test(monkeypatch):
    """One design and one seeded test design (the test design is drawn inside,
    unseeded, so both packages are given the same one)."""
    X = sample.DOE.latin_hypercube(40, 3, seed=1)
    test = jax_sample.DOE.latin_hypercube(16, 3, seed=2)
    for package in (sample, jax_sample):
        monkeypatch.setattr(package.DOE, 'latin_hypercube', staticmethod(lambda N, M: test))
    got, want = sample.DOE.space_filling_test(X, 16), jax_sample.DOE.space_filling_test(X, 16)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL)


def _function(package, funcs, root: Path):
    """Function over Ishigami at a seeded design and noise, into 2 folds,
    rotated by a permutation."""
    np.random.seed(0)
    random.seed(0)
    variance = package.GaussianNoise.Variance(len(funcs.ISHIGAMI), 0.05, is_determined=False)
    fn = package.Function(root, package.DOE.latin_hypercube, funcs.ISHIGAMI, 16, 3, variance,
                          None, True, seed=7)
    fn.repo.into_K_folds(2).rotate_folds(package.permute_axes([1, 2, 0]))
    return fn


def test_collection_and_un_rotate_folds(tmp_path):
    """collection() names the same folder, N and noise; un_rotate_folds()
    writes romcomma_tpu's tree, byte for byte."""
    port = _function(sample, functions, tmp_path / 'port')
    jax = _function(jax_sample, jax_functions, tmp_path / 'jax')
    got, want = port.collection('gpr'), jax.collection('gpr')
    assert got['folder'].relative_to(tmp_path / 'port') == want['folder'].relative_to(tmp_path / 'jax')
    assert (got['N'], got['noise']) == (want['N'], want['noise'])
    assert port.un_rotate_folds() is port and jax.un_rotate_folds() is jax
    _assert_same_bytes(tmp_path / 'jax', tmp_path / 'port', _files(tmp_path / 'jax'))
    folder = port.repo.folder
    assert (folder / 'undo_from.csv').is_file() and (folder / f'fold.{port.repo.K + 1}').is_dir()


def test_pca(tmp_path):
    csv = _origin_csv(tmp_path / 'origin.csv')
    assert sample.PCA(tmp_path / 'port', csv) == tmp_path / 'port' / 'PCA'
    assert jax_sample.PCA(tmp_path / 'jax', csv) == tmp_path / 'jax' / 'PCA'
    _assert_same_bytes(tmp_path / 'jax', tmp_path / 'port', _files(tmp_path / 'jax'))


def test_sampling_cli_lhs(tmp_path, capsys):
    """LHS M N... writes one design per N, beside the csv, of romcomma_tpu's
    files and shapes (the designs are unseeded)."""
    for package in ('port', 'jax'):
        (tmp_path / package).mkdir()
    sample.main(['LHS', str(tmp_path / 'port' / 'design.csv'), '3', '10', '25'])
    jax_sample.main(['LHS', str(tmp_path / 'jax' / 'design.csv'), '3', '10', '25'])
    assert _files(tmp_path / 'port') == _files(tmp_path / 'jax') == [
        Path('design.10.csv'), Path('design.25.csv')]
    for N in (10, 25):
        for package in ('port', 'jax'):
            design = pd.read_csv(tmp_path / package / f'design.{N}.csv', index_col=0)
            assert design.shape == (N, 3) and ((design >= 0) & (design <= 1)).all().all()
    assert f'Root path is {tmp_path / "port"}.' in capsys.readouterr().out


def test_sampling_cli_pca(tmp_path):
    csv = _origin_csv(tmp_path / 'origin.csv')
    sample.main(['PCA', str(csv), str(tmp_path / 'port')])
    jax_sample.main(['PCA', str(csv), str(tmp_path / 'jax')])
    _assert_same_bytes(tmp_path / 'jax', tmp_path / 'port', _files(tmp_path / 'jax'))
    fold = pd.read_csv(tmp_path / 'port' / 'PCA' / 'data.csv', header=[0, 1], index_col=0)
    assert fold.shape == (30, 6)


@pytest.mark.parametrize('arguments', [['LHS', 'x.csv', '3'], ['LHS', 'x.csv', '0', '5'],
                                       ['PCA', 'x.csv'], ['ABC', 'x.csv']])
def test_sampling_cli_refuses(arguments):
    with pytest.raises((ValueError, NameError)):
        sample.main(arguments)


def test_results_copy(tmp_path):
    """copy replaces the destination by the source, as romcomma_tpu's does."""
    src = tmp_path / 'src'
    (src / 'sub').mkdir(parents=True)
    (src / 'a.csv').write_text('1,2\n')
    (src / 'sub' / 'b.csv').write_text('3\n')
    for package, module in (('port', results), ('jax', jax_results)):
        dst = tmp_path / package
        (dst / 'stale').mkdir(parents=True)
        assert module.copy(src, dst) == dst
    assert _files(tmp_path / 'port') == _files(tmp_path / 'jax') == _files(src)
    _assert_same_bytes(tmp_path / 'jax', tmp_path / 'port', _files(src))


@pytest.mark.parametrize('is_through_origin', [False, True], ids=['intercept', 'through-origin'])
def test_gls(is_through_origin):
    """gls at TOL, the intercept (where there is one) the LAST coefficient."""
    rng = np.random.default_rng(11)
    N, M = 25, 3
    X = rng.normal(size=(N, M))
    y = X @ np.array([[1.5], [-2.0], [0.5]]) + 0.7 + 0.1 * rng.normal(size=(N, 1))
    A = rng.normal(size=(N, N)) * 0.1
    cov_y = A @ A.T + 0.05 * np.eye(N)
    got = regression.gls(X, y, cov_y, is_through_origin)
    want = jax_regression.gls(X, y, cov_y, is_through_origin)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.device.type == 'cpu'
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    assert got[0].shape == (M + (0 if is_through_origin else 1), 1)
    if not is_through_origin:
        assert abs(got[0][-1, 0].item() - 0.7) < 0.1


def test_type_from_parameters(tmp_path):
    """A kernel's Data names its Kernel type in both packages; anything else
    is refused."""
    port = kernels.RBF(tmp_path / 'port')
    jax = jax_kernels.RBF(tmp_path / 'jax')
    assert kernels.Kernel.TypeFromParameters(port.data) is kernels.RBF
    assert jax_kernels.Kernel.TypeFromParameters(jax.data) is jax_kernels.RBF
    assert kernels.Kernel.TypeFromParameters(port.data).TYPE_IDENTIFIER() == \
        jax_kernels.Kernel.TypeFromParameters(jax.data).TYPE_IDENTIFIER()
    with pytest.raises(TypeError, match='unrecognized'):
        kernels.Kernel.TypeFromParameters(object())
