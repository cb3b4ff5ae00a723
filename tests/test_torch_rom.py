"""The ROM slice of the port against romcomma_tpu, on the CPU in float64:
the means' gradients, Normalization.X_gradient, GPR.predict_gradient (variant
and covariant), ClosedSobolWithRotation (V_rotated, S_rotated, their gradient
in the Cayley parameters, _cayley), ROM's helpers and its active-subspace
rotation, each on the same inputs, and then user.run.rom end to end.

The models are read by both packages from one tree that romcomma_tpu trained
(the variant model) or wrote (the covariant model, its F non-diagonal)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from scipy.stats import norm

from romcomma_tpu.data.storage import Fold as JaxFold
from romcomma_tpu.data.storage import Repository as JaxRepository
from romcomma_tpu.gsa.calibrators import ClosedSobolWithRotation as JaxRotation
from romcomma_tpu.models import means as jax_means
from romcomma_tpu.models.gpr import MOGP as JaxMOGP
from romcomma_tpu.rom import ROM as JaxROM
from romcomma_tpu_torch import rom_scale, user
from romcomma_tpu_torch.base.definitions import pinned_device
from romcomma_tpu_torch.data.storage import Fold, Repository
from romcomma_tpu_torch.gsa.calibrators import ClosedSobolWithRotation
from romcomma_tpu_torch.models import means
from romcomma_tpu_torch.models.gpr import MOGP
from romcomma_tpu_torch.rom import ROM


@pytest.fixture(scope='module', autouse=True)
def _on_the_cpu():
    """The port computes on the CPU here because the tests ask for it: it
    raises where there is no CUDA device and nothing was asked for."""
    with pinned_device(torch.device('cpu')):
        yield


torch.set_num_threads(1)

#: Both packages compute the same float64 expressions in other orders.
RTOL = 1e-9
#: The gradient in the Cayley parameters: jax.grad and torch autograd through
#: a Cholesky, an inverse and a solve each, in other orders.
GRAD_RTOL = 1e-7
N, M, L = 48, 4, 2


def _frame(X, Y):
    columns = pd.MultiIndex.from_tuples([('X', f'X.{i}') for i in range(X.shape[1])]
                                        + [('Y', f'Y.{l}') for l in range(Y.shape[1])])
    return pd.DataFrame(np.column_stack([X, Y]), columns=columns, dtype=float)


def _planted(N_, M_, seed, noise, L_=1):
    """A target on a planted, non-axis-aligned plane (v1, v2) of the fold's
    normalized coordinates z = Phi^-1(X): sin(2 z.v1) + (z.v2)^2 / 2 [and
    z.v1 - 0.3 (z.v2)^2 as a second output]."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((M_, M_)))
    v1, v2 = Q[:, 0], Q[:, 1]
    X = rng.uniform(size=(N_, M_))
    z = norm.ppf(np.clip(X, 1e-12, 1 - 1e-12))
    ys = [np.sin(2.0 * (z @ v1)) + 0.5 * (z @ v2) ** 2, z @ v1 - 0.3 * (z @ v2) ** 2][:L_]
    Y = np.stack(ys, axis=1) + noise * rng.standard_normal((N_, L_))
    return _frame(X, Y), v1, v2


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """One fold (N=48, M=4, L=2): 'gpr.v.a' trained by romcomma_tpu, and
    'gpr.c.a' written by it with a non-diagonal F."""
    root = tmp_path_factory.mktemp('rom_tree')
    df, _, _ = _planted(N, M, seed=5, noise=0.05, L_=L)
    fold = JaxFold(JaxRepository.from_df(root / 'repo', df).into_K_folds(-1), 0)
    JaxMOGP('gpr.v.a', fold, is_read=False, is_covariant=False,
            is_isotropic=False).calibrate(maxiter=60)
    covariant = JaxMOGP('gpr.c.a', fold, is_read=False, is_covariant=True, is_isotropic=False)
    covariant._kernel.data.replace(variance=np.array([[1.2, 0.4], [0.4, 0.8]]),
                                   lengthscales=np.array([[1.1, 1.6, 2.3, 2.9],
                                                          [1.4, 1.2, 2.0, 3.3]]))
    covariant._likelihood.data.replace(variance=np.diag([0.02, 0.03]))
    return root / 'repo'


def _models(tree, name, **kwargs):
    """(port, romcomma_tpu) models read from the tree."""
    covariant = name == 'gpr.c.a'
    return (MOGP(name, Fold(Repository(tree), 0), True, covariant, False, **kwargs.get('port', {})),
            JaxMOGP(name, JaxFold(JaxRepository(tree), 0), True, covariant, False,
                    **kwargs.get('jax', {})))


def _points(o=7, seed=11):
    return np.random.default_rng(seed).standard_normal((o, M))


def test_mean_gradients_are_romcomma_tpus():
    x = _points()
    A, b = np.arange(M * L, dtype=float).reshape(M, L) / 7, np.array([0.5, -1.0])
    for port, jax_mean in ((means.Zero(L), jax_means.Zero(L)),
                           (means.Constant(b), jax_means.Constant(b)),
                           (means.Linear(A, b), jax_means.Linear(A, b))):
        got = port.gradient(torch.as_tensor(x)).numpy()
        assert got.shape == (x.shape[0], L, M)
        np.testing.assert_array_equal(got, np.asarray(jax_mean.gradient(jnp.asarray(x))))


def test_X_gradient_is_romcomma_tpus(tree):
    port = Fold(Repository(tree), 0).normalization
    want = JaxFold(JaxRepository(tree), 0).normalization
    Z = _points()
    for m in range(M):
        np.testing.assert_array_equal(port.X_gradient(Z, m), want.X_gradient(Z, m))


@pytest.mark.parametrize('name, chunk, mean', [
    ('gpr.v.a', None, None), ('gpr.v.a', 3, None), ('gpr.v.a', None, 'linear'),
    ('gpr.c.a', None, None), ('gpr.c.a', 3, None)],
    ids=['variant', 'variant-chunked', 'variant-linear-mean', 'covariant', 'covariant-chunked'])
def test_predict_gradient_matches_romcomma_tpu(tree, monkeypatch, name, chunk, mean):
    """Mean (o,L,M) and covariance, variant (o,o,L,M,M) and covariant
    (o,L,o,L,M,M), at romcomma_tpu's to RTOL; in chunks of 3 test points
    (the off-diagonal blocks solved per pair of chunks) as in one."""
    kwargs = {}
    if mean == 'linear':
        A, b = np.linspace(-1, 1, M * L).reshape(M, L), np.array([0.3, -0.2])
        kwargs = {'port': {'mean_function': means.Linear(A, b)},
                  'jax': {'mean_function': jax_means.Linear(A, b)}}
    port, jax_gp = _models(tree, name, **kwargs)
    if chunk:
        monkeypatch.setattr(MOGP, 'PREDICT_CHUNK', chunk * M)
    x = _points()
    got, want = port.predict_gradient(x), jax_gp.predict_gradient(x)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * np.abs(w).max())


@pytest.mark.parametrize('name', ['gpr.v.a', 'gpr.c.a'], ids=['variant', 'covariant'])
def test_predict_gradient_mean_is_the_derivative_of_predict(tree, name):
    """The gradient mean equals central differences (step 1e-5) of the port's
    own predict mean."""
    port, _ = _models(tree, name)
    x, h = _points(), 1e-5
    fd = np.stack([(port.predict(x + h * e)[0] - port.predict(x - h * e)[0]) / (2 * h)
                   for e in np.eye(M)], axis=-1)                       # (o,L,M)
    np.testing.assert_allclose(port.predict_gradient(x)[0], fd, rtol=1e-5,
                               atol=1e-5 * np.abs(fd).max())


@pytest.fixture(scope='module')
def rotations(tree):
    """(port, romcomma_tpu) ClosedSobolWithRotation of the variant model."""
    port, jax_gp = _models(tree, 'gpr.v.a')
    return ClosedSobolWithRotation(port), JaxRotation(jax_gp)


def _orthonormal(seed, Mu=M):
    return np.linalg.qr(np.random.default_rng(seed).standard_normal((M, M)))[0][:Mu]


def test_V_rotated_at_the_identity_is_the_closed_index(rotations):
    """V_rotated(I[:Mu]) = marginalize((0, Mu))['V'] for every Mu, and the
    full slice is rotation invariant (tests/test_rom.py:92-113)."""
    cal, _ = rotations
    eye = torch.eye(M, dtype=torch.float64)
    for Mu in range(1, M + 1):
        want = cal.marginalize((0, Mu))['V'].numpy()
        np.testing.assert_allclose(cal.V_rotated(eye[:Mu]).numpy(), want, rtol=RTOL,
                                   atol=1e-12)
    np.testing.assert_allclose(cal.V_rotated(torch.as_tensor(_orthonormal(0))).numpy(),
                               cal.V[0].numpy(), rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize('Mu', [1, 2, 3])
def test_V_and_S_rotated_match_romcomma_tpu(rotations, Mu):
    cal, jax_cal = rotations
    P = _orthonormal(Mu, Mu)
    for method in ('V_rotated', 'S_rotated'):
        got = getattr(cal, method)(torch.as_tensor(P)).numpy()
        want = np.asarray(getattr(jax_cal, method)(jnp.asarray(P)))
        assert got.shape == (L, L)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_cayley_matches_romcomma_tpu():
    n_free = M * (M - 1) // 2
    A = np.random.default_rng(3).normal(scale=0.7, size=n_free)
    got = ClosedSobolWithRotation._cayley(torch.as_tensor(A), M).numpy()
    np.testing.assert_allclose(got, np.asarray(JaxRotation._cayley(jnp.asarray(A), M)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got @ got.T, np.eye(M), atol=1e-12)
    assert np.linalg.det(got) == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize('Mu', [1, 2])
def test_objective_gradient_in_the_cayley_parameters_matches_jax_grad(rotations, Mu):
    """The gradient of optimize_theta's objective, -mean diag S_rotated(Cayley(A)[:Mu]),
    by torch autograd against jax.grad of romcomma_tpu's."""
    cal, jax_cal = rotations
    A = np.random.default_rng(Mu).normal(scale=0.5, size=M * (M - 1) // 2)
    At = torch.tensor(A, requires_grad=True)
    value = -torch.mean(torch.diagonal(cal.S_rotated(cal._cayley(At, M)[:Mu])))
    (got,) = torch.autograd.grad(value, At)

    def objective(a):
        return -jnp.mean(jnp.diagonal(jax_cal.S_rotated(jax_cal._cayley(a, M)[:Mu])))

    want = np.asarray(jax.grad(objective)(jnp.asarray(A)))
    np.testing.assert_allclose(value.item(), float(objective(jnp.asarray(A))), rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(want).max())


def test_optimize_theta_raises_the_leading_index(rotations):
    """The scipy Cayley descent ends in SO(M), its rows' signs fixed, with a
    leading index at least the identity's (romcomma_tpu's optax descent may
    stop elsewhere)."""
    cal, _ = rotations
    theta, best = cal.optimize_theta(Mu=2, maxiter=60, n_starts=2)
    np.testing.assert_allclose(theta @ theta.T, np.eye(M), atol=1e-10)
    assert np.linalg.det(theta) > 0
    # Each row's largest-magnitude entry positive, then det +1 by the last row.
    assert np.all(theta[np.arange(M - 1), np.abs(theta[:-1]).argmax(axis=1)] > 0)
    S = cal.S_rotated(torch.as_tensor(theta[:2])).numpy()
    assert best == pytest.approx(np.mean(np.diagonal(S)), rel=1e-9)
    identity = np.mean(np.diagonal(cal.S_rotated(torch.eye(M, dtype=torch.float64)[:2]).numpy()))
    assert best >= identity
    assert cal.last_theta_timings['evaluations'] > 0


def test_semi_norm_specs():
    """meta['semi_norm'] resolves every spec of the reference's dormant
    Sobol.SemiNorm objective (tests/test_rom.py:116-130), as romcomma_tpu's."""
    S = np.array([[0.5, 0.1], [0.2, 0.3]])
    specs = ['mean_diagonal', 'trace', 'frobenius', {'element': [0, 1]},
             {'weights': np.array([[1.0, 0.0], [0.0, 2.0]])}]
    for spec, want in zip(specs, [0.4, 0.8, np.linalg.norm(S), 0.1, 1.1]):
        assert ROM._semi_norm(S, spec) == pytest.approx(want)
        assert ROM._semi_norm(S, spec) == JaxROM._semi_norm(S, spec)
    for bad in ('nope', {'bad': 1}):
        with pytest.raises(ValueError):
            ROM._semi_norm(S, bad)


def test_rotate_lengthscales_formula():
    """The guessed-lengthscale rotation of the reference (rom/old.py:161-163;
    tests/test_rom.py:133-149), as romcomma_tpu's."""
    ls = np.array([[1.0, 2.0, 4.0]])
    theta = np.eye(3)[[2, 0, 1]]
    np.testing.assert_allclose(ROM._rotate_lengthscales(ls, theta), [[4.0, 1.0, 2.0]])
    np.testing.assert_allclose(ROM._rotate_lengthscales(ls, theta, guessed=True),
                               [[4.0, 1.0, 2.0]] * (0.5 * 3 / (3 - np.arange(3.0))))
    np.testing.assert_allclose(ROM._rotate_lengthscales(np.array([[2.0]]), theta), [[2.0]])
    assert np.all(ROM._rotate_lengthscales(ls, -np.eye(3)) > 0)
    rotation = _orthonormal(4)
    ls = np.array([[1.0, 2.0, 3.0, 4.0], [0.5, 0.7, 0.9, 1.1]])
    for guessed in (False, True):
        np.testing.assert_array_equal(ROM._rotate_lengthscales(ls, rotation, guessed),
                                      JaxROM._rotate_lengthscales(ls, rotation, guessed))
    assert ROM.GP_INITIALIZERS == JaxROM.GP_INITIALIZERS


def test_active_subspace_rotation_matches_romcomma_tpu(tree):
    """The same rng and a model read from romcomma_tpu's tree give
    romcomma_tpu's rotation (its batches of 256 points included)."""
    port, jax_gp = _models(tree, 'gpr.v.a')
    got = ROM('rom', port.fold)._active_subspace_rotation(port, 300, np.random.default_rng(7))
    want = JaxROM('rom', jax_gp.fold)._active_subspace_rotation(jax_gp, 300,
                                                                np.random.default_rng(7))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def _linear_repo(folder, N_=120, M_=3):
    """tests/test_rom.py's repository: f = 3 (x - 1/2).(1, 1, 1)/sqrt(3) + noise,
    whose active direction is not axis aligned."""
    rng = np.random.default_rng(1)
    X = rng.uniform(size=(N_, M_))
    y = (X - 0.5) @ (np.ones(M_) / np.sqrt(M_)) * 3.0 + 0.05 * rng.standard_normal(N_)
    return Repository.from_df(folder, _frame(X, y[:, None])).into_K_folds(-1)


def test_run_rom_on_the_linear_repository(tmp_path):
    """user.run.rom concentrates the variance on the leading rotated input,
    persists meta.json and an orthonormal rotation.csv, reduces, and runs the
    final GSA with standard errors in the rotated basis (tests/test_rom.py:20-37,
    :173-196)."""
    repo = _linear_repo(tmp_path / 'repo')
    X0 = Fold(repo, 0).X.to_numpy()
    (meta,) = user.run.rom('rom', repo, m=1, iterations=2, sample_size=256, maxiter=100,
                           is_error_calculated=True, is_T_partial=True)
    assert meta['history'][-1]['S_m'] > 0.9, meta['history']
    folder = repo.fold_folder(0)
    persisted = json.loads((folder / 'rom' / 'meta.json').read_text())
    assert persisted['history'] == meta['history'] and persisted['S_m'] == meta['S_m']
    rot = np.loadtxt(folder / 'rom' / 'rotation.csv', delimiter=',')
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-8)
    assert np.abs(rot - np.eye(3)).max() > 0.1
    fold = Fold(repo, 0)
    np.testing.assert_allclose(fold.X.to_numpy(), X0 @ rot.T, atol=1e-12)
    out = ROM('rom', fold).reduce(1)
    assert out == folder / 'rom' / 'reduced.1.csv'
    assert pd.read_csv(out, header=[0, 1], index_col=0).shape == (120, 2)
    gsa = folder / 'gpr.v.a' / 'gsa' / 'closed'
    S = pd.read_csv(gsa / 'S.csv').iloc[:, 2:].values
    T = pd.read_csv(gsa / 'T.csv').iloc[:, 2:].values
    assert np.isfinite(T).all() and (T >= 0).all()
    assert S[0, 0] > 0.9 and T[0, 0] < 0.2


def test_gp_initializer_strategies(tmp_path):
    """Every GP_Initializer the reference sketched drives the loop to a finite
    history, 'rbf' leaves its isotropic sibling beside the main model, and an
    unknown name raises (tests/test_rom.py:152-170)."""
    fold = Fold(_linear_repo(tmp_path / 'repo'), 0)
    for strategy in ROM.GP_INITIALIZERS:
        meta = ROM(f'rom_{strategy}', fold, iterations=1, m=1, sample_size=256, maxiter=30,
                   gp_initializer=strategy).calibrate()
        assert np.isfinite(meta['S_m']) and len(meta['history']) >= 2
    assert (fold.folder / 'gpr.v.a.rbf').is_dir()
    with pytest.raises(ValueError):
        ROM('rom_bad', fold, iterations=1, m=1, sample_size=256, maxiter=5,
            gp_initializer='nope').calibrate()


#: The largest principal angle between the planted plane and the learned
#: leading two rows that the small planted ROMs below may leave.
ANGLE_DEG = 5.0


@pytest.mark.parametrize('method', ['sobol', 'active_subspace'])
def test_rom_recovers_a_planted_plane(tmp_path, method):
    """Both rotation objectives bring the leading two rotated inputs onto a
    planted plane of four inputs: the closed index of the pair ends near 1."""
    df, v1, v2 = _planted(200, 4, seed=3, noise=0.03)
    repo = Repository.from_df(tmp_path / 'repo', df).into_K_folds(-1)
    fold = Fold(repo, 0)
    X0 = fold.X.to_numpy()
    meta = ROM('rom', fold, m=2, iterations=2, rotation_method=method, maxiter=200,
               theta_maxiter=150, theta_starts=3, sample_size=512).calibrate()
    assert meta['history'][-1]['S_m'] > 0.95, meta['history']
    rot = np.loadtxt(fold.folder / 'rom' / 'rotation.csv', delimiter=',')
    np.testing.assert_allclose(Fold(repo, 0).X.to_numpy(), X0 @ rot.T, atol=1e-12)
    angles = rom_scale.principal_angles_deg(np.stack([v1, v2], axis=1), rot[:2])
    assert angles.max() <= ANGLE_DEG, angles


def test_fold_X_rotation_composes_as_romcomma_tpus(tmp_path):
    """Fold.X_rotation composes a second rotation as old @ new in both
    packages (the tree's parity), which is not the rotation the inputs went
    through (new @ old) when the two do not commute: ROM's rotation.csv holds
    the latter (test_rom_recovers_a_planted_plane)."""
    df, _, _ = _planted(20, 3, seed=0, noise=0.0)
    R1 = np.linalg.qr(np.random.default_rng(1).standard_normal((3, 3)))[0]
    R2 = np.linalg.qr(np.random.default_rng(2).standard_normal((3, 3)))[0]
    for Repo, Fold_ in ((Repository, Fold), (JaxRepository, JaxFold)):
        fold = Fold_(Repo.from_df(tmp_path / Repo.__module__, df).into_K_folds(-1), 0)
        X0 = fold.X.to_numpy()
        fold.X_rotation = R1
        fold.X_rotation = R2
        np.testing.assert_allclose(fold.X_rotation, R1 @ R2, atol=1e-12)
        np.testing.assert_allclose(fold.X.to_numpy(), X0 @ (R2 @ R1).T, atol=1e-12)
        assert np.abs(fold.X.to_numpy() - X0 @ fold.X_rotation.T).max() > 0.1


def test_rom_scale_record_on_the_cpu(tmp_path):
    """rom_scale.run at a small size on the CPU: every field of the record,
    the planted plane recovered from rotation.csv, and no device numbers."""
    out, state = rom_scale.run(300, 5, 2, 'sobol', on='cpu', root=tmp_path, maxiter=200,
                               theta_maxiter=40, theta_starts=2)
    assert {'S_m_history', 'principal_angles_deg', 'stage_seconds', 'rom_s',
            'S_rotated_evaluations', 'S_rotated_ms_in_descent', 'S_rotated_valgrad_ms',
            'predict_gradient_256_ms', 'lml_valgrad_ms', 'unit_gram_launches',
            'rotation_orthonormality', 'rotation_det'} <= set(out)
    assert out['device'] == 'cpu' and out['peak_gib'] is None and out['card'] is None
    assert out['unit_gram_launches'] == 0 and out['S_rotated_evaluations'] > 0
    assert set(out['stage_seconds']) == {'calibrate', 'score', 'rotation', 'gsa'}
    assert out['S_m_history'] == [h['S_m'] for h in state['meta']['history']]
    assert out['S_m_history'][-1] > 0.95 and max(out['principal_angles_deg']) < 10.0
    assert out['rotation_orthonormality'] < 1e-12 and out['rotation_det'] == pytest.approx(1.0)
