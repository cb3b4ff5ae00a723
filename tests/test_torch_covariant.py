"""The port's covariant MOGP against romcomma_tpu's, on the CPU: the covariant
grams (the unit-gram kernel's covariant callers), params, LML and its
gradients through both objectives, the lengthscale-frozen CovariantUpperLML, the
predictions and posterior factors, the MOGP model, both calibration routes,
and run.gpr(is_covariant=None) -> run.gsa(is_covariant=True) as a whole.
float64 unless a case says otherwise; every case states its tolerance."""

import json
import random
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from romcomma_tpu import user as jax_user
from romcomma_tpu.data.storage import Fold as JaxFold
from romcomma_tpu.data.storage import Repository as JaxRepository
from romcomma_tpu.gsa import calibrators as jax_calibrators
from romcomma_tpu.models import gp as jax_gp
from romcomma_tpu.models import params as jax_params
from romcomma_tpu.models.gpr import MOGP as JaxMOGP
from romcomma_tpu.ops import gram as jax_gram
from romcomma_tpu.ops import pallas_kernels
from romcomma_tpu_torch import user
from romcomma_tpu_torch.base.definitions import pinned_device
from romcomma_tpu_torch.data.storage import Fold, Repository
from romcomma_tpu_torch.gsa import calibrators
from romcomma_tpu_torch.models import gp, params
from romcomma_tpu_torch.models.gpr import MOGP
from romcomma_tpu_torch.ops import gram, gram_kernels


@pytest.fixture(scope='module', autouse=True)
def _on_the_cpu():
    """The port computes on the CPU here because the tests ask for it: it
    raises where there is no CUDA device and nothing was asked for."""
    with pinned_device(torch.device('cpu')):
        yield


torch.set_num_threads(1)

CPU = torch.device('cpu')
#: Values and gradients held between the two packages at float64.
TOL = 1e-10
GRAD_TOL = 1e-8


def _problem(seed=0, N=24, M=4, L=3):
    """Inputs, outputs, and covariant parameter values with non-diagonal F
    and noise covariance."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, M))
    Y = np.stack([np.sin((l + 1.0) * X[:, 0]) + 0.3 * X[:, l % M] for l in range(L)], axis=1)
    Y = Y + 0.05 * rng.normal(size=(N, L))
    A = rng.normal(size=(L, L))
    F = 0.3 * A @ A.T + np.diag(rng.uniform(0.5, 1.5, L))
    B = rng.normal(size=(L, L))
    noise = 0.002 * B @ B.T + np.diag(rng.uniform(0.01, 0.05, L))
    return X, Y, (F, rng.uniform(0.8, 2.5, (L, M)), noise)


def _np(leaves):
    return [np.asarray(leaf) for leaf in leaves]


def _raws(values):
    """(romcomma_tpu's raw params, the port's raw params carried across)."""
    jraw = jax_params.covariant_init(*values)
    return jraw, params.covariant_from_jax(_np(jraw), on=CPU)


def _value_and_grad(objective, raw):
    """The objective's value and its gradient in every raw leaf (zeros for a
    leaf it does not reach)."""
    p = {name: value.clone().requires_grad_(True) for name, value in raw.items()}
    value = objective(p)
    grads = torch.autograd.grad(value, [p[name] for name in params.COVARIANT_FIELDS],
                                allow_unused=True)
    return value.detach(), [torch.zeros_like(p[n]) if g is None else g
                            for n, g in zip(params.COVARIANT_FIELDS, grads)]


def _close(got, want, rtol=TOL, atol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize('case', ['covariant, x1 is x2', 'covariant, x1 and x2', 'unit'])
def test_covariant_grams_match_jax(case):
    """rbf_gram_covariant and rbf_gram_covariant_unit, 1e-12 relative."""
    X, _, (F, ls, _) = _problem(seed=1)
    xs = np.random.default_rng(2).normal(size=(7, X.shape[1]))
    tX, txs, tls, tF = map(torch.tensor, (X, xs, ls, F))
    if case == 'unit':
        got, want = gram.rbf_gram_covariant_unit(tX, tls), jax_gram.rbf_gram_covariant_unit(X, ls)
    elif case == 'covariant, x1 is x2':
        got, want = gram.rbf_gram_covariant(tX, tX, tls, tF), jax_gram.rbf_gram_covariant(X, X, ls, F)
    else:
        got, want = gram.rbf_gram_covariant(tX, txs, tls, tF), jax_gram.rbf_gram_covariant(X, xs, ls, F)
    assert got.shape == want.shape
    _close(got, want, rtol=1e-12, atol=1e-12)


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_kernels, '_INTERPRET', True)


@pytest.mark.parametrize('shared', [True, False], ids=['x1 is x2', 'x1 and x2'])
def test_covariant_wrappers_match_pallas_interpret(_interpret, shared):
    """At float32, the port's plain covariant gram and its kernel wrapper
    (stacked operands; on the CPU the wrapper's unit_gram takes the plain
    version) against romcomma_tpu's rbf_gram_covariant_pallas in interpret
    mode: 2e-6, the Pallas kernel's own tolerance (tests/test_pallas.py)."""
    X, _, (F, ls, _) = _problem(seed=3, N=29)
    x2 = X if shared else np.random.default_rng(4).normal(size=(13, X.shape[1]))
    want = pallas_kernels.rbf_gram_covariant_pallas(
        *(jnp.asarray(a, jnp.float32) for a in (X, x2, ls, F)))
    tX = torch.tensor(X, dtype=torch.float32)
    tx2 = tX if shared else torch.tensor(x2, dtype=torch.float32)
    tls, tF = (torch.tensor(a, dtype=torch.float32) for a in (ls, F))
    for got in (gram.rbf_gram_covariant(tX, tx2, tls, tF),
                gram_kernels.rbf_gram_covariant_kernel(tX, tx2, tls, tF)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        _close(got, want, rtol=2e-6, atol=2e-6)


def test_covariant_from_jax_and_constrain_match_jax():
    """Leaves carried across unchanged; covariant_init and covariant_constrain
    agree with romcomma_tpu's to 1e-15; a short leaf list raises."""
    _, _, values = _problem(seed=5)
    jraw, carried = _raws(values)
    native = params.covariant_init(*values, on=CPU)
    for name, leaf in zip(params.COVARIANT_FIELDS, jraw):
        assert carried[name].dtype == native[name].dtype == torch.float64
        np.testing.assert_array_equal(carried[name].numpy(), np.asarray(leaf))
        _close(native[name], leaf, rtol=1e-15, atol=1e-15)
    want = jax_params.covariant_constrain(jraw)
    for name, value in params.covariant_constrain(carried).items():
        _close(value, want[name], rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(params.covariant_constrain(carried)['F'].numpy(), values[0],
                               rtol=1e-12)
    assert params.covariant_mask() == dict(zip(params.COVARIANT_FIELDS,
                                               map(float, jax_params.covariant_mask())))
    with pytest.raises(ValueError):
        params.covariant_from_jax(_np(jraw)[:4])


@pytest.mark.parametrize('ls_frozen', [True, False], ids=['ls frozen', 'ls trainable'])
def test_lml_and_objective_gradients_match_jax(ls_frozen):
    """lml_covariant to 1e-10 relative; the masked objective's value and
    gradient (kernel covariance trainable) to 1e-8."""
    X, Y, values = _problem(seed=6)
    jraw, raw = _raws(values)
    tX, tY = torch.tensor(X), torch.tensor(Y)
    _close(gp.lml_covariant(raw, tX, tY), jax_gp.lml_covariant(jraw, X, Y))
    kwargs = dict(kernel_covariance=True, lengthscales=not ls_frozen)
    j_objective, _ = jax_gp._covariant_objective(jraw, jax_params.covariant_mask(**kwargs),
                                                 jnp.asarray(X), jnp.asarray(Y), ls_frozen)
    want, want_grad = jax.value_and_grad(j_objective)(jraw)
    objective, _ = gp._covariant_objective(raw, params.covariant_mask(**kwargs), tX, tY)
    value, grads = _value_and_grad(objective, raw)
    _close(value, want)
    for name, g, w in zip(params.COVARIANT_FIELDS, grads, want_grad):
        _close(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)
        if name == 'raw_lengthscales':
            assert bool(g.abs().max() > 0) == (not ls_frozen)


@pytest.mark.parametrize('dtype, value_rtol, grad_rtol',
                         [(torch.float64, 1e-9, 1e-9), (torch.float32, 2e-4, 2e-3)],
                         ids=['float64', 'float32'])
def test_upper_lml_matches_autograd_and_jax(dtype, value_rtol, grad_rtol):
    """The lengthscale-frozen objective, CovariantUpperLML's analytic
    backward, against autograd through lml_covariant and against
    romcomma_tpu's _covariant_objective_upper: value and F/noise gradients,
    at float64 to 1e-9 and at float32 to rtol 2e-4 / 2e-3, romcomma_tpu's own
    limits (tests/test_pallas.py)."""
    X, Y, values = _problem(seed=7, N=30)
    jraw, raw = _raws(values)
    mask = params.covariant_mask(kernel_covariance=True)
    raw = {name: value.to(dtype) for name, value in raw.items()}
    tX, tY = torch.tensor(X, dtype=dtype), torch.tensor(Y, dtype=dtype)
    upper, merge = gp._covariant_objective(raw, mask, tX, tY)
    autograd = lambda p: -gp.lml_covariant(merge(p), tX, tY)
    j_upper, _ = jax_gp._covariant_objective_upper(
        jraw, jax_params.covariant_mask(kernel_covariance=True), jnp.asarray(X), jnp.asarray(Y))
    want, want_grad = jax.value_and_grad(j_upper)(jraw)
    got, got_grad = _value_and_grad(upper, raw)
    for v, g, w, wg in [(got, got_grad, *_value_and_grad(autograd, raw)),
                        (got, got_grad, want, want_grad)]:
        _close(v.double(), w, rtol=value_rtol, atol=0)
        for a, b in zip(g, wg):
            b = np.asarray(b.double() if torch.is_tensor(b) else b)
            _close(a.double(), b, rtol=grad_rtol, atol=grad_rtol * np.abs(b).max())


def test_predictions_and_posterior_factors_match_jax():
    """predict_covariant (y and f), all three modes of predict_covariant_full,
    posterior_factors_covariant and predict_covariant_from_factors: 1e-10."""
    X, Y, values = _problem(seed=8, N=20, M=3)
    xs = np.random.default_rng(9).normal(size=(6, 3))
    jraw, raw = _raws(values)
    tX, tY, txs = map(torch.tensor, (X, Y, xs))
    K_cho, K_inv_Y = gp.posterior_factors_covariant(raw, tX, tY)
    for got, want in zip((K_cho, K_inv_Y), jax_gp.posterior_factors_covariant(jraw, X, Y)):
        assert got.shape == want.shape
        _close(got, want)
    for y_instead_of_f in (True, False):
        want = jax_gp.predict_covariant(jraw, X, Y, xs, y_instead_of_f)
        for got in (gp.predict_covariant(raw, tX, tY, txs, y_instead_of_f),
                    gp.predict_covariant_from_factors(raw, K_cho, K_inv_Y, tX, txs,
                                                      y_instead_of_f)):
            for g, w in zip(got, want):
                _close(g, w)
    for full_cov, full_output_cov in [(False, False), (False, True), (True, False)]:
        got = gp.predict_covariant_full(raw, tX, tY, txs, full_cov, full_output_cov)
        want = jax_gp.predict_covariant_full(jraw, X, Y, xs, full_cov=full_cov,
                                             full_output_cov=full_output_cov)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _close(g, w)


def _repository(root, N=40, M=5, K=1, seed=0):
    """A small OAKLEY2004-style repository made with numpy (L=3), split into
    K folds with a seeded fold assignment, for both packages."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(N, M))
    Y = jax_user.functions.ISHIGAMI(X)
    Y = Y + 0.05 * np.std(Y, axis=0) * rng.normal(size=Y.shape)
    columns = [('X', f'X.{i}') for i in range(M)] + [('Y', f'Y.{i}') for i in range(Y.shape[1])]
    df = pd.DataFrame(np.concatenate((X, Y), axis=1), columns=pd.MultiIndex.from_tuples(columns))
    random.seed(0)
    return Repository.from_df(root, df).into_K_folds(K)


def test_mogp_round_trip_check_K_inv_Y_and_reload_quirk(tmp_path):
    """An MOGP covariant model trains, persists and reloads; its reload
    diagonalizes the trained noise covariance (the reference quirk); the
    stored log_marginal is the LML of the full trained matrix; predict,
    predict_f and check_K_inv_Y agree with romcomma_tpu's on the same folder
    to 1e-10."""
    repo = _repository(tmp_path / 'repo')
    fold = Fold(repo, 0)
    model = MOGP('gpr.c.a', fold, is_read=False, is_covariant=True, is_isotropic=False)
    assert model.is_covariant and model.kernel.data.variance.np.shape == (3, 3)
    model.calibrate(maxiter=60)
    written = np.asarray(model.likelihood.data.variance.np)
    assert written.shape == (3, 3) and np.any(written[~np.eye(3, dtype=bool)] != 0.0)
    full_lml = gp.lml_covariant(model._covariant_raw(), model._tensor(model.X),
                                model._tensor(model.Y)).item()
    np.testing.assert_allclose(model.likelihood.data.log_marginal.np[0, 0], full_lml, rtol=1e-12)
    reloaded = MOGP('gpr.c.a', fold, is_read=True, is_covariant=True, is_isotropic=False)
    noise = np.asarray(reloaded.likelihood.data.variance.np)
    np.testing.assert_allclose(np.diag(noise), np.diag(written), rtol=1e-12)
    assert np.all(noise[~np.eye(3, dtype=bool)] == 0.0)
    jax_model = JaxMOGP('gpr.c.a', JaxFold(JaxRepository(repo.folder), 0), is_read=True,
                        is_covariant=True, is_isotropic=False)
    x = np.random.default_rng(10).uniform(size=(8, 5))
    for got, want in zip(reloaded.predict(x), jax_model.predict(x)):
        _close(got, want)
    for full_cov, full_output_cov in [(False, False), (False, True), (True, False)]:
        for got, want in zip(reloaded.predict_f(x, full_cov, full_output_cov),
                             jax_model.predict_f(x, full_cov, full_output_cov)):
            _close(got, want)
    residual = reloaded.check_K_inv_Y(x)
    assert residual.shape == (3,) and np.all(residual < 1e-8)
    _close(residual, jax_model.check_K_inv_Y(x))
    variant = MOGP('gpr.v.a', fold, is_read=False, is_covariant=False, is_isotropic=False)
    _close(variant.check_K_inv_Y(x),
           JaxMOGP('gpr.v.a', JaxFold(JaxRepository(repo.folder), 0), is_read=True,
                   is_covariant=False, is_isotropic=False).check_K_inv_Y(x))


@pytest.mark.parametrize('lengthscales', ['frozen', 'trainable'])
def test_both_calibration_routes_land_together(tmp_path, lengthscales):
    """The port's covariant descent (CovariantUpperLML with the lengthscales
    frozen, autograd through the rebuilt gram with them trainable) lands
    within romcomma_tpu's own loose endpoint bound between its two routes
    (tests/test_gpr_model.py) of romcomma_tpu's on-device descent and, with
    the lengthscales frozen, of its host route (forced by large_n_threshold=1:
    L*N = 120 >= 1): the LMLs within max(1 %, 0.1), predictions at rtol 1e-2 /
    atol 5e-3 (mean) and 5e-2 / 5e-3 (SD)."""
    repo = _repository(tmp_path / 'repo')
    options = {} if lengthscales == 'frozen' else {'kernel': {'lengthscales': {'covariant': True}}}
    port = MOGP('cov.port', Fold(repo, 0), is_read=False, is_covariant=True, is_isotropic=False)
    initial = np.array(port.kernel.data.lengthscales.np)
    port.calibrate(maxiter=80, **options)
    routes = {'cov.jax': {}} | ({'cov.jax.host': {'large_n_threshold': 1}}
                                if lengthscales == 'frozen' else {})
    others = []
    for name, route in routes.items():
        model = JaxMOGP(name, JaxFold(JaxRepository(repo.folder), 0), is_read=False,
                        is_covariant=True, is_isotropic=False)
        model.calibrate(maxiter=80, **options, **route)
        others.append(model)
    lml = float(port.likelihood.data.log_marginal.np.sum())
    mean_p, sd_p = port.predict(port.X[:6])
    for other in others:
        other_lml = float(other.likelihood.data.log_marginal.np.sum())
        assert abs(other_lml - lml) < max(0.01 * abs(lml), 0.1), (lml, other_lml)
        mean, sd = other.predict(port.X[:6])
        np.testing.assert_allclose(mean, mean_p, rtol=1e-2, atol=5e-3)
        np.testing.assert_allclose(sd, sd_p, rtol=5e-2, atol=5e-3)
    moved = np.any(port.kernel.data.lengthscales.np != initial)
    assert moved == (lengthscales == 'trainable')


@pytest.fixture(scope='module')
def covariant_trees(tmp_path_factory):
    """One tiny repository (N=40, M=5, L=3, K=2), trained by the port's
    run.gpr(is_covariant=None) twice: once with the reference defaults (F
    trains on its diagonal only) and once with the kernel covariance trained
    (F non-diagonal, read by the GSA from meta.json)."""
    root = tmp_path_factory.mktemp('covariant')
    trees = {}
    for label, kwargs in (('F diagonal', {}), ('F non-diagonal', {'kernel': {'covariance': True}})):
        repo = _repository(root / label.replace(' ', '_'), K=2)
        names = user.run.gpr('gpr', repo, is_read=False, is_covariant=None, is_isotropic=None,
                             maxiter=40, **kwargs)
        trees[label] = (repo, names)
    return trees


def test_run_gpr_trains_every_pass_in_every_fold(covariant_trees):
    for repo, names in covariant_trees.values():
        assert names == ['gpr.v.i', 'gpr.v.a', 'gpr.c.a']
        for k in repo.folds:
            for name in names:
                folder = repo.fold_folder(k) / name
                for csv in ('test.csv', 'test_summary.csv', 'likelihood/log_marginal.csv'):
                    assert (folder / csv).is_file(), folder / csv
                assert json.loads((folder / 'meta.json').read_text())['result'].startswith(
                    'Converged')


def _kind_slices(M):
    return {'FIRST_ORDER': tuple((m, m + 1) for m in range(M)),
            'CLOSED': tuple((0, m + 1) for m in range(M)),
            'TOTAL': tuple((m + 1, M) for m in range(M))}


@pytest.mark.parametrize('label', ['F diagonal', 'F non-diagonal'])
def test_covariant_gsa_matches_romcomma_tpu(covariant_trees, label, tmp_path):
    """run.gsa(is_covariant=True) of both packages on copies of one trained
    tree write the same S/V files, agreeing at the CSVs' 6 decimals; the
    in-memory S and V of every kind, and the full-slice S and V, agree to
    1e-9 of each table's largest entry; the full slice's S has a unit
    diagonal (romcomma_tpu's tests/test_gsa.py). With errors, both raise, and
    under ignore_exceptions the port skips the covariant pass."""
    repo, _ = covariant_trees[label]
    gp_options = json.loads((repo.fold_folder(0) / 'gpr.c.a' / 'meta.json').read_text())
    assert gp_options['kernel']['covariance'] == (label == 'F non-diagonal')
    for package, run, Repo in (('jax', jax_user.run, JaxRepository), ('port', user.run, Repository)):
        shutil.copytree(repo.folder, tmp_path / package)
        run.gsa('gpr', Repo(tmp_path / package), is_covariant=True, is_isotropic=False,
                is_error_calculated=False)
    for k in repo.folds:
        for kind in ('first_order', 'closed', 'total'):
            for csv in ('S', 'V'):
                path = f'fold.{k}/gpr.c.a/gsa/{kind}/{csv}.csv'
                got, want = (pd.read_csv(tmp_path / p / path, index_col=[0, 1]) for p in ('port', 'jax'))
                assert list(got.columns) == list(want.columns) and got.index.equals(want.index)
                np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=2e-6)
    port_gp = MOGP('gpr.c.a', Fold(repo, 0), is_read=True, is_covariant=True, is_isotropic=False)
    jax_gp_ = JaxMOGP('gpr.c.a', JaxFold(JaxRepository(repo.folder), 0), is_read=True,
                      is_covariant=True, is_isotropic=False)
    slices = _kind_slices(port_gp.M)
    got, got_extras = calibrators.marginalize_all_kinds(port_gp, slices, False)
    want, want_extras = jax_calibrators.marginalize_all_kinds(jax_gp_, slices, False)
    pairs = [(got[kind][key], want[kind][key]) for kind in slices for key in ('S', 'V')]
    pairs += [(got_extras[key], want_extras[key]) for key in ('S', 'V0')]
    for g, w in pairs:
        w = np.asarray(w)
        assert g.shape == w.shape
        _close(g, w, rtol=0, atol=1e-9 * np.abs(w).max())
    np.testing.assert_allclose(np.diag(got_extras['S'].cpu().numpy()), 1.0, atol=1e-4)
    with pytest.raises(NotImplementedError, match='factorized_errors.py:693-703'):
        user.run.gsa('gpr', Repository(tmp_path / 'port'), is_covariant=True, is_isotropic=False,
                     is_error_calculated=True)
    with pytest.raises((ValueError, TypeError, NotImplementedError)):
        jax_user.run.gsa('gpr', JaxRepository(tmp_path / 'jax'), is_covariant=True,
                         is_isotropic=False, is_error_calculated=True)
    assert user.run.gsa('gpr', Repository(tmp_path / 'port'), is_covariant=True,
                        is_isotropic=False, is_error_calculated=True, ignore_exceptions=True) == []
