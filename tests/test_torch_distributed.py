"""The large-N variant route of the port against romcomma_tpu's, in float64 on
the CPU: ``parallel.distributed.DistributedGP`` (LML value and gradient,
posterior, predictions, Sobol' indices with W/T errors, calibration) against
romcomma_tpu's one-device ``DistributedGP`` on the same inputs, and
``MOGP.calibrate`` through the large route (large_n_threshold=1) in both
packages. romcomma_tpu runs on a one-device mesh with dense_kernels=True, its
production single-device engine; the conftest's 8 virtual devices are never
used."""

import random
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from romcomma_tpu.data.storage import Fold as JaxFold
from romcomma_tpu.data.storage import Repository as JaxRepository
from romcomma_tpu.models.gpr import MOGP as JaxMOGP
from romcomma_tpu.parallel import distributed as jax_dist
from romcomma_tpu_torch import cyclic2_engine, error_gsa, multi_output_gsa, north_star
from romcomma_tpu_torch.base.definitions import pinned_device
from romcomma_tpu_torch.gsa import calibrators
from romcomma_tpu_torch.data.storage import Fold, Repository
from romcomma_tpu_torch.models import gp, params
from romcomma_tpu_torch.models.gpr import MOGP
from romcomma_tpu_torch.models.params import NOISE_LOWER_BOUND
from romcomma_tpu_torch.ops import lbfgs
from romcomma_tpu_torch.ops.transforms import positive_inverse
from romcomma_tpu_torch.parallel import distributed
from romcomma_tpu_torch.parallel.distributed import DistributedGP
from test_torch_slice import T2_ROW_FLOOR, T2_RTOL


@pytest.fixture(scope='module', autouse=True)
def _on_the_cpu():
    """The port computes on the CPU here because the tests ask for it: it
    raises where there is no CUDA device and nothing was asked for."""
    with pinned_device(torch.device('cpu')):
        yield


torch.set_num_threads(1)

N, M, BLOCK = 96, 4, 16
KINDS = ('first_order', 'total')
#: LML value and gradient: the JAX suite's parity tolerances for the
#: distributed LML (tests/test_distributed.py), tightened to what one float64
#: factorization against another holds at cond(K) ~ 1e3.
VALUE_RTOL, GRAD_RTOL = 1e-10, 1e-8
#: alpha = K^-1 y and the predictions: two float64 Choleskys of one K.
POSTERIOR_RTOL = 1e-9
#: S: tests/test_distributed.py's. T = sqrt(|Q| / V4) where Q cancels to ~0
#: on some entries: each package then reads the square root of its own
#: rounding, sqrt(eps) ~ 1e-8 of the scale, so T's absolute floor is
#: tests/test_torch_gsa.py's 1e-7.
S_TOL, T_TOL = dict(rtol=1e-10, atol=1e-12), dict(rtol=1e-8, atol=1e-10)


_make_n_mesh = jax_dist.make_n_mesh


def _one_device_mesh():
    return _make_n_mesh(1)


@pytest.fixture(scope='module')
def problem():
    """One seeded problem (N=96, M=4, two outputs), staged in both packages."""
    rng = np.random.default_rng(42)
    X = rng.normal(size=(N, M))
    Y = np.concatenate([np.sin(X[:, :1]) + 0.1 * rng.normal(size=(N, 1)),
                        0.5 * X[:, 1:2] ** 2 + 0.05 * rng.normal(size=(N, 1))], axis=1)
    hypers = (rng.uniform(0.8, 2.0, M), 1.7, 0.05)
    jax_dgp = jax_dist.DistributedGP(N, _one_device_mesh(), block=BLOCK, dense_kernels=True)
    dgp = DistributedGP(N, block=BLOCK, dense_kernels=True)
    return dict(X=X, Y=Y, hypers=hypers, jax=jax_dgp, jax_staged=jax_dgp.stage(X, Y[:, :1]),
                port=dgp, staged=dgp.stage(X, Y[:, :1]), Xs=rng.normal(size=(7, M)))


def test_lml_value_and_gradient_match(problem):
    ls, s2, noise = problem['hypers']
    x, y = problem['jax_staged']
    value, grads = jax.value_and_grad(
        lambda p: problem['jax'].lml(p[0], p[1], p[2], x, y))(
        (jnp.asarray(ls), jnp.asarray(s2), jnp.asarray(noise)))
    p = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (ls, s2, noise)]
    got = problem['port'].lml(*p, *problem['staged'])
    got_grads = torch.autograd.grad(got, p)
    np.testing.assert_allclose(got.item(), float(value), rtol=VALUE_RTOL)
    for g, w in zip(got_grads, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=0)


def test_small_route_evaluates_the_same_exact_lml(problem):
    """gp.lml_single, the small route's LML (ExactLML), and DistributedGP.lml
    on 'upper' (the streaming route: the factor inverted in place, the pair
    tiles) on the constrained raw parameters: the same value and gradient."""
    ls, s2, noise = problem['hypers']
    raw = {'raw_lengthscales': positive_inverse(torch.tensor(ls), 0.0),
           'raw_variance': positive_inverse(torch.tensor(s2, dtype=torch.float64), 0.0),
           'raw_noise': positive_inverse(torch.tensor(noise, dtype=torch.float64),
                                         NOISE_LOWER_BOUND)}
    raw = {name: value.requires_grad_(True) for name, value in raw.items()}
    x, y = problem['staged']
    small = gp.lml_single(raw, x, y[:, 0])
    assert type(small.grad_fn).__name__ == 'ExactLMLBackward'
    c = params.variant_constrain(raw)
    constrained = [c[name] for name in ('lengthscales', 'variance', 'noise')]
    large = problem['port'].lml(*constrained, x, y)
    np.testing.assert_allclose(small.item(), large.item(), rtol=1e-14)
    leaves = list(raw.values())
    for got, want in zip(torch.autograd.grad(small, leaves), torch.autograd.grad(large, leaves)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def test_lml_is_minus_inf_where_the_factorization_breaks_down(problem):
    """A negative noise makes K indefinite: -inf, as romcomma_tpu reports."""
    ls, s2, _ = problem['hypers']
    assert problem['port'].lml(ls, s2, -10.0, *problem['staged']).item() == -np.inf


def test_posterior_alpha_and_predict_match(problem):
    ls, s2, noise = problem['hypers']
    x, y = problem['jax_staged']
    alpha_jax, _ = problem['jax'].posterior_alpha(ls, s2, noise, x, y)
    alpha, chol = problem['port'].posterior_alpha(ls, s2, noise, *problem['staged'])
    assert alpha.dtype == chol.dtype == torch.float64 and chol.shape == (N, N)
    np.testing.assert_allclose(alpha.numpy(),
                               jax_dist.from_stored(problem['jax'].plan, np.asarray(alpha_jax)),
                               rtol=POSTERIOR_RTOL)
    want = problem['jax'].predict(ls, s2, noise, x, y, problem['Xs'])
    got = problem['port'].predict(ls, s2, noise, *problem['staged'], problem['Xs'])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=POSTERIOR_RTOL)


def test_psi_solver_applies_K_inverse(problem):
    """make_psi_solver applies K^-1 along the last axis, reusing a given
    factor: against numpy's float64 solve of the same K."""
    ls, s2, noise = problem['hypers']
    x, y = problem['staged']
    dgp = problem['port']
    chol = dgp._factor64(ls, s2, noise, x)
    K = (chol @ chol.T).numpy()
    f = np.random.default_rng(5).normal(size=(2, 3, N))
    want = np.linalg.solve(K, f.reshape(-1, N).T).T.reshape(f.shape)
    for solver in (dgp.make_psi_solver(ls, s2, noise, x),
                   dgp.make_psi_solver(ls, s2, noise, x, factor=chol)):
        np.testing.assert_allclose(solver(f).numpy(), want, rtol=POSTERIOR_RTOL, atol=1e-12)


def _assert_indices(got, want, tol):
    assert set(got) == set(want)
    for m in want:
        np.testing.assert_allclose(got[m], want[m], **tol)


@pytest.mark.parametrize('kind', ['first_order', KINDS], ids=['one-kind', 'two-kinds'])
def test_sobol_indices_match(problem, kind):
    ls, s2, noise = problem['hypers']
    want = problem['jax'].sobol_indices(ls, s2, noise, *problem['jax_staged'], problem['X'],
                                        kind=kind)
    got = problem['port'].sobol_indices(ls, s2, noise, *problem['staged'], problem['X'], kind=kind)
    if isinstance(kind, str):
        _assert_indices(got, want, S_TOL)
    else:
        for k in kind:
            _assert_indices(got[k], want[k], S_TOL)
    assert {'posterior_s', 'setup_s', 'intervals_s', 'total_s'} <= set(
        problem['port'].last_gsa_timings)


@pytest.mark.parametrize('is_T_partial', [True, False], ids=['partial-T', 'total-T'])
def test_sobol_indices_with_errors_match(problem, is_T_partial):
    ls, s2, noise = problem['hypers']
    options = dict(kind=KINDS, error=True, is_T_partial=is_T_partial)
    want = problem['jax'].sobol_indices(ls, s2, noise, *problem['jax_staged'], problem['X'],
                                        **options)
    got = problem['port'].sobol_indices(ls, s2, noise, *problem['staged'], problem['X'], **options)
    for k in KINDS:
        _assert_indices(got['S'][k], want['S'][k], S_TOL)
        _assert_indices(got['T'][k], want['T'][k], T_TOL)


def test_sobol_indices_multi_output_match(problem):
    ls, s2, noise = problem['hypers']
    ls2 = np.stack([ls, 1.5 * ls])
    s2_, noise_ = np.array([s2, 0.8]), np.array([noise, 0.04])
    want = problem['jax'].sobol_indices(ls2, s2_, noise_, *problem['jax'].stage(
        problem['X'], problem['Y']), problem['X'], kind=KINDS)
    dgp = problem['port']
    got = dgp.sobol_indices(ls2, s2_, noise_, *dgp.stage(problem['X'], problem['Y']),
                            problem['X'], kind=KINDS)
    assert isinstance(got, list) and len(got) == 2 and dgp.last_gsa_timings['outputs'] == 2
    for g, w in zip(got, want):
        for k in KINDS:
            _assert_indices(g[k], w[k], S_TOL)


def test_posterior_cache_keys_on_the_stage_token(monkeypatch):
    """Repeated indices of one model on one staged pair solve once; a new
    stage() call, or other hyperparameters, solve again."""
    rng = np.random.default_rng(3)
    X, Y = rng.normal(size=(40, 3)), rng.normal(size=(40, 1))
    dgp = DistributedGP(40)
    solves = []
    original = DistributedGP.posterior_alpha
    monkeypatch.setattr(DistributedGP, 'posterior_alpha',
                        lambda self, *a, **k: solves.append(1) or original(self, *a, **k))
    x, y = dgp.stage(X, Y)
    hypers = (np.ones(3), 1.0, 0.1)
    first = dgp.sobol_indices(*hypers, x, y, X)
    assert dgp.sobol_indices(*hypers, x, y, X) == first and len(solves) == 1
    dgp.sobol_indices(np.full(3, 2.0), 1.0, 0.1, x, y, X)
    assert len(solves) == 2
    x2, y2 = dgp.stage(X, Y)
    assert dgp.sobol_indices(*hypers, x2, y2, X) == first and len(solves) == 3
    dgp.sobol_indices(*hypers, x, y, X)          # the earlier pair is no longer staged
    assert len(solves) == 4


def test_calibrate_matches(problem):
    """One scipy L-BFGS-B descent in both packages from the same start: the
    LMLs agree, and romcomma_tpu's LML at the port's optimum is the port's."""
    X, Y = problem['X'], problem['Y'][:, :1]
    start = (np.full(M, 2.0), 1.0, 0.05)
    (ls_j, s2_j, noise_j), lml_j, _ = problem['jax'].calibrate(X, Y, *start, maxiter=200)
    (ls, s2, noise), lml, iterations = problem['port'].calibrate(X, Y, *start, maxiter=200)
    assert iterations > 5 and np.isfinite(lml)
    np.testing.assert_allclose(lml, float(lml_j), rtol=1e-6)
    at_port = problem['jax'].lml(ls.numpy(), s2.item(), noise.item(), *problem['jax_staged'])
    np.testing.assert_allclose(float(at_port), lml, rtol=VALUE_RTOL)


def test_calibrate_mask_freezes_groups(problem):
    """mask = (ls, s2, noise) 0/1: frozen groups stay at their start."""
    start = (np.full(M, 2.0), 1.0, 0.05)
    (ls, s2, noise), _, _ = problem['port'].calibrate(problem['X'], problem['Y'][:, :1], *start,
                                                      maxiter=30, mask=(1.0, 0.0, 0.0))
    assert s2.item() == pytest.approx(1.0, rel=1e-12)
    assert noise.item() == pytest.approx(0.05, rel=1e-12)
    assert not np.allclose(ls.numpy(), 2.0)


def test_calibrate_multi_matches_per_output():
    """The joint descent of the summed LMLs reaches each output's own
    optimum, at the tolerances of romcomma_tpu's
    test_calibrate_multi_matches_per_output."""
    rng = np.random.default_rng(21)
    Nn, Mm, L = 192, 3, 3
    X = rng.uniform(size=(Nn, Mm))
    Y = np.stack([np.sin((l + 1.0) * X[:, 0]) + 0.1 * X[:, 1] ** (l + 1)
                  + 0.05 * rng.standard_normal(Nn) for l in range(L)], axis=1)
    dgp = DistributedGP(Nn, block=16, dense_kernels=True)
    assert dgp.fits_multi(L)
    ls0 = np.full((L, Mm), 2.0)
    (ls_b, s2_b, noise_b), lml_b, _ = dgp.calibrate_multi(X, Y, ls0, np.ones(L),
                                                          np.full(L, 0.05), maxiter=60)
    assert lml_b.shape == (L,)
    for l in range(L):
        (ls_l, s2_l, noise_l), lml_l, _ = dgp.calibrate(X, Y[:, l:l + 1], ls0[l], 1.0, 0.05,
                                                        maxiter=60)
        assert abs(lml_b[l].item() - lml_l) < max(0.5, 0.02 * abs(lml_l))
        np.testing.assert_allclose(1.0 / ls_b[l].numpy(), 1.0 / ls_l.numpy(), rtol=0.3, atol=0.15)
        np.testing.assert_allclose(s2_b[l].item(), s2_l.item(), rtol=0.3, atol=0.3)
        np.testing.assert_allclose(noise_b[l].item(), noise_l.item(), rtol=0.3, atol=0.02)


def test_fits_multi_keeps_romcomma_tpus_rule():
    for n, L, dtype in ((10240, 3, np.float32), (20000, 3, np.float32), (18918, 3, np.float32),
                        (10240, 3, np.float64), (5000, 2, np.float64)):
        want = jax_dist.DistributedGP.MULTI_MEMORY_BUDGET_BYTES >= (
            3 * L * jax_dist.plan(n, 1, 256).Npad ** 2 * np.dtype(dtype).itemsize)
        assert DistributedGP(n, dtype=dtype).fits_multi(L) == want


@pytest.fixture(scope='module')
def one_output_fold(tmp_path_factory):
    """A one-output repository (ISHIGAMI's first output, N=64, M=3), made
    once with numpy and copied for each package; fold 0 trains on all rows."""
    root = tmp_path_factory.mktemp('large_route')
    rng = np.random.default_rng(7)
    X = rng.uniform(size=(64, 3))
    Y = (np.sin(2 * np.pi * X[:, :1]) + 7 * np.sin(2 * np.pi * X[:, 1:2]) ** 2
         + 0.1 * rng.normal(size=(64, 1)))
    columns = [('X', f'X.{i}') for i in range(3)] + [('Y', 'Y.0')]
    df = pd.DataFrame(np.concatenate((X, Y), axis=1), columns=pd.MultiIndex.from_tuples(columns))
    random.seed(0)
    JaxRepository.from_df(root / 'jax', df).into_K_folds(1)
    shutil.copytree(root / 'jax', root / 'port')
    return root


def test_mogp_large_route_matches(one_output_fold, monkeypatch):
    """MOGP.calibrate(large_n_threshold=1) in both packages: the tree is
    written, log_marginal.csv holds the optimizer's LML (and the port's LML at
    the written parameters, one CSV round trip away), both packages' LMLs
    agree at the port's parameters, and both descents reach the same LML."""
    monkeypatch.setattr(jax_dist, 'make_n_mesh', lambda n=1: _one_device_mesh())
    options = dict(maxiter=100, large_n_threshold=1, distributed_block=8)
    jax_gp = JaxMOGP('large', JaxFold(JaxRepository(one_output_fold / 'jax'), 0), is_read=False,
                     is_covariant=False, is_isotropic=False)
    jax_gp.calibrate(**options)
    fold = Fold(Repository(one_output_fold / 'port'), 0)
    optimizer_lmls, original = [], DistributedGP.calibrate

    def calibrate(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        optimizer_lmls.append(out[1])
        return out

    monkeypatch.setattr(DistributedGP, 'calibrate', calibrate)
    gp = MOGP('large', fold, is_read=False, is_covariant=False, is_isotropic=False)
    meta = gp.calibrate(**options)
    assert meta['large_n_threshold'] == 1 and meta['result'].startswith('Converged in [')
    folder = fold.folder / 'large'
    for csv in ('kernel/lengthscales.csv', 'kernel/variance.csv', 'likelihood/variance.csv',
                'likelihood/log_marginal.csv', 'meta.json'):
        assert (folder / csv).is_file(), csv
    stored = pd.read_csv(folder / 'likelihood' / 'log_marginal.csv', index_col=0).to_numpy()[0, 0]
    ls = pd.read_csv(folder / 'kernel' / 'lengthscales.csv', index_col=0).to_numpy()[0]
    s2 = pd.read_csv(folder / 'kernel' / 'variance.csv', index_col=0).to_numpy()[0, 0]
    noise = pd.read_csv(folder / 'likelihood' / 'variance.csv', index_col=0).to_numpy()[0, 0]
    # In memory exactly; on disk to the 16 significant digits pandas writes.
    assert optimizer_lmls == [gp.likelihood.data.log_marginal.np[0, 0]]
    np.testing.assert_allclose(stored, optimizer_lmls[0], rtol=1e-15)
    dgp = DistributedGP(gp.N)
    x, y = dgp.stage(gp.X, gp.Y)
    np.testing.assert_allclose(dgp.lml(ls, s2, noise, x, y).item(), stored, rtol=VALUE_RTOL)
    jax_dgp = jax_dist.DistributedGP(gp.N, _one_device_mesh(), block=8, dense_kernels=True)
    np.testing.assert_allclose(float(jax_dgp.lml(ls, s2, noise, *jax_dgp.stage(gp.X, gp.Y))),
                               stored, rtol=VALUE_RTOL)
    jax_stored = float(jax_gp.likelihood.data.log_marginal.np[0, 0])
    np.testing.assert_allclose(stored, jax_stored, rtol=1e-6)


class _Stop(Exception):
    """Ends a large-route calibration once its engines are built."""


def _large_route_engines(cls, engine_of, calibrate_model, monkeypatch) -> list:
    """The engines of the DistributedGPs that a large-route calibration
    builds: its own, then, its first descent ending non-finite, its float64
    rescue's, whose descent ends the calibration."""
    engines, init = [], cls.__init__

    def recorded(self, *args, **kwargs):
        init(self, *args, **kwargs)
        engines.append(engine_of(self))

    def calibrate(self, X, Y, ls0, s2_0, noise0, **kwargs):
        if len(engines) > 1:
            raise _Stop
        return (ls0, s2_0, noise0), -np.inf, 0

    monkeypatch.setattr(cls, '__init__', recorded)
    monkeypatch.setattr(cls, 'calibrate', calibrate)
    with pytest.raises(_Stop):
        calibrate_model()
    return engines


@pytest.mark.parametrize('min_n, want', [(None, ['upper', 'cyclic']), (32, ['cyclic2', 'cyclic'])],
                         ids=['below-the-threshold', 'past-the-threshold'])
def test_mogp_large_route_takes_romcomma_tpus_engines(one_output_fold, monkeypatch, min_n, want):
    """MOGP's large route in both packages, with CYCLIC2_SINGLE_CHIP_MIN_N as
    it is or lowered below the fold's N: the descent's engine and its float64
    rescue's are romcomma_tpu's, on one device."""
    monkeypatch.setattr(jax_dist, 'make_n_mesh', lambda n=1: _one_device_mesh())
    if min_n is not None:
        monkeypatch.setattr(jax_dist.DistributedGP, 'CYCLIC2_SINGLE_CHIP_MIN_N', min_n)
        monkeypatch.setattr(DistributedGP, 'CYCLIC2_SINGLE_CHIP_MIN_N', min_n)
    options = dict(maxiter=5, large_n_threshold=1, distributed_block=8)
    theirs = _large_route_engines(
        jax_dist.DistributedGP, lambda g: g._engine, lambda: JaxMOGP(
            'routing', JaxFold(JaxRepository(one_output_fold / 'jax'), 0), is_read=False,
            is_covariant=False, is_isotropic=False).calibrate(**options), monkeypatch)
    mine = _large_route_engines(
        DistributedGP, lambda g: g.engine, lambda: MOGP(
            'routing', Fold(Repository(one_output_fold / 'port'), 0), is_read=False,
            is_covariant=False, is_isotropic=False).calibrate(**options), monkeypatch)
    assert mine == theirs == want


def test_mogp_large_route_rescues_in_float64(tmp_path, monkeypatch):
    """A descent that ends on a non-finite LML is rerun on a float64 engine
    with at most 4 line-search steps; if that one is non-finite too, the
    route raises FloatingPointError."""
    rng = np.random.default_rng(9)
    X = rng.uniform(size=(30, 2))
    df = pd.DataFrame(np.concatenate((X, np.sin(3 * X[:, :1])), axis=1),
                      columns=pd.MultiIndex.from_tuples([('X', 'X.0'), ('X', 'X.1'), ('Y', 'Y.0')]))
    random.seed(0)
    fold = Fold(Repository.from_df(tmp_path / 'repo', df).into_K_folds(1), 0)
    calls, original = [], DistributedGP.calibrate

    def calibrate(self, X, Y, *args, max_linesearch_steps=None, **kwargs):
        calls.append((self.dtype, X.dtype, max_linesearch_steps))
        (ls, s2, noise), lml, iterations = original(self, X, Y, *args,
                                                    max_linesearch_steps=max_linesearch_steps,
                                                    **kwargs)
        return (ls, s2, noise), (lml if len(calls) in rescued else -np.inf), iterations

    monkeypatch.setattr(DistributedGP, 'calibrate', calibrate)
    rescued = {2}
    gp = MOGP('rescued', fold, is_read=False, is_covariant=False, is_isotropic=False)
    gp.calibrate(maxiter=20, large_n_threshold=1)
    assert calls[1] == (torch.float64, np.float64, 4) and len(calls) == 2
    assert np.isfinite(gp.likelihood.data.log_marginal.np).all()
    calls.clear()
    rescued = set()
    gp = MOGP('not_rescued', fold, is_read=False, is_covariant=False, is_isotropic=False)
    with pytest.raises(FloatingPointError, match='non-finite LML .* even at float64'):
        gp.calibrate(maxiter=20, large_n_threshold=1)
    assert len(calls) == 2


@pytest.mark.parametrize('steps', [None, 4])
def test_max_linesearch_steps_reaches_scipy_as_maxls(monkeypatch, steps):
    seen = {}
    original = lbfgs.sp_minimize

    def sp_minimize(*args, options, **kwargs):
        seen.update(options)
        return original(*args, options=options, **kwargs)

    monkeypatch.setattr(lbfgs, 'sp_minimize', sp_minimize)
    res = lbfgs.minimize(lambda p: torch.sum((p['x'] - 3.0) ** 2),
                         {'x': torch.zeros(2, dtype=torch.float64)}, max_linesearch_steps=steps)
    assert seen.get('maxls') == steps and np.allclose(res.params['x'].numpy(), 3.0)


@pytest.mark.parametrize('refused', [
    dict(mesh=['cpu', 'cpu']), dict(mesh=('cpu',) * 4), dict(mesh=[])],
    ids=['two-device-mesh', 'four-device-mesh', 'empty-mesh'])
def test_multi_device_engines_are_refused_by_name(refused):
    with pytest.raises(ValueError, match='multi-device engines'):
        DistributedGP(10, **refused)


@pytest.mark.parametrize('tier', [dict(gsa_dtype=np.float32), dict(intervals_mixed=True),
                                  dict(intervals_mixed='ff'), dict(error_solver='device')],
                         ids=['float32-planes', 'mixed-exp', 'ff-exp', 'device-psi-solver'])
def test_tpu_tiers_are_refused_by_name(tier):
    dgp = DistributedGP(10)
    X = np.random.default_rng(0).normal(size=(10, 2))
    with pytest.raises(ValueError, match=distributed.TPU_TIERS[:30]):
        dgp.sobol_indices(np.ones(2), 1.0, 0.1, *dgp.stage(X, X[:, :1]), X, **tier)


def test_north_star_record_on_the_cpu():
    """north_star.run at a small size: every field of the JSON record, and
    the problem's structure in the indices (inputs 0 and 1 carry the output,
    input 2 none)."""
    out, state = north_star.run(200, 4, 100, on='cpu')
    assert {'valgrad_s', 'iters', 'gsa_phases_warm', 'lml', 'stage_s', 'train_s',
            'gsa_both_kinds_s', 'gsa_both_kinds_warm_s', 'end_to_end_s', 'S1_first3',
            'ST_first3', 'peak_gib', 'card'} <= set(out)
    assert out['iters'] > 5 and np.isfinite(out['lml']) and out['device'] == 'cpu'
    assert out['gsa_phases_warm']['posterior_s'] < out['gsa_both_kinds_s']
    S1 = out['S1_first3']
    assert S1[0] > 0.3 and S1[1] > 0.3 and S1[2] < 0.01 and sum(S1) < 1.01
    assert state['x_dev'].dtype == torch.float32


#: The stacked GSA's problem: problem()'s X with three outputs, and the chunk
#: both routes take, so that the stacked pass and the loop add alike.
STACKED_L, STACKED_CHUNK = 3, 32
STACKED_KINDS = ('first_order', 'closed', 'total')


@pytest.fixture(scope='module')
def stacked(problem):
    """Three outputs' indices, without and with errors: the port's stacked
    pass ('upper' and a one-device 'cyclic2') and its per-output loop, and
    romcomma_tpu's stacked pass, computed once."""
    X = problem['X']
    rng = np.random.default_rng(17)
    Y = np.concatenate([problem['Y'], np.cos(X[:, 2:3]) + 0.05 * rng.normal(size=(N, 1))], axis=1)
    ls, s2, noise = problem['hypers']
    hypers = (np.stack([ls, 1.4 * ls, 0.8 * ls]), np.array([s2, 0.9, 1.2]),
              np.array([noise, 0.04, 0.06]))
    out = {'hypers': hypers}
    engines = {'upper': problem['port'],
               'cyclic2': DistributedGP(N, block=BLOCK, dtype=np.float64, engine='cyclic2')}
    for error in (False, True):
        options = dict(kind=STACKED_KINDS, error=error, n_chunk=STACKED_CHUNK)
        for name, dgp in engines.items():
            x, y = dgp.stage(X, Y)
            out[name, error] = dgp.sobol_indices(*hypers, x, y, X, **options)
            out[name, error, 'timings'] = dict(dgp.last_gsa_timings)
            out[name, error, 'loop'] = [
                dgp.sobol_indices(*(h[l] for h in hypers), x, y[:, l:l + 1], X, **options)
                for l in range(STACKED_L)]
        jax_dgp = problem['jax']
        out['romcomma_tpu', error] = jax_dgp.sobol_indices(
            *hypers, *jax_dgp.stage(X, Y), X, kind=STACKED_KINDS, error=error)
    return out


def _tables(result, error: bool):
    """{part: (kinds, M) array} of one output's indices."""
    tables = {'S': result['S'] if error else result} | ({'T': result['T']} if error else {})
    return {part: np.array([[t[k][m] for m in range(M)] for k in STACKED_KINDS])
            for part, t in tables.items()}


@pytest.mark.parametrize('engine', ['upper', 'cyclic2'])
@pytest.mark.parametrize('error', [False, True], ids=['S', 'S-and-T'])
def test_stacked_sobol_indices_match_the_loop(stacked, engine, error):
    """Three outputs in one stacked pass: each output's S (and T) within 1e-12
    of its own sobol_indices call, on the chunks both take."""
    got = stacked[engine, error]
    assert isinstance(got, list) and len(got) == STACKED_L
    assert stacked[engine, error, 'timings']['outputs'] == STACKED_L
    for g, w in zip(got, stacked[engine, error, 'loop']):
        for part, table in _tables(g, error).items():
            np.testing.assert_allclose(table, _tables(w, error)[part], rtol=0, atol=1e-12)


@pytest.mark.parametrize('error', [False, True], ids=['S', 'S-and-T'])
def test_stacked_sobol_indices_match_romcomma_tpu(stacked, error):
    """The stacked pass against romcomma_tpu's ``_sobol_indices_multi[_error]``:
    S at S_TOL, T as T^2 (test_torch_slice.py's rule)."""
    for g, w in zip(stacked['upper', error], stacked['romcomma_tpu', error]):
        got, want = _tables(g, error), _tables(w, error)
        np.testing.assert_allclose(got['S'], want['S'], **S_TOL)
        if error:
            T2, W2 = got['T'] ** 2, want['T'] ** 2
            assert np.all(np.abs(T2 - W2) <= T2_RTOL * W2 + T2_ROW_FLOOR * W2.max()), (T2, W2)


def test_multi_output_sobol_indices_take_one_stacked_pass(problem, monkeypatch):
    """sobol_indices with (L, M) lengthscales runs ONE interval pass of all
    L calibrators (and one W/T sweep), not one per output."""
    passes, sweeps = [], []
    intervals_pass = calibrators._intervals_pass
    monkeypatch.setattr(calibrators, '_intervals_pass',
                        lambda cals, slices: passes.append(len(cals)) or intervals_pass(cals, slices))
    from romcomma_tpu_torch.gsa import factorized_errors
    scan = factorized_errors.error_scan_folds
    monkeypatch.setattr(factorized_errors, 'error_scan_folds',
                        lambda cals, need: sweeps.append(len(cals)) or scan(cals, need))
    ls, s2, noise = problem['hypers']
    dgp = problem['port']
    x, y = dgp.stage(problem['X'], problem['Y'])
    hypers = (np.stack([ls, ls]), np.array([s2, s2]), np.array([noise, noise]))
    dgp.sobol_indices(*hypers, x, y, problem['X'], kind=KINDS, error=True)
    assert passes == [2] and sweeps == [2]


def test_measurement_entry_points_on_the_cpu(monkeypatch):
    """cyclic2_engine, multi_output_gsa and error_gsa at a small size: every
    engine's value and gradient agree, the stacked pass is the loop's, and
    the large route's W/T GSA ('cyclic2' here, the threshold lowered) is the
    CPU oracle's, checked on the problem's first rows."""
    out = cyclic2_engine.run((200,), 4, 1, on='cpu')
    row = out['200']
    assert set(row) == set(cyclic2_engine.ENGINES)
    for name in ('exact', 'cyclic2', 'cyclic'):
        assert row[name]['value'] == pytest.approx(row['upper']['value'], rel=1e-4)
        assert row[name]['grad_l2'] == pytest.approx(row['upper']['grad_l2'], rel=1e-4)
    out = multi_output_gsa.run(200, 4, 3, 'error_all', on='cpu', n_chunk=64)
    assert out['max_dS_vs_sequential'] <= 1e-12 and out['max_dT_vs_sequential'] <= 1e-12
    assert out['stacked_timings']['outputs'] == 3
    monkeypatch.setattr(DistributedGP, 'CYCLIC2_SINGLE_CHIP_MIN_N', 100)
    monkeypatch.setattr(error_gsa, 'ORACLE_MAX_N', 150)
    out = error_gsa.run(200, 4, on='cpu')
    assert out['engine'] == 'cyclic2' and out['oracle_N'] == 150
    assert out['max_abs_dS_vs_cpu_f64'] <= 1e-10
    assert out['max_abs_dT2_vs_cpu_f64'] <= T2_RTOL * out['max_T2'] + 1e-12
    with pytest.raises(ValueError, match=distributed.TPU_TIERS[:30]):
        error_gsa.run(200, 4, intervals_mixed='ff', on='cpu')
