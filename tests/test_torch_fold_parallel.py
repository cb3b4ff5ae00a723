"""The port's fold-batched path against its own sequential loop and against
romcomma_tpu's, in float64 on the CPU: the batched plain gram, the batched
ExactLML, the lockstep descents (models.gp.calibrate_variant_folds), the
fold-stacked GSA (calibrators.marginalize_all_kinds_folds) and run.gpr /
run.gsa's ``fold_parallel`` tri-state."""

import random
import shutil
import threading
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from romcomma_tpu import user as jax_user
from romcomma_tpu.data.storage import Repository as JaxRepository
from romcomma_tpu.models import gp as jax_gp
from romcomma_tpu.models.params import variant_init as jax_variant_init
from romcomma_tpu.models.params import variant_mask as jax_variant_mask
from romcomma_tpu_torch import user
from romcomma_tpu_torch.base.definitions import pinned_device
from romcomma_tpu_torch.data.storage import Fold, Repository
from romcomma_tpu_torch.gsa import calibrators
from romcomma_tpu_torch.gsa.models import GSA, Sobol
from romcomma_tpu_torch.models import gp
from romcomma_tpu_torch.models.gpr import MOGP
from romcomma_tpu_torch.models.params import variant_init, variant_mask
from romcomma_tpu_torch.ops import gram, gram_kernels, lbfgs
from romcomma_tpu_torch.user import run
from test_torch_slice import _indices_close


@pytest.fixture(scope='module', autouse=True)
def _on_the_cpu():
    """The port computes on the CPU here because the tests ask for it: it
    raises where there is no CUDA device and nothing was asked for."""
    with pinned_device(torch.device('cpu')):
        yield


torch.set_num_threads(1)


# --------------------------------------------------------------------------- #
# The batched gram and LML
# --------------------------------------------------------------------------- #

def test_batched_plain_gram_is_each_members_own():
    """unit_gram_plain over a batch, and rbf_gram_variant over members with
    inputs of their own, against one plain gram per member."""
    rng = np.random.default_rng(0)
    u, v = torch.tensor(rng.normal(size=(4, 37, 5))), torch.tensor(rng.normal(size=(4, 23, 5)))
    got = gram_kernels.unit_gram_plain(u, v)
    for i in range(4):
        torch.testing.assert_close(got[i], gram_kernels.unit_gram_plain(u[i], v[i]),
                                   rtol=1e-15, atol=1e-15)
    ls, s2 = torch.tensor(rng.uniform(0.5, 2.0, (4, 5))), torch.tensor(rng.uniform(0.5, 2.0, 4))
    got = gram.rbf_gram_variant(u, u, ls, s2)
    for i in range(4):
        torch.testing.assert_close(got[i], gram.rbf_gram(u[i], u[i], ls[i], s2[i]),
                                   rtol=1e-15, atol=1e-15)


def _lml_problem(B=5, N=30, M=4, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(-1, 1, (B, N, M)))
    y = torch.tensor(np.sin(2 * x[..., 0].numpy()) + 0.1 * rng.normal(size=(B, N)))
    ls = torch.tensor(rng.uniform(0.5, 2.0, (B, M)))
    s2, noise = torch.tensor(rng.uniform(0.5, 2.0, B)), torch.tensor(rng.uniform(0.01, 0.1, B))
    return ls, s2, noise, x, y


def _value_and_grad(ls, s2, noise, x, y):
    leaves = [t.clone().requires_grad_(True) for t in (ls, s2, noise)]
    value = gp.ExactLML.apply(*leaves, x, y)
    return value.detach(), torch.autograd.grad(value.sum(), leaves)


@pytest.mark.parametrize('isotropic', [False, True], ids=['ARD', 'isotropic'])
def test_batched_exact_lml_is_each_members_own(isotropic):
    """The batched ExactLML's values and gradients against one ExactLML per
    member, within 1e-12; lengthscales (B, M) or (B, 1)."""
    ls, s2, noise, x, y = _lml_problem()
    if isotropic:
        ls = ls[:, :1]
    value, grads = _value_and_grad(ls, s2, noise, x, y)
    for b in range(x.shape[0]):
        want, want_grads = _value_and_grad(ls[b], s2[b], noise[b], x[b], y[b])
        torch.testing.assert_close(value[b], want, rtol=1e-12, atol=1e-12)
        for got, expected in zip(grads, want_grads):
            torch.testing.assert_close(got[b], expected, rtol=1e-12, atol=1e-12)


def test_a_member_that_breaks_down_leaves_the_others_finite():
    """A member whose gram is not positive definite gives -inf, and a
    non-finite gradient, for itself only."""
    ls, s2, noise, x, y = _lml_problem()
    noise[2] = -5.0
    value, grads = _value_and_grad(ls, s2, noise, x, y)
    assert value[2] == -torch.inf
    others = [0, 1, 3, 4]
    assert torch.isfinite(value[others]).all()
    for g in grads:
        assert torch.isfinite(g[others]).all() and not torch.isfinite(g[2]).all()
    for b in others:
        want, want_grads = _value_and_grad(ls[b], s2[b], noise[b], x[b], y[b])
        torch.testing.assert_close(value[b], want, rtol=1e-12, atol=1e-12)
        for got, expected in zip(grads, want_grads):
            torch.testing.assert_close(got[b], expected, rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------------------- #
# The lockstep descents
# --------------------------------------------------------------------------- #

def _folds(K=4, N=40, M=3, L=2, seed=0):
    """tests/test_fold_parallel.py's problem, as numpy arrays."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1, 1, (K, N, M))
    ys = np.stack([np.sin(2 * xs[..., 0]) + 0.1 * rng.normal(size=(K, N)),
                   xs[..., 1] ** 2 + 0.1 * rng.normal(size=(K, N))], axis=-1)[..., :L]
    return xs, ys, (np.full(L, 1.0), np.full((L, M), 1.0), np.full(L, 0.1))


@pytest.fixture(scope='module')
def folds():
    xs, ys, start = _folds()
    K = xs.shape[0]
    raws = [variant_init(*start) for _ in range(K)]
    raws = {leaf: torch.stack([raw[leaf] for raw in raws]) for leaf in raws[0]}
    return xs, ys, start, raws, gp.calibrate_variant_folds(
        raws, variant_mask(), torch.tensor(xs), torch.tensor(ys), maxiter=40)


def test_batched_descents_are_the_sequential_ones(folds):
    """Each fold and output's lockstep descent is the one calibrate_variant
    makes fold by fold: LML and parameters within 1e-9, the same iteration
    count and stop reason."""
    xs, ys, _, raws, (raw_opt, lml, iterations, stops) = folds
    for k in range(xs.shape[0]):
        single_raw, single_lml, single_iterations = gp.calibrate_variant(
            {leaf: value[k] for leaf, value in raws.items()}, variant_mask(),
            torch.tensor(xs[k]), torch.tensor(ys[k]), maxiter=40)
        torch.testing.assert_close(lml[k], single_lml, rtol=1e-9, atol=1e-9)
        assert torch.equal(iterations[k], single_iterations)
        for leaf in raws:
            torch.testing.assert_close(raw_opt[leaf][k], single_raw[leaf], rtol=1e-9, atol=1e-9)
        assert all(stop.startswith('STOP') or 'CONVERGENCE' in stop for stop in stops[k])


def test_batched_descents_match_romcomma_tpus(folds):
    """Against romcomma_tpu's vmapped calibrate_variant_folds, at its own
    test's tolerances (tests/test_fold_parallel.py: LML 1e-5, parameters
    1e-3). From one cold start the two optimizers (its optax L-BFGS, the
    port's scipy L-BFGS-B) need not stop at one point on this multimodal
    problem: run to convergence, 2 of its 8 descents end in different local
    optima. So romcomma_tpu's batched descents run to convergence, and the
    port's start from their optimum and must stay there: each package's
    stationary point is the other's, through the batched LML."""
    xs, ys, start, _, _ = folds
    K = xs.shape[0]
    jraws = jax.tree_util.tree_map(lambda *leaves: jnp.stack(leaves),
                                   *[jax_variant_init(*start) for _ in range(K)])
    want = jax_gp.calibrate_variant_folds(jraws, jax_variant_mask(), jnp.asarray(xs),
                                          jnp.asarray(ys), maxiter=1000)
    leaves = ('raw_variance', 'raw_lengthscales', 'raw_noise')
    raws = {leaf: torch.tensor(np.asarray(value)) for leaf, value in zip(leaves, want[0])}
    raw_opt, lml, _, _ = gp.calibrate_variant_folds(raws, variant_mask(), torch.tensor(xs),
                                                    torch.tensor(ys), maxiter=1000)
    np.testing.assert_allclose(lml.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    for leaf in leaves:
        np.testing.assert_allclose(raw_opt[leaf].numpy(), raws[leaf].numpy(), rtol=1e-3,
                                   atol=1e-3)


def _quadratics(n=5, P=3, seed=0):
    """n convex quadratics sum((p - t_i)^2 w_i); descent 0 starts at its
    minimum, so it returns while the others still descend."""
    rng = np.random.default_rng(seed)
    targets = torch.tensor(rng.normal(size=(n, P)))
    weights = torch.tensor(rng.uniform(0.5, 5.0, (n, P)))
    starts = [{'p': targets[0].clone()}] + [{'p': torch.full((P,), 0.1 * i, dtype=torch.float64)}
                                            for i in range(1, n)]
    return targets, weights, starts


def _batch(targets, weights, sizes):
    def batch(members, p):
        sizes.append(len(members))
        return torch.sum((p['p'] - targets[members]) ** 2 * weights[members], dim=-1)
    return batch


def test_lockstep_descents_that_return_early_leave_the_batch():
    """A descent that returns between two evaluations leaves the batch, and
    every descent is the one lbfgs.minimize makes on its own."""
    targets, weights, starts = _quadratics()
    sizes = []
    got = lbfgs.minimize_lockstep(_batch(targets, weights, sizes), starts)
    assert sizes[0] == len(starts) and min(sizes) < len(starts)
    for i, result in enumerate(got):
        want = lbfgs.minimize(lambda p: torch.sum((p['p'] - targets[i]) ** 2 * weights[i]),
                              starts[i])
        assert result.iterations == want.iterations and result.message == want.message
        assert result.value == want.value
        torch.testing.assert_close(result.params['p'], want.params['p'], rtol=0, atol=0)


@pytest.mark.parametrize('where', ['in the batched call', 'in a descent'])
def test_lockstep_stops_every_descent_and_raises(monkeypatch, where):
    """An error in the batched call, or in one descent's own scipy step,
    stops every descent and is raised; no thread is left waiting."""
    targets, weights, starts = _quadratics(seed=1)
    sizes = []
    batch = _batch(targets, weights, sizes)
    if where == 'in the batched call':
        def breaking(members, p):
            if len(sizes) == 2:
                raise RuntimeError('the batch broke')
            return batch(members, p)
    else:
        breaking, scipy_minimize = batch, lbfgs.sp_minimize

        def flaky(fun, x0, **options):
            """Descent 2's objective raises on its third evaluation."""
            if not np.allclose(x0, 0.2):
                return scipy_minimize(fun, x0, **options)
            calls = []

            def fun_2(x):
                calls.append(x)
                if len(calls) == 3:
                    raise RuntimeError('a descent broke')
                return fun(x)
            return scipy_minimize(fun_2, x0, **options)

        monkeypatch.setattr(lbfgs, 'sp_minimize', flaky)
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match='broke'):
        lbfgs.minimize_lockstep(breaking, starts)
    assert threading.active_count() == threads


# --------------------------------------------------------------------------- #
# The fold-stacked GSA, and run.gpr / run.gsa
# --------------------------------------------------------------------------- #

GSA_OPTIONS = dict(is_covariant=False, is_isotropic=False, is_error_calculated=True,
                   is_T_partial=False)


@pytest.fixture(scope='module')
def ishigami(tmp_path_factory):
    """tests/test_gsa.py::test_fold_batched_gsa_matches_sequential's problem:
    Ishigami at N=120, M=3, K=2 (two 60-row folds and the improper one),
    trained by the port's run.gpr on its batched path (maxiter=40)."""
    root = tmp_path_factory.mktemp('ishigami')
    np.random.seed(1)
    noise = user.sample.GaussianNoise.Variance(3, 0.05, False, True)
    repo = user.sample.Function(root, user.sample.DOE.latin_hypercube, user.functions.ISHIGAMI,
                                120, 3, noise, overwrite_existing=True,
                                seed=1).repo.into_K_folds(2)
    user.run.gpr('gpr', repo, is_read=False, is_covariant=False, is_isotropic=False,
                 maxiter=40, fold_parallel=True)
    return repo


def _kind_slices(gp_):
    sobols = [Sobol(gp_, kind, -1, True, is_T_partial=False) for kind in GSA.ALL_KINDS]
    return {s.kind.name: tuple(s._m_dataset) for s in sobols}, sobols[0].meta


@pytest.mark.parametrize('n_chunk', [None, 16], ids=['auto chunk', 'chunks of 16'])
def test_stacked_gsa_is_each_folds_own(ishigami, n_chunk):
    """marginalize_all_kinds_folds over the two 60-row folds against
    marginalize_all_kinds fold by fold: V, S, W and T of every slice of every
    kind, and the extras, within 1e-12 of each table's largest entry."""
    gps = [MOGP('gpr.v.a', Fold(ishigami, k), is_read=True, is_covariant=False,
                is_isotropic=False) for k in (0, 1)]
    kind_slices, meta = _kind_slices(gps[0])
    meta = meta | ({} if n_chunk is None else {'n_chunk': n_chunk})
    stacked = calibrators.marginalize_all_kinds_folds(gps, kind_slices, True, **meta)
    for gp_, (by_kind, extras) in zip(gps, stacked):
        want_by_kind, want_extras = calibrators.marginalize_all_kinds(gp_, kind_slices, True,
                                                                      **meta)
        pairs = [(by_kind[kind][key], want_by_kind[kind][key]) for kind in kind_slices
                 for key in 'VSWT'] + [(extras[key], want_extras[key]) for key in want_extras]
        assert set(extras) == set(want_extras) == {'V0', 'S', 'T'}
        for got, want in pairs:
            torch.testing.assert_close(got, want, rtol=0.0, atol=1e-12 * want.abs().max().item())


def test_run_gsa_batched_writes_the_sequential_csvs(ishigami, tmp_path):
    """run.gsa(fold_parallel=True) and run.gsa(fold_parallel=False) on copies
    of one trained tree write the same S, V, T and W, CSV by CSV, within
    1e-12 relative, and the same Collect-ed tables."""
    trees = {}
    for parallel in (True, False):
        shutil.copytree(ishigami.folder, tmp_path / str(parallel))
        trees[parallel] = Repository(tmp_path / str(parallel))
        user.run.gsa('gpr', trees[parallel], fold_parallel=parallel, **GSA_OPTIONS)
    files = sorted(p.relative_to(tmp_path / 'True') for p in (tmp_path / 'True').rglob('*.csv')
                   if 'gsa' in p.parts)
    assert len(files) == 3 * 4 * 4      # three folds and the Collect, three kinds, S V T W
    for path in files:
        got = pd.read_csv(tmp_path / 'True' / path).to_numpy(dtype=float)
        want = pd.read_csv(tmp_path / 'False' / path).to_numpy(dtype=float)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0, err_msg=str(path))


def test_auto_mode_takes_the_batched_paths(ishigami, tmp_path, monkeypatch):
    """fold_parallel=None (the default) batches the two 60-row folds of both
    run.gpr and run.gsa."""
    shutil.copytree(ishigami.folder, tmp_path / 'repo')
    repo = Repository(tmp_path / 'repo')
    calls = []
    for module, name in ((gp, 'calibrate_variant_folds'),
                         (run, 'marginalize_all_kinds_folds')):
        original = getattr(module, name)

        def spy(*args, _original=original, _name=name, **kwargs):
            calls.append(_name)
            return _original(*args, **kwargs)
        monkeypatch.setattr(module, name, spy)
    with warnings.catch_warnings():
        warnings.simplefilter('error', RuntimeWarning)
        user.run.gpr('auto', repo, is_read=False, is_covariant=False, is_isotropic=False,
                     maxiter=5)
        user.run.gsa('gpr', repo, **GSA_OPTIONS)
    assert calls == ['calibrate_variant_folds', 'marginalize_all_kinds_folds']


def _small_repository(root: Path, N=48, M=3, seed=1) -> Repository:
    """tests/test_fold_parallel.py::test_run_gpr_fold_parallel_wiring's data."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(N, M))
    Y = np.sin(2 * X[:, :1]) + 0.5 * X[:, 1:2] ** 2 + 0.05 * rng.standard_normal((N, 1))
    cols = pd.MultiIndex.from_tuples([('X', f'x{i}') for i in range(M)] + [('Y', 'y0')])
    repo = Repository.from_df(root, pd.DataFrame(np.concatenate([X, Y], axis=1), columns=cols))
    return repo.into_K_folds(2)


def test_run_gpr_fold_parallel_wiring(tmp_path):
    """run.gpr(fold_parallel=True) batches the equal-shape fold group through
    calibrate_variant_folds (the improper fold runs in place through
    MOGP.calibrate) and persists what a direct call of it gives on the same
    fresh-initialized parameters: the LML recomputed from the written
    parameters, within 1e-9."""
    repo = _small_repository(tmp_path / 'repo')
    proper = [k for k in repo.folds if Fold(repo, k).N < 48]
    gps = [MOGP('probe', Fold(repo, k), False, False, False) for k in proper]
    raws = [g._variant_raw() for g in gps]
    raws = {leaf: torch.stack([raw[leaf] for raw in raws]) for leaf in raws[0]}
    xs = torch.stack([g._tensor(g.X).mT for g in gps]).mT      # each fold's layout, as run's
    ys = torch.stack([g._tensor(g.Y) for g in gps])
    raw_opt, _, _, _ = gp.calibrate_variant_folds(raws, variant_mask(), xs, ys, maxiter=30)
    expect = [gp.lml_variant({leaf: value[i] for leaf, value in raw_opt.items()}, xs[i], ys[i])
              for i in range(len(gps))]
    names = user.run.gpr('par', repo, is_read=False, is_covariant=False, is_isotropic=False,
                         fold_parallel=True, maxiter=30)
    assert names == ['par.v.a']
    for i, k in enumerate(proper):
        written = pd.read_csv(repo.fold_folder(k) / 'par.v.a' / 'likelihood' / 'log_marginal.csv',
                              index_col=0).to_numpy()
        np.testing.assert_allclose(written[0], expect[i].detach().numpy(), rtol=1e-9, atol=1e-9)
        assert (repo.fold_folder(k) / 'par.v.a' / 'test_summary.csv').exists()
    assert (repo.fold_folder(max(repo.folds)) / 'par.v.a' / 'test_summary.csv').exists()


@pytest.mark.parametrize('step', ['gpr', 'gsa'])
def test_fold_parallel_tri_state(tmp_path, monkeypatch, step):
    """In auto mode a failure of the batched path falls back to the
    sequential loop with a RuntimeWarning naming the exception;
    fold_parallel=True raises it; KeyboardInterrupt always passes through."""
    repo = _small_repository(tmp_path / 'repo')
    options = dict(is_covariant=False, is_isotropic=False)
    if step == 'gsa':
        user.run.gpr('fb', repo, is_read=False, maxiter=5, **options)

    def call(fold_parallel):
        if step == 'gpr':
            return user.run.gpr('fb', repo, is_read=False, fold_parallel=fold_parallel,
                                maxiter=5, **options)
        return user.run.gsa('fb', repo, fold_parallel=fold_parallel, **options)

    def boom(*args, **kwargs):
        raise RuntimeError('engine exploded')

    monkeypatch.setattr(run, f'_{step}_fold_batched', boom)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        names = call(None)
    assert [str(n) for n in names] == (['fb.v.a'] if step == 'gpr' else [
        str(Path('fb.v.a') / 'gsa' / kind) for kind in ('first_order', 'closed', 'total')])
    messages = [str(w.message) for w in caught if w.category is RuntimeWarning]
    assert any('engine exploded' in m and 'sequential' in m for m in messages), messages
    with pytest.raises(RuntimeError, match='engine exploded'):
        call(True)

    def interrupt(*args, **kwargs):
        raise KeyboardInterrupt

    monkeypatch.setattr(run, f'_{step}_fold_batched', interrupt)
    with pytest.raises(KeyboardInterrupt):
        call(None)


SLICE_N, SLICE_M, SLICE_K, SLICE_SEED = 40, 5, 2, 1


@pytest.fixture(scope='module')
def slice_trees(tmp_path_factory):
    """tests/test_torch_slice.py's repository (its data seed, at which every
    fold and output of both packages reaches one optimum), trained by each
    package's run.gpr with fold_parallel=True; then each package's run.gsa
    with fold_parallel=True on a copy of the port-trained tree."""
    root = tmp_path_factory.mktemp('slice_batched')
    rng = np.random.default_rng(SLICE_SEED)
    X = rng.uniform(size=(SLICE_N, SLICE_M))
    Y = jax_user.functions.ISHIGAMI(X)
    Y = Y + 0.05 * np.std(Y, axis=0) * rng.normal(size=Y.shape)
    columns = ([('X', f'X.{i}') for i in range(SLICE_M)]
               + [('Y', f'Y.{i}') for i in range(Y.shape[1])])
    df = pd.DataFrame(np.concatenate((X, Y), axis=1), columns=pd.MultiIndex.from_tuples(columns))
    random.seed(0)                    # the fold assignment draws from `random`
    JaxRepository.from_df(root / 'jax', df).into_K_folds(SLICE_K)
    shutil.copytree(root / 'jax', root / 'port')
    options = dict(is_read=False, is_covariant=False, is_isotropic=None, fold_parallel=True)
    assert (jax_user.run.gpr('gpr', JaxRepository(root / 'jax'), **options)
            == user.run.gpr('gpr', Repository(root / 'port'), **options))
    gsa_options = GSA_OPTIONS | {'kinds': user.run.GSA.ALL_KINDS, 'fold_parallel': True}
    for package, module, repository in (('jax_gsa', jax_user, JaxRepository),
                                        ('port_gsa', user, Repository)):
        shutil.copytree(root / 'port', root / package)
        module.run.gsa('gpr', repository(root / package), **gsa_options)
    return root


def test_slice_with_fold_parallel_matches_romcomma_tpu(slice_trees):
    """The whole slice, both packages on their batched paths, at
    tests/test_torch_slice.py's tolerances: each fold's LML at rtol 1e-4
    (optax against scipy, see its test_fold_lmls_agree), then S, V, T and W
    of every fold and kind from one trained tree."""
    for k in range(SLICE_K + 1):
        for name in ('gpr.v.i', 'gpr.v.a'):
            path = Path(f'fold.{k}') / name / 'likelihood' / 'log_marginal.csv'
            np.testing.assert_allclose(pd.read_csv(slice_trees / 'port' / path, index_col=0),
                                       pd.read_csv(slice_trees / 'jax' / path, index_col=0),
                                       rtol=1e-4)
        for kind in ('first_order', 'closed', 'total'):
            for csv in 'SVTW':
                path = Path(f'fold.{k}') / 'gpr.v.a' / 'gsa' / kind / f'{csv}.csv'
                got = pd.read_csv(slice_trees / 'port_gsa' / path, index_col=[0, 1])
                want = pd.read_csv(slice_trees / 'jax_gsa' / path, index_col=[0, 1])
                assert list(got.columns) == list(want.columns) and got.index.equals(want.index)
                _indices_close(got.to_numpy(), want.to_numpy(), csv, kind, str(path))
