"""The port's multi-device variant route against romcomma_tpu's, on the CPU:
over S = 2, 3 and 4 spawned gloo ranks (one spawn per S), ``DistributedGP``'s
'cyclic' and 'cyclic2' engines (gram, factor, log-det, solves, LML and
gradient, float64 posterior and predictions, the indices with T through the
mesh's GSA sweeps), the deferred engine with several super panels and a
partial tail (parallel/cyclic_deferred.py) and the error calibrator's mesh
sweeps (gsa/mesh.py), each held to romcomma_tpu's on make_n_mesh(S) of the
conftest's 8 virtual devices from the same seeded inputs; every rank's
results are bitwise equal, a short calibrate included, and a float32
engine computes in float32 throughout, as romcomma_tpu's. The spawns also run
tests/test_torch_covariant_mesh.py's rank bodies (``mesh_suite_runs``)."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks
from jax import lax

from romcomma_tpu.gsa.calibrators import ClosedSobolWithError as JaxClosedSobolWithError
from romcomma_tpu.ops.gram import rbf_gram as jax_rbf_gram
from romcomma_tpu.parallel import cyclic_deferred as jax_cd
from romcomma_tpu.parallel import distributed as jax_dist
from romcomma_tpu_torch.parallel import spawn
from test_torch_slice import T2_ROW_FLOOR, T2_RTOL

torch.set_num_threads(1)

SIZES = (2, 3, 4)
#: Super panels of q blocks per rank for the deferred engine's own test, per
#: S: c = 5, 4, 3 blocks per rank, so q = 2 leaves a partial tail panel (and
#: a clamped tail chunk in the gradient) at S = 2 and 4, and q = 1 makes
#: four panels at S = 3.
PANEL_BLOCKS = {2: 2, 3: 1, 4: 2}
SLICES = ((0, ranks.M),) + tuple((m, m + 1) for m in range(ranks.M)) + tuple(
    (0, m + 1) for m in range(ranks.M)) + tuple((m + 1, ranks.M) for m in range(ranks.M))
#: tests/test_cyclic_deferred.py's and the JAX suite's distributed tolerances.
GRAM_ATOL, FACTOR_ATOL, LOGDET_ATOL, ALPHA_ATOL, INVERSE_ATOL = 1e-12, 1e-11, 1e-10, 1e-9, 1e-10
LML_RTOL, GRAD = 1e-12, dict(rtol=1e-8, atol=1e-10)
S_ATOL = V_ATOL = 1e-10


def mesh_suite_runs(tmp_path_factory):
    """(the port's results per S, [rank 0's, rank 1's, ...] of
    ranks.mesh_suite on S gloo ranks, one spawn each; romcomma_tpu's per S:
    its engines, its deferred engine at PANEL_BLOCKS[S], its mesh sweeps;
    romcomma_tpu's for tests/test_torch_covariant_mesh.py), computed once
    for the whole test run, by whichever of the two files asks first
    (ranks.run_once). romcomma_tpu's are computed while the spawns run."""
    base = tmp_path_factory.getbasetemp()
    folder = (base.parent if os.environ.get('PYTEST_XDIST_WORKER') else base) / 'mesh_suite'

    def compute():
        from test_torch_covariant_mesh import covariant_references
        arrays = _arrays()
        with ThreadPoolExecutor(len(SIZES) + 1) as pool:
            spawns = {S: pool.submit(spawn.run, ranks.mesh_suite, S, PANEL_BLOCKS[S], arrays,
                                     SLICES, timeout=300) for S in SIZES}
            covariant = pool.submit(covariant_references)
            theirs = {S: {} for S in SIZES}
            for (S, engine), result in _reference().items():
                theirs[S][engine] = result
            for S in SIZES:   # after _reference: its host-paced sweep programs are reused
                theirs[S].update(deferred=_deferred_reference(S, PANEL_BLOCKS[S]),
                                 sweeps=_sweeps_reference(S, arrays))
            return ({S: done.result() for S, done in spawns.items()}, theirs,
                    covariant.result())

    return ranks.run_once(folder, 'mesh_suite', compute)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """(the port's results per S, romcomma_tpu's per S): mesh_suite_runs'."""
    return mesh_suite_runs(tmp_path_factory)[:2]


@pytest.fixture(scope='module')
def port(runs):
    return {S: [r['engines'] for r in results] for S, results in runs[0].items()}


@pytest.fixture(scope='module')
def reference(runs):
    return {(S, engine): theirs[engine] for S, theirs in runs[1].items()
            for engine in ranks.ENGINES}


def _deferred_reference(S, q):
    """romcomma_tpu's DeferredEngine at super_block = q S B, all HIGHEST."""
    X, Y, _, (ls, s2, noise) = ranks.problem()
    mesh = jax_dist.make_n_mesh(S)
    pl = jax_dist.plan(ranks.N, S, ranks.B)
    eng = jax_cd.DeferredEngine(pl, mesh, super_block=q * S * ranks.B, chol_precision=None,
                                grad_precision=lax.Precision.HIGHEST)
    x = jax.device_put(jnp.asarray(jax_dist.to_stored(pl, X)), jax_dist._row_sharding(mesh))
    y = jnp.asarray(jax_dist.to_stored(pl, Y))
    U = eng.chol(eng.gram(x, ls, s2, noise))
    out = {'q': eng.q, 'factor': np.asarray(U), 'logdet': 2.0 * float(eng.logdiag(U))}
    alpha = eng.bwd(U, eng.fwd(U, y))
    out['alpha'] = jax_dist.from_stored(pl, np.asarray(alpha))
    V = eng.inv(U)
    out['inverse'] = np.asarray(V)
    _, inv = jax_cd.stored_global_perms(pl)
    grads = eng._grads(V, jnp.take(alpha, jnp.asarray(inv), axis=0), x, jnp.asarray(ls),
                       jnp.asarray(s2), jnp.asarray(noise))
    out['grads'] = np.concatenate([np.ravel(g) for g in grads])
    return out


def _arrays():
    """Float64 calibrator inputs of the problem's posterior, original order."""
    X, Y, _, (ls, s2, noise) = ranks.problem()
    K = np.asarray(jax_rbf_gram(jnp.asarray(X), jnp.asarray(X), jnp.asarray(ls),
                                jnp.asarray(s2))) + noise * np.eye(ranks.N)
    chol = np.linalg.cholesky(K)
    alpha = np.linalg.solve(K, Y)
    return dict(F=np.array([[s2]]), K_cho=chol[None], K_inv_Y=alpha.T.reshape(1, 1, ranks.N),
                Lambda=np.asarray(ls)[None, :], X=X)


def _sweeps_reference(S, arrays):
    """romcomma_tpu's error calibrator with its sweeps over make_n_mesh(S),
    host-paced as its DistributedGP.sobol_indices runs them."""
    cal = JaxClosedSobolWithError.from_arrays(
        **{k: jnp.asarray(v) for k, v in arrays.items()}, is_F_diagonal=True, L=1, M=ranks.M,
        N=ranks.N, n_chunk=ranks.N_CHUNK, is_T_partial=False)
    cal.gsa_mesh = jax_dist.make_n_mesh(S)
    return {key: np.asarray(value)
            for key, value in cal.marginalize_intervals(SLICES, host_paced=True).items()}


def _reference():
    """romcomma_tpu's, per S and engine, on make_n_mesh(S)."""
    X, Y, Xs, (ls, s2, noise) = ranks.problem()
    out = {}
    for S in SIZES:
        for engine in ranks.ENGINES:
            g = jax_dist.DistributedGP(ranks.N, jax_dist.make_n_mesh(S), block=ranks.B,
                                       dtype=np.float64, engine=engine)
            x, y = g.stage(X, Y)
            r = {'gram': np.asarray(g._gram(x, ls, s2, noise))}
            F = g._chol(g._gram(x, ls, s2, noise))
            r['factor'] = np.asarray(F)
            r['logdet'] = 2.0 * float(g._logdiag(F))
            r['alpha'] = jax_dist.from_stored(g.plan, np.asarray(g._bwd(F, g._fwd(F, y))))
            if engine == 'cyclic2':
                r['inverse'] = np.asarray(g._inv(F))
            value, grads = jax.value_and_grad(
                lambda *p: g.lml(*p, x, y), argnums=(0, 1, 2))(
                jnp.asarray(ls), jnp.asarray(s2), jnp.asarray(noise))
            r['lml'] = float(value)
            r['grad'] = np.concatenate([np.ravel(v) for v in grads])
            alpha, _ = g.posterior_alpha(ls, s2, noise, x, y)
            r['posterior'] = jax_dist.from_stored(g.plan, np.asarray(alpha))
            r['mean'], r['var'] = (np.asarray(v) for v in g.predict(ls, s2, noise, x, y, Xs))
            r['sobol'] = g.sobol_indices(ls, s2, noise, x, y, X, kind=ranks.KINDS, error=True,
                                         is_T_partial=False, n_chunk=ranks.N_CHUNK)
            out[S, engine] = r
    return out


CASES = [(S, engine) for S in SIZES for engine in ranks.ENGINES]
IDS = [f'S{S}-{engine}' for S, engine in CASES]


@pytest.mark.parametrize('S, engine', CASES, ids=IDS)
def test_gram_factor_and_solves_match_romcomma_tpu(port, reference, S, engine):
    mine, theirs = port[S][0][engine], reference[S, engine]
    np.testing.assert_allclose(mine['gram'], theirs['gram'], rtol=0, atol=GRAM_ATOL)
    np.testing.assert_allclose(mine['factor'], theirs['factor'], rtol=0, atol=FACTOR_ATOL)
    assert abs(mine['logdet'] - theirs['logdet']) <= LOGDET_ATOL
    np.testing.assert_allclose(mine['alpha'], theirs['alpha'], rtol=0, atol=ALPHA_ATOL)
    if engine == 'cyclic2':
        np.testing.assert_allclose(mine['inverse'], theirs['inverse'], rtol=0, atol=INVERSE_ATOL)


@pytest.mark.parametrize('S, engine', CASES, ids=IDS)
def test_lml_and_gradient_match_romcomma_tpu(port, reference, S, engine):
    mine, theirs = port[S][0][engine], reference[S, engine]
    np.testing.assert_allclose(mine['lml'], theirs['lml'], rtol=LML_RTOL)
    np.testing.assert_allclose(mine['grad'], theirs['grad'], **GRAD)


@pytest.mark.parametrize('S, engine', CASES, ids=IDS)
def test_posterior_and_predictions_match_romcomma_tpu(port, reference, S, engine):
    mine, theirs = port[S][0][engine], reference[S, engine]
    np.testing.assert_allclose(mine['posterior'], theirs['posterior'], rtol=0, atol=ALPHA_ATOL)
    for key in ('mean', 'var'):
        np.testing.assert_allclose(mine[key], theirs[key], rtol=0, atol=ALPHA_ATOL)


@pytest.mark.parametrize('S, engine', CASES, ids=IDS)
def test_mesh_indices_match_romcomma_tpu(port, reference, S, engine):
    """S of both kinds at S_ATOL, T squared at test_torch_slice.py's
    tolerance, through the mesh's V pass and W/T sweep on both sides."""
    mine, theirs = port[S][0][engine]['sobol'], reference[S, engine]['sobol']
    for kind in ranks.KINDS:
        m = range(ranks.M)
        np.testing.assert_allclose([mine['S'][kind][i] for i in m],
                                   [theirs['S'][kind][i] for i in m], rtol=0, atol=S_ATOL)
        got = np.array([mine['T'][kind][i] for i in m]) ** 2
        want = np.array([theirs['T'][kind][i] for i in m]) ** 2
        assert np.all(np.abs(got - want) <= T2_RTOL * want + T2_ROW_FLOOR * want.max()), \
            (kind, got, want)


@pytest.mark.parametrize('S, engine', CASES, ids=IDS)
def test_float32_engines_keep_their_dtype_on_several_ranks(port, S, engine):
    """Over S > 1 ranks a float32 engine computes as romcomma_tpu's does, in
    float32 throughout: its LML is float32, and its LML and gradient are the
    bits of the engine's own float32 gram, factor, solves and reductions
    (one device factorizes in float64: test_torch_cyclic_deferred.py)."""
    dtype, through, steps = port[S][0][engine]['float32']
    assert dtype == 'torch.float32'
    for got, want in zip(through, steps):
        assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize('S', SIZES)
def test_every_rank_returns_the_same_bits(port, S):
    """LML, gradient, posterior, predictions, indices and a short calibrate
    (every point it evaluated, its optimum, LML and iterations) are bitwise
    equal on every rank."""
    first = port[S][0]
    for other in port[S][1:]:
        for engine in ranks.ENGINES:
            a, b = first[engine], other[engine]
            for key in ('lml', 'grad', 'posterior', 'mean', 'var', 'logdet'):
                assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), (engine, key)
            assert a['sobol'] == b['sobol'], engine
            seen_a, opt_a, lml_a, it_a = a['calibrate']
            seen_b, opt_b, lml_b, it_b = b['calibrate']
            assert seen_a == seen_b and lml_a == lml_b and it_a == it_b, engine
            assert all(np.array_equal(x, y) for x, y in zip(opt_a, opt_b)), engine
    assert len(first['cyclic']['calibrate'][0]) > 3


@pytest.mark.parametrize('S', SIZES)
def test_deferred_engine_matches_romcomma_tpu(runs, S):
    """Factor, log-det, alpha through the stored-order solves, the in-place
    inverse and the half-ring pair-tile gradient, with several super panels."""
    mine, theirs = runs[0][S][0]['deferred'], runs[1][S]['deferred']
    assert mine['q'] == theirs['q'] == PANEL_BLOCKS[S]
    np.testing.assert_allclose(mine['factor'], theirs['factor'], rtol=0, atol=FACTOR_ATOL)
    assert abs(mine['logdet'] - theirs['logdet']) <= LOGDET_ATOL
    np.testing.assert_allclose(mine['alpha'], theirs['alpha'], rtol=0, atol=ALPHA_ATOL)
    np.testing.assert_allclose(mine['inverse'], theirs['inverse'], rtol=0, atol=INVERSE_ATOL)
    np.testing.assert_allclose(mine['grads'], theirs['grads'], **GRAD)
    for other in runs[0][S][1:]:
        np.testing.assert_array_equal(other['deferred']['grads'], mine['grads'])


@pytest.mark.parametrize('S', SIZES)
def test_mesh_sweeps_match_romcomma_tpu(runs, S):
    """The error calibrator's V pass and W/T sweep with their chunks over the
    mesh: V and S at V_ATOL, T squared at test_torch_slice.py's tolerance;
    every rank's bits equal."""
    mine, theirs = [r['sweeps'] for r in runs[0][S]], runs[1][S]['sweeps']
    for key in ('V', 'S'):
        np.testing.assert_allclose(mine[0][key], theirs[key], rtol=0, atol=V_ATOL)
    got, want = mine[0]['T'] ** 2, theirs['T'] ** 2
    assert np.all(np.abs(got - want) <= T2_RTOL * want + T2_ROW_FLOOR * want.max()), (got, want)
    for other in mine[1:]:
        for key in mine[0]:
            np.testing.assert_array_equal(other[key], mine[0][key])
