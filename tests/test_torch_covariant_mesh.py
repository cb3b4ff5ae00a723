"""The port's covariant mesh (parallel/covariant_mesh.py) against romcomma_tpu's,
on the CPU: over S = 2, 3 and 4 spawned gloo ranks, the covariant gram (rows
in stored order, columns global), the LML and its (F, noise_cov) gradient,
and a descent of 25 iterations, with F and the noise covariance non-diagonal
and several super panels with a clamped tail chunk (tests/test_torch_mesh.py's
PANEL_BLOCKS), each held to romcomma_tpu's DistributedCovariantGP on
make_n_mesh(S) of the conftest's 8 virtual devices and to its one-device
chain (covariant_upper_lml, calibrate_covariant_host) from the same seeded
inputs, at tests/test_covariant_mesh.py's tolerances; every rank's results
are bitwise equal. The rank bodies (torch_mesh_ranks.covariant) run in
tests/test_torch_mesh.py's spawns, one per S for the whole test run, and
romcomma_tpu's results are computed while they run (whichever of the two
files asks first: test_torch_mesh.mesh_suite_runs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks

from romcomma_tpu.models import gp as jax_gp
from romcomma_tpu.models.params import covariant_init, covariant_mask
from romcomma_tpu.ops.gram import rbf_gram_covariant
from romcomma_tpu.parallel import distributed as jax_dist
from romcomma_tpu.parallel.covariant_mesh import DistributedCovariantGP
from test_torch_mesh import PANEL_BLOCKS, SIZES, mesh_suite_runs

torch.set_num_threads(1)

#: tests/test_covariant_mesh.py's tolerances.
LML_RTOL, GRAD, GRAM, CALIBRATE_RTOL = 1e-9, dict(rtol=1e-7, atol=1e-9), \
    dict(rtol=1e-10, atol=1e-12), 1e-6
#: Blocks per rank of the plan at each S (L N = 75 rows, blocks of 8).
BLOCKS_PER_RANK = {2: 5, 3: 4, 4: 3}


def covariant_references():
    """romcomma_tpu's: per S, DistributedCovariantGP's stored-order gram,
    LML and gradient at PANEL_BLOCKS[S]; its one-device chain's LML and
    gradient, dense gram and 25-iteration descent."""
    X, Y, ls, F, noise_cov = ranks.covariant_problem()
    N, L = Y.shape
    at = (jnp.asarray(F), jnp.asarray(noise_cov))
    out = {}
    for S in SIZES:
        dgp = DistributedCovariantGP(N, L, jax_dist.make_n_mesh(S), block=ranks.COV_B,
                                     super_block=PANEL_BLOCKS[S] * S * ranks.COV_B)
        st = dgp.stage(X, Y, ls)
        value, grads = jax.value_and_grad(dgp.lml_fn(st), argnums=(0, 1))(*at)
        out[S] = {'gram': np.asarray(dgp._gram(st.u, st.O, st.ns, *at)), 'lml': float(value),
                  'grad': [np.asarray(g) for g in grads], 'perm': np.asarray(dgp.plan.perm)}
    oracle = jax_gp.covariant_upper_lml(jnp.asarray(X), jnp.asarray(ls), jnp.asarray(Y),
                                        block=16)
    value, grads = jax.value_and_grad(oracle, argnums=(0, 1))(*at)
    out['upper'] = {'lml': float(value), 'grad': [np.asarray(g) for g in grads]}
    dense = np.array(rbf_gram_covariant(jnp.asarray(X), jnp.asarray(X), jnp.asarray(ls),
                                        jnp.asarray(F))).reshape(L * N, L * N)
    out['dense'] = dense + np.kron(noise_cov, np.eye(N))
    _, lml, _ = jax_gp.calibrate_covariant_host(
        covariant_init(F, ls, noise_cov), covariant_mask(kernel_covariance=True), jnp.asarray(X),
        jnp.asarray(Y), maxiter=ranks.COV_MAXITER, ls_frozen=True)
    out['calibrate'] = float(lml)
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """({S: [rank 0's covariant results, rank 1's, ...]}, romcomma_tpu's),
    from test_torch_mesh.mesh_suite_runs."""
    port, _, theirs = mesh_suite_runs(tmp_path_factory)
    return {S: [r['covariant'] for r in results] for S, results in port.items()}, theirs


@pytest.mark.parametrize('S', SIZES)
def test_gram_matches_romcomma_tpu(runs, S):
    """The stored-order gram against romcomma_tpu's mesh gram; its real rows,
    in global order, against the dense covariant gram; padding rows zero off
    a unit diagonal and padding columns zero."""
    mine, theirs = runs[0][S][0], runs[1][S]
    assert (mine['q'], mine['c']) == (PANEL_BLOCKS[S], BLOCKS_PER_RANK[S])
    np.testing.assert_allclose(mine['gram'], theirs['gram'], **GRAM)
    perm, LN = theirs['perm'], ranks.COV_L * ranks.COV_N
    real = perm < LN
    in_global = np.empty((LN, len(perm)))
    in_global[perm[real]] = mine['gram'][real]
    np.testing.assert_allclose(in_global[:, :LN], runs[1]['dense'], **GRAM)
    assert not in_global[:, LN:].any()
    padding = mine['gram'][~real]
    assert np.array_equal(padding, np.eye(len(perm))[perm[~real]])


@pytest.mark.parametrize('S', SIZES)
def test_lml_and_grads_match_romcomma_tpu(runs, S):
    """LML, dF and dnoise against romcomma_tpu's mesh chain and its
    one-device chain (covariant_upper_lml); the LML without a gradient (no
    inverse) is the same bits."""
    mine = runs[0][S][0]
    for theirs in (runs[1][S], runs[1]['upper']):
        np.testing.assert_allclose(mine['lml'], theirs['lml'], rtol=LML_RTOL)
        for got, want in zip(mine['grad'], theirs['grad']):
            np.testing.assert_allclose(got, want, **GRAD)
    assert mine['lml, no gradient'] == mine['lml']
    assert np.abs(mine['grad'][0] - np.diag(np.diag(mine['grad'][0]))).max() > 1e-3


@pytest.mark.parametrize('S', SIZES)
def test_calibrate_matches_calibrate_covariant_host(runs, S):
    """A descent of 25 iterations with the lengthscales frozen and F's
    off-diagonals trained reaches the one-device host calibrator's LML."""
    _, _, lml, iterations, _ = runs[0][S][0]['calibrate']
    assert iterations > 5
    np.testing.assert_allclose(lml, runs[1]['calibrate'], rtol=CALIBRATE_RTOL)


@pytest.mark.parametrize('S', SIZES)
def test_every_rank_returns_the_same_bits(runs, S):
    """LML, gradient and the descent (every point it evaluated, its optimum,
    LML, iterations and stop) are bitwise equal on every rank."""
    first = runs[0][S][0]
    for other in runs[0][S][1:]:
        assert other['lml'] == first['lml']
        assert all(np.array_equal(a, b) for a, b in zip(other['grad'], first['grad']))
        seen_a, raw_a, *rest_a = first['calibrate']
        seen_b, raw_b, *rest_b = other['calibrate']
        assert seen_a == seen_b and rest_a == rest_b
        assert all(np.array_equal(raw_a[k], raw_b[k]) for k in raw_a)
    assert len(first['calibrate'][0]) > 5
