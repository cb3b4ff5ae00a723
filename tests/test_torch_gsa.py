"""The port's GSA against romcomma_tpu's, in float64 on the CPU: the Gaussian
algebra, the calibrators' V/S (ClosedSobol) and W/T/Q/psi_factor
(ClosedSobolWithError) from one posterior given to both packages'
``from_arrays``, and the pinned Sobol' constants through the port's model
layer. Tolerances are the JAX suite's own (tests/test_gsa_chunked.py)."""

import functools

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from romcomma_tpu.gsa import base as jax_base
from romcomma_tpu.gsa import calibrators as jax_calibrators
from romcomma_tpu.models import gp as jax_gp
from romcomma_tpu.models.params import variant_constrain, variant_init
from romcomma_tpu_torch.base.definitions import pinned_device
from romcomma_tpu_torch.gsa import base, calibrators
from test_reference_fixture import SOBOL_S, SOBOL_V


@pytest.fixture(scope='module', autouse=True)
def _on_the_cpu():
    """The port computes on the CPU here because the tests ask for it: it
    raises where there is no CUDA device and nothing was asked for."""
    with pinned_device(torch.device('cpu')):
        yield


torch.set_num_threads(1)

N, M = 60, 4
#: Every slice any GSA kind produces: single dims, proper and full prefixes,
#: suffixes, and the empty suffix (M, M).
SLICES = tuple([(m, m + 1) for m in range(M)] + [(0, m + 1) for m in range(M)]
               + [(m + 1, M) for m in range(M)])
#: V, S and W: the JAX suite's rtol 1e-9, atol 1e-11. T = sqrt(|Q| / V4)
#: where Q cancels to ~0 on exactly-zero entries: its floor is sqrt(eps *
#: scale), so atol 1e-7.
TOL = {'V': (1e-9, 1e-11), 'S': (1e-9, 1e-11), 'W': (1e-9, 1e-11), 'T': (1e-9, 1e-7),
       'Q': (1e-9, 1e-11), 'psi_factor': (1e-9, 1e-11)}


#: Lengthscales and noise of an ill-conditioned posterior, shaped like the
#: installation test's trained ones (long lengthscales on weak inputs, noise
#: near the data's): cond(K) = 2.4e5 at N=60.
STIFF = ((0.8, 2.0, 5.0, 10.0), 1e-4)


@functools.lru_cache(maxsize=None)
def _posterior(L: int, stiff: bool = False):
    """F, K_cho, K_inv_Y, Lambda, X of a seeded posterior, as numpy arrays
    (the construction of tests/test_gsa_chunked.py; ``stiff`` takes the
    lengthscales and noise of STIFF)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, M))
    y = np.stack([np.sin(x[:, 0]) + x[:, 1], x[:, 2] ** 2], axis=-1)[:, :L]
    y = y + 0.05 * rng.standard_normal((N, L))
    lengthscales, noise = (np.tile(STIFF[0], (L, 1)), STIFF[1]) if stiff else (1.2, 0.05)
    raw = variant_init(np.full(L, 1.0), np.broadcast_to(lengthscales, (L, M)),
                       np.full(L, noise))
    K_cho, K_inv_Y = jax_gp.posterior_factors_variant(raw, jnp.asarray(x), jnp.asarray(y))
    c = variant_constrain(raw)
    return {'F': np.asarray(c['variance'])[None, :], 'K_cho': np.asarray(K_cho),
            'K_inv_Y': np.asarray(K_inv_Y), 'Lambda': np.asarray(c['lengthscales']), 'X': x}


def _pair(cls_name: str, L: int, **meta):
    """(romcomma_tpu calibrator, port calibrator) from the same arrays."""
    arrays = _posterior(L)
    dims = {'is_F_diagonal': True, 'L': L, 'M': M, 'N': N}
    jax_cal = getattr(jax_calibrators, cls_name).from_arrays(
        **{k: jnp.asarray(v) for k, v in arrays.items()}, **dims, **meta)
    return jax_cal, getattr(calibrators, cls_name).from_arrays(**arrays, **dims, **meta)


def _close(key, got, want, message=''):
    rtol, atol = TOL[key]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=f'{key} {message}')


@pytest.mark.parametrize('n_chunk', [None, 16], ids=['one-chunk', 'chunks-of-16'])
@pytest.mark.parametrize('L', [1, 2])
def test_v_and_s_match(L, n_chunk):
    """ClosedSobol: V and S of the full interval, of every canonical slice
    through the factorized pass, and of a general slice through the padded
    per-slice path; n_chunk=16 runs the chunk loops four times."""
    meta = {} if n_chunk is None else {'n_chunk': n_chunk}
    jax_cal, cal = _pair('ClosedSobol', L, **meta)
    _close('V', cal.V[0], jax_cal.V[0])
    _close('S', cal.S, jax_cal.S)
    slices = SLICES + ((1, 3),)
    got, want = cal.marginalize_intervals(slices), jax_cal.marginalize_intervals(slices)
    for key in ('V', 'S'):
        for i, s in enumerate(slices):
            _close(key, got[key][..., i], want[key][..., i], f'slice {s}')


@pytest.mark.parametrize('n_chunk', [None, 16], ids=['one-chunk', 'chunks-of-16'])
@pytest.mark.parametrize('is_T_partial', [True, False], ids=['T-partial', 'T-full'])
@pytest.mark.parametrize('L', [1, 2])
def test_w_and_t_match(L, is_T_partial, n_chunk):
    """ClosedSobolWithError: V, S, W and T of every canonical slice, at L=1,
    where every member's plane is the same, and at L=2; all three kinds'
    slices run the forward and the reverse sweep."""
    meta = {'is_T_partial': is_T_partial} | ({} if n_chunk is None else {'n_chunk': n_chunk})
    jax_cal, cal = _pair('ClosedSobolWithError', L, **meta)
    got, want = cal.marginalize_intervals(SLICES), jax_cal.marginalize_intervals(SLICES)
    for key in ('V', 'S', 'W', 'T'):
        for i, s in enumerate(SLICES):
            _close(key, got[key][..., i], want[key][..., i], f'slice {s}')
    assert set(cal.last_interval_timings) >= {'v_pass_s', 'wt_sweep_s', 'v_chunks',
                                              'e_prep_s', 'e_loop_s', 'e_solve_s', 'e_chunks'}


@pytest.mark.parametrize('is_T_partial', [True, False], ids=['T-partial', 'T-full'])
@pytest.mark.parametrize('L', [1, 2])
def test_full_interval_errors_match(L, is_T_partial):
    """psi_factor, W, and in non-partial mode Q and T, of the full interval,
    from the lazy prefix-last sweep of a fresh calibrator."""
    jax_cal, cal = _pair('ClosedSobolWithError', L, is_T_partial=is_T_partial)
    _close('psi_factor', cal.psi_factor, jax_cal.psi_factor)
    if is_T_partial:
        _close('W', cal.W, jax_cal.W)
    else:
        for family in ('DIAGONAL', 'MIXED'):
            _close('W', getattr(cal.W, family), getattr(jax_cal.W, family), family)
        _close('Q', cal.Q, jax_cal.Q)
        _close('T', cal.T, jax_cal.T)


def test_ill_conditioned_posterior_agrees_within_its_rounding_spread():
    """At cond(K) = 2.4e5 (STIFF), W = mu_phi_mu - mu_psi_mu is a difference
    of quadforms grown by cond(K), and T is the square root of one more: the
    port's own W moves by ~1e-7 of its largest entry when K^-1 y moves by
    one ulp. So W and T^2 (the linear quantity under T's square root) are
    held to ten times that spread (the largest over three random draws),
    relative to each table's largest entry; S and V, which do not cancel
    so, to 1e-9 of theirs."""
    L = 2
    arrays = _posterior(L, stiff=True)
    dims = {'is_F_diagonal': True, 'L': L, 'M': M, 'N': N, 'is_T_partial': False}

    def port_of(a):
        return calibrators.ClosedSobolWithError.from_arrays(**a, **dims).marginalize_intervals(
            SLICES)

    port = port_of(arrays)
    nudged = [port_of(dict(arrays, K_inv_Y=arrays['K_inv_Y'] * (1 + 2.0 ** -52 * np.random
              .default_rng(seed).choice([-1.0, 1.0], arrays['K_inv_Y'].shape))))
              for seed in (1, 2, 3)]
    want = jax_calibrators.ClosedSobolWithError.from_arrays(
        **{k: jnp.asarray(v) for k, v in arrays.items()}, **dims).marginalize_intervals(SLICES)

    def spread(got, reference, key):
        got, reference = np.asarray(got), np.asarray(reference)
        if key == 'T':
            got, reference = got * got, reference * reference
        return np.abs(got - reference).max() / np.abs(reference).max()

    for key in 'SVWT':
        ulp = max(spread(n[key].numpy(), port[key].numpy(), key) for n in nudged)
        apart = spread(port[key].numpy(), want[key], key)
        print(f'{key}: port against romcomma_tpu {apart:.2e}, one-ulp spread {ulp:.2e}')
        assert apart <= (1e-9 if key in 'SV' else 10 * ulp), (key, apart, ulp)


def test_debug_reductions_match():
    jax_cal, cal = _pair('ClosedSobol', 2, debug=True)
    for key, value in cal.debug.items():
        np.testing.assert_allclose(value.numpy(), np.asarray(jax_cal.debug[key]),
                                   rtol=1e-9, atol=1e-14, err_msg=key)


def _gaussians(mean, variance, diagonal, **kwargs):
    return (base.Gaussian(torch.tensor(mean), torch.tensor(variance), diagonal, **kwargs),
            jax_base.Gaussian(jnp.asarray(mean), jnp.asarray(variance), diagonal, **kwargs))


def _same_gaussian(port, jax_gaussian):
    for field in ('exponent', 'cho_diag', 'pdf', 'det'):
        want = np.asarray(getattr(jax_gaussian, field))
        got = getattr(port, field).numpy()
        assert got.shape == want.shape, (field, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300, err_msg=field)


def test_gaussian_equal_shape_rule():
    """ordinate and mean of one shape expand into each other's batch dims:
    an outer product over the leading axes."""
    rng = np.random.default_rng(1)
    mean, ordinate = rng.normal(size=(3, 5, 4)), rng.normal(size=(3, 5, 4))
    variance = rng.uniform(0.5, 2.0, size=(4,))
    port, jax_gaussian = _gaussians(mean, variance, True, ordinate=ordinate)
    assert tuple(port.exponent.shape) == (3, 5, 3, 5)
    _same_gaussian(port, jax_gaussian)
    port = base.Gaussian(torch.tensor(mean), torch.tensor(variance), True,
                         ordinate=torch.tensor(ordinate))
    want = np.exp(-0.5 * np.sum((ordinate[:, :, None, None, :] - mean[None, None]) ** 2
                                / variance, axis=-1)) / np.prod(np.sqrt(variance))
    np.testing.assert_allclose(port.pdf.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize('LBunch', [1, 2, 3])
def test_gaussian_lbunch_rule(LBunch):
    """variance_cho gains a broadcast axis every LBunch output dims, as the
    calibrators' (l, L, N, M) layouts need."""
    rng = np.random.default_rng(2)
    mean = rng.normal(size=(1, 1, 6, 3))
    variance = rng.uniform(0.5, 2.0, size=(2, 1, 3))
    port, jax_gaussian = _gaussians(mean, variance, True, LBunch=LBunch)
    _same_gaussian(port, jax_gaussian)


def test_gaussian_full_variance_ratio_and_expand_dims():
    """A non-diagonal variance goes through its Cholesky factor; ratios and
    inserted axes follow the JAX package."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(2, 3, 3))
    variance = A @ np.swapaxes(A, -1, -2) + 3 * np.eye(3)
    mean = rng.normal(size=(2, 5, 3))
    port, jax_gaussian = _gaussians(mean, variance, False, LBunch=1)
    _same_gaussian(port, jax_gaussian)
    other, jax_other = _gaussians(mean, rng.uniform(1.0, 2.0, size=(2, 1, 3)), True, LBunch=1)
    _same_gaussian((port / other).expand_dims([-1, 1]),
                   (jax_gaussian / jax_other).expand_dims([-1, 1]))


def test_general_slice_with_errors_raises():
    """A general slice, which raised while the per-slice error path was not
    ported, now returns: its V, S, W and T through per-slice evaluation,
    romcomma_tpu's, beside a canonical slice, as romcomma_tpu's
    marginalize_intervals does."""
    slices = ((1, 3), (0, 2))
    jax_cal, cal = _pair('ClosedSobolWithError', 1)
    got, want = cal.marginalize_intervals(slices), jax_cal.marginalize_intervals(slices)
    for key in ('V', 'S', 'W', 'T'):
        for i, s in enumerate(slices):
            np.testing.assert_allclose(got[key][..., i].numpy(), np.asarray(want[key][..., i]),
                                       rtol=PER_SLICE_RTOL, atol=TOL[key][1],
                                       err_msg=f'{key} slice {s}')


#: The per-slice path against romcomma_tpu's: 1e-10 relative, with the floors
#: of TOL (T's where Q cancels).
PER_SLICE_RTOL = 1e-10


@pytest.mark.parametrize('is_T_partial', [True, False], ids=['T-partial', 'T-full'])
@pytest.mark.parametrize('L', [1, 2])
def test_per_slice_errors_match(L, is_T_partial):
    """ClosedSobolWithError.marginalize, slice by slice, against romcomma_tpu's
    on tests/test_gsa_chunked.py::_error_calibrator's problem: a single dim,
    a general slice and the full interval."""
    jax_cal, cal = _pair('ClosedSobolWithError', L, is_T_partial=is_T_partial)
    for s in ((2, 3), (1, 3), (0, M)):
        got, want = cal.marginalize(s), jax_cal.marginalize(s)
        for key in ('V', 'S', 'W', 'T'):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       rtol=PER_SLICE_RTOL, atol=TOL[key][1],
                                       err_msg=f'{key} slice {s}')


@pytest.mark.parametrize('is_T_partial', [True, False], ids=['T-partial', 'T-full'])
@pytest.mark.parametrize('L', [1, 2])
def test_factorized_sweep_matches_the_per_slice_path(L, is_T_partial):
    """The port's factorized W/T sweep against its own per-slice path, every
    canonical slice, at tests/test_gsa_chunked.py::
    test_error_intervals_match_per_slice's tolerances: the oracle the card
    holds its sweep to without JAX."""
    _, cal = _pair('ClosedSobolWithError', L, is_T_partial=is_T_partial)
    got = cal.marginalize_intervals(SLICES)
    for i, s in enumerate(SLICES):
        want = cal.marginalize(s)
        for key in ('V', 'S', 'W', 'T'):
            atol = 1e-7 if key == 'T' else 1e-11
            np.testing.assert_allclose(got[key][..., i].numpy(), want[key].numpy(), rtol=1e-9,
                                       atol=atol, err_msg=f'{key} {s} partial={is_T_partial}')


def test_errors_refuse_a_non_diagonal_signal_variance():
    """Standard errors need a diagonal F, as in the reference."""
    arrays = dict(_posterior(2), F=np.array([[1.0, 0.2], [0.2, 1.0]]))
    with pytest.raises(NotImplementedError, match='not diagonal'):
        calibrators.ClosedSobolWithError.from_arrays(**arrays, is_F_diagonal=False, L=2, M=M,
                                                     N=N)


@pytest.mark.parametrize('key', calibrators.TPU_ONLY_META)
def test_tpu_meta_is_refused(key):
    """A meta key of the JAX package's TPU tiers or routes raises, naming it."""
    with pytest.raises(ValueError, match=key):
        calibrators.ClosedSobolWithError.from_arrays(
            **_posterior(1), is_F_diagonal=True, L=1, M=M, N=N, **{key: True})


def test_pinned_sobol(tmp_path):
    """The pinned first-order Sobol' S and V of tests/test_reference_fixture.py,
    through the port's own repository, MOGP and Sobol."""
    from romcomma_tpu_torch.data.storage import Fold, Repository
    from romcomma_tpu_torch.gsa.models import GSA, Sobol
    from romcomma_tpu_torch.models.gpr import MOGP

    data = np.linspace(1, 50, 50).reshape(5, 10).T
    cols = pd.MultiIndex.from_tuples([('X', f'x{i}') for i in range(3)]
                                     + [('Y', f'y{i}') for i in range(2)])
    repo = Repository.from_df(tmp_path / 'repo', pd.DataFrame(data, columns=cols))
    repo.into_K_folds(1)
    mogp = MOGP('fix.v.a', Fold(repo, 0), False, False, False,
                kernel_parameters={'variance': 0.5 * np.ones((1, 2)),
                                   'lengthscales': np.array([[0.01] * 3, [0.03] * 3])},
                likelihood_variance=1e-4 * np.ones((1, 2)))
    sobol = Sobol(mogp, GSA.Kind.FIRST_ORDER, -1, False)
    by_kind, extras = calibrators.marginalize_all_kinds(
        mogp, {sobol.kind.name: tuple(sobol._m_dataset)}, False, **sobol.meta)
    np.testing.assert_allclose(by_kind['FIRST_ORDER']['S'].numpy(), SOBOL_S, rtol=1e-8)
    np.testing.assert_allclose(by_kind['FIRST_ORDER']['V'].numpy(), SOBOL_V, rtol=1e-6)
    np.testing.assert_array_equal(calibrators.ClosedSobol(mogp).S.numpy(), extras['S'].numpy())
    sobol.calibrate()                     # the model's own pass, written to S.csv
    written = pd.read_csv(sobol.folder / 'S.csv', index_col=[0, 1]).to_numpy()
    np.testing.assert_allclose(written[:, :3].reshape(SOBOL_S.shape), SOBOL_S, atol=5e-7)


@pytest.mark.parametrize('is_error_calculated', [False, True])
def test_sobol_calibrator_is_romcomma_tpus(tmp_path, is_error_calculated):
    """Sobol.calibrator on test_pinned_sobol's model: a fresh calibrator of
    romcomma_tpu's class for its flag (ClosedSobolWithError with errors,
    else ClosedSobol), whose marginalize_intervals over the kind's slices
    gives what Sobol.calibrate computes and writes."""
    from romcomma_tpu.data.storage import Fold as JaxFold, Repository as JaxRepository
    from romcomma_tpu.gsa.models import GSA as JaxGSA, Sobol as JaxSobol
    from romcomma_tpu.models.gpr import MOGP as JaxMOGP
    from romcomma_tpu_torch.data.storage import Fold, Repository
    from romcomma_tpu_torch.gsa.models import GSA, Sobol
    from romcomma_tpu_torch.models.gpr import MOGP

    data = np.linspace(1, 50, 50).reshape(5, 10).T
    cols = pd.MultiIndex.from_tuples([('X', f'x{i}') for i in range(3)]
                                     + [('Y', f'y{i}') for i in range(2)])

    def sobol_of(repository, fold, mogp, gsa, sobol, root):
        repo = repository.from_df(root, pd.DataFrame(data, columns=cols))
        repo.into_K_folds(1)
        model = mogp('fix.v.a', fold(repo, 0), False, False, False,
                     kernel_parameters={'variance': 0.5 * np.ones((1, 2)),
                                        'lengthscales': np.array([[0.01] * 3, [0.03] * 3])},
                     likelihood_variance=1e-4 * np.ones((1, 2)))
        return sobol(model, gsa.Kind.FIRST_ORDER, -1, is_error_calculated)

    theirs = sobol_of(JaxRepository, JaxFold, JaxMOGP, JaxGSA, JaxSobol, tmp_path / 'jax')
    mine = sobol_of(Repository, Fold, MOGP, GSA, Sobol, tmp_path / 'port')
    calibrator = mine.calibrator
    assert type(calibrator).__name__ == type(theirs.calibrator).__name__
    assert type(calibrator) is (calibrators.ClosedSobolWithError if is_error_calculated
                                else calibrators.ClosedSobol)
    slices = tuple(mine._m_dataset)
    got = calibrator.marginalize_intervals(slices)
    want, _ = calibrators.marginalize_all(mine.gp, slices, is_error_calculated, **mine.meta)
    for key in ('S', 'V') + (('T',) if is_error_calculated else ()):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-12, atol=1e-15)
    mine.calibrate()
    for key in ('S', 'T') if is_error_calculated else ('S',):
        written = pd.read_csv(mine.folder / f'{key}.csv', index_col=[0, 1]).to_numpy()
        np.testing.assert_allclose(written[:, :3].reshape(got[key].shape), got[key].numpy(),
                                   atol=5e-7)
