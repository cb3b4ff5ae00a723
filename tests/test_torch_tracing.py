"""``base.tracing``: the spans of the port's own layers. On the CPU: what the
three modes record, how spans nest and flag an exception, and the stages
each instrumented layer records (the batched ExactLML, MeshLML on
'cyclic2', the lockstep's gather, the GSA's V pass and W/T sweep, which
makes no synchronize). On a card (marked ``cuda``): the stages' device
times cover a value and gradient. Needs no JAX; on a machine with a card:

    python -m pytest tests/test_torch_tracing.py -q --noconftest -o addopts='' -p no:randomly
"""

import threading
import time

import numpy as np
import pytest
import torch

from romcomma_tpu_torch.base import tracing
from romcomma_tpu_torch.base.definitions import pinned_device
from romcomma_tpu_torch.gsa import calibrators, factorized_errors
from romcomma_tpu_torch.models.gp import ExactLML
from romcomma_tpu_torch.ops import lbfgs
from romcomma_tpu_torch.parallel.distributed import DistributedGP

MESH_STAGES = ['mesh_lml.gram', 'mesh_lml.factor', 'mesh_lml.solves', 'mesh_lml.inverse',
               'mesh_lml.pairs']
EXACT_STAGES = ['exact_lml.gram', 'exact_lml.factor', 'exact_lml.backward']
#: The stages' device times against the host time of the call they make up.
COVERAGE = 0.10


def _recording(m: str):
    """A fixture body: tracing in mode ``m`` with no span kept, restored."""
    previous = tracing.mode(m)
    tracing.reset()
    try:
        yield
    finally:
        tracing.mode(previous)
        tracing.reset()


@pytest.fixture
def on():
    """Every span recorded, the port on the CPU."""
    with pinned_device(torch.device('cpu')):
        yield from _recording('on')


@pytest.fixture
def auto():
    yield from _recording('auto')


def _names():
    return [s['name'] for s in tracing.spans()]


def test_off_records_nothing_and_opens_no_record_function():
    previous = tracing.mode('off')
    tracing.reset()
    try:
        with torch.profiler.profile() as prof:
            with tracing.span('test.off', members=3) as record:
                torch.ones(3).add_(1)
        assert record is None and tracing.spans() == []
        assert 'test.off' not in {e.name for e in prof.events()}
    finally:
        tracing.mode(previous)


def test_auto_records_under_the_profiler_alone(auto):
    with tracing.span('test.outside'):
        torch.ones(3).add_(1)
    with torch.profiler.profile() as prof:
        with tracing.span('test.inside', members=2):
            torch.ones(3).add_(1)
    (span,) = tracing.spans()
    assert span['name'] == 'test.inside' and span['attrs'] == {'members': 2}
    assert span['host_ms'] >= 0 and span['device_ms'] is None and not span['error']
    assert 'test.inside' in {e.name for e in prof.events()}


def test_parents_nest_and_an_exception_sets_error(on):
    with pytest.raises(ZeroDivisionError):
        with tracing.span('outer'):
            with tracing.span('inner.fine'):
                pass
            with tracing.span('inner.failing'):
                1 / 0
    fine, failing, outer = tracing.spans()
    assert [fine['name'], failing['name'], outer['name']] == ['inner.fine', 'inner.failing',
                                                              'outer']
    assert outer['parent'] is None and fine['parent'] == failing['parent'] == outer['id']
    assert [fine['error'], failing['error'], outer['error']] == [False, True, True]
    assert outer['start_ns'] <= fine['start_ns'] <= fine['end_ns'] <= failing['start_ns']
    assert failing['end_ns'] <= outer['end_ns']
    assert len({s['thread'] for s in (fine, failing, outer)}) == 1
    with tracing.span('after'):
        pass
    assert tracing.spans()[-1]['parent'] is None


def _batched_problem(B, N, M, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, N, M, generator=g, dtype=torch.float64)
    y = torch.sin(x[..., 0]) + 0.1 * torch.randn(B, N, generator=g, dtype=torch.float64)
    leaves = (torch.full((B, M), 1.5, dtype=torch.float64), torch.ones(B, dtype=torch.float64),
              torch.full((B,), 0.05, dtype=torch.float64))
    return ([leaf.to(device, dtype).requires_grad_(True) for leaf in leaves],
            x.to(device, dtype), y.to(device, dtype))


def _exact_value_and_grad(leaves, x, y):
    torch.autograd.grad(ExactLML.apply(*leaves, x, y).sum(), leaves)


def test_batched_exact_lml_records_its_three_stages(on):
    leaves, x, y = _batched_problem(3, 20, 2, torch.float64, torch.device('cpu'))
    _exact_value_and_grad(leaves, x, y)
    stages = {s['name']: s for s in tracing.spans()}
    assert sorted(_names()) == sorted(EXACT_STAGES)
    assert stages['exact_lml.gram']['attrs'] == {}
    assert stages['exact_lml.factor']['attrs'] == stages['exact_lml.backward']['attrs'] == {
        'members': 3}


COVARIANT_STAGES = ['covariant_lml.unit', 'covariant_lml.assemble', 'covariant_lml.factor',
                    'covariant_lml.solves', 'covariant_lml.inverse', 'covariant_lml.grads']


@pytest.mark.parametrize('m', ['auto', 'off'])
def test_covariant_upper_lml_records_its_six_stages_in_auto_mode(m):
    """Under a profiler the covariant value and gradient records its six
    stages in order in 'auto' mode, and none in 'off'."""
    from romcomma_tpu_torch.models.gp import covariant_upper_lml
    rng = np.random.default_rng(3)
    x, y = torch.tensor(rng.normal(size=(20, 2))), torch.tensor(rng.normal(size=(20, 2)))
    F = torch.tensor([[1.0, 0.2], [0.2, 0.8]], requires_grad=True)
    noise = torch.tensor([[0.05, 0.01], [0.01, 0.04]], requires_grad=True)
    previous = tracing.mode(m)
    tracing.reset()
    try:
        with pinned_device(torch.device('cpu')), torch.profiler.profile():
            lml = covariant_upper_lml(x, torch.ones((2, 2), dtype=torch.float64), y)
            torch.autograd.grad(lml(F, noise), (F, noise))
        assert _names() == (COVARIANT_STAGES if m == 'auto' else [])
    finally:
        tracing.mode(previous)
        tracing.reset()


def _cyclic2(N, device, dtype, seed=0):
    """A 'cyclic2' DistributedGP on ``device`` with N staged rows, and its
    value and gradient at one point."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, 4 if N < 1000 else 30))
    Y = np.sin(X[:, :1]) + 0.1 * rng.normal(size=(N, 1))
    dgp = DistributedGP(N, device, block=16 if N < 1000 else 256, dtype=dtype, engine='cyclic2')
    x, y = dgp.stage(X, Y)

    def value_and_grad():
        leaves = [torch.as_tensor(v, dtype=x.dtype, device=device).requires_grad_(True)
                  for v in (np.full(X.shape[1], 1.5), 1.0, 0.05)]
        torch.autograd.grad(dgp.lml(*leaves, x, y), leaves)
    return value_and_grad


def test_cyclic2_mesh_lml_records_its_five_stages(on):
    _cyclic2(64, torch.device('cpu'), np.float64)()
    assert _names() == MESH_STAGES
    assert all(s['device_ms'] is None and s['host_ms'] >= 0 for s in tracing.spans())


@pytest.mark.parametrize('fails', ['objective', 'descent'])
def test_a_stopped_lockstep_leaves_its_gathers_closed(on, monkeypatch, fails):
    """The objective (the calling thread) or one descent's scipy (its own
    thread) raises at the third evaluation: every 'lbfgs.gather' span is
    closed, the one the descent's error ended is flagged, and no thread of
    the lockstep is left."""
    calls = []

    def objective(members, p):
        calls.append(list(members))
        if fails == 'objective' and len(calls) == 3:
            raise FloatingPointError('objective')
        return torch.sum((p['x'] - 1.0) ** 2, dim=-1)

    if fails == 'descent':
        minimize = lbfgs.sp_minimize

        def failing(f, x0, **kwargs):
            evaluations = []

            def g(x):
                evaluations.append(x)
                if len(evaluations) == 3 and x0[0] == 0.0:
                    raise FloatingPointError('descent')
                return f(x)
            return minimize(g, x0, **kwargs)
        monkeypatch.setattr(lbfgs, 'sp_minimize', failing)
    before = set(threading.enumerate())
    starts = [{'x': torch.full((2,), float(i), dtype=torch.float64)} for i in range(4)]
    with pytest.raises(FloatingPointError, match=fails):
        lbfgs.minimize_lockstep(objective, starts, maxiter=50)
    assert set(threading.enumerate()) <= before
    gathers = [s for s in tracing.spans() if s['name'] == 'lbfgs.gather']
    assert len(gathers) == len(calls) + (fails == 'descent')
    assert all(s['end_ns'] >= s['start_ns'] and s['parent'] is None for s in gathers)
    assert [s['error'] for s in gathers] == [False] * len(calls) + [True] * (fails == 'descent')
    with tracing.span('after'):
        pass
    assert tracing.spans()[-1]['parent'] is None


def _closed_sobol_with_error(N=40, M=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(N, M, generator=g, dtype=torch.float64)
    y = torch.sin(X[:, 0]) + X[:, 1] ** 2 / 2 + 0.1 * torch.randn(N, generator=g,
                                                                  dtype=torch.float64)
    ls, s2, noise = torch.full((M,), 1.5, dtype=torch.float64), 1.0, 0.05
    d = ((X[:, None, :] - X[None, :, :]) / ls) ** 2
    K = s2 * torch.exp(-0.5 * d.sum(-1)) + noise * torch.eye(N, dtype=torch.float64)
    chol = torch.linalg.cholesky(K)
    alpha = torch.cholesky_solve(y[:, None], chol)
    return calibrators.ClosedSobolWithError.from_arrays(
        F=np.asarray([[s2]]), K_cho=chol[None], K_inv_Y=alpha.T.reshape(1, 1, N),
        Lambda=ls[None, :].numpy(), X=X.numpy(), is_F_diagonal=True, L=1, M=M, N=N,
        is_T_partial=False)


def test_gsa_pass_records_its_two_stages_and_no_synchronize(on, monkeypatch):
    cal = _closed_sobol_with_error()
    synchronized = []
    monkeypatch.setattr(calibrators, '_synchronize', synchronized.append)
    M = cal.M
    slices = tuple([(m, m + 1) for m in range(M)] + [(0, m + 1) for m in range(M)]
                   + [(m + 1, M) for m in range(M)])
    out = cal.marginalize_intervals(slices)
    assert set(out) == {'V', 'S', 'W', 'T'} and bool(torch.isfinite(out['T']).all())
    assert _names() == ['gsa.v_pass', 'gsa.wt_sweep']
    assert synchronized == [] and not hasattr(factorized_errors, '_synchronize')


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: a span times the card with CUDA events')
    with pinned_device(torch.device('cuda')):
        yield from _recording('on')


def _covered(call, names) -> float:
    """The least distance, over three calls after two warm ones, between the
    sum of the stages' device ms and the call's host ms ended by a
    synchronize, over the host ms; each stage recorded once, its device time
    a number and not negative."""
    gaps = []
    for rep in range(5):
        tracing.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
        stages = tracing.spans()
        assert sorted(s['name'] for s in stages) == sorted(names)
        device_ms = [s['device_ms'] for s in stages]
        assert all(ms is not None and ms >= 0.0 for ms in device_ms), stages
        if rep >= 2:
            gaps.append(abs(sum(device_ms) - host_ms) / host_ms)
    return min(gaps)


@pytest.mark.cuda
def test_stage_device_times_cover_a_value_and_gradient_on_the_card(card):
    on = torch.device('cuda')
    assert _covered(_cyclic2(4096, on, np.float32), MESH_STAGES) <= COVERAGE
    leaves, x, y = _batched_problem(6, 2048, 30, torch.float32, on)
    assert _covered(lambda: _exact_value_and_grad(leaves, x, y), EXACT_STAGES) <= COVERAGE
