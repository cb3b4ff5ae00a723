"""The covariant cell (sweep_m19_cov.fit) and the fold-batched Sobol' cell
(csv_k20.gsa, whose files are here but whose entry BENCHMARK.json does not
hold: its pass spread too widely over runs): their plain references against a dense autograd computation,
one-dimensional quadrature and the port at small sizes on the CPU; their
files and readers; whole runs at tiny sizes on the CPU, sound and with each
fault planted; and, on a card (marked ``cuda``), the covariant driver at a
reduced L N."""

import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.problems import function_vector
from perfbench.reference import covariant_lml as ref_cov
from perfbench.reference import sobol_closed as ref_closed

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f'new_reader_{name.replace(".", "_")}',
                                                  HERE / 'metrics' / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def _cpu():
    from romcomma_tpu_torch.base.definitions import pinned_device
    torch.set_num_threads(2)
    with pinned_device(torch.device('cpu')):
        yield


# --------------------------------------------------------------------------- #
# The references
# --------------------------------------------------------------------------- #

def _covariant_problem(L=2, N=10, M=3, seed=4):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(N, M)))
    y = torch.tensor(rng.normal(size=(N, L)))
    ls = torch.tensor(rng.uniform(0.7, 2.0, (L, M)))
    point = {'raw_kernel_chol_diag': torch.tensor(rng.normal(size=L)),
             'kernel_chol_lower': torch.tensor(rng.normal(size=L * (L - 1) // 2)),
             'raw_noise_chol_diag': torch.tensor(rng.normal(size=L) - 3.0),
             'noise_chol_lower': torch.tensor(0.1 * rng.normal(size=L * (L - 1) // 2))}
    return x, y, ls, point


def _dense_lml(x, y, ls, point):
    """The covariant LML by dense matrices: the Kronecker noise, slogdet and
    a solve, differentiable by autograd."""
    p = ref_cov.chol_parameters(point)
    L, N = y.shape[1], x.shape[0]
    u = x[None, :, :] / ls[:, None, :]                             # (L, N, M)
    d = u[:, :, None, None, :] - u[None, None, :, :, :]              # (L, N, L, N, M)
    E = torch.exp(-0.5 * torch.sum(d * d, -1))                          # (L, N, L, N)
    K = (p['F'][:, None, :, None] * E).reshape(L * N, L * N) + torch.kron(p['noise'],
                                                                          torch.eye(N))
    yy = y.T.reshape(-1)
    return (-0.5 * yy @ torch.linalg.solve(K, yy) - 0.5 * torch.linalg.slogdet(K)[1]
            - 0.5 * L * N * math.log(2.0 * math.pi))


@pytest.mark.parametrize('form', ['direct', 'expansion'])
def test_covariant_reference_against_dense_autograd(form):
    x, y, ls, point = _covariant_problem()
    leaves = {name: value.clone().requires_grad_(True) for name, value in point.items()}
    value = _dense_lml(x, y, ls, leaves)
    grads = torch.autograd.grad(value, list(leaves.values()))
    out = ref_cov.chol_value_and_grad(x, y, ls, point, form)
    assert float(out['lml']) == pytest.approx(float(value.detach()), rel=1e-12)
    for name, got in zip(leaves, grads):
        np.testing.assert_allclose(out[name].numpy(), got.numpy(), rtol=1e-9, atol=1e-11)


def _gauss_hermite(n=80):
    """Nodes and weights of E over t ~ N(0, 1) by Gauss-Hermite."""
    t, w = np.polynomial.hermite_e.hermegauss(n)
    w = w / w.sum()
    return t, w


def test_closed_form_integrals_against_quadrature():
    """Each per-dim factor of sobol_closed, held to Gauss-Hermite
    quadrature at a pair of rows."""
    t, w = _gauss_hermite()
    a, b, la, lb = 0.3, -1.1, 1.4, 0.8

    def e(s, c, ls):
        return np.exp(-(s - c) ** 2 / (2 * ls ** 2))
    g = lambda c, ls: np.sum(w * e(t, c, ls))                      # noqa: E731
    f64 = lambda value: torch.tensor(value, dtype=torch.float64)       # noqa: E731
    coefficients = ref_closed._one_dim(f64(la), f64(lb))
    row, col, cross, const = (float(c) for c in coefficients)
    want = np.sum(w * e(t, a, la) * e(t, b, lb)) / (g(a, la) * g(b, lb))
    assert math.exp(row * a * a + col * b * b + cross * a * b + const) == pytest.approx(
        want, rel=1e-12)
    T, Tp = np.meshgrid(t, t, indexing='ij')
    W = np.outer(w, w)
    for u in (0.0, 1.0):
        for v in (0.0, 1.0):
            row, col, cross, const = (float(c) for c in ref_closed._two_dim(
                f64(la), f64(u), f64(v)))
            integrand = ((e(T, a, la) / g(a, la)) ** u * (e(Tp, b, la) / g(b, la)) ** v
                         * np.exp(-(T - Tp) ** 2 / (2 * la ** 2)))
            got = math.exp(row * a * a + col * b * b + cross * a * b + const)
            assert got == pytest.approx(np.sum(W * integrand), rel=1e-10), (u, v)


def test_closed_reference_against_the_port(_cpu):
    from romcomma_tpu_torch.gsa import calibrators
    rng = np.random.default_rng(3)
    N, M, L = 50, 4, 3
    X = torch.tensor(rng.standard_normal((N, M)))
    # smooth outputs: S of pure noise is a difference of terms 1e8 times larger
    Y = torch.stack([torch.sin(X[:, 0]) + 0.5 * X[:, 1] ** 2, X[:, 1] * X[:, 2],
                     torch.cos(X[:, 3]) + X[:, 0]], 1) + 0.1 * torch.tensor(
        rng.standard_normal((N, L)))
    ls = torch.tensor(rng.uniform(0.8, 3.0, (L, M)))
    s2 = torch.tensor(rng.uniform(0.5, 2.0, L))
    noise = torch.tensor(rng.uniform(0.01, 0.05, L))
    slices = [(0, m + 1) for m in range(M)]
    chols, alphas = [], []
    for l in range(L):
        K = ref_cov.unit_block(X, ls[l], ls[l]) * s2[l] + noise[l] * torch.eye(N)
        chols.append(torch.linalg.cholesky(K))
        alphas.append(torch.cholesky_solve(Y[:, l:l + 1], chols[-1])[:, 0])
    cal = calibrators.ClosedSobolWithError.from_arrays(
        F=s2[None, :], K_cho=torch.stack(chols), K_inv_Y=torch.stack(alphas)[:, None, :],
        Lambda=ls, X=X, is_F_diagonal=True, L=L, M=M, N=N, is_T_partial=False)
    got = calibrators.marginalize_intervals_folds([cal], tuple(slices))[0]
    want = ref_closed.indices(X, Y, ls, s2, noise, slices, block=16)
    # the factorized pass and the direct sums round apart by ~1e-10 of V here
    np.testing.assert_allclose(got['S'].numpy(), want['S'].numpy(), rtol=1e-7, atol=1e-9)
    T = torch.diagonal(got['T'], dim1=0, dim2=1).T
    scale = float(torch.max(want['T'] ** 2))
    assert float(torch.max(torch.abs(T ** 2 - want['T'] ** 2))) / scale < 1e-6


def test_function_vector_is_rom_commas_all():
    from romcomma_tpu_torch.user import functions
    X = np.random.default_rng(0).uniform(size=(64, 19))
    np.testing.assert_allclose(function_vector.functions(X), functions.ALL(X), rtol=1e-14,
                               atol=1e-13)
    C = function_vector.noise_covariance(9, 0.1, True, np.random.default_rng(1))
    assert np.trace(C) == pytest.approx(9 * 0.01) and np.all(np.linalg.eigvalsh(C) > 0)


# --------------------------------------------------------------------------- #
# Files and readers
# --------------------------------------------------------------------------- #

def test_the_covariant_configuration_and_cell_files():
    config = json.loads((HERE / 'configs' / 'sweep_m19_cov.json').read_text())
    traffic = json.loads((HERE / 'traffic' / 'fit_covariant.json').read_text())
    cell = json.loads((HERE / 'cells' / 'sweep_m19_cov.fit.json').read_text())
    assert config['reduced'] == [] and config['K'] == -2 and config['noise_covariant']
    assert config['fold_rows'] * abs(config['K']) == config['N']
    assert config['LN'] == config['L'] * config['fold_rows'] == 44280
    assert set(config['assumed']) == {'noise', 'design', 'folds', 'twin'}
    assert traffic['driver'] == 'fit_covariant' and traffic['maxiter'] >= 1
    assert traffic['maxiter_why'] and 0 <= traffic['fold'] < abs(config['K'])
    hypers = cell['hypers']
    assert np.shape(hypers['lengthscales']) == (config['L'], config['M'])
    assert len(hypers['variance']) == len(hypers['noise']) == config['L']
    assert isinstance(hypers['seed'], int) and hypers['source']


def test_the_fold_batched_sobol_files():
    config = json.loads((HERE / 'configs' / 'csv_oakley_k20.json').read_text())
    traffic = json.loads((HERE / 'traffic' / 'gsa_folds.json').read_text())
    cell = json.loads((HERE / 'cells' / 'csv_k20.gsa.json').read_text())
    assert traffic['kinds'] == ['first_order', 'closed', 'total']
    assert traffic['is_T_partial'] is False
    assert all(0 <= k < config['K'] for k in traffic['check_folds'])
    assert np.shape(cell['hypers']['lengthscales']) == (config['L'], config['M'])
    assert set(cell['limits']) == {'S_gap', 'T_gap'}


def test_the_covariant_cell_and_its_metrics_in_benchmark_json():
    cells = {w['name']: w for w in BENCH['workloads']}
    assert cells['sweep_m19_cov.fit']['chips'] == 1
    lists = {m['name']: m.get('workloads', []) for m in BENCH['end_to_end'] + BENCH['per_layer']}
    for name in ('eval_ms', 'fit_mfu', 'device_idle.fit', 'unit_gram_roofline',
                 'valgrad_ms.covariant', 'cov_factor_ms', 'cov_inverse_ms', 'cov_grads_ms'):
        assert 'sweep_m19_cov.fit' in lists[name], name


def _span(name, device_ms):
    return {'name': name, 'attrs': {}, 'id': 0, 'parent': None, 'thread': 1, 'start_ns': 0,
            'end_ns': 0, 'host_ms': 1.0, 'device_ms': device_ms, 'error': False}


@pytest.mark.parametrize('metric', ['cov_factor_ms', 'cov_inverse_ms', 'cov_grads_ms'])
def test_covariant_span_readers(metric):
    name = 'covariant_lml.' + metric.split('_')[1]
    reader = _reader(metric)
    spans = [_span(name, 100.0), _span(name, 300.0), dict(_span(name, 1e6), error=True),
             _span('exact_lml.factor', 1e6)]
    assert reader.read({}, spans) == pytest.approx(200.0)
    assert reader.read({}, []) is None
    assert reader.read({}, [_span(name, None)]) is None


def test_covariant_valgrad_and_mfu_readers():
    from perfbench import flops_covariant
    record = {'route': 'covariant', 'valgrad_s': [2.0, 4.0], 'window_s': 10.0,
              'model_flops': flops_covariant.window_flops(44280, 19, 2, 1)}
    assert _reader('valgrad_ms.covariant').read(record) == pytest.approx(3000.0)
    assert _reader('valgrad_ms.covariant').read(dict(record, route='folds')) is None
    assert _reader('valgrad_ms.small').read(record) is None
    assert _reader('valgrad_ms.large').read(record) is None
    want = 100.0 * (2 * (44280 ** 3 + 2 * 44280 ** 2) + 2 * 44280 ** 2 * 19) / (10.0 * 67e12)
    assert _reader('fit_mfu').read(record) == pytest.approx(want, rel=1e-12)


# --------------------------------------------------------------------------- #
# Whole runs at tiny sizes
# --------------------------------------------------------------------------- #

#: csv_k20.gsa's files are here, its entry not in BENCHMARK.json: the cell's
#: configuration and traffic are named here instead.
UNLISTED = {'csv_k20.gsa': {'config': 'csv_oakley_k20', 'traffic': 'gsa_folds'}}
TINY = {
    'sweep_m19_cov.fit': {'config': {'N': 120}, 'seconds': 5},
    'csv_k20.gsa': {'config': {'N': 240, 'M': 8, 'K': 4}, 'traffic': {'check_folds': [0, 3]},
                    'cell': {'hypers': {'variance': [1.0] * 3, 'lengthscales': [[2.0] * 8] * 3,
                                        'noise': [0.05] * 3}},
                    'seconds': 2},
}
FAULTS = {'sweep_m19_cov.fit': ('unchanged', 'covariant_half', 'covariant_alter'),
          'csv_k20.gsa': ('half', 'folds_alter')}

SCRIPT = '''
import json, sys
import torch
torch.set_num_threads(2)
from perfbench import faults, faults_covariant, run
workload, fault, trace, tiny = sys.argv[1], sys.argv[2], sys.argv[3] == '1', json.loads(sys.argv[4])
unlisted = json.loads(sys.argv[5])
if workload in unlisted:
    names = unlisted[workload]
    files = {'bench': run.load_json(run.ROOT / 'BENCHMARK.json'),
             'entry': {'name': workload, 'chips': 1, **names},
             'config': run.load_json(run.HERE / 'configs' / f"{names['config']}.json"),
             'traffic': run.load_json(run.HERE / 'traffic' / f"{names['traffic']}.json"),
             'cell': run.load_json(run.HERE / 'cells' / f'{workload}.json')}
else:
    files = run.cell_files(workload)
for key in ('config', 'traffic', 'cell'):
    files[key] = dict(files[key], **tiny.get(key, {}))
faults_covariant.register()
if fault != 'none':
    faults.FAULTS[fault]()
result = run.run_cell(workload, 2 ** 31 + 17, tiny['seconds'], trace, device='cpu', files=files)
print(json.dumps({'result': result, 'forbidden': run.forbidden_modules()}))
'''


def _run(workload: str, fault: str = 'none', trace: bool = False):
    env = dict(os.environ, ROMCOMMA_X64='0', PYTHONPATH=str(ROOT), OMP_NUM_THREADS='2')
    done = subprocess.run([sys.executable, '-c', SCRIPT, workload, fault, '1' if trace else '0',
                           json.dumps(TINY[workload]), json.dumps(UNLISTED)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('workload', sorted(TINY))
def test_a_sound_run_is_whole_correct_and_free_of_jax(workload):
    out = _run(workload, trace=True)
    result = out['result']
    assert out['forbidden'] == []
    assert list(result)[:5] == ['correct', 'attempted', 'failed', 'metrics', 'device']
    assert result['correct'] is True, result['checked']
    assert result['attempted'] > 0 and result['failed'] == 0
    if workload == 'sweep_m19_cov.fit':
        assert 'valgrad_ms.covariant' in result['metrics'] and 'fit_mfu' in result['metrics']
    else:
        assert 'breakdown' in result and result['device']['window_s'] > 0


@pytest.mark.parametrize('workload,fault', [(w, f) for w in sorted(FAULTS) for f in FAULTS[w]])
def test_a_planted_fault_is_not_correct(workload, fault):
    result = _run(workload, fault)['result']
    assert result['correct'] is False, result['checked']


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
def test_the_covariant_driver_on_the_card_at_a_reduced_size():
    """The covariant cell's driver at L N = 9 x 1000 on the card: the unit
    gram is one kernel launch, the six stages carry device times, and the
    run is correct."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    script = SCRIPT.replace("device='cpu'", "device='cuda:0'")
    env = dict(os.environ, ROMCOMMA_X64='0', PYTHONPATH=str(ROOT))
    tiny = {'config': {'N': 2000}, 'seconds': 8}
    done = subprocess.run([sys.executable, '-c', script, 'sweep_m19_cov.fit', 'none', '1',
                           json.dumps(tiny), json.dumps(UNLISTED)], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])['result']
    assert result['correct'] is True, result['checked']
    for name in ('valgrad_ms.covariant', 'cov_factor_ms', 'cov_inverse_ms', 'cov_grads_ms',
                 'unit_gram_roofline', 'fit_mfu', 'device_idle.fit'):
        assert name in result['metrics'], name
