"""The port's CLIs against the repository's root scripts, on the CPU:
romcomma_tpu_torch.csv_script against csv_script.py (the tree and its
collected tables; the GSA of one trained tree) and
romcomma_tpu_torch.benchmark_script against benchmark_script.py (the grid, the
sweep-cell selection, one tiny cell run end to end); and run.gpr's
fold-batched path on folds of unequal shape."""

import random
import shutil
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import benchmark_script as jax_benchmark_script  # noqa: E402
import csv_script as jax_csv_script  # noqa: E402
from romcomma_tpu_torch import benchmark_script, csv_script, user  # noqa: E402
from romcomma_tpu_torch.base.definitions import pinned_device  # noqa: E402
from romcomma_tpu_torch.data.storage import Repository  # noqa: E402
from romcomma_tpu_torch.models import gp  # noqa: E402
from test_torch_slice import _indices_close  # noqa: E402
from test_torch_storage import _assert_same_bytes, _files  # noqa: E402


@pytest.fixture(scope='module', autouse=True)
def _on_the_cpu():
    """The port computes on the CPU here because the tests ask for it: it
    raises where there is no CUDA device and nothing was asked for."""
    with pinned_device(torch.device('cpu')):
        yield


torch.set_num_threads(1)

N, M, L, K = 40, 3, 2, 2
KINDS = ('first_order', 'closed', 'total')


def _tiny_csv(path: Path, N=N, M=M, seed=0) -> Path:
    """tests/test_scripts.py's data, at N rows."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (N, M))
    Y = np.stack([np.sin(3 * X[:, 0]) + 0.1 * rng.normal(size=N),
                  X[:, 1] ** 2 + 0.1 * rng.normal(size=N)], axis=-1)
    columns = ([('X', f'X.{i}') for i in range(M)] + [('Y', f'Y.{i}') for i in range(L)])
    pd.DataFrame(np.concatenate([X, Y], axis=1),
                 columns=pd.MultiIndex.from_tuples(columns)).to_csv(path)
    return path


@pytest.fixture(scope='module')
def csv_trees(tmp_path_factory):
    """csv_script.run(gpr=True, gsa=True) of each package on one CSV, into
    'jax' and 'port'; then the port's csv_script.run(gpr=False, gsa=True) on a
    copy of romcomma_tpu's trained tree, 'port_gsa'."""
    root = tmp_path_factory.mktemp('csv')
    csv = _tiny_csv(root / 'data.csv')
    for package, module in (('jax', jax_csv_script), ('port', csv_script)):
        random.seed(0)                # the fold assignment draws from `random`
        assert module.run(root / package, csv, gpr=True, gsa=True, ignore_exceptions=False,
                          k=K) == root / package
    shutil.copytree(root / 'jax', root / 'port_gsa')
    csv_script.run(root / 'port_gsa', csv, gpr=False, gsa=True, ignore_exceptions=False)
    return root


def _labels(path: Path):
    """A CSV as a grid of strings: its shape, and every cell that is not a
    number (headers, provenance columns, row labels)."""
    grid = pd.read_csv(path, header=None, dtype=str, keep_default_na=False).to_numpy()

    def is_number(cell):
        try:
            float(cell)
            return cell != ''
        except ValueError:
            return False
    return grid.shape, [(i, j, c) for (i, j), c in np.ndenumerate(grid) if not is_number(c)]


def test_csv_script_tree_and_tables(csv_trees):
    """The port's tree has romcomma_tpu's files; every CSV, the collected
    tables at repository and root level among them, has its shape, headers,
    provenance columns and row labels."""
    files = _files(csv_trees / 'jax')
    assert _files(csv_trees / 'port') == files
    for name in ('gpr/test_summary.csv', 'gpr/likelihood/log_marginal.csv',
                 'gpr/kernel/lengthscales.csv', 'gsa/S.csv', 'gsa/T.csv',
                 f'fold.{K}/gpr.v.a/gsa/total/W.csv'):
        assert Path(name) in files
    mismatched = [str(f) for f in files if f.suffix == '.csv'
                  and _labels(csv_trees / 'port' / f) != _labels(csv_trees / 'jax' / f)]
    assert mismatched == []


@pytest.mark.parametrize('kind', KINDS)
def test_csv_script_gsa_of_one_trained_tree(csv_trees, kind):
    """From romcomma_tpu's trained tree, the port's GSA gives S, V, T and W
    within tests/test_torch_slice.py's tolerances: every fold's tables and the
    repository-level collection."""
    for k in range(K + 1):
        for csv in 'SVTW':
            path = Path(f'fold.{k}') / 'gpr.v.a' / 'gsa' / kind / f'{csv}.csv'
            got = pd.read_csv(csv_trees / 'port_gsa' / path, index_col=[0, 1])
            want = pd.read_csv(csv_trees / 'jax' / path, index_col=[0, 1])
            assert list(got.columns) == list(want.columns) and got.index.equals(want.index)
            _indices_close(got.to_numpy(), want.to_numpy(), csv, kind, str(path))
    for csv in 'SVTW':
        # Rows (ext, kind, model, N, fold, l, i), one column per m.
        got = pd.read_csv(csv_trees / 'port_gsa' / 'gsa' / f'{csv}.csv', index_col=list(range(7)))
        want = pd.read_csv(csv_trees / 'jax' / 'gsa' / f'{csv}.csv', index_col=list(range(7)))
        assert list(got.columns) == list(want.columns) and got.index.equals(want.index)
        rows = want.index.get_level_values('kind') == kind
        _indices_close(got[rows].to_numpy(dtype=float), want[rows].to_numpy(dtype=float), csv,
                       kind, f'gsa/{csv}.csv')


def test_csv_script_cli(tmp_path, monkeypatch):
    """The CLI's flags reach run() as csv_script.py's do."""
    calls = []
    monkeypatch.setattr(csv_script, 'run', lambda *a: calls.append(a) or a[0])
    csv_script.main(['-r', '-a', '-G', '-K', '5', '-k', '-l', '0.1', str(tmp_path / 'd.csv'),
                     str(tmp_path / 'root')])
    assert calls == [(tmp_path / 'root', tmp_path / 'd.csv', True, True, False, True, -5, None,
                      False, 0.1, None, None, None)]


@pytest.mark.parametrize('name', ['K', 'Ms', 'Ns', 'NOISE_MAGNITUDES', 'IS_NOISE_VARIANCE_DETERMINED',
                                  'ROTATIONS', 'IS_GPR_READ', 'IS_GPR_ISOTROPIC',
                                  'IS_GSA_ERROR_CALCULATED'])
def test_benchmark_script_grid(name):
    assert getattr(benchmark_script, name) == getattr(jax_benchmark_script, name)


def test_benchmark_script_vector_and_kinds():
    assert (benchmark_script.FUNCTION_VECTOR.meta == jax_benchmark_script.FUNCTION_VECTOR.meta
            and len(benchmark_script.FUNCTION_VECTOR) == 9)
    assert benchmark_script.DOE.__name__ == jax_benchmark_script.DOE.__name__
    assert ([kind.name for kind in benchmark_script.GSA_KINDS]
            == [kind.name for kind in jax_benchmark_script.GSA_KINDS])


def _selected(module, monkeypatch, tmp_path, argv):
    """The (noise, M, N) cells that module.run visits for argv, recorded by a
    stand-in for user.sample.Function that samples nothing."""
    cells = []

    class Repo:
        folder = tmp_path / 'cell'

    class Function:
        def __init__(self, root, doe, vector, N, M, noise_variance, ext, overwrite):
            cells.append((noise_variance.magnitude, M, N))
            self.repo = Repo()

    monkeypatch.setattr(module.user.sample, 'Function', Function)
    args = benchmark_script.parse_args(argv + [str(tmp_path / 'root')])
    if module is jax_benchmark_script and args.input_dim:
        monkeypatch.setattr(module, 'Ms', (args.input_dim,))     # what its __main__ does
    with pinned_device(torch.device('cpu')):
        module.run(args, tmp_path / 'root')
    return cells


@pytest.mark.parametrize('argv, env', [
    (['-M', '19', '--num-processes', '940', '--process-id', '325'], {}),
    (['--num-processes', '300', '--process-id', '7'], {}),
    ([], {'ROMCOMMA_PROCESS_ID': '11', 'ROMCOMMA_NUM_PROCESSES': '1000'}),
    (['--process-id', '2'], {'ROMCOMMA_PROCESS_ID': '11', 'ROMCOMMA_NUM_PROCESSES': '1000'}),
], ids=['cell-325-of-M=19', 'flags', 'environment', 'flag-over-environment'])
def test_benchmark_script_cell_selection(tmp_path, monkeypatch, argv, env):
    """Both scripts visit the same cells for the same identity; cell 325 of
    the M=19 grid is noise 0.1, N=8000."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    argv = ['-i'] + argv
    got = _selected(benchmark_script, monkeypatch, tmp_path / 'port', argv)
    want = _selected(jax_benchmark_script, monkeypatch, tmp_path / 'jax', argv)
    assert got == want and got
    if '325' in argv:
        assert got == [(0.1, 19, 8000)]


def test_benchmark_script_tiny_cell(tmp_path, monkeypatch):
    """One cell (ALL, L=9, M=7, N=40, K=-2: two folds of 20 rows, trained
    in lockstep) sampled, trained and analysed on the CPU through main, its
    tables collected at root and copied by -y."""
    monkeypatch.setattr(benchmark_script, 'Ns', (40,))
    monkeypatch.setattr(benchmark_script, 'NOISE_MAGNITUDES', (0.1,))
    groups = []
    folds = gp.calibrate_variant_folds

    def recorded(raws, *args, **kwargs):
        out = folds(raws, *args, **kwargs)
        groups.append(tuple(out[1].shape))
        return out

    monkeypatch.setattr(gp, 'calibrate_variant_folds', recorded)
    root = tmp_path / 'root'
    assert benchmark_script.main(['-f', '-r', '-s', '-M', '7', '-y', str(tmp_path / 'copy'),
                                  str(root)]) == root
    assert groups == [(2, 9)]
    repo = root / 'all.M.7.d.v.10.00.N.40'
    for k in (0, 1):
        for kind in KINDS:
            for csv in 'SVTW':
                frame = pd.read_csv(repo / f'fold.{k}' / 'gpr.v.a' / 'gsa' / kind / f'{csv}.csv',
                                    index_col=[0, 1])
                assert frame.shape == (81, 7 if csv == 'W' else 8)
                assert np.isfinite(frame.to_numpy()).all()
    assert not (repo / 'fold.2').exists()
    # At root, as benchmark_script.py does, the likelihood and kernel
    # collections read <repo>/gpr/*.csv, where there are none, so only the
    # test summary and the GSA tables are collected there.
    for name in ('gpr/test_summary.csv', 'gsa/S.csv', 'gsa/V.csv', 'gsa/T.csv', 'gsa/W.csv'):
        assert (root / name).is_file() and (tmp_path / 'copy' / name).is_file()
    assert _files(root / 'gpr' / 'kernel') == []


def test_folds_of_unequal_shape(tmp_path, monkeypatch):
    """N=40 in K=3 folds trains on 26, 27 and 27 rows: run.gpr and run.gsa
    group the folds by shape, so the two 27-row folds train in lockstep and
    take one stacked GSA pass, and the 26-row fold and the improper fold
    each run alone. run.gpr writes the per-fold loop's tree byte for byte,
    run.gsa its S, V, T and W within 1e-12 relative
    (tests/test_torch_fold_parallel.py's rule)."""
    csv = _tiny_csv(tmp_path / 'data.csv')
    random.seed(0)
    repo = Repository.from_csv(tmp_path / 'batched', csv).into_K_folds(3)
    shutil.copytree(repo.folder, tmp_path / 'loop')
    assert [Repository(repo.fold_folder(k)).N for k in repo.folds] == [26, 27, 27, 40]
    groups = []
    folds = gp.calibrate_variant_folds

    def recorded(raws, *args, **kwargs):
        out = folds(raws, *args, **kwargs)
        groups.append(tuple(out[1].shape))
        return out

    monkeypatch.setattr(gp, 'calibrate_variant_folds', recorded)
    options = dict(is_read=False, is_covariant=False, is_isotropic=None, maxiter=40)
    user.run.gpr('gpr', repo, fold_parallel=True, **options)
    assert groups == [(2, L), (2, L)]            # the 27-row pair, isotropic then anisotropic
    user.run.gpr('gpr', Repository(tmp_path / 'loop'), fold_parallel=False, **options)
    assert groups == [(2, L), (2, L)]
    _assert_same_bytes(tmp_path / 'loop', tmp_path / 'batched', _files(tmp_path / 'loop'))
    stacked = []
    marginalize_folds = user.run.marginalize_all_kinds_folds

    def recorded_gsa(gps, *args, **kwargs):
        stacked.append([gp_.N for gp_ in gps])
        return marginalize_folds(gps, *args, **kwargs)

    monkeypatch.setattr(user.run, 'marginalize_all_kinds_folds', recorded_gsa)
    options = dict(is_covariant=False, is_isotropic=False, is_error_calculated=True,
                   is_T_partial=False)
    user.run.gsa('gpr', repo, fold_parallel=True, **options)
    assert stacked == [[27, 27]]
    user.run.gsa('gpr', Repository(tmp_path / 'loop'), fold_parallel=False, **options)
    assert stacked == [[27, 27]]
    files = [f for f in _files(tmp_path / 'loop') if 'gsa' in f.parts and f.suffix == '.csv']
    assert len(files) == 5 * 3 * 4       # four folds and the Collect, three kinds, S V T W
    for path in files:
        np.testing.assert_allclose(pd.read_csv(tmp_path / 'batched' / path).to_numpy(dtype=float),
                                   pd.read_csv(tmp_path / 'loop' / path).to_numpy(dtype=float),
                                   rtol=1e-12, atol=0.0, err_msg=str(path))
