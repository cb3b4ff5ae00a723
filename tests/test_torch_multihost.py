"""The port's multi-process paths on the CPU, over spawned gloo ranks (the
two-rank cases in one spawn): ``parallel.multihost`` (fold shares, barrier,
collects) writes the tree a single process writes, byte for byte;
``user.run.gpr``/``run.gsa`` under two ranks, the improper fold over their
mesh (large_n_threshold lowered), write the one-rank tree (rank 0 writing);
``parallel.mesh``'s sharded training step (1 x 2 and 2 x 2 meshes) and
fold-sharded calibration equal ``gp.lml_variant`` and the fold loop;
``north_star.run`` over two ranks takes the 'cyclic' engine;
``benchmark_script`` shares its sweep cells out over two ranks and writes
every cell; ``graft_entry.dryrun_multichip(2)`` runs (its covariant step
included); run.gpr's covariant pass routes as romcomma_tpu's (the
one-device descent below the large-N threshold, writing the one-rank tree;
the covariant mesh at it) and ``engine='upper'`` is refused by name on
several ranks; a rank that fails stops every rank; and ``chip_smoke.py``'s phase 13b runs its rank
body spawned over gloo. This file imports no JAX: it holds the port to
itself, romcomma_tpu's multi-process layer having no CPU mesh of processes
to run on."""

import io
import json
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import torch_mesh_ranks as ranks
from romcomma_tpu_torch import north_star
from romcomma_tpu_torch.base.definitions import pinned_device
from romcomma_tpu_torch.data.storage import Repository
from romcomma_tpu_torch.models import gp
from romcomma_tpu_torch.models.params import variant_init, variant_mask
from romcomma_tpu_torch.parallel import spawn
from romcomma_tpu_torch.parallel.distributed import DistributedGP

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

#: CSV values of the mesh-trained fold against the one-device route's.
CSV_TOL = 1e-10


@pytest.fixture(scope='module', autouse=True)
def _on_the_cpu():
    with pinned_device(torch.device('cpu')):
        yield


def _repository(root: Path, N: int = 60, K: int = 2) -> Repository:
    rng = np.random.default_rng(11)
    X = rng.uniform(size=(N, 3))
    Y = np.column_stack([np.sin(3 * X[:, 0]) + X[:, 1] ** 2, X[:, 2] - X[:, 0] * X[:, 1]])
    Y = Y + 0.05 * rng.normal(size=Y.shape)
    columns = pd.MultiIndex.from_tuples([('X', f'X.{i}') for i in range(3)]
                                        + [('Y', f'Y.{i}') for i in range(2)])
    return Repository.from_df(root, pd.DataFrame(np.column_stack([X, Y]),
                                                 columns=columns)).into_K_folds(K)


def _copies(tmp_path: Path, *names: str):
    _repository(tmp_path / 'seed')
    for name in names:
        shutil.copytree(tmp_path / 'seed', tmp_path / name)
    return [str(tmp_path / name) for name in names]


def _step_inputs():
    rng = np.random.default_rng(5)
    N, M, L = 30, 3, 4
    x, y = rng.normal(size=(N, M)), rng.normal(size=(N, L))
    raw = variant_init(rng.uniform(1.0, 2.0, L), rng.uniform(0.5, 2.0, (L, M)), np.full(L, 0.1))
    return {name: value.numpy() for name, value in raw.items()}, x, y


def _fold_inputs():
    rng = np.random.default_rng(9)
    K, N, M, L = 3, 20, 3, 2
    xs, ys = rng.normal(size=(K, N, M)), rng.normal(size=(K, N, L))
    raw = variant_init(np.full(L, 1.0), np.full((L, M), 1.0), np.full(L, 0.1))
    return {name: np.stack([value.numpy()] * K) for name, value in raw.items()}, variant_mask(), \
        xs, ys


#: north_star.run's size over two ranks: (N, M, maxiter).
STAR = (200, 4, 20)


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    """The two-rank cases (ranks.two_rank_suite) in one spawn, and the
    single-process trees they are held to."""
    tmp = tmp_path_factory.mktemp('two_ranks')
    names = ('multihost alone', 'multihost', 'run_gpr alone', 'run_gpr', 'covariant below alone',
             'covariant below', 'covariant above alone', 'covariant above')
    roots = dict(zip(names, _copies(tmp, *(name.replace(' ', '_') for name in names))))
    roots['sweep'] = str(tmp / 'sweep')
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(spawn.run, ranks.two_rank_suite, 2, roots['multihost'],
                              roots['run_gpr'], roots['sweep'], _step_inputs(), _fold_inputs(),
                              STAR, (roots['covariant below'], roots['covariant above']),
                              timeout=400)
        with pinned_device(torch.device('cpu')):
            alone = {'multihost': ranks.multihost_tree(0, roots['multihost alone']),
                     'run_gpr': ranks.run_gpr(0, roots['run_gpr alone'], 50),
                     'covariant': ranks.covariant_routing(0, roots['covariant below alone'],
                                                          roots['covariant above alone'])}
        return spawned.result(), alone, roots


def test_multihost_shares_write_the_single_process_tree(two_ranks):
    results, alone, roots = two_ranks
    assert alone['multihost'] == [0, 1, 2]
    assert [r['multihost'] for r in results] == [[0, 2], [1]]
    # meta.json files name their own folder: compare them with the roots cut
    want = ranks.tree(roots['multihost alone'], cut=roots['multihost alone'])
    got = ranks.tree(roots['multihost'], cut=roots['multihost'])
    assert sorted(got) == sorted(want)
    assert [path for path in want if want[path] != got[path]] == []
    assert any(path.startswith('gpr.v.a/gsa') for path in got)


def _same_tree(want: dict, got: dict):
    """Every file of both trees; CSVs equal within CSV_TOL, JSON equal but
    for the optimizer's result line."""
    assert sorted(got) == sorted(want)
    for path, data in want.items():
        if path.endswith('.csv'):
            a, b = (pd.read_csv(io.BytesIO(d), header=None, dtype=str, keep_default_na=False
                                ).to_numpy().ravel() for d in (data, got[path]))
            assert a.shape == b.shape, path
            x, y = (pd.to_numeric(pd.Series(cells), errors='coerce').to_numpy()
                    for cells in (a, b))
            text = np.isnan(x)
            assert list(a[text]) == list(b[text]), path
            np.testing.assert_allclose(y[~text], x[~text], rtol=CSV_TOL, atol=CSV_TOL,
                                       err_msg=path)
        elif path.endswith('.json'):
            a, b = json.loads(data), json.loads(got[path])
            a.pop('result', None), b.pop('result', None)
            assert a == b, path
        else:
            assert data == got[path], path


def test_run_gpr_on_two_ranks_writes_the_one_rank_tree(two_ranks):
    """Folds 0 and 1 (30 rows) take the small route on each rank; the
    improper fold (60 rows, large_n_threshold=50) trains over the two ranks'
    'cyclic2' mesh, its scipy descent in lockstep; rank 0 writes."""
    results, alone, roots = two_ranks
    assert alone['run_gpr'] == [(60, 'upper')]
    assert [r['run_gpr'] for r in results] == [[(60, 'cyclic2')]] * 2
    _same_tree(ranks.tree(roots['run_gpr alone'], cut=roots['run_gpr alone']),
               ranks.tree(roots['run_gpr'], cut=roots['run_gpr']))


def test_benchmark_script_shares_its_cells_over_two_ranks(two_ranks):
    """Under a process group of two ranks the sweep's two cells go one to
    each rank, which runs it alone (solo()): both cells' trees are written
    in full, and rank 0 collects every cell at root in the cells' order."""
    results, _, roots = two_ranks
    assert [r['sweep'] for r in results] == [(0, 2), (1, 2)]
    root = Path(roots['sweep'])
    cells = [root / f'all.M.{M_}.d.v.10.00.N.30' for M_ in ranks.SWEEP_GRID['Ms']]
    for cell in cells:
        for k in (0, 1):
            fold = cell / f'fold.{k}' / 'gpr.v.a'
            assert (fold / 'test_summary.csv').is_file()
            for kind in ('first_order', 'closed', 'total'):
                for csv in 'SVTW':
                    assert (fold / 'gsa' / kind / f'{csv}.csv').is_file()
    summary = pd.read_csv(root / 'gpr' / 'test_summary.csv', header=[0, 1])
    per_cell = [pd.read_csv(cell / 'gpr' / 'test_summary.csv', header=[0, 1]) for cell in cells]
    assert list(summary.iloc[:, 4]) == [7] * len(per_cell[0]) + [9] * len(per_cell[1])
    np.testing.assert_array_equal(summary.iloc[:, 5:].to_numpy(),
                                  pd.concat(per_cell).to_numpy())
    S = pd.read_csv(root / 'gsa' / 'S.csv')
    per_cell = [pd.read_csv(cell / 'gsa' / 'S.csv') for cell in cells]
    assert list(S['M']) == [7] * len(per_cell[0]) + [9] * len(per_cell[1])


def _covariant_point():
    """A small covariant problem (L N = 300 over two ranks: padding rows
    live) with F and the noise covariance non-diagonal, float32."""
    rng = np.random.default_rng(13)
    X = rng.uniform(-1, 1, (100, 4))
    Y = np.column_stack([np.sin(2 * X[:, 0]), X[:, 1] ** 2, X[:, 2] + X[:, 3]])
    Y = Y + 0.05 * rng.normal(size=Y.shape)
    F = np.array([[1.0, 0.4, 0.2], [0.4, 0.9, -0.1], [0.2, -0.1, 0.8]])
    noise = np.array([[0.02, 0.005, 0.0], [0.005, 0.03, 0.0], [0.0, 0.0, 0.025]])
    return tuple(a.astype(np.float32) for a in (X, Y, np.full((3, 4), 1.2), F, noise))


def test_chip_smoke_phase_13b_rank_body_on_gloo():
    """chip_smoke.py's phase 13b as it runs on several cards (its rank body
    spawned by name, every rank's result the same bits), on two gloo ranks
    at a small north-star problem and a small covariant one: each engine's
    float32 LML and gradient held to float64 ExactLML's by phase 13b's rule,
    within MESH_RANKS_F32_MULTIPLES of ExactLML float32's own distance, and the
    covariant mesh's to float64 CovariantUpperLML's by phase 13c's, within
    COVARIANT_MESH_F32_MULTIPLES of CovariantUpperLML float32's."""
    size = (300, 4)
    hypers = (np.full(size[1], 2.0, np.float32), np.float32(1.0), np.float32(0.05))
    point = _covariant_point()
    results = chip_smoke.mesh_ranks(2, size, hypers, point, 'gloo', 120)
    one = DistributedGP(size[0], torch.device('cpu'), dtype=np.float32, engine='upper')
    x, y = one.stage(*north_star.problem(*size))
    at = [torch.as_tensor(h) for h in hypers]
    f32 = chip_smoke._value_and_grad(torch, one, x, y, at)
    one64 = DistributedGP(size[0], torch.device('cpu'), dtype=np.float64, engine='upper')
    x64, y64 = one64.stage(x, y)
    f64 = chip_smoke._value_and_grad(torch, one64, x64, y64, [t.double() for t in at])
    reference = chip_smoke._apart(f32, f64)
    for engine in chip_smoke.MESH_ENGINES:
        apart = chip_smoke._apart([torch.as_tensor(g) for g in results[0][engine]], f64)
        assert all(a <= m * r for a, m, r in zip(apart, chip_smoke.MESH_RANKS_F32_MULTIPLES,
                                                 reference)), (engine, apart, reference)
    X, Y, ls, F, noise = (torch.as_tensor(a) for a in point)
    f32, f64 = (chip_smoke._covariant_value_and_grads(
        torch, gp.covariant_upper_lml(X.to(dtype), ls.to(dtype), Y.to(dtype)), F.to(dtype),
        noise.to(dtype)) for dtype in (torch.float32, torch.float64))
    reference = chip_smoke._apart(f32, f64)
    apart = chip_smoke._apart([torch.as_tensor(g) for g in results[0]['covariant']], f64)
    assert all(a <= m * r for a, m, r in zip(apart, chip_smoke.COVARIANT_MESH_F32_MULTIPLES,
                                             reference)), (apart, reference)


def _check_step(results, raw, x, y):
    p = {name: torch.as_tensor(value).requires_grad_(True) for name, value in raw.items()}
    loss = -torch.sum(gp.lml_variant(p, torch.as_tensor(x), torch.as_tensor(y)))
    want = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    for got_loss, (lo, hi), grads in results:
        np.testing.assert_allclose(got_loss, float(loss.detach()), rtol=1e-12)
        for name, g in grads.items():
            np.testing.assert_allclose(g, want[name][lo:hi].numpy(), rtol=1e-10, atol=1e-12)


def test_training_step_sharded_on_1x2_matches_lml_variant(two_ranks):
    _check_step([r['step'] for r in two_ranks[0]], *_step_inputs())


def test_training_step_sharded_on_2x2_matches_lml_variant():
    inputs = _step_inputs()
    _check_step(spawn.run(ranks.sharded_step, 4, *inputs, 2, timeout=120), *inputs)


def test_calibrate_folds_sharded_matches_the_fold_loop(two_ranks):
    raws, mask, xs, ys = _fold_inputs()
    for k in range(xs.shape[0]):
        want, lml, iterations = gp.calibrate_variant(
            {name: torch.as_tensor(value[k]) for name, value in raws.items()}, mask,
            torch.as_tensor(xs[k]), torch.as_tensor(ys[k]), maxiter=20)
        for got_raw, got_lml, got_iterations in (r['folds'] for r in two_ranks[0]):
            for name in raws:
                np.testing.assert_allclose(got_raw[name][k], want[name].detach().numpy(),
                                           rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(got_lml[k], lml.numpy(), rtol=1e-12)
            np.testing.assert_array_equal(got_iterations[k], np.asarray(iterations))


def test_north_star_over_two_ranks(two_ranks):
    """north_star.run over a mesh of two ranks takes the block-cyclic engine,
    as benchmarks/north_star.py does on several devices; every rank returns
    the same record; the indices keep the problem's structure."""
    records = [r['north_star'] for r in two_ranks[0]]
    assert records[0] == records[1]
    engine, S, lml, iterations, S1 = records[0]
    assert (engine, S) == ('cyclic', 2) and np.isfinite(lml) and iterations > 5
    assert S1[0] > 0.3 and S1[1] > 0.3 and S1[2] < 0.01


def test_dryrun_multichip_on_two_ranks(two_ranks):
    """graft_entry.dryrun_multichip(2) ran in the two-rank group (its checks
    raise on the ranks, which would have failed the spawn)."""
    assert len(two_ranks[0]) == 2


def test_covariant_mesh_and_upper_engine_are_refused_on_several_ranks(two_ranks):
    """On two ranks engine='upper' is still refused by name, and run.gpr's
    covariant descents route as romcomma_tpu's: below the large-N threshold
    every fold runs the one-device descent on each rank (no mesh built),
    as on one rank; at or above it, with L*N at the covariant mesh's
    threshold or more, the improper fold (L N = 120) runs over the two
    ranks' mesh and the other folds (L N = 60) on their own. (The name is
    kept from when several ranks refused both.)"""
    results, alone, _ = two_ranks
    assert alone['covariant'] == {'below': [], 'above': []}
    for r in results:
        assert "engine='upper' is single-device only" in r['covariant']['upper']
        assert r['covariant']['below'] == []
        assert r['covariant']['above'] == [(60, 2, 2)]


def test_covariant_run_gpr_on_two_ranks_writes_the_one_rank_tree(two_ranks):
    """The two ranks' covariant run.gpr writes the one-rank tree (rank 0
    writing), below the large-N threshold and at it, where the improper
    fold's descent runs over the mesh and the one rank's on its device."""
    _, _, roots = two_ranks
    for case in ('below', 'above'):
        alone, mesh = roots[f'covariant {case} alone'], roots[f'covariant {case}']
        want, got = ranks.tree(alone, cut=alone), ranks.tree(mesh, cut=mesh)
        assert any(path.endswith('gpr.c.a/likelihood/log_marginal.csv') for path in want)
        _same_tree(want, got)


def test_a_failing_rank_stops_every_rank():
    """A rank that raises comes back as an error with its traceback; the
    other ranks, waiting in a collective, are stopped."""
    with pytest.raises(RuntimeError, match='ZeroDivisionError'):
        spawn.run(ranks.fails_on_rank_one, 2, timeout=60)
