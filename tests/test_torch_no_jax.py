"""The port stands alone: a fresh process imports romcomma_tpu_torch, trains
small models through run.gpr (the variant and the covariant MOGP, and the
variant again through the large-N route, DistributedGP), runs their GSA
through run.gsa (the variant with standard errors) and one ROM.calibrate, on
the CPU it asks for, without importing jax or romcomma_tpu; then run.gpr and
run.gsa on the fold-batched path (fold_parallel=True: the lockstep descents,
the stacked GSA) on a repository of two equal folds; then the likelihood
layer, regression.gls and the CSV CLI's run (imported with the sweep CLI),
with the CPU pinned, as a Python caller pins it, around csv_script.run; and
the multi-device modules (parallel.mesh, multihost, cyclic_deferred,
covariant_mesh, spawn, gsa.mesh, graft_entry) and the measurement entry
points (cyclic2_engine, multi_output_gsa, error_gsa) import."""

import subprocess
import sys
from pathlib import Path


def test_port_runs_without_jax(tmp_path):
    script = f"""
import sys
import numpy as np, pandas as pd, torch
torch.set_num_threads(1)
import romcomma_tpu_torch
from romcomma_tpu_torch import user
from romcomma_tpu_torch.data.storage import Repository
rng = np.random.default_rng(0)
X = rng.uniform(size=(16, 3))
df = pd.DataFrame(np.concatenate((X, user.functions.ISHIGAMI(X)), axis=1),
                  columns=pd.MultiIndex.from_tuples([('X', f'X.{{i}}') for i in range(3)]
                                                    + [('Y', f'Y.{{i}}') for i in range(3)]))
repo = Repository.from_df({str(tmp_path / 'repo')!r}, df).into_K_folds(1)
with user.contexts.Environment('port', device='CPU'):
    user.run.gpr('gpr', repo, is_read=False, is_covariant=False, is_isotropic=True, maxiter=20)
    user.run.gsa('gpr', repo, is_covariant=False, is_isotropic=True, is_error_calculated=True,
                 is_T_partial=False)
    user.run.gpr('gpr', repo, is_read=None, is_covariant=True, is_isotropic=False, maxiter=20)
    user.run.gsa('gpr', repo, is_covariant=True, is_isotropic=False)
    user.run.gpr('large', repo, is_read=False, is_covariant=False, is_isotropic=False, maxiter=20,
                 large_n_threshold=1)
    from romcomma_tpu_torch.data.storage import Fold
    from romcomma_tpu_torch.rom import ROM
    ROM('rom', Fold(repo, 0), m=1, iterations=1, rotation_method='sobol', maxiter=20,
        theta_maxiter=10, theta_starts=1).calibrate()
    pair = Repository.from_df({str(tmp_path / 'pair')!r}, df).into_K_folds(2)
    user.run.gpr('gpr', pair, is_read=False, is_covariant=False, is_isotropic=None, maxiter=20,
                 fold_parallel=True)
    user.run.gsa('gpr', pair, is_covariant=False, is_isotropic=False, is_error_calculated=True,
                 fold_parallel=True)
    from romcomma_tpu_torch import benchmark_script, csv_script
    from romcomma_tpu_torch.models.likelihoods import MOGaussian
    MOGaussian(np.eye(3)).predict_log_density(np.zeros(6), np.eye(6), np.ones(6))
    user.regression.gls(X, X[:, :1], np.eye(16))
    df.to_csv({str(tmp_path / 'data.csv')!r})
from romcomma_tpu_torch.base.definitions import pinned_device
with pinned_device(torch.device('cpu')):
    csv_script.run({str(tmp_path / 'csv')!r}, {str(tmp_path / 'data.csv')!r}, gpr=True, gsa=True,
                   ignore_exceptions=False, k=2)
from romcomma_tpu_torch import cyclic2_engine, error_gsa, graft_entry, multi_output_gsa
from romcomma_tpu_torch.gsa import mesh as gsa_mesh
from romcomma_tpu_torch.parallel import covariant_mesh, cyclic_deferred, mesh, multihost, spawn
assert multihost.process_identity() == (0, 1)
assert 'romcomma_tpu_torch.parallel.distributed' in sys.modules
assert 'romcomma_tpu_torch.rom.rom' in sys.modules
print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'romcomma_tpu')))
"""
    done = subprocess.run([sys.executable, '-c', script], capture_output=True, text=True,
                          cwd=Path(__file__).parents[1], timeout=300)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip().splitlines()[-1] == '[]'
    assert (tmp_path / 'repo' / 'fold.0' / 'gpr.v.i' / 'test.csv').exists()
    for kind in ('first_order', 'closed', 'total'):
        assert (tmp_path / 'repo' / 'fold.0' / 'gpr.v.i' / 'gsa' / kind / 'T.csv').exists()
        assert (tmp_path / 'repo' / 'gpr.v.i' / 'gsa' / kind / 'W.csv').exists()
        assert (tmp_path / 'repo' / 'fold.0' / 'gpr.c.a' / 'gsa' / kind / 'S.csv').exists()
    assert (tmp_path / 'repo' / 'fold.0' / 'gpr.c.a' / 'test.csv').exists()
    for k in (0, 1):
        assert (tmp_path / 'repo' / f'fold.{k}' / 'large.v.a' / 'test.csv').exists()
    for csv in ('meta.json', 'rotation.csv'):
        assert (tmp_path / 'repo' / 'fold.0' / 'rom' / csv).exists()
    for k in (0, 1, 2):
        assert (tmp_path / 'pair' / f'fold.{k}' / 'gpr.v.a' / 'gsa' / 'total' / 'T.csv').exists()
        assert (tmp_path / 'csv' / f'fold.{k}' / 'gpr.v.a' / 'gsa' / 'total' / 'W.csv').exists()
    for csv in ('gpr/test_summary.csv', 'gsa/T.csv'):
        assert (tmp_path / 'csv' / csv).exists()
