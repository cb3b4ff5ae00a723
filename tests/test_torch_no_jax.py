"""The port stands alone: a fresh process imports romcomma_tpu_torch and
trains a small model through run.gpr on the CPU without importing jax or
romcomma_tpu."""

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
with user.contexts.Environment('port'):
    user.run.gpr('gpr', repo, is_read=False, is_covariant=False, is_isotropic=True, maxiter=20)
print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'romcomma_tpu')))
"""
    done = subprocess.run([sys.executable, '-c', script], capture_output=True, text=True,
                          cwd=Path(__file__).parents[1], timeout=300)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip().splitlines()[-1] == '[]'
    assert (tmp_path / 'repo' / 'fold.0' / 'gpr.v.i' / 'test.csv').exists()
