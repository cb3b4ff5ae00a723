"""The covariant training window: benchmark_script's covariant pass
(``-C -c``) of one fold, ``models.gp.calibrate_covariant`` called as
``MOGP._calibrate_covariant`` calls it, again and again from the same warm
start while the window is open.

Set-up samples benchmark_script's repository (the configuration's problem,
a CSV), splits it as ``into_K_folds(K)`` does under Python's random seeded
with the run's seed, and builds the fold's covariant MOGP the way
``user.run.gpr(is_covariant=None)`` builds its covariant pass: the variant
anisotropic twin ``gpr.v.a`` holds the cell's ``hypers`` (trained once, on
the seed they name), its folder is copied to ``gpr.c.a`` and read back as a
covariant model, which broadcasts F and the noise covariance from the twin's
variances and noise. The lengthscales stay frozen (rom-comma's default), so
a call builds the (L N)^2 unit gram once and then evaluates
``CovariantUpperLML`` (one (L N, L N) Cholesky, two solves and one
cholesky_inverse) each round, at most the traffic's ``maxiter`` iterations.

A unit is one call; set-up warms up with its first round. The window and
the rounds' records are the fit driver's (perfbench/drivers/fit.py), as is
the comparison that decides ``correct``: the first round, the first step and
the final round of each completed call, held to the plain float64 reference
(perfbench/reference/covariant_lml.py) at the program's points, the LML
gaps over L N, the gradients in the optimizer's own coordinates (the
Cholesky leaves of F and the noise covariance).

Faults for the covariant LML, planted for perfbench/control.py, are
perfbench/faults_covariant.py's."""

from __future__ import annotations

import math
import random
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from perfbench import flops_covariant, harness
from perfbench.drivers import fit
from perfbench.reference import covariant_lml as ref_cov
from perfbench.reference import folds as ref_folds

#: The covariant leaves, in the program's order.
LEAVES = ('raw_kernel_chol_diag', 'kernel_chol_lower', 'raw_lengthscales',
          'raw_noise_chol_diag', 'noise_chol_lower')


def setup(ctx) -> fit.State:
    from romcomma_tpu_torch.ops import gram_kernels, lbfgs
    state = fit.State()
    state.ctx, state.route, state.device = ctx, 'covariant', ctx.device
    t0 = time.perf_counter()
    data = ctx.problem.make(ctx.config, ctx.seed, ctx.folder)
    t1 = time.perf_counter()
    _setup_covariant(state, data)
    t2 = time.perf_counter()
    state.rounds = harness.Rounds(lbfgs)
    state.launches = harness.Launches(gram_kernels)
    state.calls: List[Tuple[int, int]] = []
    state.started = 0
    fit._unit(state, first_rounds=1)
    state.rounds.rounds.clear()
    state.setup_parts = {'data_s': t1 - t0, 'program_s': t2 - t1,
                         'warm_round_s': time.perf_counter() - t2}
    return state


def twin_folder(repo, k: int, hypers: Dict[str, Any]):
    """Fold k's trained variant anisotropic twin 'gpr.v.a', holding
    ``hypers`` (variance (L,), lengthscales (L, M), noise (L,))."""
    from romcomma_tpu_torch.data.storage import Fold
    from romcomma_tpu_torch.models.gpr import MOGP
    fold = Fold(repo, k)
    twin = MOGP('gpr.v.a', fold, False, False, False)
    twin.kernel.data.replace(variance=np.asarray(hypers['variance'], dtype=np.float64)[None, :],
                             lengthscales=np.asarray(hypers['lengthscales'], dtype=np.float64))
    twin.likelihood.data.replace(variance=np.asarray(hypers['noise'], dtype=np.float64)[None, :])
    return fold


def _setup_covariant(state: fit.State, data: Dict[str, Any]):
    from romcomma_tpu_torch.base.classes import Data
    from romcomma_tpu_torch.data.storage import Repository
    from romcomma_tpu_torch.models import gp as gp_module
    from romcomma_tpu_torch.models.gpr import MOGP
    from romcomma_tpu_torch.models.params import covariant_mask
    config, traffic = state.ctx.config, state.ctx.traffic
    K, k = int(config['K']), int(traffic['fold'])
    repo = Repository.from_csv(state.ctx.folder / 'repo', data['csv'])
    random.seed(state.ctx.seed)                   # Python's random draws the fold labels
    repo.into_K_folds(K)
    fold = twin_folder(repo, k, state.ctx.cell['hypers'])
    # user.run.gpr's warm start of the covariant pass from its variant twin
    Data.copy(src_folder=fold.folder / 'gpr.v.a', dst_folder=fold.folder / 'gpr.c.a')
    gp = MOGP('gpr.c.a', fold, True, True, False)
    meta, kernel_options, likelihood_options = gp._calibration_options()
    # as MOGP._calibrate_covariant calls gp.calibrate_covariant
    mask = covariant_mask(kernel_variance=kernel_options['variance'],
                          kernel_covariance=kernel_options['covariance'],
                          lengthscales=bool(kernel_options['lengthscales']['covariant']),
                          noise_variance=likelihood_options['variance'],
                          noise_covariance=likelihood_options['covariance'])
    X, Y = gp._tensor(gp.X), gp._tensor(gp.Y)
    large = gp.L * gp.N >= int(meta.get('large_n_threshold', gp.LARGE_N_THRESHOLD))
    maxiter, gtol = int(traffic['maxiter']), float(meta.get('gtol', 1e-16))

    def call():
        state.started += 1
        return gp_module.calibrate_covariant(gp._covariant_raw(), mask, X, Y, maxiter=maxiter,
                                             gtol=gtol, large=large)
    state.call = call
    state.mask = {name: float(mask[name]) for name in LEAVES}
    state.N, state.M, state.L, state.K = gp.N, gp.M, gp.L, K
    state.LN = gp.L * gp.N
    state.csv, state.fold = data['csv'], k
    state.ls = np.asarray(gp.kernel.data.lengthscales.np, dtype=np.float32).astype(np.float64)
    state.inputs = (gp, X, Y)
    state.engine = 'CovariantUpperLML'


def window(state: fit.State, seconds: float) -> Dict[str, Any]:
    state.started = 0
    out = fit.window(state, seconds)
    state.window_started = state.started
    return out


def trace(state: fit.State, record: Dict[str, Any]):
    """The fit driver's record and profiled rounds, with the covariant
    model FLOPs of the window (perfbench/flops_covariant.py)."""
    fit.trace(state, record)
    evaluations = sum(len(r['members']) for r in state.window_rounds)
    record['model_flops'] = flops_covariant.window_flops(state.LN, state.M, evaluations,
                                                         state.window_started)


close, counts = fit.close, fit.counts


# --------------------------------------------------------------------------- #
# correct
# --------------------------------------------------------------------------- #

def _inputs(state: fit.State, device: torch.device):
    """(x (N, M), y (N, L)) float64 on ``device``: the reference's own fold
    and normalization, rounded to float32 as the program's inputs are."""
    table = ref_folds.read_csv(state.csv)
    labels = ref_folds.fold_labels(table.shape[0], abs(state.K), state.ctx.seed)
    X, Y = ref_folds.normalized_fold(table, labels, state.fold, state.M)
    return tuple(torch.as_tensor(a.to(torch.float32), dtype=torch.float64, device=device)
                 for a in (X, Y))


def _reference(state: fit.State, x: torch.Tensor, y: torch.Tensor, item: Dict[str, Any],
              dtype: torch.dtype, form: str = 'direct') -> Tuple[float, np.ndarray]:
    """(objective, gradient flat in the program's order) of the reference at
    one recorded point: -lml and its gradient in the leaves, masked."""
    device = x.device
    point = {name: torch.as_tensor(item['point'][name], dtype=torch.float64, device=device)
             for name in LEAVES}
    ls = torch.as_tensor(state.ls, dtype=torch.float64, device=device)
    out = ref_cov.chol_value_and_grad(x.to(dtype), y.to(dtype), ls, point, form)
    grads = [torch.zeros(point[name].numel(), dtype=torch.float64, device=device)
             if name == 'raw_lengthscales' else
             (-out[name].to(torch.float64) * state.mask[name]).reshape(-1) for name in LEAVES]
    return -float(out['lml']), torch.cat(grads).cpu().numpy()


def check(state: fit.State, control: bool = False) -> Dict[str, Dict[str, float]]:
    """The compared numbers beside their limits. With ``control`` the
    reference in float32, its unit gram's cross term a TF32 matmul, takes the
    program's place at the program's points."""
    limits = state.ctx.cell['limits']
    x, y = _inputs(state, state.device)
    finals = fit._finals(state)
    ref: Dict[int, tuple] = {}
    got: Dict[int, tuple] = {}
    for j in [0] + finals:
        if j in ref:
            continue
        item = fit._item(state, j, 0)
        ref[j] = _reference(state, x, y, item, torch.float64)
        if control:
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                got[j] = _reference(state, x, y, item, torch.float32, 'expansion')
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
        else:
            got[j] = (item['value'], item['grad'])
    scale = float(np.max(np.abs(ref[0][1])))

    def gaps(rounds_) -> Tuple[float, float]:
        lml = grad = 0.0
        for j in rounds_:
            value, g = got[j]
            if not (np.isfinite(value) and np.all(np.isfinite(g))):
                return math.inf, math.inf
            lml = max(lml, abs(value - ref[j][0]) / state.LN)
            grad = max(grad, float(np.max(np.abs(g - ref[j][1]))) / scale)
        return lml, grad

    numbers = dict(zip(('start_lml_gap', 'start_grad_gap'), gaps([0])))
    x0 = fit._flat(fit._item(state, 0, 0)['point'])
    x1_ref = fit._first_step(x0, *ref[0])
    if control:
        finite = np.isfinite(got[0][0]) and np.all(np.isfinite(got[0][1]))
        x1 = fit._first_step(x0, *got[0]) if finite else x0
    else:
        x1 = fit._second_points(state).get(0, x0)
    moved = float(np.linalg.norm(x1_ref - x0))
    numbers['step_gap'] = float(np.linalg.norm(x1 - x1_ref)) / moved if moved > 0 else 0.0
    end = gaps(finals) if finals else (math.inf, math.inf)
    numbers.update(zip(('end_lml_gap', 'end_grad_gap'), end))
    return {name: {'value': value, 'limit': limits[name]} for name, value in numbers.items()}


# --------------------------------------------------------------------------- #
# The twin's hypers
# --------------------------------------------------------------------------- #

def train_twin(workload: str, seed: int, folder) -> Dict[str, Any]:
    """Train fold ``fold``'s variant anisotropic twin on the seed's data as
    ``user.run.gpr`` trains the pass before the covariant one
    (``MOGP('gpr.v.a').calibrate()``, float32, rom-comma's default start),
    and return its parameters as the cell's ``hypers``:

        python3 perfbench/drivers/fit_covariant.py <cell> <seed>"""
    from pathlib import Path
    from perfbench import run
    run._environment()
    from romcomma_tpu_torch.data.storage import Fold, Repository
    from romcomma_tpu_torch.models.gpr import MOGP
    files = run.cell_files(workload)
    config, traffic = files['config'], files['traffic']
    problem = __import__(f'perfbench.problems.{config["problem"]}', fromlist=['make'])
    data = problem.make(config, seed, Path(folder))
    repo = Repository.from_csv(Path(folder) / 'repo', data['csv'])
    random.seed(seed)
    repo.into_K_folds(int(config['K']))
    twin = MOGP('gpr.v.a', Fold(repo, int(traffic['fold'])), False, False, False)
    t0 = time.perf_counter()
    meta = twin.calibrate()
    return {'source': f'fold {traffic["fold"]}\'s variant anisotropic twin trained on seed '
                      f'{seed} (MOGP(\'gpr.v.a\').calibrate(), float32)',
            'seed': seed, 'train_s': time.perf_counter() - t0, 'result': meta['result'],
            'variance': twin.kernel.data.variance.np[0].astype(float).tolist(),
            'lengthscales': twin.kernel.data.lengthscales.np.astype(float).tolist(),
            'noise': twin.likelihood.data.variance.np[0].astype(float).tolist()}


if __name__ == '__main__':
    import json
    import sys
    import tempfile
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    with tempfile.TemporaryDirectory(prefix='perfbench-twin-') as scratch:
        print(json.dumps(train_twin(sys.argv[1], int(sys.argv[2]), scratch)), flush=True)
